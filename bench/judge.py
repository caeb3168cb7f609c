"""The comparison that decides ``correct``: each sampled member's report
from the program against the reference's report of the same scenario
and member seed (a trace cell's records against the reference's run of
the same cell: ``kinds/trace.py``, which names its own float sums).

Two numbers, each with its limit in ``limits/<config>.json``:

* ``exact_leaves_off``: report leaves that differ at all, over every
  leaf but the float sums below and the host's wall time. The integer
  trajectory is exact (message counts, drops, the clock, latency minima,
  maxima and quartile bins, each rank's communication time, which jobs
  finished), so any difference is a fault. A leaf missing on either side
  counts too.
* ``sum_leaves_rel_gap``: the largest relative gap among the leaves that
  are float sums taken in an order that differs between runs on the
  card (atomic adds): per-app mean latency, link loads and
  utilizations, the peak injection.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, List, Sequence, Tuple

HOST_LEAVES = re.compile(r"^sim_wall_s$")
SUM_LEAVES = re.compile(
    r"^(latency/[^/]+/avg_us"
    r"|link_load/(\w+_total_bytes|\w+_per_link_bytes|frac_\w+)"
    r"|link_utilization/[^/]+/(mean|max)|peak_inject_\w+)$")


def leaves(rep: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(rep, dict):
        for k in sorted(rep):
            yield from leaves(rep[k], f"{path}/{k}" if path else str(k))
    elif isinstance(rep, (list, tuple)):
        for i, v in enumerate(rep):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, rep


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _rel_gap(a, b) -> float:
    try:
        a, b = float(a), float(b)
    except (TypeError, ValueError):
        return math.inf
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def judge(program: Sequence[Dict], reference: Sequence[Dict],
          sums=SUM_LEAVES) -> Dict:
    """The two numbers over every sampled member (``program[i]`` against
    ``reference[i]``; a missing program report is None). ``sums`` matches
    the float-sum leaves (a configuration kind's own: ``kinds/``)."""
    off, gap, n = 0, 0.0, 0
    for got, want in zip(program, reference):
        w = {k: v for k, v in leaves(want) if not HOST_LEAVES.match(k)}
        g = ({k: v for k, v in leaves(got) if not HOST_LEAVES.match(k)}
             if got is not None else {})
        for k in set(w) | set(g):
            n += 1
            if k not in w or k not in g:
                off += 1
            elif sums.match(k):
                gap = max(gap, _rel_gap(g[k], w[k]))
            elif not _same(g[k], w[k]):
                off += 1
    return dict(exact_leaves_off=off, sum_leaves_rel_gap=gap, leaves=n,
                members=len(reference))


def verdict(numbers: Dict, limits: Dict) -> Tuple[bool, List[Tuple]]:
    """Whether every number is within its limit, and (name, value, limit)
    for each."""
    rows = [(k, numbers[k], limits[k]) for k in sorted(limits)]
    return all(v <= lim for _, v, lim in rows), rows
