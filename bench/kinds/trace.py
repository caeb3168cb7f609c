"""The trace kind: a configuration that is an inline trace (the port's
``Trace.from_dict``: jobs with arrivals, ranks, runtime estimates and DSL
sources, the fabric, ``slots`` job slots), marked ``"kind": "trace"``,
under traffic that names a call's study seeds (``seeds``), its queue
policies (``policies``) and how many cells the check compares
(``checked``). A call is ``union.run`` of a ``TraceStudy`` over those
seeds and policies: the facade lowers it to one node of the cells in
lock step (seed-major, policy-minor). Every repeat runs the same cells;
``--seed`` draws the warm-up's seeds and the cells checked. The check
runs each checked cell again, alone, through the plain reference
(``reference/sched.py``) and compares the records (``judge.py``).
"""
from __future__ import annotations

import re
import sys
import time
from typing import Dict, List, Tuple

import judge
import studygen

# keys of the configuration file that are the benchmark's, not the trace's
OWN_KEYS = ("kind", "assumed")
# a job's record: compared exactly, but for the two float sums below
JOB_KEYS = ("name", "arrival_us", "slot", "start_us", "finish_us",
            "completed", "msgs", "avg_latency_us", "max_comm_ms")
# the per-slot latency sums are taken by atomics on the card, in an order
# that differs between runs; the communication time is compared with them
SUM_LEAVES = re.compile(r"^jobs\[\d+\]/(avg_latency_us|max_comm_ms)$")


def trace_dict(config: Dict) -> Dict:
    return {k: v for k, v in config.items() if k not in OWN_KEYS}


def late_arrivals(tr: Dict) -> Dict:
    """The trace with every job arriving after the horizon: the same
    engine envelope, batch and graphs as the cell's, one window of idle
    skips to simulate (the warm-up)."""
    after = float(tr["horizon_ms"]) * 1000.0 + 1.0
    return dict(tr, jobs=[dict(j, arrival_us=after) for j in tr["jobs"]])


def records(report: Dict) -> Dict:
    """What the check compares of one cell's report (``sched_summary``):
    its window count, makespan, whether the horizon cut it, and every
    job's record."""
    return dict(windows=report["windows"], makespan_ms=report["makespan_ms"],
                horizon_hit=report["horizon_hit"],
                jobs=[{k: j[k] for k in JOB_KEYS}
                      for j in report["per_job"]])


def cell_virtual_ms(report: Dict, horizon_ms: float) -> float:
    """A cell's virtual time: its horizon where the horizon cut it (its
    clock stops within a tick past it), else its makespan."""
    return horizon_ms if report["horizon_hit"] else report["makespan_ms"]


def checked_cells(seed: int, repeats: int, seeds: List[int],
                  policies: List[str], checked: int) -> List[Tuple]:
    """``checked`` (repeat, study seed, policy) triples of the window,
    drawn from the seed: the policies in turn, so each is compared
    first, each time a (repeat, study seed) pair not yet taken for it."""
    rng = studygen._rng(seed, 2)
    left = {p: [(r, s) for r in range(repeats) for s in seeds]
            for p in policies}
    out: List[Tuple] = []
    i = 0
    while len(out) < checked and any(left.values()):
        p = policies[i % len(policies)]
        i += 1
        if left[p]:
            r, s = left[p].pop(int(rng.integers(0, len(left[p]))))
            out.append((r, s, p))
    return out


def backfills(jobs: List[Dict]) -> int:
    """Jobs (in trace order) that started while an earlier one waited."""
    n = 0
    for k, j in enumerate(jobs):
        if j["slot"] < 0:
            continue
        s = j["start_us"]
        n += any(i["arrival_us"] <= s and (i["slot"] < 0 or i["start_us"] > s)
                 for i in jobs[:k])
    return n


def recycled(jobs: List[Dict]) -> int:
    """Starts in a slot that an earlier job of the cell had held."""
    slots = [j["slot"] for j in jobs if j["slot"] >= 0]
    return len(slots) - len(set(slots))


class Study:
    """A cell of trace seeds and queue policies: its warm-up, its
    repeats, their records and the check."""

    def __init__(self, name: str, config: Dict, traffic: Dict, seed: int,
                 device: str):
        from repro_torch import union
        from repro_torch.sched import scheduler as SCHED
        from repro_torch.sched.trace import Trace

        self.name, self.seed, self.device = name, seed, device
        self.tr = trace_dict(config)
        self.seeds = [int(s) for s in traffic["seeds"]]
        self.policies = list(traffic["policies"])
        self.checked = int(traffic["checked"])
        self.units = len(self.seeds) * len(self.policies)
        self.union, self.Trace = union, Trace
        self.trace = Trace.from_dict(self.tr)
        self.horizon_ms = float(self.trace.horizon_ms)
        # the profiles' boundary: the scheduler's host view, the first
        # step of each round; the boundary profile spans rounds 2 and 3
        # of the second repeat
        self.tap_target, self.tap_rounds = (SCHED, "window_host_view"), (2, 2)

    def _study(self, trace, seeds):
        return self.union.run(self.union.Experiment(
            name=self.name, trace=self.union.TraceStudy(
                trace=trace, seeds=list(seeds), policies=self.policies,
                slots=trace.slots)), store=None, device=self.device)

    def warmup(self) -> None:
        """One call of the cell's shape on seeds none of the window's,
        every job arriving after the horizon: it captures the window
        graph of the cell's batch."""
        seeds = studygen.MemberSeeds({"member_seeds": self.seeds},
                                     self.seed).warmup()
        self._study(self.Trace.from_dict(late_arrivals(self.tr)), seeds)

    def call(self):
        """One repeat: the study of the cell's seeds and policies."""
        return self._study(self.trace, self.seeds)

    def record(self, res) -> Dict:
        cells = res.trace_cells
        vms = [cell_virtual_ms(c.report, self.horizon_ms) for c in cells]
        return dict(
            cells=[(c.seed, c.policy) for c in cells],
            reports=[c.report for c in cells],
            engine=res.telemetry["engine"].get("windowed_batch", {}),
            replicas=[], vms=sum(vms), batch_vms=max(vms, default=0.0))

    def virtual_ms(self, repeats: List[Dict]) -> float:
        return float(sum(r["vms"] for r in repeats))

    def failed(self, repeats: List[Dict]) -> int:
        return len(repeats) * self.units - sum(len(r["reports"])
                                               for r in repeats)

    def judge(self, repeats: List[Dict]) -> Dict:
        """The check: ``checked`` cells drawn from the seed, each cell's
        records against the reference's run of that cell alone."""
        from reference.sched import TraceSystem, run_cell

        t_ref = time.perf_counter()
        picks = checked_cells(self.seed, len(repeats), self.seeds,
                              self.policies, self.checked)
        got = []
        for r, s, p in picks:
            rep = dict(zip(repeats[r]["cells"], repeats[r]["reports"]))
            got.append(records(rep[(s, p)]) if (s, p) in rep else None)
        system = TraceSystem(self.tr)
        ref = {sp: run_cell(self.tr, sp[0], sp[1], self.device,
                            system=system)
               for sp in sorted({(s, p) for _, s, p in picks})}
        want = [ref[(s, p)] for _, s, p in picks]
        numbers = judge.judge(got, want, sums=SUM_LEAVES)
        print(f"bench: reference {time.perf_counter() - t_ref:.3f} s for "
              f"{len(ref)} cells, {len(picks)} compared, "
              f"{numbers['leaves']} leaves", file=sys.stderr)
        lines = ["; ".join(
            f"{s} {p}: {rep['completed']} {recycled(rep['per_job'])} "
            f"{backfills(rep['per_job'])} {rep['windows']}"
            for (s, p), rep in zip(r["cells"], r["reports"]))
            for r in repeats]
        for line in dict.fromkeys(lines):
            print(f"bench: {lines.count(line)} repeat(s) of cells (seed "
                  "policy: completed, recycled slots, backfills, windows): "
                  + line, file=sys.stderr)
        return numbers

    def shapes(self, chips: int):
        """No per-layer metric of a trace cell reads the bounds."""
        return None
