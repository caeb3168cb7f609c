"""The control of the output check, at a cell's own size on the card:
the plain reference in bfloat16 (the precision below the simulator's
float32) put in the program's place, judged against the float32
reference on the same members by the same numbers as a run's check.

    python3 bench/control.py --config <config> --traffic <traffic>

prints one JSON line: each member's numbers for the control, the
configuration's limits, and the seconds each side took. A bfloat16 clock
cannot reach the horizon in 5 us steps, so the control stops at the
ticks the horizon takes.

A trace configuration (``"kind": "trace"``) has two controls over its
traffic's seeds: each cell (seed, policy) of the bfloat16 reference,
run for the ticks its float32 cell took, against the float32 one, and
each seed's FCFS cell judged against its EASY cell (the queue policies
swapped). Each row goes to standard error as it is made.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))


def trace_control(cfg, traffic, limits, device, emit=None) -> dict:
    """The two controls of a trace configuration over the traffic's
    seeds. The bfloat16 cell gets the ticks its float32 cell took (its
    clock cannot reach the horizon in 5 us steps). ``emit`` receives
    each row as it is made."""
    import torch

    import judge
    from kinds.trace import SUM_LEAVES, trace_dict
    from reference.sched import TraceSystem, simulate_cell

    emit = emit or (lambda row: None)
    tr = trace_dict(cfg)
    system = TraceSystem(tr)
    out = dict(bfloat16=[], fcfs_as_easy=[], limits=limits, reference_s=0.0,
               control_s=0.0)

    def numbers(got, ref):
        return judge.judge([got], [ref], sums=SUM_LEAVES)

    want, ticks = {}, {}
    t0 = time.perf_counter()
    for s in traffic["seeds"]:
        for p in traffic["policies"]:
            want[s, p], ticks[s, p] = simulate_cell(tr, s, p, device,
                                                    system=system)
        row = dict(seed=s, **numbers(want[s, "fcfs"], want[s, "easy"]))
        out["fcfs_as_easy"].append(row)
        emit(dict(fcfs_as_easy=row))
    out["reference_s"] = time.perf_counter() - t0
    for (s, p), ref in want.items():
        t1 = time.perf_counter()
        got, n = simulate_cell(tr, s, p, device, fdt=torch.bfloat16,
                               max_ticks=ticks[s, p], system=system)
        row = dict(seed=s, policy=p, ticks=n, seconds=time.perf_counter() - t1,
                   **numbers(got, ref))
        out["bfloat16"].append(row)
        emit(dict(bfloat16=row))
    out["control_s"] = sum(r["seconds"] for r in out["bfloat16"])
    return out


def main(argv=None) -> int:
    import torch

    import judge
    from reference.study import member_reports

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sc = json.loads((BENCH / "configs" / f"{a.config}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{a.traffic}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{a.config}.json").read_text())
    if sc.get("kind") == "trace":
        out = trace_control(sc, traffic, limits, a.device, emit=lambda row:
                            print(json.dumps(row), file=sys.stderr,
                                  flush=True))
        print(json.dumps(dict(config=a.config, **out)))
        return 0
    seeds = traffic["member_seeds"]
    t0 = time.perf_counter()
    want = member_reports(sc, seeds, a.device)
    t1 = time.perf_counter()
    ticks = math.ceil(sc["horizon_ms"] * 1000.0 / sc["tick_us"]) + 64
    control = member_reports(sc, seeds, a.device, fdt=torch.bfloat16,
                             max_ticks=ticks)
    t2 = time.perf_counter()
    rows = [dict(seed=s, **judge.judge([c], [w]))
            for s, c, w in zip(seeds, control, want)]
    print(json.dumps(dict(config=a.config, members=rows, limits=limits,
                          reference_s=t1 - t0, control_s=t2 - t1,
                          control_virtual_ms=[c["virtual_time_ms"]
                                              for c in control])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
