"""The control of the output check, at a cell's own size on the card:
the plain reference in bfloat16 (the precision below the simulator's
float32) put in the program's place, judged against the float32
reference on the same members by the same numbers as a run's check.

    python3 bench/control.py --config <config> --traffic <traffic>

prints one JSON line: each member's numbers for the control, the
configuration's limits, and the seconds each side took. A bfloat16 clock
cannot reach the horizon in 5 us steps, so the control stops at the
ticks the horizon takes.
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
    seeds = json.loads((BENCH / "traffic" / f"{a.traffic}.json")
                       .read_text())["member_seeds"]
    limits = json.loads((BENCH / "limits" / f"{a.config}.json").read_text())
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
