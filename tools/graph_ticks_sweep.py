#!/usr/bin/env python3
"""Capture, instantiate and replay graphs of 8, 16 and 64 ticks, on one card.

    python3 tools/graph_ticks_sweep.py [--ticks 8 16 64] [--repeats 2]

For each size the engine's ``run`` holds at most that many ticks in one
captured CUDA graph (``repro_torch.netsim.engine.GRAPH_TICKS``, set here
for the sweep); the paper's 1D scenario (workload1 + UR on the 1D
dragonfly, 65,536-message pool, 5 µs tick, horizon 10 ms, seed 0) is
built afresh and run ``--repeats`` times with ``chunk=64``: the first run
captures its graph, the later ones replay the cached graph. The sizes
run in turns (8, 16, 64, then again in reverse) so that a drift of the
shared host does not favour one size. One JSON line a run: capture and
instantiate seconds, wall seconds, virtual ms per wall s, replay device
ms (CUDA events), ticks, replays, peak device memory; the card's name
and power limit first. Needs a CUDA card and nvcc; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_size(n, repeats, dev):
    import torch

    from repro_torch.netsim import engine as ENG
    from repro_torch.union import manager as MGR
    from repro_torch.union.scenario import mix_scenario
    from repro_torch.union.seeds import engine_seed

    ENG.GRAPH_TICKS = n
    sc = mix_scenario("workload1", topo="1d", scale="paper", placement="RG",
                      routing="ADP", tick_us=5.0, horizon_ms=10.0)
    rs = MGR.resolve(sc, seed=0)
    eng = MGR.build(rs, device=dev)
    rows = []
    for rep in range(repeats):
        st = eng.init_state(seed=engine_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = eng.run(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.last_run
        rows.append(dict(
            graph_ticks=s.graph_ticks, run=rep, captured=s.captured,
            capture_s=s.capture_s if s.captured else None,
            instantiate_s=s.instantiate_s if s.captured else None,
            wall_s=wall, virtual_ms=float(out.t) / 1000.0,
            virtual_ms_per_wall_s=float(out.t) / 1000.0 / wall,
            replay_device_ms=s.replay_device_ms,
            device_ms_per_tick=s.replay_device_ms / s.ticks,
            ticks=s.ticks, replays=s.replays,
            peak_device_mib=torch.cuda.max_memory_allocated() / 2**20))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, nargs="+", default=[8, 16, 64])
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("graph_ticks_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=card, torch=torch.__version__)), flush=True)
    dev = torch.device("cuda", 0)
    for n in list(args.ticks) + list(reversed(args.ticks)):
        for row in one_size(n, args.repeats, dev):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
