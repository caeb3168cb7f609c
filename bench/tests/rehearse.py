"""Rehearse one run of ``bench/run.py`` on the CPU at a small size, in a
fresh interpreter, optionally with the timed path broken underneath:

    python bench/tests/rehearse.py <workload> <config.json> <traffic.json> [fault]

(a workload of ``BENCHMARK.json``, or of ``data/trace_cells.json``, the
trace kind's rehearsal cell, with the limits of ``data/trace_limits.json``)
prints one JSON object: the run's result line (``result``) and the
top-level names of every module loaded by then (``modules``). The faults
break the program's engine call the way a faulty change could:

* ``stale``: a run that returns its states unchanged;
* ``half``: half of the batch left out, its members given copies of the
  other half's final states;
* ``exchange``: the members split over two devices, the second device's
  final states never gathered (its initial states come back);
* ``altered``: one member's delivered-message count altered where the
  engine produces it.

A trace cell's scheduler breaks underneath the same way, in its windows
(``Engine.run_window``): ``stale_window``, ``half_window`` and
``altered_window``; or in its host rounds: ``swapped``, each cell run
under the other queue policy (FCFS for EASY, EASY for FCFS).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"
TRACE_CELL = "trace_small.sched2"


def _break(fault: str) -> None:
    import numpy as np
    import torch

    from repro_torch import device as DEV
    from repro_torch.netsim import engine as ENG

    run0, prun0 = ENG.Engine.run, ENG.Engine.prun
    window0 = ENG.Engine.run_window

    def stale(self, state, chunk=64):
        self.last_run = ENG.RunStats(device=self.device.type)
        return state

    def half(self, state, chunk=64):
        B = state.t.shape[0]
        keep = ENG.stack_members([ENG.member_state(state, i)
                                  for i in range(B // 2)])
        out = run0(self, keep, chunk)
        return ENG.stack_members([ENG.member_state(out, i % (B // 2))
                                  for i in range(B)])

    def altered(self, state, chunk=64):
        out = run0(self, state, chunk)
        cnt = out.metrics.lat_cnt.clone()
        cnt[0, 0] += 1
        return out._replace(metrics=out.metrics._replace(lat_cnt=cnt))

    def exchange(self, states, chunk=64):
        return prun0(self, states[:1], chunk) + list(states[1:])

    def stale_window(self, state, t_stop):
        self.last_window = ENG.RunStats(device=self.device.type)
        return state

    def half_window(self, state, t_stop):
        B = state.t.shape[0]
        keep = ENG.stack_members([ENG.member_state(state, i)
                                  for i in range(B // 2)])
        out = window0(self, keep, np.asarray(t_stop)[:B // 2])
        return ENG.stack_members([ENG.member_state(out, i % (B // 2))
                                  for i in range(B)])

    def altered_window(self, state, t_stop):
        out = window0(self, state, t_stop)
        cnt = out.metrics.lat_cnt.clone()
        cnt[0, 0] += 1
        return out._replace(metrics=out.metrics._replace(lat_cnt=cnt))

    if fault in ("stale_window", "half_window", "altered_window"):
        ENG.Engine.run_window = locals()[fault]
    elif fault == "swapped":
        from repro_torch.sched import scheduler as SCHED

        init0 = SCHED._CellLoop.__init__
        other = {"fcfs": "easy", "easy": "fcfs"}

        def swapped(self, trace, policy, *a, **kw):
            init0(self, trace, other.get(policy, policy), *a, **kw)

        SCHED._CellLoop.__init__ = swapped
    elif fault == "stale":
        ENG.Engine.run = stale
    elif fault == "half":
        ENG.Engine.run = half
    elif fault == "altered":
        ENG.Engine.run = altered
    elif fault == "exchange":
        DEV.local_devices = lambda device=None: [torch.device("cpu")] * 2
        ENG.Engine.prun = exchange
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import run

    workload, scenario, traffic = argv[:3]
    if len(argv) > 3:
        _break(argv[3])
    args = run.parse(["--workload", workload, "--seed", "4294967311",
                      "--seconds", "0", "--trace", "1"])
    files = {}
    if workload == TRACE_CELL:
        files = dict(spec=DATA / "trace_cells.json",
                     limits_file=DATA / "trace_limits.json")
    out = run.run_cell(args, device="cpu", config_file=scenario,
                       traffic_file=traffic, **files)
    run.print_checks(out)
    print(json.dumps(dict(
        result=out,
        modules=sorted({m.split(".", 1)[0] for m in sys.modules}))))


if __name__ == "__main__":
    main(sys.argv[1:])
