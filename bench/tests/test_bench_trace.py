"""The trace kind on the CPU: a rehearsal of the scheduler cell at a small
size (``data/dragonfly1d_trace_small.json``: six jobs into three slots
of the small 1D dragonfly) prints a result line of the contract's shape
with no module of JAX or the JAX package loaded; the plain reference's
cells equal the port's batched cells exactly under FCFS and EASY, with a
slot recycled and a job backfilled; the cells checked cover every policy
first."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SMALL = DATA / "dragonfly1d_trace_small.json"
TRAFFIC = DATA / "sched_small_traffic.json"


def _kind():
    spec = importlib.util.spec_from_file_location(
        "kind_trace", BENCH / "kinds" / "trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_rehearsal_prints_the_contracts_line_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(BENCH / "tests" / "rehearse.py"),
         "trace_small.sched2", str(SMALL), str(TRAFFIC)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    r = out["result"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] == 4  # 2 seeds x 2 policies, one repeat
    assert r["device"]["platform"] == "cpu"
    assert r["checks"]["exact_leaves_off"] == dict(value=0, limit=0)
    # traced on the CPU: the host's readings, never a device number
    assert set(r["metrics"]) == {"sched.host_share", "sched.rounds_per_vms",
                                 "sched.noop_tick_share"}
    assert 0 < r["metrics"]["sched.host_share"]["value"] < 100
    assert not set(out["modules"]) & FORBIDDEN
    assert {"repro_torch", "reference", "torch"} <= set(out["modules"])
    assert res.stderr.strip().splitlines()[-1] == "correct: True"


def test_reference_cells_equal_the_ports_under_fcfs_and_easy():
    import judge
    from reference.sched import run_cell
    from repro_torch import union
    from repro_torch.sched.trace import Trace

    torch.set_num_threads(1)
    kt = _kind()
    tr = kt.trace_dict(json.loads(SMALL.read_text()))
    seeds = [2147483000, 12]
    res = union.run(union.Experiment(name="ref", trace=union.TraceStudy(
        trace=Trace.from_dict(tr), seeds=seeds, policies=["fcfs", "easy"])),
        device="cpu")
    assert res.telemetry["engine"]["windowed_batch"]["calls"] > 0
    cells = res.trace_cells
    assert [(c.seed, c.policy) for c in cells] == [
        (s, p) for s in seeds for p in ("fcfs", "easy")]
    for c in cells:
        want = run_cell(tr, c.seed, c.policy, "cpu")
        got = kt.records(c.report)
        numbers = judge.judge([got], [want], sums=kt.SUM_LEAVES)
        assert numbers["exact_leaves_off"] == 0, (c.seed, c.policy)
        assert numbers["sum_leaves_rel_gap"] == 0.0
        assert numbers["leaves"] == 3 + 9 * len(tr["jobs"])
        jobs = want["jobs"]
        assert kt.recycled(jobs) >= 1
        assert sum(j["completed"] for j in jobs) >= 4
        assert (kt.backfills(jobs) >= 1) == (c.policy == "easy")


def test_checked_cells_cover_every_policy_first():
    kt = _kind()
    picks = kt.checked_cells(2**31 + 5, repeats=3, seeds=[4, 9],
                             policies=["fcfs", "easy"], checked=5)
    assert [p for _, _, p in picks] == ["fcfs", "easy", "fcfs", "easy",
                                        "fcfs"]
    assert len(set(picks)) == 5
    assert all(0 <= r < 3 and s in (4, 9) for r, s, _ in picks)
    assert picks == kt.checked_cells(2**31 + 5, 3, [4, 9], ["fcfs", "easy"],
                                     5)
    assert len(kt.checked_cells(1, 1, [4], ["fcfs", "easy"], 9)) == 2


def test_warmup_trace_keeps_the_envelope_with_every_arrival_late():
    kt = _kind()
    tr = kt.trace_dict(json.loads(SMALL.read_text()))
    late = kt.late_arrivals(tr)
    assert [j["name"] for j in late["jobs"]] == [j["name"]
                                                 for j in tr["jobs"]]
    assert all(j["arrival_us"] > tr["horizon_ms"] * 1000.0
               for j in late["jobs"])
    assert [j["ranks"] for j in late["jobs"]] == [j["ranks"]
                                                  for j in tr["jobs"]]
    cfg = json.loads(SMALL.read_text())
    assert set(kt.trace_dict(cfg)) == set(cfg) - {"kind", "assumed"}


def test_a_clock_that_cannot_reach_the_next_arrival_ends_the_cell(
        monkeypatch):
    """In bfloat16 (the control) an arrival at 1041.67 us rounds down to a
    stop of 1040 us, where the idle-time skip puts the clock: the window
    after it takes no tick, and the cell ends there instead of asking
    for the same window again."""
    from reference import engine
    from reference.sched import simulate_cell

    torch.set_num_threads(1)
    d = _kind().trace_dict(json.loads(SMALL.read_text()))
    first = dict(d["jobs"][0], overrides={"iters": 4})  # runs past 1041 us
    late = dict(d["jobs"][3], arrival_us=1041.673095703125)
    tr = dict(d, jobs=[first, late])
    windows = []
    run = engine.Windows.run

    def counted(self, t_stop):
        windows.append(t_stop)
        assert len(windows) < 50, "the cell asks for the same window again"
        return run(self, t_stop)

    monkeypatch.setattr(engine.Windows, "run", counted)
    rec, _ = simulate_cell(tr, 5, "fcfs", "cpu", fdt=torch.bfloat16,
                           max_ticks=400)
    assert windows == [1041.673095703125] * 2
    assert [j["completed"] for j in rec["jobs"]] == [False, False]
    windows.clear()
    rec, _ = simulate_cell(tr, 5, "fcfs", "cpu", max_ticks=400)
    assert windows[0] == 1041.673095703125 and len(windows) == 3
    assert rec["jobs"][1]["start_us"] == 1041.673095703125
