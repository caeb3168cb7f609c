"""The check that decides ``correct`` comes out false when the timed path
is broken underneath a rehearsed run, once for each fault a study cell
can have, and for the scheduler cell's windows and host rounds (see
``rehearse.py``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
DATA = BENCH / "tests" / "data"


@pytest.mark.parametrize("fault", ["stale", "half", "exchange", "altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(BENCH / "tests" / "rehearse.py"),
         "df1d_w1.split4", str(DATA / "tiny.json"),
         str(DATA / "tiny_traffic.json"), fault],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=BENCH.parent)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])["result"]
    assert out["correct"] is False
    assert out["checks"]["exact_leaves_off"]["value"] > 0


def _rehearse_trace(fault):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(BENCH / "tests" / "rehearse.py"),
         "trace_small.sched2", str(DATA / "dragonfly1d_trace_small.json"),
         str(DATA / "sched_small_traffic.json"), fault],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=BENCH.parent)


@pytest.mark.parametrize("fault", ["swapped", "half_window",
                                   "altered_window"])
def test_a_broken_scheduler_is_not_correct(fault):
    res = _rehearse_trace(fault)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])["result"]
    assert out["correct"] is False
    assert out["checks"]["exact_leaves_off"]["value"] > 0


def test_a_window_that_returns_its_state_stops_the_run():
    """The scheduler's own guard stops a run whose windows never advance:
    it prints no result at all."""
    res = _rehearse_trace("stale_window")
    assert res.returncode != 0
    assert res.stdout == ""
    assert "made no progress" in res.stderr
