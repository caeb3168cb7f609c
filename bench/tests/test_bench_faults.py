"""The check that decides ``correct`` comes out false when the timed path
is broken underneath a rehearsed run, once for each fault a study cell
can have (see ``rehearse.py``)."""
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
