"""``python -m repro_torch.launch.sim`` writes the report ``run_sim`` returns."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.sim import run_sim

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _without_wall(rep):
    return {k: v for k, v in rep.items() if k != "sim_wall_s"}


def test_cli_report_equals_in_process_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sim", "--device", "cpu",
         "--workload", "baseline-nn", "--scale", "small", "--horizon-ms", "5",
         "--tick-us", "5", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    path = tmp_path / "baseline-nn__1d__RG__ADP__small_s0.json"
    assert f"wrote {path}" in res.stdout
    got = json.loads(path.read_text())
    want = run_sim("baseline-nn", "1d", "RG", "ADP", scale="small",
                   horizon_ms=5.0, tick_us=5.0, device="cpu")
    want = json.loads(json.dumps(want, default=float))
    assert _without_wall(got) == _without_wall(want)
    assert got["latency"]["nn"]["count"] > 0
    assert got["dropped"] == 0
