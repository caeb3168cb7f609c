"""The port's dry run counts what the reference's counts, on the cell that
``hlo:`` jobs are made of.

``python -m repro.launch.dryrun`` and ``python -m repro_torch.launch.dryrun``
of ``mistral_nemo_12b`` / ``train_4k`` / ``single`` (the production
(16, 16) mesh, accum 1), each in a subprocess of its own and both at
once: the reference forces 512 XLA host devices at import, and the port
joins a fake process group of 256 ranks, which cannot share a worker with
the 4-rank group of ``tests/test_torch_dryrun.py``.

The port's ``flops_per_device`` and ``analysis.per_period.flops`` and
``analysis.base.flops`` are each within 10 % of the reference's. The
port's flop counter counts matrix products; XLA's cost analysis counts
elementwise work too, which in this dense model is a small part of the
step (the Mamba-2 mixer's is not: there the port counts less, a
difference of scope). Before the row-parallel products' backward was
pinned (``train.sharding.reduce_partial``), one torch release's DTensor
ran that backward at full width on every ``model`` rank and counted
2.3 times the reference's FLOPs.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ("mistral_nemo_12b", "train_4k", "single")
TOL = 0.10


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    arch, shape, mesh = CELL
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path_factory.mktemp(pkg)
        procs[pkg] = (out, subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--accum", "1",
             "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    recs = {}
    for pkg, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{pkg}: {log[-3000:]}"
        with open(out / f"{arch}__{shape}__{mesh}.json") as f:
            recs[pkg] = json.load(f)
    return recs


def _flops(rec, path):
    for k in path:
        rec = rec[k]
    return float(rec)


@pytest.mark.parametrize("path", [
    ("flops_per_device",),
    ("analysis", "per_period", "flops"),
    ("analysis", "base", "flops"),
], ids=lambda p: ".".join(p))
def test_flops_within_ten_percent_of_the_reference(records, path):
    want = _flops(records["repro"], path)
    got = _flops(records["repro_torch"], path)
    assert want > 0
    assert abs(got / want - 1.0) <= TOL, (path, got, want, got / want)


def test_same_cell_and_mesh(records):
    ref, port = records["repro"], records["repro_torch"]
    for k in ("arch", "shape", "kind", "accum", "n_devices", "n_dp",
              "n_tokens", "params", "active_params"):
        assert port[k] == ref[k], k
