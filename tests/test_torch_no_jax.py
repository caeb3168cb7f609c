"""The port stands alone: no JAX, nothing of ``repro``, no quiet CPU runs.

* Importing ``repro_torch`` and every module of it in a fresh interpreter
  loads no ``jax`` module and no ``repro`` module.
* No source file of the port names either in an import.
* An entry point called without ``device="cpu"`` on a machine without a
  card raises instead of running on the CPU: the scenario and LM entry
  points (serving and training), the experiment facade ``repro_torch.union.run`` and the front
  doors over it (the CLI, the ensemble shims, a server's job).
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "repro_torch.launch.sim" in names, names
assert "repro_torch.launch.serve" in names, names
assert "repro_torch.sched.scheduler" in names, names
assert "repro_torch.obs.timeline" in names, names
for name in ("union.experiment", "union.planner", "union.report",
             "union.store", "core.interp", "core.hlo2skeleton",
             "netsim.fabric.fat_tree", "netsim.fabric.torus",
             "union.ensemble", "union.cli", "union.__main__",
             "union.client", "union.serve", "union.serve.server",
             "union.serve.__main__", "core.eventgen", "models.moe",
             "models.convert", "optim.adamw", "train.train_step",
             "data.pipeline", "checkpoint.manager", "launch.train",
             "configs.whisper_medium", "configs.internvl2_1b",
             "launch.mesh", "launch.specs", "launch.roofline",
             "launch.dryrun", "train.sharding", "device", "netsim.engine",
             "union.manager", "configs"):
    assert "repro_torch." + name in names, names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules")
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20


IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)(\.|\s|$)"
    r"|from\s+(jax|jaxlib|repro)(\.|\s))", re.M)


def test_no_port_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 20
    for rel in ("netsim/fabric/fat_tree.py", "netsim/fabric/torus.py",
                "union/ensemble.py", "union/cli.py", "union/__main__.py",
                "union/client.py", "union/serve/__init__.py",
                "union/serve/__main__.py", "union/serve/server.py",
                "core/eventgen.py", "models/moe.py", "optim/adamw.py",
                "train/train_step.py", "data/pipeline.py",
                "checkpoint/manager.py", "launch/train.py",
                "launch/mesh.py", "launch/specs.py", "launch/roofline.py",
                "launch/dryrun.py", "train/sharding.py", "device.py",
                "netsim/engine.py", "union/experiment.py",
                "union/manager.py", "configs/__init__.py"):
        assert PORT / rel in files, rel
    hits = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
            for p in files for m in IMPORT.finditer(p.read_text())]
    assert not hits, hits


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour "
                    "without one")


def _tiny_scenario():
    from repro_torch.union.scenario import Scenario, ScenarioJob

    return Scenario(
        name="tiny", placement="RN", tick_us=2.0, horizon_ms=1.0,
        pool_size=64,
        jobs=[ScenarioJob(
            app="pp", ranks=2,
            source="For 2 repetitions { task 0 sends a 1024 byte message "
                   "to task 1 then task 1 sends a 1024 byte message to "
                   "task 0 }")])


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from repro_torch.launch import sim
    from repro_torch.union import manager

    rs = manager.resolve(_tiny_scenario())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        manager.build(rs)
    with pytest.raises(RuntimeError, match="device='cpu'"), \
            pytest.warns(DeprecationWarning, match="run_scenario"):
        manager.run_scenario(_tiny_scenario())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.run_sim("baseline-nn", "1d", "RG", "ADP", horizon_ms=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.main(["--workload", "baseline-nn", "--horizon-ms", "1",
                  "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    # and with the CPU asked for, the same scenario runs
    with pytest.warns(DeprecationWarning, match="run_scenario"):
        rep = manager.run_scenario(_tiny_scenario(), device="cpu")
    assert rep["latency"]["pp"]["count"] == 4


def test_experiment_facade_raises_without_a_card(no_card, tmp_path):
    from repro_torch import union

    exp = union.Experiment(name="tiny", scenarios=[_tiny_scenario()])
    store = tmp_path / "store"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        union.run(exp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        union.run(exp, store=str(store))
    assert not store.exists()  # it raised before touching the store
    # the front doors over it: the CLI, the ensemble shims, a server job
    from repro_torch.union import cli
    from repro_torch.union.serve.server import JobManager

    spec = tmp_path / "tiny.json"
    _tiny_scenario().to_json(str(spec))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--scenario", str(spec), "--members", "1", "--out",
                  str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"), \
            pytest.warns(DeprecationWarning, match="run_campaign"):
        union.run_campaign(_tiny_scenario(), members=1)
    mgr = JobManager()
    job = mgr.submit(exp.to_dict())
    mgr.stop(timeout=60)
    assert job.status == "error" and "device='cpu'" in job.error
    # and with the CPU asked for, the same experiment runs
    res = union.run(exp, device="cpu")
    assert res.cells[0].report["latency"]["pp"]["count"] == 4


def test_lm_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model as MDL
    from repro_torch.train.serve_step import make_decode_state

    cfg = get_smoke_config("mamba2_370m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MDL.init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_decode_state(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2_370m", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "whisper_medium", "--smoke"])
    from repro_torch.launch import train
    from repro_torch.train.train_step import init_state
    from repro_torch.optim.adamw import OptConfig

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "mamba2_370m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, OptConfig())
    # and with the CPU asked for, a prefill step runs
    params = MDL.init_model(cfg, device="cpu")
    tok = MDL.prefill_forward(params, torch.zeros((1, 5), dtype=torch.int32),
                              cfg)
    assert tok.shape == (1,) and tok.device.type == "cpu"
