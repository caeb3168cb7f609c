"""Paper §V validation on the port: skeleton == application.

The port's direct AST interpreter (``repro_torch.core.interp``) against
its skeletons for the Table III applications (event counts per MPI
function, bytes per rank, the control-flow trace; small scale and, for
two apps, paper scale), as ``tests/test_validation.py`` does for the JAX
package; the port's interpreter against the JAX package's on the same
sources, seeded random programs among them; and the ``hlo:`` path:
``ml_workload_source`` and ``from_dryrun_record`` equal to the JAX
package's on a record written to a temporary directory, and an ``hlo:``
job resolved through the port's manager.
"""
import json

import numpy as np
import pytest

from repro.core import hlo2skeleton as REF_HLO
from repro.core import interp as REF_INTERP
from repro.core import workloads as REF_W
from repro.union import manager as REF_MGR
from repro.union.scenario import ScenarioJob as RefScenarioJob
from repro_torch.core import hlo2skeleton as HLO
from repro_torch.core import workloads as W
from repro_torch.core.interp import run_source, skeleton_trace
from repro_torch.core.translator import translate_source
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import ScenarioJob

ALL_APPS = ["cosmoflow", "alexnet", "nn", "milc", "nekbone", "lammps"]


@pytest.mark.parametrize("app", ALL_APPS)
def test_application_equals_skeleton(app):
    """Tables IV/V and Fig. 6 analogs at small scale."""
    a = W.build_application(app, "small")
    s = W.build_skeleton(app, "small")
    assert a.as_table() == s.event_counts()
    assert (a.bytes == s.bytes_per_rank()).all()
    assert a.trace == skeleton_trace(s)


@pytest.mark.parametrize("app", ["alexnet", "milc"])
def test_paper_scale_application_equals_skeleton(app):
    a = W.build_application(app, "paper")
    s = W.build_skeleton(app, "paper")
    assert a.as_table() == s.event_counts()
    assert (a.bytes == s.bytes_per_rank()).all()


@pytest.mark.parametrize("app", ALL_APPS)
def test_interpreter_matches_jax_package(app):
    got = W.build_application(app, "small")
    want = REF_W.build_application(app, "small")
    assert got.n_ranks == want.n_ranks
    assert got.as_table() == want.as_table()
    assert got.bytes.dtype == want.bytes.dtype
    np.testing.assert_array_equal(got.bytes, want.bytes)
    assert got.trace == want.trace
    assert skeleton_trace(W.build_skeleton(app, "small")) == \
        REF_INTERP.skeleton_trace(REF_W.build_skeleton(app, "small"))


STMTS = (
    "all tasks allreduce a {n} byte message",
    "all tasks synchronize",
    "all tasks compute for {n} microseconds",
    "task 0 multicasts a {n} byte message to all other tasks",
    "all tasks send a {n} byte message to task 0",
    "task 0 sends a {n} byte message to task 1",
    "all tasks exchange a {n} byte message with their neighbors in a "
    "2x2x2 grid",
)


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_validate_in_both_packages(seed):
    """Seeded random DSL programs: the port's interpreter equals its
    skeleton and the JAX package's interpreter."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    body = " then\n  ".join(
        STMTS[int(rng.integers(len(STMTS)))].format(
            n=int(rng.integers(1, 10**6))) for _ in range(n))
    src = f"For {int(rng.integers(1, 5))} repetitions {{\n  {body}\n}}"
    name = f"rand_{seed}"
    app = run_source(src, name, 8)
    sk = translate_source(src, name, 8)
    assert app.as_table() == sk.event_counts()
    assert (app.bytes == sk.bytes_per_rank()).all()
    assert app.trace == skeleton_trace(sk)
    ref = REF_INTERP.run_source(src, name, 8)
    assert app.as_table() == ref.as_table()
    np.testing.assert_array_equal(app.bytes, ref.bytes)
    assert app.trace == ref.trace


RECORD = dict(arch="fake-12b", shape="train_4k", params=6.0e9,
              flops_per_device=3.2e13, layout="tp")


def write_record(dirpath, mesh="single", **kw):
    rec = dict(RECORD, **kw)
    path = dirpath / f"{rec['arch']}__{rec['shape']}__{mesh}.json"
    path.write_text(json.dumps(rec))
    return str(path)


def test_ml_workload_source_matches_jax_package():
    assert HLO.PEAK_FLOPS == REF_HLO.PEAK_FLOPS
    assert (HLO.BUCKET_BYTES, HLO.MAX_BUCKETS) == (REF_HLO.BUCKET_BYTES,
                                                   REF_HLO.MAX_BUCKETS)
    for kw in (dict(flops_per_device=1e12, grad_bytes_per_rank=3e8,
                    steps=4),
               dict(flops_per_device=5e14, grad_bytes_per_rank=9e9,
                    steps=2, mfu=0.55),
               dict(flops_per_device=1e9, grad_bytes_per_rank=10.0)):
        got = HLO.ml_workload_source(name="fake:train", **kw)
        assert got == REF_HLO.ml_workload_source(name="fake:train", **kw)
    src = HLO.ml_workload_source(name="fake-12b:train_4k",
                                 flops_per_device=1e12,
                                 grad_bytes_per_rank=3e8, steps=4)
    app = run_source(src, "ml_fake", 16)
    sk = translate_source(src, "ml_fake", 16)
    assert app.as_table() == sk.event_counts()
    assert (app.bytes == sk.bytes_per_rank()).all()
    n_buckets = -(-int(3e8) // (128 << 20))
    assert sk.event_counts()["MPI_Allreduce"] == 4 * n_buckets * 16


@pytest.mark.parametrize("layout", ["tp", "dp"])
def test_dryrun_record_source_and_skeleton_match(tmp_path, layout):
    path = write_record(tmp_path, layout=layout)
    got = HLO.from_dryrun_record(path, steps=3)
    assert got == REF_HLO.from_dryrun_record(path, steps=3)
    assert got.startswith("# Auto-extracted by hlo2skeleton")
    sk = HLO.build_ml_skeleton("fake-12b", "train_4k",
                               dryrun_dir=str(tmp_path), n_ranks=32,
                               steps=3)
    ref = REF_HLO.build_ml_skeleton("fake-12b", "train_4k",
                                    dryrun_dir=str(tmp_path), n_ranks=32,
                                    steps=3)
    assert sk.n_ranks == ref.n_ranks == 32
    np.testing.assert_array_equal(sk.ops, ref.ops)
    np.testing.assert_array_equal(sk.grid, ref.grid)


def test_hlo_job_resolves_through_the_manager(tmp_path, monkeypatch):
    """``hlo:<arch>:<shape>[:<mesh>]`` reads
    ``results/dryrun/<arch>__<shape>__<mesh>.json`` under the working
    directory, in both packages."""
    rec_dir = tmp_path / "results" / "dryrun"
    rec_dir.mkdir(parents=True)
    write_record(rec_dir)
    write_record(rec_dir, mesh="pod", params=2.0e9)
    monkeypatch.chdir(tmp_path)
    for app, ranks in (("hlo:fake-12b:train_4k", 64),
                       ("hlo:fake-12b:train_4k:pod", None)):
        sk = MGR.build_job_skeleton(ScenarioJob(app=app, ranks=ranks),
                                    "small")
        ref = REF_MGR.build_job_skeleton(RefScenarioJob(app=app, ranks=ranks),
                                         "small")
        assert sk.n_ranks == ref.n_ranks == (ranks or 256)
        np.testing.assert_array_equal(sk.ops, ref.ops)
        assert "MPI_Allreduce" in sk.event_counts()
    with pytest.raises(ValueError, match="bad hlo app spec"):
        MGR.build_job_skeleton(ScenarioJob(app="hlo:fake-12b"), "small")
    with pytest.raises(FileNotFoundError):
        MGR.build_job_skeleton(ScenarioJob(app="hlo:other:shape"), "small")
