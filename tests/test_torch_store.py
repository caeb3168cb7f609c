"""The port's content-hash experiment store, after ``tests/test_store.py``.

Fingerprints are stable across re-planning and sensitive to exactly the
result-relevant axes (the failures axis among them); an identical rerun
executes zero cells and a changed grid cell re-executes one; trace cells
hit the store; ``RunCancelled`` fires between plan nodes with the cells
done so far persisted; the gc's size and age caps; and the port's
version block names torch and the run's device type, so its
fingerprints never equal the JAX package's, nor a CPU run's a card
run's.
"""
import json
import os

import pytest
import torch

from repro import union as REF
from repro.union import planner as REF_PLN
from repro.union import store as REF_STO
from repro_torch import union
from repro_torch.sched.trace import CatalogApp, synthetic_trace
from repro_torch.union import planner as PLN
from repro_torch.union import store as STO
from repro_torch.union.scenario import Scenario, ScenarioJob
from test_experiment import PP


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_scenario():
    return Scenario(
        name="tiny",
        jobs=[
            ScenarioJob(app="pp0", source=PP, ranks=2),
            ScenarioJob(app="pp1", source=PP, ranks=2, start_us=200.0),
        ],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256,
    )


def tiny_experiment(**kw):
    kw.setdefault("members", 2)
    return union.Experiment(
        name="store-t", scenarios=[tiny_scenario()], **kw)


def scenario_cells(exp):
    plan = PLN.plan(exp)
    return [c for n in plan.nodes if n.kind == "batched" for c in n.cells]


def fp(exp, i=0, device="cpu"):
    return STO.scenario_fingerprint(exp, scenario_cells(exp)[i], device)


def run_cpu(exp, **kw):
    return union.run(exp, device="cpu", **kw)


def store_trace():
    catalog = [CatalogApp(app="pp", ranks=2, est_runtime_us=1500.0,
                          weight=1.0, source=PP)]
    return synthetic_trace(
        4, arrival="poisson", mean_gap_us=400.0, seed=0, catalog=catalog,
        slots=2, tick_us=2.0, horizon_ms=50.0, pool_size=256,
        name="store-trace")


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def test_scenario_fingerprint_stable_and_sensitive():
    exp = tiny_experiment()
    fp0 = fp(exp)
    assert fp0 == fp(tiny_experiment())  # stable across re-planning
    assert fp0 != fp(exp, 1)  # member cells differ (seed + ordinal)
    for changed in (
        tiny_experiment(seeds=[7, 8]),
        tiny_experiment(probes=4),
        tiny_experiment(hist=8),
        tiny_experiment(strict=True),
        tiny_experiment(arrival_jitter_us=5.0),
    ):
        assert fp(changed) != fp0, changed
    # pure execution strategy does not split it
    assert fp(tiny_experiment(vmapped=False)) == fp0


def test_failure_axis_fingerprints():
    fp_plain = fp(tiny_experiment())
    axis = tiny_experiment(
        grid=union.StudyGrid(failures=["healthy", "links:0.05"]))
    by = {c.failure_name: c for c in scenario_cells(axis) if c.member == 0}
    assert STO.scenario_fingerprint(axis, by["healthy"], "cpu") == fp_plain
    fp_deg = STO.scenario_fingerprint(axis, by["links:0.05"], "cpu")
    assert fp_deg != fp_plain
    assert fp(tiny_experiment(
        grid=union.StudyGrid(failures=["links:0.1"]))) != fp_deg


def test_versions_name_torch_and_the_device_type():
    """The port's version block names torch, its CUDA and the device type
    in place of JAX's version and backend: the two packages never replay
    each other's cells, and a CPU run never replays a card run."""
    v = STO.code_versions("cpu")
    assert v == dict(store=STO.STORE_VERSION, results_schema=4,
                     torch=torch.__version__, cuda=torch.version.cuda,
                     device="cpu")
    assert STO.code_versions()["device"] == "cuda"  # naming it needs no card
    assert STO.code_versions(torch.device("cuda", 0))["device"] == "cuda"
    assert set(v) != set(REF_STO.code_versions())
    assert {"jax", "backend"} <= set(REF_STO.code_versions())

    exp = tiny_experiment()
    ref_exp = REF.Experiment.from_dict(exp.to_dict())
    ref_cells = [c for n in REF_PLN.plan(ref_exp).nodes for c in n.cells]
    for i in range(2):
        ours = {fp(exp, i, d) for d in ("cpu", "cuda")}
        assert len(ours) == 2
        assert REF_STO.scenario_fingerprint(ref_exp, ref_cells[i]) not in ours
    # trace cells too
    tr = store_trace()
    texp = union.Experiment(name="t", trace=union.TraceStudy(
        trace=tr, policies=["easy"]))
    tcell = PLN.plan(texp).nodes[0].cells[0]
    ref_texp = REF.Experiment.from_dict(texp.to_dict())
    ref_tcell = REF_PLN.plan(ref_texp).nodes[0].cells[0]
    ours = {STO.trace_fingerprint(texp, texp.trace, tr, tcell, d)
            for d in ("cpu", "cuda")}
    assert len(ours) == 2
    assert REF_STO.trace_fingerprint(
        ref_texp, ref_texp.trace, ref_texp.trace.trace, ref_tcell) not in ours


def test_store_roundtrip_and_corruption(tmp_path):
    store = STO.ExperimentStore(str(tmp_path))
    cell = union.CellResult(
        kind="scenario", name="x", seed=3, placement="RN", routing="ADP",
        report={"virtual_time_ms": 1.0, "latency": {"a": {"count": 2}}})
    key = "ab" + "0" * 62
    assert store.get(key) is None
    path = store.put(key, cell)
    got = store.get(key)
    assert got is not None and got.to_dict() == cell.to_dict()
    assert store.stats()["entries"] == 1
    with open(path, "w") as f:
        f.write("{not json")
    assert store.get(key) is None  # corrupt entries read as misses
    store.put(key, cell)
    with open(path) as f:
        entry = json.load(f)
    entry["store_version"] = STO.STORE_VERSION + 1
    with open(path, "w") as f:
        json.dump(entry, f)
    assert store.get(key) is None  # so do version-mismatched ones


# ---------------------------------------------------------------------------
# the facade with a store
# ---------------------------------------------------------------------------

def test_rerun_identical_experiment_executes_zero_cells(tmp_path):
    store = str(tmp_path / "store")
    r1 = run_cpu(tiny_experiment(), store=store)
    assert r1.telemetry["store"]["hits"] == 0
    assert r1.telemetry["store"]["misses"] == 2
    r2 = run_cpu(tiny_experiment(), store=store)
    assert r2.telemetry["store"] == dict(
        hits=2, misses=0, dir=os.path.abspath(store))
    assert r2.telemetry["node_kinds"]["batched"]["cells"] == 2
    assert [c.to_dict() for c in r1.cells] == [c.to_dict() for c in r2.cells]


def test_changed_grid_cell_reexecutes_only_that_cell(tmp_path):
    store = str(tmp_path / "store")
    run_cpu(tiny_experiment(seeds=[0, 1]), store=store)
    res = run_cpu(tiny_experiment(seeds=[0, 2]), store=store)
    assert res.telemetry["store"] == dict(
        hits=1, misses=1, dir=os.path.abspath(store))
    res3 = run_cpu(tiny_experiment(seeds=[0, 2]), store=store)
    assert res3.telemetry["store"]["misses"] == 0
    # a failure coordinate added to the grid executes only its cells
    res4 = run_cpu(tiny_experiment(
        seeds=[0, 2], grid=union.StudyGrid(failures=["healthy",
                                                     "links:0.05"])),
        store=store)
    assert res4.telemetry["store"]["hits"] == 2
    assert res4.telemetry["store"]["misses"] == 2


def test_trace_cells_hit_the_store(tmp_path):
    trace = store_trace()
    store = str(tmp_path / "store")

    def exp(policies=("fcfs", "easy")):
        return union.Experiment(
            name="store-tr",
            trace=union.TraceStudy(trace=trace, policies=list(policies)))

    r1 = run_cpu(exp(), store=store)
    assert r1.telemetry["store"]["misses"] == 2
    r2 = run_cpu(exp(), store=store)
    assert r2.telemetry["store"] == dict(
        hits=2, misses=0, dir=os.path.abspath(store))
    assert [c.to_dict() for c in r1.cells] == [c.to_dict() for c in r2.cells]
    r3 = run_cpu(exp(("fcfs", "conservative")), store=store)
    assert r3.telemetry["store"]["hits"] == 1
    assert r3.telemetry["store"]["misses"] == 1


def test_run_cancelled_between_nodes(tmp_path):
    calls = []

    def cancel():
        calls.append(True)
        return len(calls) > 1  # let node 1 run, stop before node 2

    exp = tiny_experiment(grid=union.StudyGrid(routing=["MIN", "ADP"]))
    assert len(PLN.plan(exp).nodes) == 2
    store = str(tmp_path / "store")
    with pytest.raises(union.RunCancelled) as ei:
        run_cpu(exp, store=store, cancel=cancel)
    assert ei.value.done == 2 and ei.value.total == 4
    res = run_cpu(exp, store=store)
    assert res.telemetry["store"]["hits"] == 2
    assert res.telemetry["store"]["misses"] == 2


def test_store_gc_size_and_age_caps(tmp_path):
    store = STO.ExperimentStore(str(tmp_path))
    cell = union.CellResult(
        kind="scenario", name="x", seed=0, placement="RN", routing="ADP",
        report={"virtual_time_ms": 1.0})
    paths = []
    for i in range(6):
        paths.append(store.put(f"{i:02d}" + "e" * 62, cell))
        os.utime(paths[-1], (1000.0 + i, 1000.0 + i))
    tmp_junk = os.path.join(store.cells_dir, "00", "crashed.tmp")
    with open(tmp_junk, "w") as f:
        f.write("partial write")
    sz = os.path.getsize(paths[0])

    out = store.gc(max_age_s=10.0)
    assert not os.path.exists(tmp_junk)  # .tmp always swept
    assert out["entries"] == 0 and out["removed"] == 7
    assert out["freed_bytes"] > 6 * sz

    paths = []
    for i in range(6):
        paths.append(store.put(f"{i:02d}" + "f" * 62, cell))
        os.utime(paths[-1], (2000.0 + i, 2000.0 + i))
    out = STO.store_gc(str(tmp_path), max_bytes=3 * sz)
    assert out["entries"] == 3 and out["bytes"] <= 3 * sz
    assert [os.path.exists(p) for p in paths] == [False] * 3 + [True] * 3
    out = store.gc()
    assert out["entries"] == 3 and out["removed"] == 0
