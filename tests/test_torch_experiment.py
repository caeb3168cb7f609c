"""The port's experiment facade against the JAX package's.

``repro_torch.union.run(..., device="cpu")`` (the engine's CPU path)
against the JAX facade and its goldens:

* the ``scenario``, ``ragged`` and ``trace`` parts of
  ``tests/data_experiment_golden.json`` with the exact comparisons of
  ``tests/test_experiment.py:87-146``;
* ``examples/experiments/smoke.json`` loaded and run by both packages:
  the same cells in the same order, reports equal (the golden's pinned
  fields exactly, other floats to rtol 1e-5: ``tests/torch_parity.py``).
  ``failures.json`` is in ``tests/test_torch_experiment_failures.py``;
* a batched trace grid against the same cells run sequentially;
* ``fabrics.json`` loaded and planned as the JAX package does;
* grid expansion and ``Plan.describe`` equal to the JAX planner's;
* ``SpecError`` paths, the Results round trip and the v3 upgrade;
* ``run_scenario``'s report against the one-member facade cell;
* the engine cache shared by the scenario and trace paths.
"""
import json
import os

import pytest
import torch

from repro import union as REF
from repro.union import planner as REF_PLN
from repro_torch import union
from repro_torch.netsim import engine as ENG
from repro_torch.sched.trace import CatalogApp, Trace, TraceJob, synthetic_trace
from repro_torch.union import manager as MGR
from repro_torch.union import planner as PLN
from repro_torch.union.scenario import Scenario, ScenarioJob
from test_experiment import PP, AR
from torch_parity import assert_cells_match

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "data_experiment_golden.json")
V3_FIXTURE = os.path.join(HERE, "data_results_v3.json")
EXAMPLES = os.path.join(HERE, "..", "examples", "experiments")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def tiny_scenario():
    return Scenario(
        name="tiny",
        jobs=[
            ScenarioJob(app="pp0", source=PP, ranks=2),
            ScenarioJob(app="pp1", source=PP, ranks=2, start_us=200.0),
        ],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256,
    )


def sc_a():
    return Scenario(
        name="a", jobs=[ScenarioJob(app="pp0", source=PP, ranks=2)],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256)


def sc_b():
    return Scenario(
        name="b",
        jobs=[ScenarioJob(app="ar8", source=AR, ranks=8),
              ScenarioJob(app="pp1", source=PP, ranks=2, start_us=100.0)],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256)


def catalog():
    return [
        CatalogApp(app="pp", ranks=2, est_runtime_us=1500.0, weight=2.0,
                   source=PP.replace("1024", "2048")),
        CatalogApp(app="ar", ranks=8, est_runtime_us=4000.0, weight=1.0,
                   source=AR),
    ]


def golden_trace():
    """``tests/test_experiment.py``'s golden trace, drawn by the port."""
    return synthetic_trace(
        8, arrival="poisson", mean_gap_us=400.0, seed=0, catalog=catalog(),
        slots=3, tick_us=5.0, horizon_ms=60_000.0, pool_size=1024,
        name="golden-trace")


def small_trace_factory(seed):
    """Fresh 6-job draws per seed: every member's job stream (and
    capacity envelope) differs."""
    return synthetic_trace(
        6, arrival="poisson", mean_gap_us=400.0, seed=seed,
        catalog=catalog(), slots=3, tick_us=5.0, horizon_ms=60_000.0,
        pool_size=1024, name=f"grid-{seed}")


def run_cpu(exp, **kw):
    return union.run(exp, device="cpu", **kw)


def assert_member_matches(rep, g):
    """One port facade member report against its golden digest — bit
    for bit (``tests/test_experiment.py``'s comparison)."""
    assert rep["virtual_time_ms"] == g["virtual_time_ms"]
    assert rep["dropped"] == g["dropped"]
    assert rep["config"]["envelope"] == g["envelope"]
    assert [float(s) for s in rep["config"]["start_us"]] == g["start_us"]
    for app, ga in g["apps"].items():
        assert rep["latency"][app]["count"] == ga["count"]
        assert rep["latency"][app]["avg_us"] == ga["avg_us"]
        assert rep["latency"][app]["max_us"] == ga["max_us"]
        assert rep["comm_time"][app]["max_ms"] == ga["max_comm_ms"]
        assert rep["comm_time"][app]["avg_ms"] == ga["avg_comm_ms"]


# ---------------------------------------------------------------------------
# the experiment golden
# ---------------------------------------------------------------------------

def test_scenario_campaign_matches_golden(golden):
    res = run_cpu(union.Experiment(
        name="tiny", scenarios=[tiny_scenario()], members=2))
    assert len(res.cells) == 2
    for cell, g in zip(res.cells, golden["scenario"]["members"]):
        assert cell.kind == "scenario" and cell.placement == "RN"
        assert_member_matches(cell.report, g)


def test_ragged_campaign_matches_golden(golden):
    res = run_cpu(union.Experiment(
        name="rag", scenarios=[sc_a(), sc_b()], members=1, seeds=[0, 1]))
    assert [c.name for c in res.cells] == ["a", "b"]
    assert len(PLN.plan(union.Experiment(
        name="rag", scenarios=[sc_a(), sc_b()], members=1,
        seeds=[0, 1])).nodes) == golden["ragged"]["buckets"]
    for cell, g in zip(res.cells, golden["ragged"]["members"]):
        assert_member_matches(cell.report, g)


def test_trace_study_matches_golden(golden):
    res = run_cpu(union.Experiment(
        name="tr",
        trace=union.TraceStudy(trace=golden_trace(),
                               policies=["fcfs", "easy"], seeds=1)))
    assert [c.policy for c in res.cells] == ["fcfs", "easy"]
    for cell in res.cells:
        g = golden["trace"]["policies"][cell.policy]
        assert cell.kind == "trace"
        assert cell.report["windows"] == g["windows"]
        assert cell.report["makespan_ms"] == g["makespan_us"] / 1000.0
        assert cell.report["utilization"] == g["utilization"]
        assert len(cell.report["per_job"]) == len(g["jobs"])
        for row, gj in zip(cell.report["per_job"], g["jobs"]):
            assert row["name"] == gj["name"]
            assert row["completed"] == gj["completed"]
            assert row["start_us"] == gj["start_us"]
            assert row["finish_us"] == gj["finish_us"]
            assert row["msgs"] == gj["msgs"]
            assert row["avg_latency_us"] == gj["avg_latency_us"]


# ---------------------------------------------------------------------------
# one spec file, both packages
# ---------------------------------------------------------------------------

def test_smoke_spec_matches_jax_facade():
    """``smoke.json`` (a two-member scenario study and an inline trace
    under FCFS and EASY) loaded and run by both packages."""
    path = os.path.join(EXAMPLES, "smoke.json")
    want = REF.run(REF.load_experiment(path))
    exp = union.load_experiment(path)
    assert exp.to_dict() == REF.load_experiment(path).to_dict()
    got = run_cpu(exp)
    assert len(got.cells) == 4
    assert_cells_match(got.cells, want.cells)
    assert got.experiment == want.experiment
    # the port's telemetry adds its engine calls per node kind
    assert set(got.telemetry) == set(want.telemetry) | {"engine"}
    kinds = want.telemetry["node_kinds"].keys()
    assert got.telemetry["node_kinds"].keys() == kinds
    assert got.telemetry["engine"].keys() == kinds
    for tot in got.telemetry["engine"].values():
        # the CPU path ticks eagerly: no graph, no counted launch
        assert tot["calls"] > 0 and tot["ticks"] > 0
        assert tot["replays"] == tot["captures"] == 0
        assert tot["launches"] == {}


def test_batched_trace_grid_matches_sequential():
    """A (3 seeds × 3 policies) TraceStudy through the lock-step
    ``windowed_batch`` node equals, cell by cell, the sequential
    ``windowed`` node (``batch=False``): window counts, per-job starts,
    finishes and message metrics."""

    def study(batch):
        return union.Experiment(
            name=f"grid-{batch}",
            trace=union.TraceStudy(
                factory=small_trace_factory, slots=3,
                policies=["fcfs", "easy", "conservative"],
                seeds=[0, 1, 2], batch=batch))

    plan_b = PLN.plan(study(True))
    assert len(plan_b.windowed_batch_nodes) == 1
    assert "batched scheduler × 9 trace cells" in plan_b.describe()
    plan_s = PLN.plan(study(False))
    assert plan_s.windowed_batch_nodes == []
    assert len(plan_s.windowed_nodes[0].cells) == 9

    res_b = run_cpu(study(True))
    res_s = run_cpu(study(False))
    assert res_b.telemetry["node_kinds"].keys() == {"windowed_batch"}
    assert res_s.telemetry["node_kinds"].keys() == {"windowed"}
    assert len(res_b.cells) == len(res_s.cells) == 9
    for cb, cs in zip(res_b.cells, res_s.cells):
        assert (cb.seed, cb.policy, cb.name) == (cs.seed, cs.policy, cs.name)
        rb = {k: v for k, v in cb.report.items()
              if k not in ("wall_s", "jobs_per_sec")}
        rs = {k: v for k, v in cs.report.items()
              if k not in ("wall_s", "jobs_per_sec")}
        assert rb == rs, f"cell {cb.seed}/{cb.policy} diverged"
    assert sum(c.report["completed"] for c in res_b.cells) > 0


def test_fabrics_spec_accepted_as_reference():
    """``fabrics.json`` sweeps 1d, fat_tree and torus: both packages load
    it to the same spec and plan it to the same nodes (one engine bucket a
    fabric); an Experiment built in code and a trace study naming each
    fabric validate in both. The cells are run against the JAX facade in
    ``tests/test_torch_fabric_engine.py``."""
    path = os.path.join(EXAMPLES, "fabrics.json")
    exp = union.load_experiment(path)
    ref = REF.load_experiment(path)
    assert exp.grid.fabrics == ref.grid.fabrics == ["1d", "fat_tree", "torus"]
    assert exp.to_dict() == ref.to_dict()
    got, want = PLN.plan(exp), REF_PLN.plan(ref)
    assert got.describe() == want.describe()
    assert len(got.batched_nodes) == 3
    assert [c.scenario.topo for n in got.batched_nodes for c in n.cells] == \
        [c.scenario.topo for n in want.batched_nodes for c in n.cells]
    for fabric in ("fat_tree", "torus"):
        exp = union.Experiment(
            name="f", scenarios=[tiny_scenario()],
            grid=union.StudyGrid(fabrics=["1d", fabric]))
        assert PLN.plan(exp).describe() == \
            REF_PLN.plan(_ref_experiment(exp)).describe()
        union.TraceStudy(source="poisson", topo=fabric).validate()
        REF.TraceStudy(source="poisson", topo=fabric).validate()


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def _ref_experiment(exp):
    return REF.Experiment.from_dict(exp.to_dict())


def test_grid_expansion_and_describe_match_jax_planner():
    """Placements × routing × failures × members, plus a jittered second
    scenario and a trace study: the port's plan has the JAX plan's nodes,
    cells, seeds, arrival schedules, envelopes and ``describe()`` text."""
    import numpy as np

    exp = union.Experiment(
        name="g", scenarios=[tiny_scenario(), sc_b()], members=2,
        base_seed=3, arrival_jitter_us=25.0,
        grid=union.StudyGrid(placements=["RN", "RG"], routing=["MIN", "ADP"],
                             failures=["healthy", "links:0.05"]),
        trace=union.TraceStudy(source="poisson", jobs=4, seeds=2,
                               policies=["fcfs", "easy"]))
    got, want = PLN.plan(exp), REF_PLN.plan(_ref_experiment(exp))
    assert got.describe() == want.describe()
    assert got.describe().startswith("plan for experiment 'g'")
    assert got.total_cells == want.total_cells == 2 * 4 * 2 * 2 + 2 * 2 * 2
    assert [n.kind for n in got.nodes] == [n.kind for n in want.nodes]
    for gn, wn in zip(got.nodes, want.nodes):
        assert len(gn.cells) == len(wn.cells)
        if gn.kind == "batched":
            assert vars(gn.capacity) == vars(wn.capacity)
            for gc, wc in zip(gn.cells, wn.cells):
                assert (gc.index, gc.seed, gc.member, gc.failure_name) == \
                    (wc.index, wc.seed, wc.member, wc.failure_name)
                assert gc.scenario.to_dict() == wc.scenario.to_dict()
                assert np.asarray(gc.start_us).tobytes() == \
                    np.asarray(wc.start_us).tobytes()
                for gp, wp in zip(gc.rs.placements(gc.seed),
                                  wc.rs.placements(wc.seed)):
                    np.testing.assert_array_equal(gp, wp)
        else:
            assert [(c.index, c.seed, c.policy, c.failure_name)
                    for c in gn.cells] == [
                (c.index, c.seed, c.policy, c.failure_name)
                for c in wn.cells]
    # four placement × routing variants; routing splits engine buckets
    cells = [c for n in got.batched_nodes for c in n.cells]
    assert {c.scenario.placement for c in cells} == {"RN", "RG"}
    assert len(got.batched_nodes) == 2


def test_grid_results_grouped_by_coordinates():
    res = run_cpu(union.Experiment(
        name="g", scenarios=[tiny_scenario()], members=1,
        grid=union.StudyGrid(placements=["RN", "RG"])))
    assert set(res.summary["scenario_studies"]) == {
        "tiny/1d/RN/ADP", "tiny/1d/RG/ADP"}
    rows = res.records()
    assert {r["placement"] for r in rows} == {"RN", "RG"}
    assert all(r["kind"] == "scenario" for r in rows)
    assert "experiment: g — 2 cells" in union.format_results(res)


# ---------------------------------------------------------------------------
# strict spec validation: offending paths in every message
# ---------------------------------------------------------------------------

def test_unknown_keys_raise_with_path():
    with pytest.raises(union.SpecError, match=r"experiment\.scenarios\[0\]"):
        union.Experiment.from_dict({
            "name": "e", "scenarios": [{"name": "s", "jbos": []}]})
    with pytest.raises(union.SpecError, match=r"experiment\.trace"):
        union.Experiment.from_dict({
            "name": "e", "trace": {"source": "poisson", "polcies": []}})
    with pytest.raises(union.SpecError, match=r"experiment\.grid"):
        union.Experiment.from_dict({
            "name": "e", "scenarios": [{"name": "s", "jobs": [{"app": "nn"}]}],
            "grid": {"placement": ["RN"]}})
    with pytest.raises(union.SpecError,
                       match="unknown experiment keys at experiment"):
        union.Experiment.from_dict({
            "name": "e", "scenarios": [{"name": "s", "jobs": [{"app": "nn"}]}],
            "member": 2})
    with pytest.raises(union.SpecError, match=r"trace\.jobs\[0\]"):
        Trace.from_dict({
            "name": "t",
            "jobs": [{"name": "j", "app": "nn", "arrive_us": 0.0}]})


def test_out_of_range_values_raise_with_path():
    nn = {"name": "s", "jobs": [{"app": "nn"}]}
    with pytest.raises(union.SpecError, match="experiment: experiment needs"):
        union.Experiment.from_dict({"name": "empty"})
    with pytest.raises(union.SpecError, match=r"experiment\.trace.*policy"):
        union.Experiment.from_dict({
            "name": "e", "trace": {"source": "poisson",
                                   "policies": ["sjf"]}})
    with pytest.raises(union.SpecError, match="members >= 1"):
        union.Experiment.from_dict({"name": "e", "scenarios": [nn],
                                    "members": 0})
    with pytest.raises(union.SpecError, match="arrival_jitter_us"):
        union.Experiment.from_dict({"name": "e", "scenarios": [nn],
                                    "arrival_jitter_us": -1.0})
    with pytest.raises(union.SpecError, match=r"experiment\.grid.*routing"):
        union.Experiment.from_dict({"name": "e", "scenarios": [nn],
                                    "grid": {"routing": ["UGAL"]}})
    with pytest.raises(union.SpecError, match="hist must be 0"):
        union.Experiment.from_dict({"name": "e", "scenarios": [nn],
                                    "hist": 1})
    with pytest.raises(union.SpecError, match=r"experiment\.trace.*callable"):
        union.Experiment.from_dict({
            "name": "e", "trace": {"factory": "<callable>",
                                   "policies": ["fcfs"]}})
    # the JAX package refuses the same specs with the same paths
    with pytest.raises(ValueError, match="members >= 1"):
        REF.Experiment.from_dict({"name": "e", "scenarios": [nn],
                                  "members": 0})


def test_spec_files_load_alike_and_resolve_relative(tmp_path):
    """A spec naming sibling scenario and trace files loads in both
    packages to the same dict, its references resolved against the
    spec's directory; and it survives a JSON round trip."""
    tiny_scenario().to_json(str(tmp_path / "mix.json"))
    golden_trace().to_json(str(tmp_path / "stream.json"))
    spec = dict(name="rel", scenarios=["mix.json"], members=3, base_seed=5,
                grid=dict(placements=["RN", "RG"]),
                trace=dict(source="stream.json", policies=["fcfs"]))
    path = str(tmp_path / "exp.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    exp = union.Experiment.from_json(path)
    assert exp.scenarios[0] == tiny_scenario()
    assert exp.trace.trace_for(0).name == "golden-trace"
    assert exp.to_dict() == REF.Experiment.from_json(path).to_dict()
    exp.to_json(str(tmp_path / "again.json"))
    again = union.load_experiment(str(tmp_path / "again.json"))
    assert again.to_dict() == exp.to_dict()


# ---------------------------------------------------------------------------
# the Results artifact
# ---------------------------------------------------------------------------

def test_results_roundtrip_and_v3_upgrade(tmp_path):
    res = run_cpu(union.Experiment(name="rt", scenarios=[sc_a()], members=2))
    assert res.schema_version == union.experiment.SCHEMA_VERSION == 4
    path = str(tmp_path / "results.json")
    res.save(path)
    loaded = union.Results.load(path)
    a = json.dumps(res.to_dict(), sort_keys=True, default=float)
    b = json.dumps(loaded.to_dict(), sort_keys=True, default=float)
    assert a == b
    assert loaded.records() == res.records()
    # the JAX package reads the port's artifact (one schema)
    assert json.dumps(REF.Results.load(path).to_dict(), sort_keys=True,
                      default=float) == a
    bad = json.loads(a)
    bad["schema_version"] = 99
    with pytest.raises(ValueError, match="schema_version"):
        union.Results.from_dict(bad)

    v3 = union.Results.load(V3_FIXTURE)
    assert v3.schema_version == 4 and v3.telemetry["upgraded_from"] == 3
    assert v3.telemetry["hist"] == {} and v3.telemetry["timeline"] is False
    assert v3.cells[1].report["latency"]["pp0"]["avg_us"] == 3.3
    assert v3.to_dict() == REF.Results.load(V3_FIXTURE).to_dict()
    v3.save(str(tmp_path / "up.json"))
    assert union.Results.load(str(tmp_path / "up.json")).to_dict() == \
        v3.to_dict()


# ---------------------------------------------------------------------------
# the direct run and the facade
# ---------------------------------------------------------------------------

def test_run_scenario_equals_one_member_facade_cell(golden):
    """``run_scenario`` (deprecated: it warns) stays a direct run in the
    port; its report equals the facade's one-member cell on every key the
    golden pins."""
    with pytest.warns(DeprecationWarning, match="run_scenario"):
        direct = MGR.run_scenario(tiny_scenario(), seed=0, device="cpu")
    res = run_cpu(union.Experiment(name="tiny", scenarios=[tiny_scenario()],
                                   members=1, base_seed=0, vmapped=False))
    cell = res.cells[0].report
    g = golden["scenario"]["members"][0]
    assert_member_matches(direct, g)
    assert_member_matches(cell, g)
    for key in ("virtual_time_ms", "dropped", "latency", "comm_time",
                "config"):
        assert direct[key] == cell[key], key


def test_engine_cache_shared_across_scenario_and_trace_paths():
    """A scenario study and a trace study shaped to one envelope and
    system config share one engine of the process-wide cache."""
    pp = PP.replace("1024", "3333")
    sc = Scenario(
        name="cache-sc",
        jobs=[ScenarioJob(app="j0", source=pp, ranks=2),
              ScenarioJob(app="j1", source=pp, ranks=2)],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=257)
    trace = Trace(
        name="cache-tr", slots=2, placement="RN", routing="ADP",
        tick_us=2.0, horizon_ms=50.0, pool_size=257,
        jobs=[
            TraceJob(name="t0", app="j0", ranks=2, arrival_us=0.0,
                     est_runtime_us=500.0, source=pp),
            TraceJob(name="t1", app="j1", ranks=2, arrival_us=50.0,
                     est_runtime_us=500.0, source=pp),
        ],
    )
    res1 = run_cpu(union.Experiment(name="warmup", scenarios=[sc],
                                    members=1))
    assert res1.engine_cache == {"hits": 0, "misses": 1, "builds": 1}
    res2 = run_cpu(union.Experiment(
        name="mixed", scenarios=[sc], members=2,
        trace=union.TraceStudy(trace=trace, policies=["easy"], seeds=1)))
    assert res2.engine_cache == {"hits": 2, "misses": 0, "builds": 0}
    assert len(res2.cells) == 3
    tel = res2.telemetry["engine_cache"]
    assert tel["hits"] == 2 and tel["builds"] == 0 and tel["size"] >= 1
