"""The port's deprecated front doors against the JAX package's, on the CPU.

* The ensemble shims (``run_campaign``, ``run_ragged_campaign``,
  ``run_sched_campaign``, ``build_campaign_engine``) and the direct runs
  (``run_scenario``, ``sched.run_trace``) warn with a
  ``DeprecationWarning`` naming themselves and reproduce
  ``tests/data_experiment_golden.json`` exactly
  (``tests/test_experiment.py``'s deprecation cases); ``launch.sim.run_sim``
  does not warn, as the JAX package's does not.
* The campaign cases of ``tests/test_union.py`` on the port: members of a
  batched campaign equal their runs alone, placements differ across
  members, the interference summary and matrix, ragged campaigns in one
  bucket and in two; each campaign's reports also equal the JAX
  package's campaign on the same inputs (``torch_parity``).
* A factory-built trace study through ``run_sched_campaign`` and the
  facade (``tests/test_experiment.py``'s factory case).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro import union as REF
from repro.union import ensemble as REF_ENS
from repro_torch import union
from repro_torch.netsim.engine import EngineCapacity
from repro_torch.sched import scheduler as S
from repro_torch.union import ensemble as ENS
from repro_torch.union import manager as MGR
from repro_torch.union.report import interference_matrix, interference_summary
from repro_torch.union.scenario import Scenario, ScenarioJob
from test_torch_experiment import (
    assert_member_matches,
    golden_trace,
    sc_a,
    sc_b,
    tiny_scenario,
)
from torch_parity import report_mismatches

HERE = os.path.dirname(__file__)
PP = ("For 4 repetitions {\n"
      " task 0 sends a 1024 byte message to task 1 then\n"
      " task 1 sends a 1024 byte message to task 0 }")
AR_RAGGED = ("For 2 repetitions {\n"
             " all tasks allreduce a 65536 byte message then\n"
             " all tasks compute for 100 microseconds }")


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
    with open(os.path.join(HERE, "data_experiment_golden.json")) as f:
        return json.load(f)


def quiet(fn, *a, **kw):
    """Call a deprecated door with its warning silenced (the tests that
    check the warning call it under ``pytest.warns``)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


def sched_tiny(start_us=0.0, placement="RN"):
    return Scenario(
        name="tiny",
        jobs=[ScenarioJob(app="pp0", source=PP, ranks=2),
              ScenarioJob(app="pp1", source=PP, ranks=2, start_us=start_us)],
        placement=placement, tick_us=2.0, horizon_ms=50.0, pool_size=256)


def ref_of(sc):
    from repro.union.scenario import Scenario as RefScenario

    return RefScenario.from_dict(sc.to_dict())


def assert_reports_match(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        bad = report_mismatches(g, w, f"member {i}")
        assert not bad, bad[:10]


# ---------------------------------------------------------------------------
# deprecation shims: old doors still work, warn, and match the golden
# ---------------------------------------------------------------------------

def test_old_entry_points_warn_and_match(golden):
    with pytest.warns(DeprecationWarning, match="run_campaign"):
        camp = union.run_campaign(tiny_scenario(), members=2, base_seed=0,
                                  device="cpu")
    for rep, g in zip(camp.reports, golden["scenario"]["members"]):
        assert_member_matches(rep, g)

    with pytest.warns(DeprecationWarning, match="run_scenario"):
        rep = union.run_scenario(tiny_scenario(), seed=0, device="cpu")
    assert_member_matches(rep, golden["scenario"]["members"][0])

    with pytest.warns(DeprecationWarning, match="run_ragged_campaign"):
        rag = union.run_ragged_campaign([sc_a(), sc_b()], seeds=[0, 1],
                                        device="cpu")
    assert rag.summary["ragged"]["buckets"] == 1
    for rep, g in zip(rag.reports, golden["ragged"]["members"]):
        assert_member_matches(rep, g)

    with pytest.warns(DeprecationWarning, match="run_sched_campaign"):
        camp = union.run_sched_campaign(
            golden_trace(), policies=("fcfs",), seeds=(0,), device="cpu")
    row = camp["runs"]["fcfs"][0]
    g = golden["trace"]["policies"]["fcfs"]
    assert row["makespan_ms"] == g["makespan_us"] / 1000.0
    with pytest.raises(ValueError, match=r"experiment\.trace.*policy"):
        union.Experiment.from_dict({
            "name": "e", "trace": {"source": "poisson",
                                   "policies": ["sjf"]}})

    with pytest.warns(DeprecationWarning, match="sched.run_trace"):
        res = S.run_trace(golden_trace(), policy="fcfs", seed=0,
                          device="cpu")
    want = S._run_trace_impl(golden_trace(), policy="fcfs", seed=0,
                             device="cpu")
    assert [(r.jid, r.start_us, r.finish_us, r.msgs, r.avg_latency_us)
            for r in res.records] == \
        [(r.jid, r.start_us, r.finish_us, r.msgs, r.avg_latency_us)
         for r in want.records]
    assert (res.makespan_us, res.windows) == (want.makespan_us, want.windows)


def test_run_sim_does_not_warn_and_equals_the_facade_cell():
    from repro_torch.launch.sim import run_sim

    kw = dict(scale="small", horizon_ms=2.0, tick_us=5.0, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        rep = run_sim("baseline-nn", "1d", "RG", "ADP", device="cpu", **kw)
    assert rep["engine_run"]["ticks"] > 0
    sc = union.mix_scenario("baseline-nn", topo="1d", scale="small",
                            placement="RG", routing="ADP", tick_us=5.0,
                            horizon_ms=2.0)
    cell = union.run(union.Experiment(
        name=sc.name, scenarios=[sc], members=1, base_seed=1,
        vmapped=False), device="cpu").cells[0].report
    rep.pop("engine_run")
    assert not report_mismatches(rep, cell)


def test_campaign_engine_widens_the_envelope_as_reference():
    """A prebuilt CampaignEngine contributes its widened envelope: every
    member runs and reports under it, as in the JAX package."""
    cap = EngineCapacity(Jmax=3, Pmax=8, OPmax=64)
    eng = ENS.build_campaign_engine(sched_tiny(), capacity=cap, device="cpu")
    assert eng.capacity == cap.union(eng.rs.capacity)
    got = quiet(ENS.run_campaign, sched_tiny(), members=2, engine=eng,
                device="cpu")
    from repro.netsim.engine import EngineCapacity as RefCapacity

    ref_eng = REF_ENS.build_campaign_engine(
        ref_of(sched_tiny()), capacity=RefCapacity(Jmax=3, Pmax=8, OPmax=64))
    want = quiet(REF_ENS.run_campaign, ref_of(sched_tiny()), members=2,
                 engine=ref_eng)
    assert got.reports[0]["config"]["envelope"] == dict(
        Jmax=eng.capacity.Jmax, Pmax=eng.capacity.Pmax,
        OPmax=eng.capacity.OPmax)
    assert_reports_match(got.reports, want.reports)


# ---------------------------------------------------------------------------
# tests/test_union.py's campaign cases on the port
# ---------------------------------------------------------------------------

def test_batched_member_matches_sequential_run():
    sc = sched_tiny(start_us=200.0)
    camp = quiet(ENS.run_campaign, sc, members=3, base_seed=0, vmapped=True,
                 device="cpu")
    assert camp.summary["all_done"] and camp.summary["dropped_total"] == 0
    for i, rep in enumerate(camp.reports):
        seq = quiet(MGR.run_scenario, sc, seed=i, device="cpu")
        assert rep["virtual_time_ms"] == seq["virtual_time_ms"]
        for app in ("pp0", "pp1"):
            assert rep["latency"][app]["count"] == \
                seq["latency"][app]["count"]
            np.testing.assert_allclose(
                rep["latency"][app]["avg_us"],
                seq["latency"][app]["avg_us"], rtol=1e-6)
            np.testing.assert_allclose(
                rep["comm_time"][app]["max_ms"],
                seq["comm_time"][app]["max_ms"], rtol=1e-6)
    want = quiet(REF.run_campaign, ref_of(sc), members=3, base_seed=0)
    assert_reports_match(camp.reports, want.reports)
    bad = report_mismatches(camp.summary, want.summary, "summary")
    assert not [b for b in bad if "members_per_sec" not in b], bad


def test_campaign_placements_differ_across_members():
    camp = quiet(ENS.run_campaign, sched_tiny(placement="RN"), members=3,
                 base_seed=0, device="cpu")
    assert camp.summary["apps"]["pp0"]["avg_latency_us"]["rel_spread"] > 0


def _base(placement, name="b"):
    return Scenario(name=name,
                    jobs=[ScenarioJob(app="pp0", source=PP, ranks=2)],
                    placement=placement, tick_us=2.0, horizon_ms=50.0,
                    pool_size=256)


def test_interference_summary_shape():
    co = quiet(ENS.run_campaign, sched_tiny(), members=2, base_seed=0,
               device="cpu").summary
    base = quiet(ENS.run_campaign, _base("RN"), members=2, base_seed=0,
                 device="cpu").summary
    inf = interference_summary(co, {"pp0": base})
    assert set(inf) == {"pp0"}
    assert inf["pp0"]["latency_inflation"] > 0


def test_interference_matrix_per_app_per_policy():
    def summaries(placement):
        co = quiet(ENS.run_campaign, sched_tiny(placement=placement),
                   members=2, base_seed=0, device="cpu").summary
        base = quiet(ENS.run_campaign, _base(placement, f"b-{placement}"),
                     members=2, base_seed=0, device="cpu").summary
        return co, {"pp0": base}

    co_rn, base_rn = summaries("RN")
    co_rg, base_rg = summaries("RG")
    m = interference_matrix(
        {"RN": co_rn, "RG": co_rg}, {"RN": base_rn, "RG": base_rg})
    assert m["apps"] == ["pp0"] and set(m["policies"]) == {"RN", "RG"}
    assert set(m["matrix"]["pp0"]) == {"RN", "RG"}
    for pol in ("RN", "RG"):
        cell = m["matrix"]["pp0"][pol]
        assert cell["latency_inflation"] > 0
        assert m["comm_time_inflation"]["pp0"][pol] == \
            cell["comm_time_inflation"]
        assert m["latency_variation"]["pp0"][pol] == \
            cell["latency_variation_corun"]


def _ragged_pair(tick_b=2.0):
    a = Scenario(name="a", jobs=[ScenarioJob(app="pp0", source=PP, ranks=2)],
                 placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256)
    b = Scenario(
        name="b",
        jobs=[ScenarioJob(app="ar8", source=AR_RAGGED, ranks=8),
              ScenarioJob(app="pp1", source=PP, ranks=2, start_us=100.0)],
        placement="RN", tick_us=tick_b, horizon_ms=50.0, pool_size=256)
    return a, b


def test_ragged_campaign_members_match_sequential_runs():
    sa, sb = _ragged_pair()
    camp = quiet(ENS.run_ragged_campaign, [sa, sb], seeds=[0, 1],
                 device="cpu")
    assert camp.summary["all_done"] and camp.summary["dropped_total"] == 0
    assert camp.summary["ragged"]["buckets"] == 1
    assert camp.reports[0]["config"]["envelope"] == dict(
        Jmax=2, Pmax=8, OPmax=camp.reports[0]["config"]["envelope"]["OPmax"])
    for i, (sc, seed) in enumerate([(sa, 0), (sb, 1)]):
        seq = quiet(MGR.run_scenario, sc, seed=seed, device="cpu")
        rep = camp.reports[i]
        assert rep["virtual_time_ms"] == seq["virtual_time_ms"]
        assert set(rep["latency"]) == set(seq["latency"])
        for app in seq["latency"]:
            assert rep["latency"][app]["count"] == \
                seq["latency"][app]["count"]
            if seq["latency"][app]["count"]:
                np.testing.assert_allclose(
                    rep["latency"][app]["avg_us"],
                    seq["latency"][app]["avg_us"], rtol=1e-6)
            np.testing.assert_allclose(
                rep["comm_time"][app]["max_ms"],
                seq["comm_time"][app]["max_ms"], rtol=1e-6)
    want = quiet(REF.run_ragged_campaign, [ref_of(sa), ref_of(sb)],
                     seeds=[0, 1])
    assert_reports_match(camp.reports, want.reports)
    assert camp.summary["ragged"] == want.summary["ragged"]


def test_ragged_campaign_buckets_incompatible_configs():
    sa, _ = _ragged_pair()
    sb = Scenario(name="b", jobs=[ScenarioJob(app="pp1", source=PP, ranks=2)],
                  placement="RN", tick_us=4.0, horizon_ms=50.0,
                  pool_size=256)
    camp = quiet(ENS.run_ragged_campaign, [sa, sb], seeds=[0, 0],
                 device="cpu")
    assert camp.summary["ragged"]["buckets"] == 2
    assert camp.summary["all_done"]
    assert [set(r["latency"]) for r in camp.reports] == [{"pp0"}, {"pp1"}]


def test_trace_factory_study_runs_and_serializes():
    with pytest.warns(DeprecationWarning, match="run_sched_campaign"):
        camp = union.run_sched_campaign(
            lambda seed: golden_trace(), policies=("fcfs",), seeds=(0,),
            device="cpu")
    assert camp["runs"]["fcfs"][0]["completed"] == 8
    res = union.run(union.Experiment(
        name="fac", trace=union.TraceStudy(
            factory=lambda seed: golden_trace(), policies=["fcfs"])),
        device="cpu")
    assert res.experiment["trace"]["factory"] == "<callable>"
    with pytest.raises(ValueError, match=r"experiment\.trace.*callable"):
        union.Experiment.from_dict(res.experiment)
