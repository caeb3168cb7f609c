"""The port's engine and facade on the fat-tree and torus fabrics, on the CPU.

* ``equiv-mix`` (``tests/test_engine_equivalence.py``'s mixed scenario:
  staggered arrivals, UR background traffic, adaptive routing, ring
  allreduce and P2P) on ``fat_tree_small`` and ``torus_small``, through
  the JAX engine and the port's CPU engine, under the contract of
  ``tests/test_engine_equivalence.py:98-135`` extended to every leaf of
  the final state (integers exact, floats to rtol 1e-5), and the member
  reports through ``torch_parity.report_mismatches`` (the per-level link
  load ``up``/``down`` and ``x``/``y``/``z`` included);
* ``examples/experiments/fabrics.json`` (1d, fat_tree and torus) through
  both facades, cell for cell;
* the port's counterparts of ``tests/test_fabric.py``'s cross-fabric
  experiment grid and engine-cache anti-collision tests.
"""
import os

import jax
import pytest
import torch

from repro import union as REF
from repro.union import manager as REF_MGR
from repro_torch import union
from repro_torch.netsim.engine import (
    EngineCapacity,
    clear_engine_cache,
    engine_cache_stats,
    get_engine,
)
from repro_torch.netsim.fabric import get_fabric
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario, ScenarioJob
from repro_torch.union.seeds import engine_seed
from test_engine_equivalence import mixed_scenario
from torch_parity import (
    assert_cells_match,
    assert_port_equals_ref,
    report_mismatches,
)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "experiments")
LEVELS = {"fat_tree": ["up", "down"], "torus": ["x", "y", "z"]}
PP = ("For 4 repetitions {\n"
      " task 0 sends a 1024 byte message to task 1 then\n"
      " task 1 sends a 1024 byte message to task 0 }")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fabric", ["fat_tree", "torus"])
def test_equiv_mix_matches_jax_engine(fabric):
    seed = 3
    ref_sc = mixed_scenario()
    ref_sc.topo = fabric
    ref_rs = REF_MGR.resolve(ref_sc, seed=seed)
    ref_eng = REF_MGR.build(ref_rs)
    ref_st = jax.block_until_ready(
        ref_eng.run(ref_eng.init_state(seed=engine_seed(seed))))

    sc = Scenario.from_dict(ref_sc.to_dict())
    rs = MGR.resolve(sc, seed=seed)
    assert rs.topo.route_width == ref_rs.topo.route_width
    eng = MGR.build(rs, device="cpu")
    st = eng.run(eng.init_state(seed=engine_seed(seed)))
    assert_port_equals_ref(st, ref_st)
    assert not bool(st.pool.active.any())  # the run ended with its traffic

    want = REF_MGR.member_report(ref_st, ref_rs, 0.0, seed=seed)
    got = MGR.member_report(st, rs, 0.0, seed=seed)
    assert got["link_load"]["levels"] == LEVELS[fabric]
    bad = report_mismatches(got, want)
    assert not bad, bad[:10]


def test_fabrics_spec_matches_jax_facade():
    """``fabrics.json`` sweeps 1d, fat_tree and torus: both packages load
    it alike and run it to the same cells."""
    path = os.path.join(EXAMPLES, "fabrics.json")
    exp = union.load_experiment(path)
    assert exp.to_dict() == REF.load_experiment(path).to_dict()
    want = REF.run(REF.load_experiment(path))
    got = union.run(exp, device="cpu")
    assert len(got.cells) == 6
    assert {c.fabric for c in got.cells} == {"1d", "fat_tree", "torus"}
    assert_cells_match(got.cells, want.cells)
    assert set(got.summary["scenario_studies"]) == \
        set(want.summary["scenario_studies"])


def test_cross_fabric_experiment_grid():
    """One job mix, three fabrics, one experiment: per-fabric latency and
    comm-time summaries in a single Results artifact
    (``tests/test_fabric.py``'s acceptance scenario on the port)."""
    sc = Scenario(
        name="xfab",
        jobs=[ScenarioJob(app="pp0", source=PP, ranks=2),
              ScenarioJob(app="pp1", source=PP, ranks=2, start_us=200.0)],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256)
    res = union.run(union.Experiment(
        name="xfab", scenarios=[sc], members=2,
        grid=union.StudyGrid(fabrics=["1d", "fat_tree", "torus"])),
        device="cpu")
    assert len(res.cells) == 6
    assert {c.fabric for c in res.cells} == {"1d", "fat_tree", "torus"}
    keys = set(res.summary["scenario_studies"])
    assert keys == {"xfab/1d/RN/ADP", "xfab/fat_tree/RN/ADP",
                    "xfab/torus/RN/ADP"}
    for summary in res.summary["scenario_studies"].values():
        assert summary["all_done"] and summary["dropped_total"] == 0
        assert summary["apps"]["pp0"]["avg_latency_us"]["mean"] > 0
        assert summary["apps"]["pp0"]["max_comm_ms"]["mean"] >= 0
    levels = {c.fabric: c.report["link_load"]["levels"] for c in res.cells}
    assert levels == {"1d": ["local", "global"], **LEVELS}
    for c in res.cells:
        assert "terminal" in c.report["link_utilization"]
    assert {r["fabric"] for r in res.records()} == {
        "1d", "fat_tree", "torus"}


def test_engine_cache_no_cross_fabric_collision():
    """Two fabrics with identical (Jmax, Pmax, OPmax) envelopes get
    distinct engine-cache entries — pinned with the cache counters."""
    clear_engine_cache()
    cap = EngineCapacity(Jmax=2, Pmax=4, OPmax=8)
    engines = {}
    for name in ("1d", "fat_tree", "torus"):
        t = get_fabric(name, "small")
        engines[name] = get_engine(t, capacity=cap, horizon_us=1000.0,
                                   device="cpu")
    stats = engine_cache_stats()
    assert stats["misses"] == 3 and stats["hits"] == 0
    assert len({id(e) for e in engines.values()}) == 3
    t2 = get_fabric("torus", "small")
    assert get_engine(t2, capacity=cap, horizon_us=1000.0,
                      device="cpu") is engines["torus"]
    stats = engine_cache_stats()
    assert stats["misses"] == 3 and stats["hits"] == 1
    clear_engine_cache()
