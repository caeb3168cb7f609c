"""The port's online scheduler against the JAX package's.

Each trace goes through the port's scheduler (its CPU path) and the JAX
package's ``_run_trace_impl`` / ``run_trace_batch`` from the same trace,
and must give the same job records (jid, slot, start, finish, messages and
nodes exact; latency and comm time to rtol 1e-5), window counts, sim-time
timelines and final state, every leaf under the contract of
``tests/test_engine_equivalence.py:98-135`` (``tests/torch_parity.py``):

* ``_mini_trace`` of ``tests/test_sched.py`` (three overlapping jobs,
  ``:385``; through one slot, ``:407``) and the contended three-app trace
  of ``tests/test_sched.py:446`` (where EASY backfills and FCFS does
  not), each under FCFS, EASY and conservative backfill;
* the engine cache: hits, misses, LRU evictions (which drop the engine's
  captured graphs), a rebuild after eviction with the same bits, the
  device in the key; and a scenario engine bound to its jobs shares the
  cached engine's graphs (clearing the cache frees them) and reports its
  own run.

The lock-step batch is in ``tests/test_torch_sched_batch.py``.
"""
import numpy as np
import pytest
import torch

from repro.sched import scheduler as REF_S
from repro_torch.netsim import engine as ENG
from repro_torch.obs import get_registry
from repro_torch.sched import scheduler as S
from repro_torch.sched.trace import Trace
from repro_torch.union import manager as MGR
from repro_torch.union.seeds import engine_seed
from test_sched import (
    COMPUTE_BIG, COMPUTE_MED, COMPUTE_SMALL, _mini_trace)
from test_torch_engine_graph_cuda import golden_scenarios
from torch_parity import RTOL, assert_bitwise_equal, assert_port_equals_ref


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _contended():
    """``tests/test_sched.py:446``'s trace: 300 + 400 > 504 nodes, so the
    wide job waits and EASY backfills the small one."""
    from repro.sched.trace import Trace as RefTrace, TraceJob

    return RefTrace(
        name="contend", topo="1d", scale="small", placement="RN",
        routing="MIN", tick_us=5.0, horizon_ms=400.0, pool_size=2048,
        slots=3,
        jobs=[
            TraceJob(name="big", app="big", ranks=300, arrival_us=0.0,
                     est_runtime_us=3200.0, source=COMPUTE_BIG),
            TraceJob(name="wide", app="wide", ranks=400, arrival_us=100.0,
                     est_runtime_us=1200.0, source=COMPUTE_MED),
            TraceJob(name="small", app="small", ranks=50, arrival_us=200.0,
                     est_runtime_us=2700.0, source=COMPUTE_SMALL),
        ],
    )


TRACES = {"mini": _mini_trace, "mini-1slot": lambda: _mini_trace(slots=1),
          "contend": _contended}
EXACT = ("jid", "name", "app", "n_ranks", "arrival_us", "est_runtime_us",
         "slot", "start_us", "finish_us", "completed", "msgs")


def port_trace(ref_trace) -> Trace:
    return Trace.from_dict(ref_trace.to_dict())


def assert_same_result(got, want, state=True):
    """A port SchedResult against a JAX one."""
    assert got.windows == want.windows
    assert got.horizon_hit == want.horizon_hit
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        for name in EXACT:
            assert getattr(g, name) == getattr(w, name), (g.jid, name)
        np.testing.assert_allclose(g.avg_latency_us, w.avg_latency_us,
                                   rtol=RTOL)
        np.testing.assert_allclose(g.max_comm_ms, w.max_comm_ms, rtol=RTOL)
        if w.nodes is None:
            assert g.nodes is None
        else:
            np.testing.assert_array_equal(g.nodes, w.nodes)
    assert got.makespan_us == want.makespan_us
    np.testing.assert_allclose(got.utilization, want.utilization, rtol=RTOL)
    assert got.timeline == want.timeline
    if state:
        assert_port_equals_ref(got.final_state, want.final_state)


@pytest.mark.parametrize("policy", ["fcfs", "easy", "conservative"])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_trace_matches_jax(trace, policy):
    tr = TRACES[trace]()
    want = REF_S._run_trace_impl(tr, policy=policy, seed=4,
                                 collect_state=True, timeline=True)
    got = S._run_trace_impl(port_trace(tr), policy=policy, seed=4,
                            collect_state=True, timeline=True, device="cpu")
    assert_same_result(got, want)
    assert all(r.completed for r in got.records)
    ew = got.engine_windows
    assert ew["windows"] == got.windows and ew["replays"] == 0
    assert ew["ticks"] == ew["live_ticks"] > 0  # eager: no no-op ticks
    if trace == "contend" and policy != "conservative":
        waits = {r.name: r.wait_us for r in got.records}
        # the small job backfills under EASY, not FCFS (tests/test_sched.py)
        assert (waits["small"] < 100.0) == (policy == "easy")


@pytest.fixture
def fresh_cache():
    ENG.clear_engine_cache()
    prev = ENG.set_engine_cache_limit(None)
    yield
    ENG.set_engine_cache_limit(prev)
    ENG.clear_engine_cache()


def test_engine_cache_hits_evicts_and_rebuilds_the_same_bits(fresh_cache):
    tr = port_trace(_mini_trace())
    eng = S.build_sched_engine(tr, device="cpu")[0]
    assert S.build_sched_engine(tr, device=torch.device("cpu"))[0] is eng
    assert ENG.engine_cache_stats() == dict(
        hits=1, misses=1, builds=1, evictions=0, size=1, limit=-1)
    first = S._run_trace_impl(tr, policy="easy", seed=4,
                              collect_state=True, device="cpu")
    eng.graphs["marker"] = object()  # stands for a captured graph
    other = S.build_sched_engine(tr, slots=2, device="cpu")[0]
    assert other is not eng
    assert ENG.set_engine_cache_limit(1) is None
    stats = ENG.engine_cache_stats()
    assert (stats["evictions"], stats["size"], stats["limit"]) == (1, 1, 1)
    assert eng.graphs == {}  # eviction dropped the graphs
    reg = get_registry()
    assert reg.gauge("engine_cache_size").value() == 1
    assert reg.gauge("engine_cache_limit").value() == 1
    rebuilt = S.build_sched_engine(tr, device="cpu")[0]
    assert rebuilt is not eng
    again = S._run_trace_impl(tr, policy="easy", seed=4,
                              collect_state=True, device="cpu")
    assert_bitwise_equal(first.final_state, again.final_state)
    assert ENG.engine_cache_stats()["builds"] == 3
    with pytest.raises(ValueError, match=">= 1"):
        ENG.set_engine_cache_limit(0)

    topo, _, cap, net = S._resolve_trace(tr, 3)
    key = ENG.engine_cache_key(topo, net=net, capacity=cap, device="cpu")
    assert "cpu" in key
    assert key == ENG.engine_cache_key(topo, net=net, capacity=cap,
                                       device=torch.device("cpu"))
    assert key != ENG.engine_cache_key(topo, net=net, capacity=cap,
                                       device="meta")


def test_bound_engine_reports_its_own_run(fresh_cache):
    sc, seed = golden_scenarios()["equiv-coll"]
    rs = MGR.resolve(sc, seed=seed)
    a, b = MGR.build(rs, device="cpu"), MGR.build(rs, device="cpu")
    assert ENG.engine_cache_stats()["hits"] == 1  # one cached engine
    assert a.tick is b.tick and a.graphs is b.graphs  # one owner
    assert a.last_run is None
    st = a.run(a.init_state(seed=engine_seed(seed)))
    assert a.last_run.ticks > 0 and b.last_run is None
    st_b = b.run_window(b.init_state(seed=engine_seed(seed)),
                        np.float32(np.inf))
    assert b.last_window.ticks > 0 and b.last_run is None
    assert float(st_b.t) <= float(st.t)
    with pytest.warns(DeprecationWarning, match="run_scenario"):
        rep = MGR.run_scenario(sc, seed=seed, device="cpu")
    assert rep["engine_run"]["ticks"] == a.last_run.ticks
    a.graphs["marker"] = object()  # stands for a captured graph
    ENG.clear_engine_cache()
    assert b.graphs == {}  # the cache's clear freed the bound engines' too
