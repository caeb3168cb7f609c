"""The engine's ``run_window`` on the card: replays of a captured CUDA graph.

Needs an NVIDIA GPU and ``nvcc`` (the simulator's kernels are built at
first use); skips without a card. Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_windows_cuda.py

On the ``equiv-mix`` golden scenario (small 1D dragonfly, two jobs and UR
background, the second job arriving at 700 µs) and a three-job trace:

* chained windows of the graph equal an eager loop of ``tick`` under the
  stop rule (``window_stopped``), for B = 1 and for B = 3 with different
  ``t_stop`` values, one of them inf: every leaf bit for bit except the
  float sums the card takes with atomics (``lat_sum``, ``link_bytes``,
  ``router_win(s)``), which are held to rtol 1e-5;
* a window whose members have all stopped replays nothing;
* one capture serves every window of a trace, and the drain tick's and
  link demand's launches equal the ticks replayed;
* an engine evicted from the engine cache frees its graphs; engines bound
  to a scenario's jobs share the cached engine's graphs, and clearing the
  cache frees them;
* with tracing on, ``run`` and ``run_window`` replay a traced variant of
  the graph whose events time the tick's six parts: its state is the
  plain graph's, every part reads above 0, their sum a tick is within
  10 % of the replays' device time a tick, and the plain graph replays
  again once tracing is off; ``Engine.prun`` replays the plain graph
  with tracing on;
* a window capture that fails raises; ``run_window`` never steps the
  ticks eagerly on the card.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.netsim import engine as ENG
from repro_torch.sched import scheduler as S
from repro_torch.sched.trace import Trace, TraceJob
from repro_torch.union import manager as MGR
from repro_torch.union.seeds import engine_seed
from test_torch_engine_graph_cuda import golden_scenarios
from torch_parity import RTOL, port_leaves

# float sums the card takes with atomics, in no fixed order
ATOMIC_SUMS = ("metrics.lat_sum", "metrics.link_bytes", "metrics.router_win",
               "metrics.router_wins")
PPC = (
    "For 6 repetitions {\n"
    " all tasks compute for 200 microseconds then\n"
    " task 0 sends a 2048 byte message to task 1 then\n"
    " task 1 sends a 2048 byte message to task 0 }"
)
AR = (
    "For 3 repetitions {\n"
    " all tasks compute for 200 microseconds then\n"
    " all tasks allreduce a 65536 byte message }"
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run_window replays CUDA graphs of "
                    "the tick; the CPU path ticks eagerly)")
    return torch.device("cuda", 0)


def assert_same_window(got, want):
    g, w = port_leaves(got), port_leaves(want)
    assert set(g) == set(w)
    for name in sorted(w):
        if name in ATOMIC_SUMS:
            assert np.allclose(g[name], w[name], rtol=RTOL, atol=0.0,
                               equal_nan=True), name
        else:
            assert g[name].tobytes() == w[name].tobytes(), name


def eager_window(eng, state, t_stop, horizon_us):
    """``run_window``'s loop with eager ticks and the stop rule: the end
    state and the ticks stepped."""
    batched = state.t.dim() == 1
    s = state if batched else ENG._tree_map(lambda x: x[None], state)
    t_stop = torch.as_tensor(np.broadcast_to(
        np.asarray(t_stop, np.float32), s.t.shape).copy(), device=s.t.device)
    n0 = ENG.done_slots(s)
    n = 0
    while True:
        stop = ENG.window_stopped(s, t_stop, n0, horizon_us)
        if bool(stop.all()):
            break
        s = eng.tick(s, t_stop, stop)
        n += 1
    return (s if batched else ENG.member_state(s, 0)), n


def _mix(card):
    sc, seed = golden_scenarios()["equiv-mix"]
    rs = MGR.resolve(sc, seed=seed)
    eng = MGR.build(rs, device=card)
    eng.drop_graphs()  # the cached engine's graphs: start from a capture
    return rs, eng, engine_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_window_graph_equals_eager_ticks(card, B):
    rs, eng, seed = _mix(card)
    if B == 1:
        st = eng.init_state(seed=seed)
        stops = [np.float32(700.0), np.float32(np.inf), np.float32(2500.0)]
    else:
        st = ENG.stack_members([eng.init_state(seed=seed + i)
                                for i in range(B)])
        stops = [np.array([700.0, 1234.5, np.inf], np.float32),
                 np.array([np.inf, 1500.0, np.inf], np.float32),
                 np.array([3000.0, np.inf, 4000.0], np.float32)]
    want = st
    for k, t_stop in enumerate(stops):
        st = eng.run_window(st, t_stop)
        want, n = eager_window(eng, want, t_stop, rs.horizon_us)
        w = eng.last_window
        assert w.device == "cuda" and w.captured == (k == 0)
        # the flag is read after each replay of GRAPH_TICKS ticks
        assert w.live_ticks == n
        assert w.replays == -(-n // ENG.GRAPH_TICKS)
        assert w.ticks == w.replays * w.graph_ticks
        assert w.graph_launches["drain_tick"] == w.graph_ticks
        assert w.graph_calls == w.graph_launches
        assert_same_window(st, want)
    assert {k[0] for k in eng.graphs} == {"window"}


@pytest.mark.cuda
def test_a_stopped_window_does_no_replay(card):
    rs, eng, seed = _mix(card)
    st = eng.run_window(eng.init_state(seed=seed), np.float32(700.0))
    assert eng.last_window.replays > 0
    again = eng.run_window(st, np.float32(700.0))
    w = eng.last_window
    assert (w.replays, w.ticks, w.live_ticks, w.liveness_reads) == (0, 0, 0, 1)
    assert_same_window(again, st)


def _trace():
    return Trace(
        name="mini", topo="1d", scale="small", placement="RN",
        routing="ADP", tick_us=2.0, horizon_ms=200.0, pool_size=512,
        slots=2,
        jobs=[
            TraceJob(name="ar0", app="ar", ranks=8, arrival_us=0.0,
                     est_runtime_us=2000.0, source=AR),
            TraceJob(name="pp1", app="pp", ranks=2, arrival_us=300.0,
                     est_runtime_us=1400.0, source=PPC),
            TraceJob(name="pp2", app="pp2", ranks=2, arrival_us=700.0,
                     est_runtime_us=1400.0, source=PPC),
        ],
    )


@pytest.fixture
def fresh_cache():
    ENG.clear_engine_cache()
    prev = ENG.set_engine_cache_limit(None)
    yield
    ENG.set_engine_cache_limit(prev)
    ENG.clear_engine_cache()


@pytest.mark.cuda
def test_one_capture_serves_every_window_of_a_trace(card, fresh_cache):
    tr = _trace()
    engine = S.build_sched_engine(tr, device=card)
    first = S._run_trace_impl(tr, policy="easy", seed=4, engine=engine,
                              collect_state=True)
    ew = first.engine_windows
    assert all(r.completed for r in first.records)
    assert ew["captures"] == 1 and ew["windows"] == first.windows > 3
    assert ew["launches"]["drain_tick"] == ew["ticks"]
    assert ew["launches"]["link_demand"] == ew["ticks"]
    assert 0 < ew["live_ticks"] <= ew["ticks"]
    second = S._run_trace_impl(tr, policy="easy", seed=4, engine=engine,
                               collect_state=True)
    assert second.engine_windows["captures"] == 0
    assert [(r.slot, r.start_us, r.finish_us, r.msgs)
            for r in second.records] == \
        [(r.slot, r.start_us, r.finish_us, r.msgs) for r in first.records]
    assert_same_window(second.final_state, first.final_state)


@pytest.mark.cuda
def test_eviction_frees_the_graphs(card, fresh_cache):
    tr = _trace()
    eng = S.build_sched_engine(tr, device=card)[0]
    S._run_trace_impl(tr, policy="fcfs", seed=1)
    assert len(eng.graphs) == 1
    static = weakref.ref(next(iter(eng.graphs.values())).static.pool.routes)
    ENG.set_engine_cache_limit(1)
    S.build_sched_engine(tr, slots=3, device=card)  # evicts ``eng``
    assert ENG.engine_cache_stats()["evictions"] == 1
    assert eng.graphs == {}
    gc.collect()
    assert static() is None


@pytest.mark.cuda
def test_bound_engines_share_the_cached_graphs(card, fresh_cache):
    rs, a, seed = _mix(card)
    b = MGR.build(rs, device=card)
    a.run_window(a.init_state(seed=seed), np.float32(700.0))
    assert a.last_window.captured and b.graphs is a.graphs
    b.run_window(b.init_state(seed=seed), np.float32(700.0))
    assert not b.last_window.captured  # a's graph replayed
    static = weakref.ref(next(iter(a.graphs.values())).static.pool.routes)
    ENG.clear_engine_cache()
    gc.collect()
    assert b.graphs == {} and static() is None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["run", "window"])
def test_traced_graph_times_the_parts_and_keeps_the_bits(card, kind):
    """With tracing on, ``run`` and ``run_window`` replay a traced variant
    of the graph, keyed apart, whose events time the tick's parts; its
    final state is the plain graph's, and with tracing off again the
    plain graph replays."""
    from repro_torch import obs

    rs, eng, seed = _mix(card)
    st = ENG.stack_members([eng.init_state(seed=seed + i) for i in range(3)])

    def call():
        if kind == "run":
            return eng.run(st), eng.last_run
        return eng.run_window(st, np.float32(2500.0)), eng.last_window

    plain, ps = call()
    keys, launches = set(eng.graphs), ps.graph_launches
    assert ps.part_device_ms == {} and ps.part_ticks == 0
    assert ps.inject_candidates == ps.inject_routed == 0
    obs.enable()
    try:
        traced, ts = call()
    finally:
        obs.disable()
        obs.get_tracer().clear()
    assert_same_window(traced, plain)
    assert ts.captured and ts.graph_launches == launches
    assert set(eng.graphs) - keys == {k + ("traced",) for k in keys}
    assert set(ts.part_device_ms) == set(ENG.TICK_PARTS)
    assert all(v > 0 for v in ts.part_device_ms.values()), ts.part_device_ms
    assert ts.part_ticks % ENG.GRAPH_TICKS == 0 and ts.part_ticks > 0
    per_tick = sum(ts.part_device_ms.values()) / ts.part_ticks
    assert per_tick == pytest.approx(ts.replay_device_ms / ts.ticks, rel=0.1)
    # the injection's counts cover every replayed tick: each member's
    # (job, rank, emission) candidates and UR sources, and those routed
    B, J, Pmax = st.vms.pc.shape
    per_member = J * Pmax * ENG.MAXE + st.ur_nodes.shape[1]
    assert ts.inject_candidates == ts.ticks * B * per_member
    assert 0 < ts.inject_routed < ts.inject_candidates
    again, ag = call()
    assert not ag.captured and ag.part_ticks == 0
    assert ag.inject_candidates == ag.inject_routed == 0
    assert ag.graph_launches == launches
    assert_same_window(again, plain)


@pytest.mark.cuda
def test_traced_split_replays_the_plain_graph(card):
    """``Engine.prun`` captures no traced variant, tracing on or off: its
    replicas replay while other cards would capture."""
    from repro_torch import obs

    rs, eng, seed = _mix(card)
    st = ENG.stack_members([eng.init_state(seed=seed + i) for i in range(2)])
    plain = eng.prun([st])[0]
    keys = set(eng.graphs)
    obs.enable()
    try:
        traced = eng.prun([st])[0]
    finally:
        obs.disable()
        obs.get_tracer().clear()
    assert set(eng.graphs) == keys
    assert not eng.last_run.captured and eng.last_run.part_ticks == 0
    assert_same_window(traced, plain)


@pytest.mark.cuda
def test_failed_window_capture_raises(card, monkeypatch):
    """A host sync inside the tick cannot be captured: ``run_window``
    raises and returns no state (no eager loop takes over). Last in this
    file: a failed capture may leave its capture stream current."""
    from repro_torch.kernels import ops as KOPS

    rs, eng, seed = _mix(card)
    real = KOPS.drain_tick

    def syncing(*args, **kw):
        float(args[1].sum())  # a device-to-host read
        return real(*args, **kw)

    monkeypatch.setattr(KOPS, "drain_tick", syncing)
    state = eng.init_state(seed=seed)
    with pytest.raises(RuntimeError):
        eng.run_window(state, np.float32(700.0))
    assert eng.last_window is None and eng.graphs == {}
    assert float(state.t) == 0.0
