"""The port's windowed engine and slot surgery against the JAX package's.

On the small 1D dragonfly (pool 512, tick 2 µs, as ``tests/test_sched.py``
builds it), every check of the JAX package's window tests
(``tests/test_sched.py:199-375``) on the port's CPU path, plus each
window's state against the JAX engine's under the contract of
``tests/test_engine_equivalence.py:98-135`` (integers exact, floats to
rtol 1e-5; ``tests/torch_parity.py``):

* chained ``run_window`` calls equal one uninterrupted ``run`` bit for bit
  when the window boundary sits on a job arrival, and each window equals
  the JAX engine's;
* a batched window stops each member at its own event; per-member
  ``t_stop`` sequences through one batch equal each member's own windows;
* three tenants stream through a one-slot envelope (``admit_job`` /
  ``retire_job``), as in the JAX engine;
* ``admit_jobs`` / ``retire_jobs`` on a batch equal the per-member calls
  and the JAX package's surgery; ``window_host_view`` gives the JAX view;
* the tick with a window cap of inf is the tick without one.

The mid-run outage of ``tests/test_faults.py:250`` (windows on the fault
events) is in ``tests/test_torch_faults.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.translator import translate_source as ref_translate
from repro.netsim import engine as REF_ENG
from repro.netsim.config import NetConfig as RefNetConfig
from repro.netsim.placement import place_jobs as ref_place_jobs
from repro.netsim.topology import dragonfly_1d_small as ref_dragonfly
from repro_torch.core.translator import translate_source
from repro_torch.netsim import engine as ENG
from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.placement import place_jobs
from repro_torch.netsim.topology import dragonfly_1d_small
from test_sched import AR, PP
from torch_parity import RTOL, assert_bitwise_equal, assert_port_equals_ref

INF = np.float32(np.inf)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def topo():
    return dragonfly_1d_small()


@pytest.fixture(scope="module")
def ref_topo():
    return ref_dragonfly()


def _jobs(topo, js, translate, place, ar_start=400.0):
    """The pp (2 ranks, t = 0) and ar (8 ranks, ``ar_start``) job pair of
    the JAX package's window tests, in one package's classes."""
    pl = place(topo, [2, 8], "RN", seed=9)
    return [js("pp", translate(PP, "pp_w", 2), pl[0], start_us=0.0),
            js("ar", translate(AR, "ar_w", 8), pl[1], start_us=ar_start)]


@pytest.fixture(scope="module")
def pair(topo, ref_topo):
    """(port engine, JAX engine) over the same two jobs."""
    port = ENG.build_engine(
        topo, _jobs(topo, ENG.JobSpec, translate_source, place_jobs),
        net=NetConfig(pool_size=512, tick_us=2.0), pool_size=512,
        device="cpu")
    ref = REF_ENG.build_engine(
        ref_topo,
        _jobs(ref_topo, REF_ENG.JobSpec, ref_translate, ref_place_jobs),
        net=RefNetConfig(pool_size=512, tick_us=2.0), pool_size=512)
    return port, ref


def _ref_window(ref, state, t_stop):
    return jax.block_until_ready(ref.run_window(state, t_stop))


def test_chained_windows_equal_one_run_and_the_jax_windows(pair):
    port, ref = pair
    single = port.run(port.init_state(seed=3))
    st, rst = port.init_state(seed=3), ref.init_state(seed=3)
    stops = [np.float32(400.0)]  # window 1: to the ar job's arrival
    windows = 0
    while True:
        prev = (float(st.t), int(st.rng))
        st = port.run_window(st, stops[-1])
        rst = _ref_window(ref, rst, stops[-1])
        assert_port_equals_ref(st, rst)
        assert port.last_window.ticks == port.last_window.live_ticks
        windows += 1
        if windows == 1:
            assert float(st.t) <= 400.0
        elif (float(st.t), int(st.rng)) == prev:
            assert port.last_window.ticks == 0  # stopped already
            break
        stops.append(INF)  # drain in completion-bounded windows
    assert windows >= 3  # the boundary and at least one completion stop
    assert_bitwise_equal(single, st)


def test_batched_window_freezes_members_independently(pair):
    port, ref = pair
    singles = [port.run_window(port.init_state(seed=s), np.float32(400.0))
               for s in (3, 4)]
    batched = port.run_window(
        ENG.stack_members([port.init_state(seed=s) for s in (3, 4)]),
        np.float32(400.0))
    rb = _ref_window(ref, REF_ENG.stack_members(
        [ref.init_state(seed=s) for s in (3, 4)]), np.float32(400.0))
    for i in (0, 1):
        assert_bitwise_equal(singles[i], ENG.member_state(batched, i))
        assert_port_equals_ref(ENG.member_state(batched, i),
                               REF_ENG.member_state(rb, i))


def _per_member_stops(port, stops_a, stops_b, ref=None):
    """Per-member stop sequences through one batch equal each member's own
    B = 1 windows (bit for bit) and, with ``ref``, the JAX batch's windows
    (contract)."""
    R = max(len(stops_a), len(stops_b)) + 1  # final window: unbounded
    seqs = [[np.float32(s) for s in stops] + [INF] * (R - len(stops))
            for stops in (stops_a, stops_b)]
    singles = [port.init_state(seed=s) for s in (3, 4)]
    batched = ENG.stack_members(list(singles))
    if ref is not None:
        rb = REF_ENG.stack_members([ref.init_state(seed=s) for s in (3, 4)])
    for r in range(R):
        singles = [port.run_window(s, seqs[i][r])
                   for i, s in enumerate(singles)]
        t_stop = np.array([seqs[0][r], seqs[1][r]], np.float32)
        batched = port.run_window(batched, t_stop)
        if ref is not None:
            rb = _ref_window(ref, rb, t_stop)
            assert_port_equals_ref(batched, rb)
    for i in (0, 1):
        assert_bitwise_equal(singles[i], ENG.member_state(batched, i))


def test_per_member_t_stop_chained_windows(pair):
    port, ref = pair
    _per_member_stops(port, [123.0, 800.0], [456.0], ref=ref)
    for stops_a, stops_b in [([400.0], []), ([50.0, 60.0, 70.0], [2_999.0])]:
        _per_member_stops(port, stops_a, stops_b)
    # arrival-aligned per-member stops equal one uninterrupted run per
    # member: member 0 pauses at the ar job's arrival, member 1 never
    refs = [port.run(port.init_state(seed=s)) for s in (3, 4)]
    batched = ENG.stack_members([port.init_state(seed=s) for s in (3, 4)])
    batched = port.run_window(batched, np.array([400.0, np.inf], np.float32))
    while True:
        prev = (batched.t.clone(), batched.rng.clone())
        batched = port.run_window(batched, np.array([INF, INF]))
        if torch.equal(batched.t, prev[0]) and torch.equal(batched.rng,
                                                           prev[1]):
            break
    for i in (0, 1):
        assert_bitwise_equal(refs[i], ENG.member_state(batched, i))


def test_slot_recycling_through_one_slot(topo, ref_topo):
    sk = translate_source(PP, "pp_rec", 2)
    cap = ENG.EngineCapacity(Jmax=1, Pmax=2, OPmax=sk.n_ops)
    port = ENG.build_engine(topo, [], capacity=cap,
                            net=NetConfig(pool_size=256, tick_us=2.0),
                            pool_size=256, device="cpu")
    ref = REF_ENG.build_engine(
        ref_topo, [], capacity=REF_ENG.EngineCapacity(1, 2, sk.n_ops),
        net=RefNetConfig(pool_size=256, tick_us=2.0), pool_size=256)
    ref_sk = ref_translate(PP, "pp_rec", 2)
    st, rst = port.init_state(seed=1), ref.init_state(seed=1)
    assert ENG.vacant_slots(st).tolist() == [0]
    counts = []
    occupied = np.zeros((topo.n_nodes,), bool)
    for k in range(3):
        nodes = place_jobs(topo, [2], "RN", seed=k, occupied=occupied)[0]
        st = ENG.admit_job(st, 0, ENG.JobSpec(f"pp{k}", sk, nodes,
                                              start_us=float(st.t)))
        rst = REF_ENG.admit_job(rst, 0, REF_ENG.JobSpec(
            f"pp{k}", ref_sk, nodes, start_us=float(rst.t)))
        with pytest.raises(ValueError, match="occupied"):
            ENG.admit_job(st, 0, ENG.JobSpec("again", sk, nodes))
        assert ENG.occupied_node_mask(st, topo.n_nodes).sum() == 2
        with pytest.raises(ValueError, match="unfinished"):
            ENG.retire_job(st, 0)
        st = port.run_window(st, INF)
        rst = _ref_window(ref, rst, INF)
        while not ENG.slot_done(st, 0):
            st = port.run_window(st, INF)
            rst = _ref_window(ref, rst, INF)
        assert not ENG.slot_in_flight(st, 0)
        counts.append(int(st.metrics.lat_cnt[0]))
        st = ENG.retire_job(st, 0)
        rst = REF_ENG.retire_job(rst, 0)
        assert_port_equals_ref(st, rst)
        assert ENG.vacant_slots(st).tolist() == [0]
        assert ENG.occupied_node_mask(st, topo.n_nodes).sum() == 0
    # metrics accumulate per slot: 12 messages per tenant
    assert counts == [12, 24, 36]


def test_admit_and_retire_jobs_equal_per_member_calls(topo, ref_topo):
    cap = ENG.EngineCapacity(Jmax=3, Pmax=8, OPmax=16)
    port = ENG.build_engine(topo, [], capacity=cap,
                            net=NetConfig(pool_size=256, tick_us=2.0),
                            pool_size=256, device="cpu")
    ref = REF_ENG.build_engine(
        ref_topo, [], capacity=REF_ENG.EngineCapacity(3, 8, 16),
        net=RefNetConfig(pool_size=256, tick_us=2.0), pool_size=256)
    pl = place_jobs(topo, [2, 8, 2], "RN", seed=3)
    specs = [(PP, "pp_a", 2, 0, 0.0), (AR, "ar_a", 8, 1, 30.0),
             (PP, "pp_b", 2, 2, 7.5)]
    port_specs = [ENG.JobSpec(n, translate_source(src, n, p), pl[k],
                              start_us=s) for src, n, p, k, s in specs]
    ref_specs = [REF_ENG.JobSpec(n, ref_translate(src, n, p), pl[k],
                                 start_us=s) for src, n, p, k, s in specs]
    admits = [(0, 0, 0), (0, 2, 1), (2, 1, 2), (1, 0, 1)]  # member, slot,
    retires = [(0, 2), (2, 1)]                             # job

    members = [port.init_state(seed=s) for s in (1, 2, 3)]
    batch = ENG.admit_jobs(ENG.stack_members(members),
                           [(m, s, port_specs[j]) for m, s, j in admits])
    for m, s, j in admits:
        members[m] = ENG.admit_job(members[m], s, port_specs[j])
    assert_bitwise_equal(batch, ENG.stack_members(members))
    rb = REF_ENG.admit_jobs(
        REF_ENG.stack_members([ref.init_state(seed=s) for s in (1, 2, 3)]),
        [(m, s, ref_specs[j]) for m, s, j in admits])
    assert_port_equals_ref(batch, rb)
    assert ENG.vacant_slots(ENG.member_state(batch, 0)).tolist() == [1]

    batch = ENG.retire_jobs(batch, retires)
    for m, s in retires:
        members[m] = ENG.retire_job(members[m], s, checked=False)
    assert_bitwise_equal(batch, ENG.stack_members(members))
    assert_port_equals_ref(batch, REF_ENG.retire_jobs(rb, retires))
    assert ENG.admit_jobs(batch, []) is batch
    assert ENG.retire_jobs(batch, []) is batch
    with pytest.raises(ValueError, match="outside envelope"):
        ENG.admit_jobs(batch, [(0, 3, port_specs[0])])


def test_window_host_view_matches_jax(pair):
    port, ref = pair
    batch = ENG.stack_members([port.init_state(seed=s) for s in (3, 4)])
    rb = REF_ENG.stack_members([ref.init_state(seed=s) for s in (3, 4)])
    # to the pp job's completion, then into the ar job's first allreduce
    for t_stop in (np.array([INF, INF]), np.array([603.0, 611.0],
                                                  np.float32)):
        batch = port.run_window(batch, t_stop)
        rb = _ref_window(ref, rb, t_stop)
    views = [(ENG.window_host_view(batch), REF_ENG.window_host_view(rb))]
    views += [(v.member(1), w.member(1)) for v, w in views]
    views.append((ENG.window_host_view(ENG.member_state(batch, 0)),
                  REF_ENG.window_host_view(REF_ENG.member_state(rb, 0))))
    assert views[0][0].in_flight.any()  # a window that ends mid-flight
    for got, want in views:
        assert got._fields == want._fields
        for name, g, w in zip(got._fields, got, want):
            w = np.asarray(w)
            assert g.shape == w.shape, name
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def test_tick_with_an_inf_cap_is_the_plain_tick(pair):
    port, _ = pair
    a = b = port.init_state(seed=3)
    for _ in range(40):
        a = port.tick(a)
        b = port.tick(b, torch.tensor(np.inf), torch.tensor(False))
    assert_bitwise_equal(a, b)
