"""The port's fault module and faulted engine runs against the JAX package.

On the small 1D dragonfly (pool 1,024, tick 2 µs, as
``tests/test_faults.py`` builds it):

* spec layer: ``parse_failure`` shorthands and the dict round trip give
  the reference's specs; ``timeline(topo, seed)`` equals the reference's
  bit for bit for each of the six selector kinds;
* engine layer: the healthy mask is a bitwise no-op; adaptive routing
  survives a cut of every direct global link between two groups (dead
  links carry nothing, the detour costs latency), minimal routing stalls
  on it, a router outage silences its links, a mask put on a healthy
  state by ``with_faults`` runs as one given to ``init_state`` — and
  each of these faulted runs equals the JAX engine's run with the same
  mask, every leaf (integers exact, floats to rtol 1e-5);
* timelines applied mid-run: the outage of ``tests/test_faults.py:250``
  through ``run_window`` to each fault event and ``with_faults`` between
  windows, every window and the end state equal to the JAX engine's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.netsim import engine as REF_ENG
from repro.netsim import faults as REF_F
from repro.netsim.config import NetConfig as RefNetConfig
from repro.netsim.topology import dragonfly_1d_small as ref_dragonfly
from repro.core.translator import translate_source as ref_translate
from repro_torch.netsim import engine as ENG
from repro_torch.netsim import faults as F
from repro_torch.netsim import metrics as MET
from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.engine import JobSpec, build_engine, job_vm
from repro_torch.netsim.state_io import state_to_numpy
from repro_torch.netsim.topology import dragonfly_1d_small
from repro_torch.core.translator import translate_source
from torch_parity import (
    assert_bitwise_equal, assert_port_equals_ref, port_leaves)

SRC = (
    "For 6 repetitions {\n"
    " task 0 sends a 65536 byte message to task 1 then\n"
    " task 1 sends a 65536 byte message to task 0 }"
)


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


def _r2n(topo):
    return np.asarray([0, topo.routers_per_group * topo.nodes_per_router])


def _port_job(topo):
    return JobSpec("xgroup", translate_source(SRC, "xgroup", 2), _r2n(topo))


def _ref_job(topo):
    return REF_ENG.JobSpec("xgroup", ref_translate(SRC, "xgroup", 2),
                           _r2n(topo))


def _direct_global_links(topo, ga=0, gb=1):
    dead = []
    for m in range(topo.links_per_pair):
        dead.append(int(topo.global_link_id[ga, gb, m]))
        dead.append(int(topo.global_link_id[gb, ga, m]))
    return dead


def _port_run(topo, faults=None, horizon=300_000.0, **kw):
    eng = build_engine(topo, [_port_job(topo)],
                       net=NetConfig(pool_size=1024, tick_us=2.0),
                       pool_size=1024, horizon_us=horizon, device="cpu", **kw)
    return eng.run(eng.init_state(faults=faults))


def _ref_run(topo, faults=None, horizon=300_000.0, **kw):
    eng = REF_ENG.build_engine(
        topo, [_ref_job(topo)], net=RefNetConfig(pool_size=1024, tick_us=2.0),
        pool_size=1024, horizon_us=horizon, **kw)
    return jax.block_until_ready(eng.run(eng.init_state(faults=faults)))


# ---------------------------------------------------------------------------
# spec layer
# ---------------------------------------------------------------------------

SHORTHANDS = ["healthy", "links:0.05", "routers:0.1", "level:global",
              "level:local:0.5", "block:0.25", "degrade:0.3:0.25"]


@pytest.mark.parametrize("spec", SHORTHANDS)
def test_parse_failure_matches_reference(spec):
    got, want = F.parse_failure(spec), REF_F.parse_failure(spec)
    assert got.name == want.name
    assert got.to_dict() == want.to_dict()
    assert F.FailureSpec.from_dict(got.to_dict()) == got


def test_parse_failure_errors_and_normalize():
    dict_spec = dict(name="blip", events=[
        dict(t_us=100.0, kind="random_links", fraction=0.1)])
    got = F.normalize_failures(["healthy", "degrade:0.3:0.25", dict_spec,
                                dict(kind="routers", routers=[3])])
    want = REF_F.normalize_failures(["healthy", "degrade:0.3:0.25",
                                     dict_spec, dict(kind="routers",
                                                     routers=[3])])
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    for bad in ("links:2.0", "frobnicate:0.1", 3):
        with pytest.raises(ValueError):
            F.parse_failure(bad)
    with pytest.raises(ValueError):
        F.FaultEvent(t_us=0.0, kind="warp")
    with pytest.raises(ValueError):
        F.normalize_failures(["healthy", "healthy"])
    fs = F.FailureSpec(name="mixed", events=[
        dict(t_us=0.0, kind="random_links", fraction=0.02),
        dict(t_us=500.0, kind="routers", routers=(3, 4), factor=0.5)])
    assert F.FailureSpec.from_dict(fs.to_dict()) == fs
    assert fs.has_timed_events and not fs.is_healthy
    assert F.HEALTHY.is_healthy and not F.HEALTHY.has_timed_events


EVENTS = {
    "links": [dict(t_us=0.0, kind="links", links=(70, 71, 90))],
    "routers": [dict(t_us=0.0, kind="routers", routers=(2,)),
                dict(t_us=300.0, kind="routers", routers=(5,), factor=0.5)],
    "random_links": [
        dict(t_us=100.0, kind="random_links", fraction=0.1, seed=11),
        dict(t_us=200.0, kind="random_links", fraction=0.1, seed=11,
             factor=1.0)],
    "random_routers": [dict(t_us=0.0, kind="random_routers", fraction=0.2)],
    "level": [dict(t_us=0.0, kind="level", level="global", fraction=0.3),
              dict(t_us=50.0, kind="level", level="local", factor=0.5)],
    "router_block": [dict(t_us=0.0, kind="router_block", fraction=0.25)],
}


@pytest.mark.parametrize("kind", sorted(EVENTS))
def test_timeline_matches_reference_bit_for_bit(kind, topo, ref_topo):
    spec = dict(name=kind, events=EVENTS[kind])
    for seed in (0, 3):
        got = F.FailureSpec.from_dict(spec).timeline(topo, seed)
        want = REF_F.FailureSpec.from_dict(spec).timeline(ref_topo, seed)
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, g), (_, w) in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == np.float32
                assert a.tobytes() == np.asarray(b).tobytes()
    # something actually failed
    assert any((fs.link_bw_factor != 1).any() or (fs.router_factor != 1).any()
               for _, fs in got)


# ---------------------------------------------------------------------------
# engine layer
# ---------------------------------------------------------------------------

def test_healthy_mask_is_bitwise_noop(topo):
    a = _port_run(topo)
    b = _port_run(topo, faults=F.healthy_state(topo))
    assert_bitwise_equal(a, b)


def _cut(topo):
    return F.FailureSpec(name="cut", events=[dict(
        t_us=0.0, kind="links", links=tuple(_direct_global_links(topo)))])


def test_adaptive_survives_link_failure(topo, ref_topo):
    dead = _direct_global_links(topo)
    mask = _cut(topo).initial_state(topo, 0)
    st_ok = _port_run(topo)
    st_f = _port_run(topo, faults=mask)
    assert bool(job_vm(st_f, 0).done.all()), "job must survive the failure"
    assert int(st_f.pool.dropped) == 0
    lb = st_f.metrics.link_bytes[: topo.n_links].numpy()
    assert lb[dead].sum() == 0.0, "dead links must carry no traffic"
    net = NetConfig(pool_size=1024, tick_us=2.0)
    lat = [MET.latency_summary(state_to_numpy(s), ["xgroup"], net)
           ["xgroup"]["avg_us"] for s in (st_ok, st_f)]
    assert lat[1] > lat[0], "detour must cost latency"
    assert_port_equals_ref(st_f, _ref_run(ref_topo, faults=mask))


def test_minimal_routing_stalls_on_failure(topo, ref_topo):
    """Stalled messages keep the run ticking to its horizon, 2 µs a tick:
    1,000 ticks show the stall."""
    mask = _cut(topo).initial_state(topo, 0)
    st = _port_run(topo, faults=mask, routing="MIN", horizon=2_000.0)
    assert not bool(job_vm(st, 0).done.all())
    assert bool(st.pool.active.any())  # stuck in flight
    assert int(st.pool.dropped) == 0
    assert float(st.t) == 2_000.0
    assert_port_equals_ref(st, _ref_run(ref_topo, faults=mask, routing="MIN",
                                        horizon=2_000.0))


def test_router_outage_kills_attached_links(topo, ref_topo):
    victim = 2 * topo.routers_per_group  # first router of group 2
    mask = F.FailureSpec(name="r-down", events=[dict(
        t_us=0.0, kind="routers", routers=(victim,))]).initial_state(topo, 0)
    st = _port_run(topo, faults=mask)
    assert bool(job_vm(st, 0).done.all())
    lb = st.metrics.link_bytes[: topo.n_links].numpy()
    touch = np.flatnonzero((np.asarray(topo.link_src_router) == victim)
                           | (np.asarray(topo.link_dst_router) == victim))
    assert lb[touch].sum() == 0.0
    assert_port_equals_ref(st, _ref_run(ref_topo, faults=mask))


def test_random_downmask_never_drops(topo, ref_topo):
    mask = F.parse_failure("links:0.1").initial_state(topo, cell_seed=3)
    st = _port_run(topo, faults=mask, horizon=50_000.0)
    assert int(st.pool.dropped) == 0
    lb = st.metrics.link_bytes[: topo.n_links].numpy()
    assert lb[mask.link_bw_factor == 0.0].sum() == 0.0
    assert_port_equals_ref(st, _ref_run(ref_topo, faults=mask,
                                        horizon=50_000.0))


def test_with_faults_runs_as_a_mask_at_init(topo):
    mask = _cut(topo).initial_state(topo, 0)
    eng = build_engine(topo, [_port_job(topo)],
                       net=NetConfig(pool_size=1024, tick_us=2.0),
                       pool_size=1024, horizon_us=300_000.0, device="cpu")
    st = eng.run(F.with_faults(eng.init_state(), mask))
    assert_bitwise_equal(st, _port_run(topo, faults=mask))


def test_surgery_puts_masks_on_the_state(topo):
    job = _port_job(topo)
    eng = build_engine(topo, [job], net=NetConfig(pool_size=1024, tick_us=2.0),
                       pool_size=1024, device="cpu")
    mask = F.parse_failure("routers:0.1").initial_state(topo, 1)
    st = F.with_faults(eng.init_state(), mask)
    assert st.faults.link_bw_factor.dtype == torch.float32
    assert st.faults.router_factor.numpy().tobytes() \
        == mask.router_factor.tobytes()
    from repro_torch.netsim.engine import stack_members
    batch = stack_members([eng.init_state(), eng.init_state()])
    before = batch.faults.router_factor.clone()
    out = F.set_member_faults(batch, 1, mask)
    assert torch.equal(out.faults.router_factor[0], before[0])
    assert out.faults.router_factor[1].numpy().tobytes() \
        == mask.router_factor.tobytes()
    assert torch.equal(batch.faults.router_factor, before)  # a new state


# ---------------------------------------------------------------------------
# timelines applied mid-run, between windows
# ---------------------------------------------------------------------------

def _xgroup(topo, js, translate, name, node_offset=0, start_us=0.0):
    src = (
        "For 6 repetitions {\n"
        " task 0 sends a 65536 byte message to task 1 then\n"
        " task 1 sends a 65536 byte message to task 0 }"
    )
    npg = topo.routers_per_group * topo.nodes_per_router
    return js(name, translate(src, name, 2),
              np.asarray([node_offset, npg + node_offset]),
              start_us=start_us)


def test_midrun_outage_reroutes_and_recovers(topo, ref_topo):
    """``tests/test_faults.py:250`` on the port: every direct group-0/1
    global link dies at 150 µs and returns at 400 µs; windows land on the
    two events and the masks are swapped between them (``with_faults``)."""
    def jobs(t, js, tr):
        return [_xgroup(t, js, tr, "a"),
                _xgroup(t, js, tr, "b", node_offset=1, start_us=200.0)]

    port = ENG.build_engine(
        topo, jobs(topo, ENG.JobSpec, translate_source),
        net=NetConfig(pool_size=1024, tick_us=2.0), pool_size=1024,
        horizon_us=300_000.0, device="cpu")
    ref = REF_ENG.build_engine(
        ref_topo, jobs(ref_topo, REF_ENG.JobSpec, ref_translate),
        net=RefNetConfig(pool_size=1024, tick_us=2.0), pool_size=1024,
        horizon_us=300_000.0)
    dead = [int(topo.global_link_id[a, b, m])
            for m in range(topo.links_per_pair) for a, b in ((0, 1), (1, 0))]
    glob = np.flatnonzero(np.asarray(topo.link_levels()["global"]))
    other = np.asarray([g for g in glob if g not in dead])
    L = topo.n_links

    st_ok = port.run(port.init_state())
    lb_ok = st_ok.metrics.link_bytes.numpy()[:L]
    assert lb_ok[other].sum() == 0.0  # healthy: direct links only

    def events(mod):
        return mod.FailureSpec(name="outage", events=[
            mod.FaultEvent(t_us=150.0, kind="links", links=tuple(dead)),
            mod.FaultEvent(t_us=400.0, kind="links", links=tuple(dead),
                           factor=1.0),
        ])

    tl, rtl = events(F).timeline(topo, 0), events(REF_F).timeline(ref_topo, 0)
    state = port.init_state(faults=tl[0][1])
    rstate = ref.init_state(faults=rtl[0][1])
    snaps = {}
    for (t_ev, mask), (_, rmask) in zip(tl[1:], rtl[1:]):
        state = port.run_window(state, np.float32(t_ev))
        rstate = jax.block_until_ready(
            ref.run_window(rstate, np.float32(t_ev)))
        assert_port_equals_ref(state, rstate)
        snaps[t_ev] = state.metrics.link_bytes.numpy()[:L]
        state = F.with_faults(state, mask)
        rstate = REF_F.with_faults(rstate, rmask)
    st_f = port.run(state)
    assert_port_equals_ref(st_f, jax.block_until_ready(ref.run(rstate)))

    assert bool(ENG.job_vm(st_f, 0).done.all())
    assert bool(ENG.job_vm(st_f, 1).done.all())
    assert int(st_f.pool.dropped) == 0
    # dead links: frozen during the outage, resume after the restore
    assert snaps[150.0][dead].sum() == snaps[400.0][dead].sum()
    lb_f = st_f.metrics.link_bytes.numpy()[:L]
    assert lb_f[dead].sum() > snaps[400.0][dead].sum()
    # job B rerouted: its traffic rode other global links, two hops each
    b_bytes = lb_ok[dead].sum() - lb_f[dead].sum()
    assert lb_f[other].sum() >= 2.0 * b_bytes > 0.0
    # the stall costs job A latency
    lat = port_leaves(st_f)["metrics.lat_sum"] / np.maximum(
        port_leaves(st_f)["metrics.lat_cnt"], 1)
    lat_ok = port_leaves(st_ok)["metrics.lat_sum"] / np.maximum(
        port_leaves(st_ok)["metrics.lat_cnt"], 1)
    assert lat[0] > lat_ok[0]
