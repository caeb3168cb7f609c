"""The injection's plain version and its dispatch, on the CPU.

* ``KOPS.inject`` on CPU tensors runs the plain version: one call
  counted, no launch; a given tally gains the candidates seen and those
  routed, and the result is the one without it;
* :func:`~repro_torch.kernels.inject.inject_plain` on hand-made pools:
  slots from the free stack in flat candidate order, drops past
  ``free_top``, a Valiant route around a failed link, and MIN at a
  planted tie of UGAL's compare (Valiant one ulp above it);
* a dragonfly engine injects through ``KOPS.inject`` once a tick; a fat
  tree's and a torus's engines route with their own ``route_fn`` and never
  call it;
* the traced graph's injection counts are summed by ``RunStats.merged``
  and carried into the facade's engine telemetry.

The kernel itself is held to the plain version on the card by
``tests/test_torch_inject_cuda.py``, whose input generators these tests
share.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.inject import inject_batches_plain, inject_plain
from repro_torch.netsim import engine as ENG
from repro_torch.netsim.fabric import get_fabric
from repro_torch.netsim.routing import compute_routes, topo_arrays
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario, ScenarioJob, URDecl
from repro_torch.union.seeds import engine_seed
from test_torch_inject_cuda import (
    inputs, make_candidates, make_demand, make_pool, tie_case)

PP = ("For 4 repetitions {\n"
      " task 0 sends a 1024 byte message to task 1 then\n"
      " task 1 sends a 1024 byte message to task 0 }")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kops_inject_on_cpu_counts_a_call_and_no_launch():
    topo = get_fabric("2d", "small")
    B, M = 2, 1024
    pool = make_pool(topo, B, M, [M, 30], 1)
    batches = [make_candidates(topo, B, 3, 200, 0.1, 2),
               make_candidates(topo, B, 1, 64, 0.5, 3, app0=3,
                               per_job_peak=False)]
    args = inputs(topo, pool, batches, make_demand(topo, B, 4), 10.0, "cpu")
    kw = dict(adaptive=True, hop_latency_us=0.5, n_jobs=3)
    KOPS.reset_launches()
    got, gm = KOPS.inject(*args, **kw)
    assert KOPS.CALLS["inject"] == 1 and KOPS.LAUNCHES["inject"] == 0
    want, wm = inject_batches_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gm.peak_inject, wm.peak_inject)
    assert got.free_top.tolist()[1] == 0


def test_a_given_tally_adds_the_candidates_seen_and_routed():
    topo = get_fabric("1d", "small")
    B, M = 2, 512
    pool = make_pool(topo, B, M, [M, 40], 6)
    batches = [make_candidates(topo, B, 2, 128, 0.3, 7),
               make_candidates(topo, B, 1, 32, 0.5, 8, app0=2,
                               per_job_peak=False)]
    args = inputs(topo, pool, batches, make_demand(topo, B, 9), 4.0, "cpu")
    kw = dict(adaptive=True, hop_latency_us=0.5, n_jobs=2)
    tally = torch.tensor([5, 1], dtype=torch.int64)
    got, gm = KOPS.inject(*args, **kw, counts=tally)
    want, wm = KOPS.inject(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gm.peak_inject, wm.peak_inject)
    routed = int((args[0].free_top - got.free_top).sum())
    assert 0 < routed < B * 288
    assert tally.tolist() == [5 + B * 288, 1 + routed]


def _hand_pool(topo, M, free_stack, free_top):
    B = len(free_top)
    pool = make_pool(topo, B, M, free_top, 5)
    pool["free_stack"] = np.asarray(free_stack, np.int32)
    pool["dropped"] = np.zeros(B, np.int32)
    return pool


def test_slots_in_flat_order_and_drops_past_free_top():
    topo = get_fabric("1d", "small")
    M = 8
    stacks = [[5, 2, 7, 0, 1, 3, 4, 6], [0, 1, 2, 3, 4, 5, 6, 7]]
    pool = _hand_pool(topo, M, stacks, [3, 8])
    jobs = make_candidates(topo, 2, 2, 4, 0.0, 6)
    emitted = [1, 2, 4, 6, 7]
    jobs["dst_rank"][:, emitted] = [[3, 0, 1, 2, 3]] * 2
    pool_t, metrics, t, batches, demand, tables = inputs(
        topo, pool, [jobs], make_demand(topo, 2, 7), [40.0, 50.0], "cpu")
    c = batches[0]
    out, m = inject_plain(pool_t, metrics, t, *c[:7], demand, True,
                          compute_routes, tables.T, True, 0.5, 2)
    # member 0: three free slots, taken from the top of the stack by the
    # first three emitted candidates; the last two are dropped
    assert out.free_top.tolist() == [0, 3]
    assert out.dropped.tolist() == [2, 0]
    want_slots = [[7, 2, 5], [7, 6, 5, 4, 3]]
    for b, slots in enumerate(want_slots):
        for i, s in zip(emitted, slots):
            assert bool(out.active[b, s])
            assert int(out.dst_rank[b, s]) == int(c.dst_rank[b, i])
            assert int(out.src_rank[b, s]) == int(c.src_rank[b, i])
            assert int(out.job[b, s]) == int(c.app[b, i])
            assert float(out.size[b, s]) == float(c.size[b, i])
            assert float(out.bytes_rem[b, s]) == float(c.size[b, i])
            assert float(out.inject_t[b, s]) == float(t[b])
            hops = int((out.routes[b, s] >= 0).sum())
            assert float(out.min_arrive[b, s]) == float(t[b]) + 0.5 * hops
        untouched = sorted(set(range(M)) - set(slots))
        for k in ("active", "src_rank", "routes", "min_arrive"):
            assert torch.equal(getattr(out, k)[b, untouched],
                               getattr(pool_t, k)[b, untouched]), k
    # each member's peak: the largest job's injected bytes
    sizes = c.size.numpy()
    per_job = [[sizes[b, [i for i in emitted[:len(s)] if i // 4 == j]].sum()
                for j in range(2)] for b, s in enumerate(want_slots)]
    assert m.peak_inject.tolist() == pytest.approx(
        [max(3.0, max(p)) for p in per_job])


def _one_candidate(topo, src, dst, rand, B=1):
    jobs = make_candidates(topo, B, 1, 8, 0.0, 8)
    jobs["dst_rank"][:, 3] = 1
    jobs["src_node"][:, 3] = src
    jobs["dst_node"][:, 3] = dst
    jobs["rand"][:, 3] = rand
    return jobs


def test_valiant_route_around_a_failed_link():
    topo = get_fabric("1d", "small")
    T = topo_arrays(topo, "cpu")
    src, dst, rand, _, mn, vl = tie_case(topo, T, 9)
    demand = np.zeros((1, topo.n_links + 1), np.float32)
    demand[0, mn[3]] = np.float32(1e18)  # the minimal route's global link
    pool = make_pool(topo, 1, 16, [16], 10)
    args = inputs(topo, pool, [_one_candidate(topo, src, dst, rand)],
                  demand, 5.0, "cpu")
    out, _ = inject_batches_plain(*args, adaptive=True, hop_latency_us=0.5,
                                  n_jobs=1)
    slot = int(pool["free_stack"][0, 15])
    assert out.routes[0, slot].tolist() == vl
    assert mn[3] not in vl
    # MIN routing keeps the minimal route whatever the demand
    out, _ = inject_batches_plain(*args, adaptive=False, hop_latency_us=0.5,
                                  n_jobs=1)
    assert out.routes[0, slot].tolist() == mn


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_minimal_route_at_the_tie(name):
    topo = get_fabric(name, "small")
    T = topo_arrays(topo, "cpu")
    src, dst, rand, demand, mn, vl = tie_case(topo, T, 11)
    pool = make_pool(topo, 2, 16, [16, 16], 12)
    args = inputs(topo, pool, [_one_candidate(topo, src, dst, rand, B=2)],
                  demand, 5.0, "cpu")
    out, _ = inject_batches_plain(*args, adaptive=True, hop_latency_us=0.5,
                                  n_jobs=1)
    slots = pool["free_stack"][:, 15]
    assert out.routes[0, slots[0]].tolist() == mn
    assert out.routes[1, slots[1]].tolist() == vl


def _engine(fabric, ur=None):
    sc = Scenario(name=f"inject-{fabric}",
                  jobs=[ScenarioJob(app="pp2", source=PP, ranks=2)],
                  topo=fabric, tick_us=2.0, horizon_ms=1.0, pool_size=256,
                  ur=ur)
    rs = MGR.resolve(sc, seed=1)
    return MGR.build(rs, device="cpu")


@pytest.mark.parametrize("fabric", ["1d", "fat_tree", "torus"])
def test_each_fabric_injects_on_its_own_path(fabric, monkeypatch):
    """A dragonfly's tick injects through ``KOPS.inject`` (the kernel on
    the card), once a tick for both batches; the fat tree and the torus
    keep their own router in the plain injection."""
    routed = []
    tables = ENG.routing_tables

    def spy(topo, dev):
        T, route_fn = tables(topo, dev)

        def counted(*a, **kw):
            routed.append(route_fn)
            return route_fn(*a, **kw)
        return T, counted

    monkeypatch.setattr(ENG, "routing_tables", spy)
    ENG.clear_engine_cache()
    try:
        ur = URDecl(ranks=8, size_bytes=512.0, interval_us=10.0)
        eng = _engine(fabric, ur=ur)
        st = eng.init_state(seed=engine_seed(1))
        KOPS.reset_launches()
        for _ in range(3):
            st = eng.tick(st)
    finally:
        ENG.clear_engine_cache()
    if fabric == "1d":
        assert KOPS.CALLS["inject"] == 3 and not routed
    else:
        assert KOPS.CALLS["inject"] == 0
        assert len(routed) == 6  # the jobs' batch and UR's, each tick
        assert {r.__name__ for r in routed} == {f"{fabric}_routes"}


def test_run_stats_and_telemetry_carry_the_injection_counts():
    from repro_torch.union.experiment import _add_run, _engine_totals

    a = ENG.RunStats(device="cuda", part_device_ms=dict(route=1.0),
                     part_ticks=8, inject_candidates=800, inject_routed=20)
    b = ENG.RunStats(device="cuda", part_device_ms=dict(route=2.0),
                     part_ticks=8, inject_candidates=800, inject_routed=5)
    m = ENG.RunStats.merged("cuda", [a, b])
    assert (m.inject_candidates, m.inject_routed) == (1600, 25)
    tot = _engine_totals()
    _add_run(tot, ENG.RunStats(device="cuda"))
    assert "inject_candidates" not in tot
    _add_run(tot, a)
    _add_run(tot, m)
    assert (tot["inject_candidates"], tot["inject_routed"]) == (2400, 45)
