"""The injection kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/inject.cu`` at first use); skips without a
card. Imports nothing of JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_inject_cuda.py

Every pool leaf the injection writes, ``free_top`` and ``dropped`` must
equal :func:`~repro_torch.kernels.inject.inject_plain` run on CPU copies
of the inputs bit for bit; ``peak_inject``, a float sum taken in another
order on the card, to the judge's limit (relative 1e-4). Covered: both
dragonflies at their small and paper sizes, batches of 1, 2 and 8
members, UGAL and MIN, an empty tick, a tick where every candidate
emits, a pool with fewer free slots than emitted candidates (drops in
flat order), failed links carrying 1e18 demand, a planted tie of UGAL's
compare (MIN) beside a cost one ulp above it (Valiant), the jobs' batch
followed by UR's, input leaves left as they were, the wrapper's counts,
the tally of candidates seen and routed, a captured graph's replay, and a captured paper graph's member report on
both dragonflies against the CPU run's. The input generators here are
shared with ``tests/test_torch_inject.py`` and ``chip_smoke.py``.
"""
from collections import namedtuple

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.inject import (
    Candidates, inject_batches_plain, inject_cuda, inject_tables)
from repro_torch.netsim.engine import PoolState
from repro_torch.netsim.fabric import get_fabric
from repro_torch.netsim.routing import _min_route, _val_route, topo_arrays

# the one metric the injection updates
Peak = namedtuple("Peak", "peak_inject")
HOP_LATENCY_US = 0.5
WRITTEN = ("active", "src_rank", "dst_rank", "job", "size", "bytes_rem",
           "inject_t", "min_arrive", "routes", "free_top", "dropped")


def make_pool(topo, B, M, free, seed):
    """A pool with random rows, a shuffled free stack per member and
    ``free[b]`` free slots (numpy leaves)."""
    rng = np.random.default_rng(seed)
    L = topo.n_links
    return dict(
        active=rng.random((B, M)) < 0.3,
        src_rank=rng.integers(0, 4096, (B, M), dtype=np.int32),
        dst_rank=rng.integers(0, 4096, (B, M), dtype=np.int32),
        job=rng.integers(0, 6, (B, M), dtype=np.int32),
        size=rng.integers(8, 1 << 20, (B, M)).astype(np.float32),
        bytes_rem=(rng.random((B, M)) * 1e5).astype(np.float32),
        inject_t=(rng.random((B, M)) * 100).astype(np.float32),
        min_arrive=(rng.random((B, M)) * 100).astype(np.float32),
        routes=rng.integers(-1, L, (B, M, 10), dtype=np.int32),
        free_stack=np.stack([rng.permutation(M) for _ in range(B)])
        .astype(np.int32),
        free_top=np.asarray(free, np.int32),
        dropped=rng.integers(0, 3, (B,), dtype=np.int32),
    )


def make_candidates(topo, B, n_jobs, per_job, emit, seed, app0=0,
                    per_job_peak=True):
    """A batch of ``n_jobs * per_job`` candidates a member, each emitted
    with probability ``emit`` (numpy leaves; the rank and app rows shared
    by every member, as the engine passes them)."""
    rng = np.random.default_rng(seed)
    n = n_jobs * per_job
    N = topo.n_nodes
    return dict(
        src_rank=np.tile(np.arange(per_job, dtype=np.int32), n_jobs),
        dst_rank=np.where(rng.random((B, n)) < emit,
                          rng.integers(0, per_job, (B, n)), -1)
        .astype(np.int32),
        dst_node=rng.integers(0, N, (B, n), dtype=np.int32),
        src_node=rng.integers(0, N, (B, n), dtype=np.int32),
        size=rng.integers(8, 1 << 20, (B, n)).astype(np.float32),
        app=np.repeat(np.arange(app0, app0 + n_jobs, dtype=np.int32),
                      per_job),
        rand=rng.integers(0, 2**32, (B, n), dtype=np.int64),
        per_job_peak=per_job_peak,
    )


def make_demand(topo, B, seed, dead=0):
    """(B, L+1) link demand, most links idle, and ``dead`` failed links a
    member carrying 1e18 more, as the engine adds it."""
    rng = np.random.default_rng(seed)
    L = topo.n_links
    d = (rng.random((B, L + 1)) * 1e6 * (rng.random((B, L + 1)) < 0.3))
    d = d.astype(np.float32)
    d[:, L] = 0.0
    for b in range(B):
        d[b, rng.choice(L, dead, replace=False)] += np.float32(1e18)
    return d


def on(x, device):
    return torch.as_tensor(x, device=device)


def pool_on(p, device):
    return PoolState(**{k: on(v, device) for k, v in p.items()})


def batch_on(c, device):
    B = c["dst_rank"].shape[0]
    cols = {k: on(v, device) for k, v in c.items() if k != "per_job_peak"}
    for k in ("src_rank", "app"):  # one row for every member
        cols[k] = cols[k].expand(B, -1)
    return Candidates(per_job_peak=c["per_job_peak"], **cols)


def inputs(topo, pool, batches, demand, t, device):
    """The wrapper's arguments on ``device``."""
    B = pool["free_top"].shape[0]
    t = np.array(np.broadcast_to(np.asarray(t, np.float32), (B,)))
    return (pool_on(pool, device),
            Peak(on(np.full((), 3.0, np.float32), device)),
            on(t, device),
            tuple(batch_on(c, device) for c in batches),
            on(demand, device), tables_on(topo, device))


def run_pair(card, topo, pool, batches, demand, t, adaptive=True, n_jobs=4):
    """The kernel's result and the plain version's on the CPU."""
    kw = dict(adaptive=adaptive, hop_latency_us=HOP_LATENCY_US,
              n_jobs=n_jobs)
    got = inject_cuda(*inputs(topo, pool, batches, demand, t, card), **kw)
    want = inject_batches_plain(
        *inputs(topo, pool, batches, demand, t, "cpu"), **kw)
    return got, want


_TABLES = {}


def tables_on(topo, device):
    """A dragonfly's injection tables on ``device``, built once."""
    key = (topo.cache_key(), str(device))
    if key not in _TABLES:
        _TABLES[key] = inject_tables(topo_arrays(topo, device))
    return _TABLES[key]


def assert_same(got, want):
    (gp, gm), (wp, wm) = got, want
    for k in WRITTEN:
        a, b = getattr(gp, k).cpu(), getattr(wp, k).cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        same = (a.view(torch.uint8) == b.view(torch.uint8)) \
            if a.dtype == torch.bool else (a == b)
        assert bool(same.all()), (
            f"{k}: {int((~same).sum())} of {same.numel()} differ")
    torch.testing.assert_close(gm.peak_inject.cpu(), wm.peak_inject.cpu(),
                               rtol=1e-4, atol=0.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (csrc/inject.cu)")
    return torch.device("cuda", 0)


# (fabric, scale, members, routing, candidates a job)
CASES = [
    ("1d", "small", 1, "ADP", 512),
    ("1d", "small", 2, "MIN", 512),
    ("2d", "small", 8, "ADP", 512),
    ("2d", "small", 2, "MIN", 300),
    ("1d", "paper", 8, "ADP", 16384),
    ("1d", "paper", 2, "MIN", 16384),
    ("2d", "paper", 2, "ADP", 32768),
    ("2d", "paper", 8, "ADP", 32768),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale,B,routing,per_job", CASES)
def test_kernel_equals_plain(card, name, scale, B, routing, per_job):
    topo = get_fabric(name, scale)
    M = 65536 if scale == "paper" else 2048
    pool = make_pool(topo, B, M, [M // 2 + 7 * b for b in range(B)], 1)
    jobs = make_candidates(topo, B, 4, per_job, 0.02, 2)
    got, want = run_pair(card, topo, pool, [jobs], make_demand(topo, B, 3),
                         [125.0 + 5 * b for b in range(B)],
                         adaptive=routing == "ADP")
    assert_same(got, want)
    assert bool((got[0].free_top < on(pool["free_top"], card)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [0.0, 1.0])
def test_empty_and_full_ticks(card, emit):
    """No candidate emits: the pool is a copy of its input. Every
    candidate emits, and every one gets a slot."""
    topo = get_fabric("1d", "small")
    B, M = 2, 4096
    pool = make_pool(topo, B, M, [M, M - 100], 4)
    jobs = make_candidates(topo, B, 3, 1000, emit, 5)
    got, want = run_pair(card, topo, pool, [jobs], make_demand(topo, B, 6),
                         40.0, n_jobs=3)
    assert_same(got, want)
    if emit == 0.0:
        for k in WRITTEN:
            assert torch.equal(getattr(got[0], k).cpu(), on(pool[k], "cpu"))
    else:
        assert got[0].free_top.tolist() == [M - 3000, M - 3100]
        assert got[0].dropped.tolist() == pool["dropped"].tolist()


@pytest.mark.cuda
def test_drops_past_the_free_slots_in_flat_order(card):
    topo = get_fabric("2d", "small")
    B, M = 8, 1024
    pool = make_pool(topo, B, M, [0, 1, 17, 100, 300, 2047 % M, 5, 64], 7)
    jobs = make_candidates(topo, B, 5, 2048, 0.2, 8)
    got, want = run_pair(card, topo, pool, [jobs], make_demand(topo, B, 9),
                         10.0, n_jobs=5)
    assert_same(got, want)
    assert got[0].free_top.tolist() == [0] * B
    emitted = (jobs["dst_rank"] >= 0).sum(1)
    assert got[0].dropped.tolist() == (
        pool["dropped"] + emitted - pool["free_top"]).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["1d", "2d"])
def test_failed_links_steer_the_routes(card, name):
    topo = get_fabric(name, "paper")
    B, M = 2, 65536
    pool = make_pool(topo, B, M, [M, M], 10)
    jobs = make_candidates(topo, B, 4, 8192, 0.2, 11)
    demand = make_demand(topo, B, 12, dead=4000)
    got, want = run_pair(card, topo, pool, [jobs], demand, 300.0)
    assert_same(got, want)


@pytest.mark.cuda
def test_jobs_then_ur(card):
    """The jobs' batch and then UR's, as the tick passes them: UR's
    candidates continue the emission order, and their drops too."""
    topo = get_fabric("1d", "paper")
    B, M = 8, 65536
    free = [M, 2000, 700, 0, 5000, 1300, 40000, 1]
    pool = make_pool(topo, B, M, free, 13)
    jobs = make_candidates(topo, B, 4, 16384, 0.03, 14)
    ur = make_candidates(topo, B, 1, 4096, 0.5, 15, app0=4,
                         per_job_peak=False)
    got, want = run_pair(card, topo, pool, [jobs, ur],
                         make_demand(topo, B, 16, dead=10), 55.0)
    assert_same(got, want)


def tie_case(topo, T, seed):
    """One inter-group candidate and two members' demand: in member 0 the
    minimal route's cost equals 2 x the Valiant one's + 1e-6f, rounded as
    float32 does it and above the same sum taken in double; in member 1 it
    is one ulp above. Returns (src, dst, rand, demand (2, L+1), minimal
    route, Valiant route)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    L = topo.n_links
    bw = T.link_bw.cpu().numpy()
    while True:
        src, dst = (int(x) for x in rng.integers(0, topo.n_nodes, 2))
        rand = int(rng.integers(0, 2**31))
        g_s = src // topo.nodes_per_router // topo.routers_per_group
        g_d = dst // topo.nodes_per_router // topo.routers_per_group
        if g_s == g_d:
            continue
        G = topo.n_groups
        g_i = (rand // 7) % G
        for g in (g_s, g_d, g_s):
            g_i = (g_i + 1) % G if g_i == g else g_i
        one = [torch.as_tensor([x]) for x in (src, dst, rand)]
        mn = _min_route(T, *one)[0].tolist()
        vl = _val_route(T, one[0], one[1], torch.as_tensor([g_i]),
                        one[2])[0].tolist()
        a, v = mn[3], vl[3]
        if a in vl or v in mn:
            continue
        break
    while True:
        c = f(rng.random() * 1e-5)
        d_v = f(c * bw[v])
        c = f(d_v / bw[v])
        target = f(f(f(2.0) * c) + f(1e-6))
        if float(target) <= 2.0 * float(c) + 1e-6:
            continue
        d_a = f(target * bw[a])
        while f(d_a / bw[a]) < target:
            d_a = np.nextafter(d_a, f(np.inf))
        while f(d_a / bw[a]) > target:
            d_a = np.nextafter(d_a, f(0))
        if f(d_a / bw[a]) == target:
            break
    above = d_a
    while f(above / bw[a]) <= target:
        above = np.nextafter(above, f(np.inf))
    demand = np.zeros((2, L + 1), np.float32)
    demand[:, v] = d_v
    demand[0, a] = d_a
    demand[1, a] = above
    return src, dst, rand, demand, mn, vl


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["1d", "2d"])
def test_planted_tie_keeps_the_minimal_route(card, name):
    topo = get_fabric(name, "small")
    T = topo_arrays(topo, "cpu")
    src, dst, rand, demand, mn, vl = tie_case(topo, T, 17)
    B, M = 2, 64
    pool = make_pool(topo, B, M, [M, M], 18)
    jobs = make_candidates(topo, B, 1, 8, 0.0, 19)
    jobs["dst_rank"][:, 3] = 1
    jobs["src_node"][:, 3] = src
    jobs["dst_node"][:, 3] = dst
    jobs["rand"][:, 3] = rand
    got, want = run_pair(card, topo, pool, [jobs], demand, 20.0, n_jobs=1)
    assert_same(got, want)
    slots = [int(pool["free_stack"][b, M - 1]) for b in range(B)]
    routes = got[0].routes.cpu()
    assert routes[0, slots[0]].tolist() == mn
    assert routes[1, slots[1]].tolist() == vl


@pytest.mark.cuda
def test_inputs_stay_and_the_wrapper_counts(card):
    topo = get_fabric("2d", "small")
    B, M = 3, 2048
    pool = make_pool(topo, B, M, [M, 100, 3], 20)
    jobs = make_candidates(topo, B, 4, 600, 0.05, 21)
    args = inputs(topo, pool, [jobs], make_demand(topo, B, 22),
                  [1.0, 2.0, 3.0], card)
    before = [x.clone() for x in args[0]]
    KOPS.reset_launches()
    out, _ = KOPS.inject(*args, adaptive=True, hop_latency_us=0.5, n_jobs=4)
    assert KOPS.CALLS["inject"] == KOPS.LAUNCHES["inject"] == 1
    for x, y in zip(args[0], before):
        assert torch.equal(x, y)
    assert not torch.equal(out.routes, args[0].routes)


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_call(card):
    topo = get_fabric("1d", "paper")
    B, M = 2, 65536
    pool = make_pool(topo, B, M, [M, 900], 23)
    jobs = make_candidates(topo, B, 4, 16384, 0.02, 24)
    ur = make_candidates(topo, B, 1, 4096, 0.3, 25, app0=4,
                         per_job_peak=False)
    args = inputs(topo, pool, [jobs, ur],
                  make_demand(topo, B, 26, dead=3), [7.0, 9.0], card)
    kw = dict(adaptive=True, hop_latency_us=0.5, n_jobs=4)
    eager = inject_cuda(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        inject_cuda(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = inject_cuda(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert_same(captured, eager)


@pytest.mark.cuda
def test_the_kernel_tallies_as_the_plain_version_does(card):
    """The candidates seen and routed, added to a given tally: the
    kernel's equal the plain version's, a captured graph adds them at
    every replay, and a call with no tally leaves the results as they
    are."""
    topo = get_fabric("1d", "paper")
    B, M = 2, 65536
    pool = make_pool(topo, B, M, [M, 900], 27)
    jobs = make_candidates(topo, B, 4, 16384, 0.02, 28)
    ur = make_candidates(topo, B, 1, 4096, 0.3, 29, app0=4,
                         per_job_peak=False)
    args = [inputs(topo, pool, [jobs, ur], make_demand(topo, B, 30),
                   [7.0, 9.0], d) for d in (card, "cpu")]
    kw = dict(adaptive=True, hop_latency_us=0.5, n_jobs=4)
    tally = torch.zeros(2, dtype=torch.int64, device=card)
    plain = torch.zeros(2, dtype=torch.int64)
    got = inject_cuda(*args[0], **kw, counts=tally)
    want = inject_batches_plain(*args[1], **kw, counts=plain)
    assert_same(got, want)
    routed = int((args[0][0].free_top - got[0].free_top).sum())
    assert tally.tolist() == plain.tolist() == [B * (4 * 16384 + 4096),
                                                 routed]
    assert_same(inject_cuda(*args[0], **kw), got)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        inject_cuda(*args[0], **kw)
    torch.cuda.current_stream().wait_stream(side)
    tally.zero_()
    with torch.cuda.graph(graph):
        inject_cuda(*args[0], **kw, counts=tally)
    torch.cuda.synchronize()
    assert tally.tolist() == [0, 0]  # nothing ran while it was captured
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert tally.tolist() == [2 * v for v in plain.tolist()]


@pytest.mark.cuda
@pytest.mark.parametrize("topo_name", ["1d", "2d"])
def test_paper_graph_report_equals_the_cpu_run(card, topo_name):
    """A paper scenario run on the card (graph replays through the
    kernel) and on the CPU (the plain injection): the same member
    report."""
    from repro_torch.launch.sim import run_sim
    from torch_parity import report_mismatches

    workload = "workload1" if topo_name == "1d" else "workload3"
    kw = dict(scale="paper", seed=0, horizon_ms=0.3, tick_us=5.0)
    KOPS.reset_launches()
    got = run_sim(workload, topo_name, "RG", "ADP", device=card, **kw)
    run = got.pop("engine_run")
    assert run["graph_launches"]["inject"] == run["graph_calls"]["inject"] \
        == run["graph_ticks"]
    want = run_sim(workload, topo_name, "RG", "ADP", device="cpu", **kw)
    want.pop("engine_run")
    assert not report_mismatches(got, want)
