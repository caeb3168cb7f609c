"""A tick's injection into a dragonfly engine's pool: plain PyTorch and
CUDA kernel.

A candidate is one possible message of the tick, one for each (job, rank,
emission) position of a member (and one for each UR source); those with
``dst_rank >= 0`` are emitted. Injection gives the emitted candidates pool
slots from the member's free stack in flat candidate order, routes them
(MIN, or UGAL against the link demand of the pool before injection) and
writes their pool rows; candidates past the free slots are dropped.

* :func:`inject_plain` is the engine's injection on any fabric, with the
  fabric's router ``route_fn``: the CPU path, the fat tree's and the
  torus's path on every device, and the kernel's yardstick of correctness.
  It routes every candidate, emitted or not, and writes the pool through
  masked scatters.
* :func:`inject_cuda` launches ``csrc/inject.cu`` (built at first use by
  :mod:`repro_torch.kernels._build`) for a dragonfly's routes: it finds
  each candidate's emission order by its own scan, routes only the
  candidates that get a slot, with the same integer and float operations
  as :mod:`repro_torch.netsim.routing`, and writes their rows into one
  copy of each pool leaf. A tick's batches (the jobs', then UR's) share
  that copy. The source's header note gives its design and its bound.

Both take ``counts``, a (2,) int64 tensor or None: where given, the
candidates seen and those given a slot (so routed) are added to it in
place, over every member and batch. A traced graph of the tick passes
its tally; the kernel adds to it with no launch of its own.

Shapes: every pool leaf (B, M) (routes (B, M, 10)); free_top and dropped
(B,) int32; t (B,) f32; demand (B, L+1) f32 (the dummy link last); a
batch's candidate tensors (B, n), int32 but for size (f32) and rand
(int64 holding uint32 values). The kernel takes a candidate tensor whose
member stride is 0 (one row shared by every member).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.netsim.flat import flat_set
from repro_torch.netsim.routing import TopoArrays, compute_routes

# candidates a block of the kernel scans: 256 threads x 8 rounds (inject.cu)
TILE = 2048
ROUTE_WIDTH = 10  # [term_in, l1a, l1b, g1, l2a, l2b, g2, l3a, l3b, term_out]
# the pool leaves a tick's injection writes, copied once by the kernel path
POOL_ROWS = ("active", "src_rank", "dst_rank", "job", "size", "bytes_rem",
             "inject_t", "min_arrive", "routes")


class Candidates(NamedTuple):
    """One batch of a tick's candidate messages, each tensor (B, n)."""

    src_rank: torch.Tensor
    dst_rank: torch.Tensor  # -1: not emitted
    dst_node: torch.Tensor
    src_node: torch.Tensor
    size: torch.Tensor
    app: torch.Tensor
    rand: torch.Tensor
    # group the peak-inject sum per job (job-major blocks); otherwise the
    # whole batch is one app
    per_job_peak: bool


class InjectTables(NamedTuple):
    """A fabric's routing tables: ``T`` for the plain version, and the
    int32 copies the kernel reads (a dragonfly's; None on a fabric that
    only the plain version routes)."""

    T: TopoArrays
    local_link_id: torch.Tensor  # (R, a)
    global_gw: torch.Tensor  # (G, G, lpp)
    global_link_id: torch.Tensor  # (G, G, lpp)
    link_dst_router: torch.Tensor  # (L,)


def inject_tables(T, dragonfly: bool = True) -> InjectTables:
    """The kernel's int32 tables beside a dragonfly's ``T`` (built once an
    engine); ``T`` alone for another fabric."""
    if not dragonfly:
        return InjectTables(T, None, None, None, None)

    def i32(x):
        return x.to(torch.int32).contiguous()

    return InjectTables(T, i32(T.local_link_id), i32(T.global_gw),
                        i32(T.global_link_id), i32(T.link_dst_router))


def inject_plain(pool, metrics, t, src_ranks, dst_ranks, dsts_node,
                 srcs_node, sizes, app_id, rand, demand, per_job_peak,
                 route_fn, T, adaptive, hop_latency_us, n_jobs):
    """Allocate + route a flat batch of candidate messages (mask:
    dst>=0), batched over members. All per-candidate args are (B, n);
    ``rand`` holds uint32 values in int64. ``per_job_peak`` groups
    candidates per job for the peak-inject metric (job-major blocks);
    otherwise the whole call is one app."""
    i32, f32 = torch.int32, torch.float32
    dev = t.device
    M = pool.active.shape[1]
    L = demand.shape[1] - 1
    RW = pool.routes.shape[-1]
    J = n_jobs
    B, n = dst_ranks.shape
    mask = dst_ranks >= 0
    k = torch.cumsum(mask.to(i32), dim=1) - 1  # emission order
    n_emit = mask.sum(dim=1).to(i32)  # (B,)
    can = (k < pool.free_top[:, None]) & mask
    slot_pos = (pool.free_top[:, None] - 1 - k).clamp(0, M - 1)
    slot = torch.gather(pool.free_stack, 1, slot_pos.long())
    slot = torch.where(can, slot, M)  # M = dummy row

    offs = torch.arange(B, device=dev).repeat_interleave(n) * (L + 1)
    routes, hops = route_fn(
        T, srcs_node.reshape(-1), dsts_node.reshape(-1),
        rand.reshape(-1) & 0x7FFFFFFF,
        demand.reshape(-1), adaptive, demand_offsets=offs,
    )
    routes = routes.reshape(B, n, -1)
    hops = hops.reshape(B, n)

    active = flat_set(pool.active, slot, True, valid=can)
    src_rank = flat_set(pool.src_rank, slot, src_ranks, valid=can)
    dst_rank = flat_set(pool.dst_rank, slot, dst_ranks, valid=can)
    job = flat_set(pool.job, slot, app_id, valid=can)
    size_a = flat_set(pool.size, slot, sizes, valid=can)
    rem = flat_set(pool.bytes_rem, slot, sizes, valid=can)
    inj = flat_set(pool.inject_t, slot, t[:, None], valid=can)
    mina = flat_set(
        pool.min_arrive, slot,
        t[:, None] + hops.to(f32) * hop_latency_us,
        valid=can,
    )
    # route rows: scatter whole (K,) rows per slot, dummy row last
    row_idx = slot.long() + (torch.arange(B, device=dev) * M)[:, None]
    row_idx = torch.where(can, row_idx, B * M)
    rts = torch.cat([
        pool.routes.reshape(B * M, -1),
        pool.routes.new_full((1, RW), -1),
    ])
    rts.index_put_((row_idx.reshape(-1),), routes.reshape(B * n, -1))
    rts = rts[: B * M].reshape(pool.routes.shape)

    n_alloc = torch.minimum(n_emit, pool.free_top)
    pool = pool._replace(
        active=active, src_rank=src_rank, dst_rank=dst_rank, job=job,
        size=size_a, bytes_rem=rem, inject_t=inj, min_arrive=mina,
        routes=rts, free_top=pool.free_top - n_alloc,
        dropped=pool.dropped + (n_emit - n_alloc),
    )
    inj_bytes = torch.where(can, sizes, torch.zeros((), dtype=f32,
                                                    device=dev))
    metrics = metrics._replace(
        peak_inject=torch.maximum(metrics.peak_inject,
                                  _peak(inj_bytes, per_job_peak, J)))
    return pool, metrics


def _peak(inj_bytes, per_job_peak, n_jobs):
    """A batch's bytes injected per (member, app), the largest app's."""
    if per_job_peak:
        B = inj_bytes.shape[0]
        return inj_bytes.reshape(B, n_jobs, -1).sum(dim=2).amax(dim=1)
    return inj_bytes.sum(dim=1)


def inject_batches_plain(pool, metrics, t, batches: Sequence[Candidates],
                         demand, tables: InjectTables, adaptive,
                         hop_latency_us, n_jobs, counts=None,
                         route_fn=compute_routes):
    """:func:`inject_plain` of each batch in turn, routed by ``route_fn``
    (a dragonfly's :func:`~repro_torch.netsim.routing.compute_routes`
    unless another fabric's is given) over ``tables.T``."""
    free_top0 = pool.free_top
    for c in batches:
        pool, metrics = inject_plain(
            pool, metrics, t, *c[:7], demand, c.per_job_peak,
            route_fn, tables.T, adaptive, hop_latency_us, n_jobs)
    if counts is not None:
        counts[:1].add_(sum(c.dst_rank.numel() for c in batches))
        counts[1:].add_((free_top0 - pool.free_top).sum())
    return pool, metrics


@functools.cache
def _entry_points():
    """The built library's copy, launch and error-string functions, with
    their C signatures set once (the library is built at the first
    call)."""
    lib = _build.load("inject")
    copy = lib.inject_copy_launch
    copy.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    copy.restype = ctypes.c_int
    launch = lib.inject_launch
    launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int]  # candidates, strides, n
        + [ctypes.c_void_p] * 5  # free stack, free top, dropped, t, demand
        + [ctypes.c_int]  # Lp
        + [ctypes.c_void_p] * 5  # the routing tables, link_bw
        + [ctypes.c_int] * 8  # G, a, p, cols, lpp, n_nodes, 2d, adaptive
        + [ctypes.c_float]  # hop latency
        + [ctypes.c_void_p] + [ctypes.c_int] * 3  # pool rows, B, M, tiles
        + [ctypes.c_void_p] * 6)  # tile counts, free top / dropped out,
    #                               injected bytes, counts, stream
    launch.restype = ctypes.c_int
    error_string = lib.inject_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return copy, launch, error_string


def _raise_on(err, error_string, what):
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"inject {what} failed: {msg} ({err})")


def _candidate(x, name, dtype, B, n, dev):
    """A candidate tensor as the kernel takes it: (B, n) of ``dtype`` on
    ``dev`` with unit stride along n; returns it and its member stride."""
    if x.dtype != dtype or tuple(x.shape) != (B, n) or x.device != dev:
        raise ValueError(
            f"inject: {name} must be a {dtype} tensor of shape {(B, n)} on "
            f"{dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    if n > 1 and x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def inject_cuda(pool, metrics, t, batches: Sequence[Candidates], demand,
                tables: InjectTables, adaptive, hop_latency_us, n_jobs,
                counts=None):
    """Launch the CUDA kernels on the current stream (no synchronisation):
    one copy of the written pool leaves, then each batch's scan and
    injection into that copy. The peak-inject metric is taken from the
    kernel's injected bytes as :func:`inject_plain` takes it.

    Raises on a tensor the kernel does not take and on a launch the
    driver refuses."""
    dev = pool.active.device
    if dev.type != "cuda":
        raise ValueError(f"inject_cuda needs CUDA tensors, got {dev}")
    B, M = pool.active.shape
    Lp = demand.shape[-1]
    T = tables.T
    copy, launch, error_string = _entry_points()
    p = _build.ptr

    def check(x, name, dtype, shape):
        _build.check_tensor("inject", x, name, dtype, shape, dev)

    check(pool.free_stack, "free_stack", torch.int32, (B, M))
    check(pool.free_top, "free_top", torch.int32, (B,))
    check(pool.dropped, "dropped", torch.int32, (B,))
    check(t, "t", torch.float32, (B,))
    check(demand, "demand", torch.float32, (B, T.n_links + 1))
    check(tables.local_link_id, "local_link_id", torch.int32,
          (T.n_routers, T.a))
    for name in ("global_gw", "global_link_id"):
        check(getattr(tables, name), name, torch.int32, (T.G, T.G, T.lpp))
    check(tables.link_dst_router, "link_dst_router", torch.int32,
          (T.n_links,))
    check(T.link_bw, "link_bw", torch.float32, (T.n_links,))
    if counts is not None:
        check(counts, "counts", torch.int64, (2,))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    src = [getattr(pool, f).contiguous() for f in POOL_ROWS]
    want = [(torch.bool, (B, M))] + [(torch.int32, (B, M))] * 3 \
        + [(torch.float32, (B, M))] * 4 + [(torch.int32,
                                            (B, M, ROUTE_WIDTH))]
    for f, x, (dtype, shape) in zip(POOL_ROWS, src, want):
        check(x, f, dtype, shape)
    if B == 0 or M == 0:
        return pool, metrics
    out = [torch.empty_like(x) for x in src]
    n_seg = len(src)
    _raise_on(copy(
        (ctypes.c_void_p * n_seg)(*[x.data_ptr() for x in src]),
        (ctypes.c_void_p * n_seg)(*[x.data_ptr() for x in out]),
        (ctypes.c_int64 * n_seg)(*[x.numel() * x.element_size()
                                   for x in src]),
        n_seg, stream), error_string, "copy")
    rows = (ctypes.c_void_p * n_seg)(*[x.data_ptr() for x in out])

    free_top, dropped = pool.free_top, pool.dropped
    peak = metrics.peak_inject
    for c in batches:
        n = c.dst_rank.shape[1]
        cols = []
        for name, dtype in (("src_rank", torch.int32),
                            ("dst_rank", torch.int32),
                            ("dst_node", torch.int32),
                            ("src_node", torch.int32),
                            ("size", torch.float32), ("app", torch.int32),
                            ("rand", torch.int64)):
            cols.append(_candidate(getattr(c, name), name, dtype, B, n, dev))
        tiles = max(1, -(-n // TILE))
        tile_count = torch.empty((B, tiles), dtype=torch.int32, device=dev)
        free_top_out = torch.empty_like(free_top)
        dropped_out = torch.empty_like(dropped)
        inj_bytes = torch.empty((B, n), dtype=torch.float32, device=dev)
        _raise_on(launch(
            (ctypes.c_void_p * 7)(*[x.data_ptr() for x, _ in cols]),
            (ctypes.c_int64 * 7)(*[s for _, s in cols]), n,
            p(pool.free_stack), p(free_top), p(dropped), p(t), p(demand),
            Lp, p(tables.local_link_id), p(tables.global_gw),
            p(tables.global_link_id), p(tables.link_dst_router),
            p(T.link_bw), T.G, T.a, T.p, T.cols, T.lpp, T.n_nodes,
            int(T.variant_2d), int(bool(adaptive)),
            ctypes.c_float(float(hop_latency_us)), rows, B, M, tiles,
            p(tile_count), p(free_top_out), p(dropped_out), p(inj_bytes),
            None if counts is None else p(counts), stream),
            error_string, "launch")
        free_top, dropped = free_top_out, dropped_out
        peak = torch.maximum(peak, _peak(inj_bytes, c.per_job_peak, n_jobs))
    pool = pool._replace(free_top=free_top, dropped=dropped,
                         **dict(zip(POOL_ROWS, out)))
    return pool, metrics._replace(peak_inject=peak)

