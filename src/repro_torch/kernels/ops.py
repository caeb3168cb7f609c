"""Public kernel entry points of the port: device dispatch + launch counts.

A wrapper picks its path from where its tensors lie: CPU tensors take the
plain PyTorch version (so do ``meta`` tensors, whose call only traces
shapes), CUDA tensors launch the hand-written kernel or raise, tensors on
any other device raise. There is no fallback from the kernel to the plain
version. A wrapper takes local tensors: the sharded model hands the SSD
scan each rank's own rows through ``local_map``
(:func:`repro_torch.models.mamba2.ssd_chunked`).

``CALLS`` counts, per wrapper, every call; ``LAUNCHES`` counts the calls
that launched the wrapper's kernels, once a call however many CUDA
launches the call takes (a drain tick: zero, count, drain; link demand:
zero, count, alloc, place, fold; an SSD scan: the C Bᵀ pre-pass and the
scan; its backward: four, C Bᵀ, the states and dh per row over the
chunks, the main pass per row and chunk, and the sums of dA over the
chunks and of dB and dC over a group's rows; a route-rate-drain: one;
an injection: a copy of the pool's leaves, then a count and an injection
for each batch of candidates).
The SSD scan's backward is called by autograd, from the backward of a
scan that ran on the card. A run on the card that went through the
kernels every time shows ``LAUNCHES == CALLS``; :func:`reset_launches`
sets every count to 0.
"""
from __future__ import annotations

from typing import Dict

from torch.distributed.tensor import DTensor

from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain
from repro_torch.kernels.inject import inject_batches_plain, inject_cuda
from repro_torch.kernels.link_demand import (
    link_demand_cuda, link_demand_plain)
from repro_torch.kernels.router_tick import (
    router_rate_drain_cuda, router_rate_drain_plain)
from repro_torch.kernels.ssd_scan import (
    SSDScan, ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_plain)

KERNELS = ("drain_tick", "link_demand", "router_rate_drain", "ssd_scan",
           "ssd_scan_bwd", "inject")
CALLS: Dict[str, int] = dict.fromkeys(KERNELS, 0)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        CALLS[k] = 0
        LAUNCHES[k] = 0


def _dispatch(name, device, plain, cuda, *args):
    """Count the call; the plain version for CPU tensors and for ``meta``
    ones (where it traces shapes alone, as the dry run does), the kernel
    for CUDA tensors (counted as a launch); any other device raises."""
    if any(isinstance(a, DTensor) for a in args):
        raise TypeError(f"{name}: takes each rank's local tensors, not "
                        "DTensors (map the call with local_map)")
    CALLS[name] += 1
    if device.type in ("cpu", "meta"):
        return plain(*args)
    if device.type != "cuda":
        raise TypeError(f"{name}: no kernel for tensors on {device}")
    out = cuda(*args)
    LAUNCHES[name] += 1
    return out


def drain_tick(routes, bytes_rem, active, job, min_arrive, t, dt, bw_eff,
               link_dst_router, *, n_apps: int, n_routers: int):
    """Fused drain tick (engine steps 2-3) over an explicit member batch.

    Same arguments as the JAX package's ``kernels.ops.drain_tick``;
    ``bw_eff`` is ``(L+1,)`` or per-member ``(B, L+1)``. See
    :mod:`repro_torch.kernels.drain_tick` for shapes and results.
    """
    return _dispatch("drain_tick", routes.device, drain_tick_plain,
                     drain_tick_cuda, routes, bytes_rem, active, job,
                     min_arrive, t, dt, bw_eff, link_dst_router, n_apps,
                     n_routers)


def link_demand(routes, active, bytes_rem, n_links: int):
    """(B, L+1) bytes outstanding per link of the active messages, summed
    serially in flat index order on every device (UGAL compares them).
    See :mod:`repro_torch.kernels.link_demand`."""
    return _dispatch("link_demand", routes.device, link_demand_plain,
                     link_demand_cuda, routes, active, bytes_rem, n_links)


def inject(pool, metrics, t, batches, demand, tables, *, adaptive: bool,
           hop_latency_us: float, n_jobs: int, counts=None):
    """A tick's injection into a dragonfly engine's pool: each batch of
    candidates (:class:`~repro_torch.kernels.inject.Candidates`, the
    jobs' then UR's) in turn, against the link demand ``demand`` (B, L+1).
    Returns the new pool and metrics (``peak_inject``); adds the
    candidates seen and routed to ``counts`` where given. See
    :mod:`repro_torch.kernels.inject`."""
    return _dispatch("inject", pool.active.device, inject_batches_plain,
                     inject_cuda, pool, metrics, t, tuple(batches), demand,
                     tables, adaptive, hop_latency_us, n_jobs, counts)


def router_rate_drain(routes, bytes_rem, active, share, dt):
    """Route-rate-drain of one member's pool against a share table.

    Same arguments as the JAX package's ``kernels.ops.router_rate_drain``
    (without its kernel switches): routes (M, K) int32, bytes_rem (M,) f32,
    active (M,) bool, share (L,) f32, dt scalar. Returns (new_rem, rate,
    drained). See :mod:`repro_torch.kernels.router_tick`.
    """
    return _dispatch("router_rate_drain", routes.device,
                     router_rate_drain_plain, router_rate_drain_cuda,
                     routes, bytes_rem, active, share, dt)


def ssd_scan(x, dt, A, Bm, Cm):
    """Head-flattened SSD chunk scan: (y, final state), differentiable (on
    the CPU by autograd through the plain version, on the card through
    :func:`ssd_scan_bwd`).

    The JAX package's ``kernels.ops.ssd_scan`` with B/C given per group of
    rows (one group per row there); see :mod:`repro_torch.kernels.ssd_scan`
    for shapes.
    """
    return _dispatch("ssd_scan", x.device, ssd_scan_plain, SSDScan.apply,
                     x, dt, A, Bm, Cm)


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh=None):
    """The scan's gradients (dx, ddt, dA per row, dB, dC per group) against
    dy and the final state's dh (None: zero). See
    :mod:`repro_torch.kernels.ssd_scan`."""
    return _dispatch("ssd_scan_bwd", x.device, ssd_scan_bwd_plain,
                     ssd_scan_bwd_cuda, x, dt, A, Bm, Cm, dy, dh)
