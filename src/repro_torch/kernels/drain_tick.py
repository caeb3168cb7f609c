"""The fused drain tick (engine steps 2-3): plain PyTorch and CUDA kernel.

One pass per tick over every member x message: link demand (messages per
link) -> fair-share rate -> per-message drain -> delivery mask, plus the
per-link and per-(app, destination router) byte counters the paper's
router windows need.

* :func:`drain_tick_plain` repeats ``repro.kernels.ref.drain_tick_ref``
  of the JAX package with the same float operations in the same order.
  The CPU path and the tests use it; on the card it is the kernel's
  yardstick of correctness.
* :func:`drain_tick_cuda` launches ``csrc/drain_tick.cu`` (built at first
  use by :mod:`repro_torch.kernels._build`), which replaces the TPU kernel
  ``src/repro/kernels/drain_tick.py::drain_tick_pallas``. The source's
  header note gives its design and its bound on an H100.

Shapes: routes (B, M, K) int32 link ids (-1 pad); bytes_rem, min_arrive
(B, M) f32; active (B, M) bool; job (B, M) int32 app ids (< n_apps);
t (B,) f32; dt scalar; bw_eff (L+1,) or (B, L+1) f32 effective per-link
bandwidth (dummy last); link_dst_router (L+1,) int32.
Returns (new_rem (B,M), rate (B,M), delivered (B,M) bool,
         link_bytes_delta (B, L+1), router_win_delta (B, n_apps, R)).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def drain_tick_plain(routes, bytes_rem, active, job, min_arrive, t, dt,
                     bw_eff, link_dst_router, n_apps, n_routers):
    B, M, K = routes.shape
    Lp = bw_eff.shape[-1]
    dev = routes.device
    valid = (routes >= 0) & active[:, :, None]
    lidx = torch.where(valid, routes.long(), Lp - 1)
    boff = (torch.arange(B, device=dev) * Lp)[:, None, None]
    flat = (lidx + boff).reshape(-1)

    n_l = torch.zeros(B * Lp, dtype=torch.float32, device=dev).index_put_(
        (flat,), valid.reshape(-1).to(torch.float32), accumulate=True)
    bw2 = bw_eff.expand(B, Lp)
    share = bw2 / torch.clamp(n_l.reshape(B, Lp), min=1.0) * 1e-6
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    per_link = torch.where(valid, share.reshape(-1)[flat].reshape(B, M, K), inf)
    rate = per_link.amin(dim=2)
    rate = torch.where(active & torch.isfinite(rate), rate, 0.0)
    drain = torch.minimum(rate * dt, bytes_rem)
    new_rem = bytes_rem - drain

    drain_b = torch.where(valid, drain[:, :, None], 0.0)
    link_bytes_delta = torch.zeros(
        B * Lp, dtype=torch.float32, device=dev).index_put_(
        (flat,), drain_b.reshape(-1), accumulate=True).reshape(B, Lp)
    rtr = link_dst_router.long()[lidx]  # (B, M, K)
    rw_flat = (
        job.long()[:, :, None] * n_routers + rtr
        + (torch.arange(B, device=dev) * n_apps * n_routers)[:, None, None]
    )
    router_win_delta = torch.zeros(
        B * n_apps * n_routers, dtype=torch.float32, device=dev).index_put_(
        (rw_flat.reshape(-1),), drain_b.reshape(-1), accumulate=True,
    ).reshape(B, n_apps, n_routers)
    delivered = active & (new_rem <= 1e-6) & (t[:, None] >= min_arrive)
    return new_rem, rate, delivered, link_bytes_delta, router_win_delta


def _check(x, name, dtype, shape, device):
    _build.check_tensor("drain_tick", x, name, dtype, shape, device)


@functools.cache
def _entry_points():
    """The built library's launch and error-string functions, with their C
    signatures set once (the library is built at the first call)."""
    lib = _build.load("drain_tick")
    launch = lib.drain_tick_launch
    launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7
    launch.restype = ctypes.c_int
    error_string = lib.drain_tick_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, error_string


def drain_tick_cuda(routes, bytes_rem, active, job, min_arrive, t, dt,
                    bw_eff, link_dst_router, n_apps, n_routers):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    Raises on a tensor the kernel does not take and on a launch the
    driver refuses."""
    dev = routes.device
    if dev.type != "cuda":
        raise ValueError(f"drain_tick_cuda needs CUDA tensors, got {dev}")
    B, M, K = routes.shape
    if K > 32:
        # the kernel's per-block sums of a hot link's adds cover route
        # slots 0-31 (one bit a slot in a 32-bit mask)
        raise ValueError(f"drain_tick_cuda: route width {K} > 32")
    launch, error_string = _entry_points()
    Lp = bw_eff.shape[-1]
    R = int(n_routers)
    A = int(n_apps)
    _check(routes, "routes", torch.int32, (B, M, K), dev)
    _check(bytes_rem, "bytes_rem", torch.float32, (B, M), dev)
    _check(active, "active", torch.bool, (B, M), dev)
    _check(job, "job", torch.int32, (B, M), dev)
    _check(min_arrive, "min_arrive", torch.float32, (B, M), dev)
    _check(t, "t", torch.float32, (B,), dev)
    _check(link_dst_router, "link_dst_router", torch.int32, (Lp,), dev)
    if bw_eff.dim() == 1:
        _check(bw_eff, "bw_eff", torch.float32, (Lp,), dev)
        bw_stride = 0
    else:
        _check(bw_eff, "bw_eff", torch.float32, (B, Lp), dev)
        bw_stride = Lp

    count = torch.empty((B, Lp), dtype=torch.int32, device=dev)
    new_rem = torch.empty((B, M), dtype=torch.float32, device=dev)
    rate = torch.empty((B, M), dtype=torch.float32, device=dev)
    delivered = torch.empty((B, M), dtype=torch.bool, device=dev)
    lb = torch.empty((B, Lp), dtype=torch.float32, device=dev)
    rw = torch.empty((B, A, R), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr
    err = launch(
        p(routes), p(bytes_rem), p(active), p(job), p(min_arrive), p(t),
        ctypes.c_float(float(dt)), p(bw_eff), ctypes.c_int64(bw_stride),
        p(link_dst_router), B, M, K, Lp, A, R,
        p(count), p(new_rem), p(rate), p(delivered), p(lb), p(rw),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"drain_tick kernel launch failed: {msg} ({err})")
    return new_rem, rate, delivered, lb, rw
