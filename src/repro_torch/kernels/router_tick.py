"""The route-rate-drain of one member's pool: plain PyTorch and CUDA kernel.

For each message: gather the fair share of every link on its route, take
the minimum, drain ``min(rate * dt, rem)`` and flag the messages that are
drained. This is phase 2 of the fused drain tick without its scatters, on
a share table the caller gives.

* :func:`router_rate_drain_plain` repeats ``repro.kernels.ref.
  router_rate_drain_ref`` of the JAX package with the same float
  operations. The CPU path and the tests use it; on the card it is the
  kernel's yardstick of correctness.
* :func:`router_rate_drain_cuda` launches ``csrc/router_tick.cu`` (built
  at first use by :mod:`repro_torch.kernels._build`), which replaces the
  TPU kernel ``src/repro/kernels/router_tick.py::router_rate_drain_pallas``.
  The source's header note gives its design and its bound on an H100.

Shapes: routes (M, K) int32 link ids (-1 pad); bytes_rem (M,) f32;
active (M,) bool; share (L,) f32 bytes per microsecond per message on each
link; dt scalar microseconds. Returns (new_rem (M,) f32, rate (M,) f32,
drained (M,) bool).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def router_rate_drain_plain(routes, bytes_rem, active, share, dt):
    valid = (routes >= 0) & active[:, None]
    idx = routes.clamp(min=0).long()
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=routes.device)
    per_link = torch.where(valid, share[idx], inf)
    rate = per_link.amin(dim=1)
    rate = torch.where(active & torch.isfinite(rate), rate, 0.0)
    drain = torch.minimum(rate * dt, bytes_rem)
    new_rem = bytes_rem - drain
    drained = active & (new_rem <= 1e-6)
    return new_rem, rate, drained


@functools.cache
def _entry_points():
    """The built library's launch and error-string functions, with their C
    signatures set once (the library is built at the first call)."""
    lib = _build.load("router_tick")
    launch = lib.router_rate_drain_launch
    launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ] + [ctypes.c_void_p] * 4
    launch.restype = ctypes.c_int
    error_string = lib.router_rate_drain_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, error_string


def router_rate_drain_cuda(routes, bytes_rem, active, share, dt):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    Raises on a tensor the kernel does not take and on a launch the
    driver refuses."""
    dev = routes.device
    if dev.type != "cuda":
        raise ValueError(
            f"router_rate_drain_cuda needs CUDA tensors, got {dev}")
    M, K = routes.shape
    for x, name, dtype, shape in (
            (routes, "routes", torch.int32, (M, K)),
            (bytes_rem, "bytes_rem", torch.float32, (M,)),
            (active, "active", torch.bool, (M,)),
            (share, "share", torch.float32, (share.shape[0],))):
        _build.check_tensor("router_rate_drain", x, name, dtype, shape, dev)
    launch, error_string = _entry_points()
    new_rem = torch.empty((M,), dtype=torch.float32, device=dev)
    rate = torch.empty((M,), dtype=torch.float32, device=dev)
    drained = torch.empty((M,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr
    err = launch(
        p(routes), p(bytes_rem), p(active), p(share),
        ctypes.c_float(float(dt)), M, K, p(new_rem), p(rate), p(drained),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(
            f"router_rate_drain kernel launch failed: {msg} ({err})")
    return new_rem, rate, drained
