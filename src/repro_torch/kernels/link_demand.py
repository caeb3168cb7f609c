"""The simulator's link demand: bytes outstanding per link, summed serially.

UGAL compares these sums, so they must be the same bits on every device:
the sum over the active messages crossing a link is taken serially in
the order of their flat (member, message, route slot) index, the order
the JAX engine's scatter-add takes on the CPU.

* :func:`link_demand_plain` is that scatter-add: ``index_add_``, which
  the CPU sums serially in index order, whatever the number of threads
  (``index_put_(accumulate=True)`` does not: with several threads it sums
  a large index list in parallel). On CUDA ``index_add_`` adds with
  atomics in no fixed order, so the card never takes it.
* :func:`link_demand_cuda` sorts the keys stably and launches
  ``csrc/link_demand.cu``, which adds each link's run serially. The
  source's header note gives its design and its bound on an H100.

Shapes: routes (B, M, K) int32 link ids (-1 pad); active (B, M) bool;
bytes_rem (B, M) f32. Returns (B, L+1) f32 with the dummy last column 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def link_demand_plain(routes, active, bytes_rem, n_links: int):
    B, M, K = routes.shape
    Lp = n_links + 1
    valid = (routes >= 0) & active[:, :, None]
    lidx = torch.where(valid, routes.long(), n_links)  # dummy last column
    lidx = lidx + (torch.arange(B, device=lidx.device) * Lp)[:, None, None]
    vals = (bytes_rem[:, :, None] * valid).reshape(-1)
    return torch.zeros(B * Lp, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, lidx.reshape(-1), vals).reshape(B, Lp)


@functools.cache
def _entry_points():
    """The built library's launch and error-string functions, with their C
    signatures set once (the library is built at the first call)."""
    lib = _build.load("link_demand")
    launch = lib.link_demand_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    error_string = lib.link_demand_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, error_string


def link_demand_cuda(routes, active, bytes_rem, n_links: int):
    """Stable sort of the (member, link) keys, then the serial per-link sums
    on the current stream (no synchronisation, no host round trip).

    Raises on a tensor the kernel does not take and on a launch the
    driver refuses."""
    dev = routes.device
    if dev.type != "cuda":
        raise ValueError(f"link_demand_cuda needs CUDA tensors, got {dev}")
    B, M, K = routes.shape
    n_keys = B * (n_links + 1)
    for x, name, dtype, shape in ((routes, "routes", torch.int32, (B, M, K)),
                                  (active, "active", torch.bool, (B, M)),
                                  (bytes_rem, "bytes_rem", torch.float32,
                                   (B, M))):
        _build.check_tensor("link_demand", x, name, dtype, shape, dev)
    valid = (routes >= 0) & active[:, :, None]
    keys = routes.long() + (torch.arange(B, device=dev)
                            * (n_links + 1))[:, None, None]
    keys = torch.where(valid, keys, n_keys).reshape(-1)
    sorted_keys, order = torch.sort(keys, stable=True)
    vals = bytes_rem[:, :, None].expand(B, M, K).reshape(-1)[order]
    starts = torch.searchsorted(
        sorted_keys, torch.arange(n_keys + 1, device=dev))
    out = torch.empty(n_keys, dtype=torch.float32, device=dev)
    launch, error_string = _entry_points()
    p = _build.ptr
    err = launch(p(vals), p(starts), n_keys, p(out),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"link_demand kernel launch failed: {msg} ({err})")
    return out.reshape(B, n_links + 1)
