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
* :func:`link_demand_cuda` launches ``csrc/link_demand.cu``: a bucket
  sort of the valid route entries by (member, link) key, written by hand
  (zero, count, alloc, place, then each bucket put in flat order and
  folded serially), five kernels on the current stream and no library
  call. The source's header note gives its design and its bound on an
  H100; the wrapper allocates its one int32 workspace (:func:`work_words`).

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


def work_words(B: int, M: int, K: int, n_links: int) -> int:
    """int32 words of scratch the kernel takes: per (member, link) key a
    count, a bucket start and a long-bucket slot; two words (the next free
    place and the long-bucket count); per route entry its place in its
    bucket and a bucket slot."""
    return 3 * B * (n_links + 1) + 2 + 2 * B * M * K


@functools.cache
def _entry_points():
    """The built library's launch and error-string functions, with their C
    signatures set once (the library is built at the first call)."""
    lib = _build.load("link_demand")
    launch = lib.link_demand_launch
    launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 3
    launch.restype = ctypes.c_int
    error_string = lib.link_demand_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, error_string


def link_demand_cuda(routes, active, bytes_rem, n_links: int):
    """The serial per-link sums on the current stream (no synchronisation,
    no host round trip, no library kernel).

    Raises on a tensor the kernel does not take and on a launch the
    driver refuses."""
    dev = routes.device
    if dev.type != "cuda":
        raise ValueError(f"link_demand_cuda needs CUDA tensors, got {dev}")
    B, M, K = routes.shape
    Lp = n_links + 1
    for x, name, dtype, shape in ((routes, "routes", torch.int32, (B, M, K)),
                                  (active, "active", torch.bool, (B, M)),
                                  (bytes_rem, "bytes_rem", torch.float32,
                                   (B, M))):
        _build.check_tensor("link_demand", x, name, dtype, shape, dev)
    if B * M * K >= 2**31 or B * Lp >= 2**31:
        raise ValueError(f"link_demand: {B * M * K} route entries and "
                         f"{B * Lp} keys; the kernel indexes both in int32")
    work = torch.empty(work_words(B, M, K, n_links), dtype=torch.int32,
                       device=dev)
    out = torch.empty((B, Lp), dtype=torch.float32, device=dev)
    launch, error_string = _entry_points()
    p = _build.ptr
    err = launch(p(routes), p(active), p(bytes_rem), B, M, K, Lp, p(work),
                 p(out),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"link_demand kernel launch failed: {msg} ({err})")
    return out
