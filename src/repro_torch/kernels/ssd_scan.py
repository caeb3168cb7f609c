"""The Mamba-2 SSD chunk scan: plain PyTorch and CUDA kernel.

For each (batch * head) row, over its chunks in order, with h the state
entering a chunk and cs = cumsum(dt * A) over the chunk's Q steps::

    y = (C Bᵀ ∘ L) (x·dt)  +  (C h) ∘ exp(cs)        L[t,s] = exp(cs_t - cs_s), s <= t
    h ← h·exp(cs[-1]) + Bᵀ ((x·dt) ∘ exp(cs[-1] - cs))

* :func:`ssd_scan_plain` is ``repro.kernels.ref.ssd_chunk_ref`` of the JAX
  package in PyTorch, batched over the rows with a loop over the chunks.
  The CPU path and the tests use it; on the card it is the kernel's
  yardstick of correctness.
* :func:`ssd_scan_cuda` launches ``csrc/ssd_scan.cu`` (built at first use
  by :mod:`repro_torch.kernels._build`), which replaces the TPU kernel
  ``src/repro/kernels/ssd_scan.py::ssd_scan_pallas``. A call is two CUDA
  kernels on the current stream. A pre-pass, one block per group and
  chunk, writes the causal half of C Bᵀ and Cᵀ into two scratch tensors,
  (G, nc, Q, Q) and (G, nc, ds, Q) float32, that the wrapper allocates
  (16.8 MB each at the prefill shapes, G = 8, nc = 32, Q = 128, ds = 128),
  so the rows of a group share them. Then the scan, one block per row
  looping over the row's chunks with the state in shared memory, reads
  them back. The source's header note gives the design and the bound on
  an H100.

The gradient: on the CPU, autograd through :func:`ssd_scan_plain` (the
path, and :func:`ssd_scan_bwd_plain`, the backward kernel's plain
version). On the card :class:`SSDScan` (an autograd Function) runs
:func:`ssd_scan_cuda` forward and ``ops.ssd_scan_bwd`` backward, which
launches ``csrc/ssd_scan_bwd.cu`` (:func:`ssd_scan_bwd_cuda`; no TPU kernel
corresponds: the JAX package differentiates its jnp scan). A backward
call is four CUDA kernels (:data:`SSD_BWD_KERNELS`): C Bᵀ of each group
and chunk; per row, over its chunks, the cumsums, the states entering the
chunks and dh leaving them; the main pass per (row, chunk), its products
on the tensor cores in 3xTF32; the sums of dA over the chunks and of dB
and dC over a group's rows (no atomics, so a call repeats bit for bit).
:func:`ssd_scan_bwd_stages` is its plain mirror, stage by stage, for the
tests and ``chip_smoke.py``. Its scratch at the training shapes of
``mamba2_370m`` (BH = 256 in 8 groups, nc = 32, Q = 128, hd = 64, ds =
128): 1.07 GB for the per-row dB and dC (none with one row a group), 268
MB each for the states entering the chunks and dh leaving them, 16.8 MB
for C Bᵀ, 4.2 MB for cs.

Shapes (all float32): x (BH, nc, Q, hd); dt (BH, nc, Q); A (BH,);
Bm, Cm (G, nc, Q, ds) with G dividing BH: row ``bh`` reads group
``bh // (BH // G)``. The JAX package passes one group per row (G = BH);
the Mamba-2 mixer passes one per batch row (G = batch, BH = batch * heads),
since its B and C are shared by every head. Returns (y (BH, nc, Q, hd),
final state h (BH, ds, hd)).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def _groups(x, Bm):
    BH = x.shape[0]
    G = Bm.shape[0]
    if G == 0 or BH % G:
        raise ValueError(
            f"ssd_scan: {G} groups of B/C do not divide {BH} rows")
    return G, BH // G


def ssd_scan_plain(x, dt, A, Bm, Cm):
    BH, nc, Q, hd = x.shape
    ds = Bm.shape[-1]
    G, hpg = _groups(x, Bm)
    xg = x.reshape(G, hpg, nc, Q, hd)
    dtg = dt.reshape(G, hpg, nc, Q)
    Ag = A.reshape(G, hpg, 1)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((G, hpg, ds, hd), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(nc):
        dtc = dtg[:, :, c]  # (G, hpg, Q)
        Bc = Bm[:, c, None]  # (G, 1, Q, ds): one B for every row of a group
        Cc = Cm[:, c, None]
        cs = torch.cumsum(dtc * Ag, dim=-1)
        seg = torch.exp(cs[..., -1])
        # masked before the exp (exp(-inf) = 0): above the diagonal
        # cs_t - cs_s > 0 can overflow, and autograd through a where after
        # the exp would give 0 * inf = NaN there
        L = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                                  float("-inf")))
        CB = Cc @ Bc.transpose(-1, -2)  # (G, 1, Q, Q)
        xdt = xg[:, :, c] * dtc[..., None]
        y_intra = (CB * L) @ xdt
        y_inter = (Cc @ h) * torch.exp(cs)[..., None]
        decay_out = torch.exp(cs[..., -1:] - cs)[..., None]
        h = h * seg[..., None, None] + Bc.transpose(-1, -2) @ (xdt * decay_out)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=2).reshape(BH, nc, Q, hd)
    return y, h.reshape(BH, ds, hd)


@functools.cache
def _entry_points():
    """The built library's functions, with their C signatures set once
    (the library is built at the first call)."""
    lib = _build.load("ssd_scan")
    launch = lib.ssd_scan_launch
    launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 3
    launch.restype = ctypes.c_int
    smem = lib.ssd_scan_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_size_t
    occupancy = lib.ssd_scan_blocks_per_sm
    occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    occupancy.restype = ctypes.c_int
    error_string = lib.ssd_scan_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, smem, occupancy, error_string


def ssd_scan_occupancy(Q, hd, ds):
    """What a launch at these shapes takes on the current card: the scan
    block's bytes of dynamic shared memory, and the blocks of the scan and
    of its C Bᵀ pre-pass that one SM holds at once, as CUDA's occupancy
    calculator gives them."""
    _, smem, occupancy, error_string = _entry_points()
    scan, pre = ctypes.c_int(0), ctypes.c_int(0)
    err = occupancy(Q, hd, ds, ctypes.byref(scan), ctypes.byref(pre))
    if err != 0:
        raise RuntimeError(f"ssd_scan occupancy query failed: "
                           f"{error_string(err).decode()} ({err})")
    return dict(scan_smem_bytes=smem(Q, hd, ds),
                scan_blocks_per_sm=scan.value,
                prepass_blocks_per_sm=pre.value)


def ssd_scan_cuda(x, dt, A, Bm, Cm):
    """Launch the C Bᵀ pre-pass and the scan kernel on the current stream
    (no synchronisation).

    Raises on a tensor the kernel does not take and on a launch the driver
    refuses, such as one whose shapes need more shared memory than a block
    may have."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {dev}")
    BH, nc, Q, hd = x.shape
    ds = Bm.shape[-1]
    G, hpg = _groups(x, Bm)
    f32 = torch.float32
    for t, name, shape in ((x, "x", (BH, nc, Q, hd)), (dt, "dt", (BH, nc, Q)),
                           (A, "A", (BH,)), (Bm, "Bm", (G, nc, Q, ds)),
                           (Cm, "Cm", (G, nc, Q, ds))):
        _build.check_tensor("ssd_scan", t, name, f32, shape, dev)
    launch, smem, _, error_string = _entry_points()
    y = torch.empty((BH, nc, Q, hd), dtype=f32, device=dev)
    h = torch.empty((BH, ds, hd), dtype=f32, device=dev)
    # scratch for the pre-pass's C Bᵀ and Cᵀ of each group and chunk
    cb = torch.empty((G, nc, Q, Q), dtype=f32, device=dev)
    ct = torch.empty((G, nc, ds, Q), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr
    err = launch(p(x), p(dt), p(A), p(Bm), p(Cm), p(cb), p(ct), BH, nc, Q, hd,
                 ds, hpg, p(y), p(h), ctypes.c_void_p(stream))
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(
            f"ssd_scan kernel launch failed: {msg} ({err}); Q={Q}, hd={hd}, "
            f"ds={ds} need {smem(Q, hd, ds)} bytes of shared memory a block")
    return y, h


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dh=None):
    """The gradients (dx, ddt, dA, dB, dC) of :func:`ssd_scan_plain` at
    these inputs against dy (and dh of the final state, or none), by
    autograd: the plain version of the backward kernel."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, h = ssd_scan_plain(*ins)
        outs, grads = [y], [dy]
        if dh is not None:
            outs.append(h)
            grads.append(dh)
        return tuple(torch.autograd.grad(outs, ins, grads))


# the backward's CUDA kernels, in launch order, as the profiler names them
SSD_BWD_KERNELS = ("ssd_bwd_cb_kernel", "ssd_bwd_states_kernel",
                   "ssd_bwd_main_kernel", "ssd_bwd_reduce_kernel")


@functools.cache
def _bwd_entry_points():
    lib = _build.load("ssd_scan_bwd")
    launch = lib.ssd_scan_bwd_launch
    launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 6
    launch.restype = ctypes.c_int
    info = lib.ssd_scan_bwd_kernel_info
    info.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    info.restype = ctypes.c_int
    error_string = lib.ssd_scan_bwd_error_string
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return launch, info, error_string


def ssd_scan_bwd_occupancy(Q, hd, ds):
    """Per kernel of a backward call (:data:`SSD_BWD_KERNELS`): its block's
    bytes of dynamic shared memory and the blocks that one SM holds at
    once at these shapes, as CUDA's occupancy calculator gives them."""
    _, info, error_string = _bwd_entry_points()
    n = len(SSD_BWD_KERNELS)
    smem = (ctypes.c_longlong * n)()
    blocks = (ctypes.c_int * n)()
    err = info(Q, hd, ds, smem, blocks)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd occupancy query failed: "
                           f"{error_string(err).decode()} ({err})")
    return dict(smem_bytes=dict(zip(SSD_BWD_KERNELS, smem)),
                blocks_per_sm=dict(zip(SSD_BWD_KERNELS, blocks)))


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dy, dh=None, scratch=None):
    """Launch the backward's kernels on the current stream (no
    synchronisation); returns (dx, ddt, dA, dB, dC) with dB and dC summed
    over each group's rows. Raises on a tensor the kernel does not take and
    on a launch the driver refuses. A dict given as ``scratch`` receives
    the call's intermediates: the states entering the chunks ``h_in`` and
    dh leaving them ``dh_out``, both (BH, nc, ds, hd)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_bwd_cuda needs CUDA tensors, got {dev}")
    BH, nc, Q, hd = x.shape
    ds = Bm.shape[-1]
    G, hpg = _groups(x, Bm)
    f32 = torch.float32
    dy = dy.contiguous()
    if dh is not None:
        dh = dh.contiguous()
    checks = [(x, "x", (BH, nc, Q, hd)), (dt, "dt", (BH, nc, Q)),
              (A, "A", (BH,)), (Bm, "Bm", (G, nc, Q, ds)),
              (Cm, "Cm", (G, nc, Q, ds)), (dy, "dy", (BH, nc, Q, hd))]
    if dh is not None:
        checks.append((dh, "dh", (BH, ds, hd)))
    for t, name, shape in checks:
        _build.check_tensor("ssd_scan_bwd", t, name, f32, shape, dev)
    launch, _, error_string = _bwd_entry_points()

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    dx, ddt, dA = empty(BH, nc, Q, hd), empty(BH, nc, Q), empty(BH)
    dB, dC = empty(G, nc, Q, ds), empty(G, nc, Q, ds)
    # scratch: C Bᵀ, cs, exp(cs[-1]), the states and dh as [d][n], the
    # chunks' parts of dA, and dB and dC per row when rows share a group
    cb, cs, seg = empty(G, nc, Q, Q), empty(BH, nc, Q), empty(BH, nc)
    hs, dhs, dA_part = empty(BH, nc, hd, ds), empty(BH, nc, hd, ds), empty(
        BH, nc)
    dB_rows, dC_rows = ((empty(BH, nc, Q, ds), empty(BH, nc, Q, ds))
                        if hpg > 1 else (dB, dC))
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _build.ptr
    err = launch(p(x), p(dt), p(A), p(Bm), p(Cm), p(dy),
                 p(dh) if dh is not None else None, p(cb), p(cs), p(seg),
                 p(hs), p(dhs), p(dA_part), p(dB_rows), p(dC_rows), BH, nc,
                 Q, hd, ds, hpg, p(dx), p(ddt), p(dA), p(dB), p(dC),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"ssd_scan_bwd kernel launch failed: {error_string(err).decode()}"
            f" ({err}); Q={Q}, hd={hd}, ds={ds}")
    if scratch is not None:
        scratch.update(h_in=hs.transpose(-1, -2),
                       dh_out=dhs.transpose(-1, -2))
    return dx, ddt, dA, dB, dC


def ssd_scan_bwd_stages(x, dt, A, Bm, Cm, dy, dh=None):
    """The backward kernel's stages in plain PyTorch, for the tests and
    ``chip_smoke.py``: the chunk-entry states ``h_in`` and dh at each
    chunk's exit ``dh_out`` (BH, nc, ds, hd) by the two recurrences over
    the chunk-local terms, then every chunk's gradients in closed form at
    once, summed as the kernel sums them (dA over the chunks, dB and dC
    over a group's rows). Returns dict(h_in, dh_out, grads=(dx, ddt, dA,
    dB, dC)); the grads are those of :func:`ssd_scan_bwd_plain`."""
    BH, nc, Q, hd = x.shape
    ds = Bm.shape[-1]
    G, hpg = _groups(x, Bm)
    Bc = Bm.repeat_interleave(hpg, dim=0)  # (BH, nc, Q, ds), a row's own
    Cc = Cm.repeat_interleave(hpg, dim=0)
    cs = torch.cumsum(dt * A[:, None, None], dim=-1)
    seg = torch.exp(cs[..., -1])
    ecs = torch.exp(cs)[..., None]
    dout = torch.exp(cs[..., -1:] - cs)[..., None]
    xdt = x * dt[..., None]
    local = Bc.transpose(-1, -2) @ (xdt * dout)  # (BH, nc, ds, hd)
    dlocal = Cc.transpose(-1, -2) @ (dy * ecs)
    h_in, dh_out = torch.zeros_like(local), torch.zeros_like(local)
    h = torch.zeros_like(local[:, 0])
    g = torch.zeros_like(h) if dh is None else dh
    for c in range(nc):
        h_in[:, c] = h
        h = h * seg[:, c, None, None] + local[:, c]
        dh_out[:, nc - 1 - c] = g
        g = g * seg[:, nc - 1 - c, None, None] + dlocal[:, nc - 1 - c]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                              float("-inf")))
    CB = Cc @ Bc.transpose(-1, -2)
    S = (dy @ xdt.transpose(-1, -2)) * L  # dM ∘ L (L is 0 above)
    P = S * CB
    du = Bc @ dh_out
    dxdt = (CB * L).transpose(-1, -2) @ dy + dout * du
    dyh = dy @ h_in.transpose(-1, -2)  # (Q, ds)
    dC = S @ Bc + ecs * dyh
    dB = S.transpose(-1, -2) @ Cc + dout * (xdt @ dh_out.transpose(-1, -2))
    gd = dout[..., 0] * (du * xdt).sum(-1)
    dcs = P.sum(-1) - P.sum(-2) - gd + ecs[..., 0] * (Cc * dyh).sum(-1)
    last = gd.sum(-1) + seg * (dh_out * h_in).sum((-1, -2))
    dcs = torch.cat([dcs[..., :-1], dcs[..., -1:] + last[..., None]], -1)
    rev = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = (x * dxdt).sum(-1) + A[:, None, None] * rev
    dA = (dt * rev).sum(-1).sum(-1)
    dB = dB.view(G, hpg, nc, Q, ds).sum(1)
    dC = dC.view(G, hpg, nc, Q, ds).sum(1)
    return dict(h_in=h_in, dh_out=dh_out,
                grads=(dt[..., None] * dxdt, ddt, dA, dB, dC))


class SSDScan(torch.autograd.Function):
    """The scan on the card with its gradient: :func:`ssd_scan_cuda`
    forward, ``ops.ssd_scan_bwd`` (the backward kernel, counted) backward.
    Returns (y, final state h) as the kernel does."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd_scan_cuda(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dh):
        from repro_torch.kernels import ops

        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh)
