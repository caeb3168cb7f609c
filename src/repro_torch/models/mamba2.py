"""Mamba-2 (SSD, state-space duality) block.

The PyTorch counterpart of the JAX package's ``models/mamba2.py``
(arXiv:2405.21060): the sequence is split into chunks; within a chunk the
output is the masked (C Bᵀ ∘ L) x "attention-like" form, and the state is
carried from chunk to chunk. Single-token decode is the O(1) recurrent
update. The functions are the reference's; what changes is where the
chunked scan runs: :func:`ssd_chunked` lays x out head-major and calls
:func:`repro_torch.kernels.ops.ssd_scan` (the CUDA kernel on the card,
the plain PyTorch version on the CPU), where the reference writes it in
jnp einsums. The two sum in another order, so they agree to float32
rounding, not bit for bit.

Projections are separate matrices (wz/wx/wB/wC/wdt and per-segment
convolutions), as in the reference, with one SSM group: B and C are
shared by every head.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops as KOPS
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype, dense_init
from repro_torch.train import sharding as SH


class Mamba2Mixer(torch.nn.Module):
    """The parameters of one Mamba-2 mixer (the reference's ``mamba_init``
    tree, under the same names), drawn from ``gen``. The model runs it
    through :func:`mamba_forward` and :func:`mamba_decode`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        dt = _dtype(cfg.param_dtype)
        f32 = torch.float32
        d, di, ds = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
        nh, kc = cfg.ssm_n_heads, cfg.ssm_conv

        def conv(width):
            return (torch.randn((kc, width), generator=gen, dtype=f32,
                                device=device) * 0.1).to(dt)

        def const(width, value):
            return torch.full((width,), value, dtype=f32, device=device)

        init = {
            "wz": dense_init(gen, d, di, dt, device),
            "wx": dense_init(gen, d, di, dt, device),
            "wB": dense_init(gen, d, ds, dt, device),
            "wC": dense_init(gen, d, ds, dt, device),
            "wdt": dense_init(gen, d, nh, dt, device),
            "conv_x": conv(di),
            "conv_B": conv(ds),
            "conv_C": conv(ds),
            "conv_bx": const(di, 0.0),
            "conv_bB": const(ds, 0.0),
            "conv_bC": const(ds, 0.0),
            "A_log": const(nh, 0.0),  # A = -exp(A_log) in (-inf, 0)
            "D": const(nh, 1.0),
            "dt_bias": const(nh, -2.0),  # softplus^-1(~0.12)
            "out_proj": dense_init(gen, di, d, dt, device),
            "norm_scale": const(di, 1.0),
        }
        for name, value in init.items():
            self.register_parameter(
                name, torch.nn.Parameter(value, requires_grad=False))


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d + silu. x: (B,S,C), w: (Kc,C); state: (B,Kc-1,C)."""
    Kc = w.shape[0]
    if state is None:  # zeros before the sequence (F.pad, but a DTensor
        # of some torch releases loses a placement in constant_pad_nd)
        state = SH.like(torch.zeros((x.shape[0], Kc - 1, x.shape[2]),
                                    dtype=x.dtype, device=x.device), x)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = torch.zeros_like(x, dtype=torch.float32)
    for i in range(Kc):
        out = out + xp[:, i:i + S, :].float() * w[i].float()
    out = F.silu(out + b)
    new_state = xp[:, -(Kc - 1):, :] if Kc > 1 else None
    return out.to(x.dtype), new_state


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int):
    """SSD forward.

    x : (B, S, nh, hd)   dt: (B, S, nh)   A: (nh,) negative reals
    Bm, Cm: (B, S, ds)   (single SSM group, broadcast over heads)
    Returns y: (B, S, nh, hd) float32.

    S is right-padded to a multiple of Q = min(chunk, S) with dt = 0 rows
    (an exactly zero contribution: the scan is causal), the rows are laid
    out head-major for :func:`~repro_torch.kernels.ops.ssd_scan`, and
    ``x · D`` is added to what it returns.

    DTensors (the sharded model) go through ``local_map``: each rank scans
    its own rows. The scan is row-local, so a mesh dim that shards x's
    batch (its dim 0) or heads (its dim 2) splits whole rows; the inputs
    are laid out to match (B and C on the batch's dims, A and D on the
    heads') and every other mesh dim is replicated first.
    """
    if isinstance(x, DTensor):
        return _ssd_local_map(x, dt, A, Bm, Cm, D, chunk)
    Bsz, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    xf = x.float()
    xh = xf.reshape(Bsz, nc, Q, nh, hd).permute(0, 3, 1, 2, 4).reshape(
        Bsz * nh, nc, Q, hd).contiguous()
    dth = dt.float().reshape(Bsz, nc, Q, nh).permute(0, 3, 1, 2).reshape(
        Bsz * nh, nc, Q).contiguous()
    Ah = A.float().repeat(Bsz)  # row b * nh + head
    Bg = Bm.float().reshape(Bsz, nc, Q, ds).contiguous()  # one group per b
    Cg = Cm.float().reshape(Bsz, nc, Q, ds).contiguous()
    y, _ = KOPS.ssd_scan(xh, dth, Ah, Bg, Cg)
    y = y.reshape(Bsz, nh, nc, Q, hd).permute(0, 2, 3, 1, 4).reshape(
        Bsz, S, nh, hd)
    y = y + xf * D[None, None, :, None]
    return y[:, :S0]


def _ssd_local_map(x, dt, A, Bm, Cm, D, chunk: int):
    roles = ["batch" if p == Shard(0) else "heads" if p == Shard(2) else None
             for p in x.placements]

    def lay(on_batch, on_heads):
        return tuple(on_batch if r == "batch" else
                     on_heads if r == "heads" else Replicate() for r in roles)

    rows = lay(Shard(0), Shard(2))  # x, dt and y
    per_head = lay(Replicate(), Shard(0))  # A, D
    per_batch = lay(Shard(0), Replicate())  # B, C
    # a rank's gradient of A, D (B, C) sums over its rows alone
    d_head, d_batch = lay(Partial(), Shard(0)), lay(Shard(0), Partial())
    fn = local_map(functools.partial(ssd_chunked, chunk=chunk),
                   out_placements=(rows,),
                   in_placements=(rows, rows, per_head, per_batch, per_batch,
                                  per_head),
                   in_grad_placements=(rows, rows, d_head, d_batch, d_batch,
                                       d_head),
                   device_mesh=x.device_mesh, redistribute_inputs=True)
    return fn(x, dt, A, Bm, Cm, D)


def _project(p, x, cfg: ModelConfig):
    cdt = _dtype(cfg.compute_dtype)
    xc = x.to(cdt)
    z = xc @ SH.gather_fsdp(p.wz).to(cdt)
    xs = xc @ SH.gather_fsdp(p.wx).to(cdt)
    Bm = xc @ SH.gather_fsdp(p.wB).to(cdt)
    Cm = xc @ SH.gather_fsdp(p.wC).to(cdt)
    dtr = xc @ SH.gather_fsdp(p.wdt).to(cdt)
    return z, xs, Bm, Cm, dtr


def _gated_out(p, y, z, x_dtype, cfg: ModelConfig):
    """Gated RMSNorm (Mamba-2 norm-before-out-proj), then the out projection."""
    cdt = _dtype(cfg.compute_dtype)
    yz = y * F.silu(z.float())
    ms = (yz * yz).mean(dim=-1, keepdim=True)
    yz = yz * torch.rsqrt(ms + 1e-6) * p.norm_scale
    return SH.reduce_partial(
        yz.to(cdt) @ SH.gather_fsdp(p.out_proj).to(cdt)).to(x_dtype)


def mamba_forward(p, x, cfg: ModelConfig):
    """Full-sequence Mamba-2 block. x: (B,S,d) -> (B,S,d)."""
    B, S, d = x.shape
    di, nh, hd = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dtr = _project(p, x, cfg)
    xs, _ = _causal_conv(xs, p.conv_x, p.conv_bx)
    Bm, _ = _causal_conv(Bm, p.conv_B, p.conv_bB)
    Cm, _ = _causal_conv(Cm, p.conv_C, p.conv_bC)
    dt = _softplus(dtr.float() + p.dt_bias)  # (B,S,nh)
    A = -torch.exp(p.A_log)  # (nh,)
    y = ssd_chunked(xs.reshape(B, S, nh, hd), dt, A, Bm, Cm, p.D,
                    chunk=cfg.ssm_chunk)
    return _gated_out(p, y.reshape(B, S, di), z, x.dtype, cfg)


def make_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    k = cfg.ssm_conv - 1
    return {
        "ssm": z((batch, cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim),
                 torch.float32),
        "conv_x": z((batch, k, cfg.ssm_d_inner), dtype),
        "conv_B": z((batch, k, cfg.ssm_state), dtype),
        "conv_C": z((batch, k, cfg.ssm_state), dtype),
    }


def mamba_decode(p, x, cache, cfg: ModelConfig):
    """Single-token recurrent update. x: (B,1,d). Returns (out, new cache)."""
    B = x.shape[0]
    di, nh, hd = cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dtr = _project(p, x, cfg)
    xs, ncx = _causal_conv(xs, p.conv_x, p.conv_bx, state=cache["conv_x"])
    Bm, ncB = _causal_conv(Bm, p.conv_B, p.conv_bB, state=cache["conv_B"])
    Cm, ncC = _causal_conv(Cm, p.conv_C, p.conv_bC, state=cache["conv_C"])
    xs = xs[:, 0]
    Bm = Bm[:, 0].float()
    Cm = Cm[:, 0].float()
    dt = _softplus(dtr.float()[:, 0] + p.dt_bias)  # (B,nh)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(B, nh, hd).float()
    g = torch.exp(dt * A)  # (B,nh)
    h = cache["ssm"] * g[..., None, None] + (
        Bm[:, None, :, None] * (dt[:, :, None, None] * xh[:, :, None, :]))
    y = torch.einsum("bs,bhsd->bhd", Cm, h) + xh * p.D[None, :, None]
    out = _gated_out(p, y.reshape(B, 1, di), z, x.dtype, cfg)
    return out, {"ssm": h, "conv_x": ncx, "conv_B": ncB, "conv_C": ncC}
