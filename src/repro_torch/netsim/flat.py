"""Flat-index batched scatters: fold the member index into the scatter
index.

``valid=False`` entries go to one extra dummy element that is sliced off
(the reference's ``mode="drop"``). Every scatter writes a fresh tensor:
states are values, as in the reference. Adds use ``index_add_``: serial
in index order on the CPU, atomics on CUDA (exact for the integer
counters; the float sums it takes on the card, lat_sum, are metrics
that nothing reads back).
"""
from __future__ import annotations

import torch


def _global_idx(target, idx):
    B = target.shape[0]
    size = target[0].numel()
    off = (torch.arange(B, device=idx.device) * size).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    return idx.long() + off, B * size


def _flat_scatter(target, idx, vals, valid, accumulate):
    gidx, n = _global_idx(target, idx)
    if isinstance(vals, torch.Tensor):
        vals = torch.broadcast_to(vals.to(target.dtype), idx.shape)
    else:  # a Python scalar: filled on the device (no host copy to capture)
        vals = torch.full(idx.shape, vals, dtype=target.dtype,
                          device=target.device)
    vals = vals.reshape(-1)
    flat = target.reshape(-1)
    if valid is None:
        flat = flat.clone()
    else:
        gidx = torch.where(valid, gidx, n)
        flat = torch.cat([flat, flat.new_zeros(1)])
    gidx = gidx.reshape(-1)
    if accumulate:
        flat.index_add_(0, gidx, vals)
    else:
        flat.index_put_((gidx,), vals)
    return flat[:n].reshape(target.shape)


def flat_add(target, idx, vals, valid=None):
    return _flat_scatter(target, idx, vals, valid, accumulate=True)


def flat_set(target, idx, vals, valid=None):
    return _flat_scatter(target, idx, vals, valid, accumulate=False)


def flat_reduce(target, idx, vals, how):
    gidx, _ = _global_idx(target, idx)
    return target.reshape(-1).clone().scatter_reduce_(
        0, gidx.reshape(-1), vals.reshape(-1), how).reshape(target.shape)
