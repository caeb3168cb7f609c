"""Deterministic, shardable, resumable synthetic token pipeline.

The port's copy of the JAX package's ``data/pipeline.py`` (its
``host_batch`` is numpy alone, and the port imports nothing of the
reference): batches are a pure function of ``(seed, step, row)``
(counter-based Philox), so any worker can regenerate any rows of any
step, and a resumed run needs only the step. The stream has learnable
structure (a noisy affine n-gram process). :func:`device_batch` puts a
step's batch on one device, or each rank's rows of it on a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1  # fraction of uniformly random tokens
    text_len: Optional[int] = None  # tokens per row (< seq_len for VLM cells)


def host_batch(cfg: DataConfig, step: int, lo: int = 0,
               hi: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Rows [lo, hi) of the global batch for ``step`` as int32 numpy
    (tokens, targets). Each row's randomness is keyed by its absolute row
    index, so any slice of the global batch is the same whoever makes it."""
    hi = cfg.global_batch if hi is None else hi
    n = hi - lo
    S = cfg.text_len or cfg.seq_len
    V = cfg.vocab_size
    a = 6364136223846793005 % V or 1
    start = np.empty((n, 1), np.int64)
    noise_mask = np.empty((n, S + 1), bool)
    noise_tok = np.empty((n, S + 1), np.int64)
    for i, r in enumerate(range(lo, hi)):
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=(step << 24) + r))
        start[i, 0] = rng.integers(0, V)
        noise_mask[i] = rng.random(S + 1) < cfg.noise
        noise_tok[i] = rng.integers(0, V, size=S + 1)
    seq = np.empty((n, S + 1), np.int64)
    seq[:, 0:1] = start
    for t in range(1, S + 1):  # affine chain, vectorized over rows
        seq[:, t] = (seq[:, t - 1] * a + 12345) % V
    seq = np.where(noise_mask, noise_tok, seq)
    tokens = seq[:, :-1].astype(np.int32)
    targets = seq[:, 1:].astype(np.int32)
    return tokens, targets


def device_batch(cfg: DataConfig, step: int, device=None, mesh=None,
                 batch_axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """``step``'s global batch as int32 tensors on ``device``. With a
    ``mesh``, DTensors whose rows are split over ``batch_axes`` (in mesh
    order, the first outermost) and replicated over the other axes: each
    rank makes only its own rows with :func:`host_batch` and none is
    sent."""
    if mesh is None:
        tokens, targets = host_batch(cfg, step)
        return (torch.as_tensor(tokens, device=device),
                torch.as_tensor(targets, device=device))
    names = list(mesh.mesh_dim_names)
    n, block = 1, 0  # rows split n ways; this rank's block of them
    for a in batch_axes:
        i = names.index(a)
        block = block * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    if cfg.global_batch % n:
        raise ValueError(f"a global batch of {cfg.global_batch} rows does "
                         f"not split over {n} ranks of {batch_axes}")
    rows = cfg.global_batch // n
    placements = [Shard(0) if a in batch_axes else Replicate()
                  for a in names]
    tokens, targets = host_batch(cfg, step, block * rows, (block + 1) * rows)
    shape = (cfg.global_batch, tokens.shape[1])
    return tuple(DTensor.from_local(
        torch.as_tensor(t, device=device), mesh, placements,
        run_check=False, shape=shape, stride=(shape[1], 1))
        for t in (tokens, targets))
