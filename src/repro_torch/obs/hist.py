"""Full-fidelity in-engine latency histograms, per (app, link-level).

The PyTorch counterpart of the JAX package's ``obs/hist.py``. The coarse
per-app histogram in ``Metrics.lat_hist`` keeps quartiles; this keeps
every drained message: log-bucketed counts split by the fabric level the
message crossed, plus exact streaming moments (sum / sum of squares /
max) per app, so p50 / p95 / p99 and the variation coefficient come from
the full population.

:class:`HistConfig` is a build-time choice (``build_engine(hist=...)``):
an engine built without one has no histogram code in its tick. Within a
histogrammed engine :class:`HistState` is more ``SimState`` leaves
(leading ``B`` dim when batched), updated with the engine's flat-index
scatters: undelivered slots go to one dummy element that is sliced off
(JAX's ``mode="drop"``), and the maximum is ``scatter_reduce_``.

Counts are exact integer adds, so ``merge_hist`` of two half-runs equals
one full run. On the card the float sums are atomics in no fixed order
(metrics that nothing reads back into the simulation).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class HistConfig:
    """Static histogram plan.

    ``bins``: log-spaced bucket count K; bucket ``i`` spans
    ``[lo_us * ratio**i, lo_us * ratio**(i+1))`` with the first/last
    buckets absorbing underflow/overflow (every drained message lands in
    exactly one bucket).
    """

    bins: int = 64
    lo_us: float = 0.5
    ratio: float = 1.25

    def __post_init__(self):
        if self.bins < 2:
            raise ValueError(f"hist: bins must be >= 2, got {self.bins}")
        if not self.lo_us > 0.0:
            raise ValueError(f"hist: lo_us must be > 0, got {self.lo_us}")
        if not self.ratio > 1.0:
            raise ValueError(f"hist: ratio must be > 1, got {self.ratio}")


class HistState(NamedTuple):
    """Per-member accumulators (leading ``B`` dim when batched).

    ``edges`` is a constant leaf, so a detached ``HistState`` describes
    itself.
    """

    counts: Any  # (n_apps, n_levels, K) int32 — drained msgs
    sum: Any     # (n_apps,) f32 — latency sum (us)
    sumsq: Any   # (n_apps,) f32 — sum of squares
    max: Any     # (n_apps,) f32 — max latency (us)
    edges: Any   # (K+1,) f32 — bucket edges (us), constant


def init_hist(cfg: HistConfig, n_apps: int, n_levels: int,
              device=None) -> HistState:
    """One member's empty accumulators on ``device`` (default: CPU)."""
    K = cfg.bins
    edges = cfg.lo_us * (cfg.ratio ** np.arange(K + 1, dtype=np.float64))
    f32 = torch.float32
    return HistState(
        counts=torch.zeros((n_apps, max(n_levels, 1), K), dtype=torch.int32,
                           device=device),
        sum=torch.zeros((n_apps,), dtype=f32, device=device),
        sumsq=torch.zeros((n_apps,), dtype=f32, device=device),
        max=torch.zeros((n_apps,), dtype=f32, device=device),
        edges=torch.as_tensor(edges.astype(np.float32), device=device),
    )


def bucket_of(lat, cfg: HistConfig):
    """Log-bucket index for latency ``lat`` (us) — tensor or numpy alike.

    The divisor ``log(ratio)`` is a tensor on the card, so the division
    is a correctly rounded float32 division there too (a Python float
    divisor becomes a multiply by its reciprocal in CUDA kernels)."""
    if isinstance(lat, torch.Tensor):
        log_ratio = torch.full((), math.log(cfg.ratio), dtype=lat.dtype,
                               device=lat.device)
        b = torch.floor(torch.log(torch.clamp(lat / cfg.lo_us, min=1e-9))
                        / log_ratio)
        return torch.clamp(b, 0, cfg.bins - 1).to(torch.int32)
    return np.clip(
        np.floor(np.log(np.maximum(lat / cfg.lo_us, 1e-9))
                 / math.log(cfg.ratio)),
        0, cfg.bins - 1,
    ).astype(np.int32)


def _drop_add(target, idx, vals):
    """``target.reshape(-1).at[idx].add(vals, mode="drop")`` where every
    out-of-range index is ``target.numel()``."""
    n = target.numel()
    flat = torch.cat([target.reshape(-1), target.new_zeros(1)])
    flat.index_add_(0, idx.reshape(-1).long(), vals.reshape(-1))
    return flat[:n].reshape(target.shape)


def update_hist(
    hs: HistState,
    cfg: HistConfig,
    *,
    lat: torch.Tensor,        # (B, M) f32 — latency of each pool slot (us)
    delivered: torch.Tensor,  # (B, M) bool — drained this tick (live-gated)
    app: torch.Tensor,        # (B, M) int32 app ids (UR == n_apps-1)
    level: torch.Tensor,      # (B, M) int32 fabric level of each message
) -> HistState:
    """One drain tick's update (a part of the engine's tick).

    ``delivered`` is already gated by the member freeze mask, so frozen
    members never write. One flat scatter over
    ``(B * n_apps * n_levels * K,)`` per leaf.
    """
    B, A, NL, K = hs.counts.shape
    b = bucket_of(lat, cfg)
    rows = torch.arange(B, dtype=torch.int32, device=lat.device)[:, None]
    cidx = torch.where(delivered, ((rows * A + app) * NL + level) * K + b,
                       B * A * NL * K)
    counts = _drop_add(hs.counts, cidx, delivered.to(torch.int32))

    aidx = torch.where(delivered, rows * A + app, B * A)
    lat0 = torch.where(delivered, lat, torch.zeros_like(lat))
    lsum = _drop_add(hs.sum, aidx, lat0)
    lsumsq = _drop_add(hs.sumsq, aidx, lat0 * lat0)
    flat = torch.cat([hs.max.reshape(-1), hs.max.new_zeros(1)])
    lmax = flat.scatter_reduce_(0, aidx.reshape(-1).long(), lat0.reshape(-1),
                                "amax")[: B * A].reshape(hs.max.shape)
    return hs._replace(counts=counts, sum=lsum, sumsq=lsumsq, max=lmax)


def merge_hist(a: HistState, b: HistState) -> HistState:
    """Combine two accumulator states (same shape/edges): counts and
    moments add, maxima take the max. Counts merge exactly."""
    mx = torch.maximum if isinstance(a.max, torch.Tensor) else np.maximum
    return HistState(
        counts=a.counts + b.counts,
        sum=a.sum + b.sum,
        sumsq=a.sumsq + b.sumsq,
        max=mx(a.max, b.max),
        edges=a.edges,
    )


def _np(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def hist_summary(
    hs: HistState,
    app_names: Sequence[Optional[str]],
    level_names: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Unwrap one member's accumulators into a JSON-ready report.

    Per app: full-population count / mean / p50 / p95 / p99 / max and the
    latency-variation coefficient (std / mean), plus per-fabric-level
    message counts. ``app_names`` follows the padded app axis (``None``
    rows skipped); quantiles use the geometric bucket midpoints.
    """
    counts = _np(hs.counts)  # (A, NL, K)
    lsum = _np(hs.sum, np.float64)
    lsumsq = _np(hs.sumsq, np.float64)
    lmax = _np(hs.max, np.float64)
    edges = _np(hs.edges, np.float64)
    mids = np.sqrt(edges[:-1] * edges[1:])
    NL = counts.shape[1]
    if level_names is None or len(level_names) != NL:
        level_names = [f"level{i}" for i in range(NL)]
    out: Dict[str, Any] = dict(
        bins=int(counts.shape[2]),
        lo_us=float(edges[0]),
        ratio=float(edges[1] / edges[0]),
        apps={},
    )
    for ai, name in enumerate(app_names):
        if name is None or ai >= counts.shape[0]:
            continue
        hist = counts[ai].sum(axis=0)  # (K,) marginal over levels
        cnt = int(hist.sum())
        if cnt == 0:
            out["apps"][str(name)] = dict(count=0)
            continue
        cum = np.cumsum(hist)

        def q(p):
            j = int(np.searchsorted(cum, p * cnt))
            return float(mids[min(j, len(mids) - 1)])

        mean = lsum[ai] / cnt
        var = max(lsumsq[ai] / cnt - mean * mean, 0.0)
        out["apps"][str(name)] = dict(
            count=cnt,
            mean_us=float(mean),
            p50_us=q(0.50), p95_us=q(0.95), p99_us=q(0.99),
            max_us=float(lmax[ai]),
            variation=float(math.sqrt(var) / mean) if mean > 0 else 0.0,
            levels={
                str(ln): int(counts[ai, li].sum())
                for li, ln in enumerate(level_names)
            },
        )
    return out
