"""Sim-plane probes: time-windowed ring buffers inside ``SimState``.

The PyTorch counterpart of the JAX package's ``obs/probes.py``. The
probes see what the simulated network does over virtual time: per-level
link utilization, per-app in-flight latency, pool occupancy and queue
depth, sampled every ``every`` live ticks into fixed-size ring buffers
that ride along as engine state.

Probing is a build-time choice (``build_engine(probes=...)``): an engine
built without a :class:`ProbeConfig` has no probe code in its tick.
Every update is gated member-wise by ``live_m`` (frozen members never
advance their tick counter or touch their buffers), and ring writes are
one-hot ``where`` selects at ``idx % K``.

The per-level byte sums are a float32 ``(B, L) @ (L, levels)`` product
(``torch.matmul``; the JAX package leaves it to XLA). :func:`sample_probes`
requires full float32 there: it raises when PyTorch is set to take
float32 products in TF32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class ProbeConfig:
    """Static probe plan.

    ``samples``: ring-buffer capacity K (oldest samples overwritten).
    ``every``: sampling period in *live* ticks (a frozen batch member's
    ordinal clock pauses with it).
    """

    samples: int = 64
    every: int = 8

    def __post_init__(self):
        if self.samples < 1:
            raise ValueError(f"probes: samples must be >= 1, got {self.samples}")
        if self.every < 1:
            raise ValueError(f"probes: every must be >= 1, got {self.every}")


class ProbeState(NamedTuple):
    """Per-member probe buffers (leading ``B`` dim when batched).

    Ring buffers are written at ``idx % K``; ``idx`` counts samples ever
    taken, so ``idx > K`` means the ring wrapped and :func:`ring_order`
    recovers chronological order.
    """

    t: Any                 # (K,) f32 — virtual time of each sample (us)
    link_util: Any         # (K, n_levels) f32 — per-level utilization 0..1
    inflight_lat: Any      # (K, n_apps) f32 — mean in-flight age (us)
    queue_depth: Any       # (K, n_apps) int32 — in-flight msgs per app
    pool_occ: Any          # (K,) f32 — pool slot occupancy 0..1
    tick: Any              # () int32 — live ticks elapsed (ordinal clock)
    idx: Any               # () int32 — samples ever written (monotonic)
    last_level_bytes: Any  # (n_levels,) f32 — bytes at last sample
    last_t: Any            # () f32 — virtual time of last sample


def init_probes(cfg: ProbeConfig, n_levels: int, n_apps: int,
                device=None) -> ProbeState:
    """One member's empty probe buffers on ``device`` (default: CPU)."""
    K = cfg.samples
    f32, i32 = torch.float32, torch.int32

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ProbeState(
        t=torch.full((K,), -1.0, dtype=f32, device=device),
        link_util=zeros((K, n_levels)),
        inflight_lat=zeros((K, n_apps)),
        queue_depth=zeros((K, n_apps), i32),
        pool_occ=zeros((K,)),
        tick=zeros((), i32),
        idx=zeros((), i32),
        last_level_bytes=zeros((n_levels,)),
        last_t=zeros(()),
    )


def check_full_float32() -> None:
    """Raise when float32 products would run in TF32 (about three
    decimal digits): the probes' level sums need full float32."""
    if torch.get_float32_matmul_precision() != "highest" \
            or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "probes: float32 products must run in full float32; set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def sample_probes(
    ps: ProbeState,
    cfg: ProbeConfig,
    *,
    t_new: torch.Tensor,          # (B,) f32 — post-tick virtual time
    live_m: torch.Tensor,         # (B,) bool — member freeze mask
    link_bytes: torch.Tensor,     # (B, L+1) f32 — cumulative per-link bytes
    pool_active: torch.Tensor,    # (B, M) bool
    pool_job: torch.Tensor,       # (B, M) int32 app ids (UR == n_apps-1)
    pool_inject_t: torch.Tensor,  # (B, M) f32
    free_top: torch.Tensor,       # (B,) int32 — free pool slots
    level_mask: torch.Tensor,     # (L, n_levels) f32 — link -> level one-hot
    level_bw: torch.Tensor,       # (n_levels,) f32 — aggregate bytes/us
    n_apps: int,
    pool_size: int,
) -> ProbeState:
    """One tick's probe update (a part of the engine's tick).

    Frozen members (``live_m`` false) neither advance their ordinal clock
    nor write: a member's samples are the same solo or in a batch.
    """
    check_full_float32()
    K = cfg.samples
    B = t_new.shape[0]
    dev = t_new.device
    f32, i32 = torch.float32, torch.int32
    tick2 = ps.tick + live_m.to(i32)  # (B,)
    do = live_m & (tick2 % cfg.every == 0)  # (B,)
    oh = (torch.arange(K, dtype=i32, device=dev)[None, :]
          == (ps.idx % K)[:, None]) & do[:, None]  # (B, K) ring write mask

    # per-level utilization: byte delta since the last sample over the
    # level's aggregate capacity for that virtual-time span
    L = level_mask.shape[0]
    lev_bytes = torch.matmul(link_bytes[:, :L], level_mask)  # (B, n_levels)
    d_t = t_new - ps.last_t  # (B,) us
    util = torch.where(
        (d_t[:, None] > 0.0) & (level_bw[None, :] > 0.0),
        (lev_bytes - ps.last_level_bytes)
        / (level_bw[None, :] * torch.clamp(d_t[:, None], min=1e-9)),
        torch.zeros((), dtype=f32, device=dev),
    )  # (B, n_levels)

    # per-app in-flight stats from the pool: mean age of active messages
    # and their count; inactive slots go to a dummy app row
    A1 = n_apps + 1
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    gidx = (rows * A1 + torch.where(pool_active, pool_job, n_apps)).reshape(-1)
    cnt = torch.zeros(B * A1, dtype=f32, device=dev).index_add_(
        0, gidx, torch.ones_like(gidx, dtype=f32)).reshape(B, A1)
    age = torch.where(pool_active, t_new[:, None] - pool_inject_t,
                      torch.zeros((), dtype=f32, device=dev))
    age_sum = torch.zeros(B * A1, dtype=f32, device=dev).index_add_(
        0, gidx, age.reshape(-1)).reshape(B, A1)
    cnt = cnt[:, :n_apps]
    mean_lat = age_sum[:, :n_apps] / torch.clamp(cnt, min=1.0)

    # a tensor divisor keeps the float32 division correctly rounded on the
    # card (a Python float becomes a multiply by its reciprocal there)
    occ = (pool_size - free_top).to(f32) / torch.full(
        (), float(pool_size), dtype=f32, device=dev)

    w2 = oh[:, :, None]  # (B, K, 1) for per-level / per-app buffers
    return ProbeState(
        t=torch.where(oh, t_new[:, None], ps.t),
        link_util=torch.where(w2, util[:, None, :], ps.link_util),
        inflight_lat=torch.where(w2, mean_lat[:, None, :], ps.inflight_lat),
        queue_depth=torch.where(w2, cnt.to(i32)[:, None, :], ps.queue_depth),
        pool_occ=torch.where(oh, occ[:, None], ps.pool_occ),
        tick=tick2,
        idx=ps.idx + do.to(i32),
        last_level_bytes=torch.where(do[:, None], lev_bytes,
                                     ps.last_level_bytes),
        last_t=torch.where(do, t_new, ps.last_t),
    )


def ring_order(idx: int, K: int) -> np.ndarray:
    """Buffer positions oldest -> newest for a ring written ``idx`` times.

    Before wraparound (``idx <= K``) that is ``0..idx-1``; after, the
    oldest surviving sample sits at ``idx % K``.
    """
    n = min(int(idx), int(K))
    return np.arange(int(idx) - n, int(idx), dtype=np.int64) % int(K)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def probe_timelines(
    ps: ProbeState,
    level_names: Sequence[str],
    app_names: Sequence[Optional[str]],
) -> Dict[str, Any]:
    """Unwrap one member's rings into chronological JSON-ready timelines.

    ``app_names`` follows the padded app axis (vacant job slots are
    ``None`` and skipped); ``level_names`` follows the fabric's
    ``link_levels()`` order.
    """
    idx = int(_np(ps.idx))
    K = int(_np(ps.t).shape[0])
    order = ring_order(idx, K)
    t = _np(ps.t)[order]
    util = _np(ps.link_util)[order]
    lat = _np(ps.inflight_lat)[order]
    depth = _np(ps.queue_depth)[order]
    occ = _np(ps.pool_occ)[order]
    out: Dict[str, Any] = dict(
        samples=len(order),
        wrapped=idx > K,
        t_us=[float(x) for x in t],
        pool_occupancy=[float(x) for x in occ],
        link_utilization={
            str(name): [float(x) for x in util[:, li]]
            for li, name in enumerate(level_names)
        },
        inflight_latency_us={},
        queue_depth={},
    )
    for ai, name in enumerate(app_names):
        if name is None or ai >= lat.shape[1]:
            continue
        out["inflight_latency_us"][str(name)] = [float(x) for x in lat[:, ai]]
        out["queue_depth"][str(name)] = [int(x) for x in depth[:, ai]]
    return out
