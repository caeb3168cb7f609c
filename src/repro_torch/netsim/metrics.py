"""Post-processing of SimState metrics into the paper's tables/figures."""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Sequence

import numpy as np

from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.fabric import Fabric
from repro_torch.netsim.fabric.base import KIND_TERM_IN, KIND_TERM_OUT
from repro_torch.obs.hist import hist_summary


def latency_summary(state, app_names: Sequence[str], net: NetConfig) -> Dict[str, Any]:
    """Per-app message latency stats (Fig. 7): min/avg/max + quartiles from
    the geometric histogram.

    ``app_names`` maps metric rows to names; ``None`` entries mark padded
    capacity rows (ragged campaigns) and are skipped.
    """
    m = state.metrics
    out = {}
    edges = net.latency_hist_lo_us * (
        net.latency_hist_ratio ** np.arange(net.latency_hist_bins + 1)
    )
    mids = np.sqrt(edges[:-1] * edges[1:])
    for i, name in enumerate(app_names):
        if name is None:
            continue
        cnt = int(m.lat_cnt[i])
        hist = np.asarray(m.lat_hist[i])
        if cnt == 0:
            out[name] = dict(count=0)
            continue
        cum = np.cumsum(hist)
        def q(p):
            j = int(np.searchsorted(cum, p * cnt))
            return float(mids[min(j, len(mids) - 1)])
        out[name] = dict(
            count=cnt,
            avg_us=float(m.lat_sum[i]) / cnt,
            min_us=float(m.lat_min[i]),
            max_us=float(m.lat_max[i]),
            p25_us=q(0.25), p50_us=q(0.50), p75_us=q(0.75),
        )
    return out


def comm_time_summary(state, app_names: Sequence[str]) -> Dict[str, Any]:
    """Per-app communication time (Fig. 9): max/avg over ranks, in ms.

    Jobs live in the stacked ``(J, Pmax)`` layout; each job's stats are
    computed over its real ranks only (``state.jobs.P`` masks padding).
    ``None`` names mark padded job rows and are skipped.
    """
    out = {}
    P = np.asarray(state.jobs.P)
    ct_all = np.asarray(state.vms.comm_time) / 1000.0  # (J, Pmax)
    for ji, name in enumerate(app_names):
        if ji >= ct_all.shape[0] or name is None:
            continue
        ct = ct_all[ji, : int(P[ji])]
        out[name] = dict(
            max_ms=float(ct.max()), avg_ms=float(ct.mean()), min_ms=float(ct.min())
        )
    return out


def link_load_summary(state, topo: Fabric) -> Dict[str, Any]:
    """Table VI, fabric-generic: total + per-link load per fabric level.

    Links are classified by the fabric's own hierarchy
    (:meth:`~repro_torch.netsim.fabric.base.Fabric.link_levels`): dragonfly
    local/global, fat-tree up/down, torus x/y/z. Key names follow the
    level names (``<level>_total_bytes`` etc.), so dragonfly reports keep
    their historical ``local_*``/``global_*``/``frac_global`` keys; the
    ``levels`` entry lists the level order for fabric-agnostic readers.
    """
    lb = np.asarray(state.metrics.link_bytes)[: topo.n_links]
    levels = topo.link_levels()
    names = list(levels)
    out: Dict[str, Any] = dict(levels=names)
    totals = {}
    for name, mask in levels.items():
        n = int(mask.sum())
        tot = float(lb[mask].sum())
        totals[name] = tot
        out[f"{name}_total_bytes"] = tot
        out[f"{name}_per_link_bytes"] = float(tot / max(n, 1))
        out[f"n_{name}_links"] = n
    inter_total = sum(totals.values())
    # per-level traffic shares (dragonfly keeps its historical
    # frac_global; every other level gets the symmetric frac_<level>)
    for name in names:
        out[f"frac_{name}"] = float(totals[name] / max(inter_total, 1))
    return out


def link_level_utilization(state, topo: Fabric) -> Dict[str, Any]:
    """Per-level link utilization: delivered bytes / (level bandwidth ×
    virtual time) — mean over the level's links, plus the busiest link.

    The cross-fabric comparison metric: at equal offered load, the level
    that saturates first differs per fabric (dragonfly global links,
    fat-tree up links, a torus dimension).
    """
    lb = np.asarray(state.metrics.link_bytes)[: topo.n_links]
    bw = np.asarray(topo.link_bw, np.float64)
    t_s = float(np.max(np.asarray(state.t))) * 1e-6  # us -> s
    levels = dict(topo.link_levels())
    levels["terminal"] = (
        (topo.link_kind == KIND_TERM_IN) | (topo.link_kind == KIND_TERM_OUT)
    )
    out: Dict[str, Any] = {}
    for name, mask in levels.items():
        if not mask.any() or t_s <= 0:
            out[name] = dict(mean=0.0, max=0.0)
            continue
        util = lb[mask] / (bw[mask] * t_s)
        out[name] = dict(mean=float(util.mean()), max=float(util.max()))
    return out


def router_traffic_windows(state, app_names: Sequence[str], router_set: np.ndarray):
    """Fig. 8: per-window bytes received by `router_set` routers, per app."""
    wins = np.asarray(state.metrics.router_wins)  # (W, n_apps, R)
    k = int(state.metrics.win_idx)
    wins = wins[: max(k, 1)]
    per_app = wins[:, :, router_set].sum(axis=2)  # (W, n_apps)
    return {name: per_app[:, i] for i, name in enumerate(app_names)}


class PoolExhausted(RuntimeError):
    """The message pool dropped allocations — results are corrupted."""


def check_dropped(state, strict: bool = False) -> int:
    """Surface pool-allocation failures: warn (default) or raise (strict).

    A nonzero ``pool.dropped`` means emitted messages silently vanished —
    conservation breaks and latency/comm-time numbers are invalid. Rerun
    with a larger ``pool_size``.
    """
    dropped = int(state.pool.dropped)
    if dropped:
        msg = (
            f"message pool exhausted: {dropped} allocation(s) dropped — "
            f"results are corrupted; increase pool_size"
        )
        if strict:
            raise PoolExhausted(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return dropped


def run_report(state, app_names, topo, net, sim_wall_s: float = 0.0,
               strict: bool = False) -> Dict[str, Any]:
    rep = dict(
        virtual_time_ms=float(state.t) / 1000.0,
        dropped=check_dropped(state, strict=strict),
        peak_inject_bytes_per_tick=float(state.metrics.peak_inject),
        peak_inject_TiBps=float(state.metrics.peak_inject)
        / (net.tick_us * 1e-6) / 2**40,
        latency=latency_summary(state, app_names, net),
        comm_time=comm_time_summary(state, app_names),
        link_load=link_load_summary(state, topo),
        link_utilization=link_level_utilization(state, topo),
        sim_wall_s=sim_wall_s,
    )
    # the (app, link-level) latency histograms ride along when the state
    # came from a histogrammed engine (repro_torch.obs.hist)
    if getattr(state, "hist", None) is not None:
        rep["latency_hist"] = hist_summary(
            state.hist, app_names, list(topo.link_levels()))
    return rep
