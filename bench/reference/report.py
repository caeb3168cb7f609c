"""A member's final state -> the per-member report (a frozen copy of the
port's `netsim/metrics.py` `run_report`: per-app latency and
communication time, link load and utilization by fabric level, and the
`config` block of `union/manager.py`'s `member_report`)."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .fabric import KIND_TERM_IN, KIND_TERM_OUT, Dragonfly, NetConfig


def latency_summary(m, names: List[str], net: NetConfig) -> Dict[str, Any]:
    edges = net.latency_hist_lo_us * (
        net.latency_hist_ratio ** np.arange(net.latency_hist_bins + 1))
    mids = np.sqrt(edges[:-1] * edges[1:])
    out = {}
    for i, name in enumerate(names):
        cnt = int(m["lat_cnt"][i])
        if cnt == 0:
            out[name] = dict(count=0)
            continue
        cum = np.cumsum(np.asarray(m["lat_hist"][i]))

        def q(p):
            j = int(np.searchsorted(cum, p * cnt))
            return float(mids[min(j, len(mids) - 1)])

        out[name] = dict(
            count=cnt, avg_us=float(m["lat_sum"][i]) / cnt,
            min_us=float(m["lat_min"][i]), max_us=float(m["lat_max"][i]),
            p25_us=q(0.25), p50_us=q(0.50), p75_us=q(0.75))
    return out


def comm_time_summary(comm_time, P, names: List[str]) -> Dict[str, Any]:
    out = {}
    ct_all = np.asarray(comm_time) / 1000.0
    for ji, name in enumerate(names):
        if ji >= ct_all.shape[0]:
            continue
        ct = ct_all[ji, :int(P[ji])]
        out[name] = dict(max_ms=float(ct.max()), avg_ms=float(ct.mean()),
                         min_ms=float(ct.min()))
    return out


def link_load_summary(link_bytes, topo: Dragonfly) -> Dict[str, Any]:
    lb = np.asarray(link_bytes)[:topo.n_links]
    levels = topo.link_levels()
    out: Dict[str, Any] = dict(levels=list(levels))
    totals = {}
    for name, mask in levels.items():
        n = int(mask.sum())
        tot = float(lb[mask].sum())
        totals[name] = tot
        out[f"{name}_total_bytes"] = tot
        out[f"{name}_per_link_bytes"] = float(tot / max(n, 1))
        out[f"n_{name}_links"] = n
    inter = sum(totals.values())
    for name in levels:
        out[f"frac_{name}"] = float(totals[name] / max(inter, 1))
    return out


def link_level_utilization(link_bytes, t_us, topo: Dragonfly):
    lb = np.asarray(link_bytes)[:topo.n_links]
    bw = np.asarray(topo.link_bw, np.float64)
    t_s = float(t_us) * 1e-6
    levels = dict(topo.link_levels())
    levels["terminal"] = ((topo.link_kind == KIND_TERM_IN)
                          | (topo.link_kind == KIND_TERM_OUT))
    out: Dict[str, Any] = {}
    for name, mask in levels.items():
        if not mask.any() or t_s <= 0:
            out[name] = dict(mean=0.0, max=0.0)
            continue
        util = lb[mask] / (bw[mask] * t_s)
        out[name] = dict(mean=float(util.mean()), max=float(util.max()))
    return out


def member_report(s: Dict[str, np.ndarray], names: List[str], n_jobs: int,
                  topo: Dragonfly, net: NetConfig,
                  config: Dict[str, Any]) -> Dict[str, Any]:
    """``s`` holds one member's final leaves as numpy arrays: t, the
    lat_* metrics, link_bytes, peak_inject, dropped, comm_time, P, done;
    ``names`` names the metric rows (the jobs, then "ur")."""
    peak = np.float32(s["peak_inject"])
    rep = dict(
        virtual_time_ms=float(s["t"]) / 1000.0,
        dropped=int(s["dropped"]),
        peak_inject_bytes_per_tick=float(peak),
        peak_inject_TiBps=float(peak) / (net.tick_us * 1e-6) / 2**40,
        latency=latency_summary(s, names, net),
        comm_time=comm_time_summary(s["comm_time"], s["P"], names),
        link_load=link_load_summary(s["link_bytes"], topo),
        link_utilization=link_level_utilization(s["link_bytes"], s["t"],
                                                topo),
    )
    rep["config"] = dict(config, all_done=[
        bool(np.asarray(s["done"][ji]).all()) for ji in range(n_jobs)])
    return rep
