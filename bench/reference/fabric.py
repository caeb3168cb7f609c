"""The network: link parameters, the dragonfly fabrics of the paper's
Table II and the job placement policies (a frozen copy of the port's
`netsim/config.py`, `netsim/fabric/dragonfly.py` and `netsim/placement.py`,
dragonflies only).

Link table: links[0:N] terminal-in (node->router), links[N:2N] terminal-out
(router->node), then local router links, then global router links.
``local_link_id[r, l2]`` is the link r -> the router of local index l2 in
the same group (-1 if none: 2D routers in another row and column);
``global_gw[g, tg, m]`` is the m-th router of group g owning a global
channel to group tg, ``global_link_id[g, tg, m]`` its link.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

KIND_TERM_IN, KIND_TERM_OUT, KIND_LOCAL, KIND_GLOBAL = 0, 1, 2, 3


@dataclass(frozen=True)
class NetConfig:
    """Paper §IV-A: bandwidths in bytes/s, per-hop latency, metric windows
    and the geometric latency histogram."""

    terminal_bw: float = 16 * 2**30
    local_bw: float = 4.69 * 2**30
    global_bw: float = 5.25 * 2**30
    hop_latency_us: float = 0.5
    tick_us: float = 1.0
    pool_size: int = 65536
    window_us: float = 500.0
    max_windows: int = 512
    latency_hist_bins: int = 64
    latency_hist_lo_us: float = 0.5
    latency_hist_ratio: float = 1.25


@dataclass
class Dragonfly:
    variant: str  # "1d" | "2d"
    n_groups: int
    routers_per_group: int
    nodes_per_router: int
    global_per_router: int
    rows: int = 0
    cols: int = 0
    n_routers: int = 0
    n_nodes: int = 0
    n_links: int = 0
    link_kind: np.ndarray = field(default=None, repr=False)
    link_bw: np.ndarray = field(default=None, repr=False)
    link_dst_router: np.ndarray = field(default=None, repr=False)
    link_src_router: np.ndarray = field(default=None, repr=False)
    local_link_id: np.ndarray = field(default=None, repr=False)
    global_gw: np.ndarray = field(default=None, repr=False)
    global_link_id: np.ndarray = field(default=None, repr=False)
    links_per_pair: int = 0

    # [term_in, l1a, l1b, g1, l2a, l2b, g2, l3a, l3b, term_out]
    route_width = 10

    @property
    def nodes_per_group(self) -> int:
        return self.routers_per_group * self.nodes_per_router

    def link_levels(self) -> Dict[str, np.ndarray]:
        return {"local": self.link_kind == KIND_LOCAL,
                "global": self.link_kind == KIND_GLOBAL}


def _global_wiring(G: int, a: int, h: int):
    """Channel k = local_idx*h + c of group g targets group k mod (G-1),
    skipping g itself."""
    chans = a * h
    if chans % (G - 1):
        raise ValueError("uneven global wiring")
    lpp = chans // (G - 1)
    gw = np.full((G, G, lpp), -1, np.int64)
    cnt = np.zeros((G, G), np.int64)
    for g in range(G):
        for k in range(chans):
            tg = k % (G - 1)
            if tg >= g:
                tg += 1
            gw[g, tg, cnt[g, tg]] = k // h
            cnt[g, tg] += 1
    return gw, lpp


def build_dragonfly(variant: str, G: int, a: int, p: int, h: int,
                    rows: int = 0, cols: int = 0,
                    net: NetConfig = NetConfig()) -> Dragonfly:
    t = Dragonfly(variant, G, a, p, h, rows, cols)
    R = G * a
    N = R * p
    t.n_routers, t.n_nodes = R, N
    kinds, bws, dsts, srcs = [], [], [], []
    for kind in (KIND_TERM_IN, KIND_TERM_OUT):
        for n in range(N):
            kinds.append(kind)
            bws.append(net.terminal_bw)
            dsts.append(n // p)
            srcs.append(n // p)
    local = np.full((R, a), -1, np.int64)
    if variant == "1d":
        pairs = [(l1, l2) for l1 in range(a) for l2 in range(a) if l1 != l2]
    else:
        if rows * cols != a:
            raise ValueError("2D dragonfly: rows x cols != routers a group")
        pairs = [(l1, l2) for l1 in range(a) for l2 in range(a)
                 if l1 != l2 and (l1 // cols == l2 // cols
                                  or l1 % cols == l2 % cols)]
    for g in range(G):
        base = g * a
        for l1, l2 in pairs:
            local[base + l1, l2] = len(kinds)
            kinds.append(KIND_LOCAL)
            bws.append(net.local_bw)
            dsts.append(base + l2)
            srcs.append(base + l1)
    t.local_link_id = local
    gw, lpp = _global_wiring(G, a, h)
    t.links_per_pair = lpp
    t.global_gw = np.full((G, G, lpp), -1, np.int64)
    t.global_link_id = np.full((G, G, lpp), -1, np.int64)
    for g in range(G):
        for tg in range(G):
            if tg == g:
                continue
            for m in range(lpp):
                src_r = g * a + gw[g, tg, m]
                t.global_gw[g, tg, m] = src_r
                t.global_link_id[g, tg, m] = len(kinds)
                kinds.append(KIND_GLOBAL)
                bws.append(net.global_bw)
                dsts.append(tg * a + gw[tg, g, m])
                srcs.append(src_r)
    t.link_kind = np.asarray(kinds, np.int32)
    t.link_bw = np.asarray(bws, np.float64)
    t.link_dst_router = np.asarray(dsts, np.int64)
    t.link_src_router = np.asarray(srcs, np.int64)
    t.n_links = len(kinds)
    return t


# (topo, scale) -> the arguments of build_dragonfly; "paper" is Table II
DRAGONFLIES = {
    ("1d", "paper"): ("1d", 33, 32, 8, 4),
    ("2d", "paper"): ("2d", 22, 96, 4, 7, 6, 16),
    ("1d", "small"): ("1d", 9, 8, 7, 2),
    ("2d", "small"): ("2d", 7, 12, 6, 3, 3, 4),
}


def dragonfly(topo: str, scale: str) -> Dragonfly:
    return build_dragonfly(*DRAGONFLIES[(topo, scale)])


def place_jobs(t: Dragonfly, sizes: Sequence[int], policy: str,
               seed: int, occupied=None) -> List[np.ndarray]:
    """Paper §IV-C: random nodes (RN), routers (RR) or groups (RG); each
    job takes the next ``size`` nodes of the drawn order. ``occupied``
    (an ``(n_nodes,)`` bool mask, the online scheduler's) takes the nodes
    it holds out of the order, which keeps its draw."""
    rng = np.random.default_rng(seed)
    free = t.n_nodes - (0 if occupied is None else int(occupied.sum()))
    if sum(sizes) > free:
        raise ValueError(f"jobs need {sum(sizes)} nodes of {free} free")
    p = t.nodes_per_router
    if policy == "RN":
        order = rng.permutation(t.n_nodes)
    elif policy == "RR":
        order = (rng.permutation(t.n_routers)[:, None] * p
                 + np.arange(p)[None, :]).reshape(-1)
    elif policy == "RG":
        npg = t.nodes_per_group
        order = (rng.permutation(t.n_groups)[:, None] * npg
                 + np.arange(npg)[None, :]).reshape(-1)
    else:
        raise ValueError(f"unknown placement policy {policy!r}")
    if occupied is not None:
        order = order[~np.asarray(occupied, bool)[order]]
    offs = np.cumsum([0] + list(sizes))
    return [np.asarray(order[offs[i]:offs[i + 1]], np.int64)
            for i in range(len(sizes))]
