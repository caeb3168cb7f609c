"""Dragonfly fabric (1D and 2D, paper Table II) — the first ``Fabric``.

All structure is dense numpy arrays so the tick engine can gather/scatter:

* link table: links[0:N] terminal-in (node->router), links[N:2N] terminal-out
  (router->node), then local router links, then global router links.
* ``local_link_id[r, l2]``: link id r -> router with local index l2 in the
  same group (-1 if no direct local link — 2D routers in a different
  row+column).
* ``global_gw[g, tg, m]``: the m-th router of group g owning a global
  channel to group tg, and ``global_link_id[g, tg, m]`` the matching link.

Paper configs:
  1D: radix 48, 33 groups × 32 routers × 8 nodes  (8448 nodes, 4 gch/router)
  2D: radix 48, 22 groups × 96 routers (6×16) × 4 nodes (8448, 7 gch/router)

Routing (MIN / adaptive UGAL) lives in :mod:`repro_torch.netsim.routing`;
:meth:`Dragonfly.routing_tables` binds it behind the Fabric protocol and
returns the port's own torch gather tables on the requested device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.netsim.config import NetConfig

KIND_TERM_IN, KIND_TERM_OUT, KIND_LOCAL, KIND_GLOBAL = 0, 1, 2, 3


@dataclass
class Dragonfly:
    variant: str  # "1d" | "2d"
    n_groups: int
    routers_per_group: int
    nodes_per_router: int
    global_per_router: int
    rows: int = 0  # 2D only
    cols: int = 0

    # built arrays
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

    # --- helpers ---
    def node_router(self, node):
        return node // self.nodes_per_router

    def router_group(self, r):
        return r // self.routers_per_group

    def local_index(self, r):
        return r % self.routers_per_group

    # --- Fabric protocol ---
    @property
    def family(self) -> str:
        return "dragonfly"

    @property
    def route_width(self) -> int:
        # [term_in, l1a, l1b, g1, l2a, l2b, g2, l3a, l3b, term_out]
        return 10

    @property
    def place_routers(self) -> int:
        return self.n_routers

    @property
    def place_groups(self) -> int:
        return self.n_groups

    @property
    def nodes_per_group(self) -> int:
        return self.routers_per_group * self.nodes_per_router

    def cache_key(self) -> Tuple:
        return (
            self.family, self.variant, self.n_groups, self.routers_per_group,
            self.nodes_per_router, self.global_per_router, self.rows,
            self.cols,
        )

    def link_levels(self) -> Dict[str, np.ndarray]:
        return {
            "local": self.link_kind == KIND_LOCAL,
            "global": self.link_kind == KIND_GLOBAL,
        }

    def routing_tables(self, device):
        # local import: routing.py consumes Dragonfly, fabric construction
        # must not require torch at import time
        from repro_torch.netsim.routing import compute_routes, topo_arrays

        return topo_arrays(self, device), compute_routes


def _build_global_wiring(G: int, routers_per_group: int, h: int):
    """Assign each router's global channels to target groups.

    Channel k = local_idx*h + c of group g targets group tg where
    tg = k mod (G-1), skipping g itself. Channels per group pair:
    routers_per_group*h / (G-1) (paper: 4 for 1D, 32 for 2D).
    """
    chan_per_group = routers_per_group * h
    assert chan_per_group % (G - 1) == 0, "uneven global wiring"
    lpp = chan_per_group // (G - 1)
    # gw[g, tg, m] = router local index owning m-th channel g->tg
    gw = np.full((G, G, lpp), -1, np.int64)
    cnt = np.zeros((G, G), np.int64)
    for g in range(G):
        for k in range(chan_per_group):
            tg = k % (G - 1)
            if tg >= g:
                tg += 1
            m = cnt[g, tg]
            gw[g, tg, m] = k // h  # local router index
            cnt[g, tg] += 1
    assert (cnt + np.eye(G, dtype=np.int64) * lpp == lpp).all()
    return gw, lpp


def build_dragonfly(
    variant: str,
    n_groups: int,
    routers_per_group: int,
    nodes_per_router: int,
    global_per_router: int,
    rows: int = 0,
    cols: int = 0,
    net: Optional[NetConfig] = None,
) -> Dragonfly:
    net = net or NetConfig()
    topo = Dragonfly(
        variant, n_groups, routers_per_group, nodes_per_router,
        global_per_router, rows, cols,
    )
    G, a, p, h = n_groups, routers_per_group, nodes_per_router, global_per_router
    R = G * a
    N = R * p
    topo.n_routers, topo.n_nodes = R, N

    kinds, bws, dsts, srcs = [], [], [], []

    # terminal links: in (node->router) then out (router->node)
    for n in range(N):
        kinds.append(KIND_TERM_IN); bws.append(net.terminal_bw)
        dsts.append(n // p); srcs.append(n // p)
    for n in range(N):
        kinds.append(KIND_TERM_OUT); bws.append(net.terminal_bw)
        dsts.append(n // p); srcs.append(n // p)

    # local links
    local_link_id = np.full((R, a), -1, np.int64)
    if variant == "1d":
        pairs = [(l1, l2) for l1 in range(a) for l2 in range(a) if l1 != l2]
    else:
        assert rows * cols == a
        pairs = []
        for l1 in range(a):
            r1, c1 = divmod(l1, cols)
            for l2 in range(a):
                if l1 == l2:
                    continue
                r2, c2 = divmod(l2, cols)
                if r1 == r2 or c1 == c2:
                    pairs.append((l1, l2))
    for g in range(G):
        base = g * a
        for l1, l2 in pairs:
            local_link_id[base + l1, l2] = len(kinds)
            kinds.append(KIND_LOCAL); bws.append(net.local_bw)
            dsts.append(base + l2); srcs.append(base + l1)
    topo.local_link_id = local_link_id

    # global links
    gw, lpp = _build_global_wiring(G, a, h)
    topo.links_per_pair = lpp
    global_gw = np.full((G, G, lpp), -1, np.int64)
    global_link_id = np.full((G, G, lpp), -1, np.int64)
    for g in range(G):
        for tg in range(G):
            if tg == g:
                continue
            for m in range(lpp):
                src_r = g * a + gw[g, tg, m]
                dst_r = tg * a + gw[tg, g, m]  # paired m-th channel
                global_gw[g, tg, m] = src_r
                global_link_id[g, tg, m] = len(kinds)
                kinds.append(KIND_GLOBAL); bws.append(net.global_bw)
                dsts.append(dst_r); srcs.append(src_r)
    topo.global_gw = global_gw
    topo.global_link_id = global_link_id

    topo.link_kind = np.asarray(kinds, np.int32)
    topo.link_bw = np.asarray(bws, np.float64)
    topo.link_dst_router = np.asarray(dsts, np.int64)
    topo.link_src_router = np.asarray(srcs, np.int64)
    topo.n_links = len(kinds)
    return topo


# ---- paper configurations (Table II) ----

def dragonfly_1d_paper(net: Optional[NetConfig] = None) -> Dragonfly:
    return build_dragonfly("1d", 33, 32, 8, 4, net=net)


def dragonfly_2d_paper(net: Optional[NetConfig] = None) -> Dragonfly:
    return build_dragonfly("2d", 22, 96, 4, 7, rows=6, cols=16, net=net)


# ---- reduced systems for CPU-scale benches/tests ----

def dragonfly_1d_small(net: Optional[NetConfig] = None) -> Dragonfly:
    # 9 groups x 8 routers x 7 nodes = 504 nodes; 2 gch/router (16 ch/group,
    # 2 per group pair) — big enough for the small-scale workload mixes
    return build_dragonfly("1d", 9, 8, 7, 2, net=net)


def dragonfly_2d_small(net: Optional[NetConfig] = None) -> Dragonfly:
    # 7 groups x 12 routers (3x4) x 6 nodes = 504 nodes; 3 gch/router
    # (36 ch/group, 6 per pair)
    return build_dragonfly("2d", 7, 12, 6, 3, rows=3, cols=4, net=net)
