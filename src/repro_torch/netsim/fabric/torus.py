"""3D torus fabric (dimension-order routing + adaptive bypass).

``dims = (X, Y, Z)`` routers with wraparound links in every dimension of
size > 1 and ``nodes_per_router`` hosts each. Router ``r`` sits at
``(x, y, z) = (r % X, (r // X) % Y, r // (X*Y))`` — node ids are
contiguous per router and per z-plane, so RR places whole routers and RG
places contiguous plane blocks (the classic torus block placement).

Links are unidirectional rows ``dim_link[r, d, s]`` (s=0 the +1
direction, s=1 the -1 direction; dims of size 2 get two parallel links).
Link kinds ``2 + d`` split utilization per dimension (x/y/z levels).

Routing:

* **Dimension-order (DOR)**: traverse x, then y, then z, each dimension
  going the shorter way around the ring (wrap ties broken per-message by
  the rand stream).
* **Adaptive bypass**: the same hop budget routed in *reverse* dimension
  order (z, y, x) visits a disjoint set of intermediate routers; the
  router compares live demand over both candidate link chains and takes
  the less congested one (O1TURN-style order adaptivity — hop count is
  unchanged, so the route width stays ``2 + sum(d // 2)``).

Routes are packed ``[term_in, per-dim segments in traversal order,
term_out]`` (-1 padded within each segment), so the non-padding slots
always form a connected link chain — the property the fabric route
tests check. The engine itself consumes a route as a link *set*
(fair-share min over the route's links + a hop-latency floor).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.fabric.base import terminal_link_rows

KIND_DIM0 = 2  # link kind for dimension d is KIND_DIM0 + d
DIM_NAMES = ("x", "y", "z")


@dataclass
class Torus:
    dims: Tuple[int, int, int]
    nodes_per_router: int

    n_routers: int = 0
    n_nodes: int = 0
    n_links: int = 0
    link_kind: np.ndarray = field(default=None, repr=False)
    link_bw: np.ndarray = field(default=None, repr=False)
    link_dst_router: np.ndarray = field(default=None, repr=False)
    link_src_router: np.ndarray = field(default=None, repr=False)
    dim_link: np.ndarray = field(default=None, repr=False)  # (R, 3, 2)

    # --- Fabric protocol ---
    @property
    def family(self) -> str:
        return "torus"

    @property
    def route_width(self) -> int:
        return 2 + sum(d // 2 for d in self.dims)

    @property
    def place_routers(self) -> int:
        return self.n_routers

    @property
    def place_groups(self) -> int:
        return self.dims[2]  # z-planes: contiguous router/node blocks

    @property
    def nodes_per_group(self) -> int:
        return self.dims[0] * self.dims[1] * self.nodes_per_router

    def node_router(self, node):
        return node // self.nodes_per_router

    def cache_key(self) -> Tuple:
        return (self.family, *self.dims, self.nodes_per_router)

    def link_levels(self) -> Dict[str, np.ndarray]:
        return {
            DIM_NAMES[d]: self.link_kind == KIND_DIM0 + d
            for d in range(3)
            if self.dims[d] > 1
        }

    def routing_tables(self, device):
        return torus_arrays(self, device), torus_routes


def build_torus(
    dims: Tuple[int, int, int],
    nodes_per_router: int = 1,
    net: Optional[NetConfig] = None,
) -> Torus:
    if len(dims) != 3 or any(d < 1 for d in dims):
        raise ValueError(f"torus dims must be 3 positive ints, got {dims}")
    net = net or NetConfig()
    X, Y, Z = dims
    R = X * Y * Z
    p = nodes_per_router
    topo = Torus(dims=tuple(dims), nodes_per_router=p)
    topo.n_routers, topo.n_nodes = R, R * p

    kinds, bws, dsts, srcs = terminal_link_rows(R * p, p, net.terminal_bw)

    dim_link = np.full((R, 3, 2), -1, np.int64)
    strides = (1, X, X * Y)
    for r in range(R):
        coord = (r % X, (r // X) % Y, r // (X * Y))
        for d in range(3):
            D = dims[d]
            if D <= 1:
                continue
            for s, step in ((0, 1), (1, -1)):
                nb_c = (coord[d] + step) % D
                nb = r + (nb_c - coord[d]) * strides[d]
                dim_link[r, d, s] = len(kinds)
                kinds.append(KIND_DIM0 + d)
                bws.append(net.local_bw)
                srcs.append(r)
                dsts.append(nb)

    topo.dim_link = dim_link
    topo.link_kind = np.asarray(kinds, np.int32)
    topo.link_bw = np.asarray(bws, np.float64)
    topo.link_dst_router = np.asarray(dsts, np.int64)
    topo.link_src_router = np.asarray(srcs, np.int64)
    topo.n_links = len(kinds)
    return topo


# ---- the batched router ----

class TorusArrays(NamedTuple):
    X: int
    Y: int
    Z: int
    p: int
    n_nodes: int
    n_links: int
    dim_link: torch.Tensor  # (R * 6,) int64: dim_link[r, d, s] flattened
    link_bw: torch.Tensor  # (L,) f32


def torus_arrays(t: Torus, device) -> TorusArrays:
    return TorusArrays(
        X=t.dims[0], Y=t.dims[1], Z=t.dims[2], p=t.nodes_per_router,
        n_nodes=t.n_nodes, n_links=t.n_links,
        # -1 rows (dims of size 1) are never gathered: their segment
        # loops are statically empty
        dim_link=torch.as_tensor(
            np.asarray(t.dim_link, np.int64).reshape(-1), device=device),
        link_bw=torch.as_tensor(
            np.asarray(t.link_bw, np.float32), device=device),
    )


def torus_routes(
    T: TorusArrays,
    src_nodes: torch.Tensor,
    dst_nodes: torch.Tensor,
    rand: torch.Tensor,
    link_demand: torch.Tensor,
    adaptive: bool,
    demand_offsets: torch.Tensor = None,
):
    """Returns (routes (n, route_width) int32, n_hops (n,) int32) — same
    contract as :func:`repro_torch.netsim.routing.compute_routes`.

    The reference builds one message's route in a Python loop over the
    dimensions and their hop slots; that loop is static, so here it runs
    once over whole (n,) tensors. Index arithmetic runs in int64;
    ``%`` is the floor modulo of ``jnp`` (a negative step wraps to the
    ring's far end)."""
    # local import: routing.py imports the dragonfly fabric module
    from repro_torch.netsim.routing import route_cost

    dims = (T.X, T.Y, T.Z)
    segs = [d // 2 for d in dims]  # max hops per dimension
    s = src_nodes.long()
    d = dst_nodes.long()
    r = rand.long()
    off = (torch.zeros_like(s) if demand_offsets is None
           else demand_offsets.long())
    rs = s // T.p
    rd = d // T.p
    sc = [rs % T.X, (rs // T.X) % T.Y, rs // (T.X * T.Y)]
    dc = [rd % T.X, (rd // T.X) % T.Y, rd // (T.X * T.Y)]
    # per-dimension direction + hop count (shorter way around; wrap ties
    # broken by the per-message rand bits)
    steps, sign, dirn = [], [], []
    for dim in range(3):
        D = dims[dim]
        fwd = (dc[dim] - sc[dim]) % D
        bwd = (D - fwd) % D
        tie = (r >> dim) & 1
        use_fwd = (fwd < bwd) | ((fwd == bwd) & (tie == 0))
        steps.append(torch.minimum(fwd, bwd))
        sign.append(torch.where(use_fwd, 0, 1))
        dirn.append(torch.where(use_fwd, 1, -1))

    def compose(c):
        return c[0] + T.X * (c[1] + T.Y * c[2])

    def segments(order):
        """The per-dimension link chains for a traversal in ``order``
        (dims earlier in the order are at their dst coordinate while a
        later dim is crossed), packed in traversal order so the route
        slots form a connected chain: a list of (n,) columns."""
        moved = []
        cols = []
        for dim in order:
            cur = [dc[i] if i in moved else sc[i] for i in range(3)]
            for t in range(segs[dim]):
                c = list(cur)
                c[dim] = (sc[dim] + dirn[dim] * t) % dims[dim]
                lid = T.dim_link[compose(c) * 6 + dim * 2 + sign[dim]]
                cols.append(torch.where(t < steps[dim], lid, -1))
            moved.append(dim)
        return cols

    def pack(cols):
        return torch.stack([s] + cols + [T.n_nodes + d], dim=1)

    routes = pack(segments((0, 1, 2)))
    if adaptive:
        route_b = pack(segments((2, 1, 0)))
        take_b = (route_cost(T, route_b, link_demand, off)
                  < route_cost(T, routes, link_demand, off) - 1e-6)
        routes = torch.where(take_b[:, None], route_b, routes)
    n_hops = (routes >= 0).sum(dim=1)
    return routes.to(torch.int32), n_hops.to(torch.int32)


# ---- scale configurations ----

def torus_small(net: Optional[NetConfig] = None) -> Torus:
    # 4x4x4 routers x 8 nodes = 512 nodes (>= the 504-node small
    # dragonfly, every small-scale mix fits); route width 2+6 = 8
    return build_torus((4, 4, 4), 8, net=net)


def torus_paper(net: Optional[NetConfig] = None) -> Torus:
    # 11x12x16 routers x 4 nodes = 8448 nodes — exactly the paper's
    # dragonfly host count on a torus; route width 2+5+6+8 = 21
    return build_torus((11, 12, 16), 4, net=net)
