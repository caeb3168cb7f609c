"""k-ary fat-tree / Clos fabric (Al-Fares et al.) behind the Fabric protocol.

Structure of a k-ary fat-tree (``m = k/2``):

* ``k`` pods, each with ``m`` edge (ToR) switches and ``m`` aggregation
  switches; ``m*m`` core switches; every edge hosts ``hosts_per_edge``
  nodes (default ``m`` — the canonical ``k^3/4`` host count).
* Edge ``i`` of a pod connects up to all ``m`` aggs of its pod; agg ``j``
  connects up to cores ``j*m .. j*m+m-1``; core ``j*m+i`` connects down
  to agg ``j`` of *every* pod. Up links (edge->agg, agg->core) and down
  links (core->agg, agg->edge) are separate unidirectional link rows, so
  per-level utilization splits cleanly.

Routing:

* **Deterministic up/down (D-mod-k)**: the destination host id picks the
  agg (``dst % m``) and the core (``(dst // m) % m``) — every
  source-destination pair uses one fixed path, like static ECMP hashing.
* **Adaptive upward spraying**: the up links are chosen by live link
  demand (least outstanding bytes, random-rotation tiebreak) — first the
  edge->agg hop, then agg->core; the down path is then forced by the
  destination. Downward routing in a fat-tree is always deterministic.
  Only the chosen up links enter the cost: a dead down link does not
  steer the spray (the JAX package's router does the same, and the port
  keeps its routes bit for bit).

Router ids: edges ``[0, k*m)`` (pod-major), aggs ``[k*m, 2*k*m)``,
cores ``[2*k*m, 2*k*m + m*m)``. Node ``n`` lives on edge ``n //
hosts_per_edge`` — contiguous per edge and per pod, so RR places whole
edge switches and RG places whole pods (pod-aware placement).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.fabric.base import terminal_link_rows

KIND_UP, KIND_DOWN = 2, 3


@dataclass
class FatTree:
    k: int  # pods (even); m = k//2 edges/aggs per pod, m*m cores
    hosts_per_edge: int

    n_routers: int = 0
    n_nodes: int = 0
    n_links: int = 0
    link_kind: np.ndarray = field(default=None, repr=False)
    link_bw: np.ndarray = field(default=None, repr=False)
    link_dst_router: np.ndarray = field(default=None, repr=False)
    link_src_router: np.ndarray = field(default=None, repr=False)
    # gather tables
    up1_link: np.ndarray = field(default=None, repr=False)  # (E, m)
    up2_link: np.ndarray = field(default=None, repr=False)  # (A, m)
    down1_link: np.ndarray = field(default=None, repr=False)  # (C, k)
    down2_link: np.ndarray = field(default=None, repr=False)  # (A, m)

    @property
    def m(self) -> int:
        return self.k // 2

    @property
    def n_edges(self) -> int:
        return self.k * self.m

    # --- Fabric protocol ---
    @property
    def family(self) -> str:
        return "fat_tree"

    @property
    def route_width(self) -> int:
        # [term_in, edge->agg, agg->core, core->agg, agg->edge, term_out]
        return 6

    @property
    def place_routers(self) -> int:
        return self.n_edges  # only edge switches own hosts

    @property
    def nodes_per_router(self) -> int:
        return self.hosts_per_edge

    @property
    def place_groups(self) -> int:
        return self.k  # pods

    @property
    def nodes_per_group(self) -> int:
        return self.m * self.hosts_per_edge

    def node_router(self, node):
        return node // self.hosts_per_edge

    def cache_key(self) -> Tuple:
        return (self.family, self.k, self.hosts_per_edge)

    def link_levels(self) -> Dict[str, np.ndarray]:
        return {
            "up": self.link_kind == KIND_UP,
            "down": self.link_kind == KIND_DOWN,
        }

    def routing_tables(self, device):
        return fat_tree_arrays(self, device), fat_tree_routes


def build_fat_tree(
    k: int,
    hosts_per_edge: Optional[int] = None,
    net: Optional[NetConfig] = None,
) -> FatTree:
    if k < 2 or k % 2:
        raise ValueError(f"fat-tree k must be even and >= 2, got {k}")
    net = net or NetConfig()
    m = k // 2
    h = hosts_per_edge or m
    topo = FatTree(k=k, hosts_per_edge=h)
    E, A, C = k * m, k * m, m * m
    topo.n_routers = E + A + C
    N = E * h
    topo.n_nodes = N
    agg0, core0 = E, E + A  # router-id bases

    kinds, bws, dsts, srcs = terminal_link_rows(N, h, net.terminal_bw)

    def emit(kind, bw, src_r, dst_r):
        lid = len(kinds)
        kinds.append(kind); bws.append(bw)
        srcs.append(src_r); dsts.append(dst_r)
        return lid

    # up: edge -> agg (local bw), agg -> core (global bw)
    up1 = np.zeros((E, m), np.int64)
    for e in range(E):
        pod = e // m
        for j in range(m):
            up1[e, j] = emit(KIND_UP, net.local_bw, e, agg0 + pod * m + j)
    up2 = np.zeros((A, m), np.int64)
    for a in range(A):
        j = a % m
        for i in range(m):
            up2[a, i] = emit(
                KIND_UP, net.global_bw, agg0 + a, core0 + j * m + i)

    # down: core -> agg (global bw), agg -> edge (local bw)
    down1 = np.zeros((C, k), np.int64)
    for c in range(C):
        j = c // m
        for pod in range(k):
            down1[c, pod] = emit(
                KIND_DOWN, net.global_bw, core0 + c, agg0 + pod * m + j)
    down2 = np.zeros((A, m), np.int64)
    for a in range(A):
        pod = a // m
        for i in range(m):
            down2[a, i] = emit(KIND_DOWN, net.local_bw, agg0 + a, pod * m + i)

    topo.up1_link, topo.up2_link = up1, up2
    topo.down1_link, topo.down2_link = down1, down2
    topo.link_kind = np.asarray(kinds, np.int32)
    topo.link_bw = np.asarray(bws, np.float64)
    topo.link_dst_router = np.asarray(dsts, np.int64)
    topo.link_src_router = np.asarray(srcs, np.int64)
    topo.n_links = len(kinds)
    return topo


# ---- the batched router ----

class FatTreeArrays(NamedTuple):
    m: int
    h: int
    pods: int
    n_nodes: int
    n_links: int
    up1: torch.Tensor  # (E, m) int64
    up2: torch.Tensor  # (A, m) int64
    down1: torch.Tensor  # (C, pods) int64
    down2: torch.Tensor  # (A, m) int64
    link_bw: torch.Tensor  # (L,) f32


def fat_tree_arrays(t: FatTree, device) -> FatTreeArrays:
    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return FatTreeArrays(
        m=t.m, h=t.hosts_per_edge, pods=t.k,
        n_nodes=t.n_nodes, n_links=t.n_links,
        up1=i64(t.up1_link), up2=i64(t.up2_link),
        down1=i64(t.down1_link), down2=i64(t.down2_link),
        link_bw=torch.as_tensor(
            np.asarray(t.link_bw, np.float32), device=device),
    )


def _spray(T: FatTreeArrays, cand_links, link_demand, off, rand):
    """Least-demand index over each row of ``cand_links`` (n, m) with a
    random-rotation tiebreak so zero-demand ties spread instead of piling
    on index 0. ``torch.argmin`` takes the first least cost, as
    ``jnp.argmin`` does."""
    m = T.m
    rot = (torch.arange(m, device=cand_links.device)[None, :]
           + rand[:, None]) % m  # (n, m)
    links = torch.gather(cand_links, 1, rot)
    cost = link_demand[links + off[:, None]] / T.link_bw[links]
    return torch.gather(rot, 1, torch.argmin(cost, dim=1, keepdim=True))[:, 0]


def fat_tree_routes(
    T: FatTreeArrays,
    src_nodes: torch.Tensor,
    dst_nodes: torch.Tensor,
    rand: torch.Tensor,
    link_demand: torch.Tensor,
    adaptive: bool,
    demand_offsets: torch.Tensor = None,
):
    """Returns (routes (n, 6) int32, n_hops (n,) int32) — same contract as
    :func:`repro_torch.netsim.routing.compute_routes`. Index arithmetic
    runs in int64 on non-negative values, so ``//`` and ``%`` agree with
    the reference's int32 ops."""
    s = src_nodes.long()
    d = dst_nodes.long()
    r = rand.long()
    off = (torch.zeros_like(s) if demand_offsets is None
           else demand_offsets.long())
    e_s = s // T.h
    e_d = d // T.h
    pod_s = e_s // T.m
    pod_d = e_d // T.m
    i_d = e_d % T.m
    ti = s
    to = T.n_nodes + d
    if adaptive:
        j = _spray(T, T.up1[e_s], link_demand, off, r % T.m)
        a_src = pod_s * T.m + j
        i = _spray(T, T.up2[a_src], link_demand, off, (r // T.m) % T.m)
    else:
        j = d % T.m  # D-mod-k: destination picks agg then core
        i = (d // T.m) % T.m
        a_src = pod_s * T.m + j
    u1 = T.up1[e_s, j]
    u2 = T.up2[a_src, i]
    core = j * T.m + i
    d1 = T.down1[core, pod_d]
    d2 = T.down2[pod_d * T.m + j, i_d]
    d2_same_pod = T.down2[a_src, i_d]
    same_edge = e_s == e_d
    same_pod = (pod_s == pod_d) & ~same_edge
    neg = torch.full_like(ti, -1)
    routes = torch.stack([
        ti,
        torch.where(same_edge, neg, u1),
        torch.where(same_edge | same_pod, neg, u2),
        torch.where(same_edge | same_pod, neg, d1),
        torch.where(same_edge, neg,
                    torch.where(same_pod, d2_same_pod, d2)),
        to,
    ], dim=1)
    n_hops = (routes >= 0).sum(dim=1)
    return routes.to(torch.int32), n_hops.to(torch.int32)


# ---- scale configurations ----

def fat_tree_small(net: Optional[NetConfig] = None) -> FatTree:
    # k=12 with 7 hosts/edge: 12 pods x 6 edges x 7 = 504 nodes (the
    # dragonfly-small host count, so every small-scale mix fits), 180
    # switches, 36 cores
    return build_fat_tree(12, hosts_per_edge=7, net=net)


def fat_tree_paper(net: Optional[NetConfig] = None) -> FatTree:
    # canonical k=32: 8192 hosts, 1280 switches (the datacenter-scale
    # analogue of the paper's 8448-node dragonflies)
    return build_fat_tree(32, net=net)
