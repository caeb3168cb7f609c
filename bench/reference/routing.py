"""Batched route computation: minimal (MIN) and adaptive (ADP, UGAL-style);
a frozen copy of the port's `netsim/routing.py`.

Routes are fixed-width link-id sequences (MAX_LINKS, -1 padded), computed at
message injection — MIN picks a random minimal global channel (as CODES
does); ADP compares live link demand (bytes outstanding) on the minimal
path against a Valiant path through a random intermediate group and takes
the less congested one (non-minimal biased by 2×, the classic UGAL rule).

Slot layout (MAX_LINKS=10):
  [term_in, l1a, l1b, g1, l2a, l2b, g2, l3a, l3b, term_out]
(1D uses one local hop per leg; 2D up to two — row then column.)

Every function works on a whole batch of messages at once: the message
axis is the leading tensor dimension. Index arithmetic runs in int64 (the
gather index type); all indices are non-negative, so ``//`` and ``%``
agree with the reference's int32 ops. Gathers never see an out-of-range
index: the tables are clamped at build time exactly as the reference
clamps them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fabric import Dragonfly


class TopoArrays(NamedTuple):
    variant_2d: bool
    G: int
    a: int  # routers per group
    p: int  # nodes per router
    cols: int
    lpp: int
    n_links: int
    n_routers: int
    n_nodes: int
    local_link_id: torch.Tensor  # (R, a) int64
    global_gw: torch.Tensor  # (G, G, lpp) router ids
    global_link_id: torch.Tensor  # (G, G, lpp)
    link_dst_router: torch.Tensor  # (L,)
    link_bw: torch.Tensor  # (L,) f32
    link_kind: torch.Tensor  # (L,)


def topo_arrays(t: Dragonfly, device) -> TopoArrays:
    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return TopoArrays(
        variant_2d=(t.variant == "2d"),
        G=t.n_groups, a=t.routers_per_group, p=t.nodes_per_router,
        cols=t.cols or t.routers_per_group, lpp=t.links_per_pair,
        n_links=t.n_links, n_routers=t.n_routers, n_nodes=t.n_nodes,
        local_link_id=i64(t.local_link_id),
        global_gw=i64(np.maximum(t.global_gw, 0)),
        global_link_id=i64(np.maximum(t.global_link_id, 0)),
        link_dst_router=i64(t.link_dst_router),
        link_bw=torch.as_tensor(
            np.asarray(t.link_bw, np.float32), device=device),
        link_kind=i64(t.link_kind),
    )


def _local_leg(T: TopoArrays, r_from, r_to):
    """Intra-group leg r_from -> r_to: returns (link_a, link_b) (-1 unused)."""
    l_to = r_to % T.a
    direct = T.local_link_id[r_from, l_to]  # -1 if none (2D off-row/col)
    same = r_from == r_to
    neg = torch.full_like(direct, -1)
    if not T.variant_2d:
        return torch.where(same, neg, direct), neg
    # 2D: corner router = (row of from, col of to)
    row_f = (r_from % T.a) // T.cols
    col_t = l_to % T.cols
    corner_l = row_f * T.cols + col_t
    corner_r = (r_from // T.a) * T.a + corner_l
    la_corner = T.local_link_id[r_from, corner_l]
    lb_corner = T.local_link_id[corner_r, l_to]
    has_direct = direct >= 0
    la = torch.where(same, neg, torch.where(has_direct, direct, la_corner))
    lb = torch.where(same | has_direct, neg, lb_corner)
    return la, lb


def _min_route(T: TopoArrays, src_node, dst_node, rand):
    """Minimal routes; returns (n, MAX_LINKS) link ids."""
    r_s = src_node // T.p
    r_d = dst_node // T.p
    g_s = r_s // T.a
    g_d = r_d // T.a
    ti = src_node  # terminal-in link id
    to = T.n_nodes + dst_node  # terminal-out link id

    m = rand % T.lpp
    gw_r = T.global_gw[g_s, g_d, m]
    glink = T.global_link_id[g_s, g_d, m]
    r_b = T.link_dst_router[glink]

    l1a, l1b = _local_leg(T, r_s, gw_r)
    l2a, l2b = _local_leg(T, r_b, r_d)
    la, lb = _local_leg(T, r_s, r_d)  # same-group case

    same_group = g_s == g_d
    neg = torch.full_like(ti, -1)
    return torch.stack([
        ti,
        torch.where(same_group, la, l1a),
        torch.where(same_group, lb, l1b),
        torch.where(same_group, neg, glink),
        torch.where(same_group, neg, l2a),
        torch.where(same_group, neg, l2b),
        neg, neg, neg,
        to,
    ], dim=1)


def _val_route(T: TopoArrays, src_node, dst_node, g_i, rand):
    """Valiant routes via intermediate group g_i (assumed != g_s, g_d)."""
    r_s = src_node // T.p
    r_d = dst_node // T.p
    g_s = r_s // T.a
    g_d = r_d // T.a
    ti = src_node
    to = T.n_nodes + dst_node

    m1 = rand % T.lpp
    m2 = (rand // T.lpp) % T.lpp
    gw1 = T.global_gw[g_s, g_i, m1]
    gl1 = T.global_link_id[g_s, g_i, m1]
    r_mid = T.link_dst_router[gl1]
    gw2 = T.global_gw[g_i, g_d, m2]
    gl2 = T.global_link_id[g_i, g_d, m2]
    r_b = T.link_dst_router[gl2]

    l1a, l1b = _local_leg(T, r_s, gw1)
    l2a, l2b = _local_leg(T, r_mid, gw2)
    l3a, l3b = _local_leg(T, r_b, r_d)
    return torch.stack([ti, l1a, l1b, gl1, l2a, l2b, gl2, l3a, l3b, to], dim=1)


def route_cost(T, route, link_demand, offset):
    """Congestion estimate: total outstanding bytes over the route's links,
    normalized by bandwidth. ``offset`` shifts the demand gather so a
    member-batched caller can pass one flattened (B*(L+1),) demand table.

    The sum runs left to right over the route slots, in float32, as the
    reference's reduction over a route's slots does (XLA on the CPU folds
    a row in order; ``torch.sum`` would pair its terms). ``T`` is any
    fabric's tables with a ``link_bw``: the torus router costs its two
    candidate routes with it too.
    """
    valid = route >= 0
    idx = route.clamp(min=0)
    d = link_demand[idx + offset[:, None]] / T.link_bw[idx]
    d = torch.where(valid, d, torch.zeros_like(d))
    cost = torch.zeros_like(d[:, 0])
    for k in range(d.shape[1]):
        cost = cost + d[:, k]
    return cost


def compute_routes(
    T: TopoArrays,
    src_nodes: torch.Tensor,  # (n,)
    dst_nodes: torch.Tensor,
    rand: torch.Tensor,  # (n,) non-negative per-message randomness
    link_demand: torch.Tensor,  # (L,) f32 outstanding bytes per link (or a
    #                             flattened (B*(L+1),) batch, see offsets)
    adaptive: bool,
    demand_offsets: torch.Tensor = None,  # (n,) per-message row offset
):
    """Returns (routes (n, 10) int32, n_hops (n,) int32)."""
    src_nodes = src_nodes.long()
    dst_nodes = dst_nodes.long()
    rand = rand.long()
    if demand_offsets is None:
        demand_offsets = torch.zeros_like(src_nodes)
    demand_offsets = demand_offsets.long()
    min_r = _min_route(T, src_nodes, dst_nodes, rand)
    if adaptive:
        g_s = (src_nodes // T.p) // T.a
        g_d = (dst_nodes // T.p) // T.a
        # random intermediate group != g_s, g_d
        g_i = (rand // 7) % T.G
        g_i = torch.where(g_i == g_s, (g_i + 1) % T.G, g_i)
        g_i = torch.where(g_i == g_d, (g_i + 1) % T.G, g_i)
        g_i = torch.where(g_i == g_s, (g_i + 1) % T.G, g_i)  # re-check after bump
        val_r = _val_route(T, src_nodes, dst_nodes, g_i, rand)
        cost_min = route_cost(T, min_r, link_demand, demand_offsets)
        cost_val = route_cost(T, val_r, link_demand, demand_offsets)
        inter_group = g_s != g_d
        take_val = inter_group & (cost_min > 2.0 * cost_val + 1e-6)
        routes = torch.where(take_val[:, None], val_r, min_r)
    else:
        routes = min_r
    n_hops = (routes >= 0).sum(dim=1)
    return routes.to(torch.int32), n_hops.to(torch.int32)
