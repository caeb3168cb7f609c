"""Job placement policies (paper §IV-C): RN / RR / RG — fabric-generic.

* Random Nodes (RN): nodes drawn randomly from the whole system — nodes on
  one router tend to serve different jobs.
* Random Routers (RR): a random selection of hosting routers (dragonfly
  routers, fat-tree edge/ToR switches, torus routers); the nodes of each
  chosen router are assigned consecutively.
* Random Groups (RG): a random selection of placement groups (dragonfly
  groups, fat-tree **pods** — pod-aware placement — or torus z-planes —
  contiguous block placement); nodes within the chosen groups assigned
  consecutively.

Every fabric exposes its placement units through the
:class:`~repro_torch.netsim.fabric.base.Fabric` protocol (``place_routers`` /
``nodes_per_router`` / ``place_groups`` / ``nodes_per_group``, node ids
contiguous within each), so the three policies — and their RNG draw
streams — are identical across fabrics. On a dragonfly the draws are
bit-identical to the historical dragonfly-only implementation.

**Incremental placement** (the online-scheduler path): an ``occupied``
node mask restricts every policy to the free nodes while preserving the
policy's structure — RR/RG still hand out each chosen router's/group's
*free* nodes consecutively. With ``occupied=None`` the draw is
bit-identical to the historical whole-system behaviour (the mask filters
the same permutation, consuming the same RNG stream).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.netsim.fabric import Fabric


def place_jobs(
    topo: Fabric,
    job_sizes: Sequence[int],
    policy: str,
    seed: int = 0,
    occupied: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Assign each job a disjoint set of free nodes under ``policy``.

    ``occupied`` is an optional ``(n_nodes,)`` bool mask of nodes already
    held by running jobs (``engine.occupied_node_mask``); they are never
    assigned. Raises ``ValueError`` when the jobs outsize the free nodes
    and ``RuntimeError`` if a policy would ever assign a node twice or
    hand out an occupied node (the historical silent-overlap hazard: a
    short tail slice quietly returned fewer nodes than ranks).
    """
    rng = np.random.default_rng(seed)
    total = sum(job_sizes)
    if occupied is None:
        occ = np.zeros((topo.n_nodes,), bool)
    else:
        occ = np.asarray(occupied, bool)
        if occ.shape != (topo.n_nodes,):
            raise ValueError(
                f"occupied mask shape {occ.shape} != ({topo.n_nodes},)"
            )
    n_free = int(topo.n_nodes - occ.sum())
    if total > n_free:
        raise ValueError(
            f"jobs need {total} nodes, system has {n_free} free "
            f"(of {topo.n_nodes})"
        )
    p = topo.nodes_per_router

    if policy == "RN":
        order = rng.permutation(topo.n_nodes)
    elif policy == "RR":
        routers = rng.permutation(topo.place_routers)
        order = (routers[:, None] * p + np.arange(p)[None, :]).reshape(-1)
    elif policy == "RG":
        groups = rng.permutation(topo.place_groups)
        nodes_per_group = topo.nodes_per_group
        order = (
            groups[:, None] * nodes_per_group + np.arange(nodes_per_group)[None, :]
        ).reshape(-1)
    else:
        raise ValueError(f"unknown placement policy {policy!r}")

    order = order[~occ[order]]  # free nodes only, policy order preserved

    out, off = [], 0
    for s in job_sizes:
        nodes = np.asarray(order[off : off + s], np.int64)
        if nodes.shape[0] != s:
            raise RuntimeError(
                f"placement {policy} produced {nodes.shape[0]} nodes for a "
                f"{s}-rank job (order exhausted)"
            )
        out.append(nodes)
        off += s

    flat = np.concatenate(out) if out else np.zeros((0,), np.int64)
    if flat.size != np.unique(flat).size:
        raise RuntimeError(
            f"placement {policy} assigned a node to two jobs "
            f"(sizes={list(job_sizes)}, seed={seed})"
        )
    if occ[flat].any():
        raise RuntimeError(
            f"placement {policy} assigned an occupied node (seed={seed})"
        )
    return out
