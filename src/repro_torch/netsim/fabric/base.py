"""The ``Fabric`` protocol — what a network topology must provide so the
stacked engine, the placement policies, and the metrics pipeline can treat
"which network" as runtime data.

A fabric is a dense-array description of one interconnect instance:

* **Link tables** — ``links[0:N]`` are terminal-in (node -> router, link id
  == node id), ``links[N:2N]`` terminal-out (router -> node, id == N +
  node), then the fabric's inter-router links in builder order. Every
  fabric exposes ``link_kind`` / ``link_bw`` / ``link_dst_router`` /
  ``link_src_router`` over that table.
* **A routing function** — ``routing_tables()`` returns ``(T, route_fn)``
  where ``T`` is a fabric-specific NamedTuple of torch gather tables and
  ``route_fn(T, src_nodes, dst_nodes, rand, link_demand, adaptive,
  demand_offsets)`` produces the fixed-width per-message link-id hop
  sequences (``(n, route_width)`` int32, -1 padded) the engine's inject
  pass and the fused drain tick already consume. ``route_width`` is the
  fabric's declared maximum links per route (the pool's route-row width).
* **Placement units** — node ids are contiguous per hosting router and
  per placement group, so the RN/RR/RG policies generalize:
  ``place_routers`` routers own hosts (node = router*nodes_per_router + i)
  and ``place_groups`` contiguous groups of ``nodes_per_group`` nodes
  each (dragonfly groups, fat-tree pods, torus planes).
* **Link levels** — ``link_levels()`` names the fabric's hierarchy levels
  (dragonfly local/global, fat-tree up/down, torus x/y/z) as boolean
  masks over the link table; the metrics pipeline summarizes load and
  utilization per level instead of hardwiring dragonfly KIND constants.
* **Identity** — ``cache_key()`` is the hashable tuple of defining
  parameters (family name first). The engine cache keys on it, so two
  fabrics with identical capacity envelopes never share a compiled
  engine.

Implementations: :mod:`repro_torch.netsim.fabric.dragonfly` (the paper's two
systems), :mod:`repro_torch.netsim.fabric.fat_tree` (k-ary Clos),
:mod:`repro_torch.netsim.fabric.torus` (3D torus). The registry in
:mod:`repro_torch.netsim.fabric` maps spec names ("1d", "2d", "fat_tree",
"torus") x scale ("small", "paper") to builders.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np

# shared link-kind constants for the terminal rows (every fabric's first
# 2N links); inter-router kinds are fabric-private.
KIND_TERM_IN, KIND_TERM_OUT = 0, 1


@runtime_checkable
class Fabric(Protocol):
    """Structural interface every network fabric implements."""

    # sizes
    n_nodes: int
    n_routers: int
    n_links: int
    # dense link table (numpy, length n_links)
    link_kind: np.ndarray
    link_bw: np.ndarray
    link_dst_router: np.ndarray
    link_src_router: np.ndarray

    @property
    def family(self) -> str:  # "dragonfly" | "fat_tree" | "torus" | ...
        ...

    @property
    def route_width(self) -> int:
        """Maximum links per route (the engine's pool route-row width)."""
        ...

    # placement units (node ids contiguous within each)
    @property
    def place_routers(self) -> int:
        """Routers that own hosts; node = router * nodes_per_router + i."""
        ...

    @property
    def nodes_per_router(self) -> int:
        ...

    @property
    def place_groups(self) -> int:
        """Contiguous placement groups (dragonfly group / pod / plane)."""
        ...

    @property
    def nodes_per_group(self) -> int:
        ...

    def cache_key(self) -> Tuple:
        """Hashable defining parameters, family name first — the engine
        cache's fabric identity (arrays are derived, never keyed)."""
        ...

    def link_levels(self) -> Dict[str, np.ndarray]:
        """Ordered {level name -> bool mask over links} for the fabric's
        hierarchy levels (terminal links excluded)."""
        ...

    def routing_tables(self, device) -> Tuple[object, Callable]:
        """``(T, route_fn)``: torch gather tables on ``device`` + the
        batched router.

        ``route_fn(T, src_nodes, dst_nodes, rand, link_demand, adaptive,
        demand_offsets=None) -> (routes (n, route_width) int32, n_hops)``.
        """
        ...


def terminal_link_rows(n_nodes: int, nodes_per_router: int, terminal_bw: float):
    """The shared first-2N link rows: ``kinds, bws, dsts, srcs`` lists with
    terminal-in then terminal-out links (link id == node id / N + node)."""
    kinds, bws, dsts, srcs = [], [], [], []
    for n in range(n_nodes):
        kinds.append(KIND_TERM_IN)
        bws.append(terminal_bw)
        dsts.append(n // nodes_per_router)
        srcs.append(n // nodes_per_router)
    for n in range(n_nodes):
        kinds.append(KIND_TERM_OUT)
        bws.append(terminal_bw)
        dsts.append(n // nodes_per_router)
        srcs.append(n // nodes_per_router)
    return kinds, bws, dsts, srcs
