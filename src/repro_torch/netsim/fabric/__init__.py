"""``repro_torch.netsim.fabric`` — the port's fabric registry.

The registry maps a spec-level fabric name × scale to a builder:

=========  =======================  ==========================
name       small                    paper
=========  =======================  ==========================
``1d``     9g × 8r × 7n dragonfly   33g × 32r × 8n (Table II)
``2d``     7g × 12r × 6n dragonfly  22g × 96r × 4n (Table II)
``fat_tree``  k=12, 7 hosts/edge    k=32 (8192 hosts)
``torus``  4×4×4 × 8 nodes          11×12×16 × 4 nodes
=========  =======================  ==========================

``get_fabric(name, scale)`` builds one; ``fabric_names()`` is the legal
spec vocabulary (validation error messages list it); ``fabric_key(t)``
is the engine-cache identity. See :mod:`repro_torch.netsim.fabric.base`
for the protocol.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.fabric.base import Fabric, KIND_TERM_IN, KIND_TERM_OUT
from repro_torch.netsim.fabric.dragonfly import (
    Dragonfly,
    build_dragonfly,
    dragonfly_1d_paper,
    dragonfly_1d_small,
    dragonfly_2d_paper,
    dragonfly_2d_small,
)
from repro_torch.netsim.fabric.fat_tree import (
    FatTree,
    build_fat_tree,
    fat_tree_paper,
    fat_tree_small,
)
from repro_torch.netsim.fabric.torus import (
    Torus,
    build_torus,
    torus_paper,
    torus_small,
)

BUILDERS = {
    ("1d", "paper"): dragonfly_1d_paper,
    ("2d", "paper"): dragonfly_2d_paper,
    ("1d", "small"): dragonfly_1d_small,
    ("2d", "small"): dragonfly_2d_small,
    ("fat_tree", "paper"): fat_tree_paper,
    ("fat_tree", "small"): fat_tree_small,
    ("torus", "paper"): torus_paper,
    ("torus", "small"): torus_small,
}


def fabric_names() -> Tuple[str, ...]:
    """The legal spec-level fabric names, in registry order."""
    out = []
    for name, _scale in BUILDERS:
        if name not in out:
            out.append(name)
    return tuple(out)


def scale_names() -> Tuple[str, ...]:
    out = []
    for _name, scale in BUILDERS:
        if scale not in out:
            out.append(scale)
    return tuple(out)


def get_fabric(name: str, scale: str = "small",
               net: Optional[NetConfig] = None) -> Fabric:
    """Build the registered fabric ``name`` at ``scale``."""
    try:
        builder = BUILDERS[(name, scale)]
    except KeyError:
        raise ValueError(
            f"unknown fabric {name!r} at scale {scale!r}; valid fabrics: "
            f"{sorted(fabric_names())}, scales: {sorted(scale_names())}"
        ) from None
    return builder(net)


def fabric_key(topo: Fabric) -> Tuple:
    """The fabric's engine-cache identity (family name + defining
    parameters). Two fabrics never share a key, so engines compiled for
    identical capacity envelopes on different fabrics never collide."""
    return topo.cache_key()


def routing_tables(topo: Fabric, device):
    """``(T, route_fn)`` — the fabric's gather tables on ``device`` and its
    batched router, the engine's one dispatch point."""
    return topo.routing_tables(device)


__all__ = [
    "Fabric", "KIND_TERM_IN", "KIND_TERM_OUT",
    "Dragonfly", "build_dragonfly", "dragonfly_1d_paper",
    "dragonfly_1d_small", "dragonfly_2d_paper", "dragonfly_2d_small",
    "FatTree", "build_fat_tree", "fat_tree_paper", "fat_tree_small",
    "Torus", "build_torus", "torus_paper", "torus_small",
    "BUILDERS", "fabric_names", "scale_names", "get_fabric", "fabric_key",
    "routing_tables",
]
