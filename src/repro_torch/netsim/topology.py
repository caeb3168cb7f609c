"""Back-compat shim — the topology layer moved to :mod:`repro_torch.netsim.fabric`.

The dragonfly builders (and the KIND constants the historical callers
import from here) live in :mod:`repro_torch.netsim.fabric.dragonfly`;
:func:`get_topology` resolves through the full fabric registry, so
every spec-level fabric name ("1d", "2d", "fat_tree", "torus") works
through the historical entry point.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.fabric import BUILDERS, get_fabric
from repro_torch.netsim.fabric.base import Fabric
from repro_torch.netsim.fabric.dragonfly import (
    KIND_GLOBAL,
    KIND_LOCAL,
    KIND_TERM_IN,
    KIND_TERM_OUT,
    Dragonfly,
    build_dragonfly,
    dragonfly_1d_paper,
    dragonfly_1d_small,
    dragonfly_2d_paper,
    dragonfly_2d_small,
)

__all__ = [
    "KIND_TERM_IN", "KIND_TERM_OUT", "KIND_LOCAL", "KIND_GLOBAL",
    "Dragonfly", "Fabric", "build_dragonfly",
    "dragonfly_1d_paper", "dragonfly_1d_small",
    "dragonfly_2d_paper", "dragonfly_2d_small",
    "BUILDERS", "get_topology",
]


def get_topology(variant: str, scale: str,
                 net: Optional[NetConfig] = None) -> Fabric:
    return get_fabric(variant, scale, net)
