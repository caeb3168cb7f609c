"""The runtime fault mask the engine reads on every tick.

Only the resolved mask is ported so far: :class:`FaultState` holds
per-link bandwidth factors and per-router health factors as ordinary
``SimState`` leaves, and :func:`healthy_state` gives the all-ones mask.
The engine computes the effective per-link factor each tick::

    eff[l] = link_bw_factor[l] * router_factor[src[l]] * router_factor[dst[l]]

Healthy factors are exact 1.0 multiplies and exact +0.0 demand adds, so
healthy runs are bit-identical to a fault-free engine. Fault events and
timelines (the JAX package's ``FaultEvent``/``FailureSpec``) are not
ported yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


class FaultState(NamedTuple):
    """Resolved runtime fault mask for one member (host or device arrays).

    ``link_bw_factor``: ``(L,)`` float32, multiplies each link's healthy
    bandwidth. ``router_factor``: ``(R,)`` float32, multiplies into all
    links incident on the router. Batched states carry ``(B, L)`` /
    ``(B, R)`` leaves.
    """

    link_bw_factor: Any
    router_factor: Any


def healthy_state(topo) -> FaultState:
    """All-ones factors for ``topo`` (numpy; the engine casts on init)."""
    return FaultState(
        link_bw_factor=np.ones(len(topo.link_bw), np.float32),
        router_factor=np.ones(int(topo.n_routers), np.float32),
    )
