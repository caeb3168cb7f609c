"""Carry an engine state across: numpy trees in, numpy trees out.

The simulator's counterpart of loading carried weights. A state of the
JAX package's engine, handed over as nested NamedTuples (or dicts) of
numpy arrays — ``jax.tree_util.tree_map(np.asarray, state)`` makes one —
becomes a :class:`~repro_torch.netsim.engine.SimState` on a device, with
its job tables, fault leaves and, when present, its probe rings and
histograms; :func:`state_to_numpy` goes the other way. With these, both
engines can start from one state and be compared tick by tick. Leaves
are matched by field name.

The rng counter is a uint32 in the JAX package and an int64 tensor
holding the same value in the port.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.netsim.engine import (
    JobTable, Metrics, PoolState, SimState, URState, VMState,
)
from repro_torch.netsim.faults import FaultState
from repro_torch.obs.hist import HistState
from repro_torch.obs.probes import ProbeState

_NODES = {
    "vms": VMState, "ur": URState, "pool": PoolState, "metrics": Metrics,
    "jobs": JobTable, "faults": FaultState, "probes": ProbeState,
    "hist": HistState,
}


def _field(node: Any, name: str):
    if isinstance(node, dict):
        return node.get(name)
    return getattr(node, name, None)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a, order="C"), device=device)


def state_from_numpy(tree: Any, device) -> SimState:
    """A port state on ``device`` from a numpy tree of an engine state
    (member or batched)."""
    out = {}
    for name in SimState._fields:
        node = _field(tree, name)
        if node is None:
            out[name] = None
        elif name in _NODES:
            cls = _NODES[name]
            out[name] = cls(*[_to_tensor(_field(node, f), device)
                              for f in cls._fields])
        else:
            out[name] = _to_tensor(node, device)
    return SimState(**out)


def state_to_numpy(state: SimState) -> SimState:
    """The same state with numpy leaves (rng back to uint32)."""
    def host(x):
        return x.detach().cpu().numpy()

    out = {}
    for name in SimState._fields:
        node = getattr(state, name)
        if node is None:
            out[name] = None
        elif name in _NODES:
            out[name] = type(node)(*[host(x) for x in node])
        else:
            out[name] = host(node)
    out["rng"] = out["rng"].astype(np.uint32)
    return SimState(**out)
