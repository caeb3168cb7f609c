"""Shared helpers of the port's CPU parity tests (not a test module).

States of the two engines are compared leaf by leaf, by field name:
integers (and booleans) exactly, floats to rtol 1e-5 with infinities
and NaNs in the same places — the contract of
``tests/test_engine_equivalence.py:98-135`` extended to every leaf.
Imports JAX only to read a JAX state (``ref_leaves``), so the card tests
use it on a machine without JAX.
"""
import numpy as np
import torch

from repro_torch.netsim.state_io import state_to_numpy

RTOL = 1e-5


def leaves(tree, prefix=""):
    """(path, numpy leaf) pairs of a state tree, by field name."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += leaves(getattr(tree, name), f"{prefix}{name}.")
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return [(prefix[:-1], np.asarray(tree))]


def port_leaves(state):
    return dict(leaves(state_to_numpy(state)))


def ref_leaves(state):
    import jax

    return dict(leaves(jax.tree_util.tree_map(np.asarray, state)))


def mismatches(got, want, only=None):
    """Names of the leaves of ``got`` that differ from ``want`` (dicts of
    numpy leaves) under the contract; ``only`` limits the names."""
    if set(got) != set(want):
        return [f"leaf names differ: {sorted(set(got) ^ set(want))}"]
    bad = []
    for name in sorted(want):
        if only is not None and name not in only:
            continue
        g, w = got[name], want[name]
        if g.shape != w.shape:
            bad.append(f"{name}: shape {g.shape} != {w.shape}")
        elif np.issubdtype(w.dtype, np.floating):
            if not np.allclose(g, w, rtol=RTOL, atol=0.0, equal_nan=True):
                bad.append(f"{name} differs")
        elif not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
            bad.append(f"{name} differs")
    return bad


def assert_port_states_close(a, b, only=None):
    """Two port states under the contract (integers exact, floats to
    rtol 1e-5): float sums taken by atomics on the card differ in their
    last bits from run to run."""
    bad = mismatches(port_leaves(a), port_leaves(b), only)
    assert not bad, bad


def assert_port_equals_ref(port_state, ref_state, only=None):
    bad = mismatches(port_leaves(port_state), ref_leaves(ref_state), only)
    assert not bad, bad


def assert_bitwise_equal(a, b):
    """Two port states with every leaf bit for bit equal."""
    la, lb = port_leaves(a), port_leaves(b)
    assert set(la) == set(lb)
    for name in sorted(la):
        x, y = la[name], lb[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
