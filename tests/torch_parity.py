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


# report fields the experiment golden (tests/test_experiment.py) pins
# with ``==``: compared exactly between the packages; other floats of a
# report to rtol 1e-5, NaN equal to NaN
EXACT_REPORT_FLOATS = frozenset((
    "virtual_time_ms", "avg_us", "max_us", "max_ms", "avg_ms",
    "makespan_ms", "utilization", "start_us", "finish_us",
    "avg_latency_us"))
# host wall-clock fields: they differ from run to run
HOST_TIME_KEYS = frozenset(("sim_wall_s", "wall_s", "jobs_per_sec"))


def report_mismatches(got, want, path="report", exact=False):
    """Paths where a port report (a JSON-like tree) differs from a JAX
    one: keys, lengths, integers, strings and booleans exactly; floats
    exactly under an ``EXACT_REPORT_FLOATS`` key, else to rtol 1e-5;
    host-time keys skipped."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return [f"{path}: {type(got).__name__} != dict"]
        keys = set(want) - HOST_TIME_KEYS
        if set(got) - HOST_TIME_KEYS != keys:
            return [f"{path}: keys differ: "
                    f"{sorted((set(got) - HOST_TIME_KEYS) ^ keys)}"]
        return [m for k in sorted(keys, key=str) for m in report_mismatches(
            got[k], want[k], f"{path}.{k}",
            exact or k in EXACT_REPORT_FLOATS)]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [f"{path}: lengths differ"]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in report_mismatches(g, w, f"{path}[{i}]", exact)]
    if isinstance(want, float) and not isinstance(got, bool) \
            and isinstance(got, (int, float)):
        g, w = float(got), float(want)
        if (g == w or (np.isnan(g) and np.isnan(w))
                or (not exact and np.isclose(g, w, rtol=RTOL, atol=0.0))):
            return []
        return [f"{path}: {g!r} != {w!r}"]
    if type(got) is not type(want) or got != want:
        return [f"{path}: {got!r} != {want!r}"]
    return []


def assert_cells_match(got_cells, want_cells):
    """Port CellResults against JAX ones: the same order and grid
    coordinates, and reports under :func:`report_mismatches`."""
    assert [c.key for c in got_cells] == [c.key for c in want_cells]
    for g, w in zip(got_cells, want_cells):
        gd, wd = g.to_dict(), w.to_dict()
        gr, wr = gd.pop("report"), wd.pop("report")
        assert gd == wd
        bad = report_mismatches(gr, wr, f"cell {g.key}")
        assert not bad, bad[:10]


def jax_serve(step, jparams, jcfg, prompts, slots, gen_len, frontend=None,
              encode=None):
    """The JAX package's serve loop (``repro/launch/serve.py``) on given
    weights and prompts, through ``step`` (a jitted ``decode_step``):
    each request's generated tokens. With ``frontend`` (an encoder-
    decoder's per-request frames) and ``encode`` (a jitted function of
    (params, frames) to the reference's cross K/V), each wave's decode
    state gets its slots' cross K/V, idle slots zero frames, which the
    reference's loop leaves out."""
    import jax.numpy as jnp
    from repro.models import model as JMDL

    n_req, plen = prompts.shape
    queue = list(range(n_req))
    outputs = {}
    while queue:
        slot_req = [queue.pop(0) if queue else -1 for _ in range(slots)]
        state = JMDL.init_decode_state(jcfg, slots, plen + gen_len,
                                       dtype=jnp.float32)
        if frontend is not None:
            frames = np.zeros((slots,) + frontend.shape[1:], np.float32)
            for s, r in enumerate(slot_req):
                if r >= 0:
                    frames[s] = frontend[r]
            state["xkv"] = encode(jparams, jnp.asarray(frames))
        tok = jnp.zeros((slots,), jnp.int32)
        for r in slot_req:
            if r >= 0:
                outputs[r] = []
        for t in range(plen + gen_len):
            feed = [0 if r < 0 else int(prompts[r, t]) if t < plen
                    else int(tok[s]) for s, r in enumerate(slot_req)]
            tok, state = step(jparams, state, jnp.asarray(feed, jnp.int32))
            if t >= plen:
                for s, r in enumerate(slot_req):
                    if r >= 0:
                        outputs[r].append(int(tok[s]))
    return outputs


def jax_params(model, dtype=None):
    """A port model's parameters as the JAX package's ``init_model`` tree
    (each layer leaf stacked), as JAX arrays in each parameter's dtype (or
    ``dtype``); bfloat16 values convert exactly."""
    import jax
    import jax.numpy as jnp
    from repro_torch.models.convert import jax_tree

    def arr(t):
        dt = dtype or str(t.dtype).split(".")[1]
        return jnp.asarray(t.detach().float().numpy(), dtype=jnp.dtype(dt))

    return jax.tree_util.tree_map(arr, jax_tree(dict(model.named_parameters())))
