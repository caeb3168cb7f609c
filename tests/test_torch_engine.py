"""The port's engine against the JAX package's, on the CPU.

* Both engine goldens (``tests/data_engine_golden.json``: ``equiv-mix``
  seed 3, ``equiv-coll`` seed 5, the scenarios of
  ``tests/test_engine_equivalence.py``) run through
  ``repro_torch.union.manager`` under the same contract: the integer
  trajectory exact, float sums to rtol 1e-5. The report golden too.
* Lockstep: the JAX engine's initial state of ``equiv-mix`` is carried
  into the port (``state_io``); then both engines tick, the JAX one under
  ``jax.jit``, and every leaf is compared after every tick (integers
  exact, floats to rtol 1e-5), so a divergence names its tick and leaf.
* ``run`` gives the same state whatever its ``chunk``.
* The port's ``member_report`` equals the JAX package's.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.union import manager as REF_MGR
from repro_torch.netsim.engine import job_vm
from repro_torch.netsim.state_io import state_from_numpy, state_to_numpy
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario
from repro_torch.union.seeds import engine_seed
from test_engine_equivalence import CASES

GOLDEN = os.path.join(os.path.dirname(__file__), "data_engine_golden.json")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_scenario(case):
    make, seed = CASES[case]
    return Scenario.from_dict(make().to_dict()), seed


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _run_port(case, chunk=64):
    sc, seed = port_scenario(case)
    rs = MGR.resolve(sc, seed=seed)
    init, run, _ = MGR.build(rs, device="cpu")
    return run(init(seed=engine_seed(seed)), chunk=chunk), rs


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_engine_goldens(case, golden):
    st, rs = _run_port(case)
    st = state_to_numpy(st)
    g = golden[case]["state"]
    m = st.metrics
    assert float(st.t) == g["t"]
    assert int(st.rng) == g["rng"]
    assert int(st.pool.dropped) == g["dropped"]
    assert int(st.pool.free_top) == g["free_top"]
    assert int(m.win_idx) == g["win_idx"]
    np.testing.assert_array_equal(m.lat_cnt, g["lat_cnt"])
    np.testing.assert_array_equal(m.lat_hist.sum(1), g["lat_hist_sum"])
    np.testing.assert_allclose(float(m.peak_inject), g["peak_inject"],
                               rtol=1e-6)
    np.testing.assert_allclose(m.lat_sum, g["lat_sum"], rtol=1e-5)
    np.testing.assert_allclose(m.lat_min, g["lat_min"], rtol=1e-5)
    np.testing.assert_allclose(m.lat_max, g["lat_max"], rtol=1e-5)
    np.testing.assert_allclose(float(m.link_bytes.sum()),
                               g["link_bytes_total"], rtol=1e-5)
    np.testing.assert_allclose(m.router_wins.sum(axis=(0, 2)),
                               g["router_wins_total"], rtol=1e-5)
    for ji in range(len(rs.jobs)):
        vm = job_vm(st, ji)
        assert bool(vm.done.all()) == g[f"vm{ji}_done"]
        np.testing.assert_array_equal(vm.send_done, g[f"vm{ji}_send_done"])
        np.testing.assert_array_equal(vm.recv_done, g[f"vm{ji}_recv_done"])
        np.testing.assert_array_equal(vm.pc, g[f"vm{ji}_pc"])
        np.testing.assert_allclose(vm.comm_time, g[f"vm{ji}_comm_time"],
                                   rtol=1e-5)
    if st.ur is not None:
        np.testing.assert_array_equal(st.ur.count, g["ur_count"])


def test_port_report_matches_report_golden(golden):
    sc, seed = port_scenario("equiv-mix")
    with pytest.warns(DeprecationWarning, match="run_scenario"):
        rep = MGR.run_scenario(sc, seed=seed, device="cpu")
    g = golden["equiv-mix"]
    assert rep["virtual_time_ms"] == g["report_virtual_time_ms"]
    for app, want in g["report_latency"].items():
        got = rep["latency"][app]
        assert got["count"] == want["count"]
        if want["count"]:
            np.testing.assert_allclose(got["avg_us"], want["avg_us"], rtol=1e-5)
            np.testing.assert_allclose(got["max_us"], want["max_us"], rtol=1e-5)


def _leaves(tree, prefix=""):
    """(path, numpy leaf) pairs of a state tree, by field name."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _leaves(getattr(tree, name), f"{prefix}{name}.")
        return out
    return [(prefix[:-1], np.asarray(tree))]


def _first_mismatch(port, ref):
    got = dict(_leaves(state_to_numpy(port)))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref)))
    if set(got) != set(want):
        return f"leaf names differ: {sorted(set(got) ^ set(want))}"
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            return f"{name}: shape {g.shape} != {w.shape}"
        if np.issubdtype(w.dtype, np.floating):
            ok = np.allclose(g, w, rtol=1e-5, atol=0.0, equal_nan=False)
        else:
            ok = np.array_equal(g.astype(np.int64), w.astype(np.int64))
        if not ok:
            return f"{name} differs"
    return None


@pytest.fixture(scope="module")
def lockstep():
    """Tick both engines from one initial state of ``equiv-mix`` until the
    JAX one stops; record the first (tick, leaf) that differs."""
    make, seed = CASES["equiv-mix"]
    ref_sc = make()
    ref_rs = REF_MGR.resolve(ref_sc, seed=seed)
    ref_eng = REF_MGR.build(ref_rs)
    ref_tick = jax.jit(ref_eng.tick)
    ref_st = ref_eng.init_state(seed=engine_seed(seed))

    sc, _ = port_scenario("equiv-mix")
    rs = MGR.resolve(sc, seed=seed)
    eng = MGR.build(rs, device="cpu")
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, ref_st), "cpu")

    mismatch = _first_mismatch(st, ref_st)
    ticks = 0
    horizon = ref_rs.horizon_us
    while mismatch is None:
        t = float(ref_st.t)
        all_done = bool(np.asarray(ref_st.vms.done).all()) and not bool(
            np.asarray(ref_st.pool.active).any())
        if not (t < horizon and not all_done):
            break
        ref_st = ref_tick(ref_st)
        st = eng.tick(st)
        ticks += 1
        mismatch = _first_mismatch(st, ref_st)
        if mismatch is not None:
            mismatch = f"tick {ticks}: {mismatch}"
    return dict(mismatch=mismatch, ticks=ticks, ref=ref_st, ref_rs=ref_rs,
                port=st, rs=rs, seed=seed)


def test_lockstep_every_leaf_every_tick(lockstep):
    assert lockstep["mismatch"] is None, lockstep["mismatch"]
    assert lockstep["ticks"] > 100  # the whole run, not a prefix


def _assert_reports_equal(got, want, path="report"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_reports_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_reports_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str, type(None))) or isinstance(
            want, (int, np.integer)):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=path)


def test_member_report_matches_reference(lockstep):
    seed = lockstep["seed"]
    want = REF_MGR.member_report(lockstep["ref"], lockstep["ref_rs"], 0.0,
                                 seed=seed)
    got = MGR.member_report(lockstep["port"], lockstep["rs"], 0.0, seed=seed)
    _assert_reports_equal(got, want)


def test_run_chunk_does_not_change_the_result():
    a, _ = _run_port("equiv-coll", chunk=1)
    b, _ = _run_port("equiv-coll", chunk=64)
    la, lb = _leaves(state_to_numpy(a)), _leaves(state_to_numpy(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_state_io_round_trip():
    make, seed = CASES["equiv-coll"]
    ref_rs = REF_MGR.resolve(make(), seed=seed)
    ref_st = REF_MGR.build(ref_rs).init_state(seed=engine_seed(seed))
    tree = jax.tree_util.tree_map(np.asarray, ref_st)
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    want = dict(_leaves(tree))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
