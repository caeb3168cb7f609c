"""The port's in-engine observers (probes, histograms) against the JAX package.

* The ``equiv-mix`` golden scenario (``tests/test_engine_equivalence.py``)
  with ``HistConfig()`` and ``ProbeConfig(samples=16, every=4)`` (a ring
  that wraps) compiled into both engines,
  run to its end: histogram counts and maxima exact, sums and sums of
  squares to rtol 1e-5; the probe rings' ``t``, ``queue_depth``,
  ``pool_occ``, ``tick`` and ``idx`` exact, ``link_util`` and
  ``inflight_lat`` to rtol 1e-5; every other leaf under the engine
  contract; the reports (``member_report`` with its probe timelines)
  equal.
* The observed engine's unobserved leaves equal the plain engine's, bit
  for bit.
* ``ring_order``, ``merge_hist``, ``hist_summary``, ``probe_timelines``
  and ``bucket_of`` against the reference on the same arrays; the config
  validation errors; the probes refuse TF32 products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as REF_OBS
from repro.union import manager as REF_MGR
from repro_torch import obs as OBS
from repro_torch.netsim.state_io import state_from_numpy, state_to_numpy
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario
from repro_torch.union.seeds import engine_seed
from test_engine_equivalence import CASES
from torch_parity import (
    assert_bitwise_equal, mismatches, port_leaves, ref_leaves)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROBES = dict(samples=16, every=4)


@pytest.fixture(scope="module")
def observed():
    make, seed = CASES["equiv-mix"]
    ref_rs = REF_MGR.resolve(make(), seed=seed)
    ref_eng = REF_MGR.build(ref_rs, probes=REF_OBS.ProbeConfig(**PROBES),
                            hist=REF_OBS.HistConfig())
    ref = jax.block_until_ready(
        ref_eng.run(ref_eng.init_state(seed=engine_seed(seed))))

    rs = MGR.resolve(Scenario.from_dict(make().to_dict()), seed=seed)
    eng = MGR.build(rs, device="cpu", probes=OBS.ProbeConfig(**PROBES),
                    hist=OBS.HistConfig())
    port = eng.run(eng.init_state(seed=engine_seed(seed)))
    plain = MGR.build(rs, device="cpu")
    return dict(ref=ref, ref_rs=ref_rs, port=port, rs=rs, seed=seed,
                plain=plain.run(plain.init_state(seed=engine_seed(seed))))


EXACT = ("hist.counts", "hist.max", "hist.edges", "probes.t",
         "probes.queue_depth", "probes.pool_occ", "probes.tick", "probes.idx")


def test_observed_run_matches_reference(observed):
    got, want = port_leaves(observed["port"]), ref_leaves(observed["ref"])
    assert not mismatches(got, want)
    for name in EXACT:
        assert got[name].tobytes() == want[name].astype(
            got[name].dtype).tobytes(), name
    # the run delivered, sampled and wrapped its ring
    assert int(got["probes.idx"]) > PROBES["samples"]
    counts = got["hist.counts"]
    np.testing.assert_array_equal(counts.sum(axis=(1, 2)),
                                  got["metrics.lat_cnt"])
    assert (counts.sum(axis=(0, 2)) > 0).sum() >= 2  # two levels crossed


def test_observed_report_matches_reference(observed):
    seed = observed["seed"]
    want = REF_MGR.member_report(observed["ref"], observed["ref_rs"], 0.0,
                                 seed=seed)
    got = MGR.member_report(observed["port"], observed["rs"], 0.0, seed=seed)
    assert "probes" in got and got["probes"]["wrapped"]
    _assert_reports_equal(got, want)


def test_observers_leave_the_plain_leaves_alone(observed):
    port = state_to_numpy(observed["port"])._replace(probes=None, hist=None)
    plain = state_to_numpy(observed["plain"])
    a = state_from_numpy(port, "cpu")
    b = state_from_numpy(plain, "cpu")
    assert_bitwise_equal(a, b)


def test_state_io_carries_observers(observed):
    tree = jax.tree_util.tree_map(np.asarray, observed["ref"])
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    want = ref_leaves(observed["ref"])
    got = port_leaves(state_from_numpy(tree, "cpu"))
    assert {n for n in want if n.startswith(("probes.", "hist."))} \
        <= set(got)
    assert back.probes.idx.dtype == np.int32
    assert not mismatches(got, want)


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


# ---------------------------------------------------------------------------
# host-side helpers on the same arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx,K", [(0, 4), (3, 4), (4, 4), (9, 4), (64, 64),
                                   (130, 64)])
def test_ring_order_matches_reference(idx, K):
    np.testing.assert_array_equal(OBS.ring_order(idx, K),
                                  REF_OBS.ring_order(idx, K))


def _rand_hist(rng, A=3, NL=2, K=8):
    return dict(counts=rng.integers(0, 50, (A, NL, K)).astype(np.int32),
                sum=(rng.random(A) * 1e4).astype(np.float32),
                sumsq=(rng.random(A) * 1e7).astype(np.float32),
                max=(rng.random(A) * 500).astype(np.float32),
                edges=(0.5 * 1.25 ** np.arange(K + 1)).astype(np.float32))


def test_merge_hist_and_summary_match_reference():
    rng = np.random.default_rng(0)
    a, b = _rand_hist(rng), _rand_hist(rng)
    a["counts"][1] = 0  # an app with no message
    b["counts"][1] = 0
    got = OBS.merge_hist(
        OBS.HistState(**{k: torch.as_tensor(v) for k, v in a.items()}),
        OBS.HistState(**{k: torch.as_tensor(v) for k, v in b.items()}))
    want = REF_OBS.merge_hist(
        REF_OBS.HistState(**{k: jnp.asarray(v) for k, v in a.items()}),
        REF_OBS.HistState(**{k: jnp.asarray(v) for k, v in b.items()}))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    names = ["a", None, "c"]
    assert OBS.hist_summary(got, names, ["local", "global"]) \
        == REF_OBS.hist_summary(want, names, ["local", "global"])
    assert OBS.hist_summary(got, names) == REF_OBS.hist_summary(want, names)


def test_probe_timelines_match_reference():
    rng = np.random.default_rng(1)
    K, NL, A = 6, 2, 3
    for idx in (4, 11):
        arrays = dict(
            t=rng.random(K).astype(np.float32),
            link_util=rng.random((K, NL)).astype(np.float32),
            inflight_lat=rng.random((K, A)).astype(np.float32),
            queue_depth=rng.integers(0, 9, (K, A)).astype(np.int32),
            pool_occ=rng.random(K).astype(np.float32),
            tick=np.int32(idx * 8), idx=np.int32(idx),
            last_level_bytes=rng.random(NL).astype(np.float32),
            last_t=np.float32(3.0))
        got = OBS.probe_timelines(
            OBS.ProbeState(**{k: torch.as_tensor(v)
                              for k, v in arrays.items()}),
            ["local", "global"], ["a", None, "ur"])
        want = REF_OBS.probe_timelines(
            REF_OBS.ProbeState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}),
            ["local", "global"], ["a", None, "ur"])
        assert got == want


def test_bucket_of_matches_reference():
    cfg = OBS.HistConfig()
    lat = np.concatenate([
        np.linspace(0.0, 300.0, 2001), 0.5 * 1.25 ** np.arange(64),
        [1e-12, 1e9]]).astype(np.float32)
    want = np.asarray(REF_OBS.bucket_of(jnp.asarray(lat),
                                        REF_OBS.HistConfig()))
    np.testing.assert_array_equal(OBS.bucket_of(torch.as_tensor(lat), cfg)
                                  .numpy(), want)
    np.testing.assert_array_equal(OBS.bucket_of(lat, cfg), want)


@pytest.mark.parametrize("cls,kw", [
    ("HistConfig", dict(bins=1)), ("HistConfig", dict(lo_us=0.0)),
    ("HistConfig", dict(ratio=1.0)), ("ProbeConfig", dict(samples=0)),
    ("ProbeConfig", dict(every=0))])
def test_config_validation_errors(cls, kw):
    with pytest.raises(ValueError) as got:
        getattr(OBS, cls)(**kw)
    with pytest.raises(ValueError) as want:
        getattr(REF_OBS, cls)(**kw)
    assert str(got.value) == str(want.value)


def test_probes_refuse_tf32_products():
    ps = OBS.init_probes(OBS.ProbeConfig(), 2, 2)
    batch = OBS.ProbeState(*[x[None] for x in ps])
    kw = dict(t_new=torch.ones(1), live_m=torch.ones(1, dtype=torch.bool),
              link_bytes=torch.ones(1, 5), pool_active=torch.zeros(
                  1, 4, dtype=torch.bool),
              pool_job=torch.zeros(1, 4, dtype=torch.int32),
              pool_inject_t=torch.zeros(1, 4),
              free_top=torch.full((1,), 4, dtype=torch.int32),
              level_mask=torch.ones(4, 2), level_bw=torch.ones(2), n_apps=2,
              pool_size=4)
    OBS.sample_probes(batch, OBS.ProbeConfig(every=1), **kw)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            OBS.sample_probes(batch, OBS.ProbeConfig(every=1), **kw)
    finally:
        torch.set_float32_matmul_precision(before)
