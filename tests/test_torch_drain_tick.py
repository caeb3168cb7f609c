"""The port's drain tick against the JAX package's reference.

``repro_torch.kernels.drain_tick.drain_tick_plain`` must repeat
``repro.kernels.ref.drain_tick_ref`` with the same float operations:
new_rem, rate and delivered bit for bit; the two byte-delta tables to
rtol 1e-6 (scatter-add order). Inputs are made with numpy from a seed and
handed to both. The CUDA kernel is held against the plain version in
``tests/test_torch_drain_tick_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain
from test_torch_drain_tick_cuda import (
    EXACT, HARD, SUMS, _args, _dead_link_bw, _hard_inputs, _inputs,
    float64_deltas)


def _ref(x, dt, A, R):
    out = ref.drain_tick_ref(
        *(jnp.asarray(x[k]) for k in ("routes", "bytes_rem", "active", "job",
                                      "min_arrive", "t")),
        jnp.float32(dt), jnp.asarray(x["bw_eff"]),
        jnp.asarray(x["link_dst_router"]), A, R)
    return [np.asarray(o) for o in out]


def _port(x, dt, A, R, device="cpu"):
    args = [torch.as_tensor(x[k], device=device)
            for k in ("routes", "bytes_rem", "active", "job", "min_arrive",
                      "t")]
    return drain_tick_plain(
        *args, dt, torch.as_tensor(x["bw_eff"], device=device),
        torch.as_tensor(x["link_dst_router"], device=device), A, R)


def _assert_matches(want, got):
    for name, w, g in zip(EXACT + SUMS, want, got):
        g = g.cpu().numpy()
        assert g.shape == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("B,M,L,A,R", [
    (1, 256, 64, 2, 16),
    (3, 512, 300, 4, 24),
    (2, 300, 70, 3, 12),  # M not a multiple of any block size
])
def test_plain_matches_reference(B, M, L, A, R):
    x = _inputs(B, M, 10, L, A, R, M + L)
    _assert_matches(_ref(x, 2.0, A, R), _port(x, 2.0, A, R))


@pytest.mark.parametrize("per_member", [False, True])
def test_plain_matches_reference_with_dead_links(per_member):
    B, M, K, L, A, R = 3, 256, 10, 64, 2, 16
    x = _inputs(B, M, K, L, A, R, 11)
    if per_member:
        x["bw_eff"] = _dead_link_bw(x, B, L, 99)
    else:
        x["bw_eff"][:L:7] = 0.0  # dead links in the shared row
    _assert_matches(_ref(x, 2.0, A, R), _port(x, 2.0, A, R))


@pytest.mark.parametrize("case", sorted(HARD))
def test_plain_matches_reference_on_hard_cases(case):
    """The card tests' hard cases, cut to a small size."""
    B, _, _, A, _, per_member = HARD[case]
    M = 0 if case == "empty_pool" else 300
    x = _hard_inputs(case, B, M, 50, A, 24, per_member)
    _assert_matches(_ref(x, 5.0, A, 24), _port(x, 5.0, A, 24))


def test_float64_deltas_are_the_reference_sums():
    """The card tests' float64 byte deltas equal the JAX reference's sums
    on the same drains."""
    B, M, L, A, R = 3, 400, 60, 3, 12
    x = _hard_inputs("three_members", B, M, L, A, R, True)
    want = _ref(x, 5.0, A, R)
    args = _args(x, "cpu")
    for w, got in zip(want[3:], float64_deltas(args, drain_tick_plain(
            *args, A, R)[1], A, R)):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-30)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = _inputs(1, 8, 3, 5, 2, 4, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        drain_tick_cuda(*_args(x, "cpu"), 2, 4)


def test_per_member_bandwidth_rows_match_solo_runs():
    """A (B, L+1) bandwidth matrix equals running each member alone with
    its own row, and identical rows equal the 1-D broadcast, bitwise."""
    B, M, K, L, A, R = 3, 256, 10, 64, 2, 16
    x = _inputs(B, M, K, L, A, R, 11)
    bw_1d = x["bw_eff"]
    x["bw_eff"] = _dead_link_bw(x, B, L, 99)
    full = _port(x, 2.0, A, R)
    for b in range(B):
        solo = {k: (v[b:b + 1] if k not in ("link_dst_router",) else v)
                for k, v in x.items()}
        solo["bw_eff"] = x["bw_eff"][b]
        for f, s in zip(full, _port(solo, 2.0, A, R)):
            torch.testing.assert_close(f[b], s[0], rtol=0, atol=0)
    x["bw_eff"] = np.broadcast_to(bw_1d, (B, L + 1)).copy()
    tiled = _port(x, 2.0, A, R)
    x["bw_eff"] = bw_1d
    for a, c in zip(tiled, _port(x, 2.0, A, R)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_member_batch_is_independent():
    """Member b of a batched call equals its own B=1 call."""
    x = _inputs(4, 256, 8, 40, 3, 10, 7)
    full = _port(x, 3.0, 3, 10)
    for b in range(4):
        solo = {k: (v[b:b + 1] if k not in ("bw_eff", "link_dst_router")
                    else v) for k, v in x.items()}
        for f, s in zip(full, _port(solo, 3.0, 3, 10)):
            torch.testing.assert_close(f[b], s[0], rtol=0, atol=0)


def test_fair_share_invariants():
    """A link carrying n messages gives each bw/n; a message drains at its
    bottleneck link; byte counters conserve the drained bytes."""
    x = dict(
        routes=np.asarray([[[0, 1, -1], [0, 2, -1]]], np.int32),
        bytes_rem=np.asarray([[100.0, 100.0]], np.float32),
        active=np.ones((1, 2), bool),
        job=np.zeros((1, 2), np.int32),
        min_arrive=np.zeros((1, 2), np.float32),
        t=np.asarray([1.0], np.float32),
        bw_eff=np.asarray([20.0, 2.0, 100.0, 1.0], np.float32) * 1e6,
        link_dst_router=np.asarray([0, 1, 2, 0], np.int32),
    )
    got = _port(x, 1.0, 1, 3)
    _assert_matches(_ref(x, 1.0, 1, 3), got)
    new_rem, rate, _delivered, lb, rw = got
    assert rate.tolist() == [[2.0, 10.0]]
    drained = float((torch.as_tensor(x["bytes_rem"]) - new_rem).sum())
    assert drained > 0
    assert float(lb.sum()) == pytest.approx(2 * drained, rel=1e-6)
    assert float(rw.sum()) == pytest.approx(float(lb[0, :3].sum()), rel=1e-6)


def test_ops_dispatch_takes_plain_version_on_cpu():
    B, M, L, A, R = 2, 300, 70, 3, 12
    x = _inputs(B, M, 10, L, A, R, 5)
    args = [torch.as_tensor(x[k]) for k in ("routes", "bytes_rem", "active",
                                            "job", "min_arrive", "t")]
    ops.reset_launches()
    out = ops.drain_tick(*args, 2.0, torch.as_tensor(x["bw_eff"]),
                         torch.as_tensor(x["link_dst_router"]),
                         n_apps=A, n_routers=R)
    assert ops.CALLS["drain_tick"] == 1
    assert ops.LAUNCHES["drain_tick"] == 0
    _assert_matches(_ref(x, 2.0, A, R), out)


def test_each_source_names_its_own_flags():
    """Only the drain tick and the injection ask for ``--fmad=false``
    (exact delivery ticks, UGAL's compare and the latency floor need it);
    the flags are part of the library's hash."""
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == ["drain_tick", "inject", "link_demand", "router_tick",
                       "ssd_scan", "ssd_scan_bwd"]
    for name in sources:
        flags = _build.source_flags(name)
        assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert ("--fmad=false" in flags) == (
            name in ("drain_tick", "inject")), name
        assert _build.library_path(name).name.startswith(f"{name}-")


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library's hash covers the ``csrc/*.cuh`` headers its source
    includes: an edited shared header rebuilds the drain tick and link
    demand, and leaves the SSD scan as it is."""
    import shutil

    from repro_torch.kernels import _build

    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [h.name for h in _build.local_headers(
        tmp_path / "drain_tick.cu")] == ["sim_rows.cuh"]
    names = ("drain_tick", "link_demand", "ssd_scan")
    before = {n: _build.library_path(n) for n in names}
    header = tmp_path / "sim_rows.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["drain_tick"] != before["drain_tick"]
    assert after["link_demand"] != before["link_demand"]
    assert after["ssd_scan"] == before["ssd_scan"]
