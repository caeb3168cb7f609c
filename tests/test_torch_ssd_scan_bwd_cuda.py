"""The SSD chunk scan's backward kernel against autograd through its plain
version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``src/repro_torch/kernels/csrc/
ssd_scan_bwd.cu`` and ``ssd_scan.cu`` are built at first use); skips
without a card. Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan_bwd_cuda.py

Tolerance: every output (dx, ddt, dA, dB, dC) within the forward's
|kernel - plain| <= 1e-4 |plain| + 1e-5 max|plain|; where summation order
alone breaks that, the kernel's largest error to a float64 plain version
must be at most twice the float32 plain version's (both are printed in
the assertion message). The intermediates the kernels write (the states
entering the chunks, dh leaving them) are held to the plain mirror of
the stages, ``ssd_scan_bwd_stages``, with the same rtol and atol.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (
    SSDScan, ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_bwd_stages)
from test_torch_ssd_scan_cuda import _inputs, _on

RTOL = 1e-4
ATOL_OF_MAX = 1e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the SSD backward kernel has no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def bwd_errors(got, args, dy, dh=None):
    """Per output: (max |kernel - plain32|, the tolerance's verdict, max
    |kernel - plain64|, max |plain32 - plain64|)."""
    want = ssd_scan_bwd_plain(*args, dy, dh)
    d64 = [t.double() for t in args]
    want64 = ssd_scan_bwd_plain(*d64, dy.double(),
                                None if dh is None else dh.double())
    out = {}
    for name, g, w, w64 in zip(NAMES, got, want, want64):
        scale = float(w.abs().max())
        err = (g - w).abs()
        ok = bool((err <= RTOL * w.abs() + ATOL_OF_MAX * scale).all())
        out[name] = (float(err.max()), ok,
                     float((g.double() - w64).abs().max()),
                     float((w.double() - w64).abs().max()))
    return out


def assert_bwd_close(got, args, dy, dh=None, what=""):
    for name, (err, ok, err64, plain64) in bwd_errors(got, args, dy,
                                                      dh).items():
        assert all(bool(t.isfinite().all()) for t in got), what
        assert ok or err64 <= 2 * plain64, (
            f"{what} {name}: max err {err} beyond rtol {RTOL} + "
            f"{ATOL_OF_MAX} * max; to float64 {err64}, the plain version's "
            f"{plain64}")


def _dy(x, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(tuple(x.shape)).astype(
        np.float32), device=x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,nc,Q,hd,ds,groups", [
    (2, 2, 8, 4, 4, None),         # the JAX package's kernel test shapes
    (4, 3, 16, 8, 12, None),
    (8, 3, 16, 8, 16, 2),          # B/C shared by 4 rows (smoke mixer)
    (64, 4, 128, 64, 128, 2),      # full-width rows (mamba2_370m)
    (3, 2, 37, 5, 9, None),        # odd sizes
    (16, 1, 128, 64, 128, 2),      # one chunk
    (1, 3, 128, 64, 128, None),    # a single row
    (128, 2, 128, 64, 16, 1),      # jamba: ds 16, 128 heads in one group
    (6, 2, 150, 63, 129, 3),       # Q above 128, hd and ds odd
])
def test_backward_matches_plain_on_card(cuda_device, BH, nc, Q, hd, ds,
                                        groups):
    args = _on(_inputs(BH, nc, Q, hd, ds, 5, groups), cuda_device)
    dy = _dy(args[0], 6)
    got = ssd_scan_bwd_cuda(*args, dy)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in args]
    assert_bwd_close(got, args, dy, what=f"BH={BH} nc={nc} Q={Q}")


@pytest.mark.cuda
def test_backward_with_final_state_gradient(cuda_device):
    args = _on(_inputs(8, 3, 32, 16, 16, 7, 2), cuda_device)
    dy = _dy(args[0], 8)
    dh = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (8, 16, 16)).astype(np.float32), device=cuda_device)
    assert_bwd_close(ssd_scan_bwd_cuda(*args, dy, dh), args, dy, dh,
                     what="with dh")


@pytest.mark.cuda
def test_prefill_shapes(cuda_device):
    """The training shapes of mamba2_370m: 8 x 32 heads, 32 chunks."""
    args = _on(_inputs(256, 32, 128, 64, 128, 11, 8), cuda_device)
    dy = _dy(args[0], 12)
    assert_bwd_close(ssd_scan_bwd_cuda(*args, dy), args, dy, what="prefill")


@pytest.mark.cuda
def test_zero_dt_pad_rows_get_zero_gradient(cuda_device):
    """The mixer right-pads the sequence with dt = 0 rows (x, B, C 0 there)
    and cuts y back, so dy is 0 there: every gradient of those rows is
    exactly 0, and the rows before them match the plain version."""
    BH, nc, Q, hd, ds, pad = 16, 2, 128, 64, 128, 37
    raw = _inputs(BH, nc, Q, hd, ds, 13, 2)
    for k in ("x", "dt"):
        raw[k].reshape(BH, nc * Q, -1)[:, -pad:] = 0.0
    for k in ("Bm", "Cm"):
        raw[k].reshape(2, nc * Q, -1)[:, -pad:] = 0.0
    args = _on(raw, cuda_device)
    dy = _dy(args[0], 14)
    dy.view(BH, nc * Q, hd)[:, -pad:] = 0.0
    got = ssd_scan_bwd_cuda(*args, dy)
    torch.cuda.synchronize()
    for name, g in zip(("dx", "ddt", "dB", "dC"), got[:2] + got[3:]):
        tail = g.reshape(g.shape[0], nc * Q, -1)[:, -pad:]
        assert bool((tail == 0).all()), name
    assert_bwd_close(got, args, dy, what="padded")


@pytest.mark.cuda
def test_autograd_runs_the_kernels_and_counts(cuda_device):
    """ops.ssd_scan on CUDA tensors that need gradients: the forward and
    the backward kernel launch once each, and the gradients equal the
    wrapper's on the same inputs bit for bit (no atomics)."""
    args = _on(_inputs(8, 3, 64, 16, 32, 15, 2), cuda_device)
    dy = _dy(args[0], 16)
    leaves = [a.clone().requires_grad_(True) for a in args]
    ops.reset_launches()
    y, _ = ops.ssd_scan(*leaves)
    y.backward(dy)
    assert ops.LAUNCHES["ssd_scan"] == ops.CALLS["ssd_scan"] == 1
    assert ops.LAUNCHES["ssd_scan_bwd"] == ops.CALLS["ssd_scan_bwd"] == 1
    want = ssd_scan_bwd_cuda(*args, dy)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    again = ssd_scan_bwd_cuda(*args, dy)
    for a, b in zip(again, want):
        assert torch.equal(a, b)
    assert SSDScan.apply(*args)[0].grad_fn is None  # nothing needs a grad


@pytest.mark.cuda
def test_graph_replay_matches_eager(cuda_device):
    args = _on(_inputs(16, 2, 128, 64, 128, 17, 2), cuda_device)
    dy = _dy(args[0], 18)
    eager = ssd_scan_bwd_cuda(*args, dy)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan_bwd_cuda(*args, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd_scan_bwd_cuda(*args, dy)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,nc,Q,hd,ds,groups", [
    (64, 4, 128, 64, 128, 2),      # the main path's instantiation
    (128, 2, 128, 64, 16, 1),      # jamba's group shape
    (3, 2, 37, 5, 9, None),        # odd sizes
])
def test_two_calls_give_the_same_bits(cuda_device, BH, nc, Q, hd, ds,
                                      groups):
    args = _on(_inputs(BH, nc, Q, hd, ds, 19, groups), cuda_device)
    dy = _dy(args[0], 20)
    first = ssd_scan_bwd_cuda(*args, dy)
    second = ssd_scan_bwd_cuda(*args, dy)
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("BH,nc,Q,hd,ds,groups,with_dh", [
    (32, 6, 128, 64, 128, 2, True),
    (6, 3, 150, 63, 129, 3, False),
])
def test_intermediates_match_the_plain_stages(cuda_device, BH, nc, Q, hd,
                                              ds, groups, with_dh):
    """The states entering the chunks and dh leaving them, as the kernels
    write them, against the plain mirror of the stages; the mirror's
    gradients against autograd."""
    args = _on(_inputs(BH, nc, Q, hd, ds, 27, groups), cuda_device)
    dy = _dy(args[0], 28)
    dh = None
    if with_dh:
        dh = torch.as_tensor(np.random.default_rng(29).standard_normal(
            (BH, ds, hd)).astype(np.float32), device=cuda_device)
    inter = {}
    got = ssd_scan_bwd_cuda(*args, dy, dh, scratch=inter)
    torch.cuda.synchronize()
    mirror = ssd_scan_bwd_stages(*args, dy, dh)
    for k in ("h_in", "dh_out"):
        want = mirror[k]
        scale = float(want.abs().max())
        torch.testing.assert_close(inter[k], want, rtol=RTOL,
                                   atol=ATOL_OF_MAX * scale, msg=k)
    assert torch.equal(inter["h_in"][:, 0], torch.zeros_like(
        inter["h_in"][:, 0]))
    assert_bwd_close(got, args, dy, dh, what="intermediates")
    assert_bwd_close(mirror["grads"], args, dy, dh, what="mirror")
