"""The SSD chunk-scan CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/ssd_scan.cu`` at first use); skips without
a card. Imports nothing of JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_scan_cuda.py

The kernel sums its products in serial FMA chains, the plain version in
the order of PyTorch's matrix products, so the two agree to float32
rounding: |kernel - plain| <= RTOL * |plain| + ATOL_OF_MAX * max|plain|.
The absolute term follows from the sums: an output sums Q * ds products
(16,384 at full width) whose partial sums are as large as the largest
output, so rounding error scales with the largest value, not with each
one. The numpy input generator here is shared with
``tests/test_torch_ssd_scan.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain

RTOL = 1e-4
ATOL_OF_MAX = 1e-5


def _inputs(BH, nc, Q, hd, ds, seed, groups=None):
    """x, dt = softplus(N(0,1) - 2), A = -exp(N(0,1)), B and C for
    ``groups`` groups of rows (one per row by default), as float32."""
    rng = np.random.default_rng(seed)
    G = BH if groups is None else groups
    f32 = np.float32
    return dict(
        x=rng.standard_normal((BH, nc, Q, hd)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((BH, nc, Q)) - 2.0)).astype(f32),
        A=(-np.exp(rng.standard_normal(BH))).astype(f32),
        Bm=rng.standard_normal((G, nc, Q, ds)).astype(f32),
        Cm=rng.standard_normal((G, nc, Q, ds)).astype(f32),
    )


def _on(x, device):
    return [torch.as_tensor(x[k], device=device)
            for k in ("x", "dt", "A", "Bm", "Cm")]


def assert_ssd_close(got, want, what=""):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * scale, msg=what)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the SSD scan kernel has no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,nc,Q,hd,ds,groups", [
    (2, 2, 8, 4, 4, None),         # the JAX package's kernel test shapes
    (4, 3, 16, 8, 12, None),
    (1, 4, 32, 16, 16, None),
    (8, 3, 16, 8, 16, 2),          # B/C shared by 4 rows (smoke mixer)
    (64, 4, 128, 64, 128, 2),      # full-width rows (mamba2_370m)
    (32, 2, 64, 64, 128, 1),       # a prompt shorter than the chunk
    (3, 2, 37, 5, 9, None),        # odd sizes: tiles and groups ragged
    (16, 1, 128, 64, 128, 2),      # one chunk
    (8, 3, 100, 64, 128, 2),       # Q not a multiple of the 8-row micro-tile
    (32, 2, 128, 64, 128, None),   # one group per row at full width
    (6, 2, 150, 63, 129, 3),       # hd, ds not multiples of 4; two passes
])
def test_kernel_matches_plain_on_card(cuda_device, BH, nc, Q, hd, ds, groups):
    args = _on(_inputs(BH, nc, Q, hd, ds, 5, groups), cuda_device)
    yk, hk = ssd_scan_cuda(*args)
    yp, hp = ssd_scan_plain(*args)
    torch.cuda.synchronize()
    assert_ssd_close(yk, yp, "y")
    assert_ssd_close(hk, hp, "h")


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda_device):
    """Nothing is summed with atomics: two calls give the same bits."""
    args = _on(_inputs(64, 2, 128, 64, 128, 6, groups=2), cuda_device)
    y1, h1 = ssd_scan_cuda(*args)
    y2, h2 = ssd_scan_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_kernel_matches_recurrence_on_card(cuda_device):
    """The kernel equals the token-by-token SSM recurrence (float64)."""
    BH, nc, Q, hd, ds = 2, 3, 16, 4, 6
    x = _inputs(BH, nc, Q, hd, ds, 9)
    yk, _ = ssd_scan_cuda(*_on(x, cuda_device))
    yk = yk.cpu().numpy()
    for bh in range(BH):
        h = np.zeros((ds, hd))
        xs = x["x"][bh].reshape(-1, hd).astype(np.float64)
        dts = x["dt"][bh].reshape(-1).astype(np.float64)
        Bs = x["Bm"][bh].reshape(-1, ds).astype(np.float64)
        Cs = x["Cm"][bh].reshape(-1, ds).astype(np.float64)
        for t in range(xs.shape[0]):
            h = np.exp(dts[t] * float(x["A"][bh])) * h \
                + dts[t] * np.outer(Bs[t], xs[t])
            np.testing.assert_allclose(yk[bh].reshape(-1, hd)[t], Cs[t] @ h,
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_counts_launches_and_refuses(cuda_device):
    args = _on(_inputs(4, 2, 8, 4, 4, 3, groups=2), cuda_device)
    ops.reset_launches()
    ops.ssd_scan(*args)
    assert ops.LAUNCHES["ssd_scan"] == ops.CALLS["ssd_scan"] == 1
    with pytest.raises(ValueError, match="groups"):
        ssd_scan_cuda(*args[:3], args[3][:1].repeat(3, 1, 1, 1),
                      args[4][:1].repeat(3, 1, 1, 1))
    # one chunk of 256 x 256 with a 256-wide state needs more shared
    # memory than a block may have: the launch is refused, and it raises
    big = _on(_inputs(1, 1, 256, 128, 256, 4), cuda_device)
    with pytest.raises(RuntimeError, match="shared memory"):
        ssd_scan_cuda(*big)


@pytest.mark.cuda
def test_kernel_at_jamba_shape_through_the_mixer(cuda_device):
    """``jamba_v01_52b``'s Mamba layers: 128 heads of 64 sharing one group
    of B and C with ``ds`` 16, chunks of 128, on a ragged sequence (4,000
    tokens, padded by ``ssd_chunked`` with dt = 0 to 32 chunks): the
    kernel on the card against the plain scan on the CPU, then one full
    chunk grid (4,096 tokens) against the plain scan on the card."""
    from repro_torch.models.mamba2 import ssd_chunked

    rng = np.random.default_rng(11)
    f32 = np.float32
    S, nh, hd, ds = 4000, 128, 64, 16
    raw = (rng.standard_normal((1, S, nh, hd)).astype(f32),
           np.log1p(np.exp(rng.standard_normal((1, S, nh)) - 2.0)).astype(f32),
           (-np.exp(rng.standard_normal(nh))).astype(f32),
           rng.standard_normal((1, S, ds)).astype(f32),
           rng.standard_normal((1, S, ds)).astype(f32),
           rng.standard_normal(nh).astype(f32))
    got = ssd_chunked(*[torch.as_tensor(a, device=cuda_device) for a in raw],
                      chunk=128)
    want = ssd_chunked(*map(torch.as_tensor, raw), chunk=128)
    assert got.shape == (1, S, nh, hd)
    assert_ssd_close(got.cpu(), want, "ragged")

    args = _on(_inputs(nh, 32, 128, hd, ds, 12, groups=1), cuda_device)
    yk, hk = ssd_scan_cuda(*args)
    yp, hp = ssd_scan_plain(*args)
    torch.cuda.synchronize()
    assert_ssd_close(yk, yp, "y")
    assert_ssd_close(hk, hp, "h")
