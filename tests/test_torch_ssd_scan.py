"""The port's SSD chunk scan against the JAX package's, on the CPU.

``repro_torch.kernels.ssd_scan.ssd_scan_plain`` must compute what
``repro.kernels.ops.ssd_scan`` computes, through its Pallas kernel (in
interpret mode) and through its reference ``ref.ssd_chunk_ref``, at
rtol/atol 3e-5, the tolerance the JAX package holds its kernel to: the
matrix products sum in another order. Inputs are made with numpy from a
seed and handed to both. The CUDA kernel is held against the plain
version in ``tests/test_torch_ssd_scan_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from test_torch_ssd_scan_cuda import _inputs, _on

SHAPES = [(8, 4, 4, 2, 2), (16, 8, 12, 3, 4), (32, 16, 16, 4, 1)]


def _jax(x, use_pallas):
    y, h = jops.ssd_scan(*(jnp.asarray(x[k]) for k in
                           ("x", "dt", "A", "Bm", "Cm")),
                         use_pallas=use_pallas)
    return np.asarray(y), np.asarray(h)


@pytest.mark.parametrize("Q,hd,ds,nc,BH", SHAPES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_plain_matches_jax(Q, hd, ds, nc, BH, use_pallas):
    x = _inputs(BH, nc, Q, hd, ds, Q * hd)
    want_y, want_h = _jax(x, use_pallas)
    got_y, got_h = ssd_scan_plain(*_on(x, "cpu"))
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=3e-5, atol=3e-5)


def test_plain_matches_recurrence():
    """The chunked scan equals the exact token-by-token SSM recurrence."""
    BH, nc, Q, hd, ds = 2, 2, 8, 4, 6
    x = _inputs(BH, nc, Q, hd, ds, 9)
    y, _ = ssd_scan_plain(*_on(x, "cpu"))
    for bh in range(BH):
        h = np.zeros((ds, hd))
        xs = x["x"][bh].reshape(-1, hd)
        dts = x["dt"][bh].reshape(-1)
        Bs = x["Bm"][bh].reshape(-1, ds)
        Cs = x["Cm"][bh].reshape(-1, ds)
        want = []
        for t in range(xs.shape[0]):
            h = np.exp(dts[t] * float(x["A"][bh])) * h \
                + dts[t] * np.outer(Bs[t], xs[t])
            want.append(Cs[t] @ h)
        np.testing.assert_allclose(y[bh].reshape(-1, hd).numpy(),
                                   np.stack(want), rtol=1e-4, atol=1e-4)


def test_shared_groups_match_per_row_jax():
    """B/C given once per group of rows (the Mamba-2 mixer's layout) equal
    the JAX package's scan with B/C repeated for every row."""
    BH, G, nc, Q, hd, ds = 12, 3, 3, 16, 8, 16
    x = _inputs(BH, nc, Q, hd, ds, 21, groups=G)
    rep = dict(x, Bm=np.repeat(x["Bm"], BH // G, axis=0),
               Cm=np.repeat(x["Cm"], BH // G, axis=0))
    want_y, want_h = _jax(rep, use_pallas=True)
    got_y, got_h = ssd_scan_plain(*_on(x, "cpu"))
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=3e-5, atol=3e-5)


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    x = _on(_inputs(4, 2, 8, 4, 4, 3, groups=2), "cpu")
    ops.reset_launches()
    y, h = ops.ssd_scan(*x)
    want_y, want_h = ssd_scan_plain(*x)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ops.CALLS["ssd_scan"] == 1 and ops.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError, match="groups"):
        ops.ssd_scan(*x[:3], x[3][:1].repeat(3, 1, 1, 1), x[4])
