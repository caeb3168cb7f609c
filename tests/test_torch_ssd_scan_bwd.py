"""The SSD scan's gradient in the port against the JAX package's, on the CPU.

* The Mamba-2 mixer's scan, ``repro_torch.models.mamba2.ssd_chunked``
  (whose CPU path differentiates ``ssd_scan_plain``, the backward kernel's
  plain version ``ssd_scan_bwd_plain``), against ``jax.vjp`` of
  ``repro.models.mamba2.ssd_chunked``: a ragged sequence whose last chunk
  is padded, B and C shared by every head.
* The gradient of the final state, against ``jax.vjp`` of
  ``repro.kernels.ref.ssd_chunk_ref`` row by row.
* ``ssd_scan_bwd_stages``, the plain mirror of the CUDA kernels' stages
  (the states entering the chunks, dh leaving them, every chunk's
  gradients in closed form), against autograd and against the JAX
  reference: it is what the card tests and ``chip_smoke.py`` hold the
  kernels' intermediates to.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: |port - jax| <= 1e-4 |jax| + 1e-5 max|jax|, each output (sums
in another order). Log-decays are kept moderate (dt·A a step about -0.2):
the reference takes exp before its causal mask, so a chunk whose
cumulative decay overflows exp above the diagonal gives it NaN gradients
(C.8), which the port does not share.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro.models import mamba2 as jax_mamba2
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (
    ssd_scan_bwd_plain, ssd_scan_bwd_stages, ssd_scan_plain)
from repro_torch.models import mamba2 as torch_mamba2
from test_torch_ssd_scan_cuda import _inputs, _on

RTOL = 1e-4
ATOL_OF_MAX = 1e-5


def assert_close(got, want, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * scale, err_msg=what)


def _mixer_inputs(Bsz, S, nh, hd, ds, seed):
    """x, dt = softplus(N(0,1) - 2), A = -exp(N(0,1)) / 2, B and C a
    batch row, D, and a cotangent for y, as float32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((Bsz, S, nh, hd)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((Bsz, S, nh)) - 2.0)).astype(
            f32),
        A=(-np.exp(rng.standard_normal(nh)) / 2).astype(f32),
        Bm=rng.standard_normal((Bsz, S, ds)).astype(f32),
        Cm=rng.standard_normal((Bsz, S, ds)).astype(f32),
        D=rng.standard_normal(nh).astype(f32),
        dy=rng.standard_normal((Bsz, S, nh, hd)).astype(f32),
    )


NAMES = ("x", "dt", "A", "Bm", "Cm", "D")


@pytest.mark.parametrize("Bsz,S,nh,hd,ds,chunk", [
    (2, 13, 3, 4, 6, 8),     # ragged: the last chunk holds 5 of 8 steps
    (1, 32, 4, 8, 16, 8),    # whole chunks
    (2, 20, 2, 5, 3, 16),    # one chunk of 16 and a padded one
])
def test_mixer_gradients_match_jax(Bsz, S, nh, hd, ds, chunk):
    v = _mixer_inputs(Bsz, S, nh, hd, ds, 100 + S)
    fn = functools.partial(jax_mamba2.ssd_chunked, chunk=chunk)
    y_j, vjp = jax.vjp(fn, *(jnp.asarray(v[k]) for k in NAMES))
    want = vjp(jnp.asarray(v["dy"]))
    leaves = [torch.tensor(v[k], requires_grad=True) for k in NAMES]
    y_t = torch_mamba2.ssd_chunked(*leaves, chunk=chunk)
    got = torch.autograd.grad(y_t, leaves, torch.as_tensor(v["dy"]))
    assert_close(y_t.detach().numpy(), y_j, "y")
    for name, g, w in zip(NAMES, got, want):
        assert_close(g.numpy(), w, f"d{name}")


@pytest.mark.parametrize("BH,nc,Q,hd,ds", [(3, 3, 8, 4, 6), (2, 2, 16, 8, 5)])
def test_final_state_gradient_matches_jax_reference(BH, nc, Q, hd, ds):
    """dy and dh of the final state together, against jax.vjp of the
    reference's sequential scan, one row at a time."""
    raw = _inputs(BH, nc, Q, hd, ds, 7 + Q)
    rng = np.random.default_rng(8 + Q)
    dy = rng.standard_normal((BH, nc, Q, hd)).astype(np.float32)
    dh = rng.standard_normal((BH, ds, hd)).astype(np.float32)
    got = ssd_scan_bwd_plain(*_on(raw, "cpu"), torch.as_tensor(dy),
                             torch.as_tensor(dh))
    stages = ssd_scan_bwd_stages(*_on(raw, "cpu"), torch.as_tensor(dy),
                                 torch.as_tensor(dh))["grads"]
    for bh in range(BH):
        ins = [jnp.asarray(raw[k][bh]) for k in ("x", "dt", "A", "Bm", "Cm")]
        _, vjp = jax.vjp(ssd_chunk_ref, *ins, jnp.zeros((ds, hd)))
        want = vjp((jnp.asarray(dy[bh]), jnp.asarray(dh[bh])))[:5]
        for name, g, s, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                 stages, want):
            assert_close(g[bh].numpy(), w, f"row {bh} {name}")
            assert_close(s[bh].numpy(), w, f"row {bh} {name} (stages)")


@pytest.mark.parametrize("BH,nc,Q,hd,ds,groups,with_dh", [
    (4, 3, 8, 4, 6, 2, True),
    (3, 4, 16, 5, 7, None, False),
    (6, 1, 8, 3, 4, 3, True),        # one chunk: no carry at all
])
def test_stages_mirror_matches_autograd(BH, nc, Q, hd, ds, groups, with_dh):
    """In float64: the mirror's gradients equal autograd through the plain
    scan; its states entering chunk c + 1 equal the final state of the
    plain scan over chunks 0 .. c."""
    args = [t.double() for t in _on(_inputs(BH, nc, Q, hd, ds, 40 + nc,
                                            groups), "cpu")]
    rng = np.random.default_rng(41 + nc)
    dy = torch.as_tensor(rng.standard_normal((BH, nc, Q, hd)))
    dh = torch.as_tensor(rng.standard_normal((BH, ds, hd))) if with_dh \
        else None
    mirror = ssd_scan_bwd_stages(*args, dy, dh)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), mirror["grads"],
                          ssd_scan_bwd_plain(*args, dy, dh)):
        assert_close(g.numpy(), w.numpy(), name)
    assert not mirror["h_in"][:, 0].any()
    for c in range(nc - 1):
        cut = [args[0][:, :c + 1], args[1][:, :c + 1], args[2],
               args[3][:, :c + 1], args[4][:, :c + 1]]
        _, h = ssd_scan_plain(*cut)
        assert_close(mirror["h_in"][:, c + 1].numpy(), h.numpy(),
                     f"h_in[{c + 1}]")
    final = dh if dh is not None else torch.zeros((BH, ds, hd),
                                                  dtype=torch.float64)
    assert_close(mirror["dh_out"][:, -1].numpy(), final.numpy(), "dh_out[-1]")


def test_stages_dh_matches_jax_reference():
    """dh leaving chunk c is the gradient, through the reference's scan of
    the later chunks from that state, of their y and the final state."""
    BH, nc, Q, hd, ds = 2, 4, 8, 4, 6
    raw = _inputs(BH, nc, Q, hd, ds, 51)
    rng = np.random.default_rng(52)
    dy = rng.standard_normal((BH, nc, Q, hd)).astype(np.float32)
    dh = rng.standard_normal((BH, ds, hd)).astype(np.float32)
    mirror = ssd_scan_bwd_stages(*_on(raw, "cpu"), torch.as_tensor(dy),
                                 torch.as_tensor(dh))
    for bh in range(BH):
        for c in range(nc - 1):
            tail = [jnp.asarray(raw[k][bh, c + 1:]) for k in
                    ("x", "dt", "Bm", "Cm")]
            h0 = jnp.asarray(mirror["h_in"][bh, c + 1].numpy())
            _, vjp = jax.vjp(
                lambda h: ssd_chunk_ref(tail[0], tail[1], raw["A"][bh],
                                        tail[2], tail[3], h), h0)
            (want,) = vjp((jnp.asarray(dy[bh, c + 1:]), jnp.asarray(dh[bh])))
            assert_close(mirror["dh_out"][bh, c].numpy(), want,
                         f"row {bh} dh_out[{c}]")


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    args = _on(_inputs(4, 2, 8, 4, 6, 61, groups=2), "cpu")
    dy = torch.as_tensor(np.random.default_rng(62).standard_normal(
        (4, 2, 8, 4)).astype(np.float32))
    ops.reset_launches()
    got = ops.ssd_scan_bwd(*args, dy)
    want = ssd_scan_bwd_plain(*args, dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.CALLS["ssd_scan_bwd"] == 1
    assert ops.LAUNCHES["ssd_scan_bwd"] == 0
