"""The port's route-rate-drain against the JAX package's, on the CPU.

``repro_torch.kernels.ops.router_rate_drain`` (its plain version on CPU
tensors) must equal ``repro.kernels.ops.router_rate_drain`` bit for bit,
through the Pallas kernel (interpret mode, the pool padded to its
512-row blocks) and through the reference: the same float operations,
nothing summed. Inputs are made with numpy from a seed and handed to
both. A NaN share or remaining byte count gives what the reference's
``jnp.min`` and ``jnp.minimum`` give (the share's messages take rate 0).
The CUDA kernel is held against the plain version in
``tests/test_torch_router_tick_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops
from test_torch_router_tick_cuda import (
    NAMES, _edge_inputs, _inputs, _on, same_bits)


@pytest.mark.parametrize("M,L,K", [(512, 64, 10), (1000, 300, 10),
                                   (2048, 1500, 6), (65, 40, 10)])
@pytest.mark.parametrize("dt", [1.0, 5.0])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_plain_matches_jax_exactly(M, L, K, dt, use_pallas):
    x = _inputs(M, K, L, M + L, dead=0.05)
    want = jops.router_rate_drain(
        *(jnp.asarray(x[k]) for k in ("routes", "bytes_rem", "active",
                                      "share")),
        dt, use_pallas=use_pallas)
    got = ops.router_rate_drain(*_on(x, "cpu"), dt)
    for name, w, g in zip(NAMES, want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("case", ["example", "nan_share", "nan_bytes_rem"])
def test_plain_matches_reference_on_nan_inputs(case):
    """NaN shares and remaining bytes, bit for bit against
    ``router_rate_drain_ref`` (NaN where it has NaN; the two frameworks
    give NaNs of other payloads): ``example`` is two routes over a NaN share
    (rate 0, nothing drained); the others are the card tests' NaN cases
    at a small size."""
    if case == "example":
        x = dict(routes=np.array([[0, 1, -1], [0, 2, 1]], np.int32),
                 bytes_rem=np.array([100.0, 50.0], np.float32),
                 active=np.array([True, True]),
                 share=np.array([1.0, np.nan, 3.0], np.float32))
    else:
        x = _edge_inputs(case, 1000, 10, 300)
    want = ref.router_rate_drain_ref(
        *(jnp.asarray(x[k]) for k in ("routes", "bytes_rem", "active",
                                      "share")), 2.0)
    got = ops.router_rate_drain(*_on(x, "cpu"), 2.0)
    for name, w, g in zip(NAMES, want, got):
        assert same_bits(g, torch.from_numpy(np.array(w))), name
    if case == "example":
        assert got[1].tolist() == [0.0, 0.0]
        assert got[0].tolist() == [100.0, 50.0]
    else:
        assert np.isnan(x["share"]).any() or np.isnan(x["bytes_rem"]).any()


def test_fair_share_invariants():
    """A message's rate is its bottleneck link's share; inactive messages
    and padding take no rate; a drain never takes more than remains."""
    share = torch.tensor([10.0, 2.0, 100.0])
    routes = torch.tensor([[0, 1, -1, -1], [0, 2, -1, -1], [2, -1, -1, -1],
                           [-1, -1, -1, -1]], dtype=torch.int32)
    rem = torch.tensor([100.0, 100.0, 50.0, 7.0])
    act = torch.tensor([True, True, False, True])
    new_rem, rate, drained = ops.router_rate_drain(routes, rem, act, share,
                                                   1.0)
    assert rate.tolist() == [2.0, 10.0, 0.0, 0.0]
    assert new_rem.tolist() == [98.0, 90.0, 50.0, 7.0]
    assert drained.tolist() == [False, False, False, False]
    new_rem, _, drained = ops.router_rate_drain(routes, rem, act, share, 60.0)
    assert new_rem.tolist() == [0.0, 0.0, 50.0, 7.0]
    assert drained.tolist() == [True, True, False, False]


def test_cpu_dispatch_counts_no_launch():
    ops.reset_launches()
    x = _on(_inputs(8, 3, 5, 1), "cpu")
    ops.router_rate_drain(*x, 1.0)
    assert ops.CALLS["router_rate_drain"] == 1
    assert ops.LAUNCHES["router_rate_drain"] == 0
