"""The port's route-rate-drain against the JAX package's, on the CPU.

``repro_torch.kernels.ops.router_rate_drain`` (its plain version on CPU
tensors) must equal ``repro.kernels.ops.router_rate_drain`` bit for bit,
through the Pallas kernel (interpret mode, the pool padded to its
512-row blocks) and through the reference: the same float operations,
nothing summed. Inputs are made with numpy from a seed and handed to
both. The CUDA kernel is held against the plain version in
``tests/test_torch_router_tick_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from test_torch_router_tick_cuda import NAMES, _inputs, _on


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
