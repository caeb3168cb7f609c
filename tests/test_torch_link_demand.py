"""The port's link demand sums serially in flat index order, on the CPU.

``repro_torch.kernels.ops.link_demand`` on CPU tensors must give, bit for
bit, the sum a serial float32 loop over the route entries takes in
(member, message, route slot) order: the order of the JAX engine's
scatter-add on the CPU, which the engine lockstep in
``tests/test_torch_engine.py`` holds the port to at small sizes and
``test_equals_the_reference_scatter_at_pool_scale`` at the paper's. The CUDA kernel is held
against the plain version in ``tests/test_torch_link_demand_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim.engine import _flat_add
from repro_torch.kernels import ops
from repro_torch.kernels.link_demand import link_demand_cuda, work_words
from test_torch_link_demand_cuda import HARD, _hard_inputs, _inputs, _on


def _serial(x, L):
    B, M, K = x["routes"].shape
    out = np.zeros((B, L + 1), np.float32)
    for b in range(B):
        for m in range(M):
            if not x["active"][b, m]:
                continue
            for k in range(K):
                link = x["routes"][b, m, k]
                if link >= 0:
                    out[b, link] = np.float32(out[b, link]
                                              + x["bytes_rem"][b, m])
    return out


@pytest.mark.parametrize("B,M,K,L", [(1, 400, 10, 60), (3, 257, 6, 9)])
def test_plain_is_the_serial_sum(B, M, K, L):
    x = _inputs(B, M, K, L, B * M)
    ops.reset_launches()
    got = ops.link_demand(*_on(x, "cpu"), L)
    assert ops.CALLS["link_demand"] == 1 and ops.LAUNCHES["link_demand"] == 0
    want = _serial(x, L)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert float(got[:, L].abs().max()) == 0.0  # the dummy column


@pytest.mark.parametrize("case", sorted(HARD))
def test_plain_is_the_serial_sum_on_hard_cases(case):
    """The card tests' hard cases, cut to a CPU loop's size."""
    B = HARD[case][0]
    x = _hard_inputs(case, B, 0 if case == "empty_pool" else 300, 40)
    want = _serial(x, 40)
    got = ops.link_demand(*_on(x, "cpu"), 40)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_workspace_and_refusals():
    """The kernel's workspace: three words a key, two more, two a route
    entry; the CUDA wrapper refuses tensors that are not on a card."""
    assert work_words(1, 65536, 10, 53856) == 3 * 53857 + 2 + 2 * 655360
    assert work_words(3, 0, 10, 4) == 3 * 15 + 2
    x = _on(_inputs(1, 8, 3, 5, 0), "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        link_demand_cuda(*x, 5)


def test_plain_is_serial_at_pool_scale_with_threads():
    """At the paper's pool size with several intra-op threads the plain
    version still sums serially (``index_put_(accumulate=True)`` does not:
    it splits a large index list across threads)."""
    x = _inputs(1, 65536, 10, 53856, 5)
    r = x["routes"].reshape(-1)
    act = np.repeat(x["active"].reshape(-1), 10)
    valid = (r >= 0) & act
    want = np.zeros(53857, np.float32)
    np.add.at(want, r[valid], np.repeat(x["bytes_rem"].reshape(-1), 10)[valid])
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = ops.link_demand(*_on(x, "cpu"), 53856)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("B,M,L", [(1, 65536, 53856), (2, 65573, 73920)])
def test_equals_the_reference_scatter_at_pool_scale(B, M, L):
    """At the paper's pool and link counts, with several intra-op threads,
    the port's demand equals bit for bit the demand the JAX engine builds
    (``jnp.zeros`` and its ``_flat_add`` scatter-add, as in its injection
    step) from the same numpy inputs."""
    x = _inputs(B, M, 10, L, 23)
    routes, active = jnp.asarray(x["routes"]), jnp.asarray(x["active"])
    valid = (routes >= 0) & active[:, :, None]
    lidx = jnp.where(valid, routes, L)
    want = np.asarray(_flat_add(
        jnp.zeros((B, L + 1), jnp.float32), lidx,
        jnp.broadcast_to(jnp.asarray(x["bytes_rem"])[:, :, None], lidx.shape)
        * valid))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = ops.link_demand(*_on(x, "cpu"), L)
    finally:
        torch.set_num_threads(threads)
    assert got.shape == (B, L + 1)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
