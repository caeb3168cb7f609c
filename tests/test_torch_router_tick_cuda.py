"""The route-rate-drain CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/router_tick.cu`` at first use); skips
without a card. Imports nothing of JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_router_tick_cuda.py

new_rem, rate and drained must equal the plain version bit for bit: the
kernel does the same float operations and sums nothing. The numpy input
generator here is shared with ``tests/test_torch_router_tick.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.router_tick import (
    router_rate_drain_cuda, router_rate_drain_plain)

NAMES = ("new_rem", "rate", "drained")


def _inputs(M, K, L, seed, frac=0.5, dead=0.0):
    """Routes with -1 pads, remaining bytes, an active mask with ``frac``
    of the pool active, and a share table with a ``dead`` share of 0."""
    rng = np.random.default_rng(seed)
    share = (rng.random(L) * 1e3 + 1.0).astype(np.float32)
    share[rng.random(L) < dead] = 0.0
    return dict(
        routes=rng.integers(-1, L, size=(M, K), dtype=np.int32),
        bytes_rem=(rng.random(M) * 1e5).astype(np.float32),
        active=rng.random(M) < frac,
        share=share,
    )


def _on(x, device):
    return [torch.as_tensor(x[k], device=device)
            for k in ("routes", "bytes_rem", "active", "share")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the route-rate-drain kernel has "
                    "no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,dead", [
    (65536, 53856, 0.0),   # paper 1D pool and links
    (65573, 73920, 0.05),  # ragged pool, paper 2D links, dead links
    (1, 8, 0.0),
])
@pytest.mark.parametrize("dt", [5.0, 0.3])
def test_kernel_matches_plain_on_card(cuda_device, M, L, dead, dt):
    args = _on(_inputs(M, 10, L, 11, dead=dead), cuda_device)
    k = router_rate_drain_cuda(*args, dt)
    p = router_rate_drain_plain(*args, dt)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, k, p):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_wrapper_counts_launches_and_checks_inputs(cuda_device):
    args = _on(_inputs(600, 4, 50, 12), cuda_device)
    ops.reset_launches()
    ops.router_rate_drain(*args, 1.0)
    assert ops.LAUNCHES["router_rate_drain"] == 1
    assert ops.CALLS["router_rate_drain"] == 1
    with pytest.raises(ValueError, match="bytes_rem"):
        router_rate_drain_cuda(args[0], args[1].double(), *args[2:], 1.0)
