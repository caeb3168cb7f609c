"""The link-demand CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/link_demand.cu`` at first use); skips
without a card. Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_link_demand_cuda.py

The plain version sums serially in index order only on the CPU, so the
kernel's sums on the card must equal the plain version's on a CPU copy
of the same inputs, bit for bit. The remaining bytes span six orders of
magnitude, so a sum taken in another order differs in its last bits.
The numpy input generator here is shared with
``tests/test_torch_link_demand.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.link_demand import link_demand_cuda, link_demand_plain


def _inputs(B, M, K, L, seed, frac=0.6):
    rng = np.random.default_rng(seed)
    # a few hot links take long runs, as terminal and global links do
    routes = np.where(rng.random((B, M, K)) < 0.1,
                      rng.integers(0, min(8, L), size=(B, M, K)),
                      rng.integers(-1, L, size=(B, M, K))).astype(np.int32)
    return dict(
        routes=routes,
        active=rng.random((B, M)) < frac,
        bytes_rem=(10.0 ** rng.uniform(0, 6, (B, M))).astype(np.float32),
    )


def _on(x, device):
    return [torch.as_tensor(x[k], device=device)
            for k in ("routes", "active", "bytes_rem")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the link-demand kernel has no CPU "
                    "mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,L", [(1, 65536, 53856), (3, 65573, 73920),
                                   (2, 7, 5)])
def test_kernel_equals_serial_cpu_sums(cuda_device, B, M, L):
    x = _inputs(B, M, 10, L, 17)
    got = link_demand_cuda(*_on(x, cuda_device), L).cpu()
    want = link_demand_plain(*_on(x, "cpu"), L)
    assert got.shape == want.shape == (B, L + 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_wrapper_counts_launches(cuda_device):
    x = _on(_inputs(1, 100, 4, 20, 1), cuda_device)
    ops.reset_launches()
    ops.link_demand(*x, 20)
    assert ops.LAUNCHES["link_demand"] == ops.CALLS["link_demand"] == 1
