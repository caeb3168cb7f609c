"""The drain-tick CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/drain_tick.cu`` at first use); skips
without a card. Imports nothing of JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_drain_tick_cuda.py

new_rem, rate and delivered must equal the plain version exactly; the
byte deltas, summed by float atomics in run-to-run varying order, to
rtol 1e-5. The numpy input generators here are shared with
``tests/test_torch_drain_tick.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain

EXACT = ("new_rem", "rate", "delivered")
SUMS = ("link_bytes_delta", "router_win_delta")


def _inputs(B, M, K, L, A, R, seed, frac=0.5):
    rng = np.random.default_rng(seed)
    return dict(
        routes=rng.integers(-1, L, size=(B, M, K), dtype=np.int32),
        bytes_rem=(rng.random((B, M)) * 1e5).astype(np.float32),
        active=rng.random((B, M)) < frac,
        job=rng.integers(0, A, size=(B, M), dtype=np.int32),
        min_arrive=(rng.random((B, M)) * 10.0).astype(np.float32),
        t=np.linspace(4.0, 9.0, B).astype(np.float32),
        bw_eff=np.concatenate([
            (rng.random(L) * 1e3 + 1.0).astype(np.float32),
            np.ones(1, np.float32)]),
        link_dst_router=np.concatenate([
            rng.integers(0, R, size=L, dtype=np.int32),
            np.zeros(1, np.int32)]),
    )


def _dead_link_bw(x, B, L, seed):
    rng = np.random.default_rng(seed)
    factors = np.where(rng.random((B, L)) < 0.15, 0.0,
                       rng.random((B, L)) * 0.9 + 0.1).astype(np.float32)
    return np.concatenate(
        [x["bw_eff"][None, :L] * factors, np.ones((B, 1), np.float32)], axis=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the drain-tick kernel has no "
                    "CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,L,A,R,per_member", [
    (1, 65536, 53856, 5, 1056, False),
    (3, 65573, 73920, 5, 2112, True),
])
def test_kernel_matches_plain_on_card(cuda_device, B, M, L, A, R, per_member):
    x = _inputs(B, M, 10, L, A, R, 3)
    if per_member:
        x["bw_eff"] = _dead_link_bw(x, B, L, 4)
    args = [torch.as_tensor(x[k], device=cuda_device)
            for k in ("routes", "bytes_rem", "active", "job", "min_arrive",
                      "t")]
    bw = torch.as_tensor(x["bw_eff"], device=cuda_device)
    ldr = torch.as_tensor(x["link_dst_router"], device=cuda_device)
    k = drain_tick_cuda(*args, 5.0, bw, ldr, A, R)
    p = drain_tick_plain(*args, 5.0, bw, ldr, A, R)
    torch.cuda.synchronize()
    for name, a, b in zip(EXACT + SUMS, k, p):
        if name in EXACT:
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=name)
