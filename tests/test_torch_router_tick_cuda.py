"""The route-rate-drain CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/router_tick.cu`` at first use); skips
without a card. Imports nothing of JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_router_tick_cuda.py

new_rem, rate and drained must equal the plain version bit for bit, a NaN
where the plain version has a NaN (``same_bits``): the kernel does the
same float operations and sums nothing.
Besides the paper's shapes, the edges of the kernel's design: NaN shares
and remaining bytes, warps whose messages are all inactive, rows that are
all padding, the compile-time width K = 10 and the generic path (K = 4,
tensors not aligned for vector accesses), ragged pools, and a CUDA-graph
replay against an eager call. The numpy input generators here are shared
with ``tests/test_torch_router_tick.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.router_tick import (
    router_rate_drain_cuda, router_rate_drain_plain)

NAMES = ("new_rem", "rate", "drained")


def _inputs(M, K, L, seed, frac=0.5, dead=0.0, nan_share=0.0, nan_rem=0.0):
    """Routes with -1 pads, remaining bytes, an active mask with ``frac``
    of the pool active, and a share table with a ``dead`` share of 0; a
    ``nan_share`` share of the table and a ``nan_rem`` share of the
    remaining bytes are NaN."""
    rng = np.random.default_rng(seed)
    share = (rng.random(L) * 1e3 + 1.0).astype(np.float32)
    share[rng.random(L) < dead] = 0.0
    x = dict(
        routes=rng.integers(-1, L, size=(M, K), dtype=np.int32),
        bytes_rem=(rng.random(M) * 1e5).astype(np.float32),
        active=rng.random(M) < frac,
        share=share,
    )
    nan = np.random.default_rng(seed + 1000)
    if nan_share:
        share[nan.random(L) < nan_share] = np.nan
    if nan_rem:
        x["bytes_rem"][nan.random(M) < nan_rem] = np.nan
    return x


# the edges of the kernel's design, at the paper's sizes
EDGES = {  # case: (M, K, L)
    "nan_share": (65536, 10, 53856),
    "nan_bytes_rem": (65536, 10, 53856),
    "inactive_warps": (65536, 10, 53856),
    "all_inactive": (65536, 10, 53856),
    "all_padding": (65536, 10, 53856),
    "padded_rows": (65536, 10, 53856),
    "k4": (65536, 4, 53856),
    "ragged_by_one": (65537, 10, 53856),
    "ragged_small": (3, 10, 8),
}


def _edge_inputs(case, M, K, L, seed=21):
    """Inputs of one edge case: ``nan_share`` makes 2 % of the share table
    NaN, ``nan_bytes_rem`` 1 % of the remaining bytes; ``inactive_warps``
    leaves every other run of 32 messages inactive (whole warps with no
    active message) and ``all_inactive`` the whole pool; ``all_padding``
    has only -1 in every row; ``padded_rows`` ends the rows with 2-6 pads
    after their valid links, as the engine's routes are padded;
    ``k4``, ``ragged_by_one`` and ``ragged_small`` are the random inputs
    at another width or pool size."""
    x = _inputs(M, K, L, seed,
                nan_share=0.02 if case == "nan_share" else 0.0,
                nan_rem=0.01 if case == "nan_bytes_rem" else 0.0)
    rng = np.random.default_rng(seed + 1)
    if case == "inactive_warps":
        x["active"][(np.arange(M) // 32) % 2 == 1] = False
    elif case == "all_inactive":
        x["active"][:] = False
    elif case == "all_padding":
        x["routes"][:] = -1
    elif case == "padded_rows":
        x["routes"] = padded_routes(M, K, L, rng)
    return x


def padded_routes(M, K, L, rng):
    """Rows of 4 to K - 2 valid links followed by -1 pads, the shape of
    the engine's routes (a minimal 1D dragonfly route is up to 6 links)."""
    routes = rng.integers(0, L, size=(M, K), dtype=np.int32)
    n_valid = rng.integers(4, K - 1, size=M)
    routes[np.arange(K)[None, :] >= n_valid[:, None]] = -1
    return routes


def _on(x, device):
    return [torch.as_tensor(x[k], device=device)
            for k in ("routes", "bytes_rem", "active", "share")]


def same_bits(a, b):
    """Equal bit for bit, floats compared as int32 with every NaN as one
    value: NaN where the other is NaN (of whatever payload), the same bits
    everywhere else (so -0.0 differs from 0.0)."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a = torch.where(nan, 0, a.view(torch.int32))
        b = torch.where(nan, 0, b.view(torch.int32))
    return torch.equal(a, b)


def _assert_matches(k, p):
    for name, a, b in zip(NAMES, k, p):
        assert a.dtype == b.dtype, name
        assert same_bits(a, b), name


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
    _assert_matches(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGES))
def test_kernel_matches_plain_on_edges(cuda_device, case):
    args = _on(_edge_inputs(case, *EDGES[case]), cuda_device)
    k = router_rate_drain_cuda(*args, 5.0)
    p = router_rate_drain_plain(*args, 5.0)
    torch.cuda.synchronize()
    _assert_matches(k, p)


@pytest.mark.cuda
def test_nan_share_gives_no_rate(cuda_device):
    """A message whose route crosses a NaN share takes rate 0 and drains
    nothing, as the reference's min, which keeps the NaN, gives it."""
    routes = torch.tensor([[0, 1, -1], [0, 2, 1]], dtype=torch.int32,
                          device=cuda_device)
    rem = torch.tensor([100.0, 50.0], device=cuda_device)
    act = torch.tensor([True, True], device=cuda_device)
    share = torch.tensor([1.0, float("nan"), 3.0], device=cuda_device)
    k = router_rate_drain_cuda(routes, rem, act, share, 2.0)
    _assert_matches(k, router_rate_drain_plain(routes, rem, act, share, 2.0))
    assert k[1].tolist() == [0.0, 0.0]
    assert k[0].tolist() == [100.0, 50.0]


@pytest.mark.cuda
def test_unaligned_views_match_plain(cuda_device):
    """Routes that start one word into their storage, and flags and
    remaining bytes one message in (not aligned for the vector accesses
    of the compile-time path), take the generic path."""
    M, K = 65536, 10
    routes, rem, act, share = _on(_inputs(M + 1, K, 53856, 23), cuda_device)
    routes = routes.reshape(-1)[1:1 + M * K].view(M, K)
    args = [routes, rem[1:], act[1:], share]
    k = router_rate_drain_cuda(*args, 5.0)
    p = router_rate_drain_plain(*args, 5.0)
    torch.cuda.synchronize()
    _assert_matches(k, p)


@pytest.mark.cuda
def test_graph_replay_equals_an_eager_call(cuda_device):
    """The wrapper captured in a CUDA graph replays to an eager call's
    bits, on fresh inputs copied into the captured ones."""
    args = _on(_inputs(65536, 10, 53856, 24), cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        router_rate_drain_cuda(*args, 5.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = router_rate_drain_cuda(*args, 5.0)
    for case in ("padded_rows", "nan_share"):
        fresh = _on(_edge_inputs(case, 65536, 10, 53856, seed=25),
                    cuda_device)
        for dst, src in zip(args, fresh):
            dst.copy_(src)
        graph.replay()
        eager = router_rate_drain_cuda(*fresh, 5.0)
        torch.cuda.synchronize()
        _assert_matches(captured, eager)
        _assert_matches(eager, router_rate_drain_plain(*fresh, 5.0))


@pytest.mark.cuda
def test_wrapper_counts_launches_and_checks_inputs(cuda_device):
    args = _on(_inputs(600, 4, 50, 12), cuda_device)
    ops.reset_launches()
    ops.router_rate_drain(*args, 1.0)
    assert ops.LAUNCHES["router_rate_drain"] == 1
    assert ops.CALLS["router_rate_drain"] == 1
    with pytest.raises(ValueError, match="bytes_rem"):
        router_rate_drain_cuda(args[0], args[1].double(), *args[2:], 1.0)
