"""The link-demand CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/link_demand.cu`` at first use); skips
without a card. Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_link_demand_cuda.py

The plain version sums serially in index order only on the CPU, so the
kernel's sums on the card must equal the plain version's on a CPU copy
of the same inputs, bit for bit. The remaining bytes span six orders of
magnitude, so a sum taken in another order differs in its last bits.
The hard cases put most entries in one bucket (longer than a block sorts
in shared memory), make every message inactive, empty the pool, make it
ragged, put -1 between valid links, give three members their own
shares of active messages and crowd about 100 entries on every link; a
CUDA-graph replay must give an eager call's bits. The fabrics' other
route widths (K = 6 on the fat tree, 8 on the small torus, 21 on the
paper torus) run at their fabrics' shapes, ragged pools among them; at
K = 21 a pool of 65,536 messages has too many route entries for the fold
block's bitmap, so every bucket of more than 64 entries is folded by the
block's walk over the pool, while a pool of 20,000 takes the bitmap for
buckets up to 8,192 entries and the walk for a longer one. A fresh
process's first call at the fat tree's and the torus's shapes (the
latter inside a graph capture) must launch. The numpy
input generators here are shared with ``tests/test_torch_link_demand.py``
and ``chip_smoke.py``.
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


# the hard cases of the card's bucket sort, at the paper's sizes
HARD = {  # case: (B, M, L)
    "one_bucket": (1, 65536, 53856),
    "all_inactive": (1, 65536, 53856),
    "empty_pool": (1, 0, 53856),
    "ragged": (1, 65573, 73920),
    "mid_row_padding": (1, 65536, 53856),
    "three_members": (3, 65536, 53856),
    "crowded_links": (1, 65536, 4000),
}


def _hard_inputs(case, B, M, L, seed=5):
    """Inputs of one hard case: ``one_bucket`` sends nine tenths of the
    route entries to link 3 (a bucket longer than a block sorts) and one
    in eighty to link 5 (a few thousand: a block's sort); ``all_inactive``
    has no active message; ``mid_row_padding`` puts -1 in random slots
    between valid links; ``three_members`` gives each member its own
    share of active messages; ``crowded_links`` (given few links) puts
    about 100 entries on each, around the longest bucket a warp sorts."""
    x = _inputs(B, M, 10, L, seed)
    rng = np.random.default_rng(seed + 1)
    r = x["routes"]
    if case == "one_bucket":
        u = rng.random(r.shape)
        r[u < 0.9] = min(3, L - 1)
        r[(u >= 0.9) & (u < 0.9125)] = min(5, L - 1)
    elif case == "all_inactive":
        x["active"][:] = False
    elif case == "mid_row_padding":
        r[:] = np.abs(r)
        r[:, :, 1:-1][rng.random(r[:, :, 1:-1].shape) < 0.3] = -1
    elif case == "three_members":
        x["active"] = rng.random((B, M)) < np.asarray([0.05, 0.5, 0.95])[
            :B, None]
    return x


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
@pytest.mark.parametrize("case", sorted(HARD))
def test_kernel_equals_serial_cpu_sums_on_hard_cases(cuda_device, case):
    B, M, L = HARD[case]
    x = _hard_inputs(case, B, M, L)
    got = link_demand_cuda(*_on(x, cuda_device), L).cpu()
    want = link_demand_plain(*_on(x, "cpu"), L)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# the fabrics' route widths at their shapes: (B, M, K, L)
WIDTHS = {
    "fat_tree_paper": (1, 65536, 6, 49152),
    "fat_tree_paper_ragged": (2, 65573, 6, 49152),
    "torus_small_ragged": (2, 4099, 8, 1408),
    "torus_paper": (1, 65536, 21, 29568),
    "torus_paper_ragged": (1, 65573, 21, 29568),
}


def _long_bucket_inputs(B, M, K, L, seed):
    """A pool whose link 3 takes a bucket of over 8,192 entries and link
    100 one of about 3,000 (longer than a warp sorts, short enough for a
    block's bitmap)."""
    x = _inputs(B, M, K, L, seed)
    u = np.random.default_rng(seed + 1).random(x["routes"].shape)
    medium = 3000.0 / (M * K * 0.6)
    x["routes"][u < 0.025] = 3
    x["routes"][(u >= 0.025) & (u < 0.025 + medium)] = 100
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_kernel_equals_serial_cpu_sums_at_fabric_widths(cuda_device, case):
    B, M, K, L = WIDTHS[case]
    x = _inputs(B, M, K, L, 23)
    got = link_demand_cuda(*_on(x, cuda_device), L).cpu()
    want = link_demand_plain(*_on(x, "cpu"), L)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [65536, 20000])
def test_long_buckets_at_route_width_21(cuda_device, M):
    """K = 21: at M = 65,536 the bitmap does not fit (every long bucket,
    the eight hot links' and link 100's, walks the pool); at M = 20,000 it
    does (link 100's bucket takes the bitmap, link 3's walks)."""
    L = 29568
    x = _long_bucket_inputs(1, M, 21, L, 37)
    valid = (x["routes"] >= 0) & x["active"][:, :, None]
    assert int((valid & (x["routes"] == 3)).sum()) > 8192
    assert 64 < int((valid & (x["routes"] == 100)).sum()) <= 8192
    got = link_demand_cuda(*_on(x, cuda_device), L).cpu()
    want = link_demand_plain(*_on(x, "cpu"), L)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


FIRST_CALL = """
import sys
import torch
from repro_torch.kernels.link_demand import link_demand_cuda, link_demand_plain
from test_torch_link_demand_cuda import _inputs, _on, WIDTHS

dev = torch.device("cuda", 0)
B, M, K, L = WIDTHS[sys.argv[1]]
x = _inputs(B, M, K, L, 61)
on = _on(x, dev)
if sys.argv[2] == "captured":
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # the process's first call
        got = link_demand_cuda(*on, L)
    graph.replay()
else:
    got = link_demand_cuda(*on, L)  # the process's first call
torch.cuda.synchronize()
want = link_demand_plain(*_on(x, "cpu"), L)
assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
print("ok")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("case,how", [("fat_tree_paper", "eager"),
                                      ("torus_paper", "captured")])
def test_first_call_sets_the_shared_memory_limit(cuda_device, case, how):
    """A fresh process's first call: the paper fat tree's bitmap is 48 KB
    of dynamic shared memory, over the limit with the fold kernel's static
    arrays unless the wrapper sets the opt-in attribute; the paper torus's
    first call inside a graph capture sets it there."""
    from test_torch_drain_tick_cuda import run_fresh

    run_fresh(FIRST_CALL, case, how)


@pytest.mark.cuda
def test_graph_replay_equals_an_eager_call(cuda_device):
    """The wrapper captured in a CUDA graph (its workspace comes from the
    graph's pool) replays to the eager call's bits, on fresh inputs copied
    into the captured ones."""
    x = _on(_inputs(1, 65536, 10, 53856, 29), cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        link_demand_cuda(*x, 53856)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = link_demand_cuda(*x, 53856)
    for seed in (30, 31):
        fresh = _on(_hard_inputs("mid_row_padding", 1, 65536, 53856, seed),
                    cuda_device)
        for dst, src in zip(x, fresh):
            dst.copy_(src)
        graph.replay()
        eager = link_demand_cuda(*fresh, 53856)
        torch.cuda.synchronize()
        assert torch.equal(captured.view(torch.int32), eager.view(torch.int32))


@pytest.mark.cuda
def test_wrapper_counts_launches(cuda_device):
    x = _on(_inputs(1, 100, 4, 20, 1), cuda_device)
    ops.reset_launches()
    ops.link_demand(*x, 20)
    assert ops.LAUNCHES["link_demand"] == ops.CALLS["link_demand"] == 1
