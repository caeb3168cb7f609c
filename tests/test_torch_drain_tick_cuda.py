"""The drain-tick CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc/drain_tick.cu`` at first use); skips
without a card. Imports nothing of JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_drain_tick_cuda.py

new_rem, rate and delivered must equal the plain version bit for bit (a
NaN where the plain version has a NaN); the byte deltas, summed by float
atomics in run-to-run varying order, to rtol 1e-5 with NaN where the
reference has NaN: of the plain version's, and in the hard cases (where
one entry takes up to 300,000 equal adds, and the plain version's own
float32 sums are up to about 1e-4 off) of the same sums taken in
float64. The fabrics' other route widths (K = 6 on the fat tree, 8 on
the small torus, 21 on the paper torus) run at their fabrics' shapes:
ragged pools, a hot link at K = 21, and the paper torus's router-window
table (5 apps x 2,112 routers), which with the staged rows needs more
than the 48 KB of shared memory a block gets without the opt-in
attribute; a fresh process whose first call of that kernel is captured
into a CUDA graph replays it right, and one whose first call needs 48 KB
of dynamic shared memory beside the kernel's static slots launches. The
numpy input generators here are shared with
``tests/test_torch_drain_tick.py`` and ``chip_smoke.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain
from test_torch_router_tick_cuda import same_bits

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


# the hard cases of the card's kernels, at the paper's sizes
HARD = {  # case: (B, M, L, A, R, per-member bandwidth rows)
    "one_bucket": (1, 65536, 53856, 5, 1056, False),
    "all_inactive": (1, 65536, 53856, 5, 1056, False),
    "empty_pool": (1, 0, 53856, 5, 1056, False),
    "ragged": (1, 65573, 73920, 5, 2112, False),
    "mid_row_padding": (1, 65536, 53856, 5, 1056, False),
    "three_members": (3, 65536, 53856, 5, 1056, True),
    "large_window_table": (1, 65536, 53856, 64, 2112, False),
    "nan_bandwidth": (1, 65536, 53856, 5, 1056, False),
    "nan_bytes_rem": (1, 65536, 53856, 5, 1056, False),
}


def _hard_inputs(case, B, M, L, A, R, per_member, seed=6):
    """Inputs of one hard case: ``one_bucket`` routes nine tenths of the
    entries over link 3 and gives most messages one app, so one count,
    one link-byte entry and one router-window entry take most adds;
    ``all_inactive`` has no active message; ``mid_row_padding`` puts -1 in
    random slots between valid links; ``three_members`` gives each member
    its own share of active messages and its own bandwidth row with dead
    links; ``large_window_table`` has a router-window table too large for
    a block's shared memory (64 apps x 2,112 routers); ``nan_bandwidth``
    makes 2 % of the links' bandwidth NaN (their messages take rate 0)
    and ``nan_bytes_rem`` 1 % of the remaining bytes (NaN new_rem, and NaN
    byte deltas on their routes)."""
    x = _inputs(B, M, 10, L, A, R, seed)
    rng = np.random.default_rng(seed + 1)
    r = x["routes"]
    if per_member:
        x["bw_eff"] = _dead_link_bw(x, B, L, seed + 2)
    if case == "one_bucket":
        r[rng.random(r.shape) < 0.9] = min(3, L - 1)
        x["job"][rng.random(x["job"].shape) < 0.9] = 0
    elif case == "all_inactive":
        x["active"][:] = False
    elif case == "mid_row_padding":
        r[:] = np.abs(r)
        r[:, :, 1:-1][rng.random(r[:, :, 1:-1].shape) < 0.3] = -1
    elif case == "three_members":
        x["active"] = rng.random((B, M)) < np.asarray([0.05, 0.5, 0.95])[
            :B, None]
    elif case == "nan_bandwidth":
        x["bw_eff"][:L][rng.random(L) < 0.02] = np.nan
    elif case == "nan_bytes_rem":
        x["bytes_rem"][rng.random((B, M)) < 0.01] = np.nan
    return x


def _args(x, device):
    """(drain_tick args without n_apps, n_routers) on ``device``."""
    return ([torch.as_tensor(x[k], device=device)
             for k in ("routes", "bytes_rem", "active", "job", "min_arrive",
                       "t")]
            + [5.0, torch.as_tensor(x["bw_eff"], device=device),
               torch.as_tensor(x["link_dst_router"], device=device)])


def _assert_kernel_matches(k, p):
    for name, a, b in zip(EXACT + SUMS, k, p):
        if name in EXACT:
            assert same_bits(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0,
                                       equal_nan=True, msg=name)


def float64_deltas(args, rate, n_apps, n_routers):
    """The two byte-delta tables summed in float64 on the CPU from the
    float32 drains (``min(rate * dt, rem)``, the kernel's and the plain
    version's arithmetic): the reference for the float32 sums where one
    entry takes so many equal adds that one float32 chain of them drifts
    (300,000 adds on one link: the plain version's sums on the card are
    up to about 1e-4 off)."""
    routes, rem, active, job, _mina, _t, dt, bw, ldr = [
        a.cpu() if torch.is_tensor(a) else a for a in args]
    B, M, K = routes.shape
    Lp = bw.shape[-1]
    drain = torch.minimum(rate.cpu() * dt, rem).double()
    valid = (routes >= 0) & active[:, :, None]
    lidx = torch.where(valid, routes.long(), Lp - 1)
    d = torch.where(valid, drain[:, :, None], 0.0).reshape(-1)
    boff = (torch.arange(B) * Lp)[:, None, None]
    lb = torch.zeros(B * Lp, dtype=torch.float64).index_add_(
        0, (lidx + boff).reshape(-1), d).reshape(B, Lp)
    rw_idx = (job.long()[:, :, None] * n_routers + ldr.long()[lidx]
              + (torch.arange(B) * n_apps * n_routers)[:, None, None])
    rw = torch.zeros(B * n_apps * n_routers, dtype=torch.float64).index_add_(
        0, rw_idx.reshape(-1), d).reshape(B, n_apps, n_routers)
    return lb, rw


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
    _assert_kernel_matches(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HARD))
def test_kernel_matches_plain_on_hard_cases(cuda_device, case):
    B, M, L, A, R, per_member = HARD[case]
    args = _args(_hard_inputs(case, B, M, L, A, R, per_member), cuda_device)
    k = drain_tick_cuda(*args, A, R)
    p = drain_tick_plain(*args, A, R)
    torch.cuda.synchronize()
    for name, a, b in zip(EXACT, k, p):
        assert same_bits(a, b), name
    for name, a, b in zip(SUMS, k[3:], float64_deltas(args, k[1], A, R)):
        torch.testing.assert_close(a.cpu().double(), b, rtol=1e-5, atol=0,
                                   equal_nan=True,
                                   msg=lambda m, name=name: f"{name}: {m}")


# the fabrics' route widths at their shapes: (B, M, K, L, A, R, per-member
# bandwidth rows)
WIDTHS = {
    "fat_tree_paper": (1, 65536, 6, 49152, 5, 1280, False),
    "fat_tree_paper_ragged": (2, 65573, 6, 49152, 5, 1280, True),
    "torus_small_ragged": (2, 4099, 8, 1408, 5, 64, True),
    "torus_paper": (1, 65536, 21, 29568, 5, 2112, False),
    "torus_paper_ragged": (3, 65573, 21, 29568, 5, 2112, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_kernel_matches_plain_at_fabric_widths(cuda_device, case):
    B, M, K, L, A, R, per_member = WIDTHS[case]
    x = _inputs(B, M, K, L, A, R, 8)
    if per_member:
        x["bw_eff"] = _dead_link_bw(x, B, L, 9)
    args = _args(x, cuda_device)
    k = drain_tick_cuda(*args, A, R)
    p = drain_tick_plain(*args, A, R)
    torch.cuda.synchronize()
    _assert_kernel_matches(k, p)


@pytest.mark.cuda
def test_hot_link_at_route_width_21(cuda_device):
    """Nine tenths of the paper torus pool's route entries on one link
    (its count far above the per-block summing threshold, in slots up to
    20) and most messages of one app."""
    B, M, K, L, A, R = 1, 65536, 21, 29568, 5, 2112
    x = _inputs(B, M, K, L, A, R, 12)
    rng = np.random.default_rng(13)
    x["routes"][rng.random(x["routes"].shape) < 0.9] = 3
    x["job"][rng.random(x["job"].shape) < 0.9] = 0
    args = _args(x, cuda_device)
    k = drain_tick_cuda(*args, A, R)
    torch.cuda.synchronize()
    for name, a, b in zip(EXACT, k, drain_tick_plain(*args, A, R)):
        assert same_bits(a, b), name
    for name, a, b in zip(SUMS, k[3:], float64_deltas(args, k[1], A, R)):
        torch.testing.assert_close(a.cpu().double(), b, rtol=1e-5, atol=0,
                                   equal_nan=True,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_route_width_above_32_is_refused(cuda_device):
    """The kernel sums a hot link's adds per block only in route slots
    below 32; the wrapper takes no wider route."""
    args = _args(_inputs(1, 64, 33, 100, 2, 10, 1), cuda_device)
    with pytest.raises(ValueError, match="route width"):
        drain_tick_cuda(*args, 2, 10)


# a fresh process's first call of the kernel: captured into a graph (the
# paper torus's 63,744-byte shared table), or eager with a table and rows
# of exactly 48 KB, to which the kernel's static shared memory adds
FIRST_CALL = """
import sys
import torch
from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain
from test_torch_drain_tick_cuda import (
    _args, _assert_kernel_matches, _inputs, FIRST_CALL_SHAPES)

dev = torch.device("cuda", 0)
B, M, K, L, A, R = FIRST_CALL_SHAPES[sys.argv[1]]
args = _args(_inputs(B, M, K, L, A, R, 50), dev)
if sys.argv[1] == "captured":
    fresh = _args(_inputs(B, M, K, L, A, R, 51), dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # the process's first call
        got = drain_tick_cuda(*args, A, R)
    for dst, src in zip(args, fresh):
        if torch.is_tensor(dst):
            dst.copy_(src)
    graph.replay()
else:
    got = drain_tick_cuda(*args, A, R)  # the process's first call
torch.cuda.synchronize()
_assert_kernel_matches(got, drain_tick_plain(*args, A, R))
print("ok")
"""
FIRST_CALL_SHAPES = {  # (B, M, K, L, A, R)
    "captured": (1, 65536, 21, 29568, 5, 2112),
    "edge_of_48kb": (1, 4096, 6, 1000, 6, 1792),
}


def run_fresh(code, *argv):
    """Run ``code`` in a fresh interpreter (no kernel called yet) with the
    port and the tests importable; its output must be ``ok``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, os.pardir, "src"), here]))
    res = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FIRST_CALL_SHAPES))
def test_first_call_sets_the_shared_memory_limit(cuda_device, case):
    """The shared table needs the opt-in attribute, which the wrapper sets
    at the process's first call of that size: inside a graph capture, and
    where the dynamic size is 48 KB and the static slots push the total
    over."""
    run_fresh(FIRST_CALL, case)


@pytest.mark.cuda
@pytest.mark.parametrize("A,R", [(5, 1056), (64, 2112)])
def test_graph_replay_equals_an_eager_call(cuda_device, A, R):
    """The wrapper captured in a CUDA graph replays to an eager call's
    results on fresh inputs copied into the captured ones: bit for bit
    where the arithmetic is element-wise, to rtol 1e-5 for the byte deltas
    (float atomics)."""
    args = _args(_inputs(1, 65536, 10, 53856, A, R, 40), cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        drain_tick_cuda(*args, A, R)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = drain_tick_cuda(*args, A, R)
    for seed in (41, 42):
        fresh = _args(_hard_inputs("mid_row_padding", 1, 65536, 53856, A, R,
                                   False, seed), cuda_device)
        for dst, src in zip(args, fresh):
            if torch.is_tensor(dst):
                dst.copy_(src)
        graph.replay()
        eager = drain_tick_cuda(*fresh, A, R)
        torch.cuda.synchronize()
        _assert_kernel_matches(captured, eager)
