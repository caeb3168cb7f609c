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
float64. The numpy input generators here are shared with
``tests/test_torch_drain_tick.py`` and ``chip_smoke.py``.
"""
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
