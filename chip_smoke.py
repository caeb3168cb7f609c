#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero without them. Every phase prints one JSON line with
its seconds, and any failure raises (non-zero exit, no result line):

1. build the six CUDA sources of ``src/repro_torch/kernels/csrc/`` for
   ``sm_90a``, one ``nvcc`` each, all started together; print each one's
   ``-Xptxas -v`` report and the card's name and power limit, in the
   build line and on a line of its own as ``nvidia-smi`` gives them;
2. drain-tick kernel against its plain PyTorch version on the card at the
   paper's shapes (M = 65,536 and a ragged 65,573; K = 10; L+1 = 53,857
   and 73,921; B = 1 with a 1-D bandwidth row, B = 3 with per-member rows
   and dead links): new_rem, rate and delivered exact, the byte deltas to
   rtol 1e-5 (float atomics sum in another order); kernel and plain times
   by CUDA events, and the bound from the bytes the call must move; then
   the hard cases of the card tests (``tests/test_torch_drain_tick_cuda.py``,
   NaN bandwidths and NaN remaining bytes among them);
3. link-demand kernel against its plain version on a CPU copy at the
   paper's shapes and in the card tests' hard cases, bit for bit (the
   plain version sums serially only on the CPU); how many sums
   ``index_add_`` and ``index_put_(accumulate=True)`` on the card give
   with other bits; times and the byte bound;
4. SSD chunk-scan kernel (its C Bᵀ pre-pass and the scan, two CUDA
   kernels a call) against its plain version at the Mamba-2 prefill
   shapes (8 requests x 32 heads, 32 chunks of 128, head 64, state 128),
   and at a ragged length (4,000) through the mixer's padding, within
   |kernel - plain| <= 1e-4 |plain| + 1e-5 max|plain|; times, the bound
   from the FLOPs and bytes the call needs, the achieved TFLOP/s and share
   of the bound, each kernel's device time, the scan's shared memory and
   both kernels' blocks per SM;
   then the scan's backward (``csrc/ssd_scan_bwd.cu``, four CUDA kernels a
   call: C Bᵀ, the states and dh per row over the chunks, the main pass
   per row and chunk on the tensor cores in 3xTF32, the sums over chunks
   and rows) against autograd through the plain scan at
   the training shapes of ``mamba2_370m`` (the same as phase 4's), at a
   ragged 4,000 whose 96 pad rows (dt, x, B, C and dy 0) must get exactly
   0 gradients, and at jamba's group shape (``ds`` 16, 128 heads of 64 in
   one group): each of dx, ddt, dA, dB and dC within the forward's
   tolerance, or, where summation order alone breaks it, at most twice
   the float32 plain version's error to a float64 plain version (both
   printed); the states entering the chunks and dh leaving them against
   the plain mirror of the stages; two calls equal bit for bit; times,
   the bound from the FLOPs and bytes at the TF32 rate of the tensor cores
   it uses (and at the fp32 rate), each kernel's device time, shared
   memory and blocks per SM;
5. route-rate-drain kernel against its plain version, bit for bit (NaN
   where the plain version has NaN): random routes at the paper's 1D and
   2D shapes (almost no -1 in them), the engine's padded rows, and NaN
   shares and remaining bytes (``tests/test_torch_router_tick_cuda.py``);
   times and the byte bound;
6. the two engine goldens of ``tests/data_engine_golden.json`` on the card,
   each through the engine's ``run`` (replays of a captured CUDA graph)
   and through an eager loop of ``tick``;
7. the paper-scale simulator on the 1D dragonfly (Table II, 8,448 nodes;
   workload1 + UR, 65,536-message pool) through ``run_sim`` (graph
   replays) with the launch counts set to 0 just before and read just
   after: the wrappers count while a graph is captured, so a run's
   launches are its replays times its graph's captured launches, and the
   drain tick's and link demand's must equal the ticks run; the rate is
   virtual milliseconds simulated per wall second (a tick's virtual time
   varies with the idle-time skip, and liveness is read once per 64
   ticks, so drain calls are not simulated work), with the graph's
   capture and instantiate seconds and the replays' device ms a tick
   (CUDA events); then an eager loop of ``tick`` from the same seed: at
   sampled ticks, the drain kernel against the plain version on the live
   pool, and the link demand and UGAL route choices on the card against
   the CPU's, bit for bit, and the drain tick's and link demand's device
   times on that pool (``live_ms``); the route-rate-drain on that pool
   with the share table of its state, against its plain version, and its
   device time there (``live_ms``, 0 launches counted: no path calls it);
   a profile of 20 eager ticks (device time by kernel, the device's busy
   share, each wrapper's device time and operations a tick); the eager
   loop's end state must have a graph run's integer-trajectory and pool
   digests and float sums within rtol 1e-5; the graph replays of the last
   chunk under the profiler (busy share); the first 128 eager ticks on
   the card and on the port's CPU path with equal digests every 64 ticks;
8. ``paper_1d_members``: four members of one batch at the 1D paper scale
   to 5 ms (seeds 0-3 with their own placements; member 2 with slowed ranks,
   member 3 with 2 % of the fabric links dead), each equal (digests) to
   its own B = 1 run; member-virtual-ms per wall s, device ms a tick and
   peak device memory at B = 1, 4 and 8;
   ``paper_1d_observed``: the 1D run to 2 ms with the histograms and
   probes compiled in: its plain leaves have the plain run's digests,
   its histogram and probe counts are consistent; the observers' device
   ms a tick;
   ``paper_1d_trace``: the online scheduler on the 1D paper system, a
   16-job Poisson trace of the paper's Table III applications at their
   paper rank counts (4 slots, horizon 20 ms), each window replays of a
   captured graph: ``run_trace`` under FCFS and EASY, ``run_trace_batch``
   over FCFS, EASY and EASY with 2 % of the links down from 5 to 12 ms,
   and that cell alone; batched cells equal their own runs (records and
   final-state digests), the first 3 windows of the EASY cell equal eager
   ticks under the stop rule, the drain tick's and link demand's launches
   equal the ticks replayed (and a profile of the first window's replays
   finds each of their 8 kernels once a tick), at least 4 jobs complete
   and a slot is recycled; windows, jobs, no-op ticks, replay device ms a
   tick, host ms a window, capture seconds and peak memory of each run;
   ``paper_1d_experiment``: the experiment facade (``union.run``) on one
   study at the 1D paper scale: workload1 to 10 ms under placements RN
   and RG, 2 members, healthy and with 2 % of the links down from 3 to
   7 ms (one batched node of 8 cells: a stacked graph ``run`` and
   ``run_window`` rounds), and the trace cut to 10 ms under FCFS and EASY
   crossed with the same failures (one lock-step node of 4 cells),
   against a store in a temporary directory, the launch counts set to 0
   before and read after: healthy cells equal their members run alone
   and trace cells their cells alone (integers exact, floats bit for
   bit), launches equal the ticks replayed, a rerun from the store
   executes 0 cells, ``Results.save``/``load`` keep the cells; the
   study's and each node kind's wall s, member-virtual-ms and jobs per
   wall s, the host share outside the replays, engine-cache hits and
   builds, peak memory, the plan, ``format_results`` and the outage's
   interference matrix;
   ``member_split``: the facade on workload1 at the 1D paper scale, 4
   members (seeds 0-3) to 2 ms, with the device list of a one-card host
   (one stacked B = 4 run), then with ``local_devices`` patched to
   ``[cuda:0, cuda:0]`` (two B = 2 replicas through ``Engine.prun``, in
   turn), then over the real cards where there are several: each split
   cell's report equal to the stacked one's (report fields and integers
   exact, other floats to rtol 1e-5; how many leaves came out bit for
   bit), the drain tick's and link demand's launches equal their calls
   and the ticks on every replica; each run's wall and
   member-virtual-ms per wall s;
   ``paper_fabrics``: workload1 + UR to 2 ms on the paper fat tree (k =
   32, 8,192 hosts, route width 6) and the paper torus (11 x 12 x 16 x 4,
   8,448 hosts, route width 21), each as in 7 (its line per fabric): the
   drain tick's and link demand's launches equal the ticks replayed, the
   graph run's digests equal the eager loop's, the live pool's kernels
   against their plain versions (and both timed there), the first 64
   eager ticks equal to the CPU path's;
   ``union_front_doors``: the CLI's ``main(argv)`` on a three-member
   campaign of a tiny scenario, then the Union server on ``127.0.0.1``
   with one submission through the client and one cancellation; the
   CLI's result file and the server's Results equal ``union.run`` of the
   same spec; the seconds of each;
   then the paper-scale 2D dragonfly (workload3) as in 7, shorter (in
   7 and here the injection kernel's launches equal the ticks; on the
   fat tree and the torus it is never called);
   ``inject``: the injection kernel alone on both paper dragonflies'
   live pools (tick 10, batches of 1 and 8 copies of the member), its
   recorded arguments of the next tick and the same tick with every job
   candidate emitted: every written pool leaf and the tally of
   candidates seen and routed equal to the plain version's on the card,
   the peak's difference as ``max_abs_err``, the kernel's device time as
   a graph of 20
   calls beside the byte bound, the plain version's time;
9. Mamba-2 370M at full width (48 layers, seeded random weights, float32
   weights, bfloat16 compute) through ``make_prefill_step`` on 8 requests
   x 4,096 tokens, counted like the simulator: prefill tokens per second,
   peak device memory, one scan launch per layer and step; then the
   chunked forward's greedy tokens against token-by-token decode on
   2 x 64 tokens, at least 95 % equal in float32 (and the bfloat16 figure);
10. the port's serve loop (4 slots, 8 requests, prompt 16, 24 generated
   tokens): served tokens, decode tokens per second; a profile of one
   decode step;
11. ``lm_prefill_dense``: ``mistral_nemo_12b`` at full width and depth
   (40 layers, 12.2 B float32 weights from seed 0, bfloat16 compute)
   through ``make_prefill_step`` on 2 requests x 4,096 tokens, counted
   like phase 9 (every count 0: no hand-written kernel is on this path):
   step seconds, prefill tokens per second, peak device memory, a
   profile of one step (busy share, kernels, the top 10) and the step's
   time by part (attention, MLP, MoE, Mamba-2: CUDA events around each
   call, ``part_ms``); forward against decode at
   least 95 % equal in float32 over 2 x 64 tokens (and the bfloat16
   figure);
12. ``lm_serve_dense``: the same model through the serve loop as in 10;
13. ``lm_families``: the six other decoder-only architectures at full
   width, depth cut (``FAMILIES``): one counted prefill of one request
   (4,096 tokens; 6,144 for ``mixtral_8x22b``, past its 4,096-key
   window), its profile (the top 5) and time by part, forward against
   decode at least 95 % equal in float32 over
   2 x 64 tokens at a MoE capacity factor of E/k (where no token drops;
   the figure at the config's factor is printed too), a serve of 4
   requests (prompt 8, 8 generated), each one's weights freed before the
   next; ``jamba_v01_52b``'s scan launches equal its calls (7 Mamba
   layers) and the kernel holds to its plain version on its first Mamba
   layer's input (``ds`` 16, 128 heads of 64);
14. ``lm_encdec``: ``whisper_medium`` (24 encoder and 24 decoder layers,
   1,500 frames) and ``internvl2_1b`` (24 layers, 256 patches) at full
   width and depth, random float32 weights from seed 0, bfloat16
   compute: a counted batched ``make_prefill_step`` with random frame or
   patch embeddings (4 x 448 and 4 x (256 + 1,024) tokens; no
   hand-written kernel is on this path, so every count stays 0), its
   profile and time by part (encoder, cross-attention, self-attention,
   MLP); whisper's ``prefill`` with the cross K/V cache, then decode; the
   serve loop (4 slots, 8 requests, prompt 16, 24 generated; whisper with
   each request's frames); forward against decode at least 95 % equal in
   float32 over 2 x 64 tokens (whisper's biases at their initial zeros,
   where the reference's cross K/V cache, which leaves them out, agrees
   with its forward);
15. ``lm_train``: ``mamba2_370m`` at full width and depth (48 layers,
   remat, AdamW) through ``repro_torch.launch.train``'s step function on
   its ``host_batch`` data (8 x 4,096 tokens a step), 5 steps with the
   counts set to 0 before and read after: each step's loss finite and
   the fifth's below the first's, the backward kernel 48 launches for 48
   calls a step; a checkpoint of step 5 saved, restored into a fresh
   state and stepped, bit for bit the uninterrupted sixth step (profiled);
   a step at accum=2; then ``whisper_medium`` at full width, 3 steps of 4
   x 448 tokens with 1,500 random frames; s a step, tokens/s, peak MiB;
16. ``lm_train_mesh``: ``mamba2_370m`` at full width and depth, 2 steps
   of 8 x 4,096 tokens unsharded, then on the (1, 1) smoke mesh of a
   one-rank NCCL process group (its store a file in a temporary
   directory): parameters and moments DTensors placed by
   ``cell_shardings``, the step under the sharding constraints, the scan
   running each rank's rows through ``local_map``; the counts set to 0
   before and read after (48 backward launches for 48 calls a step), the
   loss and every parameter and moment bit for bit the unsharded steps
   (else the largest difference, within 1e-4), s a step beside the
   unsharded one's; the group destroyed at the end;
17. ``dryrun_hybrid``: the port's dry run of ``mistral_nemo_12b`` /
   ``train_4k`` / ``single`` (256 fake ranks on meta tensors, started as
   a subprocess right after the build, in a temporary directory, so that
   it traces on the host while the card runs the phases above): its
   ``flops_per_device`` and ``analysis.per_period.flops`` within 10 % of
   the reference's record of the cell (constants written on the CPU),
   its roofline terms against the H100's rates, its collectives by kind,
   its wall s; then its ``hlo:`` job at 128 ranks co-run with ``milc`` on
   the small 1D dragonfly through ``union.manager`` on the card (graph
   replays), the horizon cut to the ML job's first compute segment plus
   5 ms: both jobs deliver, the drain tick's and link demand's launches
   equal their calls and the ticks;
18. the kernel summary line (each kernel's launches as read in the counted
   windows, the simulator kernels' also on the trace's windows, the
   facade's run and the two paper fabrics, with their device ms on each
   fabric's live pool, the SSD scan's also on ``lm_families``, its
   backward's on ``lm_train``'s 5 steps, both on ``lm_train_mesh``'s
   (``mesh_launches``), the simulator kernels' on the co-run
   (``hybrid_launches``) and on ``member_split``'s two replicas
   (``split_launches``); its largest error against its plain version),
   then the result line.

Where a phase counts a kernel's runs in a profile, a profile short of
runs is taken again on the same inputs, up to three in all (CUPTI drops
activity records when thousands of kernels a tick fill its device
buffer); the phase line lists each short profile's missing runs under
``short_profiles``, and a shortfall in all three, or one run too many,
fails.

Imports nothing of JAX or of the JAX package (``src/repro``); the card
tests' input generators come from ``tests/test_torch_*_cuda.py``, which
import no JAX either.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "data_engine_golden.json")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense

PAPER_1D = dict(workload="workload1", topo="1d", scale="paper",
                horizon_ms=10.0)
PAPER_2D = dict(workload="workload3", topo="2d", scale="paper",
                horizon_ms=6.0)
# workload1 + UR on the other two paper fabrics (route widths 6 and 21)
PAPER_FABRICS = (
    dict(workload="workload1", topo="fat_tree", scale="paper",
         horizon_ms=2.0),
    dict(workload="workload1", topo="torus", scale="paper", horizon_ms=2.0),
)
# ticks of each paper run compared between the card and the CPU path
CARD_VS_CPU_TICKS = 128
FABRIC_CARD_VS_CPU_TICKS = 64
KERNEL_SOURCES = ("drain_tick", "link_demand", "router_tick", "ssd_scan",
                  "ssd_scan_bwd", "inject")
# the SSD kernel's tolerance against its plain version: an output sums
# Q * ds = 16,384 float32 products whose partial sums are as large as the
# largest output, so rounding error scales with max|plain|
SSD_RTOL, SSD_ATOL_OF_MAX = 1e-4, 1e-5
# the two CUDA kernels of one ssd_scan call, as the profiler names them
SSD_KERNELS = ("ssd_scan_cb_kernel", "ssd_scan_kernel")
# every device operation of one call of the simulator's two wrappers
WRAPPER_KERNELS = {
    "drain_tick": ("drain_zero_kernel", "drain_count_kernel", "drain_kernel"),
    "link_demand": ("link_zero_kernel", "link_count_kernel",
                    "link_alloc_kernel", "link_place_kernel",
                    "link_fold_kernel"),
}
LM_ARCH = "mamba2_370m"
DENSE_ARCH = "mistral_nemo_12b"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def need(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def drain_inputs(B, M, K, Lp, A, R, seed, per_member, dev):
    """numpy-seeded drain-tick inputs at the given shapes, on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    L = Lp - 1
    routes = rng.integers(-1, L, size=(B, M, K), dtype=np.int32)
    rem = (rng.random((B, M), dtype=np.float32) * 1e5).astype(np.float32)
    act = rng.random((B, M)) < 0.5
    job = rng.integers(0, A, size=(B, M), dtype=np.int32)
    mina = (rng.random((B, M), dtype=np.float32) * 10.0).astype(np.float32)
    t = np.linspace(4.0, 9.0, B).astype(np.float32)
    bw = np.concatenate([
        (rng.random(L, dtype=np.float32) * 16e9 + 1e9).astype(np.float32),
        np.ones(1, np.float32)])
    if per_member:
        factor = np.where(rng.random((B, L)) < 0.15, 0.0,
                          rng.random((B, L)) * 0.9 + 0.1).astype(np.float32)
        bw = np.concatenate(
            [bw[None, :L] * factor, np.ones((B, 1), np.float32)], axis=1)
    ldr = np.concatenate(
        [rng.integers(0, R, size=L, dtype=np.int32), np.zeros(1, np.int32)])

    def d(x):
        return torch.as_tensor(x, device=dev)

    return (d(routes), d(rem), d(act), d(job), d(mina), d(t), 5.0,
            d(bw.astype(np.float32)), d(ldr))


def compare_drain(args, n_apps, n_routers):
    """Kernel vs plain on the same inputs: exact where the arithmetic is
    element-wise, rtol 1e-5 on the atomically summed byte deltas. Returns
    the largest absolute difference over all outputs."""
    import torch

    from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain

    k = drain_tick_cuda(*args, n_apps, n_routers)
    p = drain_tick_plain(*args, n_apps, n_routers)
    torch.cuda.synchronize()
    for name, a, b in zip(("new_rem", "rate", "delivered"), k[:3], p[:3]):
        need(torch.equal(a, b), f"drain_tick {name}: kernel != plain")
    for name, a, b in zip(("link_bytes_delta", "router_win_delta"),
                          k[3:], p[3:]):
        need(torch.allclose(a, b, rtol=1e-5, atol=0.0),
             f"drain_tick {name}: kernel vs plain beyond rtol 1e-5 "
             f"(max abs diff {float((a - b).abs().max())})")
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(k, p))


def time_ms(fn, reps=20, warmup=3):
    """Median milliseconds of one ``fn`` call over ``reps`` CUDA-event
    timings: host launch cost included, so a short kernel reads long."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps=20, calls=20):
    """Median device milliseconds of one ``fn`` call: ``calls`` calls are
    captured in one CUDA graph and each replay is timed with CUDA events,
    so the host's launch cost does not enter."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def drain_bound_ms(args, n_apps, n_routers):
    """The least time for one drain tick: every input read once and every
    output written once at the HBM rate, against a few float operations per
    route entry at the float32 rate; the larger of the two."""
    routes, rem, act, job, mina, t, _dt, bw, ldr = args
    B, M, K = routes.shape
    Lp = bw.shape[-1]
    moved = sum(x.numel() * x.element_size()
                for x in (routes, rem, act, job, mina, t, bw, ldr))
    moved += B * M * (4 + 4 + 1) + B * Lp * 4 + B * n_apps * n_routers * 4
    ops = B * M * K * 6  # divide, multiply, min, two adds, compare
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), moved


def phase_kernel(dev):
    """The drain tick at the paper's shapes (above), then the hard cases of
    ``tests/test_torch_drain_tick_cuda.py`` (one hot link, no active
    message, an empty pool, a ragged pool, -1 between valid links, three
    members with their own bandwidth rows, a router-window table too large
    for shared memory, NaN bandwidths, NaN remaining bytes): new_rem, rate
    and delivered bit for bit (NaN where the plain version has NaN), the
    byte deltas to rtol 1e-5 of their float64 sums, NaN where those are
    (one entry takes up to 300,000 equal adds there, and the plain
    version's float32 sums, in their own order, are up to about 1e-4 off;
    both errors are printed)."""
    import torch

    from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain
    from test_torch_drain_tick_cuda import HARD as DRAIN_HARD
    from test_torch_drain_tick_cuda import _args as _drain_args
    from test_torch_drain_tick_cuda import _hard_inputs as _drain_hard_inputs
    from test_torch_drain_tick_cuda import float64_deltas
    from test_torch_router_tick_cuda import same_bits

    t0 = time.perf_counter()
    cases = [
        # B, M, Lp, n_apps, R, per-member bw   (paper 1D / 2D shapes)
        (1, 65536, 53857, 5, 1056, False),
        (1, 65573, 73921, 5, 2112, False),
        (3, 65536, 53857, 5, 1056, True),
        (3, 65573, 73921, 5, 2112, True),
    ]
    rows = []
    max_err = 0.0
    for i, (B, M, Lp, A, R, per_member) in enumerate(cases):
        args = drain_inputs(B, M, 10, Lp, A, R, 100 + i, per_member, dev)
        err = compare_drain(args, A, R)
        max_err = max(max_err, err)
        row = dict(B=B, M=M, Lp=Lp, per_member_bw=per_member,
                   max_abs_err=err)
        if B == 1:
            row["kernel_ms"] = device_ms(lambda: drain_tick_cuda(*args, A, R))
            row["kernel_call_ms"] = time_ms(
                lambda: drain_tick_cuda(*args, A, R))
            row["plain_ms"] = time_ms(lambda: drain_tick_plain(*args, A, R))
            row["bound_ms"], row["bound_by"], row["bytes"] = drain_bound_ms(
                args, A, R)
        rows.append(row)
    hard = []
    for case, (B, M, L, A, R, per_member) in sorted(DRAIN_HARD.items()):
        args = _drain_args(_drain_hard_inputs(case, B, M, L, A, R,
                                              per_member), dev)
        k = drain_tick_cuda(*args, A, R)
        p = drain_tick_plain(*args, A, R)
        torch.cuda.synchronize()
        for name, a, b in zip(("new_rem", "rate", "delivered"), k, p):
            need(same_bits(a, b), f"drain_tick {case} {name}: kernel != "
                 "plain")
        rel = {}
        for name, a, b, c in zip(("link_bytes_delta", "router_win_delta"),
                                 k[3:], p[3:], float64_deltas(args, k[1], A,
                                                              R)):
            a, b = a.cpu().double(), b.cpu().double()
            need(torch.allclose(a, c, rtol=1e-5, atol=0.0, equal_nan=True),
                 f"drain_tick {case} {name}: kernel vs float64 sums beyond "
                 f"rtol 1e-5")
            num = ~torch.isnan(c)  # NaN sums are held by position above
            a, b, c = a[num], b[num], c[num]
            scale = c.abs().clamp(min=1e-30)
            rel[name] = dict(kernel=float(((a - c).abs() / scale).max()),
                             plain=float(((b - c).abs() / scale).max()))
        hard.append(dict(case=case, B=B, M=M, Lp=L + 1, n_apps=A,
                         routers=R, exact=True,
                         max_rel_err_vs_float64_sums=rel))
    emit(dict(phase="kernel_vs_plain", seconds=time.perf_counter() - t0,
              cases=rows, hard_cases=hard))
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 3: the link-demand kernel against its plain version
# ---------------------------------------------------------------------------

def link_demand_inputs(M, L, seed):
    """numpy-seeded link-demand inputs on the CPU (one member): 10 route
    slots, a tenth
    of the entries on 8 hot links (runs of about 4,000 active entries at
    M = 65,536), half the messages active, remaining bytes over six orders
    of magnitude."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    routes = np.where(rng.random((1, M, 10)) < 0.1,
                      rng.integers(0, 8, size=(1, M, 10)),
                      rng.integers(-1, L, size=(1, M, 10))).astype(np.int32)
    return [torch.as_tensor(a) for a in (
        routes, rng.random((1, M)) < 0.5,
        (10.0 ** rng.uniform(0, 6, (1, M))).astype(np.float32))]


def phase_link_demand(dev):
    """The link-demand kernel at the paper's pool and link shapes against
    its plain version on a CPU copy (serial sums there), bit for bit; the
    remaining bytes span six orders of magnitude so that another order
    shows. Times: the kernel (its five launches, no library call) and the plain
    version on the card by CUDA events, and ``index_put_(accumulate=True)``
    over the flat entries as the one library call that takes these sums
    (in another order); the bound is the bytes the call must move. Counts
    the sums that the plain version on the card (``index_add_``, atomics)
    and that library call give with other bits than the serial sums. Then
    the hard cases of ``tests/test_torch_link_demand_cuda.py`` (one bucket
    of most entries, no active message, an empty pool, a ragged pool, -1
    between valid links, three members, about 100 entries on every link),
    bit for bit."""
    import torch

    from repro_torch.kernels.link_demand import (
        link_demand_cuda, link_demand_plain)
    from test_torch_link_demand_cuda import HARD, _hard_inputs, _on

    t0 = time.perf_counter()
    hard = []
    for case, (B, M, L) in sorted(HARD.items()):
        x = _hard_inputs(case, B, M, L)
        got = link_demand_cuda(*_on(x, dev), L).cpu()
        want = link_demand_plain(*_on(x, "cpu"), L)
        need(torch.equal(got.view(torch.int32), want.view(torch.int32)),
             f"link_demand {case}: kernel != serial plain sums")
        hard.append(dict(case=case, B=B, M=M, L=L, exact=True,
                         max_abs_err=float((got - want).abs().max())))
    rows = []
    for i, (M, L) in enumerate(((65536, 53856), (65573, 73920))):
        host = link_demand_inputs(M, L, 300 + i)
        args = [a.to(dev) for a in host]
        got = link_demand_cuda(*args, L)
        want = link_demand_plain(*host, L)
        torch.cuda.synchronize()
        need(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
             f"link_demand: kernel != serial plain sums at M={M}, L={L}")
        on_card_plain = link_demand_plain(*args, L).cpu()
        flat = (torch.where(args[0] >= 0, args[0], L).long()
                .reshape(-1))
        vals = (args[2][:, :, None] * ((args[0] >= 0) & args[1][:, :, None])
                ).reshape(-1)

        def library():
            return torch.zeros(L + 1, device=dev).index_put_(
                (flat,), vals, accumulate=True)

        def differing(x):  # sums that are not the serial sums' bits
            return int((x.cpu().reshape(-1).view(torch.int32)
                        != want.reshape(-1).view(torch.int32)).sum())

        moved = sum(a.numel() * a.element_size() for a in args) + (L + 1) * 4
        rows.append(dict(
            M=M, L=L, exact=True,
            max_abs_err=float((got.cpu() - want).abs().max()),
            # the plain version on the card takes index_add_ (atomics)
            index_add_on_card_sums_differing=differing(on_card_plain),
            index_put_on_card_sums_differing=differing(library()),
            kernel_ms=device_ms(lambda: link_demand_cuda(*args, L)),
            kernel_call_ms=time_ms(lambda: link_demand_cuda(*args, L)),
            plain_ms=time_ms(lambda: link_demand_plain(*args, L)),
            library_ms=time_ms(library),
            bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=moved))
    emit(dict(phase="link_demand_vs_plain", seconds=time.perf_counter() - t0,
              cases=rows, hard_cases=hard))
    return rows + hard

# ---------------------------------------------------------------------------
# phase 4: the SSD chunk scan against its plain version
# ---------------------------------------------------------------------------

def ssd_inputs(BH, G, nc, Q, hd, ds, seed, dev):
    """numpy-seeded scan inputs: x ~ N(0,1), dt = softplus(N(0,1) - 2),
    A = -exp(N(0,1)), B and C ~ N(0,1) for G groups of rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32
    xs = (rng.standard_normal((BH, nc, Q, hd)).astype(f32),
          np.log1p(np.exp(rng.standard_normal((BH, nc, Q)) - 2.0)).astype(f32),
          (-np.exp(rng.standard_normal(BH))).astype(f32),
          rng.standard_normal((G, nc, Q, ds)).astype(f32),
          rng.standard_normal((G, nc, Q, ds)).astype(f32))
    return [torch.as_tensor(x, device=dev) for x in xs]


def ssd_check(got, want, what):
    """|got - want| <= SSD_RTOL |want| + SSD_ATOL_OF_MAX max|want|; returns
    the largest absolute difference."""
    scale = float(want.abs().max())
    err = (got - want).abs()
    ok = bool((err <= SSD_RTOL * want.abs() + SSD_ATOL_OF_MAX * scale).all())
    need(ok and bool(got.isfinite().all()),
         f"ssd_scan {what}: kernel vs plain beyond rtol {SSD_RTOL} + "
         f"{SSD_ATOL_OF_MAX} * {scale} (max abs diff {float(err.max())})")
    return float(err.max())


def ssd_bound_ms(x, Bm):
    """The least time for one scan: the causal half of C Bᵀ once per group
    and chunk, the causal half of its product with x·dt, C h and the state
    update per row and chunk, at the float32 rate (no tensor cores), against
    each input read once and y and h written once; the larger of the two."""
    BH, nc, Q, hd = x.shape
    G, ds = Bm.shape[0], Bm.shape[-1]
    tri = Q * (Q + 1) // 2
    flops = (G * nc * tri * 2 * ds
             + BH * nc * (tri * 2 * hd + 2 * Q * 2 * ds * hd))
    moved = 4 * (2 * BH * nc * Q * hd + BH * nc * Q + BH
                 + 2 * G * nc * Q * ds + BH * ds * hd)
    by_ops = flops / FP32_OPS_PER_S * 1e3
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes
            else "bytes", flops, moved)


def phase_ssd(dev, B=8, nh=32, hd=64, ds=128, Q=128, S=4096, Sr=4000):
    """The defaults are the prefill step's shapes: 8 requests x 32 heads,
    4,096 tokens; ``Sr`` is the ragged length."""
    import torch

    from repro_torch.kernels.ssd_scan import (
        ssd_scan_cuda, ssd_scan_occupancy, ssd_scan_plain)
    from repro_torch.models.mamba2 import ssd_chunked

    t0 = time.perf_counter()
    args = ssd_inputs(B * nh, B, S // Q, Q, hd, ds, 7, dev)
    yk, hk = ssd_scan_cuda(*args)
    yp, hp = ssd_scan_plain(*args)
    torch.cuda.synchronize()
    err_y = ssd_check(yk, yp, "y")
    err_h = ssd_check(hk, hp, "h")
    del yk, hk, yp, hp
    kernel_ms = time_ms(lambda: ssd_scan_cuda(*args), reps=10, warmup=2)
    plain_ms = time_ms(lambda: ssd_scan_plain(*args), reps=5, warmup=1)
    bound_ms, bound_by, flops, moved = ssd_bound_ms(args[0], args[3])
    _, _, rows = device_profile(lambda: ssd_scan_cuda(*args))
    kernel_device_ms = {name: sum(r[0] for r in rows if name in r[2]) / 1e3
                        for name in SSD_KERNELS}

    # a ragged length through the mixer's padding (4,000 -> 32 chunks of
    # 128, the last one padded with dt = 0): all 8 rows on the card, batch
    # row 0 against the plain scan on the CPU
    import numpy as np

    rng = np.random.default_rng(8)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((B, Sr, nh)) - 2.0))
    raw = (rng.standard_normal((B, Sr, nh, hd)).astype(f32), dt.astype(f32),
           (-np.exp(rng.standard_normal(nh))).astype(f32),
           rng.standard_normal((B, Sr, ds)).astype(f32),
           rng.standard_normal((B, Sr, ds)).astype(f32),
           rng.standard_normal(nh).astype(f32))
    on = [torch.as_tensor(a, device=dev) for a in raw]
    yr = ssd_chunked(*on, chunk=Q)
    torch.cuda.synchronize()
    cpu0 = [torch.as_tensor(a[:1] if a.ndim > 1 else a) for a in raw]
    want = ssd_chunked(*cpu0, chunk=Q)
    need(tuple(yr.shape) == (B, Sr, nh, hd), f"ssd_chunked shape {yr.shape}")
    err_r = ssd_check(yr[:1].cpu(), want, f"ragged S={Sr}")
    emit(dict(phase="ssd_scan_vs_plain", seconds=time.perf_counter() - t0,
              BH=B * nh, groups=B, nc=S // Q, Q=Q, hd=hd, ds=ds,
              max_abs_err_y=err_y, max_abs_err_h=err_h,
              max_abs_err_ragged=err_r, ragged_S=Sr,
              rtol=SSD_RTOL, atol_of_max=SSD_ATOL_OF_MAX,
              kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by, gflop=flops / 1e9, bytes=moved,
              tflop_per_s=flops / 1e9 / kernel_ms,
              share_of_bound=bound_ms / kernel_ms,
              kernel_device_ms=kernel_device_ms,
              occupancy=ssd_scan_occupancy(Q, hd, ds)))
    return dict(max_abs_err=max(err_y, err_h, err_r), ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 5: the route-rate-drain against its plain version
# ---------------------------------------------------------------------------

def router_bound_ms(args):
    """The least time for one route-rate-drain: routes, flags, remaining
    bytes and the share table read once, new_rem, rate and drained
    written once, at the HBM rate (one compare per route entry is far
    below the float32 rate)."""
    M = args[0].shape[0]
    moved = sum(a.numel() * a.element_size() for a in args) + M * 9
    return moved / HBM_BYTES_PER_S * 1e3, moved


def router_cases(dev):
    """phase 5's labelled inputs, each (routes, bytes_rem, active, share)
    on ``dev``: ``random_1d`` and ``random_2d`` (routes drawn from
    [-1, L), so about one entry in 54,000 is a pad: the kernel row's case
    is random_1d), ``padded_rows_1d`` (random_1d with the card tests' rows
    of 4-8 links and 2-6 pads, as the engine's routes are padded), and
    ``nan_share_1d`` / ``nan_bytes_rem_1d`` (the card tests' cases: 2 % of
    the shares, 1 % of the remaining bytes NaN)."""
    import numpy as np
    import torch

    from test_torch_router_tick_cuda import _edge_inputs, _on, padded_routes

    def random_args(M, L, seed):
        rng = np.random.default_rng(seed)
        return [torch.as_tensor(a, device=dev) for a in (
            rng.integers(-1, L, size=(M, 10), dtype=np.int32),
            (rng.random(M, dtype=np.float32) * 1e5).astype(np.float32),
            rng.random(M) < 0.5,
            (rng.random(L, dtype=np.float32) * 1e3 + 1.0).astype(np.float32))]

    cases = {"random_1d": random_args(65536, 53857, 200),
             "random_2d": random_args(65573, 73921, 201)}
    cases["padded_rows_1d"] = [torch.as_tensor(padded_routes(
        65536, 10, 53857, np.random.default_rng(202)), device=dev)
    ] + cases["random_1d"][1:]
    for case in ("nan_share", "nan_bytes_rem"):
        cases[f"{case}_1d"] = _on(_edge_inputs(case, 65536, 10, 53856), dev)
    return cases


def phase_router(dev):
    """The route-rate-drain against its plain version on ``router_cases``,
    bit for bit (NaN where the plain version has NaN); device and call
    times, the plain version's time and the byte bound for each."""
    import torch

    from repro_torch.kernels.router_tick import (
        router_rate_drain_cuda, router_rate_drain_plain)
    from test_torch_router_tick_cuda import same_bits

    t0 = time.perf_counter()
    rows = []
    for case, args in router_cases(dev).items():
        k = router_rate_drain_cuda(*args, 5.0)
        p = router_rate_drain_plain(*args, 5.0)
        torch.cuda.synchronize()
        for name, a, b in zip(("new_rem", "rate", "drained"), k, p):
            need(same_bits(a, b),
                 f"router_rate_drain {case} {name}: kernel != plain")
        routes, _, active, share = args
        bound_ms, moved = router_bound_ms(args)
        rows.append(dict(
            case=case, M=routes.shape[0], L=share.shape[0],
            active=int(active.sum()),
            pad_entries=int((routes < 0).sum()),
            nan=int(torch.isnan(share).sum() + torch.isnan(args[1]).sum()),
            max_abs_err=max(float((a.float() - b.float()).abs().nan_to_num()
                                  .max()) for a, b in zip(k, p)),
            kernel_ms=device_ms(lambda: router_rate_drain_cuda(*args, 5.0)),
            kernel_call_ms=time_ms(lambda: router_rate_drain_cuda(*args, 5.0)),
            plain_ms=time_ms(lambda: router_rate_drain_plain(*args, 5.0)),
            bound_ms=bound_ms, bound_by="bytes", bytes=moved))
    emit(dict(phase="router_rate_drain_vs_plain",
              seconds=time.perf_counter() - t0, exact=True, cases=rows))
    return rows


def live_router_args(st, rs, dev):
    """The route-rate-drain's inputs for a live member state: its pool and
    the share table of that state, ``bw_run / max(n, 1) * 1e-6`` with n
    the active route entries on each link (plain PyTorch operations, the
    drain tick's arithmetic)."""
    import torch

    bw_run = live_drain_args(st, rs, dev)[7][0]
    p = st.pool
    valid = (p.routes >= 0) & p.active[:, None]
    n = torch.bincount(p.routes[valid].long(), minlength=bw_run.shape[0])
    share = bw_run / torch.clamp(n.to(torch.float32), min=1.0) * 1e-6
    return [p.routes, p.bytes_rem, p.active, share], float(rs.net.tick_us)


# ---------------------------------------------------------------------------
# phase 6: engine goldens on the card
# ---------------------------------------------------------------------------

def check_golden(st, rs, g):
    """The contract of tests/test_engine_equivalence.py: the integer
    trajectory exact, float sums to rtol 1e-5."""
    import numpy as np

    from repro_torch.netsim.engine import job_vm
    from repro_torch.netsim.state_io import state_to_numpy

    st = state_to_numpy(st)
    m = st.metrics
    need(float(st.t) == g["t"], f"t {float(st.t)} != {g['t']}")
    need(int(st.rng) == g["rng"], f"rng {int(st.rng)} != {g['rng']}")
    need(int(st.pool.dropped) == g["dropped"], "dropped")
    need(int(st.pool.free_top) == g["free_top"], "free_top")
    need(int(m.win_idx) == g["win_idx"], "win_idx")
    need(m.lat_cnt.tolist() == g["lat_cnt"], "lat_cnt")
    need(m.lat_hist.sum(1).tolist() == g["lat_hist_sum"], "lat_hist sums")
    close = np.testing.assert_allclose
    close(float(m.peak_inject), g["peak_inject"], rtol=1e-6)
    close(m.lat_sum, g["lat_sum"], rtol=1e-5)
    close(m.lat_min, g["lat_min"], rtol=1e-5)
    close(m.lat_max, g["lat_max"], rtol=1e-5)
    close(float(m.link_bytes.sum()), g["link_bytes_total"], rtol=1e-5)
    close(m.router_wins.sum(axis=(0, 2)), g["router_wins_total"], rtol=1e-5)
    for ji in range(len(rs.jobs)):
        vm = job_vm(st, ji)
        need(bool(vm.done.all()) == g[f"vm{ji}_done"], f"vm{ji} done")
        for f in ("send_done", "recv_done", "pc"):
            need(getattr(vm, f).tolist() == g[f"vm{ji}_{f}"], f"vm{ji} {f}")
        close(vm.comm_time, g[f"vm{ji}_comm_time"], rtol=1e-5)
    if st.ur is not None:
        need(st.ur.count.tolist() == g["ur_count"], "ur count")


def phase_goldens(dev):
    """Both engine goldens through the graph ``run`` and through an eager
    loop of ``tick`` (liveness read every 64 ticks, as ``run`` does), each
    held to the golden contract; then the report golden through
    ``run_scenario``."""
    import numpy as np

    from repro_torch.union import manager as MGR
    from repro_torch.union.seeds import engine_seed
    from test_torch_engine_graph_cuda import eager_run, golden_scenarios

    t0 = time.perf_counter()
    with open(GOLDEN) as f:
        golden = json.load(f)
    runs = {}
    for case, (sc, seed) in golden_scenarios().items():
        rs = MGR.resolve(sc, seed=seed)
        eng = MGR.build(rs, device=dev)
        check_golden(eng.run(eng.init_state(seed=engine_seed(seed))), rs,
                     golden[case]["state"])
        stats = eng.last_run
        need(stats.replays > 0 and stats.graph_launches["drain_tick"]
             == stats.graph_ticks, f"goldens {case}: the run replayed no "
             "graph of drain ticks")
        check_golden(eager_run(eng, eng.init_state(seed=engine_seed(seed)),
                               rs.horizon_us), rs, golden[case]["state"])
        runs[case] = dict(ticks=stats.ticks, graph_ticks=stats.graph_ticks,
                          replays=stats.replays)
    sc, seed = golden_scenarios()["equiv-mix"]
    rep = MGR._run_member(sc, seed=seed, device=dev)
    g = golden["equiv-mix"]
    need(rep["virtual_time_ms"] == g["report_virtual_time_ms"],
         "report virtual_time_ms")
    for app, want in g["report_latency"].items():
        got = rep["latency"][app]
        need(got["count"] == want["count"], f"report {app} count")
        if want["count"]:
            np.testing.assert_allclose(got["avg_us"], want["avg_us"], rtol=1e-5)
            np.testing.assert_allclose(got["max_us"], want["max_us"], rtol=1e-5)
    emit(dict(phase="goldens", seconds=time.perf_counter() - t0,
              cases=sorted(golden), graph_and_eager=True, runs=runs, ok=True))


# ---------------------------------------------------------------------------
# phases 7-8: paper-scale simulator
# ---------------------------------------------------------------------------

TRAJECTORY = ("t", "rng", "lat_cnt", "pc", "send_done", "recv_done",
              "dropped", "free_top", "win_idx")


def trajectory(st):
    from repro_torch.netsim.state_io import state_to_numpy

    s = state_to_numpy(st)
    return dict(t=s.t, rng=s.rng, lat_cnt=s.metrics.lat_cnt, pc=s.vms.pc,
                send_done=s.vms.send_done, recv_done=s.vms.recv_done,
                dropped=s.pool.dropped, free_top=s.pool.free_top,
                win_idx=s.metrics.win_idx)


def trajectory_digests(st):
    """sha256 of each integer-trajectory leaf and of the pool's routes,
    active flags and remaining-bytes bits, for one member state."""
    import hashlib

    import numpy as np

    from repro_torch.netsim.state_io import state_to_numpy

    s = state_to_numpy(st)
    leaves = dict(trajectory(st), routes=s.pool.routes, active=s.pool.active,
                  bytes_rem=s.pool.bytes_rem)
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in leaves.items()}


def card_vs_cpu(name, rs, eng, n=CARD_VS_CPU_TICKS, every=64):
    """The first ``n`` ticks of the scenario on the card and on the port's
    CPU path (``index_add_`` demand, the plain drain tick), from one
    seed: every ``every`` ticks the digests of ``trajectory_digests`` must
    be equal. The CPU path is the one the CPU lockstep tests hold to the
    JAX engine."""
    from repro_torch.union import manager as MGR
    from repro_torch.union.seeds import engine_seed

    t0 = time.perf_counter()
    cpu = MGR.build(rs, device="cpu")
    a = eng.init_state(seed=engine_seed(0))
    c = cpu.init_state(seed=engine_seed(0))
    cpu_s = 0.0
    checks = []
    for i in range(1, n + 1):
        a = eng.tick(a)
        t1 = time.perf_counter()
        c = cpu.tick(c)
        cpu_s += time.perf_counter() - t1
        if i % every == 0:
            da, dc = trajectory_digests(a), trajectory_digests(c)
            need(da == dc, f"{name}: after {i} ticks the card and the CPU "
                 f"differ in {sorted(k for k in da if da[k] != dc[k])}")
            checks.append(dict(tick=i, active=int(a.pool.active.sum()),
                               digest=da["bytes_rem"][:16]))
    return dict(ticks=n, every=every, checks=checks, equal=True,
                cpu_s_per_tick=cpu_s / n, seconds=time.perf_counter() - t0)


def live_drain_args(st, rs, dev):
    """The drain tick's inputs for a live member state, as the engine
    builds them."""
    import numpy as np
    import torch

    topo = rs.topo
    flt = st.faults
    src = torch.as_tensor(np.asarray(topo.link_src_router, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(topo.link_dst_router, np.int64), device=dev)
    eff = flt.link_bw_factor * flt.router_factor[src] * flt.router_factor[dst]
    bw = torch.as_tensor(np.asarray(topo.link_bw, np.float32), device=dev)
    bw_run = torch.cat([bw * eff, torch.ones(1, device=dev)])[None]
    ldr = torch.as_tensor(np.concatenate(
        [np.asarray(topo.link_dst_router, np.int32), np.zeros(1, np.int32)]),
        device=dev)
    p = st.pool
    return (p.routes[None], p.bytes_rem[None], p.active[None], p.job[None],
            p.min_arrive[None], st.t[None], float(rs.net.tick_us), bw_run,
            ldr)


def route_parity(st, rs, dev, seed, n=65536):
    """The link demand that UGAL compares and the routes it picks, on the
    card against the CPU, for a live member state: the link-demand kernel
    sums the pool on the card, its plain version sums a CPU copy serially
    in the reference's order, and ``n`` seeded (source, destination, rand)
    triples are routed adaptively against each side's demand. Demand sums
    must be equal bit for bit, routes and hop counts exactly. Returns what
    was compared."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim.fabric import routing_tables

    topo = rs.topo
    L = topo.n_links
    p = st.pool
    on_card = [x[None] for x in (p.routes, p.active, p.bytes_rem)]
    card = ops.link_demand(*on_card, L)  # the kernel
    host = ops.link_demand(*[x.cpu() for x in on_card], L)  # serial, CPU
    card_h = card.cpu()
    same = card_h.view(torch.int32) == host.view(torch.int32)
    need(bool(same.all()),
         f"link demand: {int((~same).sum())} of {same.numel()} sums differ "
         "between the card and the CPU")
    rng = np.random.default_rng(seed)
    src = rng.integers(0, topo.n_nodes, n, dtype=np.int64)
    dst = rng.integers(0, topo.n_nodes, n, dtype=np.int64)
    rand = rng.integers(0, 2**31, n, dtype=np.int64)
    out = {}
    for where, demand in (("card", card), ("cpu", host)):
        T, route_fn = routing_tables(topo, demand.device)
        on = [torch.as_tensor(a, device=demand.device)
              for a in (src, dst, rand)]
        routes, hops = route_fn(T, *on, demand.reshape(-1), True)
        minimal, _ = route_fn(T, *on, demand.reshape(-1), False)
        out[where] = (routes.cpu(), hops.cpu(), minimal.cpu())
    (rc, hc, mc), (rh, hh, _) = out["card"], out["cpu"]
    need(torch.equal(rc, rh) and torch.equal(hc, hh),
         f"UGAL routes: {int((rc != rh).any(1).sum())} of {n} differ between "
         "the card and the CPU")
    return dict(links_with_demand=int((host > 0).sum()), routed=n,
                nonminimal=int((rc != mc).any(1).sum()),
                demand_max_abs_err=float((card_h - host).abs().max()))


def device_profile(fn):
    """Run ``fn`` under torch.profiler (CUPTI): the wall microseconds and
    the device kernels as (self device us, calls, name), largest first.
    The profiler's own cost is in the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    return out, wall_us, rows


def kernel_named(key, name):
    """Whether a profiler key names the CUDA kernel ``name`` (a function
    of the port's sources, templated or not)."""
    return f"::{name}(" in key or f"::{name}<" in key


# profiles of one piece of work that may come out short of kernel runs
# before the shortfall fails (counted_profile)
PROFILE_TRIES = 3


def counted_profile(fn, want, what):
    """``device_profile(fn)`` in which every kernel of ``want()`` (a dict
    of kernel name to the runs it must show, read after ``fn``) shows
    exactly that many runs. CUPTI drops activity records when its device
    buffer fills faster than its thread empties it, and these profiles
    hold up to two thousand kernels a tick, so a profile short of runs is
    taken again on the same inputs, up to PROFILE_TRIES profiles: a kernel
    that the work does not run is short in every one. More runs than
    wanted fail at once. Returns ``fn``'s result, the wall microseconds,
    the rows, and the runs that each short profile missed."""
    short = []
    for _ in range(PROFILE_TRIES):
        out, wall_us, rows = device_profile(fn)
        runs = {k: (sum(r[1] for r in rows if kernel_named(r[2], k)), n)
                for k, n in want().items()}
        need(all(got <= n for got, n in runs.values()),
             f"{what}: kernels ran more times than wanted (runs, wanted): "
             f"{runs}")
        missed = {k: n - got for k, (got, n) in runs.items() if got != n}
        if not missed:
            return out, wall_us, rows, short
        short.append(missed)
    need(False, f"{what}: kernels ran fewer times than wanted in each of "
         f"{PROFILE_TRIES} profiles, short by {short}")


def wrapper_runs(n):
    """The runs of each simulator wrapper's kernels in ``n`` ticks: one a
    tick (the wrappers issue nothing else: no memset, no library
    kernel)."""
    return {k: n for names in WRAPPER_KERNELS.values() for k in names}


def wrapper_kernels(rows, n):
    """Each simulator wrapper's device time and device operations a tick
    in a profile of ``n`` ticks, its kernels found by name."""
    wrappers = {}
    for wrapper, names in WRAPPER_KERNELS.items():
        mine = [r for r in rows if any(kernel_named(r[2], k) for k in names)]
        wrappers[wrapper] = dict(
            device_us_per_tick=sum(r[0] for r in mine) / n,
            device_ops_per_tick=sum(r[1] for r in mine) / n)
    return wrappers


def profile_ticks(eng, st, n=20):
    """Device time by kernel over ``n`` ticks and the device's busy share
    of the wall time; each wrapper's device time and device operations a
    tick, found by its kernels' names, each of which must run once a tick
    (``counted_profile``). Returns the state after the ticks and the
    summary."""
    def ticks():
        s = st
        for _ in range(n):
            s = eng.tick(s)
        return s

    st, wall_us, rows, short = counted_profile(
        ticks, lambda: wrapper_runs(n), "profile")
    busy_us = sum(r[0] for r in rows)
    return st, dict(
        ticks=n, wall_ms_per_tick=wall_us / n / 1e3,
        device_ms_per_tick=busy_us / n / 1e3,
        device_busy_share=busy_us / wall_us,
        wrappers=wrapper_kernels(rows, n), short_profiles=short,
        device_kernels_per_tick=sum(r[1] for r in rows) / n,
        top=[dict(name=k[:70], us_per_tick=us / n, calls_per_tick=c / n)
             for us, c, k in rows[:8]],
    )


def paper_engine(cfg, dev, **build_kw):
    """The paper scenario ``cfg`` resolved (seed 0) and built on ``dev``
    (``build_kw``: the observers): (resolved scenario, engine, number of
    app slots)."""
    from repro_torch.union import manager as MGR
    from repro_torch.union.scenario import mix_scenario

    sc = mix_scenario(cfg["workload"], topo=cfg["topo"], scale=cfg["scale"],
                      placement="RG", routing="ADP", tick_us=5.0,
                      horizon_ms=cfg["horizon_ms"])
    rs = MGR.resolve(sc, seed=0)
    return (rs, MGR.build(rs, device=dev, **build_kw),
            len(rs.padded_app_names(rs.capacity)))


def replayed_counts(run):
    """The kernel wrappers' launches and calls of a run on the card (a
    ``RunStats`` as a dict): each replay runs what its graph captured,
    and the wrappers count only while a graph is captured."""
    return ({k: run["replays"] * v for k, v in run["graph_launches"].items()},
            {k: run["replays"] * v for k, v in run["graph_calls"].items()})


FLOAT_SUMS = ("lat_sum", "link_bytes", "router_wins", "comm_time")


def float_sums(st):
    """Float sums of a member state that the contract holds to rtol 1e-5
    (float atomics on the card sum in no fixed order)."""
    from repro_torch.netsim.state_io import state_to_numpy

    s = state_to_numpy(st)
    m = s.metrics
    return dict(lat_sum=m.lat_sum.astype("float64"),
                link_bytes=m.link_bytes.sum(dtype="float64"),
                router_wins=m.router_wins.sum(axis=(0, 2), dtype="float64"),
                comm_time=s.vms.comm_time.sum(axis=1, dtype="float64"))


def same_run(a, b, what):
    """Two member states of one scenario: equal integer-trajectory and pool
    digests, float sums within rtol 1e-5."""
    import numpy as np

    da, db = trajectory_digests(a), trajectory_digests(b)
    need(da == db, f"{what}: digests differ in "
         f"{sorted(k for k in da if da[k] != db[k])}")
    fa, fb = float_sums(a), float_sums(b)
    for k in FLOAT_SUMS:
        need(np.allclose(fa[k], fb[k], rtol=1e-5, atol=0.0),
             f"{what}: float sums of {k} beyond rtol 1e-5")


def live_any(st, horizon_us):
    """``run``'s liveness read of a member state (one host sync)."""
    from repro_torch.netsim.engine import member_live

    return bool(member_live(st, horizon_us))


PROFILE_AT = 11  # the eager 20-tick profile starts here (inside one chunk)
CHUNK = 64  # ticks between liveness reads, as ``run``'s default


def phase_paper(name, cfg, dev, phase=None, cpu_ticks=CARD_VS_CPU_TICKS):
    """The paper run on ``cfg``: counted through ``run_sim`` (graph
    replays), then an eager loop of ``tick`` from the same seed (sampled
    ticks, the 20-tick profile, liveness every 64 ticks as ``run``) held
    to a graph ``run`` by digests, the graph replays profiled over the last
    chunk, and the first ``cpu_ticks`` eager ticks held to the CPU path.
    Emits its line as ``phase`` (default ``name``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.drain_tick import (
        drain_tick_cuda, drain_tick_plain)
    from repro_torch.kernels.link_demand import (
        link_demand_cuda, link_demand_plain)
    from repro_torch.kernels.router_tick import (
        router_rate_drain_cuda, router_rate_drain_plain)
    from repro_torch.launch.sim import run_sim
    from repro_torch.union.seeds import engine_seed
    from test_torch_router_tick_cuda import same_bits

    kw = dict(scale=cfg["scale"], seed=0, horizon_ms=cfg["horizon_ms"],
              tick_us=5.0)
    # the main path, counted: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = run_sim(cfg["workload"], cfg["topo"], "RG", "ADP", device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = dict(launches=dict(ops.LAUNCHES), calls=dict(ops.CALLS))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    run = rep["engine_run"]
    launches, calls = replayed_counts(run)
    ticks = run["ticks"]
    need(run["device"] == "cuda" and run["replays"] > 0,
         f"{name}: run_sim replayed no graph")
    need(launches["drain_tick"] > 0, f"{name}: the drain kernel was never "
         "launched")
    for k in ("drain_tick", "link_demand"):
        need(launches[k] == calls[k] == ticks,
             f"{name}: {launches[k]} {k} launches for {calls[k]} calls and "
             f"{ticks} ticks")
        # what the wrappers counted: one eager warm-up tick, then the
        # graph's ticks while it was captured
        need(counted["launches"][k] == counted["calls"][k]
             == run["graph_ticks"] + 1,
             f"{name}: {k} counted {counted['launches'][k]} launches, "
             f"{counted['calls'][k]} calls in the window")
    need(launches["router_rate_drain"] == calls["router_rate_drain"]
         and counted["launches"]["router_rate_drain"]
         == counted["calls"]["router_rate_drain"],
         f"{name}: route-rate-drain launches != calls")
    # a dragonfly injects through the kernel once a tick; the fat tree and
    # the torus route in the plain injection and never call it
    want_inject = ticks if cfg["topo"] in ("1d", "2d") else 0
    need(launches["inject"] == calls["inject"] == want_inject,
         f"{name}: {launches['inject']} inject launches for "
         f"{calls['inject']} calls and {ticks} ticks")
    need(rep["dropped"] == 0, f"{name}: {rep['dropped']} messages dropped")
    delivered = {app: v.get("count", 0) for app, v in rep["latency"].items()}

    # the same scenario again through the manager, as an eager tick loop:
    # the kernel against its plain version, and demand sums and routes
    # against the CPU's, on live pools at sampled ticks
    rs, eng, n_apps = paper_engine(cfg, dev)
    st = eng.init_state(seed=engine_seed(0))
    # five sample points spread over the run; a point whose pool is empty
    # moves on to the next tick with messages in flight
    targets = sorted({int(x) for x in np.linspace(10, ticks - 10, 5)})
    sampled, prof, late = [], None, None
    i, eager_s = 0, 0.0
    while True:
        if i % CHUNK == 0:
            t1 = time.perf_counter()
            alive = live_any(st, rs.horizon_us)
            eager_s += time.perf_counter() - t1
            if not alive:
                break
            if i == ticks - CHUNK:
                late = st  # the graph profile's start: the last chunk
        if i == PROFILE_AT:
            st, prof = profile_ticks(eng, st)
            i += prof["ticks"]
            continue
        t1 = time.perf_counter()
        st = eng.tick(st)
        eager_s += time.perf_counter() - t1
        i += 1
        if len(sampled) == len(targets) or i - 1 < targets[len(sampled)] \
                or not bool(st.pool.active.any()):
            continue
        args = live_drain_args(st, rs, dev)
        R, L = rs.topo.n_routers, rs.topo.n_links
        err = compare_drain(args, n_apps, R)
        pool = [x[None] for x in (st.pool.routes, st.pool.active,
                                  st.pool.bytes_rem)]
        # the route-rate-drain on this pool and its state's shares: its
        # plain version's bits, and the drain tick's rate
        rargs, dt = live_router_args(st, rs, dev)
        k = router_rate_drain_cuda(*rargs, dt)
        pk = router_rate_drain_plain(*rargs, dt)
        for what, a, b in zip(("new_rem", "rate", "drained"), k, pk):
            need(same_bits(a, b), f"{name}: route-rate-drain {what} "
                 f"!= plain on the live pool at tick {i - 1}")
        need(same_bits(k[1], drain_tick_plain(*args, n_apps, R)[1][0]),
             f"{name}: route-rate-drain rate != the drain tick's on "
             f"the live pool at tick {i - 1}")
        sampled.append(dict(
            tick=i - 1, active=int(st.pool.active.sum()), max_abs_err=err,
            route_parity=route_parity(st, rs, dev, i - 1),
            router_rate_drain_exact=True,
            live_ms=dict(
                drain_tick=device_ms(
                    lambda: drain_tick_cuda(*args, n_apps, R)),
                link_demand=device_ms(
                    lambda: link_demand_cuda(*pool, L)),
                router_rate_drain=device_ms(
                    lambda: router_rate_drain_cuda(*rargs, dt))),
            # the plain versions on the same pool, on the card, at the
            # first sampled tick (a plain drain tick takes about 0.1 s)
            plain_live_ms=None if sampled else dict(
                drain_tick=time_ms(
                    lambda: drain_tick_plain(*args, n_apps, R), reps=3,
                    warmup=1),
                link_demand=time_ms(
                    lambda: link_demand_plain(*pool, L), reps=3,
                    warmup=1))))
    eager = st
    need(i == ticks, f"{name}: the eager loop ran {i} ticks, the graph run "
         f"{ticks}")
    need(len(sampled) >= 2, f"{name}: only {len(sampled)} sampled ticks had "
         "messages in flight")
    need(late is not None, f"{name}: no state at tick {ticks - CHUNK}")

    # the graph run from the same seed on this engine (it captures its
    # graph here: the one run_sim captured on the cached engine is
    # dropped): the eager loop's digests and float sums
    eng.drop_graphs()
    graph = eng.run(eng.init_state(seed=engine_seed(0)))
    same_run(graph, eager, f"{name}: graph run vs eager ticks")
    graph_stats = dataclasses.asdict(eng.last_run)
    # the graph replays of the last chunk under the profiler
    out, wall_us, rows, short = counted_profile(
        lambda: eng.run(late), lambda: wrapper_runs(eng.last_run.ticks),
        f"{name}: graph profile")
    same_run(out, eager, f"{name}: graph run of the last chunk vs eager")
    busy_us = sum(r[0] for r in rows)
    n_prof = eng.last_run.ticks
    need(n_prof == CHUNK and eng.last_run.replays > 0,
         f"{name}: the profiled run replayed {n_prof} ticks, want {CHUNK}")
    # on the device: the replays ran each simulator kernel once a tick
    graph_prof = dict(
        ticks=n_prof, wall_ms_per_tick=wall_us / n_prof / 1e3,
        device_ms_per_tick=busy_us / n_prof / 1e3,
        device_busy_share=busy_us / wall_us,
        wrappers=wrapper_kernels(rows, n_prof), short_profiles=short,
        device_kernels_per_tick=sum(r[1] for r in rows) / n_prof)
    against_cpu = card_vs_cpu(name, rs, eng, n=cpu_ticks)
    lat_cnt = trajectory(eager)["lat_cnt"].tolist()
    need(float(eager.t) / 1000.0 == rep["virtual_time_ms"],
         f"{name}: the counted run ended at another time")
    need([delivered[a] for a in rep["latency"]]
         == [c for a, c in zip(rs.padded_app_names(rs.capacity), lat_cnt)
             if a is not None],
         f"{name}: the counted run delivered other counts")
    virtual_ms = rep["virtual_time_ms"]
    emit(dict(phase=phase or name, seconds=time.perf_counter() - t0,
              workload=cfg["workload"], topo=cfg["topo"],
              horizon_ms=cfg["horizon_ms"], nodes=rs.topo.n_nodes,
              links=rs.topo.n_links, route_width=rs.topo.route_width,
              pool=rs.pool_size,
              virtual_time_ms=virtual_ms, wall_s=wall,
              virtual_ms_per_wall_s=virtual_ms / wall,
              ticks=ticks, graph_ticks=run["graph_ticks"],
              replays=run["replays"], liveness_reads=run["liveness_reads"],
              capture_s=run["capture_s"], instantiate_s=run["instantiate_s"],
              replay_device_ms=run["replay_device_ms"],
              replay_device_ms_per_tick=run["replay_device_ms"] / ticks,
              replay_share_of_wall=run["replay_device_ms"] / (wall * 1e3),
              graph_profile=graph_prof,
              graph_rerun=dict(
                  capture_s=graph_stats["capture_s"],
                  instantiate_s=graph_stats["instantiate_s"],
                  replay_device_ms_per_tick=graph_stats["replay_device_ms"]
                  / graph_stats["ticks"]),
              # host seconds of the eager loop's ticks and liveness reads
              # (the profiled ticks and the sampled ticks' checks left
              # out), scaled to the run's ticks
              eager_wall_s=eager_s * ticks / (ticks - prof["ticks"]),
              eager_virtual_ms_per_wall_s=virtual_ms * (ticks - prof["ticks"])
              / (eager_s * ticks),
              drain_calls=calls["drain_tick"],
              drain_launches=launches["drain_tick"],
              link_demand_launches=launches["link_demand"],
              router_rate_drain_launches=launches["router_rate_drain"],
              counted_while_capturing=counted["launches"],
              dropped=rep["dropped"],
              peak_device_mib=peak_mib, delivered=delivered,
              sampled_ticks=sampled, graph_equals_eager=True,
              card_vs_cpu=against_cpu, profile=prof))
    return dict(drain_tick=launches["drain_tick"],
                link_demand=launches["link_demand"],
                router_rate_drain=launches["router_rate_drain"],
                inject=launches["inject"],
                router_live=dict(
                    tick=sampled[0]["tick"], active=sampled[0]["active"],
                    ms=sampled[0]["live_ms"]["router_rate_drain"]),
                live=dict(tick=sampled[0]["tick"],
                          active=sampled[0]["active"],
                          ms=sampled[0]["live_ms"],
                          plain_ms=sampled[0]["plain_live_ms"]),
                link_demand_max_abs_err=max(
                    s["route_parity"]["demand_max_abs_err"]
                    for s in sampled)), delivered


def recorded_inject(eng, st):
    """The arguments of the engine's ``KOPS.inject`` call in one eager
    tick from ``st`` (the tick's candidates, demand and pool)."""
    from repro_torch.kernels import ops

    seen = []
    wrapper = ops.inject

    def record(*args, **kw):
        seen.append((args, kw))
        return wrapper(*args, **kw)

    ops.inject = record
    try:
        eng.tick(st)
    finally:
        ops.inject = wrapper
    need(len(seen) == 1, f"inject: {len(seen)} calls in one tick")
    return seen[0]


def inject_bound_ms(args, routed):
    """The least time for one injection: each batch's emission flags read
    once and its injected bytes written once (4 B a candidate each), a
    routed candidate's other inputs read once (28 B) and its pool row
    written (69 B), every written pool leaf copied once (69 B a slot read
    and written), at the HBM rate. Returns (ms, bytes)."""
    pool, _, _, batches = args[:4]
    B, M = pool.active.shape
    cands = sum(c.dst_rank.numel() for c in batches)
    moved = 8 * cands + (28 + 69) * routed + 2 * 69 * B * M
    return moved / HBM_BYTES_PER_S * 1e3, moved


def phase_inject(dev, cfgs=(PAPER_1D, PAPER_2D), members=(1, 8), at=10):
    """``inject``: the injection kernel alone on the paper dragonflies'
    live pools. Each engine ticks ``at`` ticks eagerly from seed 0 (a
    batch of ``members`` copies of the member), then the next tick's
    ``KOPS.inject`` arguments are recorded; the kernel's result equals the
    plain version's on the card (every written leaf and the tally of
    candidates seen and routed bit for bit, the peak to rtol 1e-4; a row's
    ``max_abs_err`` is the peak's difference, the leaves' being 0), and
    both are timed there (the kernel as a CUDA graph of 20 calls,
    ``device_ms``), on that tick and on the same tick with every job
    candidate emitted, beside the byte bound."""
    import torch

    from repro_torch.kernels.inject import (
        POOL_ROWS, inject_batches_plain, inject_cuda)
    from repro_torch.netsim.engine import stack_members
    from repro_torch.union.seeds import engine_seed

    t0 = time.perf_counter()
    rows = []
    for cfg in cfgs:
        rs, eng, _ = paper_engine(cfg, dev)
        st = eng.init_state(seed=engine_seed(0))
        for _ in range(at):
            st = eng.tick(st)
        for B in members:
            args, kw = recorded_inject(eng, stack_members([st] * B))
            pool, batches = args[0], tuple(args[3])
            jobs = batches[0]._replace(
                dst_rank=batches[0].dst_rank.clamp(min=0))
            full_args = args[:3] + ((jobs,) + batches[1:],) + args[4:]
            for what, a in (("live", args), ("all_emit", full_args)):
                tally = [torch.zeros(2, dtype=torch.int64, device=dev)
                         for _ in range(2)]
                got = inject_cuda(*a, **dict(kw, counts=tally[0]))
                want = inject_batches_plain(*a, **dict(kw, counts=tally[1]))
                for k in POOL_ROWS + ("free_top", "dropped"):
                    need(torch.equal(getattr(got[0], k),
                                     getattr(want[0], k)),
                         f"inject {cfg['topo']} B={B} {what}: {k} differs "
                         "from the plain version")
                need(torch.equal(*tally),
                     f"inject {cfg['topo']} B={B} {what}: counts "
                     f"{tally[0].tolist()} against {tally[1].tolist()}")
                torch.testing.assert_close(
                    got[1].peak_inject, want[1].peak_inject, rtol=1e-4,
                    atol=0.0)
                routed = int((pool.free_top - got[0].free_top).sum())
                need(tally[0].tolist()[1] == routed,
                     f"inject {cfg['topo']} B={B} {what}: counted "
                     f"{tally[0].tolist()[1]} routed, not {routed}")
                bound_ms, moved = inject_bound_ms(a, routed)
                row = dict(
                    topo=cfg["topo"], members=B, tick=at, case=what,
                    candidates=sum(c.dst_rank.numel() for c in a[3]),
                    emitted=sum(int((c.dst_rank >= 0).sum()) for c in a[3]),
                    routed=routed,
                    max_abs_err=float((got[1].peak_inject
                                       - want[1].peak_inject).abs().max()),
                    ms=device_ms(lambda: inject_cuda(*a, **kw)),
                    bound_ms=bound_ms, bound_by="bytes", bytes=moved)
                if what == "live":
                    row["plain_ms"] = time_ms(
                        lambda: inject_batches_plain(*a, **kw), reps=3,
                        warmup=1)
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                rows.append(row)
        del eng, st
        free_engines()
    emit(dict(phase="inject", seconds=time.perf_counter() - t0, rows=rows))
    return rows


def timed_run(eng, state):
    """One ``run`` with the peak memory counted from 0: (final state, wall
    s, RunStats, peak device MiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.run(state)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, eng.last_run,
            torch.cuda.max_memory_allocated() / 2**20)


def phase_members(dev, cfg=dict(PAPER_1D, horizon_ms=5.0)):
    """Members of one batch at the 1D paper scale, to 5 ms (cut from 10
    to keep the script inside its time). Four members: seeds 0-3,
    each with its own placement (``resolve(sc, seed=s)``: jobs and UR) and
    ``engine_seed(s)``; member 2 with a rank slowdown of 1.5 on a tenth of
    CosmoFlow's ranks; member 3 with entry 0 of the ``links2pct`` timeline
    (2 % of the fabric links dead, cell seed 3). Each member of the B = 4
    graph run has the digests (and float sums within rtol 1e-5) of its
    own B = 1 graph run. Then member-virtual-ms per wall s, device ms a
    tick (CUDA events around the replays) and peak device memory at B =
    1 (seed 0), 4 (the four members; and seeds 0-3, healthy) and 8 (seeds
    0-7, healthy), each on an engine of its own: the first run captures
    (its peak memory is the row's), the second, timed, replays the cached
    graph."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.netsim import engine as ENG
    from repro_torch.netsim.faults import FailureSpec, FaultEvent
    from repro_torch.union import manager as MGR
    from repro_torch.union.seeds import engine_seed

    t0 = time.perf_counter()

    def member(rs, eng, s, **kw):
        other = MGR.resolve(rs.scenario, seed=s)
        placements = [j.rank2node for j in other.jobs] + [other.ur.rank2node]
        return eng.init_state(seed=engine_seed(s), placements=placements,
                              **kw)

    def four(rs, eng):
        P0 = rs.jobs[0].skeleton.n_ranks
        slow = np.ones(P0, np.float32)
        slow[: P0 // 10] = 1.5
        mask = FailureSpec(name="links2pct", events=[FaultEvent(
            t_us=0.0, kind="random_links", fraction=0.02)]).timeline(
                rs.topo, 3)[0][1]
        extra = dict(slowed=int((slow > 1).sum()),
                     dead_links=int((mask.link_bw_factor == 0).sum()))
        return [member(rs, eng, 0), member(rs, eng, 1),
                member(rs, eng, 2, rank_slowdown_override=[slow]
                       + [None] * (len(rs.jobs) - 1)),
                member(rs, eng, 3, faults=mask)], extra

    rows, extra = {}, {}
    # the four members, then healthy batches of seeds 0..B-1 (at B = 4
    # too: the dead links of member 3 stall messages, so its batch takes
    # more ticks to the horizon)
    for label, B in (("4", 4), ("1", 1), ("4_healthy", 4), ("8", 8)):
        rs, eng, _ = paper_engine(cfg, dev)
        if label == "4":
            ms, extra = four(rs, eng)
        else:
            ms = [member(rs, eng, s) for s in range(B)]
        state = ms[0] if B == 1 else ENG.stack_members(ms)
        out, _, first, peak = timed_run(eng, state)  # captures
        if label == "4":
            for i, m in enumerate(ms):
                same_run(ENG.member_state(out, i), eng.run(m),
                         f"paper_1d_members: member {i} of the batch vs "
                         "its own run")
        _, wall, stats, _ = timed_run(eng, state)
        need(not stats.captured, "paper_1d_members: the timed run captured")
        rows[label] = dict(
            wall_s=wall, ticks=stats.ticks,
            member_virtual_ms_per_wall_s=B * cfg["horizon_ms"] / wall,
            device_ms_per_tick=stats.replay_device_ms / stats.ticks,
            capture_s=first.capture_s, instantiate_s=first.instantiate_s,
            peak_device_mib=peak,
            launches={k: v for k, v in replayed_counts(
                dataclasses.asdict(stats))[0].items() if v})
        eng.drop_graphs()  # the cached engine's: the next batch captures
        del rs, eng, ms, state, out
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase="paper_1d_members", seconds=time.perf_counter() - t0,
              workload=cfg["workload"], horizon_ms=cfg["horizon_ms"],
              members_equal_their_own_runs=4,
              dead_links_member_3=extra["dead_links"],
              slowed_ranks_member_2=extra["slowed"], by_batch=rows))


def phase_observed(dev, cfg=dict(PAPER_1D, horizon_ms=2.0)):
    """The 1D paper run with ``HistConfig()`` and ``ProbeConfig()``
    compiled in, to 2 ms, through the graph: its unobserved leaves have
    the plain engine's digests; its histogram counts per app sum to
    ``lat_cnt``; its probe counter is its live ticks over ``every`` and
    the ring holds the last ``min(idx, samples)`` samples. Device ms a
    tick with and without the observers (CUDA events, cached graphs, in
    turns: plain, observed, observed, plain)."""
    import numpy as np

    from repro_torch.obs import HistConfig, ProbeConfig, ring_order
    from repro_torch.union.seeds import engine_seed

    t0 = time.perf_counter()
    pc, hc = ProbeConfig(), HistConfig()
    rs, plain, _ = paper_engine(cfg, dev)
    _, observed, _ = paper_engine(cfg, dev, probes=pc, hist=hc)
    engines = dict(plain=plain, observed=observed)
    final, times = {}, dict(plain=[], observed=[])
    for what, eng in engines.items():  # the captures
        final[what] = eng.run(eng.init_state(seed=engine_seed(0)))
    for what in ("plain", "observed", "observed", "plain"):  # in turns
        eng = engines[what]
        _, wall, stats, _ = timed_run(eng, eng.init_state(seed=engine_seed(0)))
        times[what].append(dict(wall_s=wall, ticks=stats.ticks,
                                device_ms_per_tick=stats.replay_device_ms
                                / stats.ticks))
    st, plain_st = final["observed"], final["plain"]
    same_run(st, plain_st, "paper_1d_observed: observed vs plain leaves")
    counts = st.hist.counts.cpu().numpy()
    lat_cnt = st.metrics.lat_cnt.cpu().numpy()
    need((counts.sum(axis=(1, 2)) == lat_cnt).all(),
         "paper_1d_observed: histogram counts do not sum to lat_cnt")
    idx, live_ticks = int(st.probes.idx), int(st.probes.tick)
    need(idx == live_ticks // pc.every and idx > 0,
         f"paper_1d_observed: {idx} samples for {live_ticks} live ticks")
    ts = st.probes.t.cpu().numpy()
    held = ts[ring_order(idx, pc.samples)]
    need(len(held) == min(idx, pc.samples) and (held >= 0).all()
         and (np.diff(held) > 0).all(),
         "paper_1d_observed: the ring does not hold the last samples in "
         "order")
    need(idx >= pc.samples or (ts[idx:] == -1.0).all(),
         "paper_1d_observed: the ring holds samples it never took")
    emit(dict(phase="paper_1d_observed", seconds=time.perf_counter() - t0,
              horizon_ms=cfg["horizon_ms"], probes=vars(pc), hist=vars(hc),
              samples=idx, live_ticks=live_ticks,
              delivered=int(lat_cnt.sum()),
              levels_crossed=int((counts.sum(axis=(0, 2)) > 0).sum()),
              plain=times["plain"], observed=times["observed"],
              observer_device_ms_per_tick=sum(
                  r["device_ms_per_tick"] for r in times["observed"]) / 2
              - sum(r["device_ms_per_tick"] for r in times["plain"]) / 2))


# ---------------------------------------------------------------------------
# paper_1d_trace: the online scheduler on the paper's 1D system
# ---------------------------------------------------------------------------

# the trace's catalog: the paper's Table III applications at their paper
# rank counts (``ranks=None``): app, runtime estimate µs, weight, iters
TRACE_CATALOG = (("cosmoflow", 130_000.0, 0.5, 1), ("nn", 5_000.0, 2.0, 2),
                 ("lammps", 5_000.0, 1.0, 2), ("nekbone", 3_000.0, 1.0, 2),
                 ("milc", 4_000.0, 0.5, 1))
TRACE_JOBS, TRACE_GAP_US, TRACE_HORIZON_MS, TRACE_SLOTS = 16, 1000.0, 20.0, 4
TRACE_EAGER_WINDOWS = 3  # windows of the easy cell held to eager ticks


def paper_trace(scale="paper", horizon_ms=TRACE_HORIZON_MS):
    """16 Poisson arrivals (mean gap 1 ms, seed 0) of the catalog on the
    1D dragonfly: tick 5 µs, ADP routing, RN placement, 4 slots, the
    paper pool (65,536 messages), horizon 20 ms (or ``horizon_ms``)."""
    from repro_torch.sched.trace import CatalogApp, synthetic_trace

    cat = [CatalogApp(app=a, est_runtime_us=e, weight=w,
                      overrides={"iters": it})
           for a, e, w, it in TRACE_CATALOG]
    return synthetic_trace(
        TRACE_JOBS, arrival="poisson", mean_gap_us=TRACE_GAP_US, seed=0,
        catalog=cat, topo="1d", scale=scale, placement="RN", routing="ADP",
        tick_us=5.0, horizon_ms=horizon_ms, slots=TRACE_SLOTS)


def trace_outage():
    """2 % of the fabric links down at 5 ms and back at 12 ms (seed 7)."""
    from repro_torch.netsim.faults import FailureSpec, FaultEvent

    return FailureSpec(name="outage", events=[
        FaultEvent(t_us=5_000.0, kind="random_links", fraction=0.02, seed=7),
        FaultEvent(t_us=12_000.0, kind="random_links", fraction=0.02,
                   seed=7, factor=1.0)])


def trace_row(res, wall_s, peak_mib):
    """One scheduler run's line: its jobs, windows and engine totals
    (``SchedResult.engine_windows``; a batch's are its cells')."""
    from collections import Counter

    recs = res.records
    slots = Counter(r.slot for r in recs if r.slot >= 0)
    ew = res.engine_windows
    W = max(ew["windows"], 1)
    return dict(
        policy=res.policy, windows=res.windows, jobs=len(recs),
        started=sum(slots.values()),
        completed=sum(r.completed for r in recs),
        slots_recycled=sum(n - 1 for n in slots.values()),
        virtual_ms=float(res.final_state.t) / 1e3, wall_s=wall_s,
        virtual_ms_per_wall_s=float(res.final_state.t) / 1e3 / wall_s,
        jobs_per_s=res.jobs_per_sec,
        batch_windows=ew["windows"], ticks=ew["ticks"],
        live_ticks=ew["live_ticks"],
        noop_tick_share=1.0 - ew["live_ticks"] / max(ew["ticks"], 1),
        replays=ew["replays"], captures=ew["captures"],
        capture_s=ew["capture_s"],
        replay_device_ms_per_tick=ew["replay_device_ms"] / max(ew["ticks"],
                                                               1),
        # host time a window: the round between windows (view, policy,
        # surgery) and the window call's time beyond its replays' device
        # time (copy-in, flag reads, copy-out)
        host_round_ms_per_window=1e3 * ew["host_round_s"] / W,
        window_overhead_ms_per_window=(
            1e3 * ew["window_wall_s"] - ew["replay_device_ms"]) / W,
        peak_device_mib=peak_mib, launches=ew["launches"])


def same_records(a, b, what):
    """Two SchedResults of one cell: the same records (jid, slot, start,
    finish, messages, completed, and the bits of avg_latency_us and
    max_comm_ms), window counts and final-state digests."""
    import numpy as np

    def bits(x):
        return np.float64(x).tobytes()

    need(len(a.records) == len(b.records), f"{what}: record counts differ")
    for x, y in zip(a.records, b.records):
        need((x.jid, x.slot, x.msgs, x.completed)
             == (y.jid, y.slot, y.msgs, y.completed)
             and [bits(v) for v in (x.start_us, x.finish_us,
                                    x.avg_latency_us, x.max_comm_ms)]
             == [bits(v) for v in (y.start_us, y.finish_us,
                                   y.avg_latency_us, y.max_comm_ms)],
             f"{what}: job {x.jid}'s records differ")
    need(a.windows == b.windows, f"{what}: window counts differ")
    same_run(a.final_state, b.final_state, what)


def phase_trace(dev):
    """``paper_1d_trace``: a 16-job trace through the port's online
    scheduler on the paper's 1D system, each window replays of a captured
    graph. ``run_trace`` under FCFS and EASY on one engine, then
    ``run_trace_batch`` over FCFS, EASY and EASY with a mid-run outage,
    and the outage cell alone: every batched member equal to its own
    sequential run (records and final-state digests). The first windows
    of the EASY cell equal an eager loop of ``tick`` under the stop rule;
    the drain tick's and link demand's launches equal the ticks replayed,
    and a profile of the first window's replays finds each of their
    kernels once a tick replayed.
    The counts are set to 0 before the scheduler runs and read after."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim import engine as ENG
    from repro_torch.sched import scheduler as S
    from repro_torch.union.seeds import engine_seed
    from test_torch_windows_cuda import eager_window

    t0 = time.perf_counter()
    tr = paper_trace()
    engine = S.build_sched_engine(tr, device=dev)
    eng = engine[0]

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated() / 2**20
        res = out if isinstance(out, list) else [out]
        return out, [trace_row(r, wall, peak) for r in res]

    ops.reset_launches()
    runs, rows = {}, {}
    for pol in ("fcfs", "easy"):
        runs[pol], (rows[pol],) = timed(lambda: S._run_trace_impl(
            tr, policy=pol, seed=0, engine=engine, collect_state=True))
    batch, brows = timed(lambda: S.run_trace_batch(
        [(tr, "fcfs", 0), (tr, "easy", 0), (tr, "easy", 0, trace_outage())],
        engine=engine, collect_state=True))
    runs["outage"], (rows["outage"],) = timed(lambda: S._run_trace_impl(
        tr, policy="easy", seed=0, engine=engine, collect_state=True,
        failure=trace_outage()))
    counted = dict(ops.LAUNCHES)
    ticks = launches = 0
    for r in [rows["fcfs"], rows["easy"], rows["outage"], brows[0]]:
        ticks += r["ticks"]
        launches += r["launches"].get("drain_tick", 0)
        need(r["launches"].get("drain_tick") == r["ticks"]
             and r["launches"].get("link_demand") == r["ticks"],
             f"paper_1d_trace: launches {r['launches']} != {r['ticks']} "
             "ticks replayed")
    for i, key in enumerate(("fcfs", "easy", "outage")):
        same_records(batch[i], runs[key], f"paper_1d_trace: batched {key} "
                     "cell vs its own run")
    for key in ("fcfs", "easy"):
        need(rows[key]["completed"] >= 4 and rows[key]["slots_recycled"] >= 1,
             f"paper_1d_trace: {key} completed {rows[key]['completed']} "
             f"jobs, recycled {rows[key]['slots_recycled']} slots")
    need(rows["outage"]["ticks"] > 0 and rows["easy"]["captures"] == 0,
         "paper_1d_trace: the easy run captured again")

    # the first windows of the EASY cell: graph replays against eager
    # ticks under the stop rule, from the same surgery
    _, topo, resolved, net = engine
    cell = S._CellLoop(tr, "easy", tr.slots, 0, topo, resolved, net)
    state = eng.init_state(seed=engine_seed(0))
    eager = []
    for w in range(TRACE_EAGER_WINDOWS):
        retires, admits, t_stop = cell.step(ENG.window_host_view(state))
        for slot in retires:
            state = ENG.retire_job(state, slot, checked=False)
        for slot, spec in admits:
            state = ENG.admit_job(state, slot, spec, checked=False)
        need(cell.active, "paper_1d_trace: the cell ended early")
        if w == 0:
            # on the device: the window's replays ran each simulator
            # kernel once a tick replayed
            got, wall_us, prof, short = counted_profile(
                lambda: eng.run_window(state, np.float32(t_stop)),
                lambda: wrapper_runs(eng.last_window.ticks),
                "paper_1d_trace: window 0's replays")
            lw = eng.last_window
            need(not lw.captured, "paper_1d_trace: the profiled window "
                 "captured")
            busy_us = sum(r[0] for r in prof)
            window_prof = dict(
                ticks=lw.ticks, live_ticks=lw.live_ticks,
                replays=lw.replays, wall_ms=wall_us / 1e3,
                device_ms_per_tick=busy_us / lw.ticks / 1e3,
                device_busy_share=busy_us / wall_us,
                wrappers=wrapper_kernels(prof, lw.ticks),
                short_profiles=short)
        else:
            got = eng.run_window(state, np.float32(t_stop))
        e0 = time.perf_counter()
        want, n = eager_window(eng, state, np.float32(t_stop),
                               tr.horizon_ms * 1000.0)
        same_run(got, want, f"paper_1d_trace: window {w}, graph vs eager")
        need(eng.last_window.live_ticks == n,
             f"paper_1d_trace: window {w}: {eng.last_window.live_ticks} "
             f"live ticks, {n} eager")
        eager.append(dict(t_stop_us=float(t_stop), ticks=n,
                          replays=eng.last_window.replays,
                          eager_s=time.perf_counter() - e0))
        state = got
        cell.windows += 1
    emit(dict(phase="paper_1d_trace", seconds=time.perf_counter() - t0,
              trace=dict(jobs=TRACE_JOBS, mean_gap_us=TRACE_GAP_US,
                         horizon_ms=TRACE_HORIZON_MS, slots=TRACE_SLOTS,
                         catalog=TRACE_CATALOG,
                         arrivals=[(j.name, j.arrival_us) for j in tr.jobs]),
              capacity=vars(eng.capacity), runs=rows, batch=brows,
              batch_member_virtual_ms_per_wall_s=sum(
                  r["virtual_ms"] for r in brows) / brows[0]["wall_s"],
              batched_equal_sequential=3, eager_windows=eager,
              window_profile=window_prof, counted_calls=counted))
    return dict(drain_tick=launches, link_demand=launches, ticks=ticks)


# ---------------------------------------------------------------------------
# paper_1d_experiment: the experiment facade on the paper's 1D system
# ---------------------------------------------------------------------------

EXPERIMENT_HORIZON_MS = 10.0


def experiment_outage():
    """``trace_outage``'s form inside the 10 ms horizon: 2 % of the
    fabric links down at 3 ms and back at 7 ms (seed 7)."""
    from repro_torch.netsim.faults import FailureSpec, FaultEvent

    return FailureSpec(name="outage", events=[
        FaultEvent(t_us=3_000.0, kind="random_links", fraction=0.02, seed=7),
        FaultEvent(t_us=7_000.0, kind="random_links", fraction=0.02,
                   seed=7, factor=1.0)])


def paper_experiment():
    """One study at the 1D paper scale (as paper_1d: 65,536-message pool,
    5 µs tick, ADP): workload1 to 10 ms under placements RN and RG, 2
    members, healthy and with ``experiment_outage`` (8 cells, one batched
    node: 4 plain members in one stacked ``run``, 4 timed ones through
    ``run_window`` rounds); and ``paper_trace`` cut to 10 ms under FCFS
    and EASY, 1 seed, which the failures axis crosses too (one
    ``windowed_batch`` node of 4 cells)."""
    from repro_torch import union
    from repro_torch.union.scenario import mix_scenario

    sc = mix_scenario("workload1", topo="1d", scale="paper", placement="RG",
                      routing="ADP", tick_us=5.0,
                      horizon_ms=EXPERIMENT_HORIZON_MS)
    return union.Experiment(
        name="paper_1d_experiment", scenarios=[sc], members=2,
        grid=union.StudyGrid(placements=["RN", "RG"],
                             failures=["healthy", experiment_outage()]),
        trace=union.TraceStudy(
            trace=paper_trace(horizon_ms=EXPERIMENT_HORIZON_MS),
            policies=["fcfs", "easy"], seeds=1))


def same_value(a, b) -> bool:
    """Integers and strings equal, floats bit for bit (NaN equal to NaN)."""
    import math

    if isinstance(a, float) or isinstance(b, float):
        return (isinstance(a, float) and isinstance(b, float)
                and (a == b or (math.isnan(a) and math.isnan(b))))
    return a == b


def same_scenario_report(got, want, what):
    """A facade cell's report against a direct run's: virtual time,
    drops, and per app every latency figure (count, average, minimum,
    maximum, quartiles) and the communication times."""
    pairs = [("virtual_time_ms", got["virtual_time_ms"],
              want["virtual_time_ms"]),
             ("dropped", got["dropped"], want["dropped"])]
    for part in ("latency", "comm_time"):
        need(got[part].keys() == want[part].keys(),
             f"{what}: {part} apps differ")
        for app, w in want[part].items():
            g = got[part][app]
            need(g.keys() == w.keys(), f"{what}: {part}.{app} keys differ")
            pairs += [(f"{part}.{app}.{k}", g[k], w[k]) for k in w]
    bad = [f"{k}: {a!r} != {b!r}" for k, a, b in pairs
           if not same_value(a, b)]
    need(not bad, f"{what}: {bad}")
    return len(pairs)


def phase_experiment(dev):
    """``paper_1d_experiment``: the experiment facade
    (``repro_torch.union.run``) over ``paper_experiment`` on the card,
    against a store in a temporary directory, with the launch counts set
    to 0 just before and read just after. Each healthy scenario cell's
    report equals its member run alone through ``run_scenario``; each
    trace cell's per-job records equal ``_run_trace_impl``'s for that
    cell alone; the drain tick's and link demand's launches equal the
    ticks replayed; a second ``run`` against the store executes 0 cells
    and returns equal cells, as does ``Results.save`` then ``load``.
    Prints the study's wall s by node kind, member-virtual-ms per wall s
    of the batched node, jobs per wall s of the trace node, the host
    share outside the replays, engine-cache hits and builds, peak device
    memory, ``Plan.describe()``, ``format_results`` and the outage's
    interference matrix against the healthy cells."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import union
    from repro_torch.kernels import ops
    from repro_torch.sched import scheduler as S
    from repro_torch.union import manager as MGR
    from repro_torch.union import planner as PLN
    from repro_torch.union.report import interference_matrix

    t0 = time.perf_counter()
    exp = paper_experiment()
    p0 = time.perf_counter()
    plan = PLN.plan(exp)
    plan_s = time.perf_counter() - p0
    need([(n.kind, len(n.cells)) for n in plan.nodes]
         == [("batched", 8), ("windowed_batch", 4)],
         f"paper_1d_experiment: plan {plan.describe()}")

    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        res = union.run(exp, plan=plan, store=store, device=dev)
        torch.cuda.synchronize()
        counted = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20

        def dumps(cells):
            return [json.dumps(c.to_dict(), sort_keys=True, default=float)
                    for c in cells]

        need(res.telemetry["store"]["misses"] == 12,
             f"paper_1d_experiment: store {res.telemetry['store']}")
        r0 = time.perf_counter()
        again = union.run(exp, store=store, device=dev)
        rerun_s = time.perf_counter() - r0
        need(again.telemetry["store"]["hits"] == 12
             and again.telemetry["store"]["misses"] == 0
             and again.engine_cache["builds"] == 0,
             f"paper_1d_experiment: the rerun executed cells: "
             f"{again.telemetry['store']}, {again.engine_cache}")
        need(dumps(again.cells) == dumps(res.cells),
             "paper_1d_experiment: the store's cells differ")
        path = os.path.join(tmp, "results.json")
        res.save(path)
        need(dumps(union.Results.load(path).cells) == dumps(res.cells),
             "paper_1d_experiment: Results.save/load changed the cells")

    eng_tot = res.telemetry["engine"]
    for kind, tot in eng_tot.items():
        for k in ("drain_tick", "link_demand"):
            need(tot["launches"].get(k, 0) == tot["ticks"] > 0,
                 f"paper_1d_experiment: {kind}: {k} launched "
                 f"{tot['launches'].get(k, 0)} times for {tot['ticks']} "
                 "ticks replayed")
    for k in ("drain_tick", "link_demand"):
        need(counted[k] > 0, f"paper_1d_experiment: no {k} launch counted")

    # the healthy cells against their members run alone
    sc = exp.scenarios[0]
    healthy = [c for c in res.scenario_cells if c.failure == "healthy"]
    need(len(healthy) == 4, "paper_1d_experiment: 4 healthy cells")
    a0 = time.perf_counter()
    compared = 0
    for c in healthy:
        alone = MGR._run_member(dataclasses.replace(sc, placement=c.placement),
                                 seed=c.seed, device=dev)
        compared += same_scenario_report(
            c.report, alone,
            f"paper_1d_experiment: cell {c.key} vs its member alone")
    # the trace cells against each cell alone
    tr = exp.trace.trace
    engine = S.build_sched_engine(tr, device=dev)
    failures = {f.name: f for f in exp.grid.failures}
    for c in res.trace_cells:
        fl = failures[c.failure]
        alone = S._run_trace_impl(
            tr, policy=c.policy, seed=c.seed, engine=engine,
            failure=None if fl.is_healthy else fl)
        rows = [r.to_dict(exp.trace.tau_us) for r in alone.records]
        need(c.report["windows"] == alone.windows
             and len(rows) == len(c.report["per_job"])
             and all(g.keys() == w.keys()
                     and all(same_value(g[k], w[k]) for k in w)
                     for g, w in zip(c.report["per_job"], rows)),
             f"paper_1d_experiment: trace cell {c.key}'s records differ "
             "from the cell alone")
    alone_s = time.perf_counter() - a0

    kinds = res.telemetry["node_kinds"]
    b_wall = kinds["batched"]["wall_s"]
    t_wall = kinds["windowed_batch"]["wall_s"]
    groups = res.summary["scenario_studies"]
    matrix = interference_matrix(
        {p: groups[f"workload1/1d/{p}/ADP/outage"] for p in ("RN", "RG")},
        {p: {app: groups[f"workload1/1d/{p}/ADP"]
             for app in groups[f"workload1/1d/{p}/ADP"]["apps"]}
         for p in ("RN", "RG")})
    emit(dict(
        phase="paper_1d_experiment", seconds=time.perf_counter() - t0,
        horizon_ms=EXPERIMENT_HORIZON_MS, plan_s=plan_s,
        study_wall_s=res.wall_s, node_kinds=kinds,
        batched_member_virtual_ms_per_wall_s=sum(
            c.report["virtual_time_ms"] for c in res.scenario_cells) / b_wall,
        trace_jobs_per_wall_s=sum(
            c.report["jobs"] for c in res.trace_cells) / t_wall,
        trace_completed=[c.report["completed"] for c in res.trace_cells],
        engine={kind: dict(
            tot, device_ms_per_tick=tot["replay_device_ms"]
            / max(tot["ticks"], 1),
            host_share_outside_replays=1.0 - tot["replay_device_ms"] / 1e3
            / kinds[kind]["wall_s"]) for kind, tot in eng_tot.items()},
        study_host_share_outside_replays=1.0 - sum(
            t["replay_device_ms"] for t in eng_tot.values()) / 1e3
        / res.wall_s,
        engine_cache=res.engine_cache, counted_at_capture=counted,
        peak_device_mib=peak, rerun_from_store_s=rerun_s,
        healthy_cells_equal_alone=len(healthy),
        healthy_values_compared=compared,
        trace_cells_equal_alone=len(res.trace_cells), alone_runs_s=alone_s,
        describe=plan.describe().splitlines(),
        format_results=union.format_results(res).splitlines(),
        outage_interference=matrix))
    return {k: sum(t["launches"].get(k, 0) for t in eng_tot.values())
            for k in ("drain_tick", "link_demand", "router_rate_drain",
                      "inject")}


# ---------------------------------------------------------------------------
# member_split: a batched node's members split across devices
# ---------------------------------------------------------------------------

SPLIT_HORIZON_MS = 2.0


def split_experiment():
    """workload1 at the 1D paper scale (33 x 32 x 8, 53,856 links; RG,
    ADP, 5 µs ticks), 4 members of seeds 0-3, to 2 ms: one batched node
    of 4 plain cells."""
    from repro_torch import union
    from repro_torch.union.scenario import mix_scenario

    sc = mix_scenario("workload1", topo="1d", scale="paper", placement="RG",
                      routing="ADP", tick_us=5.0, horizon_ms=SPLIT_HORIZON_MS)
    return union.Experiment(name="member_split", scenarios=[sc], members=4,
                            base_seed=0)


def report_leaves(rep, path="report"):
    """{path: value} of a report's leaves, host-time keys left out."""
    from torch_parity import HOST_TIME_KEYS

    if isinstance(rep, dict):
        out = {}
        for k, v in rep.items():
            if k not in HOST_TIME_KEYS:
                out.update(report_leaves(v, f"{path}.{k}"))
        return out
    if isinstance(rep, (list, tuple)):
        out = {}
        for i, v in enumerate(rep):
            out.update(report_leaves(v, f"{path}[{i}]"))
        return out
    return {path: rep}


def phase_member_split(dev):
    """``member_split``: ``split_experiment`` through the facade
    (``repro_torch.union.run``) with the device list of a one-card host
    (one stacked B = 4 ``run``), then with ``local_devices`` patched to
    ``[cuda:0, cuda:0]`` (two replicas of B = 2 through ``Engine.prun``,
    in turn on one engine), then, on a host of several cards, over the
    real cards (replicas at once, one thread a card); the counts set to 0
    just before each run and read just after. Each split cell's report
    equals the stacked one's under ``torch_parity``'s contract (report
    fields and integers exact, other floats to rtol 1e-5; the drain
    tick's router windows are float atomics); on the split runs the drain
    tick's and link demand's launches equal their calls and the ticks on
    every replica. Prints each run's wall, member-virtual-ms per wall s,
    the engine's totals and which report leaves came out bit for bit.
    Returns the split runs' launches of both kernels."""
    import torch

    from repro_torch import device as DEV
    from repro_torch import union
    from repro_torch.kernels import ops
    from repro_torch.netsim import engine as ENG
    from torch_parity import report_mismatches

    t0 = time.perf_counter()
    exp = split_experiment()
    host = DEV.local_devices(dev)
    runs = [("stacked", [dev]), ("split_one_card", [dev, dev])]
    if len(host) > 1:
        runs.append(("split_cards", host))
    real = DEV.local_devices
    rows, base, split_launches = {}, None, {}
    try:
        for label, devs in runs:
            DEV.local_devices = lambda device=None, devs=devs: list(devs)
            torch.cuda.synchronize()
            ops.reset_launches()
            w0 = time.perf_counter()
            res = union.run(exp, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            counted = dict(launches=dict(ops.LAUNCHES), calls=dict(ops.CALLS))
            tot = res.telemetry["engine"]["batched"]
            need(len(res.cells) == 4 and tot["calls"] == 1,
                 f"member_split/{label}: {len(res.cells)} cells, "
                 f"{tot['calls']} engine calls")
            for k in ("drain_tick", "link_demand"):
                need(tot["launches"].get(k, 0) == tot["ticks"] > 0,
                     f"member_split/{label}: {k} launched "
                     f"{tot['launches'].get(k, 0)} times for "
                     f"{tot['ticks']} ticks")
            row = dict(devices=[str(d) for d in devs], wall_s=wall,
                       node_wall_s=res.telemetry["node_kinds"]["batched"]
                       ["wall_s"],
                       member_virtual_ms_per_wall_s=sum(
                           c.report["virtual_time_ms"] for c in res.cells)
                       / res.telemetry["node_kinds"]["batched"]["wall_s"],
                       engine=tot, engine_cache=res.engine_cache,
                       counted_at_capture=counted)
            if label == "stacked":
                base = res
                rows[label] = row
                continue
            # the replicas' own stats (Engine.prun's merged RunStats)
            split = [e.last_run for e in ENG._ENGINE_CACHE.values()
                     if e.last_run is not None and e.last_run.replicas]
            need(len(split) == 1 and len(split[0].replicas) == len(devs),
                 f"member_split/{label}: no prun of {len(devs)} replicas")
            replicas = []
            for r in split[0].replicas:
                launched = {k: r.replays * r.graph_launches.get(k, 0)
                            for k in ("drain_tick", "link_demand")}
                calls = {k: r.replays * r.graph_calls.get(k, 0)
                         for k in ("drain_tick", "link_demand")}
                need(all(launched[k] == calls[k] == r.ticks > 0
                         for k in launched),
                     f"member_split/{label}: a replica launched {launched} "
                     f"for {calls} calls and {r.ticks} ticks")
                replicas.append(dict(ticks=r.ticks, replays=r.replays,
                                     launches=launched,
                                     device_ms=r.replay_device_ms))
            for k in ("drain_tick", "link_demand"):
                need(counted["launches"].get(k, 0) > 0,
                     f"member_split/{label}: no {k} launch counted")
            # each cell against the stacked run's
            bit, leaves, not_bit = 0, 0, []
            for got, want in zip(res.cells, base.cells):
                need(got.key == want.key,
                     f"member_split/{label}: cell {got.key} != {want.key}")
                bad = report_mismatches(got.report, want.report,
                                        f"cell {got.key}")
                need(not bad, f"member_split/{label}: {bad[:10]}")
                g, w = report_leaves(got.report), report_leaves(want.report)
                leaves += len(w)
                same = [p for p in w if same_value(g[p], w[p])]
                bit += len(same)
                not_bit += [f"{got.key}:{p}" for p in w if p not in same]
            split_launches[label] = {k: tot["launches"].get(k, 0)
                                     for k in ("drain_tick", "link_demand",
                                               "inject")}
            rows[label] = dict(row, replicas=replicas,
                               report_leaves=leaves, bit_for_bit=bit,
                               not_bit_for_bit=not_bit[:40])
            print(f"member_split/{label}: {bit} of {leaves} report leaves "
                  f"bit for bit; wall {wall:.3f} s against the stacked "
                  f"{rows['stacked']['wall_s']:.3f} s", flush=True)
    finally:
        DEV.local_devices = real
    emit(dict(phase="member_split", seconds=time.perf_counter() - t0,
              workload="workload1", horizon_ms=SPLIT_HORIZON_MS, members=4,
              host_devices=len(host), runs=rows))
    return split_launches["split_one_card"]


def phase_fabrics(dev):
    """``paper_fabrics``: workload1 + UR at the paper scale on the fat tree
    (k = 32, 8,192 hosts, route width 6) and the torus (11 x 12 x 16 x 4,
    8,448 hosts, route width 21), each as ``phase_paper`` runs the
    dragonflies (counted through ``run_sim``, the eager loop's digests
    against a graph run, the live pool's kernels against their plain
    versions), with the first 64 eager ticks held to the CPU path.
    Returns each fabric's drain-tick and link-demand launches."""
    out = {}
    for cfg in PAPER_FABRICS:
        launches, delivered = phase_paper(
            f"paper_fabrics/{cfg['topo']}", cfg, dev, phase="paper_fabrics",
            cpu_ticks=FABRIC_CARD_VS_CPU_TICKS)
        free_engines()
        need(sum(delivered.values()) > 0,
             f"paper_fabrics/{cfg['topo']}: nothing delivered")
        out[cfg["topo"]] = launches
    return out


TINY_SCENARIO = dict(
    name="tiny", placement="RN", tick_us=2.0, horizon_ms=50.0,
    pool_size=256,
    jobs=[dict(app="pp", ranks=2, source=(
        "For 4 repetitions { task 0 sends a 1024 byte message to task 1 "
        "then task 1 sends a 1024 byte message to task 0 }"))])


def phase_front_doors(dev):
    """``union_front_doors``: the CLI (``repro_torch.union.cli.main``) on
    a three-member campaign of the tiny scenario, and the Union server on
    ``127.0.0.1`` (an ephemeral port, its worker on the card) with one
    submission of that experiment through the client and one cancellation
    (a second submission held at its first node, cancelled there). The
    CLI's result file and the server's Results must equal ``union.run``
    of the same spec, cell for cell (``same_scenario_report``); the
    cancelled job ends ``cancelled`` with no cell run and no Results."""
    import contextlib
    import io
    import tempfile
    import threading

    from repro_torch import union
    from repro_torch.union import cli as CLI
    from repro_torch.union.client import ServeClient, ServeError
    from repro_torch.union.serve import make_server

    t0 = time.perf_counter()
    sc = union.Scenario.from_dict(TINY_SCENARIO)
    exp = union.Experiment(name="tiny", scenarios=[sc], members=3)
    want = union.run(exp, device=dev)

    def same_cells(got, what):
        need(len(got.cells) == len(want.cells), f"{what}: cell counts")
        for g, w in zip(got.cells, want.cells):
            need(g.key == w.key, f"{what}: cell {g.key} != {w.key}")
            same_scenario_report(g.report, w.report, f"{what} {g.key}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny.json")
        with open(path, "w") as f:
            json.dump(TINY_SCENARIO, f)
        out_dir = os.path.join(tmp, "out")
        printed = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            CLI.main(["--scenario", path, "--members", "3", "--out",
                      out_dir, "--device", str(dev)])
        cli_s = time.perf_counter() - t1
        files = os.listdir(out_dir)
        need(files == ["tiny__1d__RN__ADP__small__m3_s0.json"],
             f"CLI wrote {files}")
        same_cells(union.Results.load(os.path.join(out_dir, files[0])),
                   "CLI")

    class Gate:
        """Holds the worker at the first node of a job named
        ``cancel-me`` until released."""

        def __init__(self):
            self.paused = threading.Event()
            self.release = threading.Event()

        def __call__(self, job):
            if job.experiment.name == "cancel-me":
                self.paused.set()
                need(self.release.wait(timeout=120), "gate never released")

    gate = Gate()
    srv = make_server(host="127.0.0.1", port=0, node_hook=gate, device=dev)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    try:
        c = ServeClient(f"http://127.0.0.1:{srv.port}")
        t1 = time.perf_counter()
        job = c.submit(exp)
        st = c.wait(job, timeout=300, poll_s=0.05)
        need(st["status"] == "done", f"server job ended {st}")
        same_cells(c.results(job), "server")
        serve_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        held = c.submit(union.Experiment(name="cancel-me", scenarios=[sc],
                                         members=3))
        need(gate.paused.wait(timeout=120), "the worker never took the job")
        need(c.status(held)["status"] == "running", "held job not running")
        c.cancel(held)
        gate.release.set()
        st2 = c.wait(held, timeout=120, poll_s=0.05)
        need(st2["status"] == "cancelled" and st2["cells_completed"] == 0,
             f"cancelled job ended {st2}")
        try:
            c.results(held)
            need(False, "a cancelled job returned Results")
        except ServeError as e:
            need(e.status == 409, f"results of a cancelled job: {e}")
        cancel_s = time.perf_counter() - t1
        health = c.health()
    finally:
        gate.release.set()
        srv.close()
        serving.join(timeout=30)
    need(not serving.is_alive(), "the server thread did not stop")
    emit(dict(phase="union_front_doors", seconds=time.perf_counter() - t0,
              cells=len(want.cells), cli_s=cli_s,
              cli_printed=printed.getvalue().splitlines(),
              server_submit_to_results_s=serve_s, server_cancel_s=cancel_s,
              server_jobs=health["jobs"], engine_cache=health["engine_cache"],
              equal_to_union_run=True))


# ---------------------------------------------------------------------------
# phases 9-13: language-model serving
# ---------------------------------------------------------------------------

def agreement(params, cfg, tokens, dev):
    """Share of positions where the chunked forward's greedy token equals
    the one token-by-token decode gives (the check tests/test_models.py
    applies to the JAX package)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import model as MDL

    h, _ = MDL.forward_hidden(params, tokens, cfg)
    need(bool(h.float().isfinite().all()), f"{cfg.compute_dtype}: hidden "
         "state not finite")
    full = torch.argmax(L.mask_padded_vocab(
        L.logits_from_hidden(params, h, cfg).float(), cfg), dim=-1)
    state = MDL.init_decode_state(cfg, tokens.shape[0], tokens.shape[1],
                                  dtype=torch.float32, device=dev)
    preds = []
    for t in range(tokens.shape[1]):
        nxt, state = MDL.decode_step(params, state, tokens[:, t], cfg)
        preds.append(nxt)
    return float((torch.stack(preds, 1) == full).float().mean())


def lm_tokens(cfg, B, S, seed, dev):
    import numpy as np
    import torch

    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32), device=dev)


def counted_prefill(params, cfg, tokens, steps, what):
    """``make_prefill_step`` once to warm up, then ``steps`` times with the
    launch counts set to 0 just before and read just after and the peak
    memory reset: (tokens, wall seconds a step, {kernel: (launches,
    calls)}, peak MiB). Every call on the card must have launched."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train.serve_step import make_prefill_step

    prefill = make_prefill_step(cfg)
    prefill(params, tokens)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    walls = []
    for _ in range(steps):
        t1 = time.perf_counter()
        out = prefill(params, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    counts = {k: (ops.LAUNCHES[k], ops.CALLS[k]) for k in ops.KERNELS}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    for k, (n, c) in counts.items():
        need(n == c, f"{what}: {n} {k} launches for {c} calls")
    need(tuple(out.shape) == (tokens.shape[0],) and out.dtype == torch.int32
         and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
         f"{what}: tokens {out}")
    return out, walls, counts, peak_mib


def step_profile(fn, top=10, want=None, what=""):
    """One call of ``fn`` under the profiler: wall and device ms, the
    device's busy share, device kernels, the ``top`` kernels; and the
    profiler's rows. With ``want`` (kernel name to runs), the profile must
    show those runs (``counted_profile``)."""
    if want is None:
        _, wall_us, rows = device_profile(fn)
        short = []
    else:
        _, wall_us, rows, short = counted_profile(fn, lambda: want, what)
    busy_us = sum(r[0] for r in rows)
    return dict(wall_ms=wall_us / 1e3, device_ms=busy_us / 1e3,
                device_busy_share=busy_us / wall_us,
                device_kernels=sum(r[1] for r in rows),
                top=[dict(name=k[:70], ms=us / 1e3, calls=c)
                     for us, c, k in rows[:top]],
                short_profiles=short), rows


def phase_lm_prefill(dev, steps=3):
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.train.serve_step import make_prefill_step

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    params = MDL.init_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    B, S = 8, 4096
    tokens = lm_tokens(cfg, B, S, 0, dev)
    out, walls, counts, peak_mib = counted_prefill(params, cfg, tokens,
                                                   steps, "lm_prefill")
    launches, calls = counts["ssd_scan"]
    router_launches = counts["router_rate_drain"][0]
    need(launches == calls == cfg.n_layers * steps,
         f"lm_prefill: {launches} scan launches for {calls} calls, want "
         f"{cfg.n_layers} a step")
    step_s = sorted(walls)[len(walls) // 2]
    prefill = make_prefill_step(cfg)
    # the profiled step runs each of the scan's kernels once a layer
    prof, rows = step_profile(
        lambda: prefill(params, tokens),
        want={name: cfg.n_layers for name in SSD_KERNELS},
        what="lm_prefill: the profiled step's scan kernels")
    scan_us = {name: sum(r[0] for r in rows if name in r[2])
               for name in SSD_KERNELS}
    prof.update(ssd_scan_share_of_device=sum(scan_us.values())
                / (prof["device_ms"] * 1e3),
                ssd_scan_device_ms={k: us / 1e3 for k, us in scan_us.items()})

    # forward vs decode on the card, float32 compute (the same weights)
    toks = lm_tokens(cfg, 2, 64, 1, dev)
    agree32 = agreement(params, cfg.replace(compute_dtype="float32"), toks,
                        dev)
    need(agree32 >= 0.95, f"lm_prefill: forward/decode agreement {agree32} "
         "below 0.95 in float32")
    agree16 = agreement(params, cfg, toks, dev)
    emit(dict(phase="lm_prefill", seconds=time.perf_counter() - t0,
              arch=LM_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
              params=n_params, param_dtype=cfg.param_dtype,
              compute_dtype=cfg.compute_dtype, batch=B, seq=S, steps=steps,
              step_s=walls, prefill_tokens_per_s=B * S / step_s,
              ssd_scan_calls=calls, ssd_scan_launches=launches,
              router_rate_drain_launches=router_launches,
              peak_device_mib=peak_mib, first_tokens=out.tolist(),
              profile=prof,
              agreement_f32=agree32, agreement_bf16=agree16))
    return params, cfg, dict(ssd_scan=launches,
                             router_rate_drain=router_launches)


def phase_lm_serve(params, cfg, dev, phase="lm_serve"):
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.train.serve_step import make_decode_state, make_decode_step

    t0 = time.perf_counter()
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, 16), dtype=np.int32)
    serve(params, cfg, prompts[:1], slots=4, gen_len=2, device=dev)  # warm-up
    outputs, st = serve(params, cfg, prompts, slots=4, gen_len=24, device=dev)
    need(sorted(outputs) == list(range(8))
         and all(len(v) == 24 and all(0 <= t < cfg.vocab_size for t in v)
                 for v in outputs.values()), f"{phase}: outputs")
    # one decode step of 4 slots under the profiler
    state = make_decode_state(cfg, 4, 40, dtype=torch.float32, device=dev)
    tok = torch.as_tensor(prompts[:4, 0], device=dev)
    step = make_decode_step(cfg)
    step(params, state, tok)
    prof, _ = step_profile(lambda: step(params, state, tok), top=5)
    emit(dict(phase=phase, seconds=time.perf_counter() - t0,
              arch=cfg.name, slots=4, requests=st["requests"], prompt_len=16,
              gen_len=24, waves=st["waves"], decode_steps=st["decode_steps"],
              served_tokens=st["tokens"], wall_s=st["wall_s"],
              served_tokens_per_s=st["tokens"] / st["wall_s"],
              decode_tokens_per_s=st["decode_steps"] * 4 / st["wall_s"],
              first_request=outputs[0], decode_step_profile=prof))


# the model's parts a prefill step is split into, as (module, function):
# the model and the layers call each through its module, so a wrapper set
# on the module sees every call
PARTS = (("layers", "chunked_attention"), ("layers", "apply_mlp"),
         ("moe", "apply_moe"), ("mamba2", "mamba_forward"))


def part_ms(fn, parts=PARTS):
    """One call of ``fn`` with CUDA events recorded around every call of
    each of ``parts`` and around the whole: the whole's ms and, for each
    part, its calls, ms and share of the whole. A part's time runs from its first kernel's start to its
    last's end on the stream, idle gaps included, so it is device time
    only where the device is busy (a prefill step is, 97-99 %)."""
    import importlib

    import torch

    marks, saved = [], []

    def timed(name, f):
        def call(*args, **kw):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            t0.record()
            out = f(*args, **kw)
            t1.record()
            marks.append((name, t0, t1))
            return out
        return call

    for mod_name, name in parts:
        mod = importlib.import_module(f"repro_torch.models.{mod_name}")
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timed(name, getattr(mod, name)))
    try:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    sums = {}
    for name, a, b in marks:
        entry = sums.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += a.elapsed_time(b)
    whole = t0.elapsed_time(t1)
    return dict(whole_ms=whole, parts={
        k: dict(calls=n, ms=ms, share=ms / whole)
        for k, (n, ms) in sums.items()})


def phase_lm_prefill_dense(dev, steps=3):
    """``mistral_nemo_12b`` at full width and depth (12.2 B float32
    parameters, bfloat16 compute) through ``make_prefill_step`` on 2
    requests x 4,096 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.train.serve_step import make_prefill_step

    t0 = time.perf_counter()
    cfg = get_config(DENSE_ARCH)
    params = MDL.init_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    B, S = 2, 4096
    tokens = lm_tokens(cfg, B, S, 0, dev)
    out, walls, counts, peak_mib = counted_prefill(
        params, cfg, tokens, steps, "lm_prefill_dense")
    step_s = sorted(walls)[len(walls) // 2]
    prefill = make_prefill_step(cfg)
    prof, _ = step_profile(lambda: prefill(params, tokens))
    prof["parts"] = part_ms(lambda: prefill(params, tokens))
    toks = lm_tokens(cfg, 2, 64, 1, dev)
    agree32 = agreement(params, cfg.replace(compute_dtype="float32"), toks,
                        dev)
    need(agree32 >= 0.95, f"lm_prefill_dense: forward/decode agreement "
         f"{agree32} below 0.95 in float32")
    agree16 = agreement(params, cfg, toks, dev)
    emit(dict(phase="lm_prefill_dense", seconds=time.perf_counter() - t0,
              arch=DENSE_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
              heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
              vocab=cfg.vocab_size, params=n_params,
              param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
              batch=B, seq=S, steps=steps, step_s=walls,
              prefill_tokens_per_s=B * S / step_s,
              launches={k: n for k, (n, _) in counts.items()},
              peak_device_mib=peak_mib, first_tokens=out.tolist(),
              profile=prof, agreement_f32=agree32, agreement_bf16=agree16))
    return params, cfg


# each other decoder-only architecture at full width: its depth (cut to
# fit one card and keep the phase short) and its prefill length
FAMILIES = (
    ("command_r_35b", 4, 4096),  # LayerNorm, tied, vocab 256,000
    ("mistral_large_123b", 4, 4096),  # bfloat16 weights
    ("nemotron_4_340b", 2, 4096),  # squared ReLU, d_head 192, LayerNorm
    ("mixtral_8x22b", 4, 6144),  # 8 experts top-2; the 4,096-key window
    ("granite_moe_3b_a800m", 8, 4096),  # 40 experts top-8
    ("jamba_v01_52b", 8, 4096),  # one whole period: Mamba, attention, MoE
)


def recorded_scan_inputs():
    """Wrap ``ops.ssd_scan`` (through which the Mamba-2 mixer calls it) so
    that the first call's inputs are kept; returns (the kept list, a
    function that restores the wrapper)."""
    from repro_torch.kernels import ops

    kept, orig = [], ops.ssd_scan

    def keep(*args):
        if not kept:
            kept.extend(a.clone() for a in args)
        return orig(*args)

    ops.ssd_scan = keep
    return kept, lambda: setattr(ops, "ssd_scan", orig)


def phase_lm_families(dev):
    """Each of the other six decoder-only architectures at full width and
    the depth of ``FAMILIES``: a counted prefill of one request, forward
    against decode in float32 over 2 x 64 tokens, a serve of 4 requests.
    Returns the SSD scan's launches in jamba's counted prefill."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as MDL
    from repro_torch.models.moe import no_drop
    from repro_torch.train.serve_step import make_prefill_step

    scan = None
    for arch, layers, S in FAMILIES:
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(n_layers=layers)
        params = MDL.init_model(cfg, seed=0, device=dev)
        n_params = sum(p.numel() for p in params.parameters())
        init_s = time.perf_counter() - t0
        tokens = lm_tokens(cfg, 1, S, 0, dev)
        kept, restore = recorded_scan_inputs()
        try:
            out, walls, counts, peak_mib = counted_prefill(
                params, cfg, tokens, 1, arch)
        finally:
            restore()
        prefill = make_prefill_step(cfg)
        prof, _ = step_profile(lambda: prefill(params, tokens), top=5)
        prof["parts"] = part_ms(lambda: prefill(params, tokens))
        line = dict(phase="lm_families", arch=arch, layers=layers,
                    d_model=cfg.d_model, params=n_params,
                    param_dtype=cfg.param_dtype, init_s=init_s, seq=S,
                    step_s=walls[0], prefill_tokens_per_s=S / walls[0],
                    launches={k: n for k, (n, _) in counts.items()},
                    peak_device_mib=peak_mib, first_token=out.tolist(),
                    profile=prof)
        n_mamba = sum(s.kind == "mamba" for s in cfg.period) * cfg.n_periods
        need(counts["ssd_scan"] == (n_mamba, n_mamba),
             f"{arch}: ssd_scan {counts['ssd_scan']} (launches, calls), want "
             f"{n_mamba} each")
        if n_mamba:
            # the kernel against its plain version on the first Mamba
            # layer's input, as the warm-up prefill gave it
            yk, hk = ssd_scan_cuda(*kept)
            yp, hp = ssd_scan_plain(*kept)
            torch.cuda.synchronize()
            scan = dict(launches=counts["ssd_scan"][0],
                        shape=dict(BH=kept[0].shape[0], groups=kept[3].shape[0],
                                   nc=kept[0].shape[1], Q=kept[0].shape[2],
                                   hd=kept[0].shape[3], ds=kept[3].shape[3]),
                        max_abs_err=max(ssd_check(yk, yp, f"{arch} y"),
                                        ssd_check(hk, hp, f"{arch} h")))
            line["ssd_scan"] = scan
            del yk, hk, yp, hp
        del kept
        toks = lm_tokens(cfg, 2, 64, 1, dev)
        f32 = cfg.replace(compute_dtype="float32")
        line["agreement_f32"] = agreement(params, no_drop(f32), toks, dev)
        need(line["agreement_f32"] >= 0.95, f"{arch}: forward/decode "
             f"agreement {line['agreement_f32']} below 0.95 in float32")
        if cfg.moe_num_experts:
            line["moe_capacity_factor_for_agreement"] = \
                cfg.moe_num_experts / cfg.moe_top_k
            line["agreement_f32_config_capacity"] = agreement(
                params, f32, toks, dev)
        prompts = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (4, 8), dtype=np.int32)
        outputs, st = serve(params, cfg, prompts, slots=4, gen_len=8,
                            device=dev)
        need(sorted(outputs) == list(range(4))
             and all(len(v) == 8 and all(0 <= t < cfg.vocab_size for t in v)
                     for v in outputs.values()), f"{arch}: serve outputs")
        line.update(served_tokens=st["tokens"], serve_wall_s=st["wall_s"],
                    seconds=time.perf_counter() - t0)
        emit(line)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    need(scan is not None, "lm_families: no Mamba layer ran the scan")
    return scan


# ---------------------------------------------------------------------------
# the SSD scan's backward against autograd through its plain version
# ---------------------------------------------------------------------------

SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def ssd_bwd_check(got, args, dy, what):
    """Each output of the backward kernel against autograd through the
    plain scan in float32: within SSD_RTOL |plain| + SSD_ATOL_OF_MAX
    max|plain|, or, where summation order alone breaks that, its largest
    error to a float64 plain version at most twice the float32 plain
    version's. Returns, per output, both errors to float64 and the
    largest difference from the float32 plain version."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain

    want = ssd_scan_bwd_plain(*args, dy)
    want64 = ssd_scan_bwd_plain(*(a.double() for a in args), dy.double())
    rows = {}
    for name, g, w, w64 in zip(SSD_BWD_NAMES, got, want, want64):
        err = (g - w).abs()
        within = bool((err <= SSD_RTOL * w.abs()
                       + SSD_ATOL_OF_MAX * float(w.abs().max())).all())
        e64 = float((g.double() - w64).abs().max())
        p64 = float((w.double() - w64).abs().max())
        need(bool(g.isfinite().all()) and (within or e64 <= 2 * p64),
             f"ssd_scan_bwd {what} {name}: max diff {float(err.max())} "
             f"beyond the tolerance, and {e64} from float64 against the "
             f"plain version's {p64}")
        rows[name] = dict(max_abs_err=float(err.max()), within_tol=within,
                          kernel_err_f64=e64, plain_err_f64=p64)
        del err
    del want, want64
    torch.cuda.empty_cache()
    return rows


def ssd_bwd_bound_ms(x, Bm):
    """The least time for one backward call: its products (the causal
    halves of dM, (dM ∘ L) B, (dM ∘ L)ᵀ C and (C Bᵀ ∘ L)ᵀ dy per row and
    chunk, C Bᵀ's causal half once per group and chunk, and per row and
    chunk B dh, dy h_inᵀ, (x·dt) dhᵀ, Cᵀ(exp(cs) ∘ dy) and the state
    recomputation, Q·ds·hd each; the exp(cs) term of d cs is a row sum of
    C ∘ (dy h_inᵀ), so C h_in is not needed), three TF32 products each
    (3xTF32) at the tensor cores' TF32 rate, against the inputs (x, dt, A,
    B, C, dy) read once and the outputs (dx, ddt, dA, dB, dC) written
    once; the larger of the two. Returns it, what bounds it, the FLOPs,
    the bytes, and the bound at the float32 rate outside the tensor cores
    (the same products as single float32 FMAs)."""
    BH, nc, Q, hd = x.shape
    G, ds = Bm.shape[0], Bm.shape[-1]
    tri = Q * (Q + 1) // 2
    flops = 2 * (G * nc * tri * ds
                 + BH * nc * (tri * (2 * hd + 2 * ds) + 5 * Q * ds * hd))
    moved = 4 * (3 * BH * nc * Q * hd          # x, dy; dx
                 + 2 * BH * nc * Q + 2 * BH    # dt, A; ddt, dA
                 + 4 * G * nc * Q * ds)        # B, C; dB, dC
    by_ops = 3 * flops / TF32_OPS_PER_S * 1e3
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes
            else "bytes", flops, moved,
            max(flops / FP32_OPS_PER_S * 1e3, by_bytes))


def phase_ssd_bwd(dev, B=8, nh=32, hd=64, ds=128, Q=128, S=4096, Sr=4000):
    """The backward kernel at the training shapes of ``mamba2_370m`` (8
    sequences x 32 heads, 4,096 tokens, one group of B/C per sequence),
    at a ragged 4,000 (the last chunk's 96 pad rows: dt, x, B, C and dy 0
    there, every gradient of them exactly 0) and at jamba's group shape
    (``ds`` 16, 128 heads of 64 sharing one group)."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan import (
        SSD_BWD_KERNELS, ssd_scan_bwd_cuda, ssd_scan_bwd_occupancy,
        ssd_scan_bwd_plain, ssd_scan_bwd_stages)

    t0 = time.perf_counter()
    nc = S // Q

    def dy_like(x, seed):
        return torch.as_tensor(np.random.default_rng(seed).standard_normal(
            tuple(x.shape)).astype(np.float32), device=dev)

    args = ssd_inputs(B * nh, B, nc, Q, hd, ds, 21, dev)
    dy = dy_like(args[0], 22)
    inter = {}
    got = ssd_scan_bwd_cuda(*args, dy, scratch=inter)
    again = ssd_scan_bwd_cuda(*args, dy)
    torch.cuda.synchronize()
    repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    need(repeat_equal, "ssd_scan_bwd: two calls on the same inputs differ")
    del again
    # the intermediates against the plain mirror of the stages
    mirror = ssd_scan_bwd_stages(*args, dy)
    stages = {}
    for k in ("h_in", "dh_out"):
        want = mirror[k]
        err = (inter[k] - want).abs()
        ok = bool((err <= SSD_RTOL * want.abs()
                   + SSD_ATOL_OF_MAX * float(want.abs().max())).all())
        need(ok, f"ssd_scan_bwd {k}: max diff {float(err.max())} from the "
             "plain mirror beyond the tolerance")
        stages[k] = float(err.max())
    del mirror, inter, err, want
    main = ssd_bwd_check(got, args, dy, "train shapes")
    del got
    kernel_ms = time_ms(lambda: ssd_scan_bwd_cuda(*args, dy), reps=5,
                        warmup=1)
    plain_ms = time_ms(lambda: ssd_scan_bwd_plain(*args, dy), reps=3,
                       warmup=1)
    bound_ms, bound_by, flops, moved, fp32_bound_ms = ssd_bwd_bound_ms(
        args[0], args[3])
    _, _, rows = device_profile(lambda: ssd_scan_bwd_cuda(*args, dy))
    kernel_device_ms = {name: sum(r[0] for r in rows
                                  if kernel_named(r[2], name)) / 1e3
                        for name in SSD_BWD_KERNELS}
    del args, dy
    torch.cuda.empty_cache()

    # ragged: S = 4,000 padded to 32 chunks, the pad rows as the mixer
    # makes them
    pad = S - Sr
    rng = np.random.default_rng(23)
    raw = [a.cpu().numpy() for a in ssd_inputs(B * nh, B, nc, Q, hd, ds, 24,
                                               "cpu")]
    for i in (0, 1):  # x, dt
        raw[i].reshape(B * nh, S, -1)[:, -pad:] = 0.0
    for i in (3, 4):  # B, C
        raw[i].reshape(B, S, -1)[:, -pad:] = 0.0
    args = [torch.as_tensor(a, device=dev) for a in raw]
    dy = torch.as_tensor(rng.standard_normal((B * nh, nc, Q, hd)).astype(
        np.float32), device=dev)
    dy.view(B * nh, S, hd)[:, -pad:] = 0.0
    got = ssd_scan_bwd_cuda(*args, dy)
    torch.cuda.synchronize()
    for name, g in zip(SSD_BWD_NAMES, got):
        if name != "dA":
            tail = g.reshape(g.shape[0], S, -1)[:, -pad:]
            need(bool((tail == 0).all()), f"ssd_scan_bwd ragged: {name} of "
                 "the pad rows not 0")
    ragged = ssd_bwd_check(got, args, dy, f"ragged S={Sr}")
    del got, args, dy

    # jamba's group shape: one group of B/C for 128 heads, ds 16
    jargs = ssd_inputs(128, 1, nc, Q, 64, 16, 25, dev)
    jdy = dy_like(jargs[0], 26)
    jamba = ssd_bwd_check(ssd_scan_bwd_cuda(*jargs, jdy), jargs, jdy,
                          "jamba group")
    jamba_ms = time_ms(lambda: ssd_scan_bwd_cuda(*jargs, jdy), reps=5,
                       warmup=1)
    del jargs, jdy
    torch.cuda.empty_cache()
    err = max(r["max_abs_err"] for d in (main, ragged, jamba)
              for r in d.values())
    emit(dict(phase="ssd_scan_bwd_vs_plain", seconds=time.perf_counter() - t0,
              BH=B * nh, groups=B, nc=nc, Q=Q, hd=hd, ds=ds, ragged_S=Sr,
              rtol=SSD_RTOL, atol_of_max=SSD_ATOL_OF_MAX,
              train_shapes=main, ragged=ragged, jamba_group=jamba,
              kernel_ms=kernel_ms, plain_ms=plain_ms,
              plain_is="autograd through ssd_scan_plain: its forward and "
                       "backward",
              bound_ms=bound_ms, bound_by=bound_by,
              bound_unit="3xTF32 on the tensor cores",
              fp32_bound_ms=fp32_bound_ms, gflop=flops / 1e9,
              bytes=moved, tflop_per_s=flops / 1e9 / kernel_ms,
              share_of_bound=bound_ms / kernel_ms,
              kernel_device_ms=kernel_device_ms, jamba_kernel_ms=jamba_ms,
              stages_max_abs_err=stages, repeat_bit_equal=repeat_equal,
              occupancy=ssd_scan_bwd_occupancy(Q, hd, ds),
              jamba_occupancy=ssd_scan_bwd_occupancy(Q, 64, 16)))
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# encoder-decoder and vision-language serving
# ---------------------------------------------------------------------------

# what a step of an encoder-decoder or a VLM is split into (see part_ms);
# the MLP's calls include the encoder's (inside ``encode``)
ENCDEC_PARTS = (("model", "encode"), ("layers", "attention_cross"),
                ("layers", "attention_train"), ("layers", "apply_mlp"))
# (arch, batch, text tokens of the batched prefill)
ENCDEC = (("whisper_medium", 4, 448), ("internvl2_1b", 4, 1024))


def frontend_embeds(cfg, B, seed, dev):
    """Random frame (encoder) or patch embeddings (B, P, d), float32."""
    import numpy as np
    import torch

    P = cfg.enc_seq if cfg.enc_layers else cfg.num_patches
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32), device=dev)


def encdec_agreement(params, cfg, tokens, frames, dev):
    """The forward's greedy tokens against token-by-token decode (with
    the cross K/V of ``frames`` for an encoder-decoder; text alone for the
    VLM, whose decode has no patch path), as ``agreement``."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import model as MDL

    fe = frames if cfg.enc_layers else None
    h, _ = MDL.forward_hidden(params, tokens, cfg, frontend_embeds=fe)
    need(bool(h.float().isfinite().all()), f"{cfg.name}: hidden state not "
         "finite")
    full = torch.argmax(L.mask_padded_vocab(
        L.logits_from_hidden(params, h, cfg).float(), cfg), dim=-1)
    state = MDL.init_decode_state(cfg, tokens.shape[0], tokens.shape[1],
                                  dtype=torch.float32, device=dev)
    state, first = MDL.prefill(params, state, tokens[:, :1], cfg,
                               frontend_embeds=fe)
    preds = [first]
    for t in range(1, tokens.shape[1]):
        nxt, state = MDL.decode_step(params, state, tokens[:, t], cfg)
        preds.append(nxt)
    return float((torch.stack(preds, 1) == full).float().mean())


def phase_lm_encdec(dev, steps=3):
    """``whisper_medium`` and ``internvl2_1b`` at full width and depth:
    a batched prefill with random frame or patch embeddings, whisper's
    prefill with the cross K/V and decode, the serve loop, forward against
    decode."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as MDL
    from repro_torch.train.serve_step import make_prefill_step

    for arch, B, S in ENCDEC:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        params = MDL.init_model(cfg, seed=0, device=dev)
        n_params = sum(p.numel() for p in params.parameters())
        tokens = lm_tokens(cfg, B, S, 0, dev)
        fe = frontend_embeds(cfg, B, 1, dev)
        prefill = make_prefill_step(cfg)
        prefill(params, tokens, fe)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        walls = []
        for _ in range(steps):
            t1 = time.perf_counter()
            out = prefill(params, tokens, fe)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        launches = {k: (ops.LAUNCHES[k], ops.CALLS[k]) for k in ops.KERNELS}
        need(all(n == c == 0 for n, c in launches.values()),
             f"{arch}: kernel calls {launches} (no hand-written kernel is on "
             "this path)")
        need(tuple(out.shape) == (B,) and bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()), f"{arch}: {out}")
        step_s = sorted(walls)[len(walls) // 2]
        prof, _ = step_profile(lambda: prefill(params, tokens, fe), top=5)
        prof["parts"] = part_ms(lambda: prefill(params, tokens, fe),
                                ENCDEC_PARTS)
        line = dict(phase="lm_encdec", arch=arch, layers=cfg.n_layers,
                    enc_layers=cfg.enc_layers, d_model=cfg.d_model,
                    heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                    vocab=cfg.vocab_size, params=n_params,
                    frontend=tuple(fe.shape), batch=B, text=S, steps=steps,
                    step_s=walls,
                    prefill_tokens_per_s=B * (S + cfg.num_patches) / step_s,
                    peak_device_mib=peak_mib, first_tokens=out.tolist(),
                    profile=prof)
        if cfg.enc_layers:
            # prefill with the cross K/V cache, then 8 greedy steps
            state = MDL.init_decode_state(cfg, B, 24, dtype=torch.float32,
                                          device=dev)
            t1 = time.perf_counter()
            state, tok = MDL.prefill(params, state, tokens[:, :16], cfg,
                                     frontend_embeds=fe)
            for _ in range(8):
                tok, state = MDL.decode_step(params, state, tok, cfg)
            torch.cuda.synchronize()
            need(len(state["xkv"]) == cfg.n_periods
                 and tuple(state["xkv"][0]["pos0"][0].shape)
                 == (B, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head),
                 f"{arch}: cross K/V {state['xkv'][0]['pos0'][0].shape}")
            line["prefill_xkv_then_decode_s"] = time.perf_counter() - t1
        toks = lm_tokens(cfg, 2, 64, 1, dev)
        frames = frontend_embeds(cfg, 2, 2, dev)
        agree32 = encdec_agreement(params, cfg.replace(compute_dtype="float32"),
                                   toks, frames, dev)
        need(agree32 >= 0.95, f"{arch}: forward/decode agreement {agree32} "
             "below 0.95 in float32")
        line["agreement_f32"] = agree32
        rng = np.random.default_rng(2)
        prompts = rng.integers(0, cfg.vocab_size, (8, 16), dtype=np.int32)
        frames = (rng.standard_normal((8, cfg.enc_seq, cfg.d_model)).astype(
            np.float32) if cfg.enc_layers else None)
        serve(params, cfg, prompts[:1], slots=4, gen_len=2,
              frontend=None if frames is None else frames[:1], device=dev)
        outputs, st = serve(params, cfg, prompts, slots=4, gen_len=24,
                            frontend=frames, device=dev)
        need(sorted(outputs) == list(range(8))
             and all(len(v) == 24 and all(0 <= t < cfg.vocab_size for t in v)
                     for v in outputs.values()), f"{arch}: serve outputs")
        line.update(served_tokens=st["tokens"], serve_wall_s=st["wall_s"],
                    served_tokens_per_s=st["tokens"] / st["wall_s"],
                    decode_tokens_per_s=st["decode_steps"] * 4 / st["wall_s"],
                    seconds=time.perf_counter() - t0)
        emit(line)
        del params
        state = None
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training on one card
# ---------------------------------------------------------------------------

def named_state(params, opt):
    return dict({"p " + n: p for n, p in params.named_parameters()},
                **{"m " + n: t for n, t in opt.m.items()},
                **{"v " + n: t for n, t in opt.v.items()}, step=opt.step)


def timed_step(step_fn, params, opt, *batch):
    import torch

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt, m = step_fn(params, opt, *batch)
    torch.cuda.synchronize()
    return params, opt, {k: float(v) for k, v in m.items()}, \
        time.perf_counter() - t1


def phase_lm_train(dev, steps=5):
    """``mamba2_370m`` at full width and depth (48 layers, remat, AdamW)
    through ``repro_torch.launch.train``'s step function on its data (8 x
    4,096 tokens a step), counted; a checkpoint of step 5 restored and
    stepped, bit for bit the uninterrupted sixth step; one step at
    accum=2; then ``whisper_medium`` at full width, 3 steps with frames."""
    import gc
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import SSD_BWD_KERNELS
    from repro_torch.launch import train as TRAIN
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state, make_train_step

    t0 = time.perf_counter()
    args = TRAIN.parser().parse_args(
        ["--arch", LM_ARCH, "--steps", str(steps + 1), "--global-batch", "8",
         "--seq-len", "4096", "--device", "cuda"])
    cfg, opt_cfg, dc, step_fn = TRAIN.build(args)
    need(cfg.remat, f"{LM_ARCH}: remat off")
    params, opt = init_state(cfg, opt_cfg, seed=0, device=dev)
    batches = [device_batch(dc, s, dev) for s in range(steps + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, walls, per_step = [], [], []
    for s in range(steps):
        before = dict(ops.LAUNCHES), dict(ops.CALLS)
        params, opt, m, wall = timed_step(step_fn, params, opt, *batches[s])
        losses.append(m["loss"])
        walls.append(wall)
        per_step.append({k: (ops.LAUNCHES[k] - before[0][k],
                             ops.CALLS[k] - before[1][k])
                         for k in ("ssd_scan", "ssd_scan_bwd")})
    launches = {k: ops.LAUNCHES[k] for k in ops.KERNELS}
    calls = {k: ops.CALLS[k] for k in ops.KERNELS}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    for k in ops.KERNELS:
        need(launches[k] == calls[k], f"lm_train: {k} {launches[k]} launches "
             f"for {calls[k]} calls")
    for s, c in enumerate(per_step):
        need(c["ssd_scan_bwd"] == (cfg.n_layers, cfg.n_layers),
             f"lm_train step {s + 1}: ssd_scan_bwd {c['ssd_scan_bwd']} "
             f"(launches, calls), want {cfg.n_layers} each")
    need(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
         f"lm_train: losses {losses}")
    step_s = sorted(walls)[len(walls) // 2]
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t1 = time.perf_counter()
        mgr.save(steps, (params, opt))
        save_s = time.perf_counter() - t1
        fresh = init_state(cfg, opt_cfg, seed=1, device=dev)
        t1 = time.perf_counter()
        (rp, ro), meta = mgr.restore(mgr.latest_step(), fresh)
        restore_s = time.perf_counter() - t1
    need(meta["step"] == steps, f"lm_train: restored step {meta}")
    for k, t in named_state(params, opt).items():
        need(torch.equal(t, named_state(rp, ro)[k]),
             f"lm_train: restored {k} differs")
    # the sixth step, uninterrupted and from the restored checkpoint,
    # under the profiler for the uninterrupted one
    out = {}

    def sixth():
        out["run"] = step_fn(params, opt, *batches[steps])
        return out["run"]

    _, wall_us, prows = device_profile(sixth)
    busy_us = sum(r[0] for r in prows)
    p6, o6, m6 = out["run"]
    rp, ro, rm, _ = timed_step(step_fn, rp, ro, *batches[steps])
    a, b = named_state(p6, o6), named_state(rp, ro)
    same = all(torch.equal(a[k], b[k]) for k in a)
    need(same and float(m6["loss"]) == rm["loss"],
         "lm_train: the step after restoring differs from the "
         "uninterrupted sixth step")
    del rp, ro, fresh, a, b
    gc.collect()
    # one step at accum=2 (two microbatches of 4)
    step2 = make_train_step(cfg, opt_cfg, accum=2)
    ops.reset_launches()
    p6, o6, m7, wall7 = timed_step(step2, p6, o6, *batches[steps + 1])
    need(math.isfinite(m7["loss"]) and ops.LAUNCHES["ssd_scan_bwd"]
         == ops.CALLS["ssd_scan_bwd"] == 2 * cfg.n_layers,
         f"lm_train accum=2: loss {m7['loss']}, ssd_scan_bwd "
         f"{ops.LAUNCHES['ssd_scan_bwd']} launches")
    tokens_per_step = dc.global_batch * dc.seq_len
    bwd_us = sum(r[0] for r in prows
                 if any(kernel_named(r[2], k) for k in SSD_BWD_KERNELS))
    line = dict(phase="lm_train", arch=LM_ARCH, layers=cfg.n_layers,
                d_model=cfg.d_model, params=sum(p.numel()
                                               for p in p6.parameters()),
                remat=cfg.remat, batch=dc.global_batch, seq=dc.seq_len,
                steps=steps, step_s=walls, tokens_per_s=tokens_per_step
                / step_s, losses=losses, loss_step6=float(m6["loss"]),
                loss_accum2=m7["loss"], accum2_step_s=wall7,
                grad_norm_step6=float(m6["grad_norm"]),
                launches=launches, calls=calls, ssd_scan_bwd_per_step=[
                    c["ssd_scan_bwd"][0] for c in per_step],
                peak_device_mib=peak_mib, ckpt_save_s=save_s,
                ckpt_restore_s=restore_s, resume_bit_exact=same,
                profile_step6=dict(wall_ms=wall_us / 1e3,
                                   device_ms=busy_us / 1e3,
                                   device_busy_share=busy_us / wall_us,
                                   ssd_scan_bwd_ms=bwd_us / 1e3,
                                   top=[dict(name=k[:70], ms=us / 1e3,
                                             calls=c)
                                        for us, c, k in prows[:8]]))
    line["seconds_mamba"] = time.perf_counter() - t0
    del params, opt, p6, o6, batches
    gc.collect()
    torch.cuda.empty_cache()

    # whisper_medium at full width: attention's and cross-attention's
    # backward and the flash cross-entropy at vocab 51,865
    t1 = time.perf_counter()
    wcfg = get_config("whisper_medium")
    wopt = adamw.OptConfig(lr=3e-4, total_steps=10, warmup_steps=1)
    wp, wo = init_state(wcfg, wopt, seed=0, device=dev)
    wstep = make_train_step(wcfg, wopt)
    wdc = DataConfig(vocab_size=wcfg.vocab_size, seq_len=448, global_batch=4)
    frames = frontend_embeds(wcfg, 4, 3, dev)
    torch.cuda.reset_peak_memory_stats()
    wl, ww = [], []
    for s in range(3):
        wp, wo, m, wall = timed_step(wstep, wp, wo, *device_batch(wdc, s, dev),
                                     frames)
        wl.append(m["loss"])
        ww.append(wall)
    need(all(math.isfinite(x) for x in wl), f"lm_train whisper: {wl}")
    line["whisper"] = dict(layers=wcfg.n_layers, enc_layers=wcfg.enc_layers,
                           batch=4, text=448, frames=wcfg.enc_seq,
                           remat=wcfg.remat, step_s=ww, losses=wl,
                           tokens_per_s=4 * 448 / sorted(ww)[1],
                           peak_device_mib=torch.cuda.max_memory_allocated()
                           / 2**20, seconds=time.perf_counter() - t1)
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    del wp, wo, frames
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ssd_scan_bwd=launches["ssd_scan_bwd"], step_s=step_s)


# ---------------------------------------------------------------------------
# training on a mesh, and the dry run's hlo: job beside an HPC app
# ---------------------------------------------------------------------------

def phase_lm_train_mesh(dev, train_step_s, steps=2):
    """``lm_train_mesh``: ``mamba2_370m`` at full width and depth, 2 steps
    of 8 x 4,096 tokens, first unsharded (``lm_train``'s step function,
    seed and data), then on the (1, 1) smoke mesh of an NCCL process group
    of this one process (its store a file in a temporary directory):
    parameters and moments DTensors placed by ``cell_shardings``, the
    batch's rows by ``device_batch``, the step under ``mesh_axes``, the
    counts set to 0 just before and read just after. The loss and every
    parameter and moment held to the unsharded steps; s a step beside
    the unsharded steps' and ``lm_train``'s (the last step's difference
    is the host cost of DTensor dispatch). The group is destroyed at the
    end."""
    import gc

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import device_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TRAIN
    from repro_torch.launch.mesh import batch_axes_of, make_smoke_mesh
    from repro_torch.train.train_step import init_state

    t0 = time.perf_counter()
    args = TRAIN.parser().parse_args(
        ["--arch", LM_ARCH, "--steps", "6", "--global-batch", "8",
         "--seq-len", "4096", "--device", "cuda"])  # lm_train's schedule
    cfg, opt_cfg, dc, step_fn = TRAIN.build(args)
    params, opt = init_state(cfg, opt_cfg, seed=0, device=dev)
    ref_losses, ref_walls = [], []
    for s in range(steps):
        params, opt, m, wall = timed_step(step_fn, params, opt,
                                          *device_batch(dc, s, dev))
        ref_losses.append(m["loss"])
        ref_walls.append(wall)
    ref = named_state(params, opt)

    def value(x):
        return float(x.full_tensor() if isinstance(x, DTensor) else x)

    with TRAIN.one_process_group(dev):
        mesh = make_smoke_mesh("cuda")
        pm, om = init_state(cfg, opt_cfg, seed=0, device=dev)
        pm, om = TRAIN.place_state(cfg, pm, opt_cfg, mesh)
        need(all(isinstance(p, DTensor) for p in pm.parameters())
             and all(isinstance(t, DTensor) for t in om.m.values()),
             "lm_train_mesh: parameters or moments not placed")
        batches = [device_batch(dc, s, dev, mesh, batch_axes_of(mesh))
                   for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses, walls, per_step = [], [], []
        for s in range(steps):
            before = dict(ops.LAUNCHES), dict(ops.CALLS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with TRAIN.mesh_context(mesh):
                pm, om, mm = step_fn(pm, om, *batches[s])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            losses.append(value(mm["loss"]))
            per_step.append({k: (ops.LAUNCHES[k] - before[0][k],
                                 ops.CALLS[k] - before[1][k])
                             for k in ("ssd_scan", "ssd_scan_bwd")})
        launches = {k: ops.LAUNCHES[k] for k in ops.KERNELS}
        calls = {k: ops.CALLS[k] for k in ops.KERNELS}
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        got = {k: (v.to_local() if isinstance(v, DTensor) else v).detach()
               for k, v in named_state(pm, om).items()}
    for k in ("ssd_scan", "ssd_scan_bwd"):
        need(launches[k] == calls[k] > 0,
             f"lm_train_mesh: {k} {launches[k]} launches for {calls[k]} "
             "calls")
    for s, c in enumerate(per_step):
        need(c["ssd_scan_bwd"] == (cfg.n_layers, cfg.n_layers),
             f"lm_train_mesh step {s + 1}: ssd_scan_bwd {c['ssd_scan_bwd']} "
             f"(launches, calls), want {cfg.n_layers} each")
    need(all(math.isfinite(x) for x in losses), f"lm_train_mesh: {losses}")
    diffs = {k: float((got[k].float() - t.detach().float()).abs().max())
             for k, t in ref.items()}
    bit_exact = all(torch.equal(got[k], t) for k, t in ref.items()) \
        and losses == ref_losses
    worst = max(diffs, key=diffs.get)
    # not bit for bit: the largest difference, then a float32 tolerance
    need(bit_exact or (max(abs(a - b) for a, b in zip(losses, ref_losses))
                       <= 1e-4 * abs(ref_losses[0])
                       and diffs[worst] <= 1e-4),
         f"lm_train_mesh: losses {losses} against {ref_losses}; largest "
         f"difference {diffs[worst]} at {worst}")
    emit(dict(phase="lm_train_mesh", arch=LM_ARCH, layers=cfg.n_layers,
              mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
              backend="nccl", batch=dc.global_batch, seq=dc.seq_len,
              steps=steps, step_s=walls, unsharded_step_s=ref_walls,
              lm_train_step_s=train_step_s,
              # the last step of each, past the first step's warm-up
              dtensor_host_cost_s=walls[-1] - ref_walls[-1],
              losses=losses, unsharded_losses=ref_losses,
              bit_exact=bit_exact, max_abs_diff=diffs[worst],
              max_abs_diff_at=worst, launches=launches, calls=calls,
              ssd_scan_bwd_per_step=[c["ssd_scan_bwd"][0] for c in per_step],
              peak_device_mib=peak_mib,
              seconds=time.perf_counter() - t0))
    del params, opt, pm, om, ref, got, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ssd_scan=launches["ssd_scan"],
                ssd_scan_bwd=launches["ssd_scan_bwd"])


DRYRUN_CELL = ("mistral_nemo_12b", "train_4k", "single")
HYBRID_RANKS = 128
# the reference's record of DRYRUN_CELL, written on the CPU by
# ``PYTHONPATH=src python -m repro.launch.dryrun --arch mistral_nemo_12b
# --shape train_4k --mesh single --accum 1``: its flops_per_device and
# analysis.per_period.flops; the port's must lie within DRYRUN_FLOPS_TOL
REF_DRYRUN_FLOPS = 419494803537920.0
REF_DRYRUN_PERIOD_FLOPS = 9935653961728.0
DRYRUN_FLOPS_TOL = 0.10


def start_dryrun(tmp):
    """The port's dry run of ``DRYRUN_CELL`` in a subprocess with ``tmp``
    as its working directory: it joins a fake process group of 256 ranks,
    which cannot share a process with ``lm_train_mesh``'s NCCL group, and
    traces on the host (no card) while the card runs the other phases."""
    arch, shape, mesh = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(tmp, "dryrun.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out",
         os.path.join(tmp, "results", "dryrun")],
        cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT)
    return dict(proc=proc, log=log, tmp=tmp, t0=time.time())


def phase_dryrun_hybrid(dev, dry):
    """``dryrun_hybrid``: the dry run's record (waited for), its roofline
    terms against the H100's rates, its collectives by kind and its wall
    s; then, in its working directory, ``hlo:mistral_nemo_12b:train_4k``
    at 128 ranks co-run with ``milc`` through the port's ``union``
    scenario path on the card (the second half of
    ``examples/hybrid_workload.py``; the small 1D dragonfly, RG, ADP, 5 µs
    ticks), its horizon cut to the end of the ML job's first compute
    segment plus 5 ms, the counts set to 0 just before and read just
    after. Both jobs deliver messages; the drain tick's and link
    demand's launches equal their calls and the ticks run."""
    import re

    from repro_torch.core.hlo2skeleton import from_dryrun_record
    from repro_torch.kernels import ops
    from repro_torch.union import manager as MGR
    from repro_torch.union.scenario import Scenario, ScenarioJob

    t0 = time.perf_counter()
    rc = dry["proc"].wait(timeout=900)
    dry["log"].close()
    # its own wall: from its start to its last write (it ends long before
    # this phase asks, beside the phases above)
    wall = os.path.getmtime(dry["log"].name) - dry["t0"]
    with open(dry["log"].name) as f:
        log = f.read()
    need(rc == 0, f"dryrun_hybrid: the dry run exited {rc}: {log[-2000:]}")
    arch, shape, mesh = DRYRUN_CELL
    path = os.path.join(dry["tmp"], "results", "dryrun",
                        f"{arch}__{shape}__{mesh}.json")
    with open(path) as f:
        rec = json.load(f)
    need(rec["n_devices"] == 256 and rec["flops_per_device"] > 0
         and rec["analysis"] is not None,
         f"dryrun_hybrid: record {sorted(rec)}")
    flops = dict(
        flops_per_device=(rec["flops_per_device"], REF_DRYRUN_FLOPS),
        per_period_flops=(rec["analysis"]["per_period"]["flops"],
                          REF_DRYRUN_PERIOD_FLOPS))
    for what, (got, ref) in flops.items():
        print(f"dryrun_hybrid: {what} {got:.6e} against the reference's "
              f"{ref:.6e} ({got / ref:.4f}x)", flush=True)
        need(abs(got / ref - 1.0) <= DRYRUN_FLOPS_TOL,
             f"dryrun_hybrid: {what} {got} is {got / ref:.4f}x the "
             f"reference's {ref}, beyond {DRYRUN_FLOPS_TOL}")
    src = from_dryrun_record(path)
    seg_ms = float(re.search(r"compute for ([0-9.]+) milliseconds",
                             src).group(1))
    sc = Scenario(name="hybrid", jobs=[
        ScenarioJob(app=f"hlo:{arch}:{shape}", ranks=HYBRID_RANKS),
        ScenarioJob(app="milc", overrides={"iters": 2})],
        topo="1d", scale="small", placement="RG", routing="ADP",
        tick_us=5.0, horizon_ms=seg_ms + 5.0, pool_size=4096)
    here = os.getcwd()
    os.chdir(dry["tmp"])  # hlo: jobs read results/dryrun/ from here
    try:
        ops.reset_launches()
        t1 = time.perf_counter()
        rep = MGR._run_member(sc, seed=1)
        co_wall = time.perf_counter() - t1
        counted = dict(launches=dict(ops.LAUNCHES), calls=dict(ops.CALLS))
    finally:
        os.chdir(here)
    run = rep["engine_run"]
    launches, calls = replayed_counts(run)
    need(run["device"] == "cuda" and run["replays"] > 0,
         "dryrun_hybrid: the co-run replayed no graph")
    for k in ("drain_tick", "link_demand"):
        need(launches[k] == calls[k] == run["ticks"] > 0,
             f"dryrun_hybrid: {launches[k]} {k} launches for {calls[k]} "
             f"calls and {run['ticks']} ticks")
    delivered = {name: rep["latency"][name]["count"]
                 for name in (f"hlo:{arch}:{shape}", "milc")}
    need(all(n > 0 for n in delivered.values()),
         f"dryrun_hybrid: delivered {delivered}")
    emit(dict(phase="dryrun_hybrid", cell=list(DRYRUN_CELL),
              dryrun_wall_s=wall, lower_s=rec["lower_s"],
              compile_s=rec["compile_s"], roofline=rec["roofline"],
              flops_per_device=rec["flops_per_device"],
              flops_vs_reference={k: dict(port=g, reference=r, ratio=g / r)
                                  for k, (g, r) in flops.items()},
              bytes_per_device=rec["bytes_per_device"],
              wire_bytes_per_device=rec["wire_bytes_per_device"],
              collectives_by_kind=rec["collectives"]["by_kind_count"],
              collective_bytes_by_kind=rec["collectives"]["by_kind_bytes"],
              memory=rec["memory"], model_flops_total=rec["model_flops_total"],
              useful_flops_ratio=rec["useful_flops_ratio"],
              hybrid=dict(ranks=HYBRID_RANKS, horizon_ms=sc.horizon_ms,
                          compute_segment_ms=seg_ms, wall_s=co_wall,
                          ticks=run["ticks"], replays=run["replays"],
                          delivered=delivered,
                          avg_latency_us={k: rep["latency"][k]["avg_us"]
                                          for k in delivered},
                          launches=launches, calls=calls,
                          counted_while_capturing=counted),
              seconds=time.perf_counter() - t0))
    return launches


def free_engines() -> None:
    """Drop the cached engines and their captured graphs."""
    import gc

    import torch

    from repro_torch.netsim.engine import clear_engine_cache

    clear_engine_cache()
    gc.collect()
    torch.cuda.empty_cache()


def fabric_live(fabric_launches, kernel):
    """A simulator kernel's device ms a call and its plain version's on
    each paper fabric's live pool (first sampled tick)."""
    return {f: dict(tick=v["live"]["tick"], active=v["live"]["active"],
                    ms=v["live"]["ms"][kernel],
                    plain_ms=v["live"]["plain_ms"][kernel])
            for f, v in fabric_launches.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path[:0] = [SRC, os.path.join(ROOT, "tests")]

    # float32 products in full float32 (the kernels' plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    dry = start_dryrun(tmp)
    try:
        return run_phases(dev, dry, t0)
    finally:
        if dry["proc"].poll() is None:
            dry["proc"].kill()
            dry["proc"].wait()
        dry["log"].close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(dev, dry, t0) -> int:
    import torch

    from repro_torch.kernels import _build

    _build.load_all(KERNEL_SOURCES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, card=card,
              torch=torch.__version__, cuda=torch.version.cuda,
              compiler_output={
                  k: _build.BUILD_LOG[k]["compiler_output"].strip()
                  .splitlines() for k in KERNEL_SOURCES}))
    print(card, flush=True)

    rows, max_err = phase_kernel(dev)
    dem_rows = phase_link_demand(dev)
    ssd = phase_ssd(dev)
    ssd_bwd = phase_ssd_bwd(dev)
    rtr = phase_router(dev)
    # each engine phase ends by clearing the engine cache, so that the
    # next one captures its own graphs with the device memory free
    phase_goldens(dev)
    free_engines()
    launches1, delivered1 = phase_paper("paper_1d", PAPER_1D, dev)
    free_engines()
    for app in ("alexnet", "lammps", "nn", "ur"):
        need(delivered1.get(app, 0) > 0, f"paper_1d: {app} delivered nothing")
    phase_members(dev)
    free_engines()
    phase_observed(dev)
    free_engines()
    trace_launches = phase_trace(dev)
    free_engines()
    experiment_launches = phase_experiment(dev)
    free_engines()
    split_launches = phase_member_split(dev)
    free_engines()
    fabric_launches = phase_fabrics(dev)
    phase_front_doors(dev)
    free_engines()
    launches2, _ = phase_paper("paper_2d", PAPER_2D, dev)
    free_engines()
    inject_rows = phase_inject(dev)
    params, cfg, lm_launches = phase_lm_prefill(dev)
    phase_lm_serve(params, cfg, dev)
    del params
    free_engines()
    params, cfg = phase_lm_prefill_dense(dev)
    phase_lm_serve(params, cfg, dev, phase="lm_serve_dense")
    del params
    free_engines()
    families_scan = phase_lm_families(dev)
    free_engines()
    phase_lm_encdec(dev)
    free_engines()
    train = phase_lm_train(dev)
    mesh_train = phase_lm_train_mesh(dev, train["step_s"])
    free_engines()
    hybrid = phase_dryrun_hybrid(dev, dry)
    free_engines()

    main_row, dem = rows[0], dem_rows[0]
    emit({"kernels": [
        dict(name="drain_tick", route="cuda",
             source="src/repro_torch/kernels/csrc/drain_tick.cu",
             replaces="src/repro/kernels/drain_tick.py:131",
             tpu="src/repro/kernels/drain_tick.py::drain_tick_pallas",
             launches=launches1["drain_tick"], max_abs_err=max_err,
             ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
             bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
             library_ms=None,
             # the scheduler's windows on paper_1d_trace (its four runs)
             trace_launches=trace_launches["drain_tick"],
             # the facade's run on paper_1d_experiment (both nodes)
             experiment_launches=experiment_launches["drain_tick"],
             # paper_fabrics' counted runs (route widths 6 and 21)
             fabric_launches={f: v["drain_tick"]
                              for f, v in fabric_launches.items()},
             fabric_live=fabric_live(fabric_launches, "drain_tick"),
             # dryrun_hybrid's co-run of the hlo: job with milc
             hybrid_launches=hybrid["drain_tick"],
             # member_split's two replicas on one card (Engine.prun)
             split_launches=split_launches["drain_tick"]),
        dict(name="link_demand", route="cuda",
             source="src/repro_torch/kernels/csrc/link_demand.cu",
             replaces="src/repro/netsim/engine.py:805",
             tpu=None,  # the reference's jnp scatter-add, not a TPU kernel
             launches=launches1["link_demand"],
             trace_launches=trace_launches["link_demand"],
             experiment_launches=experiment_launches["link_demand"],
             fabric_launches={f: v["link_demand"]
                              for f, v in fabric_launches.items()},
             fabric_live=fabric_live(fabric_launches, "link_demand"),
             hybrid_launches=hybrid["link_demand"],
             split_launches=split_launches["link_demand"],
             max_abs_err=max([r["max_abs_err"] for r in dem_rows]
                             + [launches1["link_demand_max_abs_err"]]
                             + [v["link_demand_max_abs_err"]
                                for v in fabric_launches.values()]),
             ms=dem["kernel_ms"], plain_ms=dem["plain_ms"],
             bound_ms=dem["bound_ms"], bound_by=dem["bound_by"],
             library_ms=dem["library_ms"]),
        dict(name="inject", route="cuda",
             source="src/repro_torch/kernels/csrc/inject.cu",
             replaces="src/repro/netsim/engine.py:634",
             tpu=None,  # the reference's jnp injection, not a TPU kernel
             launches=launches1["inject"] + launches2["inject"],
             experiment_launches=experiment_launches["inject"],
             split_launches=split_launches["inject"],
             fabric_launches={f: v["inject"]
                              for f, v in fabric_launches.items()},
             max_abs_err=max(r["max_abs_err"] for r in inject_rows),
             ms=inject_rows[0]["ms"],
             plain_ms=inject_rows[0]["plain_ms"],
             bound_ms=inject_rows[0]["bound_ms"], bound_by="bytes",
             library_ms=None, rows=inject_rows),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:59",
             tpu="src/repro/kernels/ssd_scan.py::ssd_scan_pallas",
             launches=lm_launches["ssd_scan"],
             max_abs_err=max(ssd["max_abs_err"], families_scan["max_abs_err"]),
             ms=ssd["ms"], plain_ms=ssd["plain_ms"],
             bound_ms=ssd["bound_ms"], bound_by=ssd["bound_by"],
             library_ms=None,
             # jamba_v01_52b's counted prefill on lm_families (ds 16)
             families_launches=families_scan["launches"],
             # lm_train_mesh's 2 steps on the (1, 1) mesh, via local_map
             mesh_launches=mesh_train["ssd_scan"]),
        dict(name="ssd_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
             # no TPU counterpart: the reference differentiates its jnp
             # ssd_chunked, whose gradient this kernel computes
             replaces="src/repro/models/mamba2.py:71",
             tpu=None,
             # lm_train's 5 counted steps of mamba2_370m (48 layers)
             launches=train["ssd_scan_bwd"],
             max_abs_err=ssd_bwd["max_abs_err"], ms=ssd_bwd["ms"],
             plain_ms=ssd_bwd["plain_ms"], bound_ms=ssd_bwd["bound_ms"],
             bound_by=ssd_bwd["bound_by"], library_ms=None,
             mesh_launches=mesh_train["ssd_scan_bwd"]),
        dict(name="router_rate_drain", route="cuda",
             source="src/repro_torch/kernels/csrc/router_tick.cu",
             replaces="src/repro/kernels/router_tick.py:48",
             tpu="src/repro/kernels/router_tick.py::router_rate_drain_pallas",
             # no path of the port calls it: the counted windows of the
             # paper runs and of lm_prefill read its launches (0 for 0 calls)
             launches=launches1["router_rate_drain"]
             + launches2["router_rate_drain"]
             + lm_launches["router_rate_drain"],
             experiment_launches=experiment_launches["router_rate_drain"],
             max_abs_err=max(r["max_abs_err"] for r in rtr),
             ms=rtr[0]["kernel_ms"], plain_ms=rtr[0]["plain_ms"],
             bound_ms=rtr[0]["bound_ms"], bound_by=rtr[0]["bound_by"],
             library_ms=None,
             # device time on the live 1D paper pool (first sampled tick)
             live_ms=launches1["router_live"]["ms"],
             live_tick=launches1["router_live"]["tick"]),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
