#!/usr/bin/env python3
"""Drive the PyTorch port of the simulator on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; exits non-zero without them. Every phase prints one JSON line with
its seconds, and any failure raises (non-zero exit, no result line):

1. build ``src/repro_torch/kernels/csrc/drain_tick.cu`` for ``sm_90a``;
   print the card's name and power limit, in the build line and on a
   line of its own as ``nvidia-smi`` gives them;
2. drain-tick kernel against its plain PyTorch version on the card at the
   paper's shapes (M = 65,536 and a ragged 65,573; K = 10; L+1 = 53,857
   and 73,921; B = 1 with a 1-D bandwidth row, B = 3 with per-member rows
   and dead links): new_rem, rate and delivered exact, the byte deltas to
   rtol 1e-5 (float atomics sum in another order); kernel and plain times
   by CUDA events, and the bound from the bytes the call must move;
3. the two engine goldens of ``tests/data_engine_golden.json`` on the card;
4. the paper-scale main path on the 1D dragonfly (Table II, 8,448 nodes;
   workload1 + UR, 65,536-message pool) through ``run_sim`` with the
   launch counts set to 0 just before and read just after; the rate is
   virtual milliseconds simulated per wall second (a tick's virtual time
   varies with the idle-time skip, and the host loop checks liveness once
   per 64 ticks, so drain calls are not simulated work); the kernel
   against the plain version on live pool states at sampled ticks; two
   more runs with one seed must give one integer trajectory; a profile
   of 20 ticks (device time by kernel, the device's busy share);
5. the paper-scale 2D dragonfly (workload3) the same way, shorter;
6. the kernel summary line, then the result line.

Imports nothing of JAX or of the JAX package (``src/repro``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "data_engine_golden.json")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

PAPER_1D = dict(workload="workload1", topo="1d", horizon_ms=10.0)
PAPER_2D = dict(workload="workload3", topo="2d", horizon_ms=6.0)


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
    from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain

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
    emit(dict(phase="kernel_vs_plain", seconds=time.perf_counter() - t0,
              cases=rows))
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 3: engine goldens on the card
# ---------------------------------------------------------------------------

PP = (
    "For 4 repetitions {\n"
    " task 0 sends a 4096 byte message to task 1 then\n"
    " task 1 sends a 4096 byte message to task 0 }"
)
AR = (
    "For 3 repetitions {\n"
    " all tasks allreduce a 65536 byte message then\n"
    " all tasks compute for 200 microseconds }"
)
COLL = (
    "For 2 repetitions {\n"
    " all tasks exchange a 2048 byte message with their neighbors"
    " in a 2x2x2 grid then\n"
    " task 0 multicasts a 4096 byte message to all other tasks then\n"
    " all tasks allreduce a 512 byte message then\n"
    " task 0 asynchronously sends a 1024 byte message to all other tasks then\n"
    " all tasks synchronize then\n"
    " all tasks compute for 50 microseconds }"
)


def golden_scenarios():
    from repro_torch.union.scenario import Scenario, ScenarioJob, URDecl

    mix = Scenario(
        name="equiv-mix",
        jobs=[ScenarioJob(app="ar8", source=AR, ranks=8),
              ScenarioJob(app="pp2", source=PP, ranks=2, start_us=700.0)],
        placement="RN", routing="ADP",
        ur=URDecl(ranks=16, size_bytes=4096.0, interval_us=300.0),
        tick_us=2.0, horizon_ms=80.0, pool_size=512,
    )
    coll = Scenario(
        name="equiv-coll",
        jobs=[ScenarioJob(app="coll8", source=COLL, ranks=8),
              ScenarioJob(app="pp2", source=PP, ranks=2, start_us=150.0)],
        placement="RN", routing="ADP", tick_us=2.0, horizon_ms=60.0,
        pool_size=512,
    )
    return {"equiv-mix": (mix, 3), "equiv-coll": (coll, 5)}


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
    import numpy as np

    from repro_torch.union import manager as MGR
    from repro_torch.union.seeds import engine_seed

    t0 = time.perf_counter()
    with open(GOLDEN) as f:
        golden = json.load(f)
    for case, (sc, seed) in golden_scenarios().items():
        rs = MGR.resolve(sc, seed=seed)
        init, run, _ = MGR.build(rs, device=dev)
        check_golden(run(init(seed=engine_seed(seed))), rs,
                     golden[case]["state"])
    sc, seed = golden_scenarios()["equiv-mix"]
    rep = MGR.run_scenario(sc, seed=seed, device=dev)
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
              cases=sorted(golden), ok=True))


# ---------------------------------------------------------------------------
# phases 4-5: paper-scale main path
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


def profile_ticks(eng, st, n=20):
    """Device time by kernel over ``n`` ticks (torch.profiler, CUPTI) and
    the device's busy share of the wall time; the profiler's own cost is
    in the wall time. Returns the state after the ticks and the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st = eng.tick(st)
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
    busy_us = sum(r[0] for r in rows)
    drain_us = sum(r[0] for r in rows
                   if "drain_kernel" in r[2] or "count_kernel" in r[2])
    return st, dict(
        ticks=n, wall_ms_per_tick=wall_us / n / 1e3,
        device_ms_per_tick=busy_us / n / 1e3,
        device_busy_share=busy_us / wall_us,
        drain_kernels_us_per_tick=drain_us / n,
        device_kernels_per_tick=sum(r[1] for r in rows) / n,
        top=[dict(name=k[:70], us_per_tick=us / n, calls_per_tick=c / n)
             for us, c, k in rows[:8]],
    )


def phase_paper(name, cfg, dev):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.sim import run_sim
    from repro_torch.union import manager as MGR
    from repro_torch.union.scenario import mix_scenario
    from repro_torch.union.seeds import engine_seed

    kw = dict(scale="paper", seed=0, horizon_ms=cfg["horizon_ms"],
              tick_us=5.0)
    # the main path, counted: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = run_sim(cfg["workload"], cfg["topo"], "RG", "ADP", device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["drain_tick"]
    calls = ops.CALLS["drain_tick"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    need(launches > 0, f"{name}: the drain kernel was never launched")
    need(launches == calls,
         f"{name}: {launches} kernel launches for {calls} drain calls")
    need(rep["dropped"] == 0, f"{name}: {rep['dropped']} messages dropped")
    delivered = {app: v.get("count", 0) for app, v in rep["latency"].items()}

    # the same scenario again through the manager: the kernel against its
    # plain version on live pool states at sampled ticks, then the rest of
    # the run; a third run must end in the same integer trajectory
    sc = mix_scenario(cfg["workload"], topo=cfg["topo"], scale="paper",
                      placement="RG", routing="ADP", tick_us=5.0,
                      horizon_ms=cfg["horizon_ms"])
    rs = MGR.resolve(sc, seed=0)
    eng = MGR.build(rs, device=dev)
    n_apps = len(rs.padded_app_names(rs.capacity))
    st = eng.init_state(seed=engine_seed(0))
    samples = sorted({int(x) for x in np.linspace(10, calls - 10, 5)})
    sampled = []
    i = 0
    while i <= samples[-1]:
        if i == samples[0] + 1:  # profile 20 ticks early in the run
            st, prof = profile_ticks(eng, st)
            i += prof["ticks"]
            continue
        st = eng.tick(st)
        if i in samples:
            args = live_drain_args(st, rs, dev)
            err = compare_drain(args, n_apps, rs.topo.n_routers)
            sampled.append(dict(tick=i, active=int(st.pool.active.sum()),
                                max_abs_err=err))
        i += 1
    second = trajectory(eng.run(st))
    third = trajectory(eng.run(eng.init_state(seed=engine_seed(0))))
    for k in TRAJECTORY:
        need(np.array_equal(second[k], third[k]),
             f"{name}: two runs with one seed differ in {k}")
    need(float(second["t"]) / 1000.0 == rep["virtual_time_ms"],
         f"{name}: the counted run ended at another time")
    lat_cnt = second["lat_cnt"].tolist()
    need([delivered[a] for a in rep["latency"]]
         == [c for a, c in zip(rs.padded_app_names(rs.capacity), lat_cnt)
             if a is not None],
         f"{name}: the counted run delivered other counts")
    emit(dict(phase=name, seconds=time.perf_counter() - t0,
              workload=cfg["workload"], topo=cfg["topo"],
              horizon_ms=cfg["horizon_ms"], nodes=rs.topo.n_nodes,
              links=rs.topo.n_links, pool=rs.pool_size,
              virtual_time_ms=rep["virtual_time_ms"], wall_s=wall,
              virtual_ms_per_wall_s=rep["virtual_time_ms"] / wall,
              drain_calls=calls, drain_launches=launches, dropped=rep["dropped"],
              peak_device_mib=peak_mib, delivered=delivered,
              sampled_ticks=sampled, identical_reruns=True,
              profile=prof))
    return rep, launches, calls, delivered


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load("drain_tick")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, card=card,
              torch=torch.__version__, cuda=torch.version.cuda,
              compiler_output=_build.BUILD_LOG["drain_tick"]
              ["compiler_output"].strip().splitlines()))
    print(card, flush=True)

    rows, max_err = phase_kernel(dev)
    phase_goldens(dev)
    _rep1, launches1, calls1, delivered1 = phase_paper(
        "paper_1d", PAPER_1D, dev)
    for app in ("alexnet", "lammps", "nn", "ur"):
        need(delivered1.get(app, 0) > 0, f"paper_1d: {app} delivered nothing")
    phase_paper("paper_2d", PAPER_2D, dev)

    main_row = rows[0]
    emit({"kernels": [dict(
        name="drain_tick", route="cuda",
        source="src/repro_torch/kernels/csrc/drain_tick.cu",
        replaces="src/repro/kernels/drain_tick.py:131",
        tpu="src/repro/kernels/drain_tick.py::drain_tick_pallas",
        launches=launches1, max_abs_err=max_err,
        ms=main_row["kernel_ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, kernel_ms=main_row["kernel_ms"],
        bound_us=main_row["bound_ms"] * 1e3,
    )]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
