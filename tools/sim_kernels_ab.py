#!/usr/bin/env python3
"""Hold this checkout's simulator-tick kernels against another build of them, on one card.

    mkdir -p build/sim_ab_other
    for f in link_demand drain_tick; do
      git show <rev>:src/repro_torch/kernels/csrc/$f.cu > build/sim_ab_other/$f.cu
    done
    python3 tools/sim_kernels_ab.py build/sim_ab_other

The other sources are those of the first design: ``link_demand.cu`` takes
the values in key order and the run starts that a stable sort and a
``searchsorted`` give (that Python lives here, not in the package), and
``drain_tick.cu`` zeroes three tables with ``cudaMemsetAsync`` and then
launches a counting and a drain kernel. The tool builds them with the
flags of ``repro_torch.kernels._build`` into ``build/``, with three
variants of the other drain kernel that leave out its link-table atomics,
its router-table atomics or both, and runs both builds on:

* ``chip_smoke.py``'s phase 2 inputs (drain tick) and phase 3 inputs (link
  demand) at the paper's 1D and 2D shapes;
* a live pool: the paper's 1D scenario (workload1) ticked 11 ticks on the
  card, about 10,000 messages in flight.

It prints one JSON line: for each input, how many values differ bit for
bit between the two builds (``new_rem``, ``rate``, ``delivered``, the
demand sums) and the largest relative difference of the byte deltas;
each build's device milliseconds a call (a CUDA graph of 20 calls, timed
in turns: other, this, this, other); each build's device operations a
call and device microseconds by kernel under the profiler; and the pieces
of the other build measured apart: for the drain tick the memsets, the
counting kernel, the drain kernel and that kernel without its link-table
and router-table atomics; for link demand the key build, the sort, the
gather, the ``searchsorted`` and the serial sum. Needs a CUDA card and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LB_ATOMIC = "    atomicAdd(lb + l, drain);\n"
RW_ATOMIC = "    atomicAdd(rw + link_dst_router[l], drain);\n"
DRAIN_VARIANTS = {"full": (), "no_router_atomics": (RW_ATOMIC,),
                  "no_link_atomics": (LB_ATOMIC,),
                  "no_atomics": (LB_ATOMIC, RW_ATOMIC)}


def build_other(other_dir: Path):
    """Compile the other link-demand source and the four variants of the
    other drain tick, one nvcc each, all at once."""
    from repro_torch.kernels import _build

    out = Path(ROOT) / "build" / "sim_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    srcs = {"link_demand": other_dir / "link_demand.cu"}
    text = (other_dir / "drain_tick.cu").read_text()
    for name, cut in DRAIN_VARIANTS.items():
        src = text
        for line in cut:
            if line not in src:
                raise SystemExit(f"sim_kernels_ab: {line.strip()!r} not in "
                                 "the other drain_tick.cu")
            src = src.replace(line, "")
        path = out / f"drain_tick_{name}.cu"
        path.write_text(src)
        srcs[f"drain_tick_{name}"] = path
    for name, src in srcs.items():
        so = out / f"{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.file_flags(src), "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sim_kernels_ab: nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def other_drain(lib):
    """The first design's drain-tick wrapper around ``lib``."""
    import torch

    from repro_torch.kernels import _build

    launch = lib.drain_tick_launch
    launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7
    launch.restype = ctypes.c_int

    def run(routes, rem, act, job, mina, t, dt, bw, ldr, A, R, m=None):
        B, M, K = routes.shape
        M = M if m is None else m
        Lp = bw.shape[-1]
        dev = routes.device
        out = [torch.empty((B, Lp), dtype=torch.int32, device=dev),
               torch.empty((B, M), device=dev), torch.empty((B, M), device=dev),
               torch.empty((B, M), dtype=torch.bool, device=dev),
               torch.empty((B, Lp), device=dev),
               torch.empty((B, A, R), device=dev)]
        p = _build.ptr
        err = launch(p(routes), p(rem), p(act), p(job), p(mina), p(t),
                     ctypes.c_float(float(dt)), p(bw),
                     ctypes.c_int64(0 if bw.dim() == 1 else Lp), p(ldr),
                     B, M, K, Lp, A, R, *(p(x) for x in out),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the other drain tick failed ({err})")
        return out[1:]
    return run


def other_demand(lib):
    """The first design's link-demand wrapper: a stable sort of int64 keys,
    the values gathered in key order, ``searchsorted`` for the run starts,
    then ``lib``'s serial sum. Returns (the wrapper, its pieces)."""
    import torch

    from repro_torch.kernels import _build

    launch = lib.link_demand_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int

    def keys(routes, active, n_links):
        B = routes.shape[0]
        n_keys = B * (n_links + 1)
        valid = (routes >= 0) & active[:, :, None]
        k = routes.long() + (torch.arange(B, device=routes.device)
                             * (n_links + 1))[:, None, None]
        return torch.where(valid, k, n_keys).reshape(-1)

    def gather(bytes_rem, order, K):
        B, M = bytes_rem.shape
        return bytes_rem[:, :, None].expand(B, M, K).reshape(-1)[order]

    def starts(sorted_keys, n_keys):
        return torch.searchsorted(
            sorted_keys, torch.arange(n_keys + 1, device=sorted_keys.device))

    def serial(vals, st, n_keys):
        out = torch.empty(n_keys, device=vals.device)
        err = launch(_build.ptr(vals), _build.ptr(st), n_keys,
                     _build.ptr(out), ctypes.c_void_p(
                         torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the other link demand failed ({err})")
        return out

    def run(routes, active, bytes_rem, n_links):
        B, M, K = routes.shape
        n_keys = B * (n_links + 1)
        sk, order = torch.sort(keys(routes, active, n_links), stable=True)
        return serial(gather(bytes_rem, order, K), starts(sk, n_keys),
                      n_keys).reshape(B, n_links + 1)

    return run, dict(keys=keys, gather=gather, starts=starts, serial=serial)


def differ(a, b):
    """Values whose bits differ (floats compared as int32)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def rel_diff(a, b):
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) \
        if a.numel() else 0.0


def by_kernel(fn, calls=20):
    """Device operations a call and device microseconds a call by name,
    from the profiler over ``calls`` calls."""
    from chip_smoke import device_profile

    _, _, rows = device_profile(lambda: [fn() for _ in range(calls)])
    return (sum(c for _, c, _ in rows) / calls,
            {k[:60]: us / calls for us, _, k in rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="directory holding the other link_demand.cu "
                    "and drain_tick.cu")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sim_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import (
        PAPER_1D, device_ms, drain_inputs, link_demand_inputs,
        live_drain_args, paper_engine)
    from repro_torch.kernels import _build
    from repro_torch.kernels.drain_tick import drain_tick_cuda
    from repro_torch.kernels.link_demand import link_demand_cuda
    from repro_torch.union.seeds import engine_seed

    dev = torch.device("cuda", 0)
    _build.load_all(["drain_tick", "link_demand"])
    libs = build_other(Path(args.other))
    drain = {n: other_drain(libs[f"drain_tick_{n}"]) for n in DRAIN_VARIANTS}
    demand, pieces = other_demand(libs["link_demand"])

    # inputs: chip_smoke's phases 2 and 3 at the 1D and 2D shapes, then a
    # live pool of the 1D paper run
    drains = {"1d": (drain_inputs(1, 65536, 10, 53857, 5, 1056, 100, False,
                                  dev), 5, 1056),
              "2d": (drain_inputs(1, 65573, 10, 73921, 5, 2112, 101, False,
                                  dev), 5, 2112)}
    demands = {"1d": ([a.to(dev) for a in link_demand_inputs(
        65536, 53856, 300)], 53856),
        "2d": ([a.to(dev) for a in link_demand_inputs(
            65573, 73920, 301)], 73920)}
    rs, eng, n_apps = paper_engine(PAPER_1D, dev)
    st = eng.init_state(seed=engine_seed(0))
    for _ in range(11):
        st = eng.tick(st)
    p = st.pool
    drains["live_1d"] = (live_drain_args(st, rs, dev), n_apps,
                         rs.topo.n_routers)
    demands["live_1d"] = ([x[None].contiguous()
                           for x in (p.routes, p.active, p.bytes_rem)],
                          rs.topo.n_links)
    live_active = int(p.active.sum())

    result = dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        other=args.other, live_active_messages=live_active,
        drain_tick={}, link_demand={})

    for case, (a, A, R) in drains.items():
        o = drain["full"](*a, A, R)
        n = drain_tick_cuda(*a, A, R)
        torch.cuda.synchronize()
        row = {f"{k}_differ": differ(x, y) for k, x, y in
               zip(("new_rem", "rate", "delivered"), o[:3], n[:3])}
        row.update({f"{k}_max_rel_diff": rel_diff(x, y) for k, x, y in
                    zip(("link_bytes_delta", "router_win_delta"), o[3:],
                        n[3:])})
        other_fn = lambda: drain["full"](*a, A, R)  # noqa: E731
        this_fn = lambda: drain_tick_cuda(*a, A, R)  # noqa: E731
        row["device_ms_other_this_this_other"] = [
            device_ms(f) for f in (other_fn, this_fn, this_fn, other_fn)]
        row["other_ops_per_call"], row["other_us_by_kernel"] = by_kernel(
            other_fn)
        row["this_ops_per_call"], row["this_us_by_kernel"] = by_kernel(this_fn)
        # the other build's pieces apart: its memsets alone (M = 0 makes
        # its entry point return after them) and its drain kernel with and
        # without each table's atomics
        row["other_memsets_device_ms"] = device_ms(
            lambda: drain["full"](*a, A, R, m=0))
        row["other_variants_device_ms"] = {
            name: device_ms(lambda f=f: f(*a, A, R))
            for name, f in drain.items()}
        row["other_variants_drain_kernel_us"] = {
            name: sum(us for k, us in by_kernel(
                lambda f=f: f(*a, A, R))[1].items() if "drain_kernel" in k)
            for name, f in drain.items()}
        result["drain_tick"][case] = row

    for case, (a, L) in demands.items():
        o = demand(*a, L)
        n = link_demand_cuda(*a, L)
        torch.cuda.synchronize()
        row = dict(sums_differ=differ(o, n), sums=o.numel())
        other_fn = lambda: demand(*a, L)  # noqa: E731
        this_fn = lambda: link_demand_cuda(*a, L)  # noqa: E731
        row["device_ms_other_this_this_other"] = [
            device_ms(f) for f in (other_fn, this_fn, this_fn, other_fn)]
        row["other_ops_per_call"], row["other_us_by_kernel"] = by_kernel(
            other_fn)
        row["this_ops_per_call"], row["this_us_by_kernel"] = by_kernel(this_fn)
        routes, active, rem = a
        B, M, K = routes.shape
        n_keys = B * (L + 1)
        keys = pieces["keys"](routes, active, L)
        sk, order = torch.sort(keys, stable=True)
        vals = pieces["gather"](rem, order, K)
        starts = pieces["starts"](sk, n_keys)
        row["other_pieces_device_ms"] = dict(
            keys=device_ms(lambda: pieces["keys"](routes, active, L)),
            sort=device_ms(lambda: torch.sort(keys, stable=True)),
            gather=device_ms(lambda: pieces["gather"](rem, order, K)),
            searchsorted=device_ms(lambda: pieces["starts"](sk, n_keys)),
            serial_sum=device_ms(
                lambda: pieces["serial"](vals, starts, n_keys)))
        row["valid_entries"] = int(((routes >= 0) & active[:, :, None]).sum())
        row["largest_run"] = int(torch.diff(starts).max())
        result["link_demand"][case] = row

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
