#!/usr/bin/env python3
"""Hold this checkout's simulator kernels against another build of them, on one card.

    mkdir -p build/sim_ab_other
    for f in drain_tick.cu router_tick.cu sim_rows.cuh; do
      git show <rev>:src/repro_torch/kernels/csrc/$f > build/sim_ab_other/$f
    done
    python3 tools/sim_kernels_ab.py build/sim_ab_other

The directory holds any of ``drain_tick.cu``, ``link_demand.cu`` and
``router_tick.cu`` (with the ``sim_rows.cuh`` they include, if any); the
tool holds each one it finds against the checkout's, builds them with the
flags of ``repro_torch.kernels._build`` into ``build/``, one nvcc each,
all at once, and runs both builds on:

* ``chip_smoke.py``'s phase 2 inputs (drain tick), phase 3 inputs (link
  demand) and phase 5 cases (route-rate-drain: random, padded and NaN);
* a live pool: the paper's 1D scenario (workload1) ticked 11 ticks on the
  card, about 10,000 messages in flight (the route-rate-drain takes the
  share table of that state, as chip_smoke's ``live_ms`` does).

``drain_tick.cu`` may be of the first design (three tables zeroed with
``cudaMemsetAsync``, then a counting and a drain kernel): the tool then
also builds variants of its drain kernel without its link-table atomics,
its router-table atomics or both. Or of the later design, whose C
interface is the checkout's. ``link_demand.cu`` is of the first design:
it takes the values in key order and the run starts that a stable sort
and a ``searchsorted`` give (that Python lives here, not in the package).
``router_tick.cu`` has the checkout's C interface; the tool builds its
pieces apart (an empty launch of its grid, the floor; the flags and
remaining bytes loaded without the rows; the rows too, without the
gathers) from both sources, and the checkout's kernel at other block
shapes and messages a thread (``SWEEP``) and with other load choices
(``ROUTER_ALTERNATIVES``).

It prints one JSON line: for each input, how many values differ bit for
bit between the two builds (NaN equal to NaN) and from the plain version,
and the largest relative difference of the drain tick's byte deltas; each
build's device milliseconds a call (a CUDA graph of 20 calls, timed in
turns: other, this, this, other); device operations a call and device
microseconds by kernel under the profiler; and the pieces above. Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = Path(ROOT) / "src" / "repro_torch" / "kernels" / "csrc"
OUT = Path(ROOT) / "build" / "sim_ab"

# cuts of the first design's drain kernel
LB_ATOMIC = "    atomicAdd(lb + l, drain);\n"
RW_ATOMIC = "    atomicAdd(rw + link_dst_router[l], drain);\n"
DRAIN_VARIANTS = {"full": (), "no_router_atomics": (RW_ATOMIC,),
                  "no_link_atomics": (LB_ATOMIC,),
                  "no_atomics": (LB_ATOMIC, RW_ATOMIC)}

# the route-rate-drain's pieces: (text, replacement) cuts of each design
OLD_GATHER = ("      if (l >= 0) rmin = fminf(rmin, __ldg(share + l));\n",
              "      if (l >= 0) rmin = fminf(rmin, (float)l);\n")
NEW_GATHER = ("      s[j][k] = l[j][k] >= 0 ? __ldg(share + l[j][k]) : "
              "INFINITY;\n", "      s[j][k] = (float)l[j][k];\n")
ROUTER_PIECES = {
    "other": {
        "full": (),
        "empty": (("  if (m >= M) return;\n", "  return;\n"),),
        "flags_only": (("      const int32_t l = row[k];\n",
                        "      const int32_t l = k;\n"), OLD_GATHER),
        "no_gathers": (OLD_GATHER,),
    },
    "this": {
        "full": (),
        "empty": (("  if (m0 >= M) return;\n", "  return;\n"),),
        "flags_only": (("      const int2 w = flag[j] ? __ldg(row + k) : "
                        "make_int2(-1, -1);\n",
                        "      const int2 w = make_int2(flag[j] ? k : -1, "
                        "-1);\n"), NEW_GATHER),
        "no_gathers": (NEW_GATHER,),
    },
}
# block shapes and messages a thread the checkout's kernel is built with
SWEEP = [(threads, per_thread) for threads in (32, 64, 128, 256, 512)
         for per_thread in (1, 2, 4)]
# other choices of the checkout's kernel at its own shape: the gathers
# through the L2 only (ld.global.cg), and the rows loaded with the flags
# instead of after them (the gathers still skip inactive messages); and,
# to tell which resource holds the gathers (their results then are wrong
# and are not compared), the gathers confined to the table's first 4 KB
# (32 lines that stay in the L1, a warp's 32 gathers still on up to 32
# lines) and to its first 128 bytes (one line a warp's gather)
ROUTER_ALTERNATIVES = {
    "gather_cg": (("__ldg(share + l[j][k])", "__ldcg(share + l[j][k])"),),
    "gather_4kb": (("__ldg(share + l[j][k])",
                    "__ldg(share + (l[j][k] & 1023))"),),
    "gather_128b": (("__ldg(share + l[j][k])",
                     "__ldg(share + (l[j][k] & 31))"),),
    "rows_with_flags": (
        ("      const int2 w = flag[j] ? __ldg(row + k) : "
         "make_int2(-1, -1);\n",
         "      const int2 w = m0 + j < M ? __ldg(row + k) : "
         "make_int2(-1, -1);\n"),
        ("      s[j][k] = l[j][k] >= 0 ? __ldg",
         "      s[j][k] = flag[j] && l[j][k] >= 0 ? __ldg")),
}
SWEEP_CASES = ("random_1d", "padded_rows_1d", "live_1d")


def cut(text, cuts, what):
    for old, new in cuts:
        if old not in text:
            raise SystemExit(f"sim_kernels_ab: {old.strip()!r} not in {what}")
        text = text.replace(old, new)
    return text


def build(sources, other_dir: Path):
    """Compile {name: source path}, one nvcc each, all at once, with the
    package's flags. The checkout's route-rate-drain builds
    (``router_this_*``, ``router_sweep_*``) take their quoted headers from
    the checkout's ``csrc/``; the other build's look in ``other_dir``
    first."""
    from repro_torch.kernels import _build

    jobs = {}
    for name, src in sources.items():
        mine = name.startswith(("router_this_", "router_sweep_",
                                "router_alt_"))
        inc = [f"-I{d}" for d in ([] if mine else [other_dir.resolve()])
               + [CSRC]]
        so = OUT / f"{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.file_flags(src), *inc, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sim_kernels_ab: nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def write(name, text):
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return path


def drain_sources(other_dir: Path):
    """The other drain tick, and its variants if it is of the first
    design; whether it is."""
    text = (other_dir / "drain_tick.cu").read_text()
    first = LB_ATOMIC in text and RW_ATOMIC in text
    variants = DRAIN_VARIANTS if first else {"full": ()}
    return {f"drain_tick_{n}": write(f"drain_tick_{n}", cut(
        text, [(line, "") for line in c], "the other drain_tick.cu"))
        for n, c in variants.items()}, first


def router_sources(other_dir: Path):
    """The pieces of both route-rate-drain sources and the sweep of the
    checkout's."""
    srcs = {}
    texts = {"other": (other_dir / "router_tick.cu").read_text(),
             "this": (CSRC / "router_tick.cu").read_text()}
    for who, pieces in ROUTER_PIECES.items():
        for piece, c in pieces.items():
            srcs[f"router_{who}_{piece}"] = write(
                f"router_{who}_{piece}",
                cut(texts[who], c, f"the {who} router_tick.cu"))
    for alt, c in ROUTER_ALTERNATIVES.items():
        srcs[f"router_alt_{alt}"] = write(
            f"router_alt_{alt}", cut(texts["this"], c, "router_tick.cu"))
    for threads, per in SWEEP:
        text = re.sub(r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {threads};", texts["this"])
        text = re.sub(r"constexpr int kPerThread = \d+;",
                      f"constexpr int kPerThread = {per};", text)
        srcs[f"router_sweep_{threads}x{per}"] = write(
            f"router_sweep_{threads}x{per}", text)
    return srcs


def other_drain(lib):
    """A drain-tick wrapper around ``lib`` (the C interface of both
    designs)."""
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


def router_runner(lib):
    """A route-rate-drain wrapper around ``lib`` (the checkout's C
    interface)."""
    import torch

    from repro_torch.kernels import _build

    launch = lib.router_rate_drain_launch
    launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    launch.restype = ctypes.c_int

    def run(routes, rem, act, share, dt):
        M, K = routes.shape
        dev = routes.device
        out = [torch.empty((M,), device=dev), torch.empty((M,), device=dev),
               torch.empty((M,), dtype=torch.bool, device=dev)]
        p = _build.ptr
        err = launch(p(routes), p(rem), p(act), p(share),
                     ctypes.c_float(float(dt)), M, K, *(p(x) for x in out),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"a route-rate-drain build failed ({err})")
        return out
    return run


def differ(a, b):
    """Values whose bits differ (floats compared as int32, NaN equal to
    NaN whatever its payload)."""
    import torch

    if a.dtype == torch.float32:
        nan = torch.isnan(a) & torch.isnan(b)
        a = torch.where(nan, 0, a.view(torch.int32))
        b = torch.where(nan, 0, b.view(torch.int32))
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


def drain_ab(drain, first, drains, device_ms):
    from repro_torch.kernels.drain_tick import drain_tick_cuda
    import torch

    out = {}
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
        if first:
            # the first design's pieces apart: its memsets alone (M = 0
            # makes its entry point return after them) and its drain
            # kernel with and without each table's atomics
            row["other_memsets_device_ms"] = device_ms(
                lambda: drain["full"](*a, A, R, m=0))
            row["other_variants_device_ms"] = {
                name: device_ms(lambda f=f: f(*a, A, R))
                for name, f in drain.items()}
            row["other_variants_drain_kernel_us"] = {
                name: sum(us for k, us in by_kernel(
                    lambda f=f: f(*a, A, R))[1].items()
                    if "drain_kernel" in k)
                for name, f in drain.items()}
        out[case] = row
    return out


def demand_ab(demand, pieces, demands, device_ms):
    from repro_torch.kernels.link_demand import link_demand_cuda
    import torch

    out = {}
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
        out[case] = row
    return out


def router_ab(runners, cases, device_ms):
    from repro_torch.kernels.router_tick import (
        router_rate_drain_cuda, router_rate_drain_plain)
    import torch

    names = ("new_rem", "rate", "drained")
    out = {}
    for case, (a, dt) in cases.items():
        o = runners["router_other_full"](*a, dt)
        n = router_rate_drain_cuda(*a, dt)
        p = router_rate_drain_plain(*a, dt)
        torch.cuda.synchronize()
        row = dict(M=a[0].shape[0], L=a[3].shape[0], active=int(a[2].sum()),
                   differ_other_vs_this={k: differ(x, y) for k, x, y in
                                         zip(names, o, n)},
                   differ_this_vs_plain={k: differ(x, y) for k, x, y in
                                         zip(names, n, p)})
        other_fn = lambda: runners["router_other_full"](*a, dt)  # noqa: E731
        this_fn = lambda: router_rate_drain_cuda(*a, dt)  # noqa: E731
        row["device_ms_other_this_this_other"] = [
            device_ms(f) for f in (other_fn, this_fn, this_fn, other_fn)]
        for who in ROUTER_PIECES:
            row[f"{who}_pieces_device_ms"] = {
                piece: device_ms(lambda f=runners[f"router_{who}_{piece}"]:
                                 f(*a, dt))
                for piece in ROUTER_PIECES[who]}
        if case in SWEEP_CASES:
            row["this_sweep_device_ms"] = {
                f"{t}x{m}": device_ms(lambda f=runners[
                    f"router_sweep_{t}x{m}"]: f(*a, dt))
                for t, m in SWEEP}
            row["this_alternatives_device_ms"] = {
                alt: device_ms(lambda f=runners[f"router_alt_{alt}"]:
                               f(*a, dt))
                for alt in ROUTER_ALTERNATIVES}
        out[case] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="directory holding the other drain_tick.cu,"
                    " link_demand.cu or router_tick.cu (any of them)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sim_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tests")]
    from chip_smoke import (
        PAPER_1D, device_ms, drain_inputs, link_demand_inputs,
        live_drain_args, live_router_args, paper_engine, router_cases)
    from repro_torch.kernels import _build
    from repro_torch.union.seeds import engine_seed

    other = Path(args.other)
    have = {n for n in ("drain_tick", "link_demand", "router_tick")
            if (other / f"{n}.cu").exists()}
    if not have:
        raise SystemExit(f"sim_kernels_ab: no kernel source in {other}")
    dev = torch.device("cuda", 0)
    _build.load_all(sorted(have))
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    first = False
    if "drain_tick" in have:
        srcs, first = drain_sources(other)
        sources.update(srcs)
    if "link_demand" in have:
        sources["link_demand"] = other / "link_demand.cu"
    if "router_tick" in have:
        sources.update(router_sources(other))
    libs = build(sources, other)

    # the live pool: the 1D paper run ticked 11 ticks on the card
    rs, eng, n_apps = paper_engine(PAPER_1D, dev)
    st = eng.init_state(seed=engine_seed(0))
    for _ in range(11):
        st = eng.tick(st)
    p = st.pool
    result = dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        other=args.other, kernels=sorted(have),
        live_active_messages=int(p.active.sum()))

    if "drain_tick" in have:
        drain = {n: other_drain(libs[f"drain_tick_{n}"])
                 for n in (DRAIN_VARIANTS if first else ("full",))}
        drains = {"1d": (drain_inputs(1, 65536, 10, 53857, 5, 1056, 100,
                                      False, dev), 5, 1056),
                  "2d": (drain_inputs(1, 65573, 10, 73921, 5, 2112, 101,
                                      False, dev), 5, 2112),
                  "live_1d": (live_drain_args(st, rs, dev), n_apps,
                              rs.topo.n_routers)}
        result["drain_tick"] = dict(
            other_design="first" if first else "later",
            cases=drain_ab(drain, first, drains, device_ms))
    if "link_demand" in have:
        demand, pieces = other_demand(libs["link_demand"])
        demands = {
            "1d": ([a.to(dev) for a in link_demand_inputs(
                65536, 53856, 300)], 53856),
            "2d": ([a.to(dev) for a in link_demand_inputs(
                65573, 73920, 301)], 73920),
            "live_1d": ([x[None].contiguous()
                         for x in (p.routes, p.active, p.bytes_rem)],
                        rs.topo.n_links)}
        result["link_demand"] = demand_ab(demand, pieces, demands, device_ms)
    if "router_tick" in have:
        runners = {n: router_runner(lib) for n, lib in libs.items()
                   if n.startswith("router_")}
        cases = {c: (a, 5.0) for c, a in router_cases(dev).items()}
        cases["live_1d"] = live_router_args(st, rs, dev)
        result["router_rate_drain"] = router_ab(runners, cases, device_ms)

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
