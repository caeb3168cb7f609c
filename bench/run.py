"""The port's benchmark: one cell, one run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (``BENCHMARK.json``). A run:

1. set-up: imports the port (``src/repro_torch``), builds or loads the
   simulator's kernels (``build/repro_torch/`` in the checkout), reads
   the cell's configuration (``configs/<config>.json``) and traffic
   (``traffic/<traffic>.json``), and warms up with one ``union.run``
   call of the cell's shape whose jobs arrive after the horizon: it
   captures the same graphs and fills the engine cache. The
   configuration's ``"kind"`` (a scenario file where it has none) names
   the module that knows its calls, ``kinds/<kind>.py``;
2. the window: ``union.run`` calls (repeats) of the cell's fixed study
   until ``--seconds`` have passed; every number covers all the repeats
   and all the time they took;
3. the check: a sample of the window's members or cells, drawn from the
   seed, is simulated again by the plain reference (``reference/``) and
   compared (``judge.py``, limits in ``limits/<config>.json``);
4. one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
   (the end-to-end metrics, or with ``--trace 1`` the per-layer ones,
   each read by ``metrics/<name>.py``), ``device`` and, traced,
   ``breakdown``; the compared numbers come last, on standard error too.

It exits non-zero, printing no result, without CUDA, with another number
of cards than the cell's, or when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNELS = ("drain_tick", "link_demand")
# repeats of a traced run on the card that hold a profile (the replay
# profile and the boundary profile's start, then its end); the engine's
# and the facade's readings take the repeats after them
PROFILED_REPEATS = 2


class NoRun(RuntimeError):
    """The run cannot be made here; nothing is printed on standard
    output."""


def _cache_env():
    """Kernel caches at fixed paths inside the checkout (the port builds
    its own kernels under ``build/repro_torch/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench_json: Path = ROOT / "BENCHMARK.json"):
    """The cell's entry, its configuration's entry and the metrics it
    reports, all from ``BENCHMARK.json``."""
    spec = json.loads(bench_json.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise NoRun(f"no workload {name!r} in {bench_json}")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return cell, config, mine(spec["end_to_end"]), mine(spec["per_layer"])


def kind_of(config: dict):
    """The module of a configuration's kind (``kinds/<kind>.py``; a file
    without ``"kind"`` is a scenario), found by name as metrics are."""
    kind = config.get("kind", "scenario")
    path = BENCH / "kinds" / f"{kind}.py"
    if not path.exists():
        raise NoRun(f"no configuration kind {kind!r} ({path})")
    return _load(path)


def run_cell(args, device=None, config_file=None, traffic_file=None,
             spec=None, limits_file=None) -> dict:
    """One run of the cell; returns the result line's object. ``device``
    "cpu", ``config_file`` and ``traffic_file`` rehearse it on the CPU at
    a small size (the tests); ``spec`` and ``limits_file`` stand for
    ``BENCHMARK.json`` and the configuration's limits there."""
    import torch

    import judge
    from profiling import QUIET_S, Tap

    cell, config, e2e, per_layer = cell_spec(
        args.workload, Path(spec or ROOT / "BENCHMARK.json"))
    chips = int(cell["chips"])
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            raise NoRun("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() != chips:
            raise NoRun(f"cell {cell['name']} takes {chips} card(s); "
                        f"{torch.cuda.device_count()} are visible")
    traffic = json.loads(Path(traffic_file or BENCH / "traffic" /
                              f"{cell['traffic']}.json").read_text())
    limits = json.loads(Path(limits_file or BENCH / "limits" /
                             f"{cell['config']}.json").read_text())
    cfg = json.loads(Path(config_file or ROOT / config["file"]).read_text())
    kind = kind_of(cfg)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import union  # noqa: F401  (counted as imports)
    from repro_torch.netsim import engine as ENG
    from repro_torch.obs import spans as SPANS

    t_import = time.perf_counter()
    if on_card:
        from repro_torch.kernels import _build

        _build.load_all(KERNELS)
    t_build = time.perf_counter()
    study = kind.Study(cell["name"], cfg, traffic, args.seed,
                       device or "cuda")

    def sync():
        if on_card:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)

    study.warmup()
    sync()
    setup_s = time.perf_counter() - T_START
    print(f"bench: set-up: imports {t_import - T_START:.3f} s, kernels "
          f"{t_build - t_import:.3f} s, warm-up "
          f"{T_START + setup_s - t_build:.3f} s", file=sys.stderr)

    tap = None
    if args.trace:
        SPANS.get_tracer().clear()
        SPANS.enable()
        if on_card:
            tap = Tap(rounds=study.tap_rounds)
            tap.install(*study.tap_target)
    repeats = []
    t_w0 = time.perf_counter()
    try:
        while True:
            if tap is not None:
                tap.repeat = len(repeats)
            t0 = time.perf_counter()
            res = study.call() if tap is None else _watched(tap, study.call)
            t1 = time.perf_counter()
            repeats.append(dict(study.record(res), wall_s=t1 - t0,
                                t0_ns=int(t0 * 1e9), t1_ns=int(t1 * 1e9)))
            # a traced window holds the two profiled repeats and one more
            if t1 - t_w0 >= args.seconds and (
                    tap is None or len(repeats) > PROFILED_REPEATS):
                break
        window_s = time.perf_counter() - t_w0
    finally:
        if tap is not None:
            tap.remove()
        SPANS.disable()
    if tap is not None and tap.unquiet:
        print(f"bench: {tap.unquiet} profiler start(s) or stop(s) found a "
              f"card's thread still running after {QUIET_S} s",
              file=sys.stderr)
    del res
    span_events = list(SPANS.get_tracer().events)
    span_origin = SPANS.get_tracer().origin_ns

    peak = None
    if on_card:
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))
    # the program's state and graphs go before the reference runs
    ENG.clear_engine_cache()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    print(f"bench: set-up {setup_s:.3f} s, window {window_s:.3f} s of "
          f"{len(repeats)} repeats (wall s, ticks, replay device ms: "
          + "; ".join(f"{r['wall_s']:.3f} {r['engine'].get('ticks')} "
                      f"{r['engine'].get('replay_device_ms', 0.0):.1f}"
                      for r in repeats) + ")", file=sys.stderr)
    correct, rows = judge.verdict(study.judge(repeats), limits)

    metrics = {}
    if not args.trace:
        rate = study.virtual_ms(repeats) / window_s
        values = dict(sim_rate=rate, scenario_rate=rate, split_rate=rate,
                      trace_rate=rate, setup_s=setup_s)
        if peak is not None:
            values["peak_mem_mib"] = peak / 2**20
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    else:
        ctx = dict(
            chips=chips, repeats=repeats,
            clean_repeats=repeats[PROFILED_REPEATS if tap else 0:],
            spans=span_events, span_origin_ns=span_origin,
            shapes=study.shapes(chips),
            replay_profile=tap.replay_profile if tap else None,
            boundary_profile=tap.boundary_profile if tap else None)
        for m in per_layer:
            v = _load(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])

    out = dict(correct=bool(correct), attempted=len(repeats) * study.units,
               failed=study.failed(repeats), metrics=metrics,
               device=device_block(on_card, chips, peak))
    if args.trace and tap is not None:
        out["device"].update(_busy(tap.boundary_profile, chips))
        out["breakdown"] = breakdown(tap, span_events, span_origin)
    out["checks"] = {name: dict(value=v, limit=lim) for name, v, lim in rows}
    found = forbidden_modules()
    if found:
        raise NoRun(f"loaded modules of JAX or the JAX package: {found}")
    return out


def _watched(tap, call):
    """``call()`` in a thread of its own while this thread serves the
    tap's requests to start and stop the profiler."""
    box = {}

    def work():
        try:
            box["out"] = call()
        except BaseException as e:  # re-raised in the harness's thread
            box["err"] = e

    th = threading.Thread(target=work)
    th.start()
    tap.serve(th)
    th.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def device_block(on_card: bool, chips: int, peak) -> dict:
    if not on_card:
        return dict(platform="cpu", kind="cpu (rehearsal, not the card)",
                    count=1, memory_peak_bytes=None)
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, memory_peak_bytes=int(peak))


def _busy(bp, chips: int) -> dict:
    """Busy seconds of the boundary profile, averaged over the cards, and
    its length."""
    if not bp:
        return {}
    from profiling import union_ns

    busy = [union_ns([(e[2], e[3]) for e in bp["events"]
                      if e[4] and e[1] == d], bp["lo"], bp["hi"])
            for d in range(chips)]
    return dict(busy_s=sum(busy) / len(busy) / 1e9,
                window_s=(bp["hi"] - bp["lo"]) / 1e9)


def breakdown(tap, spans, origin_ns) -> dict:
    """The device operations that took most time in the replay profile,
    and the longest idle gaps of card 0 in the boundary profile, each
    named by the innermost host span around its middle."""
    from profiling import gaps_ns

    out = {}
    rp = tap.replay_profile
    if rp:
        ops = sorted(rp["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
        out["device_ops"] = [[name, s] for name, (s, _) in ops]
    bp = tap.boundary_profile
    if bp:
        off = bp["offset_ns"]
        sp = [(origin_ns + int(e["ts_us"] * 1000) + off,
               origin_ns + int((e["ts_us"] + e["dur_us"]) * 1000) + off,
               e["name"]) for e in spans if e.get("ph") != "C"]
        gaps = gaps_ns([(e[2], e[3]) for e in bp["events"]
                        if e[4] and e[1] == 0], bp["lo"], bp["hi"])
        rows = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) // 2
            inside = [s for s in sp if s[0] <= mid <= s[1]]
            name = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                    else "between union.run calls")
            rows.append([name, (b - a) / 1e9])
        out["idle_gaps"] = rows
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def print_checks(out: dict) -> None:
    """The compared numbers, each beside its limit, on standard error."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)


def report(out: dict) -> None:
    """The compared numbers on standard error, then the result line."""
    print_checks(out)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    _cache_env()
    sys.path.insert(0, str(BENCH))
    try:
        out = run_cell(args)
    except NoRun as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
