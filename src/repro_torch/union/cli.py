"""``python -m repro_torch.union``: flags -> one Experiment -> ``union.run``.

The CLI is a thin translation layer over the port's Experiment facade:
every mode (scenario campaigns, ragged multi-scenario campaigns,
online-trace scheduling, whole experiment files) builds one
:class:`~repro_torch.union.experiment.Experiment`, runs it through the
single front door, and renders/saves the uniform Results artifact. The
flags, ``--list`` and the result files are the JAX package's
``python -m repro.union``'s; ``--device`` (default ``cuda``; a run raises
without a card) is the port's own, and ``--device cpu`` runs the
engine's CPU path.

Examples::

    # run a saved experiment spec end to end
    python -m repro_torch.union --experiment my_study.json

    # 8-member vmapped campaign of the paper's workload1 mix
    python -m repro_torch.union --scenario workload1 --members 8 --iters 2

    # ragged campaign: members with different job/rank counts
    python -m repro_torch.union --scenario mix_a.json mix_b.json --members 4

    # per-app baselines + the (app x placement policy) interference grid
    python -m repro_torch.union --scenario workload1 --baselines \
        --placements RN RR RG

    # online scheduling: a 64-job Poisson stream through 8 job slots
    python -m repro_torch.union --trace poisson --trace-jobs 64 \
        --sched fcfs easy

    # what would run, without running it
    python -m repro_torch.union --scenario workload1 --plan

    # enumerate builtin mixes, catalog apps, and saved specs
    python -m repro_torch.union --list
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from typing import Dict, List, Optional

from repro_torch import obs
from repro_torch.netsim.fabric import fabric_names
from repro_torch.obs import log
from repro_torch.union import experiment as EXP
from repro_torch.union import planner as PLN
from repro_torch.union import report as REP
from repro_torch.union.scenario import (
    MIXES, MIX_HAS_UR, Scenario, load_scenario)


def _apply_cli_overrides(sc: Scenario, args) -> Scenario:
    sc = dataclasses.replace(
        sc, jobs=[dataclasses.replace(j) for j in sc.jobs])
    if args.topo and len(args.topo) == 1:
        sc.topo = args.topo[0]  # several fabrics become a grid axis instead
    if args.horizon_ms is not None:
        sc.horizon_ms = args.horizon_ms
    if args.tick_us is not None:
        sc.tick_us = args.tick_us
    if args.iters is not None:
        for j in sc.jobs:
            if j.source is not None:
                continue  # inline-DSL jobs declare their own parameters
            key = "updates" if j.app == "alexnet" else "iters"
            j.overrides = dict(j.overrides, **{key: args.iters})
    return sc


def _list_specs(out=print) -> None:
    """--list: builtin mixes, baseline apps, and saved spec files."""
    out("builtin mixes (--scenario <name>):")
    for name, apps in MIXES.items():
        ur = " + UR background" if name in MIX_HAS_UR else ""
        out(f"  {name:>12}: {', '.join(apps)}{ur}")
    from repro_torch.core import workloads as W

    out("baseline-<app> (each app alone), apps from the catalog:")
    out(f"  {', '.join(sorted(W.SPECS))}")
    out("synthetic traces (--trace): poisson, weibull")
    # look next to the cwd AND next to the installed package (the repo
    # root when running from a source tree), so --list works from anywhere
    repo_root = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    bases = [os.getcwd()]
    if repo_root not in bases:
        bases.append(repo_root)
    found = set()
    for base in bases:
        for pattern, kind in (
            ("examples/experiments/*.json", "experiment"),
            ("examples/scenarios/*.json", "scenario/trace"),
            ("results/union/*.json", "results artifact"),
        ):
            for p in sorted(glob.glob(os.path.join(base, pattern))):
                if p in found:
                    continue
                if not found:
                    out("saved specs:")
                found.add(p)
                out(f"  [{kind}] {os.path.relpath(p)}")
    if not found:
        out("saved specs: none found (looked in examples/experiments, "
            "examples/scenarios, results/union)")


def _save_results(res: EXP.Results, out_dir: str, tag: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag[:120] + ".json")
    res.save(path)
    print(f"wrote {path}")


def _build_trace_study(ap, args) -> EXP.TraceStudy:
    if args.trace in ("poisson", "weibull"):
        topo = args.topo[0] if args.topo else None
        if args.topo and len(args.topo) > 1:
            ap.error("--trace supports a single --topo fabric per run")
        return EXP.TraceStudy(
            source=args.trace, jobs=args.trace_jobs,
            gap_us=args.trace_gap_us, slots=args.slots, topo=topo,
            policies=list(args.sched), seeds=args.trace_seeds,
        )
    if os.path.exists(args.trace):
        if args.topo:
            ap.error("--topo is not supported with a trace file: the file"
                     " declares its own 'topo' — edit the trace instead")
        return EXP.TraceStudy(
            source=args.trace, slots=args.slots, policies=list(args.sched),
            seeds=args.trace_seeds,
        )
    if args.trace.endswith(".json"):
        ap.error(f"--trace {args.trace!r}: file not found")
    ap.error(f"--trace {args.trace!r}: not a file and not"
             " 'poisson'/'weibull'")


def _grid_summaries(res: EXP.Results, name: str, topo: str, routing: str,
                    policies: List[str]) -> Dict[str, Dict]:
    """Per-placement-policy campaign summaries of one scenario group."""
    groups = res.summary["scenario_studies"]
    return {pol: groups[f"{name}/{topo}/{pol}/{routing}"]
            for pol in policies if f"{name}/{topo}/{pol}/{routing}" in groups}


def _run_experiment(args, exp: EXP.Experiment,
                    tag: Optional[str] = None) -> None:
    from repro_torch import union

    if args.probes:
        exp.probes = args.probes
        exp.probe_every = args.probe_every
    if args.hist:
        exp.hist = args.hist
    if args.timeline:
        exp.timeline = True
    if getattr(args, "failures", None):
        import json

        from repro_torch.netsim.faults import normalize_failures

        # the failures axis crosses every mode's grid; runtime fault
        # masks, so the axis costs zero extra engine compiles. A .json
        # entry is a failure-spec file (name + timed events).
        entries = []
        for f in args.failures:
            if isinstance(f, str) and f.endswith(".json"):
                with open(f) as fh:
                    entries.append(json.load(fh))
            else:
                entries.append(f)
        exp.grid = dataclasses.replace(
            exp.grid, failures=normalize_failures(entries))
    if args.plan:
        print(PLN.plan(exp).describe())
        return
    res = union.run(exp, store=args.store, device=args.device)
    if args.store:
        st = res.telemetry.get("store", {})
        print(f"store {args.store}: {st.get('hits', 0)} cell(s) reused, "
              f"{st.get('misses', 0)} simulated")
        if getattr(args, "store_max_bytes", None):
            from repro_torch.union.store import store_gc

            g = store_gc(args.store, max_bytes=args.store_max_bytes)
            print(f"store gc: removed {g['removed']} entr(ies), "
                  f"{g['entries']} kept ({g['bytes']} bytes)")
    _attach_interference(args, exp, res)
    print(REP.format_results(res))
    _print_interference(res)
    _save_results(res, args.out, tag or f"experiment__{exp.name}")
    if args.profile:
        obs.write_chrome_trace(args.profile)
        base, _ = os.path.splitext(args.profile)
        obs.write_jsonl(base + ".jsonl")
        print(f"wrote trace {args.profile} (+ {base}.jsonl)")
    if args.timeline:
        named = [(c.key, c.report["timeline"]) for c in res.cells
                 if "timeline" in c.report]
        if named:
            obs.write_sim_trace(args.timeline, named)
            print(f"wrote sim-time trace {args.timeline} "
                  f"({len(named)} cell(s))")
        else:
            log.warning("--timeline: no trace cells in this run; nothing"
                        " to export")
    if args.metrics:
        obs.write_openmetrics(args.metrics)
        print(f"wrote metrics {args.metrics}")


def _attach_interference(args, exp: EXP.Experiment, res: EXP.Results) -> None:
    """--baselines: co-run-vs-baseline inflation (and the per-placement
    interference matrix with --placements), from the grouped summaries of
    the *same* Results — baselines ran inside the one experiment."""
    if not getattr(args, "baselines", False) or not exp.scenarios:
        return
    sc = exp.scenarios[0]
    pols = [sc.placement] + [
        p for p in (args.placements or []) if p != sc.placement]
    baseline_apps = [s.name.split("baseline-", 1)[1]
                     for s in exp.scenarios if s.name.startswith("baseline-")]
    by_policy = _grid_summaries(res, sc.name, sc.topo, sc.routing, pols)
    baselines_by_policy = {
        pol: {app: _grid_summaries(
            res, f"baseline-{app}", sc.topo, sc.routing, [pol])[pol]
            for app in baseline_apps}
        for pol in pols
    }
    res.summary["baselines"] = baselines_by_policy[sc.placement]
    res.summary["interference"] = REP.interference_summary(
        by_policy[sc.placement], baselines_by_policy[sc.placement])
    if args.placements:
        res.summary["interference_matrix"] = REP.interference_matrix(
            by_policy, baselines_by_policy)


def _print_interference(res: EXP.Results) -> None:
    inf = res.summary.get("interference")
    if inf:
        print("=== interference (co-run vs baseline) ===")
        for app, d in inf.items():
            print(f"  {app:>12}: latency x{d['latency_inflation']:.2f} "
                  f"(variation {d['latency_variation_baseline']:.1%} -> "
                  f"{d['latency_variation_corun']:.1%}) | "
                  f"comm time x{d['comm_time_inflation']:.2f}")
    matrix = res.summary.get("interference_matrix")
    if matrix:
        print("=== interference matrix (app x placement policy) ===")
        for app in matrix["apps"]:
            row = " ".join(
                f"{pol}: x{matrix['comm_time_inflation'][app][pol]:.2f}"
                for pol in matrix["comm_time_inflation"][app])
            print(f"  {app:>12} comm-time inflation | {row}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.union",
        description="Union workload manager — one front door: declarative "
        "Experiments over scenarios, traces, and study grids.",
    )
    ap.add_argument("--experiment", default=None, metavar="PATH",
                    help="run a saved Experiment JSON spec through the"
                    " facade (the other flags below are translations onto"
                    " the same spec)")
    ap.add_argument("--scenario", nargs="+",
                    help=f"scenario JSON file(s), or builtin: {sorted(MIXES)}"
                    " / baseline-<app>. More than one spec runs a *ragged*"
                    " campaign: members with different job/rank counts,"
                    " bucketed by engine envelope, one batched run per"
                    " bucket.")
    ap.add_argument("--trace", default=None,
                    help="online-scheduler mode: a trace JSON file, or"
                    " 'poisson' / 'weibull' for a synthetic arrival stream"
                    " drawn from the app catalog (see docs/sched.md)")
    ap.add_argument("--sched", nargs="+", default=["easy"],
                    choices=["fcfs", "easy", "conservative"],
                    help="queue policy(ies) for --trace runs; more than one"
                    " compares policies on the same trace + engine")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine job slots (Jmax envelope) for --trace runs"
                    " (default: the trace's own 'slots', 8 for synthetic)")
    ap.add_argument("--trace-jobs", type=int, default=64,
                    help="synthetic trace length (--trace poisson/weibull)")
    ap.add_argument("--trace-gap-us", type=float, default=2000.0,
                    help="mean interarrival gap for synthetic traces")
    ap.add_argument("--trace-seeds", type=int, default=1,
                    help="number of trace seeds (campaign over seeds x"
                    " policies; synthetic traces redraw arrivals per seed)")
    ap.add_argument("--topo", nargs="+", default=None,
                    choices=sorted(fabric_names()),
                    help="network fabric(s): one value overrides the"
                    " scenario's/trace's topology; several cross the study"
                    " grid over fabrics (same job mix on every named"
                    " fabric, one Results artifact)")
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequential", action="store_true",
                    help="loop members instead of one batched run"
                    " (debug/bench)")
    ap.add_argument("--baselines", action="store_true",
                    help="also run each app alone (inside the same"
                    " experiment); report interference deltas")
    ap.add_argument("--placements", nargs="+", default=None,
                    choices=["RN", "RR", "RG"],
                    help="cross the study grid over these placement"
                    " policies (one run, grouped summaries); with"
                    " --baselines additionally report the per-(app,"
                    " policy) interference matrix (Fig. 7/9 grid)")
    ap.add_argument("--strict", action="store_true",
                    help="raise when the message pool drops allocations")
    ap.add_argument("--arrival-jitter-us", type=float, default=0.0,
                    help="per-member random extra arrival offset per job")
    ap.add_argument("--iters", type=int, default=None,
                    help="override every named app's iteration count "
                    "(inline-DSL jobs are left untouched)")
    ap.add_argument("--horizon-ms", type=float, default=None)
    ap.add_argument("--tick-us", type=float, default=None)
    ap.add_argument("--out", default="results/union")
    ap.add_argument("--store", metavar="DIR", default=None,
                    help="content-hash experiment store: cells already in"
                    " DIR are returned without simulation, fresh cells"
                    " are persisted — re-running a grid re-executes only"
                    " changed cells (the same store a repro_torch.union.serve"
                    " server uses; see docs/serve.md)")
    ap.add_argument("--store-max-bytes", type=int, default=None,
                    metavar="N",
                    help="after the run, garbage-collect the --store"
                    " down to N bytes (oldest-written entries evicted"
                    " first; see repro_torch.union.store.store_gc)")
    ap.add_argument("--failures", nargs="+", default=None,
                    metavar="SPEC",
                    help="failures-axis grid entries"
                    " (repro_torch.netsim.faults): 'healthy', 'links:P' /"
                    " 'routers:P' (random fraction dead),"
                    " 'level:NAME[:P]' (a fabric level),"
                    " 'block:P' (contiguous router block / correlated"
                    " outage), 'degrade:P:F' (fraction P at bandwidth"
                    " factor F), or a failure-spec JSON file with timed"
                    " events. Fault masks are runtime data — the whole"
                    " axis shares each variant's one compiled engine")
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="enable the host-plane span tracer (repro_torch.obs)"
                    " and write a Chrome trace-event JSON here (open in"
                    " Perfetto / chrome://tracing), plus a .jsonl run log"
                    " beside it")
    ap.add_argument("--probes", type=int, default=0, metavar="N",
                    help="enable sim-plane probes: N-sample ring buffers"
                    " of per-level link utilization, in-flight latency,"
                    " pool occupancy, and queue depth per cell (a probed"
                    " engine variant — its own compile cache entry)")
    ap.add_argument("--probe-every", type=int, default=8, metavar="K",
                    help="probe sampling period in engine ticks")
    ap.add_argument("--hist", type=int, default=0, metavar="BINS",
                    help="enable full-fidelity per-(app, link-level)"
                    " latency histograms with BINS log buckets (p50/p95/"
                    "p99/max + variation per app; a histogrammed engine"
                    " variant — its own compile cache entry)")
    ap.add_argument("--timeline", metavar="SIM.json", default=None,
                    help="record sim-time job lifecycle timelines for"
                    " trace cells (arrival/queue/backfill/run/drain) and"
                    " write them here as a Chrome trace over *virtual*"
                    " time (one track per engine slot)")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="write the process-wide metrics registry"
                    " (cells completed, window rounds, engine-cache"
                    " traffic, throughput) as OpenMetrics text")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs"
                    " the engine's CPU path with the plain versions of the"
                    " kernels)")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="diagnostic logging (-v info, -vv debug; default"
                    " warnings only)")
    ap.add_argument("--emit", metavar="PATH", default=None,
                    help="write the resolved scenario (or experiment) spec"
                    " to PATH and exit")
    ap.add_argument("--plan", action="store_true",
                    help="print the planner's lowering (nodes, envelopes,"
                    " engine reuse) and exit without running")
    ap.add_argument("--list", action="store_true", dest="list_specs",
                    help="enumerate builtin mixes, catalog apps, and saved"
                    " scenario/experiment specs, then exit")
    args = ap.parse_args(argv)
    obs.set_verbosity(args.verbose)
    if args.profile:
        obs.enable()

    if args.list_specs:
        _list_specs()
        return

    if args.experiment is not None:
        if args.topo:
            ap.error("--topo is not supported with --experiment: set the"
                     " scenario 'topo' or grid 'fabrics' in the spec")
        exp = EXP.load_experiment(args.experiment)
        if args.emit:
            exp.to_json(args.emit)
            print(f"wrote experiment spec to {args.emit}")
            return
        log.info("experiment: %s", exp.name)
        _run_experiment(args, exp, tag=f"experiment__{exp.name}"
                        f"_s{exp.base_seed}")
        return

    if args.trace is not None:
        study = _build_trace_study(ap, args)
        synthetic = study.source in ("poisson", "weibull")
        exp = EXP.Experiment(
            name=f"trace-{args.trace}" if synthetic
            else f"trace-{os.path.basename(args.trace)}",
            trace=study, base_seed=args.seed,
        )
        seeds = study.seed_list(args.seed)
        log.info("trace campaign: %s x %d seed(s) x policies %s",
                 exp.name, len(seeds), args.sched)
        _run_experiment(
            args, exp,
            tag=f"trace__{exp.name}__{'+'.join(args.sched)}_s{args.seed}")
        return

    if not args.scenario:
        ap.error("one of --experiment, --scenario or --trace is required")

    scenarios = [
        _apply_cli_overrides(load_scenario(s), args) for s in args.scenario
    ]
    sc = scenarios[0]
    if args.emit:
        sc.to_json(args.emit)
        print(f"wrote scenario spec to {args.emit}")
        return

    if len(scenarios) > 1:
        # ragged campaign: every scenario contributes --members members
        # (seeds base_seed..base_seed+members-1), mixed shapes in one run.
        if args.baselines or args.arrival_jitter_us:
            ap.error("--baselines / --arrival-jitter-us are not supported "
                     "with multiple scenarios (ragged campaigns); run the "
                     "scenarios separately for baselines")
        names = "+".join(s.name for s in scenarios)
        log.info("ragged campaign: %s x %d members each (%s)", names,
                 args.members,
                 "batched" if not args.sequential else "sequential")
        grid = EXP.StudyGrid()
        if args.topo and len(args.topo) > 1:
            grid = EXP.StudyGrid(fabrics=list(dict.fromkeys(args.topo)))
        exp = EXP.Experiment(
            name=names, scenarios=scenarios, members=args.members,
            base_seed=args.seed, grid=grid, vmapped=not args.sequential,
            strict=args.strict,
        )
        _run_experiment(args, exp,
                        tag=f"ragged__{names}__m{args.members}_s{args.seed}")
        return

    exp_scenarios = [sc]
    if args.baselines and args.topo and len(args.topo) > 1:
        # baseline/interference summaries are single-fabric (they join
        # co-run and baseline groups on the scenario's own coordinates)
        ap.error("--baselines is not supported with several --topo fabrics;"
                 " run one fabric at a time")
    if args.baselines:
        for job in sc.jobs:
            exp_scenarios.append(dataclasses.replace(
                sc, name=f"baseline-{job.app}",
                jobs=[dataclasses.replace(job, start_us=0.0)], ur=None))
    fabrics = None
    if args.topo and len(args.topo) > 1:
        # exactly the named fabrics, in order (the scenario's own topo
        # joins the sweep only if named) — same semantics as the ragged
        # multi-scenario path
        fabrics = list(dict.fromkeys(args.topo))
    grid = EXP.StudyGrid(fabrics=fabrics)
    if args.placements:
        pols = [sc.placement] + [p for p in args.placements
                                 if p != sc.placement]
        grid = EXP.StudyGrid(placements=pols, fabrics=fabrics)
    exp = EXP.Experiment(
        name=sc.name, scenarios=exp_scenarios, members=args.members,
        base_seed=args.seed, grid=grid, vmapped=not args.sequential,
        strict=args.strict, arrival_jitter_us=args.arrival_jitter_us,
    )
    log.info("campaign: %s x %d members (%s)", sc.name, args.members,
             "vmapped" if not args.sequential else "sequential")
    _run_experiment(
        args, exp,
        tag=f"{sc.name}__{sc.topo}__{sc.placement}__{sc.routing}"
        f"__{sc.scale}__m{args.members}_s{args.seed}")


if __name__ == "__main__":
    main()
