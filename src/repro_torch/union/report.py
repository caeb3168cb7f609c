"""Campaign aggregation — the paper's interference summary, over ensembles.

The paper's finding (§VI): network interference shows up for *HPC* apps as
**message-latency variation** and for *ML* apps as **communication-time
inflation**. A campaign gives distributions over ensemble members, so both
are reported per app: latency avg/max spread across members, comm-time
spread, and (given a baseline campaign of the app running alone)
co-run-vs-baseline inflation factors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def _spread(xs: List[float]) -> Dict[str, float]:
    a = np.asarray(xs, np.float64)
    mean = float(a.mean()) if a.size else 0.0
    return dict(
        mean=mean,
        std=float(a.std()) if a.size else 0.0,
        min=float(a.min()) if a.size else 0.0,
        max=float(a.max()) if a.size else 0.0,
        # (max-min)/mean — the latency-variation metric of Fig. 7
        rel_spread=float((a.max() - a.min()) / mean) if a.size and mean else 0.0,
    )


def campaign_summary(campaign) -> Dict[str, Any]:
    """Aggregate per-member reports of one CampaignResult."""
    return reports_summary(
        campaign.reports, members=campaign.members, vmapped=campaign.vmapped,
        wall_s=campaign.wall_s, members_per_sec=campaign.members_per_sec,
    )


def reports_summary(reports: List[Dict], members: Optional[int] = None,
                    vmapped: Optional[bool] = None, wall_s: float = 0.0,
                    members_per_sec: Optional[float] = None) -> Dict[str, Any]:
    """Aggregate a list of per-member reports (one ensemble/study group).

    Ragged groups have members with different app sets; each app is
    aggregated over the members that actually ran it.
    """
    if members is None:
        members = len(reports)
    if members_per_sec is None:
        members_per_sec = members / max(wall_s, 1e-9)
    apps: List[str] = []
    for r in reports:
        for app in r["latency"]:
            if app not in apps:
                apps.append(app)
    per_app: Dict[str, Any] = {}
    for app in apps:
        lat = [
            r["latency"][app] for r in reports
            if r["latency"].get(app, {}).get("count")
        ]
        ct = [r["comm_time"].get(app) for r in reports]
        ct = [c for c in ct if c is not None]
        per_app[app] = dict(
            members_with_traffic=len(lat),
            avg_latency_us=_spread([m["avg_us"] for m in lat]),
            max_latency_us=_spread([m["max_us"] for m in lat]),
            max_comm_ms=_spread([c["max_ms"] for c in ct]),
            avg_comm_ms=_spread([c["avg_ms"] for c in ct]),
        )
        # full-fidelity tails, when members ran histogrammed
        # (Experiment.hist > 0): per-member p99 and variation spreads
        hr = [
            r["latency_hist"]["apps"][app] for r in reports
            if r.get("latency_hist", {}).get("apps", {}).get(app, {}).get(
                "count")
        ]
        if hr:
            per_app[app]["hist"] = dict(
                count=int(sum(h["count"] for h in hr)),
                p99_us=_spread([h["p99_us"] for h in hr]),
                variation=_spread([h["variation"] for h in hr]),
            )
    # per-fabric-level link utilization (mean-of-means / max-of-max over
    # members) — which level saturates first differs per fabric
    link_util: Dict[str, Any] = {}
    per_level: Dict[str, List[Dict]] = {}
    for r in reports:
        for lvl, u in r.get("link_utilization", {}).items():
            per_level.setdefault(lvl, []).append(u)
    for lvl, us in per_level.items():
        link_util[lvl] = dict(
            mean=float(np.mean([u["mean"] for u in us])),
            max=float(np.max([u["max"] for u in us])),
        )
    return dict(
        members=members,
        vmapped=vmapped,
        wall_s=wall_s,
        members_per_sec=members_per_sec,
        virtual_time_ms=_spread([r["virtual_time_ms"] for r in reports]),
        dropped_total=int(sum(r["dropped"] for r in reports)),
        all_done=all(all(r["config"]["all_done"]) for r in reports),
        apps=per_app,
        link_utilization=link_util,
    )


def interference_summary(
    corun: Dict[str, Any], baselines: Dict[str, Dict[str, Any]]
) -> Dict[str, Any]:
    """Co-run campaign vs per-app baseline campaigns (the grey boxes of
    Figs. 7/9): latency and comm-time inflation per app.

    ``baselines`` maps app name -> that app's *alone* campaign summary.
    """
    out: Dict[str, Any] = {}
    for app, co in corun["apps"].items():
        base = baselines.get(app)
        if base is None or app not in base.get("apps", {}):
            continue
        b = base["apps"][app]

        def ratio(key, stat="mean"):
            denom = b[key][stat]
            return float(co[key][stat] / denom) if denom else float("nan")

        out[app] = dict(
            # HPC signature: latency variation grows under interference
            latency_inflation=ratio("avg_latency_us"),
            max_latency_inflation=ratio("max_latency_us"),
            latency_variation_corun=co["avg_latency_us"]["rel_spread"],
            latency_variation_baseline=b["avg_latency_us"]["rel_spread"],
            # ML signature: communication time inflates
            comm_time_inflation=ratio("max_comm_ms"),
        )
    return out


def interference_matrix(
    by_policy: Dict[str, Dict[str, Any]],
    baselines_by_policy: Dict[str, Dict[str, Dict[str, Any]]],
) -> Dict[str, Any]:
    """Per-(app, placement-policy) interference matrix — the full Fig. 7/9
    grid: rows are apps, columns placement policies (RN/RR/RG), cells the
    co-run-vs-baseline inflation of :func:`interference_summary`.

    ``by_policy`` maps placement policy -> that policy's co-run campaign
    summary; ``baselines_by_policy`` maps policy -> per-app baseline
    summaries (each app alone under the same placement policy).
    """
    apps: List[str] = []
    cells: Dict[str, Dict[str, Any]] = {}
    for pol, corun in by_policy.items():
        per_app = interference_summary(corun, baselines_by_policy.get(pol, {}))
        for app, d in per_app.items():
            if app not in apps:
                apps.append(app)
            cells.setdefault(app, {})[pol] = d
    return dict(
        apps=apps,
        policies=list(by_policy),
        matrix=cells,
        # the headline grids: latency variation (HPC signature) and
        # comm-time inflation (ML signature), app x policy
        latency_variation={
            app: {pol: d["latency_variation_corun"]
                  for pol, d in cells[app].items()}
            for app in apps
        },
        comm_time_inflation={
            app: {pol: d["comm_time_inflation"]
                  for pol, d in cells[app].items()}
            for app in apps
        },
    )


# ---------------------------------------------------------------------------
# online-scheduler (repro_torch.sched) aggregation
# ---------------------------------------------------------------------------

def sched_summary(result, tau_us: float = 10_000.0) -> Dict[str, Any]:
    """Aggregate one :class:`repro_torch.sched.SchedResult`: per-job wait time,
    bounded slowdown, and system utilization — the scheduler-side metrics
    next to the engine's latency/comm-time interference ones."""
    recs = result.records
    done = [r for r in recs if r.completed]
    per_job = [r.to_dict(tau_us) for r in recs]
    return dict(
        trace=result.trace.name,
        policy=result.policy,
        slots=result.slots,
        seed=result.seed,
        jobs=len(recs),
        completed=len(done),
        horizon_hit=result.horizon_hit,
        windows=result.windows,
        wall_s=result.wall_s,
        jobs_per_sec=result.jobs_per_sec,
        makespan_ms=result.makespan_us / 1000.0,
        utilization=result.utilization,
        wait_us=_spread([r.wait_us for r in done]),
        bounded_slowdown=_spread([r.bounded_slowdown(tau_us) for r in done]),
        runtime_ms=_spread([r.runtime_us / 1000.0 for r in done]),
        avg_latency_us=_spread([r.avg_latency_us for r in done if r.msgs]),
        per_job=per_job,
    )


def format_sched_summary(s: Dict[str, Any]) -> str:
    lines = [
        f"policy={s['policy']} slots={s['slots']} "
        f"jobs={s['completed']}/{s['jobs']} windows={s['windows']} "
        f"wall={s['wall_s']:.1f}s ({s['jobs_per_sec']:.2f} jobs/s)"
        + (" HORIZON-CAPPED" if s["horizon_hit"] else ""),
        f"  makespan {s['makespan_ms']:.1f}ms | utilization "
        f"{s['utilization']:.1%} | wait mean {s['wait_us']['mean']:.0f}us "
        f"max {s['wait_us']['max']:.0f}us | bounded slowdown mean "
        f"{s['bounded_slowdown']['mean']:.2f} max "
        f"{s['bounded_slowdown']['max']:.2f}",
    ]
    # histogrammed trace runs attach per-slot tail summaries
    hist_apps = s.get("latency_hist", {}).get("apps", {})
    for slot, h in hist_apps.items():
        if h.get("count"):
            lines.append(
                f"  {slot}: hist n={h['count']} p50 {h['p50_us']:.1f}us "
                f"p99 {h['p99_us']:.1f}us max {h['max_us']:.1f}us "
                f"variation {h['variation']:.3f}")
    return "\n".join(lines)


def sched_campaign_summary(
    cells_by_policy: Dict[str, List[Dict[str, Any]]]
) -> Dict[str, Any]:
    """Aggregate per-cell :func:`sched_summary` rows per queue policy —
    the trace half of the Results summary pipeline (and the historical
    ``run_sched_campaign`` aggregate)."""
    return {
        pol: dict(
            runs=len(rows),
            completed=int(sum(r["completed"] for r in rows)),
            jobs=int(sum(r["jobs"] for r in rows)),
            mean_wait_us=_spread([r["wait_us"]["mean"] for r in rows]),
            mean_bounded_slowdown=_spread(
                [r["bounded_slowdown"]["mean"] for r in rows]),
            utilization=_spread([r["utilization"] for r in rows]),
            makespan_ms=_spread([r["makespan_ms"] for r in rows]),
        )
        for pol, rows in cells_by_policy.items()
    }


# ---------------------------------------------------------------------------
# the one summary/format pipeline over Experiment Results
# ---------------------------------------------------------------------------

def _scenario_groups(cells) -> Dict[str, List]:
    """Group scenario cells by their study-grid coordinates
    (``name/fabric/placement/routing``, plus a trailing ``/failure``
    segment for non-healthy failures-axis cells — healthy keys keep
    their historical shape)."""
    groups: Dict[str, List] = {}
    for c in cells:
        key = f"{c.name}/{c.fabric}/{c.placement}/{c.routing}"
        if c.failure != "healthy":
            key += f"/{c.failure}"
        groups.setdefault(key, []).append(c)
    return groups


def _trace_label(c) -> str:
    """Trace study group label: the queue policy, qualified by the
    failures-axis coordinate when degraded."""
    return (c.policy if c.failure == "healthy"
            else f"{c.policy}/{c.failure}")


def results_summary(results) -> Dict[str, Any]:
    """One summary over a whole :class:`~repro_torch.union.experiment.Results`:
    every scenario study group aggregated like a campaign, every trace
    study aggregated per queue policy."""
    vmapped = results.experiment.get("vmapped", True)
    scenario_studies = {
        key: reports_summary(
            [c.report for c in group], vmapped=vmapped,
            wall_s=sum(c.report.get("sim_wall_s", 0.0) for c in group))
        for key, group in _scenario_groups(results.scenario_cells).items()
    }
    trace_cells = results.trace_cells
    policies: List[str] = []
    for c in trace_cells:
        if _trace_label(c) not in policies:
            policies.append(_trace_label(c))
    trace_studies = sched_campaign_summary({
        pol: [c.report for c in trace_cells if _trace_label(c) == pol]
        for pol in policies
    }) if trace_cells else {}
    return dict(
        cells=len(results.cells),
        wall_s=results.wall_s,
        engine_cache=dict(results.engine_cache),
        scenario_studies=scenario_studies,
        trace_studies=trace_studies,
    )


def format_results(results) -> str:
    """Render a Results container — the single formatting front door that
    replaces the per-entry-point ``format_summary``/``format_sched_summary``
    split (both remain as the per-group primitives it composes)."""
    s = results.summary or results_summary(results)
    cache = s.get("engine_cache", {})
    gets = cache.get("hits", 0) + cache.get("misses", 0)
    ratio = f" ({cache.get('hits', 0) / gets:.0%} hit)" if gets else ""
    lines = [
        f"experiment: {results.experiment.get('name', '?')} — "
        f"{s['cells']} cells in {s['wall_s']:.1f}s (engine cache: "
        f"{cache.get('hits', 0)} hits, {cache.get('misses', 0)} "
        f"compiles{ratio})"
    ]
    telemetry = getattr(results, "telemetry", None) or {}
    # execution-style accounting: how the planner split the cells and
    # what each style cost (batched scheduler vs per-cell windowed loop)
    node_kinds = telemetry.get("node_kinds") or {}
    if node_kinds:
        lines.append("  node kinds: " + " | ".join(
            f"{kind}: {v['cells']} cells / {v['nodes']} node(s) "
            f"in {v['wall_s']:.1f}s"
            for kind, v in sorted(node_kinds.items())))
    # host-plane telemetry (repro_torch.obs): where this run's wall-clock went
    spans = telemetry.get("spans") or {}
    for i, (name, total_ms) in enumerate(spans.get("top", [])):
        info = spans.get("by_name", {}).get(name, {})
        lines.append(
            f"  wall sink #{i + 1}: {name} — {total_ms:.0f}ms "
            f"across {info.get('count', 0)} span(s)")
    for key, summary in s.get("scenario_studies", {}).items():
        lines.append(f"--- scenario study {key} ---")
        lines.append(format_summary(summary))
    for c in results.trace_cells:
        lines.append(format_sched_summary(c.report))
    trace_agg = s.get("trace_studies", {})
    if trace_agg:
        lines.append("--- trace aggregate (per policy) ---")
        for pol, a in trace_agg.items():
            lines.append(
                f"  {pol:>5}: completed {a['completed']}/{a['jobs']} | "
                f"wait mean {a['mean_wait_us']['mean']:.0f}us | "
                f"BSLD mean {a['mean_bounded_slowdown']['mean']:.2f} | "
                f"util {a['utilization']['mean']:.1%} | makespan "
                f"{a['makespan_ms']['mean']:.1f}ms")
    return "\n".join(lines)


def format_summary(summary: Dict[str, Any]) -> str:
    lines = [
        f"members={summary['members']} vmapped={summary['vmapped']} "
        f"wall={summary['wall_s']:.1f}s "
        f"({summary['members_per_sec']:.2f} members/s) "
        f"all_done={summary['all_done']} dropped={summary['dropped_total']}",
        f"virtual_time_ms: mean={summary['virtual_time_ms']['mean']:.1f} "
        f"spread={summary['virtual_time_ms']['rel_spread']:.2%}",
    ]
    for app, s in summary["apps"].items():
        lines.append(
            f"  {app:>12}: avg latency {s['avg_latency_us']['mean']:9.1f}us "
            f"(±{s['avg_latency_us']['std']:.1f}, "
            f"spread {s['avg_latency_us']['rel_spread']:.1%}) | "
            f"max comm {s['max_comm_ms']['mean']:8.1f}ms "
            f"(±{s['max_comm_ms']['std']:.1f})"
        )
        h = s.get("hist")
        if h:
            lines.append(
                f"  {'':>12}  tail (hist, n={h['count']}): "
                f"p99 {h['p99_us']['mean']:9.1f}us "
                f"(±{h['p99_us']['std']:.1f}) | "
                f"variation {h['variation']['mean']:.3f}"
            )
    return "\n".join(lines)
