"""The port's copies of the jax-free modules have not drifted.

The port keeps its own copies of the DSL, the skeleton translator, the
workloads, the dragonfly, fat-tree and torus builders, the placement
policies, the model configuration and the architecture registry, the
scheduler's traces and queue policies, the host-plane observability
modules (spans, export, metrics, sim-time timelines), the experiment
reports (summaries, the interference summaries, formatting),
``fabric_key``, the §V validation interpreter and hlo2skeleton's DSL
emitter. Built from the same inputs, each must give what the JAX
package's module gives.
"""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import workloads as ref_workloads
from repro.obs import export as ref_export
from repro.obs import metrics as ref_metrics
from repro.obs import spans as ref_spans
from repro.obs import timeline as ref_timeline
from repro.sched import queue as ref_queue
from repro.sched import trace as ref_trace
from repro.netsim.fabric import get_fabric as ref_get_fabric
from repro.netsim.placement import place_jobs as ref_place_jobs
from repro_torch import configs
from repro_torch.core import workloads
from repro_torch.netsim.fabric import get_fabric
from repro_torch.netsim.placement import place_jobs
from repro_torch.obs import export, metrics, spans, timeline
from repro_torch.sched import queue, trace
from repro_torch.union.scenario import Scenario, ScenarioJob, mix_scenario

DRAGONFLIES = [(n, s) for n in ("1d", "2d") for s in ("small", "paper")]
OTHER_FABRICS = [(n, s) for n in ("fat_tree", "torus")
                 for s in ("small", "paper")]
ALL_FABRICS = DRAGONFLIES + OTHER_FABRICS
LINK_TABLES = ("link_kind", "link_bw", "link_dst_router", "link_src_router")
OTHER_ARRAYS = {"fat_tree": LINK_TABLES + ("up1_link", "up2_link",
                                           "down1_link", "down2_link"),
                "torus": LINK_TABLES + ("dim_link",)}
OTHER_SIZES = ("n_routers", "n_nodes", "n_links", "route_width",
               "place_routers", "nodes_per_router", "place_groups",
               "nodes_per_group", "family")
ARRAYS = ("link_kind", "link_bw", "link_dst_router", "link_src_router",
          "local_link_id", "global_gw", "global_link_id")
SIZES = ("n_routers", "n_nodes", "n_links", "links_per_pair", "route_width",
         "place_routers", "nodes_per_router", "place_groups",
         "nodes_per_group")


@pytest.mark.parametrize("name,scale", DRAGONFLIES)
def test_dragonfly_builders_match(name, scale):
    want, got = ref_get_fabric(name, scale), get_fabric(name, scale)
    for a in ARRAYS:
        w, g = getattr(want, a), getattr(got, a)
        assert w.dtype == g.dtype, a
        np.testing.assert_array_equal(g, w, err_msg=a)
    for a in SIZES:
        assert getattr(got, a) == getattr(want, a), a
    assert got.cache_key() == want.cache_key()
    for (ln, lm), (wn, wm) in zip(got.link_levels().items(),
                                  want.link_levels().items()):
        assert ln == wn
        np.testing.assert_array_equal(lm, wm)


@pytest.mark.parametrize("name,scale", OTHER_FABRICS)
def test_fat_tree_torus_builders_match(name, scale):
    want, got = ref_get_fabric(name, scale), get_fabric(name, scale)
    assert type(got).__name__ == type(want).__name__
    for a in OTHER_ARRAYS[name]:
        w, g = getattr(want, a), getattr(got, a)
        assert w.dtype == g.dtype, a
        np.testing.assert_array_equal(g, w, err_msg=a)
    for a in OTHER_SIZES:
        assert getattr(got, a) == getattr(want, a), a
    assert got.cache_key() == want.cache_key()
    assert list(got.link_levels()) == list(want.link_levels())
    for (ln, lm), (wn, wm) in zip(got.link_levels().items(),
                                  want.link_levels().items()):
        np.testing.assert_array_equal(lm, wm, err_msg=ln)
    node = np.arange(got.n_nodes)
    np.testing.assert_array_equal(got.node_router(node),
                                  want.node_router(node))


@pytest.mark.parametrize("scale", ["small", "paper"])
@pytest.mark.parametrize("app", sorted(ref_workloads.SPECS))
def test_workload_skeletons_match(app, scale):
    want = ref_workloads.build_skeleton(app, scale)
    got = workloads.build_skeleton(app, scale)
    assert got.n_ranks == want.n_ranks
    np.testing.assert_array_equal(got.ops, want.ops)
    np.testing.assert_array_equal(got.grid, want.grid)


@pytest.mark.parametrize("policy", ["RN", "RR", "RG"])
@pytest.mark.parametrize("name,scale", [("1d", "small"), ("2d", "paper"),
                                        ("fat_tree", "paper"),
                                        ("torus", "small")])
def test_placements_match(policy, name, scale):
    topo = get_fabric(name, scale)
    ref_topo = ref_get_fabric(name, scale)
    sizes = [64, 64, 128, 32] if scale == "small" else [1024, 512, 2048, 512]
    for seed in (0, 1, 7):
        want = ref_place_jobs(ref_topo, sizes, policy, seed=seed)
        got = place_jobs(topo, sizes, policy, seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fabric", ["fat_tree", "torus"])
def test_fat_tree_torus_specs_accepted_as_reference(fabric):
    """A scenario naming the fabric validates in both packages, with the
    same spec and the same fabric; the registry lists every fabric in the
    reference's order, so validation messages name the same ones."""
    from repro.netsim.fabric import fabric_names as ref_fabric_names
    from repro.union.scenario import Scenario as RefScenario
    from repro.union.scenario import ScenarioJob as RefScenarioJob
    from repro_torch.netsim.fabric import fabric_names

    assert fabric_names() == ref_fabric_names()
    for scale in ("small", "paper"):
        sc = Scenario(name="x", jobs=[ScenarioJob(app="nn")], topo=fabric,
                      scale=scale)
        sc.validate()
        ref = RefScenario.from_dict(sc.to_dict())
        ref.validate()
        assert ref.to_dict() == sc.to_dict()
        assert get_fabric(fabric, scale).cache_key() == \
            ref_get_fabric(fabric, scale).cache_key()
    with pytest.raises(ValueError, match="valid fabrics") as got:
        Scenario(name="x", jobs=[ScenarioJob(app="nn")], topo="3d").validate()
    with pytest.raises(ValueError, match="valid fabrics") as want:
        RefScenario(name="x", jobs=[RefScenarioJob(app="nn")],
                    topo="3d").validate()
    assert str(got.value) == str(want.value)


def test_mix_scenarios_validate():
    for wl in ("workload1", "workload2", "workload3", "baseline-nn"):
        mix_scenario(wl, topo="2d", scale="paper").validate()


DERIVED = ("padded_vocab", "d_qkv", "ssm_d_inner", "ssm_n_heads",
           "n_periods")


@pytest.mark.parametrize("arch", configs.PORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_model_configs_match(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    want = getattr(ref_configs, get)(arch)
    got = getattr(configs, get)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for a in DERIVED:
        assert getattr(got, a) == getattr(want, a), a
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_registry_matches_and_refuses_the_rest():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in ref_configs.ARCH_IDS:
        assert configs.canon(arch.replace("_", "-")) == \
            ref_configs.canon(arch.replace("_", "-"))
        if arch in configs.PORTED:
            continue
        with pytest.raises(ValueError, match="not yet ported"):
            configs.get_config(arch)
    cfg = ref_configs.get_config("jamba_v01_52b")
    assert dataclasses.asdict(configs.smoke_shrink(cfg)) == \
        dataclasses.asdict(ref_configs.smoke_shrink(cfg))


# ---------------------------------------------------------------------------
# the scheduler's traces and queue policies
# ---------------------------------------------------------------------------

def _paper_catalog(mod):
    """Table III applications at their paper rank counts."""
    return [
        mod.CatalogApp(app="cosmoflow", est_runtime_us=130_000.0,
                       weight=0.5, overrides={"iters": 1}),
        mod.CatalogApp(app="nn", est_runtime_us=5_000.0, weight=2.0,
                       overrides={"iters": 2}),
        mod.CatalogApp(app="milc", est_runtime_us=4_000.0, weight=0.5,
                       overrides={"iters": 1}),
    ]


@pytest.mark.parametrize("catalog", ["default", "paper"])
@pytest.mark.parametrize("arrival", ["poisson", "weibull"])
def test_synthetic_traces_match(arrival, catalog):
    for seed in (0, 3, 11):
        kw = dict(arrival=arrival, mean_gap_us=700.0, seed=seed, slots=4)
        if catalog == "paper":
            kw.update(scale="paper")
            want = ref_trace.synthetic_trace(
                9, catalog=_paper_catalog(ref_trace), **kw)
            got = trace.synthetic_trace(9, catalog=_paper_catalog(trace),
                                        **kw)
        else:
            want = ref_trace.synthetic_trace(9, **kw)
            got = trace.synthetic_trace(9, **kw)
        assert got.to_dict() == want.to_dict()
    assert [dataclasses.asdict(c) for c in trace.default_catalog()] == \
        [dataclasses.asdict(c) for c in ref_trace.default_catalog()]


def test_trace_roundtrip_and_fabrics(tmp_path):
    tr = trace.synthetic_trace(6, seed=2, placement="RR")
    p = str(tmp_path / "t.json")
    tr.to_json(p)
    assert trace.load_trace(p) == tr
    assert ref_trace.load_trace(p).to_dict() == tr.to_dict()
    with pytest.raises(ValueError, match="unknown trace keys"):
        trace.Trace.from_dict(dict(tr.to_dict(), slotz=3))
    for fabric in ("fat_tree", "torus"):
        # both packages accept these fabrics, to the same trace
        want = ref_trace.Trace.from_dict(dict(tr.to_dict(), topo=fabric))
        got = trace.Trace.from_dict(dict(tr.to_dict(), topo=fabric))
        assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError, match="unknown topo") as got:
        trace.Trace.from_dict(dict(tr.to_dict(), topo="3d"))
    with pytest.raises(ValueError, match="unknown topo") as want:
        ref_trace.Trace.from_dict(dict(tr.to_dict(), topo="3d"))
    assert str(got.value) == str(want.value)


def _queue_jobs(mod, rng, n):
    return [mod.QueuedJob(jid=i, name=f"j{i}",
                          n_ranks=int(rng.integers(1, 17)),
                          arrival_us=float(round(rng.uniform(0, 5000), 1)),
                          est_runtime_us=float(round(rng.uniform(1, 3000),
                                                     1)))
            for i in range(n)]


@pytest.mark.parametrize("policy", ["fcfs", "easy", "conservative"])
def test_queue_policies_match(policy):
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n, nodes, slots = int(rng.integers(1, 16)), 20, int(
            rng.integers(1, 5))
        want = ref_queue.simulate_queue(
            _queue_jobs(ref_queue, np.random.default_rng(seed), n),
            nodes, slots, policy=policy)
        got = queue.simulate_queue(
            _queue_jobs(queue, np.random.default_rng(seed), n), nodes,
            slots, policy=policy)
        assert got["spans"] == want["spans"]
        assert got["makespan_us"] == want["makespan_us"]
        assert [dataclasses.asdict(r) for r in got["reservations"]] == \
            [dataclasses.asdict(r) for r in want["reservations"]]
        # one decision of PendingQueue.select with jobs running
        rq, q = ref_queue.PendingQueue(policy), queue.PendingQueue(policy)
        for j, k in zip(
                _queue_jobs(ref_queue, np.random.default_rng(seed + 99), n),
                _queue_jobs(queue, np.random.default_rng(seed + 99), n)):
            rq.push(j)
            q.push(k)
        running = [(600.0, 6), (1500.0, 3)]
        ws, wr = rq.select(0.0, 8, slots, running)
        gs, gr = q.select(0.0, 8, slots, running)
        assert [j.jid for j in gs] == [j.jid for j in ws]
        assert (dataclasses.asdict(gr) if gr else None) == \
            (dataclasses.asdict(wr) if wr else None)
        assert [j.jid for j in q.jobs] == [j.jid for j in rq.jobs]


# ---------------------------------------------------------------------------
# host-plane observability: spans, export, metrics, sim-time timelines
# ---------------------------------------------------------------------------

SPAN_EVENTS = [
    dict(name="sched.window", cat="sched", ts_us=1.0, dur_us=40.0,
         cpu_ms=0.03, tid=0, args=dict(window=0)),
    dict(name="engine.get", cat="engine", ts_us=2.0, dur_us=5.0,
         cpu_ms=0.01, tid=0),
    dict(name="sched.window", cat="sched", ts_us=50.0, dur_us=60.0,
         cpu_ms=0.05, tid=1, args=dict(window=1)),
    dict(name="cache", cat="counter", ph="C", ts_us=70.0,
         args=dict(hits=3.0)),
    dict(name="union.run", cat="host", ts_us=0.0, dur_us=200.0,
         cpu_ms=0.2, tid=0),
]


def test_span_tracer_and_exports_match(tmp_path):
    assert spans.summarize(SPAN_EVENTS, top=2) == \
        ref_spans.summarize(SPAN_EVENTS, top=2)
    assert export.chrome_events(SPAN_EVENTS, pid=7) == \
        ref_export.chrome_events(SPAN_EVENTS, pid=7)
    paths = [str(tmp_path / f"{k}.jsonl") for k in ("got", "want")]
    export.write_jsonl(paths[0], SPAN_EVENTS)
    ref_export.write_jsonl(paths[1], SPAN_EVENTS)
    assert open(paths[0]).read() == open(paths[1]).read()
    tracer = spans.get_tracer()
    was = spans.tracing()
    tracer.clear()
    spans.enable()
    try:
        with spans.span("outer", cat="sched", k=1) as h:
            h.set(extra=2)
            spans.counter("depth", queued=3)
    finally:
        if not was:
            spans.disable()
    names = [(e["name"], e.get("cat"), e.get("args")) for e in tracer.events]
    tracer.clear()
    assert ("outer", "sched", dict(k=1, extra=2)) in names
    assert ("depth", "counter", dict(queued=3.0)) in names


def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("cells_done", "cells finished").inc(3, policy="easy")
    reg.counter("cells_done").inc(policy="fcfs")
    reg.gauge("engine_cache_size", "engines held").set(2)
    h = reg.histogram("window_ms", "window wall ms", buckets=(1.0, 10.0))
    for v in (0.5, 3.0, 30.0):
        h.observe(v)
    return reg


def test_metrics_registry_matches():
    assert _registry(metrics).render_openmetrics() == \
        _registry(ref_metrics).render_openmetrics()


def _timeline(mod):
    rec = mod.TimelineRecorder()
    rec.sample_queue(0.0, 1)
    rec.start(0, False)
    rec.sample_queue(100.0, 2)
    rec.start(2, True)
    rec.retire(0, 900.0)
    rec.retire(2, 950.0)

    class R:  # the JobRecord fields the recorder reads
        def __init__(self, jid, slot, start, finish, completed=True):
            self.jid, self.name, self.app, self.n_ranks = \
                jid, f"j{jid}", "pp", 2
            self.arrival_us, self.slot = 10.0 * jid, slot
            self.start_us, self.finish_us = start, finish
            self.completed = completed

    recs = [R(0, 0, 0.0, 880.0), R(1, -1, float("nan"), float("nan"),
                                   False), R(2, 1, 100.0, 940.0)]
    return rec.to_dict(recs, 2)


def test_sim_timelines_match():
    got, want = _timeline(timeline), _timeline(ref_timeline)
    assert got == want
    g = timeline.sim_chrome_trace([("cell", got)])
    w = ref_timeline.sim_chrome_trace([("cell", want)])
    assert g["traceEvents"] == w["traceEvents"]
    assert g["otherData"]["time_domain"] == w["otherData"]["time_domain"]


# ---------------------------------------------------------------------------
# the experiment facade's jax-free pieces: report, fabric_key, the §V
# interpreter and hlo2skeleton
# ---------------------------------------------------------------------------

def _results_dict(seed=0):
    """A seeded schema-v4 Results dict: scenario cells of two grid groups
    (one degraded, one histogrammed), trace cells under two policies."""
    rng = np.random.default_rng(seed)

    def spread():
        a = rng.uniform(1.0, 100.0, 3)
        return dict(mean=float(a.mean()), std=float(a.std()),
                    min=float(a.min()), max=float(a.max()),
                    rel_spread=float((a.max() - a.min()) / a.mean()))

    cells = []
    for failure in ("healthy", "links:0.05"):
        for m in range(3):
            rep = dict(
                virtual_time_ms=float(rng.uniform(1, 50)),
                dropped=int(rng.integers(0, 2)),
                sim_wall_s=float(rng.uniform(0.1, 2)),
                config=dict(all_done=[bool(rng.integers(0, 2)), True]),
                latency={app: dict(count=int(rng.integers(0, 9)),
                                   avg_us=float(rng.uniform(1, 9)),
                                   max_us=float(rng.uniform(9, 20)))
                         for app in ("pp0", "ar8")},
                comm_time={app: dict(avg_ms=float(rng.uniform(0, 1)),
                                     max_ms=float(rng.uniform(1, 2)))
                           for app in ("pp0", "ar8")},
                link_utilization={lvl: dict(mean=float(rng.uniform(0, .5)),
                                            max=float(rng.uniform(.5, 1)))
                                  for lvl in ("local", "global")},
            )
            if failure == "healthy":
                rep["latency_hist"] = dict(apps={app: dict(
                    count=int(rng.integers(1, 9)),
                    p50_us=float(rng.uniform(1, 5)),
                    p99_us=float(rng.uniform(5, 9)),
                    max_us=float(rng.uniform(9, 12)),
                    variation=float(rng.uniform(0, 1)))
                    for app in ("pp0", "ar8")})
            cells.append(dict(kind="scenario", name="tiny", seed=m,
                              placement="RN", routing="ADP", member=m,
                              policy=None, fabric="1d", failure=failure,
                              report=rep))
    for seed in range(2):
        for policy in ("fcfs", "easy"):
            rep = dict(trace="t", policy=policy, slots=2, seed=seed,
                       jobs=4, completed=int(rng.integers(1, 5)),
                       horizon_hit=bool(rng.integers(0, 2)),
                       windows=int(rng.integers(3, 9)),
                       wall_s=float(rng.uniform(0.1, 1)),
                       jobs_per_sec=float(rng.uniform(1, 9)),
                       makespan_ms=float(rng.uniform(1, 9)),
                       utilization=float(rng.uniform(0, 1)),
                       wait_us=spread(), bounded_slowdown=spread(),
                       runtime_ms=spread(), avg_latency_us=spread(),
                       per_job=[])
            cells.append(dict(kind="trace", name="t", seed=seed,
                              placement="RN", routing="ADP", member=0,
                              policy=policy, fabric="1d",
                              failure="healthy", report=rep))
    return dict(schema_version=4, experiment=dict(name="drift"),
                wall_s=3.5, engine_cache=dict(hits=2, misses=1, builds=1),
                summary={}, telemetry=dict(
                    node_kinds=dict(batched=dict(nodes=1, cells=6,
                                                 wall_s=1.5)),
                    spans=dict(top=[["engine.run", 1200.0]],
                               by_name={"engine.run": dict(count=1)})),
                cells=cells)


@pytest.mark.parametrize("seed", [0, 1])
def test_report_summaries_match(seed):
    from repro.union import experiment as ref_experiment
    from repro.union import report as ref_report
    from repro_torch.union import experiment, report

    d = _results_dict(seed)
    got = experiment.Results.from_dict(d)
    want = ref_experiment.Results.from_dict(d)
    sg, sw = report.results_summary(got), ref_report.results_summary(want)
    assert sg == sw
    assert len(sg["scenario_studies"]) == 2 and len(sg["trace_studies"]) == 2
    got.summary, want.summary = sg, sw
    assert report.format_results(got) == ref_report.format_results(want)
    base = {"pp0": sg["scenario_studies"]["tiny/1d/RN/ADP"],
            "ar8": sg["scenario_studies"]["tiny/1d/RN/ADP"]}
    corun = sg["scenario_studies"]["tiny/1d/RN/ADP/links:0.05"]
    assert report.interference_summary(corun, base) == \
        ref_report.interference_summary(corun, base)
    by_policy = {"RN": corun, "RG": base["pp0"]}
    baselines = {"RN": base, "RG": base}
    assert report.interference_matrix(by_policy, baselines) == \
        ref_report.interference_matrix(by_policy, baselines)
    for rep in (c.report for c in got.trace_cells):
        assert report.format_sched_summary(rep) == \
            ref_report.format_sched_summary(rep)


@pytest.mark.parametrize("name,scale", ALL_FABRICS)
def test_fabric_key_matches(name, scale):
    from repro.netsim.fabric import fabric_key as ref_fabric_key
    from repro_torch.netsim.fabric import fabric_key

    assert fabric_key(get_fabric(name, scale)) == \
        ref_fabric_key(ref_get_fabric(name, scale))


@pytest.mark.parametrize("app", sorted(ref_workloads.SPECS))
def test_interp_run_source_matches(app):
    from repro.core import interp as ref_interp
    from repro_torch.core import interp

    src, ranks, ov = workloads.get_source(app, "small")
    got = interp.run_source(src, app, ranks, ov)
    want = ref_interp.run_source(src, app, ranks, dict(ov))
    assert got.as_table() == want.as_table()
    np.testing.assert_array_equal(got.bytes, want.bytes)
    assert got.trace == want.trace


def test_hlo2skeleton_dsl_matches():
    from repro.core import hlo2skeleton as ref_hlo
    from repro_torch.core import hlo2skeleton as hlo

    for flops, grad, steps in ((1e12, 3e8, 4), (2e15, 4e10, 8),
                               (3e9, 1e3, 1)):
        kw = dict(name="m:s", flops_per_device=flops,
                  grad_bytes_per_rank=grad, steps=steps)
        assert hlo.ml_workload_source(**kw) == \
            ref_hlo.ml_workload_source(**kw)
