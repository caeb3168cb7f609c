"""The single front door: declarative Experiments, one ``run``, typed Results.

The port of the JAX package's ``repro.union.experiment`` on the port's
engine. An **Experiment** declares a whole hybrid-workload study in one
spec (JSON-loadable; one spec file loads in both packages): closed-mix
scenario ensembles *and* open-stream traces, crossed with a study grid
of seeds × placements × routing × failures × queue policies. :func:`run`
lowers it through the planner (:mod:`repro_torch.union.planner`) into
engine-bucketed execution nodes, draws every engine from the
process-wide cache in :mod:`repro_torch.netsim.engine` on the run's
device (CUDA unless the caller asks for the CPU; a batched node's
members may spread over every local card, see below), and returns the same
schema-versioned :class:`Results` container as the JAX package, which
:mod:`repro_torch.union.report` renders through one summary/format
pipeline.

Schema (all keys optional unless noted)::

    {
      "name": "study1",
      "scenarios": ["workload1",          # builtin mix / baseline-<app>,
                    "my_mix.json",        # a scenario file,
                    {"name": ..., "jobs": [...]}],   # or inline
      "members": 3,                       # ensemble members per variant
      "base_seed": 0,
      "seeds": [3, 5, 8],                 # explicit member seeds (optional;
                                          # length members, or variants ×
                                          # members consumed flat)
      "grid": {"placements": ["RN", "RG"],# cross every scenario with these
               "routing": ["MIN", "ADP"]},
      "arrival_jitter_us": 0.0,
      "trace": {                          # open-stream study (optional)
        "source": "poisson",              # 'poisson'|'weibull'|trace file
        "jobs": 64, "gap_us": 2000.0,     # synthetic-draw parameters
        "slots": 8, "policies": ["fcfs", "easy"], "seeds": 2
      }
    }

On the card every engine call replays captured CUDA graphs of the tick
(:class:`~repro_torch.netsim.engine.Engine`): plain cells one stacked
``run``, cells with timed fault events ``run_window`` rounds with a
per-member ``t_stop``, trace cells the scheduler's windows. With D
local devices (:func:`repro_torch.device.local_devices`, every visible
card) and D > 1 dividing a vectorised node's plain members, the members
split into D stacked chunks, one a device, run at once on the engine's
replicas (:meth:`~repro_torch.netsim.engine.Engine.prun`, the
reference's ``pmap``); otherwise they run as one stacked batch on the
run's device. Timed-fault cells and trace cells stay on the run's
device.
"""
from __future__ import annotations

import json
import logging
import time
import warnings
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import device as DEV
from repro_torch.device import resolve_device
from repro_torch.netsim.engine import (
    _fetch,
    engine_cache_stats,
    get_engine,
    member_state,
    stack_members,
    state_to,
)
from repro_torch.obs import (
    Progress,
    ProbeConfig,
    get_registry,
    get_tracer,
    log as obs_log,
    span,
    summarize,
    tracing,
)
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario, load_scenario
from repro_torch.union.seeds import engine_seed
from repro_torch.union.validate import (
    SpecError,
    check_keys,
    check_mapping,
    dataclass_from_dict,
    reraise_with_path,
)

# v2: cells carry a `fabric` coordinate, scenario_studies group keys are
# name/fabric/placement/routing, reports include link_utilization
# v3: results carry a `telemetry` block (spans summary + engine-cache
# counters); probed runs add per-cell `report["probes"]` timelines
# v4: telemetry engine-cache stats are per-run deltas (plus absolute
# `size`), not process-cumulative; histogrammed runs add per-cell
# `report["latency_hist"]` (full-fidelity p50/p95/p99/variation) and a
# telemetry `hist` config block; timeline runs add per-trace-cell
# `report["timeline"]` sim-time job lifecycles
SCHEMA_VERSION = 4


def _resolve_spec_path(spec: str, base_dir: Optional[str]) -> str:
    """Resolve a file reference inside an experiment spec relative to the
    spec file's own directory (falling back to the cwd), so saved
    experiments that name sibling scenario/trace files load from
    anywhere. Non-path names (builtin mixes) pass through untouched."""
    import os

    if base_dir and not os.path.isabs(spec):
        cand = os.path.join(base_dir, spec)
        if os.path.exists(cand):
            return cand
        if spec.endswith(".json") and not os.path.exists(spec):
            return cand  # missing either way: error against the spec's dir
    return spec


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclass
class StudyGrid:
    """Factors crossed with every scenario: fabric, placement, routing
    and failure axes.

    ``None`` leaves the scenario's own value; a list replaces it with one
    variant per entry (seeds are the extra axis, via ``members``/``seeds``;
    queue policies are the trace-side axis in :class:`TraceStudy`).
    ``fabrics`` sweeps the network itself — the same job mix lowered onto
    each named fabric ("1d"/"2d" dragonflies, "fat_tree", "torus"), each
    variant on its own compiled engine (the cache keys on fabric
    identity), all in one Results artifact.

    ``failures`` sweeps the network's *health*
    (:mod:`repro_torch.netsim.faults`): each entry is a failure spec —
    ``"healthy"``, a shorthand string (``"links:0.02"``,
    ``"level:global"``, ``"block:0.1"``), or a full
    :class:`~repro_torch.netsim.faults.FailureSpec` dict with timed events.
    The fault mask is runtime data, so the whole axis shares each
    variant's one compiled engine — a failure campaign costs zero extra
    compiles. The axis applies to scenario ensembles *and* trace
    studies.
    """

    placements: Optional[List[str]] = None
    routing: Optional[List[str]] = None
    fabrics: Optional[List[str]] = None
    failures: Optional[List[Any]] = None

    def __post_init__(self):
        if self.failures is not None:
            from repro_torch.netsim.faults import normalize_failures

            self.failures = normalize_failures(self.failures)

    def validate(self) -> None:
        from repro_torch.netsim.fabric import fabric_names

        for p in self.placements or []:
            if p not in ("RN", "RR", "RG"):
                raise ValueError(f"unknown placement {p!r} in grid")
        for r in self.routing or []:
            if r.upper() not in ("MIN", "ADP", "ADAPTIVE"):
                raise ValueError(f"unknown routing {r!r} in grid")
        for f in self.fabrics or []:
            if f not in fabric_names():
                raise ValueError(
                    f"unknown fabric {f!r} in grid; valid fabrics: "
                    f"{sorted(fabric_names())}")
        # failures were normalized (and so parse-validated) in
        # __post_init__; level names are checked against the actual
        # fabric when the pattern resolves at execution time.

    @property
    def is_default(self) -> bool:
        return (self.placements is None and self.routing is None
                and self.fabrics is None and self.failures is None)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in (
            ("placements", self.placements), ("routing", self.routing),
            ("fabrics", self.fabrics)) if v is not None}
        if self.failures is not None:
            d["failures"] = [f.to_dict() for f in self.failures]
        return d


@dataclass
class TraceStudy:
    """The open-stream side of an experiment: a trace × policies × seeds.

    ``source`` is ``'poisson'`` / ``'weibull'`` (synthetic draws — fresh
    arrivals per seed) or a trace-JSON path (fixed job stream; seeds vary
    placement draws and engine RNG). An inline ``trace`` dict or Trace
    object fixes the stream directly; a ``factory`` callable
    (``seed -> Trace``) is the programmatic escape hatch (not
    JSON-serializable).
    """

    source: Optional[str] = None
    jobs: int = 64
    gap_us: float = 2000.0
    slots: Optional[int] = None
    topo: Optional[str] = None  # fabric for synthetic draws (default "1d")
    policies: List[str] = field(default_factory=lambda: ["easy"])
    seeds: Union[int, List[int]] = 1
    tau_us: float = 10_000.0  # bounded-slowdown threshold for summaries
    batch: bool = True  # lock-step compatible cells through one engine
    trace: Optional[Any] = None  # repro_torch.sched.Trace
    factory: Optional[Callable] = field(default=None, repr=False)

    def validate(self) -> None:
        if self.source is None and self.trace is None and self.factory is None:
            raise ValueError(
                "trace study needs a 'source' ('poisson'/'weibull'/file), "
                "an inline 'trace', or a factory"
            )
        if self.factory is not None and not callable(self.factory):
            raise ValueError(
                "trace study 'factory' must be a callable (seed -> Trace); "
                "it is not JSON-expressible — use 'source' or an inline "
                "'trace' in specs"
            )
        if self.source in ("poisson", "weibull") and self.jobs < 1:
            raise ValueError("trace study needs jobs >= 1")
        from repro_torch.netsim.fabric import fabric_names
        from repro_torch.sched.queue import POLICIES

        if self.topo is not None and self.topo not in fabric_names():
            raise ValueError(
                f"unknown topo {self.topo!r}; valid fabrics: "
                f"{sorted(fabric_names())}")
        if self.topo is not None and (
                self.trace is not None or self.factory is not None
                or self.source not in ("poisson", "weibull")):
            raise ValueError(
                "'topo' applies to synthetic sources only "
                "('poisson'/'weibull'); a trace file or inline trace "
                "declares its own topo")
        if not self.policies:
            raise ValueError("trace study needs at least one policy")
        for p in self.policies:
            if p not in POLICIES:
                raise ValueError(
                    f"unknown queue policy {p!r}; expected one of {POLICIES}")
        n = self.seeds if isinstance(self.seeds, int) else len(self.seeds)
        if n < 1:
            raise ValueError("trace study needs at least one seed")

    def seed_list(self, base_seed: int) -> List[int]:
        if isinstance(self.seeds, int):
            return [base_seed + i for i in range(self.seeds)]
        return list(self.seeds)

    def trace_for(self, seed: int):
        """Materialize this study's trace for one seed."""
        from repro_torch.sched.trace import load_trace, synthetic_trace

        if self.factory is not None:
            return self.factory(seed)
        if self.trace is not None:
            return self.trace
        if self.source in ("poisson", "weibull"):
            kw = dict(slots=self.slots) if self.slots else {}
            if self.topo is not None:
                kw["topo"] = self.topo
            return synthetic_trace(
                self.jobs, arrival=self.source, mean_gap_us=self.gap_us,
                seed=seed, **kw)
        return load_trace(self.source)

    @property
    def redraws_per_seed(self) -> bool:
        """Whether each seed gets a fresh job stream (synthetic/factory)."""
        return self.factory is not None or (
            self.trace is None and self.source in ("poisson", "weibull"))

    def to_dict(self) -> Dict[str, Any]:
        d = {
            k: getattr(self, k)
            for k in ("source", "jobs", "gap_us", "slots", "topo",
                      "policies", "seeds", "tau_us")
            if getattr(self, k) is not None
        }
        if not self.batch:
            d["batch"] = False
        if self.factory is not None:
            # a record of what ran, not a reconstructible spec — loading
            # it back raises with the path (factory must be a callable)
            d["factory"] = "<callable>"
        if self.trace is not None:
            d["trace"] = self.trace.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Any, path: str = "trace",
                  base_dir: Optional[str] = None) -> "TraceStudy":
        from repro_torch.sched.trace import Trace

        d = dict(check_mapping(d, path, "trace study"))
        trace = d.pop("trace", None)
        if trace is not None and not isinstance(trace, Trace):
            trace = Trace.from_dict(trace, path=f"{path}.trace")
        check_keys(d, cls.__dataclass_fields__, path, "trace study")
        src = d.get("source")
        if src is not None and src not in ("poisson", "weibull"):
            d["source"] = _resolve_spec_path(src, base_dir)
        try:
            st = cls(trace=trace, **d)
        except TypeError as e:
            raise SpecError(f"{path}: {e}") from e
        reraise_with_path(st.validate, path)
        return st


@dataclass
class Experiment:
    """One declarative spec for a whole study — the facade's only input."""

    name: str
    scenarios: List[Scenario] = field(default_factory=list)
    trace: Optional[TraceStudy] = None
    members: int = 1
    base_seed: int = 0
    seeds: Optional[List[int]] = None
    grid: StudyGrid = field(default_factory=StudyGrid)
    arrival_jitter_us: float = 0.0
    vmapped: bool = True
    strict: bool = False
    # sim-plane probes (repro_torch.obs): probes > 0 runs every cell on the
    # probed engine variant with ring buffers of that many samples,
    # taken every `probe_every` live ticks. 0 (default) = the unprobed
    # engine, bit-identical to the goldens.
    probes: int = 0
    probe_every: int = 8
    # full-fidelity latency histograms (repro_torch.obs.hist): hist > 0 runs
    # every cell on the histogrammed engine variant with that many
    # log-spaced buckets per (app, link-level). 0 (default) = off.
    hist: int = 0
    # sim-time job lifecycle timelines (repro_torch.obs.timeline): trace cells
    # record arrival -> queue -> backfill -> run -> drain transitions
    # into report["timeline"] (exported via the CLI's --timeline).
    timeline: bool = False

    def probe_config(self) -> Optional[ProbeConfig]:
        if not self.probes:
            return None
        return ProbeConfig(samples=self.probes, every=self.probe_every)

    def hist_config(self):
        if not self.hist:
            return None
        from repro_torch.obs import HistConfig

        return HistConfig(bins=self.hist)

    def validate(self) -> None:
        if not self.scenarios and self.trace is None:
            raise ValueError(
                "experiment needs at least one scenario or a trace study")
        if self.members < 1:
            raise ValueError("experiment needs members >= 1")
        if self.arrival_jitter_us < 0:
            raise ValueError("arrival_jitter_us must be >= 0")
        if self.probes < 0:
            raise ValueError("probes must be >= 0 (ring-buffer samples)")
        if self.probe_every < 1:
            raise ValueError("probe_every must be >= 1 (ticks)")
        if self.hist and self.hist < 2:
            raise ValueError("hist must be 0 (off) or >= 2 (buckets)")
        for sc in self.scenarios:
            sc.validate()
        self.grid.validate()
        if self.trace is not None:
            self.trace.validate()

    # ---- (de)serialization -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = dict(name=self.name)
        if self.scenarios:
            d["scenarios"] = [sc.to_dict() for sc in self.scenarios]
        if self.trace is not None:
            d["trace"] = self.trace.to_dict()
        if self.members != 1:
            d["members"] = self.members
        if self.base_seed:
            d["base_seed"] = self.base_seed
        if self.seeds is not None:
            d["seeds"] = list(self.seeds)
        if not self.grid.is_default:
            d["grid"] = self.grid.to_dict()
        if self.arrival_jitter_us:
            d["arrival_jitter_us"] = self.arrival_jitter_us
        if not self.vmapped:
            d["vmapped"] = False
        if self.strict:
            d["strict"] = True
        if self.probes:
            d["probes"] = self.probes
            if self.probe_every != 8:
                d["probe_every"] = self.probe_every
        if self.hist:
            d["hist"] = self.hist
        if self.timeline:
            d["timeline"] = True
        return d

    @classmethod
    def from_dict(cls, d: Any, path: str = "experiment",
                  base_dir: Optional[str] = None) -> "Experiment":
        d = dict(check_mapping(d, path, "experiment"))
        scenarios = []
        for i, s in enumerate(d.pop("scenarios", [])):
            if isinstance(s, Scenario):
                scenarios.append(s)
            elif isinstance(s, str):
                scenarios.append(
                    load_scenario(_resolve_spec_path(s, base_dir)))
            else:
                scenarios.append(
                    Scenario.from_dict(s, path=f"{path}.scenarios[{i}]"))
        trace = d.pop("trace", None)
        if trace is not None and not isinstance(trace, TraceStudy):
            trace = TraceStudy.from_dict(trace, path=f"{path}.trace",
                                         base_dir=base_dir)
        grid = d.pop("grid", None)
        if grid is None:
            grid = StudyGrid()
        elif not isinstance(grid, StudyGrid):
            grid = dataclass_from_dict(
                StudyGrid, grid, f"{path}.grid", "grid")
        check_keys(d, cls.__dataclass_fields__, path, "experiment")
        try:
            exp = cls(scenarios=scenarios, trace=trace, grid=grid, **d)
        except TypeError as e:
            raise SpecError(f"{path}: {e}") from e
        reraise_with_path(exp.validate, path)
        return exp

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def from_json(cls, path: str) -> "Experiment":
        import os

        with open(path) as f:
            return cls.from_dict(json.load(f),
                                 base_dir=os.path.dirname(path))


def load_experiment(spec: str) -> Experiment:
    """An experiment from a JSON file path."""
    return Experiment.from_json(spec)


# ---------------------------------------------------------------------------
# typed results
# ---------------------------------------------------------------------------

@dataclass
class CellResult:
    """One study cell: an ensemble member (scenario cells) or one
    (trace seed × policy) scheduler run (trace cells). ``report`` holds
    the raw per-member metrics dict; :meth:`records` flattens it to tidy
    rows for cross-cell analysis."""

    kind: str  # "scenario" | "trace"
    name: str
    seed: int
    placement: str
    routing: str
    member: int = 0
    policy: Optional[str] = None  # trace cells: queue policy
    fabric: str = "1d"  # the network fabric this cell ran on
    # the failures-axis coordinate (repro_torch.netsim.faults spec name);
    # "healthy" cells keep their historical keys/group keys unchanged.
    failure: str = "healthy"
    report: Dict[str, Any] = field(default_factory=dict)

    @property
    def _fail_seg(self) -> str:
        return "" if self.failure == "healthy" else f"/{self.failure}"

    @property
    def key(self) -> str:
        """Stable human-readable cell key (sim-trace process names,
        grouping): grid coordinates, no report contents."""
        if self.kind == "trace":
            return (f"{self.name}/{self.fabric}/{self.policy}"
                    f"{self._fail_seg}/s{self.seed}")
        return (f"{self.name}/{self.fabric}/{self.placement}"
                f"/{self.routing}{self._fail_seg}/m{self.member}")

    def records(self) -> List[Dict[str, Any]]:
        """Tidy rows: one per app (scenario cells) or one per cell
        (trace cells), with the study-grid coordinates repeated."""
        base = dict(kind=self.kind, name=self.name, seed=self.seed,
                    placement=self.placement, routing=self.routing,
                    member=self.member, policy=self.policy,
                    fabric=self.fabric, failure=self.failure)
        if self.kind == "trace":
            s = self.report
            return [dict(
                base, jobs=s["jobs"], completed=s["completed"],
                makespan_ms=s["makespan_ms"], utilization=s["utilization"],
                mean_wait_us=s["wait_us"]["mean"],
                mean_bounded_slowdown=s["bounded_slowdown"]["mean"],
            )]
        rows = []
        for app, lat in self.report.get("latency", {}).items():
            ct = self.report.get("comm_time", {}).get(app) or {}
            rows.append(dict(
                base, app=app,
                virtual_time_ms=self.report.get("virtual_time_ms"),
                msgs=lat.get("count"), avg_latency_us=lat.get("avg_us"),
                max_latency_us=lat.get("max_us"),
                max_comm_ms=ct.get("max_ms"), avg_comm_ms=ct.get("avg_ms"),
            ))
        return rows

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class Results:
    """The facade's uniform return: every cell of the study, typed, plus
    one summary — serializable to a schema-versioned JSON artifact."""

    experiment: Dict[str, Any]  # the spec, as a plain dict
    cells: List[CellResult]
    wall_s: float = 0.0
    engine_cache: Dict[str, int] = field(default_factory=dict)
    summary: Dict[str, Any] = field(default_factory=dict)
    # v3: host-plane telemetry (repro_torch.obs) — spans summary for this run
    # (empty unless tracing was enabled), engine-cache counters, and the
    # probe configuration that produced any per-cell `report["probes"]`
    # timelines. v4: engine-cache counters are THIS run's deltas (plus
    # the absolute cache `size`), and histogrammed/timelined runs add
    # `hist` / `timeline` blocks.
    telemetry: Dict[str, Any] = field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    @property
    def scenario_cells(self) -> List[CellResult]:
        return [c for c in self.cells if c.kind == "scenario"]

    @property
    def trace_cells(self) -> List[CellResult]:
        return [c for c in self.cells if c.kind == "trace"]

    def records(self) -> List[Dict[str, Any]]:
        """Tidy per-cell rows across the whole study."""
        return [row for c in self.cells for row in c.records()]

    # ---- the JSON artifact -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dict(
            schema_version=self.schema_version,
            experiment=self.experiment,
            wall_s=self.wall_s,
            engine_cache=dict(self.engine_cache),
            summary=self.summary,
            telemetry=self.telemetry,
            cells=[c.to_dict() for c in self.cells],
        )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Results":
        version = d.get("schema_version")
        if version == 3:
            d = _upgrade_v3(d)
        elif version != SCHEMA_VERSION:
            raise ValueError(
                f"results artifact has schema_version={version!r}; this "
                f"build reads version {SCHEMA_VERSION} (and upgrades 3)")
        return cls(
            experiment=d["experiment"],
            cells=[CellResult(**c) for c in d["cells"]],
            wall_s=d.get("wall_s", 0.0),
            engine_cache=d.get("engine_cache", {}),
            summary=d.get("summary", {}),
            telemetry=d.get("telemetry", {}),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=float)

    @classmethod
    def load(cls, path: str) -> "Results":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _upgrade_v3(d: Dict[str, Any]) -> Dict[str, Any]:
    """Upgrade a schema-v3 artifact dict to v4 in place of a reject.

    v3 -> v4 changed telemetry only: ``hist``/``timeline`` blocks were
    added, and ``engine_cache`` counters became per-run deltas. The old
    cumulative counters cannot be re-derived from the artifact, so they
    are kept as-is and the upgrade is recorded in
    ``telemetry["upgraded_from"]`` — old ledgers and store entries stay
    loadable across the bump instead of raising.
    """
    d = dict(d, schema_version=SCHEMA_VERSION)
    tele = dict(d.get("telemetry") or {})
    tele.setdefault("hist", {})
    tele.setdefault("timeline", False)
    tele["upgraded_from"] = 3
    d["telemetry"] = tele
    return d


class RunCancelled(RuntimeError):
    """Raised by :func:`run` when its ``cancel`` callback fired between
    plan nodes. Cells completed before the cancellation point were
    already persisted to the store (when one is attached), so a
    re-submission resumes from them."""

    def __init__(self, done: int, total: int):
        super().__init__(f"run cancelled after {done}/{total} cells")
        self.done = done
        self.total = total


# ---------------------------------------------------------------------------
# the executor: Plan nodes -> cells
# ---------------------------------------------------------------------------

def _engine_totals() -> Dict[str, Any]:
    """What a node kind's engine calls did (``telemetry["engine"]``)."""
    return dict(calls=0, ticks=0, live_ticks=0, replays=0, captures=0,
                capture_s=0.0, replay_device_ms=0.0, launches={})


def _add_run(tot: Dict[str, Any], st) -> None:
    """Add one ``run`` or ``run_window`` call's
    :class:`~repro_torch.netsim.engine.RunStats`: on the card a call's
    kernel launches are its replays times its graph's captured launches.
    A traced call's part times add ``part_device_ms`` and ``part_ticks``,
    and its injection counts ``inject_candidates`` and ``inject_routed``,
    which are absent otherwise."""
    tot["calls"] += 1
    tot["ticks"] += st.ticks
    tot["live_ticks"] += st.live_ticks
    tot["replays"] += st.replays
    tot["captures"] += int(st.captured)
    tot["capture_s"] += st.capture_s + st.instantiate_s
    tot["replay_device_ms"] += st.replay_device_ms
    for k, v in st.graph_launches.items():
        tot["launches"][k] = tot["launches"].get(k, 0) + st.replays * v
    if st.part_ticks:
        parts = tot.setdefault("part_device_ms", {})
        for k, v in st.part_device_ms.items():
            parts[k] = parts.get(k, 0.0) + v
        tot["part_ticks"] = tot.get("part_ticks", 0) + st.part_ticks
        for k in ("inject_candidates", "inject_routed"):
            tot[k] = tot.get(k, 0) + getattr(st, k)


def _add_windows(tot: Dict[str, Any], ew: Dict[str, Any]) -> None:
    """Add a scheduler run's window totals (``SchedResult.engine_windows``)."""
    tot["calls"] += ew["windows"]
    for k in ("ticks", "live_ticks", "replays", "captures", "capture_s",
              "replay_device_ms"):
        tot[k] += ew[k]
    for k, v in ew["launches"].items():
        tot["launches"][k] = tot["launches"].get(k, 0) + v


def _run_faulted(eng, inits, cells, host, tot):
    """Drive timed-failure scenario cells through ``eng.run_window``,
    applying each cell's :class:`~repro_torch.netsim.faults.FaultEvent`\\ s
    at their sim-times. One stacked batch, per-member ``t_stop`` capped at
    each member's own next event — members with no pending event run to
    the horizon while batch-mates pause for mask surgery. One host read a
    round (the clock, the VMs' done flags and the pool's active flags,
    with one wait for the device); on the card each round replays the
    engine's captured window graph."""
    from repro_torch.netsim.faults import set_member_faults

    horizon = float(host.horizon_us)
    tls = [c.failure.timeline(host.topo, c.seed) for c in cells]
    state = stack_members(inits)
    # timeline[0] is the t=0 mask, already applied by init_state.
    cur = [1] * len(cells)
    while True:
        t, done, act = _fetch(state.t, state.vms.done, state.pool.active)
        fin = done.all(axis=(1, 2)) & ~act.any(axis=1)
        live = (t < horizon) & ~fin
        if not live.any():
            break
        t_stop = np.full(len(cells), np.inf, np.float32)
        for i, tl in enumerate(tls):
            if not live[i]:
                continue
            # apply every event now due; the timeline's strictly
            # increasing times guarantee the next stop is > t[i], so
            # every window round makes sim-time progress.
            while cur[i] < len(tl) and tl[cur[i]][0] <= t[i]:
                state = set_member_faults(state, i, tl[cur[i]][1])
                cur[i] += 1
            if cur[i] < len(tl):
                t_stop[i] = tl[cur[i]][0]
        state = eng.run_window(state, t_stop)
        _add_run(tot, eng.last_window)
    return [member_state(state, i) for i in range(len(cells))]


def _exec_batched(node, exp: Experiment, device,
                  tot) -> List[Tuple[int, CellResult]]:
    """One engine from the shared cache, one batched call per node (one
    batch a local device when they divide the members, on the engine's
    replicas), and window rounds for cells with timed fault events;
    ``tot`` sums the engine calls' stats."""
    host = node.host
    stats0 = engine_cache_stats()
    with span("engine.cache_get", cat="engine",
              fabric=host.scenario.topo) as sp:
        eng = get_engine(
            host.topo, routing=host.scenario.routing, ur=host.ur,
            net=host.net, pool_size=host.pool_size,
            horizon_us=host.horizon_us, capacity=node.capacity,
            probes=exp.probe_config(), hist=exp.hist_config(),
            device=device,
        )
        cold = engine_cache_stats()["misses"] > stats0["misses"]
        sp.set(hit=not cold)
    with span("engine.init", cat="engine", cells=len(node.cells)):
        inits = [
            eng.init_state(
                seed=engine_seed(cell.seed),
                placements=cell.rs.placements(cell.seed),
                start_us=cell.start_us,
                jobs_override=cell.rs.jobs,
                faults=(cell.failure.initial_state(host.topo, cell.seed)
                        if cell.failure is not None else None),
            )
            for cell in node.cells
        ]
    n = len(node.cells)
    # cells with timed fault events need the windowed driver (mask
    # surgery at event boundaries); everything else — healthy and
    # static-pattern cells alike — keeps the plain single-call run,
    # which is the bit-identity path the goldens pin.
    timed_ix = [i for i, c in enumerate(node.cells)
                if c.failure is not None and c.failure.has_timed_events]
    plain_ix = [i for i in range(n) if i not in set(timed_ix)]
    t0 = time.perf_counter()
    states: List[Any] = [None] * n
    # cold = this node built its engine, so the run below captures its
    # graphs on the card; warm = the engine already existed in this
    # process (its graphs too, for a batch size it has run).
    with span("engine.run", cat="engine", members=n, cold=cold,
              vmapped=exp.vmapped, timed_faults=len(timed_ix)):
        if plain_ix:
            p_inits = [inits[i] for i in plain_ix]
            np_ = len(p_inits)
            devs = DEV.local_devices(device)
            D = len(devs)
            if exp.vmapped and D > 1 and np_ % D == 0:
                # members split across the devices: each runs an
                # (n/D)-batch on the engine's replica there
                chunk = np_ // D
                batches = []
                for d, dev in enumerate(devs):
                    with span("engine.stack", cat="engine", members=chunk,
                              device=str(dev)):
                        batches.append(state_to(stack_members(
                            p_inits[d * chunk:(d + 1) * chunk]), dev))
                finals = eng.prun(batches)
                _add_run(tot, eng.last_run)
                with span("engine.unstack", cat="engine", members=np_):
                    p_states = [member_state(finals[i // chunk], i % chunk)
                                for i in range(np_)]
            elif exp.vmapped:
                # every plain member in one stacked batch on the device
                with span("engine.stack", cat="engine", members=np_,
                          device=str(eng.device)):
                    batch = stack_members(p_inits)
                final = eng.run(batch)
                _add_run(tot, eng.last_run)
                with span("engine.unstack", cat="engine", members=np_):
                    p_states = [member_state(final, i) for i in range(np_)]
            else:
                p_states = []
                for s in p_inits:
                    p_states.append(eng.run(s))
                    _add_run(tot, eng.last_run)
            for i, st in zip(plain_ix, p_states):
                states[i] = st
        if timed_ix:
            f_states = _run_faulted(
                eng, [inits[i] for i in timed_ix],
                [node.cells[i] for i in timed_ix], host, tot)
            for i, st in zip(timed_ix, f_states):
                states[i] = st
    wall = time.perf_counter() - t0

    out = []
    for cell, st in zip(node.cells, states):
        rep = MGR.member_report(
            st, cell.rs, wall / n, seed=cell.seed, strict=exp.strict,
            start_us=cell.start_us, capacity=node.capacity,
        )
        out.append((cell.index, CellResult(
            kind="scenario", name=cell.scenario.name, seed=cell.seed,
            placement=cell.scenario.placement,
            routing=cell.scenario.routing, member=cell.member,
            fabric=cell.scenario.topo, failure=cell.failure_name,
            report=rep,
        )))
    return out


def _trace_cell_result(cell, trace, res, study, probes, topo,
                       hist=None) -> CellResult:
    """Wrap one SchedResult as a CellResult (shared by both trace paths)."""
    from repro_torch.union.report import sched_summary

    rep = sched_summary(res, tau_us=study.tau_us)
    if probes is not None and res.final_state is not None:
        from repro_torch.obs import probe_timelines

        # trace cells recycle job slots, so probe app-axis rows are
        # *slots*, not jobs — label them as such.
        rep["probes"] = probe_timelines(
            res.final_state.probes, list(topo.link_levels()),
            [f"slot{j}" for j in range(res.slots)],
        )
    if hist is not None and res.final_state is not None:
        from repro_torch.obs import hist_summary

        # same slot-axis labeling: histogram app rows are engine slots
        rep["latency_hist"] = hist_summary(
            res.final_state.hist,
            [f"slot{j}" for j in range(res.slots)],
            list(topo.link_levels()),
        )
    if res.timeline is not None:
        rep["timeline"] = res.timeline
    return CellResult(
        kind="trace", name=trace.name, seed=cell.seed,
        placement=trace.placement, routing=trace.routing,
        policy=cell.policy, fabric=trace.topo,
        failure=cell.failure_name, report=rep,
    )


def _exec_windowed(node, exp: Experiment, device,
                   tot) -> List[Tuple[int, CellResult]]:
    """The slot-recycling scheduler loop per (trace seed × policy) cell;
    engines come from the shared process-wide cache."""
    from repro_torch.sched.scheduler import _run_trace_impl, build_sched_engine

    study = node.study
    probes = exp.probe_config()
    hist = exp.hist_config()
    out = []
    engine = None
    trace = None
    last_seed = None
    for cell in node.cells:
        if trace is None or (study.redraws_per_seed and cell.seed != last_seed):
            trace = study.trace_for(cell.seed)
            with span("engine.cache_get", cat="engine", trace=trace.name):
                engine = build_sched_engine(trace, study.slots,
                                            probes=probes, hist=hist,
                                            device=device)
            last_seed = cell.seed
        with span("sched.trace", cat="sched", trace=trace.name,
                  policy=cell.policy, seed=cell.seed) as sp:
            res = _run_trace_impl(
                trace, policy=cell.policy, slots=study.slots,
                seed=cell.seed, engine=engine,
                collect_state=probes is not None or hist is not None,
                timeline=exp.timeline, failure=cell.failure,
            )
            sp.set(windows=res.windows, jobs=len(res.records))
        _add_windows(tot, res.engine_windows)
        out.append((cell.index, _trace_cell_result(
            cell, trace, res, study, probes, engine[1], hist=hist)))
    return out


def _exec_windowed_batch(node, exp: Experiment, device,
                         tot) -> List[Tuple[int, CellResult]]:
    """Lock-step every (seed × policy) cell of the node through ONE
    batched windowed engine — one host read and one window call per
    round, per-member ``t_stop`` advancing each cell to its own next
    event. Bit-identical to :func:`_exec_windowed` cell by cell."""
    from repro_torch.sched.scheduler import build_sched_engine, run_trace_batch

    study = node.study
    probes = exp.probe_config()
    hist = exp.hist_config()
    first = node.traces[node.cells[0].seed]
    with span("engine.cache_get", cat="engine", trace=first.name):
        engine = build_sched_engine(
            first, study.slots, probes=probes, capacity=node.capacity,
            hist=hist, device=device)
    specs = [(node.traces[c.seed], c.policy, c.seed, c.failure)
             for c in node.cells]
    with span("sched.trace_batch", cat="sched", cells=len(specs)) as sp:
        results = run_trace_batch(
            specs, slots=study.slots, engine=engine,
            collect_state=probes is not None or hist is not None,
            timeline=exp.timeline,
        )
        sp.set(windows=max(r.windows for r in results),
               jobs=sum(len(r.records) for r in results))
    _add_windows(tot, results[0].engine_windows)  # shared by the cells
    return [
        (cell.index, _trace_cell_result(
            cell, node.traces[cell.seed], res, study, probes, engine[1],
            hist=hist))
        for cell, res in zip(node.cells, results)
    ]


_EXECUTORS = {
    "batched": _exec_batched,
    "windowed": _exec_windowed,
    "windowed_batch": _exec_windowed_batch,
}


def _node_fingerprints(node, exp, device) -> Dict[int, str]:
    """Per-cell content fingerprints for one plan node (index -> hash)."""
    from repro_torch.union import store as STO

    if node.kind == "batched":
        return {c.index: STO.scenario_fingerprint(exp, c, device)
                for c in node.cells}
    study = node.study
    if node.kind == "windowed_batch":
        traces = node.traces
    else:
        # materialize once per seed for hashing; the executor re-derives
        # the same trace deterministically (synthetic draws are seeded)
        traces = {}
        for c in node.cells:
            if c.seed not in traces:
                traces[c.seed] = study.trace_for(c.seed)
    return {
        c.index: STO.trace_fingerprint(exp, study, traces[c.seed], c, device)
        for c in node.cells
    }


def _consult_store(store, node, exp, device):
    """Split one plan node against the store: ``(exec_node, hits, fps)``
    where ``exec_node`` carries only the miss cells (the node itself is
    never mutated — plans are reusable), ``hits`` is the recovered
    ``(index, CellResult)`` list, and ``fps`` maps every cell index to
    its fingerprint (for persisting the misses afterwards)."""
    from dataclasses import replace as dc_replace

    fps = _node_fingerprints(node, exp, device)
    hits: List[Tuple[int, CellResult]] = []
    miss_cells = []
    for cell in node.cells:
        cached = store.get(fps[cell.index])
        if cached is not None:
            hits.append((cell.index, cached))
        else:
            miss_cells.append(cell)
    if len(miss_cells) == len(node.cells):
        return node, hits, fps
    return dc_replace(node, cells=miss_cells), hits, fps


def run(experiment, plan=None, store=None, cancel=None,
        device=None) -> Results:
    """The facade: lower ``experiment`` through the planner and execute it
    on ``device`` (CUDA by default; ``"cpu"`` runs the engine's CPU path;
    without a card a call that does not ask for the CPU raises).

    Accepts an :class:`Experiment` (or a prebuilt
    :class:`~repro_torch.union.planner.Plan` via ``plan``) and returns
    :class:`Results`. Every engine is drawn from the process-wide cache,
    so repeated studies — and mixed scenario+trace studies sharing an
    envelope — build each engine, and capture its graphs, once per
    process.

    ``store`` (an :class:`~repro_torch.union.store.ExperimentStore` or a
    directory path) deduplicates across *processes and time*: each cell
    is keyed by a content fingerprint of its resolved spec, the port's
    versions and the device type, and cells already in the store are
    returned verbatim with zero simulation — re-submitting an identical
    experiment executes nothing, a one-cell change executes one cell.
    ``cancel`` is a zero-arg callable polled between plan nodes; when it
    returns true the run raises :class:`RunCancelled` (cells finished so
    far are already persisted to the store).
    """
    from repro_torch.union import planner as PLN
    from repro_torch.union.report import results_summary

    dev = resolve_device(device)
    if isinstance(store, str):
        from repro_torch.union.store import ExperimentStore

        store = ExperimentStore(store)
    ev0 = get_tracer().n_events
    with span("union.run", cat="run",
              experiment=getattr(experiment, "name", None)):
        if plan is None:
            plan = PLN.plan(experiment)
        stats0 = engine_cache_stats()
        t0 = time.time()
        # cells come back bucket-grouped; restore study order via the
        # planner's cell ordinals (scenario and trace ordinals are
        # separate spaces: scenario cells first, then trace cells).
        indexed: List = []
        trace_indexed: List = []
        node_kinds: Dict[str, Dict[str, float]] = {}
        engine_kinds: Dict[str, Dict[str, Any]] = {}
        store_hits = 0
        store_misses = 0
        reg = get_registry()
        node_wall = reg.histogram(
            "union_node_wall_seconds",
            "wall time per executed plan node")
        progress = Progress(
            plan.total_cells,
            enabled=obs_log.isEnabledFor(logging.INFO))
        for node in plan.nodes:
            done = len(indexed) + len(trace_indexed)
            if cancel is not None and cancel():
                raise RunCancelled(done, plan.total_cells)
            if node.kind not in _EXECUTORS:
                raise ValueError(f"unknown plan node kind {node.kind!r}")
            out = indexed if node.kind == "batched" else trace_indexed
            exec_node = node
            fps: Dict[int, str] = {}
            if store is not None:
                with span("store.consult", cat="store",
                          cells=len(node.cells)) as sp:
                    exec_node, hits, fps = _consult_store(
                        store, node, plan.experiment, dev)
                    sp.set(hits=len(hits))
                store_hits += len(hits)
                out.extend(hits)
                progress.advance(len(hits))
            nt0 = time.time()
            produced: List[Tuple[int, CellResult]] = []
            if exec_node.cells:
                produced = _EXECUTORS[node.kind](
                    exec_node, plan.experiment, dev,
                    engine_kinds.setdefault(node.kind, _engine_totals()))
                out.extend(produced)
            if store is not None and produced:
                store_misses += len(produced)
                with span("store.put", cat="store", cells=len(produced)):
                    for idx, cell in produced:
                        store.put(fps[idx], cell)
            agg = node_kinds.setdefault(
                node.kind, dict(nodes=0, cells=0, wall_s=0.0))
            agg["nodes"] += 1
            agg["cells"] += len(node.cells)
            agg["wall_s"] += time.time() - nt0
            node_wall.observe(time.time() - nt0)
            progress.advance(len(produced))
        progress.close()
        cells = (
            [c for _, c in sorted(indexed, key=lambda p: p[0])]
            + [c for _, c in sorted(trace_indexed, key=lambda p: p[0])]
        )
        stats1 = engine_cache_stats()
        res = Results(
            experiment=plan.experiment.to_dict(),
            cells=cells,
            wall_s=time.time() - t0,
            engine_cache=dict(
                hits=stats1["hits"] - stats0["hits"],
                misses=stats1["misses"] - stats0["misses"],
                builds=stats1["builds"] - stats0["builds"],
            ),
        )
        with span("union.summarize", cat="run"):
            res.summary = results_summary(res)

            # process-plane metrics: this run's contribution to the
            # registry
            reg.counter("union_experiments",
                        "experiment facade runs").inc()
            reg.counter("union_cells_completed",
                        "experiment cells executed").inc(len(cells))
            reg.counter("union_engine_cache_hits",
                        "engine-cache hits").inc(res.engine_cache["hits"])
            reg.counter("union_engine_cache_builds",
                        "engine builds").inc(res.engine_cache["builds"])
            if store is not None:
                reg.counter("union_store_hits",
                            "cells recovered from the experiment store"
                            ).inc(store_hits)
                reg.counter("union_store_misses",
                            "cells simulated and persisted to the store"
                            ).inc(store_misses)
            trace_cells = [c for c in cells if "windows" in c.report]
            reg.counter("union_window_rounds",
                        "scheduler window rounds executed").inc(
                sum(int(c.report.get("windows", 0)) for c in trace_cells))
            reg.gauge("union_last_run_wall_seconds",
                      "wall time of the most recent run()").set(res.wall_s)
            t_wall = sum(float(c.report.get("wall_s", 0.0))
                         for c in trace_cells)
            if t_wall > 0:
                reg.gauge("union_trace_jobs_per_sec",
                          "rolling trace throughput of the last run").set(
                    sum(int(c.report.get("jobs", 0)) for c in trace_cells)
                    / t_wall)
    res.telemetry = dict(
        # this run's spans only (the tracer is process-wide)
        spans=(summarize(get_tracer().events[ev0:]) if tracing() else {}),
        # v4: THIS run's cache traffic (deltas), plus the absolute cache
        # size — process-cumulative counters made run artifacts depend on
        # what ran before them in the same process.
        engine_cache=dict(res.engine_cache, size=stats1["size"]),
        # wall time per execution style — makes batching wins visible in
        # every artifact, not just the benchmarks
        node_kinds={
            k: dict(nodes=v["nodes"], cells=v["cells"],
                    wall_s=round(v["wall_s"], 4))
            for k, v in node_kinds.items()
        },
        probes=(
            dict(samples=plan.experiment.probes,
                 every=plan.experiment.probe_every)
            if plan.experiment.probes else {}
        ),
        hist=(
            asdict(plan.experiment.hist_config())
            if plan.experiment.hist else {}
        ),
        timeline=bool(plan.experiment.timeline),
        # the port's engine calls per node kind (RunStats summed: ticks,
        # graph replays and captures, replay device ms by CUDA events,
        # kernel launches); the JAX package's telemetry has no such block
        engine=engine_kinds,
        # content-hash store traffic for THIS run: hits came back with
        # zero simulation, misses were simulated then persisted
        store=(
            dict(hits=store_hits, misses=store_misses, dir=store.root)
            if store is not None else {}
        ),
    )
    return res


def deprecated_entry(old: str, new: str) -> None:
    """Warn once per call site that an old front door is a shim now."""
    warnings.warn(
        f"{old} is deprecated; use {new} (see docs/experiment.md for the "
        "migration table)",
        DeprecationWarning, stacklevel=3,
    )
