"""The planner: lower a declarative Experiment into an executable Plan.

The port of the JAX package's ``repro.union.planner``. Planning is pure
resolution — no engine is built and no device is touched here. The
planner

1. expands the study grid (scenarios × grid fabrics × grid placements ×
   grid routing, each with ``members`` seeded ensemble members; trace
   studies into (trace seed × queue policy) cells);
2. resolves every scenario variant to its engine inputs and **buckets**
   member cells by compatible engine configuration (same topology / net /
   routing / UR shape / horizon), unioning capacity envelopes per bucket
   so one engine serves the whole bucket in a single batched call —
   members whose job sets differ are padded with inert no-op jobs;
3. decides the execution style per node: ``batched`` (one stacked engine
   call), ``windowed`` (the slot-recycling online scheduler loop) or
   ``windowed_batch`` (many trace cells lock-stepped through one batched
   windowed engine).

The executor (:func:`repro_torch.union.experiment.run`) then walks the
plan, drawing every engine from the process-wide cache in
:mod:`repro_torch.netsim.engine` — a new execution style is a new node
kind here, not a new public entry point.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.netsim.engine import EngineCapacity
from repro_torch.obs import span
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario


def bucket_key(rs: MGR.ResolvedScenario) -> Tuple:
    """Scenario members sharing this key can share one compiled engine
    (their capacity envelopes are unioned; job tables are runtime data).

    Keys on the whole frozen NetConfig — the same object
    ``engine_cache_key`` keys on — so any future scenario-derived net
    field automatically splits buckets instead of silently sharing one."""
    sc = rs.scenario
    ur = rs.ur
    return (
        sc.topo, sc.scale, sc.routing.upper(), rs.net,
        float(rs.horizon_us),
        None if ur is None else (
            ur.rank2node.shape[0], float(ur.size_bytes),
            float(ur.interval_us), float(ur.start_us),
        ),
    )


@dataclass
class ScenarioCell:
    """One ensemble member of one grid variant: a (scenario, seed) pair
    plus its actual arrival schedule (scenario ``start_us`` + jitter) and
    its failures-axis coordinate (a runtime fault mask — cells differing
    only in ``failure`` share one compiled engine)."""

    scenario: Scenario
    seed: int
    member: int  # member index within its variant's ensemble
    index: int = 0  # study-wide cell ordinal (Results preserve this order)
    rs: MGR.ResolvedScenario = field(repr=False, default=None)
    start_us: np.ndarray = field(repr=False, default=None)
    failure: Any = None  # repro_torch.netsim.faults.FailureSpec (None = healthy)

    @property
    def failure_name(self) -> str:
        return self.failure.name if self.failure is not None else "healthy"


@dataclass
class TraceCell:
    """One online-scheduler run: a trace seed under one queue policy
    (plus the failures-axis coordinate, applied as runtime fault events
    at window boundaries)."""

    seed: int
    policy: str
    index: int = 0  # study-wide cell ordinal (Results preserve this order)
    failure: Any = None  # repro_torch.netsim.faults.FailureSpec (None = healthy)

    @property
    def failure_name(self) -> str:
        return self.failure.name if self.failure is not None else "healthy"


@dataclass
class BatchedNode:
    """One compiled engine, one batched run over ``cells`` members."""

    cells: List[ScenarioCell]
    capacity: EngineCapacity
    host: MGR.ResolvedScenario = field(repr=False, default=None)
    kind: str = "batched"


@dataclass
class WindowedNode:
    """The slot-recycling scheduler loop over (trace seed × policy) cells.

    ``study`` is the experiment's TraceStudy; traces are materialized at
    execution time (synthetic studies redraw arrivals per seed), and every
    cell's engine comes from the shared process-wide cache.
    """

    study: Any  # repro_torch.union.experiment.TraceStudy
    cells: List[TraceCell]
    kind: str = "windowed"


@dataclass
class WindowedBatchNode:
    """One batched windowed engine lock-stepping many trace cells.

    Every cell's trace resolved to the same engine configuration (fabric
    key, net, slots, routing mode, horizon) — the same compatibility rule
    :func:`bucket_key` applies to scenario members — so one compiled
    engine serves the whole (seed × policy) grid: each window round runs
    every live cell to its own next event via a per-member ``t_stop``
    vector. ``capacity`` is the union envelope over the cells' traces;
    ``traces`` maps seed → materialized trace (fixed-stream studies share
    one object across seeds).
    """

    study: Any  # repro_torch.union.experiment.TraceStudy
    cells: List[TraceCell]
    capacity: EngineCapacity
    traces: Dict[int, Any] = field(repr=False, default_factory=dict)
    kind: str = "windowed_batch"


@dataclass
class Plan:
    """The lowered experiment: an ordered list of execution nodes."""

    experiment: Any  # repro_torch.union.experiment.Experiment
    nodes: List[Any]

    @property
    def batched_nodes(self) -> List[BatchedNode]:
        return [n for n in self.nodes if n.kind == "batched"]

    @property
    def windowed_nodes(self) -> List[WindowedNode]:
        return [n for n in self.nodes if n.kind == "windowed"]

    @property
    def windowed_batch_nodes(self) -> List[WindowedBatchNode]:
        return [n for n in self.nodes if n.kind == "windowed_batch"]

    @property
    def total_cells(self) -> int:
        """Study-wide cell count (the executor's progress denominator)."""
        return sum(len(n.cells) for n in self.nodes)

    def describe(self) -> str:
        """Human-readable lowering: nodes, envelopes, engine reuse."""
        lines = [f"plan for experiment {self.experiment.name!r}:"]
        obs_bits = []
        if getattr(self.experiment, "probes", 0):
            obs_bits.append(f"probes={self.experiment.probes}")
        if getattr(self.experiment, "hist", 0):
            obs_bits.append(f"hist={self.experiment.hist} bins")
        if getattr(self.experiment, "timeline", False):
            obs_bits.append("timeline")
        if obs_bits:
            # instrumented engines are distinct cache entries — worth
            # seeing at plan time since it changes what compiles
            lines.append(
                "  observability: " + ", ".join(obs_bits)
                + " (instrumented engine variants compile separately)")
        fails = getattr(self.experiment.grid, "failures", None)
        if fails:
            lines.append(
                "  failures axis: " + ", ".join(f.name for f in fails)
                + " (runtime fault masks — zero extra engine compiles)")
        for i, node in enumerate(self.nodes):
            if node.kind == "batched":
                cap = node.capacity
                names = sorted({c.scenario.name for c in node.cells})
                fabric = node.host.scenario.topo
                lines.append(
                    f"  node {i}: batched × {len(node.cells)} members "
                    f"({'+'.join(names)}) @ fabric {fabric} @ envelope "
                    f"(Jmax={cap.Jmax}, Pmax={cap.Pmax}, OPmax={cap.OPmax})"
                )
            elif node.kind == "windowed_batch":
                cap = node.capacity
                seeds = sorted({c.seed for c in node.cells})
                lines.append(
                    f"  node {i}: batched scheduler × {len(node.cells)} "
                    f"trace cells ({len(seeds)} seeds × policies "
                    f"{sorted({c.policy for c in node.cells})}) @ envelope "
                    f"(Jmax={cap.Jmax}, Pmax={cap.Pmax}, OPmax={cap.OPmax})"
                )
            else:
                lines.append(
                    f"  node {i}: windowed scheduler × {len(node.cells)} "
                    f"cells (seeds × policies "
                    f"{sorted({c.policy for c in node.cells})})"
                )
        return "\n".join(lines)


def _member_seeds(exp, n_variants: int) -> List[List[int]]:
    """Per-variant seed lists from the experiment's seed declaration."""
    m = exp.members
    if exp.seeds is None:
        per = [exp.base_seed + i for i in range(m)]
        return [list(per) for _ in range(n_variants)]
    seeds = list(exp.seeds)
    if len(seeds) == m:
        return [list(seeds) for _ in range(n_variants)]
    if len(seeds) == n_variants * m:
        return [seeds[v * m:(v + 1) * m] for v in range(n_variants)]
    raise ValueError(
        f"experiment.seeds has {len(seeds)} entries; expected members "
        f"({m}) or variants × members ({n_variants * m})"
    )


def plan(exp) -> Plan:
    """Lower an Experiment into a Plan (resolution + bucketing only)."""
    with span("planner.plan", cat="planner") as sp:
        p = _plan(exp)
        sp.set(nodes=len(p.nodes),
               cells=sum(len(n.cells) for n in p.nodes))
    return p


def _plan(exp) -> Plan:
    exp.validate()
    variants: List[Scenario] = []
    for sc in exp.scenarios:
        for fb in (exp.grid.fabrics or [sc.topo]):
            for pl in (exp.grid.placements or [sc.placement]):
                for rt in (exp.grid.routing or [sc.routing]):
                    variants.append(
                        sc if (fb == sc.topo and pl == sc.placement
                               and rt == sc.routing)
                        else replace(sc, topo=fb, placement=pl, routing=rt)
                    )

    seeds = _member_seeds(exp, len(variants))
    # the failures axis reuses each variant's member seeds: a degraded
    # cell and its healthy baseline share seed/placements, so deltas
    # attribute to the failure alone. Fault masks are runtime data — the
    # axis multiplies cells, never engine buckets.
    fails = exp.grid.failures or [None]
    cells: List[ScenarioCell] = []
    for v, sc in enumerate(variants):
        rs = MGR.resolve(sc, seed=seeds[v][0] if seeds[v] else 0)
        base_start = np.asarray(rs.start_us, np.float32)
        for fl in fails:
            for m, seed in enumerate(seeds[v]):
                start = base_start
                if exp.arrival_jitter_us > 0:
                    jit_rng = np.random.default_rng(seed)
                    start = base_start + jit_rng.uniform(
                        0.0, exp.arrival_jitter_us, size=base_start.shape
                    ).astype(np.float32)
                cells.append(ScenarioCell(
                    scenario=sc, seed=seed, member=m, index=len(cells),
                    rs=rs, start_us=start, failure=fl))

    buckets: Dict[Tuple, List[ScenarioCell]] = {}
    for cell in cells:
        buckets.setdefault(bucket_key(cell.rs), []).append(cell)

    nodes: List[Any] = []
    for group in buckets.values():
        cap = group[0].rs.capacity
        for cell in group[1:]:
            cap = cap.union(cell.rs.capacity)
        nodes.append(BatchedNode(cells=group, capacity=cap,
                                 host=group[0].rs))

    if exp.trace is not None:
        nodes.extend(_plan_trace(exp))
    return Plan(experiment=exp, nodes=nodes)


def _plan_trace(exp) -> List[Any]:
    """Lower the experiment's TraceStudy into scheduler nodes.

    Trace cells bucket by engine compatibility exactly like scenario
    members do: cells whose traces resolve to the same (fabric key,
    routing mode, net config, horizon, slots) share one compiled engine
    and become a :class:`WindowedBatchNode` with the union capacity
    envelope; singleton buckets — and studies opting out via
    ``batch=False`` — fall back to the sequential :class:`WindowedNode`.
    Either way the cells carry study-wide ordinals so Results keep the
    (seed-major, policy-minor) order regardless of node grouping.
    """
    study = exp.trace
    tseeds = study.seed_list(exp.base_seed)
    fails = exp.grid.failures or [None]
    cells = [
        TraceCell(seed=s, policy=p, failure=fl, index=i)
        for i, (s, p, fl) in enumerate(
            (s, p, fl) for s in tseeds for p in study.policies
            for fl in fails)
    ]
    if not getattr(study, "batch", True) or len(cells) < 2:
        return [WindowedNode(study=study, cells=cells)]

    # resolution (job-source parsing, topology build) happens here at
    # plan time; the executor resolves again per unique trace — cheap
    # next to simulation, and it keeps the plan a pure description.
    from repro_torch.netsim.fabric import fabric_key
    from repro_torch.sched.scheduler import _resolve_trace

    traces = {s: study.trace_for(s) for s in tseeds}
    resolved: Dict[int, Tuple] = {}
    buckets: Dict[Tuple, List[TraceCell]] = {}
    for cell in cells:
        tr = traces[cell.seed]
        n_slots = study.slots or tr.slots
        if id(tr) not in resolved:
            resolved[id(tr)] = _resolve_trace(tr, n_slots)
        topo, _, _, net = resolved[id(tr)]
        key = (fabric_key(topo),
               tr.routing.upper() in ("ADP", "ADAPTIVE"), net,
               float(tr.horizon_ms), n_slots)
        buckets.setdefault(key, []).append(cell)

    nodes: List[Any] = []
    for group in buckets.values():
        if len(group) < 2:
            nodes.append(WindowedNode(study=study, cells=group))
            continue
        cap = None
        for cell in group:
            cap_i = resolved[id(traces[cell.seed])][2]
            cap = cap_i if cap is None else cap.union(cap_i)
        nodes.append(WindowedBatchNode(
            study=study, cells=group, capacity=cap,
            traces={s: traces[s] for s in {c.seed for c in group}},
        ))
    return nodes
