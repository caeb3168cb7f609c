"""Deprecated campaign front doors — shims over the port's Experiment facade.

The JAX package keeps three historical entry points here
(:func:`run_campaign`, :func:`run_ragged_campaign`,
:func:`run_sched_campaign`); the port keeps them the same way. They lower
onto :func:`repro_torch.union.experiment.run` — one planner, one
process-wide engine cache, one executor — and re-shape the uniform
:class:`~repro_torch.union.experiment.Results` back into their historical
return types, as the JAX package's shims do. Each takes ``device``
(CUDA by default; ``"cpu"`` runs the engine's CPU path). New code should
declare an :class:`~repro_torch.union.experiment.Experiment` instead; see
``docs/experiment.md`` for the migration table.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.netsim.engine import EngineCapacity
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario


@dataclass
class CampaignEngine:
    """An engine reusable across campaigns of one envelope.

    Backed by the process-wide engine cache, so two CampaignEngines at
    one envelope share their tables and captured graphs; kept as the
    return type of :func:`build_campaign_engine` for callers that
    pre-widen capacity envelopes.
    """

    rs: MGR.ResolvedScenario
    init: Callable
    run: Callable
    capacity: EngineCapacity


def build_campaign_engine(
    scenario: Scenario,
    base_seed: int = 0,
    capacity: Optional[EngineCapacity] = None,
    device=None,
) -> CampaignEngine:
    rs = MGR.resolve(scenario, seed=base_seed)
    eng = MGR.build(rs, capacity=capacity, device=device)
    return CampaignEngine(rs=rs, init=eng.init_state, run=eng.run,
                          capacity=eng.capacity)


@dataclass
class CampaignResult:
    scenario: Scenario
    members: int
    base_seed: int
    vmapped: bool  # one batched engine call (vs a Python loop)
    wall_s: float
    reports: List[Dict] = field(default_factory=list)
    summary: Dict = field(default_factory=dict)

    @property
    def members_per_sec(self) -> float:
        return self.members / max(self.wall_s, 1e-9)


def _campaign_result(scenario, res, members, base_seed, vmapped,
                     ragged: bool = False, buckets: int = 0):
    """Re-shape facade Results into the historical CampaignResult."""
    from repro_torch.union.report import campaign_summary

    reports = [c.report for c in res.cells]
    out = CampaignResult(
        scenario=scenario, members=members, base_seed=base_seed,
        vmapped=vmapped,
        wall_s=sum(r.get("sim_wall_s", 0.0) for r in reports),
        reports=reports,
    )
    out.summary = campaign_summary(out)
    if ragged:
        out.summary["ragged"] = dict(
            buckets=buckets,
            envelopes=[r["config"]["envelope"] for r in reports],
        )
    return out


def run_campaign(
    scenario: Scenario,
    members: int = 8,
    base_seed: int = 0,
    vmapped: bool = True,
    strict: bool = False,
    arrival_jitter_us: float = 0.0,
    engine: Optional[CampaignEngine] = None,
    device=None,
) -> CampaignResult:
    """Deprecated front door — run ``members`` ensemble members of one
    scenario (seeds ``base_seed + i``).

    Shim over ``union.run``: equivalent to an Experiment with one
    scenario and ``members`` seeds. ``vmapped=True`` is one batched
    engine call; ``False`` loops members (debug/bench baseline);
    ``arrival_jitter_us`` staggers each member's arrivals by a
    deterministic per-(member, job) offset. A prebuilt ``engine``
    contributes only its (possibly widened) capacity envelope — its
    tables and graphs are already shared through the process-wide engine
    cache.
    """
    import dataclasses

    from repro_torch.union import experiment as EXP

    EXP.deprecated_entry(
        "repro_torch.union.run_campaign",
        "repro_torch.union.run(Experiment(scenarios=[...], members=N))",
    )
    if engine is not None:
        # preserve the historical widened-envelope behavior: run (and
        # report) every member under the prebuilt engine's capacity.
        cap = engine.capacity
        scenario = dataclasses.replace(scenario, reserve=dict(
            jobs=cap.Jmax, ranks=cap.Pmax, ops=cap.OPmax))
    res = EXP.run(EXP.Experiment(
        name=scenario.name, scenarios=[scenario], members=members,
        base_seed=base_seed, vmapped=vmapped, strict=strict,
        arrival_jitter_us=arrival_jitter_us,
    ), device=device)
    return _campaign_result(scenario, res, members, base_seed, vmapped)


def run_ragged_campaign(
    scenarios: Sequence[Scenario],
    seeds: Optional[Sequence[int]] = None,
    base_seed: int = 0,
    vmapped: bool = True,
    strict: bool = False,
    device=None,
) -> CampaignResult:
    """Deprecated front door — one campaign over members with *different*
    job/rank counts (member ``i`` runs ``scenarios[i]`` with
    ``seeds[i]``).

    Shim over ``union.run``: equivalent to an Experiment listing every
    member's scenario with explicit per-member seeds. The planner buckets
    members by compatible engine configuration, compiles **one** engine
    per bucket at the union capacity envelope, and pads smaller members
    with inert no-op jobs (``start_us=inf``, born done) — provably not
    perturbing the real jobs' trajectories.
    """
    from repro_torch.union import experiment as EXP

    EXP.deprecated_entry(
        "repro_torch.union.run_ragged_campaign",
        "repro_torch.union.run(Experiment(scenarios=[...], seeds=[...]))",
    )
    from repro_torch.union import planner as PLN

    scenarios = list(scenarios)
    if seeds is None:
        seeds = [base_seed + i for i in range(len(scenarios))]
    if len(seeds) != len(scenarios):
        raise ValueError("seeds and scenarios must have equal length")
    exp = EXP.Experiment(
        name="+".join(dict.fromkeys(sc.name for sc in scenarios)),
        scenarios=scenarios, members=1, seeds=list(seeds),
        base_seed=base_seed, vmapped=vmapped, strict=strict,
    )
    plan = PLN.plan(exp)
    res = EXP.run(exp, plan=plan, device=device)
    return _campaign_result(
        scenarios[0], res, len(scenarios), base_seed, vmapped,
        ragged=True, buckets=len(plan.batched_nodes),
    )


def run_sched_campaign(
    trace_or_factory,
    policies: Sequence[str] = ("fcfs", "easy"),
    seeds: Sequence[int] = (0,),
    slots: Optional[int] = None,
    tau_us: float = 10_000.0,
    device=None,
) -> Dict[str, Any]:
    """Deprecated front door — online-scheduler campaign: trace seeds ×
    queue policies.

    Shim over ``union.run``: equivalent to an Experiment with a
    TraceStudy. ``trace_or_factory`` is a :class:`repro_torch.sched.Trace`
    (same job stream every seed) or a callable ``seed -> Trace`` (fresh
    arrival draws per seed). One engine per trace envelope is drawn from
    the process-wide cache and shared across the policy comparison, so
    the deltas measure scheduling, not recompilation — and compatible
    (seed × policy) cells lock-step through one batched engine via the
    planner's ``WindowedBatchNode`` (bit-identical to per-cell runs).
    """
    from repro_torch.union import experiment as EXP

    EXP.deprecated_entry(
        "repro_torch.union.run_sched_campaign",
        "repro_torch.union.run(Experiment(trace=TraceStudy(...)))",
    )
    if callable(trace_or_factory):
        study = EXP.TraceStudy(
            factory=trace_or_factory, policies=list(policies),
            seeds=list(seeds), slots=slots, tau_us=tau_us)
        name = "trace-factory"
    else:
        study = EXP.TraceStudy(
            trace=trace_or_factory, policies=list(policies),
            seeds=list(seeds), slots=slots, tau_us=tau_us)
        name = trace_or_factory.name
    res = EXP.run(EXP.Experiment(name=name, trace=study), device=device)
    cells: Dict[str, List[Dict]] = {
        p: [c.report for c in res.trace_cells if c.policy == p]
        for p in policies
    }
    return dict(
        policies=list(policies), seeds=list(seeds), wall_s=res.wall_s,
        summary=res.summary["trace_studies"], runs=cells,
    )
