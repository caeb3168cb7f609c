"""The workload manager: Scenario -> engine inputs -> one simulation.

``resolve`` turns a declarative :class:`~repro_torch.union.scenario.Scenario`
into everything the engine needs (skeletons, topology, placements,
NetConfig, arrival offsets); ``build`` takes the engine for its envelope
from the process-wide cache on a device and binds the scenario's jobs;
``run_scenario`` runs a single member and returns the standard report.

Every entry point runs on CUDA unless the caller passes ``device``
(``"cpu"`` for the CPU); without a card it raises rather than run on the
CPU.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import workloads as W
from repro_torch.core.translator import translate_source
from repro_torch.netsim import metrics as MET
from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.engine import (
    Engine,
    EngineCapacity,
    JobSpec,
    URSpec,
    get_engine,
    job_vm,
)
from repro_torch.netsim.placement import place_jobs
from repro_torch.netsim.state_io import state_to_numpy
from repro_torch.netsim.topology import Fabric, get_topology
from repro_torch.obs.probes import probe_timelines
from repro_torch.obs.spans import span
from repro_torch.union.scenario import Scenario, ScenarioJob, UR_RANKS
from repro_torch.union.seeds import engine_seed

DEFAULT_POOL = {"small": 8192, "paper": 65536}


def build_job_skeleton(job: ScenarioJob, scale: str):
    """One ScenarioJob -> a registered SkeletonProgram.

    Three app sources: an inline DSL ``source``, an hlo2skeleton dry-run
    record (``hlo:<arch>:<shape>[:<mesh>]``), or a `workloads.SPECS` name.
    """
    if job.source is not None:
        return translate_source(
            job.source, f"{job.app}_{job.ranks}", job.ranks, job.overrides
        )
    if job.app.startswith("hlo:"):
        from repro_torch.core.hlo2skeleton import build_ml_skeleton

        parts = job.app.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(f"bad hlo app spec {job.app!r}; want hlo:<arch>:<shape>[:<mesh>]")
        arch, shape = parts[1], parts[2]
        mesh = parts[3] if len(parts) == 4 else "single"
        return build_ml_skeleton(
            arch, shape, mesh=mesh, n_ranks=job.ranks or 256,
            overrides=job.overrides,
        )
    if job.ranks is None:
        return W.build_skeleton(job.app, scale, overrides=job.overrides)
    src, default_ranks, ov = W.get_source(job.app, scale)
    ov.update(job.overrides)
    return translate_source(src, f"{job.app}_{scale}_{job.ranks}", job.ranks, ov)


@dataclass
class ResolvedScenario:
    scenario: Scenario
    topo: Fabric
    jobs: List[JobSpec]  # placement for placement_seed baked in
    ur: Optional[URSpec]
    net: NetConfig
    app_names: List[str]  # jobs + ["ur"] when UR present
    job_sizes: List[int]  # jobs + UR ranks when present (placement order)
    pool_size: int
    horizon_us: float
    placement_seed: int

    def placements(self, seed: int) -> List[np.ndarray]:
        """Per-member placements: same scenario shape, a fresh draw."""
        return place_jobs(self.topo, self.job_sizes, self.scenario.placement, seed=seed)

    @property
    def start_us(self) -> List[float]:
        return [j.start_us for j in self.jobs]

    @property
    def capacity(self) -> EngineCapacity:
        """The (Jmax, Pmax, OPmax) envelope this scenario needs. A scenario
        ``reserve`` widens it."""
        cap = EngineCapacity.of_jobs(self.jobs)
        rv = self.scenario.reserve
        if rv:
            cap = cap.union(EngineCapacity(
                Jmax=rv.get("jobs", 1), Pmax=rv.get("ranks", 1),
                OPmax=rv.get("ops", 1),
            ))
        return cap

    def padded_app_names(self, cap: EngineCapacity) -> List[Optional[str]]:
        """Metric-row names under capacity ``cap``: real jobs first, None
        for padded job rows, 'ur' on the final row when UR is present."""
        names: List[Optional[str]] = [j.name for j in self.jobs]
        names += [None] * (cap.Jmax - len(self.jobs))
        if self.ur is not None:
            names.append("ur")
        return names


def resolve(scenario: Scenario, seed: int = 0) -> ResolvedScenario:
    scenario.validate()
    topo = get_topology(scenario.topo, scenario.scale)
    skels = [build_job_skeleton(j, scenario.scale) for j in scenario.jobs]
    sizes = [s.n_ranks for s in skels]
    ur_decl = scenario.ur
    if ur_decl is not None:
        sizes = sizes + [ur_decl.ranks or UR_RANKS[scenario.scale]]
    placements = place_jobs(topo, sizes, scenario.placement, seed=seed)
    jobs = [
        JobSpec(j.app, skel, placements[i], start_us=j.start_us)
        for i, (j, skel) in enumerate(zip(scenario.jobs, skels))
    ]
    ur = (
        URSpec(
            "ur", placements[-1], size_bytes=ur_decl.size_bytes,
            interval_us=ur_decl.interval_us, start_us=ur_decl.start_us,
        )
        if ur_decl is not None
        else None
    )
    pool_size = scenario.pool_size or DEFAULT_POOL[scenario.scale]
    net = NetConfig(pool_size=pool_size, tick_us=scenario.tick_us)
    return ResolvedScenario(
        scenario=scenario, topo=topo, jobs=jobs, ur=ur, net=net,
        app_names=[j.app for j in scenario.jobs] + (["ur"] if ur else []),
        job_sizes=sizes, pool_size=pool_size,
        horizon_us=scenario.horizon_ms * 1000.0, placement_seed=seed,
    )


def build(rs: ResolvedScenario, device=None, probes=None, hist=None,
          capacity: Optional[EngineCapacity] = None) -> Engine:
    """The engine for a resolved scenario on ``device`` (CUDA by default):
    an :class:`~repro_torch.netsim.engine.Engine` that unpacks as
    ``init, run, tick`` and carries ``run_window``.

    It is the process-wide cache's engine for this scenario's envelope
    (``reserve`` included) and system config
    (:func:`~repro_torch.netsim.engine.get_engine`), bound to this
    scenario's jobs and UR placement (:func:`bind_jobs`). ``capacity``
    widens the envelope beyond this scenario's own needs so the same
    engine serves other (smaller) scenarios (the ensemble's prebuilt
    :class:`~repro_torch.union.ensemble.CampaignEngine`). ``probes`` (a
    :class:`repro_torch.obs.ProbeConfig`) and ``hist`` (a
    :class:`repro_torch.obs.HistConfig`) select the engine with the probe
    rings and the full-fidelity latency histograms compiled into its
    tick, its own cache entry.
    """
    cap = rs.capacity if capacity is None else capacity.union(rs.capacity)
    eng = get_engine(
        rs.topo, routing=rs.scenario.routing, ur=rs.ur, net=rs.net,
        pool_size=rs.pool_size, horizon_us=rs.horizon_us,
        capacity=cap, device=device, probes=probes, hist=hist,
    )
    return bind_jobs(eng, rs)


def bind_jobs(eng: Engine, rs: ResolvedScenario) -> Engine:
    """A cached (job-free) engine whose ``init_state`` defaults to this
    scenario's jobs and UR placement. It shares the cached engine's tables,
    functions, captured graphs and replicas on other devices (its
    ``prun`` runs on the cached engines at this envelope, as the
    reference's wrapper shares one pmap cache entry); its
    ``run``/``run_window``/``prun`` write their ``RunStats`` on it
    (``last_run``, ``last_window``)."""
    default_placements = [np.asarray(j.rank2node) for j in rs.jobs]
    if rs.ur is not None:
        default_placements.append(np.asarray(rs.ur.rank2node))

    def init_state(seed: int = 1, placements=None, start_us=None,
                   jobs_override=None, rank_slowdown_override=None,
                   faults=None):
        if jobs_override is None:
            jobs_override = rs.jobs
            if placements is None:
                placements = default_placements
        return eng.init_state(
            seed=seed, placements=placements, start_us=start_us,
            jobs_override=jobs_override,
            rank_slowdown_override=rank_slowdown_override,
            faults=faults,
        )

    return dataclasses.replace(eng, init_state=init_state, last_run=None,
                               last_window=None)


def member_report(state, rs: ResolvedScenario, wall_s: float = 0.0,
                  seed: int = 0, strict: bool = False,
                  start_us: Optional[Sequence[float]] = None,
                  capacity: Optional[EngineCapacity] = None) -> Dict:
    """The standard report of one member state (on any device).

    ``start_us`` records this member's *actual* arrival schedule when it
    differs from the scenario's (e.g. the experiment's arrival jitter);
    ``capacity`` is the engine envelope the state was simulated under
    (defaults to the scenario's own)."""
    with span("union.member_report", cat="run", seed=seed):
        state = state_to_numpy(state)
        cap = capacity or rs.capacity
        names = rs.padded_app_names(cap)
        rep = MET.run_report(state, names, rs.topo, rs.net, wall_s,
                             strict=strict)
        sc = rs.scenario
        rep["config"] = dict(
            workload=sc.name, topo=sc.topo, placement=sc.placement,
            routing=sc.routing, scale=sc.scale, seed=seed,
            ranks=rs.job_sizes,
            start_us=[float(s) for s in (start_us if start_us is not None
                                         else rs.start_us)],
            all_done=[
                bool(job_vm(state, ji).done.all())
                for ji in range(len(rs.jobs))
            ],
            envelope=dict(Jmax=cap.Jmax, Pmax=cap.Pmax, OPmax=cap.OPmax),
        )
        if state.probes is not None:
            rep["probes"] = probe_timelines(
                state.probes, list(rs.topo.link_levels()), names)
    return rep


def _run_member(scenario: Scenario, seed: int = 0, strict: bool = False,
               device=None) -> Dict:
    """Run a single scenario member on ``device`` (CUDA by default) and
    return its report: the report of the facade's one-member cell
    (``union.run(Experiment(scenarios=[sc], members=1, base_seed=seed,
    vmapped=False))``), bit for bit, plus ``engine_run``.

    ``seed`` drives both the placement draw and the engine RNG
    (``engine_seed(seed)``), as the JAX package's ``run_scenario`` does.
    ``engine_run`` says how the engine ran
    (:class:`~repro_torch.netsim.engine.RunStats`: ticks, liveness reads,
    graph replays and capture times on the card), which a facade cell
    does not carry. ``launch.sim.run_sim`` runs through here.
    """
    rs = resolve(scenario, seed=seed)
    eng = build(rs, device=device)
    state = eng.init_state(seed=engine_seed(seed))
    t0 = time.perf_counter()
    state = eng.run(state)  # returns after a host read of the last state
    wall = time.perf_counter() - t0
    rep = member_report(state, rs, wall, seed=seed, strict=strict)
    rep["engine_run"] = dataclasses.asdict(eng.last_run)
    return rep


def run_scenario(scenario: Scenario, seed: int = 0, strict: bool = False,
                 device=None) -> Dict:
    """Deprecated front door — run a single scenario member.

    Declare ``union.run(Experiment(scenarios=[sc], members=1))`` instead;
    this warns and returns :func:`_run_member`'s report, which equals the
    facade's one-member cell bit for bit (and adds ``engine_run``).
    """
    from repro_torch.union.experiment import deprecated_entry

    deprecated_entry(
        "repro_torch.union.run_scenario",
        "repro_torch.union.run(Experiment(scenarios=[...], members=1))",
    )
    return _run_member(scenario, seed=seed, strict=strict, device=device)
