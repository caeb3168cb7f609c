"""The rolling-horizon online scheduler: trace -> chained engine windows.

The port of the JAX package's ``repro.sched.scheduler`` over the port's
windowed engine (on the card, each window replays a captured CUDA graph
of the tick).

One compiled ``EngineCapacity(Jmax=slots, Pmax, OPmax)`` envelope serves
the whole trace. The host loop alternates with the engine:

1. pull arrivals whose time has come into the pending queue;
2. retire finished slots (VMs done *and* pool drained — a slot must not
   be recycled while its messages are in flight), freeing their nodes;
3. ask the queue policy (FCFS / EASY backfill) who starts now, place each
   start against the currently occupied node set (``place_jobs`` with the
   ``occupied`` mask), and :func:`~repro_torch.netsim.engine.admit_job` it
   into a free slot;
4. ``run_window(state, t_stop)`` — advance virtual time to the next
   scheduling event (the next arrival, or any slot completing).

Hundreds of jobs stream through ``Jmax`` slots this way; state (clock,
in-flight messages, metrics, RNG) carries over across windows, and a
chained run is bit-identical to a single uninterrupted run of the same
job set (pinned by tests/test_torch_windows.py and
tests/test_torch_sched.py against the JAX package).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from dataclasses import dataclass, field
from operator import attrgetter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.engine import (
    EngineCapacity,
    JobSpec,
    RunStats,
    WindowView,
    admit_job,
    admit_jobs,
    get_engine,
    member_state,
    retire_job,
    retire_jobs,
    stack_members,
    window_host_view,
)
from repro_torch.netsim.faults import set_member_faults, with_faults
from repro_torch.netsim.placement import place_jobs
from repro_torch.netsim.topology import get_topology
from repro_torch.obs import TimelineRecorder, log, span
from repro_torch.sched.queue import PendingQueue, QueuedJob
from repro_torch.sched.trace import Trace, TraceJob
from repro_torch.union import manager as MGR
from repro_torch.union.seeds import engine_seed, place_seed


@dataclass
class JobRecord:
    """One trace job's life: arrival -> start -> finish, plus metrics."""

    jid: int
    name: str
    app: str
    n_ranks: int
    arrival_us: float
    est_runtime_us: float
    slot: int = -1
    start_us: float = float("nan")
    finish_us: float = float("nan")
    completed: bool = False
    msgs: int = 0
    avg_latency_us: float = 0.0
    max_comm_ms: float = 0.0
    nodes: Optional[np.ndarray] = None

    @property
    def wait_us(self) -> float:
        return self.start_us - self.arrival_us

    @property
    def runtime_us(self) -> float:
        return self.finish_us - self.start_us

    def bounded_slowdown(self, tau_us: float = 10_000.0) -> float:
        """max((wait + run) / max(run, tau), 1) — the BSLD metric."""
        if not self.completed:
            return float("nan")
        run = self.runtime_us
        return max((self.wait_us + run) / max(run, tau_us), 1.0)

    def to_dict(self, tau_us: float = 10_000.0) -> Dict[str, Any]:
        return dict(
            name=self.name, app=self.app, n_ranks=self.n_ranks,
            slot=self.slot, arrival_us=self.arrival_us,
            start_us=self.start_us, finish_us=self.finish_us,
            wait_us=self.wait_us, runtime_us=self.runtime_us,
            est_runtime_us=self.est_runtime_us,
            bounded_slowdown=self.bounded_slowdown(tau_us),
            completed=self.completed, msgs=self.msgs,
            avg_latency_us=self.avg_latency_us,
            max_comm_ms=self.max_comm_ms,
        )


@dataclass
class WindowTotals:
    """What the engine's windows of one scheduler run did, summed over its
    ``run_window`` calls (the :class:`~repro_torch.netsim.engine.RunStats`
    of each). ``launches`` are the kernel wrappers' launches (replays times
    the captured graph's launches on the card). ``window_wall_s`` is host
    time around the ``run_window`` calls (state copy-in, replays, flag
    reads, copy-out); ``host_round_s`` host time of the rounds between
    windows (the host view, the queue policy and the slot surgery)."""

    windows: int = 0
    ticks: int = 0
    live_ticks: int = 0
    replays: int = 0
    captures: int = 0
    capture_s: float = 0.0
    replay_device_ms: float = 0.0
    window_wall_s: float = 0.0
    host_round_s: float = 0.0
    launches: Dict[str, int] = field(default_factory=dict)

    def add(self, st: RunStats, wall_s: float) -> None:
        self.windows += 1
        self.ticks += st.ticks
        self.live_ticks += st.live_ticks
        self.replays += st.replays
        if st.captured:
            self.captures += 1
            self.capture_s += st.capture_s + st.instantiate_s
        self.replay_device_ms += st.replay_device_ms
        self.window_wall_s += wall_s
        for k, v in st.graph_launches.items():
            self.launches[k] = self.launches.get(k, 0) + st.replays * v


@dataclass
class SchedResult:
    trace: Trace
    policy: str
    slots: int
    seed: int
    records: List[JobRecord]
    makespan_us: float
    utilization: float  # node-seconds used / (n_nodes * makespan)
    windows: int
    wall_s: float
    horizon_hit: bool
    n_nodes: int
    capacity: EngineCapacity
    final_state: Any = field(default=None, repr=False)
    # sim-time lifecycle timeline (repro_torch.obs.timeline), when recorded
    timeline: Optional[Dict[str, Any]] = None
    # the engine windows' totals (WindowTotals as a dict); a batch's
    # totals are shared by its cells
    engine_windows: Optional[Dict[str, Any]] = None

    @property
    def jobs_per_sec(self) -> float:
        return len(self.records) / max(self.wall_s, 1e-9)


@dataclass
class _Resolved:
    tj: TraceJob
    skeleton: Any
    n_ranks: int
    arrival_us: float  # float32-exact


def _resolve_trace(trace: Trace, slots: int):
    trace.validate()
    topo = get_topology(trace.topo, trace.scale)
    resolved = []
    for tj in trace.jobs:
        sk = MGR.build_job_skeleton(tj.to_scenario_job(), trace.scale)
        if sk.n_ranks > topo.n_nodes:
            raise ValueError(
                f"trace job {tj.name!r} needs {sk.n_ranks} nodes; the "
                f"{trace.topo}/{trace.scale} system has {topo.n_nodes}"
            )
        resolved.append(_Resolved(
            tj=tj, skeleton=sk, n_ranks=sk.n_ranks,
            # the engine clock is float32 — quantize arrivals so window
            # caps and job starts are representable exactly
            arrival_us=float(np.float32(tj.arrival_us)),
        ))
    resolved.sort(key=lambda r: (r.arrival_us, r.tj.name))
    cap = EngineCapacity(
        Jmax=slots,
        Pmax=max(r.n_ranks for r in resolved),
        OPmax=max(r.skeleton.n_ops for r in resolved),
    )
    pool_size = trace.pool_size or MGR.DEFAULT_POOL[trace.scale]
    net = NetConfig(pool_size=pool_size, tick_us=trace.tick_us)
    return topo, resolved, cap, net


def build_sched_engine(
    trace: Trace,
    slots: Optional[int] = None,
    probes=None,
    capacity: Optional[EngineCapacity] = None,
    hist=None,
    device=None,
):
    """The scheduler's engine for a trace: one envelope sized
    ``Jmax=slots`` serves every window. Returns ``(engine, topo,
    resolved_jobs, net)``, reusable across seeds and policies of the same
    trace shape.

    The engine comes from the **process-wide cache** in
    :mod:`repro_torch.netsim.engine` (keyed by capacity envelope, system
    config and ``device``, CUDA by default), so every run at one envelope
    shares one engine and, on the card, its captured window graphs.
    ``probes`` (a :class:`repro_torch.obs.ProbeConfig`) and ``hist`` select
    the observed engine, its own cache entry. ``capacity`` widens the
    envelope beyond this trace's own needs (padded ranks are born done and
    padded ops END, so widening leaves the trajectory as it is)."""
    slots = slots or trace.slots
    topo, resolved, cap, net = _resolve_trace(trace, slots)
    if capacity is not None:
        cap = cap.union(capacity)
    eng = get_engine(
        topo, routing=trace.routing, net=net, pool_size=net.pool_size,
        horizon_us=trace.horizon_ms * 1000.0, capacity=cap, probes=probes,
        hist=hist, device=device,
    )
    return eng, topo, resolved, net


class _CellLoop:
    """Host-side state machine for ONE trace cell (trace × policy × seed).

    :meth:`step` consumes this cell's freshly fetched
    :class:`~repro_torch.netsim.engine.WindowView` and performs exactly one
    scheduling round — arrivals, retires, admissions — mutating the host
    bookkeeping and returning the engine surgery (slots to retire, specs
    to admit) plus the next window's ``t_stop``. Both drivers advance
    cells through this one code path: the sequential
    :func:`_run_trace_impl` steps one cell against a member state, the
    lock-step :func:`run_trace_batch` steps every cell of a batch against
    one shared batched state. One decision path is what keeps the batched
    campaign bit-identical to the sequential one.

    ``timeline`` attaches a :class:`repro_torch.obs.TimelineRecorder` that
    writes down every transition in sim time (queue depth, backfill
    decisions, slot drains) — purely observational, and sim-time only,
    so recorded runs stay bit-identical and batched ≡ sequential.

    ``failure`` (a :class:`repro_torch.netsim.faults.FailureSpec`) attaches a
    fault schedule: :meth:`step` caps ``t_stop`` at the next pending
    fault event so windows land exactly on event times, and the drivers
    apply :meth:`pop_due_faults` to the engine state between windows.
    """

    def __init__(self, trace, policy, slots, seed, topo, resolved, net,
                 timeline=None, failure=None):
        self.trace = trace
        self.policy = policy
        self.slots = slots
        self.seed = seed
        self.topo = topo
        self.net = net
        self.horizon_us = trace.horizon_ms * 1000.0
        self.queue = PendingQueue(policy=policy)
        self.free_slots = list(range(slots))  # ascending == a valid heap
        self.occupied = np.zeros((topo.n_nodes,), bool)
        self.running: Dict[int, JobRecord] = {}
        self.draining: Dict[int, JobRecord] = {}
        self.records: List[JobRecord] = []
        self.tl = timeline  # Optional[TimelineRecorder]
        self.lat0: Dict[int, Tuple[float, int]] = {}  # slot -> (sum, cnt)
        self.arrivals = [
            QueuedJob(jid=i, name=r.tj.name, n_ranks=r.n_ranks,
                      arrival_us=r.arrival_us,
                      est_runtime_us=float(r.tj.est_runtime_us), payload=r)
            for i, r in enumerate(resolved)
        ]
        self.ai = 0
        self.windows = 0
        self.t_now = 0.0
        self.horizon_hit = False
        # entry 0 of the fault timeline is the t=0 mask, applied by the
        # driver at init_state time; the cursor walks the timed events.
        self.fault_tl = (
            failure.timeline(topo, seed) if failure is not None else [])
        self.fault_cur = 1 if self.fault_tl else 0
        self.guard = 20 * len(self.arrivals) + 1000 + len(self.fault_tl)
        self.active = bool(self.arrivals)

    def initial_faults(self):
        """The t=0 fault mask for ``init_state(faults=...)`` (or None)."""
        return self.fault_tl[0][1] if self.fault_tl else None

    def pop_due_faults(self):
        """The latest fault snapshot now due, advancing the cursor past
        every due entry (snapshots are cumulative — only the last one
        matters). None when no event is due."""
        fs = None
        while (self.fault_cur < len(self.fault_tl)
               and self.fault_tl[self.fault_cur][0] <= self.t_now):
            fs = self.fault_tl[self.fault_cur][1]
            self.fault_cur += 1
        return fs

    def step(
        self, view: WindowView
    ) -> Tuple[List[int], List[Tuple[int, JobSpec]], float]:
        """One scheduling round against the post-window host view.

        Returns ``(retires, admits, t_stop)``; flips ``active`` off when
        the cell is finished (horizon hit, or nothing left to run) — a
        deactivated cell runs no further windows.
        """
        self.guard -= 1
        if self.guard < 0:
            raise RuntimeError(
                "scheduler made no progress (windows stopped advancing); "
                "this is a bug — please report the trace"
            )
        retires: List[int] = []
        admits: List[Tuple[int, JobSpec]] = []
        t_now = self.t_now = float(view.t)
        if t_now >= self.horizon_us:
            self.horizon_hit = True
            self.active = False
            return retires, admits, np.inf

        # 1. arrivals whose time has come (plus a fast-forward pull when
        # the system is empty: the engine skips to the job's start)
        arrivals, queue = self.arrivals, self.queue
        while self.ai < len(arrivals) and (
                arrivals[self.ai].arrival_us <= t_now):
            queue.push(arrivals[self.ai])
            self.ai += 1
        if (not queue and not self.running and not self.draining
                and self.ai < len(arrivals)):
            queue.push(arrivals[self.ai])
            self.ai += 1

        # 2. retire finished slots; free nodes immediately, recycle the
        # slot once its messages drained. All per-slot flags and metric
        # deltas come from the single prefetched view — no device reads.
        for slot, rec in list(self.running.items()):
            if view.slot_done[slot]:
                rec.finish_us = min(t_now, self.horizon_us)
                rec.completed = True
                s1 = float(view.lat_sum[slot])
                c1 = int(view.lat_cnt[slot])
                s0, c0 = self.lat0[slot]
                rec.msgs = c1 - c0
                rec.avg_latency_us = (s1 - s0) / max(rec.msgs, 1)
                ct = view.comm_time[slot, : rec.n_ranks]
                rec.max_comm_ms = float(ct.max()) / 1000.0
                self.occupied[rec.nodes] = False
                del self.running[slot]
                self.draining[slot] = rec
        for slot, rec in list(self.draining.items()):
            if not view.in_flight[slot]:
                retires.append(slot)
                heapq.heappush(self.free_slots, slot)
                self.records.append(rec)
                del self.draining[slot]
                if self.tl is not None:
                    self.tl.retire(rec.jid, t_now)

        # 3. admissions: the queue policy decides who starts now
        free_nodes = int(self.topo.n_nodes - self.occupied.sum())
        running_ests = [
            (r.start_us + r.est_runtime_us, r.n_ranks)
            for r in self.running.values()
        ]
        # draining slots hold no nodes but do hold their slot until the
        # last in-flight message lands — model that as an imminent free
        running_ests += [(t_now + self.net.tick_us, 0)
                         for _ in self.draining]
        starts, _resv = queue.select(
            t_now, free_nodes, len(self.free_slots), running_ests)
        # a start is a *backfill* when an earlier-arrived job is still
        # waiting in the queue (jids follow arrival order)
        min_pending = min((j.jid for j in queue.jobs), default=None)
        for qjob in starts:
            r: _Resolved = qjob.payload
            slot = heapq.heappop(self.free_slots)
            nodes = place_jobs(
                self.topo, [qjob.n_ranks], self.trace.placement,
                seed=place_seed(self.seed, qjob.jid),
                occupied=self.occupied,
            )[0]
            self.occupied[nodes] = True
            start = float(np.float32(max(t_now, qjob.arrival_us)))
            rec = JobRecord(
                jid=qjob.jid, name=qjob.name, app=r.tj.app,
                n_ranks=qjob.n_ranks, arrival_us=qjob.arrival_us,
                est_runtime_us=qjob.est_runtime_us, slot=slot,
                start_us=start, nodes=nodes,
            )
            # metrics are untouched by admit/retire surgery, so the
            # window-end view still holds the admission-time baselines
            self.lat0[slot] = (
                float(view.lat_sum[slot]), int(view.lat_cnt[slot]))
            admits.append(
                (slot, JobSpec(qjob.name, r.skeleton, nodes,
                               start_us=start)))
            self.running[slot] = rec
            if self.tl is not None:
                self.tl.start(
                    qjob.jid,
                    min_pending is not None and qjob.jid > min_pending,
                )
        if self.tl is not None:
            self.tl.sample_queue(t_now, len(queue.jobs))

        if (not (self.running or self.draining or queue)
                and self.ai >= len(arrivals)):
            self.active = False
            return retires, admits, np.inf

        # 4. the next window's cap: the next arrival, the next fault
        # event (windows must land exactly on event times), or unbounded
        t_stop = (
            arrivals[self.ai].arrival_us
            if self.ai < len(arrivals) else np.inf
        )
        if self.fault_cur < len(self.fault_tl):
            t_stop = min(t_stop, self.fault_tl[self.fault_cur][0])
        return retires, admits, t_stop

    def finalize(
        self, wall_s: float, capacity: EngineCapacity, final_state=None,
        engine_windows: Optional[WindowTotals] = None,
    ) -> SchedResult:
        """Close the books: horizon-capped leftovers (still-running,
        queued, and arrivals the horizon cut off before they ever reached
        the queue) become incomplete records; one stable jid sort."""
        records = self.records
        for rec in list(self.running.values()) + list(
                self.draining.values()):
            records.append(rec)
        for qjob in self.queue.jobs + self.arrivals[self.ai:]:
            records.append(JobRecord(
                jid=qjob.jid, name=qjob.name, app=qjob.payload.tj.app,
                n_ranks=qjob.n_ranks, arrival_us=qjob.arrival_us,
                est_runtime_us=qjob.est_runtime_us,
            ))
        records.sort(key=attrgetter("jid"))
        assert len(records) == len(self.arrivals)

        done = [r for r in records if r.completed]
        makespan = max((r.finish_us for r in done), default=0.0)
        util = (
            sum(r.n_ranks * r.runtime_us for r in done)
            / max(self.topo.n_nodes * makespan, 1e-9)
        )
        return SchedResult(
            trace=self.trace, policy=self.policy, slots=self.slots,
            seed=self.seed, records=records, makespan_us=makespan,
            utilization=util, windows=self.windows, wall_s=wall_s,
            horizon_hit=self.horizon_hit, n_nodes=self.topo.n_nodes,
            capacity=capacity, final_state=final_state,
            timeline=(
                self.tl.to_dict(records, self.slots)
                if self.tl is not None else None
            ),
            engine_windows=(dataclasses.asdict(engine_windows)
                            if engine_windows is not None else None),
        )


def _run_trace_impl(
    trace: Trace,
    policy: str = "easy",
    slots: Optional[int] = None,
    seed: int = 0,
    engine=None,
    collect_state: bool = False,
    timeline: bool = False,
    failure=None,
    device=None,
) -> SchedResult:
    """Stream a trace through the online scheduler.

    ``seed`` drives placement draws and the engine RNG (routing
    tiebreaks). Pass a prebuilt ``engine`` tuple (from
    :func:`build_sched_engine`) to reuse it, and its captured graphs,
    across policies and seeds; otherwise one is taken from the engine
    cache on ``device`` (CUDA by default). One
    :func:`~repro_torch.netsim.engine.window_host_view` per window feeds
    the whole host round. ``failure`` (a
    :class:`repro_torch.netsim.faults.FailureSpec`) runs the trace on a
    degraded fabric: the t=0 mask seeds the engine state and timed events
    are applied between windows, each window landing on an event time.
    """
    slots = slots or trace.slots
    t0 = time.time()
    if engine is None:
        engine = build_sched_engine(trace, slots, device=device)
    eng, topo, resolved, net = engine

    cell = _CellLoop(
        trace, policy, slots, seed, topo, resolved, net,
        timeline=TimelineRecorder() if timeline else None,
        failure=failure,
    )
    totals = WindowTotals()
    state = eng.init_state(seed=engine_seed(seed),
                           faults=cell.initial_faults())
    while cell.active:
        h0 = time.perf_counter()
        view = window_host_view(state)
        retires, admits, t_stop = cell.step(view)
        for slot in retires:
            state = retire_job(state, slot, checked=False)
        for slot, spec in admits:
            state = admit_job(state, slot, spec, checked=False)
        if not cell.active:
            break
        fs = cell.pop_due_faults()
        if fs is not None:
            state = with_faults(state, fs)
        w0 = time.perf_counter()
        totals.host_round_s += w0 - h0
        with span("sched.window", cat="sched", window=cell.windows,
                  t_now_us=cell.t_now, queued=len(cell.queue.jobs),
                  running=len(cell.running)):
            state = eng.run_window(state, np.float32(t_stop))
        totals.add(eng.last_window, time.perf_counter() - w0)
        cell.windows += 1
        log.debug(
            "sched window %d: t=%.1fus queued=%d running=%d draining=%d",
            cell.windows, cell.t_now, len(cell.queue.jobs),
            len(cell.running), len(cell.draining),
        )
    return cell.finalize(
        time.time() - t0, eng.capacity,
        state if collect_state else None, totals,
    )


def run_trace(
    trace: Trace,
    policy: str = "easy",
    slots: Optional[int] = None,
    seed: int = 0,
    engine=None,
    collect_state: bool = False,
    timeline: bool = False,
    failure=None,
    device=None,
) -> SchedResult:
    """Deprecated front door — stream one trace through the scheduler.

    Shim over the facade's windowed executor: declare a
    :class:`~repro_torch.union.experiment.TraceStudy` in an Experiment and
    call ``union.run`` instead. Kept bit-identical for callers that drive
    the loop directly (``engine=``/``collect_state``); see
    :func:`_run_trace_impl` for the arguments.
    """
    from repro_torch.union.experiment import deprecated_entry

    deprecated_entry(
        "repro_torch.sched.run_trace",
        "repro_torch.union.run(Experiment(trace=TraceStudy(...)))",
    )
    return _run_trace_impl(
        trace, policy=policy, slots=slots, seed=seed, engine=engine,
        collect_state=collect_state, timeline=timeline, failure=failure,
        device=device,
    )


def run_trace_batch(
    specs: Sequence[Tuple],
    slots: Optional[int] = None,
    engine=None,
    collect_state: bool = False,
    probes=None,
    hist=None,
    timeline: bool = False,
    device=None,
) -> List[SchedResult]:
    """Lock-step many trace cells through ONE batched windowed engine.

    ``specs`` is ``[(trace, policy, seed), ...]``, optionally
    ``(trace, policy, seed, failure)`` with a
    :class:`repro_torch.netsim.faults.FailureSpec` per cell (fault masks
    are runtime data, so a mixed healthy and degraded batch shares one
    engine): the cells of a (seed × policy) grid whose traces resolve to
    the same fabric, net config, horizon and slot count (mismatches
    raise). Each round the driver

    1. fetches one :func:`~repro_torch.netsim.engine.window_host_view`
       covering every member,
    2. steps every live cell's host :class:`_CellLoop`, the decision path
       the sequential driver uses,
    3. applies all cells' retires and admissions with one indexed write
       per state leaf (:func:`retire_jobs` / :func:`admit_jobs`),
    4. runs one ``run_window`` with a per-member ``t_stop``: every member
       advances to its own next event, finished members freeze in place.

    Every member's trajectory stays bit-identical to its own sequential
    run. Pass a prebuilt ``engine`` tuple from :func:`build_sched_engine`
    (built with ``capacity=`` the union envelope); with ``engine=None``
    one is taken over the union of the specs' envelopes, on ``device``.
    ``collect_state`` returns each member's final state on its result.
    """
    t0 = time.time()
    # normalize 3-tuples to 4-tuples (failure=None)
    specs = [
        (sp[0], sp[1], sp[2], sp[3] if len(sp) > 3 else None)
        for sp in specs
    ]
    if not specs:
        return []
    resolved_by: Dict[int, Tuple] = {}
    slots_by: Dict[int, int] = {}
    for trace, _, _, _ in specs:
        if id(trace) not in resolved_by:
            n_slots = slots or trace.slots
            resolved_by[id(trace)] = _resolve_trace(trace, n_slots)
            slots_by[id(trace)] = n_slots
    first = specs[0][0]
    if engine is None:
        cap = resolved_by[id(first)][2]
        for trace, _, _, _ in specs:
            cap = cap.union(resolved_by[id(trace)][2])
        engine = build_sched_engine(
            first, slots_by[id(first)], probes=probes, capacity=cap,
            hist=hist, device=device)
    eng, topo, _, net = engine

    # one engine must serve every cell, so anything baked into the
    # engine has to agree across specs
    key0 = (topo.cache_key(), net, slots_by[id(first)],
            first.routing.upper() in ("ADP", "ADAPTIVE"),
            float(first.horizon_ms))
    for trace, _, _, _ in specs:
        topo_i, _, cap_i, net_i = resolved_by[id(trace)]
        key_i = (topo_i.cache_key(), net_i, slots_by[id(trace)],
                 trace.routing.upper() in ("ADP", "ADAPTIVE"),
                 float(trace.horizon_ms))
        if key_i != key0:
            raise ValueError(
                f"trace {trace.name!r} resolves to a different engine "
                "config than the batch's; batch cells must share fabric, "
                "net, slots, routing and horizon"
            )
        if (cap_i.Pmax > eng.capacity.Pmax
                or cap_i.OPmax > eng.capacity.OPmax):
            raise ValueError(
                f"trace {trace.name!r} needs envelope {cap_i}, beyond the "
                f"shared engine's {eng.capacity}"
            )

    cells = [
        _CellLoop(trace, policy, slots_by[id(trace)], seed, topo,
                  resolved_by[id(trace)][1], net,
                  timeline=TimelineRecorder() if timeline else None,
                  failure=fl)
        for trace, policy, seed, fl in specs
    ]
    batched = stack_members([
        eng.init_state(seed=engine_seed(seed), faults=c.initial_faults())
        for (_, _, seed, _), c in zip(specs, cells)
    ])
    B = len(cells)
    totals = WindowTotals()
    rounds = 0
    while True:
        live = [i for i in range(B) if cells[i].active]
        if not live:
            break
        h0 = time.perf_counter()
        view = window_host_view(batched)
        all_retires: List[Tuple[int, int]] = []
        all_admits: List[Tuple[int, int, JobSpec]] = []
        t_stop = np.full((B,), np.inf, np.float32)
        ran: List[_CellLoop] = []
        for i in live:
            retires, admits, ts = cells[i].step(view.member(i))
            all_retires.extend((i, s) for s in retires)
            all_admits.extend((i, s, sp) for s, sp in admits)
            if cells[i].active:
                t_stop[i] = ts
                ran.append(cells[i])
        batched = retire_jobs(batched, all_retires)
        batched = admit_jobs(batched, all_admits)
        for i in live:
            if cells[i].active:
                fs = cells[i].pop_due_faults()
                if fs is not None:
                    batched = set_member_faults(batched, i, fs)
        if not ran:
            break
        w0 = time.perf_counter()
        totals.host_round_s += w0 - h0
        # finished / horizon-hit members are not live and freeze in
        # place; everyone else advances to its own next event
        with span("sched.batch_window", cat="sched", round=rounds,
                  cells=len(ran)):
            batched = eng.run_window(batched, t_stop)
        totals.add(eng.last_window, time.perf_counter() - w0)
        rounds += 1
        for c in ran:
            c.windows += 1
        log.debug(
            "sched batch round %d: %d/%d cells live", rounds, len(ran), B)

    wall = time.time() - t0
    finals = (
        [member_state(batched, i) for i in range(B)]
        if collect_state else [None] * B
    )
    # wall attribution: the rounds are shared work — split evenly so
    # per-cell jobs/sec stays meaningful and sums to the aggregate
    return [
        c.finalize(wall / B, eng.capacity, f, totals)
        for c, f in zip(cells, finals)
    ]
