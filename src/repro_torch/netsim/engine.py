"""Tensor-timestepped co-simulation engine (the CODES/ROSS adaptation).

The PyTorch counterpart of the JAX package's ``netsim/engine.py``. One
``tick`` advances Δt of virtual time:
  1. **Rank VMs** (stacked over jobs, vectorized over ranks): ranks
     entering an (op, round) emit messages and bump their cumulative
     send/recv thresholds; collectives are expanded algorithmically
     (ring / recursive-doubling / binomial).
  2. **Injection**: emitted messages get pool slots (stack allocator),
     routes (MIN or adaptive, live link demand) and latency floors
     (:mod:`repro_torch.kernels.inject`: on the card a dragonfly's is a
     CUDA kernel that routes only the messages given a slot).
  3. **Network**: fluid fair-share wormhole model — the fused drain tick
     (:mod:`repro_torch.kernels.ops`, a CUDA kernel on the card).
  4. **Bookkeeping**: deliveries unblock VMs; latency histograms, per-app
     router-window counters, link loads; the PDES time skip.

**Stacked layout**: all jobs' VM state lives in ``(J, Pmax)`` padded
tensors and the job programs are runtime data — a :class:`JobTable` of
``(J, OPmax, 4)`` op/grid tables — carried inside :class:`SimState`.

**Explicit member batch**: every state leaf has a leading member
dimension ``B``. ``run``/``tick`` accept a single member state
(promoted to ``B=1``) or a stacked batch; scatters fold the member index
into one flat index.

**How it matches the JAX engine bit for bit** (the contract of
``tests/test_engine_equivalence.py``):

* uint32 arithmetic (the rng counter and its hash) runs in int64 masked
  with ``0xFFFFFFFF``; the rng leaf is an int64 tensor holding the
  uint32 value.
* JAX's ``mode="drop"`` scatters scatter into one extra dummy element
  that is sliced off; ``.at[].min/max`` is ``scatter_reduce_``.
* The link-demand estimate that UGAL compares is summed serially in flat
  index order on every device (:func:`repro_torch.kernels.ops.link_demand`:
  the CPU's scatter-add; on the card a hand-written bucket sort of the
  route entries by link, each bucket put in flat order and summed
  serially), the reference's order, so the card takes the CPU's routes. The
  other scatter-adds are integer counters (exact in any order) or float
  metrics nothing reads back.
* The injection ``lax.cond`` is not needed: injection always runs, and
  for members with nothing to send it is a bit-exact no-op.
* The ``lax.while_loop`` becomes a loop that steps ``chunk`` ticks
  between liveness checks (one host sync per chunk). Ticks of a member
  that is no longer live are exact no-ops (``live_m`` freezes it), so the
  chunk size does not change the result. On the card the ticks of a
  chunk are a captured CUDA graph, replayed (see ``run`` in
  :func:`build_engine`); on the CPU they run eagerly.
* The probes and histograms (:mod:`repro_torch.obs`) are compiled into
  the tick only when the engine is built with them, as in the reference;
  without them the tick and the state are unchanged.
* ``run_window`` (the online scheduler's engine call) ticks until every
  member has reached its window event: its ``t_stop``, a job slot
  completing, or the end of its run. The stop rule is monotone and a
  stopped member's ticks are exact no-ops, so on the card the window
  replays whole captured graphs of ``GRAPH_TICKS`` ticks and still gives
  the reference's tick-exact ``lax.while_loop`` bits.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (
    Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.skeleton import OP, SkeletonProgram
from repro_torch.device import resolve_device
from repro_torch.kernels import inject as KINJ
from repro_torch.kernels import ops as KOPS
from repro_torch.netsim.config import NetConfig
from repro_torch.netsim.fabric import Fabric, routing_tables
from repro_torch.netsim.flat import flat_add, flat_reduce, flat_set
from repro_torch.netsim.faults import FaultState
from repro_torch.obs.hist import HistConfig, HistState, init_hist, update_hist
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.probes import (
    ProbeConfig, ProbeState, init_probes, sample_probes)
from repro_torch.obs.spans import span, tracing

MAXE = 8  # max emissions per rank per (op, round)
MASK32 = 0xFFFFFFFF
# ticks one captured CUDA graph holds at most (``run`` on the card); a
# chunk of ``chunk`` ticks replays a graph of gcd(chunk, GRAPH_TICKS)
# ticks chunk / gcd times. 8: on an H100 a graph of 8 ticks of the 1D
# paper scenario captures and instantiates in about 0.2-0.4 s, one of 64
# in about 3 s, and both replay at one rate (tools/graph_ticks_sweep.py)
GRAPH_TICKS = 8
# one capture at a time in the process: a capture reads the kernel
# wrappers' counts around itself, and replicas on distinct cards run in
# threads of their own (``Engine.prun``)
_CAPTURE_LOCK = threading.Lock()
# the tick's parts in order (``tick_batched``): with tracing on, the graphs
# are captured with a timing event at each boundary (``RunStats``'
# ``part_device_ms``)
TICK_PARTS = ("emit", "demand", "route", "drain", "account", "skip")


class JobTable(NamedTuple):
    """The job set as runtime data: stacked, padded program/placement tables.

    Leaves are `(J, ...)` for a member state and `(B, J, ...)` when
    batched. Padded jobs have ``P=1``, an END-only program, and
    ``start=inf``; padded ranks (``p >= P[j]``) are born done.
    """

    ops: torch.Tensor  # (J, OPmax, 4) int32, END-padded
    grid: torch.Tensor  # (J, OPmax, 4) int32 cartesian dims for XCHG
    P: torch.Tensor  # (J,) int32 actual ranks per job (>= 1)
    logp: torch.Tensor  # (J,) int32 ceil(log2(max(P, 2)))
    r2n: torch.Tensor  # (J, Pmax) int32 rank -> node (0-padded)
    slowdown: torch.Tensor  # (J, Pmax) f32 per-rank COMPUTE stretch
    start: torch.Tensor  # (J,) f32 arrival offset (inf for padded jobs)


class VMState(NamedTuple):
    pc: torch.Tensor  # (J, Pmax) int32
    rnd: torch.Tensor  # (J, Pmax) int32 round within current op
    emitted: torch.Tensor  # (J, Pmax) bool — entered current (op, round)
    busy_until: torch.Tensor  # (J, Pmax) f32 us
    send_need: torch.Tensor  # (J, Pmax) int32 cumulative deliveries required
    send_done: torch.Tensor
    recv_need: torch.Tensor
    recv_done: torch.Tensor
    comm_time: torch.Tensor  # (J, Pmax) f32 us blocked on communication
    done: torch.Tensor  # (J, Pmax) bool


class URState(NamedTuple):
    next_t: torch.Tensor  # (Pu,) f32
    count: torch.Tensor  # (Pu,) int32


class PoolState(NamedTuple):
    active: torch.Tensor  # (M,) bool
    src_rank: torch.Tensor  # (M,) int32
    dst_rank: torch.Tensor
    job: torch.Tensor  # (M,) int32 (== app id; UR uses id Jmax)
    size: torch.Tensor  # (M,) f32
    bytes_rem: torch.Tensor  # (M,) f32
    inject_t: torch.Tensor
    min_arrive: torch.Tensor
    routes: torch.Tensor  # (M, route_width) int32 (fabric-declared width)
    free_stack: torch.Tensor  # (M,) int32
    free_top: torch.Tensor  # scalar int32 (number of free slots)
    dropped: torch.Tensor  # scalar int32 (allocation failures; must stay 0)


class Metrics(NamedTuple):
    lat_hist: torch.Tensor  # (n_apps, BINS) int32
    lat_sum: torch.Tensor  # (n_apps,) f32
    lat_min: torch.Tensor
    lat_max: torch.Tensor
    lat_cnt: torch.Tensor
    link_bytes: torch.Tensor  # (L+1,) f32 cumulative per link
    router_win: torch.Tensor  # (n_apps, R) f32 current window (recv bytes)
    router_wins: torch.Tensor  # (W, n_apps, R) f32 snapshots
    win_idx: torch.Tensor
    peak_inject: torch.Tensor  # f32 max bytes injected in one (tick, app)


class SimState(NamedTuple):
    t: torch.Tensor  # (B,) f32 us ((,) for a member state)
    vms: VMState
    ur: Optional[URState]
    pool: PoolState
    metrics: Metrics
    rng: torch.Tensor  # int64 holding the uint32 counter
    jobs: JobTable
    ur_nodes: Optional[torch.Tensor]  # (Pu,) int32 (None when no UR source)
    # sim-plane probe rings (repro_torch.obs.probes): None unless the
    # engine was built with a ProbeConfig, so the unprobed state layout
    # is unchanged
    probes: Optional[ProbeState] = None
    # per-(app, link-level) latency histograms (repro_torch.obs.hist):
    # None unless built with a HistConfig
    hist: Optional[HistState] = None
    # runtime fault mask (repro_torch.netsim.faults), always populated by
    # ``init_state``: healthy factors are exact 1.0 multiplies and +0.0
    # demand adds
    faults: Optional[FaultState] = None


@dataclass
class JobSpec:
    name: str
    skeleton: SkeletonProgram
    rank2node: np.ndarray  # (P,) node ids
    start_us: float = 0.0  # arrival offset (staggered co-scheduling)


@dataclass
class URSpec:
    name: str
    rank2node: np.ndarray
    size_bytes: float = 10 * 1024
    interval_us: float = 1000.0
    start_us: float = 0.0


@dataclass(frozen=True)
class EngineCapacity:
    """The envelope one engine serves: any job set with ``n_jobs <= Jmax``,
    every job's ``n_ranks <= Pmax`` and ``n_ops <= OPmax``."""

    Jmax: int
    Pmax: int
    OPmax: int

    @staticmethod
    def of_jobs(jobs: Sequence[JobSpec]) -> "EngineCapacity":
        return EngineCapacity(
            Jmax=max(len(jobs), 1),
            Pmax=max((j.skeleton.n_ranks for j in jobs), default=1),
            OPmax=max((j.skeleton.n_ops for j in jobs), default=1),
        )

    def union(self, other: "EngineCapacity") -> "EngineCapacity":
        return EngineCapacity(
            max(self.Jmax, other.Jmax), max(self.Pmax, other.Pmax),
            max(self.OPmax, other.OPmax),
        )


@dataclass
class RunStats:
    """What one ``run`` or ``run_window`` call did (``Engine.last_run``,
    ``Engine.last_window``).

    ``ticks`` counts every tick stepped, a stopped member's no-op ticks
    included; ``live_ticks`` (windows only) the ticks in which some member
    had not yet stopped, counted on the device outside the state. On the
    card each chunk or window replays a captured graph of ``graph_ticks``
    ticks; ``graph_calls`` and ``graph_launches`` are the kernel wrappers'
    counts (``repro_torch.kernels.ops``) taken while that graph was
    captured, so the launches of the call are ``replays`` times them.
    ``replay_device_ms`` is CUDA-event time around the replays.
    ``replicas`` holds each replica's own stats when the call was
    :meth:`Engine.prun` (:meth:`merged`), else nothing.

    With tracing on (:func:`repro_torch.obs.tracing`), the card replays a
    traced variant of each graph that times the tick's parts
    (``TICK_PARTS``) by events inside the graph: ``part_device_ms`` sums
    each part's device ms over the last replay of every chunk or window,
    which hold ``part_ticks`` ticks, and ``inject_candidates`` and
    ``inject_routed`` count the injection kernel's candidates and those
    given a slot (routed) over every replayed tick (a dragonfly's; the fat
    tree and the torus, injected by the plain version, count none).
    Otherwise all stay empty.
    """

    device: str
    ticks: int = 0
    live_ticks: int = 0
    liveness_reads: int = 0
    graph_ticks: int = 0
    replays: int = 0
    captured: bool = False
    capture_s: float = 0.0
    instantiate_s: float = 0.0
    graph_calls: Dict[str, int] = field(default_factory=dict)
    graph_launches: Dict[str, int] = field(default_factory=dict)
    replay_device_ms: float = 0.0
    part_device_ms: Dict[str, float] = field(default_factory=dict)
    part_ticks: int = 0
    inject_candidates: int = 0
    inject_routed: int = 0
    replicas: Tuple["RunStats", ...] = ()

    @classmethod
    def merged(cls, device: str, parts: Sequence["RunStats"]) -> "RunStats":
        """The stats of replicas' calls as one call's: counts and times
        summed, ``captured`` if any replica captured. Every replica
        replays a graph of the same shape, so each kept the same graph
        counts, and ``replays`` times them stays the launches."""
        first = parts[0]
        if any(p.graph_launches != first.graph_launches
               or p.graph_ticks != first.graph_ticks for p in parts):
            raise ValueError("replicas replayed graphs of other counts")
        part_ms: Dict[str, float] = {}
        for p in parts:
            for k, v in p.part_device_ms.items():
                part_ms[k] = part_ms.get(k, 0.0) + v
        return cls(
            device=device,
            ticks=sum(p.ticks for p in parts),
            live_ticks=sum(p.live_ticks for p in parts),
            liveness_reads=sum(p.liveness_reads for p in parts),
            graph_ticks=first.graph_ticks,
            replays=sum(p.replays for p in parts),
            captured=any(p.captured for p in parts),
            capture_s=sum(p.capture_s for p in parts),
            instantiate_s=sum(p.instantiate_s for p in parts),
            graph_calls=dict(first.graph_calls),
            graph_launches=dict(first.graph_launches),
            replay_device_ms=sum(p.replay_device_ms for p in parts),
            part_device_ms=part_ms,
            part_ticks=sum(p.part_ticks for p in parts),
            inject_candidates=sum(p.inject_candidates for p in parts),
            inject_routed=sum(p.inject_routed for p in parts),
            replicas=tuple(parts))


@dataclass
class Engine:
    """The engine bundle for one capacity envelope.

    Unpacks like the historical ``(init_state, run, tick)`` triple.
    ``run`` ticks until no member is live; ``run_window`` until every
    member reaches its window event (the online scheduler's call);
    ``capacity`` is the envelope; ``last_run`` and ``last_window`` are the
    :class:`RunStats` of the latest calls on this object.

    On the card the captured graphs live in ``graphs``, one per state
    shape and kind of call, for the life of this object;
    :meth:`drop_graphs` frees them. An engine bound to a scenario's jobs
    (:func:`repro_torch.union.manager.bind_jobs`) shares the cached
    engine's tables and ``graphs`` and keeps its own stats.

    ``replica(device)`` gives the engine at this envelope on another
    device (:func:`get_engine` sets it to a cache lookup, so every engine
    at one envelope shares one set of replicas); :meth:`prun` runs
    member batches on them.
    """

    init_state: Callable
    tick: Callable
    capacity: EngineCapacity
    device: torch.device
    run_fn: Callable = field(repr=False)
    window_fn: Callable = field(repr=False)
    graphs: Dict[tuple, "_TickGraph"] = field(default_factory=dict,
                                              repr=False)
    last_run: Optional[RunStats] = None
    last_window: Optional[RunStats] = None
    replica: Optional[Callable[[torch.device], "Engine"]] = field(
        default=None, repr=False)

    def __iter__(self):
        return iter((self.init_state, self.run, self.tick))

    def run(self, state: "SimState", chunk: int = 64) -> "SimState":
        """Tick until no member is live. Liveness is read on the host once
        per ``chunk`` ticks; the extra ticks of a finished member are
        exact no-ops, so ``chunk`` does not change the result. On the card
        the ticks are replays of a captured graph; on the CPU, eager."""
        return self._run(state, chunk, time_parts=True)

    def _run(self, state: "SimState", chunk: int,
             time_parts: bool) -> "SimState":
        # ``time_parts``: with tracing on, replay the traced variant
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        stats = RunStats(device=self.device.type)
        out = self.run_fn(state, chunk, self.graphs, stats, time_parts)
        self.last_run = stats
        return out

    def prun(self, states: Sequence["SimState"],
             chunk: int = 64) -> List["SimState"]:
        """``run`` over D stacked member batches, the d-th on its own
        device (the reference's ``pmap`` of ``run`` over a leading device
        axis); returns their D final states, each on its device.

        Batch d runs on this engine when it lies on this engine's device,
        else on ``replica`` of its device. Batches on distinct devices run
        at once, one host thread a device, all joined before a result is
        read; batches on one device share its engine (one captured graph
        and its buffers) and run in turn. ``last_run`` is the replicas'
        stats merged (:meth:`RunStats.merged`).

        Traced, the call is an ``engine.prun`` span and each device's turn
        an ``engine.replica`` span in its thread, which ends with the
        replica's ``replay_device_ms`` and ``wait_ms``, the time from its
        end to the join. The replicas replay the plain graphs even then,
        and time no tick part: capturing a traced variant on one card
        while the others replay collides with a device-wide synchronize
        from another thread (a profiler's start), which fails while a
        stream captures."""
        groups: Dict[str, List[int]] = {}
        for d, s in enumerate(states):
            groups.setdefault(str(s.t.device), []).append(d)
        engines = {dev: self if dev == str(self.device)
                   else self._replica_on(torch.device(dev))
                   for dev in groups}
        out: List[Optional[SimState]] = [None] * len(states)
        parts: List[Optional[RunStats]] = [None] * len(states)
        ends: Dict[str, Tuple[float, object]] = {}

        def run_on(dev: str) -> None:
            eng = engines[dev]
            members = sum(int(states[d].t.shape[0]) for d in groups[dev])
            with span("engine.replica", cat="engine", device=dev,
                      members=members) as sp, \
                    (torch.cuda.device(dev) if eng.device.type == "cuda"
                     else contextlib.nullcontext()):
                for d in groups[dev]:
                    out[d] = eng._run(states[d], chunk, time_parts=False)
                    parts[d] = eng.last_run
                sp.set(replay_device_ms=sum(parts[d].replay_device_ms
                                            for d in groups[dev]))
            ends[dev] = (time.perf_counter(), sp)

        with span("engine.prun", cat="engine", replicas=len(groups)):
            if len(groups) == 1:
                run_on(next(iter(groups)))
            else:
                with ThreadPoolExecutor(len(groups)) as pool:
                    for f in [pool.submit(run_on, dev) for dev in groups]:
                        f.result()
            joined = time.perf_counter()
            # a span's record holds its handle's args: set after it ended
            for end, sp in ends.values():
                sp.set(wait_ms=(joined - end) * 1e3)
        self.last_run = RunStats.merged(self.device.type, parts)
        return out

    def _replica_on(self, device: torch.device) -> "Engine":
        if self.replica is None:
            raise ValueError(
                f"this engine has no replica on {device}: an engine of "
                "build_engine runs on its own device only; get_engine's "
                "engines have replicas")
        return self.replica(device)

    def run_window(self, state: "SimState", t_stop) -> "SimState":
        """One scheduling window: tick until every member has stopped,
        a member stopping when virtual time reaches its ``t_stop`` (a
        scalar, or one per member of a batch), when one more of its job
        slots is done than when the window began, or when it is no longer
        live. A stopped member stays frozen while its batch-mates tick."""
        stats = RunStats(device=self.device.type)
        out = self.window_fn(state, t_stop, self.graphs, stats)
        self.last_window = stats
        return out

    def drop_graphs(self) -> None:
        """Free the captured graphs and their static buffers (those of
        every engine bound to this one too)."""
        self.graphs.clear()


def _ceil_log2(P: int) -> int:
    return max(1, math.ceil(math.log2(max(P, 2))))


def pack_jobs(
    jobs: Sequence[JobSpec],
    cap: EngineCapacity,
    *,
    placements: Optional[Sequence[np.ndarray]] = None,
    start_us: Optional[Sequence[float]] = None,
    rank_slowdown: Optional[Sequence[Optional[np.ndarray]]] = None,
    device,
) -> JobTable:
    """Stack a job list into the padded (Jmax, Pmax/OPmax) runtime tables
    on ``device``.

    ``placements`` replaces each job's ``rank2node``; ``start_us``
    replaces each job's arrival offset (a member's actual schedule);
    ``rank_slowdown`` gives each job's per-rank COMPUTE stretch (None for
    a job: 1.0).
    """
    J, Pmax, OPmax = cap.Jmax, cap.Pmax, cap.OPmax
    if len(jobs) > J:
        raise ValueError(f"{len(jobs)} jobs exceed engine capacity Jmax={J}")
    ops = np.zeros((J, OPmax, 4), np.int32)
    ops[:, :, 0] = OP["END"]
    grid = np.zeros((J, OPmax, 4), np.int32)
    P = np.ones((J,), np.int32)
    r2n = np.zeros((J, Pmax), np.int32)
    slow = np.ones((J, Pmax), np.float32)
    start = np.full((J,), np.inf, np.float32)
    for ji, j in enumerate(jobs):
        sk = j.skeleton
        if sk.n_ranks > Pmax or sk.n_ops > OPmax:
            raise ValueError(
                f"job {j.name!r} ({sk.n_ranks} ranks, {sk.n_ops} ops) exceeds "
                f"engine capacity (Pmax={Pmax}, OPmax={OPmax})"
            )
        ops[ji, : sk.n_ops] = sk.ops
        grid[ji, : sk.n_ops] = sk.grid
        P[ji] = sk.n_ranks
        pl = placements[ji] if placements is not None else j.rank2node
        r2n[ji, : sk.n_ranks] = np.asarray(pl, np.int32)
        if rank_slowdown is not None and rank_slowdown[ji] is not None:
            slow[ji, : sk.n_ranks] = np.asarray(rank_slowdown[ji], np.float32)
        s = float(j.start_us)
        if start_us is not None and start_us[ji] is not None:
            s = float(start_us[ji])
        start[ji] = s
    logp = np.asarray([_ceil_log2(int(p)) for p in P], np.int32)

    def dev(x):
        return torch.as_tensor(x, device=device)

    return JobTable(
        ops=dev(ops), grid=dev(grid), P=dev(P), logp=dev(logp), r2n=dev(r2n),
        slowdown=dev(slow), start=dev(start),
    )


def _hash(x):
    """The reference's uint32 hash on int64 tensors holding uint32 values."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & MASK32
    return x ^ (x >> 16)


def _tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested NamedTuples (None stays);
    ``rest`` are trees of the same structure whose leaves ``fn`` also
    takes."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, *xs) for xs in zip(tree, *rest)])
    return fn(tree, *rest)


def _leaves(tree):
    """The tensor leaves of nested NamedTuples, in field order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


@dataclass
class _TickGraph:
    """A captured graph of ``ticks`` ticks over the static buffers
    ``static``, with its flag and what its capture counted. A window's
    graph also holds its ``t_stop`` and ``n0`` buffers, written before
    each window, and its flag is ``[any member not stopped, live ticks]``."""

    graph: "torch.cuda.CUDAGraph"
    static: SimState
    flag: torch.Tensor
    ticks: int
    calls: Dict[str, int]
    launches: Dict[str, int]
    capture_s: float
    instantiate_s: float
    t_stop: Optional[torch.Tensor] = None
    n0: Optional[torch.Tensor] = None
    clock: Optional["_PartClock"] = None


class _PartClock:
    """Timing events at the boundaries of the tick's parts
    (``TICK_PARTS``), recorded while a traced graph is captured: one row
    of ``len(TICK_PARTS) + 1`` events a captured tick. They are nodes of
    the graph (external event records), so after a replay they hold its
    times; the eager step before a capture records none. Beside them, the
    injection's counts (candidates seen, candidates given a slot and so
    routed) are added up on the device by every replayed tick: the
    dragonfly's injection kernel adds them to ``counts`` with no launch of
    its own, so the traced graph runs the plain graph's operations."""

    def __init__(self, device):
        self.rows: List[List["torch.cuda.Event"]] = []
        self.counts = torch.zeros((2,), dtype=torch.int64, device=device)

    def tick(self) -> None:
        """The start of a tick."""
        if torch.cuda.is_current_stream_capturing():
            self.rows.append([])
            self._record()

    def __call__(self, part: str) -> None:
        """The end of ``part``."""
        if torch.cuda.is_current_stream_capturing():
            if part != TICK_PARTS[len(self.rows[-1]) - 1]:
                raise ValueError(f"tick part {part!r} out of order")
            self._record()

    def counter(self) -> Optional[torch.Tensor]:
        """The injection's tally while a graph is captured, else None."""
        if torch.cuda.is_current_stream_capturing():
            return self.counts
        return None

    def _record(self) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.rows[-1].append(ev)

    def read(self, stats: RunStats) -> None:
        """Add the times of the graph's last replay, which has ended, to
        ``stats``, and the injection's counts of every replay since the
        last read."""
        for row in self.rows:
            for part, a, b in zip(TICK_PARTS, row, row[1:]):
                stats.part_device_ms[part] = (
                    stats.part_device_ms.get(part, 0.0) + a.elapsed_time(b))
        stats.part_ticks += len(self.rows)
        seen, routed = self.counts.tolist()
        self.counts.zero_()
        stats.inject_candidates += seen
        stats.inject_routed += routed


def member_live(state: SimState, horizon_us: float) -> torch.Tensor:
    """Whether a member, or each member of a batch, is live: before
    ``horizon_us`` with a rank not done or a message in flight. ``run``
    ticks while any member is live; a tick leaves a member that is not
    live as it is."""
    done = state.vms.done.flatten(-2).all(-1) & ~state.pool.active.any(-1)
    return (state.t < horizon_us) & ~done


def done_slots(state: SimState) -> torch.Tensor:
    """Fully done job slots of a member (or per member); vacant slots
    count too."""
    return state.vms.done.all(-1).sum(-1)


def window_stopped(state: SimState, t_stop, n0,
                   horizon_us: float) -> torch.Tensor:
    """``run_window``'s stop rule: a member stops when it is no longer
    live, when its clock reaches ``t_stop``, or when more of its job slots
    are done than the ``n0`` its window began with. Monotone: a stopped
    member's ticks are no-ops, so it stays stopped."""
    return ~(member_live(state, horizon_us) & (state.t < t_stop)
             & (done_slots(state) <= n0))


def _member_batched(fn):
    """Promote a member state (scalar t) to a B=1 batch around ``fn``."""

    def wrapper(state: SimState, *args, **kw):
        if state.t.dim() == 0:
            out = fn(_tree_map(lambda x: x[None], state), *args, **kw)
            return _tree_map(lambda x: x[0], out)
        return fn(state, *args, **kw)

    return wrapper


def build_engine(
    topo: Fabric,
    jobs: Sequence[JobSpec],
    *,
    routing: str = "ADP",
    ur: Optional[URSpec] = None,
    net: Optional[NetConfig] = None,
    pool_size: Optional[int] = None,
    horizon_us: float = 500_000.0,
    capacity: Optional[EngineCapacity] = None,
    device=None,
    probes: Optional[ProbeConfig] = None,
    hist: Optional[HistConfig] = None,
) -> Engine:
    """Returns an :class:`Engine` — unpacks as ``(init_state, run, tick)``;
    ``run``: state -> final state.

    ``jobs`` is the default job set; ``capacity`` (default: what ``jobs``
    need) may widen the padded envelope, as a scenario's ``reserve`` does,
    and ``init_state(jobs_override=...)`` swaps in any job set that fits
    it. ``run`` and ``tick`` accept a member state or a stacked batch of
    members (leading ``B`` dim; :func:`stack_members`).

    Faults, rank slowdowns and arrival offsets are per-member runtime
    data: ``init_state(faults=..., rank_slowdown_override=...,
    start_us=...)``.

    ``probes`` (a :class:`repro_torch.obs.ProbeConfig`) and ``hist`` (a
    :class:`repro_torch.obs.HistConfig`) compile the sim-plane observers
    into the tick; without them the tick holds no observer code.

    ``device`` defaults to CUDA and raises when there is none (see
    :func:`resolve_device`). On CUDA, ``run`` replays captured CUDA
    graphs of the tick, kept per state shape (so per batch size) for the
    engine's life; a capture that fails raises.
    """
    dev = resolve_device(device)
    net = net or NetConfig()
    T, route_fn = routing_tables(topo, dev)
    # a dragonfly injects through the kernel wrapper (its UGAL router in
    # csrc/inject.cu on the card); other fabrics route with their own
    # route_fn in the plain injection on every device
    dragonfly = topo.family == "dragonfly"
    inject_tables = KINJ.inject_tables(T, dragonfly)
    L = topo.n_links
    RW = topo.route_width  # pool route-row width (fabric-declared)
    n_nodes = topo.n_nodes
    M = pool_size or net.pool_size
    cap = capacity or EngineCapacity.of_jobs(jobs)
    J, Pmax = cap.Jmax, cap.Pmax
    n_apps = J + (1 if ur else 0)
    adaptive = routing.upper() in ("ADP", "ADAPTIVE")
    dt = float(np.float32(net.tick_us))
    BINS = net.latency_hist_bins
    W = net.max_windows
    R = topo.n_routers
    i32, i64, f32 = torch.int32, torch.int64, torch.float32

    ur_r2n = np.asarray(ur.rank2node, np.int32) if ur else None
    Pu = int(ur.rank2node.shape[0]) if ur else 0
    link_dstr = torch.as_tensor(np.concatenate(
        [np.asarray(topo.link_dst_router, np.int32), np.zeros(1, np.int32)]
    ), device=dev)  # (L+1,) with the dummy row
    link_srcr_l = torch.as_tensor(
        np.asarray(topo.link_src_router, np.int64), device=dev)
    link_dstr_l = torch.as_tensor(
        np.asarray(topo.link_dst_router, np.int64), device=dev)
    bw_base = torch.as_tensor(np.asarray(topo.link_bw, np.float32), device=dev)

    # probe constants: link -> level one-hot and each level's aggregate
    # healthy capacity (denominators stay healthy capacity under runtime
    # faults, so a failure shows as a per-level utilization shift)
    if probes is not None:
        _lm = np.stack(
            [np.asarray(m, np.float32) for m in topo.link_levels().values()],
            axis=1,
        )  # (L, n_levels)
        probe_level_mask = torch.as_tensor(_lm, device=dev)
        probe_level_bw = torch.as_tensor(
            (np.asarray(topo.link_bw, np.float32)[:, None]
             * _lm).sum(axis=0),
            device=dev)  # (n_levels,), float32 sums as the reference's
        probe_n_levels = _lm.shape[1]

    # histogram constants: link -> fabric-level index (a message's level
    # is the max level of its route links; a dummy 0 row at index L)
    if hist is not None:
        _hl = np.zeros((L + 1,), np.int32)
        _levels = topo.link_levels()
        for _li, _mask in enumerate(_levels.values()):
            _hl[:L][np.asarray(_mask, bool)] = _li
        hist_link_level = torch.as_tensor(_hl, device=dev)
        hist_n_levels = max(len(_levels), 1)

    # static candidate-index patterns for the stacked injection pass:
    # candidates are job-major, rank-major, emission-minor.
    N = J * Pmax * MAXE
    cand_job = torch.as_tensor(
        np.repeat(np.arange(J, dtype=np.int64), Pmax * MAXE), device=dev)
    cand_rank = torch.as_tensor(np.tile(
        np.repeat(np.arange(Pmax, dtype=np.int64), MAXE), J), device=dev)
    cand_local = torch.as_tensor(
        np.tile(np.arange(Pmax * MAXE, dtype=np.int64), J), device=dev)
    ranks_v = torch.arange(Pmax, dtype=i32, device=dev)[None, None, :]
    cand_rank32 = cand_rank.to(i32)
    cand_job32 = cand_job.to(i32)
    ur_ids = torch.arange(Pu, dtype=i32, device=dev)
    ur_sizes = torch.full((Pu,), float(ur.size_bytes) if ur else 0.0,
                          dtype=f32, device=dev)
    ur_app = torch.full((Pu,), J, dtype=i32, device=dev)
    emit_slots = torch.arange(MAXE, dtype=i32, device=dev)
    win_ids = torch.arange(W, dtype=i32, device=dev)
    slot_ids = torch.arange(M, dtype=i32, device=dev)
    zero_f = torch.zeros((), dtype=f32, device=dev)
    inf_f = torch.full((), math.inf, dtype=f32, device=dev)
    dt_f = torch.full((), dt, dtype=f32, device=dev)

    def gather_op(table, pc):
        # pc stays inside the program: every program ends with END, where
        # its rank is done and stops advancing
        idx = pc.long()[..., None].expand(-1, -1, -1, 4)
        return torch.gather(table, 2, idx)

    # ------------------------------------------------------------------
    # stacked emission: one pass computes this (op, round)'s messages for
    # every (job, rank) — batched over members.
    # ------------------------------------------------------------------
    def vm_emit(jt: JobTable, vm: VMState, t, live_m):
        B = t.shape[0]
        ranks = ranks_v
        P = jt.P[:, :, None]  # (B, J, 1)
        row = gather_op(jt.ops, vm.pc)  # (B, J, Pmax, 4)
        opc, a0, a1, a2 = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
        g = gather_op(jt.grid, vm.pc)
        enter = (
            (~vm.emitted) & (~vm.done)
            & (t[:, None, None] >= jt.start[:, :, None])
            & live_m[:, None, None]
        )

        dst = torch.full((B, J, Pmax, MAXE), -1, dtype=i32, device=dev)
        size = torch.zeros((B, J, Pmax), dtype=f32, device=dev)
        send_inc = torch.zeros((B, J, Pmax), dtype=i32, device=dev)
        recv_inc = torch.zeros((B, J, Pmax), dtype=i32, device=dev)
        busy = vm.busy_until

        # COMPUTE (straggler factor scales the delay per rank)
        is_comp = opc == OP["COMPUTE"]
        busy = torch.where(
            enter & is_comp,
            t[:, None, None] + a0.to(f32) * jt.slowdown, busy,
        )

        # P2P / IP2P
        is_p2p = (opc == OP["P2P"]) | (opc == OP["IP2P"])
        send_p2p = is_p2p & (ranks == a0)
        dst[..., 0] = torch.where(send_p2p, a1, dst[..., 0])
        size = torch.where(send_p2p, a2.to(f32), size)
        send_inc = send_inc + send_p2p.to(i32)
        recv_inc = recv_inc + (is_p2p & (ranks == a1)).to(i32)

        # GATHER (root a0, size a1)
        is_gather = opc == OP["GATHER"]
        send_g = is_gather & (ranks != a0)
        dst[..., 0] = torch.where(send_g, a0, dst[..., 0])
        size = torch.where(send_g, a1.to(f32), size)
        send_inc = send_inc + send_g.to(i32)
        recv_inc = recv_inc + torch.where(is_gather & (ranks == a0), P - 1, 0)

        # SCATTER (root a0, size a1), MAXE targets per round
        is_scat = opc == OP["SCATTER"]
        base = vm.rnd * MAXE
        tgt = base[..., None] + emit_slots
        tgt = tgt + (tgt >= a0[..., None]).to(i32)  # skip root
        valid_s = (
            is_scat[..., None] & (ranks == a0)[..., None] & (tgt < P[..., None])
        )
        dst = torch.where(valid_s, tgt, dst)
        size = torch.where(is_scat & (ranks == a0), a1.to(f32), size)
        send_inc = send_inc + torch.where(
            is_scat & (ranks == a0), valid_s.sum(-1).to(i32), 0
        )
        recv_first = is_scat & (ranks != a0) & (vm.rnd == 0)
        recv_inc = recv_inc + recv_first.to(i32)

        # XCHG (size a0, ndims a1, dims g): one round, 2*ndims neighbors
        is_x = opc == OP["XCHG"]
        dims = g.clamp(min=1)  # (B, J, Pmax, 4)
        stride = torch.cat(
            [torch.ones_like(dims[..., :1]), torch.cumprod(dims[..., :3], dim=-1)],
            dim=-1,
        )
        coord = torch.remainder(
            torch.div(ranks[..., None], stride, rounding_mode="floor"), dims)
        for d in range(4):
            for s, dirn in ((2 * d, 1), (2 * d + 1, -1)):
                if s >= MAXE:
                    continue
                nb_c = torch.remainder(coord[..., d] + dirn, dims[..., d])
                nb = ranks + (nb_c - coord[..., d]) * stride[..., d]
                use = is_x & (a1 > d)
                dst[..., s] = torch.where(use, nb, dst[..., s])
        size = torch.where(is_x, a0.to(f32), size)
        nmsg = 2 * torch.clamp(a1, max=4)
        send_inc = send_inc + torch.where(is_x, nmsg, 0)
        recv_inc = recv_inc + torch.where(is_x, nmsg, 0)

        # ALLREDUCE: ring (>=4KiB) 2(P-1) rounds of size/P; else RD log2
        is_ar = opc == OP["ALLREDUCE"]
        is_bar = opc == OP["BARRIER"]
        big = a0 >= 4096
        ring = is_ar & big
        nb_ring = torch.remainder(ranks + 1, P)
        sz_ring = torch.ceil(a0.to(f32) / P)
        dst[..., 0] = torch.where(ring, nb_ring, dst[..., 0])
        size = torch.where(ring, sz_ring, size)
        send_inc = send_inc + ring.to(i32)
        recv_inc = recv_inc + ring.to(i32)

        rd = (is_ar & ~big) | is_bar
        pow2 = torch.ones_like(vm.rnd) << vm.rnd.clamp(max=30)
        peer = ranks ^ pow2
        rd_ok = rd & (peer < P)
        dst[..., 0] = torch.where(rd_ok, peer, dst[..., 0])
        size = torch.where(rd_ok, torch.clamp(a0.to(f32), min=8.0), size)
        send_inc = send_inc + rd_ok.to(i32)
        recv_inc = recv_inc + rd_ok.to(i32)

        # BCAST (root a0, size a1): binomial over relative ranks
        is_bc = opc == OP["BCAST"]
        rel = torch.remainder(ranks - a0, P)
        bc_send = is_bc & (rel < pow2) & (rel + pow2 < P)
        bc_dst = torch.remainder(rel + pow2 + a0, P)
        dst[..., 0] = torch.where(bc_send, bc_dst, dst[..., 0])
        size = torch.where(bc_send, a1.to(f32), size)
        send_inc = send_inc + bc_send.to(i32)
        bc_recv = is_bc & (rel >= pow2) & (rel < 2 * pow2)
        recv_inc = recv_inc + bc_recv.to(i32)

        # apply entry
        dst = torch.where(enter[..., None], dst, -1)
        vm = vm._replace(
            emitted=vm.emitted | enter,
            busy_until=busy,
            send_need=vm.send_need + torch.where(enter, send_inc, 0),
            recv_need=vm.recv_need + torch.where(enter, recv_inc, 0),
        )
        return vm, dst, size

    # ------------------------------------------------------------------
    # the tick (batched: every leaf carries the member dim B)
    # ------------------------------------------------------------------
    def _n_rounds(opc, a0, P, logp):
        ring = opc == OP["ALLREDUCE"]
        big = a0 >= 4096
        return torch.where(
            ring, torch.where(big, 2 * (P - 1), logp),
            torch.where(
                (opc == OP["BCAST"]) | (opc == OP["BARRIER"]), logp,
                torch.where(
                    opc == OP["SCATTER"],
                    torch.div(P - 2, MAXE, rounding_mode="floor") + 1, 1),
            ),
        )

    def live(s: SimState):
        return member_live(s, horizon_us)

    def tick_batched(state: SimState, t_cap=math.inf,
                     stop_m: Optional[torch.Tensor] = None,
                     mark: Optional[_PartClock] = None) -> SimState:
        # ``t_cap`` (a scalar or a (B,) f32 tensor) clamps the PDES time
        # skip (step 7) for windowed runs: it enters the wake-up minimum
        # like a pending job's start, so a window boundary at an arrival
        # leaves the trajectory that of an uninterrupted run with that job
        # in the table. ``stop_m`` (B,) freezes members that reached their
        # window event (run_window). At the default t_cap=inf neither step
        # is taken: both would be exact no-ops, and ``run``'s tick stays
        # as it was. ``mark`` (a traced graph's capture only) is called at
        # the end of each of the tick's parts, ``TICK_PARTS``.
        jt = state.jobs
        t = state.t  # (B,)
        B = t.shape[0]
        pool, metrics, rng = state.pool, state.metrics, state.rng
        # per-member freeze mask: finished / horizon-capped members must
        # not mutate (bit-identity with their own B=1 run)
        live_m = live(state)
        if stop_m is not None:
            live_m = live_m & ~stop_m
        windowed = isinstance(t_cap, torch.Tensor) or math.isfinite(t_cap)
        if windowed:
            t_cap = torch.as_tensor(t_cap, dtype=f32, device=dev)

        # --- 0. runtime fault mask -> effective per-link bandwidth ---
        flt = state.faults
        rf = flt.router_factor  # (B, R)
        eff_f = flt.link_bw_factor * rf[:, link_srcr_l] * rf[:, link_dstr_l]
        bw_run = torch.cat(
            [bw_base[None, :] * eff_f, torch.ones((B, 1), dtype=f32, device=dev)],
            dim=1,
        )  # (B, L+1) with the dummy row

        # --- 1. VM entry + emission + injection (one stacked pass) ---
        vms, dst, sizes = vm_emit(jt, state.vms, t, live_m)
        fired = (dst >= 0).flatten(2).any(2)  # (B, J)

        # per-job rng offsets reproduce the per-job-loop draw schedule:
        # each *fired* job advanced the stream by its P*MAXE candidates.
        adv = (jt.P.to(i64) * MAXE) * fired.to(i64)  # (B, J)
        base = (rng[:, None] + torch.cumsum(adv, dim=1) - adv) & MASK32
        rng_jobs = (rng + adv.sum(dim=1)) & MASK32

        dst_f = dst.reshape(B, N)
        sizes_f = sizes[:, :, :, None].expand(B, J, Pmax, MAXE).reshape(B, N)
        r2n_f = jt.r2n.reshape(B, J * Pmax)
        srcs_node = r2n_f[:, cand_job * Pmax + cand_rank]
        dst_node_idx = cand_job[None, :] * Pmax + dst_f.clamp(min=0)
        dsts_node = torch.gather(r2n_f, 1, dst_node_idx)
        rand = _hash((base[:, cand_job] + cand_local[None, :]) & MASK32)

        ur_state = state.ur
        rng2 = rng_jobs
        if ur_state is not None:
            fire = (t[:, None] >= ur_state.next_t) & live_m[:, None]  # (B,Pu)
            pu_ids = torch.arange(Pu, dtype=i64, device=dev)[None, :]
            rnd = _hash(
                (ur_state.count.to(i64) * 9781 + pu_ids + rng_jobs[:, None])
                & MASK32
            )
            dstn = (rnd % n_nodes).to(i32)
            ur_rand = _hash((rng_jobs[:, None] + pu_ids) & MASK32)

        if mark is not None:
            mark("emit")
        # injection always runs: for members (and jobs) with nothing to
        # send every candidate is masked, which is a bit-exact no-op, and
        # it saves the host sync a branch would cost. The link demand
        # (outstanding bytes per link) comes from the PRE-injection pool —
        # the job pass and the UR pass both route against this snapshot.
        demand = KOPS.link_demand(pool.routes, pool.active, pool.bytes_rem,
                                  L)
        # failed links: infinite demand steers adaptive routes around
        # them; +0.0 when healthy, so the add is a bit-exact no-op.
        demand = torch.cat([
            demand[:, :L] + torch.where(eff_f > 0.0, 0.0, 1e18).to(f32),
            demand[:, L:],
        ], dim=1)
        if mark is not None:
            mark("demand")

        batches = [KINJ.Candidates(
            cand_rank32.expand(B, N), dst_f, dsts_node, srcs_node, sizes_f,
            cand_job32.expand(B, N), rand, per_job_peak=True)]
        if ur_state is not None:
            batches.append(KINJ.Candidates(
                ur_ids.expand(B, Pu),
                torch.where(fire, 0, -1).to(i32),  # dst_rank 0 marker
                dstn, state.ur_nodes, ur_sizes.expand(B, Pu),
                ur_app.expand(B, Pu), ur_rand, per_job_peak=False))
        if dragonfly:
            pool, metrics = KOPS.inject(
                pool, metrics, t, batches, demand, inject_tables,
                adaptive=adaptive, hop_latency_us=net.hop_latency_us,
                n_jobs=J,
                counts=None if mark is None else mark.counter())
        else:
            pool, metrics = KINJ.inject_batches_plain(
                pool, metrics, t, batches, demand, inject_tables, adaptive,
                net.hop_latency_us, J, route_fn=route_fn)
        if ur_state is not None:
            rng2 = (rng_jobs + Pu * fire.any(dim=1).to(i64)) & MASK32
            ur_state = URState(
                next_t=torch.where(
                    fire, ur_state.next_t + ur.interval_us, ur_state.next_t),
                count=ur_state.count + fire.to(i32),
            )
        if mark is not None:
            mark("route")

        # --- 2-3. fused drain tick: demand -> fair share -> drain ->
        # delivery, plus per-link byte counters (the CUDA kernel) ---
        new_rem, _rate, delivered, lb_delta, rw_delta = KOPS.drain_tick(
            pool.routes, pool.bytes_rem, pool.active, pool.job,
            pool.min_arrive, t, dt, bw_run, link_dstr,
            n_apps=n_apps, n_routers=R,
        )
        if mark is not None:
            mark("drain")
        # horizon-frozen members may still carry in-flight messages: their
        # drain results are discarded (the freeze in place of a select)
        new_rem = torch.where(live_m[:, None], new_rem, pool.bytes_rem)
        delivered = delivered & live_m[:, None]
        link_bytes = metrics.link_bytes + lb_delta * live_m[:, None]
        router_win = metrics.router_win + rw_delta * live_m[:, None, None]

        # --- latency metrics ---
        # torch.log may differ from the reference's log by an ulp at a bin
        # edge; only per-app bin totals are in the parity contract.
        lat = (t[:, None] + dt) - pool.inject_t  # delivered at end of tick
        ratio = math.log(net.latency_hist_ratio)
        bins = torch.clamp(
            torch.log(torch.clamp(lat / net.latency_hist_lo_us, min=1e-6))
            / ratio,
            0, BINS - 1,
        ).to(i32)
        app_of = pool.job
        d32 = delivered.to(i32)
        lat_hist = flat_add(
            metrics.lat_hist,
            torch.where(delivered, app_of, 0) * BINS
            + torch.where(delivered, bins, 0),
            d32,
        )
        lat_sum = flat_add(
            metrics.lat_sum, app_of, torch.where(delivered, lat, zero_f))
        lat_cnt = flat_add(metrics.lat_cnt, app_of, d32)
        lat_min = flat_reduce(
            metrics.lat_min, app_of, torch.where(delivered, lat, inf_f), "amin")
        lat_max = flat_reduce(
            metrics.lat_max, app_of, torch.where(delivered, lat, -inf_f), "amax")

        # (app, link-level) histograms, compiled in only when configured
        # (``delivered`` is already live_m-gated above)
        hist_st = state.hist
        if hist is not None:
            msg_lvl = torch.where(
                pool.routes >= 0,
                hist_link_level[pool.routes.clamp(0, L).long()], 0,
            ).amax(dim=-1)  # (B, M)
            hist_st = update_hist(hist_st, hist, lat=lat, delivered=delivered,
                                  app=app_of, level=msg_lvl)

        # --- 4. delivery notifications -> VMs (UR id J is dropped) ---
        notify = delivered & (pool.job < J)
        sd = flat_add(
            vms.send_done, pool.job * Pmax + pool.src_rank,
            notify.to(i32), valid=notify,
        )
        rd = flat_add(
            vms.recv_done, pool.job * Pmax + pool.dst_rank,
            notify.to(i32), valid=notify,
        )
        vms = vms._replace(send_done=sd, recv_done=rd)

        # free delivered slots
        freed = delivered
        kf = torch.cumsum(freed.to(i32), dim=1) - 1
        pos = pool.free_top[:, None] + kf
        free_stack = flat_set(
            pool.free_stack, pos, slot_ids.expand(B, M), valid=freed)
        pool = pool._replace(
            active=pool.active & ~delivered,
            bytes_rem=new_rem,
            free_stack=free_stack,
            free_top=pool.free_top + freed.sum(dim=1).to(i32),
        )

        # --- 5. VM completion / advance (one stacked pass) ---
        row = gather_op(jt.ops, vms.pc)
        opc, a0 = row[..., 0], row[..., 1]
        P = jt.P[:, :, None]
        nr = _n_rounds(opc, a0, P, jt.logp[:, :, None])
        tdt = t[:, None, None] + dt
        ready = vms.emitted & ~vms.done & (tdt >= vms.busy_until)
        sat = (vms.send_done >= vms.send_need) & (vms.recv_done >= vms.recv_need)
        # IP2P / LOG / RESET never block; COMPUTE blocks on busy only
        nonblock = (
            (opc == OP["IP2P"]) | (opc == OP["LOG"]) | (opc == OP["RESET"])
            | (opc == OP["COMPUTE"])
        )
        complete = ready & (sat | nonblock) & live_m[:, None, None]
        is_comm = ~(
            (opc == OP["COMPUTE"]) | (opc == OP["LOG"]) | (opc == OP["RESET"])
            | (opc == OP["END"])
        )
        blocked = (
            vms.emitted & ~vms.done & ~complete & (tdt >= vms.busy_until)
            & is_comm & live_m[:, None, None]
        )
        comm_time = vms.comm_time + torch.where(blocked, dt_f, zero_f)

        rnd2 = torch.where(complete, vms.rnd + 1, vms.rnd)
        advance = complete & (rnd2 >= nr)
        pc2 = torch.where(advance, vms.pc + 1, vms.pc)
        rnd2 = torch.where(advance, 0, rnd2)
        emitted2 = vms.emitted & ~complete
        opc_next = gather_op(jt.ops, pc2)[..., 0]
        done2 = vms.done | (opc_next == OP["END"])
        vms = vms._replace(
            pc=pc2, rnd=rnd2, emitted=emitted2, done=done2, comm_time=comm_time
        )

        # --- 6. window rotation (per member) ---
        win_t = torch.floor((t + dt) / net.window_us).to(i32)
        rotate = (win_t > metrics.win_idx) & live_m  # (B,)
        wi = torch.clamp(metrics.win_idx, max=W - 1)
        hit = rotate[:, None] & (win_ids[None, :] == wi[:, None])  # (B, W)
        router_wins = torch.where(
            hit[:, :, None, None], router_win[:, None], metrics.router_wins)
        router_win = torch.where(rotate[:, None, None], zero_f, router_win)
        win_idx = metrics.win_idx + rotate.to(i32)

        metrics = metrics._replace(
            lat_hist=lat_hist, lat_sum=lat_sum, lat_cnt=lat_cnt,
            lat_min=lat_min, lat_max=lat_max,
            link_bytes=link_bytes, router_win=router_win,
            router_wins=router_wins, win_idx=win_idx,
        )
        if mark is not None:
            mark("account")

        # --- 7. event-driven time skip (PDES hybrid): when the network is
        # empty and every live rank is inside a COMPUTE delay (or its job
        # has not arrived yet), jump to the earliest wake-up (clamped to
        # the next metrics window).
        any_active = pool.active.any(dim=1)  # (B,)
        started = t[:, None] >= jt.start  # (B, J)
        live_r = ~vms.done
        can_act = (started[:, :, None] & live_r & ~vms.emitted).flatten(1).any(1) \
            | (live_r & vms.emitted & (vms.busy_until <= tdt)).flatten(1).any(1)
        waiting_busy = live_r & vms.emitted & (vms.busy_until > tdt)
        min_busy = torch.where(waiting_busy, vms.busy_until, inf_f).flatten(1) \
            .amin(dim=1)
        # a job still pending arrival wakes the sim at its start time
        pend = ~started & live_r.any(dim=2)
        min_busy = torch.minimum(
            min_busy, torch.where(pend, jt.start, inf_f).amin(dim=1))
        if windowed:
            # the window cap is a wake-up too (a job about to be admitted)
            min_busy = torch.minimum(min_busy, t_cap)
        if ur_state is not None:
            min_busy = torch.minimum(min_busy, ur_state.next_t.amin(dim=1))
        next_window = (win_idx.to(f32) + 1.0) * net.window_us
        skip_to = torch.minimum(min_busy, next_window)
        idle = ~any_active & ~can_act & torch.isfinite(skip_to)
        if windowed:
            # a member whose last job just completed must not jump ahead:
            # the scheduler reads its ``t`` as "now" when it starts queued
            # jobs on the freed nodes (without a window the run ends there)
            all_done_m = vms.done.flatten(1).all(1) & ~any_active
            idle = idle & ~(all_done_m & torch.isfinite(t_cap))
        t_new = torch.where(idle, torch.maximum(t + dt, skip_to), t + dt)
        t_out = torch.where(live_m, t_new, t)

        # --- 8. sim-plane probes (compiled in only when configured) ---
        probes_st = state.probes
        if probes is not None:
            probes_st = sample_probes(
                probes_st, probes,
                t_new=t_out, live_m=live_m,
                link_bytes=metrics.link_bytes,
                pool_active=pool.active, pool_job=pool.job,
                pool_inject_t=pool.inject_t, free_top=pool.free_top,
                level_mask=probe_level_mask, level_bw=probe_level_bw,
                n_apps=n_apps, pool_size=M,
            )
        rng_out = torch.where(live_m, (rng2 + 1) & MASK32, rng)
        if mark is not None:
            mark("skip")

        return SimState(
            t=t_out, vms=vms, ur=ur_state, pool=pool,
            metrics=metrics, rng=rng_out,
            jobs=jt, ur_nodes=state.ur_nodes, probes=probes_st,
            hist=hist_st, faults=state.faults,
        )

    # ------------------------------------------------------------------
    def init_state(
        seed: int = 1,
        placements: Optional[Sequence[np.ndarray]] = None,
        start_us: Optional[Sequence[float]] = None,
        jobs_override: Optional[Sequence[JobSpec]] = None,
        rank_slowdown_override: Optional[Sequence[np.ndarray]] = None,
        faults: Optional[FaultState] = None,
    ) -> SimState:
        """Build one member's initial state on the engine's device.

        ``placements`` (the jobs' rank2node arrays, plus UR's as the final
        entry when a UR source exists) overrides the build-time
        placements; ``start_us`` overrides per-job arrival offsets;
        ``seed`` sets the engine RNG; ``jobs_override`` swaps in another
        job set that fits the capacity envelope;
        ``rank_slowdown_override`` gives per-job rank slowdowns;
        ``faults`` sets the member's runtime fault mask (default healthy).
        Stack member states with
        :func:`stack_members` and pass the batch to ``run``.
        """
        js = list(jobs_override) if jobs_override is not None else list(jobs)
        table = pack_jobs(
            js, cap,
            placements=placements[: len(js)] if placements is not None else None,
            start_us=start_us, rank_slowdown=rank_slowdown_override,
            device=dev,
        )
        P_np = table.P.cpu().numpy()
        ops_np = table.ops.cpu().numpy()
        ranks = np.arange(Pmax, dtype=np.int32)[None, :]
        done0 = (ranks >= P_np[:, None]) | (
            ops_np[:, 0, 0] == OP["END"]
        )[:, None]

        def z(dtype=i32):
            return torch.zeros((J, Pmax), dtype=dtype, device=dev)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        vms = VMState(
            pc=z(), rnd=z(), emitted=z(torch.bool), busy_until=z(f32),
            send_need=z(), send_done=z(), recv_need=z(), recv_done=z(),
            comm_time=z(f32), done=torch.as_tensor(done0, device=dev),
        )
        ur_state = None
        ur_nodes = None
        if ur is not None:
            ur_state = URState(
                next_t=full((Pu,), float(ur.start_us), f32),
                count=torch.zeros((Pu,), dtype=i32, device=dev),
            )
            ur_nodes = torch.as_tensor(
                np.asarray(placements[len(js)], np.int32)
                if placements is not None and len(placements) > len(js)
                else ur_r2n, device=dev)
        pool = PoolState(
            active=torch.zeros((M,), dtype=torch.bool, device=dev),
            src_rank=torch.zeros((M,), dtype=i32, device=dev),
            dst_rank=torch.zeros((M,), dtype=i32, device=dev),
            job=torch.zeros((M,), dtype=i32, device=dev),
            size=torch.zeros((M,), dtype=f32, device=dev),
            bytes_rem=torch.zeros((M,), dtype=f32, device=dev),
            inject_t=torch.zeros((M,), dtype=f32, device=dev),
            min_arrive=torch.zeros((M,), dtype=f32, device=dev),
            routes=full((M, RW), -1, i32),
            free_stack=torch.arange(M, dtype=i32, device=dev),
            free_top=full((), M, i32),
            dropped=full((), 0, i32),
        )
        metrics = Metrics(
            lat_hist=torch.zeros((n_apps, BINS), dtype=i32, device=dev),
            lat_sum=torch.zeros((n_apps,), dtype=f32, device=dev),
            lat_min=full((n_apps,), math.inf, f32),
            lat_max=full((n_apps,), -math.inf, f32),
            lat_cnt=torch.zeros((n_apps,), dtype=i32, device=dev),
            link_bytes=torch.zeros((L + 1,), dtype=f32, device=dev),
            router_win=torch.zeros((n_apps, R), dtype=f32, device=dev),
            router_wins=torch.zeros((W, n_apps, R), dtype=f32, device=dev),
            win_idx=full((), 0, i32),
            peak_inject=full((), 0.0, f32),
        )
        if faults is None:
            faults = FaultState(np.ones((L,), np.float32),
                                np.ones((R,), np.float32))
        flt = FaultState(*[
            torch.as_tensor(np.asarray(x.cpu() if isinstance(
                x, torch.Tensor) else x, np.float32), device=dev)
            for x in faults])
        if tuple(flt.link_bw_factor.shape) != (L,) \
                or tuple(flt.router_factor.shape) != (R,):
            raise ValueError(
                f"faults shapes {tuple(flt.link_bw_factor.shape)}/"
                f"{tuple(flt.router_factor.shape)} do not match fabric "
                f"(L={L}, R={R})")
        return SimState(
            t=full((), 0.0, f32), vms=vms, ur=ur_state, pool=pool,
            metrics=metrics, rng=full((), int(seed) & MASK32, i64),
            jobs=table, ur_nodes=ur_nodes,
            probes=(init_probes(probes, probe_n_levels, n_apps, device=dev)
                    if probes is not None else None),
            hist=(init_hist(hist, n_apps, hist_n_levels, device=dev)
                  if hist is not None else None),
            faults=flt,
        )

    # ------------------------------------------------------------------
    # run and run_window: the ticks of a chunk (or window) as replays of a
    # captured graph on the card, eager on the CPU
    # ------------------------------------------------------------------
    def capture(state: SimState, n: int, step, finish, flag,
                **buffers) -> _TickGraph:
        """Capture ``n`` calls of ``step`` on a state of this shape as a
        CUDA graph over static buffers (a copy of ``state``): the steps,
        then the last state copied back into the buffers and ``finish``
        of it, which writes ``flag``. A failure to capture raises."""
        with _CAPTURE_LOCK:
            return _capture(state, n, step, finish, flag, **buffers)

    def _capture(state, n, step, finish, flag, **buffers) -> _TickGraph:
        static = _tree_map(torch.clone, state)
        # one eager step first, its result dropped: it builds the kernels
        # and sets up the libraries the tick calls, which must not happen
        # while a graph is captured
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        calls0, launches0 = dict(KOPS.CALLS), dict(KOPS.LAUNCHES)
        # captured on a stream of this engine's device (torch's default
        # capture stream lies on the device of the process's first
        # capture), with unsafe calls barred in this thread only: the
        # replicas on other cards replay meanwhile (``Engine.prun``)
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            t0 = time.perf_counter()
            s = static
            for _ in range(n):
                s = step(s)
            for dst, src in zip(_leaves(static), _leaves(s)):
                if dst is not src:
                    dst.copy_(src)
            finish(s)
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        return _TickGraph(
            graph=graph, static=static, flag=flag, ticks=n,
            calls={k: KOPS.CALLS[k] - calls0[k] for k in calls0},
            launches={k: KOPS.LAUNCHES[k] - launches0[k] for k in launches0},
            capture_s=t1 - t0, instantiate_s=t2 - t1, **buffers)

    def load_graph(kind, n, state: SimState, graphs, stats: RunStats,
                   make, time_parts: bool = True) -> _TickGraph:
        """The graph of ``kind`` for ``state``'s shape (captured by
        ``make`` on a miss), with ``state`` copied into its buffers. With
        tracing on and ``time_parts``, the graph's traced variant, keyed
        apart, which times the tick's parts."""
        traced = time_parts and tracing()
        key = (kind, n) + tuple(tuple(x.shape) for x in _leaves(state))
        if traced:
            key += ("traced",)
        with span("engine.graph_load", cat="engine", kind=kind,
                  traced=traced) as sp:
            tg = graphs.get(key)
            sp.set(captured=tg is None)
            if tg is None:
                tg = make(state, n, _PartClock(dev) if traced else None)
                graphs[key] = tg
                stats.captured = True
            stats.graph_ticks = n
            stats.capture_s = tg.capture_s
            stats.instantiate_s = tg.instantiate_s
            stats.graph_calls, stats.graph_launches = tg.calls, tg.launches
            for dst, src in zip(_leaves(tg.static), _leaves(state)):
                dst.copy_(src)
        return tg

    def capture_run(state: SimState, n: int,
                    clock: Optional[_PartClock]) -> _TickGraph:
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        step = tick_batched
        if clock is not None:
            def step(s):
                clock.tick()
                return tick_batched(s, mark=clock)

        return capture(state, n, step,
                       lambda s: flag.copy_(live(s).any()), flag,
                       clock=clock)

    def replay(tg: _TickGraph, reps: int, stats: RunStats, more) -> None:
        """Replay ``tg``'s graph ``reps`` times between host reads of
        ``more()`` until it says stop; the replays' CUDA-event time goes
        into ``stats``, and a traced graph's part times after each
        read."""
        events = []
        while True:
            with span("engine.chunk", cat="engine", replays=reps) as sp:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    tg.graph.replay()
                b.record()
                events.append((a, b))
                stats.replays += reps
                stats.liveness_reads += 1
                go = more()
                if tg.clock is not None:
                    tg.clock.read(stats)
                    sp.set(device_ms=a.elapsed_time(b))
            if not go:
                break
        stats.replay_device_ms = sum(a.elapsed_time(b) for a, b in events)

    def clone_out(tg: _TickGraph) -> SimState:
        # a copy: the next call overwrites the static buffers
        with span("engine.unstack", cat="engine",
                  members=int(tg.static.t.shape[0])):
            return _tree_map(torch.clone, tg.static)

    def run_graphs(state: SimState, chunk: int, graphs, stats: RunStats,
                   time_parts: bool) -> SimState:
        n = math.gcd(chunk, GRAPH_TICKS)
        tg = load_graph("run", n, state, graphs, stats, capture_run,
                        time_parts)
        stats.liveness_reads += 1
        if bool(live(tg.static).any()):
            replay(tg, chunk // n, stats, lambda: bool(tg.flag))
        stats.ticks = stats.replays * n
        return clone_out(tg)

    def run_batched(state: SimState, chunk: int, graphs, stats: RunStats,
                    time_parts: bool):
        if dev.type == "cuda":
            return run_graphs(state, chunk, graphs, stats, time_parts)
        while True:
            stats.liveness_reads += 1
            if not bool(live(state).any()):
                return state
            with span("engine.chunk", cat="engine", ticks=chunk):
                for _ in range(chunk):
                    state = tick_batched(state)
            stats.ticks += chunk

    def stopped(s: SimState, t_stop, n0):
        return window_stopped(s, t_stop, n0, horizon_us)

    def capture_window(state: SimState, n: int,
                       clock: Optional[_PartClock]) -> _TickGraph:
        B = state.t.shape[0]
        t_stop = torch.full((B,), math.inf, dtype=f32, device=dev)
        n0 = done_slots(state).clone()
        flag = torch.zeros((2,), dtype=i64, device=dev)

        def step(s):
            if clock is not None:
                clock.tick()
            stop = stopped(s, t_stop, n0)
            flag[1:].add_((~stop).any().to(i64))  # a tick with a member live
            return tick_batched(s, t_stop, stop_m=stop, mark=clock)

        def finish(s):
            flag[:1].copy_((~stopped(s, t_stop, n0)).any().to(i64))

        return capture(state, n, step, finish, flag, t_stop=t_stop, n0=n0,
                       clock=clock)

    def window_graphs(state: SimState, t_stop, graphs,
                      stats: RunStats) -> SimState:
        n = GRAPH_TICKS
        tg = load_graph("window", n, state, graphs, stats, capture_window)
        tg.t_stop.copy_(t_stop)
        tg.n0.copy_(done_slots(tg.static))
        tg.flag.zero_()
        stats.liveness_reads += 1
        if bool((~stopped(tg.static, tg.t_stop, tg.n0)).any()):
            def more():
                go, stats.live_ticks = tg.flag.tolist()
                return go

            replay(tg, 1, stats, more)
        stats.ticks = stats.replays * n
        return clone_out(tg)

    def window_batched(state: SimState, t_stop, graphs, stats: RunStats):
        B = state.t.shape[0]
        t_stop = torch.as_tensor(np.broadcast_to(
            np.asarray(t_stop, np.float32), (B,)).copy(), device=dev)
        if dev.type == "cuda":
            return window_graphs(state, t_stop, graphs, stats)
        n0 = done_slots(state)
        while True:
            stop = stopped(state, t_stop, n0)
            stats.liveness_reads += 1
            if bool(stop.all()):
                return state
            state = tick_batched(state, t_stop, stop_m=stop)
            stats.ticks += 1
            stats.live_ticks += 1

    return Engine(
        init_state=init_state,
        tick=_member_batched(tick_batched),
        capacity=cap,
        device=dev,
        run_fn=_member_batched(run_batched),
        window_fn=_member_batched(window_batched),
    )


# ---------------------------------------------------------------------------
# process-wide engine cache: one engine per (capacity envelope, system
# config, device). Job tables are runtime data, so every caller at the same
# envelope and config (scenarios, member batches, the scheduler's windows)
# shares one engine and, through it, its captured graphs (an engine bound
# to a scenario's jobs shares them too).
# ---------------------------------------------------------------------------

_ENGINE_CACHE: "OrderedDict[Tuple, Engine]" = OrderedDict()
_ENGINE_CACHE_STATS = {"hits": 0, "misses": 0, "builds": 0, "evictions": 0}
# LRU bound on the cache (:func:`set_engine_cache_limit`): ``None``
# (default, or the environment's ``REPRO_ENGINE_CACHE_MAX`` read at import)
# is unbounded; a long-lived process (the ``repro_torch.union.serve``
# server) caps it so that device memory stays bounded. A rebuild after
# eviction gives the same bits: the key holds every input the engine bakes.
_ENGINE_CACHE_MAX: Optional[int] = (
    int(os.environ["REPRO_ENGINE_CACHE_MAX"])
    if os.environ.get("REPRO_ENGINE_CACHE_MAX") else None
)


def _cache_gauges() -> None:
    """Mirror the cache's size and limit into the process metrics
    registry."""
    reg = get_registry()
    reg.gauge("engine_cache_size",
              "compiled engines held by the process-wide cache").set(
        len(_ENGINE_CACHE))
    limit = reg.gauge("engine_cache_limit",
                      "LRU cap on the engine cache (0 = unbounded)")
    limit.set(0 if _ENGINE_CACHE_MAX is None else _ENGINE_CACHE_MAX)


def _evict_to_limit() -> None:
    ev = get_registry().counter(
        "engine_cache_evictions",
        "engines dropped by the LRU cap (rebuilt on next request)")
    while (_ENGINE_CACHE_MAX is not None
           and len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX):
        _, eng = _ENGINE_CACHE.popitem(last=False)
        eng.drop_graphs()
        _ENGINE_CACHE_STATS["evictions"] += 1
        ev.inc()


def set_engine_cache_limit(limit: Optional[int]) -> Optional[int]:
    """Cap the process-wide engine cache at ``limit`` entries (LRU
    eviction; ``None`` removes the cap). Returns the previous limit. An
    evicted engine drops its captured graphs and rebuilds, with the same
    bits, on its next request."""
    global _ENGINE_CACHE_MAX
    if limit is not None and limit < 1:
        raise ValueError("engine cache limit must be >= 1 (or None)")
    prev = _ENGINE_CACHE_MAX
    _ENGINE_CACHE_MAX = limit
    _evict_to_limit()
    _cache_gauges()
    return prev


def engine_cache_key(
    topo: Fabric,
    *,
    routing: str = "ADP",
    ur: Optional[URSpec] = None,
    net: Optional[NetConfig] = None,
    pool_size: Optional[int] = None,
    horizon_us: float = 500_000.0,
    capacity: EngineCapacity,
    device=None,
    probes: Optional[ProbeConfig] = None,
    hist: Optional[HistConfig] = None,
) -> Tuple:
    """Everything an engine bakes in besides the job tables: the fabric's
    ``cache_key()``, the routing mode, the UR source's shape (its
    placement is per-member init data), the net config, pool size,
    horizon, capacity envelope, the device (CUDA's with its index) and the
    observers. Fault masks are runtime data and not in the key."""
    net = net or NetConfig()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ur_key = None if ur is None else (
        int(ur.rank2node.shape[0]), float(ur.size_bytes),
        float(ur.interval_us), float(ur.start_us),
    )
    return (
        topo.cache_key(), routing.upper() in ("ADP", "ADAPTIVE"), ur_key,
        net, int(pool_size or net.pool_size), float(horizon_us), capacity,
        str(dev), probes, hist,
    )


def get_engine(
    topo: Fabric,
    *,
    routing: str = "ADP",
    ur: Optional[URSpec] = None,
    net: Optional[NetConfig] = None,
    pool_size: Optional[int] = None,
    horizon_us: float = 500_000.0,
    capacity: EngineCapacity,
    device=None,
    probes: Optional[ProbeConfig] = None,
    hist: Optional[HistConfig] = None,
) -> Engine:
    """An engine from the process-wide cache (built on a miss).

    Cached engines are built with an **empty default job set**: callers
    pass their jobs at init time (``init_state(jobs_override=...)``, and
    the UR placement as the final ``placements`` entry) or admit them
    (:func:`admit_job`). :func:`build_engine` stays the uncached primitive.
    """
    key = engine_cache_key(
        topo, routing=routing, ur=ur, net=net, pool_size=pool_size,
        horizon_us=horizon_us, capacity=capacity, device=device,
        probes=probes, hist=hist,
    )
    eng = _ENGINE_CACHE.get(key)
    if eng is not None:
        _ENGINE_CACHE_STATS["hits"] += 1
        _ENGINE_CACHE.move_to_end(key)  # LRU: a hit is a use
        return eng
    _ENGINE_CACHE_STATS["misses"] += 1
    _ENGINE_CACHE_STATS["builds"] += 1
    eng = build_engine(
        topo, [], routing=routing, ur=ur, net=net, pool_size=pool_size,
        horizon_us=horizon_us, capacity=capacity, device=key[7],
        probes=probes, hist=hist,
    )
    # its replicas on other devices: the cached engines of this envelope
    eng.replica = lambda dev: get_engine(
        topo, routing=routing, ur=ur, net=net, pool_size=pool_size,
        horizon_us=horizon_us, capacity=capacity, device=dev,
        probes=probes, hist=hist)
    _ENGINE_CACHE[key] = eng
    _evict_to_limit()
    _cache_gauges()
    return eng


def engine_cache_stats() -> Dict[str, int]:
    """Hit, miss, build and eviction counts, the current size and the LRU
    limit (-1 = unbounded) of the process-wide cache."""
    return dict(
        _ENGINE_CACHE_STATS, size=len(_ENGINE_CACHE),
        limit=-1 if _ENGINE_CACHE_MAX is None else _ENGINE_CACHE_MAX,
    )


def clear_engine_cache() -> None:
    """Drop every cached engine and its captured graphs, and zero the
    counters."""
    for eng in _ENGINE_CACHE.values():
        eng.drop_graphs()
    _ENGINE_CACHE.clear()
    _ENGINE_CACHE_STATS.update(hits=0, misses=0, builds=0, evictions=0)


# ---------------------------------------------------------------------------
# state accessors
# ---------------------------------------------------------------------------

def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def job_vm(state: SimState, ji: int) -> VMState:
    """Job ``ji``'s VM state of a member state, trimmed to its real ranks
    (numpy leaves)."""
    P = int(state.jobs.P[ji])
    return VMState(*[_host(x[ji])[:P] for x in state.vms])


def job_done(state: SimState, ji: int) -> bool:
    return bool(job_vm(state, ji).done.all())


def member_state(batched_state: SimState, i: int) -> SimState:
    """Unstack member ``i`` of a batched state."""
    return _tree_map(lambda x: x[i], batched_state)


def stack_members(states: Sequence[SimState]) -> SimState:
    """Stack member states into one batch (leading member dim)."""
    return _tree_map(lambda *xs: torch.stack(xs), *states)


def state_to(state: SimState, device) -> SimState:
    """``state`` with every leaf on ``device`` (itself where they are)."""
    return _tree_map(lambda x: x.to(device), state)


# ---------------------------------------------------------------------------
# job-slot admit/retire (the online scheduler's state surgery between
# windows, on the host). A vacant slot has ``start == inf``, as
# ``pack_jobs`` pads unused capacity and ``retire_job`` leaves a finished
# slot; a retired slot's VMs are all done and its program is END-only, so
# it is inert to the other jobs' trajectories (the chained-window tests pin
# this). Surgery builds the new rows in numpy and writes them with one
# indexed write per leaf into a new tensor: states stay values.
# ---------------------------------------------------------------------------

def vacant_slots(state: SimState) -> np.ndarray:
    """Indices of the vacant job slots of a member state."""
    return np.flatnonzero(np.isinf(_host(state.jobs.start)))


def slot_done(state: SimState, slot: int) -> bool:
    """Every rank of ``slot`` has reached END (its program finished)."""
    return bool(state.vms.done[slot].all())


def slot_in_flight(state: SimState, slot: int) -> bool:
    """``slot`` still owns active pool messages. A slot must drain before
    it is recycled: a reused slot id would credit in-flight deliveries to
    the new tenant."""
    return bool((state.pool.active & (state.pool.job == slot)).any())


class WindowView(NamedTuple):
    """What the scheduler reads between windows, fetched with one wait for
    the device (:func:`window_host_view`). Per-member shapes (``(J,)``,
    ``(J, Pmax)``) or with a leading batch dim; host numpy arrays."""

    t: np.ndarray          # () | (B,)       float32 virtual clock
    slot_done: np.ndarray  # (J,) | (B, J)   every rank at END
    in_flight: np.ndarray  # (J,) | (B, J)   slot owns active pool msgs
    lat_sum: np.ndarray    # per-slot latency sums (metrics app axis)
    lat_cnt: np.ndarray    # per-slot delivered-message counts
    comm_time: np.ndarray  # (J, Pmax) | (B, J, Pmax) per-rank comm time

    def member(self, i: int) -> "WindowView":
        """Member ``i``'s rows of a batched view (no further transfers)."""
        return WindowView(*(a[i] for a in self))


def _fetch(*xs: torch.Tensor):
    """Host numpy copies of tensors, with one wait for the device."""
    if xs[0].device.type != "cuda":
        return [x.numpy().copy() for x in xs]
    outs = [x.to("cpu", non_blocking=True) for x in xs]  # pinned copies
    torch.cuda.current_stream(xs[0].device).synchronize()
    return [o.numpy() for o in outs]


def window_host_view(state: SimState) -> WindowView:
    """The scheduler's per-window host view of a member or batched state:
    six leaves fetched at once, the slot masks then computed on the host."""
    t, done, active, job, lat_sum, lat_cnt, comm = _fetch(
        state.t, state.vms.done, state.pool.active, state.pool.job,
        state.metrics.lat_sum, state.metrics.lat_cnt, state.vms.comm_time)
    slot_done_m = done.all(axis=-1)
    J = done.shape[-2]
    in_flight = np.zeros(slot_done_m.shape, bool)
    sel = active & (job < J)  # UR traffic uses the extra app id J
    if slot_done_m.ndim == 1:
        in_flight[job[sel]] = True
    else:
        b_idx = np.broadcast_to(
            np.arange(job.shape[0])[:, None], job.shape)[sel]
        in_flight[b_idx, job[sel]] = True
    return WindowView(t, slot_done_m, in_flight, lat_sum, lat_cnt, comm)


def _slot_rows(specs: Sequence[Optional[JobSpec]], J: int, OPmax: int,
               Pmax: int, slots: Sequence[int]):
    """Job-table rows and VM ``done`` rows for slots that take ``specs``
    (None: vacated), as numpy arrays with a leading row axis."""
    K = len(specs)
    ops = np.zeros((K, OPmax, 4), np.int32)
    ops[:, :, 0] = OP["END"]
    grid = np.zeros((K, OPmax, 4), np.int32)
    P = np.ones((K,), np.int32)
    logp = np.ones((K,), np.int32)
    r2n = np.zeros((K, Pmax), np.int32)
    slow = np.ones((K, Pmax), np.float32)
    start = np.full((K,), np.inf, np.float32)
    done = np.ones((K, Pmax), bool)
    for k, (spec, slot) in enumerate(zip(specs, slots)):
        if not 0 <= slot < J:
            raise ValueError(f"slot {slot} outside envelope Jmax={J}")
        if spec is None:
            continue
        sk = spec.skeleton
        if sk.n_ranks > Pmax or sk.n_ops > OPmax:
            raise ValueError(
                f"job {spec.name!r} ({sk.n_ranks} ranks, {sk.n_ops} ops) "
                f"exceeds engine capacity (Pmax={Pmax}, OPmax={OPmax})"
            )
        ops[k, : sk.n_ops] = sk.ops
        grid[k, : sk.n_ops] = sk.grid
        P[k] = sk.n_ranks
        logp[k] = _ceil_log2(sk.n_ranks)
        r2n[k, : sk.n_ranks] = np.asarray(spec.rank2node, np.int32)
        start[k] = np.float32(spec.start_us)
        done[k] = np.arange(Pmax) >= sk.n_ranks
    return JobTable(ops, grid, P, logp, r2n, slow, start), done


def _write_slots(state: SimState, idx, table: JobTable,
                 done: np.ndarray) -> SimState:
    """A new state whose job slots at ``idx`` (index arrays: slots, or
    members and slots) hold ``table``'s rows and fresh VM rows."""
    dev = state.t.device
    idx = tuple(torch.as_tensor(np.asarray(i, np.int64), device=dev)
                for i in idx)

    def put(leaf, rows):
        return leaf.index_put(idx, torch.as_tensor(rows, device=dev))

    jobs = JobTable(*[put(leaf, rows) for leaf, rows in zip(state.jobs,
                                                           table)])
    vms = VMState(*[
        put(leaf, done) if name == "done"
        else leaf.index_put(idx, torch.zeros(
            (len(done),) + tuple(leaf.shape[-1:]), dtype=leaf.dtype,
            device=dev))
        for name, leaf in zip(VMState._fields, state.vms)])
    return state._replace(jobs=jobs, vms=vms)


def admit_jobs(state: SimState,
               admits: Sequence[Tuple[int, int, JobSpec]]) -> SimState:
    """Write many jobs into vacant slots of a **batched** state at once:
    ``admits`` is ``[(member, slot, spec), ...]`` with distinct
    ``(member, slot)`` pairs (so the writes are deterministic), one
    indexed write per state leaf. Envelope checks run here; vacancy is the
    caller's bookkeeping."""
    if not admits:
        return state
    jt = state.jobs
    J, OPmax, Pmax = jt.ops.shape[-3], jt.ops.shape[-2], jt.r2n.shape[-1]
    table, done = _slot_rows([a[2] for a in admits], J, OPmax, Pmax,
                             [a[1] for a in admits])
    return _write_slots(state, ([a[0] for a in admits],
                                [a[1] for a in admits]), table, done)


def retire_jobs(state: SimState,
                retires: Sequence[Tuple[int, int]]) -> SimState:
    """Vacate many ``(member, slot)`` pairs of a **batched** state at once,
    the multi-member :func:`retire_job`. Done and drained checks are the
    caller's (the scheduler has just read both masks)."""
    if not retires:
        return state
    jt = state.jobs
    J, OPmax, Pmax = jt.ops.shape[-3], jt.ops.shape[-2], jt.r2n.shape[-1]
    table, done = _slot_rows([None] * len(retires), J, OPmax, Pmax,
                             [s for _, s in retires])
    return _write_slots(state, ([m for m, _ in retires],
                                [s for _, s in retires]), table, done)


def occupied_node_mask(state: SimState, n_nodes: int) -> np.ndarray:
    """(n_nodes,) bool: the nodes held by the non-vacant slots of a member
    state, the free-node accounting the scheduler places against."""
    occ = np.zeros((n_nodes,), bool)
    start, P, r2n = _fetch(state.jobs.start, state.jobs.P, state.jobs.r2n)
    for j in np.flatnonzero(np.isfinite(start)):
        occ[r2n[j, : int(P[j])]] = True
    return occ


def admit_job(state: SimState, slot: int, spec: JobSpec,
              checked: bool = True) -> SimState:
    """Write ``spec`` into vacant job ``slot`` of a member state: its
    program, placement and arrival rows and fresh VM rows (padded ranks
    born done); the other slots are untouched. The job idles until
    ``spec.start_us``. ``checked=False`` skips the vacancy check (a device
    read) for callers whose own bookkeeping tracks the slots."""
    jt = state.jobs
    J, OPmax, Pmax = jt.ops.shape[0], jt.ops.shape[1], jt.r2n.shape[1]
    if checked and 0 <= slot < J and not math.isinf(float(jt.start[slot])):
        raise ValueError(f"slot {slot} is occupied (start="
                         f"{float(jt.start[slot])}); retire it first")
    table, done = _slot_rows([spec], J, OPmax, Pmax, [slot])
    return _write_slots(state, ([slot],), table, done)


def retire_job(state: SimState, slot: int, checked: bool = True) -> SimState:
    """Vacate job ``slot`` of a member state: END-only program,
    ``start=inf``, all-done VMs. The slot must have finished
    (``slot_done``) and drained (``not slot_in_flight``); ``checked=False``
    skips those two device reads for callers that just read the masks
    from :func:`window_host_view`."""
    jt = state.jobs
    J, OPmax, Pmax = jt.ops.shape[0], jt.ops.shape[1], jt.r2n.shape[1]
    if checked and 0 <= slot < J:
        if not slot_done(state, slot):
            raise ValueError(
                f"slot {slot} has unfinished ranks; cannot retire")
        if slot_in_flight(state, slot):
            raise ValueError(f"slot {slot} still has in-flight messages; "
                             "drain before retiring")
    table, done = _slot_rows([None], J, OPmax, Pmax, [slot])
    return _write_slots(state, ([slot],), table, done)
