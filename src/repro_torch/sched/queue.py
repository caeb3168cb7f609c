"""Pending-queue state and policies: FCFS, EASY and conservative backfill.

The queue is plain host-side state (scheduling decisions happen between
engine windows). Two resources bound admission: free **nodes** (the
fabric's) and free engine **job slots** (the compiled envelope's
``Jmax``); every job uses one slot and ``n_ranks`` nodes.

* **FCFS** starts the arrival-order prefix that fits; the head of the
  queue blocks everything behind it.
* **EASY backfill** (Mu'alem & Feitelson) gives the blocked head a
  *reservation*: the shadow time when, by the running jobs' user
  estimates, enough nodes and a slot will be free. Any later job may jump
  the queue iff it fits now and either (a) its estimated completion is
  before the shadow time, or (b) it only uses nodes/slots the head won't
  need then ("extra"). The head's reserved start is never delayed —
  :func:`simulate_queue` plus the hypothesis property test pin this.
* **Conservative backfill** gives *every* queued job a reservation, in
  arrival order, against the estimate-driven resource profile (running
  jobs' releases plus earlier reservations' holds). A job starts now only
  when its earliest feasible start *is* now — so no backfill ever delays
  any earlier-arrived job's reserved start, not just the head's.
  Reservations are recomputed from the profile at every decision point
  (the classic formulation): actual completions come in at or before the
  estimates, so recomputation only moves reserved starts earlier.

Wait/slowdown accounting lives with the records the scheduler keeps; the
queue only decides *who starts now*.
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

POLICIES = ("fcfs", "easy", "conservative")


@dataclass
class QueuedJob:
    """A pending arrival, as the queue sees it."""

    jid: int  # trace order (stable tiebreak)
    name: str
    n_ranks: int
    arrival_us: float
    est_runtime_us: float
    payload: Any = None  # scheduler-side resolution (skeleton etc.)


@dataclass
class Reservation:
    """The head-of-queue job's EASY reservation at one decision point."""

    jid: int
    shadow_us: float  # reserved start (by running jobs' estimates)
    extra_nodes: int  # free-now nodes the head won't need at shadow time
    extra_slots: int


@dataclass
class PendingQueue:
    """Arrival-ordered pending jobs plus the admission policy."""

    policy: str = "fcfs"
    jobs: List[QueuedJob] = field(default_factory=list)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown queue policy {self.policy!r}; expected one of "
                f"{POLICIES}"
            )

    def push(self, job: QueuedJob) -> None:
        self.jobs.append(job)

    def __len__(self) -> int:
        return len(self.jobs)

    def __bool__(self) -> bool:
        return bool(self.jobs)

    def select(
        self,
        now: float,
        free_nodes: int,
        free_slots: int,
        running: Sequence[Tuple[float, int]],
    ) -> Tuple[List[QueuedJob], Optional[Reservation]]:
        """Pop the jobs that start *now*; return them plus the head's
        reservation (EASY, when the head is blocked).

        ``running`` lists ``(est_end_us, n_ranks)`` of currently running
        jobs — the estimate base for the shadow-time computation.

        The arrival-order prefix is computed as an array program over the
        rank table (cumulative demand vs free capacity). Backfill (EASY's
        shadow window, conservative's per-job reservations) is inherently
        sequential in decision order and stays host-side — the batched
        trace driver interleaves those decisions across cells between
        shared engine windows instead of vectorizing them.
        """
        if self.policy == "conservative":
            return self._select_conservative(
                now, free_nodes, free_slots, running)
        # both policies start the runnable arrival-order prefix; as an
        # array program over the rank table: job i starts iff every job
        # up to and including i fits, i.e. the cumulative rank demand
        # stays within free_nodes and i is within the free slot budget
        k = 0
        if self.jobs and free_slots >= 1:
            ranks = np.fromiter(
                (j.n_ranks for j in self.jobs), np.int64, len(self.jobs))
            ok = (np.cumsum(ranks) <= free_nodes) & (
                np.arange(len(ranks)) < free_slots)
            k = len(ranks) if ok.all() else int(ok.argmin())
        starts: List[QueuedJob] = self.jobs[:k]
        del self.jobs[:k]
        free_slots -= k
        free_nodes -= sum(j.n_ranks for j in starts)
        if not self.jobs or self.policy == "fcfs":
            return starts, None

        # EASY: the head is blocked — reserve its start, then backfill.
        # Started jobs count as running at their estimates.
        run = [(end, n) for end, n in running]
        run += [(now + j.est_runtime_us, j.n_ranks) for j in starts]
        head = self.jobs[0]
        resv = _reservation(head, now, free_nodes, free_slots, run)
        extra_nodes, extra_slots = resv.extra_nodes, resv.extra_slots

        i = 1
        while i < len(self.jobs) and free_slots >= 1:
            cand = self.jobs[i]
            fits_now = cand.n_ranks <= free_nodes
            before_shadow = now + cand.est_runtime_us <= resv.shadow_us
            in_extra = (
                cand.n_ranks <= extra_nodes and extra_slots >= 1
            )
            if fits_now and (before_shadow or in_extra):
                starts.append(self.jobs.pop(i))
                free_slots -= 1
                free_nodes -= cand.n_ranks
                if not before_shadow:
                    # runs past the shadow time: it consumes the head's
                    # spare capacity permanently
                    extra_nodes -= cand.n_ranks
                    extra_slots -= 1
                else:
                    # ends before the shadow: its nodes return in time,
                    # but they are gone from "free now" (updated above)
                    extra_nodes = min(extra_nodes, free_nodes)
            else:
                i += 1
        return starts, resv

    def _select_conservative(
        self,
        now: float,
        free_nodes: int,
        free_slots: int,
        running: Sequence[Tuple[float, int]],
    ) -> Tuple[List[QueuedJob], Optional[Reservation]]:
        """Walk the queue in arrival order, giving every job its earliest
        feasible start against the profile of running jobs' releases and
        earlier jobs' reservations. Jobs whose earliest start is *now*
        start; everything else holds a reservation no later job may
        delay."""
        profile = _Profile(now, free_nodes, free_slots)
        for end, n in running:
            # a job past its estimate still holds its resources — model
            # its release as imminent (strictly after now), never as
            # already free (counting it free would start jobs that don't
            # actually fit and crash the admission path)
            profile.release(end if end > now else now + 1.0, n, 1)
        starts: List[QueuedJob] = []
        head_resv: Optional[Reservation] = None
        i = 0
        while i < len(self.jobs):
            job = self.jobs[i]
            t = profile.earliest(job.n_ranks, job.est_runtime_us)
            if t is None:
                raise RuntimeError(
                    f"job {job.name!r} ({job.n_ranks} ranks) can never start"
                )
            if t <= now:
                starts.append(self.jobs.pop(i))
                profile.hold(now, now + job.est_runtime_us, job.n_ranks, 1)
            else:
                profile.hold(t, t + job.est_runtime_us, job.n_ranks, 1)
                if head_resv is None:
                    head_resv = Reservation(
                        jid=job.jid, shadow_us=t,
                        extra_nodes=0, extra_slots=0)
                i += 1
        return starts, head_resv


class _Profile:
    """Estimate-driven (nodes, slots) availability over time: the base
    free pool at ``now`` plus release/hold deltas at later instants."""

    def __init__(self, now: float, free_nodes: int, free_slots: int):
        self.now = now
        self.base = (free_nodes, free_slots)
        # (t, dnodes, dslots), kept sorted so queries never re-sort
        self.deltas: List[Tuple[float, int, int]] = []

    def release(self, t: float, nodes: int, slots: int) -> None:
        if t > self.now:
            insort(self.deltas, (t, nodes, slots))
        else:
            self.base = (self.base[0] + nodes, self.base[1] + slots)

    def hold(self, t0: float, t1: float, nodes: int, slots: int) -> None:
        """Consume resources during [t0, t1)."""
        if t0 <= self.now:
            self.base = (self.base[0] - nodes, self.base[1] - slots)
        else:
            insort(self.deltas, (t0, -nodes, -slots))
        self.release(t1, nodes, slots)

    def _min_avail(self, events, t0: float, t1: float) -> Tuple[int, int]:
        """Minimum (nodes, slots) available over [t0, t1); ``events`` is
        ``self.deltas`` pre-sorted by the caller.

        All deltas at one instant are netted before the running minimum
        updates: a release and a hold at the same ``t`` cancel (intervals
        are half-open, so a job ending at ``t`` and one reserved at ``t``
        never overlap) — folding the hold first would show a transient
        negative dip and spuriously block feasible backfill windows."""
        nodes, slots = self.base
        i = 0
        while i < len(events) and events[i][0] <= t0:
            nodes += events[i][1]
            slots += events[i][2]
            i += 1
        mn_nodes, mn_slots = nodes, slots
        while i < len(events) and events[i][0] < t1:
            t = events[i][0]
            while i < len(events) and events[i][0] == t:
                nodes += events[i][1]
                slots += events[i][2]
                i += 1
            mn_nodes = min(mn_nodes, nodes)
            mn_slots = min(mn_slots, slots)
        return mn_nodes, mn_slots

    def earliest(self, n_ranks: int, est_us: float) -> Optional[float]:
        """Earliest t >= now where (n_ranks nodes, 1 slot) are available
        throughout [t, t + est_us)."""
        events = self.deltas  # maintained sorted by insort
        candidates = [self.now] + [t for t, _, _ in events if t > self.now]
        for t in candidates:
            mn_nodes, mn_slots = self._min_avail(events, t, t + est_us)
            if mn_nodes >= n_ranks and mn_slots >= 1:
                return t
        return None


def _reservation(
    head: QueuedJob,
    now: float,
    free_nodes: int,
    free_slots: int,
    running: Sequence[Tuple[float, int]],
) -> Reservation:
    """Shadow time: walk running jobs by estimated end, accumulating freed
    nodes/slots until the head fits both."""
    nodes, slots, shadow = free_nodes, free_slots, now
    for end, n in sorted(running):
        if nodes >= head.n_ranks and slots >= 1:
            break
        nodes += n
        slots += 1
        shadow = max(shadow, end)
    if nodes < head.n_ranks or slots < 1:
        # not startable even on an empty system — callers validate job
        # sizes up front, so this is a logic error, not a user error
        raise RuntimeError(
            f"job {head.name!r} ({head.n_ranks} ranks) can never start"
        )
    return Reservation(
        jid=head.jid, shadow_us=shadow,
        extra_nodes=nodes - head.n_ranks, extra_slots=slots - 1,
    )


def simulate_queue(
    jobs: Sequence[QueuedJob],
    n_nodes: int,
    n_slots: int,
    policy: str = "fcfs",
) -> Dict[str, Any]:
    """Estimate-driven discrete-event run of the queue alone (no network
    engine): every job's *actual* runtime equals its estimate.

    The analytic mirror of the full scheduler — used by the property
    tests (EASY never delays the head's reserved start) and for quick
    policy comparisons. Returns per-job ``(start_us, end_us)`` plus
    makespan and the reservation log.
    """
    q = PendingQueue(policy=policy)
    pending = sorted(jobs, key=lambda j: (j.arrival_us, j.jid))
    for j in pending:
        if j.n_ranks > n_nodes:
            raise ValueError(f"job {j.name!r} needs {j.n_ranks} > {n_nodes}")
    ai = 0
    now = 0.0
    free_nodes, free_slots = n_nodes, n_slots
    running: List[Tuple[float, int, QueuedJob]] = []  # (end, n, job)
    out: Dict[int, Tuple[float, float]] = {}
    reservations: List[Reservation] = []
    while ai < len(pending) or q or running:
        # 1. arrivals at or before now
        while ai < len(pending) and pending[ai].arrival_us <= now:
            q.push(pending[ai])
            ai += 1
        # 2. completions at or before now
        still = []
        for end, n, job in running:
            if end <= now:
                free_nodes += n
                free_slots += 1
            else:
                still.append((end, n, job))
        running = still
        # 3. starts
        starts, resv = q.select(
            now, free_nodes, free_slots,
            [(end, n) for end, n, _ in running],
        )
        if resv is not None:
            reservations.append(resv)
        for job in starts:
            free_nodes -= job.n_ranks
            free_slots -= 1
            end = now + job.est_runtime_us
            running.append((end, job.n_ranks, job))
            out[job.jid] = (now, end)
        # 4. advance to the next event
        nxt = []
        if running:
            nxt.append(min(end for end, _, _ in running))
        if ai < len(pending):
            nxt.append(pending[ai].arrival_us)
        if not nxt:
            break
        now = max(now, min(nxt))
    spans = {jid: dict(start_us=s, end_us=e) for jid, (s, e) in out.items()}
    return dict(
        spans=spans,
        makespan_us=max((e for _, e in out.values()), default=0.0),
        reservations=reservations,
    )
