"""Sim-time job lifecycle timelines for scheduled (trace) runs.

The host-plane tracer (:mod:`repro_torch.obs.spans`) answers *where does
wall-clock go*; this module answers *what did the scheduler do over
virtual time*: when each trace job arrived, how long it queued, whether
it was backfilled past an earlier arrival, when it ran and when its slot
drained. The scheduler's :class:`~repro_torch.sched.scheduler._CellLoop`
already observes every one of those transitions in both the sequential
and lock-step batched drivers — a :class:`TimelineRecorder` just writes
them down.

Everything recorded is **sim-time only** (µs of virtual time, job ids,
slot ids — never wall clocks), so a batched cell's timeline is
bit-identical to the same cell run sequentially; the batched≡sequential
equality tests cover the timeline payload unchanged.

:func:`sim_chrome_trace` renders cells as a Chrome trace-event JSON:
one *process* per trace cell, one *thread track* per engine slot (job
lifecycle spans land on the slot that ran them), plus a queue-depth
counter track per cell. Since sim time is in µs — Chrome's native trace
unit — Perfetto renders virtual time directly.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _f(x) -> Optional[float]:
    """NaN-safe float for JSON payloads (NaN -> None)."""
    x = float(x)
    return None if math.isnan(x) else x


class TimelineRecorder:
    """Per-cell collector for the scheduler's lifecycle transitions.

    The :class:`~repro_torch.sched.scheduler.JobRecord` table already carries
    arrival / start / finish per job; the recorder adds what the records
    don't keep — backfill decisions, slot-drain (retire) times, and the
    queue-depth series — and assembles the JSON-ready timeline.
    """

    def __init__(self) -> None:
        self.backfilled: Dict[int, bool] = {}   # jid -> started past an
        #                                          earlier-arrived queued job
        self.retire_us: Dict[int, float] = {}   # jid -> slot drained
        self.queue_depth: List[Tuple[float, int]] = []  # (t_us, depth)

    def start(self, jid: int, backfill: bool) -> None:
        self.backfilled[jid] = bool(backfill)

    def retire(self, jid: int, t_us: float) -> None:
        self.retire_us[jid] = float(t_us)

    def sample_queue(self, t_us: float, depth: int) -> None:
        if not self.queue_depth or self.queue_depth[-1][1] != depth:
            self.queue_depth.append((float(t_us), int(depth)))

    def to_dict(self, records: Sequence[Any], slots: int) -> Dict[str, Any]:
        """Assemble the cell timeline from the finalized job records."""
        jobs = []
        for rec in records:
            jobs.append(dict(
                jid=int(rec.jid), name=rec.name, app=rec.app,
                slot=int(rec.slot),
                arrival_us=float(rec.arrival_us),
                start_us=_f(rec.start_us),
                finish_us=_f(rec.finish_us),
                retire_us=self.retire_us.get(rec.jid),
                backfill=self.backfilled.get(rec.jid, False),
                completed=bool(rec.completed),
            ))
        return dict(
            slots=int(slots),
            jobs=jobs,
            queue_depth=[[t, d] for t, d in self.queue_depth],
        )


def sim_chrome_trace(
    named_timelines: Sequence[Tuple[str, Dict[str, Any]]],
) -> Dict[str, Any]:
    """Cell timelines -> a Chrome trace-event payload over *virtual* time.

    ``named_timelines`` is ``[(cell_key, timeline_dict), ...]`` with each
    timeline as produced by :meth:`TimelineRecorder.to_dict` (the
    ``report["timeline"]`` of a trace cell). Layout: one process per
    cell (named by its key), one thread per engine slot — every slot
    gets a metadata event even if idle, so the track-per-slot structure
    is explicit — job lifecycle spans as ``ph: "X"`` on their slot's
    track, and a per-cell ``queue_depth`` counter (``ph: "C"``).
    """
    evs: List[Dict[str, Any]] = []
    for pid, (key, tl) in enumerate(named_timelines):
        evs.append(dict(
            name="process_name", ph="M", pid=pid, tid=0,
            args=dict(name=str(key)),
        ))
        for slot in range(int(tl.get("slots", 0))):
            evs.append(dict(
                name="thread_name", ph="M", pid=pid, tid=slot,
                args=dict(name=f"slot{slot}"),
            ))
        for job in tl.get("jobs", []):
            start = job.get("start_us")
            if start is None:
                continue  # never admitted (horizon-cut) -> no span
            end = job.get("retire_us")
            if end is None:
                end = job.get("finish_us")
            if end is None:
                end = start
            evs.append(dict(
                name=str(job["name"]), cat="job", ph="X",
                ts=float(start), dur=max(float(end) - float(start), 0.0),
                pid=pid, tid=int(job.get("slot", 0)),
                args=dict(
                    jid=job.get("jid"), app=job.get("app"),
                    arrival_us=job.get("arrival_us"),
                    wait_us=float(start) - float(job.get("arrival_us", start)),
                    finish_us=job.get("finish_us"),
                    backfill=bool(job.get("backfill", False)),
                    completed=bool(job.get("completed", False)),
                ),
            ))
        for t_us, depth in tl.get("queue_depth", []):
            evs.append(dict(
                name="queue_depth", ph="C", ts=float(t_us), pid=pid, tid=0,
                args=dict(queued=int(depth)),
            ))
    return dict(
        traceEvents=evs,
        displayTimeUnit="ms",
        otherData=dict(producer="repro_torch.obs", time_domain="sim_us"),
    )


def write_sim_trace(
    path: str,
    named_timelines: Sequence[Tuple[str, Dict[str, Any]]],
) -> str:
    """Write cell timelines as a sim-time Chrome trace. Returns ``path``."""
    with open(path, "w") as f:
        json.dump(sim_chrome_trace(named_timelines), f)
    return path
