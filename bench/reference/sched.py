"""The online scheduler's plain reference: a trace file, a cell's seed and
its queue policy -> every job's record, worked out from the file alone.

The trace file is the JSON that the port's ``Trace.from_dict`` reads
(jobs with an inline ``source`` and ``ranks``, their arrivals and
runtime estimates, the fabric, ``slots`` job slots). One cell runs on
its own, window by window (``engine.Windows``), never in a batch with
other cells:

1. arrivals whose time has come join the queue (with nothing queued,
   running or draining, the next arrival joins early: the engine skips
   to its start);
2. a running job whose ranks are all done frees its nodes; its slot is
   vacated once none of its messages is in flight;
3. the queue policy picks the jobs that start now (FCFS: the arrival-
   order prefix that fits the free nodes and slots; EASY: then a
   reservation for the blocked head from the running jobs' runtime
   estimates, and backfill that does not delay it); each start takes the
   lowest free slot and random nodes among the free ones (RN with the
   occupied nodes left out), and idles until its arrival;
4. a window runs to the next arrival.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .engine import Simulator, Windows
from .fabric import NetConfig, dragonfly, place_jobs
from .programs import translate_source
from .study import engine_seed


def place_seed(seed: int, jid: int) -> int:
    """A cell seed and a job -> that job's placement draw (the
    scheduler's derivation)."""
    return (seed * 1_000_003 + jid * 7919 + 17) % (2**31)


class Job:
    """One arrival: trace order by (float32 arrival, name) gives ``jid``."""

    def __init__(self, jid: int, d: Dict[str, Any]):
        if "source" not in d or "ranks" not in d:
            raise ValueError(f"job {d.get('name')!r}: the reference takes "
                             "jobs with an inline source and ranks")
        self.jid, self.name, self.app = jid, d["name"], d["app"]
        self.arrival = float(np.float32(d.get("arrival_us", 0.0)))
        self.est = float(d.get("est_runtime_us", 50_000.0))
        self.program = translate_source(
            d["source"], f"{d['app']}_{d['ranks']}", int(d["ranks"]),
            d.get("overrides") or {})
        self.n = self.program.n_ranks


class TraceSystem:
    """A trace file, ready to run cells: its jobs in trace order, the
    fabric and the engine envelope (``slots`` slots, every job's ranks
    and ops)."""

    def __init__(self, tr: Dict[str, Any]):
        self.tr = tr
        order = sorted(tr["jobs"], key=lambda d: (
            float(np.float32(d.get("arrival_us", 0.0))), d["name"]))
        self.jobs = [Job(i, d) for i, d in enumerate(order)]
        self.topo = dragonfly(tr.get("topo", "1d"), tr.get("scale", "small"))
        self.slots = int(tr.get("slots", 8))
        self.net = NetConfig(tick_us=float(tr.get("tick_us", 5.0)))
        self.pool_size = int(tr["pool_size"])
        self.horizon_us = float(tr.get("horizon_ms", 4000.0)) * 1000.0

    def simulator(self, device, fdt=torch.float32) -> Simulator:
        return Simulator(
            self.topo, [j.program for j in self.jobs],
            routing=self.tr.get("routing", "ADP"), net=self.net,
            pool_size=self.pool_size, horizon_us=self.horizon_us,
            start_us=[], ur=None, device=device, fdt=fdt, slots=self.slots)


def select(policy: str, queue: List[Job], now: float, free_nodes: int,
           free_slots: int, running: List[Tuple[float, int]]) -> List[Job]:
    """Remove from ``queue`` and return the jobs that start now.
    ``running`` holds (estimated end, nodes) of the running jobs."""
    starts: List[Job] = []
    used = 0
    for j in queue:
        if len(starts) >= free_slots or used + j.n > free_nodes:
            break
        starts.append(j)
        used += j.n
    del queue[:len(starts)]
    free_nodes -= used
    free_slots -= len(starts)
    if policy == "fcfs" or not queue:
        return starts
    if policy != "easy":
        raise ValueError(f"the reference holds fcfs and easy, not {policy!r}")
    # EASY: the head's reservation, from the running jobs' estimates (the
    # jobs started above count at theirs)
    head = queue[0]
    ends = sorted(running + [(now + j.est, j.n) for j in starts])
    nodes, slots, shadow = free_nodes, free_slots, now
    for end, n in ends:
        if nodes >= head.n and slots >= 1:
            break
        nodes, slots, shadow = nodes + n, slots + 1, max(shadow, end)
    if nodes < head.n or slots < 1:
        raise RuntimeError(f"job {head.name!r} can never start")
    extra_nodes, extra_slots = nodes - head.n, slots - 1
    i = 1
    while i < len(queue) and free_slots >= 1:
        j = queue[i]
        ends_first = now + j.est <= shadow
        spare = j.n <= extra_nodes and extra_slots >= 1
        if j.n <= free_nodes and (ends_first or spare):
            starts.append(queue.pop(i))
            free_slots -= 1
            free_nodes -= j.n
            if ends_first:
                extra_nodes = min(extra_nodes, free_nodes)
            else:
                extra_nodes -= j.n
                extra_slots -= 1
        else:
            i += 1
    return starts


class Record:
    def __init__(self, job: Job):
        self.job, self.slot = job, -1
        self.start = self.finish = float("nan")
        self.completed, self.msgs = False, 0
        self.avg_latency_us = self.max_comm_ms = 0.0
        self.nodes: Optional[np.ndarray] = None
        self.lat0 = (0.0, 0)


def run_cell(tr: Dict[str, Any], seed: int, policy: str, device,
             fdt=torch.float32, max_ticks: Optional[int] = None,
             system: Optional[TraceSystem] = None) -> Dict[str, Any]:
    """One cell of the trace on ``device`` in float type ``fdt``: its
    window count, makespan, whether the horizon cut it, and each job's
    record in trace order."""
    return simulate_cell(tr, seed, policy, device, fdt, max_ticks,
                         system)[0]


def simulate_cell(tr, seed, policy, device, fdt=torch.float32,
                  max_ticks=None, system=None) -> Tuple[Dict[str, Any], int]:
    """``run_cell``'s records and the ticks the cell took."""
    ts = system or TraceSystem(tr)
    sim = ts.simulator(device, fdt)
    if max_ticks is None:
        max_ticks = 2 * int(math.ceil(ts.horizon_us / sim.dt)) + 64
    win = Windows(sim, sim.vacant_state(engine_seed(seed)), max_ticks)
    jobs, horizon = ts.jobs, ts.horizon_us
    queue: List[Job] = []
    free = list(range(ts.slots))
    occupied = np.zeros((ts.topo.n_nodes,), bool)
    running: Dict[int, Record] = {}
    draining: Dict[int, Record] = {}
    records = {j.jid: Record(j) for j in jobs}
    ai, windows, horizon_hit = 0, 0, False
    while True:
        v = win.view()
        now = v["t"]
        if now >= horizon:
            horizon_hit = True
            break
        while ai < len(jobs) and jobs[ai].arrival <= now:
            queue.append(jobs[ai])
            ai += 1
        if not (queue or running or draining) and ai < len(jobs):
            queue.append(jobs[ai])
            ai += 1
        for slot, rec in list(running.items()):
            if v["slot_done"][slot]:
                rec.finish, rec.completed = min(now, horizon), True
                rec.msgs = int(v["lat_cnt"][slot]) - rec.lat0[1]
                rec.avg_latency_us = (float(v["lat_sum"][slot])
                                      - rec.lat0[0]) / max(rec.msgs, 1)
                rec.max_comm_ms = float(
                    v["comm_time"][slot, :rec.job.n].max()) / 1000.0
                occupied[rec.nodes] = False
                del running[slot]
                draining[slot] = rec
        for slot in list(draining):
            if not v["in_flight"][slot]:
                win.write(slot, None)
                heapq.heappush(free, slot)
                del draining[slot]
        ests = [(r.start + r.job.est, r.job.n) for r in running.values()]
        ests += [(now + ts.net.tick_us, 0)] * len(draining)
        free_nodes = int(ts.topo.n_nodes - occupied.sum())
        for job in select(policy, queue, now, free_nodes, len(free), ests):
            rec = records[job.jid]
            rec.slot = heapq.heappop(free)
            rec.nodes = place_jobs(ts.topo, [job.n], ts.tr.get(
                "placement", "RN"), place_seed(seed, job.jid),
                occupied=occupied)[0]
            occupied[rec.nodes] = True
            rec.start = float(np.float32(max(now, job.arrival)))
            rec.lat0 = (float(v["lat_sum"][rec.slot]),
                        int(v["lat_cnt"][rec.slot]))
            win.write(rec.slot, (job.program, rec.nodes, rec.start))
            running[rec.slot] = rec
        if not (running or draining or queue) and ai >= len(jobs):
            break
        if win.exhausted:
            break
        ticks = win.run(jobs[ai].arrival if ai < len(jobs) else math.inf)
        windows += 1
        if not ticks:
            # the clock stands at a stop that the next arrival's time
            # lies beyond (a clock too coarse to hold that time, as a
            # control's): nothing changes from here on
            break
    done = [r for r in records.values() if r.completed]
    return dict(
        windows=windows, horizon_hit=horizon_hit,
        makespan_ms=max((r.finish for r in done), default=0.0) / 1000.0,
        jobs=[dict(name=r.job.name, arrival_us=r.job.arrival, slot=r.slot,
                   start_us=r.start, finish_us=r.finish,
                   completed=r.completed, msgs=r.msgs,
                   avg_latency_us=r.avg_latency_us,
                   max_comm_ms=r.max_comm_ms)
              for r in sorted(records.values(), key=lambda r: r.job.jid)]), \
        win.ticks
