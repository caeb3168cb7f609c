"""Profiles of the traced run, taken with ``torch.profiler`` (CUPTI) at
two places of the window, both found by watching graph replays and the
facade's member reports as they happen:

* the **replay profile**: ``replays`` whole replays of one device's
  captured tick graph in the middle of the first repeat. It gives the
  device operations a tick and each kernel's device time. CUPTI drops
  activity records when its buffer fills, so a profile whose wrapper
  kernels did not each run once a tick is taken again a liveness group
  later, up to ``TRIES`` profiles (``counted_profile`` of the
  repository's ``chip_smoke.py``, which this copies).
* the **boundary profile**: from the first member report of the first
  repeat (after its last replay) through the host work between repeats
  (reports, the next call's plan, engine look-up and initial states) to
  the end of the second repeat's first ``boundary_replays`` replays. It
  gives the device's busy and idle time and the idle gaps, each named by
  the host span that covers it. A trace cell's boundary (``rounds``)
  spans whole scheduler rounds instead, each a host round (the view,
  the queue policy, slot surgery) and its window's replays: from the
  start of round ``rounds[0]`` of the second repeat to the start of the
  round ``rounds[1]`` rounds later.

Where the members are split over cards (one host thread a card), the
profiler is started and stopped only while every other card's thread is
held before or after a replay: started or stopped beside graph launches
in other threads, ``torch.profiler`` hung in ``stop`` (its CUPTI flush)
in 2 of 3 processes that took the profiles 6 times each on four H100s.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

TRIES = 3
# seconds a watcher that starts or stops a profile waits for the other
# cards' threads to reach a replay; one that has ended its run never does
QUIET_S = 10.0
WRAPPER_KERNELS = {
    "drain_tick": ("drain_zero_kernel", "drain_count_kernel", "drain_kernel"),
    "link_demand": ("link_zero_kernel", "link_count_kernel",
                    "link_alloc_kernel", "link_place_kernel",
                    "link_fold_kernel"),
}


def kernel_named(key: str, name: str) -> bool:
    """Whether a profiler name is the CUDA kernel ``name`` (templated or
    not)."""
    return f"::{name}(" in key or f"::{name}<" in key


def _sync_all():
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _events(prof):
    """(name, device, start_ns, end_ns, on_device) of every profiled
    event; device events are kernels, memory copies and sets."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        try:
            t0, dur = e.start_ns(), e.duration_ns()
        except AttributeError:
            t0, dur = e.start_us() * 1000, e.duration_us() * 1000
        on_dev = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append((e.name(), e.device_index(), t0, t0 + dur, on_dev))
    return out


def union_ns(spans: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of intervals, clipped to [lo, hi]."""
    tot, cur = 0, lo
    for a, b in sorted(spans):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            tot += b - a
            cur = b
    return tot


def gaps_ns(spans: List[Tuple[int, int]], lo: int, hi: int):
    """The idle intervals of [lo, hi] outside every interval."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Tap:
    """Watches the process's CUDA graph replays and the facade's member
    reports to take the two profiles; ``repeat`` is set by the harness
    before each repeat's call. The watched calls run in threads of the
    program (a helper thread that makes the repeat's call, and one thread
    a card where the members are split); a watcher that reaches the start
    or the end of a profile waits there while the harness's own thread
    (``serve``) starts or stops the profiler, which has to be started
    and stopped by one thread. A replay's watcher first holds every other
    card's thread at its next replay (``_quiet``), so that no graph is
    launched while the profiler starts or stops."""

    def __init__(self, replays: int = 2, skip: int = 40,
                 boundary_replays: int = 2, graph_ticks: int = 8,
                 rounds: Optional[Tuple[int, int]] = None):
        self.k, self.skip, self.k2 = replays, skip, boundary_replays
        self.rounds, self.round = rounds, 0
        self.graph_ticks = graph_ticks
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.hold, self.parked, self.unquiet = False, 0, 0
        self.requests: "queue.Queue" = queue.Queue()
        self.repeat = -1
        self.count: Dict[int, int] = {}
        self.p1_state, self.p1_at, self.p1_dev, self.p1_n = "armed", skip, \
            None, 0
        self.p1_short: List[Dict[str, int]] = []
        self.replay_profile: Optional[Dict] = None
        self.p2_state, self.p2_n = "armed", 0
        self.boundary_profile: Optional[Dict] = None
        self.prof = None

    # -- install / remove ----------------------------------------------
    def install(self, module, name: str = "member_report"):
        """Watch the graph replays and calls of ``module.<name>``, the
        boundary: the facade's member reports, or a trace cell's host
        view (one call a scheduler round)."""
        import torch

        self._graph_cls = torch.cuda.CUDAGraph
        self._orig_replay = self._graph_cls.replay
        self._mod, self._name = module, name
        self._orig_boundary = getattr(module, name)
        tap = self

        def replay(graph):
            tap._before_replay()
            tap._orig_replay(graph)
            tap._after_replay()

        def boundary(*a, **kw):
            tap._on_boundary()
            return tap._orig_boundary(*a, **kw)

        self._graph_cls.replay = replay
        setattr(module, name, boundary)

    def remove(self):
        self._graph_cls.replay = self._orig_replay
        setattr(self._mod, self._name, self._orig_boundary)
        if self.prof is not None:
            self._stop()

    # -- the harness's thread --------------------------------------------
    def serve(self, worker: threading.Thread) -> None:
        """Start and stop the profiler as the watchers ask, until
        ``worker`` (the thread making the repeat's call) has ended."""
        while worker.is_alive() or not self.requests.empty():
            try:
                what, done = self.requests.get(timeout=0.005)
            except queue.Empty:
                continue
            try:
                with self.lock:
                    if what == "start":
                        self._start()
                        if self.p1_state == "starting":
                            self.p1_state = "on"
                        else:
                            self.p2_state = "on"
                    elif what == "stop_replays":
                        self._finish_p1()
                    else:
                        self.boundary_profile = self._stop()
                        self.p2_state = "done"
            finally:
                done.set()

    def _ask(self, what: str) -> None:
        done = threading.Event()
        self.requests.put((what, done))
        done.wait()

    # -- the profiler ----------------------------------------------------
    def _start(self):
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        _sync_all()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with record_function("bench.clock"):
            self.mark_ns = time.perf_counter_ns()
        self.t0_ns = time.perf_counter_ns()

    def _stop(self):
        _sync_all()
        t1 = time.perf_counter_ns()
        prof, self.prof = self.prof, None
        prof.stop()
        ev = _events(prof)
        mark = [e for e in ev if e[0] == "bench.clock" and not e[4]]
        off = (mark[0][2] - self.mark_ns) if mark else 0
        return dict(events=ev, lo=self.t0_ns + off, hi=t1 + off,
                    offset_ns=off)

    # -- watchers (the program's threads) ---------------------------------
    def _gate(self):
        """Wait here while another watcher holds the cards (lock held)."""
        if self.hold:
            self.parked += 1
            self.cond.notify_all()
            self.cond.wait_for(lambda: not self.hold)
            self.parked -= 1

    def _quiet(self, what: str) -> None:
        """Hold the other cards' threads at their next replay, ask the
        harness's thread for ``what``, then let them go (lock not held).
        Where a thread does not come within ``QUIET_S`` seconds, its run
        has ended, and the profiler starts or stops all the same."""
        with self.lock:
            self.hold = True
            others = len(self.count) - 1
            if not self.cond.wait_for(lambda: self.parked >= others,
                                      timeout=QUIET_S):
                self.unquiet += 1
        try:
            self._ask(what)
        finally:
            with self.lock:
                self.hold = False
                self.cond.notify_all()

    def _device(self) -> int:
        import torch

        return torch.cuda.current_device()

    def _before_replay(self):
        dev = self._device()
        with self.lock:
            self._gate()
            n = self.count.get(dev, 0)
            self.count[dev] = n + 1
            start = (self.p1_state == "armed" and self.prof is None
                     and self.p2_state == "armed" and self.repeat == 0
                     and n == self.p1_at)
            if start:
                self.p1_state, self.p1_dev, self.p1_n = "starting", dev, 0
        if start:
            self._quiet("start")

    def _after_replay(self):
        dev = self._device()
        ask = None
        with self.lock:
            self._gate()
            if self.p1_state == "on" and dev == self.p1_dev:
                self.p1_n += 1
                if self.p1_n == self.k:
                    ask = "stop_replays"
                    self.p1_state = "stopping"
            elif (self.p2_state == "on" and self.repeat == 1 and dev == 0
                  and self.rounds is None):
                self.p2_n += 1
                if self.p2_n == self.k2:
                    ask = "stop_boundary"
                    self.p2_state = "stopping"
        if ask:
            self._quiet(ask)

    def _on_boundary(self):
        """A member report: the boundary profile starts at the first one
        of the first repeat (a trace cell's rounds: ``_on_round``)."""
        if self.rounds is not None:
            return self._on_round()
        with self.lock:
            start = (self.p2_state == "armed" and self.repeat == 0
                     and self.prof is None
                     and self.p1_state not in ("starting", "on"))
            if start:
                self.p2_state = "starting"
        if start:
            self._ask("start")

    def _on_round(self):
        """A trace cell's round begins: the boundary profile starts at
        round ``rounds[0]`` of the second repeat and stops ``rounds[1]``
        rounds later."""
        first, n = self.rounds
        ask = None
        with self.lock:
            if self.repeat != 1:
                return
            r, self.round = self.round, self.round + 1
            if (r == first and self.p2_state == "armed"
                    and self.prof is None):
                self.p2_state, ask = "starting", "start"
            elif r == first + n and self.p2_state == "on":
                self.p2_state, ask = "stopping", "stop_boundary"
        if ask:
            self._ask(ask)

    def _finish_p1(self):
        got = self._stop()
        dev = self.p1_dev
        mine = [e for e in got["events"] if e[4] and e[1] == dev]
        ticks = self.k * self.graph_ticks
        runs = {k: sum(1 for e in mine if kernel_named(e[0], k))
                for names in WRAPPER_KERNELS.values() for k in names}
        if any(n > ticks for n in runs.values()):
            raise RuntimeError(f"replay profile: kernels ran more than once "
                               f"a tick ({runs} in {ticks} ticks)")
        missed = {k: ticks - n for k, n in runs.items() if n != ticks}
        if missed and len(self.p1_short) + 1 < TRIES:
            self.p1_short.append(missed)
            self.p1_state = "armed"
            self.p1_at = self.count[dev] + self.graph_ticks
            return
        if missed:
            self.p1_short.append(missed)
            self.p1_state = "failed"
            return
        by_name: Dict[str, List[float]] = {}
        for name, _, a, b, _ in mine:
            row = by_name.setdefault(name, [0.0, 0])
            row[0] += (b - a) / 1e9
            row[1] += 1
        self.replay_profile = dict(ticks=ticks, records=len(mine),
                                   by_name=by_name)
        self.p1_state = "done"
