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
  the host span that covers it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

TRIES = 3
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
    and stopped by one thread."""

    def __init__(self, replays: int = 2, skip: int = 40,
                 boundary_replays: int = 2, graph_ticks: int = 8):
        self.k, self.skip, self.k2 = replays, skip, boundary_replays
        self.graph_ticks = graph_ticks
        self.lock = threading.Lock()
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
    def install(self, manager_module):
        import torch

        self._graph_cls = torch.cuda.CUDAGraph
        self._orig_replay = self._graph_cls.replay
        self._mgr = manager_module
        self._orig_report = manager_module.member_report
        tap = self

        def replay(graph):
            tap._before_replay()
            tap._orig_replay(graph)
            tap._after_replay()

        def member_report(*a, **kw):
            tap._on_report()
            return tap._orig_report(*a, **kw)

        self._graph_cls.replay = replay
        manager_module.member_report = member_report

    def remove(self):
        self._graph_cls.replay = self._orig_replay
        self._mgr.member_report = self._orig_report
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
    def _before_replay(self):
        import torch

        dev = torch.cuda.current_device()
        with self.lock:
            n = self.count.get(dev, 0)
            self.count[dev] = n + 1
            start = (self.p1_state == "armed" and self.prof is None
                     and self.p2_state == "armed" and self.repeat == 0
                     and n == self.p1_at)
            if start:
                self.p1_state, self.p1_dev, self.p1_n = "starting", dev, 0
        if start:
            self._ask("start")

    def _after_replay(self):
        import torch

        dev = torch.cuda.current_device()
        ask = None
        with self.lock:
            if self.p1_state == "on" and dev == self.p1_dev:
                self.p1_n += 1
                if self.p1_n == self.k:
                    ask = "stop_replays"
                    self.p1_state = "stopping"
            elif (self.p2_state == "on" and self.repeat == 1 and dev == 0):
                self.p2_n += 1
                if self.p2_n == self.k2:
                    ask = "stop_boundary"
                    self.p2_state = "stopping"
        if ask:
            self._ask(ask)

    def _on_report(self):
        with self.lock:
            start = (self.p2_state == "armed" and self.repeat == 0
                     and self.prof is None
                     and self.p1_state not in ("starting", "on"))
            if start:
                self.p2_state = "starting"
        if start:
            self._ask("start")

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
