"""Host-plane span tracer — where does wall-clock go, per run.

A process-wide :class:`Tracer` collects **spans**: named, categorized
wall-clock intervals with process-CPU time and arbitrary key/value
arguments, opened with the :func:`span` context manager::

    with span("engine.run", cat="engine", members=8) as sp:
        final = run(state)
        sp.set(cold=was_cache_miss)

The tracer is **disabled by default** and the disabled path is a single
attribute check plus a no-op context manager — cheap enough to leave the
instrumentation inline on every hot host path (the facade, the planner,
the scheduler loop). Enable it with :func:`enable` (the CLI's
``--profile`` flag does), then export via :mod:`repro_torch.obs.export`:
Chrome trace-event JSON (load in Perfetto / ``chrome://tracing``) or a
structured JSONL run log.

Spans are thread-safe: each thread gets its own Chrome ``tid`` row, and
event recording takes one lock around a list append.

While a ``torch.profiler`` profile is active, an enabled span also opens
``torch.profiler.record_function(name)``, so that it shows in the
profile beside the device's kernels, on the profile's clock. The profiler
records only the threads it records (the one that started it, unless
configured for all threads); on any other the label is dropped.
"""
from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class SpanHandle:
    """The mutable handle yielded by :func:`span` — add args mid-span."""

    __slots__ = ("args",)

    def __init__(self, args: Dict[str, Any]):
        self.args = args

    def set(self, **kw) -> None:
        self.args.update(kw)


class _NullSpan:
    """Yielded when tracing is disabled; swallows ``set`` calls."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """A process-wide span collector (one instance per process).

    Records are plain dicts: ``name``, ``cat``, ``ts_us`` (relative to
    the tracer's origin), ``dur_us``, ``cpu_ms`` (process time spent
    inside the span), ``tid`` (small per-thread ordinal), ``args``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        self.enabled = False
        self.origin_ns = time.perf_counter_ns()
        self.events: List[Dict[str, Any]] = []

    # -- lifecycle -----------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self.events = []
            self._tids = {}
            self.origin_ns = time.perf_counter_ns()

    @property
    def n_events(self) -> int:
        return len(self.events)

    # -- recording -----------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def record(self, name: str, cat: str, t0_ns: int, dur_ns: int,
               cpu_ns: int, args: Dict[str, Any]) -> None:
        ev = dict(
            name=name, cat=cat,
            ts_us=(t0_ns - self.origin_ns) / 1000.0,
            dur_us=dur_ns / 1000.0,
            cpu_ms=cpu_ns / 1e6,
            tid=self._tid(),
        )
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def counter(self, name: str, **values: float) -> None:
        """A Chrome counter ('C') sample — e.g. cache hit totals over time."""
        if not self.enabled:
            return
        ev = dict(
            name=name, cat="counter", ph="C",
            ts_us=(time.perf_counter_ns() - self.origin_ns) / 1000.0,
            args={k: float(v) for k, v in values.items()},
        )
        with self._lock:
            self.events.append(ev)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable() -> None:
    """Turn span collection on (idempotent)."""
    _TRACER.enable()


def disable() -> None:
    _TRACER.disable()


def tracing() -> bool:
    return _TRACER.enabled


@contextmanager
def span(name: str, /, cat: str = "host", **args):
    """Time a block. Near-zero overhead while the tracer is disabled
    (one attribute check, a shared null handle, no clock reads)."""
    tr = _TRACER
    if not tr.enabled:
        yield _NULL_SPAN
        return
    handle = SpanHandle(dict(args))
    label = _profiler_label(name)
    t0 = time.perf_counter_ns()
    c0 = time.process_time_ns()
    try:
        yield handle
    finally:
        dur = time.perf_counter_ns() - t0
        cpu = time.process_time_ns() - c0
        if label is not None:
            label.__exit__(None, None, None)
        tr.record(name, cat, t0, dur, cpu, handle.args)


def _profiler_label(name: str):
    """``torch.profiler.record_function(name)``, entered, while a torch
    profile is active; else None. Torch is not imported here: with no
    torch loaded, no profile can be active."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    label = prof.record_function(name)
    label.__enter__()
    return label


def counter(name: str, **values: float) -> None:
    _TRACER.counter(name, **values)


def summarize(events: Optional[List[Dict[str, Any]]] = None,
              top: int = 3) -> Dict[str, Any]:
    """Aggregate span events by name: count, total/max wall, CPU time.

    Returns ``{"by_name": {...}, "top": [[name, total_ms], ...]}`` — the
    ``top`` list is the top-N wall-clock sinks among **leaf-ish** spans
    (every span counts; nesting means parents dominate, so the report
    layer prefers specific engine/scheduler spans over ``union.run``).
    """
    if events is None:
        events = _TRACER.events
    by_name: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ph") == "C":
            continue
        d = by_name.setdefault(ev["name"], dict(
            count=0, total_ms=0.0, max_ms=0.0, cpu_ms=0.0,
            cat=ev.get("cat", "host")))
        d["count"] += 1
        dur_ms = ev["dur_us"] / 1000.0
        d["total_ms"] += dur_ms
        d["max_ms"] = max(d["max_ms"], dur_ms)
        d["cpu_ms"] += ev.get("cpu_ms", 0.0)
    ranked = sorted(
        ((name, d["total_ms"]) for name, d in by_name.items()
         if name != "union.run"),
        key=lambda p: -p[1])
    return dict(
        by_name=by_name,
        top=[[name, total] for name, total in ranked[:top]],
    )
