"""Process-wide metrics registry with OpenMetrics text export.

The third observability plane: spans see *one run's* wall-clock, probes
and histograms see *one run's* virtual time — the registry sees the
**process**: cells completed, window rounds, engine-cache traffic,
rolling throughput. It is the scrape surface a persistent Union server
(ROADMAP item 2) will expose; today it exports on demand via
``write_openmetrics(path)`` / the CLI's ``--metrics``, and feeds the
``-v`` live progress line for long batched campaigns.

No dependencies: instruments are plain counters in a dict, and the
exposition format is the OpenMetrics text format written by hand
(``# TYPE``/``# HELP`` headers, ``_total``-suffixed counter samples,
terminated by ``# EOF``) — parseable by any Prometheus scraper.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Tuple


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{k}="{str(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


class Counter:
    """Monotonically increasing count (exported with a ``_total`` suffix)."""

    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self._vals: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        k = tuple(sorted(labels.items()))
        self._vals[k] = self._vals.get(k, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._vals.get(tuple(sorted(labels.items())), 0.0)

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        return [
            (f"{self.name}_total", dict(k), v)
            for k, v in sorted(self._vals.items())
        ]


class Gauge:
    """A value that goes up and down (last write wins)."""

    kind = "gauge"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self._vals: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._vals[tuple(sorted(labels.items()))] = float(value)

    def value(self, **labels: str) -> float:
        return self._vals.get(tuple(sorted(labels.items())), 0.0)

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        return [(self.name, dict(k), v) for k, v in sorted(self._vals.items())]


class Histogram:
    """Cumulative-bucket histogram over fixed upper bounds."""

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Tuple[float, ...]):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self._sum += v
        self._n += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        out: List[Tuple[str, Dict[str, str], float]] = []
        cum = 0
        for ub, c in zip(self.buckets, self._counts):
            cum += c
            out.append((f"{self.name}_bucket", {"le": repr(ub)}, float(cum)))
        cum += self._counts[-1]
        out.append((f"{self.name}_bucket", {"le": "+Inf"}, float(cum)))
        out.append((f"{self.name}_count", {}, float(self._n)))
        out.append((f"{self.name}_sum", {}, self._sum))
        return out


class MetricsRegistry:
    """A named family of instruments; re-registration returns the
    existing instrument (idempotent under re-import / repeated runs)."""

    def __init__(self) -> None:
        self._instruments: Dict[str, Any] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = (
                      0.01, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0,
                  )) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, buckets),
                         Histogram)

    def _get(self, name, make, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = make()
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {type(inst).__name__}"
            )
        return inst

    def clear(self) -> None:
        self._instruments.clear()

    def render_openmetrics(self) -> str:
        """The OpenMetrics text exposition of every instrument."""
        lines: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            lines.append(f"# TYPE {name} {inst.kind}")
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            for sample, labels, value in inst.samples():
                lines.append(f"{sample}{_fmt_labels(labels)} {value:g}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (one per process, like the tracer)."""
    return _REGISTRY


def write_openmetrics(path: str,
                      registry: Optional[MetricsRegistry] = None) -> str:
    """Write the registry's OpenMetrics exposition. Returns ``path``."""
    reg = registry or _REGISTRY
    with open(path, "w") as f:
        f.write(reg.render_openmetrics())
    return path


class Progress:
    """A ``\\r``-rewriting live progress line (cells done/total + ETA).

    Writes to stderr only when enabled (the CLI enables it under ``-v``);
    a finished bar terminates its line so the next log write starts
    clean. Wall-clock based, so it never touches result payloads.
    """

    def __init__(self, total: int, label: str = "cells",
                 enabled: bool = True, stream=None):
        self.total = max(int(total), 0)
        self.label = label
        self.enabled = bool(enabled) and self.total > 0
        self.stream = stream if stream is not None else sys.stderr
        self.done = 0
        self.t0 = time.time()
        self._dirty = False

    def advance(self, n: int = 1) -> None:
        self.done += n
        if not self.enabled:
            return
        dt = time.time() - self.t0
        rate = self.done / dt if dt > 0 else 0.0
        eta = (self.total - self.done) / rate if rate > 0 else float("inf")
        eta_s = f"{eta:.0f}s" if eta != float("inf") else "?"
        self.stream.write(
            f"\r[{self.label}] {self.done}/{self.total} "
            f"({dt:.1f}s elapsed, eta {eta_s})"
        )
        self.stream.flush()
        self._dirty = True

    def close(self) -> None:
        if self.enabled and self._dirty:
            self.stream.write("\n")
            self.stream.flush()
            self._dirty = False
