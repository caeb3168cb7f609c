"""Telemetry exporters + the leveled run logger.

Two export formats for the span tracer (:mod:`repro_torch.obs.spans`):

* :func:`write_chrome_trace` — Chrome trace-event JSON (``ph: "X"``
  complete events, microsecond timestamps). Open in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.
* :func:`write_jsonl` — one JSON object per line (span records verbatim),
  the grep/pandas-friendly structured run log.

Plus the subsystem's **leveled logger**, ``repro_torch.obs.log`` — the
replacement for stray ``print()`` diagnostics across the CLI, the
scheduler loop, and the launch wrappers. Quiet by default (WARNING);
:func:`set_verbosity` maps the CLI's ``-v`` count to INFO/DEBUG.
:func:`log_to_jsonl` attaches a structured JSONL sink so a run's log
lines land next to its trace.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.spans import get_tracer

# ---------------------------------------------------------------------------
# the leveled logger
# ---------------------------------------------------------------------------

log = logging.getLogger("repro_torch.obs")
if not log.handlers:  # idempotent under re-import
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname).1s %(name)s] %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.WARNING)
    log.propagate = False


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """A child of the ``repro_torch.obs`` logger (shares handlers/level)."""
    return log if not name else log.getChild(name)


def set_verbosity(v: int) -> None:
    """0 -> WARNING (quiet, the default), 1 -> INFO, 2+ -> DEBUG."""
    log.setLevel(
        logging.WARNING if v <= 0 else
        logging.INFO if v == 1 else logging.DEBUG)


class _JsonlHandler(logging.Handler):
    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._f = open(path, "a")

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._f.write(json.dumps(dict(
                t=time.time(), level=record.levelname,
                logger=record.name, msg=record.getMessage())) + "\n")
            self._f.flush()
        except Exception:
            self.handleError(record)

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            super().close()


def log_to_jsonl(path: str, level: int = logging.DEBUG) -> logging.Handler:
    """Attach a structured JSONL sink to the run logger; returns the
    handler (remove it with ``log.removeHandler`` when done)."""
    h = _JsonlHandler(path)
    h.setLevel(level)
    log.addHandler(h)
    return h


# ---------------------------------------------------------------------------
# trace exporters
# ---------------------------------------------------------------------------

def chrome_events(events: Optional[List[Dict[str, Any]]] = None,
                  pid: Optional[int] = None) -> List[Dict[str, Any]]:
    """Span records -> Chrome trace-event dicts (``ph: X`` / ``C``)."""
    if events is None:
        events = get_tracer().events
    if pid is None:
        pid = os.getpid()
    out = []
    for ev in events:
        if ev.get("ph") == "C":
            out.append(dict(
                name=ev["name"], ph="C", ts=ev["ts_us"], pid=pid, tid=0,
                args=ev.get("args", {}),
            ))
            continue
        ce: Dict[str, Any] = dict(
            name=ev["name"], cat=ev.get("cat", "host"), ph="X",
            ts=ev["ts_us"], dur=ev["dur_us"], pid=pid,
            tid=ev.get("tid", 0),
        )
        args = dict(ev.get("args", {}))
        args["cpu_ms"] = ev.get("cpu_ms", 0.0)
        ce["args"] = args
        out.append(ce)
    return out


def write_chrome_trace(path: str,
                       events: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write the tracer's events as Chrome trace-event JSON. Returns
    ``path``. The file is a complete, Perfetto-loadable object:
    ``{"traceEvents": [...], "displayTimeUnit": "ms"}``."""
    payload = dict(
        traceEvents=chrome_events(events),
        displayTimeUnit="ms",
        otherData=dict(producer="repro_torch.obs"),
    )
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def write_jsonl(path: str,
                events: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write span records as one JSON object per line (the run log)."""
    if events is None:
        events = get_tracer().events
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, default=float) + "\n")
    return path
