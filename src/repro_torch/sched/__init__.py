"""repro_torch.sched — trace-driven online cluster scheduler on the port.

Jobs **arrive** over time (synthetic Poisson/Weibull traces or replayed
JSON traces, :mod:`repro_torch.sched.trace`), wait in a pending queue under
FCFS, EASY or conservative backfill (:mod:`repro_torch.sched.queue`), and
are placed incrementally against the occupied node set, streaming through
one engine envelope via slot-recycling windows
(:mod:`repro_torch.sched.scheduler`). The trace and queue modules are
copies of the JAX package's; the scheduler is its port.
"""
from repro_torch.sched.queue import PendingQueue, QueuedJob, simulate_queue
from repro_torch.sched.scheduler import (
    JobRecord, SchedResult, run_trace, run_trace_batch,
)
from repro_torch.sched.trace import (
    CatalogApp,
    Trace,
    TraceJob,
    default_catalog,
    load_trace,
    synthetic_trace,
)

__all__ = [
    "CatalogApp",
    "JobRecord",
    "PendingQueue",
    "QueuedJob",
    "SchedResult",
    "Trace",
    "TraceJob",
    "default_catalog",
    "load_trace",
    "run_trace",
    "run_trace_batch",
    "simulate_queue",
    "synthetic_trace",
]
