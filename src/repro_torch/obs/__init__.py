"""repro_torch.obs — observability for the port's simulation pipeline.

**Host plane** (:mod:`repro_torch.obs.spans` +
:mod:`repro_torch.obs.export`): a process-wide span tracer (the online
scheduler's windows among its spans), exported as Chrome trace-event JSON
(Perfetto) or a structured JSONL run log, plus the leveled run logger
``log``.

**Sim plane** (:mod:`repro_torch.obs.probes` + :mod:`repro_torch.obs.hist`
+ :mod:`repro_torch.obs.timeline`): ring-buffer probes inside ``SimState``
sampling per-level link utilization, per-app in-flight latency, pool
occupancy and queue depth every K live ticks; full-fidelity per-(app,
link-level) latency histograms with exact streaming moments; and
sim-time job lifecycle timelines recorded by the scheduler loop. Probes
and histograms are compiled into the engine's tick only when requested
(``build_engine(probes=..., hist=...)``), so the plain engine's tick and
states are unchanged.

**Process plane** (:mod:`repro_torch.obs.metrics`): a process-wide
metrics registry (counters, gauges, histograms) with OpenMetrics text
export; the engine cache reports through it.

The host- and process-plane modules and the timeline are copies of the
JAX package's jax-free modules (``tests/test_torch_fabric.py`` holds
them to it).
"""
from repro_torch.obs.spans import (  # noqa: F401
    Tracer, get_tracer, enable, disable, tracing,
    span, counter, summarize,
)
from repro_torch.obs.export import (  # noqa: F401
    log, get_logger, set_verbosity, log_to_jsonl,
    chrome_events, write_chrome_trace, write_jsonl,
)
from repro_torch.obs.hist import (  # noqa: F401
    HistConfig, HistState, bucket_of, hist_summary, init_hist, merge_hist,
    update_hist,
)
from repro_torch.obs.probes import (  # noqa: F401
    ProbeConfig, ProbeState, init_probes, probe_timelines, ring_order,
    sample_probes,
)
from repro_torch.obs.timeline import (  # noqa: F401
    TimelineRecorder, sim_chrome_trace, write_sim_trace,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, Progress,
    get_registry, write_openmetrics,
)

__all__ = [
    "Tracer", "get_tracer", "enable", "disable", "tracing",
    "span", "counter", "summarize",
    "log", "get_logger", "set_verbosity", "log_to_jsonl",
    "chrome_events", "write_chrome_trace", "write_jsonl",
    "ProbeConfig", "ProbeState", "init_probes", "sample_probes",
    "ring_order", "probe_timelines",
    "HistConfig", "HistState", "bucket_of", "init_hist", "update_hist",
    "merge_hist", "hist_summary",
    "TimelineRecorder", "sim_chrome_trace", "write_sim_trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Progress",
    "get_registry", "write_openmetrics",
]
