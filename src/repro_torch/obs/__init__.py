"""repro_torch.obs — the simulation's in-engine observers.

The sim plane of the JAX package's ``repro.obs``: ring-buffer probes
inside ``SimState`` sampling per-level link utilization, per-app
in-flight latency, pool occupancy and queue depth every K live ticks
(:mod:`repro_torch.obs.probes`), and full-fidelity per-(app, link-level)
latency histograms with exact streaming moments
(:mod:`repro_torch.obs.hist`). Both are compiled into the engine's tick
only when requested (``build_engine(probes=..., hist=...)``), so the
plain engine's tick and states are unchanged.
"""
from repro_torch.obs.hist import (  # noqa: F401
    HistConfig, HistState, bucket_of, hist_summary, init_hist, merge_hist,
    update_hist,
)
from repro_torch.obs.probes import (  # noqa: F401
    ProbeConfig, ProbeState, init_probes, probe_timelines, ring_order,
    sample_probes,
)

__all__ = [
    "ProbeConfig", "ProbeState", "init_probes", "sample_probes",
    "ring_order", "probe_timelines",
    "HistConfig", "HistState", "bucket_of", "init_hist", "update_hist",
    "merge_hist", "hist_summary",
]
