"""tick.kernels_per_tick.trace: ``tick.kernels_per_tick`` in the online
scheduler's cells (a trace configuration: two whole replays of its
window graph, 16 ticks), which reports ``trace_rate``."""
from readers import same_as

read = same_as("tick.kernels_per_tick")
