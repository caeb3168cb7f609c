"""engine.replay_ms_per_tick.trace: ``engine.replay_ms_per_tick`` in the
online scheduler's cells (a trace configuration: the window graphs'
replays over the ticks they ran, no-op ticks included), which reports
``trace_rate``."""
from readers import same_as

read = same_as("engine.replay_ms_per_tick")
