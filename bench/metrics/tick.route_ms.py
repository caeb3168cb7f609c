"""tick.route_ms: device milliseconds a tick of one batch in the tick's
``route`` part, routing and injection: both ``inject`` calls (UGAL and
the pool's ``_flat_set`` calls); timed by events inside the traced tick
graph (``RunStats.part_device_ms``), summed over the window's repeats
that held no profile."""
from tick_parts import part_ms_per_tick


def read(ctx):
    return part_ms_per_tick(ctx, "route")
