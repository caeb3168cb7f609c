"""tick.route_ms: device milliseconds a tick of one batch in the tick's
``route`` part, routing and injection: ``KOPS.inject``, on a dragonfly
on the card the hand-written injection kernels (``csrc/inject.cu``: UGAL
and the pool-slot writes of the candidates given a slot); timed by
events inside the traced tick graph (``RunStats.part_device_ms``),
summed over the window's repeats that held no profile."""
from tick_parts import part_ms_per_tick


def read(ctx):
    return part_ms_per_tick(ctx, "route")
