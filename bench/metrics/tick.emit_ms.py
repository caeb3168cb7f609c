"""tick.emit_ms: device milliseconds a tick of one batch in the tick's
``emit`` part, VM emission: the fault mask, ``vm_emit`` (XCHG's
``cumprod`` too), the rng offsets, the candidate gathers and the UR
draws (and, in a window, the stop test); timed by events inside the
traced tick graph (``RunStats.part_device_ms``), summed over the
window's repeats that held no profile."""
from tick_parts import part_ms_per_tick


def read(ctx):
    return part_ms_per_tick(ctx, "emit")
