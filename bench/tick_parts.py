"""Shared by the ``tick.<part>_ms`` readers: one part of the tick
(``repro_torch.netsim.engine.TICK_PARTS``), timed by events inside the
traced tick graph (``RunStats.part_device_ms``)."""
from __future__ import annotations


def part_ms_per_tick(ctx, part: str):
    """Device milliseconds a tick of one batch in ``part``: its times
    summed over the window's repeats that held no profile, over the ticks
    they cover (``part_ticks``); None where the program timed no part."""
    ms, ticks = 0.0, 0
    for r in ctx["clean_repeats"]:
        eng = r["engine"]
        if part in eng.get("part_device_ms", {}):
            ms += eng["part_device_ms"][part]
            ticks += eng.get("part_ticks", 0)
    if ticks <= 0:
        return None
    return ms / ticks
