"""tick.roofline: the least time of a tick (every member's SimState read
and written once and the fabric's tables read once, at the HBM rate;
``bounds.tick_bound_ms`` from the cell's shapes) over the replays'
device milliseconds a tick (``engine.replay_ms_per_tick``)."""
import bounds


def read(ctx):
    ms = sum(r["engine"].get("replay_device_ms", 0.0)
             for r in ctx["clean_repeats"])
    ticks = sum(r["engine"].get("ticks", 0) for r in ctx["clean_repeats"])
    if ms <= 0 or ticks <= 0:
        return None
    return 100.0 * bounds.tick_bound_ms(ctx["shapes"]) / (ms / ticks)
