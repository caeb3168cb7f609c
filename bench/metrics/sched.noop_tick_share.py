"""sched.noop_tick_share: the share of the windows' ticks in which every
member had stopped (``1 - live_ticks / ticks`` of the trace node's
engine totals): a window replays whole graphs of 8 ticks, and the ticks
after the batch's last member stops run as no-ops; over the window's
repeats that held no profile."""


def read(ctx):
    ticks = sum(r["engine"].get("ticks", 0) for r in ctx["clean_repeats"])
    live = sum(r["engine"].get("live_ticks", 0)
               for r in ctx["clean_repeats"])
    if ticks <= 0:
        return None
    return 100.0 * (1.0 - live / ticks)
