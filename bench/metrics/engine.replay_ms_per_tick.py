"""engine.replay_ms_per_tick: device milliseconds of the captured tick
graphs' replays (CUDA events, ``RunStats.replay_device_ms``) over the
ticks they ran, summed over the window's repeats that held no profile
and, where the members are split, over the replicas: the device time of
one tick of one replica's batch."""


def read(ctx):
    ms = sum(r["engine"].get("replay_device_ms", 0.0)
             for r in ctx["clean_repeats"])
    ticks = sum(r["engine"].get("ticks", 0) for r in ctx["clean_repeats"])
    if ms <= 0 or ticks <= 0:
        return None
    return ms / ticks
