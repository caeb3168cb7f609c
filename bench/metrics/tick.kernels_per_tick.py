"""tick.kernels_per_tick: device operations (kernels, memory sets and
copies) recorded in the replay profile, over the ticks its whole
replays ran."""


def read(ctx):
    rp = ctx.get("replay_profile")
    if not rp:
        return None
    return rp["records"] / rp["ticks"]
