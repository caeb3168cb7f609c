"""device.idle_share: the share of the boundary profile (from the first
repeat's member reports, over the host work between repeats, to the end
of the second repeat's first replays) in which no device operation ran,
averaged over the cell's cards."""
from profiling import union_ns


def read(ctx):
    bp = ctx.get("boundary_profile")
    if not bp or bp["hi"] <= bp["lo"]:
        return None
    span = bp["hi"] - bp["lo"]
    busy = [union_ns([(e[2], e[3]) for e in bp["events"]
                      if e[4] and e[1] == d], bp["lo"], bp["hi"])
            for d in range(ctx["chips"])]
    return 100.0 * (1.0 - sum(busy) / len(busy) / span)
