"""split.replica_skew: the largest replica's replay device milliseconds
over the replicas' mean (``RunStats.replicas`` of ``Engine.prun``),
summed over the window's repeats; read where the members are split over
cards."""


def read(ctx):
    per = {}
    for r in ctx["repeats"]:
        for i, rep in enumerate(r["replicas"]):
            per[i] = per.get(i, 0.0) + rep["replay_device_ms"]
    if len(per) < 2:
        return None
    mean = sum(per.values()) / len(per)
    return max(per.values()) / mean if mean > 0 else None
