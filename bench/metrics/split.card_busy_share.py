"""split.card_busy_share: the share of the split engine call in which the
cards replay graphs: in each repeat that held no profile, the replicas'
replay device milliseconds (``replay_device_ms`` of the ``engine.replica``
spans) over the replicas times the wall time of the ``engine.prun`` span,
averaged over the repeats; read where the members are split over cards."""


def read(ctx):
    origin = ctx["span_origin_ns"]
    shares = []
    for r in ctx["clean_repeats"]:
        busy = wall = 0.0
        for e in ctx["spans"]:
            if e["name"] not in ("engine.prun", "engine.replica"):
                continue
            t = origin + e["ts_us"] * 1000.0
            if not r["t0_ns"] <= t <= r["t1_ns"]:
                continue
            if e["name"] == "engine.prun":
                wall += e["args"]["replicas"] * e["dur_us"] / 1000.0
            else:
                busy += e["args"].get("replay_device_ms", 0.0)
        if busy > 0 and wall > 0:
            shares.append(100.0 * busy / wall)
    if not shares:
        return None
    return sum(shares) / len(shares)
