"""facade.host_share: the share of the ``union.run`` spans' wall time
outside their ``engine.run`` spans (plan, resolve, engine look-up,
initial states, member reports), over the window's repeats that held no
profile."""


def read(ctx):
    origin = ctx["span_origin_ns"]
    run = eng = 0.0
    for e in ctx["spans"]:
        if e.get("ph") == "C" or e["name"] not in ("union.run", "engine.run"):
            continue
        t = origin + e["ts_us"] * 1000.0
        if not any(r["t0_ns"] <= t <= r["t1_ns"]
                   for r in ctx["clean_repeats"]):
            continue
        if e["name"] == "union.run":
            run += e["dur_us"]
        else:
            eng += e["dur_us"]
    if run <= 0:
        return None
    return 100.0 * (run - eng) / run
