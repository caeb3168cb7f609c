"""sched.host_share: the share of the ``union.run`` spans' wall time
outside their ``sched.batch_window`` spans (the engine's windows): the
plan, the engine look-up, the initial states, every scheduler round's
host view, queue policy and slot surgery, and the cells' summaries, over
the window's repeats that held no profile."""


def read(ctx):
    origin = ctx["span_origin_ns"]
    run = win = 0.0
    for e in ctx["spans"]:
        if e.get("ph") == "C" or e["name"] not in ("union.run",
                                                   "sched.batch_window"):
            continue
        t = origin + e["ts_us"] * 1000.0
        if not any(r["t0_ns"] <= t <= r["t1_ns"]
                   for r in ctx["clean_repeats"]):
            continue
        if e["name"] == "union.run":
            run += e["dur_us"]
        else:
            win += e["dur_us"]
    if run <= 0 or win <= 0:
        return None
    return 100.0 * (run - win) / run
