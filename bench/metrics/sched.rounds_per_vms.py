"""sched.rounds_per_vms: scheduler rounds (``sched.batch_window`` spans,
one window of the lock-stepped batch each) over the batch's virtual
milliseconds (its longest cell's, ``kinds/trace.py``), over the window's
repeats that held no profile: how often the host stops the card."""


def read(ctx):
    origin = ctx["span_origin_ns"]
    rounds = 0
    for e in ctx["spans"]:
        if e.get("ph") == "C" or e["name"] != "sched.batch_window":
            continue
        t = origin + e["ts_us"] * 1000.0
        rounds += any(r["t0_ns"] <= t <= r["t1_ns"]
                      for r in ctx["clean_repeats"])
    vms = sum(r.get("batch_vms", 0.0) for r in ctx["clean_repeats"])
    if rounds <= 0 or vms <= 0:
        return None
    return rounds / vms
