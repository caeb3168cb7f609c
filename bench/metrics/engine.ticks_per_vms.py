"""engine.ticks_per_vms: engine ticks over the virtual milliseconds they
simulated (the idle-time skip jumps empty stretches; ticks are counted
in whole liveness chunks), over the window's repeats that held no
profile; a split call's ticks are over its replicas, each of which
simulated the call's virtual time."""


def read(ctx):
    ticks = vms = 0.0
    for r in ctx["clean_repeats"]:
        t = r["engine"].get("ticks", 0)
        if not t or not r["reports"]:
            continue
        ticks += t
        vms += (max(x["virtual_time_ms"] for x in r["reports"])
                * max(1, len(r["replicas"])))
    if ticks <= 0 or vms <= 0:
        return None
    return ticks / vms
