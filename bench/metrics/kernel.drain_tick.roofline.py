"""kernel.drain_tick.roofline: the fused drain tick's bound
(``bounds.drain_bound_ms`` from the cell's shapes) over the device time
a tick of its three kernels (``drain_zero_kernel``,
``drain_count_kernel``, ``drain_kernel``) in the replay profile."""
import bounds
from profiling import WRAPPER_KERNELS, kernel_named


def read(ctx):
    rp = ctx.get("replay_profile")
    if not rp:
        return None
    s = sum(v[0] for name, v in rp["by_name"].items()
            if any(kernel_named(name, k)
                   for k in WRAPPER_KERNELS["drain_tick"]))
    if s <= 0:
        return None
    bound_ms, _ = bounds.drain_bound_ms(ctx["shapes"])
    return 100.0 * bound_ms / (s * 1e3 / rp["ticks"])
