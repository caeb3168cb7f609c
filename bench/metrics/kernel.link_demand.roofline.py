"""kernel.link_demand.roofline: the link demand's bound (its bytes,
``bounds.link_demand_bound_ms`` from the cell's shapes) over the device
time a tick of its five kernels (``link_zero_kernel``,
``link_count_kernel``, ``link_alloc_kernel``, ``link_place_kernel``,
``link_fold_kernel``) in the replay profile."""
import bounds
from profiling import WRAPPER_KERNELS, kernel_named


def read(ctx):
    rp = ctx.get("replay_profile")
    if not rp:
        return None
    s = sum(v[0] for name, v in rp["by_name"].items()
            if any(kernel_named(name, k)
                   for k in WRAPPER_KERNELS["link_demand"]))
    if s <= 0:
        return None
    return 100.0 * bounds.link_demand_bound_ms(ctx["shapes"]) / (
        s * 1e3 / rp["ticks"])
