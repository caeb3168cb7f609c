"""Public kernel entry points of the port: device dispatch + launch counts.

A wrapper picks its path from where its tensors lie: CPU tensors take the
plain PyTorch version, CUDA tensors launch the hand-written kernel or
raise. There is no fallback from the kernel to the plain version.

``CALLS`` counts, per wrapper, every call; ``LAUNCHES`` counts the calls
that launched the kernel (a drain-tick call is two CUDA launches: count,
then drain). A run on the card that went through the kernel every time
shows ``LAUNCHES == CALLS``; :func:`reset_launches` sets every count to 0.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.drain_tick import drain_tick_cuda, drain_tick_plain

CALLS: Dict[str, int] = {"drain_tick": 0}
LAUNCHES: Dict[str, int] = {"drain_tick": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        CALLS[k] = 0
        LAUNCHES[k] = 0


def drain_tick(routes, bytes_rem, active, job, min_arrive, t, dt, bw_eff,
               link_dst_router, *, n_apps: int, n_routers: int):
    """Fused drain tick (engine steps 2-3) over an explicit member batch.

    Same arguments as the JAX package's ``kernels.ops.drain_tick``;
    ``bw_eff`` is ``(L+1,)`` or per-member ``(B, L+1)``. See
    :mod:`repro_torch.kernels.drain_tick` for shapes and results.
    """
    CALLS["drain_tick"] += 1
    if routes.device.type == "cpu":
        return drain_tick_plain(
            routes, bytes_rem, active, job, min_arrive, t, dt, bw_eff,
            link_dst_router, n_apps, n_routers,
        )
    out = drain_tick_cuda(
        routes, bytes_rem, active, job, min_arrive, t, dt, bw_eff,
        link_dst_router, n_apps, n_routers,
    )
    LAUNCHES["drain_tick"] += 1
    return out
