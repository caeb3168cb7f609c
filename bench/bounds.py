"""The yardstick's arithmetic: the H100's peaks and the bytes and
operations that the simulator's work needs, from the cell's shapes.

``drain_bound_ms`` and ``link_demand_bytes`` are copies of the byte and
operation counts in the repository's ``chip_smoke.py`` (its
``drain_bound_ms`` and the link-demand phase's ``moved``), taken over a
member batch; ``tick_bytes`` is the tick's own bound. Each counts every
input read once and every output written once.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


@dataclass(frozen=True)
class SimShapes:
    """The shapes of one engine call's state: ``B`` members of ``J`` job
    slots of up to ``Pmax`` ranks and ``OPmax`` ops, a pool of ``M``
    messages of route width ``K``, ``L`` links, ``R`` routers, ``G``
    groups of ``a`` routers with ``lpp`` global links a group pair,
    ``n_apps`` metric rows (the jobs and the UR source), ``Pu`` UR ranks,
    ``W`` router windows and ``BINS`` latency bins."""

    B: int
    J: int
    Pmax: int
    OPmax: int
    M: int
    K: int
    L: int
    R: int
    G: int
    a: int
    lpp: int
    n_apps: int
    Pu: int
    W: int = 512
    BINS: int = 64


def drain_bound_ms(s: SimShapes):
    """The least time of one fused drain tick over the batch: its inputs
    (routes, remaining bytes, active flags, app ids, arrival floors, the
    clock, per-member bandwidths, each link's router) read once and its
    outputs (remaining bytes, rates, delivered flags, per-link and
    per-(app, router) byte deltas) written once at the HBM rate, against
    six float operations a route entry at the float32 rate; the larger,
    and which bounds it."""
    B, M, K, Lp = s.B, s.M, s.K, s.L + 1
    moved = (B * M * K * 4 + B * M * (4 + 1 + 4 + 4) + B * 4 + B * Lp * 4
             + Lp * 4)
    moved += B * M * (4 + 4 + 1) + B * Lp * 4 + B * s.n_apps * s.R * 4
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = B * M * K * 6 / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def link_demand_bytes(s: SimShapes) -> int:
    """Routes, active flags and remaining bytes read once, the per-link
    sums written once."""
    return s.B * s.M * (s.K * 4 + 1 + 4) + s.B * (s.L + 1) * 4


def link_demand_bound_ms(s: SimShapes) -> float:
    return link_demand_bytes(s) / HBM_BYTES_PER_S * 1e3


def state_bytes(s: SimShapes) -> int:
    """One member's SimState: the clock, the rank VMs, the UR source, the
    message pool, the metrics, the rng, the job tables, the UR placement
    and the fault factors."""
    JP = s.J * s.Pmax
    vms = JP * (4 * 4 + 4 + 4 * 3 + 1 + 1)  # 8 int32/f32 leaves, 2 bools
    ur = s.Pu * (4 + 4) + s.Pu * 4
    pool = s.M * (1 + 4 * 7 + s.K * 4 + 4) + 4 + 4
    metrics = (s.n_apps * s.BINS * 4 + s.n_apps * 4 * 4 + (s.L + 1) * 4
               + s.n_apps * s.R * 4 + s.W * s.n_apps * s.R * 4 + 4 + 4)
    jobs = s.J * s.OPmax * 4 * 4 * 2 + s.J * 4 * 2 + JP * 4 * 2 + s.J * 4
    faults = s.L * 4 + s.R * 4
    return 4 + vms + ur + pool + metrics + 8 + jobs + faults


def table_bytes(s: SimShapes) -> int:
    """The fabric's tables that a tick reads: the dragonfly router's
    local-link, gateway and global-link tables and each link's destination
    router (int64) and bandwidth (float32); the engine's link bandwidths
    (float32), source and destination routers (int64) for the fault
    factors; the drain's destination routers (int32, with the dummy
    link)."""
    return (s.R * s.a * 8 + 2 * s.G * s.G * s.lpp * 8 + s.L * (8 + 4)
            + s.L * (4 + 8 + 8) + (s.L + 1) * 4)


def tick_bytes(s: SimShapes) -> int:
    """The bytes a tick must move: every member's state read once and
    written once, the fabric's tables read once."""
    return 2 * s.B * state_bytes(s) + table_bytes(s)


def tick_bound_ms(s: SimShapes) -> float:
    return tick_bytes(s) / HBM_BYTES_PER_S * 1e3
