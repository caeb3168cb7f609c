"""Simulation configuration (paper §IV-A defaults)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NetConfig:
    # bandwidths (bytes/s) — paper: terminal 16 GiB/s, local 4.69, global 5.25
    terminal_bw: float = 16 * 2**30
    local_bw: float = 4.69 * 2**30
    global_bw: float = 5.25 * 2**30
    hop_latency_us: float = 0.5  # per traversed link (router+wire)
    tick_us: float = 1.0  # Δt of the tensor-timestepped engine
    # historical route-row width; superseded by the fabric's own
    # ``route_width`` (kept for spec/cache-key stability)
    max_route_links: int = 10
    # message pool / emission limits
    pool_size: int = 65536
    max_emit_per_rank: int = 8
    # metrics
    window_us: float = 500.0  # paper: 0.5 ms router-counter windows
    max_windows: int = 512
    latency_hist_bins: int = 64
    latency_hist_lo_us: float = 0.5  # first bin edge
    latency_hist_ratio: float = 1.25  # geometric bin growth
