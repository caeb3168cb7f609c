"""A scenario file and member seeds -> each member's report, worked out
from the file alone: the programs from the jobs' DSL sources, the fabric,
each member's placement and engine seed, the simulation and the report.

The scenario file is the JSON that the port's ``Scenario.from_json``
reads; the reference takes only jobs with an inline ``source``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .engine import Simulator
from .fabric import NetConfig, dragonfly, place_jobs
from .programs import translate_source


def engine_seed(seed: int) -> int:
    """A member seed -> its engine rng stream (the facade's derivation)."""
    return (seed * 2654435761 + 1) % (2**32)


class Study:
    """One scenario, ready to simulate batches of members."""

    def __init__(self, sc: Dict[str, Any]):
        self.sc = sc
        self.topo = dragonfly(sc.get("topo", "1d"), sc.get("scale", "small"))
        jobs = sc["jobs"]
        for j in jobs:
            if "source" not in j or "ranks" not in j:
                raise ValueError(f"job {j.get('app')!r}: the reference takes "
                                 "jobs with an inline source and ranks")
        self.programs = [translate_source(j["source"], f"{j['app']}_"
                                          f"{j['ranks']}", int(j["ranks"]),
                                          j.get("overrides"))
                         for j in jobs]
        self.names = [j["app"] for j in jobs]
        self.ur = sc.get("ur")
        self.sizes = [p.n_ranks for p in self.programs]
        if self.ur is not None:
            self.ur = dict(dict(size_bytes=10 * 1024, interval_us=1000.0,
                                start_us=0.0), **self.ur)
            self.sizes.append(int(self.ur["ranks"]))
            self.names.append("ur")
        self.start_us = [float(j.get("start_us", 0.0)) for j in jobs]
        self.net = NetConfig(tick_us=float(sc.get("tick_us", 5.0)))
        self.pool_size = int(sc["pool_size"])
        self.horizon_us = float(sc.get("horizon_ms", 600.0)) * 1000.0

    def simulator(self, device, fdt=torch.float32) -> Simulator:
        return Simulator(
            self.topo, self.programs, routing=self.sc.get("routing", "ADP"),
            net=self.net, pool_size=self.pool_size,
            horizon_us=self.horizon_us, start_us=self.start_us, ur=self.ur,
            device=device, fdt=fdt)

    def placements(self, seed: int) -> List[np.ndarray]:
        return place_jobs(self.topo, self.sizes,
                          self.sc.get("placement", "RG"), seed)

    def config(self, seed: int) -> Dict[str, Any]:
        sc = self.sc
        return dict(
            workload=sc["name"], topo=sc.get("topo", "1d"),
            placement=sc.get("placement", "RG"),
            routing=sc.get("routing", "ADP"), scale=sc.get("scale", "small"),
            seed=seed, ranks=list(self.sizes),
            start_us=[float(np.float32(s)) for s in self.start_us],
            envelope=dict(Jmax=len(self.programs),
                          Pmax=max(p.n_ranks for p in self.programs),
                          OPmax=max(p.n_ops for p in self.programs)))


def member_reports(sc: Dict[str, Any], seeds: Sequence[int], device,
                   fdt=torch.float32, max_ticks=None) -> List[Dict[str, Any]]:
    """The report of each member seed, the members simulated as one batch
    on ``device`` in float type ``fdt``."""
    from .report import member_report

    st = Study(sc)
    sim = st.simulator(device, fdt)
    state = sim.init_state([st.placements(s) for s in seeds],
                           [engine_seed(s) for s in seeds])
    state, _ = sim.run(state, max_ticks)
    m = state.metrics

    def host(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()

    leaves = dict(
        t=state.t, lat_cnt=m.lat_cnt, lat_hist=m.lat_hist, lat_sum=m.lat_sum,
        lat_min=m.lat_min, lat_max=m.lat_max, link_bytes=m.link_bytes,
        peak_inject=m.peak_inject, dropped=state.pool.dropped,
        comm_time=state.vms.comm_time, P=state.jobs.P, done=state.vms.done)
    leaves = {k: host(v) for k, v in leaves.items()}
    return [member_report({k: v[b] for k, v in leaves.items()}, st.names,
                          len(st.programs), st.topo, st.net, st.config(s))
            for b, s in enumerate(seeds)]
