"""Hybrid-workload simulation runner on the port's engine.

  python -m repro_torch.launch.sim --workload workload1 --topo 1d \
      --placement RG --routing ADP --scale paper --out results/netsim

Workload mixes follow paper Table III; ``baseline-<app>`` simulates one
application alone. Reports land as JSON, the same report the JAX
package's ``python -m repro.launch.sim`` writes. ``--device`` defaults to
``cuda`` and the run raises when there is no card; ``--device cpu`` runs
on the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Optional

from repro_torch.union.manager import _run_member
from repro_torch.union.scenario import MIXES, MIX_HAS_UR, UR_RANKS, mix_scenario  # noqa: F401 (re-export)

log = logging.getLogger("repro_torch")


def run_sim(
    workload: str,
    topo_variant: str,
    placement: str,
    routing: str,
    scale: str = "small",
    seed: int = 0,
    horizon_ms: float = 600.0,
    tick_us: float = 5.0,
    iters_override: Optional[int] = None,
    pool_size: Optional[int] = None,
    stagger_us: float = 0.0,
    device=None,
) -> Dict:
    """One simulation of a builtin mix on ``device`` (CUDA by default):
    the report of the facade's one-member cell, bit for bit, plus
    ``engine_run`` (kept for compatibility, and without a warning, as the
    JAX package's ``run_sim``; new code declares an Experiment)."""
    scenario = mix_scenario(
        workload, topo=topo_variant, scale=scale, placement=placement,
        routing=routing, iters_override=iters_override, tick_us=tick_us,
        horizon_ms=horizon_ms, pool_size=pool_size, stagger_us=stagger_us,
    )
    return _run_member(scenario, seed=seed, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True,
                    help="workload1|workload2|workload3|baseline-<app>")
    ap.add_argument("--topo", default="1d", choices=["1d", "2d"])
    ap.add_argument("--placement", default="RG", choices=["RN", "RR", "RG"])
    ap.add_argument("--routing", default="ADP", choices=["MIN", "ADP"])
    ap.add_argument("--scale", default="small", choices=["small", "paper"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon-ms", type=float, default=600.0)
    ap.add_argument("--tick-us", type=float, default=5.0)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--stagger-us", type=float, default=0.0,
                    help="stagger job arrivals by this offset per job index")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the plain versions of the kernels)")
    ap.add_argument("--out", default="results/netsim")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="diagnostic logging (-v prints a report excerpt)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)

    os.makedirs(args.out, exist_ok=True)
    rep = run_sim(
        args.workload, args.topo, args.placement, args.routing,
        scale=args.scale, seed=args.seed, horizon_ms=args.horizon_ms,
        tick_us=args.tick_us, iters_override=args.iters,
        stagger_us=args.stagger_us, device=args.device,
    )
    tag = (f"{args.workload}__{args.topo}__{args.placement}__{args.routing}"
           f"__{args.scale}_s{args.seed}")
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1, default=float)
    print(f"wrote {path}")
    log.info("%s", json.dumps(
        {k: rep[k] for k in ("virtual_time_ms", "comm_time", "link_load")},
        indent=1, default=float)[:1200])


if __name__ == "__main__":
    main()
