"""Declarative scenario specs — the Union workload-manager input language.

A **Scenario** is a plain dict (JSON-loadable) naming the jobs to co-run,
how large each is, when it arrives, where it lands, and what network it
runs on. It replaces the hardcoded ``MIXES`` table of the original driver:
any mix of `workloads.SPECS` apps, hlo2skeleton-extracted ML jobs, or
inline Union-DSL sources is expressible.

Schema (all keys optional unless noted)::

    {
      "name": "my_mix",
      "topo": "1d" | "2d",            # dragonfly variant   (default 1d)
      "scale": "small" | "paper",     # topology + app scale (default small)
      "placement": "RN" | "RR" | "RG",# paper §IV-C policies (default RG)
      "routing": "MIN" | "ADP",       # (default ADP)
      "tick_us": 5.0,
      "horizon_ms": 600.0,
      "pool_size": 8192,              # default scale-dependent
      "jobs": [                       # required, >= 1 entry
        {"app": "cosmoflow",          # workloads.SPECS name, or
                                      # "hlo:<arch>:<shape>[:<mesh>]" for an
                                      # hlo2skeleton dry-run record
         "ranks": 64,                 # override the spec's scale rank count
         "overrides": {"iters": 2},   # DSL parameter overrides
         "start_us": 0.0},            # arrival offset (staggered arrivals)
        {"app": "pingpong",           # any name + inline DSL source
         "source": "For 4 repetitions { ... }",
         "ranks": 2}
      ],
      "ur": {"ranks": 128,            # uniform-random background source
             "size_bytes": 10240, "interval_us": 1000.0, "start_us": 0.0},
      "reserve": {"jobs": 4, "ranks": 256, "ops": 64}
                                      # optional engine-capacity reservation:
                                      # widens the (Jmax, Pmax, OPmax)
                                      # envelope so differently-shaped
                                      # scenarios share one compiled engine
    }
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

# paper Table III (moved here from launch/sim.py; re-exported there)
MIXES: Dict[str, List[str]] = {
    "workload1": ["cosmoflow", "alexnet", "lammps", "nn"],
    "workload2": ["cosmoflow", "alexnet", "lammps", "milc", "nn"],
    "workload3": ["cosmoflow", "alexnet", "nekbone", "milc", "nn"],
}
MIX_HAS_UR = {"workload1"}

UR_RANKS = {"paper": 4096, "small": 128}


@dataclass
class ScenarioJob:
    app: str
    ranks: Optional[int] = None
    overrides: Dict[str, Any] = field(default_factory=dict)
    start_us: float = 0.0
    source: Optional[str] = None  # inline Union DSL (app becomes the name)

    def validate(self) -> None:
        if not self.app:
            raise ValueError("job needs an 'app' name")
        if self.ranks is not None and self.ranks < 1:
            raise ValueError(f"job {self.app!r}: ranks must be >= 1")
        if self.start_us < 0:
            raise ValueError(f"job {self.app!r}: start_us must be >= 0")
        if self.source is not None and self.ranks is None:
            raise ValueError(f"inline-DSL job {self.app!r} needs explicit ranks")


@dataclass
class URDecl:
    ranks: Optional[int] = None  # default: UR_RANKS[scale]
    size_bytes: float = 10 * 1024
    interval_us: float = 1000.0
    start_us: float = 0.0


@dataclass
class Scenario:
    name: str
    jobs: List[ScenarioJob]
    topo: str = "1d"
    scale: str = "small"
    placement: str = "RG"
    routing: str = "ADP"
    ur: Optional[URDecl] = None
    tick_us: float = 5.0
    horizon_ms: float = 600.0
    pool_size: Optional[int] = None
    # optional capacity reservation: {"jobs": J, "ranks": P, "ops": O}
    # widens the engine envelope beyond this scenario's own needs so other
    # scenarios (up to the reserve) reuse the same compiled engine —
    # ragged campaigns and interactive sweeps skip re-jitting.
    reserve: Optional[Dict[str, int]] = None

    def validate(self) -> None:
        if self.reserve is not None:
            unknown = set(self.reserve) - {"jobs", "ranks", "ops"}
            if unknown:
                raise ValueError(
                    f"unknown reserve keys: {sorted(unknown)}; "
                    "expected subset of {'jobs', 'ranks', 'ops'}"
                )
            for k, v in self.reserve.items():
                if not isinstance(v, int) or v < 1:
                    raise ValueError(f"reserve[{k!r}] must be a positive int")
        from repro_torch.netsim.fabric import fabric_names, scale_names

        if not self.jobs:
            raise ValueError("scenario needs at least one job")
        if self.topo not in fabric_names():
            raise ValueError(
                f"unknown topo {self.topo!r}; valid fabrics: "
                f"{sorted(fabric_names())}"
            )
        if self.scale not in scale_names():
            raise ValueError(
                f"unknown scale {self.scale!r}; valid scales: "
                f"{sorted(scale_names())}"
            )
        if self.placement not in ("RN", "RR", "RG"):
            raise ValueError(f"unknown placement {self.placement!r}")
        if self.routing.upper() not in ("MIN", "ADP", "ADAPTIVE"):
            raise ValueError(f"unknown routing {self.routing!r}")
        for j in self.jobs:
            j.validate()
        names = [j.app for j in self.jobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate job names in scenario: {names}")

    # ---- (de)serialization -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["jobs"] = [
            {k: v for k, v in asdict(j).items() if v not in (None, {}, 0.0) or k == "app"}
            for j in self.jobs
        ]
        if self.ur is None:
            d.pop("ur")
        if self.pool_size is None:
            d.pop("pool_size")
        if self.reserve is None:
            d.pop("reserve")
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any], path: str = "scenario") -> "Scenario":
        from repro_torch.union.validate import (
            check_keys, check_mapping, dataclass_from_dict, reraise_with_path,
        )

        d = dict(check_mapping(d, path, "scenario"))
        jobs = [
            j if isinstance(j, ScenarioJob)
            else dataclass_from_dict(
                ScenarioJob, j, f"{path}.jobs[{i}]", "scenario job")
            for i, j in enumerate(d.pop("jobs", []))
        ]
        ur = d.pop("ur", None)
        if ur is not None and not isinstance(ur, URDecl):
            ur = dataclass_from_dict(URDecl, ur, f"{path}.ur", "ur")
        check_keys(d, cls.__dataclass_fields__, path, "scenario")
        try:
            sc = cls(jobs=jobs, ur=ur, **d)
        except TypeError as e:
            from repro_torch.union.validate import SpecError

            raise SpecError(f"{path}: {e}") from e
        reraise_with_path(sc.validate, path)
        return sc

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def from_json(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def mix_scenario(
    workload: str,
    *,
    topo: str = "1d",
    scale: str = "small",
    placement: str = "RG",
    routing: str = "ADP",
    iters_override: Optional[int] = None,
    tick_us: float = 5.0,
    horizon_ms: float = 600.0,
    pool_size: Optional[int] = None,
    stagger_us: float = 0.0,
) -> Scenario:
    """Builtin scenarios: paper Table III mixes plus ``baseline-<app>``.

    ``stagger_us`` > 0 staggers the mix's job arrivals by that offset per
    job index (the dynamic co-scheduling case the paper could not run).
    """
    if workload.startswith("baseline-"):
        apps = [workload.split("-", 1)[1]]
        with_ur = False
    elif workload in MIXES:
        apps = MIXES[workload]
        with_ur = workload in MIX_HAS_UR
    else:
        raise ValueError(
            f"unknown workload {workload!r}; expected one of "
            f"{sorted(MIXES)} or baseline-<app>"
        )
    jobs = []
    for i, a in enumerate(apps):
        ov: Dict[str, Any] = {}
        if iters_override:
            ov = {"updates" if a == "alexnet" else "iters": iters_override}
        jobs.append(ScenarioJob(app=a, overrides=ov, start_us=i * stagger_us))
    ur = URDecl(ranks=UR_RANKS[scale]) if with_ur else None
    return Scenario(
        name=workload, jobs=jobs, topo=topo, scale=scale, placement=placement,
        routing=routing, ur=ur, tick_us=tick_us, horizon_ms=horizon_ms,
        pool_size=pool_size,
    )


def load_scenario(spec: str) -> Scenario:
    """A scenario from a JSON file path, or a builtin mix/baseline name."""
    import os

    if os.path.exists(spec) or spec.endswith(".json"):
        return Scenario.from_json(spec)
    return mix_scenario(spec)
