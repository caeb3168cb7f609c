"""Job arrival traces — the online scheduler's input language.

A **Trace** is a JSON-loadable job stream plus the base system config
(topology, scale, placement policy, routing, tick). Each **TraceJob**
names an app exactly like a scenario job does (`workloads.SPECS` name or
an inline Union-DSL ``source``; the JAX package's ``hlo:`` records are
not ported yet), plus its arrival offset and a user *runtime estimate* — the
quantity EASY backfill reserves against (estimates may be wrong; only the
simulation decides actual runtimes).

Schema::

    {
      "name": "my_trace",
      "topo": "1d", "scale": "small",
      "placement": "RN", "routing": "ADP",
      "tick_us": 5.0, "horizon_ms": 4000.0,
      "slots": 8,                    # engine envelope Jmax (job slots)
      "jobs": [
        {"name": "job0", "app": "cosmoflow", "ranks": 16,
         "arrival_us": 0.0, "est_runtime_us": 50000.0,
         "overrides": {"iters": 2}},
        {"name": "job1", "app": "pp", "ranks": 2, "arrival_us": 1500.0,
         "est_runtime_us": 2000.0, "source": "For 4 repetitions { ... }"}
      ]
    }

:func:`synthetic_trace` draws a stream from the scenario app catalog with
Poisson (exponential) or Weibull interarrival gaps — the SMART-style
"jobs submitted to a shared dragonfly" setting.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.union.scenario import ScenarioJob


@dataclass
class TraceJob:
    """One arrival: an app spec plus arrival time and runtime estimate."""

    name: str
    app: str
    arrival_us: float = 0.0
    ranks: Optional[int] = None
    est_runtime_us: float = 50_000.0
    overrides: Dict[str, Any] = field(default_factory=dict)
    source: Optional[str] = None  # inline Union DSL

    def to_scenario_job(self) -> ScenarioJob:
        """The scenario-side view — reuses the manager's app resolution."""
        return ScenarioJob(
            app=self.app, ranks=self.ranks, overrides=dict(self.overrides),
            source=self.source,
        )

    def validate(self) -> None:
        if not self.name:
            raise ValueError("trace job needs a 'name'")
        if self.arrival_us < 0:
            raise ValueError(f"job {self.name!r}: arrival_us must be >= 0")
        if self.est_runtime_us <= 0:
            raise ValueError(f"job {self.name!r}: est_runtime_us must be > 0")
        self.to_scenario_job().validate()


@dataclass
class Trace:
    name: str
    jobs: List[TraceJob]
    topo: str = "1d"
    scale: str = "small"
    placement: str = "RN"
    routing: str = "ADP"
    tick_us: float = 5.0
    horizon_ms: float = 4000.0
    pool_size: Optional[int] = None
    slots: int = 8  # engine envelope Jmax — concurrent job slots

    def validate(self) -> None:
        from repro_torch.netsim.fabric import fabric_names, scale_names

        if not self.jobs:
            raise ValueError("trace needs at least one job")
        if self.slots < 1:
            raise ValueError("trace needs at least one job slot")
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
        names = [j.name for j in self.jobs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate job names in trace")
        for j in self.jobs:
            j.validate()

    # ---- (de)serialization -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["jobs"] = [
            {k: v for k, v in asdict(j).items()
             if v not in (None, {}) or k in ("name", "app")}
            for j in self.jobs
        ]
        if self.pool_size is None:
            d.pop("pool_size")
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any], path: str = "trace") -> "Trace":
        from repro_torch.union.validate import (
            SpecError, check_keys, check_mapping, dataclass_from_dict,
            reraise_with_path,
        )

        d = dict(check_mapping(d, path, "trace"))
        jobs = [
            j if isinstance(j, TraceJob)
            else dataclass_from_dict(
                TraceJob, j, f"{path}.jobs[{i}]", "trace job")
            for i, j in enumerate(d.pop("jobs", []))
        ]
        check_keys(d, cls.__dataclass_fields__, path, "trace")
        try:
            tr = cls(jobs=jobs, **d)
        except TypeError as e:
            raise SpecError(f"{path}: {e}") from e
        reraise_with_path(tr.validate, path)
        return tr

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def from_json(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_trace(path: str) -> Trace:
    """A trace from a JSON file path."""
    return Trace.from_json(path)


# ---------------------------------------------------------------------------
# synthetic traces from the scenario app catalog
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CatalogApp:
    """One drawable app template for synthetic traces."""

    app: str
    ranks: Optional[int] = None
    est_runtime_us: float = 50_000.0
    weight: float = 1.0
    overrides: Dict[str, Any] = field(default_factory=dict, hash=False)
    source: Optional[str] = None


_PP_SRC = (
    "For 8 repetitions {\n"
    " task 0 sends a 4096 byte message to task 1 then\n"
    " task 1 sends a 4096 byte message to task 0 }"
)
_AR_SRC = (
    "For 4 repetitions {\n"
    " all tasks compute for 500 microseconds then\n"
    " all tasks allreduce a 262144 byte message }"
)
_HALO_SRC = (
    "For 4 repetitions {\n"
    " all tasks compute for 300 microseconds then\n"
    " all tasks exchange a 65536 byte message with their neighbors in a"
    " 4x2 grid }"
)


def default_catalog(scale: str = "small") -> List[CatalogApp]:
    """The default synthetic-trace mix: a UR-ish point-to-point stream, a
    collective-heavy solver, a halo-exchange stencil, and an ML training
    loop (the named ``nn`` SPECS app) — the paper's hybrid-fleet spread,
    sized for CPU-scale runs.
    """
    return [
        CatalogApp(app="pp", ranks=2, est_runtime_us=1_500.0, weight=2.0,
                   source=_PP_SRC),
        CatalogApp(app="ar", ranks=16, est_runtime_us=6_000.0, weight=1.5,
                   source=_AR_SRC),
        CatalogApp(app="halo", ranks=8, est_runtime_us=4_000.0, weight=1.5,
                   source=_HALO_SRC),
        CatalogApp(app="nn", ranks=64, est_runtime_us=4_000.0, weight=1.0,
                   overrides={"iters": 1}),
    ]


def synthetic_trace(
    n_jobs: int,
    *,
    arrival: str = "poisson",
    mean_gap_us: float = 2_000.0,
    weibull_shape: float = 1.5,
    seed: int = 0,
    catalog: Optional[List[CatalogApp]] = None,
    name: Optional[str] = None,
    **base: Any,
) -> Trace:
    """Draw a synthetic arrival trace from an app catalog.

    ``arrival='poisson'`` uses exponential interarrival gaps with mean
    ``mean_gap_us``; ``'weibull'`` uses Weibull gaps with shape
    ``weibull_shape`` scaled to the same mean (shape < 1 gives the bursty
    heavy-tailed arrivals real clusters see). ``base`` forwards any
    :class:`Trace` field (placement, slots, tick_us, ...). Deterministic
    per ``seed``; arrival times are float32-rounded so the engine clock
    can represent them exactly.
    """
    if n_jobs < 1:
        raise ValueError("n_jobs must be >= 1")
    rng = np.random.default_rng(seed)
    if arrival == "poisson":
        gaps = rng.exponential(mean_gap_us, n_jobs)
    elif arrival == "weibull":
        from math import gamma

        scale_us = mean_gap_us / gamma(1.0 + 1.0 / weibull_shape)
        gaps = rng.weibull(weibull_shape, n_jobs) * scale_us
    else:
        raise ValueError(f"unknown arrival process {arrival!r}")
    gaps[0] = 0.0  # first job arrives at t=0
    arrivals = np.cumsum(gaps)

    cat = catalog if catalog is not None else default_catalog(
        base.get("scale", "small"))
    w = np.asarray([c.weight for c in cat], np.float64)
    picks = rng.choice(len(cat), size=n_jobs, p=w / w.sum())

    jobs = []
    for i in range(n_jobs):
        c = cat[picks[i]]
        jobs.append(TraceJob(
            name=f"{c.app}-{i}",
            app=c.app,
            arrival_us=float(np.float32(arrivals[i])),
            ranks=c.ranks,
            est_runtime_us=float(c.est_runtime_us),
            overrides=dict(c.overrides),
            source=c.source,
        ))
    tr = Trace(
        name=name or f"{arrival}-{n_jobs}x-s{seed}", jobs=jobs, **base)
    tr.validate()
    return tr
