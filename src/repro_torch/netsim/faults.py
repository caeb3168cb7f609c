"""Degraded fabrics as runtime data: failure patterns and fault schedules.

The PyTorch counterpart of the JAX package's ``netsim/faults.py``. The
engine carries a :class:`FaultState` — per-link bandwidth factors and
per-router health factors — as ordinary ``SimState`` leaves with the
member batch dim, so one engine serves an ensemble of different failure
patterns.

Three layers, host side:

* :class:`FaultState` — the resolved runtime mask. ``link_bw_factor``
  is ``(L,)`` float32 (1.0 healthy, 0.0 dead, in-between degraded);
  ``router_factor`` is ``(R,)`` float32 and multiplies into every link
  touching that router. The engine computes the effective per-link
  factor each tick::

      eff[l] = link_bw_factor[l] * router_factor[src[l]] * router_factor[dst[l]]

  Links with ``eff == 0`` read as **infinite demand** to adaptive route
  selection (ADP detours around them) and drain at zero bandwidth (MIN
  stalls). Healthy factors are exact 1.0 multiplies and exact +0.0
  demand adds, so healthy runs are bit-identical to a fault-free engine.

* :class:`FaultEvent` — one timed change at sim-time ``t_us``: a pattern
  selector (explicit ids, random fraction, fabric level, contiguous
  router block) plus the bandwidth ``factor`` to set the selection to.

* :class:`FailureSpec` — a named list of events. ``timeline(topo,
  seed)`` resolves the cumulative :class:`FaultState` after each
  distinct event time. The port applies entry 0 at ``init_state``; later
  entries are applied between runs with :func:`with_faults` /
  :func:`set_member_faults`.

Random draws are seeded via :func:`repro_torch.union.seeds.fault_seed`
with numpy's generator, so a cell's failure pattern is the JAX
package's bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FaultState",
    "FaultEvent",
    "FailureSpec",
    "HEALTHY",
    "healthy_state",
    "parse_failure",
    "normalize_failures",
    "set_member_faults",
    "with_faults",
]

_KINDS = ("links", "routers", "random_links", "random_routers",
          "level", "router_block")


class FaultState(NamedTuple):
    """Resolved runtime fault mask for one member (host or device arrays).

    ``link_bw_factor``: ``(L,)`` float32, multiplies each link's healthy
    bandwidth. ``router_factor``: ``(R,)`` float32, multiplies into all
    links incident on the router. Batched states carry ``(B, L)`` /
    ``(B, R)`` leaves.
    """

    link_bw_factor: Any
    router_factor: Any


def healthy_state(topo) -> FaultState:
    """All-ones factors for ``topo`` (numpy; the engine casts on init)."""
    return FaultState(
        link_bw_factor=np.ones(len(topo.link_bw), np.float32),
        router_factor=np.ones(int(topo.n_routers), np.float32),
    )


@dataclass(frozen=True)
class FaultEvent:
    """One timed fault change: at ``t_us``, set the selected links (or
    all links of the selected routers) to bandwidth ``factor``.

    Selectors (exactly one per event):

    * ``kind="links"`` — explicit ``links`` ids;
    * ``kind="routers"`` — explicit ``routers`` ids (sets their
      ``router_factor``);
    * ``kind="random_links"`` — ``ceil(fraction * n_fabric_links)``
      fabric links drawn uniformly without replacement (terminal links
      are never drawn: losing one severs its rank, a node failure that
      the router kinds model);
    * ``kind="random_routers"`` — ``ceil(fraction * R)`` routers;
    * ``kind="level"`` — the fabric level named ``level`` (e.g.
      ``"global"``), optionally thinned to a random ``fraction`` of it;
    * ``kind="router_block"`` — a contiguous block of
      ``ceil(fraction * R)`` routers at a seeded offset (a correlated
      pod or plane outage).

    Random draws derive from ``fault_seed(cell_seed)`` plus the event's
    index, or its ``seed`` when given: the same cell reproduces the same
    pattern, and a down event is exactly undone by an up event with the
    same selector and seed and ``factor=1.0``.
    """

    t_us: float
    kind: str
    factor: float = 0.0
    links: Optional[Tuple[int, ...]] = None
    routers: Optional[Tuple[int, ...]] = None
    level: Optional[str] = None
    fraction: float = 0.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault event kind {self.kind!r}; "
                f"expected one of {_KINDS}")
        if self.kind == "links" and not self.links:
            raise ValueError("kind='links' needs a non-empty links list")
        if self.kind == "routers" and not self.routers:
            raise ValueError("kind='routers' needs a non-empty routers list")
        if self.kind == "level" and not self.level:
            raise ValueError("kind='level' needs a level name")
        if self.kind in ("random_links", "random_routers", "router_block") \
                and not (0.0 < self.fraction <= 1.0):
            raise ValueError(
                f"kind={self.kind!r} needs fraction in (0, 1], "
                f"got {self.fraction}")
        if not (0.0 <= self.factor):
            raise ValueError(f"factor must be >= 0, got {self.factor}")

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = dict(t_us=float(self.t_us), kind=self.kind,
                                 factor=float(self.factor))
        if self.links is not None:
            d["links"] = [int(x) for x in self.links]
        if self.routers is not None:
            d["routers"] = [int(x) for x in self.routers]
        if self.level is not None:
            d["level"] = self.level
        if self.fraction:
            d["fraction"] = float(self.fraction)
        if self.seed is not None:
            d["seed"] = int(self.seed)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        known = {"t_us", "kind", "factor", "links", "routers", "level",
                 "fraction", "seed"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown fault event keys: {sorted(extra)}")
        d = dict(d)
        for k in ("links", "routers"):
            if d.get(k) is not None:
                d[k] = tuple(int(x) for x in d[k])
        return cls(**d)

    def _draw(self, topo, cell_seed: int, index: int) -> Tuple[
            np.ndarray, np.ndarray]:
        """Resolve the selector to (link_ids, router_ids) for ``topo``."""
        # imported here: repro_torch.union imports the engine, which
        # imports this module
        from repro_torch.union.seeds import fault_seed

        L = len(topo.link_bw)
        R = int(topo.n_routers)
        base = fault_seed(int(cell_seed))
        salt = int(self.seed) if self.seed is not None else 7919 * index
        rng = np.random.default_rng((base + salt) % (2**63))
        none = np.zeros(0, np.int64)
        if self.kind == "links":
            ids = np.asarray(self.links, np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= L):
                raise ValueError(f"link id out of range [0, {L})")
            return ids, none
        if self.kind == "routers":
            ids = np.asarray(self.routers, np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= R):
                raise ValueError(f"router id out of range [0, {R})")
            return none, ids
        if self.kind == "random_links":
            # fabric links only; terminal ids are [0, 2*n_nodes)
            t0 = 2 * int(topo.n_nodes)
            n_fab = L - t0
            k = min(n_fab, int(math.ceil(self.fraction * n_fab)))
            return t0 + rng.choice(n_fab, size=k, replace=False), none
        if self.kind == "random_routers":
            k = min(R, int(math.ceil(self.fraction * R)))
            return none, rng.choice(R, size=k, replace=False)
        if self.kind == "level":
            levels = topo.link_levels()
            if self.level not in levels:
                raise ValueError(
                    f"fabric has no level {self.level!r}; "
                    f"levels: {sorted(levels)}")
            ids = np.flatnonzero(levels[self.level])
            if self.fraction and self.fraction < 1.0:
                k = max(1, int(math.ceil(self.fraction * ids.size)))
                ids = rng.choice(ids, size=min(k, ids.size), replace=False)
            return ids.astype(np.int64), none
        # router_block: contiguous routers at a seeded offset
        k = max(1, min(R, int(math.ceil(self.fraction * R))))
        start = int(rng.integers(0, R))
        ids = (start + np.arange(k)) % R
        return none, ids.astype(np.int64)


@dataclass
class FailureSpec:
    """A named failure scenario: a (possibly empty) schedule of events.
    An empty schedule is the healthy baseline."""

    name: str = "healthy"
    events: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        if not self.name or "/" in self.name:
            raise ValueError(
                f"failure name must be non-empty and '/'-free, "
                f"got {self.name!r}")
        self.events = sorted(
            [e if isinstance(e, FaultEvent) else FaultEvent.from_dict(e)
             for e in self.events],
            key=lambda e: float(e.t_us))

    @property
    def is_healthy(self) -> bool:
        return not self.events

    @property
    def has_timed_events(self) -> bool:
        return any(float(e.t_us) > 0.0 for e in self.events)

    def to_dict(self) -> Dict[str, Any]:
        return dict(name=self.name,
                    events=[e.to_dict() for e in self.events])

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FailureSpec":
        extra = set(d) - {"name", "events"}
        if extra:
            raise ValueError(f"unknown failure spec keys: {sorted(extra)}")
        return cls(name=d.get("name", "healthy"),
                   events=list(d.get("events", [])))

    def timeline(self, topo, cell_seed: int) -> List[
            Tuple[float, FaultState]]:
        """Cumulative :class:`FaultState` (numpy) at each distinct event
        time.

        Entry 0 is always ``(0.0, <state>)`` — the t=0 initial mask with
        every ``t_us <= 0`` event applied (all-ones when healthy). Later
        entries carry the mask in force *from* that time on.
        """
        link_f = np.ones(len(topo.link_bw), np.float32)
        router_f = np.ones(int(topo.n_routers), np.float32)
        out: List[Tuple[float, FaultState]] = []
        i = 0
        while i < len(self.events):
            t = float(self.events[i].t_us)
            while i < len(self.events) \
                    and float(self.events[i].t_us) == t:
                ev = self.events[i]
                links, routers = ev._draw(topo, cell_seed, i)
                link_f[links] = np.float32(ev.factor)
                router_f[routers] = np.float32(ev.factor)
                i += 1
            out.append((max(t, 0.0),
                        FaultState(link_f.copy(), router_f.copy())))
        if not out or out[0][0] > 0.0:
            out.insert(0, (0.0, healthy_state(topo)))
        # collapse several t<=0 snapshots into one initial entry
        while len(out) > 1 and out[1][0] <= 0.0:
            out.pop(0)
        return out

    def initial_state(self, topo, cell_seed: int) -> FaultState:
        """The t=0 mask (pattern generators resolved, timed events not)."""
        return self.timeline(topo, cell_seed)[0][1]


HEALTHY = FailureSpec()


def parse_failure(spec: Any) -> FailureSpec:
    """Normalize one failure entry to a :class:`FailureSpec`.

    Accepts a ``FailureSpec``, a dict (``FailureSpec.from_dict``; a dict
    without ``events`` is one t=0 event), or a shorthand string:

    * ``"healthy"`` — the baseline;
    * ``"links:P"`` — random fraction ``P`` of links dead;
    * ``"routers:P"`` — random fraction ``P`` of routers dead;
    * ``"level:NAME"`` / ``"level:NAME:P"`` — a fabric level (all of it,
      or a random fraction);
    * ``"block:P"`` — a contiguous router block (correlated outage);
    * ``"degrade:P:F"`` — random fraction ``P`` of links at bandwidth
      factor ``F`` instead of dead.

    The spec string itself becomes the failure ``name``.
    """
    if isinstance(spec, FailureSpec):
        return spec
    if isinstance(spec, dict):
        if "events" in spec or set(spec) <= {"name", "events"}:
            return FailureSpec.from_dict(spec)
        d = dict(spec)
        name = d.pop("name", None)
        ev = FaultEvent.from_dict(dict(d, t_us=d.get("t_us", 0.0)))
        return FailureSpec(name=name or ev.kind, events=[ev])
    if not isinstance(spec, str):
        raise ValueError(f"cannot parse failure spec: {spec!r}")
    s = spec.strip()
    if s == "healthy":
        return FailureSpec()
    parts = s.split(":")
    head, rest = parts[0], parts[1:]
    try:
        if head == "links" and len(rest) == 1:
            ev = FaultEvent(0.0, "random_links", fraction=float(rest[0]))
        elif head == "routers" and len(rest) == 1:
            ev = FaultEvent(0.0, "random_routers", fraction=float(rest[0]))
        elif head == "level" and len(rest) in (1, 2):
            ev = FaultEvent(0.0, "level", level=rest[0],
                            fraction=float(rest[1]) if len(rest) == 2
                            else 1.0)
        elif head == "block" and len(rest) == 1:
            ev = FaultEvent(0.0, "router_block", fraction=float(rest[0]))
        elif head == "degrade" and len(rest) == 2:
            ev = FaultEvent(0.0, "random_links", fraction=float(rest[0]),
                            factor=float(rest[1]))
        else:
            raise ValueError(s)
    except ValueError as e:
        raise ValueError(
            f"cannot parse failure spec {spec!r} "
            "(expected healthy | links:P | routers:P | level:NAME[:P] | "
            f"block:P | degrade:P:F): {e}") from None
    return FailureSpec(name=s, events=[ev])


def normalize_failures(
        failures: Optional[Sequence[Any]]) -> Optional[List[FailureSpec]]:
    """Normalize a list of failure entries (None passes through)."""
    if failures is None:
        return None
    out = [parse_failure(x) for x in failures]
    if not out:
        raise ValueError("failures axis must be None or non-empty")
    names = [f.name for f in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate failure names in axis: {names}")
    return out


def _on(fs: FaultState, device) -> FaultState:
    return FaultState(*[torch.as_tensor(np.asarray(x, np.float32)
                                        if not isinstance(x, torch.Tensor)
                                        else x, dtype=torch.float32,
                                        device=device) for x in fs])


def with_faults(state, fs: FaultState):
    """Member-state surgery: replace the fault leaves wholesale, as
    float32 tensors on the state's device."""
    return state._replace(faults=_on(fs, state.faults.link_bw_factor.device))


def set_member_faults(state, member: int, fs: FaultState):
    """Batched-state surgery: a new state whose member ``member`` has the
    fault leaves ``fs`` (the others' rows unchanged)."""
    f = state.faults
    new = _on(fs, f.link_bw_factor.device)
    out = []
    for old, row in zip(f, new):
        old = old.clone()
        old[member] = row
        out.append(old)
    return state._replace(faults=FaultState(*out))
