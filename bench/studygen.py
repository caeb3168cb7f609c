"""The traffic of a study cell: the member seeds of each repeat, the
warm-up's seeds, and which members the output check samples.

A traffic file (``traffic/<cell>.json``) holds ``member_seeds``, the
members of one ``union.run`` call (one repeat: each seed draws its
member's placement and engine rng), and ``checked``, how many of the
window's member reports are compared with the reference's. Every repeat runs the same members,
so every run and every ``--seed`` times the same work: another member's
placement congests the network differently and takes another number of
ticks. ``--seed`` draws the warm-up's members (apart from the window's)
and the members checked.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SEED_SPACE = 2**31  # member seeds lie in [0, 2**31)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


class MemberSeeds:
    """The member seeds of a run's repeats."""

    def __init__(self, traffic: dict, seed: int):
        self.seeds = [int(s) for s in traffic["member_seeds"]]
        self.seed = seed

    @property
    def members(self) -> int:
        return len(self.seeds)

    def block(self) -> List[int]:
        """One repeat's member seeds."""
        return list(self.seeds)

    def warmup(self) -> List[int]:
        """Member seeds for the warm-up call, none of the window's."""
        rng = _rng(self.seed, 1)
        out: List[int] = []
        while len(out) < self.members:
            s = int(rng.integers(0, SEED_SPACE))
            if s not in self.seeds and s not in out:
                out.append(s)
        return out


def checked_members(seed: int, repeats: int, members: int,
                    checked: int) -> List[Tuple[int, int]]:
    """``checked`` (repeat, member) pairs of the window, drawn from the
    seed: member positions in turn, each from a repeat drawn among those
    not yet taken at that position, so every position of a batch (every
    card's share, where the batch is split) is covered first."""
    rng = _rng(seed, 2)
    left = {p: list(range(repeats)) for p in range(members)}
    out: List[Tuple[int, int]] = []
    i = 0
    while len(out) < checked and any(left.values()):
        p = i % members
        i += 1
        if left[p]:
            r = left[p].pop(int(rng.integers(0, len(left[p]))))
            out.append((r, p))
    return out


def late_start(scenario: dict, horizon_us: float) -> dict:
    """The scenario with every job arriving after the horizon: the same
    engine envelope, batch and graphs as the cell's, with almost nothing
    to simulate (the warm-up)."""
    sc = dict(scenario)
    sc["jobs"] = [dict(j, start_us=float(horizon_us) + 1.0)
                  for j in scenario["jobs"]]
    return sc


def member_virtual_ms(reports: Sequence[dict]) -> float:
    return float(sum(r["virtual_time_ms"] for r in reports))
