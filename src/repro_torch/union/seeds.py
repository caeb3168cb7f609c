"""Deterministic seed-stream derivation — one definition for every path.

A study cell is identified by one integer ``seed``; every random draw it
makes (engine RNG stream, per-job placement draws) derives from it through
the functions here. The same derivations used to live copy-pasted in
``union.manager`` and ``sched.scheduler``; they are pinned bit-compatible
with those originals by ``tests/test_experiment.py``, so results keyed by
seed stay reproducible across releases.
"""
from __future__ import annotations


def engine_seed(seed: int) -> int:
    """Placement/member seed -> engine RNG stream.

    Knuth multiplicative hash (+1 keeps streams for seeds 0 and 1 distinct
    and nonzero — the engine RNG must not start at 0).
    """
    return (seed * 2654435761 + 1) % (2**32)


def fault_seed(seed: int) -> int:
    """Cell seed -> failure-pattern draw stream (``netsim.faults``).

    Decorrelated from both :func:`engine_seed` and :func:`place_seed` so
    a failure pattern never aliases a placement or RNG draw.
    """
    return (seed * 2246822519 + 3266489917) % (2**32)


def place_seed(seed: int, jid: int) -> int:
    """Per-(run, job) placement stream — decorrelated, deterministic.

    Used by the online scheduler: each admitted trace job draws its
    placement from its own stream so admission order does not perturb
    other jobs' draws.
    """
    return (seed * 1_000_003 + jid * 7919 + 17) % (2**31)
