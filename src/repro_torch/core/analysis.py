"""Skeleton-side accounting: MPI event counts + bytes per rank from the IR.

This is the *skeleton* half of the paper's §V validation (Tables IV/V);
``core/interp.py`` computes the same quantities by walking the original AST
(the "full application" side). The two must agree exactly.

Accounting conventions (applied identically on both sides):
  * bytes(rank) = application-level payload the rank transmits
    (collectives count their buffer size once per call per participating
    sender; tree/ring internals are simulation detail, not app behaviour).
  * events are grouped by modeled MPI function name.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

from repro_torch.core.skeleton import OP, SkeletonProgram


def skeleton_event_counts(skel: SkeletonProgram) -> Dict[str, int]:
    P = skel.n_ranks
    c: Dict[str, int] = defaultdict(int)
    c["MPI_Init"] += P
    for op, a0, a1, a2 in skel.ops:
        if op == OP["P2P"]:
            c["MPI_Send"] += 1
        elif op == OP["IP2P"]:
            c["MPI_Isend"] += 1
        elif op == OP["GATHER"]:
            c["MPI_Send"] += P - 1
        elif op == OP["SCATTER"]:
            c["MPI_Send"] += P - 1
        elif op == OP["XCHG"]:
            ndims = int(a1)
            c["MPI_Isend"] += 2 * ndims * P
            c["MPI_Irecv"] += 2 * ndims * P
            c["MPI_Waitall"] += P
        elif op == OP["ALLREDUCE"]:
            c["MPI_Allreduce"] += P
        elif op == OP["BCAST"]:
            c["MPI_Bcast"] += P
        elif op == OP["BARRIER"]:
            c["MPI_Barrier"] += P
        elif op == OP["END"]:
            c["MPI_Finalize"] += P
    return dict(c)


def skeleton_bytes_per_rank(skel: SkeletonProgram) -> np.ndarray:
    P = skel.n_ranks
    b = np.zeros(P, np.int64)
    for op, a0, a1, a2 in skel.ops:
        if op == OP["P2P"] or op == OP["IP2P"]:
            b[a0] += a2
        elif op == OP["GATHER"]:
            b += a1
            b[a0] -= a1  # root does not send to itself
        elif op == OP["SCATTER"]:
            b[a0] += (P - 1) * a1
        elif op == OP["XCHG"]:
            b += 2 * int(a1) * int(a0)
        elif op == OP["ALLREDUCE"]:
            b += a0
        elif op == OP["BCAST"]:
            b[a0] += a1
    return b
