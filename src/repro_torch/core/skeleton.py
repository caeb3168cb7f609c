"""Tensorized skeleton IR + registry.

A Union skeleton is the paper's ``union_skeleton_model`` struct, adapted to
tensors: instead of a C function pointer, the program is a dense (n_ops, 4)
int32 op array shared SPMD across ranks (every rank runs the same program;
per-rank peers are computed from the rank id and virtual-topology helpers).
The event generator (core/eventgen.py) is the "conceptual_main": it advances
per-rank program counters against the network simulator in situ.

Op encoding (columns: [opcode, a0, a1, a2]):

  COMPUTE    a0=time_us
  P2P        a0=src_rank a1=dst_rank a2=size      (blocking send)
  IP2P       (same, nonblocking)
  XCHG       a0=size  (grid dims in the parallel `grid` array; exchanges
              `size` bytes with every face neighbor, nonblocking + waitall)
  ALLREDUCE  a0=size   (ring: 2(P-1) rounds of size/P)
  BCAST      a0=root a1=size   (binomial tree)
  GATHER     a0=root a1=size   (all other ranks send `size` to root)
  SCATTER    a0=root a1=size   (root sends `size` to each other rank)
  BARRIER    (dissemination, log2 P rounds of 8 bytes)
  LOG/RESET  no-op markers (kept so control flow matches the application)
  END        program end
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

OPCODES = [
    "COMPUTE", "P2P", "IP2P", "XCHG", "ALLREDUCE", "BCAST", "GATHER",
    "SCATTER", "BARRIER", "LOG", "RESET", "END",
]
OP = {name: i for i, name in enumerate(OPCODES)}

# MPI function each opcode models (for Table IV-style validation)
MPI_NAME = {
    OP["P2P"]: "MPI_Send",
    OP["IP2P"]: "MPI_Isend",
    OP["XCHG"]: "MPI_Isend",  # + MPI_Irecv + MPI_Waitall, counted per dim·dir
    OP["ALLREDUCE"]: "MPI_Allreduce",
    OP["BCAST"]: "MPI_Bcast",
    OP["GATHER"]: "MPI_Send",
    OP["SCATTER"]: "MPI_Send",
    OP["BARRIER"]: "MPI_Barrier",
}


@dataclass
class SkeletonProgram:
    """The paper's `union_skeleton_model`, tensorized."""

    program_name: str
    n_ranks: int
    ops: np.ndarray  # (n_ops, 4) int32
    grid: np.ndarray  # (n_ops, 4) int32 cartesian dims for XCHG (0-padded)
    source: str = ""  # original DSL text (deployability: rerun on real HW)

    @property
    def n_ops(self) -> int:
        return int(self.ops.shape[0])

    def op_rows(self, name: str) -> np.ndarray:
        return np.nonzero(self.ops[:, 0] == OP[name])[0]

    # ---- validation helpers (paper §V) ----
    def event_counts(self) -> Dict[str, int]:
        """Count of each modeled MPI function across all ranks."""
        from repro_torch.core.analysis import skeleton_event_counts

        return skeleton_event_counts(self)

    def bytes_per_rank(self) -> np.ndarray:
        from repro_torch.core.analysis import skeleton_bytes_per_rank

        return skeleton_bytes_per_rank(self)


# ---------------------------------------------------------------------------
# registry — "Union maintains a list of available skeleton objects"
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, SkeletonProgram] = {}


def register(skel: SkeletonProgram) -> SkeletonProgram:
    _REGISTRY[skel.program_name] = skel
    return skel


def get(name: str) -> SkeletonProgram:
    if name not in _REGISTRY:
        raise KeyError(
            f"no skeleton {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available() -> List[str]:
    return sorted(_REGISTRY)
