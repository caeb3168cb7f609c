"""Direct AST interpreter — the "full application" reference.

The paper validates Union by running the *application* (compiled
coNCePTuaL → C+MPI) and the *skeleton* and comparing (a) per-MPI-function
event counts, (b) bytes transmitted per rank, (c) control flow (Fig. 6).
Without an MPI cluster in the loop, the application side is this direct
interpreter over the AST: it never goes through the skeleton IR, so it is
an independent implementation of the program's semantics.

It also produces the control-flow trace (sequence of operation kinds) used
for the Fig. 6-style control-flow equality check.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import ast_nodes as A
from repro_torch.core import dsl
from repro_torch.core.translator import bind_params


class AppRun:
    """Event counts / bytes / control-flow trace of one application run."""

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks
        self.events: Dict[str, int] = defaultdict(int)
        self.bytes = np.zeros(n_ranks, np.int64)
        self.trace: List[str] = []  # control-flow (rank-agnostic op sequence)

    def as_table(self) -> Dict[str, int]:
        return dict(self.events)


def run_application(
    prog: A.Program, n_ranks: int, overrides: Optional[Dict] = None
) -> AppRun:
    env = bind_params(prog, n_ranks, overrides)
    run = AppRun(n_ranks)
    P = n_ranks
    run.events["MPI_Init"] += P

    def ev(e: A.Expr) -> int:
        return int(round(A.eval_expr(e, env)))

    def do(s: A.Stmt):
        if isinstance(s, A.For):
            for _ in range(ev(s.count)):
                for b in s.body:
                    do(b)
            return
        if isinstance(s, A.Compute):
            run.trace.append("compute")
            return
        if isinstance(s, A.Send):
            size = ev(s.size)
            if isinstance(s.src, A.TaskId) and isinstance(s.dst, A.TaskId):
                run.events["MPI_Send" if s.blocking else "MPI_Isend"] += 1
                run.bytes[ev(s.src.index)] += size
                run.trace.append("send")
            elif isinstance(s.src, A.AllTasks) and isinstance(s.dst, A.TaskId):
                root = ev(s.dst.index)
                for r in range(P):
                    if r != root:
                        run.events["MPI_Send"] += 1
                        run.bytes[r] += size
                run.trace.append("gather")
            elif isinstance(s.src, A.TaskId) and isinstance(s.dst, A.AllOtherTasks):
                root = ev(s.src.index)
                for r in range(P):
                    if r != root:
                        run.events["MPI_Send"] += 1
                        run.bytes[root] += size
                run.trace.append("scatter")
            else:
                raise ValueError(f"unsupported send {s}")
            return
        if isinstance(s, A.GridNeighbors):
            size = ev(s.size)
            ndims = len(s.dims)
            for r in range(P):
                run.events["MPI_Isend"] += 2 * ndims
                run.events["MPI_Irecv"] += 2 * ndims
                run.events["MPI_Waitall"] += 1
                run.bytes[r] += 2 * ndims * size
            run.trace.append("xchg")
            return
        if isinstance(s, A.Allreduce):
            size = ev(s.size)
            run.events["MPI_Allreduce"] += P
            run.bytes += size
            run.trace.append("allreduce")
            return
        if isinstance(s, A.Bcast):
            root, size = ev(s.root), ev(s.size)
            run.events["MPI_Bcast"] += P
            run.bytes[root] += size
            run.trace.append("bcast")
            return
        if isinstance(s, A.Barrier):
            run.events["MPI_Barrier"] += P
            run.trace.append("barrier")
            return
        if isinstance(s, (A.Reset, A.Log)):
            run.trace.append("log")
            return
        raise ValueError(f"unsupported stmt {s}")

    for s in prog.body:
        do(s)
    run.events["MPI_Finalize"] += P
    return run


def run_source(src: str, name: str, n_ranks: int, overrides=None) -> AppRun:
    return run_application(dsl.parse(src, name), n_ranks, overrides)


def skeleton_trace(skel) -> List[str]:
    """Control-flow trace of a skeleton (for Fig. 6-style comparison)."""
    from repro_torch.core.skeleton import OP

    names = {
        OP["COMPUTE"]: "compute", OP["P2P"]: "send", OP["IP2P"]: "send",
        OP["XCHG"]: "xchg", OP["ALLREDUCE"]: "allreduce",
        OP["BCAST"]: "bcast", OP["GATHER"]: "gather",
        OP["SCATTER"]: "scatter", OP["BARRIER"]: "barrier",
        OP["LOG"]: "log", OP["RESET"]: "log",
    }
    out = []
    for op, *_ in skel.ops:
        if op == OP["END"]:
            break
        out.append(names[int(op)])
    return out
