"""The Union translator: DSL AST -> tensorized skeleton.

Mirrors the paper's three steps (§III-C):
  1. *initialization* — construct the skeleton object (name + program) and
     register it in the skeleton list;
  2. *skeletonization* — communication buffers are never allocated (the IR
     carries byte counts only) and computation becomes COMPUTE delay ops
     (the paper's UNION_Compute());
  3. *interception* — every communication statement lowers to a UNION_MPI_*
     op consumed by the event generator instead of a real MPI call.

Loops are unrolled at translation time (the skeleton is a straight-line
event program; cap guards against runaway reps).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ast_nodes as A
from repro_torch.core import dsl
from repro_torch.core.skeleton import OP, SkeletonProgram, register

MAX_OPS = 500_000


class TranslateError(ValueError):
    pass


def bind_params(prog: A.Program, n_ranks: int, overrides: Optional[Dict] = None):
    env = {"num_tasks": float(n_ranks)}
    for p in prog.params:
        env[p.name] = float(p.default)
    for k, v in (overrides or {}).items():
        if k not in env:
            raise TranslateError(f"unknown parameter {k!r}")
        env[k] = float(v)
    for a in prog.asserts:
        if n_ranks < a.min_tasks:
            raise TranslateError(f"assert failed: {a.desc} (num_tasks >= {a.min_tasks})")
    return env


def _task_index(sel: A.TaskSel, env) -> int:
    assert isinstance(sel, A.TaskId)
    return int(A.eval_expr(sel.index, env))


def translate(
    prog: A.Program,
    n_ranks: int,
    overrides: Optional[Dict] = None,
    source: str = "",
) -> SkeletonProgram:
    env = bind_params(prog, n_ranks, overrides)
    ops: List[Tuple[int, int, int, int]] = []
    grid: List[Tuple[int, int, int, int]] = []

    def emit(opcode: int, a0=0, a1=0, a2=0, g=(0, 0, 0, 0)):
        if len(ops) >= MAX_OPS:
            raise TranslateError(f"skeleton exceeds {MAX_OPS} ops")
        for v in (a0, a1, a2):
            if int(v) > 2**31 - 1:
                raise TranslateError(
                    f"operand {v} exceeds int32 (message sizes must be "
                    f"< 2 GiB — bucket large collectives, cf. hlo2skeleton)"
                )
        ops.append((opcode, int(a0), int(a1), int(a2)))
        grid.append(tuple(g))

    def emit_stmt(s: A.Stmt):
        if isinstance(s, A.For):
            reps = int(A.eval_expr(s.count, env))
            for _ in range(reps):
                for b in s.body:
                    emit_stmt(b)
            return
        if isinstance(s, A.Compute):
            usecs = int(round(A.eval_expr(s.usecs, env)))
            emit(OP["COMPUTE"], usecs)
            return
        if isinstance(s, A.Send):
            size = int(round(A.eval_expr(s.size, env)))
            code = OP["P2P"] if s.blocking else OP["IP2P"]
            if isinstance(s.src, A.TaskId) and isinstance(s.dst, A.TaskId):
                emit(code, _task_index(s.src, env), _task_index(s.dst, env), size)
            elif isinstance(s.src, A.AllTasks) and isinstance(s.dst, A.TaskId):
                emit(OP["GATHER"], _task_index(s.dst, env), size)
            elif isinstance(s.src, A.TaskId) and isinstance(s.dst, A.AllOtherTasks):
                emit(OP["SCATTER"], _task_index(s.src, env), size)
            else:
                raise TranslateError(f"unsupported send pattern {s}")
            return
        if isinstance(s, A.GridNeighbors):
            size = int(round(A.eval_expr(s.size, env)))
            dims = tuple(s.dims) + (0,) * (4 - len(s.dims))
            total = 1
            for d in s.dims:
                total *= d
            if total != n_ranks:
                raise TranslateError(
                    f"grid {s.dims} has {total} cells but job has {n_ranks} ranks"
                )
            emit(OP["XCHG"], size, len(s.dims), 0, g=dims)
            return
        if isinstance(s, A.Allreduce):
            emit(OP["ALLREDUCE"], int(round(A.eval_expr(s.size, env))))
            return
        if isinstance(s, A.Bcast):
            emit(OP["BCAST"], int(A.eval_expr(s.root, env)),
                 int(round(A.eval_expr(s.size, env))))
            return
        if isinstance(s, A.Barrier):
            emit(OP["BARRIER"])
            return
        if isinstance(s, A.Reset):
            emit(OP["RESET"])
            return
        if isinstance(s, A.Log):
            emit(OP["LOG"])
            return
        raise TranslateError(f"unsupported statement {s}")

    for s in prog.body:
        emit_stmt(s)
    emit(OP["END"])

    skel = SkeletonProgram(
        program_name=prog.name,
        n_ranks=n_ranks,
        ops=np.asarray(ops, np.int32),
        grid=np.asarray(grid, np.int32),
        source=source,
    )
    return register(skel)


def translate_source(
    src: str, name: str, n_ranks: int, overrides: Optional[Dict] = None
) -> SkeletonProgram:
    return translate(dsl.parse(src, name), n_ranks, overrides, source=src)


# ---------------------------------------------------------------------------
# debug back-end: C-like dump mimicking the paper's Fig. 5 generated code
# ---------------------------------------------------------------------------

def generate_c_stub(skel: SkeletonProgram) -> str:
    from repro_torch.core.skeleton import OPCODES

    lines = [
        "/* Auto-generated by the Union translator (debug backend) */",
        "#include <union_api.h>",
        "",
        f"static int {skel.program_name}_main (int argc, char *argv[]) {{",
        "  UNION_Init(&argc, &argv);",
    ]
    for i, (op, a0, a1, a2) in enumerate(skel.ops):
        name = OPCODES[op]
        if name == "COMPUTE":
            lines.append(f"  UNION_Compute({a0} /* us */);")
        elif name in ("P2P", "IP2P"):
            fn = "UNION_MPI_Send" if name == "P2P" else "UNION_MPI_Isend"
            lines.append(f"  if (rank=={a0}) {fn}(NULL /* skeletonized */, {a2}, {a1});")
        elif name == "XCHG":
            dims = tuple(int(x) for x in skel.grid[i][:a1])
            lines.append(f"  UNION_Neighbor_alltoall(NULL, {a0}, grid{dims});")
        elif name == "ALLREDUCE":
            lines.append(f"  UNION_MPI_Allreduce(NULL, NULL, {a0});")
        elif name == "BCAST":
            lines.append(f"  UNION_MPI_Bcast(NULL, {a1}, {a0});")
        elif name == "GATHER":
            lines.append(f"  if (rank!={a0}) UNION_MPI_Send(NULL, {a1}, {a0});")
        elif name == "SCATTER":
            lines.append(f"  if (rank=={a0}) for (int p=0;p<nranks;p++) if (p!=rank) UNION_MPI_Send(NULL, {a1}, p);")
        elif name == "BARRIER":
            lines.append("  UNION_MPI_Barrier();")
        elif name == "END":
            break
    lines += ["  UNION_Finalize();", "  return 0;", "}", "", (
        "static struct union_skeleton_model model = {\n"
        f"  .program_name = \"{skel.program_name}\",\n"
        f"  .conceptual_main = {skel.program_name}_main,\n"
        "};"
    )]
    return "\n".join(lines)
