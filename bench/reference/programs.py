"""DSL program -> the engine's op table (a frozen copy of the port's
`core/skeleton.py` op encoding and `core/translator.py`, without the
skeleton registry).

Op encoding (columns: [opcode, a0, a1, a2]):

  COMPUTE    a0=time_us
  P2P        a0=src_rank a1=dst_rank a2=size      (blocking send)
  IP2P       (same, nonblocking)
  XCHG       a0=size  (grid dims in the parallel `grid` array)
  ALLREDUCE  a0=size   (ring: 2(P-1) rounds of size/P; else recursive doubling)
  BCAST      a0=root a1=size   (binomial tree)
  GATHER     a0=root a1=size   (all other ranks send `size` to root)
  SCATTER    a0=root a1=size   (root sends `size` to each other rank)
  BARRIER    (dissemination, log2 P rounds of 8 bytes)
  LOG/RESET  no-op markers
  END        program end
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import ast_nodes as A
from . import dsl

OPCODES = [
    "COMPUTE", "P2P", "IP2P", "XCHG", "ALLREDUCE", "BCAST", "GATHER",
    "SCATTER", "BARRIER", "LOG", "RESET", "END",
]
OP = {name: i for i, name in enumerate(OPCODES)}
MAX_OPS = 500_000


@dataclass
class Program:
    name: str
    n_ranks: int
    ops: np.ndarray  # (n_ops, 4) int32
    grid: np.ndarray  # (n_ops, 4) int32

    @property
    def n_ops(self) -> int:
        return int(self.ops.shape[0])


def _bind_params(prog: A.Program, n_ranks: int, overrides: Optional[Dict]):
    env = {"num_tasks": float(n_ranks)}
    for p in prog.params:
        env[p.name] = float(p.default)
    for k, v in (overrides or {}).items():
        if k not in env:
            raise ValueError(f"unknown parameter {k!r}")
        env[k] = float(v)
    for a in prog.asserts:
        if n_ranks < a.min_tasks:
            raise ValueError(
                f"assert failed: {a.desc} (num_tasks >= {a.min_tasks})")
    return env


def translate_source(src: str, name: str, n_ranks: int,
                     overrides: Optional[Dict] = None) -> Program:
    """Parse ``src`` and unroll it into one straight-line op table."""
    prog = dsl.parse(src, name)
    env = _bind_params(prog, n_ranks, overrides)
    ops: List[Tuple[int, int, int, int]] = []
    grid: List[Tuple[int, int, int, int]] = []

    def task(sel) -> int:
        if not isinstance(sel, A.TaskId):
            raise ValueError(f"not a task index: {sel}")
        return int(A.eval_expr(sel.index, env))

    def emit(opcode: int, a0=0, a1=0, a2=0, g=(0, 0, 0, 0)):
        if len(ops) >= MAX_OPS:
            raise ValueError(f"program exceeds {MAX_OPS} ops")
        for v in (a0, a1, a2):
            if int(v) > 2**31 - 1:
                raise ValueError(f"operand {v} exceeds int32")
        ops.append((opcode, int(a0), int(a1), int(a2)))
        grid.append(tuple(g))

    def emit_stmt(s):
        if isinstance(s, A.For):
            for _ in range(int(A.eval_expr(s.count, env))):
                for b in s.body:
                    emit_stmt(b)
        elif isinstance(s, A.Compute):
            emit(OP["COMPUTE"], int(round(A.eval_expr(s.usecs, env))))
        elif isinstance(s, A.Send):
            size = int(round(A.eval_expr(s.size, env)))
            code = OP["P2P"] if s.blocking else OP["IP2P"]
            if isinstance(s.src, A.TaskId) and isinstance(s.dst, A.TaskId):
                emit(code, task(s.src), task(s.dst), size)
            elif isinstance(s.src, A.AllTasks) and isinstance(s.dst, A.TaskId):
                emit(OP["GATHER"], task(s.dst), size)
            elif (isinstance(s.src, A.TaskId)
                  and isinstance(s.dst, A.AllOtherTasks)):
                emit(OP["SCATTER"], task(s.src), size)
            else:
                raise ValueError(f"unsupported send pattern {s}")
        elif isinstance(s, A.GridNeighbors):
            size = int(round(A.eval_expr(s.size, env)))
            total = int(np.prod(s.dims))
            if total != n_ranks:
                raise ValueError(f"grid {s.dims} has {total} cells but the "
                                 f"job has {n_ranks} ranks")
            emit(OP["XCHG"], size, len(s.dims), 0,
                 g=tuple(s.dims) + (0,) * (4 - len(s.dims)))
        elif isinstance(s, A.Allreduce):
            emit(OP["ALLREDUCE"], int(round(A.eval_expr(s.size, env))))
        elif isinstance(s, A.Bcast):
            emit(OP["BCAST"], int(A.eval_expr(s.root, env)),
                 int(round(A.eval_expr(s.size, env))))
        elif isinstance(s, A.Barrier):
            emit(OP["BARRIER"])
        elif isinstance(s, A.Reset):
            emit(OP["RESET"])
        elif isinstance(s, A.Log):
            emit(OP["LOG"])
        else:
            raise ValueError(f"unsupported statement {s}")

    for s in prog.body:
        emit_stmt(s)
    emit(OP["END"])
    return Program(name, n_ranks, np.asarray(ops, np.int32),
                   np.asarray(grid, np.int32))
