"""AST for the Union dialect of coNCePTuaL (see dsl.py grammar): a frozen copy of the port's `core/ast_nodes.py`."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


# ---- expressions ----

@dataclass(frozen=True)
class Num:
    value: float


@dataclass(frozen=True)
class Var:
    name: str  # parameter name or builtin (num_tasks)


@dataclass(frozen=True)
class BinOp:
    op: str  # + - * /
    lhs: "Expr"
    rhs: "Expr"


Expr = Union[Num, Var, BinOp]


def eval_expr(e: Expr, env) -> float:
    if isinstance(e, Num):
        return e.value
    if isinstance(e, Var):
        if e.name not in env:
            raise KeyError(f"unbound variable {e.name!r}")
        return env[e.name]
    if isinstance(e, BinOp):
        a, b = eval_expr(e.lhs, env), eval_expr(e.rhs, env)
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[e.op]
    raise TypeError(e)


# ---- task selectors ----

@dataclass(frozen=True)
class AllTasks:
    pass


@dataclass(frozen=True)
class TaskId:
    index: Expr


@dataclass(frozen=True)
class AllOtherTasks:  # valid as a send target only
    pass


TaskSel = Union[AllTasks, TaskId, AllOtherTasks]


# ---- statements ----

@dataclass(frozen=True)
class ParamDecl:
    name: str
    desc: str
    flags: Tuple[str, ...]
    default: float


@dataclass(frozen=True)
class Assert:
    desc: str
    # only num_tasks >= N is supported (paper usage)
    min_tasks: int


@dataclass(frozen=True)
class Send:
    src: TaskSel
    dst: TaskSel
    size: Expr
    blocking: bool = True


@dataclass(frozen=True)
class GridNeighbors:
    """all tasks exchange `size` with each face neighbor of a cartesian grid
    (nonblocking sendrecv per dimension, then wait) — the paper's NN/MILC
    pattern."""
    dims: Tuple[int, ...]
    size: Expr
    periodic: bool = True


@dataclass(frozen=True)
class Allreduce:
    size: Expr


@dataclass(frozen=True)
class Bcast:
    root: Expr
    size: Expr


@dataclass(frozen=True)
class Barrier:
    pass


@dataclass(frozen=True)
class Compute:
    tasks: TaskSel
    usecs: Expr


@dataclass(frozen=True)
class Reset:
    tasks: TaskSel


@dataclass(frozen=True)
class Log:
    tasks: TaskSel
    what: str


@dataclass(frozen=True)
class For:
    count: Expr
    body: Tuple["Stmt", ...]


Stmt = Union[Send, GridNeighbors, Allreduce, Bcast, Barrier, Compute, Reset, Log, For]


@dataclass
class Program:
    name: str
    params: List[ParamDecl] = field(default_factory=list)
    asserts: List[Assert] = field(default_factory=list)
    body: List[Stmt] = field(default_factory=list)
    version: Optional[str] = None
