"""The Union DSL: a coNCePTuaL-dialect lexer + recursive-descent parser (a
frozen copy of the port's `core/dsl.py`, which the reference parses the
scenario's sources with).

Grammar (keyword-heavy, English-like; `then`, newline or `.` separate
statements; `#` comments). Supported statements — a superset of what the
paper's six workloads need, deliberately close to coNCePTuaL [Pakin 2007]:

  Require language version "1.5".
  reps is "Number of repetitions" and comes from "--reps" or "-r"
      with default 1000.
  Assert that "needs two tasks" with num_tasks >= 2.
  For <expr> repetitions { <stmts> }            # or ... repetitions <stmt>
  task 0 sends a <expr> byte message to task 1
  task 0 asynchronously sends a <expr> byte message to all other tasks
  all tasks exchange a <expr> byte message with their neighbors
      in a 8x8x8 grid                            # NN / MILC pattern
  all tasks allreduce a <expr> byte message      # CosmoFlow/AlexNet/LAMMPS
  task 0 multicasts a <expr> byte message to all other tasks
  all tasks synchronize
  all tasks compute for <expr> microseconds|milliseconds|seconds
  task 0 resets its counters
  task 0 logs "<text>"

Sizes accept units: byte/bytes/KiB/MiB/KB/MB. Expressions: numbers,
declared parameters, num_tasks, + - * / and parentheses.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import ast_nodes as A

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*) |
    (?P<string>"[^"]*") |
    (?P<number>\d+\.\d+|\d+) |
    (?P<op>[{}()+\-*/.,]|>=|<=|==|x) |
    (?P<word>[A-Za-z_][A-Za-z0-9_]*) |
    (?P<nl>\n) |
    (?P<ws>[ \t\r]+)
    """,
    re.VERBOSE,
)

_UNITS = {
    "byte": 1, "bytes": 1,
    "kb": 1000, "mb": 1000**2, "gb": 1000**3,
    "kib": 1024, "mib": 1024**2, "gib": 1024**3,
}
_TIME_UNITS = {
    "microsecond": 1.0, "microseconds": 1.0, "usecs": 1.0,
    "millisecond": 1e3, "milliseconds": 1e3, "msecs": 1e3, "ms": 1e3,
    "second": 1e6, "seconds": 1e6,
}


class ParseError(ValueError):
    pass


def tokenize(src: str) -> List[str]:
    toks = []
    for m in _TOKEN_RE.finditer(src):
        kind = m.lastgroup
        if kind in ("comment", "ws", "nl"):
            continue
        text = m.group()
        toks.append(text.lower() if kind == "word" else text)
    return toks


class Parser:
    def __init__(self, toks: List[str], name: str):
        self.toks = toks
        self.i = 0
        self.prog = A.Program(name=name)
        self.param_names = {"num_tasks"}

    # ---- token helpers ----
    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ParseError("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, *words):
        for w in words:
            t = self.next()
            if t != w:
                raise ParseError(f"expected {w!r}, got {t!r} (pos {self.i})")

    def accept(self, word) -> bool:
        if self.peek() == word:
            self.i += 1
            return True
        return False

    def skip_seps(self):
        while self.peek() in (".", "then"):
            self.i += 1

    # ---- expressions ----
    def parse_expr(self) -> A.Expr:
        e = self.parse_term()
        while self.peek() in ("+", "-"):
            op = self.next()
            e = A.BinOp(op, e, self.parse_term())
        return e

    def parse_term(self) -> A.Expr:
        e = self.parse_atom()
        while self.peek() in ("*", "/"):
            op = self.next()
            e = A.BinOp(op, e, self.parse_atom())
        return e

    def parse_atom(self) -> A.Expr:
        t = self.next()
        if t == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if re.fullmatch(r"\d+\.\d+|\d+", t):
            val = float(t)
            # optional size unit
            if self.peek() in _UNITS:
                val *= _UNITS[self.next()]
            return A.Num(val)
        if t in self.param_names:
            return A.Var(t)
        raise ParseError(f"unexpected token {t!r} in expression")

    def parse_size_expr(self) -> A.Expr:
        e = self.parse_expr()
        if self.peek() in _UNITS:
            unit = self.next()
            e = A.BinOp("*", e, A.Num(_UNITS[unit]))
        return e

    # ---- task selectors ----
    def parse_task_sel(self) -> A.TaskSel:
        if self.accept("all"):
            if self.accept("other"):
                self.expect("tasks")
                return A.AllOtherTasks()
            self.expect("tasks")
            return A.AllTasks()
        self.expect("task")
        return A.TaskId(self.parse_expr())

    # ---- statements ----
    def parse_program(self) -> A.Program:
        self.skip_seps()
        while self.peek() is not None:
            self.parse_stmt_into(self.prog.body)
            self.skip_seps()
        return self.prog

    def parse_stmt_into(self, out: List[A.Stmt]):
        t = self.peek()
        if t == "require":
            self.expect("require", "language", "version")
            self.prog.version = self.next().strip('"')
            return
        if t == "assert":
            self.expect("assert", "that")
            desc = self.next().strip('"')
            self.expect("with", "num_tasks", ">=")
            n = int(float(self.next()))
            self.prog.asserts.append(A.Assert(desc, n))
            return
        # parameter declaration: <name> is "<desc>" and comes from ...
        if (
            t not in ("task", "all", "for")
            and self.peek(1) == "is"
        ):
            name = self.next()
            self.expect("is")
            desc = self.next().strip('"')
            self.expect("and", "comes", "from")
            flags = [self.next().strip('"')]
            while self.accept("or"):
                flags.append(self.next().strip('"'))
            self.expect("with", "default")
            default = float(self.next())
            self.prog.params.append(A.ParamDecl(name, desc, tuple(flags), default))
            self.param_names.add(name)
            return
        if t == "for":
            self.expect("for")
            count = self.parse_expr()
            self.expect("repetitions")
            body: List[A.Stmt] = []
            if self.accept("{"):
                self.skip_seps()
                while not self.accept("}"):
                    self.parse_stmt_into(body)
                    self.skip_seps()
            else:
                self.skip_seps()
                self.parse_stmt_into(body)
                # chain subsequent `then`-joined statements into the loop
                while self.peek() == "then":
                    self.skip_seps()
                    if self.peek() is None or self.peek() == "for":
                        break
                    self.parse_stmt_into(body)
            out.append(A.For(count, tuple(body)))
            return
        # task-prefixed statements
        sel = self.parse_task_sel()
        verb = self.next()
        if verb in ("sends", "send", "asynchronously"):
            blocking = verb != "asynchronously"
            if not blocking:
                if self.peek() in ("sends", "send"):
                    self.next()
            self.expect("a")
            size = self.parse_size_expr()
            if self.peek() in ("byte",):
                self.next()
            self.expect("message", "to")
            dst = self.parse_task_sel()
            out.append(A.Send(sel, dst, size, blocking))
            return
        if verb == "exchange" or verb == "exchanges":
            self.expect("a")
            size = self.parse_size_expr()
            if self.peek() == "byte":
                self.next()
            self.expect("message", "with", "their", "neighbors", "in", "a")
            dims = [int(float(self.next()))]
            while self.accept("x"):
                dims.append(int(float(self.next())))
            self.expect("grid")
            out.append(A.GridNeighbors(tuple(dims), size))
            return
        if verb in ("allreduce", "allreduces"):
            self.expect("a")
            size = self.parse_size_expr()
            if self.peek() == "byte":
                self.next()
            self.expect("message")
            out.append(A.Allreduce(size))
            return
        if verb in ("multicasts", "multicast"):
            self.expect("a")
            size = self.parse_size_expr()
            if self.peek() == "byte":
                self.next()
            self.expect("message", "to", "all", "other", "tasks")
            if not isinstance(sel, A.TaskId):
                raise ParseError("multicast root must be a single task")
            out.append(A.Bcast(sel.index, size))
            return
        if verb in ("synchronize", "synchronizes"):
            out.append(A.Barrier())
            return
        if verb in ("compute", "computes", "sleep", "sleeps"):
            self.expect("for")
            t_expr = self.parse_expr()
            unit = self.next()
            if unit not in _TIME_UNITS:
                raise ParseError(f"unknown time unit {unit!r}")
            out.append(A.Compute(sel, A.BinOp("*", t_expr, A.Num(_TIME_UNITS[unit]))))
            return
        if verb in ("resets", "reset"):
            self.expect("its", "counters")
            out.append(A.Reset(sel))
            return
        if verb in ("logs", "log"):
            what = self.next().strip('"') if self.peek().startswith('"') else ""
            out.append(A.Log(sel, what))
            return
        raise ParseError(f"unknown verb {verb!r}")


def parse(src: str, name: str = "program") -> A.Program:
    return Parser(tokenize(src), name).parse_program()
