"""Value-expression AST for the mini-Halide frontend.

Index expressions are affine (``repro_torch.core.poly.AffineExpr``); *value*
expressions are a small arithmetic AST whose leaves are constants and
``FuncRef`` s (reads of other funcs at affine indices), whose nodes are
binary ops, unary ops (``sqrt``, ``erf``, ``exp``) and selects.  The AST
supports:

  * numeric evaluation given a load callback (drives the reference
    interpreter and the cycle-accurate simulator),
  * op counting / depth (PE-count and HLS-latency models, paper Tables IV/V),
  * substitution of func references (inlining) and of iteration vars
    (scheduling rewrites).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Sequence, Tuple, Union

from repro_torch.core.poly import AffineExpr

Number = Union[int, float]


def _sqrt(a: float) -> float:
    return math.sqrt(a) if a >= 0 else math.nan


def _exp(a: float) -> float:
    try:
        return math.exp(a)
    except OverflowError:
        return math.inf


_BINOPS: Dict[str, Callable[[float, float], float]] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b if b != 0 else 0.0,
    "min": min,
    "max": max,
    "shr": lambda a, b: float(int(a) >> int(b)),
    "lt": lambda a, b: 1.0 if a < b else 0.0,
    "gt": lambda a, b: 1.0 if a > b else 0.0,
}

# unary ops: one f32 result of one operand (a square root for a norm's
# scale, ``erf`` for the exact GELU, ``exp`` for a softmax); a negative
# square root is NaN, as IEEE's is, and an ``exp`` past the range inf
_UNOPS: Dict[str, Callable[[float], float]] = {
    "sqrt": _sqrt,
    "erf": math.erf,
    "exp": _exp,
}


class Expr:
    """Base class for value expressions."""

    def _wrap(self, other) -> "Expr":
        if isinstance(other, Expr):
            return other
        if isinstance(other, (int, float)):
            return Const(other)
        raise TypeError(f"cannot use {other!r} in a value expression")

    def __add__(self, o):
        return BinOp("add", self, self._wrap(o))

    def __radd__(self, o):
        return BinOp("add", self._wrap(o), self)

    def __sub__(self, o):
        return BinOp("sub", self, self._wrap(o))

    def __rsub__(self, o):
        return BinOp("sub", self._wrap(o), self)

    def __mul__(self, o):
        return BinOp("mul", self, self._wrap(o))

    def __rmul__(self, o):
        return BinOp("mul", self._wrap(o), self)

    def __truediv__(self, o):
        return BinOp("div", self, self._wrap(o))

    def __lt__(self, o):
        return BinOp("lt", self, self._wrap(o))

    def __gt__(self, o):
        return BinOp("gt", self, self._wrap(o))


@dataclass(frozen=True)
class Const(Expr):
    value: Number


@dataclass(frozen=True)
class IterVal(Expr):
    """Value of an iteration variable (phase selects in demosaic/upsample)."""

    name: str


@dataclass(frozen=True)
class FuncRef(Expr):
    """Read of ``func`` at affine indices (over the consumer's iter vars)."""

    func: str
    indices: Tuple[AffineExpr, ...]


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    a: Expr
    b: Expr


@dataclass(frozen=True)
class UnOp(Expr):
    op: str
    a: Expr


@dataclass(frozen=True)
class Select(Expr):
    cond: Expr
    if_true: Expr
    if_false: Expr


def minimum(a, b) -> Expr:
    e = a if isinstance(a, Expr) else Const(a)
    return BinOp("min", e, e._wrap(b))


def maximum(a, b) -> Expr:
    e = a if isinstance(a, Expr) else Const(a)
    return BinOp("max", e, e._wrap(b))


def sqrt(a) -> Expr:
    return UnOp("sqrt", a if isinstance(a, Expr) else Const(a))


def erf(a) -> Expr:
    return UnOp("erf", a if isinstance(a, Expr) else Const(a))


def exp(a) -> Expr:
    return UnOp("exp", a if isinstance(a, Expr) else Const(a))


# ---------------------------------------------------------------------------
# Evaluation / analysis
# ---------------------------------------------------------------------------


def eval_expr(
    e: Expr,
    point: Mapping[str, int],
    load: Callable[[str, Tuple[int, ...]], float],
) -> float:
    """Evaluate at an iteration point; ``load(func, element)`` supplies reads."""
    if isinstance(e, Const):
        return float(e.value)
    if isinstance(e, IterVal):
        return float(point[e.name])
    if isinstance(e, FuncRef):
        idx = tuple(ix.eval(point) for ix in e.indices)
        return float(load(e.func, idx))
    if isinstance(e, BinOp):
        return _BINOPS[e.op](
            eval_expr(e.a, point, load), eval_expr(e.b, point, load)
        )
    if isinstance(e, UnOp):
        return _UNOPS[e.op](eval_expr(e.a, point, load))
    if isinstance(e, Select):
        c = eval_expr(e.cond, point, load)
        return eval_expr(e.if_true if c != 0 else e.if_false, point, load)
    raise TypeError(f"cannot evaluate {e!r}")


def count_ops(e: Expr) -> int:
    """Arithmetic-op count — the paper's PE-utilization proxy (16-bit ALUs)."""
    if isinstance(e, (Const, FuncRef, IterVal)):
        return 0
    if isinstance(e, BinOp):
        n = count_ops(e.a) + count_ops(e.b)
        # mul/div by power-of-two constants fold into shifts inside a PE but
        # still occupy one ALU op; count every binop as one PE op.
        return n + 1
    if isinstance(e, UnOp):
        return count_ops(e.a) + 1
    if isinstance(e, Select):
        return count_ops(e.cond) + count_ops(e.if_true) + count_ops(e.if_false) + 1
    raise TypeError(f"cannot count {e!r}")


def expr_depth(e: Expr) -> int:
    """Longest op chain — the HLS latency model (1 cycle per ALU level)."""
    if isinstance(e, (Const, FuncRef, IterVal)):
        return 0
    if isinstance(e, BinOp):
        return 1 + max(expr_depth(e.a), expr_depth(e.b))
    if isinstance(e, UnOp):
        return 1 + expr_depth(e.a)
    if isinstance(e, Select):
        return 1 + max(expr_depth(e.cond), expr_depth(e.if_true), expr_depth(e.if_false))
    raise TypeError(f"cannot measure {e!r}")


def refs_in(e: Expr) -> List[FuncRef]:
    out: List[FuncRef] = []

    def walk(n: Expr) -> None:
        if isinstance(n, FuncRef):
            out.append(n)
        elif isinstance(n, BinOp):
            walk(n.a)
            walk(n.b)
        elif isinstance(n, UnOp):
            walk(n.a)
        elif isinstance(n, Select):
            walk(n.cond)
            walk(n.if_true)
            walk(n.if_false)

    walk(e)
    return out


def substitute_refs(e: Expr, table: Mapping[str, Callable[[Tuple[AffineExpr, ...]], Expr]]) -> Expr:
    """Replace reads of funcs in ``table`` by inlined expressions (the paper's
    frontend inlining of non-realized funcs)."""
    if isinstance(e, (Const, IterVal)):
        return e
    if isinstance(e, FuncRef):
        fn = table.get(e.func)
        return fn(e.indices) if fn is not None else e
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute_refs(e.a, table), substitute_refs(e.b, table))
    if isinstance(e, UnOp):
        return UnOp(e.op, substitute_refs(e.a, table))
    if isinstance(e, Select):
        return Select(
            substitute_refs(e.cond, table),
            substitute_refs(e.if_true, table),
            substitute_refs(e.if_false, table),
        )
    raise TypeError(f"cannot substitute in {e!r}")


def substitute_vars(e: Expr, subst: Mapping[str, AffineExpr]) -> Expr:
    """Rewrite the affine indices of every FuncRef (inlining / strip-mining).

    ``IterVal`` leaves referring to substituted vars are only valid when the
    substitution is a pure renaming; enforce that."""
    if isinstance(e, Const):
        return e
    if isinstance(e, IterVal):
        repl = subst.get(e.name)
        if repl is None:
            return e
        names = repl.dims
        if len(names) == 1 and repl.coeff(names[0]) == 1 and repl.const == 0:
            return IterVal(names[0])
        raise ValueError(f"IterVal({e.name}) under non-renaming substitution")
    if isinstance(e, FuncRef):
        return FuncRef(e.func, tuple(ix.substitute(subst) for ix in e.indices))
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute_vars(e.a, subst), substitute_vars(e.b, subst))
    if isinstance(e, UnOp):
        return UnOp(e.op, substitute_vars(e.a, subst))
    if isinstance(e, Select):
        return Select(
            substitute_vars(e.cond, subst),
            substitute_vars(e.if_true, subst),
            substitute_vars(e.if_false, subst),
        )
    raise TypeError(f"cannot substitute in {e!r}")


__all__ = [
    "Expr",
    "Const",
    "IterVal",
    "FuncRef",
    "BinOp",
    "UnOp",
    "Select",
    "minimum",
    "maximum",
    "sqrt",
    "erf",
    "exp",
    "eval_expr",
    "count_ops",
    "expr_depth",
    "refs_in",
    "substitute_refs",
    "substitute_vars",
]
