"""Mini-Halide: Funcs, Vars, reduction domains, and the scheduling language.

Mirrors the subset of Halide the paper relies on (§V-A):

  * pure function definitions over affine indices,
  * reduction updates (``update``) over an ``RDom`` — kept as a *single
    combined statement* as the paper's frontend does; the combiner is a sum
    (``f[...] + term``) or a running maximum (``maximum(f[...], term)``),
  * scheduling directives: ``store_root/compute_root`` (realize a buffer —
    everything else is inlined, Halide's default), ``unroll``,
    ``tile`` (selects the accelerator invocation extents),
    ``hw_accelerate`` / ``stream_to_accelerator`` (host/accelerator split).

Index convention follows Halide: ``f[x, y]`` has ``x`` as the fastest
(innermost) dimension; default loop order is row-major over reversed indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.poly import AffineExpr
from .expr import BinOp, Const, Expr, FuncRef

# how a reduction combines its terms: the binary op of ``acc = op(acc, term)``
COMBINERS = ("add", "max")


class Var:
    """An iteration variable; arithmetic yields affine index expressions."""

    def __init__(self, name: str):
        self.name = name
        self.expr = AffineExpr.var(name)

    def __add__(self, o):
        return self.expr + _aff(o)

    def __radd__(self, o):
        return _aff(o) + self.expr

    def __sub__(self, o):
        return self.expr - _aff(o)

    def __rsub__(self, o):
        return _aff(o) - self.expr

    def __mul__(self, o):
        return self.expr * o

    __rmul__ = __mul__

    def __repr__(self):
        return f"Var({self.name})"


def _aff(o) -> AffineExpr:
    if isinstance(o, Var):
        return o.expr
    return AffineExpr.of(o)


class RDom:
    """Reduction domain: ordered reduction variables with extents."""

    def __init__(self, *extents: int, name: str = "r"):
        self.vars: List[Var] = [Var(f"{name}{i}") for i in range(len(extents))]
        self.extents: Tuple[int, ...] = tuple(extents)

    def __getitem__(self, i: int) -> Var:
        return self.vars[i]

    def __iter__(self):
        return iter(self.vars)


@dataclass
class Reduction:
    rvars: Tuple[str, ...]       # reduction dim names, outermost first
    rextents: Tuple[int, ...]
    init: Expr
    term: Expr                   # combined statement: acc = acc + term
    unrolled: bool = False       # fully-unrolled reductions trigger the
                                 # stencil scheduling policy (paper §V-B)
    combiner: str = "add"        # or "max": acc = max(acc, term)


class Func:
    """A (pure or reduction) stage in the pipeline."""

    def __init__(self, name: str):
        self.name = name
        self.index_vars: Optional[Tuple[str, ...]] = None  # as written: x fastest
        self.expr: Optional[Expr] = None
        self.reduction: Optional[Reduction] = None
        self.is_input = False
        self.input_ndim = 0
        # scheduling state
        self.realized = False          # store_root/compute_root; default inline
        self.unroll_factors: Dict[str, int] = {}
        self.tile_extents: Optional[Dict[str, int]] = None
        self.accelerator_output = False
        self.on_host = False           # excluded from the accelerator region

    # -- inputs ----------------------------------------------------------------
    @staticmethod
    def input(name: str, ndim: int) -> "Func":
        f = Func(name)
        f.is_input = True
        f.input_ndim = ndim
        f.realized = True
        return f

    # -- algorithm ----------------------------------------------------------------
    def __getitem__(self, idx) -> FuncRef:
        if not isinstance(idx, tuple):
            idx = (idx,)
        return FuncRef(self.name, tuple(_aff(i) for i in idx))

    def __setitem__(self, idx, value) -> None:
        if not isinstance(idx, tuple):
            idx = (idx,)
        names = []
        for v in idx:
            if not isinstance(v, Var):
                raise TypeError("pure definitions must index by Vars")
            names.append(v.name)
        if self.index_vars is not None and self.index_vars != tuple(names):
            raise ValueError(f"{self.name}: inconsistent index vars")
        self.index_vars = tuple(names)
        if isinstance(value, (int, float)):
            value = Const(value)
        self.expr = value

    def update(self, idx: Sequence[Var], rhs: Expr, rdom: RDom) -> None:
        """Reduction update ``f[idx] = f[idx] + term`` (or ``maximum(f[idx],
        term)``) over ``rdom`` — stored as the paper's combined single
        statement."""
        names = tuple(v.name for v in idx)
        if self.index_vars is None:
            self.index_vars = names
        if self.expr is None:
            self.expr = Const(0)
        combiner, term = _extract_update_term(self.name, rhs)
        self.reduction = Reduction(
            rvars=tuple(v.name for v in rdom.vars),
            rextents=rdom.extents,
            init=self.expr,
            term=term,
            combiner=combiner,
        )

    # -- scheduling language ----------------------------------------------------------
    def store_root(self) -> "Func":
        self.realized = True
        return self

    compute_root = store_root

    def store_at(self, *_args) -> "Func":
        # one accelerator tile <=> one realization level in this backend
        self.realized = True
        return self

    compute_at = store_at

    def inline(self) -> "Func":
        self.realized = False
        return self

    def unroll(self, v: Union[Var, str], factor: int) -> "Func":
        name = v.name if isinstance(v, Var) else v
        self.unroll_factors[name] = factor
        return self

    def unroll_reduction(self) -> "Func":
        if self.reduction is None:
            raise ValueError(f"{self.name} has no reduction to unroll")
        self.reduction.unrolled = True
        return self

    def tile(self, **extents: int) -> "Func":
        self.tile_extents = dict(extents)
        return self

    def hw_accelerate(self) -> "Func":
        self.accelerator_output = True
        self.realized = True
        return self

    def stream_to_accelerator(self) -> "Func":
        if not self.is_input:
            raise ValueError("stream_to_accelerator applies to inputs")
        return self

    def compute_on_host(self) -> "Func":
        self.on_host = True
        return self

    def __repr__(self):
        kind = "input" if self.is_input else ("reduce" if self.reduction else "pure")
        return f"Func({self.name}, {kind}, realized={self.realized})"


def _extract_update_term(name: str, rhs: Expr) -> Tuple[str, Expr]:
    """Accept ``f[...] + term`` / ``term + f[...]`` (a sum) or
    ``maximum(f[...], term)`` / ``maximum(term, f[...])`` (a running
    maximum) and return the combiner and ``term``."""
    if isinstance(rhs, BinOp) and rhs.op in COMBINERS:
        if isinstance(rhs.a, FuncRef) and rhs.a.func == name:
            return rhs.op, rhs.b
        if isinstance(rhs.b, FuncRef) and rhs.b.func == name:
            return rhs.op, rhs.a
    raise ValueError("reduction update must have the form f[...] = f[...] + term "
                     "or f[...] = maximum(f[...], term)")


__all__ = ["Var", "RDom", "Func", "Reduction", "COMBINERS"]
