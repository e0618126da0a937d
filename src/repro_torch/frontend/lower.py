"""Lowering: scheduled mini-Halide Funcs -> loop-nest pipeline IR.

Performs the frontend work the paper describes in §V-A/§V-B's input:

  1. **Inlining** of non-realized funcs (Halide's default; drives the
     recompute-vs-buffer trade-off of Table V),
  2. **Bounds inference**: required region per realized func, propagated
     backwards from the accelerator output tile through affine access maps,
  3. Emission of ``Stage`` records — the "scheduled Halide IR" that unified
     buffer extraction consumes.  Each stage is one combined statement
     surrounded by a perfect loop nest (pure loops outer, reduction loops
     inner).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.poly import AffineExpr, AffineMap, Box
from .expr import (
    Const,
    Expr,
    FuncRef,
    count_ops,
    eval_expr,
    expr_depth,
    refs_in,
    substitute_refs,
    substitute_vars,
)
from .func import Func, Reduction


@dataclass
class Stage:
    """One combined statement in a perfect loop nest."""

    name: str                       # buffer written (== func name)
    dims: Tuple[str, ...]           # loop order, outermost first (pure then red.)
    domain: Box                     # full iteration domain (incl. reduction dims)
    pure_dims: Tuple[str, ...]      # outermost-first pure dims
    value: Expr                     # pure body, or reduction term
    reduction: Optional[Reduction]
    store: AffineMap                # stage dims -> buffer element
    loads: List[Tuple[str, AffineMap]] = field(default_factory=list)
    unroll_factors: Dict[str, int] = field(default_factory=dict)
    on_host: bool = False

    @property
    def latency(self) -> int:
        """HLS latency model: one cycle per ALU level (§V-B scheduler)."""
        base = expr_depth(self.value)
        if self.reduction is not None:
            base += 1  # accumulate add
        return max(base, 1)

    @property
    def pe_ops(self) -> int:
        """16-bit ALU ops per statement instance (PE model, Table IV/V)."""
        n = count_ops(self.value)
        if self.reduction is not None:
            n += 1
        return n

    def unrolled_copies(self) -> int:
        u = 1
        for f in self.unroll_factors.values():
            u *= f
        return u

    def reduction_fully_unrolled(self) -> bool:
        """Paper §V-B policy predicate: every reduction loop fully unrolled."""
        if self.reduction is None:
            return True
        if self.reduction.unrolled:
            return True
        return all(
            self.unroll_factors.get(rv, 1) == re
            for rv, re in zip(self.reduction.rvars, self.reduction.rextents)
        )

    def __repr__(self):
        return f"Stage({self.name}, dims={self.dims}, dom={self.domain.extents})"


@dataclass
class Pipeline:
    """Topologically ordered stages + buffer geometry."""

    stages: List[Stage]
    inputs: List[str]
    output: str
    buffer_boxes: Dict[str, Box]    # realized buffer name -> element box
    host_stages: List[Stage] = field(default_factory=list)

    def stage(self, name: str) -> Stage:
        for s in self.stages + self.host_stages:
            if s.name == name:
                return s
        raise KeyError(name)

    def consumers_of(self, buf: str) -> List[Stage]:
        return [s for s in self.stages if any(b == buf for b, _ in s.loads)]

    def producer_of(self, buf: str) -> Optional[Stage]:
        for s in self.stages:
            if s.name == buf:
                return s
        return None


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


def lower_pipeline(
    output: Func,
    funcs: Sequence[Func],
    output_extents: Mapping[str, int],
) -> Pipeline:
    """Lower a scheduled func graph into a Pipeline.

    ``output_extents`` maps the output's index vars to the accelerator tile
    extents selected by ``tile`` (one accelerator invocation).
    """
    by_name: Dict[str, Func] = {f.name: f for f in funcs}
    if output.name not in by_name:
        by_name[output.name] = output
    output.realized = True

    # -- 1. inline non-realized funcs -------------------------------------------
    inlined_exprs = _resolve_inlining(by_name)

    # -- 2. reachable realized funcs, topological order ---------------------------
    order = _topo_realized(output.name, by_name, inlined_exprs)

    # -- 3. bounds inference (backwards) -----------------------------------------
    tile = output.tile_extents or dict(output_extents)
    out_box = _box_for(output, {v: tile[v] for v in output.index_vars})
    required: Dict[str, Box] = {output.name: out_box}
    for name in reversed(order):
        f = by_name[name]
        if f.is_input:
            continue
        stage_dom = _stage_domain(f, required[name])
        expr = inline_into(_final_expr(f, inlined_exprs), by_name, inlined_exprs)
        for ref in refs_in(expr):
            prod = by_name[ref.func]
            assert prod.realized, "inline_into left an unrealized ref"
            # loop-order dims of the producer buffer: reversed index order
            acc = AffineMap(tuple(stage_dom.dims), tuple(reversed(ref.indices)))
            rbox = acc.range_box(stage_dom, _loop_dims(prod))
            required[ref.func] = (
                rbox if ref.func not in required else required[ref.func].hull(rbox)
            )

    # -- 4. emit stages --------------------------------------------------------------
    stages: List[Stage] = []
    host_stages: List[Stage] = []
    for name in order:
        f = by_name[name]
        if f.is_input:
            continue
        box = required[name]
        stage = _make_stage(f, box, inlined_exprs, by_name)
        (host_stages if f.on_host else stages).append(stage)

    inputs = [n for n in order if by_name[n].is_input]
    buffer_boxes = {n: required[n] for n in required}
    return Pipeline(stages, inputs, output.name, buffer_boxes, host_stages)


# -- helpers ------------------------------------------------------------------


def _loop_dims(f: Func) -> Tuple[str, ...]:
    """Outermost-first loop dims of a func's buffer (reversed index order)."""
    if f.is_input:
        return tuple(f"i{k}" for k in reversed(range(f.input_ndim)))
    assert f.index_vars is not None, f.name
    return tuple(reversed(f.index_vars))


def _box_for(f: Func, extents: Mapping[str, int]) -> Box:
    dims = _loop_dims(f)
    return Box(dims, tuple((0, extents[d] - 1) for d in dims))


def _stage_domain(f: Func, buf_box: Box) -> Box:
    """Stage iteration domain: pure loops (over the required buffer box)
    outermost, reduction loops innermost."""
    dims = list(buf_box.dims)
    ivs = list(buf_box.intervals)
    if f.reduction is not None:
        for rv, re in zip(f.reduction.rvars, f.reduction.rextents):
            dims.append(rv)
            ivs.append((0, re - 1))
    return Box(tuple(dims), tuple(ivs))


def _resolve_inlining(by_name: Dict[str, Func]) -> Dict[str, Expr]:
    """Fixed-point inline of every non-realized pure func."""
    resolved: Dict[str, Expr] = {}

    def resolve(name: str, stack: Tuple[str, ...]) -> Expr:
        if name in resolved:
            return resolved[name]
        if name in stack:
            raise ValueError(f"inlining cycle through {name}")
        f = by_name[name]
        if f.reduction is not None:
            raise ValueError(f"cannot inline reduction func {name}; realize it")
        assert f.expr is not None, f"{name} has no definition"
        e = f.expr
        table = {}
        for ref in refs_in(e):
            p = by_name[ref.func]
            if not p.realized:
                inner = resolve(ref.func, stack + (name,))
                pvars = p.index_vars

                def mk(inner=inner, pvars=pvars):
                    def apply(indices):
                        subst = dict(zip(pvars, indices))
                        return substitute_vars(inner, subst)

                    return apply

                table[ref.func] = mk()
        if table:
            e = substitute_refs(e, table)
            # inlined bodies may themselves reference inlined funcs
            while any(not by_name[r.func].realized for r in refs_in(e)):
                table2 = {}
                for ref in refs_in(e):
                    p = by_name[ref.func]
                    if not p.realized:
                        inner = resolve(ref.func, stack + (name,))
                        pvars = p.index_vars

                        def mk2(inner=inner, pvars=pvars):
                            def apply(indices):
                                return substitute_vars(inner, dict(zip(pvars, indices)))

                            return apply

                        table2[ref.func] = mk2()
                e = substitute_refs(e, table2)
        resolved[name] = e
        return e

    for name, f in by_name.items():
        if not f.is_input and f.reduction is None:
            resolve(name, ())
    return resolved


def _final_expr(f: Func, inlined: Dict[str, Expr]) -> Expr:
    if f.reduction is not None:
        return f.reduction.term
    return inlined.get(f.name, f.expr)  # type: ignore[return-value]


def inline_into(expr: Expr, by_name: Dict[str, Func], inlined: Dict[str, Expr]) -> Expr:
    """Inline every non-realized func reference inside ``expr``."""
    for _ in range(64):
        pending = [r for r in refs_in(expr) if not by_name[r.func].realized]
        if not pending:
            return expr
        table = {}
        for ref in pending:
            p = by_name[ref.func]
            inner, pvars = inlined[ref.func], p.index_vars

            def mk(inner=inner, pvars=pvars):
                return lambda indices: substitute_vars(inner, dict(zip(pvars, indices)))

            table[ref.func] = mk()
        expr = substitute_refs(expr, table)
    raise ValueError("inlining did not converge")


def _topo_realized(
    out_name: str, by_name: Dict[str, Func], inlined: Dict[str, Expr]
) -> List[str]:
    order: List[str] = []
    seen: Set[str] = set()

    def visit(name: str) -> None:
        if name in seen:
            return
        seen.add(name)
        f = by_name[name]
        if not f.is_input:
            expr = inline_into(_final_expr(f, inlined), by_name, inlined)
            assert expr is not None, f"{name} has no definition"
            for ref in refs_in(expr):
                visit(ref.func)
        order.append(name)

    visit(out_name)
    return order


def _make_stage(
    f: Func, buf_box: Box, inlined: Dict[str, Expr], by_name: Dict[str, Func]
) -> Stage:
    dom = _stage_domain(f, buf_box)
    expr = inline_into(_final_expr(f, inlined), by_name, inlined)
    store = AffineMap(
        tuple(dom.dims), tuple(AffineExpr.var(d) for d in buf_box.dims)
    )
    loads: List[Tuple[str, AffineMap]] = []
    for ref in refs_in(expr):
        acc = AffineMap(tuple(dom.dims), tuple(reversed(ref.indices)))
        loads.append((ref.func, acc))
    red = f.reduction
    return Stage(
        name=f.name,
        dims=tuple(dom.dims),
        domain=dom,
        pure_dims=tuple(buf_box.dims),
        value=expr,
        reduction=red,
        store=store,
        loads=loads,
        unroll_factors=dict(f.unroll_factors),
        on_host=f.on_host,
    )


# ---------------------------------------------------------------------------
# Normalized (codegen-friendly) stage view
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NormalizedStage:
    """Zero-based view of a :class:`Stage` for code generators.

    ``Stage`` records carry *absolute* coordinates: the iteration domain is
    the required buffer box (whose lower bounds need not be 0) and access
    maps index producer buffers by absolute element.  Backends that realize
    buffers as dense arrays want everything rebased to 0:

      * the iteration domain becomes pure extents x reduction extents,
      * each load's access map sends zero-based stage dims to zero-based
        producer elements (producer-box lower bounds subtracted),
      * the store map is the identity on the pure dims (element == pure
        iteration point), which :func:`normalize_stage` verifies.

    ``dim_lower`` retains each stage dim's original lower bound so value
    expressions reading iteration variables (``IterVal``) can reconstruct
    absolute coordinates.
    """

    name: str
    pure_dims: Tuple[str, ...]          # outermost first; [0] is the loop var
    pure_extents: Tuple[int, ...]
    red_dims: Tuple[str, ...]
    red_extents: Tuple[int, ...]
    value: Expr                         # FuncRefs pair 1:1, in refs_in order,
                                        # with ``loads`` entries
    init: Optional[Expr]                # reduction init, None for pure stages
    loads: Tuple[Tuple[str, AffineMap], ...]   # zero-based access maps
    dim_lower: Tuple[Tuple[str, int], ...]
    on_host: bool = False
    combiner: str = "add"               # a reduction's: acc = op(acc, term)

    @property
    def dims(self) -> Tuple[str, ...]:
        return self.pure_dims + self.red_dims

    def extent(self, dim: str) -> int:
        if dim in self.pure_dims:
            return self.pure_extents[self.pure_dims.index(dim)]
        return self.red_extents[self.red_dims.index(dim)]

    def lower_of(self, dim: str) -> int:
        return dict(self.dim_lower).get(dim, 0)


def normalize_stage(stage: Stage, buffer_boxes: Mapping[str, Box]) -> NormalizedStage:
    """Rebase a stage and its access maps to zero-based coordinates."""
    buf_box = buffer_boxes[stage.name]
    if tuple(buf_box.dims) != stage.pure_dims:
        raise ValueError(
            f"{stage.name}: buffer box dims {buf_box.dims} != pure dims "
            f"{stage.pure_dims}"
        )
    dim_lower: Dict[str, int] = {
        d: lo for d, (lo, _) in zip(buf_box.dims, buf_box.intervals)
    }
    red_dims: Tuple[str, ...] = ()
    red_extents: Tuple[int, ...] = ()
    init: Optional[Expr] = None
    combiner = "add"
    if stage.reduction is not None:
        red_dims = tuple(stage.reduction.rvars)
        red_extents = tuple(stage.reduction.rextents)
        init = stage.reduction.init
        combiner = stage.reduction.combiner
        for rv in red_dims:
            dim_lower[rv] = 0
    # the store map must be the identity on the pure dims for the rebasing
    # (element == iteration point) to be sound
    for e, d in zip(stage.store.exprs, stage.pure_dims):
        if e != AffineExpr.var(d):
            raise ValueError(f"{stage.name}: non-identity store map {stage.store}")
    shift = {
        d: AffineExpr.var(d) + lo for d, lo in dim_lower.items() if lo != 0
    }
    loads: List[Tuple[str, AffineMap]] = []
    for buf, acc in stage.loads:
        pbox = buffer_boxes[buf]
        if acc.n_out != len(pbox.dims):
            raise ValueError(f"{stage.name}: load of {buf} rank mismatch")
        exprs = []
        for e, (plo, _) in zip(acc.exprs, pbox.intervals):
            e2 = e.substitute(shift) if shift else e
            exprs.append(e2 - plo)
        loads.append((buf, AffineMap(tuple(stage.dims), tuple(exprs))))
    return NormalizedStage(
        name=stage.name,
        pure_dims=tuple(stage.pure_dims),
        pure_extents=tuple(buf_box.extents),
        red_dims=red_dims,
        red_extents=red_extents,
        value=stage.value,
        init=init,
        loads=tuple(loads),
        dim_lower=tuple(sorted(dim_lower.items())),
        on_host=stage.on_host,
        combiner=combiner,
    )


def normalize_pipeline(pipe: "Pipeline") -> List[NormalizedStage]:
    """Normalized stages in execution order (device stages, then host)."""
    return [
        normalize_stage(s, pipe.buffer_boxes)
        for s in list(pipe.stages) + list(pipe.host_stages)
    ]


# ---------------------------------------------------------------------------
# Reference interpreter (golden model for all backends)
# ---------------------------------------------------------------------------


def execute_pipeline(
    pipe: Pipeline, input_arrays: Mapping[str, "object"]
) -> Dict[str, Dict[Tuple[int, ...], float]]:
    """Execute the pipeline pointwise (von Neumann semantics).  Returns the
    value table of every realized buffer — the golden reference the unified
    buffer backends are validated against."""
    import numpy as np

    values: Dict[str, Dict[Tuple[int, ...], float]] = {}
    for name, arr in input_arrays.items():
        a = np.asarray(arr)
        values[name] = {}
        # buffer element coords are absolute; required boxes may not start
        # at 0 (e.g. every tap >= 1), so key by idx + box lower bound
        lo = tuple(
            l for l, _ in pipe.buffer_boxes[name].intervals
        ) if name in pipe.buffer_boxes else (0,) * a.ndim
        for idx in np.ndindex(*a.shape):
            values[name][tuple(i + l for i, l in zip(idx, lo))] = float(a[idx])

    def load(buf: str, elem: Tuple[int, ...]) -> float:
        # FuncRef indices are in Halide index order (fastest first); the value
        # tables are keyed in loop order (outermost first) — reverse here.
        return values[buf][tuple(reversed(elem))]

    for st in list(pipe.stages) + list(pipe.host_stages):
        tbl: Dict[Tuple[int, ...], float] = values.setdefault(st.name, {})
        if st.reduction is None:
            for p in st.domain.points():
                tbl[st.store.eval(p)] = eval_expr(st.value, p, load)
        else:
            init = st.reduction.init
            combine = _COMBINE[st.reduction.combiner]
            for p in st.domain.points():
                e = st.store.eval(p)
                if _first_rpoint(p, st.reduction):
                    tbl[e] = eval_expr(init, p, load)
                tbl[e] = combine(tbl[e], eval_expr(st.value, p, load))
    return values


def _nan_max(a: float, b: float) -> float:
    """The larger operand, NaN if either is (as torch's ``maximum``)."""
    return math.nan if a != a or b != b else max(a, b)


_COMBINE = {"add": lambda a, b: a + b, "max": _nan_max}


def _first_rpoint(p: Mapping[str, int], red: Reduction) -> bool:
    return all(p[rv] == 0 for rv in red.rvars)


__all__ = [
    "Stage",
    "Pipeline",
    "NormalizedStage",
    "lower_pipeline",
    "normalize_stage",
    "normalize_pipeline",
    "execute_pipeline",
]
