"""Cycle-accurate scheduling (paper §V-B).

Turns the multidimensional iteration domains of the lowered pipeline into
one-dimensional cycle times at every buffer port.  Three policies:

  * **stencil**  — all stages fused into a single rate-matched pipeline at
    initiation interval 1 (line-buffer schedules).  Selected when every
    reduction loop is fully unrolled.
  * **dnn**      — coarse-grained double-buffered pipeline across tiles;
    stages are laid out sequentially inside a tile and the coarse II is
    found by binary search (Fig. 7).
  * **sequential** — the naive baseline of Tables VI/VII: kernels run one
    after another and loops are *not* pipelined (each statement instance
    occupies ``latency`` cycles).

The stencil scheduler derives each producer's schedule *coefficients* from
its consumers (rate matching, the SDF-style constraint of [12]) and the
*offsets* by an exact affine longest-path: for consumer load ``A`` the
constraint  ``S_t(p) >= W_s(A(p))``  has an affine left/right difference, so
its max over the (box) domain is exact — no ILP needed for this program
class.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.frontend.expr import substitute_vars
from repro_torch.frontend.lower import Pipeline, Stage
from .poly import AffineExpr, AffineMap, Box, Schedule


# ---------------------------------------------------------------------------
# Scheduled-stage record
# ---------------------------------------------------------------------------


@dataclass
class ScheduledStage:
    """A stage after unroll rewriting + cycle assignment."""

    name: str
    domain: Box                      # rewritten domain (unrolled dims split)
    pure_dims: Tuple[str, ...]       # rewritten pure dims (loop order)
    red_dims: Tuple[str, ...]        # rewritten (still-rolled) reduction dims
    unrolled_dims: Tuple[str, ...]   # dims executing in the same cycle
    unrolled_red_dims: Tuple[str, ...] = ()  # unrolled *reduction* dims
    issue: AffineExpr = AffineExpr.constant(0)  # iteration point -> issue cycle
    latency: int = 0                 # compute latency (issue -> write)
    store: AffineMap = None          # rewritten store map
    loads: List[Tuple[str, AffineMap]] = field(default_factory=list)
    pe_ops: int = 0
    is_input: bool = False
    value: object = None             # value Expr (unroll-substituted)

    @property
    def write_expr(self) -> AffineExpr:
        return self.issue + self.latency

    def write_schedule_per_element(self) -> Tuple[Box, AffineMap, AffineExpr]:
        """(element domain, elem->elem identity, write cycle expr) with
        reduction dims pinned to their final iteration."""
        expr = self.write_expr
        dom = self.domain
        for rd in self.red_dims:
            lo, hi = dom.bounds(rd)
            expr = expr.substitute({rd: AffineExpr.constant(hi)})
            dom = dom.drop(rd)
        return dom, self.store_without_reduction(), expr

    def store_without_reduction(self) -> AffineMap:
        in_dims = tuple(d for d in self.domain.dims if d not in self.red_dims)
        return AffineMap(in_dims, self.store.exprs)

    def cycles(self) -> int:
        """Cycle span of this stage in isolation."""
        lo, hi = self.issue.range_over(self.domain)
        return hi - lo + 1 + self.latency


@dataclass
class PipelineSchedule:
    policy: str                       # stencil | dnn | sequential
    stages: Dict[str, ScheduledStage]  # includes input pseudo-stages
    completion: int                   # total cycles for one invocation
    ii: int = 1                       # coarse II (dnn) / output II (stencil)
    tile_count: int = 1
    total_completion: Optional[int] = None  # across tiles (dnn)

    def stage(self, name: str) -> ScheduledStage:
        return self.stages[name]


# ---------------------------------------------------------------------------
# Policy selection (paper §V-B)
# ---------------------------------------------------------------------------


def select_policy(pipe: Pipeline) -> str:
    """Stencil iff every reduction loop is fully unrolled."""
    for st in pipe.stages:
        if not st.reduction_fully_unrolled():
            return "dnn"
    return "stencil"


# ---------------------------------------------------------------------------
# Unroll rewriting
# ---------------------------------------------------------------------------


def _rewrite_unroll(st: Stage) -> ScheduledStage:
    """Split every unrolled dim d (factor u) into d_o (extent/u) at d's loop
    position and d_u (extent u) appended innermost with schedule coeff 0.
    Fully-unrolled dims keep only the unrolled copy dim."""
    dom = st.domain
    subst: Dict[str, AffineExpr] = {}
    unrolled: List[str] = []
    for d, u in st.unroll_factors.items():
        if u <= 1:
            continue
        extent = dom.extent(d)
        if extent % u:
            raise ValueError(f"{st.name}: unroll {u} does not divide extent {extent} of {d}")
        if u == extent:
            # fully unrolled: the dim itself becomes a same-cycle dim
            unrolled.append(d)
            continue
        do, du = f"{d}__o", f"{d}__u"
        i = dom.dims.index(d)
        dims = list(dom.dims)
        ivs = list(dom.intervals)
        dims[i] = do
        ivs[i] = (0, extent // u - 1)
        dims.append(du)
        ivs.append((0, u - 1))
        dom = Box(tuple(dims), tuple(ivs))
        subst[d] = AffineExpr.var(do) * u + AffineExpr.var(du)
        unrolled.append(du)

    store = st.store.substitute(subst) if subst else st.store
    store = AffineMap(tuple(dom.dims), store.exprs)
    loads = [
        (b, AffineMap(tuple(dom.dims), m.substitute(subst).exprs if subst else m.exprs))
        for b, m in st.loads
    ]
    red = tuple(
        rv for rv in (st.reduction.rvars if st.reduction else ())
        if rv not in unrolled and rv in dom.dims
    )
    pure = tuple(d for d in dom.dims if d not in red and d not in unrolled)
    return ScheduledStage(
        name=st.name,
        domain=dom,
        pure_dims=pure,
        red_dims=red,
        unrolled_dims=tuple(unrolled),
        unrolled_red_dims=tuple(
            rv for rv in (st.reduction.rvars if st.reduction else ())
            if rv in unrolled
        ),
        issue=AffineExpr.constant(0),  # filled by the scheduler
        latency=st.latency,
        store=store,
        loads=loads,
        pe_ops=st.pe_ops * st.unrolled_copies(),
        value=substitute_vars(st.value, subst) if subst else st.value,
    )


def _input_pseudo_stage(name: str, box: Box) -> ScheduledStage:
    return ScheduledStage(
        name=name,
        domain=box,
        pure_dims=tuple(box.dims),
        red_dims=(),
        unrolled_dims=(),
        issue=AffineExpr.constant(0),
        latency=0,
        store=AffineMap.identity(box.dims),
        loads=[],
        is_input=True,
    )


def _raster(box: Box, skip: Sequence[str] = (), ii: int = 1) -> AffineExpr:
    """Row-major raster schedule over a box; ``skip`` dims get coefficient 0
    (unrolled), ``ii`` scales the whole expression (initiation interval)."""
    expr = AffineExpr.constant(0)
    stride = ii
    for d in reversed(box.dims):
        if d in skip:
            continue
        lo, _ = box.bounds(d)
        expr = expr + (AffineExpr.var(d) - lo) * stride
        stride *= box.extent(d)
    return expr


def raster_cycles(extents: Sequence[int], latency: int, ii: int = 1) -> int:
    """Cycle count of rastering a box of ``extents`` at initiation interval
    ``ii`` with ``latency`` cycles of drain — the single-stage
    specialization of the §V-B cycle model.

    This is the same arithmetic a :class:`ScheduledStage` with a ``_raster``
    issue expression reports through :meth:`ScheduledStage.cycles`, exposed
    as a standalone entry so the Pallas backend's block-height cost hook
    (``backend/plan.scheduler_cost``) prices candidate row panels with the
    scheduler's own model (cross-checked against ``core/simulator.py`` in
    the test suite).  The same model prices the recompute-vs-carry trade of
    cross-grid-step line buffers: recompute mode rasters ``|shifts|``
    panels per step, carry mode rasters one panel plus a one-time warm-up
    (``raster_cycles`` over the halo rows, charged to the pipeline fill)
    with the ring rotation riding the memory side — whichever modeled
    schedule is cheaper decides the chain's mode."""
    dims = tuple(f"__c{i}" for i in range(len(extents)))
    box = Box(dims, tuple((0, max(int(e), 1) - 1) for e in extents))
    issue = _raster(box, ii=ii)
    lo, hi = issue.range_over(box)
    return hi - lo + 1 + latency


# ---------------------------------------------------------------------------
# Stencil scheduler
# ---------------------------------------------------------------------------


def _demanded_strides(
    consumer: ScheduledStage, load: AffineMap
) -> Optional[List[int]]:
    """Schedule coefficients for a producer's *element* dims, rate-matched to
    a consumer load.  After zeroing the consumer's unrolled dims, each load
    expr must be  ``m*d + c``  over a single consumer dim with the consumer
    schedule coefficient divisible by m.  Returns None when the pattern is
    more complex (caller falls back to the producer's own raster)."""
    strides: List[int] = []
    for e in load.exprs:
        terms = [
            (d, c) for d, c in e.coeffs if c != 0 and d not in consumer.unrolled_dims
        ]
        if not terms:
            strides.append(0)
            continue
        if len(terms) != 1:
            return None
        d, m = terms[0]
        cd = consumer.issue.coeff(d)
        if m == 0 or cd % m:
            return None
        strides.append(abs(cd // m))
    return strides


def _enforce_injective(box: Box, strides: List[int]) -> List[int]:
    """Bump strides (smallest first) so no two points share a cycle."""
    out = list(strides)
    order = sorted(range(len(box.dims)), key=lambda i: (abs(out[i]), -i))
    span = 0
    for i in order:
        extent = box.extents[i]
        if extent <= 1:
            continue
        if abs(out[i]) <= span:
            out[i] = span + 1
        span += abs(out[i]) * (extent - 1)
    return out


def _propagate_input_unroll(
    s: ScheduledStage, cons: List[Tuple[ScheduledStage, AffineMap]]
) -> None:
    """When consumers access an input with unrolled dims, strip-mine the
    matching input element dims so the input stream can push the same number
    of words per cycle (the paper's sch4: unrolling doubles I/O throughput)."""
    factors: Dict[str, int] = {}
    for t, m in cons:
        for k, e in enumerate(m.exprs):
            for d, c in e.coeffs:
                if d not in t.unrolled_dims or c == 0:
                    continue
                # only the strip-mine pattern u*d_o + c*d_u widens the input
                # stream; overlapping stencil taps (an unrolled reduction dim
                # with no outer partner) are satisfied by data *reuse*
                u = t.domain.extent(d) * abs(c)
                has_partner = any(
                    d2 != d and d2 not in t.unrolled_dims and abs(c2) == u
                    for d2, c2 in e.coeffs
                )
                if not has_partner:
                    continue
                dim = s.domain.dims[k]
                factors[dim] = max(factors.get(dim, 1), u)
    for dim, u in factors.items():
        extent = s.domain.extent(dim)
        if u <= 1 or extent % u:
            continue
        do, du = f"{dim}__o", f"{dim}__u"
        i = s.domain.dims.index(dim)
        dims = list(s.domain.dims)
        ivs = list(s.domain.intervals)
        dims[i] = do
        ivs[i] = (0, extent // u - 1)
        dims.append(du)
        ivs.append((0, u - 1))
        s.domain = Box(tuple(dims), tuple(ivs))
        s.unrolled_dims = s.unrolled_dims + (du,)
        # store map still yields original element coordinates
        exprs = list(s.store.exprs)
        exprs[i] = AffineExpr.var(do) * u + AffineExpr.var(du)
        s.store = AffineMap(tuple(s.domain.dims), tuple(exprs))
        s.pure_dims = tuple(d for d in s.domain.dims if d not in s.unrolled_dims)


def _elem_write_expr(p: ScheduledStage, elem_exprs: Sequence[AffineExpr]) -> Optional[AffineExpr]:
    """Write time of buffer element ``elem_exprs`` (affine over some consumer
    dims).  Inverts the producer's store map; supports identity stores and
    the two-term strip-mined form ``u*d_o + d_u`` produced by unrolling, as
    long as every coefficient in the element expr is divisible by u (true
    after per-copy fixing).  Returns None when not exactly invertible."""
    dom, store, w = p.write_schedule_per_element()
    subst: Dict[str, AffineExpr] = {}
    for k, se in enumerate(store.exprs):
        e = elem_exprs[k]
        terms = [(d, c) for d, c in se.coeffs if c != 0]
        if len(terms) == 1 and terms[0][1] == 1 and se.const == 0:
            subst[terms[0][0]] = e
        elif len(terms) == 2 and se.const == 0:
            (d1, c1), (d2, c2) = terms
            if c2 == 1 and c1 > 1:
                do, u, du = d1, c1, d2
            elif c1 == 1 and c2 > 1:
                do, u, du = d2, c2, d1
            else:
                return None
            if any(c % u for _, c in e.coeffs):
                return None
            rem = e.const % u
            subst[du] = AffineExpr.constant(rem)
            outer = AffineExpr(
                tuple((d, c // u) for d, c in e.coeffs), (e.const - rem) // u
            )
            subst[do] = outer
        else:
            return None
    return w.substitute(subst)


def schedule_stencil(pipe: Pipeline) -> PipelineSchedule:
    stages: Dict[str, ScheduledStage] = {}
    for st in pipe.stages:
        stages[st.name] = _rewrite_unroll(st)
    for name in pipe.inputs:
        stages[name] = _input_pseudo_stage(name, pipe.buffer_boxes[name])

    order = [s.name for s in pipe.stages]
    consumers: Dict[str, List[Tuple[ScheduledStage, AffineMap]]] = {}
    for s in stages.values():
        for b, m in s.loads:
            consumers.setdefault(b, []).append((s, m))

    # 1. output (last stage) gets a pure raster schedule
    out_name = order[-1]
    out = stages[out_name]
    out.issue = _raster(out.domain, skip=out.unrolled_dims)

    # 2. coefficients, consumers -> producers (reverse topo)
    for name in reversed(order[:-1]):
        _assign_coeffs(stages[name], consumers.get(name, []))
    for name in pipe.inputs:
        _propagate_input_unroll(stages[name], consumers.get(name, []))
        _assign_coeffs(stages[name], consumers.get(name, []))

    # 3. relax, producers -> consumers: when a producer's stride was bumped
    #    for injectivity (its rows are wider than the consumer's), consumers
    #    adopt the bumped rate.  This is the fusion of [12]: every stage ends
    #    up riding the widest (input-tile) raster, so dependence distances
    #    stay uniform instead of drifting row by row.
    topo = list(pipe.inputs) + order
    for name in topo:
        s = stages[name]
        s_span = s.issue.range_over(s.domain)[1] + 1
        for b, m in s.loads:
            p = stages[b]
            # resident buffers (e.g. preloaded weights, produced in a tiny
            # fraction of the consumer's span and re-read) must not slow the
            # consumer down: the offset pass already delays the first read
            # until the preload finishes
            p_span = p.issue.range_over(p.domain)[1] + 1
            if p_span * 4 < s_span:
                continue
            for k, e in enumerate(m.exprs):
                terms = [
                    (d, c) for d, c in e.coeffs
                    if c != 0 and d not in s.unrolled_dims
                ]
                if len(terms) != 1:
                    continue
                d, mc = terms[0]
                w = _elem_stride(p, k)
                if w is None:
                    continue
                want = w * abs(mc)
                cur = s.issue.coeff(d)
                if 0 < cur < want:
                    s.issue = s.issue + AffineExpr.var(d) * (want - cur)

    # 4. offsets, producers -> consumers (forward exact longest-path)
    delta: Dict[str, int] = {}
    for name in topo:
        s = stages[name]
        d = 0
        for b, m in s.loads:
            # producer issue exprs are updated in place, so their deltas are
            # already included — pass 0 to avoid double counting
            d = max(d, _dependence_delta(stages[b], 0, s, m))
        delta[name] = d
        s.issue = s.issue + d

    completion = stages[out_name].write_expr.range_over(stages[out_name].domain)[1] + 1
    return PipelineSchedule("stencil", stages, completion, ii=1)


def _elem_stride(p: ScheduledStage, k: int) -> Optional[int]:
    """Schedule stride of the producer per unit step of buffer element dim k
    (None when the store structure makes it non-integral)."""
    se = p.store.exprs[k]
    terms = [(d, c) for d, c in se.coeffs if c != 0]
    if len(terms) == 1 and terms[0][1] == 1:
        return abs(p.issue.coeff(terms[0][0]))
    if len(terms) == 2:
        # strip-mined store u*do + du: element stride = coeff(do)/u
        (d1, c1), (d2, c2) = sorted(terms, key=lambda t: -abs(t[1]))
        u = abs(c1)
        co = p.issue.coeff(d1)
        if c2 in (1, -1) and u > 1 and co % u == 0:
            return abs(co // u)
    return None


def _dependence_delta(
    p: ScheduledStage, p_delta: int, s: ScheduledStage, m: AffineMap
) -> int:
    """Minimal extra delay of consumer ``s`` so that  S_s(pt) >= W_p(A(pt))
    everywhere.  Enumerates the consumer's unrolled copies so strip-mined
    store maps stay exactly invertible; falls back to the conservative
    last-write bound when inversion fails."""
    copies = _copy_assignments(s)
    worst = None
    for cu in copies:
        subst = {d: AffineExpr.constant(v) for d, v in cu.items()}
        elem_exprs = [e.substitute(subst) for e in m.exprs]
        w = _elem_write_expr(p, elem_exprs)
        if w is None:
            worst = None
            break
        gap = w + p_delta - s.issue.substitute(subst)
        dom = s.domain
        for d in cu:
            dom = dom.drop(d)
        g = gap.range_over(dom)[1]
        worst = g if worst is None else max(worst, g)
    if worst is not None:
        return max(0, worst)
    # conservative fallback: wait for the producer's final write
    last = p.write_expr.range_over(p.domain)[1] + p_delta
    first = s.issue.range_over(s.domain)[0]
    return max(0, last - first)


def _copy_assignments(s: ScheduledStage) -> List[Dict[str, int]]:
    if not s.unrolled_dims:
        return [{}]
    out: List[Dict[str, int]] = [{}]
    for d in s.unrolled_dims:
        lo, hi = s.domain.bounds(d)
        out = [dict(a, **{d: v}) for a in out for v in range(lo, hi + 1)]
    return out


def _assign_coeffs(
    s: ScheduledStage,
    cons: List[Tuple[ScheduledStage, AffineMap]],
) -> None:
    """Rate-matched coefficients for a producer (fallback: own raster).
    Demand-matching applies only to identity-store producers; strip-mined
    producers (unrolled) keep their own raster, which runs at least as fast
    as any consumer demands."""
    identity_store = (
        not s.unrolled_dims
        and not s.red_dims
        and s.store.exprs
        == tuple(AffineExpr.var(d) for d in s.domain.dims)
    )
    if not identity_store:
        s.issue = _raster(s.domain, skip=s.unrolled_dims)
        return
    demanded: Optional[List[int]] = None
    for t, m in cons:
        st = _demanded_strides(t, m)
        if st is None:
            demanded = None
            break
        demanded = st if demanded is None else [max(a, b) for a, b in zip(demanded, st)]
    if demanded is None or all(w == 0 for w in demanded):
        s.issue = _raster(s.domain)
        return
    demanded = _enforce_injective(s.domain, demanded)
    expr = AffineExpr.constant(0)
    for d, w in zip(s.domain.dims, demanded):
        lo, _ = s.domain.bounds(d)
        expr = expr + (AffineExpr.var(d) - lo) * w
    s.issue = expr


# ---------------------------------------------------------------------------
# DNN scheduler (coarse-grained double-buffered pipeline, Fig. 7)
# ---------------------------------------------------------------------------


def schedule_dnn(pipe: Pipeline, tile_count: int = 1) -> PipelineSchedule:
    stages: Dict[str, ScheduledStage] = {}
    for st in pipe.stages:
        stages[st.name] = _rewrite_unroll(st)
    for name in pipe.inputs:
        stages[name] = _input_pseudo_stage(name, pipe.buffer_boxes[name])

    order = list(pipe.inputs) + [s.name for s in pipe.stages]
    # HLS list schedule per stage: raster over own (rewritten) domain
    start = 0
    lengths: Dict[str, int] = {}
    for name in order:
        s = stages[name]
        s.issue = _raster(s.domain, skip=s.unrolled_dims) + start
        span = s.cycles()
        lengths[name] = span
        start += span
    sum_latency = start

    # binary search the coarse II (lower bound: longest stage — the largest
    # reduction stage runs at 100% utilization; upper bound: sequential)
    lo = max(lengths.values())
    hi = sum_latency
    best = hi
    while lo <= hi:
        mid = (lo + hi) // 2
        if _ii_legal(stages, order, mid):
            best = mid
            hi = mid - 1
        else:
            lo = mid + 1
    ii = best
    completion = sum_latency
    total = (tile_count - 1) * ii + sum_latency if tile_count > 1 else sum_latency
    return PipelineSchedule(
        "dnn", stages, completion, ii=ii, tile_count=tile_count, total_completion=total
    )


def _ii_legal(
    stages: Dict[str, ScheduledStage], order: List[str], ii: int
) -> bool:
    """Double-buffered legality: every stage must fit within one II window so
    that tile k+1's writes do not overrun tile k's reads of the *other*
    buffer copy; data dependencies inside a tile are already satisfied by the
    sequential layout."""
    for name in order:
        s = stages[name]
        if s.cycles() > ii:
            return False
    return True


# ---------------------------------------------------------------------------
# Sequential baseline (Tables VI/VII)
# ---------------------------------------------------------------------------


def schedule_sequential(pipe: Pipeline, tile_count: int = 1) -> PipelineSchedule:
    """Kernels one after another, loops not pipelined: each statement
    instance occupies ``latency`` cycles (II per iteration = latency)."""
    stages: Dict[str, ScheduledStage] = {}
    start = 0
    for name in pipe.inputs:
        s = _input_pseudo_stage(name, pipe.buffer_boxes[name])
        s.issue = _raster(s.domain) + start
        start += s.domain.size()
        stages[name] = s
    for st in pipe.stages:
        s = _rewrite_unroll(st)
        ii = max(s.latency, 1)
        s.issue = _raster(s.domain, skip=s.unrolled_dims, ii=ii) + start
        start += s.domain.size() // max(1, math.prod(
            s.domain.extent(d) for d in s.unrolled_dims
        )) * ii + s.latency
        stages[st.name] = s
    completion = start
    total = completion * tile_count if tile_count > 1 else completion
    return PipelineSchedule(
        "sequential", stages, completion, ii=0, tile_count=tile_count,
        total_completion=total,
    )


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def schedule_pipeline(
    pipe: Pipeline, tile_count: int = 1, policy: Optional[str] = None
) -> PipelineSchedule:
    policy = policy or select_policy(pipe)
    if policy == "stencil":
        return schedule_stencil(pipe)
    if policy == "dnn":
        return schedule_dnn(pipe, tile_count)
    if policy == "sequential":
        return schedule_sequential(pipe, tile_count)
    raise ValueError(f"unknown policy {policy}")


__all__ = [
    "ScheduledStage",
    "PipelineSchedule",
    "select_policy",
    "raster_cycles",
    "schedule_pipeline",
    "schedule_stencil",
    "schedule_dnn",
    "schedule_sequential",
]
