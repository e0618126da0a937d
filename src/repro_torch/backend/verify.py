"""Static plan verification: certify a :class:`PipelinePlan` before emission.

The planner derives every delivery decision (views, rings, line buffers,
padded grids, lane blocks, grid reductions) from affine access maps, and the
emitter trusts those decisions blindly — a drifted field in the plan IR
turns into a silent mis-slice or an unmasked tail inside ``pallas_call``.
This pass re-proves the contract between the two from the plan IR alone,
using the ``core/poly`` affine machinery (map images, box differences,
emptiness): no kernel is executed, no buffer is touched, and a plan no test
has ever run still gets certified.

Four rule families, ``UB``-prefixed after the unified-buffer abstraction
they guard:

``UB1xx`` — **bounds**.  Every HBM view, delivered block tap, ring tap, and
scratch tap, composed with the kernel's (valid) grid domain, lands inside
its declared buffer / block / ring / panel extents.  Padded-grid delivery
*past* the valid extent is exempt here by design — proving it is masked is
the ``UB2xx`` family's job.

``UB2xx`` — **mask soundness**.  Wherever delivered or computed rows/lanes
exceed the valid extents (``valid0``/``valid1``, reduction tails), the plan
carries the masking metadata (``PaddedGrid``/``lane_grid``/``RedGrid``) the
emitter keys its iota masks on, with mutually consistent fields; ring
warm-up views cover exactly the carried halo before any steady-state read,
and line-buffer halos fit the block (no torn rotates, no uninitialized
carried rows).  UB205 is the lane (column) variant of that carry model:
under a lane-blocked 2-D grid the only sound carry structures are *column*
rings — ``(bh, ..., bw + halo)`` state rotated once per lane step and
re-warmed from a lane-pinned prefix at lane step 0 of every row step — and
the rule proves the warm-up covers exactly the carried columns, the steady
view streams from the leading lane start, the rotate source never overlaps
unrefreshed columns (``halo <= bw``), and the ``(row, lane)`` sweep
accounts every column exactly once (batch-composed through ``bofs``: the
lane warm-up guard fires at ``jprog == 0``, which recurs at every row step
of every batch slot).  Row-carry structures composed with a lane grid are
rejected by the same rule — between two visits of a row panel every lane
step clobbers a row ring.

``UB3xx`` — **write disjointness / exactly-once**.  No two grid steps write
the same output element except through a declared ``RedGrid`` accumulation;
per-stage shift sets re-derived from the raw access maps match the planned
ones, and the implied eval-row counts match ``KernelGroup.eval_rows()``.

``UB4xx`` — **budget audit**.  An independent re-summation of view, ring,
scratch, and output bytes against ``vmem_bytes()``, and of the planner's
working-set accounting ``(bytes_per_row, fixed)`` against ``KernelGroup.ws``
and the recorded VMEM budget.

``UB5xx`` — **batch-step isolation**.  Under a batch grid (a leading grid
dim sweeping independent tiles), the batch declaration is consistent with
the grid and the plan notes (UB501), no carried ring or line-buffer state
crosses a batch boundary — every carry structure must reset (re-fire its
warm-up) at each batch step (UB502) — and the eval accounting is exactly
once *per batch element*: each slot evaluates the full per-tile row count
including its own warm-up, never a single globally amortized one (UB503).

Every violation carries the rule id, the offending kernel/stage/view, and a
concrete witness point (a buffer coordinate, a tap row, or the offending
byte counts).  ``verify_plan`` returns all violations; callers that want a
hard gate use :func:`assert_plan_verified` or
``compile_pipeline(verify=True)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.poly import AffineExpr, AffineMap, Box, map_image
from repro_torch.core.ubplan import VMEM_BYTES

from .access import AxisAccess, LoadAccess
from .errors import PlanError
from .plan import (
    ELEM_BYTES,
    KernelGroup,
    PipelinePlan,
    RingStream,
    CHAIN_TILE_MAX,
    chain_tile_shape,
    chain_times,
    StagePlan,
    ViewGroup,
)

__all__ = [
    "RULES",
    "PlanViolation",
    "PlanVerificationError",
    "verify_plan",
    "assert_plan_verified",
]


# Rule catalog: id -> what the rule proves (see backend/README.md for the
# prose version; keep the two in sync).
RULES: Dict[str, str] = {
    "UB101": "HBM view bounds: every view image lies inside its buffer",
    "UB102": "delivered-block bounds: in-block and ring taps fit the block",
    "UB103": "scratch bounds: fused taps hit materialized panels/ring rows",
    "UB201": "padded-grid masks: tail delivery is masked and metadata-consistent",
    "UB202": "ring warm-up: the pinned prefix covers the halo before any read",
    "UB203": "line-buffer carry: halo fits the block; shifts span lo..hi",
    "UB204": "reduction tails: RedGrid covers the true extent, ceil-stepped",
    "UB205": "lane carry: column rings warm, rotate, and cover the (row, "
             "lane) sweep exactly once; no row carry under a lane grid",
    "UB301": "exactly-once: extra grid dims are declared; rows cover the extent",
    "UB302": "eval accounting: derived shift sets and eval rows match the plan",
    "UB401": "VMEM re-summation: stream/ring/scratch bytes match vmem_bytes()",
    "UB402": "VMEM budget: the working set fits the recorded budget",
    "UB403": "working-set drift: re-derived (bytes_per_row, fixed) match ws",
    "UB404": "weight panels: a group planned against shared memory carries "
             "nothing and its panels cut its reduction's weight axis evenly",
    "UB405": "hidden chain: a chained group carries nothing, only its chain "
             "reads its hidden stages, its panels cut the hidden axis and "
             "every input staged along it evenly, and a panel takes only the "
             "words of one no later stage reads",
    "UB406": "window attention: a window group carries nothing, its score "
             "tile is its first fused stage, read only at the reader's own "
             "row and the keys' reduction variables by statistics and an "
             "output that reduce over the tile's key axes, and each "
             "statistic only at its own position",
    "UB501": "batch grid: leading dim, unit block, occupancy and notes agree",
    "UB502": "batch isolation: no ring/line-buffer state crosses a batch step",
    "UB503": "per-batch exactly-once: each slot evaluates the full per-tile rows",
}


@dataclass(frozen=True)
class PlanViolation:
    """One broken plan invariant: a named rule, where, and a witness."""

    rule: str
    kernel: str
    message: str
    stage: Optional[str] = None
    view: Optional[str] = None
    witness: Tuple[int, ...] = ()

    def __str__(self) -> str:
        where = self.kernel
        if self.stage and self.stage != self.kernel:
            where += f"/{self.stage}"
        if self.view:
            where += f" view={self.view}"
        wit = f" witness={self.witness}" if self.witness else ""
        return f"[{self.rule}] {where}: {self.message}{wit}"


class PlanVerificationError(PlanError):
    """A plan failed static verification; ``.violations`` has the details."""

    code = "PLAN-VERIFY"

    def __init__(self, violations: Sequence[PlanViolation]):
        self.violations = list(violations)
        lines = "\n".join(f"  {v}" for v in self.violations)
        super().__init__(
            f"plan verification failed ({len(self.violations)} violation(s)):\n"
            f"{lines}"
        )


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tap_interval(
    ax: AxisAccess, red_ext: Dict[str, int], extent_of
) -> Tuple[int, int]:
    """Inclusive element interval one tap axis touches: the reduction-offset
    range widened by the pure-dim sweep (``stride * (extent - 1)``)."""
    lo, hi = ax.offset_range(red_ext)
    if ax.pure_dim is not None:
        d = ax.stride * (extent_of(ax.pure_dim) - 1)
        lo, hi = lo + min(0, d), hi + max(0, d)
    return lo, hi


def _interval_witness(lo: int, hi: int, n: int) -> Optional[int]:
    """A point of ``[lo, hi]`` outside ``[0, n - 1]``, or None if contained.
    Uses the 1-D box difference so the witness is an *extreme* offender."""
    if lo > hi or n <= 0:
        return lo
    outside = Box(("o",), ((lo, hi),)).difference(Box(("o",), ((0, n - 1),)))
    if not outside:
        return None
    olo, ohi = outside[0].intervals[0]
    return olo if olo < 0 else ohi


def _view_label(kg: KernelGroup, gi: int) -> str:
    g = kg.groups[gi]
    return f"{g.buffer}[{gi}]"


# ---------------------------------------------------------------------------
# UB1xx — bounds
# ---------------------------------------------------------------------------


def _check_view_bounds(
    kg: KernelGroup, shapes: Dict[str, Tuple[int, ...]], out: List[PlanViolation]
) -> None:
    """UB101: the affine image of every view's valid domain lies inside its
    buffer's extents.  The domain is the *valid* part of the padded grid —
    rows ``[0, e0)``, lanes ``[0, e1)`` — because delivery past the valid
    extent is clamped/masked (proved by UB2xx), exactly the contract
    ``required_extents()`` promises callers."""
    for gi, g in enumerate(kg.groups):
        label = _view_label(kg, gi)
        shape = shapes.get(g.buffer)
        if shape is None:
            out.append(PlanViolation(
                "UB101", kg.name, f"view of unknown buffer {g.buffer!r}",
                view=label,
            ))
            continue
        if len(shape) != g.ndim:
            out.append(PlanViolation(
                "UB101", kg.name,
                f"view rank {g.ndim} != buffer rank {len(shape)}", view=label,
            ))
            continue
        rows = g.rows0 if g.pinned else kg.e0
        dims: List[str] = []
        ivs: List[Tuple[int, int]] = []
        exprs: List[AffineExpr] = []
        bad = None
        for j in range(g.ndim):
            d = f"i{j}"
            dims.append(d)
            if j == g.blocked_axis:
                if rows <= 0:
                    bad = f"degenerate blocked axis {j}: {rows} rows"
                    break
                ivs.append((0, rows - 1))
                exprs.append(AffineExpr.var(d) * g.stride0 + AffineExpr.constant(g.k0))
            elif j == g.lane_axis:
                cols = (
                    g.cols0 if g.lane_pinned
                    else (kg.e1 if kg.e1 is not None else 1)
                )
                if cols <= 0:
                    bad = f"degenerate lane axis {j}: {cols} columns"
                    break
                ivs.append((0, cols - 1))
                exprs.append(
                    AffineExpr.var(d) * g.lane_stride + AffineExpr.constant(g.l0)
                )
            else:
                if g.span[j] <= 0:
                    bad = f"degenerate axis {j}: span {g.span[j]}"
                    break
                ivs.append((g.base[j], g.base[j] + g.span[j] - 1))
                exprs.append(AffineExpr.var(d))
        if bad is not None:
            out.append(PlanViolation("UB101", kg.name, bad, view=label))
            continue
        dom = Box(tuple(dims), tuple(ivs))
        image = map_image(
            AffineMap(tuple(dims), tuple(exprs)), dom,
            out_dims=tuple(f"x{j}" for j in range(g.ndim)),
        )
        buf = Box.from_extents(tuple(f"x{j}" for j in range(g.ndim)), shape)
        escaped = image.difference(buf)
        if escaped:
            witness = tuple(lo for lo, _ in escaped[0].intervals)
            out.append(PlanViolation(
                "UB101", kg.name,
                f"view image {image.intervals} escapes buffer extents {shape}",
                view=label, witness=witness,
            ))


def _check_block_taps(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB102: in-kernel tap slices fit the delivered block.  Per view
    binding, every non-blocked/non-lane axis's tap interval (reduction
    offsets + pure-dim sweep, relative to the group's hulled base) must fit
    the group's span; ring taps must start inside the carried halo and at
    the row the binding's view start implies."""
    rg = kg.red_grid
    for sp in kg.stages:
        red_ext = sp.red_extent_map(rg)
        ext_of = sp.nstage.extent
        for k, la in enumerate(sp.accesses):
            if sp.load_kind[k] != "view":
                continue
            for bk, gi in sp.view_binding[k].items():
                if not (0 <= gi < len(kg.groups)):
                    out.append(PlanViolation(
                        "UB102", kg.name, f"binding {bk} -> missing group {gi}",
                        stage=sp.name,
                    ))
                    continue
                g = kg.groups[gi]
                label = _view_label(kg, gi)
                shift, off = bk[0], bk[1]
                if g.blocked_axis is not None and off is not None:
                    want_k0 = off + g.stride0 * shift
                    if g.k0 != want_k0:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"binding {bk} implies view start {want_k0}, "
                            f"group has k0={g.k0}",
                            stage=sp.name, view=label, witness=(g.k0,),
                        ))
                if (
                    g.lane_axis is not None and not g.lane_pinned
                    and len(bk) >= 4 and bk[3] is not None
                ):
                    want_l0 = bk[3] + g.lane_stride * bk[2]
                    if g.l0 != want_l0:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"binding {bk} implies lane start {want_l0}, "
                            f"group has l0={g.l0}",
                            stage=sp.name, view=label, witness=(g.l0,),
                        ))
                for j, ax in enumerate(la.axes):
                    if j == g.blocked_axis or j == g.lane_axis:
                        continue                 # block-relative; tile by bh/bw
                    if j == g.red_axis:
                        if rg is None:
                            continue             # undeclared dim: UB301 reports
                        if g.resident:
                            full = ext_of(rg.dim)
                            if g.base[j] != 0 or g.span[j] < full:
                                out.append(PlanViolation(
                                    "UB102", kg.name,
                                    f"resident reduction axis {j} holds "
                                    f"[{g.base[j]}, {g.base[j] + g.span[j]}) "
                                    f"but the kernel indexes [0, {full})",
                                    stage=sp.name, view=label,
                                    witness=(full - 1,),
                                ))
                        else:
                            lo, hi = ax.offset_range(red_ext)
                            w = _interval_witness(lo, hi, g.red_chunk)
                            if w is not None:
                                out.append(PlanViolation(
                                    "UB102", kg.name,
                                    f"reduction-axis tap offset {w} outside "
                                    f"the delivered chunk [0, {g.red_chunk})",
                                    stage=sp.name, view=label, witness=(w,),
                                ))
                        continue
                    lo, hi = _tap_interval(ax, red_ext, ext_of)
                    w = _interval_witness(lo - g.base[j], hi - g.base[j], g.span[j])
                    if w is not None:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"axis {j} tap [{lo}, {hi}] outside delivered "
                            f"span [{g.base[j]}, {g.base[j] + g.span[j]})",
                            stage=sp.name, view=label, witness=(w + g.base[j],),
                        ))
            for bk, (ri, t0) in sp.ring_binding[k].items():
                if not (0 <= ri < len(kg.rings)):
                    out.append(PlanViolation(
                        "UB102", kg.name, f"binding {bk} -> missing ring {ri}",
                        stage=sp.name,
                    ))
                    continue
                r = kg.rings[ri]
                label = f"ring:{'lane:' if r.lane else ''}{r.buffer}[{ri}]"
                shift, off = bk[0], bk[1]
                if r.lane:
                    # column ring: the tap column t0 is implied by the
                    # binding's *lane* start, and the shared row binding of
                    # the delivery class must match the one the tap uses —
                    # drift in either reads the wrong carried column
                    lshift, loff = bk[2], bk[3]
                    lstart = loff + r.stride0 * lshift - r.lo
                    if lstart % r.stride0 != 0 or lstart // r.stride0 != t0:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"lane ring tap {bk} starts at column {t0}, but "
                            f"its lane start implies column "
                            f"{lstart}/{r.stride0}",
                            stage=sp.name, view=label, witness=(t0,),
                        ))
                    if not (0 <= t0 <= r.halo):
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"lane ring tap column {t0} outside the carried "
                            f"halo [0, {r.halo}] — the tap window "
                            f"[{t0}, {t0}+bw) escapes the {r.halo}+bw-column "
                            f"ring",
                            stage=sp.name, view=label, witness=(t0,),
                        ))
                    if off is not None and off + r.row_stride * shift != r.row_k0:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"lane ring tap {bk} implies row start "
                            f"{off + r.row_stride * shift}, but the delivery "
                            f"class is bound at row_k0={r.row_k0}",
                            stage=sp.name, view=label, witness=(r.row_k0,),
                        ))
                else:
                    start = off + r.stride0 * shift - r.lo
                    if start % r.stride0 != 0 or start // r.stride0 != t0:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"ring tap {bk} starts at row {t0}, but its view "
                            f"start implies row {start}/{r.stride0}",
                            stage=sp.name, view=label, witness=(t0,),
                        ))
                    if not (0 <= t0 <= r.halo):
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"ring tap row {t0} outside the carried halo "
                            f"[0, {r.halo}] — the tap window [{t0}, {t0}+bh) "
                            f"escapes the {r.halo}+bh-row ring",
                            stage=sp.name, view=label, witness=(t0,),
                        ))
                for j, ax in enumerate(la.axes):
                    if j == r.axis or (r.lane and j == r.row_axis):
                        continue                 # tiled by bw / bh
                    lo, hi = _tap_interval(ax, red_ext, ext_of)
                    w = _interval_witness(lo - r.base[j], hi - r.base[j], r.span[j])
                    if w is not None:
                        out.append(PlanViolation(
                            "UB102", kg.name,
                            f"axis {j} ring tap [{lo}, {hi}] outside hull "
                            f"[{r.base[j]}, {r.base[j] + r.span[j]})",
                            stage=sp.name, view=label, witness=(w + r.base[j],),
                        ))


def _check_scratch_taps(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB103: every fused (scratch) tap hits a panel the producer actually
    materializes — a planned ``(shift, lane shift)`` panel in recompute
    mode, a ring row within ``[lo, hi]`` under a line buffer — and the
    producer runs before the consumer, so no read sees uninitialized
    scratch.  Inner tap axes must also fit the producer's panel extents."""
    order = {sp.name: i for i, sp in enumerate(kg.stages)}
    lane = kg.lane_grid is not None
    for ci, sp in enumerate(kg.stages):
        red_ext = sp.red_extent_map(kg.red_grid)
        ext_of = sp.nstage.extent
        for k, la in enumerate(sp.accesses):
            if sp.load_kind[k] != "scratch":
                continue
            pname = sp.scratch_producer[k]
            if pname is None or pname not in order:
                out.append(PlanViolation(
                    "UB103", kg.name,
                    f"scratch load {k} names unknown producer {pname!r}",
                    stage=sp.name,
                ))
                continue
            if order[pname] >= ci:
                out.append(PlanViolation(
                    "UB103", kg.name,
                    f"reads {pname!r} before it is evaluated "
                    f"(stage order {order[pname]} >= {ci})",
                    stage=sp.name,
                ))
                continue
            psp = kg.stage_plan(pname)
            plb = psp.line_buffer
            row_offs = la.axes[0].offsets(red_ext)
            jL = sp.lane_axis_of[k] if lane else None
            lane_offs = la.axes[jL].offsets(red_ext) if jL is not None else [0]
            panels = {
                (s, t) for s in psp.shifts for t in psp.lane_shifts
            }
            for s in sp.bind_shifts():
                for o in row_offs:
                    slot = o + s
                    if plb is not None and plb.lane:
                        # producer carried in per-row-shift *column* rings:
                        # the row slot must name a planned ring, and every
                        # lane tap must land inside the carried lane window
                        if slot not in psp.shifts:
                            out.append(PlanViolation(
                                "UB103", kg.name,
                                f"taps {pname!r} at row shift {slot}, but "
                                f"its column rings exist only at row shifts "
                                f"{sorted(psp.shifts)}",
                                stage=sp.name, witness=(slot,),
                            ))
                        for t in sp.bind_lane_shifts() if lane else (0,):
                            for lo_ in lane_offs:
                                lslot = lo_ + t
                                if not (plb.lo <= lslot <= plb.hi):
                                    out.append(PlanViolation(
                                        "UB103", kg.name,
                                        f"taps {pname!r} at lane shift "
                                        f"{lslot}, but its column ring "
                                        f"carries [{plb.lo}, {plb.hi}]",
                                        stage=sp.name, witness=(slot, lslot),
                                    ))
                        continue
                    if plb is not None:
                        if not (plb.lo <= slot <= plb.hi):
                            out.append(PlanViolation(
                                "UB103", kg.name,
                                f"taps {pname!r} at row shift {slot}, but its "
                                f"ring carries [{plb.lo}, {plb.hi}]",
                                stage=sp.name, witness=(slot,),
                            ))
                        continue
                    for t in sp.bind_lane_shifts() if lane else (0,):
                        for lo_ in lane_offs:
                            lslot = lo_ + t
                            if (slot, lslot) not in panels:
                                out.append(PlanViolation(
                                    "UB103", kg.name,
                                    f"taps {pname!r} at panel "
                                    f"(shift {slot}, lane {lslot}) which is "
                                    f"never materialized "
                                    f"(planned {sorted(panels)})",
                                    stage=sp.name, witness=(slot, lslot),
                                ))
            # inner axes index the producer's panel directly
            pext = psp.nstage.pure_extents
            for j, ax in enumerate(la.axes):
                if j == 0 or j == jL or j >= len(pext):
                    continue
                lo, hi = _tap_interval(ax, red_ext, ext_of)
                w = _interval_witness(lo, hi, pext[j])
                if w is not None:
                    out.append(PlanViolation(
                        "UB103", kg.name,
                        f"axis {j} taps {pname!r} panel at [{lo}, {hi}] "
                        f"outside extent {pext[j]}",
                        stage=sp.name, witness=(w,),
                    ))


# ---------------------------------------------------------------------------
# UB2xx — mask soundness
# ---------------------------------------------------------------------------


def _check_masks(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB201: wherever the grid delivers rows/lanes past the valid extents,
    the plan carries consistent masking metadata.  The emitter's taint
    discipline — iota row/lane masks keyed on ``padded_grid``/``lane_grid``,
    applied to every store and accumulate — kills any value derived from
    rows beyond ``valid_e0`` / lanes beyond ``valid1``; this rule proves the
    metadata those masks are keyed on exists and matches the grid, and that
    every streaming view declares the valid extents the masks assume."""
    if kg.streamed:
        steps0 = kg.steps0
        pg = kg.padded_grid
        if pg is not None:
            if (pg.extent, pg.block, pg.steps) != (kg.e0, kg.bh, steps0):
                out.append(PlanViolation(
                    "UB201", kg.name,
                    f"padded_grid ({pg.extent}, {pg.block}, {pg.steps}) != "
                    f"grid reality ({kg.e0}, {kg.bh}, {steps0})",
                    witness=(pg.extent, pg.block, pg.steps),
                ))
        elif steps0 * kg.bh > kg.e0:
            out.append(PlanViolation(
                "UB201", kg.name,
                f"{steps0} x {kg.bh}-row steps deliver "
                f"{steps0 * kg.bh - kg.e0} rows past the {kg.e0}-row extent "
                f"with no padded_grid to mask them",
                witness=(kg.e0,),
            ))
        lg = kg.lane_grid
        if lg is not None:
            steps1 = (
                kg.grid[kg.bofs + 1] if len(kg.grid) > kg.bofs + 1 else 0
            )
            if kg.bw is None or (lg.extent, lg.block, lg.steps) != (
                kg.e1, kg.bw, steps1
            ):
                out.append(PlanViolation(
                    "UB201", kg.name,
                    f"lane_grid ({lg.extent}, {lg.block}, {lg.steps}) != "
                    f"grid reality ({kg.e1}, {kg.bw}, {steps1})",
                    witness=(lg.extent, lg.block, lg.steps),
                ))
        elif kg.bw is not None:
            out.append(PlanViolation(
                "UB201", kg.name,
                f"lane block bw={kg.bw} without a lane_grid declaring the "
                f"valid lane extent",
            ))
    else:
        if kg.padded_grid is not None or kg.lane_grid is not None:
            out.append(PlanViolation(
                "UB201", kg.name,
                "unstreamed kernel carries padded/lane grid metadata",
            ))
    for gi, g in enumerate(kg.groups):
        if g.blocked_axis is not None and not g.pinned and g.valid0 != kg.e0:
            out.append(PlanViolation(
                "UB201", kg.name,
                f"streaming view valid0={g.valid0} != output extent {kg.e0}: "
                f"tail masks would trust the wrong valid row count",
                view=_view_label(kg, gi),
                witness=() if g.valid0 is None else (g.valid0,),
            ))
        if g.lane_axis is not None and not g.lane_pinned and g.valid1 != kg.e1:
            # lane-pinned warm-up views are exempt: they deliver a fixed
            # halo-column window whose coverage UB205 proves directly
            out.append(PlanViolation(
                "UB201", kg.name,
                f"lane view valid1={g.valid1} != lane extent {kg.e1}",
                view=_view_label(kg, gi),
                witness=() if g.valid1 is None else (g.valid1,),
            ))


def _check_rings(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB202: each input ring's warm-up (pinned prefix) view covers exactly
    the carried halo starting at the trailing view start ``lo``, the steady
    view streams from the leading start ``hi``, and the halo fits the block
    (a rotate whose source overlaps its destination would tear the carried
    rows) — so every carried row is initialized before any tap reads it.
    Lane (column) rings are proved by UB205 (:func:`_check_lane_carry`)."""
    for ri, r in enumerate(kg.rings):
        if r.lane:
            continue
        label = f"ring:{r.buffer}[{ri}]"
        if r.hi <= r.lo or r.stride0 < 1 or (r.hi - r.lo) % r.stride0 != 0:
            out.append(PlanViolation(
                "UB202", kg.name,
                f"degenerate ring window lo={r.lo} hi={r.hi} "
                f"stride={r.stride0}",
                view=label, witness=(r.lo, r.hi),
            ))
            continue
        if r.halo > kg.bh:
            out.append(PlanViolation(
                "UB202", kg.name,
                f"carried halo {r.halo} exceeds block height {kg.bh}: the "
                f"rotate's source overlaps rows it has not yet refreshed",
                view=label, witness=(r.halo,),
            ))
        ok_prefix = (
            0 <= r.prefix < len(kg.groups)
            and kg.groups[r.prefix].pinned
            and kg.groups[r.prefix].rows0 == r.halo
            and kg.groups[r.prefix].k0 == r.lo
            and kg.groups[r.prefix].stride0 == r.stride0
            and kg.groups[r.prefix].blocked_axis == r.axis
        )
        if not ok_prefix:
            got = (
                kg.groups[r.prefix] if 0 <= r.prefix < len(kg.groups) else None
            )
            out.append(PlanViolation(
                "UB202", kg.name,
                f"warm-up view must pin {r.halo} rows from {r.lo} "
                f"(stride {r.stride0}) on axis {r.axis}; got "
                + (
                    f"rows0={got.rows0} k0={got.k0} stride={got.stride0} "
                    f"pinned={got.pinned}" if got is not None
                    else f"missing group {r.prefix}"
                ),
                view=label, witness=(r.halo,),
            ))
        ok_steady = (
            0 <= r.steady < len(kg.groups)
            and not kg.groups[r.steady].pinned
            and kg.groups[r.steady].k0 == r.hi
            and kg.groups[r.steady].stride0 == r.stride0
            and kg.groups[r.steady].blocked_axis == r.axis
        )
        if not ok_steady:
            out.append(PlanViolation(
                "UB202", kg.name,
                f"steady view must stream from the leading start {r.hi} "
                f"(stride {r.stride0}) on axis {r.axis}",
                view=label, witness=(r.hi,),
            ))


def _check_line_buffers(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB203: a row-line-buffered stage's ring spans exactly the demanded
    shift window (``lo = min(shifts)``, ``hi = max(shifts)``) and its halo
    fits the block (steady steps compute ``bh`` rows; a larger halo would
    carry rows no step ever wrote).  Row carry cannot compose with a lane
    grid — between two visits of one row panel every lane step clobbers the
    ring — so that pairing is a UB205 violation; *lane* line buffers (the
    sound column variant) are proved by :func:`_check_lane_carry`."""
    for sp in kg.stages:
        lb = sp.line_buffer
        if lb is None or lb.lane:
            continue
        if kg.lane_grid is not None:
            out.append(PlanViolation(
                "UB205", kg.name,
                "row line buffer composed with a lane grid: every lane "
                "step would rotate rows the next lane step still needs — "
                "only a lane (column) line buffer carries under a 2-D grid",
                stage=sp.name,
            ))
        if sp is kg.stages[-1]:
            out.append(PlanViolation(
                "UB203", kg.name, "output stage cannot be line-buffered",
                stage=sp.name,
            ))
            continue
        if not sp.shifts or lb.lo != min(sp.shifts) or lb.hi != max(sp.shifts):
            out.append(PlanViolation(
                "UB203", kg.name,
                f"ring window [{lb.lo}, {lb.hi}] != demanded shift span "
                f"[{min(sp.shifts) if sp.shifts else 0}, "
                f"{max(sp.shifts) if sp.shifts else 0}]",
                stage=sp.name, witness=(lb.lo, lb.hi),
            ))
        if lb.halo > kg.bh:
            out.append(PlanViolation(
                "UB203", kg.name,
                f"carried halo {lb.halo} exceeds block height {kg.bh}",
                stage=sp.name, witness=(lb.halo,),
            ))
        if not kg.streamed or not sp.streamed:
            out.append(PlanViolation(
                "UB203", kg.name,
                "line buffer on an unstreamed stage has no grid to carry "
                "across",
                stage=sp.name,
            ))


def _check_lane_carry(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB205: the per-lane rotation model for carry under a lane-blocked
    2-D grid.  Each lane (column) ring holds ``(bh, ..., bw + halo)``
    columns; the emitter rotates it once per lane step (``jprog > 0``) and
    re-warms it at lane step 0 of *every* row step — a guard that recurs at
    every row step of every batch slot, which is what makes the carry
    batch-composed through ``bofs`` for free.  This rule proves, per ring:

    * the lane window is well-formed and its halo fits the lane block
      (``halo <= bw`` — the rotate's source ``[bw, bw + halo)`` must not
      overlap columns it has not yet refreshed);
    * the warm-up (lane-pinned prefix) view delivers exactly the ``halo``
      carried columns from the trailing lane start ``lo``, sharing the
      class's row binding, so every carried column is initialized before
      any tap reads it;
    * the steady view streams ``bw`` fresh columns per lane step from the
      leading lane start ``hi`` with the same row binding — with the
      warm-up that tiles the lane extent exactly once per ``(row, lane)``
      sweep (lane-step coverage itself is UB301);
    * the warm-up re-fires per row sweep (``batch_reset``), unbatched case
      here, batched under UB502 — a global-first warm-up would serve row
      step ``i`` columns rotated out of row step ``i - 1``.

    Lane *line buffers* (fused-stage column rings, one per demanded row
    shift) get the analogous checks, and any lane carry structure on a
    kernel with no lane grid is rejected outright."""
    lane_ok = kg.lane_grid is not None and kg.bw is not None
    for ri, r in enumerate(kg.rings):
        if not r.lane:
            if lane_ok:
                out.append(PlanViolation(
                    "UB205", kg.name,
                    f"row ring '{r.buffer}' on a lane-blocked kernel: every "
                    f"lane step would rotate rows the next lane step still "
                    f"needs",
                ))
            continue
        label = f"ring:lane:{r.buffer}[{ri}]"
        if not lane_ok:
            out.append(PlanViolation(
                "UB205", kg.name,
                "lane ring on a kernel with no lane grid has no lane steps "
                "to rotate across",
                view=label,
            ))
            continue
        if (
            r.hi <= r.lo or r.stride0 < 1
            or (r.hi - r.lo) % r.stride0 != 0
            or r.row_axis is None or r.row_axis == r.axis
        ):
            out.append(PlanViolation(
                "UB205", kg.name,
                f"degenerate lane ring window lo={r.lo} hi={r.hi} "
                f"stride={r.stride0} row_axis={r.row_axis} axis={r.axis}",
                view=label, witness=(r.lo, r.hi),
            ))
            continue
        if r.halo > kg.bw:
            out.append(PlanViolation(
                "UB205", kg.name,
                f"carried lane halo {r.halo} exceeds lane block width "
                f"{kg.bw}: the rotate's source overlaps columns it has not "
                f"yet refreshed",
                view=label, witness=(r.halo,),
            ))
        pfx = (
            kg.groups[r.prefix] if 0 <= r.prefix < len(kg.groups) else None
        )
        ok_prefix = (
            pfx is not None
            and pfx.lane_pinned and not pfx.pinned
            and pfx.cols0 == r.halo
            and pfx.lane_axis == r.axis
            and pfx.l0 == r.lo
            and pfx.lane_stride == r.stride0
            and pfx.blocked_axis == r.row_axis
            and pfx.k0 == r.row_k0
            and pfx.stride0 == r.row_stride
        )
        if not ok_prefix:
            out.append(PlanViolation(
                "UB205", kg.name,
                f"lane warm-up view must lane-pin exactly {r.halo} columns "
                f"from {r.lo} (stride {r.stride0}) on axis {r.axis} with "
                f"row binding (axis {r.row_axis}, k0={r.row_k0}, stride "
                f"{r.row_stride}); got "
                + (
                    f"cols0={pfx.cols0} l0={pfx.l0} "
                    f"lane_stride={pfx.lane_stride} "
                    f"lane_pinned={pfx.lane_pinned} k0={pfx.k0}"
                    if pfx is not None else f"missing group {r.prefix}"
                ),
                view=label, witness=(r.halo,),
            ))
        sty = (
            kg.groups[r.steady] if 0 <= r.steady < len(kg.groups) else None
        )
        ok_steady = (
            sty is not None
            and not sty.pinned and not sty.lane_pinned
            and sty.lane_axis == r.axis
            and sty.l0 == r.hi
            and sty.lane_stride == r.stride0
            and sty.blocked_axis == r.row_axis
            and sty.k0 == r.row_k0
            and sty.stride0 == r.row_stride
        )
        if not ok_steady:
            out.append(PlanViolation(
                "UB205", kg.name,
                f"lane steady view must stream from the leading lane start "
                f"{r.hi} (stride {r.stride0}) on axis {r.axis} with row "
                f"binding (axis {r.row_axis}, k0={r.row_k0}, stride "
                f"{r.row_stride}); got "
                + (
                    f"l0={sty.l0} lane_stride={sty.lane_stride} "
                    f"lane_pinned={sty.lane_pinned} k0={sty.k0}"
                    if sty is not None else f"missing group {r.steady}"
                ),
                view=label, witness=(r.hi,),
            ))
        if not r.batch_reset and not kg.batched:
            out.append(PlanViolation(
                "UB205", kg.name,
                f"lane ring '{r.buffer}' warms up only at the global first "
                f"row step (batch_reset=False): row step i would read "
                f"columns rotated out of row step i-1",
                view=label,
            ))
    for sp in kg.stages:
        lb = sp.line_buffer
        if lb is None or not lb.lane:
            continue
        if not lane_ok:
            out.append(PlanViolation(
                "UB205", kg.name,
                "lane line buffer on a kernel with no lane grid has no "
                "lane steps to rotate across",
                stage=sp.name,
            ))
            continue
        if sp is kg.stages[-1]:
            out.append(PlanViolation(
                "UB205", kg.name,
                "output stage cannot be lane-line-buffered",
                stage=sp.name,
            ))
            continue
        ls = sp.lane_shifts
        if not ls or lb.lo != min(ls) or lb.hi != max(ls):
            out.append(PlanViolation(
                "UB205", kg.name,
                f"column-ring window [{lb.lo}, {lb.hi}] != demanded lane "
                f"shift span [{min(ls) if ls else 0}, {max(ls) if ls else 0}]",
                stage=sp.name, witness=(lb.lo, lb.hi),
            ))
        if lb.halo > kg.bw:
            out.append(PlanViolation(
                "UB205", kg.name,
                f"carried lane halo {lb.halo} exceeds lane block width "
                f"{kg.bw}",
                stage=sp.name, witness=(lb.halo,),
            ))
        if not kg.streamed or not sp.streamed:
            out.append(PlanViolation(
                "UB205", kg.name,
                "lane line buffer on an unstreamed stage has no grid to "
                "carry across",
                stage=sp.name,
            ))
        if not lb.batch_reset and not kg.batched:
            out.append(PlanViolation(
                "UB205", kg.name,
                "lane line buffer warms up only at the global first row "
                "step (batch_reset=False): row step i would read columns "
                "rotated out of row step i-1",
                stage=sp.name,
            ))


def _check_red_grid(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB204: a grid-lifted reduction covers its true extent by
    ceil-division — the masked tail is the only shortfall allowed — and the
    declared dim is the stage's leading reduction dim (the contract that
    keeps chunked accumulation order identical to the reference)."""
    rg = kg.red_grid
    if rg is None:
        return
    if len(kg.stages) != 1:
        out.append(PlanViolation(
            "UB204", kg.name,
            "grid reduction on a fused kernel is unsupported",
        ))
        return
    ns = kg.output.nstage
    if not ns.red_dims or rg.dim != ns.red_dims[0]:
        out.append(PlanViolation(
            "UB204", kg.name,
            f"RedGrid dim {rg.dim!r} is not the leading reduction dim "
            f"{ns.red_dims[:1]}",
        ))
        return
    true_extent = ns.red_extents[0]
    if rg.extent != true_extent:
        out.append(PlanViolation(
            "UB204", kg.name,
            f"RedGrid extent {rg.extent} != true reduction extent "
            f"{true_extent}: tail terms would be mis-masked",
            witness=(rg.extent,),
        ))
    if rg.chunk < 1 or rg.steps != _cdiv(rg.extent, rg.chunk):
        out.append(PlanViolation(
            "UB204", kg.name,
            f"RedGrid steps {rg.steps} != ceil({rg.extent}/{rg.chunk}): "
            f"accumulation would drop or repeat chunks",
            witness=(rg.steps,),
        ))
    if not kg.grid or kg.grid[-1] != rg.steps:
        out.append(PlanViolation(
            "UB204", kg.name,
            f"grid {kg.grid} does not end with the {rg.steps} reduction "
            f"steps",
        ))


# ---------------------------------------------------------------------------
# UB3xx — write disjointness / exactly-once
# ---------------------------------------------------------------------------


def _check_write_once(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB301: grid dim 0 tiles the output rows disjointly and covers the
    extent; every *additional* grid dim must be declared — the lane grid
    (disjoint lane blocks) or a RedGrid (accumulation) — otherwise two grid
    steps would store the same output element twice.

    The batch dim (when declared via ``batch_grid``; UB501 proves the
    declaration itself) is write-disjoint by construction — every slot
    stores its own output tile — so it is excluded from the extra-dim
    count here."""
    n_extra = len(kg.grid) - 1 - kg.bofs
    declared = (1 if kg.lane_grid is not None else 0) + (
        1 if kg.red_grid is not None else 0
    )
    if kg.lane_grid is not None and kg.red_grid is not None:
        out.append(PlanViolation(
            "UB301", kg.name,
            "lane grid and reduction grid both claim grid dim 1",
        ))
    if n_extra != declared:
        out.append(PlanViolation(
            "UB301", kg.name,
            f"grid {kg.grid} has {n_extra} dim(s) beyond the row dim but "
            f"only {declared} declared (lane_grid/red_grid): undeclared "
            f"steps would rewrite the same output element",
            witness=(0,) * len(kg.output.nstage.pure_extents),
        ))
    if kg.streamed:
        covered = kg.steps0 * kg.bh
        if covered < kg.e0:
            out.append(PlanViolation(
                "UB301", kg.name,
                f"{kg.steps0} x {kg.bh}-row steps cover {covered} of "
                f"{kg.e0} output rows: rows [{covered}, {kg.e0}) are never "
                f"written",
                witness=(covered,),
            ))
        if kg.lane_grid is not None:
            steps1 = (
                kg.grid[kg.bofs + 1] if len(kg.grid) > kg.bofs + 1 else 0
            )
            lane_cov = steps1 * (kg.bw or 0)
            if kg.e1 is not None and lane_cov < kg.e1:
                out.append(PlanViolation(
                    "UB301", kg.name,
                    f"lane steps cover {lane_cov} of {kg.e1} lanes",
                    witness=(0, lane_cov),
                ))
    else:
        if kg.base_grid != (1,):
            out.append(PlanViolation(
                "UB301", kg.name,
                f"unstreamed kernel must run a single grid step per batch "
                f"slot, got {kg.grid}",
            ))


def _derive_shift_sets(kg: KernelGroup) -> Dict[str, Set[int]]:
    """Re-derive each fused stage's demanded row-shift set straight from
    the raw access maps (the same reverse-topological propagation the
    planner runs, but independent of the stored ``shifts`` fields)."""
    derived: Dict[str, Set[int]] = {kg.stages[-1].name: {0}}
    for sp in reversed(kg.stages[:-1]):
        req: Set[int] = set()
        for cons in kg.stages:
            if cons.name == sp.name:
                continue
            red_ext = dict(
                zip(cons.nstage.red_dims, cons.nstage.red_extents)
            )
            for k, la in enumerate(cons.accesses):
                if (
                    cons.load_kind[k] != "scratch"
                    or cons.scratch_producer[k] != sp.name
                ):
                    continue
                for off in la.axes[0].offsets(red_ext):
                    for s in derived.get(cons.name, set()):
                        req.add(off + s)
        derived[sp.name] = req
    return derived


def _check_eval_accounting(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB302/UB503: the planned shift sets match the ones the access maps
    demand, and the per-stage eval-row counts implied by those derived sets
    (and the grid) match ``KernelGroup.eval_rows()`` — the metric every
    recompute-vs-carry decision and test harness trusts.

    Under a batch grid the ground truth for the batch-step count is the
    grid itself (``kg.grid[0]``), never ``batch_grid.steps`` — the same
    independence principle the unbatched checks follow.  A line buffer
    with ``batch_reset=False`` warms up once globally instead of once per
    batch slot, so its true eval count drops below the per-batch
    accounting; both drifts are exactly-once-per-batch violations and
    fire UB503 (UB302 stays the unbatched rule)."""
    derived = _derive_shift_sets(kg)
    reported = kg.eval_rows()
    steps = kg.steps0 if kg.streamed else 1
    lane_steps = kg.lane_steps
    bsteps = kg.grid[0] if kg.batched else 1
    eval_rule = "UB503" if kg.batched else "UB302"
    for sp in kg.stages:
        want = derived.get(sp.name, set())
        if set(sp.shifts) != want:
            out.append(PlanViolation(
                "UB302", kg.name,
                f"planned shifts {sorted(sp.shifts)} != demanded "
                f"{sorted(want)}",
                stage=sp.name,
            ))
            continue
        if not (kg.streamed and sp.streamed):
            expect = bsteps * sp.e0
        elif sp.line_buffer is not None and sp.line_buffer.lane:
            # per (row step, row shift): one bw-wide panel per lane step
            # plus one halo-wide warm-up panel per row step — the
            # ``lane_steps + 1`` shape is the exactly-once accounting of
            # the (row, lane) sweep, re-run in full per batch slot
            expect = bsteps * steps * kg.bh * len(want) * (lane_steps + 1)
        elif sp.line_buffer is not None:
            halo = max(want) - min(want)
            if kg.batched and not sp.line_buffer.batch_reset:
                # Warm-up runs once for the whole batched sweep — the
                # emission this plan describes under-evaluates every slot
                # after the first.
                expect = bsteps * steps * kg.bh + halo
            else:
                expect = bsteps * (steps * kg.bh + halo)
        else:
            expect = bsteps * (
                steps * kg.bh * len(want) * lane_steps * len(sp.lane_shifts)
            )
        got = reported.get(sp.name)
        if got != expect:
            out.append(PlanViolation(
                eval_rule, kg.name,
                f"eval_rows reports {got}, derived accounting says {expect}",
                stage=sp.name,
                witness=(got if got is not None else -1, expect),
            ))


# ---------------------------------------------------------------------------
# UB4xx — budget audit
# ---------------------------------------------------------------------------


def _staged_copies(kg: KernelGroup) -> int:
    """Shared-memory bytes of what a group planned against shared memory
    (``kg.panels`` or ``kg.chain``) stages: each buffer read only through
    grid-invariant views (but a chain's ``unstaged`` ones), over the hull
    of those views, each panel buffer's axis cut to one panel, every extent
    after the first padded to an odd count as the CUDA kernel lays the copy
    out."""
    if kg.panels is not None:
        pn = kg.panels
        cuts = [(pn.group, pn.axis, pn.block)]
    elif kg.chain is not None:
        cuts = [(gi, a, kg.chain.block) for gi, a in kg.chain.staged]
    else:
        cuts = []
    # a chain's panel cut on a leading axis: rows of whole 16-byte words,
    # the innermost extent padded to 4 more than a multiple of 8
    words = set()
    direct = {g.buffer for g in kg.groups if g.blocked_axis is not None}
    if kg.chain is not None:
        direct |= set(kg.chain.unstaged)
    hull: Dict[str, List[int]] = {}
    for g in kg.groups:
        if g.buffer in direct:
            continue
        need = [g.base[j] + g.span[j] for j in range(g.ndim)]
        prev = hull.get(g.buffer)
        hull[g.buffer] = [max(a, b) for a, b in zip(prev, need)] if prev else need
    for gi, axis, block in cuts:
        if 0 <= gi < len(kg.groups):
            ext = hull.get(kg.groups[gi].buffer)
            if ext is not None and 0 <= axis < len(ext):
                ext[axis] = block
                if kg.chain is not None and axis < len(ext) - 1:
                    words.add(kg.groups[gi].buffer)

    def padded(buf: str, ext: List[int]) -> List[int]:
        out = [e if a == 0 or e % 2 else e + 1 for a, e in enumerate(ext)]
        if buf in words:
            out[-1] = ext[-1] + (4 - ext[-1]) % 8
        return out

    return sum(ELEM_BYTES * math.prod(padded(buf, ext)) for buf, ext in hull.items())


def _scratch_rows(kg: KernelGroup) -> int:
    """Elements of one panel row of every recompute-mode scratch entry; a
    chain's hidden stage holds one panel of its innermost axis, and a panel
    that takes a dead panel's words holds none of its own."""
    hidden = kg.chain.hidden if kg.chain is not None else ()
    takers = kg.chain.takers if kg.chain is not None else ()
    rows = 0
    for sp in kg.stages[:-1]:
        if sp.name in takers:
            continue
        sh = list(sp.nstage.pure_extents[1:])
        if sp.name in hidden and sh:
            sh[-1] = kg.chain.block
        rows += len(sp.shifts) * len(sp.lane_shifts) * (math.prod(sh) if sh else 1)
    return rows


def _resummed_vmem_bytes(kg: KernelGroup) -> int:
    """Independent re-summation of the kernel's VMEM residency under the
    declared double-buffering rules: grid-advanced view streams are double
    buffered, pinned/resident views, rings, and scratch are single, the
    output panel is pipelined (double).  A group planned against shared
    memory (``kg.panels``, ``kg.chain``, ``kg.window``) holds its scratch
    and its staged copies only."""
    if kg.smem_planned:
        return kg.bh * _scratch_rows(kg) * ELEM_BYTES + _staged_copies(kg)
    total = 0
    for g in kg.groups:
        advanced = not g.pinned and (
            g.blocked_axis is not None
            or (
                g.red_axis is not None
                and not g.resident
                and len(kg.base_grid) > 1
            )
            or (g.lane_axis is not None and len(kg.base_grid) > 1)
        )
        blk = ELEM_BYTES * math.prod(g.block_shape(kg.bh, kg.bw))
        total += blk * (2 if advanced else 1)
    for r in kg.rings:
        total += r.ring_bytes(kg.bh, kg.bw)
    for sp, key in kg.scratch_entries():
        total += ELEM_BYTES * math.prod(sp.scratch_shape(kg.bh, key))
    total += 2 * kg.output.panel_bytes(kg.bh)
    return total


def _resummed_ws(kg: KernelGroup) -> Tuple[int, int]:
    """Independent re-derivation of the planner's working-set accounting:
    ``bytes_per_row`` (everything that scales with the block height: the
    output panel, blocked view streams, ring bodies, scratch rows) and
    ``fixed`` (pinned warm-ups, broadcast/resident views, carried halos).
    For a group planned against shared memory (``kg.panels``, ``kg.chain``,
    ``kg.window``): its scratch rows, and its staged copies."""
    if kg.smem_planned:
        return _scratch_rows(kg) * ELEM_BYTES, _staged_copies(kg)
    lane = kg.bw is not None
    out_ns = kg.output.nstage
    inner_shape = list(out_ns.pure_extents[1:])
    if lane and inner_shape:
        inner_shape[-1] = kg.bw
    bpr = (math.prod(inner_shape) if inner_shape else 1) * ELEM_BYTES
    fixed = 0
    for g in kg.groups:
        sz = ELEM_BYTES * math.prod(
            (g.cols0 if g.lane_pinned else (kg.bw or 1))
            if j == g.lane_axis else (
                (g.span[j] if g.resident else g.red_chunk)
                if j == g.red_axis else g.span[j]
            )
            for j in range(g.ndim) if j != g.blocked_axis
        )
        if g.pinned:
            fixed += g.rows0 * sz
        elif g.blocked_axis is not None:
            bpr += sz
        elif g.lane_axis is not None:
            fixed += 2 * sz
        else:
            fixed += sz
    for r in kg.rings:
        if r.lane:
            # column ring (bh, ..., bw + halo): the whole ring scales with
            # the block height; there is no bh-independent part
            inner = math.prod(
                r.span[j] for j in range(r.ndim)
                if j != r.axis and j != r.row_axis
            )
            bpr += ((kg.bw or 0) + r.halo) * inner * ELEM_BYTES
            continue
        inner = math.prod(r.span[j] for j in range(r.ndim) if j != r.axis)
        bpr += inner * ELEM_BYTES
        fixed += r.halo * inner * ELEM_BYTES
    scratch_rows = 0
    for sp in kg.stages[:-1]:
        sh = list(sp.nstage.pure_extents[1:])
        if lane and sh:
            sh[-1] = kg.bw
        inner = math.prod(sh) if sh else 1
        if sp.line_buffer is not None and sp.line_buffer.lane:
            # one (bh, ..., bw + halo) column ring per demanded row shift
            shl = list(sp.nstage.pure_extents[1:])
            if shl:
                shl[-1] = (kg.bw or 0) + sp.line_buffer.halo
            scratch_rows += len(sp.shifts) * (math.prod(shl) if shl else 1)
        elif sp.line_buffer is not None:
            scratch_rows += inner
            fixed += sp.line_buffer.halo * inner * ELEM_BYTES
        else:
            scratch_rows += len(sp.shifts) * len(sp.lane_shifts) * inner
    bpr += scratch_rows * ELEM_BYTES
    return bpr, fixed


def _check_panels(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB404: a group planned against shared memory (``kg.panels``) is one
    the CUDA kernel runs as planned: it carries nothing (no ring, line
    buffer, grid reduction or lane grid; no pinned, lane- or
    reduction-tiled view), no buffer is read both through row-blocked views
    (read from global memory) and grid-invariant ones (staged), and its
    panel view is one grid-invariant view group, read by the output stage
    alone, whose panel axis spans the output stage's one reduction from 0,
    is indexed by that reduction's variable alone at stride 1, and is cut
    into panels that divide it."""
    pn = kg.panels
    if pn is None:
        return

    def bad(msg: str, *witness: int) -> None:
        out.append(PlanViolation("UB404", kg.name, msg, witness=tuple(witness)))

    if kg.rings or kg.line_buffered or kg.red_grid is not None or kg.lane_grid is not None:
        bad("weight panels in a group that carries rows, columns or chunks")
    if any(g.pinned or g.lane_axis is not None or g.red_axis is not None for g in kg.groups):
        bad("weight panels beside a pinned, lane- or reduction-tiled view")
    direct = {g.buffer for g in kg.groups if g.blocked_axis is not None}
    mixed = sorted({g.buffer for g in kg.groups if g.blocked_axis is None} & direct)
    if mixed:
        bad(f"buffers {mixed} read both row-blocked and grid-invariant")
    out_ns = kg.output.nstage
    if len(out_ns.red_dims) != 1:
        bad(f"weight panels on an output stage with reductions {out_ns.red_dims}")
        return
    red, extent = out_ns.red_dims[0], out_ns.red_extents[0]
    if not 0 <= pn.group < len(kg.groups):
        bad(f"panel view group {pn.group} does not exist", pn.group)
        return
    g = kg.groups[pn.group]
    if g.blocked_axis is not None or not 0 <= pn.axis < g.ndim:
        bad(f"panel view {g.buffer!r} is row-blocked or has no axis {pn.axis}", pn.axis)
        return
    if pn.extent != extent or g.base[pn.axis] != 0 or g.span[pn.axis] != extent:
        bad(f"panel axis of {g.buffer!r} [{g.base[pn.axis]}, +{g.span[pn.axis]}) "
            f"is not the reduction's extent {extent}", pn.extent, extent)
    if pn.block < 1 or extent % pn.block:
        bad(f"panel of {pn.block} does not divide the extent {extent}", pn.block, extent)
    if sum(h.buffer == g.buffer for h in kg.groups) != 1:
        bad(f"panel buffer {g.buffer!r} is read through more than one view")
    for sp in kg.stages:
        for la, binding in zip(sp.accesses, sp.view_binding):
            if pn.group not in binding.values():
                continue
            ax = la.axes[pn.axis]
            if sp is not kg.output:
                bad(f"panel view {g.buffer!r} read by fused stage {sp.name!r}")
            elif (ax.pure_dim, ax.const, ax.red_coeffs) != (None, 0, ((red, 1),)):
                bad(f"a load of {g.buffer!r} indexes its panel axis by {ax}, "
                    f"not by {red!r} alone")


def _along(ax: AxisAccess, dim: Optional[str], red: Optional[str]) -> bool:
    """Whether ``ax`` is the pure dim ``dim`` alone, or the reduction
    variable ``red`` alone: stride 1, offset 0."""
    if dim is not None:
        return (ax.pure_dim, ax.stride, ax.red_coeffs, ax.const) == (dim, 1, (), 0)
    return (ax.pure_dim, ax.red_coeffs, ax.const) == (None, ((red, 1),), 0)


def _check_chain(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB405: a chained group (``kg.chain``) is one the CUDA kernel runs as
    planned: it carries nothing (as UB404 asks), its consumer is a fused
    stage with one reduction over the hidden extent, each hidden stage a
    fused stage whose innermost extent is the hidden one and whose other
    extents are the consumer's, read only at the reader's own position by a
    hidden stage (at its innermost index) or by the consumer (at its
    reduction variable), so that a block needs one panel of it at a time;
    the panel divides the extent; each input staged in panels is
    grid-invariant, its buffer's only view, spans the hidden extent from 0
    on its axis and is read only by the chain along it; each input left
    unstaged is grid-invariant and read only by stages before the chain;
    the consumer's sums fit the block's registers
    (``plan.chain_tile_shape``), and so does the hidden panel's tile of a
    thread (at most ``CHAIN_TILE_MAX`` elements); and a panel that takes a
    dead panel's words (``reuse``) is a fused stage no larger than it, each
    panel given or taken once, and every stage that reads the dead panel
    runs in a turn before the taker's first write (``plan.chain_times``:
    the hidden stages in the consumer's turn, the output after every
    turn)."""
    ch = kg.chain
    if ch is None:
        return

    def bad(msg: str, *witness: int) -> None:
        out.append(PlanViolation("UB405", kg.name, msg, witness=tuple(witness)))

    if kg.panels is not None:
        bad("a group with both weight panels and a hidden chain")
    if kg.rings or kg.line_buffered or kg.red_grid is not None or kg.lane_grid is not None:
        bad("a hidden chain in a group that carries rows, columns or chunks")
    if any(g.pinned or g.lane_axis is not None or g.red_axis is not None for g in kg.groups):
        bad("a hidden chain beside a pinned, lane- or reduction-tiled view")
    names = kg.stage_names
    if ch.consumer not in names[:-1] or any(h not in names[:-1] for h in ch.hidden):
        bad(f"consumer {ch.consumer!r} or hidden {ch.hidden} not fused stages of the group")
        return
    cons = kg.stage_plan(ch.consumer)
    cns = cons.nstage
    if len(cns.red_dims) != 1 or cns.red_extents[0] != ch.extent:
        bad(f"consumer reductions {cns.red_dims} over {cns.red_extents}, not one over "
            f"the hidden extent {ch.extent}", ch.extent)
        return
    red = cns.red_dims[0]
    if ch.block < 1 or ch.extent % ch.block:
        bad(f"panel of {ch.block} does not divide the hidden extent {ch.extent}",
            ch.block, ch.extent)
    outer = kg.bh * math.prod(cns.pure_extents[1:-1])
    if chain_tile_shape(outer, cns.pure_extents[-1]) is None:
        bad(f"the consumer's {outer} x {cns.pure_extents[-1]} sums a block fit no "
            f"register tile", outer, cns.pure_extents[-1])
    rows, cols = ch.tile
    if rows < 1 or cols < 1 or rows * cols > CHAIN_TILE_MAX:
        bad(f"a hidden tile of {rows} x {cols} elements a thread", rows, cols)
    _check_reuse(kg, bad)
    for h in ch.hidden:
        hs = kg.stage_plan(h).nstage
        if hs.pure_extents[-1] != ch.extent or hs.pure_extents[:-1] != cns.pure_extents[:-1]:
            bad(f"hidden stage {h!r} of extents {hs.pure_extents} does not run along "
                f"the hidden axis at the consumer's positions", *hs.pure_extents)
    for sp in kg.stages:
        dims = sp.nstage.pure_dims
        for la, prod in zip(sp.accesses, sp.scratch_producer):
            if prod not in ch.hidden:
                continue
            own = len(la.axes) == len(dims) and all(
                _along(ax, d, None) for ax, d in zip(la.axes[:-1], dims[:-1]))
            if sp.name in ch.hidden:
                ok = own and _along(la.axes[-1], dims[-1], None)
            elif sp is cons:
                ok = own and _along(la.axes[-1], None, red)
            else:
                ok = False
            if not ok:
                bad(f"stage {sp.name!r} reads hidden stage {prod!r} other than one "
                    f"panel at a time")
    first = min(names.index(h) for h in ch.hidden)
    for buf in ch.unstaged:
        views = [g for g in kg.groups if g.buffer == buf]
        readers = {sp.name for sp in kg.stages for b in sp.view_binding
                   for gi in b.values() if kg.groups[gi].buffer == buf}
        if not views or any(g.blocked_axis is not None for g in views) or \
                any(names.index(r) >= first for r in readers):
            bad(f"unstaged input {buf!r} is not a grid-invariant input read only before "
                f"the chain")
    for gi, a in ch.staged:
        if not 0 <= gi < len(kg.groups):
            bad(f"staged view group {gi} does not exist", gi)
            continue
        g = kg.groups[gi]
        if g.blocked_axis is not None or not 0 <= a < g.ndim:
            bad(f"panel view {g.buffer!r} is row-blocked or has no axis {a}", a)
            continue
        if (g.base[a], g.span[a]) != (0, ch.extent):
            bad(f"panel axis of {g.buffer!r} [{g.base[a]}, +{g.span[a]}) is not the "
                f"hidden extent {ch.extent}", g.base[a], g.span[a])
        if sum(h.buffer == g.buffer for h in kg.groups) != 1:
            bad(f"panel buffer {g.buffer!r} is read through more than one view")
        for sp in kg.stages:
            for la, binding in zip(sp.accesses, sp.view_binding):
                if gi not in binding.values():
                    continue
                if sp.name in ch.hidden:
                    ok = _along(la.axes[a], sp.nstage.pure_dims[-1], None)
                elif sp is cons:
                    ok = _along(la.axes[a], None, red)
                else:
                    ok = False
                if not ok:
                    bad(f"stage {sp.name!r} reads panel buffer {g.buffer!r} other than "
                        f"along the hidden axis")


def _check_window(kg: KernelGroup, out: List[PlanViolation]) -> None:
    """UB406: a window-attention group (``kg.window``) is one the CUDA
    kernel runs as planned: it carries nothing (as UB404 asks) and is
    neither paneled nor chained; its score tile is its first fused stage,
    which reads no fused stage, and its statistics the other fused stages;
    the output and each statistic reduce over ``keys`` terms, over the
    tile's last axes (as many as the output's reductions, of their
    extents), and their pure axes start with the tile's others, a
    statistic's are exactly those; they read the tile at their own
    position on those axes and at the reduction variables, stride 1 and
    offset 0, on the key axes, and a statistic at their own position; so
    a block holds its rows' whole tile and statistics in shared memory and
    nothing of them reaches global memory."""
    wa = kg.window
    if wa is None:
        return

    def bad(msg: str, *witness: int) -> None:
        out.append(PlanViolation("UB406", kg.name, msg, witness=tuple(witness)))

    if kg.panels is not None or kg.chain is not None:
        bad("a window tile in a group with weight panels or a hidden chain")
    if kg.rings or kg.line_buffered or kg.red_grid is not None or kg.lane_grid is not None:
        bad("a window tile in a group that carries rows, columns or chunks")
    if any(g.pinned or g.lane_axis is not None or g.red_axis is not None for g in kg.groups):
        bad("a window tile beside a pinned, lane- or reduction-tiled view")
    names = kg.stage_names
    if names[:1] != [wa.score] or tuple(names[1:-1]) != wa.stats:
        bad(f"tile {wa.score!r} and statistics {wa.stats} are not the group's fused "
            f"stages {names[:-1]}")
        return
    score = kg.stage_plan(wa.score)
    if any(p is not None for p in score.scratch_producer):
        bad(f"tile {wa.score!r} reads a fused stage")
    sdims, sext = score.nstage.pure_dims, score.nstage.pure_extents
    k = len(kg.output.nstage.red_dims)
    if not 0 < k < len(sdims):
        bad(f"an output of {k} reductions over a tile of {len(sdims)} axes", k, len(sdims))
        return
    rows, keys = sdims[:-k], tuple(sext[-k:])
    if math.prod(keys) != wa.keys:
        bad(f"{wa.keys} keys, where the tile's key axes hold {keys}", wa.keys, *keys)
    for sp in kg.stages[1:]:
        ns = sp.nstage
        if tuple(ns.red_extents) != keys or ns.combiner not in ("add", "max"):
            bad(f"stage {sp.name!r} reduces over {ns.red_extents}, not the keys {keys}",
                *ns.red_extents)
            continue
        if ns.pure_dims[:len(rows)] != rows or (sp is not kg.output and ns.pure_dims != rows):
            bad(f"stage {sp.name!r} of axes {ns.pure_dims} does not run at the tile's "
                f"rows {rows}")
            continue
        for la, prod in zip(sp.accesses, sp.scratch_producer):
            if prod is None:
                continue
            ok = len(la.axes) == len(rows) + (k if prod == wa.score else 0) and all(
                _along(ax, d, None) for ax, d in zip(la.axes, rows))
            if prod == wa.score:
                ok = ok and all(_along(ax, None, r)
                                for ax, r in zip(la.axes[len(rows):], ns.red_dims))
            elif prod not in wa.stats:
                ok = False
            if not ok:
                bad(f"stage {sp.name!r} reads {prod!r} other than at its own position "
                    f"and the keys")


def _check_reuse(kg: KernelGroup, bad) -> None:
    """UB405's rule for a chain's ``reuse``: each ``(taker, dead)`` pair
    two distinct fused stages, the taker's panel no larger than the dead
    one's, no panel in two pairs, and every reader of the dead panel in a
    turn before the taker's."""
    ch = kg.chain
    if not ch.reuse:
        return
    fused = [sp.name for sp in kg.stages[:-1]]
    times = chain_times(fused, ch.consumer, ch.hidden)
    seen: Set[str] = set()
    for taker, dead in ch.reuse:
        if taker not in fused or dead not in fused or taker == dead:
            bad(f"panel {taker!r} takes the words of {dead!r}, not another fused panel")
            continue
        if {taker, dead} & seen:
            bad(f"panel {taker!r} or {dead!r} given or taken twice")
        seen |= {taker, dead}
        size = {n: math.prod(kg.scratch_shape(kg.stage_plan(n), 0)) for n in (taker, dead)}
        if size[taker] > size[dead]:
            bad(f"panel {taker!r} of {size[taker]} floats does not fit the {size[dead]} "
                f"of {dead!r}", size[taker], size[dead])
        late = [sp.name for sp in kg.stages if dead in sp.scratch_producer
                and times.get(sp.name, len(fused)) >= times[taker]]
        if late:
            bad(f"panel {taker!r} takes the words of {dead!r}, which {late} still read",
                times[taker])


def _check_budget(
    kg: KernelGroup, budget: int, out: List[PlanViolation]
) -> None:
    """UB401/UB402/UB403: re-summed residency vs ``vmem_bytes()``, the
    double-buffered working set vs the recorded VMEM budget, and the
    re-derived ``(bytes_per_row, fixed)`` pair vs the stored ``ws``."""
    resum = _resummed_vmem_bytes(kg)
    declared = kg.vmem_bytes
    if resum != declared:
        out.append(PlanViolation(
            "UB401", kg.name,
            f"re-summed VMEM residency {resum} B != declared "
            f"vmem_bytes {declared} B",
            witness=(resum, declared),
        ))
    bpr, fixed = _resummed_ws(kg)
    if (bpr, fixed) != tuple(kg.ws):
        out.append(PlanViolation(
            "UB403", kg.name,
            f"re-derived working set (bytes_per_row={bpr}, fixed={fixed}) "
            f"!= planned ws {tuple(kg.ws)}",
            witness=(bpr, fixed),
        ))
    if kg.streamed:
        # a chain's or window tile's working set is what its kernel
        # allocates, once
        live = (1 if kg.chain is not None or kg.window is not None else 2) * bpr * kg.bh + fixed
        if live > budget:
            out.append(PlanViolation(
                "UB402", kg.name,
                f"double-buffered working set {live} B exceeds the "
                f"recorded VMEM budget {budget} B",
                witness=(live, budget),
            ))


# ---------------------------------------------------------------------------
# UB5xx — batch-step isolation
# ---------------------------------------------------------------------------


def _check_batch(
    kg: KernelGroup, notes: Dict[str, object], out: List[PlanViolation]
) -> None:
    """UB501/UB502: the batch grid declaration is well-formed and every
    piece of carried VMEM state resets at batch boundaries.

    UB501 proves the declaration: a batched plan (``notes['batch']``) must
    batch every kernel, the batch dim must be the leading grid dim with a
    unit block, occupancy must satisfy ``0 < extent <= steps``, and the
    per-kernel ``batch_grid`` must agree with the plan-level notes.  UB502
    proves isolation: rings and line buffers are *reused* across batch
    steps, not re-allocated, so each must declare ``batch_reset=True`` —
    otherwise slot ``b`` reads rows rotated in by slot ``b - 1``.  (The
    eval-count consequence of a non-resetting line buffer is UB503,
    emitted by the accounting check.)"""
    bg = kg.batch_grid
    plan_batch = notes.get("batch")
    if bg is None:
        if plan_batch is not None:
            out.append(PlanViolation(
                "UB501", kg.name,
                f"plan declares batch={plan_batch} but the kernel has no "
                f"batch grid",
            ))
        return
    if plan_batch is None:
        out.append(PlanViolation(
            "UB501", kg.name,
            "kernel has a batch grid but the plan declares no batch",
        ))
    if not kg.grid or kg.grid[0] != bg.steps:
        out.append(PlanViolation(
            "UB501", kg.name,
            f"batch grid declares {bg.steps} steps but the leading grid "
            f"dim is {kg.grid[0] if kg.grid else None}",
            witness=(kg.grid[0] if kg.grid else -1, bg.steps),
        ))
    if bg.block != 1:
        out.append(PlanViolation(
            "UB501", kg.name,
            f"batch steps must advance one slot at a time, got block "
            f"{bg.block}",
        ))
    if not (0 < bg.extent <= bg.steps):
        out.append(PlanViolation(
            "UB501", kg.name,
            f"batch occupancy {bg.extent} outside (0, {bg.steps}]",
            witness=(bg.extent, bg.steps),
        ))
    cap = notes.get("batch_capacity", plan_batch)
    if plan_batch is not None and (bg.extent, bg.steps) != (plan_batch, cap):
        out.append(PlanViolation(
            "UB501", kg.name,
            f"kernel batch grid (extent={bg.extent}, steps={bg.steps}) "
            f"disagrees with plan notes (batch={plan_batch}, "
            f"capacity={cap})",
        ))
    for r in kg.rings:
        if not r.batch_reset:
            out.append(PlanViolation(
                "UB502", kg.name,
                f"ring '{r.buffer}' carries rotated rows across batch "
                f"steps (batch_reset=False): slot b would read slot b-1's "
                f"halo",
            ))
    for sp in kg.stages:
        lb = sp.line_buffer
        if lb is not None and not lb.batch_reset:
            out.append(PlanViolation(
                "UB502", kg.name,
                f"line buffer carries warm-up rows across batch steps "
                f"(batch_reset=False)",
                stage=sp.name,
            ))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def verify_plan(plan: PipelinePlan) -> List[PlanViolation]:
    """Statically verify every kernel of ``plan``; return all violations
    (empty list == certified).  Purely a function of the plan IR — no
    kernel is compiled or executed."""
    shapes = {
        n: tuple(b.extents) for n, b in plan.pipeline.buffer_boxes.items()
    }
    budget = int(plan.notes.get("vmem_budget", VMEM_BYTES))
    out: List[PlanViolation] = []
    for kg in plan.kernels:
        _check_view_bounds(kg, shapes, out)
        _check_block_taps(kg, out)
        _check_scratch_taps(kg, out)
        _check_masks(kg, out)
        _check_rings(kg, out)
        _check_line_buffers(kg, out)
        _check_lane_carry(kg, out)
        _check_red_grid(kg, out)
        _check_write_once(kg, out)
        _check_eval_accounting(kg, out)
        _check_batch(kg, plan.notes, out)
        _check_panels(kg, out)
        _check_chain(kg, out)
        _check_window(kg, out)
        _check_budget(kg, budget, out)
    return out


def assert_plan_verified(plan: PipelinePlan) -> PipelinePlan:
    """Raise :class:`PlanVerificationError` if ``plan`` has any violation;
    return the plan unchanged otherwise (chainable)."""
    violations = verify_plan(plan)
    if violations:
        raise PlanVerificationError(violations)
    return plan
