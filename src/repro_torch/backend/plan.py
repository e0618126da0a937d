"""Pipeline planning: the *plan* half of the backend's plan/emit split.

``build_pipeline_plan`` turns a lowered pipeline into a :class:`PipelinePlan`
— an explicit mid-level memory plan between the Stage IR and the Pallas
target, in the spirit of the heterogeneous-Halide and memory-template flows
(see ISSUE/PAPERS): every decision about *where data lives and how it moves*
is made here, symbolically, before any kernel is traced.

A plan is a list of :class:`KernelGroup` records, each one future
``pallas_call``:

  * **views** (:class:`ViewGroup`) are the HBM->VMEM push streams: a
    (shifted/strided) window of a producer buffer delivered block-by-block
    by a BlockSpec,
  * **stages** (:class:`StagePlan`) are the statements fused into the
    kernel; every non-output stage's panels live in VMEM scratch
    (``pl.pallas_call`` ``scratch_shapes``) instead of round-tripping HBM —
    the paper's coarse producer->consumer pipeline (Fig. 7),
  * an optional :class:`RedGrid` puts a large reduction dim into the grid
    with accumulation across grid steps (the ``kernels/matmul.py`` K-loop
    pattern, generated), replacing full in-kernel unrolling.

Planning passes, in order:

  1. per-stage access decomposition (``access.py``) + streamability,
  2. **fusion** — greedy reverse-topological grouping: a producer joins its
     consumers' kernel when every consumer is in the same group, the
     consumers read it with stride 1 along the blocked dim, and the
     producer's live range (rows demanded per consumer panel, from the
     affine access maps) fits the VMEM budget,
  3. **grid reduction** — single-stage kernels whose leading reduction dim
     is large get it chunked into the grid (``ceil`` steps: a non-dividing
     chunk leaves a masked tail step); small operands indexed only by the
     reduction dim stay whole in VMEM (:attr:`ViewGroup.resident`) instead
     of re-walking their chunk sequence once per row panel,
  4. **carry placement** — fused shift sets become cross-grid-step
     :class:`LineBuffer` rings (each intermediate row computed exactly
     once) and row-shifted view classes collapse into :class:`RingStream`
     deliveries (each input row delivered once); per chain the planner
     prices carry against recompute fusion (``line_buffer="auto"``) and
     keeps the cheaper modeled schedule, falling back per stage/class
     wherever ``halo > bh``,
  5. **block-height selection** — ``core/ubplan.plan_affine_stage`` with the
     scheduler cost hook (``scheduler_cost``) pricing candidate panels with
     ``core/scheduling.raster_cycles``, including the carry/warm-up terms;
     any height is legal — a non-divisor block yields a :class:`PaddedGrid`
     (grid = ``ceil(extent / bh)``, tail block masked by the emitter), with
     the padding waste priced into the cost like any other step,
  6. **lane blocking** — the trailing (lane) dimension can enter the grid
     too: a 2-D grid ``(ceil(e0/bh), ceil(e1/bw))`` with a lane-tail mask
     mirroring the row mask, engaged explicitly (``block_w``) or
     automatically when even a one-row full-width panel would blow the VMEM
     budget (the paper's vectorize-to-lane-width rule, Eq. 2: a lane block
     is a whole number of 128-wide fetches).  Column taps become per-offset
     shifted views and fused intermediates recompute per demanded *lane
     shift* — the PR 2 recompute scheme applied along the second axis —
     while ``align_tpu`` rounds ``bw`` itself to 128-lane multiples so the
     emitted blocks (not just the ``aligned_blocks()`` report) are
     hardware-tileable.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.scheduling import raster_cycles
from repro_torch.core.ubplan import (
    KernelPlan,
    LANE,
    StreamPlan,
    VMEM_BYTES,
    affine_stage_bh_cap,
    align_tpu_shape,
    lane_width_candidates,
    plan_affine_stage,
)
from repro_torch.frontend.expr import eval_expr, expr_depth, refs_in
from repro_torch.frontend.lower import NormalizedStage, Pipeline, normalize_pipeline

from .access import LoadAccess, UnsupportedAccessError, decompose_stage
from .errors import PlanError

ELEM_BYTES = 4                      # all generated streams are f32

# cycle-model constants for the scheduler cost hook: HBM push bandwidth in
# bytes/cycle and the fixed per-grid-step cost (DMA issue + pipeline drain)
HBM_BYTES_PER_CYCLE = 64
STEP_OVERHEAD_CYCLES = 32
# on-chip bandwidth for ring rotations (VMEM-to-VMEM vector copies): the
# carry side of the recompute-vs-carry trade rides the memory system, not
# the PE raster, and VMEM moves roughly an order of magnitude faster
VMEM_BYTES_PER_CYCLE = 8 * HBM_BYTES_PER_CYCLE

# grid-reduction defaults: reduction extents at or above the threshold are
# chunked into the grid; each chunk is at most MAX_RED_CHUNK in-kernel steps
RED_GRID_THRESHOLD = 256
MAX_RED_CHUNK = 128

# fixed per-grid-step cost of maintaining one cross-grid-step ring: the
# pl.when rotate/warm-up branches plus the copy issue.  A contiguous
# (stride-1) rotation is a lane-wide VMEM move and rides the memory side at
# VMEM_BYTES_PER_CYCLE; a *strided* ring (e.g. camera's stride-2 demosaic
# parity class) cannot coalesce its rotation into wide vector moves, so its
# elements are priced serially at ~1 element/cycle on top of the raster —
# which is what makes short-grid strided rings (few steps to amortize the
# warm-up against) lose to plain per-tap delivery under ``auto``.
RING_STEP_OVERHEAD_CYCLES = 8


class FusionInfeasible(PlanError):
    """A candidate fusion group violates a structural or VMEM constraint."""

    code = "PLAN-FUSION"


def staged_strides(extents: Sequence[int], vector: bool = False) -> Tuple[int, ...]:
    """Float strides of a copy of ``extents`` staged in shared memory: each
    extent after the first padded to an odd count, so that 32 threads
    reading 32 consecutive indices of any one axis hit 32 banks.  With
    ``vector`` the innermost extent is padded instead to 4 more than a
    multiple of 8: rows of whole 16-byte words, whose 16-byte loads by 16
    threads, one row each, take two wavefronts (a chained group's panel cut
    along a leading axis, read along its rows four terms a load)."""
    padded = [e if a == 0 or e % 2 else e + 1 for a, e in enumerate(extents)]
    if vector and len(extents) > 1:
        padded[-1] = extents[-1] + (4 - extents[-1]) % 8
    return tuple(math.prod(padded[a + 1:]) for a in range(len(extents)))


def staged_bytes(extents: Sequence[int], vector: bool = False) -> int:
    """Shared-memory bytes of a staged copy of ``extents``, padding included."""
    return ELEM_BYTES * extents[0] * staged_strides(extents, vector)[0]


@dataclass(frozen=True)
class WeightPanels:
    """A fused group planned against shared memory as the CUDA kernel fills
    it, where the Pallas working-set model (every view double-buffered in
    VMEM) cannot hold it: the group carries nothing, reads its row-blocked
    views straight from global memory, keeps its fused panels in shared
    memory, stages every grid-invariant input there whole, except view
    group ``group`` (the weight of the output stage's reduction, indexed
    along ``axis`` by the reduction's variable), which is staged ``block``
    entries of that axis at a time.  Each block of the kernel evaluates its
    fused panels once, then accumulates its output over the panels in
    turn, each element's sum in the reduction's order."""

    group: int
    axis: int
    block: int
    extent: int

    @property
    def count(self) -> int:
        return self.extent // self.block


# a chained group (:class:`HiddenChain`): the threads of its CUDA block,
# which evaluate one hidden panel in one pass, and the consumer's sums one
# thread keeps in registers across the hidden panels
CHAIN_THREADS = 512
CHAIN_TILE_MAX = 32


@dataclass(frozen=True)
class HiddenChain:
    """A fused group that chains two reductions through a hidden axis, planned
    against shared memory as the CUDA kernel fills it (a transformer MLP:
    ``fc2[co] = sum_h gelu[h] * w2[h, co]``, ``gelu[h]`` of ``fc1[h] = sum_c
    ln[c] * w1[c, h]``).  The ``consumer`` (a fused stage, not the output) reduces
    over the innermost axis of the ``hidden`` stages, whose extent is
    ``extent``; nothing of them is ever written to global memory, and no
    block holds more than ``block`` entries of that axis: it walks the
    hidden axis in ``count`` panels, each time staging panel ``kc`` of every
    input indexed along it (``staged``: view group and axis), evaluating
    the hidden stages' panels into shared memory (the unified buffer) and
    adding their terms to the consumer's sums, held in registers across the
    panels, each sum's terms in the reduction's order.  Everything else
    of the group is as :class:`WeightPanels` has it: nothing carried,
    row-blocked views read from global memory, the other fused panels whole
    in shared memory, every other grid-invariant input staged whole, but
    those read only by the stages before the chain (``unstaged``, e.g. the
    depthwise weights): evaluated once a block, they read global memory,
    and the shared memory goes to the chain, which walks its panels.

    Each thread evaluates a register tile of the hidden panel, ``tile =
    (rows, cols)``: ``rows`` positions by ``cols`` entries of the hidden
    axis, their reductions' chains side by side (:func:`hidden_tile_shape`).
    A fused panel that no stage reads once the chain has begun gives its
    words to a panel written from the consumer on (``reuse``: ``(taker,
    dead)`` pairs, e.g. the consumer's sums in the depthwise panel)."""

    hidden: Tuple[str, ...]
    consumer: str
    extent: int
    block: int
    staged: Tuple[Tuple[int, int], ...]
    unstaged: Tuple[str, ...] = ()
    tile: Tuple[int, int] = (1, 1)
    reuse: Tuple[Tuple[str, str], ...] = ()

    @property
    def count(self) -> int:
        return self.extent // self.block

    @property
    def takers(self) -> Tuple[str, ...]:
        """The fused stages whose panels lie in a dead panel's words."""
        return tuple(t for t, _d in self.reuse)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chain_tile_shape(outer: int, inner: int) -> Optional[Tuple[int, int, int, int]]:
    """How a chained group's ``CHAIN_THREADS`` threads hold its consumer's
    panel of ``outer`` positions by ``inner`` (its innermost axis) in one
    pass, at most ``CHAIN_TILE_MAX`` sums a thread: ``(lanes, cols, groups,
    rows)``, ``lanes`` threads along the innermost axis, each ``cols``
    elements ``lanes`` apart, by ``groups`` rows of threads of ``rows``
    positions each; of those, the fewest loads a term (``rows + cols``),
    then the fewest idle elements.  None where no such tile exists."""
    best = None
    for lanes in (32, 64, 128, 256):
        groups = CHAIN_THREADS // lanes
        cols, rows = _cdiv(inner, lanes), _cdiv(outer, groups)
        if rows * cols > CHAIN_TILE_MAX:
            continue
        key = (rows + cols, groups * rows * lanes * cols - outer * inner, lanes)
        if best is None or key < best[0]:
            best = (key, (lanes, cols, groups, rows))
    return None if best is None else best[1]


def hidden_tile_shape(outer: int, inner: int) -> Optional[Tuple[int, int]]:
    """How a chained group's ``CHAIN_THREADS`` threads evaluate a hidden
    panel of ``outer`` positions by ``inner`` entries of the hidden axis in
    one pass, each thread a register tile of at least two and at most
    ``CHAIN_TILE_MAX`` elements: ``(rows, cols)``, ``ceil(inner / cols)``
    lanes along the hidden axis, each ``cols`` entries that far apart, by
    ``ceil(outer / rows)`` groups of threads of ``rows`` positions each; of
    those, the fewest loads a term (``rows + cols``), then the fewest idle
    elements, then the fewest columns (each position's row a broadcast to
    the lanes).  None where no such tile exists."""
    best = None
    for rows in range(1, min(outer, CHAIN_TILE_MAX) + 1):
        for cols in range(1, min(inner, CHAIN_TILE_MAX // rows) + 1):
            lanes, groups = _cdiv(inner, cols), _cdiv(outer, rows)
            if rows * cols < 2 or lanes * groups > CHAIN_THREADS:
                continue
            key = (rows + cols, groups * rows * lanes * cols - outer * inner, cols)
            if best is None or key < best[0]:
                best = (key, (rows, cols))
    return None if best is None else best[1]


@dataclass(frozen=True)
class WindowAttention:
    """A fused group that keeps a window-attention score tile in shared
    memory, planned against shared memory as the CUDA kernel fills it (Swin
    Transformer's W-MSA and SW-MSA: per window and head ``softmax(q . k^T +
    bias + mask) . v``).  The fused stage ``score`` is the tile: its pure
    axes are the block's rows (the heads), the window and query axes
    (``rows`` after the first) and then the key axes; each other fused
    stage of ``stats`` (a row's maximum, then its sum of ``exp``) and the
    output reduce over the keys, reading the tile at their own row and the
    keys' reduction variables, the statistics at their own position.  No
    score, probability or statistic leaves shared memory: a block evaluates
    the tile, then each statistic, then the output, a barrier between them,
    and stores the output straight to global memory; its row-blocked views
    (the queries, keys and values of its heads) read global memory and its
    grid-invariant inputs are staged whole.  ``keys`` is the keys a query
    reduces over, ``windows`` the windows of one row (head) and ``masked``
    those whose keys fall in more than one region of a mask the output's
    terms select from the positions alone (a shifted window's)."""

    score: str
    stats: Tuple[str, ...]
    keys: int
    windows: int = 0
    masked: int = 0


@dataclass(frozen=True)
class LineBuffer:
    """Cross-grid-step line buffer for a fused intermediate: instead of
    recomputing the stage's panel at every consumer-demanded row shift, one
    VMEM ring of ``bh + halo`` rows persists across grid steps.  Each step
    rotates the ring (the trailing ``halo`` rows carry over) and computes
    exactly ``bh`` new rows — the panel at shift ``hi`` — so every
    intermediate row is evaluated exactly once; step 0 additionally fills
    the ``halo`` warm-up rows (the first rows of the shift-``lo`` panel).
    Consumers tap the ring at ``[shift - lo, shift - lo + bh)`` exactly
    where they used to tap the per-shift panel.

    ``batch_reset`` governs behaviour under a batch grid (the leading grid
    dim sweeping independent tiles): the warm-up must re-fire at the first
    row step of *every* batch element, because the rows carried out of the
    previous tile belong to a different image.  ``False`` is never planned —
    it exists so seeded corruption tests can materialize the
    carried-across-a-batch-boundary bug and prove the verifier rejects it
    (rule UB502).

    ``lane=True`` is the column variant for lane-blocked kernels: ``lo``
    and ``hi`` are *lane* shifts, and the carry runs along the lane axis
    *inside* each row sweep — one ring of ``bw + halo`` columns per
    demanded row shift, rotated per lane step and re-warmed at lane step 0
    of every row step (row carry cannot survive a lane grid: between two
    visits of one row panel every other lane step clobbers the ring)."""

    lo: int                           # min consumer-demanded row shift
    hi: int                           # max consumer-demanded row shift
    batch_reset: bool = True          # re-warm at every batch boundary
    lane: bool = False                # carry along the lane axis instead

    @property
    def halo(self) -> int:
        """Rows (columns when ``lane``) carried across grid steps."""
        return self.hi - self.lo

    def ring_rows(self, bh: int) -> int:
        return bh + self.halo

    def ring_cols(self, bw: int) -> int:
        return bw + self.halo


@dataclass
class RingStream:
    """Cross-grid-step line buffer for an *input delivery* class: several
    row-shifted views of one buffer (same blocked axis, stride, and shift
    parity) collapse into a single streaming view at the leading shift
    (``hi``) plus a tiny pinned warm-up view of the ``halo`` rows below it,
    with a VMEM ring carrying the halo between grid steps.  Each input row
    is then *delivered* once instead of once per tap — the paper's
    line-buffered unified buffer, lifted from pixels to rows.

    ``lane=True`` is the *column* variant for lane-blocked 2-D grids:
    ``axis`` is then the producer's lane axis, ``lo``/``hi``/``stride0``
    describe the member views' lane starts, and the ring — shape
    ``(bh, ..., bw + halo)`` — rotates per *lane* step inside the row
    sweep, re-warming from a lane-pinned prefix view at lane step 0 of
    every row step.  The shared row-axis binding of the class (every
    member view has the same blocked axis, start, and stride — it is part
    of the class key) lives in ``row_axis``/``row_k0``/``row_stride``."""

    buffer: str
    axis: int                         # producer axis carried by the ring
    stride0: int                      # view stride along that axis
    lo: int                           # smallest member view start (k0)
    hi: int                           # largest member view start (k0)
    steady: int                       # group index of the streaming view
    prefix: int                       # group index of the pinned warm-up view
    ndim: int
    base: List[int]                   # hull base per axis (axis: ``lo``)
    span: List[int]                   # hull span per non-ring axis
    key: Tuple = ()                   # delivery-class key (for plan retries)
    batch_reset: bool = True          # re-warm at every batch boundary
                                      # (False only via seeded corruption;
                                      # rejected by verify rule UB502)
    lane: bool = False                # column ring: carry along the lane axis
    row_axis: Optional[int] = None    # lane ring: the class's row-blocked axis
    row_k0: int = 0                   # lane ring: shared row view start
    row_stride: int = 1               # lane ring: shared row view stride

    @property
    def halo(self) -> int:
        """Carried rows (columns when ``lane``), in lattice units (one unit
        = ``stride0`` elements)."""
        return (self.hi - self.lo) // self.stride0

    def ring_shape(self, bh: int, bw: Optional[int] = None) -> Tuple[int, ...]:
        if self.lane:
            return tuple(
                bh if j == self.row_axis
                else (bw + self.halo if j == self.axis else self.span[j])
                for j in range(self.ndim)
            )
        return tuple(
            bh + self.halo if j == self.axis else self.span[j]
            for j in range(self.ndim)
        )

    def ring_bytes(self, bh: int, bw: Optional[int] = None) -> int:
        return ELEM_BYTES * math.prod(self.ring_shape(bh, bw))


@dataclass(frozen=True)
class PaddedGrid:
    """Grid dim 0 covers the extent by ceil-division: ``steps * block``
    rows are delivered and computed but only the first ``extent`` are
    valid.  The emitter masks the ragged edge (iota-derived row masks on
    every stored/accumulated panel), so arbitrary extents compile without
    a dividing block height — the unified-buffer abstraction hiding the
    ragged edge behind address generation."""

    extent: int                       # true extent along the blocked dim
    block: int                        # planned block height
    steps: int                        # grid extent = ceil(extent / block)

    @property
    def pad(self) -> int:
        """Rows of padded (masked) work in the tail block."""
        return self.steps * self.block - self.extent


# ---------------------------------------------------------------------------
# View groups: planned HBM->VMEM streams
# ---------------------------------------------------------------------------


@dataclass
class ViewGroup:
    """One HBM->VMEM stream: a (possibly shifted/strided) view of a producer
    buffer, delivered in blocks by a BlockSpec.

    ``blocked_axis`` advances with grid dim 0 (the row-panel stream);
    ``red_axis`` advances with grid dim 1 when the kernel carries a
    grid-level reduction (chunked delivery of a reduction-indexed axis);
    ``lane_axis`` advances with grid dim 1 when the kernel blocks the
    trailing (lane) dimension — a column-shifted window whose start ``l0``
    bakes the tap's lane offset into the view, exactly as ``k0`` does for
    row shifts."""

    buffer: str
    ndim: int
    blocked_axis: Optional[int]       # producer axis tiled over grid dim 0
    k0: int = 0                       # blocked-axis view start (row shift)
    stride0: int = 1                  # blocked-axis stride baked into the view
    red_axis: Optional[int] = None    # producer axis tiled over grid dim 1
    red_chunk: int = 1                # block extent on the red axis
    base: List[int] = field(default_factory=list)   # per-axis view start
    span: List[int] = field(default_factory=list)   # per-axis view length
    valid0: Optional[int] = None      # valid blocked-axis elements of the view
                                      # (grid delivery past this is padding)
    pinned: bool = False              # warm-up view of a RingStream: a fixed
                                      # ``rows0``-row block delivered once
    rows0: int = 0                    # blocked-axis block rows when pinned
    resident: bool = False            # reduction-indexed operand kept whole
                                      # in VMEM (fetched once, not per chunk)
    lane_axis: Optional[int] = None   # producer axis tiled over the lane grid
    l0: int = 0                       # lane-axis view start (column shift)
    lane_stride: int = 1              # lane-axis stride baked into the view
    valid1: Optional[int] = None      # valid lane-axis elements of the view
    lane_pinned: bool = False         # warm-up view of a *lane* RingStream: a
                                      # fixed ``cols0``-column block delivered
                                      # once per row step (lane index pinned 0)
    cols0: int = 0                    # lane-axis block columns when lane_pinned

    def view_slices(self, e0: int, e1: Optional[int] = None) -> Tuple[slice, ...]:
        out = []
        for j in range(self.ndim):
            if j == self.blocked_axis:
                rows = self.rows0 if self.pinned else e0
                out.append(
                    slice(self.k0, self.k0 + self.stride0 * (rows - 1) + 1, self.stride0)
                )
            elif j == self.lane_axis:
                cols = self.cols0 if self.lane_pinned else e1
                out.append(
                    slice(self.l0, self.l0 + self.lane_stride * (cols - 1) + 1,
                          self.lane_stride)
                )
            else:
                out.append(slice(self.base[j], self.base[j] + self.span[j]))
        return tuple(out)

    def block_shape(self, bh: int, bw: Optional[int] = None) -> Tuple[int, ...]:
        out = []
        for j in range(self.ndim):
            if j == self.blocked_axis:
                out.append(self.rows0 if self.pinned else bh)
            elif j == self.lane_axis:
                out.append(self.cols0 if self.lane_pinned else bw)
            elif j == self.red_axis:
                out.append(self.span[j] if self.resident else self.red_chunk)
            else:
                out.append(self.span[j])
        return tuple(out)

    def index_map(self, n_grid: int, dim1: str = "red") -> Callable:
        """BlockSpec index map.  Grid dim 0 advances ``blocked_axis``; when
        the kernel has a second grid dim it is either the reduction chunk
        (``dim1="red"``) or the lane block (``dim1="lane"``).  A
        ``lane_pinned`` warm-up view pins its lane index to block 0: the
        block index changes only with the row step, so Pallas re-fetches it
        once per row step — exactly the per-row-sweep warm-up cadence."""
        blocked = None if self.pinned else self.blocked_axis
        red = None if self.resident else self.red_axis
        lane = None if self.lane_pinned else self.lane_axis
        nd = self.ndim
        if n_grid == 1:
            if blocked is None:
                return lambda i, nd=nd: (0,) * nd
            return lambda i, blocked=blocked, nd=nd: tuple(
                i if j == blocked else 0 for j in range(nd)
            )
        if dim1 == "lane":
            return lambda i, k, blocked=blocked, lane=lane, nd=nd: tuple(
                i if j == blocked else (k if j == lane else 0) for j in range(nd)
            )
        return lambda i, k, blocked=blocked, red=red, nd=nd: tuple(
            i if j == blocked else (k if j == red else 0) for j in range(nd)
        )


# ---------------------------------------------------------------------------
# Stage plans
# ---------------------------------------------------------------------------

# a view binding key: (panel shift, blocked-axis offset or None for whole
# delivery) -> index into the kernel's view groups.  Lane-blocked kernels
# widen the key to (shift, offset, lane shift, lane offset or None).
BindKey = Tuple


@dataclass
class StagePlan:
    """One stage's placement inside a kernel.

    ``shifts`` is the set of row-panel shifts at which the stage's panel is
    materialized per grid step: ``(0,)`` for the kernel's output stage, the
    union of consumer demands for fused (VMEM-scratch) intermediates — the
    producer rows demanded per consumer panel, straight from the affine
    access maps."""

    nstage: NormalizedStage
    accesses: List[LoadAccess]
    streamed: bool
    shifts: Tuple[int, ...] = (0,)
    load_kind: List[str] = field(default_factory=list)        # "view"|"scratch"
    scratch_producer: List[Optional[str]] = field(default_factory=list)
    view_binding: List[Dict[BindKey, int]] = field(default_factory=list)
    blocked_axis_of: List[Optional[int]] = field(default_factory=list)
    # cross-grid-step carry: when set, the stage's panels live in one
    # persistent ring (see :class:`LineBuffer`) instead of per-shift scratch
    line_buffer: Optional[LineBuffer] = None
    # per load, bindings served by an input RingStream instead of a view
    # group: (shift, offset) -> (ring index, ring row of the tap's start)
    ring_binding: List[Dict[BindKey, Tuple[int, int]]] = field(
        default_factory=list
    )
    # lane blocking (2-D grids): the lane-panel shifts at which consumers
    # demand this stage per lane step (the column analog of ``shifts``),
    # the kernel's lane block width, and per load the axis tiled over the
    # lane grid.  ``bw is None`` means the kernel does not lane-block and
    # every lane field is inert.
    lane_shifts: Tuple[int, ...] = (0,)
    bw: Optional[int] = None
    lane_axis_of: List[Optional[int]] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.nstage.name

    @property
    def d0(self) -> str:
        return self.nstage.pure_dims[0]

    @property
    def e0(self) -> int:
        return self.nstage.pure_extents[0]

    # valid-extent metadata for padded grids: the stage's true extent along
    # the blocked dim; panel rows past it (tail-block padding) are masked
    @property
    def valid_e0(self) -> int:
        return self.e0

    def valid_rows(self, bh: int, step: int) -> int:
        """Valid rows of this stage's panel at grid step ``step``."""
        if not self.streamed:
            return self.e0
        return max(0, min(bh, self.e0 - step * bh))

    def panel_shape(self, bh: int) -> Tuple[int, ...]:
        if not self.streamed:
            return tuple(self.nstage.pure_extents)
        shape = (bh,) + tuple(self.nstage.pure_extents[1:])
        if self.bw is not None:
            shape = shape[:-1] + (self.bw,)
        return shape

    def panel_bytes(self, bh: int) -> int:
        return ELEM_BYTES * math.prod(self.panel_shape(bh))

    def ring_shape(self, bh: int) -> Tuple[int, ...]:
        """VMEM shape of this stage's (row) line-buffer ring."""
        assert self.line_buffer is not None and not self.line_buffer.lane
        return (self.line_buffer.ring_rows(bh),) + tuple(
            self.nstage.pure_extents[1:]
        )

    def lane_ring_shape(self, bh: int) -> Tuple[int, ...]:
        """VMEM shape of one *lane* (column) line-buffer ring: ``bh`` panel
        rows by ``bw + halo`` columns — one such ring exists per demanded
        row shift, rotated per lane step."""
        lb = self.line_buffer
        assert lb is not None and lb.lane and self.bw is not None
        inner = list(self.nstage.pure_extents[1:])
        inner[-1] = lb.ring_cols(self.bw)
        return (bh, *inner)

    def scratch_shape(self, bh: int, key) -> Tuple[int, ...]:
        """Shape of one scratch entry: a row-line-buffer ring (``key is
        None``), a lane-line-buffer ring (``(row shift, None)``), or a
        per-shift panel (a row shift, or a (row, lane) shift pair under
        lane blocking)."""
        if key is None:
            return self.ring_shape(bh)
        if isinstance(key, tuple) and key[1] is None:
            return self.lane_ring_shape(bh)
        return self.panel_shape(bh)

    # -- verifier-facing metadata ------------------------------------------

    def bind_shifts(self) -> Tuple[int, ...]:
        """Row shifts at which this stage's panels are actually materialized
        per grid step: the full demanded shift set in recompute mode, but
        only ``(lo, hi)`` under a row line buffer (warm-up seeds ``lo..hi``
        once; every steady step evaluates the single leading-edge panel
        ``hi``).  A *lane* line buffer carries columns, not rows: every
        demanded row shift keeps its own lane ring, so the row binding set
        stays the full demanded one."""
        lb = self.line_buffer
        return self.shifts if lb is None or lb.lane else (lb.lo, lb.hi)

    def bind_lane_shifts(self) -> Tuple[int, ...]:
        """Lane shifts at which panels are materialized per lane step: the
        full demanded set in recompute mode, ``(lo, hi)`` under a lane line
        buffer (the halo-wide warm-up panel at ``lo`` and the steady
        leading-edge panel at ``hi``)."""
        lb = self.line_buffer
        if lb is not None and lb.lane:
            return (lb.lo, lb.hi)
        return self.lane_shifts

    def red_extent_map(self, red_grid: Optional["RedGrid"]) -> Dict[str, int]:
        """In-kernel reduction extents, as the emitter iterates them: a dim
        lifted into the grid (``red_grid``) contributes only its in-chunk
        extent per grid step — the grid index advances the rest."""
        ext = dict(zip(self.nstage.red_dims, self.nstage.red_extents))
        if red_grid is not None and red_grid.dim in ext:
            ext[red_grid.dim] = red_grid.chunk
        return ext


@dataclass(frozen=True)
class RedGrid:
    """A reduction dim lifted into the grid (accumulate across grid steps).

    ``steps = ceil(extent / chunk)``: when the chunk does not divide the
    extent, the final grid step is a *masked tail* — the emitter zeroes
    every in-chunk term whose global reduction index reaches ``extent``, so
    padded K-tail steps contribute exactly 0 to the accumulation."""

    dim: str
    chunk: int                        # in-kernel steps per grid step
    steps: int                        # grid extent (= ceil(extent / chunk))
    extent: int                       # true reduction extent

    @property
    def padded(self) -> bool:
        return self.steps * self.chunk != self.extent

    @property
    def tail(self) -> int:
        """Valid in-chunk steps of the final grid step."""
        return self.extent - (self.steps - 1) * self.chunk


# ---------------------------------------------------------------------------
# Kernel groups
# ---------------------------------------------------------------------------


@dataclass
class KernelGroup:
    """One future ``pallas_call``: fused stages + their delivery plan."""

    stages: List[StagePlan]           # topo order; last writes the output
    groups: List[ViewGroup]           # HBM->VMEM view streams
    bh: int
    grid: Tuple[int, ...]
    red_grid: Optional[RedGrid] = None
    padded_grid: Optional[PaddedGrid] = None
    rings: List[RingStream] = field(default_factory=list)
    notes: Dict[str, object] = field(default_factory=dict)
    # lane blocking: grid dim 1 walks ceil(e1/bw) lane blocks (mutually
    # exclusive with red_grid); ``lane_grid.pad`` lanes of the tail block
    # are masked by the emitter, mirroring the row-grid tail
    bw: Optional[int] = None
    lane_grid: Optional[PaddedGrid] = None
    # working-set accounting the block height was selected under, for the
    # planner's lane-engagement / budget checks: (bytes_per_row, fixed)
    ws: Tuple[int, int] = (0, 0)
    # batch grid: a leading grid dim sweeping ``batch_grid.extent``
    # independent tiles (``batch_grid.steps`` slots; extent < steps is a
    # ragged final batch whose padded slots are masked to zero).  The
    # per-tile structure — views, rings, scratch, block shapes — is reused
    # unchanged per batch step: rings and line-buffer warm-ups *reset* at
    # batch boundaries (re-fire their step-0 warm-up), they are not
    # re-allocated, so the VMEM footprint is batch-invariant
    batch_grid: Optional[PaddedGrid] = None
    # planned against the CUDA kernel's shared memory, its weight staged in
    # panels (see :class:`WeightPanels`); None for a Pallas-model plan
    panels: Optional[WeightPanels] = None
    # planned against shared memory with two reductions chained through a
    # hidden axis walked in panels (see :class:`HiddenChain`)
    chain: Optional[HiddenChain] = None
    # planned against shared memory with a window-attention score tile (see
    # :class:`WindowAttention`)
    window: Optional[WindowAttention] = None

    @property
    def output(self) -> StagePlan:
        return self.stages[-1]

    @property
    def smem_planned(self) -> bool:
        """Planned against shared memory as the CUDA kernel fills it (weight
        panels, a hidden chain or a window-attention tile): its views read
        global memory or are staged, and its working set is allocated once."""
        return self.panels is not None or self.chain is not None or self.window is not None

    def stage_plan(self, name: str) -> StagePlan:
        for sp in self.stages:
            if sp.name == name:
                return sp
        raise KeyError(name)

    @property
    def line_buffered(self) -> Tuple[str, ...]:
        """Names of fused stages carried in cross-grid-step rings."""
        return tuple(sp.name for sp in self.stages if sp.line_buffer is not None)

    @property
    def name(self) -> str:
        return self.output.name

    @property
    def stage_names(self) -> List[str]:
        return [sp.name for sp in self.stages]

    @property
    def fused(self) -> bool:
        return len(self.stages) > 1

    @property
    def streamed(self) -> bool:
        return self.output.streamed

    @property
    def e0(self) -> int:
        return self.output.e0

    @property
    def padded(self) -> bool:
        return self.padded_grid is not None

    @property
    def pad_rows(self) -> int:
        return 0 if self.padded_grid is None else self.padded_grid.pad

    @property
    def e1(self) -> Optional[int]:
        """Output lane extent (the valid span of the lane grid), or None
        when the kernel does not lane-block."""
        return None if self.lane_grid is None else self.lane_grid.extent

    @property
    def batched(self) -> bool:
        return self.batch_grid is not None

    @property
    def bofs(self) -> int:
        """Grid-dim offset of the row axis: 1 when a leading batch dim is
        present, else 0.  Every structural grid index (row panels, lane
        blocks, reduction chunks) shifts right by this amount."""
        return 1 if self.batch_grid is not None else 0

    @property
    def batch_steps(self) -> int:
        """Batch slots swept per invocation (1 when not batched)."""
        return self.batch_grid.steps if self.batch_grid is not None else 1

    @property
    def base_grid(self) -> Tuple[int, ...]:
        """The per-tile grid (batch dim stripped)."""
        return self.grid[self.bofs:]

    @property
    def steps0(self) -> int:
        """Grid extent along the row dim (1 for unstreamed kernels)."""
        return self.grid[self.bofs]

    @property
    def lane_steps(self) -> int:
        """Grid extent along the lane dim (1 when not lane-blocked)."""
        return self.grid[self.bofs + 1] if self.lane_grid is not None else 1

    def required_extents(self) -> Dict[str, Tuple[int, ...]]:
        """Per input buffer, the minimal extent along every axis that the
        planned view slices require (the hull over this kernel's groups)."""
        out: Dict[str, Tuple[int, ...]] = {}
        for g in self.groups:
            need = []
            for j in range(g.ndim):
                if j == g.blocked_axis:
                    rows = g.rows0 if g.pinned else self.e0
                    need.append(g.k0 + g.stride0 * (rows - 1) + 1)
                elif j == g.lane_axis:
                    cols = g.cols0 if g.lane_pinned else self.e1
                    need.append(g.l0 + g.lane_stride * (cols - 1) + 1)
                else:
                    need.append(g.base[j] + g.span[j])
            prev = out.get(g.buffer)
            out[g.buffer] = (
                tuple(max(a, b) for a, b in zip(prev, need)) if prev else tuple(need)
            )
        return out

    def panel_axes(self) -> Dict[str, Tuple[int, int]]:
        """Each buffer staged a panel at a time: its ``(axis, block)``."""
        if self.panels is not None:
            pn = self.panels
            return {self.groups[pn.group].buffer: (pn.axis, pn.block)}
        if self.chain is not None:
            ch = self.chain
            return {self.groups[gi].buffer: (a, ch.block) for gi, a in ch.staged}
        return {}

    def staged_extents(self) -> Dict[str, Tuple[int, ...]]:
        """Under :attr:`panels` or :attr:`chain`, the extents of each buffer
        the kernel stages in shared memory (:func:`_staged_hull`), a panel
        buffer's axis cut to one panel; empty for a Pallas-model plan."""
        if not self.smem_planned:
            return {}
        cut = self.panel_axes()
        skip = self.chain.unstaged if self.chain is not None else ()
        return {
            buf: tuple(cut[buf][1] if buf in cut and a == cut[buf][0] else e
                       for a, e in enumerate(ext))
            for buf, ext in (_staged_hull(self.groups) or {}).items() if buf not in skip
        }

    def staged_vector(self, buf: str) -> bool:
        """Whether staged buffer ``buf`` is laid out in rows of 16-byte words
        (``staged_strides``): a chain's panel cut along a leading axis."""
        cut = self.panel_axes().get(buf) if self.chain is not None else None
        return cut is not None and cut[0] < next(
            g.ndim for g in self.groups if g.buffer == buf) - 1

    def scratch_shape(self, sp: StagePlan, key) -> Tuple[int, ...]:
        """One scratch entry's shape as the kernel holds it: a hidden stage
        of a :attr:`chain` one panel of its innermost axis, any other
        ``sp.scratch_shape``."""
        shape = sp.scratch_shape(self.bh, key)
        if self.chain is not None and sp.name in self.chain.hidden:
            return shape[:-1] + (self.chain.block,)
        return shape

    def validate_buffers(self, buffers: Mapping[str, object]) -> None:
        """Check the arrays backing this kernel's view streams against the
        plan's declared extents, raising a clear error naming the buffer and
        axis instead of letting a mis-shaped array surface as a cryptic
        BlockSpec/slice failure inside ``pallas_call``.

        Under a batch grid every backing array carries one extra leading
        dim of exactly ``batch_grid.steps`` (the slot capacity — the runner
        pads ragged batches up to it); the per-tile extents follow."""
        bg = self.batch_grid
        for buf, need in self.required_extents().items():
            if buf not in buffers:
                raise KeyError(
                    f"kernel {self.name!r}: missing input buffer {buf!r} "
                    f"(needs extents >= {need})"
                )
            got = tuple(getattr(buffers[buf], "shape", ()))
            if bg is not None:
                if len(got) != len(need) + 1 or got[0] != bg.steps:
                    raise ValueError(
                        f"kernel {self.name!r}: buffer {buf!r} has shape "
                        f"{got}, but the batched plan needs a leading batch "
                        f"dim of exactly {bg.steps} slots followed by "
                        f"per-tile extents >= {need}"
                    )
                got = got[1:]
            elif len(got) != len(need):
                raise ValueError(
                    f"kernel {self.name!r}: buffer {buf!r} has rank {len(got)} "
                    f"(shape {got}), but the plan's views need rank {len(need)} "
                    f"with extents >= {need}"
                )
            for j, (s, n) in enumerate(zip(got, need)):
                if s < n:
                    raise ValueError(
                        f"kernel {self.name!r}: buffer {buf!r} axis {j} has "
                        f"extent {s}, but the plan's view needs >= {n} "
                        f"(shape {got} vs required {need})"
                    )

    def scratch_entries(self) -> List[Tuple[StagePlan, object]]:
        """(stage, key) pairs, in emission order, of every VMEM-resident
        intermediate the kernel materializes: ``key`` is a row shift for a
        recompute-mode panel, a ``(row shift, lane shift)`` pair under lane
        blocking, ``None`` for a row line-buffer ring, or ``(row shift,
        None)`` for a lane line-buffer ring (one per demanded row shift)."""
        out: List[Tuple[StagePlan, object]] = []
        for sp in self.stages[:-1]:
            lb = sp.line_buffer
            if lb is not None and lb.lane:
                out.extend((sp, (s, None)) for s in sp.shifts)
            elif lb is not None:
                out.append((sp, None))
            elif self.lane_grid is not None:
                out.extend(
                    (sp, (s, t)) for s in sp.shifts for t in sp.lane_shifts
                )
            else:
                out.extend((sp, s) for s in sp.shifts)
        return out

    @property
    def scratch_bytes(self) -> int:
        return sum(
            ELEM_BYTES * math.prod(self.scratch_shape(sp, key))
            for sp, key in self.scratch_entries()
        ) + sum(r.ring_bytes(self.bh, self.bw) for r in self.rings)

    def eval_rows(self) -> Dict[str, int]:
        """Rows of each stage evaluated per kernel invocation — the
        recompute metric line buffering improves.  A recompute-mode fused
        stage evaluates ``|shifts|`` panels per grid step; a line-buffered
        one evaluates exactly ``bh`` new rows per step plus a one-time
        ``halo``-row warm-up.  Under lane blocking a "row" is one panel row
        per lane block: each row is evaluated once per lane step and lane
        shift (partial-width evaluations count as rows, so the metric stays
        comparable across lane-blocked and full-width plans of equal work).

        A batch grid multiplies everything by the batch-slot count: each
        slot re-runs the full per-tile sweep, including the line-buffer
        warm-up (the per-batch exactly-once property — rule UB503 — is
        exactly this ``batch_steps * (steps * bh + halo)`` shape, *not* a
        single globally amortized warm-up)."""
        steps = self.steps0 if self.streamed else 1
        lane_steps = self.lane_steps
        bsteps = self.batch_steps
        out: Dict[str, int] = {}
        for sp in self.stages:
            if not (self.streamed and sp.streamed):
                out[sp.name] = bsteps * sp.e0
            elif sp.line_buffer is not None and sp.line_buffer.lane:
                # per (row step, row shift): one full-width panel per lane
                # step plus one halo-wide warm-up panel (partial widths
                # count as rows, keeping the metric comparable)
                out[sp.name] = bsteps * (
                    steps * self.bh * len(sp.shifts) * (lane_steps + 1)
                )
            elif sp.line_buffer is not None:
                out[sp.name] = bsteps * (steps * self.bh + sp.line_buffer.halo)
            else:
                out[sp.name] = bsteps * (
                    steps * self.bh * len(sp.shifts)
                    * lane_steps * len(sp.lane_shifts)
                )
        return out

    @property
    def vmem_bytes(self) -> int:
        return self.ub_plan().vmem_bytes

    def ub_plan(self) -> KernelPlan:
        """The kernel's unified-buffer structure, for introspection.

        Stream ``axes`` name the grid dims a stream's block index advances
        with; under a batch grid the structural dims shift right by
        ``bofs``.  The batch dim itself is deliberately *not* listed — the
        per-tile stream structure (and hence the VMEM footprint and the
        double-buffering decisions) is batch-invariant, which is the point
        of the batch grid."""
        bofs = self.bofs
        streams = []
        for k, g in enumerate(self.groups):
            axes: Tuple[int, ...] = ()
            if not g.pinned:
                axes = tuple(
                    ax + bofs for ax, cond in (
                        (0, g.blocked_axis is not None),
                        (1, g.red_axis is not None and not g.resident),
                        (1, g.lane_axis is not None and not g.lane_pinned),
                    )
                    if cond and ax < len(self.base_grid)
                )
            blk = g.block_shape(self.bh, self.bw)
            if self.smem_planned:
                # read straight from global memory, or through the staged
                # copy listed below: nothing of the view is resident
                streams.append(StreamPlan(
                    f"{g.buffer}[{k}]", blk, axes, 0, double_buffered=False,
                ))
                continue
            streams.append(StreamPlan(
                f"{g.buffer}[{k}]",
                blk,
                axes,
                ELEM_BYTES * math.prod(blk),
                double_buffered=bool(axes),
            ))
        for buf, ext in self.staged_extents().items():
            streams.append(StreamPlan(
                f"staged:{buf}", ext, (), staged_bytes(ext, self.staged_vector(buf)),
                double_buffered=False,
            ))
        for r in self.rings:
            tag = "lane:" if r.lane else ""
            streams.append(StreamPlan(
                f"ring:{tag}{r.buffer}@{r.lo}..{r.hi}",
                r.ring_shape(self.bh, self.bw), (),
                r.ring_bytes(self.bh, self.bw), double_buffered=False,
            ))
        taken = dict(self.chain.reuse) if self.chain is not None else {}
        for sp, key in self.scratch_entries():
            tag = "ring" if key is None else str(key)
            shape = self.scratch_shape(sp, key)
            if sp.name in taken:
                # in a dead panel's words, counted there
                tag += f" in {taken[sp.name]}"
            streams.append(StreamPlan(
                f"scratch:{sp.name}@{tag}", shape, (),
                0 if sp.name in taken else ELEM_BYTES * math.prod(shape),
                double_buffered=False,
            ))
        out = self.output
        if self.smem_planned:
            # evaluated in registers and stored straight to global memory
            streams.append(StreamPlan(
                "out", out.panel_shape(self.bh), (bofs,), 0, double_buffered=False,
            ))
        else:
            streams.append(StreamPlan(
                "out", out.panel_shape(self.bh), (bofs,) if out.streamed else (),
                out.panel_bytes(self.bh),
            ))
        notes = {
            "bh": self.bh,
            "streamed": out.streamed,
            "stage": out.name,
            "stages": self.stage_names,
        }
        if self.red_grid is not None:
            notes["red_grid"] = (self.red_grid.dim, self.red_grid.chunk)
            if self.red_grid.padded:
                notes["red_tail"] = self.red_grid.tail
        if self.padded_grid is not None:
            pg = self.padded_grid
            notes["padded_grid"] = (pg.extent, pg.block, pg.steps)
        if self.lane_grid is not None:
            lg = self.lane_grid
            notes["lane_grid"] = (lg.extent, lg.block, lg.steps)
            notes["bw"] = self.bw
        if self.batch_grid is not None:
            bg = self.batch_grid
            notes["batch_grid"] = (bg.extent, bg.block, bg.steps)
        if self.line_buffered:
            notes["linebuf"] = {
                sp.name: (sp.line_buffer.lo, sp.line_buffer.hi)
                for sp in self.stages if sp.line_buffer is not None
            }
        if self.rings:
            notes["rings"] = tuple(
                (r.buffer, r.lo, r.hi, r.stride0) for r in self.rings
            )
        if self.panels is not None:
            pn = self.panels
            notes["weight_panels"] = (
                self.groups[pn.group].buffer, pn.axis, pn.block, pn.count,
            )
        if self.chain is not None:
            ch = self.chain
            notes["hidden_chain"] = (ch.hidden, ch.consumer, ch.block, ch.count, ch.tile)
        if self.window is not None:
            wa = self.window
            notes["window_attention"] = (wa.score, wa.stats, wa.keys, wa.windows, wa.masked)
        resident = [g.buffer for g in self.groups if g.resident]
        if resident:
            notes["red_resident"] = tuple(resident)
        notes.update(self.notes)
        return KernelPlan(self.grid, streams, notes)

    def hbm_bytes(self) -> int:
        """Estimated HBM bytes one invocation moves: every delivered input
        block (resident broadcast blocks and pinned warm-up views fetched
        once) plus the output store.  Summed over a pipeline's kernels this
        is the traffic metric fusion improves — fused intermediates never
        appear, and ring-delivered inputs count once per grid step instead
        of once per tap.  Under a lane grid, dim 1 varies fastest: a
        row-blocked lane-less stream's block index is constant across the
        inner lane sweep, so Pallas re-fetches it only ``steps0`` times,
        while lane-blocked streams fetch once per (row, lane) step.

        A batch grid multiplies the whole per-tile traffic by the slot
        count: every input stream (pinned warm-up views included) carries a
        batch index, so its block changes — and is re-fetched — once per
        batch slot, and each slot stores its own output tile."""
        base = self.base_grid
        steps0 = base[0]
        dim1_steps = base[1] if len(base) > 1 else 1
        total = ELEM_BYTES * math.prod(self.output.nstage.pure_extents)
        for g in self.groups:
            blk = ELEM_BYTES * math.prod(g.block_shape(self.bh, self.bw))
            if g.pinned:
                deliveries = 1
            elif self.lane_grid is not None:
                if g.lane_axis is not None and not g.lane_pinned:
                    # the inner lane index cycles every outer row step, so
                    # the block index changes on every grid step
                    deliveries = steps0 * dim1_steps
                elif g.blocked_axis is not None:
                    # lane-less row streams and lane-pinned warm-up views:
                    # the block index changes only with the row step
                    deliveries = steps0
                else:
                    deliveries = 1
            elif g.blocked_axis is not None:
                deliveries = steps0 * (dim1_steps if g.red_axis is not None else 1)
            elif g.red_axis is not None and not g.resident:
                # chunk sequence re-walked every row panel
                deliveries = steps0 * dim1_steps
            else:
                deliveries = 1
            total += blk * deliveries
        return self.batch_steps * total

    def aligned_blocks(self) -> Dict[str, Tuple[int, ...]]:
        """Compiled-mode (8, 128)-tile-aligned block shapes per stream, the
        lane/sublane rounding of ``core/ubplan.align_tpu_shape``.  Under an
        ``align_tpu`` lane grid the planner already emits 128-multiple lane
        blocks, so this report matches the emitted shapes on the lane dim."""
        out = {f"{g.buffer}[{k}]": align_tpu_shape(g.block_shape(self.bh, self.bw))
               for k, g in enumerate(self.groups)}
        out["out"] = align_tpu_shape(self.output.panel_shape(self.bh))
        return out


# ---------------------------------------------------------------------------
# Pipeline plans
# ---------------------------------------------------------------------------


@dataclass
class PipelinePlan:
    pipeline: Pipeline
    nstages: List[NormalizedStage]
    kernels: List[KernelGroup]
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return len(self.nstages)

    @property
    def n_kernels(self) -> int:
        return len(self.kernels)

    @property
    def fused_away(self) -> List[str]:
        """Intermediates that never touch HBM (VMEM-scratch residents)."""
        return [sp.name for kg in self.kernels for sp in kg.stages[:-1]]

    @property
    def line_buffered(self) -> Dict[str, Tuple[str, ...]]:
        """Per kernel, the fused stages carried in cross-grid-step rings."""
        return {
            kg.name: kg.line_buffered for kg in self.kernels if kg.line_buffered
        }

    @property
    def n_rings(self) -> int:
        """Input delivery classes collapsed into cross-grid-step rings."""
        return sum(len(kg.rings) for kg in self.kernels)

    @property
    def lane_blocked(self) -> Dict[str, Tuple[int, int]]:
        """Per lane-blocked kernel, its ``(bw, lane steps)`` decision."""
        return {
            kg.name: (kg.bw, kg.lane_grid.steps)
            for kg in self.kernels if kg.lane_grid is not None
        }

    @property
    def batch(self) -> Optional[int]:
        """Valid tiles per invocation, or None for an unbatched plan."""
        return self.notes.get("batch")

    @property
    def batch_capacity(self) -> Optional[int]:
        """Batch slots per invocation (>= ``batch``; the runner zero-pads
        the ragged tail), or None for an unbatched plan."""
        return self.notes.get("batch_capacity")

    def eval_rows(self) -> Dict[str, int]:
        """Rows evaluated per stage per pipeline invocation (recompute
        metric; see :meth:`KernelGroup.eval_rows`)."""
        out: Dict[str, int] = {}
        for kg in self.kernels:
            out.update(kg.eval_rows())
        return out

    def total_eval_rows(self) -> int:
        return sum(self.eval_rows().values())

    def kernel_for(self, name: str) -> KernelGroup:
        for kg in self.kernels:
            if kg.name == name:
                return kg
        for kg in self.kernels:
            if name in kg.stage_names:
                return kg
        raise KeyError(name)

    def hbm_bytes(self) -> int:
        return sum(kg.hbm_bytes() for kg in self.kernels)

    def spill_bytes(self) -> int:
        """Bytes a tile's kernels write to HBM for another kernel of the plan
        to read back: each group output that a later group reads, once
        written and once read by each group that reads it.  0 where every
        intermediate stays in its group's on-chip scratch."""
        total = 0
        for kg in self.kernels:
            readers = sum(
                any(g.buffer == kg.name for g in other.groups)
                for other in self.kernels if other is not kg
            )
            if readers:
                total += (1 + readers) * ELEM_BYTES * math.prod(
                    kg.output.nstage.pure_extents
                )
        return total


# ---------------------------------------------------------------------------
# Cost model (scheduler-driven block heights)
# ---------------------------------------------------------------------------


def scheduler_cost(
    e0: int,
    stmts_per_row: int,
    latency: int,
    bytes_per_row: int,
    fixed_bytes: int,
    *,
    carry_stmts: int = 0,
    warmup_stmts: int = 0,
    rotate_cycles: float = 0.0,
    lane_steps: int = 1,
    carry_stmts_per_row: int = 0,
    lane_warmup_stmts: int = 0,
) -> Callable[[int], float]:
    """Price a candidate block height with the §V-B cycle model.

    Each grid step overlaps the next panel's DMA with the current panel's
    compute (Pallas's implicit double buffering == the paper's AGG/TB
    schedule), so the steady-state step cost is ``max(compute, dma)`` plus a
    fixed per-step overhead; the pipeline fill (first panel's DMA or the
    last panel's drain, whichever the overlap cannot hide) scales with the
    panel, which is what makes the optimum interior rather than "largest
    block that fits VMEM" — the old heuristic this hook replaces.

    Non-divisor blocks run ``ceil(e0 / bh)`` grid steps (a padded grid):
    the tail block is delivered, computed, and masked in full, so its
    padding waste is priced automatically — every step, padded or not,
    costs the full per-step cycles.  A block with less padded work beats an
    equal-step block with more.

    ``carry_stmts`` and ``warmup_stmts`` price the *carry* side of the
    recompute-vs-carry trade (cross-grid-step line buffers): rotating the
    rings copies ``carry_stmts`` elements every step — a VMEM-to-VMEM
    vector move charged to the memory side at ``VMEM_BYTES_PER_CYCLE``,
    overlapping the raster like any other DMA — and the step-0 warm-up
    evaluates ``warmup_stmts`` extra statements once (real PE work, priced
    with ``raster_cycles`` and charged to the pipeline fill).
    ``rotate_cycles`` is the *serial* part of ring maintenance — the
    per-step rotate/warm-up branches and any strided (non-coalescing)
    rotation copies — which runs at the top of the kernel body before the
    raster and therefore cannot hide under the DMA/compute overlap; it is
    what lets the model decline a ring whose bookkeeping costs more than
    the delivery it saves (the camera demosaic stride-2 parity class).
    The planner builds one cost per mode — recompute-mode
    ``stmts_per_row``/streams vs carry-mode with these terms — and the
    cheaper modeled schedule decides the chain's mode, tie-broken toward
    less HBM traffic.

    ``lane_steps`` is the lane-grid step count (``ceil(e1 / bw)``) of a
    2-D lane-blocked plan: every row panel is swept once per lane block,
    so the steady-state term scales by it while the one-time pipeline
    fill does not.  This is what makes modeled cycles comparable *across*
    lane widths — a narrow block's cheaper per-step panel no longer hides
    the extra grid steps it costs — i.e. joint (bh, bw) pricing instead
    of the greedy widest-fit lane selection.

    ``carry_stmts_per_row`` and ``lane_warmup_stmts`` price *lane* carry
    (column rings and lane line buffers of a 2-D grid): rotating a column
    ring copies ``carry_stmts_per_row`` elements per panel row every grid
    step — a VMEM move like ``carry_stmts``, but scaling with the block
    height because every carried column spans the whole row panel — and
    the lane warm-up re-fires once per *row step* (not once per kernel),
    evaluating ``lane_warmup_stmts`` statements per panel row each time.
    """
    def cost(bh: int) -> float:
        steps = _cdiv(e0, bh) * lane_steps
        compute = raster_cycles((bh, max(stmts_per_row, 1)), latency)
        dma = (bytes_per_row * bh) / HBM_BYTES_PER_CYCLE
        if carry_stmts or carry_stmts_per_row:
            dma += (
                (carry_stmts + carry_stmts_per_row * bh)
                * ELEM_BYTES / VMEM_BYTES_PER_CYCLE
            )
        per_step = max(compute, dma) + rotate_cycles + STEP_OVERHEAD_CYCLES
        fill = min(compute, dma) + fixed_bytes / HBM_BYTES_PER_CYCLE
        if warmup_stmts:
            fill += raster_cycles((warmup_stmts,), latency)
        total = steps * per_step + fill
        if lane_warmup_stmts:
            total += _cdiv(e0, bh) * raster_cycles(
                (bh, lane_warmup_stmts), latency
            )
        return total

    return cost


def _stage_latency(ns: NormalizedStage) -> int:
    base = expr_depth(ns.value)
    if ns.red_dims:
        base += 1
    return max(base, 1)


# ---------------------------------------------------------------------------
# Per-stage helpers
# ---------------------------------------------------------------------------


def _stream_ok(accesses: Sequence[LoadAccess], d0: str) -> bool:
    """Streamable iff no load indexes two producer axes by the outer dim."""
    return all(
        sum(1 for ax in la.axes if ax.pure_dim == d0) <= 1 for la in accesses
    )


def _blocked_axis(la: LoadAccess, d0: str) -> Optional[int]:
    j0 = None
    for j, ax in enumerate(la.axes):
        if ax.pure_dim == d0:
            j0 = j
    return j0


def _check_tags(la: LoadAccess) -> None:
    tags = [ax.pure_dim for ax in la.axes if ax.pure_dim is not None]
    if len(tags) != len(set(tags)):
        raise UnsupportedAccessError(
            f"load of {la.buffer} indexes one pure dim on two axes"
        )


def _red_grid_candidate(
    ns: NormalizedStage,
    accesses: Sequence[LoadAccess],
    threshold: int,
    chunk: Optional[int] = None,
) -> Optional[Tuple[RedGrid, Dict[int, Optional[int]]]]:
    """Decide whether the stage's leading reduction dim can enter the grid.

    Only the *leading* reduction dim is eligible: chunking it across grid
    steps then preserves the reference interpreter's lexicographic
    accumulation order exactly (the emitted kernel stays bit-identical to
    the fully-unrolled path in f32 — padded tail terms are masked to exact
    zeros, and appending ``+ 0.0`` does not perturb an f32 accumulator).
    The chunk no longer needs to divide the extent: ``steps`` is the
    ceil-division and the emitter masks the tail chunk's invalid terms, so
    K=1000 chunks as 7x128 + a masked 104-tail instead of falling back to
    a full unroll or an awkward divisor.  Every load axis touching the dim
    must be indexed by it alone (``coeff 1, const 0, no pure dim``) so
    chunked BlockSpec delivery is exact; returns the plan plus each load's
    reduction-blocked axis.

    ``chunk`` overrides the default chunk size (an autotuner knob — the
    chunk trades per-step VMEM residency against grid-step overhead); it
    is clamped to the extent, and a value of 1 declines the grid
    reduction entirely (every chunk is one term — pure overhead).  A
    running maximum stays whole: a masked tail term reads 0.0, which only
    a sum ignores."""
    if not ns.red_dims or ns.combiner != "add":
        return None
    r = ns.red_dims[0]
    extent = ns.red_extents[0]
    if extent < threshold:
        return None
    if chunk is None:
        chunk = min(MAX_RED_CHUNK, (extent + 1) // 2)
    else:
        chunk = max(1, min(chunk, extent))
    if chunk <= 1:
        return None
    axis_of: Dict[int, Optional[int]] = {}
    for k, la in enumerate(accesses):
        hit = None
        for j, ax in enumerate(la.axes):
            coeffs = dict(ax.red_coeffs)
            if r not in coeffs or coeffs[r] == 0:
                continue
            if hit is not None:
                return None                     # r rides two axes of one load
            if ax.pure_dim is not None or ax.red_coeffs != ((r, 1),) or ax.const != 0:
                return None                     # chunked delivery not exact
            hit = j
        axis_of[k] = hit
    return RedGrid(r, chunk, _cdiv(extent, chunk), extent), axis_of


# ---------------------------------------------------------------------------
# Kernel-group construction
# ---------------------------------------------------------------------------


def _shift_sets(
    members: Sequence[Tuple[NormalizedStage, List[LoadAccess], bool]],
) -> Dict[str, Tuple[int, ...]]:
    """Consumer demands propagated reverse-topologically: the row-panel
    shifts at which each fused stage must be available per grid step."""
    names = {ns.name for ns, _, _ in members}
    out_ns = members[-1][0]
    in_group: Dict[str, List[Tuple[NormalizedStage, LoadAccess]]] = {}
    for ns, acc, _ in members:
        for la in acc:
            if la.buffer in names:
                in_group.setdefault(la.buffer, []).append((ns, la))
    shifts_of: Dict[str, Tuple[int, ...]] = {out_ns.name: (0,)}
    for ns, _, _ in reversed(members[:-1]):
        shifts: Set[int] = set()
        for cons, la in in_group.get(ns.name, []):
            d0 = cons.pure_dims[0]
            ax0 = la.axes[0]
            if ax0.pure_dim != d0 or ax0.stride != 1:
                raise FusionInfeasible(
                    f"{cons.name} reads {ns.name} with stride "
                    f"{ax0.stride} on the blocked dim"
                )
            if any(
                j != 0 and ax.pure_dim == d0 for j, ax in enumerate(la.axes)
            ):
                raise FusionInfeasible(
                    f"{cons.name} reads {ns.name} by the blocked dim on a "
                    f"non-leading axis"
                )
            red_ext = dict(zip(cons.red_dims, cons.red_extents))
            for off in ax0.offsets(red_ext):
                if off < 0:
                    raise FusionInfeasible(
                        f"{cons.name} reads {ns.name} at negative offset {off}"
                    )
                for s in shifts_of[cons.name]:
                    shifts.add(off + s)
        if not shifts:
            raise FusionInfeasible(f"{ns.name} has no in-group consumer")
        shifts_of[ns.name] = tuple(sorted(shifts))
    return shifts_of


def _lane_shift_sets(
    members: Sequence[Tuple[NormalizedStage, List[LoadAccess], bool]],
) -> Dict[str, Tuple[int, ...]]:
    """Column analog of :func:`_shift_sets` for lane-blocked kernels: the
    lane-panel shifts at which each fused stage must be available per lane
    step, propagated reverse-topologically from the consumers' lane-axis
    (trailing-axis) offsets.  Requires every in-group edge to read the
    producer's trailing axis by the consumer's own lane dim with stride 1
    and non-negative offsets — the same structural contract rows have —
    and every member to be at least rank 2 (a rank-1 stage's only axis is
    the row-blocked one).  Violations raise :class:`FusionInfeasible`,
    which makes the *lane-blocked* fusion infeasible; the planner then
    falls back to per-stage lane-blocked kernels."""
    names = {ns.name for ns, _, _ in members}
    out_ns = members[-1][0]
    for ns, _, _ in members:
        if len(ns.pure_dims) < 2:
            raise FusionInfeasible(
                f"{ns.name} is rank-1: no lane dim to block"
            )
    in_group: Dict[str, List[Tuple[NormalizedStage, LoadAccess]]] = {}
    for ns, acc, _ in members:
        for la in acc:
            if la.buffer in names:
                in_group.setdefault(la.buffer, []).append((ns, la))
    lane_of: Dict[str, Tuple[int, ...]] = {out_ns.name: (0,)}
    for ns, _, _ in reversed(members[:-1]):
        shifts: Set[int] = set()
        for cons, la in in_group.get(ns.name, []):
            dl = cons.pure_dims[-1]
            axl = la.axes[-1]
            if axl.pure_dim != dl or axl.stride != 1:
                raise FusionInfeasible(
                    f"{cons.name} reads {ns.name}'s lane axis by "
                    f"{axl.pure_dim} (stride {axl.stride}); lane blocking "
                    f"needs the consumer lane dim at stride 1"
                )
            if any(
                j != len(la.axes) - 1 and ax.pure_dim == dl
                for j, ax in enumerate(la.axes)
            ):
                raise FusionInfeasible(
                    f"{cons.name} reads {ns.name} by the lane dim on a "
                    f"non-trailing axis"
                )
            red_ext = dict(zip(cons.red_dims, cons.red_extents))
            for off in axl.offsets(red_ext):
                if off < 0:
                    raise FusionInfeasible(
                        f"{cons.name} reads {ns.name} at negative lane "
                        f"offset {off}"
                    )
                for t in lane_of[cons.name]:
                    shifts.add(off + t)
        if not shifts:
            raise FusionInfeasible(f"{ns.name} has no in-group consumer")
        lane_of[ns.name] = tuple(sorted(shifts))
    return lane_of


def _ring_rewrite(
    groups: List[ViewGroup], e0_out: int, banned: Set[Tuple]
) -> Tuple[List[ViewGroup], List[RingStream], Dict[int, int], Dict[int, Tuple[int, int]]]:
    """Collapse row-shifted view classes into cross-grid-step ring streams.

    Views of one buffer that differ only in their blocked-axis start (same
    axis, stride, and start residue) deliver overlapping windows shifted by
    whole rows — the halo a line buffer carries.  Each such class becomes
    one streaming view at the *leading* start ``hi`` plus a pinned
    ``halo``-row warm-up view at ``lo``, with a VMEM ring (managed by the
    emitter) carrying the trailing rows between grid steps.  Returns the
    rewritten group list, the rings, an old->new index map for untouched
    groups, and an old index -> (ring, tap row) map for collapsed ones."""
    classes: Dict[Tuple, List[int]] = {}
    for gi, g in enumerate(groups):
        if g.blocked_axis is None or g.red_axis is not None or g.pinned:
            continue
        key = (g.buffer, g.blocked_axis, g.stride0, g.k0 % g.stride0)
        if key in banned:
            continue
        classes.setdefault(key, []).append(gi)
    specs = sorted(
        (kv for kv in classes.items() if len(kv[1]) >= 2),
        key=lambda kv: min(kv[1]),
    )
    if not specs:
        return groups, [], {gi: gi for gi in range(len(groups))}, {}
    member = {gi for _, idxs in specs for gi in idxs}
    new_groups: List[ViewGroup] = []
    gmap: Dict[int, int] = {}
    for gi, g in enumerate(groups):
        if gi not in member:
            gmap[gi] = len(new_groups)
            new_groups.append(g)
    rings: List[RingStream] = []
    ring_map: Dict[int, Tuple[int, int]] = {}
    for key, idxs in specs:
        ms = [groups[i] for i in idxs]
        ax, stride0, nd = ms[0].blocked_axis, ms[0].stride0, ms[0].ndim
        lo = min(g.k0 for g in ms)
        hi = max(g.k0 for g in ms)
        halo = (hi - lo) // stride0
        base: List[int] = []
        span: List[int] = []
        for j in range(nd):
            if j == ax:
                base.append(lo)
                span.append(0)
            else:
                b = min(g.base[j] for g in ms)
                t = max(g.base[j] + g.span[j] for g in ms)
                base.append(b)
                span.append(t - b)
        steady_base = list(base)
        steady_base[ax] = hi
        steady_span = list(span)
        steady_span[ax] = e0_out
        si = len(new_groups)
        new_groups.append(ViewGroup(
            ms[0].buffer, nd, ax, hi, stride0, None, 1,
            base=steady_base, span=steady_span, valid0=e0_out,
        ))
        prefix_base = list(base)
        prefix_base[ax] = lo
        prefix_span = list(span)
        prefix_span[ax] = halo
        pi = len(new_groups)
        new_groups.append(ViewGroup(
            ms[0].buffer, nd, ax, lo, stride0, None, 1,
            base=prefix_base, span=prefix_span, valid0=None,
            pinned=True, rows0=halo,
        ))
        r = len(rings)
        rings.append(RingStream(
            ms[0].buffer, ax, stride0, lo, hi, si, pi, nd, base, span, key=key
        ))
        for gi in idxs:
            ring_map[gi] = (r, (groups[gi].k0 - lo) // stride0)
    return new_groups, rings, gmap, ring_map


def _lane_ring_rewrite(
    groups: List[ViewGroup], e0_out: int, e1_out: int, banned: Set[Tuple]
) -> Tuple[List[ViewGroup], List[RingStream], Dict[int, int], Dict[int, Tuple[int, int]]]:
    """Column analog of :func:`_ring_rewrite` for lane-blocked kernels:
    collapse *lane*-shifted view classes into per-lane-step ring streams.

    Views of one buffer that share their entire row binding (blocked axis,
    start, stride — all part of the class key) and differ only in their
    lane-axis start (same lane axis, stride, and start residue) deliver
    column windows shifted by whole lane-lattice units.  Each class becomes
    one streaming view at the leading lane start ``hi`` plus a *lane-pinned*
    warm-up view of the ``halo`` columns below it (fetched once per row
    step — its lane block index is pinned to 0), with a
    ``(bh, ..., bw + halo)`` VMEM ring rotated by the emitter once per lane
    step.  Each input row is then delivered once per row sweep instead of
    once per lane tap."""
    classes: Dict[Tuple, List[int]] = {}
    for gi, g in enumerate(groups):
        if (
            g.lane_axis is None or g.blocked_axis is None
            or g.red_axis is not None or g.pinned or g.lane_pinned
        ):
            continue
        key = (
            "lane", g.buffer, g.lane_axis, g.lane_stride,
            g.l0 % g.lane_stride, g.blocked_axis, g.k0, g.stride0,
        )
        if key in banned:
            continue
        classes.setdefault(key, []).append(gi)
    specs = sorted(
        (kv for kv in classes.items() if len(kv[1]) >= 2),
        key=lambda kv: min(kv[1]),
    )
    if not specs:
        return groups, [], {gi: gi for gi in range(len(groups))}, {}
    member = {gi for _, idxs in specs for gi in idxs}
    new_groups: List[ViewGroup] = []
    gmap: Dict[int, int] = {}
    for gi, g in enumerate(groups):
        if gi not in member:
            gmap[gi] = len(new_groups)
            new_groups.append(g)
    rings: List[RingStream] = []
    ring_map: Dict[int, Tuple[int, int]] = {}
    for key, idxs in specs:
        ms = [groups[i] for i in idxs]
        axL, lstride, nd = ms[0].lane_axis, ms[0].lane_stride, ms[0].ndim
        ax0, k0, rstride = ms[0].blocked_axis, ms[0].k0, ms[0].stride0
        lo = min(g.l0 for g in ms)
        hi = max(g.l0 for g in ms)
        halo = (hi - lo) // lstride
        base: List[int] = []
        span: List[int] = []
        for j in range(nd):
            if j == axL:
                base.append(lo)
                span.append(0)
            elif j == ax0:
                base.append(k0)
                span.append(0)
            else:
                b = min(g.base[j] for g in ms)
                t = max(g.base[j] + g.span[j] for g in ms)
                base.append(b)
                span.append(t - b)
        steady_base = list(base)
        steady_base[axL] = hi
        steady_base[ax0] = k0
        steady_span = list(span)
        steady_span[axL] = e1_out
        steady_span[ax0] = e0_out
        si = len(new_groups)
        new_groups.append(ViewGroup(
            ms[0].buffer, nd, ax0, k0, rstride, None, 1,
            base=steady_base, span=steady_span, valid0=e0_out,
            lane_axis=axL, l0=hi, lane_stride=lstride, valid1=e1_out,
        ))
        prefix_base = list(base)
        prefix_base[axL] = lo
        prefix_base[ax0] = k0
        prefix_span = list(span)
        prefix_span[axL] = halo
        prefix_span[ax0] = e0_out
        pi = len(new_groups)
        new_groups.append(ViewGroup(
            ms[0].buffer, nd, ax0, k0, rstride, None, 1,
            base=prefix_base, span=prefix_span, valid0=e0_out,
            lane_axis=axL, l0=lo, lane_stride=lstride, valid1=None,
            lane_pinned=True, cols0=halo,
        ))
        r = len(rings)
        rings.append(RingStream(
            ms[0].buffer, axL, lstride, lo, hi, si, pi, nd, base, span,
            key=key, lane=True, row_axis=ax0, row_k0=k0, row_stride=rstride,
        ))
        for gi in idxs:
            ring_map[gi] = (r, (groups[gi].l0 - lo) // lstride)
    return new_groups, rings, gmap, ring_map


def _staged_hull(groups: Sequence[ViewGroup]) -> Optional[Dict[str, Tuple[int, ...]]]:
    """Per buffer read only through grid-invariant views (none of them
    row-blocked), the hull of those views from 0: what a group planned
    against shared memory stages.  None where a buffer is read both
    row-blocked and grid-invariant."""
    direct = {g.buffer for g in groups if g.blocked_axis is not None}
    hull: Dict[str, Tuple[int, ...]] = {}
    for g in groups:
        if g.blocked_axis is not None:
            continue
        if g.buffer in direct:
            return None
        need = tuple(b + n for b, n in zip(g.base, g.span))
        prev = hull.get(g.buffer)
        hull[g.buffer] = tuple(map(max, prev, need)) if prev else need
    return hull


def _weight_panels(
    members: List[Tuple[NormalizedStage, List[LoadAccess], bool]],
    plans: Mapping[str, StagePlan],
    groups: Sequence[ViewGroup],
    rings: Sequence[RingStream],
    red_grid: Optional[RedGrid],
    *,
    vmem_budget: int,
    block_h: Optional[int],
    cost: Optional[Callable[[int], float]],
    align_tpu: bool,
) -> Optional[Tuple[WeightPanels, int, int, int]]:
    """Plan a fused group that the Pallas working-set model cannot hold
    against shared memory as the CUDA kernel fills it (see
    :class:`WeightPanels`), or None where the group does not qualify.

    It qualifies where it carries nothing (no ring, line buffer or grid
    reduction), each fused producer is demanded at its consumer's own rows
    (shift 0, so no halo is recomputed), every buffer is read either only
    through row-blocked views (read from global memory) or only through
    grid-invariant ones (staged), and one grid-invariant view group, read
    by the output stage alone, indexes one axis exactly by the output's
    one reduction variable over the reduction's whole extent: the weight
    staged in panels.  Its working set is the fused panels' rows
    (``bytes_per_row``) and the staged copies, padding included
    (``fixed``), under the same ``2 * bytes_per_row * bh + fixed <=
    vmem_budget`` rule.  The panel is the widest divisor of the reduction's
    extent at which some block height fits; the block height is then
    chosen as for any other group.  Returns the panels, the working set and
    the block height."""
    out_ns = members[-1][0]
    stages = [plans[ns.name] for ns, _, _ in members]
    if rings or red_grid is not None or any(sp.line_buffer is not None for sp in stages):
        return None
    if any(sp.shifts != (0,) or sp.lane_shifts != (0,) for sp in stages[:-1]):
        return None
    if any(g.pinned or g.lane_axis is not None or g.red_axis is not None for g in groups):
        return None
    if len(out_ns.red_dims) != 1 or any(ns.combiner != "add" for ns, _, _ in members):
        return None
    red, extent = out_ns.red_dims[0], out_ns.red_extents[0]
    hull = _staged_hull(groups)
    if hull is None:
        return None
    out_sp = stages[-1]
    best: Optional[Tuple[int, int, int]] = None
    for gi, g in enumerate(groups):
        if g.buffer not in hull or sum(h.buffer == g.buffer for h in groups) != 1:
            continue
        if any(gi in b.values() for sp in stages[:-1] for b in sp.view_binding):
            continue
        loads = [la for la, b in zip(out_sp.accesses, out_sp.view_binding) if gi in b.values()]
        for a in range(g.ndim):
            if g.base[a] == 0 and g.span[a] == extent and loads and all(
                la.axes[a].pure_dim is None and la.axes[a].const == 0
                and la.axes[a].red_coeffs == ((red, 1),)
                for la in loads
            ):
                size = math.prod(g.span)
                if best is None or size > best[0]:
                    best = (size, gi, a)
    if best is None:
        return None
    _size, gi, axis = best
    panel_buffer = groups[gi].buffer
    e0 = out_ns.pure_extents[0]
    scratch = ELEM_BYTES * sum(math.prod(ns.pure_extents[1:]) for ns, _, _ in members[:-1])
    for block in (d for d in range(extent, 0, -1) if extent % d == 0):
        fixed = sum(
            staged_bytes([block if b == panel_buffer and j == axis else e
                          for j, e in enumerate(ext)])
            for b, ext in hull.items()
        )
        if block_h is not None:
            bh = min(block_h, e0)
        else:
            bh = plan_affine_stage(
                e0, scratch, fixed, vmem_budget=vmem_budget, cost=cost,
                align_tpu=align_tpu,
            )
        if 2 * scratch * bh + fixed <= vmem_budget:
            return WeightPanels(gi, axis, block, extent), scratch, fixed, bh
    return None


def _own(la: LoadAccess, dims: Sequence[str]) -> bool:
    """Whether a load reads its producer at the reader's own position on
    every axis but the last: axis ``a`` at ``dims[a]``, stride 1, offset 0."""
    return len(la.axes) == len(dims) + 1 and all(
        (a.pure_dim, a.stride, a.red_coeffs, a.const) == (d, 1, (), 0)
        for a, d in zip(la.axes[:-1], dims)
    )


def chain_shape(
    stages: Sequence[StagePlan], groups: Sequence[ViewGroup],
) -> Optional[Tuple[str, Tuple[str, ...], Tuple[Tuple[int, int], ...], Tuple[str, ...]]]:
    """The chain a fused group's stages hold, or None: ``(consumer, hidden,
    staged, unstaged)`` as :class:`HiddenChain` names them.  The consumer
    is a fused stage, not the output, with one reduction (the last such
    chain); the hidden stages are those
    it reads at its own position with that reduction's variable alone on
    their innermost axis, and, from them back, the fused producers a hidden
    stage reads at its own position (the same innermost index).  Every
    hidden stage's innermost extent is the reduction's, its other extents
    the consumer's outer ones, and no other stage reads it.  ``staged`` are
    the grid-invariant view groups, each its buffer's only view, read only
    by the chain and along the hidden axis by every load: at the reading
    hidden stage's innermost index, or the consumer's reduction variable;
    ``unstaged`` the grid-invariant buffers only stages before the first
    hidden one read."""
    out = stages[-1]
    for cons in reversed(stages[:-1]):
        ns = cons.nstage
        if len(ns.red_dims) != 1:
            continue
        red, extent = ns.red_dims[0], ns.red_extents[0]
        outer = ns.pure_dims[:-1]
        by_name = {sp.name: sp for sp in stages}
        hidden: List[str] = []
        todo = [
            p for la, p in zip(cons.accesses, cons.scratch_producer)
            if p is not None and _own(la, outer)
            and (la.axes[-1].pure_dim, la.axes[-1].const, la.axes[-1].red_coeffs)
            == (None, 0, ((red, 1),))
        ]
        while todo:
            name = todo.pop()
            if name in hidden:
                continue
            hidden.append(name)
            sp = by_name[name]
            inner = sp.nstage.pure_dims[-1]
            todo += [
                p for la, p in zip(sp.accesses, sp.scratch_producer)
                if p is not None and _own(la, sp.nstage.pure_dims[:-1])
                and (la.axes[-1].pure_dim, la.axes[-1].stride, la.axes[-1].red_coeffs,
                     la.axes[-1].const) == (inner, 1, (), 0)
            ]
        if not hidden:
            continue
        ok = all(
            by_name[h].nstage.pure_extents[-1] == extent
            and by_name[h].nstage.pure_extents[:-1] == ns.pure_extents[:-1]
            for h in hidden
        ) and out.name != cons.name
        # nothing but the chain reads a hidden stage
        for sp in stages:
            if sp.name in hidden or sp is cons:
                continue
            if any(p in hidden for p in sp.scratch_producer):
                ok = False
        if not ok:
            continue
        # each grid-invariant view: the hidden axis of every load of it
        along: Dict[int, Set[Optional[int]]] = {}
        for sp in stages:
            if sp.name in hidden:
                key = (sp.nstage.pure_dims[-1], 1, (), 0)
            elif sp is cons:
                key = (None, 1, ((red, 1),), 0)
            else:
                key = None
            for la, b in zip(sp.accesses, sp.view_binding):
                hits = [a for a, ax in enumerate(la.axes)
                        if (ax.pure_dim, ax.stride, ax.red_coeffs, ax.const) == key]
                for gi in set(b.values()):
                    if groups[gi].blocked_axis is None:
                        along.setdefault(gi, set()).add(hits[0] if len(hits) == 1 else None)
        staged = []
        for gi, axes in sorted(along.items()):
            if axes == {None}:
                continue
            g = groups[gi]
            a = next(iter(axes))
            if len(axes) != 1 or sum(h.buffer == g.buffer for h in groups) != 1 \
                    or (g.base[a], g.span[a]) != (0, extent):
                ok = False
                break
            staged.append((gi, a))
        if ok:
            order = [sp.name for sp in stages if sp.name in hidden]
            first = min(i for i, sp in enumerate(stages) if sp.name in hidden)
            later = {groups[gi].buffer for sp in stages[first:] for b in sp.view_binding
                     for gi in b.values()}
            unstaged = sorted({g.buffer for g in groups if g.blocked_axis is None} - later)
            return cons.name, tuple(order), tuple(staged), tuple(unstaged)
    return None


def _hidden_chain(
    members: List[Tuple[NormalizedStage, List[LoadAccess], bool]],
    plans: Mapping[str, StagePlan],
    groups: Sequence[ViewGroup],
    rings: Sequence[RingStream],
    red_grid: Optional[RedGrid],
    *,
    vmem_budget: int,
    block_h: Optional[int],
) -> Optional[Tuple[HiddenChain, int, int, int]]:
    """Plan a fused group that chains two reductions through a hidden axis
    (:class:`HiddenChain`, :func:`chain_shape`) against shared memory as the
    CUDA kernel fills it, or None where the group holds no chain or cannot
    fit.  It qualifies as :func:`_weight_panels` asks (nothing carried, each
    fused producer at its consumer's rows, every buffer read either
    row-blocked or grid-invariant).  Its working set is what the kernel
    allocates, once: the fused panels' rows, a hidden stage's cut to one
    panel (``bytes_per_row``), and the staged copies, each panel buffer's
    hidden axis cut to one panel (in rows of 16-byte words where the cut is
    on a leading axis), none of the inputs only the stages before the chain
    read (``fixed``), under ``bytes_per_row * bh + fixed <=
    vmem_budget``; a panel that takes a dead panel's words
    (:func:`chain_reuse`) counts nothing.  The block height is the largest
    (at most ``block_h``) whose consumer panel the block's threads hold in
    registers (:func:`chain_tile_shape`) and at which some panel fits; the
    panel then the widest divisor of the hidden extent that fits and whose
    hidden panel a register tile of two or more elements a thread covers in
    one pass (:func:`hidden_tile_shape`), else the widest that fits, one
    element a thread.  Returns the chain, the working set and the block
    height."""
    stages = [plans[ns.name] for ns, _, _ in members]
    if rings or red_grid is not None or any(sp.line_buffer is not None for sp in stages):
        return None
    if any(sp.shifts != (0,) or sp.lane_shifts != (0,) for sp in stages[:-1]):
        return None
    if any(g.pinned or g.lane_axis is not None or g.red_axis is not None for g in groups):
        return None
    if any(ns.combiner != "add" for ns, _, _ in members):
        return None
    hull = _staged_hull(groups)
    found = chain_shape(stages, groups)
    if hull is None or found is None:
        return None
    consumer, hidden, staged, unstaged = found
    cons = plans[consumer].nstage
    extent = cons.red_extents[0]
    cut = {groups[gi].buffer: a for gi, a in staged}
    e0 = cons.pure_extents[0]
    reuse = chain_reuse(stages, consumer, hidden)
    takers = {t for t, _d in reuse}

    def row_bytes(block: int) -> int:
        return ELEM_BYTES * sum(
            math.prod(ns.pure_extents[1:-1]) * block if ns.name in hidden
            else math.prod(ns.pure_extents[1:])
            for ns, _, _ in members[:-1] if ns.name not in takers
        )

    def fixed_bytes(block: int) -> int:
        return sum(
            staged_bytes([block if b in cut and j == cut[b] else e for j, e in enumerate(ext)],
                         b in cut and cut[b] < len(ext) - 1)
            for b, ext in hull.items() if b not in unstaged
        )

    blocks = [d for d in range(extent, 0, -1) if extent % d == 0]
    top = e0 if block_h is None else min(block_h, e0)
    for bh in range(top, 0, -1) if block_h is None else (top,):
        outer = bh * math.prod(cons.pure_extents[1:-1])
        if chain_tile_shape(outer, cons.pure_extents[-1]) is None:
            continue
        fits = [b for b in blocks if row_bytes(b) * bh + fixed_bytes(b) <= vmem_budget]
        if not fits:
            continue
        block = next((b for b in fits if hidden_tile_shape(outer, b) is not None), fits[0])
        tile = hidden_tile_shape(outer, block) or (1, 1)
        return (HiddenChain(hidden, consumer, extent, block, staged, unstaged, tile, reuse),
                row_bytes(block), fixed_bytes(block), bh)
    return None


def window_shape(stages: Sequence[StagePlan]) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """The window-attention tile a fused group's stages hold, or None:
    ``(score, stats)`` as :class:`WindowAttention` names them.  The output
    is a sum over ``k`` reduction variables; the first fused stage, the
    score tile, has the keys as its last ``k`` pure axes, of those extents,
    and its other axes are each other fused stage's (the statistics'), and
    lead the output's.  Every statistic and the output reduce over the
    keys with the same extents, read the tile at their own position and
    the keys' variables (stride 1, offset 0), and read each statistic at
    their own position; the statistics read no other fused stage."""
    out, fused = stages[-1], list(stages[:-1])
    if len(fused) < 2 or not out.nstage.red_dims or out.nstage.combiner != "add":
        return None
    score = fused[0]
    k = len(out.nstage.red_dims)
    sp_dims, sp_ext = score.nstage.pure_dims, score.nstage.pure_extents
    if len(sp_dims) <= k or tuple(sp_ext[-k:]) != tuple(out.nstage.red_extents):
        return None
    rows = sp_dims[:-k]
    names = {sp.name for sp in fused}
    for t in fused[1:] + [out]:
        ns = t.nstage
        if tuple(ns.red_extents) != tuple(sp_ext[-k:]) or ns.pure_dims[:len(rows)] != rows:
            return None
        if t is not out and ns.pure_dims != rows:
            return None
        red = ns.red_dims
        for la, p in zip(t.accesses, t.scratch_producer):
            if p is None:
                continue
            if p not in names:
                return None
            want = [(d, 1, (), 0) for d in rows]
            if p == score.name:
                want += [(None, 1, ((r, 1),), 0) for r in red]
            if [(a.pure_dim, a.stride, a.red_coeffs, a.const) for a in la.axes] != want:
                return None
    if any(p is not None for p in score.scratch_producer):
        return None
    return score.name, tuple(sp.name for sp in fused[1:])


def window_masked(kg: "KernelGroup") -> Tuple[int, int]:
    """``(windows, masked)`` of a window-attention group: the windows of
    one row (head), the values of the tile's axes after the first that its
    key reads share, and those whose keys fall in more than one region of
    the mask the tile starts from (its reduction's initial value, from the
    positions alone; Swin's shifted windows): a window is masked where the
    initial value takes more than one value over the keys of the window's
    first query."""
    score = kg.stage_plan(kg.window.score)
    ns = score.nstage
    k = len(kg.output.nstage.red_dims)
    keys = ns.pure_dims[-k:]
    keyed = [la for la in score.accesses if any(a.pure_dim in keys for a in la.axes)]
    shared = {a.pure_dim for la in keyed for a in la.axes}
    win = [d for d in ns.pure_dims[1:-k] if d in shared]
    windows = math.prod(ns.extent(d) for d in win)
    if ns.init is None or refs_in(ns.init):
        return windows, 0
    masked = 0
    for w in itertools.product(*(range(ns.extent(d)) for d in win)):
        point = {d: ns.lower_of(d) for d in ns.pure_dims}
        point.update((d, v + ns.lower_of(d)) for d, v in zip(win, w))
        seen = set()
        for r in itertools.product(*(range(ns.extent(d)) for d in keys)):
            point.update((d, v + ns.lower_of(d)) for d, v in zip(keys, r))
            seen.add(eval_expr(ns.init, point, None))
        masked += len(seen) > 1
    return windows, masked


def _window_attention(
    members: List[Tuple[NormalizedStage, List[LoadAccess], bool]],
    plans: Mapping[str, StagePlan],
    groups: Sequence[ViewGroup],
    rings: Sequence[RingStream],
    red_grid: Optional[RedGrid],
    *,
    vmem_budget: int,
    block_h: Optional[int],
) -> Optional[Tuple[WindowAttention, int, int, int]]:
    """Plan a fused group that holds a window-attention score tile
    (:class:`WindowAttention`, :func:`window_shape`) against shared memory
    as the CUDA kernel fills it, or None where the group holds no such tile
    or cannot fit.  It carries nothing (no ring, line buffer or grid
    reduction, no pinned, lane- or reduction-tiled view, every fused stage
    at its consumers' rows).  Its working set is what the kernel
    allocates, once: every fused panel's rows (``bytes_per_row``) and the
    staged copies of the grid-invariant inputs (``fixed``), under
    ``bytes_per_row * bh + fixed <= vmem_budget``.  The block height is
    ``block_h`` or 1, one head a block: a block's heads share no load.
    Returns the tile, the working set and the block height."""
    stages = [plans[ns.name] for ns, _, _ in members]
    if rings or red_grid is not None or any(sp.line_buffer is not None for sp in stages):
        return None
    if any(sp.shifts != (0,) or sp.lane_shifts != (0,) for sp in stages[:-1]):
        return None
    if any(g.pinned or g.lane_axis is not None or g.red_axis is not None for g in groups):
        return None
    hull = _staged_hull(groups)
    found = window_shape(stages)
    if hull is None or found is None:
        return None
    score, stats = found
    e0 = stages[-1].nstage.pure_extents[0]
    bh = min(block_h or 1, e0)
    row = ELEM_BYTES * sum(math.prod(ns.pure_extents[1:]) for ns, _, _ in members[:-1])
    fixed = sum(staged_bytes(ext) for ext in hull.values())
    if row * bh + fixed > vmem_budget:
        return None
    keys = math.prod(stages[-1].nstage.red_extents)
    return WindowAttention(score, stats, keys), row, fixed, bh


def chain_times(names: Sequence[str], consumer: str, hidden: Sequence[str]) -> Dict[str, int]:
    """When a chained group's kernel evaluates each fused stage of
    ``names`` (in order), as the index of its turn: each stage in its own
    turn, a barrier after it, but the hidden stages, evaluated a panel at a
    time inside the consumer's turn, and the output, after every turn."""
    at = {n: i for i, n in enumerate(names)}
    return {n: at[consumer] if n in hidden else at[n] for n in names}


def chain_reuse(
    stages: Sequence[StagePlan], consumer: str, hidden: Sequence[str],
) -> Tuple[Tuple[str, str], ...]:
    """Which fused panels of a chained group take a dead panel's words: the
    consumer and each fused stage after it, in turn, take those of the
    smallest panel that holds theirs, neither hidden nor taken nor a taker,
    whose readers all run in turns before the taker's (:func:`chain_times`).
    The stages before the consumer keep their places."""
    names = [sp.name for sp in stages[:-1]]
    times = chain_times(names, consumer, hidden)
    size = {sp.name: math.prod(sp.nstage.pure_extents[1:]) for sp in stages[:-1]}
    last = {n: max((times.get(sp.name, len(names)) for sp in stages
                    if n in sp.scratch_producer), default=-1) for n in names}
    out: List[Tuple[str, str]] = []
    used: Set[str] = set()
    for t in names[names.index(consumer):]:
        if t in hidden:
            continue
        free = [d for d in names if d not in hidden and d not in used and d != t
                and last[d] < times[t] and size[d] >= size[t]]
        if free:
            d = min(free, key=lambda d: (size[d], names.index(d)))
            out.append((t, d))
            used |= {t, d}
    return tuple(out)


def _build_kernel_group(
    members: List[Tuple[NormalizedStage, List[LoadAccess], bool]],
    buffer_shapes: Mapping[str, Tuple[int, ...]],
    *,
    block_h: Optional[int] = None,
    block_w: Optional[int] = None,
    lane_block: object = "auto",
    vmem_budget: int = VMEM_BYTES,
    cost_model: str = "scheduler",
    align_tpu: bool = False,
    grid_reduction: bool = True,
    red_grid_threshold: int = RED_GRID_THRESHOLD,
    line_buffer: object = "auto",
    red_resident: bool = True,
    red_chunk: Optional[int] = None,
    lane_price: str = "joint",
) -> KernelGroup:
    """Build the delivery plan for one kernel (one or more fused stages).

    ``line_buffer`` selects the recompute-vs-carry mode for fused
    intermediates and shifted input deliveries: ``False`` recomputes fused
    panels per demanded shift and streams one view per tap (the PR 2
    scheme), ``True`` carries halo rows in cross-grid-step rings wherever
    structurally feasible (``halo <= bh``), and ``"auto"`` builds both
    plans and keeps the one the scheduler cost model prices cheaper.  When
    no scheduler pricing exists (explicit ``block_h``, or a different
    ``cost_model``), ``"auto"`` prefers carry wherever feasible — it is
    strictly less traffic and at most equal compute — and tags the plan
    ``linebuf_mode="carry-unpriced"``.

    ``block_w`` forces a lane-blocked 2-D grid (``ceil(e0/bh)`` row panels
    x ``ceil(e1/bw)`` lane blocks); without it the planner engages the lane
    grid automatically when even a one-row full-width panel exceeds the
    VMEM budget.  Lane-blocked kernels run in recompute mode (rings and
    line buffers only span grid dim 0) and are mutually exclusive with
    grid-level reductions.

    Raises :class:`FusionInfeasible` when a multi-stage group violates a
    structural constraint or cannot fit VMEM at any block height; a
    single-stage group always plans (matching the pre-refactor backend).

    ``red_chunk`` overrides the grid-reduction chunk size (see
    :func:`_red_grid_candidate`); ``lane_price`` selects the budget-driven
    lane-width policy — ``"joint"`` (default) prices every fitting
    (bh, bw) pair with the scheduler model, ``"greedy"`` restores the
    PR 5 widest-first first-fit."""
    if lane_price not in ("joint", "greedy"):
        raise ValueError(
            f"lane_price must be 'joint' or 'greedy': {lane_price!r}"
        )
    multi = len(members) > 1
    out_ns, out_acc, out_streamed = members[-1]
    names = {ns.name for ns, _, _ in members}
    if multi and not all(st for _, _, st in members):
        raise FusionInfeasible("fusion requires every member stage to stream")
    for ns, acc, _ in members:
        for la in acc:
            _check_tags(la)

    # shift sets are a pure function of the access maps; modes share them
    shifts_of = _shift_sets(members)

    # -- grid reduction (single-stage kernels only) ---------------------------
    red_grid: Optional[RedGrid] = None
    red_axis_of: Dict[int, Optional[int]] = {}
    if grid_reduction and not multi and out_streamed:
        cand = _red_grid_candidate(
            out_ns, out_acc, red_grid_threshold, chunk=red_chunk
        )
        if cand is not None:
            red_grid, red_axis_of = cand

    e0_out = out_ns.pure_extents[0]
    kernel_streamed = out_streamed

    # -- lane-blocking candidacy ----------------------------------------------
    # the lane grid tiles the *trailing* pure dim; it needs a streamed
    # rank>=2 kernel, no grid reduction (both claim grid dim 1), and — for
    # fused groups — lane shift sets satisfying the same structural
    # contract rows have (stride-1 trailing-axis reads, offsets >= 0)
    e1_out = out_ns.pure_extents[-1] if len(out_ns.pure_extents) >= 2 else None
    lane_possible = (
        lane_block is not False
        and kernel_streamed and e1_out is not None and red_grid is None
        and all(len(ns.pure_extents) >= 2 for ns, _, _ in members)
    )
    lane_shifts_of: Optional[Dict[str, Tuple[int, ...]]] = None
    if lane_possible and multi:
        try:
            lane_shifts_of = _lane_shift_sets(members)
        except FusionInfeasible:
            if block_w is not None:
                # forced lane blocking must not be silently dropped: fail
                # this *fusion* so the pipeline planner falls back to
                # per-stage kernels, each lane-blocked on its own
                raise
            lane_possible = False

    def assemble(
        lb_names: Set[str], use_rings: bool, banned: Set[Tuple],
        bw: Optional[int] = None,
        lane_lb_names: Set[str] = frozenset(),
        use_lane_rings: bool = False,
        lane_banned: Set[Tuple] = frozenset(),
    ) -> KernelGroup:
        lane = bw is not None
        plans = {
            ns.name: StagePlan(ns, list(acc), streamed)
            for ns, acc, streamed in members
        }
        for n, s in shifts_of.items():
            plans[n].shifts = s
        if lane:
            for n, sp in plans.items():
                sp.bw = bw
                if lane_shifts_of is not None and n in lane_shifts_of:
                    sp.lane_shifts = lane_shifts_of[n]
        for n in lb_names:
            s = shifts_of[n]
            plans[n].line_buffer = LineBuffer(s[0], s[-1])
        for n in lane_lb_names:
            assert lane and lane_shifts_of is not None and n not in lb_names
            s = lane_shifts_of[n]
            plans[n].line_buffer = LineBuffer(s[0], s[-1], lane=True)

        # -- view groups for boundary loads ----------------------------------
        groups: List[ViewGroup] = []
        by_key: Dict[tuple, int] = {}

        def group_for(key, buffer, ndim, blocked, k0, stride0, red_ax,
                      red_chunk, lane_ax=None, l0=0, lane_stride=1):
            if key not in by_key:
                by_key[key] = len(groups)
                groups.append(ViewGroup(
                    buffer, ndim, blocked, k0, stride0, red_ax, red_chunk,
                    base=[None] * ndim, span=[0] * ndim,  # type: ignore[list-item]
                    valid0=e0_out if blocked is not None else None,
                    lane_axis=lane_ax, l0=l0, lane_stride=lane_stride,
                    valid1=e1_out if lane_ax is not None else None,
                ))
            return by_key[key]

        for ns, acc, _ in members:
            sp = plans[ns.name]
            red_ext = dict(zip(ns.red_dims, ns.red_extents))
            # the gridded reduction dim contributes only its in-chunk extent
            # to offset enumeration (its grid part advances the BlockSpec)
            if red_grid is not None:
                red_ext[red_grid.dim] = red_grid.chunk
            # a line-buffered stage evaluates panels only at the steady-state
            # shift (hi) and the warm-up shift (lo), so only those bindings
            # — and hence only those view starts — exist; a *lane* line
            # buffer trims the lane binding set the same way while the row
            # set stays the full demanded one (one ring per row shift)
            bind_shifts = sp.bind_shifts()
            bind_lanes = sp.bind_lane_shifts() if lane else (0,)
            lane_dim = ns.pure_dims[-1] if lane else None
            for k, la in enumerate(acc):
                if la.buffer in names:
                    sp.load_kind.append("scratch")
                    sp.scratch_producer.append(la.buffer)
                    sp.view_binding.append({})
                    sp.ring_binding.append({})
                    sp.blocked_axis_of.append(0)
                    sp.lane_axis_of.append(len(la.axes) - 1 if lane else None)
                    continue
                j0 = _blocked_axis(la, sp.d0) if kernel_streamed and sp.streamed else None
                jr = red_axis_of.get(k)
                jL = None
                if lane:
                    for j, ax in enumerate(la.axes):
                        if ax.pure_dim == lane_dim and j != j0:
                            jL = j
                sp.load_kind.append("view")
                sp.scratch_producer.append(None)
                sp.blocked_axis_of.append(j0)
                sp.lane_axis_of.append(jL)
                sp.ring_binding.append({})
                binding: Dict[BindKey, int] = {}
                ndim = len(la.axes)
                stride0 = la.axes[j0].stride if j0 is not None else 1
                lstride = la.axes[jL].stride if jL is not None else 1
                row_offs = (
                    la.axes[j0].offsets(red_ext) if j0 is not None else [None]
                )
                lane_offs = (
                    la.axes[jL].offsets(red_ext) if jL is not None else [None]
                )
                for shift in bind_shifts:
                    for off in row_offs:
                        k0 = 0 if off is None else off + stride0 * shift
                        for lshift in bind_lanes:
                            for loff in lane_offs:
                                l0 = (
                                    0 if loff is None
                                    else loff + lstride * lshift
                                )
                                key = (
                                    la.buffer,
                                    None if off is None else j0, stride0, k0,
                                    jr, jL, lstride, l0,
                                )
                                gidx = group_for(
                                    key, la.buffer, ndim,
                                    None if off is None else j0, k0, stride0,
                                    jr,
                                    red_grid.chunk if jr is not None else 1,
                                    lane_ax=jL, l0=l0, lane_stride=lstride,
                                )
                                bk = (
                                    (shift, off, lshift, loff) if lane
                                    else (shift, off)
                                )
                                binding[bk] = gidx
                sp.view_binding.append(binding)

                # hull the non-blocked axes of every group this load touches
                for gidx in set(binding.values()):
                    g = groups[gidx]
                    for j, ax in enumerate(la.axes):
                        if j == g.blocked_axis:
                            g.span[j] = e0_out
                            continue
                        if j == g.lane_axis:
                            g.span[j] = e1_out
                            continue
                        if j == g.red_axis:
                            g.base[j] = 0
                            g.span[j] = ns.extent(red_grid.dim)  # full axis
                            continue
                        lo, hi = ax.offset_range(red_ext)
                        top = hi
                        if ax.pure_dim is not None:
                            top = hi + ax.stride * (ns.extent(ax.pure_dim) - 1)
                        if g.base[j] is None:
                            g.base[j], g.span[j] = lo, top - lo + 1
                        else:
                            new_base = min(g.base[j], lo)
                            new_top = max(g.base[j] + g.span[j] - 1, top)
                            g.base[j], g.span[j] = new_base, new_top - new_base + 1

        for g in groups:
            if g.blocked_axis is not None:
                g.base[g.blocked_axis] = g.k0
            if g.lane_axis is not None:
                g.base[g.lane_axis] = g.l0

        # -- collapse shifted delivery classes into ring streams -------------
        rings: List[RingStream] = []
        if use_rings and kernel_streamed:
            groups, rings, gmap, ring_map = _ring_rewrite(groups, e0_out, banned)
            if ring_map:
                for sp in plans.values():
                    for li, binding in enumerate(sp.view_binding):
                        kept: Dict[BindKey, int] = {}
                        for bk, gi in binding.items():
                            if gi in ring_map:
                                sp.ring_binding[li][bk] = ring_map[gi]
                            else:
                                kept[bk] = gmap[gi]
                        sp.view_binding[li] = kept
        if use_lane_rings and lane and kernel_streamed:
            groups, lrings, lgmap, lring_map = _lane_ring_rewrite(
                groups, e0_out, e1_out, set(lane_banned)
            )
            if lring_map:
                nr0 = len(rings)
                for sp in plans.values():
                    for li, binding in enumerate(sp.view_binding):
                        kept2: Dict[BindKey, int] = {}
                        for bk, gi in binding.items():
                            if gi in lring_map:
                                r, t0 = lring_map[gi]
                                sp.ring_binding[li][bk] = (nr0 + r, t0)
                            else:
                                kept2[bk] = lgmap[gi]
                        sp.view_binding[li] = kept2
            rings = rings + lrings

        # -- grid reductions: keep small invariant operands whole in VMEM ----
        # (chunk re-delivery once per row panel is pure refetch traffic)
        if red_grid is not None and red_resident:
            for g in groups:
                if (
                    g.blocked_axis is None and g.red_axis is not None
                    and not g.pinned
                    and ELEM_BYTES * math.prod(g.span) <= vmem_budget // 4
                ):
                    g.resident = True

        # bounds inference guarantees accesses stay inside producer boxes;
        # check anyway so a planning bug fails loudly, not as a mis-slice
        for g in groups:
            shape = buffer_shapes[g.buffer]
            for j in range(g.ndim):
                if j == g.blocked_axis:
                    rows = g.rows0 if g.pinned else e0_out
                    top = g.k0 + g.stride0 * (rows - 1)
                elif j == g.lane_axis:
                    cols = g.cols0 if g.lane_pinned else e1_out
                    top = g.l0 + g.lane_stride * (cols - 1)
                else:
                    top = g.base[j] + g.span[j] - 1
                if g.base[j] < 0 or top >= shape[j]:
                    raise UnsupportedAccessError(
                        f"view of {g.buffer} axis {j} [{g.base[j]}, {top}] "
                        f"exceeds extent {shape[j]}"
                    )

        # -- VMEM accounting + block height ----------------------------------
        inner_shape = list(out_ns.pure_extents[1:])
        if lane and inner_shape:
            inner_shape[-1] = bw
        inner_out = math.prod(inner_shape) if inner_shape else 1
        bytes_per_row = inner_out * ELEM_BYTES      # the output panel
        fixed_bytes = 0
        for g in groups:
            sz = ELEM_BYTES * math.prod(
                (g.cols0 if g.lane_pinned else bw) if j == g.lane_axis else (
                    (g.span[j] if g.resident else g.red_chunk)
                    if j == g.red_axis else g.span[j]
                )
                for j in range(g.ndim) if j != g.blocked_axis
            )
            if g.pinned:
                fixed_bytes += g.rows0 * sz
            elif g.blocked_axis is not None:
                bytes_per_row += sz
            elif g.lane_axis is not None:
                # a lane-only stream is re-delivered (double-buffered) every
                # grid step but does not scale with the block height
                fixed_bytes += 2 * sz
            else:
                fixed_bytes += sz
        for r in rings:
            if r.lane:
                # column ring (bh, ..., bw + halo): the whole ring scales
                # with the block height; there is no bh-independent part
                inner = math.prod(
                    r.span[j] for j in range(r.ndim)
                    if j != r.axis and j != r.row_axis
                )
                bytes_per_row += (bw + r.halo) * inner * ELEM_BYTES
                continue
            inner = math.prod(
                r.span[j] for j in range(r.ndim) if j != r.axis
            )
            bytes_per_row += inner * ELEM_BYTES     # ring body scales with bh
            fixed_bytes += r.halo * inner * ELEM_BYTES
        scratch_rows = 0                            # scratch scales with bh too
        for ns, _, _ in members[:-1]:
            sp = plans[ns.name]
            sh = list(ns.pure_extents[1:])
            if lane and sh:
                sh[-1] = bw
            inner = math.prod(sh) if sh else 1
            if sp.line_buffer is not None and sp.line_buffer.lane:
                # one (bh, ..., bw + halo) column ring per demanded row shift
                shl = list(ns.pure_extents[1:])
                shl[-1] = bw + sp.line_buffer.halo
                scratch_rows += len(sp.shifts) * math.prod(shl)
            elif sp.line_buffer is not None:
                scratch_rows += inner
                fixed_bytes += sp.line_buffer.halo * inner * ELEM_BYTES
            else:
                scratch_rows += len(sp.shifts) * len(sp.lane_shifts) * inner
        bytes_per_row += scratch_rows * ELEM_BYTES

        # the scheduler cost closure is built for *every* streamed kernel
        # (not just model-chosen block heights): explicit-block_h plans and
        # every lane-width candidate get their ``model_cycles`` recorded,
        # which is what the joint (bh, bw) selection below and the
        # autotuner's pruning stage rank candidates by.  ``bh_priced``
        # (set in the notes) records whether the block height itself was
        # chosen by the model — the recompute-vs-carry arbitration only
        # trusts cycle comparisons between model-chosen heights, exactly
        # as before.
        cost = None
        if kernel_streamed and cost_model == "scheduler":
            stmts_per_row = 0
            carry_stmts = 0
            warmup_stmts = 0
            carry_stmts_per_row = 0
            lane_warmup_stmts = 0
            rotate = 0.0
            for ns, _, _ in members:
                sp = plans[ns.name]
                sh = list(ns.pure_extents[1:])
                if lane and sh:
                    sh[-1] = bw
                inner = math.prod(sh) if sh else 1
                red = math.prod(ns.red_extents) if ns.red_dims else 1
                if red_grid is not None:
                    red = (red // ns.red_extents[0]) * red_grid.chunk
                if sp.line_buffer is not None and sp.line_buffer.lane:
                    # per lane step: one bw-wide panel per demanded row
                    # shift, plus a per-lane-step ring rotation (scaling
                    # with bh) and a per-row-step halo-wide warm-up
                    inner_mid = math.prod(ns.pure_extents[1:-1])
                    stmts_per_row += len(sp.shifts) * inner * red
                    carry_stmts_per_row += (
                        len(sp.shifts) * sp.line_buffer.halo * inner_mid
                    )
                    lane_warmup_stmts += (
                        len(sp.shifts) * sp.line_buffer.halo * inner_mid * red
                    )
                elif sp.line_buffer is not None:
                    stmts_per_row += inner * red
                    carry_stmts += sp.line_buffer.halo * inner
                    warmup_stmts += sp.line_buffer.halo * inner * red
                else:
                    stmts_per_row += (
                        len(sp.shifts) * len(sp.lane_shifts) * inner * red
                    )
            for r in rings:
                if r.lane:
                    # column-ring rotation copies bh * halo * inner elements
                    # per lane step — scales with the block height
                    inner = math.prod(
                        r.span[j] for j in range(r.ndim)
                        if j != r.axis and j != r.row_axis
                    )
                    carry_stmts_per_row += r.halo * inner
                    continue
                inner = math.prod(
                    r.span[j] for j in range(r.ndim) if j != r.axis
                )
                elems = r.halo * inner
                if r.stride0 == 1:
                    # contiguous rotation: a lane-wide VMEM move that
                    # overlaps the raster on the memory side
                    carry_stmts += elems
                else:
                    # strided rotation cannot coalesce into wide vector
                    # moves: serial element shuffles on top of the
                    # raster, plus the per-step branch machinery
                    rotate += float(elems) + RING_STEP_OVERHEAD_CYCLES
            latency = max(_stage_latency(ns) for ns, _, _ in members)
            # grid dims beyond the row dim multiply the steady-state step
            # count: lane blocks sweep every row panel once per lane step,
            # and a grid reduction revisits each row panel once per chunk
            # step (stmts_per_row above already counts only the in-chunk
            # terms).  Pricing them makes model_cycles comparable across
            # (bw, red_chunk) candidates — narrower blocks / smaller
            # chunks pay for their extra grid steps.
            steps_mult = 1
            if lane:
                steps_mult = _cdiv(e1_out, bw)
            elif red_grid is not None:
                steps_mult = red_grid.steps
            cost = scheduler_cost(
                e0_out, stmts_per_row, latency, bytes_per_row, fixed_bytes,
                carry_stmts=carry_stmts, warmup_stmts=warmup_stmts,
                rotate_cycles=rotate,
                lane_steps=steps_mult,
                carry_stmts_per_row=carry_stmts_per_row,
                lane_warmup_stmts=lane_warmup_stmts,
            )
        if not kernel_streamed:
            bh = e0_out
        elif block_h is not None:
            if block_h < 1:
                raise ValueError(f"{out_ns.name}: block_h must be >= 1")
            # any block height plans: a non-divisor runs on a padded grid
            # whose masked tail block hangs past the edge (blocks above the
            # extent degenerate to one padded step, so clamp to the extent)
            bh = min(block_h, e0_out)
        else:
            bh = plan_affine_stage(
                e0_out, bytes_per_row, fixed_bytes,
                vmem_budget=vmem_budget, cost=cost, align_tpu=align_tpu,
            )

        panels: Optional[WeightPanels] = None
        chain: Optional[HiddenChain] = None
        window: Optional[WindowAttention] = None
        # a window-attention tile is planned against shared memory even where
        # the working-set model could hold it: its kernel holds one head's
        # tile, whatever the model would double-buffer
        tile_shaped = multi and window_shape([plans[ns.name] for ns, _, _ in members]) is not None
        if multi and (2 * bytes_per_row * bh + fixed_bytes > vmem_budget or tile_shaped):
            staged = None if lane else _weight_panels(
                members, plans, groups, rings, red_grid,
                vmem_budget=vmem_budget, block_h=block_h, cost=cost,
                align_tpu=align_tpu,
            )
            if staged is not None:
                panels, bytes_per_row, fixed_bytes, bh = staged
            else:
                chained = None if lane else _hidden_chain(
                    members, plans, groups, rings, red_grid,
                    vmem_budget=vmem_budget, block_h=block_h,
                )
                tiled = None if lane or chained is not None else _window_attention(
                    members, plans, groups, rings, red_grid,
                    vmem_budget=vmem_budget, block_h=block_h,
                )
                if chained is not None:
                    chain, bytes_per_row, fixed_bytes, bh = chained
                elif tiled is not None:
                    window, bytes_per_row, fixed_bytes, bh = tiled
                else:
                    raise FusionInfeasible(
                        f"group ending at {out_ns.name}: live range exceeds VMEM budget"
                    )

        padded_grid: Optional[PaddedGrid] = None
        lane_grid: Optional[PaddedGrid] = None
        if kernel_streamed:
            steps0 = _cdiv(e0_out, bh)
            grid: Tuple[int, ...] = (steps0,)
            if steps0 * bh != e0_out:
                padded_grid = PaddedGrid(e0_out, bh, steps0)
            if lane:
                steps1 = _cdiv(e1_out, bw)
                grid = (steps0, steps1)
                lane_grid = PaddedGrid(e1_out, bw, steps1)
        else:
            grid = (1,)
        if red_grid is not None:
            grid = grid + (red_grid.steps,)

        notes: Dict[str, object] = {
            "cost_model": cost_model if kernel_streamed else "degenerate"
        }
        if cost is not None:
            notes["model_cycles"] = cost(bh)
            notes["bh_priced"] = block_h is None
        return KernelGroup(
            stages=[plans[ns.name] for ns, _, _ in members],
            groups=groups,
            bh=bh,
            grid=grid,
            red_grid=red_grid,
            padded_grid=padded_grid,
            rings=rings,
            notes=notes,
            bw=bw if lane else None,
            lane_grid=lane_grid,
            ws=(bytes_per_row, fixed_bytes),
            panels=panels,
            chain=chain,
            window=window,
        )

    # -- mode selection: recompute fusion vs cross-grid-step carry -----------
    want_rings = line_buffer is not False
    # upper bound of any legal block height (plan_affine_stage's candidate
    # cap): a stage whose halo exceeds it can never carry
    if block_h is not None:
        bh_cap = min(block_h, e0_out)
    else:
        bh_cap = affine_stage_bh_cap(e0_out)
    lb_capable: Tuple[str, ...] = ()
    if multi and want_rings and kernel_streamed:
        lb_capable = tuple(
            ns.name for ns, _, _ in members[:-1]
            if len(shifts_of[ns.name]) >= 2
            and shifts_of[ns.name][-1] - shifts_of[ns.name][0] <= bh_cap
        )

    def attempt(lb_names: Sequence[str], use_rings: bool) -> KernelGroup:
        # carry feasibility (halo <= bh) depends on the chosen block height,
        # which depends on the carry decisions — iterate, shedding stages
        # and ring classes whose halo the selected block cannot cover
        lb = set(lb_names)
        banned: Set[Tuple] = set()
        for _ in range(len(members) + 8):
            kg = assemble(lb, use_rings, banned)
            bad_lb = {
                sp.name for sp in kg.stages[:-1]
                if sp.line_buffer is not None and sp.line_buffer.halo > kg.bh
            }
            bad_rings = {r.key for r in kg.rings if r.halo > kg.bh}
            if not bad_lb and not bad_rings:
                return kg
            lb -= bad_lb
            banned |= bad_rings
        return assemble(set(), False, set())

    def plan_no_lane() -> KernelGroup:
        if not want_rings:
            return attempt((), False)
        try:
            kg_lb = attempt(lb_capable, True)
        except FusionInfeasible:
            # carry bookkeeping cannot fit where plain recompute fusion might
            return attempt((), False)
        if line_buffer is True:
            return kg_lb
        if not kg_lb.line_buffered and not kg_lb.rings:
            return kg_lb
        # carry-vs-recompute arbitration only trusts cycle comparisons
        # between *model-chosen* block heights (``bh_priced``); an explicit
        # block_h still records model_cycles (for the autotuner) but keeps
        # the PR 4 carry-unpriced preference below
        c_lb = (
            kg_lb.notes.get("model_cycles")
            if kg_lb.notes.get("bh_priced") else None
        )
        if c_lb is None:
            # no scheduler pricing (explicit block_h / other cost model):
            # carry is strictly less traffic and at most equal compute, so
            # prefer it and record the choice was not cost-arbitrated
            kg_lb.notes["linebuf_mode"] = "carry-unpriced"
            return kg_lb
        try:
            kg_rc = attempt((), False)
        except FusionInfeasible:
            return kg_lb
        c_rc = (
            kg_rc.notes.get("model_cycles")
            if kg_rc.notes.get("bh_priced") else None
        )
        if c_rc is not None:
            # recompute must be cheaper by more than one step's fixed
            # overhead (sub-overhead differences are model noise) to justify
            # its extra HBM traffic; at comparable cycles the carry plan's
            # traffic wins
            meaningfully_cheaper = c_rc < c_lb - STEP_OVERHEAD_CYCLES
            cheaper_and_no_worse = (
                c_rc < c_lb and kg_rc.hbm_bytes() <= kg_lb.hbm_bytes()
            )
            if meaningfully_cheaper or cheaper_and_no_worse:
                kg_rc.notes["linebuf_mode"] = "recompute-cheaper"
                return kg_rc
        return kg_lb

    # -- lane blocking: explicit block_w, or VMEM-driven auto engagement -----
    # lane-blocked kernels carry *columns*: row rings and row line buffers
    # cannot survive a lane grid (between two visits of one row panel every
    # other lane step clobbers the ring), so the carry machinery pivots to
    # the lane axis — per-row-shift column rings for fused intermediates
    # and per-lane-step column ring streams for shifted input deliveries,
    # priced against lane recompute exactly as the row modes are
    lane_lb_capable: Tuple[str, ...] = ()
    if multi and want_rings and kernel_streamed and lane_shifts_of is not None:
        lane_lb_capable = tuple(
            ns.name for ns, _, _ in members[:-1]
            if len(lane_shifts_of[ns.name]) >= 2
        )

    def attempt_lane_carry(bw: int) -> KernelGroup:
        # column-carry feasibility (halo <= bw) is known up front — the
        # lane block width is fixed per attempt — but ring classes are not
        # enumerated until assembly, so iterate the same shed loop rows use
        llb = {
            n for n in lane_lb_capable
            if lane_shifts_of[n][-1] - lane_shifts_of[n][0] <= bw
        }
        shed: Set[str] = set(lane_lb_capable) - llb
        lane_banned: Set[Tuple] = set()
        for _ in range(len(members) + 8):
            kg = assemble(
                set(), False, set(), bw=bw,
                lane_lb_names=llb, use_lane_rings=True,
                lane_banned=lane_banned,
            )
            bad_lb = {
                sp.name for sp in kg.stages[:-1]
                if sp.line_buffer is not None and sp.line_buffer.lane
                and sp.line_buffer.halo > bw
            }
            bad_rings = {r.key for r in kg.rings if r.lane and r.halo > bw}
            if not bad_lb and not bad_rings:
                if shed or lane_banned:
                    kg.notes["lane_carry_shed"] = {
                        "stages": sorted(shed),
                        "ring_classes": len(lane_banned),
                    }
                return kg
            llb -= bad_lb
            shed |= bad_lb
            lane_banned |= bad_rings
        return assemble(set(), False, set(), bw=bw)

    def attempt_lane(bw: int) -> KernelGroup:
        def tag(kg: KernelGroup, reason: str) -> KernelGroup:
            kg.notes["lane"] = "forced" if block_w is not None else "auto-vmem"
            kg.notes["lane_carry"] = reason
            return kg

        if not want_rings:
            return tag(assemble(set(), False, set(), bw=bw), "carry-disabled")
        if _cdiv(e1_out, bw) < 2:
            # one lane step has no step to carry columns *across*: a ring
            # would tie recompute on every metric, so don't plan one
            return tag(
                assemble(set(), False, set(), bw=bw), "single-lane-step"
            )
        try:
            kg_lb = attempt_lane_carry(bw)
        except FusionInfeasible:
            return tag(
                assemble(set(), False, set(), bw=bw), "carry-infeasible"
            )
        carried = bool(kg_lb.rings) or any(
            sp.line_buffer is not None for sp in kg_lb.stages
        )
        if not carried:
            reason = (
                "halo-exceeds-bw" if "lane_carry_shed" in kg_lb.notes
                else "nothing-to-carry"
            )
            return tag(kg_lb, reason)
        if line_buffer is True:
            return tag(kg_lb, "carried")
        # same arbitration contract as plan_no_lane: only trust cycle
        # comparisons between model-chosen block heights; prefer carry
        # (strictly less traffic) when unpriced
        c_lb = (
            kg_lb.notes.get("model_cycles")
            if kg_lb.notes.get("bh_priced") else None
        )
        if c_lb is None:
            kg_lb.notes["linebuf_mode"] = "carry-unpriced"
            return tag(kg_lb, "carried")
        try:
            kg_rc = assemble(set(), False, set(), bw=bw)
        except FusionInfeasible:
            return tag(kg_lb, "carried")
        c_rc = (
            kg_rc.notes.get("model_cycles")
            if kg_rc.notes.get("bh_priced") else None
        )
        if c_rc is not None:
            meaningfully_cheaper = c_rc < c_lb - STEP_OVERHEAD_CYCLES
            cheaper_and_no_worse = (
                c_rc < c_lb and kg_rc.hbm_bytes() <= kg_lb.hbm_bytes()
            )
            if meaningfully_cheaper or cheaper_and_no_worse:
                kg_rc.notes["linebuf_mode"] = "recompute-cheaper"
                return tag(kg_rc, "recompute-cheaper")
        return tag(kg_lb, "carried")

    if block_w is not None:
        if lane_possible:
            bw_eff = min(block_w, e1_out)
            if align_tpu:
                # emission-time lane rounding: the emitted blocks themselves
                # are 128-lane multiples (masked lane tail), not just the
                # aligned_blocks() report
                bw_eff = _cdiv(bw_eff, LANE) * LANE
            return attempt_lane(bw_eff)
        # structurally no lane dim to block (rank-1, unstreamed, or a grid
        # reduction owns dim 1): plan flat, but say so in the plan notes
        # instead of dropping the request silently
        kg = plan_no_lane()
        kg.notes["lane"] = "unsupported"
        return kg

    def overflows(kg: KernelGroup) -> bool:
        bpr, fixed = kg.ws
        # a chain's or window tile's working set counts what its kernel
        # allocates, once
        live = (1 if kg.chain is not None or kg.window is not None else 2) * bpr * kg.bh + fixed
        return kernel_streamed and live > vmem_budget

    kg_flat: Optional[KernelGroup] = None
    try:
        kg_flat = plan_no_lane()
    except FusionInfeasible:
        if not lane_possible:
            raise
    if kg_flat is not None and not (lane_possible and overflows(kg_flat)):
        return kg_flat
    # even a one-row full-width panel exceeds the budget (or fusion only
    # fits lane-blocked): tile the lane dim.  ``lane_price="greedy"`` keeps
    # the PR 5 behavior — widest fitting block wins, first fit returned.
    # ``"joint"`` (default) builds *every* fitting (bh, bw) pair —
    # ``attempt_lane`` re-runs block-height selection per width, and
    # ``model_cycles`` now scales with the lane-step count — and keeps the
    # modeled-cheapest, tie-broken toward less HBM traffic then wider
    # blocks.  128-lane multiples (the wide-fetch FW of paper Eq. 2) are
    # preferred as a *pool* whenever any fits, so pricing never trades a
    # hardware-tileable width for a sub-cycle modeling difference — the
    # same budget-beats-alignment rule as plan_affine_stage.
    fitting: List[KernelGroup] = []
    for bw_cand in lane_width_candidates(e1_out, order=lane_price):
        try:
            kg2 = attempt_lane(bw_cand)
        except FusionInfeasible:
            continue
        if overflows(kg2):
            continue
        if lane_price == "greedy":
            return kg2
        fitting.append(kg2)
    if fitting:
        aligned = [kg for kg in fitting if kg.bw % LANE == 0]
        pool = aligned or fitting
        best = min(pool, key=lambda kg: (
            kg.notes.get("model_cycles", float("inf")),
            kg.hbm_bytes(),
            -kg.bw,
        ))
        best.notes["lane_price"] = "joint"
        return best
    if kg_flat is not None:
        return kg_flat
    raise FusionInfeasible(
        f"group ending at {out_ns.name}: no lane-blocked plan fits VMEM"
    )


# ---------------------------------------------------------------------------
# Pipeline planning (fusion grouping + per-group builds)
# ---------------------------------------------------------------------------


# producers a fusion trial that fails may take along at once, where only
# a chain they complete fits (:func:`_chain_lookahead`)
CHAIN_LOOKAHEAD = 3


def _chain_lookahead(trial: Set[str], order: Sequence[str], consumers: Mapping[str, List[str]],
                     members: Mapping[str, List[str]], by_name: Mapping[str, Tuple],
                     shapes: Mapping[str, Tuple[int, ...]], build_kw: Mapping[str, object],
                     ) -> Optional[Set[str]]:
    """A fusion trial that fails may fit once the producers of a chain join
    it too: a chain's consumer alone beside its output overflows the
    working-set model, while the whole chain walks its hidden axis in
    panels (:class:`HiddenChain`; e.g. Swin's MLP, whose rows of 28
    positions are twice ConvNeXt's).  Add, one at a time in reverse
    topological order, up to ``CHAIN_LOOKAHEAD`` producers still alone in
    their groups whose consumers all lie in the trial, and return the first
    trial that plans as a chain, or None."""
    trial = set(trial)
    for _ in range(CHAIN_LOOKAHEAD):
        nxt = next((n for n in reversed(order) if n not in trial and members.get(n) == [n]
                    and consumers.get(n) and set(consumers[n]) <= trial
                    and not by_name[n][0].on_host), None)
        if nxt is None:
            return None
        trial.add(nxt)
        try:
            kg = _build_kernel_group([by_name[n] for n in order if n in trial], shapes, **build_kw)
        except (FusionInfeasible, UnsupportedAccessError, ValueError):
            continue
        if kg.chain is not None:
            return trial
    return None


def build_pipeline_plan(
    pipe: Pipeline,
    *,
    block_h: Optional[int] = None,
    block_w: Optional[int] = None,
    lane_block: object = "auto",
    fuse: bool = True,
    grid_reduction: bool = True,
    red_grid_threshold: int = RED_GRID_THRESHOLD,
    vmem_budget: int = VMEM_BYTES,
    cost_model: str = "scheduler",
    align_tpu: bool = False,
    line_buffer: object = "auto",
    red_resident: bool = True,
    batch: Optional[int] = None,
    batch_capacity: Optional[int] = None,
    red_chunk: Optional[int] = None,
    lane_price: str = "joint",
) -> PipelinePlan:
    """``batch=N`` plans a leading grid dim sweeping N independent tiles
    through one ``pallas_call`` per kernel group: every input buffer (and
    every kernel output) gains a leading batch dim, the per-tile plan —
    views, rings, scratch, block heights — is reused unchanged per batch
    step, and ring / line-buffer warm-ups re-fire at each batch boundary
    (reset, not re-allocate: the VMEM footprint is batch-invariant).
    ``batch_capacity`` (default ``batch``) sizes the grid in *slots*: a
    plan with ``batch < batch_capacity`` is a ragged final batch whose
    padded slots are masked to exact zeros, so one capacity-sized compile
    serves any occupancy up to it.

    ``red_chunk`` and ``lane_price`` are schedule knobs surfaced for the
    autotuner (``backend/autotune``): the grid-reduction chunk size and
    the budget-driven lane-width policy (``"joint"`` scheduler-priced
    (bh, bw) selection, ``"greedy"`` the historical widest-first fit) —
    see :func:`_build_kernel_group`."""
    if batch_capacity is not None and batch is None:
        raise ValueError("batch_capacity requires batch")
    if batch is not None:
        if batch < 1:
            raise ValueError(f"batch must be >= 1: {batch}")
        if batch_capacity is None:
            batch_capacity = batch
        elif batch_capacity < batch:
            raise ValueError(
                f"batch_capacity {batch_capacity} < batch {batch}"
            )
    nstages = normalize_pipeline(pipe)
    shapes = {n: tuple(b.extents) for n, b in pipe.buffer_boxes.items()}
    infos = []
    for ns in nstages:
        if ns.init is not None and refs_in(ns.init):
            raise UnsupportedAccessError(
                f"{ns.name}: reduction init with buffer reads is not supported"
            )
        accesses = decompose_stage(ns)
        infos.append((ns, accesses, _stream_ok(accesses, ns.pure_dims[0])))
    by_name = {ns.name: info for info in infos for ns in [info[0]]}

    # consumer map over every stage (host stages pin their inputs in HBM)
    consumers: Dict[str, List[str]] = {}
    for ns, acc, _ in infos:
        for la in acc:
            if la.buffer in by_name:
                consumers.setdefault(la.buffer, []).append(ns.name)

    order = [ns.name for ns, _, _ in infos]
    device = [n for n in order if not by_name[n][0].on_host]
    assign = {n: n for n in order}               # stage -> fusion-group root
    members: Dict[str, List[str]] = {n: [n] for n in order}

    build_kw = dict(
        block_h=block_h, block_w=block_w, lane_block=lane_block,
        vmem_budget=vmem_budget,
        cost_model=cost_model,
        align_tpu=align_tpu, grid_reduction=grid_reduction,
        red_grid_threshold=red_grid_threshold,
        line_buffer=line_buffer, red_resident=red_resident,
        red_chunk=red_chunk, lane_price=lane_price,
    )

    def group_infos(root: str) -> List[Tuple]:
        return [by_name[n] for n in order if n in set(members[root])]

    if fuse:
        for name in reversed(device):
            cons = consumers.get(name, [])
            if not cons or name == pipe.output:
                continue
            if any(by_name[c][0].on_host for c in cons):
                continue                         # host consumers read HBM
            roots = {assign[c] for c in cons}
            if len(roots) != 1:
                continue
            root = roots.pop()
            # reverse-topo iteration means `name` is still a singleton root
            # here; try the enlarged group and commit only if it plans
            trial = set(members[root]) | {name}
            try:
                _build_kernel_group(
                    [by_name[n] for n in order if n in trial],
                    shapes, **build_kw,
                )
            except (FusionInfeasible, UnsupportedAccessError, ValueError):
                trial = _chain_lookahead(trial, order, consumers, members, by_name,
                                         shapes, build_kw)
                if trial is None:
                    continue
            for n in trial - set(members[root]):
                members[root].append(n)
                assign[n] = root
                del members[n]

    kernels = []
    for name in order:
        if assign[name] != name or name not in members:
            continue
        kernels.append(_build_kernel_group(group_infos(name), shapes, **build_kw))
    # a window tile's windows, and those its mask splits into regions
    for kg in kernels:
        if kg.window is not None:
            windows, masked = window_masked(kg)
            kg.window = dataclasses.replace(kg.window, windows=windows, masked=masked)
    notes = {
        "fuse": fuse, "grid_reduction": grid_reduction,
        "cost_model": cost_model, "vmem_budget": vmem_budget,
        "align_tpu": align_tpu, "line_buffer": line_buffer,
        "red_resident": red_resident, "block_w": block_w,
        "red_chunk": red_chunk, "lane_price": lane_price,
    }
    if batch is not None:
        # the batch dim is a post-processing step over finished per-tile
        # kernel groups: fusion trials, block-height pricing, and VMEM
        # budgeting all ran on the per-tile problem, and the batch axis is
        # prepended as the slowest-varying grid dim — so the inner row
        # step cycles once per slot and every step-0 warm-up re-fires per
        # batch element by construction
        bg = PaddedGrid(extent=batch, block=1, steps=batch_capacity)
        for kg in kernels:
            kg.batch_grid = bg
            kg.grid = (batch_capacity,) + kg.grid
        notes["batch"] = batch
        notes["batch_capacity"] = batch_capacity
    return PipelinePlan(pipe, nstages, kernels, notes=notes)


__all__ = [
    "ELEM_BYTES",
    "HBM_BYTES_PER_CYCLE",
    "STEP_OVERHEAD_CYCLES",
    "RED_GRID_THRESHOLD",
    "FusionInfeasible",
    "LineBuffer",
    "RingStream",
    "ViewGroup",
    "StagePlan",
    "RedGrid",
    "WeightPanels",
    "HiddenChain",
    "WindowAttention",
    "window_shape",
    "CHAIN_THREADS",
    "CHAIN_TILE_MAX",
    "chain_reuse",
    "chain_shape",
    "chain_tile_shape",
    "chain_times",
    "hidden_tile_shape",
    "staged_bytes",
    "staged_strides",
    "PaddedGrid",
    "KernelGroup",
    "PipelinePlan",
    "scheduler_cost",
    "build_pipeline_plan",
]
