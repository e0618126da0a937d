"""Unified-buffer planning for Pallas TPU kernels.

This is the TPU re-targeting of the paper's buffer-mapping step (DESIGN.md
§2): a Pallas ``(grid, BlockSpec)`` pair *is* a physical unified buffer —

  * the grid is the port's **iteration domain**,
  * ``BlockSpec.index_map`` is the **access map** (in block units),
  * Pallas's implicit software pipeline is the **schedule** (each grid step
    issues the next block's DMA while computing the current one — exactly
    the AGG/TB double buffering of paper §IV-B),
  * the VMEM block is the **wide fetch**: lane width 128 plays the role of
    the fetch width FW, so the vectorization rule of Eq. 2 becomes "tile the
    innermost dim to a multiple of 128 (and the sublane dim to 8/16)".

``plan_*`` functions do what ``mapping.py`` does for the CGRA: pick block
shapes such that the double-buffered working set fits the VMEM budget, with
hardware-aligned MXU dims, and report the resulting unified-buffer structure
for introspection.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# TPU v5e-class constants (see DESIGN.md §2)
VMEM_BYTES = 96 * 1024 * 1024          # usable VMEM budget (conservative)
LANE = 128                             # vector lane width == wide-fetch FW
SUBLANE = {2: 16, 4: 8}                # min sublane tile by dtype bytes
MXU = 128                              # systolic array edge

# NVIDIA H100: the most shared memory one thread block may use (227 KB of
# the SM's 256 KB, opted into as dynamic shared memory).  The port's
# kernels keep exactly the plan's VMEM scratch in shared memory, so this is
# the port's default planning budget.
H100_SMEM_PER_BLOCK = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_pow2(x: int, lo: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return max(p, lo)


@dataclass
class StreamPlan:
    """One operand's HBM->VMEM push stream (a physical unified buffer)."""

    name: str
    block: Tuple[int, ...]
    grid_axes: Tuple[int, ...]          # which grid dims advance this stream
    bytes_per_block: int
    double_buffered: bool = True

    @property
    def vmem_bytes(self) -> int:
        return self.bytes_per_block * (2 if self.double_buffered else 1)


@dataclass
class KernelPlan:
    grid: Tuple[int, ...]
    streams: List[StreamPlan]
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def vmem_bytes(self) -> int:
        return sum(s.vmem_bytes for s in self.streams)

    def fits(self, budget: int = VMEM_BYTES) -> bool:
        return self.vmem_bytes <= budget


# ---------------------------------------------------------------------------
# generic stage planning (backend codegen: plan from affine access structure)
# ---------------------------------------------------------------------------


def affine_stage_bh_cap(
    grid_extent: int, max_bh: int = 256, prefer_stream: bool = True
) -> int:
    """Largest block height :func:`plan_affine_stage` will ever consider for
    ``grid_extent`` — the candidate cap shared with the backend planner,
    which pre-filters carry decisions (a line-buffer halo larger than this
    can never fit under ``halo <= bh``)."""
    cap = min(max_bh, grid_extent)
    if prefer_stream and grid_extent > 8:
        cap = min(cap, max(grid_extent // 4, 8))
    return max(cap, 1)


def plan_affine_stage(
    grid_extent: int,
    bytes_per_row: int,
    fixed_bytes: int,
    *,
    vmem_budget: int = VMEM_BYTES,
    max_bh: int = 256,
    prefer_stream: bool = True,
    cost: Optional[Callable[[int], float]] = None,
    align_tpu: bool = False,
    allow_padding: bool = True,
) -> int:
    """Pick the block height for a generated stage kernel.

    The backend streams row panels of the outermost pure loop dim through
    VMEM; ``bytes_per_row`` is the double-buffered working set that scales
    with the block height (blocked input streams, the output panel, and the
    ``bh``-proportional body of any cross-grid-step line-buffer ring) and
    ``fixed_bytes`` the block-height-independent residents: broadcast views
    (weights, whole buffers, VMEM-resident reduction operands), the carried
    halo rows of line-buffer rings, and their pinned warm-up views.  Ring
    placement is therefore budget-checked here, by the same ``2 *
    bytes_per_row * bh + fixed_bytes <= vmem_budget`` feasibility rule as
    the recompute-fusion scratch it replaces.

    The extent here comes from a stage's iteration domain, which is rarely
    a power of two (e.g. 62 for a 64-input 3x3 stencil).  Any block height
    is a candidate: non-divisor blocks run on a *padded grid* of
    ``ceil(extent / bh)`` steps whose last block hangs past the edge (the
    backend masks it — see ``backend/plan.PaddedGrid``).  Padding is not
    free: the tail block is delivered and computed in full, so selection
    charges each candidate for the rows ``ceil(e/bh)*bh - e`` of padded
    work.  ``allow_padding=False`` restores the divisor-only candidate set
    for callers that need exact tiling.  ``prefer_stream`` caps the block
    at a quarter of the extent so pipelines actually exercise the
    multi-step push schedule instead of degenerating to one giant block.

    ``cost`` is the scheduler hook: a map from candidate block height to
    modeled cycles (see ``backend/plan.scheduler_cost``, which prices the
    padded tail step like any other step).  When given, the block height is
    the cheapest VMEM-fitting candidate; ties break toward less padding,
    then the larger block.  Without a cost hook the choice minimizes grid
    steps first and padding waste second, which reduces to the old
    "largest fitting divisor" rule whenever a dividing block can match the
    step count.

    ``align_tpu`` restricts candidates to sublane multiples (8 rows for
    f32) when any such block fits the budget, so compiled (non-interpret)
    TPU mode gets hardware-tileable panels; with padding allowed an aligned
    candidate almost always exists (62 rows -> 8-row blocks on an 8-step
    padded grid), and the VMEM guarantee always wins over alignment.
    """
    cap = affine_stage_bh_cap(grid_extent, max_bh, prefer_stream)
    if allow_padding:
        candidates = list(range(cap, 0, -1))
    else:
        candidates = [d for d in range(cap, 0, -1) if grid_extent % d == 0] or [1]

    def fits(bh: int) -> bool:
        return 2 * bytes_per_row * bh + fixed_bytes <= vmem_budget

    def steps(bh: int) -> int:
        return -(-grid_extent // bh)

    def waste(bh: int) -> int:
        return steps(bh) * bh - grid_extent

    fitting = [bh for bh in candidates if fits(bh)]
    if align_tpu:
        sub = SUBLANE[4]
        aligned = [bh for bh in fitting if bh % sub == 0]
        if aligned:
            fitting = aligned
    if not fitting:
        return 1
    if cost is None:
        return min(fitting, key=lambda bh: (steps(bh), waste(bh), -bh))
    return min(fitting, key=lambda bh: (cost(bh), waste(bh), -bh))


def lane_width_candidates(lane_extent: int, *, order: str = "greedy") -> List[int]:
    """Candidate lane-block widths for a 2-D (row x lane) grid.

    ``order="greedy"`` (default) is the original engagement list, widest
    first: every multiple of the 128-lane vector width below the extent
    (the wide-fetch FW of paper Eq. 2 — a lane block is a whole number of
    wide fetches), then power-of-two fallbacks (all < 128, so the two
    pools are disjoint) as the escape hatch of last resort.  Because the
    128-multiples lead, budget-driven engagement naturally lands on a
    lane-tileable width whenever one fits, and falls through to narrower
    blocks only to honour the VMEM guarantee — the same
    budget-beats-alignment rule as :func:`plan_affine_stage`.

    ``order="joint"`` is the candidate *pool* for joint (bh, bw) pricing
    (``backend/plan``'s scheduler-model lane selection and the autotuner):
    a superset of the greedy list that also yields the ceil-division
    widths ``ceil(extent / s)`` for small step counts ``s`` — the
    low-padding splits a narrow extent actually wants, which the
    128-multiple/power-of-two-only list cannot express (e.g. extent 96
    gains 48 and 32-adjacent 24, extent 300 gains 150/100/75...).  Still
    sorted widest first so greedy consumers of the pool stay monotone.

    Widths >= the extent are excluded — they are the degenerate "full
    width resident" plan the lane grid exists to avoid."""
    mults = list(range((lane_extent - 1) // LANE * LANE, 0, -LANE))
    small = [w for w in (64, 32, 16, 8, 4, 2, 1) if w < lane_extent]
    if order == "greedy":
        return (mults + small) or [1]
    if order != "joint":
        raise ValueError(f"order must be 'greedy' or 'joint': {order!r}")
    pool = set(mults) | set(small)
    for s in range(2, 9):
        w = -(-lane_extent // s)
        if 0 < w < lane_extent:
            pool.add(w)
    return sorted(pool, reverse=True) or [1]


def align_tpu_shape(shape: Sequence[int], dtype_bytes: int = 4) -> Tuple[int, ...]:
    """Round a block shape up to TPU tile granularity: the minor (lane) dim
    to a multiple of 128 and the second-minor (sublane) dim to the dtype's
    sublane quantum (8 for f32, 16 for bf16) — the vectorization rule of
    paper Eq. 2 with lane width as the fetch width FW.  Rank-0/1 shapes only
    align the dims they have."""
    out = list(shape)
    if not out:
        return tuple(out)
    out[-1] = _round_up(out[-1], LANE)
    if len(out) >= 2:
        out[-2] = _round_up(out[-2], SUBLANE.get(dtype_bytes, 8))
    return tuple(out)


# ---------------------------------------------------------------------------
# matmul: (M, K) x (K, N) -> (M, N)
# ---------------------------------------------------------------------------


def plan_matmul(
    m: int,
    n: int,
    k: int,
    dtype_bytes: int = 2,
    vmem_budget: int = VMEM_BYTES,
    out_bytes: int = 4,
) -> KernelPlan:
    """Block selection for the tiled matmul, unified-buffer style.

    Strategy (the paper's capacity/bandwidth trade): start from MXU-aligned
    maximal square-ish blocks and shrink the K block first (it only affects
    pipelining depth, not output locality), then N, then M.
    """
    sub = SUBLANE.get(dtype_bytes, 8)
    bm = min(_round_up(m, sub), 512)
    bn = min(_round_up(n, LANE), 512)
    bk = min(_round_up(k, LANE), 2048)

    def mk() -> KernelPlan:
        grid = (math.ceil(m / bm), math.ceil(n / bn), math.ceil(k / bk))
        streams = [
            StreamPlan("lhs", (bm, bk), (0, 2), bm * bk * dtype_bytes),
            StreamPlan("rhs", (bk, bn), (2, 1), bk * bn * dtype_bytes),
            StreamPlan("acc", (bm, bn), (0, 1), bm * bn * out_bytes),
            StreamPlan("out", (bm, bn), (0, 1), bm * bn * dtype_bytes),
        ]
        return KernelPlan(grid, streams, {"bm": bm, "bn": bn, "bk": bk})

    plan = mk()
    while not plan.fits(vmem_budget):
        if bk > LANE:
            bk //= 2
        elif bn > LANE:
            bn //= 2
        elif bm > sub:
            bm //= 2
        else:
            break
        plan = mk()
    return plan


# ---------------------------------------------------------------------------
# flash attention: Q (B*H, S, D) with KV (B*Hkv, S, D)
# ---------------------------------------------------------------------------


def plan_attention(
    seq_q: int,
    seq_kv: int,
    head_dim: int,
    dtype_bytes: int = 2,
    vmem_budget: int = VMEM_BYTES,
) -> KernelPlan:
    bq = min(_round_down_pow2(seq_q, 1), 512)
    bkv = min(_round_down_pow2(seq_kv, 1), 1024)
    d = head_dim

    def mk() -> KernelPlan:
        grid = (math.ceil(seq_q / bq), math.ceil(seq_kv / bkv))
        streams = [
            StreamPlan("q", (bq, d), (0,), bq * d * dtype_bytes),
            StreamPlan("k", (bkv, d), (1,), bkv * d * dtype_bytes),
            StreamPlan("v", (bkv, d), (1,), bkv * d * dtype_bytes),
            StreamPlan("scores", (bq, bkv), (0, 1), bq * bkv * 4, double_buffered=False),
            StreamPlan("acc", (bq, d), (0,), bq * d * 4, double_buffered=False),
            StreamPlan("out", (bq, d), (0,), bq * d * dtype_bytes),
        ]
        return KernelPlan(grid, streams, {"bq": bq, "bkv": bkv})

    plan = mk()
    while not plan.fits(vmem_budget):
        if bkv > LANE:
            bkv //= 2
        elif bq > 16:
            bq //= 2
        else:
            break
        plan = mk()
    return plan


# ---------------------------------------------------------------------------
# 2-D stencil over row panels
# ---------------------------------------------------------------------------


def plan_stencil(
    height: int,
    width: int,
    halo: int,
    dtype_bytes: int = 4,
    vmem_budget: int = VMEM_BYTES,
) -> KernelPlan:
    bh = min(_round_down_pow2(height, 8), 256)

    def mk() -> KernelPlan:
        grid = (math.ceil(height / bh),)
        streams = [
            StreamPlan(f"rows+{r}", (bh, width + 2 * halo), (0,),
                       bh * (width + 2 * halo) * dtype_bytes)
            for r in range(2 * halo + 1)
        ] + [StreamPlan("out", (bh, width), (0,), bh * width * dtype_bytes)]
        return KernelPlan(grid, streams, {"bh": bh})

    plan = mk()
    while not plan.fits(vmem_budget) and bh > 8:
        bh //= 2
        plan = mk()
    if not plan.fits(vmem_budget):
        # last resort: give up DMA/compute overlap (single-buffered streams)
        for s in plan.streams:
            s.double_buffered = False
        plan.notes["single_buffered"] = True
    return plan


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan
# ---------------------------------------------------------------------------


def plan_ssd(
    seq: int,
    heads: int,
    head_dim: int,
    state: int,
    chunk: int = 256,
    dtype_bytes: int = 2,
    vmem_budget: int = VMEM_BYTES,
) -> KernelPlan:
    c = min(chunk, seq)

    def mk() -> KernelPlan:
        grid = (math.ceil(seq / c),)
        streams = [
            StreamPlan("x", (c, heads * head_dim), (0,), c * heads * head_dim * dtype_bytes),
            StreamPlan("b", (c, state), (0,), c * state * dtype_bytes),
            StreamPlan("cc", (c, state), (0,), c * state * dtype_bytes),
            StreamPlan("dt", (c, heads), (0,), c * heads * 4),
            StreamPlan("state", (heads, head_dim, state), (), heads * head_dim * state * 4,
                       double_buffered=False),
            StreamPlan("y", (c, heads * head_dim), (0,), c * heads * head_dim * dtype_bytes),
        ]
        return KernelPlan(grid, streams, {"chunk": c})

    plan = mk()
    while not plan.fits(vmem_budget) and c > 16:
        c //= 2
        plan = mk()
    return plan


__all__ = [
    "VMEM_BYTES",
    "LANE",
    "MXU",
    "SUBLANE",
    "StreamPlan",
    "KernelPlan",
    "affine_stage_bh_cap",
    "plan_affine_stage",
    "lane_width_candidates",
    "align_tpu_shape",
    "plan_matmul",
    "plan_attention",
    "plan_stencil",
    "plan_ssd",
]
