"""Cycle model of the paper's scheduler (§V-B), the part the planner needs.

A verbatim copy of ``_raster`` and ``raster_cycles`` from the JAX package's
``core/scheduling.py``: ``backend/plan.scheduler_cost`` prices candidate
block heights with ``raster_cycles``.  The stencil, DNN and sequential
schedulers themselves are not part of the port yet.
"""

from __future__ import annotations

from typing import Sequence

from .poly import AffineExpr, Box


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


__all__ = ["raster_cycles"]
