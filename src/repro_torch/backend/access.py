"""Affine access decomposition for Stage -> Pallas code generation.

A normalized stage's load is an affine map from zero-based stage dims to
zero-based producer elements.  The Pallas backend supports the access class
Halide loop nests actually produce after lowering (and that the paper's
unified-buffer extraction handles): every producer axis is indexed by

    stride * pure_dim  +  sum_r coeff_r * red_dim_r  +  const

with at most one pure dim per axis and a positive stride.  This covers
stencil taps (``y + dy``), rate changes (``2*y + dy``), rolled reductions
(``y + ry``), broadcast weights (reduction/constant-only axes), and matmul
operands.  Anything outside the class raises :class:`UnsupportedAccessError`
with a precise reason, so callers can fall back to the reference interpreter
or the CGRA simulator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.poly import AffineExpr, AffineMap
from repro_torch.frontend.lower import NormalizedStage

from .errors import PlanError


class UnsupportedAccessError(PlanError, NotImplementedError):
    """Access map outside the backend's affine class."""

    code = "PLAN-ACCESS"


@dataclass(frozen=True)
class AxisAccess:
    """One producer-axis index expression, decomposed."""

    pure_dim: Optional[str]             # at most one pure dim per axis
    stride: int                         # coeff of pure_dim; 1 when absent
    red_coeffs: Tuple[Tuple[str, int], ...]
    const: int

    def offset_at(self, rho: Mapping[str, int]) -> int:
        """Axis offset once the reduction point ``rho`` is fixed."""
        return self.const + sum(c * rho[r] for r, c in self.red_coeffs)

    def offset_range(self, red_extents: Mapping[str, int]) -> Tuple[int, int]:
        """Exact [min, max] of the offset over the reduction box."""
        lo = hi = self.const
        for r, c in self.red_coeffs:
            span = c * (red_extents[r] - 1)
            if span >= 0:
                hi += span
            else:
                lo += span
        return lo, hi

    def offsets(self, red_extents: Mapping[str, int]) -> List[int]:
        """All offset values the axis takes over the reduction box."""
        vals = [self.const]
        for r, c in self.red_coeffs:
            vals = [v + c * k for v in vals for k in range(red_extents[r])]
        return sorted(set(vals))


@dataclass(frozen=True)
class LoadAccess:
    """A load's access map as per-axis decompositions (producer loop order)."""

    buffer: str
    axes: Tuple[AxisAccess, ...]

    def element_at(self, point: Mapping[str, int]) -> Tuple[int, ...]:
        out = []
        for ax in self.axes:
            e = ax.offset_at(point)
            if ax.pure_dim is not None:
                e += ax.stride * point[ax.pure_dim]
            out.append(e)
        return tuple(out)


def decompose_axis(
    expr: AffineExpr, pure_dims: Sequence[str], red_dims: Sequence[str]
) -> AxisAccess:
    pure: Optional[str] = None
    stride = 1
    reds: List[Tuple[str, int]] = []
    for name, coeff in expr.coeffs:
        if coeff == 0:
            continue
        if name in red_dims:
            reds.append((name, coeff))
        elif name in pure_dims:
            if pure is not None:
                raise UnsupportedAccessError(
                    f"axis {expr!r} mixes pure dims {pure} and {name}"
                )
            if coeff < 0:
                raise UnsupportedAccessError(
                    f"axis {expr!r} has negative stride on {name}"
                )
            pure, stride = name, coeff
        else:
            raise UnsupportedAccessError(f"axis {expr!r} uses unknown dim {name}")
    return AxisAccess(pure, stride, tuple(reds), expr.const)


def decompose_load(
    buffer: str, acc: AffineMap, pure_dims: Sequence[str], red_dims: Sequence[str]
) -> LoadAccess:
    return LoadAccess(
        buffer, tuple(decompose_axis(e, pure_dims, red_dims) for e in acc.exprs)
    )


def decompose_stage(nstage: NormalizedStage) -> List[LoadAccess]:
    """Decompose every load of a normalized stage (refs_in order)."""
    return [
        decompose_load(buf, acc, nstage.pure_dims, nstage.red_dims)
        for buf, acc in nstage.loads
    ]


__all__ = [
    "UnsupportedAccessError",
    "AxisAccess",
    "LoadAccess",
    "decompose_axis",
    "decompose_load",
    "decompose_stage",
]
