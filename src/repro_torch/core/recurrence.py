"""Affine address/schedule generation as a recurrence relation (paper Fig. 5c).

A naive AddressGenerator computes ``sum_i s_i * d_i + offset`` with one
multiplier per loop dim (Fig. 5a).  The optimized hardware keeps a single
running register and, on each counter step, adds the *delta* of the outermost
loop variable that incremented:

    d_outer = s_outer - sum_{i inner} s_i * (r_i - 1)

This module produces those configuration constants (the "configuration bits"
buffer mapping must emit) and provides a pure-software model of the
single-adder datapath, which the tests check against the affine expression —
the paper's key hardware optimization, verified exhaustively.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

from .poly import AffineExpr, Box


@dataclass(frozen=True)
class AGConfig:
    """Configuration of one IterationDomain + AddressGenerator pair.

    Dims are in loop order (outermost first); the hardware counter steps the
    innermost dim fastest.
    """

    dims: Tuple[str, ...]
    ranges: Tuple[int, ...]       # extents r_i
    strides: Tuple[int, ...]      # affine coefficients s_i
    offset: int                   # affine constant at the domain origin
    deltas: Tuple[int, ...]       # recurrence deltas d_i (Fig. 5c)

    @property
    def words(self) -> int:
        out = 1
        for r in self.ranges:
            out *= r
        return out


def make_ag(expr: AffineExpr, box: Box) -> AGConfig:
    """Compile an affine schedule/address expression into the recurrence
    configuration of Fig. 5c."""
    dims = box.dims
    strides = tuple(expr.coeff(d) for d in dims)
    # offset = value at the domain origin
    origin = {d: box.bounds(d)[0] for d in dims}
    offset = expr.eval(origin)
    ranges = box.extents
    deltas: List[int] = []
    for i in range(len(dims)):
        inner = range(i + 1, len(dims))
        d_i = strides[i] - sum(strides[j] * (ranges[j] - 1) for j in inner)
        deltas.append(d_i)
    return AGConfig(dims, ranges, strides, offset, tuple(deltas))


def ag_values(cfg: AGConfig) -> Iterator[int]:
    """Software model of the optimized single-adder datapath: a mixed-radix
    counter plus one running register updated by the delta of the outermost
    incremented variable."""
    n = len(cfg.ranges)
    counters = [0] * n
    addr = cfg.offset
    total = cfg.words
    for _ in range(total):
        yield addr
        # increment innermost-first; find the outermost variable that
        # increments this step (all inner ones wrap)
        k = n - 1
        while k >= 0 and counters[k] == cfg.ranges[k] - 1:
            counters[k] = 0
            k -= 1
        if k < 0:
            return  # domain exhausted
        counters[k] += 1
        addr += cfg.deltas[k]


def ag_matches_affine(expr: AffineExpr, box: Box) -> bool:
    """Exhaustive equivalence check: recurrence datapath == affine function."""
    cfg = make_ag(expr, box)
    it = ag_values(cfg)
    for p in box.points():
        if next(it) != expr.eval(p):
            return False
    return True


__all__ = ["AGConfig", "make_ag", "ag_values", "ag_matches_affine"]
