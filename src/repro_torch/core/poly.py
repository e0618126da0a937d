"""Restricted polyhedral model for unified-buffer analysis.

The paper (§III) represents each unified-buffer port with three polyhedral
objects implemented there with ISL:

  * an *iteration domain*  — set of statement instances using the port,
  * an *access map*        — iteration point -> buffer element,
  * a *schedule*           — iteration point -> scalar cycle after reset.

Halide loop nests (after tiling) produce dense rectangular iteration domains
and affine access maps/schedules, so we implement a restricted — but exact
for this program class — polyhedral model:

  * ``Box``       : dense rectangular integer domain  (product of intervals)
  * ``AffineExpr``: integer-affine expression over named dims
  * ``AffineMap`` : tuple of AffineExpr outputs over a shared dim tuple

Quasi-affine operations needed by the paper's *vectorization* transform
(Eq. 2: ``(x, y) -> (x mod FW, floor(x/FW), y)``) are realized by rewriting
the *domain* (strip-mining: substitute ``x = xo*FW + xi``) so every derived
object stays purely affine.  This mirrors how the paper's compiler itself
introduces a new aggregation dimension rather than manipulating mods.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Affine expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AffineExpr:
    """Integer-affine expression  ``sum_i coeff[d_i] * d_i + const``."""

    coeffs: Tuple[Tuple[str, int], ...] = ()
    const: int = 0

    # -- construction -------------------------------------------------------
    @staticmethod
    def var(name: str) -> "AffineExpr":
        return AffineExpr(((name, 1),), 0)

    @staticmethod
    def constant(c: int) -> "AffineExpr":
        return AffineExpr((), int(c))

    @staticmethod
    def of(obj) -> "AffineExpr":
        if isinstance(obj, AffineExpr):
            return obj
        if isinstance(obj, int):
            return AffineExpr.constant(obj)
        if isinstance(obj, str):
            return AffineExpr.var(obj)
        raise TypeError(f"cannot coerce {obj!r} to AffineExpr")

    # -- views ---------------------------------------------------------------
    def coeff_dict(self) -> Dict[str, int]:
        return dict(self.coeffs)

    def coeff(self, name: str) -> int:
        return self.coeff_dict().get(name, 0)

    @property
    def dims(self) -> Tuple[str, ...]:
        return tuple(n for n, c in self.coeffs if c != 0)

    def is_constant(self) -> bool:
        return all(c == 0 for _, c in self.coeffs)

    # -- algebra -------------------------------------------------------------
    @staticmethod
    def _norm(d: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
        return tuple(sorted((k, v) for k, v in d.items() if v != 0))

    def __add__(self, other) -> "AffineExpr":
        other = AffineExpr.of(other)
        d = self.coeff_dict()
        for k, v in other.coeffs:
            d[k] = d.get(k, 0) + v
        return AffineExpr(self._norm(d), self.const + other.const)

    __radd__ = __add__

    def __neg__(self) -> "AffineExpr":
        return AffineExpr(tuple((k, -v) for k, v in self.coeffs), -self.const)

    def __sub__(self, other) -> "AffineExpr":
        return self + (-AffineExpr.of(other))

    def __rsub__(self, other) -> "AffineExpr":
        return AffineExpr.of(other) + (-self)

    def __mul__(self, k: int) -> "AffineExpr":
        if not isinstance(k, int):
            raise TypeError("AffineExpr may only be scaled by integers")
        return AffineExpr(tuple((n, c * k) for n, c in self.coeffs), self.const * k)

    __rmul__ = __mul__

    def __eq__(self, other) -> bool:  # structural equality after normalization
        if not isinstance(other, AffineExpr):
            return NotImplemented
        return self._norm(self.coeff_dict()) == other._norm(other.coeff_dict()) and (
            self.const == other.const
        )

    def __hash__(self) -> int:
        return hash((self._norm(self.coeff_dict()), self.const))

    # -- evaluation / substitution -------------------------------------------
    def eval(self, point: Mapping[str, int]) -> int:
        total = self.const
        for name, c in self.coeffs:
            total += c * point[name]
        return total

    def substitute(self, subst: Mapping[str, "AffineExpr"]) -> "AffineExpr":
        """Replace dims with affine expressions (used by strip-mining/fusion)."""
        out = AffineExpr.constant(self.const)
        for name, c in self.coeffs:
            repl = subst.get(name)
            if repl is None:
                out = out + AffineExpr(((name, c),), 0)
            else:
                out = out + AffineExpr.of(repl) * c
        return out

    def rename(self, mapping: Mapping[str, str]) -> "AffineExpr":
        return AffineExpr(
            AffineExpr._norm({mapping.get(n, n): c for n, c in self.coeffs}),
            self.const,
        )

    # -- ranges ---------------------------------------------------------------
    def range_over(self, box: "Box") -> Tuple[int, int]:
        """Exact [min, max] of the expression over a box domain."""
        lo = hi = self.const
        for name, c in self.coeffs:
            a, b = box.bounds(name)
            if c >= 0:
                lo += c * a
                hi += c * b
            else:
                lo += c * b
                hi += c * a
        return lo, hi

    def __repr__(self) -> str:
        parts = []
        for n, c in self.coeffs:
            if c == 1:
                parts.append(n)
            elif c == -1:
                parts.append(f"-{n}")
            else:
                parts.append(f"{c}*{n}")
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts).replace("+ -", "- ")


# ---------------------------------------------------------------------------
# Box domains
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Box:
    """Dense rectangular integer domain.

    ``dims``    — ordered dim names, **outermost first** (Halide loop order).
    ``intervals`` — matching (lo, hi) *inclusive* bounds.
    """

    dims: Tuple[str, ...]
    intervals: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        if len(self.dims) != len(self.intervals):
            raise ValueError("dims/intervals length mismatch")
        for (lo, hi), d in zip(self.intervals, self.dims):
            if lo > hi:
                raise ValueError(f"empty interval for {d}: [{lo}, {hi}]")

    @staticmethod
    def make(**bounds: Tuple[int, int]) -> "Box":
        return Box(tuple(bounds.keys()), tuple(bounds.values()))

    @staticmethod
    def from_extents(dims: Sequence[str], extents: Sequence[int]) -> "Box":
        return Box(tuple(dims), tuple((0, e - 1) for e in extents))

    # -- queries ---------------------------------------------------------------
    def bounds(self, name: str) -> Tuple[int, int]:
        return self.intervals[self.dims.index(name)]

    def extent(self, name: str) -> int:
        lo, hi = self.bounds(name)
        return hi - lo + 1

    @property
    def extents(self) -> Tuple[int, ...]:
        return tuple(hi - lo + 1 for lo, hi in self.intervals)

    def size(self) -> int:
        return math.prod(self.extents)

    def contains(self, point: Mapping[str, int]) -> bool:
        return all(lo <= point[d] <= hi for d, (lo, hi) in zip(self.dims, self.intervals))

    def points(self) -> Iterable[Dict[str, int]]:
        """Iterate lexicographically (outer dims slowest), matching loop order."""
        ranges = [range(lo, hi + 1) for lo, hi in self.intervals]
        for combo in itertools.product(*ranges):
            yield dict(zip(self.dims, combo))

    # -- transforms -------------------------------------------------------------
    def rename(self, mapping: Mapping[str, str]) -> "Box":
        return Box(tuple(mapping.get(d, d) for d in self.dims), self.intervals)

    def drop(self, name: str) -> "Box":
        i = self.dims.index(name)
        return Box(self.dims[:i] + self.dims[i + 1 :], self.intervals[:i] + self.intervals[i + 1 :])

    def insert(self, index: int, name: str, lo: int, hi: int) -> "Box":
        return Box(
            self.dims[:index] + (name,) + self.dims[index:],
            self.intervals[:index] + ((lo, hi),) + self.intervals[index:],
        )

    def intersect(self, other: "Box") -> Optional["Box"]:
        if self.dims != other.dims:
            raise ValueError("intersect requires identical dim tuples")
        ivs = []
        for (a, b), (c, d) in zip(self.intervals, other.intervals):
            lo, hi = max(a, c), min(b, d)
            if lo > hi:
                return None
            ivs.append((lo, hi))
        return Box(self.dims, tuple(ivs))

    def intersects(self, other: "Box") -> bool:
        """Emptiness test on the intersection (Boxes themselves are always
        non-empty by construction, so emptiness only arises from set
        operations: an empty intersection here, an empty difference below)."""
        return self.intersect(other) is not None

    def difference(self, other: "Box") -> List["Box"]:
        """``self \\ other`` as a list of *disjoint* boxes (possibly empty).

        Standard slab decomposition: walk the dims outermost-first, carving
        off the below/above slabs on each dim with every earlier dim already
        clamped to the intersection, so the pieces partition the difference
        exactly.  An empty list means ``self`` is covered by ``other``."""
        if self.dims != other.dims:
            raise ValueError("difference requires identical dim tuples")
        inter = self.intersect(other)
        if inter is None:
            return [self]
        out: List["Box"] = []
        clamped: List[Tuple[int, int]] = []
        for i in range(len(self.dims)):
            lo, hi = self.intervals[i]
            ilo, ihi = inter.intervals[i]
            rest = self.intervals[i + 1:]
            if lo < ilo:
                out.append(Box(self.dims, tuple(clamped) + ((lo, ilo - 1),) + rest))
            if ihi < hi:
                out.append(Box(self.dims, tuple(clamped) + ((ihi + 1, hi),) + rest))
            clamped.append((ilo, ihi))
        return out

    def covers(self, other: "Box") -> bool:
        """True iff ``other \\ self`` is empty (``other`` ⊆ ``self``)."""
        return not other.difference(self)

    def hull(self, other: "Box") -> "Box":
        if self.dims != other.dims:
            raise ValueError("hull requires identical dim tuples")
        return Box(
            self.dims,
            tuple(
                (min(a, c), max(b, d))
                for (a, b), (c, d) in zip(self.intervals, other.intervals)
            ),
        )

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{lo} <= {d} <= {hi}" for d, (lo, hi) in zip(self.dims, self.intervals)
        )
        return f"{{ ({', '.join(self.dims)}) : {inner} }}"


# ---------------------------------------------------------------------------
# Affine maps
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AffineMap:
    """Affine map  (d_0, ..., d_n) -> (e_0(d), ..., e_m(d))."""

    in_dims: Tuple[str, ...]
    exprs: Tuple[AffineExpr, ...]

    @staticmethod
    def make(in_dims: Sequence[str], exprs: Sequence) -> "AffineMap":
        return AffineMap(tuple(in_dims), tuple(AffineExpr.of(e) for e in exprs))

    @staticmethod
    def identity(dims: Sequence[str]) -> "AffineMap":
        return AffineMap(tuple(dims), tuple(AffineExpr.var(d) for d in dims))

    @property
    def n_out(self) -> int:
        return len(self.exprs)

    # -- application --------------------------------------------------------------
    def eval(self, point: Mapping[str, int]) -> Tuple[int, ...]:
        return tuple(e.eval(point) for e in self.exprs)

    def compose(self, inner: "AffineMap", out_names: Sequence[str]) -> "AffineMap":
        """self ∘ inner: first apply ``inner``, then ``self``.

        ``out_names`` names inner's outputs so they can bind to self's in_dims
        (must equal ``self.in_dims`` in order).
        """
        if tuple(out_names) != self.in_dims:
            raise ValueError(f"inner outputs {out_names} must match {self.in_dims}")
        subst = dict(zip(self.in_dims, inner.exprs))
        return AffineMap(inner.in_dims, tuple(e.substitute(subst) for e in self.exprs))

    def substitute(self, subst: Mapping[str, AffineExpr]) -> "AffineMap":
        new_in: List[str] = []
        seen = set()
        for d in self.in_dims:
            repl = subst.get(d)
            names = repl.dims if repl is not None else (d,)
            for n in names:
                if n not in seen:
                    seen.add(n)
                    new_in.append(n)
        return AffineMap(tuple(new_in), tuple(e.substitute(subst) for e in self.exprs))

    def rename_inputs(self, mapping: Mapping[str, str]) -> "AffineMap":
        return AffineMap(
            tuple(mapping.get(d, d) for d in self.in_dims),
            tuple(e.rename(mapping) for e in self.exprs),
        )

    # -- analysis -------------------------------------------------------------------
    def range_box(self, box: Box, out_dims: Optional[Sequence[str]] = None) -> Box:
        """Per-output-dim exact interval hull of the image of ``box``."""
        names = tuple(out_dims) if out_dims else tuple(f"o{i}" for i in range(self.n_out))
        return Box(names, tuple(e.range_over(box) for e in self.exprs))

    def image(self, box: Box, out_dims: Optional[Sequence[str]] = None) -> Box:
        """Image of ``box`` under the map, as a Box over the output dims.

        For this restricted model the per-output interval hull *is* the
        rectangular hull of the true image, and each axis interval is tight
        (``AffineExpr.range_over`` is exact over a box).  The hull
        over-approximates the image only when outputs are correlated
        through shared input dims — which makes it a *sound* basis for
        bounds checking: ``image ⊆ extents`` proves every accessed element
        is in bounds, and a witness corner of ``image \\ extents`` is a
        per-axis-reachable out-of-bounds coordinate."""
        return self.range_box(box, out_dims)

    def matrix(self) -> List[List[int]]:
        """Coefficient matrix, rows = outputs, cols = in_dims (no constant)."""
        return [[e.coeff(d) for d in self.in_dims] for e in self.exprs]

    def constants(self) -> List[int]:
        return [e.const for e in self.exprs]

    def try_invert(self) -> Optional["AffineMap"]:
        """Exact inverse for square maps with invertible integer matrix whose
        inverse is also integral (unimodular or diagonal-divisible).  Returns
        None when no integral affine inverse exists."""
        n = len(self.in_dims)
        if self.n_out != n:
            return None
        mat = [[Fraction(v) for v in row] for row in self.matrix()]
        # Build augmented [mat | I] and Gauss-Jordan over rationals.
        aug = [row[:] + [Fraction(int(i == j)) for j in range(n)] for i, row in enumerate(mat)]
        for col in range(n):
            piv = next((r for r in range(col, n) if aug[r][col] != 0), None)
            if piv is None:
                return None
            aug[col], aug[piv] = aug[piv], aug[col]
            pv = aug[col][col]
            aug[col] = [v / pv for v in aug[col]]
            for r in range(n):
                if r != col and aug[r][col] != 0:
                    f = aug[r][col]
                    aug[r] = [a - f * b for a, b in zip(aug[r], aug[col])]
        inv = [row[n:] for row in aug]
        if any(v.denominator != 1 for row in inv for v in row):
            return None
        consts = self.constants()
        out_names = tuple(f"t{i}" for i in range(n))
        exprs = []
        for i in range(n):
            e = AffineExpr.constant(-sum(int(inv[i][j]) * consts[j] for j in range(n)))
            for j in range(n):
                e = e + AffineExpr.var(out_names[j]) * int(inv[i][j])
            exprs.append(e)
        return AffineMap(out_names, tuple(exprs))

    def __repr__(self) -> str:
        return f"({', '.join(self.in_dims)}) -> ({', '.join(map(repr, self.exprs))})"


# ---------------------------------------------------------------------------
# Schedules (1-D affine cycle maps, paper §III Eq. 1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Schedule:
    """Cycle-accurate schedule: iteration point -> cycles after reset.

    The paper's schedules map multi-dimensional iteration domains to *scalar*
    cycle counts (e.g. ``(x, y) -> 64y + x``), unlike classic multidimensional
    polyhedral schedules.
    """

    expr: AffineExpr
    domain: Box

    def at(self, point: Mapping[str, int]) -> int:
        return self.expr.eval(point)

    def first_cycle(self) -> int:
        return self.expr.range_over(self.domain)[0]

    def last_cycle(self) -> int:
        return self.expr.range_over(self.domain)[1]

    def is_injective_per_cycle(self) -> bool:
        """True when no two points in the domain share a cycle (port conflict
        freedom).  Holds iff strides form a 'mixed-radix' system covering the
        extents; checked exactly on small domains, by stride analysis otherwise."""
        if self.domain.size() <= 4096:
            seen = set()
            for p in self.domain.points():
                t = self.at(p)
                if t in seen:
                    return False
                seen.add(t)
            return True
        # stride analysis: sort dims by |coeff| ascending; each coeff must be >=
        # span of all smaller dims + 1 (sufficient condition).
        items = sorted(
            ((abs(self.expr.coeff(d)), self.domain.extent(d)) for d in self.domain.dims
             if self.domain.extent(d) > 1),
        )
        span = 0
        for coeff, extent in items:
            if coeff == 0 or coeff <= span:
                return False
            span += coeff * (extent - 1)
        return True

    def __repr__(self) -> str:
        return f"sched[{self.expr!r} over {self.domain!r}]"


# ---------------------------------------------------------------------------
# Strip-mining (the vectorization rewrite of paper Eq. 2)
# ---------------------------------------------------------------------------


def strip_mine_box(box: Box, dim: str, factor: int, outer: str, inner: str) -> Box:
    """Split ``dim`` (extent must be divisible by ``factor``) into
    ``outer``*factor + ``inner``; outer replaces dim's position, inner is the
    new innermost dimension of the pair."""
    lo, hi = box.bounds(dim)
    extent = hi - lo + 1
    if extent % factor != 0:
        raise ValueError(f"extent {extent} of {dim} not divisible by {factor}")
    if lo != 0:
        raise ValueError("strip-mining requires zero-based dims (normalize first)")
    i = box.dims.index(dim)
    dims = list(box.dims)
    ivs = list(box.intervals)
    dims[i] = outer
    ivs[i] = (0, extent // factor - 1)
    dims.insert(i + 1, inner)
    ivs.insert(i + 1, (0, factor - 1))
    return Box(tuple(dims), tuple(ivs))


def strip_mine_subst(dim: str, factor: int, outer: str, inner: str) -> Dict[str, AffineExpr]:
    """Substitution ``dim -> outer*factor + inner`` for affine rewriting."""
    return {dim: AffineExpr.var(outer) * factor + AffineExpr.var(inner)}


# ---------------------------------------------------------------------------
# Set operations (functional spellings of the Box/AffineMap methods; the
# plan verifier composes these: access-map image over the full grid domain,
# differenced against the declared extents, empty == proven in bounds)
# ---------------------------------------------------------------------------


def map_image(m: AffineMap, box: Box, out_dims: Optional[Sequence[str]] = None) -> Box:
    """Image of ``box`` under ``m`` (see :meth:`AffineMap.image`)."""
    return m.image(box, out_dims)


def box_difference(a: Box, b: Box) -> List[Box]:
    """``a \\ b`` as disjoint boxes; empty list iff ``a`` ⊆ ``b``."""
    return a.difference(b)


def boxes_intersect(a: Box, b: Box) -> bool:
    """Non-emptiness of ``a ∩ b``."""
    return a.intersects(b)


# ---------------------------------------------------------------------------
# Dependence analysis
# ---------------------------------------------------------------------------


def dependence_distance(
    write_access: AffineMap,
    write_sched: Schedule,
    read_access: AffineMap,
    read_sched: Schedule,
) -> Optional[int]:
    """Constant cycle distance between producing and consuming a value.

    For a read at iteration ``i`` touching element ``A_r(i)``, the producing
    write iteration is ``j = A_w^{-1}(A_r(i))``; the distance is
    ``S_r(i) - S_w(j)``.  Returns the constant distance if it is independent
    of ``i`` (the shift-register condition, paper §V-C), else None.
    """
    inv = write_access.try_invert()
    if inv is None:
        return None
    # j = inv(A_r(i)) : express write iteration dims as affine exprs of read dims
    j_exprs = inv.compose(read_access, inv.in_dims)
    # S_w(j) as affine function of read iteration dims
    subst = dict(zip(write_sched.domain.dims, j_exprs.exprs))
    s_w_of_i = write_sched.expr.substitute(subst)
    dist = read_sched.expr - s_w_of_i
    if not dist.is_constant():
        return None
    return dist.const


def max_dependence_distance(
    write_access: AffineMap,
    write_sched: Schedule,
    read_access: AffineMap,
    read_sched: Schedule,
) -> Optional[int]:
    """Max over the read domain of the (possibly varying) write->read
    distance; None if the write access map is not invertible."""
    inv = write_access.try_invert()
    if inv is None:
        return None
    j_exprs = inv.compose(read_access, inv.in_dims)
    subst = dict(zip(write_sched.domain.dims, j_exprs.exprs))
    dist = read_sched.expr - write_sched.expr.substitute(subst)
    return dist.range_over(read_sched.domain)[1]


def live_values_bound(
    write_sched: Schedule,
    read_scheds: Sequence[Schedule],
    write_access: AffineMap,
    read_accesses: Sequence[AffineMap],
) -> int:
    """Upper bound on simultaneously-live values (storage minimization).

    With a single streaming write port at initiation interval II_w, the number
    of live values is bounded by ``ceil(max_distance / II_w)`` — the paper's
    line-buffer sizing rule (e.g. 64 live pixels for the 64-cycle delay in
    the brighten/blur example).  Falls back to exhaustive counting on small
    domains when distances are not analyzable.
    """
    distances: List[int] = []
    for acc, sched in zip(read_accesses, read_scheds):
        d = max_dependence_distance(write_access, write_sched, acc, sched)
        if d is None:
            distances = []
            break
        distances.append(max(d, 0))
    if distances:
        # write initiation interval = min gap between consecutive writes
        ii = _min_schedule_gap(write_sched)
        max_d = max(distances)
        return max(1, -(-max_d // max(ii, 1)) + 1)
    # exhaustive fallback (small domains only)
    events: List[Tuple[int, int]] = []
    writes = {}
    for p in write_sched.domain.points():
        writes[write_access.eval(p)] = write_sched.at(p)
    last_read: Dict[Tuple[int, ...], int] = {}
    for acc, sched in zip(read_accesses, read_scheds):
        for p in sched.domain.points():
            e = acc.eval(p)
            t = sched.at(p)
            last_read[e] = max(last_read.get(e, t), t)
    for e, tw in writes.items():
        tr = last_read.get(e)
        if tr is None:
            continue
        events.append((tw, 1))
        events.append((tr + 1, -1))
    events.sort()
    live = peak = 0
    for _, delta in events:
        live += delta
        peak = max(peak, live)
    return max(peak, 1)


def _min_schedule_gap(sched: Schedule) -> int:
    """Smallest positive gap between consecutive issue cycles of a schedule
    (the effective initiation interval of the port)."""
    coeffs = [
        abs(sched.expr.coeff(d))
        for d in sched.domain.dims
        if sched.domain.extent(d) > 1 and sched.expr.coeff(d) != 0
    ]
    return min(coeffs) if coeffs else 1


__all__ = [
    "AffineExpr",
    "AffineMap",
    "Box",
    "Schedule",
    "map_image",
    "box_difference",
    "boxes_intersect",
    "strip_mine_box",
    "strip_mine_subst",
    "dependence_distance",
    "max_dependence_distance",
    "live_values_bound",
]
