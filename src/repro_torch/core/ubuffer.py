"""The unified buffer abstraction (paper §III).

A unified buffer is described *only* in terms of its ports.  Each port is
specified by a polyhedral triple:

  * iteration domain — the statement instances that use the port,
  * access map       — iteration point -> buffer element touched,
  * schedule         — iteration point -> cycle (after reset) of the access.

Physical capacity and data placement are deliberately absent: they are derived
by the mapping backend (``mapping.py``).  The abstraction also defines the
*stream semantics* used to validate any physical implementation: a mapped
design is correct iff it produces the same (cycle, value) stream on every
output port as the abstract specification.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .poly import (
    AffineExpr,
    AffineMap,
    Box,
    Schedule,
    dependence_distance,
    live_values_bound,
    max_dependence_distance,
)

IN = "in"
OUT = "out"


@dataclass(frozen=True)
class Port:
    """One unified-buffer port (paper Fig. 2)."""

    name: str
    direction: str  # IN | OUT
    domain: Box
    access: AffineMap
    schedule: Schedule
    width: int = 1  # words moved per access (vectorized ports > 1)

    def __post_init__(self):
        if self.direction not in (IN, OUT):
            raise ValueError(f"bad port direction {self.direction}")
        if self.domain.dims != self.schedule.domain.dims:
            raise ValueError(
                f"port {self.name}: schedule domain dims {self.schedule.domain.dims} "
                f"!= iteration domain dims {self.domain.dims}"
            )

    # -- stream semantics ---------------------------------------------------
    def events(self) -> Iterable[Tuple[int, Tuple[int, ...], Dict[str, int]]]:
        """Yield (cycle, element, iteration point) for every access, in
        iteration order."""
        for p in self.domain.points():
            yield self.schedule.at(p), self.access.eval(p), p

    def first_cycle(self) -> int:
        return self.schedule.expr.range_over(self.domain)[0]

    def last_cycle(self) -> int:
        return self.schedule.expr.range_over(self.domain)[1]

    def touched_box(self, out_dims: Optional[Sequence[str]] = None) -> Box:
        """Interval hull of buffer elements touched through this port."""
        return self.access.range_box(self.domain, out_dims)

    def with_delay(self, delay: int) -> "Port":
        return replace(
            self,
            schedule=Schedule(self.schedule.expr + delay, self.schedule.domain),
        )


@dataclass
class UnifiedBuffer:
    """A buffer defined purely by its port specifications."""

    name: str
    ports: List[Port] = field(default_factory=list)
    element_bits: int = 16

    # -- construction ---------------------------------------------------------
    def add_port(self, port: Port) -> None:
        self.ports.append(port)

    @property
    def in_ports(self) -> List[Port]:
        return [p for p in self.ports if p.direction == IN]

    @property
    def out_ports(self) -> List[Port]:
        return [p for p in self.ports if p.direction == OUT]

    # -- derived geometry -------------------------------------------------------
    def logical_box(self) -> Box:
        """Interval hull of all elements touched by any port."""
        dims = tuple(f"a{i}" for i in range(self.ports[0].access.n_out))
        box = self.ports[0].touched_box(dims)
        for p in self.ports[1:]:
            box = box.hull(p.touched_box(dims))
        return box

    def ports_per_cycle(self) -> int:
        """Peak memory operations per cycle in steady state — determines
        whether the buffer fits a physical primitive's bandwidth."""
        total = 0
        for p in self.ports:
            from .poly import _min_schedule_gap

            gap = _min_schedule_gap(p.schedule)
            total += max(1, p.width) if gap == 1 else 1
        return total

    # -- storage analysis ---------------------------------------------------------
    def capacity_bound(self) -> int:
        """Minimal words needed, maximized over write ports (paper's storage
        minimization: max live values)."""
        if not self.in_ports or not self.out_ports:
            return 0
        best = 0
        for w in self.in_ports:
            cap = live_values_bound(
                w.schedule,
                [r.schedule for r in self.out_ports],
                w.access,
                [r.access for r in self.out_ports],
            )
            best = max(best, cap)
        return best

    def port_distance(self, src: Port, dst: Port) -> Optional[int]:
        """Constant dependence distance src->dst, None when non-constant."""
        return dependence_distance(src.access, src.schedule, dst.access, dst.schedule)

    # -- validation -----------------------------------------------------------------
    def validate(self) -> List[str]:
        """Check spec well-formedness.  Returns list of problems (empty = ok)."""
        problems: List[str] = []
        for p in self.ports:
            if not p.schedule.is_injective_per_cycle():
                problems.append(f"port {p.name}: schedule reuses a cycle")
        # every read must happen at/after the write of the same element
        for r in self.out_ports:
            for w in self.in_ports:
                inv = w.access.try_invert()
                if inv is None:
                    continue
                j = inv.compose(r.access, inv.in_dims)
                subst = dict(zip(w.schedule.domain.dims, j.exprs))
                dist = r.schedule.expr - w.schedule.expr.substitute(subst)
                lo = dist.range_over(r.domain)[0]
                if lo < 0:
                    problems.append(
                        f"port {r.name}: reads element before it is written "
                        f"(min distance {lo})"
                    )
                break
        return problems

    # -- reference stream (used to validate physical mappings) ------------------------
    def output_stream(
        self, value_of: Callable[[Tuple[int, ...]], float]
    ) -> Dict[str, List[Tuple[int, float]]]:
        """The abstract (cycle, value) stream per output port, given the
        element->value function (normally produced by upstream compute)."""
        out: Dict[str, List[Tuple[int, float]]] = {}
        for p in self.out_ports:
            seq = sorted((c, value_of(e)) for c, e, _ in p.events())
            out[p.name] = seq
        return out

    def __repr__(self) -> str:
        return (
            f"UnifiedBuffer({self.name}, {len(self.in_ports)} in / "
            f"{len(self.out_ports)} out, box={self.logical_box().extents})"
        )


def make_streaming_write_port(
    name: str,
    buffer_dims: Sequence[str],
    extents: Sequence[int],
    start: int = 0,
    width: int = 1,
) -> Port:
    """Convenience: a raster-order write port covering a dense box, one word
    per cycle (the shape produced by an upstream II=1 kernel)."""
    box = Box.from_extents(buffer_dims, extents)
    access = AffineMap.identity(buffer_dims)
    stride = 1
    expr = AffineExpr.constant(start)
    for d, e in zip(reversed(buffer_dims), reversed(list(extents))):
        expr = expr + AffineExpr.var(d) * stride
        stride *= e
    return Port(name, IN, box, access, Schedule(expr, box), width)


__all__ = ["IN", "OUT", "Port", "UnifiedBuffer", "make_streaming_write_port"]
