"""Unified buffer extraction (paper §V-B).

Converts every realized Halide buffer into a ``UnifiedBuffer``: each memory
reference becomes a port with an iteration domain, an access map, and the
cycle-accurate schedule assigned by ``scheduling.py``.

Unrolled dims are resolved here: every unrolled copy of a statement gets its
own port (fixed copy coordinates), and ports that end up with identical
(domain, access, schedule) collapse into one — the hardware broadcast the
paper relies on for, e.g., one ifmap value feeding many MACs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.frontend.lower import Pipeline
from .poly import AffineExpr, AffineMap, Box
from .scheduling import PipelineSchedule, ScheduledStage, _copy_assignments
from .ubuffer import IN, OUT, Port, Schedule, UnifiedBuffer


@dataclass
class ExtractionResult:
    buffers: Dict[str, UnifiedBuffer]
    # buffers whose data simply streams off the accelerator (no consumers)
    output_streams: List[str]
    # compute-kernel PE cost per stage (Table IV/V model)
    pe_ops: Dict[str, int]

    def total_pe_ops(self) -> int:
        return sum(self.pe_ops.values())


def _fixed(s: ScheduledStage, cu: Dict[str, int]):
    """Stage pieces with unrolled dims pinned to one copy: returns (domain
    without those dims, substitution)."""
    subst = {d: AffineExpr.constant(v) for d, v in cu.items()}
    dom = s.domain
    for d in cu:
        dom = dom.drop(d)
    return dom, subst


def extract_buffers(pipe: Pipeline, sched: PipelineSchedule) -> ExtractionResult:
    buffers: Dict[str, UnifiedBuffer] = {}
    outputs: List[str] = []
    pe_ops: Dict[str, int] = {}

    # consumers per buffer
    cons: Dict[str, List[Tuple[ScheduledStage, AffineMap]]] = {}
    for s in sched.stages.values():
        if not s.is_input:
            pe_ops[s.name] = s.pe_ops
        for b, m in s.loads:
            cons.setdefault(b, []).append((s, m))

    for name, producer in sched.stages.items():
        users = cons.get(name, [])
        if not users:
            if not producer.is_input:
                outputs.append(name)
            continue
        ub = UnifiedBuffer(name)

        # ---- input ports: one per unrolled copy of the producing statement
        seen = set()
        for cu in _copy_assignments(producer):
            dom, subst = _fixed(producer, cu)
            # drop reduction dims: the element is committed at the final
            # reduction iteration
            wdom, wsubst = dom, dict(subst)
            for rd in producer.red_dims:
                lo, hi = wdom.bounds(rd)
                wsubst[rd] = AffineExpr.constant(hi)
                wdom = wdom.drop(rd)
            access = AffineMap(
                tuple(wdom.dims), tuple(e.substitute(wsubst) for e in producer.store.exprs)
            )
            expr = producer.write_expr.substitute(wsubst)
            key = (access, expr, wdom)
            if key in seen:
                continue
            seen.add(key)
            ub.add_port(
                Port(
                    f"{name}.in{len(ub.in_ports)}",
                    IN,
                    wdom,
                    access,
                    Schedule(expr, wdom),
                )
            )

        # ---- output ports: one per (consumer load, unrolled copy)
        seen = set()
        for t, m in users:
            for cu in _copy_assignments(t):
                dom, subst = _fixed(t, cu)
                access = AffineMap(
                    tuple(dom.dims), tuple(e.substitute(subst) for e in m.exprs)
                )
                expr = t.issue.substitute(subst)
                key = (access, expr, dom)
                if key in seen:
                    continue
                seen.add(key)
                ub.add_port(
                    Port(
                        f"{name}.out{len(ub.out_ports)}.{t.name}",
                        OUT,
                        dom,
                        access,
                        Schedule(expr, dom),
                    )
                )
        buffers[name] = ub

    return ExtractionResult(buffers, outputs, pe_ops)


__all__ = ["ExtractionResult", "extract_buffers"]
