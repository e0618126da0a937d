"""Unified buffer mapping (paper §V-C): abstract UBs -> physical UB configs.

Transforms applied, in order:

  1. **Shift-register extraction** — output ports whose dependence distance
     to another port is constant (and whose value stream is a subset) become
     taps on a delay chain instead of SRAM reads (Fig. 8a).
  2. **Banking** — remaining ports are spread over enough physical tiles to
     satisfy the bandwidth (simplified [7], Fig. 8b).
  3. **Vectorization** — SRAM-facing streams are strip-mined by the fetch
     width FW (Eqs. 2-3); the serial sides land in the aggregator (AGG) and
     transpose buffer (TB) register files (Fig. 9).
  4. **Address linearization** — N-d element coords -> 1-d physical address
     via the layout offset vector, modulo the minimized capacity (Eq. 4).
  5. **Chaining** — capacities beyond one tile split across chained tiles via
     TileID = floor(a / C), addr = a mod C (Eqs. 5-6, Fig. 10).

The result (``MappedBuffer``) carries the recurrence AG/SG configurations
(Fig. 5c) for every generator the hardware needs — the "configuration bits".
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .poly import AffineExpr, AffineMap, Box, Schedule, dependence_distance
from .recurrence import AGConfig, make_ag
from .ubuffer import IN, OUT, Port, UnifiedBuffer


@dataclass
class HardwareSpec:
    """One physical unified buffer (MEM tile) of the target CGRA (§VI)."""

    fetch_width: int = 4          # words per SRAM access (4 x 16b = 64b)
    tile_words: int = 2048        # 512 x 64b single-port SRAM = 2048 words
    sram_ports_per_cycle: int = 1  # single-port: one (wide) access / cycle
    max_sr_delay: int = 16        # delays <= this stay in the PE-fabric SRs
    agg_words: int = 8
    tb_words: int = 8


@dataclass
class SRTap:
    """A shift-register tap feeding one output port.

    ``fed_by``/``delay`` describe the physical chain segment; ``origin`` /
    ``origin_delay`` locate the tap on the dense stream pushed through the
    originating IN port (total delay from the write).
    """

    port: str
    fed_by: str                   # feeding port name (IN port or earlier tap)
    delay: int                    # chain-segment registers from the feeder
    origin: str = ""              # originating IN port
    origin_delay: int = 0         # cumulative delay from the origin


@dataclass
class BankConfig:
    """One SRAM bank (or chained group) with its port assignments."""

    ports: List[str]
    capacity: int                 # minimized words (before chaining)
    tiles: int                    # chained physical tiles
    offset_vector: Tuple[int, ...]
    modulo: int
    write_ag: Optional[AGConfig] = None
    read_ags: List[AGConfig] = field(default_factory=list)
    vectorized: bool = False
    agg_words: int = 0
    tb_words: int = 0


@dataclass
class MappedBuffer:
    name: str
    sr_taps: List[SRTap]
    sr_register_bits: int
    banks: List[BankConfig]

    @property
    def mem_tiles(self) -> int:
        return sum(b.tiles for b in self.banks)

    @property
    def sram_words(self) -> int:
        """Words held in SRAM-backed tiles (register banks excluded)."""
        return sum(b.capacity for b in self.banks if b.tiles > 0)

    @property
    def register_bank_words(self) -> int:
        return sum(b.capacity for b in self.banks if b.tiles == 0)


# ---------------------------------------------------------------------------
# 1. shift-register extraction
# ---------------------------------------------------------------------------


def _stream_superset(src: Port, dst: Port) -> bool:
    """src's value stream covers dst's: identical access-stride structure and
    dst touches no element src does not."""
    if len(src.access.exprs) != len(dst.access.exprs):
        return False
    sbox = src.touched_box()
    dbox = dst.touched_box()
    for (slo, shi), (dlo, dhi) in zip(sbox.intervals, dbox.intervals):
        if dlo < slo or dhi > shi:
            return False
    return True


def extract_shift_registers(
    ub: UnifiedBuffer, hw: HardwareSpec
) -> Tuple[List[SRTap], List[Port], int]:
    """Exhaustive shift-register analysis (paper §V-C): find all output
    ports reachable at constant delay from a feeder port, chain them by
    increasing delay, and return (taps, remaining SRAM ports, register bits).

    Only *small* inter-tap delays (<= max_sr_delay) become PE-fabric shift
    registers; a long leg (e.g. a 64-cycle line delay) stays an SRAM-backed
    FIFO, which we keep as a bank with a sequential access pattern.
    """
    taps: List[SRTap] = []
    remaining: List[Port] = []
    feeders = list(ub.in_ports)
    if not feeders:
        return [], list(ub.out_ports), 0

    # distance of every out port to its best (nearest-preceding) feeder
    dist: Dict[str, Optional[int]] = {}
    origin: Dict[str, str] = {}
    for p in ub.out_ports:
        best = None
        for w in feeders:
            d = dependence_distance(w.access, w.schedule, p.access, p.schedule)
            if d is not None and d >= 0 and _stream_superset(w, p):
                if best is None or d < best:
                    best = d
                    origin[p.name] = w.name
        dist[p.name] = best

    remaining.extend(p for p in ub.out_ports if dist[p.name] is None)
    chainable = sorted(
        (p for p in ub.out_ports if dist[p.name] is not None),
        key=lambda p: dist[p.name],
    )
    register_bits = 0
    prev_name: Optional[str] = None
    prev_d = 0
    for p in chainable:
        d = dist[p.name]
        step = d - prev_d if prev_name is not None else d
        feeder = prev_name if prev_name is not None else feeders[0].name
        if step <= hw.max_sr_delay:
            taps.append(SRTap(p.name, feeder, step, origin[p.name], d))
            register_bits += step * ub.element_bits
            prev_name, prev_d = p.name, d
        else:
            # long leg: stays an SRAM (FIFO) port
            remaining.append(p)
            # later taps may still chain off this port
            prev_name, prev_d = p.name, d
    return taps, remaining, register_bits


# ---------------------------------------------------------------------------
# 2-5. banking, vectorization, linearization, chaining
# ---------------------------------------------------------------------------


def _layout_and_capacity(ub: UnifiedBuffer, ports: Sequence[Port]) -> Tuple[Tuple[int, ...], int]:
    """Row-major offset vector over the touched box + minimized capacity
    (live values), rounded so the modulo is cheap (power of two)."""
    box = ub.logical_box()
    offsets: List[int] = []
    stride = 1
    for e in reversed(box.extents):
        offsets.append(stride)
        stride *= e
    offsets.reverse()
    cap = ub.capacity_bound()
    mod = 1 << max(0, (cap - 1)).bit_length() if cap > 1 else 1
    return tuple(offsets), min(mod, stride) or 1


def _linear_addr_expr(access: AffineMap, offsets: Sequence[int]) -> AffineExpr:
    expr = AffineExpr.constant(0)
    for e, o in zip(access.exprs, offsets):
        expr = expr + e * o
    return expr


def _innermost_contiguous(port: Port) -> bool:
    """Vectorizable: the fastest-varying dim advances the address by 1 each
    cycle (the strip-mining of Eqs. 2-3 applies to the innermost loop)."""
    dims = port.domain.dims
    if not dims:
        return False
    inner = dims[-1]
    # schedule advances by 1 with the innermost dim and the access map's last
    # output advances by 1 too
    return (
        port.schedule.expr.coeff(inner) == 1
        and port.access.exprs[-1].coeff(inner) == 1
    )


def map_unified_buffer(ub: UnifiedBuffer, hw: Optional[HardwareSpec] = None) -> MappedBuffer:
    hw = hw or HardwareSpec()
    taps, sram_ports, reg_bits = extract_shift_registers(ub, hw)

    banks: List[BankConfig] = []
    if sram_ports or (not taps and ub.out_ports):
        offsets, modulo = _layout_and_capacity(ub, sram_ports)
        cap = ub.capacity_bound()
        # ---- banking: each bank supports sram_ports_per_cycle wide accesses;
        # vectorization by FW lets one port issue 1 access per FW cycles
        groups: List[List[Port]] = []
        per_bank = hw.sram_ports_per_cycle * hw.fetch_width
        current: List[Port] = []
        budget = per_bank - 1  # writer occupies one slot group
        for p in sram_ports:
            need = 1 if _innermost_contiguous(p) else hw.fetch_width
            if budget - need < 0 and current:
                groups.append(current)
                current = []
                budget = per_bank - 1
            current.append(p)
            budget -= need
        if current or not groups:
            groups.append(current)

        for gi, group in enumerate(groups):
            # a bank stores only the elements its own ports touch: the hull
            # of the group's footprints, capped by the whole-buffer live bound
            if group:
                hull = group[0].touched_box()
                for p in group[1:]:
                    hull = hull.hull(p.touched_box())
                bank_cap = max(1, min(cap, hull.size()))
            else:
                bank_cap = max(1, cap)
            vectorized = all(_innermost_contiguous(p) for p in group) and group != []
            write_ag = None
            if ub.in_ports:
                w = ub.in_ports[0]
                addr = _linear_addr_expr(w.access, offsets)
                if vectorized and _innermost_contiguous(w):
                    # Eq. 3: the SRAM side indexes floor(x/FW): model by the
                    # strided outer loop (1 wide access per FW cycles)
                    write_ag = make_ag(addr, w.domain)
                else:
                    write_ag = make_ag(addr, w.domain)
            read_ags = [
                make_ag(_linear_addr_expr(p.access, offsets), p.domain) for p in group
            ]
            # register-file-sized banks (tiny resident footprints, e.g. a
            # PE's private weight slice) live in registers, not MEM tiles
            if bank_cap <= hw.agg_words:
                tiles = 0
            else:
                tiles = max(1, math.ceil(bank_cap / hw.tile_words))
            banks.append(
                BankConfig(
                    ports=[p.name for p in group],
                    capacity=bank_cap,
                    tiles=tiles,
                    offset_vector=offsets,
                    modulo=modulo,
                    write_ag=write_ag,
                    read_ags=read_ags,
                    vectorized=vectorized,
                    agg_words=hw.agg_words if vectorized else 0,
                    tb_words=hw.tb_words * max(1, len(group)) if vectorized else 0,
                )
            )
    return MappedBuffer(ub.name, taps, reg_bits, banks)


def map_design(
    buffers: Dict[str, UnifiedBuffer], hw: Optional[HardwareSpec] = None
) -> Dict[str, MappedBuffer]:
    hw = hw or HardwareSpec()
    return {name: map_unified_buffer(ub, hw) for name, ub in buffers.items()}


__all__ = [
    "HardwareSpec",
    "SRTap",
    "BankConfig",
    "MappedBuffer",
    "extract_shift_registers",
    "map_unified_buffer",
    "map_design",
]
