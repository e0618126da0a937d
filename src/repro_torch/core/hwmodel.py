"""Component-level area/energy model of physical unified buffers (Table II)
and of full designs (Table IV, Figs. 13/14).

The constants are calibrated to the paper's published TSMC-16nm numbers
(Table II and §VI-A) — this is an analytical model, not a synthesis flow:

  * dual-port 2048x16b SRAM macro: ~2.5x the area of the single-port
    512x64b macro of the same capacity, ~40% more energy per access [25];
  * addressing/control on CGRA PEs costs ~15 PE tiles worth of area;
  * dedicated AG/SG logic (with the Fig. 5c recurrence optimization) costs
    a small fixed area per generator;
  * wide-fetch amortization: energy/word drops with fetch width [34].

Outputs reproduce the three Table II rows and per-application energy/runtime
(CGRA @900MHz vs FPGA @200MHz, Figs. 13/14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple

from .mapping import MappedBuffer

# ---- calibrated component constants (TSMC 16nm, paper §VI) ----------------
UM2 = 1.0
SRAM_DP_2048x16_AREA = 15.6e3 * UM2       # 82% of 19k (Table II row 1)
SRAM_SP_512x64_AREA = 5.5e3 * UM2         # 32% of 17k (Table II row 3)
PE_TILE_AREA = 1.0e3 * UM2                # one CGRA PE tile
ADDR_ON_PES_AREA = 15.0e3 * UM2           # addressing mapped onto PEs
AG_SG_AREA = 0.75e3 * UM2                 # one ID+AG+SG triple (Fig. 5c)
AGG_TB_AREA = 1.2e3 * UM2                 # aggregator / transpose buffer RF
MUX_CHAIN_AREA = 0.4e3 * UM2

SRAM_DP_ENERGY_PJ = 3.0                   # per 16b access
SRAM_SP_WIDE_ENERGY_PJ = 4.4              # per 64b access (4 words)
AG_PE_ENERGY_PJ = 1.8                     # addressing on PEs, per access
AG_DEDICATED_ENERGY_PJ = 0.55             # dedicated AG/SG, per access
AGG_TB_ENERGY_PJ = 0.30                   # register-file read+write per word
PE_OP_ENERGY_PJ = 0.9                     # one 16b ALU op on the CGRA
FPGA_OP_ENERGY_PJ = 3.9                   # one 16b op on the FPGA fabric
FPGA_MEM_ENERGY_PJ = 10.5                 # one BRAM access
CGRA_CLOCK_HZ = 900e6
FPGA_CLOCK_HZ = 200e6


@dataclass
class BufferVariant:
    name: str
    mem_area_um2: float
    sram_fraction: float
    total_area_um2: float
    energy_pj_per_access: float


def table2_variants() -> Dict[str, BufferVariant]:
    """The three physical-unified-buffer implementations of Table II, for a
    3x3 convolution workload (1 write + 2 SRAM-serviced reads per cycle plus
    SR taps)."""
    out: Dict[str, BufferVariant] = {}

    # 1. dual-port SRAM + addressing on PEs (baseline)
    mem = SRAM_DP_2048x16_AREA / 0.82
    total = mem + ADDR_ON_PES_AREA
    energy = SRAM_DP_ENERGY_PJ + AG_PE_ENERGY_PJ
    out["dp_sram_pes"] = BufferVariant(
        "DP SRAM + PEs (Baseline)", mem, SRAM_DP_2048x16_AREA / mem, total, energy
    )

    # 2. dual-port SRAM + dedicated AG
    n_generators = 2 + 2 * 2   # ID/AG/SG on each of 2 ports + sharing
    mem = SRAM_DP_2048x16_AREA + n_generators * AG_SG_AREA + MUX_CHAIN_AREA * 4
    out["dp_sram_ag"] = BufferVariant(
        "DP SRAM + AG",
        mem,
        SRAM_DP_2048x16_AREA / mem,
        mem,
        SRAM_DP_ENERGY_PJ + AG_DEDICATED_ENERGY_PJ + 0.05,
    )

    # 3. wide-fetch single-port SRAM + AGG + TB + AGs (the physical UB)
    n_generators = 6           # AGG in/out, SRAM in/out (shared SG), TB in/out
    mem = (
        SRAM_SP_512x64_AREA
        + 2 * AGG_TB_AREA
        + n_generators * AG_SG_AREA
        + MUX_CHAIN_AREA * 10
    )
    # energy per (16b word) access: wide access amortized over 4 words +
    # AGG/TB movement + AG
    energy = SRAM_SP_WIDE_ENERGY_PJ / 4 + 2 * AGG_TB_ENERGY_PJ + AG_DEDICATED_ENERGY_PJ + 0.25
    out["wide_sp_ub"] = BufferVariant(
        "4-wide SP SRAM + AGG + TB + AGs",
        mem,
        SRAM_SP_512x64_AREA / mem,
        mem,
        energy,
    )
    return out


@dataclass
class DesignCost:
    pe_count: int
    mem_tiles: int
    mem_accesses: int
    pe_ops_total: int
    cgra_energy_pj: float
    fpga_energy_pj: float
    cgra_runtime_s: float
    fpga_runtime_s: float

    @property
    def cgra_energy_per_op_pj(self) -> float:
        return self.cgra_energy_pj / max(self.pe_ops_total, 1)

    @property
    def fpga_energy_per_op_pj(self) -> float:
        return self.fpga_energy_pj / max(self.pe_ops_total, 1)


def design_cost(
    pe_ops_per_cycle: int,
    mapped: Mapping[str, MappedBuffer],
    completion_cycles: int,
    statements: int,
) -> DesignCost:
    """Energy/runtime model for a compiled design (Figs. 13/14).

    ``statements`` is the number of statement instances executed (so
    ops_total = statements * ops per statement is robust to II != 1).
    """
    mem_tiles = sum(m.mem_tiles for m in mapped.values())
    # every statement instance performs one access per touched port group
    mem_accesses = 0
    for m in mapped.values():
        ports = sum(len(b.ports) for b in m.banks) + len(m.sr_taps) + 1
        mem_accesses += statements * max(1, ports) // 4
    pe_ops_total = statements * max(pe_ops_per_cycle, 1)
    ub_energy = SRAM_SP_WIDE_ENERGY_PJ / 4 + 2 * AGG_TB_ENERGY_PJ + AG_DEDICATED_ENERGY_PJ
    cgra = pe_ops_total * PE_OP_ENERGY_PJ + mem_accesses * ub_energy
    fpga = pe_ops_total * FPGA_OP_ENERGY_PJ + mem_accesses * FPGA_MEM_ENERGY_PJ
    return DesignCost(
        pe_count=pe_ops_per_cycle,
        mem_tiles=mem_tiles,
        mem_accesses=mem_accesses,
        pe_ops_total=pe_ops_total,
        cgra_energy_pj=cgra,
        fpga_energy_pj=fpga,
        cgra_runtime_s=completion_cycles / CGRA_CLOCK_HZ,
        fpga_runtime_s=completion_cycles / FPGA_CLOCK_HZ,
    )


__all__ = ["BufferVariant", "DesignCost", "table2_variants", "design_cost"]
