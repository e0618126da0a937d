"""Three-term roofline of one rank's step on an NVIDIA H100 — the port of
the JAX package's ``roofline/analysis.py``.

    compute term    = Σ FLOPs of a unit / that unit's peak FLOP/s
    memory term     = HBM bytes / HBM bytes/s
    collective term = Σ collective bytes / the link's bytes/s

Every quantity is one rank's (``dispatch_cost``: the ops that rank
dispatches on its local tensors), so the terms are one GPU's times.

Hardware constants, all data-sheet figures and none of them measured here:

* ``PEAK_FLOPS`` 989.4 TFLOP/s dense bf16 on the tensor cores and
  ``PEAK_F32_FLOPS`` 67 TFLOP/s IEEE f32 outside them, ``HBM_BW`` 3.35 TB/s
  HBM3 (NVIDIA H100 SXM data sheet).  A product of f32 operands is charged
  at the f32 rate: the port runs f32 products in full f32 (TF32 off).
* ``NVLINK_BW`` 900 GB/s a GPU, both directions together (NVLink 4, the
  same data sheet), for a group whose ranks all lie in one node of
  ``NODE_GPUS`` = 8 consecutive ranks (DGX H100).
* ``NET_BW`` 100 GB/s a GPU, both directions together, for a group that
  crosses nodes: 400 Gb/s NDR InfiniBand a direction, one ConnectX-7 for
  each GPU (NVIDIA DGX H100 data sheet).  On the (16, 16) and (2, 16, 16)
  production meshes every ``data`` and ``pod`` group and every 16-wide
  ``model`` group crosses nodes.

Collective bytes are a collective's result bytes over the group's rate, as
the JAX report divides them by one link's; with both directions counted
the term is a lower bound.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

PEAK_FLOPS = 989.4e12        # bf16 dense, tensor cores (H100 SXM data sheet)
PEAK_F32_FLOPS = 67e12       # IEEE f32, outside the tensor cores (same)
HBM_BW = 3.35e12             # HBM3 bytes/s (same)
NVLINK_BW = 900e9            # NVLink 4 bytes/s a GPU, both directions (same)
NET_BW = 100e9               # 400 Gb/s NDR InfiniBand a direction, both (DGX H100 data sheet)
NODE_GPUS = 8                # GPUs a node: consecutive ranks (DGX H100)
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB HBM3
H100_MEMORY_BYTES = 85017493504

# the peak of each unit a FLOP is charged to (``Cost.flops`` keys)
PEAKS = {"bf16": PEAK_FLOPS, "f32": PEAK_F32_FLOPS}


@dataclass
class RooflineReport:
    name: str
    chips: int
    flops: float                      # one rank's product FLOPs (all units)
    hbm_bytes: float                  # one rank's HBM bytes (no fusion)
    collective_bytes: Dict[str, int]  # one rank's, by collective kind
    model_flops: float = 0.0          # 6*N*D (train) or 2*N*tokens (global)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    nvlink_bw: float = NVLINK_BW
    net_bw: float = NET_BW
    flops_by_unit: Optional[Dict[str, float]] = None   # {"bf16": .., "f32": ..}
    network_bytes: int = 0            # the part of collective_bytes that crosses nodes
    trace_cost: Optional[Dict] = None

    @property
    def t_compute(self) -> float:
        units = self.flops_by_unit or {"bf16": self.flops}
        return sum(f / (self.peak_flops if u == "bf16" else PEAKS[u]) for u, f in units.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        total = sum(self.collective_bytes.values())
        return (total - self.network_bytes) / self.nvlink_bw + self.network_bytes / self.net_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs (per rank): catches remat and redundancy."""
        per_chip_model = self.model_flops / self.chips
        return per_chip_model / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time (how close to the roofline)."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        useful = (self.model_flops / self.chips) / self.peak_flops
        return useful / bound if bound > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "flops": self.flops,
            "flops_by_unit": self.flops_by_unit,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "network_bytes": self.network_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "trace_cost": self.trace_cost,
        }


__all__ = [
    "H100_MEMORY_BYTES", "HBM_BW", "NET_BW", "NODE_GPUS", "NVLINK_BW", "PEAKS", "PEAK_F32_FLOPS",
    "PEAK_FLOPS", "RooflineReport",
]
