"""The port's roofline: one rank's traced step against H100 data-sheet
peaks (``analysis``), the cost of the ops a rank dispatches
(``dispatch_cost``) and the work of the hand-written kernels
(``kernel_cost``) — the counterpart of the JAX package's ``roofline``."""

from .analysis import RooflineReport
from .dispatch_cost import Cost, DispatchCostMode, report, trace_cost

__all__ = ["Cost", "DispatchCostMode", "RooflineReport", "report", "trace_cost"]
