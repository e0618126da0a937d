"""The port's ``distributed/`` on ``torch.distributed`` and DTensor: the
sharding planner (``sharding``), the sharding context and its hints
(``context``), ring attention (``ring_attention``) and the GPipe schedule
(``pipeline``)."""

from .context import clear_sharding_context, hint, set_sharding_context
from .sharding import ShardingPlan, make_plan, param_shardings

__all__ = [
    "clear_sharding_context",
    "hint",
    "set_sharding_context",
    "ShardingPlan",
    "make_plan",
    "param_shardings",
]
