"""The port's backend: plan, certify and run lowered Halide pipelines on an
NVIDIA H100 through hand-written CUDA kernels (one per planned kernel
group), with a plain PyTorch version of every kernel beside it.

The planner (``plan``), the verifier (``verify``), the access decomposition
and the error taxonomy are the JAX package's, kept as copies so that the
port imports nothing of it; ``eager``, ``cuda_codegen``, ``build``,
``runner``, ``serve_bridge``, ``demo`` and ``faults`` are the port's own.
"""

from .access import AxisAccess, LoadAccess, UnsupportedAccessError, decompose_stage
from .eager import EagerKernel, GroupKernel, LoweredGroup, eval_trace
from .errors import (
    BackendError,
    BackendWarning,
    DeadlineExceededError,
    DegradedModeWarning,
    EmitError,
    LaneCarryDegradeWarning,
    MissingInputError,
    NonFiniteInputError,
    PlanError,
    PoisonedTileError,
    QueueFullError,
    RequestError,
    ServeError,
)
from .plan import (
    FusionInfeasible,
    KernelGroup,
    LineBuffer,
    PaddedGrid,
    PipelinePlan,
    RedGrid,
    RingStream,
    StagePlan,
    ViewGroup,
    build_pipeline_plan,
    scheduler_cost,
)
from .runner import (
    TUNABLE_KEYS,
    TorchPipeline,
    clear_pipeline_cache,
    compile_pipeline,
    compile_stage,
    drop_pipeline_cache_entry,
    inputs_to_torch,
    max_abs_error,
    pipeline_cache_size,
    pipeline_cache_stats,
    plan_cache_key,
    reference_arrays,
)
from .serve_bridge import PipelineServer, TileRequest
from .verify import (
    RULES, PlanVerificationError, PlanViolation, assert_plan_verified, verify_plan,
)

__all__ = [
    "AxisAccess",
    "LoadAccess",
    "UnsupportedAccessError",
    "decompose_stage",
    "EagerKernel",
    "GroupKernel",
    "LoweredGroup",
    "eval_trace",
    "BackendError",
    "BackendWarning",
    "DeadlineExceededError",
    "DegradedModeWarning",
    "EmitError",
    "LaneCarryDegradeWarning",
    "MissingInputError",
    "NonFiniteInputError",
    "PlanError",
    "PoisonedTileError",
    "QueueFullError",
    "RequestError",
    "ServeError",
    "FusionInfeasible",
    "KernelGroup",
    "LineBuffer",
    "PaddedGrid",
    "PipelinePlan",
    "RedGrid",
    "RingStream",
    "StagePlan",
    "ViewGroup",
    "build_pipeline_plan",
    "scheduler_cost",
    "TUNABLE_KEYS",
    "TorchPipeline",
    "clear_pipeline_cache",
    "compile_pipeline",
    "compile_stage",
    "drop_pipeline_cache_entry",
    "inputs_to_torch",
    "max_abs_error",
    "pipeline_cache_size",
    "pipeline_cache_stats",
    "plan_cache_key",
    "reference_arrays",
    "PipelineServer",
    "TileRequest",
    "RULES",
    "PlanVerificationError",
    "PlanViolation",
    "assert_plan_verified",
    "verify_plan",
]
