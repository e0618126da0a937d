"""Structured error taxonomy for the plan/emit/serve stack.

The static verifier (``backend/verify``) made *plans* predictable: every
broken invariant surfaces as a named ``UBxyz`` rule with a concrete
witness.  This module extends the same discipline to the *runtime*: every
failure the compiler or the serving layer can produce is a named class in
one four-family taxonomy, and each instance carries the witness of where
it happened — the kernel group, the fused stage, the offending request —
so a fault report reads like a verifier violation, not a Pallas traceback.

Families (mirroring the stack, producer to consumer):

``PlanError``
    Planning failed: the pipeline cannot be scheduled as asked.
    ``FusionInfeasible`` (plan.py), ``UnsupportedAccessError`` (access.py)
    and ``PlanVerificationError`` (verify.py) are its concrete subclasses.

``EmitError``
    A certified plan failed to lower: ``emit_kernel`` or the jit trace
    raised.  Always wraps the original exception (``__cause__``) and names
    the kernel group that broke.

``RequestError``
    One request is bad or individually failed — a validation rejection at
    ``PipelineServer.submit()`` (shape, dtype, missing input, non-finite
    values) or a per-request serving outcome (deadline miss, poisoned
    tile isolated by quarantine).  Subclasses ``ValueError`` so existing
    ``except ValueError`` callers keep working.  A ``RequestError`` never
    fails anyone else's request: that is the isolation contract.

``ServeError``
    The serving layer itself failed — a whole dispatch faulted and the
    recovery ladder (recompile → heuristic schedule → per-tile fallback)
    was exhausted, or admission control rejected work
    (``QueueFullError``).

Warnings mirror the split: ``BackendWarning`` is the root,
``DegradedModeWarning`` marks every *recovered* fault — the system kept
serving, but on a degraded path (heuristic schedule after a corrupt
schedule db, recompute after an impossible carry) — so a log grep for one
class finds every silent-degradation event.

Every class stringifies as ``[CODE] where: message witness=...`` exactly
like :class:`~repro_torch.backend.verify.PlanViolation` does for ``UBxyz``
rules; ``code`` is the stable grep key.
"""

from __future__ import annotations

from typing import Optional, Tuple


class BackendError(Exception):
    """Root of the backend failure taxonomy.

    ``kernel`` / ``stage`` / ``request`` name where the failure happened
    (any may be ``None``); ``witness`` is a small tuple of concrete
    evidence — a coordinate, a byte count, a queue depth — mirroring
    ``PlanViolation.witness``.  ``code`` is the stable per-class grep key.
    """

    code: str = "E000"

    def __init__(
        self,
        message: str,
        *,
        kernel: Optional[str] = None,
        stage: Optional[str] = None,
        request: Optional[object] = None,
        witness: Tuple = (),
    ) -> None:
        self.message = message
        self.kernel = kernel
        self.stage = stage
        self.request = request
        self.witness = tuple(witness)
        super().__init__(self._format())

    def __str__(self) -> str:
        # KeyError.__str__ would repr-quote the message on the
        # MissingInputError diamond; pin the formatted form for the whole
        # taxonomy instead.
        return self._format()

    def _format(self) -> str:
        where = []
        if self.kernel:
            where.append(f"kernel={self.kernel}")
        if self.stage and self.stage != self.kernel:
            where.append(f"stage={self.stage}")
        if self.request is not None:
            where.append(f"request={self.request}")
        head = f"[{self.code}]"
        if where:
            head += " " + " ".join(where) + ":"
        wit = f" witness={self.witness}" if self.witness else ""
        return f"{head} {self.message}{wit}"


class PlanError(BackendError):
    """Planning failed: the pipeline cannot be scheduled as requested."""

    code = "PLAN"


class EmitError(BackendError, RuntimeError):
    """A certified plan failed to lower to an executable kernel.
    Subclasses ``RuntimeError`` so the pre-taxonomy emission-gate
    contract (compiled mode off-TPU raises a ``RuntimeError`` naming the
    backend) keeps holding through the wrap."""

    code = "EMIT"


class RequestError(BackendError, ValueError):
    """One request is invalid or individually failed; nobody else's
    request is affected.  Subclasses ``ValueError`` for back-compat with
    the pre-taxonomy ``submit()`` contract."""

    code = "REQ"


class MissingInputError(RequestError, KeyError):
    """A request omits a pipeline input (also a ``KeyError``, the
    pre-taxonomy class ``submit()`` raised for this)."""

    code = "REQ-MISSING"


class NonFiniteInputError(RequestError):
    """A request input contains NaN/Inf; rejected at admission so the
    poison never reaches a batched dispatch."""

    code = "REQ-NONFINITE"


class DeadlineExceededError(RequestError):
    """A request missed its deadline — expired in the queue or completed
    late; its (possibly computed) outputs are discarded, never returned
    late as if on time."""

    code = "REQ-DEADLINE"


class PoisonedTileError(RequestError):
    """Quarantine isolated this tile: dispatched alone it still fails or
    produces non-finite output, so the fault travels with the tile, not
    the batch."""

    code = "REQ-POISONED"


class ServeError(BackendError):
    """The serving layer failed past per-request isolation: a dispatch
    faulted and the recovery ladder was exhausted."""

    code = "SERVE"


class QueueFullError(ServeError):
    """Admission control (``admission="reject"``) refused a submit: the
    bounded queue is at ``max_pending``."""

    code = "SERVE-QUEUE-FULL"


# ---------------------------------------------------------------------------
# Warnings: every recovered / degraded path is a named class
# ---------------------------------------------------------------------------


class BackendWarning(UserWarning):
    """Root of the backend warning taxonomy."""


class DegradedModeWarning(BackendWarning):
    """The system recovered from a fault but is running a degraded path
    (heuristic schedule, recompute fusion, per-tile dispatch); the
    message names the fault and the fallback."""


class ScheduleDBCorruptWarning(DegradedModeWarning):
    """``schedule_db.json`` is corrupt (truncated, garbage JSON, wrong
    version, malformed row); ``compile_pipeline(tune=...)`` degraded to
    the heuristic planner instead of raising mid-compile."""


class LaneCarryDegradeWarning(DegradedModeWarning):
    """``line_buffer=True`` was requested but a lane-blocked kernel had to
    degrade (fully or partially) to recompute mode; the message names the
    planner's reason (``halo-exceeds-bw``, ``carry-infeasible``, ...)."""


class TunedModeMismatchWarning(BackendWarning):
    """A stored schedule measured in one execution mode is being served to
    a compile in another (interpret rankings may not transfer to TPU)."""


__all__ = [
    "BackendError",
    "PlanError",
    "EmitError",
    "RequestError",
    "MissingInputError",
    "NonFiniteInputError",
    "DeadlineExceededError",
    "PoisonedTileError",
    "ServeError",
    "QueueFullError",
    "BackendWarning",
    "DegradedModeWarning",
    "ScheduleDBCorruptWarning",
    "LaneCarryDegradeWarning",
    "TunedModeMismatchWarning",
]
