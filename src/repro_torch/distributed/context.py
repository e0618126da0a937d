"""Module-level sharding context — the port of the JAX package's
``distributed/context.py``.

Model code is sharding-agnostic; it calls ``hint(x, kind)`` at the points
where the layout matters (attention heads/sequence, MoE dispatch, logits).
When a context is installed (by a launcher or a test) and ``x`` is a
``DTensor``, a hint redistributes it to the plan's layout for ``kind``,
the counterpart of ``with_sharding_constraint``; otherwise it returns ``x``
itself, so the single-device path runs unchanged.  The context also turns
on DTensor's implicit replication: the plain tensors the model makes
(positions, masks, scalars) join DTensor operands as replicated values,
which they are on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from .sharding import placements

_CTX: Optional["_Context"] = None


class _Context:
    def __init__(self, mesh, plan):
        self.mesh = mesh
        self.plan = plan
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(implicit_replication())


def set_sharding_context(mesh, plan) -> None:
    global _CTX
    clear_sharding_context()
    _CTX = _Context(mesh, plan)


def clear_sharding_context() -> None:
    global _CTX
    if _CTX is not None:
        _CTX.stack.close()
    _CTX = None


@contextlib.contextmanager
def sharding_context(mesh, plan):
    set_sharding_context(mesh, plan)
    try:
        yield
    finally:
        clear_sharding_context()


def current():
    """The installed context (``.mesh``, ``.plan``), or None."""
    return _CTX


def hint(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Redistribute ``x`` to the active plan's layout for ``kind`` (``x``
    itself when no context is installed, ``x`` is not a DTensor, or the
    plan has no spec for this kind/shape)."""
    if _CTX is None or not isinstance(x, DTensor):
        return x
    spec = _CTX.plan.activation_spec(kind, tuple(x.shape))
    if spec is None:
        return x
    return x.redistribute(_CTX.mesh, placements(spec, _CTX.mesh))


def whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor sharded along ``dim`` gathered along it (its other
    placements kept); anything else as it is.  DTensor cannot reshape the
    rows of a product over a sequence-sharded operand back to (B, S, ...)
    or gather reliably along a sharded dim in the torch releases the port
    runs on; the model gathers first at those sites (the sequence before a
    block's projections is Megatron-SP's all-gather, which XLA inserts for
    the JAX package)."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    if not any(p.is_shard(dim) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim) else p
                                          for p in x.placements])


class _GradWholeAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x

    @staticmethod
    def backward(ctx, grad):
        return whole_along(grad, ctx.dim), None


def grad_whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` itself, whose gradient is gathered along ``dim`` on its way
    back (``whole_along``): for a view whose backward cannot take that dim
    sharded.  A plain tensor is returned as it is."""
    return _GradWholeAlong.apply(x, dim) if isinstance(x, DTensor) else x


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, ...) activation whole along S (``whole_along(x, 1)``)."""
    return whole_along(x, 1)


def batch_rows(x: DTensor) -> list:
    """The placements of ``x``'s batch rows: split along dim 0 over the
    mesh dims that split ``x`` there, whole on every other."""
    return [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]


def local_rows(t: torch.Tensor, mesh, rows: Sequence) -> torch.Tensor:
    """This rank's part of ``t`` laid out as ``rows`` (``batch_rows``), as
    a local tensor; a plain ``t`` is the same on every rank."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, list(rows)).to_local()


def from_local_rows(x: torch.Tensor, mesh, rows: Sequence, shape: Sequence[int]) -> DTensor:
    """The contiguous DTensor of global ``shape`` whose part on each rank,
    laid out as ``rows``, is that rank's ``x``."""
    stride, n = [], 1
    for e in reversed(shape):
        stride.insert(0, n)
        n *= e
    return DTensor.from_local(x, mesh, list(rows), run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def _all_reduce(x: torch.Tensor, op: str, mesh, dims: Sequence[int]) -> torch.Tensor:
    for d in dims:
        x = funcol.all_reduce(x, op, (mesh, d))
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = x.wait()
    return x


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return _all_reduce(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_over(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """A local tensor summed over the ranks of ``mesh``'s dims ``dims``
    (an all-reduce a dim; ``x`` itself for none).  Its gradient is passed
    on as it is: the sum is whole on each of those ranks, and what follows
    runs the same there (Megatron's reduction from the model-parallel
    region), so each rank's own term takes the whole gradient."""
    return _SumOver.apply(x, mesh, tuple(dims)) if dims else x


def max_over(x: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """A local tensor's maximum over the ranks of ``mesh``'s dims ``dims``,
    with no gradient (a softmax's shift)."""
    with torch.no_grad():
        return _all_reduce(x.detach(), "max", mesh, dims)


__all__ = [
    "batch_rows", "clear_sharding_context", "current", "from_local_rows", "grad_whole_along",
    "hint", "local_rows", "max_over", "seq_whole", "set_sharding_context", "sharding_context",
    "sum_over", "whole_along",
]
