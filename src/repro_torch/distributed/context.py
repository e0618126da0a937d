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
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
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


def reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with partial sums (or maxima) as the reduced value, whole
    on those mesh dims; anything else as it is.  For a reduction over a
    split dim that meets a tensor of another layout: DTensor's rules in
    torch 2.11 cannot take a split operand to the partial layout."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, ...) activation whole along S (``whole_along(x, 1)``)."""
    return whole_along(x, 1)


__all__ = [
    "clear_sharding_context", "current", "grad_whole_along", "hint", "reduced", "seq_whole",
    "set_sharding_context", "sharding_context", "whole_along",
]
