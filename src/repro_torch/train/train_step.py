"""Train-step builder: remat + microbatch gradient accumulation + AdamW —
the port of the JAX package's ``train/train_step.py``.

The JAX step is one XLA program whose microbatch loop is a ``lax.scan``;
here the loop is Python: each microbatch's ``forward_train`` (each layer
checkpointed under ``remat``) is differentiated with
``torch.autograd.grad``, its gradients cast by ``comm_dtype``, accumulated
in ``acc_dtype`` (f32 by default) and averaged, optionally stochastically
rounded to bf16 (``compress_grads``), then AdamW updates the state.  On
``kernels="cuda"`` the attention and SSD kernels run in the forward and in
each layer's recompute, and their backward is the plain version's gradient
(``kernels.grad``).

ZeRO-grad (``grad_shardings``, a tree of ``distributed.sharding``
``NamedSharding``s, e.g. ``zero_shardings``): with DTensor parameters,
each microbatch's gradients and the accumulator are redistributed to those
layouts (a data-parallel split on top of the parameter's), so the gradient
reduction over the data axes becomes a reduce-scatter; the optimizer then
takes each gradient to its parameter's layout.  A sharded step runs under
the plan's ``distributed.context.sharding_context``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import forward_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _leaves, _map
from .optimizer import AdamWConfig, adamw_update, stochastic_round_bf16


class TrainState(NamedTuple):
    params: Dict
    opt: Dict
    generator: torch.Generator    # the JAX key's counterpart: compress_grads' noise


def _unflatten(template: Mapping, leaves: List[torch.Tensor]) -> Dict:
    """``leaves`` (in ``_leaves`` order) as a tree shaped as ``template``."""
    it = iter(leaves)

    def build(t: Mapping) -> Dict:
        return {k: build(t[k]) if isinstance(t[k], Mapping) else next(it) for k in sorted(t)}

    return build(template)


def microbatch_grads(
    cfg: ModelConfig, params: Mapping, batch: Mapping, *, kv_chunk: int = 512,
    remat: bool = True, kernels: str = "cuda",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, the gradient of every parameter leaf in ``_leaves`` order) of
    one microbatch; a leaf the loss does not reach gets zeros, as
    ``jax.value_and_grad`` gives."""
    with torch.enable_grad():
        p = _map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = forward_train(cfg, p, batch, kv_chunk=kv_chunk, remat=remat, kernels=kernels)
        grads = torch.autograd.grad(loss, [t for _, t in _leaves(p)], allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def _rows(t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows ``start:stop`` of a batch array, a DTensor's laid out as the
    batch is (a slice of a batch-sharded dim comes back replicated: every
    rank would run the whole microbatch)."""
    rows = t[start:stop]
    return rows.redistribute(t.device_mesh, t.placements) if isinstance(t, DTensor) else rows


def batch_grads(
    cfg: ModelConfig, params: Mapping, batch: Mapping, *, microbatches: int = 1,
    kv_chunk: int = 512, remat: bool = True, comm_dtype: Optional[torch.dtype] = None,
    acc_dtype: Optional[torch.dtype] = None, kernels: str = "cuda",
    grad_shardings: Optional[Mapping] = None,
) -> Tuple[torch.Tensor, Dict]:
    """(mean loss, mean gradient tree) over ``microbatches`` equal slices
    of the batch's rows, accumulated as the JAX step's scan does; each
    microbatch's gradients and the accumulator laid out by
    ``grad_shardings`` when given."""
    shards = None if grad_shardings is None else [sh for _, sh in _leaves(grad_shardings)]

    def constrain(gs: List[torch.Tensor]) -> List[torch.Tensor]:
        if shards is None:
            return gs
        return [g.redistribute(sh.mesh, sh.placements) for g, sh in zip(gs, shards)]

    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
    mbs = b // microbatches
    adt = acc_dtype or torch.float32
    acc = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    for i in range(microbatches):
        mb = {k: _rows(v, i * mbs, (i + 1) * mbs) for k, v in batch.items()}
        loss, grads = microbatch_grads(cfg, params, mb, kv_chunk=kv_chunk, remat=remat,
                                       kernels=kernels)
        if comm_dtype is not None:
            grads = [g.to(comm_dtype) for g in grads]
        grads = constrain([g.to(adt) for g in grads])
        acc = grads if acc is None else constrain([a + g for a, g in zip(acc, grads)])
        loss_sum = loss_sum + loss
    return loss_sum / microbatches, _unflatten(params, [g / microbatches for g in acc])


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    kv_chunk: int = 512,
    remat: bool = True,
    grad_shardings: Optional[Mapping] = None,   # ZeRO-grad: accumulator layouts
    comm_dtype: Optional[torch.dtype] = None,   # per-microbatch grads cast to it
    acc_dtype: Optional[torch.dtype] = None,    # gradient accumulator (default f32)
    kernels: str = "cuda",
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics the
    tensors ``loss`` (mean over microbatches), ``grad_norm`` and ``lr``.

    ``batch["tokens"]/["labels"]``: (B, S) with B divisible by microbatches.
    The step is functional: it returns a new state and leaves the old one
    as it was, except that ``compress_grads`` draws from its generator."""

    def train_step(state: TrainState, batch: Mapping):
        loss, grads = batch_grads(
            cfg, state.params, batch, microbatches=microbatches, kv_chunk=kv_chunk,
            remat=remat, comm_dtype=comm_dtype, acc_dtype=acc_dtype, kernels=kernels,
            grad_shardings=grad_shardings,
        )
        if opt_cfg.compress_grads:
            grads = _map(lambda g: stochastic_round_bf16(g, state.generator).to(torch.float32),
                         grads)
        new_params, new_opt, om = adamw_update(opt_cfg, state.params, grads, state.opt)
        return TrainState(new_params, new_opt, state.generator), {"loss": loss, **om}

    return train_step


__all__ = ["TrainState", "batch_grads", "make_train_step", "microbatch_grads"]
