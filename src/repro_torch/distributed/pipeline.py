"""Pipeline parallelism over the ``pod`` axis (optional alternative to DP)
— the port of the JAX package's ``distributed/pipeline.py``.

GPipe-style schedule: each pod holds a contiguous stage of layers;
microbatches stream through the stages, and the inter-pod handoff is a
point-to-point ring — the paper's *chained* unified buffers at the coarsest
granularity (a stage's activations are pushed to the next stage's buffer on
a static schedule; the bubble is the pipeline's startup delay, exactly like
the line-buffer startup cycles).

Schedule (F = stages, M = microbatches):  step t ∈ [0, M+F-1); stage s works
on microbatch t-s when 0 <= t-s < M.  All stages execute the same program
every step (SPMD-uniform), with masking for bubble steps.  Each step's
output goes to stage ``(s + 1) % F`` by one ``batch_isend_irecv`` in the
axis's process group (the push after the last step is skipped: nothing
reads it, and a 1-stage ring then sends nothing).  At the end the last
stage broadcasts its outputs, which is what the JAX module's masked
``psum`` computes.

Forward only: the point-to-point pushes carry no gradient, so a call under
autograd raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


def _stage_slice(t: torch.Tensor, mesh, axis: str, stage: int) -> torch.Tensor:
    """This stage's slice of a leaf stacked on a leading stage axis: a
    DTensor is laid out with the stage axis over ``axis`` and its local
    block taken; a plain tensor holds every stage and is indexed."""
    if not isinstance(t, DTensor):
        return t[stage]
    dim = mesh.mesh_dim_names.index(axis)
    pl = [Shard(0) if i == dim else Replicate() for i in range(mesh.ndim)]
    return t.redistribute(mesh, pl).to_local()[0]


def _tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_forward(
    apply_stage: Callable,   # (stage_params, x (mb, ...), stage_idx) -> y
    mesh,
    axis: str = "pod",
):
    """Returns fn(stage_params_stacked, microbatches) -> outputs.

    ``stage_params_stacked``: a tensor or a dict tree of them with a leading
    stage axis, as DTensors (any layout) or plain tensors holding every
    stage.  ``microbatches``: (M, mb, ...), the same on every rank (a plain
    tensor or a DTensor); outputs: (M, mb, ...) from the last stage, a plain
    tensor, the same on every rank."""
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(dim)
    group = mesh.get_group(axis)

    def fn(stage_params_stacked, microbatches):
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in _leaf_list(stage_params_stacked) + [microbatches]
        ):
            raise NotImplementedError("pipeline_forward is forward only; run it under "
                                      "torch.no_grad()")
        stage = mesh.get_local_rank(axis)
        micro = microbatches
        if isinstance(micro, DTensor):
            micro = micro.full_tensor()
        params_stage = _tree(lambda t: _stage_slice(t, mesh, axis, stage), stage_params_stacked)
        m = micro.shape[0]
        nxt_rank = dist.get_global_rank(group, (stage + 1) % n_stages)
        prev_rank = dist.get_global_rank(group, (stage - 1) % n_stages)
        last = n_stages - 1

        buf = torch.zeros_like(micro[0])
        outs = torch.zeros_like(micro)
        steps = m + n_stages - 1
        for t in range(steps):
            mb_idx = t - stage                       # microbatch this stage sees
            active = 0 <= mb_idx < m
            # stage 0 ingests from the microbatch stream; others from buf
            x_in = micro[min(max(mb_idx, 0), m - 1)] if stage == 0 else buf
            y = apply_stage(params_stage, x_in, stage)
            if not active:
                y = buf
            # the last stage records its finished microbatch
            done_idx = t - last
            if stage == last and 0 <= done_idx < m:
                outs[done_idx] = y
            # push to the next stage (ring; the last stage's push wraps harmlessly)
            if t + 1 < steps:
                if n_stages == 1:
                    buf = y
                else:
                    recv = torch.empty_like(y)
                    ops = [dist.P2POp(dist.isend, y.contiguous(), nxt_rank, group),
                           dist.P2POp(dist.irecv, recv, prev_rank, group)]
                    for req in dist.batch_isend_irecv(ops):
                        req.wait()
                    buf = recv
        # broadcast the last stage's results to every pod
        if n_stages > 1:
            dist.broadcast(outs, src=dist.get_global_rank(group, last), group=group)
        return outs

    return fn


def _leaf_list(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaf_list(v)]
    return [tree]


__all__ = ["pipeline_forward"]
