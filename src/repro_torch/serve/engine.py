"""Batched serving: greedy decode with a KV cache — the port of the JAX
package's ``serve/engine.py``.

``make_serve_step`` is the single-token decode program: one new token per
slot against the cache.  ``ServeEngine`` is the small driver: fixed batch
slots, greedy sampling, per-slot stop handling (continuous-batching lite),
the prompts fed token by token through ``decode_step`` as the JAX engine
feeds them.  Decode launches no hand-written kernel (the JAX model's decode
reaches no Pallas kernel).

``kv_cache_specs`` gives every cache entry its spec under a sharding plan:
the sequence dim over ``model`` (flash-decoding; the paper's *chaining*
across chips), batch over the data axes; for batch-1 long-context decode the
sequence shards over both axes.  Given a ``plan``, ``ServeEngine`` places
its cache by those specs on the plan's mesh and decodes under the plan's
sharding context.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.context import sharding_context, whole_along
from repro_torch.distributed.sharding import P, axis_sizes, placements
from repro_torch.models import decode_step, init_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _leaves
from .slots import pad_to_slots


def kv_cache_specs(plan, cache_shapes: Dict) -> Dict:
    """PartitionSpecs for every cache entry, by shape."""
    mesh = plan.mesh
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in sizes if a in ("pod", "data"))
    dpn = 1
    for a in dp:
        dpn *= sizes[a]
    msize = sizes["model"]

    ATTN = ("k", "v", "shared_k", "shared_v")

    def spec_for(name: str, shape) -> P:
        # attention caches are (L|napp, B, H, S, D): seq is dim 3
        batch = shape[1]
        entries = [None] * len(shape)
        if batch % dpn == 0 and batch >= dpn:
            entries[1] = dp
            if name in ATTN and shape[3] % msize == 0:
                entries[3] = "model"        # seq over model (flash-decoding)
        elif name in ATTN:
            total = dpn * msize
            if shape[3] % total == 0:
                entries[3] = dp + ("model",)  # batch-1: seq over everything
            elif shape[3] % msize == 0:
                entries[3] = "model"
        else:
            # ssm states with undivisible batch: shard heads over model
            if len(shape) >= 3 and shape[2] % msize == 0:
                entries[2] = "model"
        return P(*entries)

    return {k: spec_for(k, v.shape) for k, v in cache_shapes.items()}


def place_cache(plan, cache: Dict[str, torch.Tensor]) -> Dict[str, DTensor]:
    """Each cache tensor as a DTensor on the plan's mesh, laid out by
    ``kv_cache_specs``."""
    specs = kv_cache_specs(plan, cache)
    return {k: distribute_tensor(v, plan.mesh, placements(specs[k], plan.mesh))
            for k, v in cache.items()}


def make_serve_step(cfg: ModelConfig, greedy: bool = True, *, kernels: str = "cuda") -> Callable:
    """(params, cache, tokens (B,), pos) -> (next_tokens (B,) int64, cache).
    The next tokens are a plain tensor, the same on every rank, also when
    the parameters and cache are DTensors."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_step(cfg, params, cache, tokens, pos, kernels=kernels)
        # the vocabulary whole first: DTensor's argmax over a sharded dim
        # gathers wrongly for a batch of one (torch 2.13)
        nxt = torch.argmax(whole_along(logits, -1), dim=-1)
        return (nxt.full_tensor() if isinstance(nxt, DTensor) else nxt), cache

    return serve_step


@dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot batched greedy decoding (continuous-batching lite).  The
    cache is f32 on the parameters' device, as the JAX engine's;
    ``kernels`` is ``decode_step``'s (``"eager"`` for CPU tensors).  With a
    sharding ``plan`` (the parameters then DTensors on its mesh) the cache
    is placed by ``kv_cache_specs`` and each step runs under the plan's
    sharding context."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int, max_seq: int, *,
                 kernels: str = "cuda", plan=None):
        self.cfg = cfg
        self.params = params
        self.batch = batch_slots
        self.max_seq = max_seq
        self.plan = plan
        self.device = next(t for _, t in _leaves(params)).device
        self.cache = init_kv_cache(cfg, batch_slots, max_seq, dtype=torch.float32,
                                   device=self.device)
        if plan is not None:
            self.cache = place_cache(plan, self.cache)
        self.step_fn = make_serve_step(cfg, kernels=kernels)
        self.pos = 0

    @torch.no_grad()
    def run(self, requests: List[Request]) -> List[Request]:
        if self.plan is None:
            return self._run(requests)
        with sharding_context(self.plan.mesh, self.plan):
            return self._run(requests)

    def _run(self, requests: List[Request]) -> List[Request]:
        reqs = pad_to_slots(
            requests, self.batch, lambda: Request(prompt=[0], max_new=0)
        )
        max_prompt = max(len(r.prompt) for r in reqs)
        total = max_prompt + max(r.max_new for r in reqs)
        if total > self.max_seq:
            raise ValueError(f"prompt and new tokens need {total} positions; the cache has "
                             f"{self.max_seq}")
        tok = np.zeros((self.batch,), np.int64)
        for t in range(total - 1):
            for i, r in enumerate(reqs):
                if t < len(r.prompt):
                    tok[i] = r.prompt[t]
            nxt, self.cache = self.step_fn(
                self.params, self.cache, torch.from_numpy(tok).to(self.device), t
            )
            nxt = nxt.cpu().numpy()
            for i, r in enumerate(reqs):
                # the model's prediction becomes input once the prompt is done
                if t + 1 >= len(r.prompt) and not r.done:
                    if len(r.generated) < r.max_new:
                        r.generated.append(int(nxt[i]))
                        tok[i] = int(nxt[i])
                    else:
                        r.done = True
        return reqs


__all__ = [
    "ServeEngine",
    "Request",
    "kv_cache_specs",
    "make_serve_step",
    "pad_to_slots",
    "place_cache",
]
