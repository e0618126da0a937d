"""Batched serving: greedy decode with a KV cache — the port of the JAX
package's ``serve/engine.py``.

``make_serve_step`` is the single-token decode program: one new token per
slot against the cache.  ``ServeEngine`` is the small driver: fixed batch
slots, greedy sampling, per-slot stop handling (continuous-batching lite),
the prompts fed token by token through ``decode_step`` as the JAX engine
feeds them.  Decode launches no hand-written kernel (the JAX model's decode
reaches no Pallas kernel).  The cache's ``PartitionSpec``s
(``kv_cache_specs``) come with the port of ``distributed/``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np
import torch

from repro_torch.models import decode_step, init_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _leaves
from .slots import pad_to_slots


def make_serve_step(cfg: ModelConfig, greedy: bool = True, *, kernels: str = "cuda") -> Callable:
    """(params, cache, tokens (B,), pos) -> (next_tokens (B,) int64, cache)."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_step(cfg, params, cache, tokens, pos, kernels=kernels)
        return torch.argmax(logits, dim=-1), cache

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
    ``kernels`` is ``decode_step``'s (``"eager"`` for CPU tensors)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int, max_seq: int, *,
                 kernels: str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.batch = batch_slots
        self.max_seq = max_seq
        self.device = next(t for _, t in _leaves(params)).device
        self.cache = init_kv_cache(cfg, batch_slots, max_seq, dtype=torch.float32,
                                   device=self.device)
        self.step_fn = make_serve_step(cfg, kernels=kernels)
        self.pos = 0

    @torch.no_grad()
    def run(self, requests: List[Request]) -> List[Request]:
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
    "make_serve_step",
    "pad_to_slots",
]
