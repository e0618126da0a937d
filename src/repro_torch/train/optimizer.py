"""AdamW with optional gradient compression — the port of the JAX
package's ``train/optimizer.py``.

Trees are the port's nested dicts of tensors.  Moments are f32; the update
keeps the JAX function's order of operations: the clip scale from the
global norm, the f32 moments, bias correction, decoupled weight decay, then
the cast back to each parameter's dtype.  The update is functional: it
returns new tensors and leaves its arguments as they were.  With DTensor
parameters the moments follow their parameter's layout, and each gradient
(ZeRO-sharded or not) is taken to it before the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import _leaves, _map

_LOW16 = 0xFFFF0000


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # gradient compression: all-reduce/accumulate grads in bf16 with
    # stochastic rounding (error stays bounded; saves 2x collective bytes)
    compress_grads: bool = False


def adamw_init(params: Mapping) -> Dict:
    """f32 zero moments shaped (and, for DTensors, laid out) as ``params``
    and a 0-d int32 ``step``, on the parameters' device."""
    dev = next(t for _, t in _leaves(params)).device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {
        "m": _map(zeros, params),
        "v": _map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def stochastic_round_bf16(
    x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding (gradient compression): the
    JAX function's ``(bits + noise) & 0xFFFF0000`` on x's f32 bits, with
    ``noise`` uniform in [0, 2**16).  ``noise`` given (integers of x's
    shape, as the JAX function draws them) makes the result bit for bit the
    JAX package's; otherwise it is drawn from ``generator``.  The unsigned
    32-bit sum is taken in int64 and masked, as torch has no uint32
    arithmetic on every device."""
    xf = x.to(torch.float32)
    if noise is None:
        noise = torch.randint(0, 1 << 16, xf.shape, generator=generator, device=xf.device,
                              dtype=torch.int64)
    bits = xf.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + noise.to(device=xf.device, dtype=torch.int64)) & _LOW16
    signed = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded).to(torch.int32)
    return signed.view(torch.float32).to(torch.bfloat16)


def global_norm(tree: Mapping) -> torch.Tensor:
    total = 0
    for _, leaf in _leaves(tree):
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


def adamw_update(
    cfg: AdamWConfig, params: Mapping, grads: Mapping, state: Mapping
) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step: (new params, new optimizer state, {"grad_norm",
    "lr"}), as the JAX function."""
    step = state["step"] + 1
    lr = _schedule(cfg, state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    c1 = 1 - cfg.b1 ** step
    c2 = 1 - cfg.b2 ** step

    def upd(p, g, m, v):
        if isinstance(g, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / c1
        vhat = v / c2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m, v

    def walk(p, g, m, v):
        if isinstance(p, Mapping):
            out = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in out.items()} for i in range(3))
        return upd(p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, state["m"], state["v"])
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "stochastic_round_bf16", "global_norm"]
