"""Oracles for the hand-written kernels: a torch port of the JAX package's
``src/repro/kernels/ref.py``, one function per oracle, with its semantics
(dtypes, the end-aligned causal diagonal, the sequential SSD recurrence).

``kernels="ref"`` in :mod:`repro_torch.kernels.ops` selects them; the CPU
tests hold them against the JAX oracles and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def stencil3x3_ref(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x: (H+2, W+2) padded input; weights: (3, 3) -> out (H, W).

    Accumulates in ``x.dtype`` promoted with ``weights.dtype``, as the JAX
    oracle does (``jnp.zeros(x.dtype) + weights[dy, dx] * x[...]``; a 0-d
    torch tensor would not promote, so both operands are cast first)."""
    h, w = x.shape[0] - 2, x.shape[1] - 2
    rt = torch.promote_types(x.dtype, weights.dtype)
    out = torch.zeros((h, w), dtype=x.dtype, device=x.device)
    for dy in range(3):
        for dx in range(3):
            out = out + weights[dy, dx].to(rt) * x[dy : dy + h, dx : dx + w].to(rt)
    return out


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    *, q_offset: Optional[int] = None,
) -> torch.Tensor:
    """q (B, Sq, D), k/v (B, Skv, D) -> (B, Sq, D); under ``causal`` query
    row r stands at position ``q_offset + r``: by default ``Skv - Sq``, the
    diagonal aligned to the *end* of the KV window, as the JAX oracle's."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        off = skv - sq if q_offset is None else q_offset
        qi = torch.arange(sq, device=q.device)[:, None] + off
        ki = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_ref(
    x: torch.Tensor,      # (S, H, P)   inputs per head
    dt: torch.Tensor,     # (S, H)      softplus-activated step sizes (> 0)
    a: torch.Tensor,      # (H,)        negative state decay rate per head
    b: torch.Tensor,      # (S, N)      input projection (shared across heads)
    c: torch.Tensor,      # (S, N)      output projection
) -> torch.Tensor:
    """y_t = C_t^T h_t with h_t = exp(a*dt_t) h_{t-1} + dt_t * B_t x_t^T, as a
    loop over steps with an f32 state.  Returns y: (S, H, P) in x's dtype."""
    s, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf, af = x.float(), dt.float(), b.float(), c.float(), a.float()
    hstate = torch.zeros((h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(af * dtf[t])[:, None, None]
        upd = dtf[t][:, None, None] * (xf[t][:, :, None] * bf[t][None, None, :])
        hstate = decay * hstate + upd
        ys.append(torch.einsum("hpn,n->hp", hstate, cf[t]))
    return torch.stack(ys).to(x.dtype)


__all__ = ["stencil3x3_ref", "matmul_ref", "attention_ref", "ssd_ref"]
