"""Gradients through the hand-written attention and SSD kernels.

The JAX package differentiates its models through XLA code and has no
backward kernel (no ``custom_vjp``); the port keeps the hand-written kernels
on the training path with one ``torch.autograd.Function`` each:

* the forward launches the CUDA kernel (``flash_attention.flash_attention``,
  ``ssd.ssd_scan``) on the detached inputs and saves them;
* the backward is the vector-Jacobian product of the kernel's *plain
  version* (``flash_attention_plain``, ``ssd_scan_plain``) with the same
  blocks or chunk, recomputed on the saved inputs under autograd.

The backward is not a fallback: it is the gradient of the plain version,
the function the kernel computes, and the forward never runs the plain
version in the kernel's place.  ``ops.attention_op`` / ``ops.ssd_op`` with
``kernels="cuda"`` route here when grad is enabled and an input needs a
gradient; a direct call of the CUDA entry with such an input raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import flash_attention as _fa
from . import ssd as _ssd


def _plain_vjp(plain, inputs: Sequence[torch.Tensor], needs: Sequence[bool], grad_out, **kw):
    """The gradients of ``plain(*inputs, **kw)`` against ``grad_out`` for
    the inputs in ``needs``, None for the others; each gradient in its
    input's dtype (the plain version's casts are differentiated)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        out = plain(*leaves, **kw)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if need else None for need in needs)


class KernelAttention(torch.autograd.Function):
    """``flash_attention`` forward on the CUDA kernel; backward the VJP of
    ``flash_attention_plain`` with the same blocks and query offset.  Grads
    for q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: Optional[int], block_kv: Optional[int],
                q_offset: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.kw = {"causal": causal, "block_q": block_q, "block_kv": block_kv,
                  "q_offset": q_offset}
        return _fa.flash_attention(q.detach(), k.detach(), v.detach(), **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        grads = _plain_vjp(_fa.flash_attention_plain, ctx.saved_tensors,
                           ctx.needs_input_grad[:3], grad_out, **ctx.kw)
        return (*grads, None, None, None, None)


class KernelSSD(torch.autograd.Function):
    """``ssd_scan`` forward on the four CUDA kernels; backward the VJP of
    ``ssd_scan_plain`` with the same chunk.  Grads for x, dt, a, b and c,
    each in its caller's dtype (the kernel reads dt, a, b, c as f32)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: Optional[int]):
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return _ssd.ssd_scan(*(t.detach() for t in (x, dt, a, b, c)), chunk=chunk)

    @staticmethod
    def backward(ctx, grad_out):
        grads = _plain_vjp(_ssd.ssd_scan_plain, ctx.saved_tensors, ctx.needs_input_grad[:5],
                           grad_out, chunk=ctx.chunk)
        return (*grads, None)


__all__ = ["KernelAttention", "KernelSSD"]
