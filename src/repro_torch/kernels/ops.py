"""Public wrappers for the hand-written kernels (the ``ops.py`` layer), the
counterparts of ``src/repro/kernels/ops.py:26-51``.

Each op runs the CUDA kernel by default (``kernels="cuda"``, CUDA tensors
only: CPU tensors raise ``ValueError``); ``kernels="eager"`` runs its plain
PyTorch version on any device and ``kernels="ref"`` the oracle (the JAX
package's ``use_pallas=False``).  Nothing falls back from one to another.

``attention_op`` and ``ssd_op`` are differentiable on every route: with
``kernels="cuda"``, a call that autograd records (grad enabled, an input
needing a gradient) goes through a ``torch.autograd.Function`` of ``grad``,
whose forward launches the kernel and whose backward is the gradient of the
plain version; ``"eager"`` and ``"ref"`` differentiate natively.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import ref
from ._cuda import needs_grad
from .grad import KernelAttention, KernelSSD
from .flash_attention import flash_attention, flash_attention_plain
from .matmul import matmul, matmul_plain
from .ssd import ssd_scan, ssd_scan_plain
from .stencil import stencil3x3, stencil3x3_plain

KERNEL_CHOICES = ("cuda", "eager", "ref")


def _choose(kernels: str, cuda, plain, oracle):
    if kernels not in KERNEL_CHOICES:
        raise ValueError(f"kernels must be one of {KERNEL_CHOICES}: {kernels!r}")
    return {"cuda": cuda, "eager": plain, "ref": oracle}[kernels]


def matmul_op(a: torch.Tensor, b: torch.Tensor, kernels: str = "cuda") -> torch.Tensor:
    return _choose(kernels, matmul, matmul_plain, ref.matmul_ref)(a, b)


def stencil3x3_op(x: torch.Tensor, weights: torch.Tensor, kernels: str = "cuda") -> torch.Tensor:
    return _choose(kernels, stencil3x3, stencil3x3_plain, ref.stencil3x3_ref)(x, weights)


def attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, kernels: str = "cuda",
    *, block_q: Optional[int] = None, block_kv: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """``block_q`` / ``block_kv`` are the JAX kernel's blocks (each must
    divide its sequence; the plan's by default); the oracle has none.
    ``q_offset``: query row r stands at position ``q_offset + r`` of the
    keys (a rank's rows of a sequence split over ranks; ``q_offset + Sq <=
    Skv`` under ``causal``), on every route; None keeps each route's own
    default (the kernels' Sq == Skv, the oracle's end-aligned diagonal)."""
    fn = _choose(kernels, flash_attention, flash_attention_plain, ref.attention_ref)
    if kernels == "ref":
        return fn(q, k, v, causal=causal, q_offset=q_offset)
    if kernels == "cuda" and needs_grad(q, k, v):
        return KernelAttention.apply(q, k, v, causal, block_q, block_kv, q_offset)
    return fn(q, k, v, causal=causal, block_q=block_q, block_kv=block_kv, q_offset=q_offset)


def ssd_op(x, dt, a, b, c, kernels: str = "cuda", *, chunk: Optional[int] = None) -> torch.Tensor:
    """``chunk`` is the JAX kernel's chunk length (it must divide S; the
    plan's by default); the oracle's recurrence has none."""
    fn = _choose(kernels, ssd_scan, ssd_scan_plain, ref.ssd_ref)
    if kernels == "ref":
        return fn(x, dt, a, b, c)
    if kernels == "cuda" and needs_grad(x, dt, a, b, c):
        return KernelSSD.apply(x, dt, a, b, c, chunk)
    return fn(x, dt, a, b, c, chunk=chunk)


def to_tensor(
    arr, dtype: Optional[torch.dtype] = None, device: Union[str, torch.device] = "cuda"
) -> torch.Tensor:
    """A tensor on ``device`` (the card unless the caller asks for the CPU)
    holding ``arr``: a numpy array, or anything ``numpy.asarray`` takes, the
    JAX package's arrays among them.  A bfloat16 array (``ml_dtypes``'
    type, which ``torch.from_numpy`` cannot read) is carried bit for bit
    through its 16-bit pattern; ``dtype`` then casts, rounding to nearest
    even as numpy and JAX do."""
    host = np.array(arr, copy=True, order="C")
    if host.dtype.name == "bfloat16":
        t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host)
    return t.to(device=device, dtype=dtype or t.dtype)


__all__ = ["KERNEL_CHOICES", "attention_op", "matmul_op", "ssd_op", "stencil3x3_op", "to_tensor"]
