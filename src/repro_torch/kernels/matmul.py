"""Tiled matmul with an f32 accumulator: a hand-written CUDA kernel
(``csrc/matmul.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/matmul.py:22``
(``_matmul_kernel``, launched at ``:60``), the generated matmul kernel's
hand-written baseline.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid with
K innermost, carrying a (bm, bn) f32 accumulator block in VMEM across the
K steps.  The CUDA kernel does not carry the BlockSpecs over: a block of
256 threads owns a 64×64 output tile and loops over K itself through
16-deep shared-memory slices, each thread holding 4×4 accumulators in
registers.  ``block_m/n/k`` keep the JAX signature, defaults
(``plan_matmul``) and divisibility check.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.ubplan import plan_matmul
from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda

KERNEL = CudaLauncher(
    "matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4, "src/repro/kernels/matmul.py:22"
)


def _check(
    a: torch.Tensor, b: torch.Tensor,
    block_m: Optional[int], block_n: Optional[int], block_k: Optional[int],
) -> Tuple[int, int, int]:
    """The JAX kernel's argument checks; returns its blocks (bm, bn, bk)."""
    check_dtypes("matmul", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    m, k = a.shape
    n = b.shape[1]
    plan = plan_matmul(m, n, k, dtype_bytes=a.element_size())
    bm = block_m or min(plan.notes["bm"], m)
    bn = block_n or min(plan.notes["bn"], n)
    bk = block_k or min(plan.notes["bk"], k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"matmul dims ({m},{n},{k}) must divide blocks ({bm},{bn},{bk})")
    return bm, bn, bk


def matmul(
    a: torch.Tensor, b: torch.Tensor, *,
    block_m: Optional[int] = None, block_n: Optional[int] = None, block_k: Optional[int] = None,
) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, f32 accumulation, by
    the CUDA kernel.  CUDA tensors only."""
    _check(a, b, block_m, block_n, block_k)
    dev = require_cuda("matmul", a, b)
    ac, bc = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    KERNEL(dev, ac.data_ptr(), bc.data_ptr(), out.data_ptr(), m, n, k, DTYPE_CODE[a.dtype])
    return out


def matmul_plain(
    a: torch.Tensor, b: torch.Tensor, *,
    block_m: Optional[int] = None, block_n: Optional[int] = None, block_k: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the Pallas body's accumulation over K
    blocks, ``acc += a[:, kb] @ b[kb, :]`` in f32, cast to a's dtype."""
    _, _, bk = _check(a, b, block_m, block_n, block_k)
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        acc = acc + torch.matmul(a[:, k0 : k0 + bk].float(), b[k0 : k0 + bk].float())
    return acc.to(a.dtype)


__all__ = ["KERNEL", "matmul", "matmul_plain"]
