"""3×3 weighted valid convolution: a hand-written CUDA kernel
(``csrc/stencil3x3.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/stencil.py:23``
(``_stencil_kernel``, launched at ``:54``), the generated gaussian kernel's
hand-written baseline.  The TPU kernel pushes three row-shifted views of
the padded input through BlockSpecs of ``block_h`` rows, one grid step per
panel.  The CUDA kernel does not carry those BlockSpecs over: a block of
128 threads covers 128 output columns and 16 rows, and each thread walks
down its column with the 3×3 window in registers.  ``block_h`` keeps the
JAX signature, default (``plan_stencil``) and fallback (the largest
divisor of H), but no tiling changes a result: each output is the same
nine products summed from 0 in ``dy``-then-``dx`` order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.ubplan import plan_stencil
from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda

KERNEL = CudaLauncher(
    "stencil3x3", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, "src/repro/kernels/stencil.py:23"
)


def _check(x: torch.Tensor, weights: torch.Tensor, block_h: Optional[int]) -> int:
    """The JAX kernel's argument checks; returns its block height."""
    check_dtypes("stencil3x3", x)
    if x.ndim != 2 or x.shape[0] < 3 or x.shape[1] < 3:
        raise ValueError(f"stencil3x3: x must be (H+2, W+2) with H, W >= 1, got {tuple(x.shape)}")
    if tuple(weights.shape) != (3, 3):
        raise ValueError(f"stencil3x3: weights must be (3, 3), got {tuple(weights.shape)}")
    h, w = x.shape[0] - 2, x.shape[1] - 2
    plan = plan_stencil(h, w, halo=1, dtype_bytes=x.element_size())
    bh = block_h or min(plan.notes["bh"], h)
    while h % bh:          # fall back to the largest dividing block height
        bh -= 1
    return bh


def stencil3x3(
    x: torch.Tensor, weights: torch.Tensor, *, block_h: Optional[int] = None
) -> torch.Tensor:
    """x: (H+2, W+2) padded input, weights: (3, 3) -> (H, W) in x's dtype,
    by the CUDA kernel.  CUDA tensors only."""
    _check(x, weights, block_h)
    dev = require_cuda("stencil3x3", x)
    xc = x.contiguous()
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev).contiguous()
    h, wd = x.shape[0] - 2, x.shape[1] - 2
    out = torch.empty((h, wd), dtype=x.dtype, device=dev)
    KERNEL(dev, xc.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, DTYPE_CODE[x.dtype])
    return out


def stencil3x3_plain(
    x: torch.Tensor, weights: torch.Tensor, *, block_h: Optional[int] = None
) -> torch.Tensor:
    """The plain PyTorch version: the Pallas body's f32 accumulation over
    the whole image at once (row panels do not change a value); the weights
    stay a tensor on x's device, so each product rounds as the kernel's."""
    _check(x, weights, block_h)
    h, wd = x.shape[0] - 2, x.shape[1] - 2
    xf = x.float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    acc = torch.zeros((h, wd), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + w[dy, dx] * xf[dy : dy + h, dx : dx + wd]
    return acc.to(x.dtype)


__all__ = ["KERNEL", "stencil3x3", "stencil3x3_plain"]
