"""3×3 weighted valid convolution: a hand-written CUDA kernel
(``csrc/stencil3x3.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/stencil.py:23``
(``_stencil_kernel``, launched at ``:54``), the generated gaussian kernel's
hand-written baseline.  The TPU kernel pushes three row-shifted views of
the padded input through BlockSpecs of ``block_h`` rows, one grid step per
panel.  The CUDA kernel does not carry those BlockSpecs over: a thread owns
``V`` consecutive outputs of a band of ``R`` rows and loads the band's
``R + 2`` input rows into registers before its first sum, so many bytes
are in flight at once; ``plan`` cuts the image into strips and bands from
its shape.  ``block_h`` keeps the JAX signature, but neither the JAX
kernel's row panels nor these bands change a result: each output is the
same nine products summed from 0 in ``dy``-then-``dx`` order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda

KERNEL = CudaLauncher(
    "stencil3x3", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4, "src/repro/kernels/stencil.py:23"
)

# outputs a thread computes along a row (16 bytes of them), and the band
# height ``R`` the kernel is compiled for (``ROWS`` in ``csrc/stencil3x3.cu``)
LANES = {torch.float32: 4, torch.bfloat16: 8}
ROWS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, dtype: torch.dtype) -> dict:
    """How the kernel cuts an (H, W) output, from shape and dtype alone:
    ``v`` outputs a thread along a row; ``threads`` a block (a multiple of
    32, at most 256: the most that leave the fewest idle threads in the
    last strip of ``threads * v`` columns); ``rows``, the band ``R``; and
    the launch's ``strips``, ``bands`` and ``blocks``."""
    v = LANES[dtype]
    cols = _cdiv(w, v)
    threads = min(range(32, 257, 32), key=lambda t: (_cdiv(cols, t) * t - cols, -t))
    strips = _cdiv(cols, threads)
    bands = _cdiv(h, ROWS)
    return {"v": v, "threads": threads, "rows": ROWS, "strips": strips, "bands": bands,
            "blocks": strips * bands}


def blocks_per_sm(x: torch.Tensor) -> int:
    """How many blocks of the kernel a call on ``x`` launches fit an SM, from
    the CUDA runtime (the instantiation ``x``'s alignment selects).  CUDA
    tensors only."""
    require_cuda("stencil3x3", x)
    h, w = x.shape[0] - 2, x.shape[1] - 2
    p = plan(h, w, x.dtype)
    out = ctypes.c_int()
    query = KERNEL.symbol("stencil3x3_occupancy", [ctypes.c_void_p] + [ctypes.c_int] * 3
                          + [ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(x.device):
        rc = query(x.data_ptr(), w, DTYPE_CODE[x.dtype], p["threads"], ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"stencil3x3: occupancy query failed (cudaError {rc})")
    return out.value


def _check(x: torch.Tensor, weights: torch.Tensor) -> None:
    """The JAX kernel's argument checks.  Its block height is not
    computed: the JAX kernel falls back to the largest divisor of H, so any
    ``block_h`` is accepted, and no block height changes a result."""
    check_dtypes("stencil3x3", x)
    if x.ndim != 2 or x.shape[0] < 3 or x.shape[1] < 3:
        raise ValueError(f"stencil3x3: x must be (H+2, W+2) with H, W >= 1, got {tuple(x.shape)}")
    if tuple(weights.shape) != (3, 3):
        raise ValueError(f"stencil3x3: weights must be (3, 3), got {tuple(weights.shape)}")


def stencil3x3(
    x: torch.Tensor, weights: torch.Tensor, *, block_h: Optional[int] = None
) -> torch.Tensor:
    """x: (H+2, W+2) padded input, weights: (3, 3) -> (H, W) in x's dtype,
    by the CUDA kernel, one launch.  CUDA tensors only."""
    _check(x, weights)
    dev = require_cuda("stencil3x3", x)
    xc = x.contiguous()
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev).contiguous()
    h, wd = x.shape[0] - 2, x.shape[1] - 2
    p = plan(h, wd, x.dtype)
    out = torch.empty((h, wd), dtype=x.dtype, device=dev)
    KERNEL(dev, xc.data_ptr(), w.data_ptr(), out.data_ptr(), h, wd, DTYPE_CODE[x.dtype],
           p["threads"])
    return out


def stencil3x3_plain(
    x: torch.Tensor, weights: torch.Tensor, *, block_h: Optional[int] = None
) -> torch.Tensor:
    """The plain PyTorch version: the Pallas body's f32 accumulation over
    the whole image at once (row panels do not change a value); the weights
    stay a tensor on x's device, so each product rounds as the kernel's."""
    _check(x, weights)
    h, wd = x.shape[0] - 2, x.shape[1] - 2
    xf = x.float()
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    acc = torch.zeros((h, wd), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + w[dy, dx] * xf[dy : dy + h, dx : dx + wd]
    return acc.to(x.dtype)


__all__ = ["KERNEL", "blocks_per_sm", "plan", "stencil3x3", "stencil3x3_plain"]
