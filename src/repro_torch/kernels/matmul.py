"""Tiled matmul with an f32 accumulator: two hand-written CUDA kernels and
their plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/matmul.py:22``
(``_matmul_kernel``, launched at ``:60``), the generated matmul kernel's
hand-written baseline.  The TPU kernel walks a (M/bm, N/bn, K/bk) grid with
K innermost, carrying a (bm, bn) f32 accumulator block in VMEM across the
K steps.  The CUDA kernels do not carry the BlockSpecs over; ``route``
picks one by dtype and shape alone:

- ``"wgmma"`` (``csrc/matmul_wgmma.cu``): bf16 operands whose K and N are
  multiples of 8, so that TMA can read their rows (an operand whose data
  does not start on a 16-byte boundary is copied to one that does).  A
  block owns a 128×256 output tile; a producer warp
  feeds a 4-stage shared-memory ring by TMA and two warpgroups multiply on
  the tensor cores (``wgmma``), accumulating in f32.
- ``"simt"`` (``csrc/matmul.cu``): every other call, f32 among them (the
  JAX kernel's f32 products are IEEE f32, which the tensor cores' TF32
  would not meet).  A block of 256 threads owns a 128×128 output tile (64
  threads and 64×64 where those cannot fill the card), each thread 8×8
  accumulators in registers fed by explicit fused multiply-adds, and loops
  over K through a 3-stage ring of 16-deep shared-memory slices filled by
  ``cp.async``.  Where even 64×64 tiles leave SMs idle, ``simt_plan`` splits
  K: the kernel writes each split's partial sums to an f32 workspace and a
  second kernel (``matmul_reduce``) adds them in order and casts, so the
  result is the same on every run.

Neither is a fallback for the other: a refused launch raises.
``block_m/n/k`` keep the JAX signature, defaults (``plan_matmul``) and
divisibility check.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.ubplan import plan_matmul
from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda, tma_aligned

KERNEL = CudaLauncher(
    "matmul", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7, "src/repro/kernels/matmul.py:22"
)
REDUCE = CudaLauncher(
    "matmul_reduce", [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
    "src/repro/kernels/matmul.py:22", file="matmul",
)
WGMMA = CudaLauncher(
    "matmul_wgmma", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, "src/repro/kernels/matmul.py:22"
)


# the SIMT kernel's output tiles, largest first, and its K slice (the
# tiles ``matmul_launch`` takes and ``BK`` of csrc/matmul.cu), the SMs its
# blocks should fill, the blocks a split call aims at (its 64-thread blocks
# run two an SM at least) and the least K a split of it should sum
SIMT_TILES = (128, 64)
SIMT_BK = 16
SM_COUNT = 132
SPLIT_BLOCKS = 2 * SM_COUNT
MIN_SPLIT_K = 64


def simt_plan(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """How the SIMT kernel runs (M, K) @ (K, N), from the shape alone:
    ``(tile, k_split, splits)``.  The largest square output tile whose
    count reaches ``SM_COUNT`` blocks; where even the smallest does not, K
    is cut into ``splits`` ranges of ``k_split`` (a multiple of the slice
    depth, at least ``MIN_SPLIT_K``), enough to bring the blocks to
    ``SPLIT_BLOCKS``."""
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    for tile in SIMT_TILES:
        tiles = cdiv(m, tile) * cdiv(n, tile)
        if tiles >= SM_COUNT:
            return tile, k, 1
    k_split = max(MIN_SPLIT_K, cdiv(cdiv(k, cdiv(SPLIT_BLOCKS, tiles)), SIMT_BK) * SIMT_BK)
    if k_split >= k:
        return tile, k, 1
    return tile, k_split, cdiv(k, k_split)


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


def _route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route of checked operands."""
    tma = a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
    return "wgmma" if a.dtype == torch.bfloat16 and tma else "simt"


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel ``matmul(a, b)`` launches: ``"wgmma"`` for bf16 operands
    whose K and N are multiples of 8 (TMA's rule for row strides), else
    ``"simt"``.  CUDA tensors only, as ``matmul``."""
    _check(a, b, None, None, None)
    require_cuda("matmul", a, b)
    return _route(a, b)


def matmul(
    a: torch.Tensor, b: torch.Tensor, *,
    block_m: Optional[int] = None, block_n: Optional[int] = None, block_k: Optional[int] = None,
) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, f32 accumulation, by
    the CUDA kernel ``route`` names.  CUDA tensors only."""
    _check(a, b, block_m, block_n, block_k)
    dev = require_cuda("matmul", a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if _route(a, b) == "wgmma":
        ac, bc = tma_aligned(a), tma_aligned(b)
        WGMMA(dev, ac.data_ptr(), bc.data_ptr(), out.data_ptr(), m, n, k)
    else:
        launch_simt(a.contiguous(), b.contiguous(), out)
    return out


def launch_simt(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """The SIMT kernel on contiguous ``a`` and ``b`` of one device, into
    ``out`` (``simt_plan``): one launch, or with K split, one into an f32
    workspace from the caching allocator and one of ``matmul_reduce``."""
    m, k = a.shape
    n = b.shape[1]
    dtype = DTYPE_CODE[a.dtype]
    tile, k_split, splits = simt_plan(m, n, k)
    ptrs = (a.data_ptr(), b.data_ptr())
    if splits == 1:
        KERNEL(a.device, *ptrs, out.data_ptr(), m, n, k, dtype, tile, k_split, 1)
        return
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
    KERNEL(a.device, *ptrs, ws.data_ptr(), m, n, k, dtype, tile, k_split, splits)
    REDUCE(a.device, ws.data_ptr(), out.data_ptr(), m * n, splits, dtype)


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


def matmul_reduce_plain(ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The plain version of ``matmul_reduce``: the f32 splits of ``ws``
    (splits, M, N) added in order, cast to ``dtype``."""
    acc = ws[0]
    for s in range(1, ws.shape[0]):
        acc = acc + ws[s]
    return acc.to(dtype)


__all__ = [
    "KERNEL", "REDUCE", "WGMMA", "launch_simt", "matmul", "matmul_plain", "matmul_reduce_plain",
    "route", "simt_plan",
]
