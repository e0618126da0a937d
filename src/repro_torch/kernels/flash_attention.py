"""Blockwise (flash) attention with an online softmax: a hand-written CUDA
kernel (``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py:29``
(``_flash_kernel``, launched at ``:95``).  The TPU kernel walks a
(B, Sq/bq, Skv/bkv) grid with the KV axis innermost, keeping the running
max and sum as (bq, 128)-lane VMEM tiles and skipping KV blocks wholly
above the causal diagonal.  The CUDA kernels do not carry the BlockSpecs
over: a block per (folded batch-head, query tile) loops over KV tiles up to
the diagonal, with the statistics one float per row and the masked scores
``-1e30`` as on the TPU.  ``q_offset`` places query row r at position
``q_offset + r`` of the keys (``q_offset + Sq <= Skv``): a rank's own rows
of a sequence split over ranks, the JAX attention's ``q_offset``
(``src/repro/models/layers.py:chunked_gqa_attention``).  With none, causal
masking takes Sq == Skv, the Pallas kernel's self-attention.  ``route``
picks one by dtype and shape alone:

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 inputs with a head
  dim that is a multiple of 8 (so that TMA can read their rows; an input
  whose data does not start on a 16-byte boundary is copied to one that
  does) and at most 256.  K and V tiles by TMA, Q Kᵀ and P V on the tensor
  cores (``wgmma``), P rounded to bf16 for its product.  Up to D 128, 128
  query rows a block (a warpgroup of 64 each) and KV tiles of 128 rows;
  above it (gemma3-1b's 256), 64 query rows a block, one warpgroup, and
  KV tiles of 64 rows (``wgmma_plan``).
- ``"simt"`` (``csrc/flash_attention.cu``): every other call: f32, and
  bf16 head dims that are not a multiple of 8.  64 query rows a block,
  64-row KV tiles in shared memory as f32;
  each thread a register tile of 8 (D ≤ 64 by ``cp.async``, 128 threads)
  or 4 rows (256 threads) by 4 score columns, and the same rows of the
  output, read as float4s, every product an explicit fused multiply-add, the
  softmax in registers (a row across 16 lanes, ``__shfl_xor_sync``), V of
  a tile landing during its Q Kᵀ and the next K during its P V (by
  ``cp.async`` for f32 rows it can copy whole, else through registers).
  Head dims up to 256, compiled for 64, 128 or 256 (``simt_plan``).

Neither is a fallback for the other: a refused launch raises.  ``block_q``
and ``block_kv`` keep the JAX signature, defaults (``plan_attention``) and
divisibility check.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.ubplan import plan_attention
from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda, tma_aligned

NEG_INF = -1e30
MAX_HEAD_DIM = 256
SIMT_BLOCK = 64   # query rows of a SIMT block, and KV rows of its tiles

KERNEL = CudaLauncher(
    "flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3,
    "src/repro/kernels/flash_attention.py:29",
)
WGMMA = CudaLauncher(
    "flash_attention_wgmma",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2,
    "src/repro/kernels/flash_attention.py:29",
)


def _check(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    block_q: Optional[int], block_kv: Optional[int], q_offset: Optional[int] = None,
) -> Tuple[int, int]:
    """The JAX kernel's argument checks (with no ``q_offset``, causal
    masking takes Sq == Skv), and a query offset's bound (``0 <= q_offset``,
    and ``q_offset + Sq <= Skv`` under ``causal``); returns its blocks
    (bq, bkv)."""
    check_dtypes("flash_attention", q, k, v)
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            "flash_attention: q must be (B, Sq, D) and k, v (B, Skv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    _, sq, d = q.shape
    skv = k.shape[1]
    if q_offset is None:
        if causal and sq != skv:
            raise ValueError("flash_attention: causal masking assumes self-attention layout "
                             "(Sq == Skv); a rank's query rows name their q_offset")
    elif q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got {q_offset}")
    elif causal and q_offset + sq > skv:
        raise ValueError(
            f"flash_attention: causal query rows at q_offset {q_offset} + Sq {sq} run past "
            f"Skv {skv} (causal masking needs q_offset + Sq <= Skv)"
        )
    plan = plan_attention(sq, skv, d, dtype_bytes=q.element_size())
    bq = block_q or min(plan.notes["bq"], sq)
    bkv = block_kv or min(plan.notes["bkv"], skv)
    if sq % bq or skv % bkv:
        raise ValueError(f"flash_attention: seq ({sq}, {skv}) must divide blocks ({bq}, {bkv})")
    return bq, bkv


def _route(q: torch.Tensor) -> str:
    """The route of checked inputs."""
    d = q.shape[2]
    tma = d % 8 == 0 and d <= MAX_HEAD_DIM
    return "wgmma" if q.dtype == torch.bfloat16 and tma else "simt"


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel ``flash_attention(q, k, v)`` launches: ``"wgmma"`` for
    bf16 inputs with a head dim that is a multiple of 8 (TMA's rule for
    row strides) and at most 256, else ``"simt"``.  CUDA tensors only, as
    ``flash_attention``."""
    _check(q, k, v, False, None, None)
    require_cuda("flash_attention", q, k, v)
    return _route(q)


def wgmma_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """How the tensor-core kernel takes bf16 inputs of this shape, as its
    library reports it (``csrc/flash_attention_wgmma.cu``'s ``Tile<DMAX>``,
    through ``flash_attention_wgmma_tile``): the head dim it is compiled
    for (``dmax``), its tile (``block_q`` query rows by ``block_kv`` KV
    rows), the consumer warpgroups of a block (64 query rows each), its
    threads (a producer warp among them), each block's shared memory
    (``smem_bytes``), its blocks and, from the card, the blocks an SM holds
    (``blocks_per_sm``).  CUDA tensors only."""
    dev = require_cuda("flash_attention", q, k, v)
    b, sq, d = q.shape
    tile = (ctypes.c_int * 6)()
    per_sm = ctypes.c_int()
    arg = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    rc = WGMMA.symbol("flash_attention_wgmma_tile", arg)(d, tile)
    if rc == 0:
        with torch.cuda.device(dev):
            rc = WGMMA.symbol("flash_attention_wgmma_occupancy", arg)(d, ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"flash_attention: tile or occupancy query failed (cudaError {rc})")
    keys = ("dmax", "block_q", "block_kv", "consumers", "threads", "smem_bytes")
    plan = dict(zip(keys, tile))
    plan["blocks"] = -(-sq // plan["block_q"]) * b
    plan["blocks_per_sm"] = per_sm.value
    return plan


def simt_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """How the SIMT kernel takes these inputs: its tile (``block_q`` query
    rows by ``block_kv`` KV rows), threads, the head dim it is compiled for
    (``dmax``), its blocks and how K and V reach shared memory (``copy``:
    ``"cp.async"`` for f32 with D % 4 == 0 on 16-byte boundaries, else
    ``"registers"``).  On CUDA tensors also, from the card, each block's
    shared memory (``smem_bytes``) and the blocks an SM holds
    (``blocks_per_sm``)."""
    b, sq, d = q.shape
    aligned = (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    copy = "cp.async" if q.dtype == torch.float32 and d % 4 == 0 and aligned else "registers"
    plan = {"block_q": SIMT_BLOCK, "block_kv": SIMT_BLOCK,
            "threads": 128 if d <= 64 and copy == "cp.async" else 256,
            "dmax": 64 if d <= 64 else 128 if d <= 128 else 256,
            "blocks": -(-sq // SIMT_BLOCK) * b, "copy": copy}
    if q.is_cuda:
        out = [ctypes.c_int() for _ in range(3)]
        query = KERNEL.symbol("flash_attention_occupancy", [ctypes.c_int] * 3
                              + [ctypes.POINTER(ctypes.c_int)] * 3)
        with torch.cuda.device(q.device):
            rc = query(d, DTYPE_CODE[q.dtype], int(copy == "cp.async"), *map(ctypes.byref, out))
        if rc != 0:
            raise RuntimeError(f"flash_attention: occupancy query failed (cudaError {rc})")
        plan["smem_bytes"], plan["threads"], plan["blocks_per_sm"] = (x.value for x in out)
    return plan


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: Optional[int] = None, block_kv: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Attention over (B, S, D) with batch × heads folded into B, scale
    ``1/sqrt(D)``, query row r at position ``q_offset + r`` (None: 0, and
    Sq == Skv under ``causal``, the JAX kernel's contract), by the CUDA
    kernel ``route`` names.  CUDA tensors only, or meta tensors: those go to
    the operator ``repro_torch::flash_attention``, whose fake implementation
    gives the output's shape and dtype and computes nothing (the dry run's,
    ``launch.dryrun``)."""
    _check(q, k, v, causal, block_q, block_kv, q_offset)
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: the CUDA kernel takes head dims up to {MAX_HEAD_DIM}, got {q.shape[2]}"
        )
    if q.device.type == "meta":
        require_cuda("flash_attention", q, k, v, meta=True)
        return _flash_attention_op(q, k, v, causal, q_offset or 0)
    return _launch(require_cuda("flash_attention", q, k, v), q, k, v, causal, q_offset or 0)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, q_offset: int) -> torch.Tensor:
    return _launch(q.device, q, k, v, causal, q_offset)


def _launch(dev: torch.device, q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    """The kernel's launch on checked inputs."""
    b, sq, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, d), dtype=q.dtype, device=dev)
    if _route(q) == "wgmma":
        qc, kc, vc = (tma_aligned(t) for t in (q, k, v))
        ptrs = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr())
        WGMMA(dev, *ptrs, b, sq, skv, d, 1.0 / (d ** 0.5), int(causal), q_offset)
    else:
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        ptrs = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr())
        KERNEL(dev, *ptrs, b, sq, skv, d, 1.0 / (d ** 0.5), int(causal), q_offset,
               DTYPE_CODE[q.dtype])
    return out


@_flash_attention_op.register_fake
def _(q, k, v, causal, q_offset):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: Optional[int] = None, block_kv: Optional[int] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the Pallas body's blockwise online softmax
    over (bq, bkv) blocks, query row r at position ``q_offset + r`` (None
    as in ``flash_attention``), KV blocks wholly above the diagonal skipped.
    A KV block wholly above one row but not its whole block leaves that
    row's statistics as they were (its scores are -1e30: exp gives 0 and
    rescales by 1), so a call on rows [o, o + n) at ``q_offset=o`` is bit
    for bit the whole call's rows at the same blocks."""
    bq, bkv = _check(q, k, v, causal, block_q, block_kv, q_offset)
    q_offset = q_offset or 0
    b, sq, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((b, sq, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, bq):
        qb = qf[:, q0 : q0 + bq]
        m = torch.full((b, bq, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, bq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, bq, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, bkv):
            if causal and k0 > q_offset + q0 + bq - 1:
                continue
            s = torch.matmul(qb, kf[:, k0 : k0 + bkv].transpose(1, 2)) * scale
            if causal:
                rows = q_offset + q0 + torch.arange(bq, device=q.device)[:, None]
                cols = k0 + torch.arange(bkv, device=q.device)[None, :]
                s = torch.where(cols <= rows, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vf[:, k0 : k0 + bkv])
            m = m_new
        out[:, q0 : q0 + bq] = acc / l
    return out.to(q.dtype)


__all__ = [
    "KERNEL", "MAX_HEAD_DIM", "NEG_INF", "SIMT_BLOCK", "WGMMA",
    "flash_attention", "flash_attention_plain", "route", "simt_plan", "wgmma_plan",
]
