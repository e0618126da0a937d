"""Mamba2 SSD (state-space duality) chunked scan: two hand-written CUDA
kernels (``csrc/ssd_scan.cu``) and their plain PyTorch versions.

Replaces the Pallas kernel ``src/repro/kernels/ssd.py:27`` (``_ssd_kernel``,
launched at ``:86``).  The TPU kernel runs the chunk axis as a sequential
grid, one (L, H, P) block of x per step, with the whole (H, P, N) f32 state
in VMEM scratch.  The CUDA kernels do not carry the BlockSpecs over.
``C Bᵀ`` of a chunk is the same for every head and too large for one block
at L = 256 (256 KiB), so a first kernel (``ssd_gram``) writes its lower
triangle for every chunk into a buffer: one 64-thread block per 32×32 tile
on or below the diagonal (36 a chunk at L = 256), each thread a 4×4 tile
of explicit FMAs over float4s of C and B, which a 2-slice ``cp.async``
ring brings in 64 of N at a time (through registers where N % 4 != 0 or
the data is not on 16 bytes); a block off the diagonal also writes the
zero tile mirroring it above, so no block only writes zeros.  The state of a head depends only
on that head's inputs, so the scan kernel's (``ssd_chunk_scan``) grid is
(head, 32-wide slice of P), each block looping over the chunks in order
with its slice of the state in shared memory and reading the buffer.
``ssd_scan`` launches both, one launch each.  ``chunk`` keeps the JAX
signature, default (``plan_ssd``) and divisibility check.  dt, a, B and C
are read as f32 (the Pallas body casts them so too); x and y keep the
input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.ubplan import plan_ssd
from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda

GRAM = CudaLauncher(
    "ssd_gram", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, "src/repro/kernels/ssd.py:27",
    file="ssd_scan",
)
KERNEL = CudaLauncher(
    "ssd_scan", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6, "src/repro/kernels/ssd.py:27"
)


def _check(x, dt, a, b, c, chunk: Optional[int]) -> int:
    """The JAX kernel's argument checks; returns its chunk length."""
    check_dtypes("ssd_scan", x)
    for t in (dt, a, b, c):
        if not t.dtype.is_floating_point:
            raise TypeError(f"ssd_scan: dt, a, b, c must be floating point, got {t.dtype}")
    if x.ndim != 3:
        raise ValueError(f"ssd_scan: x must be (S, H, P), got {tuple(x.shape)}")
    s_len, h, p = x.shape
    if tuple(dt.shape) != (s_len, h) or tuple(a.shape) != (h,) or b.ndim != 2 \
            or b.shape[0] != s_len or tuple(c.shape) != tuple(b.shape):
        raise ValueError(
            "ssd_scan: want x (S, H, P), dt (S, H), a (H,), b and c (S, N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, {tuple(c.shape)}"
        )
    plan = plan_ssd(s_len, h, p, b.shape[1])
    l = chunk or min(plan.notes["chunk"], s_len)
    if s_len % l:
        raise ValueError(f"ssd_scan: seq {s_len} must divide chunk {l}")
    return l


def _check_gram(b, c, chunk: int) -> None:
    check_dtypes("ssd_gram", b, c)
    if b.ndim != 2 or tuple(c.shape) != tuple(b.shape) or chunk < 1 or b.shape[0] % chunk:
        raise ValueError(
            f"ssd_gram: want b and c (S, N) with chunk {chunk} dividing S; got "
            f"{tuple(b.shape)}, {tuple(c.shape)}"
        )


def _check_g(g, x, l: int) -> None:
    if tuple(g.shape) != (x.shape[0] // l, l, l):
        raise ValueError(f"ssd_scan: g must be (S / {l}, {l}, {l}), got {tuple(g.shape)}")


def ssd_gram(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """``C Bᵀ`` of every chunk of ``chunk`` steps, (S / chunk, chunk, chunk)
    f32, its lower triangle with zeros above, by the CUDA kernel.  CUDA
    tensors only."""
    _check_gram(b, c, chunk)
    dev = require_cuda("ssd_gram", b, c)
    s_len, n = b.shape
    bf, cf = (t.to(torch.float32).contiguous() for t in (b, c))
    g = torch.empty((s_len // chunk, chunk, chunk), dtype=torch.float32, device=dev)
    GRAM(dev, bf.data_ptr(), cf.data_ptr(), g.data_ptr(), s_len, n, chunk)
    return g


def ssd_gram_plain(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_gram``."""
    _check_gram(b, c, chunk)
    n = b.shape[1]
    bc, cc = b.float().view(-1, chunk, n), c.float().view(-1, chunk, n)
    return torch.matmul(cc, bc.transpose(1, 2)).tril()


def ssd_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    g: torch.Tensor, *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """y: (S, H, P) in x's dtype, by the scan kernel, given ``g``, the
    chunks' ``C Bᵀ`` as ``ssd_gram`` gives it.  CUDA tensors only."""
    l = _check(x, dt, a, b, c, chunk)
    _check_g(g, x, l)
    dev = require_cuda("ssd_scan", x, dt, a, b, c, g)
    s_len, h, p = x.shape
    f32 = [t.to(torch.float32).contiguous() for t in (dt, a, b, c, g)]
    xc = x.contiguous()
    y = torch.empty_like(xc)
    KERNEL(dev, xc.data_ptr(), *(t.data_ptr() for t in f32), y.data_ptr(),
           s_len, h, p, b.shape[1], l, DTYPE_CODE[x.dtype])
    return y


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """y: (S, H, P) in x's dtype, by the two CUDA kernels.  CUDA tensors only."""
    l = _check(x, dt, a, b, c, chunk)
    require_cuda("ssd_scan", x, dt, a, b, c)
    g = ssd_gram(b.float(), c.float(), l)
    return ssd_chunk_scan(x, dt, a, b, c, g, chunk=l)


def ssd_chunk_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    g: torch.Tensor, *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_chunk_scan``: the Pallas body's
    chunked dual form, chunk by chunk with the f32 state carried.  The decay
    above the diagonal is dropped with ``torch.where``: ``exp`` may overflow
    there, and ``inf * 0`` would be NaN."""
    l = _check(x, dt, a, b, c, chunk)
    _check_g(g, x, l)
    s_len, h, p = x.shape
    xf, dtf, af, bf, cf, gf = x.float(), dt.float(), a.float(), b.float(), c.float(), g.float()
    state = torch.zeros((h, p, b.shape[1]), dtype=torch.float32, device=x.device)
    y = torch.empty((s_len, h, p), dtype=torch.float32, device=x.device)
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()[:, :, None]
    for ci, t0 in enumerate(range(0, s_len, l)):
        xc, dtc, bc, cc = xf[t0 : t0 + l], dtf[t0 : t0 + l], bf[t0 : t0 + l], cf[t0 : t0 + l]
        s = torch.cumsum(af[None, :] * dtc, dim=0)                       # (L, H)
        gap = s[:, None, :] - s[None, :, :]                              # (L, L, H)
        decay = torch.where(mask, torch.exp(gap) * dtc[None, :, :], 0.0)
        y_intra = torch.einsum("lm,lmh,mhp->lhp", gf[ci], decay, xc)
        y_inter = torch.exp(s)[:, :, None] * torch.einsum("ln,hpn->lhp", cc, state)
        y[t0 : t0 + l] = y_intra + y_inter
        tail = torch.exp(s[-1][None, :] - s) * dtc                       # (L, H)
        state = torch.exp(s[-1])[:, None, None] * state + torch.einsum(
            "lh,lhp,ln->hpn", tail, xc, bc
        )
    return y.to(x.dtype)


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_scan``."""
    l = _check(x, dt, a, b, c, chunk)
    return ssd_chunk_scan_plain(x, dt, a, b, c, ssd_gram_plain(b.float(), c.float(), l), chunk=l)


__all__ = [
    "GRAM", "KERNEL", "ssd_chunk_scan", "ssd_chunk_scan_plain", "ssd_gram", "ssd_gram_plain",
    "ssd_scan", "ssd_scan_plain",
]
