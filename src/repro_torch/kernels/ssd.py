"""Mamba2 SSD (state-space duality) chunked scan: four hand-written CUDA
kernels (``csrc/ssd_scan.cu``) and their plain PyTorch versions.

Replaces the Pallas kernel ``src/repro/kernels/ssd.py:27`` (``_ssd_kernel``,
launched at ``:86``).  The TPU kernel runs the chunk axis as a sequential
grid, one (L, H, P) block of x per step, with the whole (H, P, N) f32 state
in VMEM scratch.  The CUDA kernels do not carry the BlockSpecs over: only
the state's recurrence is sequential, and it is elementwise, so the op is
split as Mamba2's own GPU implementation splits it:

* ``ssd_gram``: ``C Bᵀ`` of every chunk, its lower triangle with zeros
  above (the same for every head, and 256 KiB at L = 256, too large for one
  block): one 64-thread block per 32×32 tile on or below the diagonal, 4×4
  FMA tiles over float4s through a 2-slice ``cp.async`` ring over N.
* ``ssd_chunk_state``: per (chunk, head), the cumulative log-decay ``s``
  by a block-wide scan, into an (S, H) f32 buffer, and the chunk's own
  state contribution, an (N × L)(L × P) product, into an f32 workspace
  (S / L, H, N, P): each chunk's state transposed, P fastest.
* ``ssd_state_pass``: one thread per (h, n, p) walks the chunks in order
  and overwrites each contribution with the state entering that chunk, in
  place.
* ``ssd_chunk_out``: per (64-row tile of a chunk, chunk, head), the
  state's read-out and the intra-chunk sum into one accumulator.

The products are 64×64 output tiles of 64 threads, each an 8×8 tile of
explicit FMAs read as float4s from a two-slot ring of 16-deep slices
(``cp.async`` where every row lies on 16 bytes, through registers
otherwise).  ``ssd_chunk_scan`` launches the last three; ``ssd_scan`` all
four, one launch each.  ``chunk`` keeps the JAX signature, default
(``plan_ssd``) and divisibility check.  dt, a, B and C are read as f32 (the
Pallas body casts them so too); x and y keep the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.ubplan import plan_ssd
from ._cuda import DTYPE_CODE, CudaLauncher, check_dtypes, require_cuda

REPLACES = "src/repro/kernels/ssd.py:27"
GRAM = CudaLauncher("ssd_gram", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3, REPLACES,
                    file="ssd_scan")
STATE = CudaLauncher("ssd_chunk_state", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6, REPLACES,
                     file="ssd_scan")
PASS = CudaLauncher("ssd_state_pass", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5, REPLACES,
                    file="ssd_scan")
OUT = CudaLauncher("ssd_chunk_out", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6, REPLACES,
                   file="ssd_scan")


def _check(x, dt, a, b, c, chunk: Optional[int]) -> int:
    """The JAX kernel's argument checks (``a`` None: a kernel that does not
    read it); returns its chunk length."""
    check_dtypes("ssd_scan", x)
    for t in (dt, a, b, c):
        if t is not None and not t.dtype.is_floating_point:
            raise TypeError(f"ssd_scan: dt, a, b, c must be floating point, got {t.dtype}")
    if x.ndim != 3:
        raise ValueError(f"ssd_scan: x must be (S, H, P), got {tuple(x.shape)}")
    s_len, h, p = x.shape
    if tuple(dt.shape) != (s_len, h) or (a is not None and tuple(a.shape) != (h,)) \
            or b.ndim != 2 or b.shape[0] != s_len or tuple(c.shape) != tuple(b.shape):
        raise ValueError(
            "ssd_scan: want x (S, H, P), dt (S, H), a (H,), b and c (S, N); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {None if a is None else tuple(a.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}"
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


def _gram(dev, bf, cf, chunk: int) -> torch.Tensor:
    s_len, n = bf.shape
    g = torch.empty((s_len // chunk, chunk, chunk), dtype=torch.float32, device=dev)
    GRAM(dev, bf.data_ptr(), cf.data_ptr(), g.data_ptr(), s_len, n, chunk)
    return g


def ssd_gram(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """``C Bᵀ`` of every chunk of ``chunk`` steps, (S / chunk, chunk, chunk)
    f32, its lower triangle with zeros above, by the CUDA kernel.  CUDA
    tensors only."""
    _check_gram(b, c, chunk)
    dev = require_cuda("ssd_gram", b, c)
    return _gram(dev, *_f32(b, c), chunk)


def ssd_gram_plain(b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_gram``."""
    _check_gram(b, c, chunk)
    n = b.shape[1]
    bc, cc = b.float().view(-1, chunk, n), c.float().view(-1, chunk, n)
    return torch.matmul(cc, bc.transpose(1, 2)).tril()


def _check_f32(fn: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: dtype {t.dtype} is not supported; the states and s are float32")


def _check_states(fn: str, states, s, x_shape, n: int, chunk: int) -> None:
    """``states`` (S / chunk, H, N, P) and ``s`` (S, H), both float32."""
    _check_f32(fn, states, s)
    s_len, h, p = x_shape
    if chunk < 1 or s_len % chunk or tuple(states.shape) != (s_len // chunk, h, n, p) \
            or tuple(s.shape) != (s_len, h):
        raise ValueError(
            f"{fn}: want states (S / {chunk}, H, N, P) and s (S, H) for x {tuple(x_shape)} and "
            f"N {n}; got {tuple(states.shape)}, {tuple(s.shape)}"
        )


def _check_pass(states, s, chunk: int) -> None:
    if states.ndim != 4:
        raise ValueError(
            f"ssd_state_pass: states must be (S / L, H, N, P), got {tuple(states.shape)}"
        )
    nc, h, n, p = states.shape
    _check_states("ssd_state_pass", states, s, (nc * chunk, h, p), n, chunk)


def _f32(*tensors: torch.Tensor):
    return [t.to(torch.float32).contiguous() for t in tensors]


# The launches on checked tensors: x contiguous, everything else contiguous
# float32, all on ``dev``.

def _chunk_state(dev, xc, dtf, af, bf, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    s_len, h, p = xc.shape
    n = bf.shape[1]
    states = torch.empty((s_len // chunk, h, n, p), dtype=torch.float32, device=dev)
    s = torch.empty((s_len, h), dtype=torch.float32, device=dev)
    STATE(dev, xc.data_ptr(), dtf.data_ptr(), af.data_ptr(), bf.data_ptr(), states.data_ptr(),
          s.data_ptr(), s_len, h, p, n, chunk, DTYPE_CODE[xc.dtype])
    return states, s


def _state_pass(dev, states, s, chunk: int) -> torch.Tensor:
    nc, h, n, p = states.shape
    PASS(dev, states.data_ptr(), s.data_ptr(), nc * chunk, h, p, n, chunk)
    return states


def _chunk_out(dev, xc, dtf, cf, gf, s, states, chunk: int) -> torch.Tensor:
    s_len, h, p = xc.shape
    y = torch.empty_like(xc)
    OUT(dev, xc.data_ptr(), dtf.data_ptr(), cf.data_ptr(), gf.data_ptr(), s.data_ptr(),
        states.data_ptr(), y.data_ptr(), s_len, h, p, cf.shape[1], chunk, DTYPE_CODE[xc.dtype])
    return y


def _chunk_scan(dev, xc, dtf, af, bf, cf, gf, chunk: int) -> torch.Tensor:
    states, s = _chunk_state(dev, xc, dtf, af, bf, chunk)
    _state_pass(dev, states, s, chunk)
    return _chunk_out(dev, xc, dtf, cf, gf, s, states, chunk)


def ssd_chunk_state(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's own state contribution, (S / chunk, H, N, P) f32 (the
    state transposed), and ``s``, the cumulative log-decay inside each chunk,
    (S, H) f32, by the CUDA kernel.  CUDA tensors only."""
    l = _check(x, dt, a, b, b, chunk)
    dev = require_cuda("ssd_chunk_state", x, dt, a, b)
    return _chunk_state(dev, x.contiguous(), *_f32(dt, a, b), l)


def ssd_state_pass(states: torch.Tensor, s: torch.Tensor, chunk: int) -> torch.Tensor:
    """Overwrites ``states`` (``ssd_chunk_state``'s contributions) in place
    with the state entering each chunk, by the CUDA kernel, and returns it.
    CUDA tensors only."""
    _check_pass(states, s, chunk)
    dev = require_cuda("ssd_state_pass", states, s)
    if not (states.is_contiguous() and s.is_contiguous()):
        raise ValueError(
            "ssd_state_pass: states and s must be contiguous (states is written in place)"
        )
    return _state_pass(dev, states, s, chunk)


def ssd_chunk_out(
    x: torch.Tensor, dt: torch.Tensor, c: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
    states: torch.Tensor, chunk: int,
) -> torch.Tensor:
    """y: (S, H, P) in x's dtype, by the CUDA kernel, given the chunks'
    ``C Bᵀ`` (``ssd_gram``), ``s`` and the entering states
    (``ssd_chunk_state`` then ``ssd_state_pass``).  CUDA tensors only."""
    l = _check(x, dt, None, c, c, chunk)
    _check_g(g, x, l)
    _check_states("ssd_chunk_out", states, s, tuple(x.shape), c.shape[1], l)
    dev = require_cuda("ssd_chunk_out", x, dt, c, g, s, states)
    return _chunk_out(dev, x.contiguous(), *_f32(dt, c, g, s, states), l)


def ssd_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    g: torch.Tensor, *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """y: (S, H, P) in x's dtype, by ``ssd_chunk_state``, ``ssd_state_pass``
    and ``ssd_chunk_out``, given ``g``, the chunks' ``C Bᵀ`` as ``ssd_gram``
    gives it.  The workspace (the states and s) is allocated here.  CUDA
    tensors only."""
    l = _check(x, dt, a, b, c, chunk)
    _check_g(g, x, l)
    dev = require_cuda("ssd_scan", x, dt, a, b, c, g)
    return _chunk_scan(dev, x.contiguous(), *_f32(dt, a, b, c, g), l)


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """y: (S, H, P) in x's dtype, by the four CUDA kernels.  CUDA tensors
    only, or meta tensors: those go to the operator ``repro_torch::ssd_scan``,
    whose fake implementation gives y's shape and dtype and computes
    nothing (the dry run's, ``launch.dryrun``)."""
    l = _check(x, dt, a, b, c, chunk)
    if x.device.type == "meta":
        require_cuda("ssd_scan", x, dt, a, b, c, meta=True)
        return _ssd_scan_op(x, dt, a, b, c, l)
    return _scan(require_cuda("ssd_scan", x, dt, a, b, c), x, dt, a, b, c, l)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cuda")
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> torch.Tensor:
    return _scan(x.device, x, dt, a, b, c, chunk)


def _scan(dev: torch.device, x, dt, a, b, c, chunk: int) -> torch.Tensor:
    """The four launches on checked inputs."""
    dtf, af, bf, cf = _f32(dt, a, b, c)
    return _chunk_scan(dev, x.contiguous(), dtf, af, bf, cf, _gram(dev, bf, cf, chunk), chunk)


@_ssd_scan_op.register_fake
def _(x, dt, a, b, c, chunk):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def ssd_chunk_state_plain(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``ssd_chunk_state``: the Pallas body's
    ``s`` and state update's contribution, for every chunk at once."""
    l = _check(x, dt, a, b, b, chunk)
    s_len, h, p = x.shape
    nc, n = s_len // l, b.shape[1]
    xf, dtf = x.float().view(nc, l, h, p), dt.float().view(nc, l, h)
    s = torch.cumsum(a.float()[None, None, :] * dtf, dim=1)               # (C, L, H)
    tail = torch.exp(s[:, -1:, :] - s) * dtf
    states = torch.einsum("clh,clhp,cln->chnp", tail, xf, b.float().view(nc, l, n))
    return states, s.reshape(s_len, h)


def ssd_state_pass_plain(states: torch.Tensor, s: torch.Tensor, chunk: int) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_state_pass``, into a new tensor:
    the Pallas body's state update (``exp(s_{L-1}) * state + contribution``)
    carried over the chunks in order."""
    _check_pass(states, s, chunk)
    nc, h = states.shape[:2]
    decay = torch.exp(s.view(nc, chunk, h)[:, -1])                         # (C, H)
    out = torch.empty_like(states)
    state = torch.zeros_like(states[0])
    for ci in range(nc):
        out[ci] = state
        state = decay[ci][:, None, None] * state + states[ci]
    return out


def ssd_chunk_out_plain(
    x: torch.Tensor, dt: torch.Tensor, c: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
    states: torch.Tensor, chunk: int,
) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_chunk_out``: the Pallas body's
    intra-chunk sum and read-out, chunk by chunk.  The exponent above the
    diagonal is masked to ``-inf`` before ``exp``: ``exp`` may overflow
    there, and an overflowed ``inf`` would make ``inf * 0`` NaN in the value
    or in its gradient."""
    l = _check(x, dt, None, c, c, chunk)
    _check_g(g, x, l)
    _check_states("ssd_chunk_out", states, s, tuple(x.shape), c.shape[1], l)
    s_len, h, p = x.shape
    xf, dtf, cf, gf = x.float(), dt.float(), c.float(), g.float()
    y = torch.empty((s_len, h, p), dtype=torch.float32, device=x.device)
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()[:, :, None]
    for ci, t0 in enumerate(range(0, s_len, l)):
        sc, dtc = s[t0 : t0 + l], dtf[t0 : t0 + l]
        gap = sc[:, None, :] - sc[None, :, :]                                # (L, L, H)
        decay = torch.exp(torch.where(mask, gap, -torch.inf)) * dtc[None, :, :]
        y_intra = torch.einsum("lm,lmh,mhp->lhp", gf[ci], decay, xf[t0 : t0 + l])
        y_inter = torch.exp(sc)[:, :, None] * torch.einsum(
            "ln,hnp->lhp", cf[t0 : t0 + l], states[ci]
        )
        y[t0 : t0 + l] = y_intra + y_inter
    return y.to(x.dtype)


def ssd_chunk_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    g: torch.Tensor, *, chunk: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version of ``ssd_chunk_scan``: the Pallas body's
    chunked dual form, chunk by chunk with the f32 state carried (the
    reference of the three kernels' composition).  The exponent above the
    diagonal is masked to ``-inf`` before ``exp``: ``exp`` may overflow
    there, and an overflowed ``inf`` would make ``inf * 0`` NaN in the value
    or in its gradient."""
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
        decay = torch.exp(torch.where(mask, gap, -torch.inf)) * dtc[None, :, :]
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
    "GRAM", "OUT", "PASS", "STATE", "ssd_chunk_out", "ssd_chunk_out_plain", "ssd_chunk_scan",
    "ssd_chunk_scan_plain", "ssd_chunk_state", "ssd_chunk_state_plain", "ssd_gram",
    "ssd_gram_plain", "ssd_scan", "ssd_scan_plain", "ssd_state_pass", "ssd_state_pass_plain",
]
