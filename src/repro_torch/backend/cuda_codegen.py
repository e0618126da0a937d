"""Plan -> CUDA C++ emission for Hopper (``sm_90a``).

``emit_kernel`` writes one CUDA kernel, plus an ``extern "C"`` launcher, for a
planned :class:`~repro_torch.backend.plan.KernelGroup`.  It replaces the JAX
package's generated Pallas kernel (``repro/backend/codegen.py``,
``emit_kernel``) and computes what that kernel computes; it is not a
block-by-block transliteration:

* **Carried axes are loops, independent axes are grid dims.**  A Pallas TPU
  grid runs in order and the generated kernel depends on it: input rings and
  line buffers rotate across row steps and warm up at row step 0 of every
  batch slot.  CUDA blocks run in no order, so a group that carries anything
  gets one thread block per batch slot, which sweeps its row steps in a loop;
  a group that carries nothing gets a grid of (row step, batch slot).
* **Shared memory holds exactly what Pallas kept in VMEM scratch**: the fused
  intermediates' panels and line-buffer rings and the input rings
  (``KernelGroup.scratch_bytes``).  Delivered view blocks are read straight
  from global memory through the plan's own address arithmetic (resolved
  once in ``eager.LoweredGroup``), every load bounded by the buffer's extents
  and the view's valid rows, with 0 outside.
* **One element per thread iteration.**  Threads stride over each panel's
  elements; each evaluates the stage's lowered program (the reference
  interpreter's f32 operations in its order, reductions unrolled) as C.
  ``__syncthreads()`` separates ring rotation, landing, each fused stage and
  the output store, in the order of the Pallas kernel body.

What bounds it on the H100: each group is a stencil over f32 images, a few
operations per byte, so it is bound by HBM bytes (``KernelGroup.hbm_bytes``
over 3.35 TB/s).  This first version is written to be right, not fast: a
carried group runs on one SM per batch slot, and view taps are re-read from
global memory (through L1/L2) once per tap.

The library is compiled by ``build.py`` with ``-fmad=false`` and IEEE
division, so the kernel and the plain PyTorch version (``eager.py``) run the
same f32 operations in the same order and agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

from .eager import EagerKernel, LoweredGroup, Op, Tap, block_tap
from .errors import EmitError
from .plan import KernelGroup, StagePlan

# threads per block: a carried group runs one block per batch slot, so it
# takes the most threads a block may have at a comfortable register budget
THREADS_CARRIED = 512
THREADS_GRID = 256

# the TPU kernel this emitter replaces, for reports
REPLACES = "src/repro/backend/codegen.py:755"

_BIN_FN = {
    "div": "ub_div",
    "min": "ub_min",
    "max": "ub_max",
    "shr": "ub_shr",
    "lt": "ub_lt",
    "gt": "ub_gt",
}
_BIN_INFIX = {"add": "+", "sub": "-", "mul": "*"}


def _flit(v: float) -> str:
    """An exact C literal of ``v`` rounded to f32."""
    with np.errstate(over="ignore"):
        f = float(np.float32(v))        # round to nearest, inf past the range
    if math.isnan(f):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(f):
        return "__int_as_float(0x7f800000)" if f > 0 else "__int_as_float(0xff800000)"
    return f"{f.hex()}f"


def _affine(const: int, terms: Sequence[Tuple[int, str]]) -> str:
    """``const + sum(coeff * var)`` as a C int expression."""
    parts = [str(const)] if const or not terms else []
    for c, v in terms:
        if c == 0:
            continue
        parts.append(v if c == 1 else f"{c} * {v}")
    return " + ".join(parts) if parts else "0"


def _horner(idx: Sequence[str], dims: Sequence[str]) -> str:
    """Row-major linear index of ``idx`` in an array of extents ``dims``."""
    lin = f"({idx[0]})"
    for a, d in zip(idx[1:], dims[1:]):
        lin = f"({lin} * {d} + ({a}))"
    return lin


def smem_layout(kg: KernelGroup) -> Tuple[List[int], List[int], int]:
    """Shared-memory float offsets of each scratch entry and each input
    ring, and the total bytes (== ``kg.scratch_bytes``)."""
    off = 0
    s_off, r_off = [], []
    for sp, key in kg.scratch_entries():
        s_off.append(off)
        off += math.prod(sp.scratch_shape(kg.bh, key))
    for r in kg.rings:
        r_off.append(off)
        off += math.prod(r.ring_shape(kg.bh))
    return s_off, r_off, 4 * off


class _GroupEmitter:
    def __init__(self, lg: LoweredGroup, tag: str):
        self.lg = lg
        self.kg = lg.kg
        self.tag = tag
        kg = self.kg
        self.nt = THREADS_CARRIED if lg.carried else THREADS_GRID
        self.ranks = []
        for b in lg.buffer_order:
            self.ranks.append(next(g.ndim for g in kg.groups if g.buffer == b))
        self.max_rank = max(self.ranks) if self.ranks else 1
        self.s_off, self.r_off, self.smem = smem_layout(kg)
        if self.smem > H100_SMEM_PER_BLOCK:
            raise EmitError(
                f"scratch of {self.smem} bytes exceeds the H100's "
                f"{H100_SMEM_PER_BLOCK}-byte shared memory per block",
                kernel=kg.name, witness=(self.smem, H100_SMEM_PER_BLOCK),
            )
        self.s_shapes = [sp.scratch_shape(kg.bh, key) for sp, key in lg.entries]
        self.r_shapes = [r.ring_shape(kg.bh) for r in kg.rings]

    # -- loads --------------------------------------------------------------

    def _axis(self, ax) -> str:
        terms = []
        if ax.step:
            terms.append((ax.step, "i0"))
        if ax.q is not None:
            terms.append((ax.stride, f"p{ax.q}"))
        return _affine(ax.const, terms)

    def tap(self, t: Tap) -> str:
        idx = [self._axis(ax) for ax in t.axes]
        if t.kind == "ring":
            dims = [str(d) for d in self.r_shapes[t.src]]
            return f"r{t.src}[{_horner(idx, dims)}]"
        if t.kind == "scratch":
            dims = [str(d) for d in self.s_shapes[t.src]]
            return f"s{t.src}[{_horner(idx, dims)}]"
        b = self.lg.slot_of[self.kg.groups[t.src].buffer]
        dims = [f"D{b}_{j}" for j in range(len(idx))]
        ok = [f"(unsigned)({a}) < (unsigned){d}" for a, d in zip(idx, dims)]
        if t.rows is not None:
            ok.append(f"{_affine(0, [(t.rows[0], 'i0'), (1, 'p0')])} < {t.rows[1]}")
        return f"ub_load(g{b}, {' && '.join(ok)}, {_horner(idx, dims)})"

    def program(self, ops: Sequence[Op]) -> Tuple[List[str], str]:
        lines = []
        for k, op in enumerate(ops):
            kind = op[0]
            if kind == "const":
                rhs = _flit(op[1])
            elif kind == "iter":
                _, q, c, step = op
                terms = [(1, f"p{q}")] + ([(step, "i0")] if step else [])
                rhs = f"(float)({_affine(c, terms)})"
            elif kind == "tap":
                rhs = self.tap(op[1])
            elif kind == "bin":
                a, b = f"v{op[2]}", f"v{op[3]}"
                if op[1] in _BIN_INFIX:
                    rhs = f"{a} {_BIN_INFIX[op[1]]} {b}"
                else:
                    rhs = f"{_BIN_FN[op[1]]}({a}, {b})"
            else:
                rhs = f"ub_sel(v{op[1]}, v{op[2]}, v{op[3]})"
            lines.append(f"const float v{k} = {rhs};")
        return lines, f"v{len(ops) - 1}"

    # -- loops --------------------------------------------------------------

    def loop(self, shape: Sequence[int], body: List[str]) -> List[str]:
        n = math.prod(shape)
        out = [f"for (int e = threadIdx.x; e < {n}; e += {self.nt}) {{"]
        if len(shape) == 1:
            out.append("  const int p0 = e;")
        else:
            out.append("  int rem = e;")
            for d in range(len(shape) - 1, 0, -1):
                out.append(f"  const int p{d} = rem % {shape[d]}; rem /= {shape[d]};")
            out.append("  const int p0 = rem;")
        out += ["  " + ln for ln in body]
        out.append("}")
        return out

    def panel(self, sp: StagePlan, shift: int, rows: Optional[int], store: Callable[[str], List[str]]) -> List[str]:
        lg, kg = self.lg, self.kg
        shape = lg.panel_shape(sp, rows)
        body, val = self.program(lg.programs[(sp.name, shift)])
        if lg.masked(sp):
            ext = kg.padded_grid.extent
            body.append(f"const float val = (p0 + i0 * {kg.bh} < {ext}) ? {val} : 0.f;")
            val = "val"
        body += store(val)
        return self.loop(shape, body)

    def rotate(self, name: str, halo: int, inner: int) -> List[str]:
        bh = self.kg.bh
        return [
            f"for (int e = threadIdx.x; e < {halo * inner}; e += {self.nt}) "
            f"{name}[e] = {name}[{bh * inner} + e];"
        ]

    def land(self, name: str, offset: int, gi: int, shape: Sequence[int]) -> List[str]:
        val = self.tap(block_tap(self.kg, gi))
        return self.loop(shape, [f"{name}[{offset} + e] = {val};"])

    # -- kernel -------------------------------------------------------------

    def body(self) -> List[str]:
        lg, kg = self.lg, self.kg
        bh = kg.bh
        sync = "__syncthreads();"
        out: List[str] = []
        if kg.rings:
            for r, ring in enumerate(kg.rings):
                shape = self.r_shapes[r]
                inner = math.prod(shape[1:])
                h = ring.halo
                out.append("if (i0 > 0) {")
                out += ["  " + ln for ln in self.rotate(f"r{r}", h, inner)]
                out.append("} else {")
                out += ["  " + ln for ln in self.land(f"r{r}", 0, ring.prefix, (h,) + tuple(shape[1:]))]
                out.append("}")
            out.append(sync)
            for r, ring in enumerate(kg.rings):
                shape = self.r_shapes[r]
                inner = math.prod(shape[1:])
                out += self.land(f"r{r}", ring.halo * inner, ring.steady, (bh,) + tuple(shape[1:]))
            out.append(sync)
        for si, (sp, key) in enumerate(lg.entries):
            name = f"s{si}"
            inner = math.prod(self.s_shapes[si][1:])
            if key is None:
                lb = sp.line_buffer
                h = lb.halo
                out.append("if (i0 > 0) {")
                out += ["  " + ln for ln in self.rotate(name, h, inner)]
                out.append("}")
                out.append(sync)
                out.append("if (i0 == 0) {")
                warm = self.panel(sp, lb.lo, h, lambda v, n=name: [f"{n}[e] = {v};"])
                out += ["  " + ln for ln in warm]
                out.append("}")
                out += self.panel(
                    sp, lb.hi, None,
                    lambda v, n=name, o=h * inner: [f"{n}[{o} + e] = {v};"],
                )
            else:
                out += self.panel(sp, key, None, lambda v, n=name: [f"{n}[e] = {v};"])
            out.append(sync)
        out_sp = kg.output
        if lg.streamed(out_sp):
            inner = math.prod(out_sp.nstage.pure_extents[1:])
            e0 = kg.e0

            def store(v):
                return [f"if (i0 * {bh} + p0 < {e0}) out[i0 * {bh * inner} + e] = {v};"]
        else:
            def store(v):
                return [f"out[e] = {v};"]
        out += self.panel(out_sp, 0, None, store)
        if lg.carried:
            out.append(sync)
        return out

    def source(self) -> str:
        lg, kg = self.lg, self.kg
        t = self.tag
        nb = max(len(lg.buffer_order), 1)
        R = self.max_rank
        out_tile = math.prod(kg.output.nstage.pure_extents)
        lines = [
            f"// kernel group {kg.name!r}: stages {kg.stage_names}, bh={kg.bh}, "
            f"grid={kg.grid}, rings={len(kg.rings)}, "
            f"line buffers={list(kg.line_buffered)}, "
            f"padded={kg.padded_grid is not None}, smem={self.smem} B",
            f"struct UbParams{t} {{",
            f"  const float* in[{nb}];",
            "  float* out;",
            f"  int dims[{nb}][{R}];",
            "};",
            "",
            f"__global__ void __launch_bounds__({self.nt}) ub_kernel_{t}(const UbParams{t} P) {{",
            "  extern __shared__ float ub_smem[];",
            "  const int slot = blockIdx.y;",
        ]
        for b, rank in enumerate(self.ranks):
            for j in range(rank):
                lines.append(f"  const int D{b}_{j} = P.dims[{b}][{j}];")
            size = " * ".join(f"(long long)D{b}_{j}" for j in range(rank))
            lines.append(
                f"  const float* __restrict__ g{b} = P.in[{b}] + (long long)slot * {size};"
            )
        lines.append(
            f"  float* __restrict__ out = P.out + (long long)slot * {out_tile}LL;"
        )
        for si, off in enumerate(self.s_off):
            lines.append(f"  float* const s{si} = ub_smem + {off};  // {self.s_shapes[si]}")
        for r, off in enumerate(self.r_off):
            lines.append(f"  float* const r{r} = ub_smem + {off};  // {self.r_shapes[r]}")
        if lg.carried:
            lines.append(f"  for (int i0 = 0; i0 < {lg.steps}; ++i0) {{")
        else:
            lines.append("  for (int i0 = blockIdx.x; i0 < blockIdx.x + 1; ++i0) {")
        lines += ["    " + ln for ln in self.body()]
        lines += ["  }", "}", ""]
        grid_x = 1 if lg.carried else lg.steps
        lines += [
            f'extern "C" int ub_launch_{t}(const void* const* in, void* out, '
            "const long long* dims, void* stream) {",
            f"  UbParams{t} p;",
            f"  for (int b = 0; b < {nb}; ++b) {{",
            f"    p.in[b] = b < {len(lg.buffer_order)} ? (const float*)in[b] : nullptr;",
            f"    for (int j = 0; j < {R}; ++j) p.dims[b][j] = (int)dims[b * {R} + j];",
            "  }",
            "  p.out = (float*)out;",
            f"  cudaError_t err = cudaFuncSetAttribute(ub_kernel_{t}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {self.smem});",
            "  if (err != cudaSuccess) return (int)err;",
            f"  ub_kernel_{t}<<<dim3({grid_x}, {kg.batch_steps}), {self.nt}, "
            f"{self.smem}, (cudaStream_t)stream>>>(p);",
            "  return (int)cudaGetLastError();",
            "}",
            "",
        ]
        return "\n".join(lines)


def emit_kernel(kg: KernelGroup, tag: str = "0", lowered: Optional[LoweredGroup] = None) -> str:
    """CUDA C++ for one kernel group: a ``__global__`` kernel and its
    ``extern "C"`` launcher ``ub_launch_<tag>``.  Deterministic in the plan.
    Raises :class:`EmitError` for a variant not ported yet or a scratch
    footprint over the H100's shared memory per block."""
    lg = lowered if lowered is not None else LoweredGroup(kg)
    return _GroupEmitter(lg, tag).source()


_PREAMBLE = """// Generated by repro_torch.backend.cuda_codegen; do not edit.
#include "ub_kernel.cuh"

extern "C" const char* ub_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

"""


def emit_library(lowered: Sequence[LoweredGroup]) -> str:
    """One ``.cu`` source holding every group of a pipeline (group ``i``
    launches through ``ub_launch_<i>``), so a pipeline builds with one
    ``nvcc`` call."""
    return _PREAMBLE + "\n".join(
        emit_kernel(lg.kg, str(i), lg) for i, lg in enumerate(lowered)
    )


class CudaKernel:
    """The wrapper of one generated CUDA kernel.

    On CUDA tensors it launches the kernel on the current stream and counts
    the launch in ``launches``; a refused launch raises :class:`EmitError`.
    On CPU tensors it runs the plain version (``plain``, the
    :class:`~repro_torch.backend.eager.EagerKernel`) — only because the
    tensors lie on the CPU."""

    def __init__(self, lg: LoweredGroup, lib: ctypes.CDLL, tag: str):
        self.lg = lg
        self.kg = lg.kg
        self.plain = EagerKernel(lg)
        self.launches = 0
        fn = getattr(lib, f"ub_launch_{tag}")
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        self._fn = fn
        self._err = lib.ub_error_string
        self._err.argtypes = [ctypes.c_int]
        self._err.restype = ctypes.c_char_p
        self._rank = max(
            (g.ndim for g in lg.kg.groups), default=1
        )

    @property
    def name(self) -> str:
        return self.kg.name

    @property
    def stage_names(self) -> List[str]:
        return self.kg.stage_names

    def __call__(self, buffers: Mapping[str, torch.Tensor]) -> torch.Tensor:
        lg, kg = self.lg, self.kg
        ts = [buffers[b] for b in lg.buffer_order]
        devs = {t.device for t in ts}
        if len(devs) != 1:
            raise ValueError(f"kernel {kg.name!r}: buffers on several devices {devs}")
        dev = devs.pop()
        if dev.type == "cpu":
            return self.plain(buffers)
        if dev.type != "cuda":
            raise ValueError(f"kernel {kg.name!r}: unsupported device {dev}")
        for b, t in zip(lg.buffer_order, ts):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(
                    f"kernel {kg.name!r}: buffer {b!r} must be a contiguous "
                    f"float32 tensor, got {t.dtype} contiguous={t.is_contiguous()}"
                )
        kg.validate_buffers(buffers)
        lead = 1 if kg.batch_grid is not None else 0
        dims: List[int] = []
        for t in ts:
            ext = list(t.shape[lead:])
            if math.prod(ext) >= 2 ** 31:
                raise ValueError(f"kernel {kg.name!r}: tile of {ext} exceeds int32 indexing")
            dims += ext + [1] * (self._rank - len(ext))
        out_shape = tuple(kg.output.nstage.pure_extents)
        if lead:
            out_shape = (kg.batch_steps,) + out_shape
        out = torch.empty(out_shape, dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])
        cdims = (ctypes.c_longlong * max(len(dims), 1))(*dims)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(ptrs, out.data_ptr(), cdims, stream)
        if rc != 0:
            raise EmitError(
                f"launch refused: {self._err(rc).decode()} (cudaError {rc})",
                kernel=kg.name,
            )
        self.launches += 1
        return out


__all__ = [
    "CudaKernel",
    "REPLACES",
    "emit_kernel",
    "emit_library",
    "smem_layout",
]
