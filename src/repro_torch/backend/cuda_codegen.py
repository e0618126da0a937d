"""Plan -> CUDA C++ emission for Hopper (``sm_90a``).

``emit_kernel`` writes one CUDA kernel, plus an ``extern "C"`` launcher, for a
planned :class:`~repro_torch.backend.plan.KernelGroup`.  It replaces the JAX
package's generated Pallas kernel (``repro/backend/codegen.py``,
``emit_kernel``) and computes what that kernel computes; it is not a
block-by-block transliteration:

* **Carried axes are loops, independent axes are grid dims.**  A Pallas TPU
  grid runs in order and the generated kernel depends on it: input rings and
  line buffers rotate across row steps (or, under a lane grid, across lane
  steps) and warm up at the first step; a grid reduction accumulates into
  the revisited output block over its chunks.  CUDA blocks run in no order,
  so each carried axis becomes a loop inside one block:

  ============================  ==========================  ====================
  group                          one thread block per        loop inside
  ============================  ==========================  ====================
  row rings / line buffers       batch slot                  row steps ``i0``
  column rings / lane buffers    (row step, slot)            lane steps ``j``
  lane grid, nothing carried     (row step x lane step,      none
                                 slot)
  grid reduction                 (row step, slot)            chunks ``k``, per
                                                             output element
  anything else                  (row step, slot)            none
  ============================  ==========================  ====================

  Under a grid reduction each thread keeps one output element's
  accumulator in a register across the chunks (the element -> thread map is
  the same every chunk), so the chunk loop sits inside the element loop.
* **Shared memory holds exactly what Pallas kept in VMEM scratch**: the fused
  intermediates' panels and row or column line-buffer rings and the input
  rings (``KernelGroup.scratch_bytes``).  Delivered view blocks are read
  straight from global memory through the plan's own address arithmetic
  (resolved once in ``eager.LoweredGroup``), every load bounded by the
  buffer's extents and the view's valid rows and lanes, with 0 outside.
* **One element per thread iteration.**  Threads stride over each panel's
  elements; each evaluates the stage's lowered program (the reference
  interpreter's f32 operations in the Pallas kernel's order, reductions
  unrolled per chunk) as C.  ``__syncthreads()`` separates ring rotation,
  landing, each fused stage and the output store, in the order of the
  Pallas kernel body.

What bounds it on the H100: a stencil group does a few operations per byte
of f32 image, so it is bound by HBM bytes (``KernelGroup.hbm_bytes`` over
3.35 TB/s); a convolution over channels or a matmul does hundreds of f32
operations per element and is bound by operations (67 TFLOP/s without
tensor cores).  This version is written to be right, not fast: a
row-carried group runs on one SM per batch slot (a column-carried one on
one block per row step and slot), view taps are re-read from global memory
(through L1/L2) once per tap, and reductions use scalar f32 operations.

The library is compiled by ``build.py`` with ``-fmad=false`` and IEEE
division, so the kernel and the plain PyTorch version (``eager.py``) run the
same f32 operations in the same order and agree bit for bit; a masked
K-tail term is added as ``+ 0.0f``, as Pallas adds its zero.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

from .eager import AxisIndex, Bounds, EagerKernel, LoweredGroup, Op, Tap, _resized, block_tap
from .errors import EmitError
from .plan import KernelGroup, StagePlan

# threads per block: a carried group sweeps its steps inside one block, so
# it takes the most threads a block may have at a comfortable register
# budget
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


def _horner(idx: Sequence[str], dims: Sequence[object]) -> str:
    """Row-major linear index of ``idx`` in an array of extents ``dims``."""
    lin = f"({idx[0]})"
    for a, d in zip(idx[1:], dims[1:]):
        lin = f"({lin} * {d} + ({a}))"
    return lin


def _indent(lines: Sequence[str]) -> List[str]:
    return ["  " + ln for ln in lines]


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
        off += math.prod(r.ring_shape(kg.bh, kg.bw))
    return s_off, r_off, 4 * off


def grid_x(lg: LoweredGroup) -> int:
    """Thread blocks per batch slot (the launch's ``gridDim.x``)."""
    if lg.row_carried:
        return 1
    if lg.lane_carried:
        return lg.steps
    return lg.steps * lg.lane_steps


class _GroupEmitter:
    def __init__(self, lg: LoweredGroup, tag: str):
        self.lg = lg
        self.kg = lg.kg
        self.tag = tag
        kg = self.kg
        self.nt = THREADS_CARRIED if lg.row_carried or lg.lane_carried else THREADS_GRID
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
        self.r_shapes = [r.ring_shape(kg.bh, kg.bw) for r in kg.rings]

    # -- loads --------------------------------------------------------------

    @staticmethod
    def index(ax: AxisIndex) -> str:
        terms = [(ax.step, "i0"), (ax.lstep, "j"), (ax.kstep, "k")]
        if ax.q is not None:
            terms.append((ax.stride, f"p{ax.q}"))
        return _affine(ax.const, [t for t in terms if t[0]])

    def bounds(self, bounds: Bounds) -> List[str]:
        return [f"{self.index(ax)} < {limit}" for ax, limit in bounds]

    def tap(self, t: Tap) -> str:
        idx = [self.index(ax) for ax in t.axes]
        if t.kind == "ring":
            return f"r{t.src}[{_horner(idx, self.r_shapes[t.src])}]"
        if t.kind == "scratch":
            return f"s{t.src}[{_horner(idx, self.s_shapes[t.src])}]"
        b = self.lg.slot_of[self.kg.groups[t.src].buffer]
        dims = [f"D{b}_{j}" for j in range(len(idx))]
        ok = [f"(unsigned)({a}) < (unsigned){d}" for a, d in zip(idx, dims)]
        ok += self.bounds(t.bounds)
        return f"ub_load(g{b}, {' && '.join(ok)}, {_horner(idx, dims)})"

    def program(self, ops: Sequence[Op]) -> Tuple[List[str], str]:
        lines = []
        for k, op in enumerate(ops):
            kind = op[0]
            if kind == "const":
                rhs = _flit(op[1])
            elif kind == "iter":
                rhs = f"(float)({self.index(op[1])})"
            elif kind == "tap":
                rhs = self.tap(op[1])
            elif kind == "bin":
                a, b = f"v{op[2]}", f"v{op[3]}"
                if op[1] in _BIN_INFIX:
                    rhs = f"{a} {_BIN_INFIX[op[1]]} {b}"
                else:
                    rhs = f"{_BIN_FN[op[1]]}({a}, {b})"
            elif kind == "sel":
                rhs = f"ub_sel(v{op[1]}, v{op[2]}, v{op[3]})"
            elif kind == "mask":
                rhs = f"({' && '.join(self.bounds(op[2]))}) ? v{op[1]} : 0.f"
            else:
                rhs = "acc"
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
        out += _indent(body)
        out.append("}")
        return out

    @staticmethod
    def at(
        name: str, dims: Sequence[int], shape: Sequence[int],
        offsets: Optional[Dict[int, int]] = None,
    ) -> str:
        """``name`` (extents ``dims``) at the coordinates of a loop over
        ``shape``, shifted by ``offsets``: the flat loop index where only
        the leading axis is shifted and the trailing extents agree."""
        offsets = offsets or {}
        if set(offsets) <= {0} and tuple(shape[1:]) == tuple(dims[1:]):
            off = offsets.get(0, 0) * math.prod(dims[1:])
            return f"{name}[{off} + e]" if off else f"{name}[e]"
        idx = [_affine(offsets.get(d, 0), [(1, f"p{d}")]) for d in range(len(dims))]
        return f"{name}[{_horner(idx, dims)}]"

    def panel(
        self, sp: StagePlan, shift: int, lshift: int,
        store: Callable[[Sequence[int], str], List[str]],
        rows: Optional[int] = None, cols: Optional[int] = None,
    ) -> List[str]:
        shape = self.lg.panel_shape(sp, rows, cols)
        body, val = self.program(self.lg.programs[(sp.name, shift, lshift)])
        return self.loop(shape, body + store(shape, val))

    def rotate(self, name: str, dims: Sequence[int], axis: int, halo: int, n: int) -> List[str]:
        """Carry the ring's tail ``[n, n + halo)`` into its head on ``axis``."""
        if axis == 0:
            inner = math.prod(dims[1:])
            return [
                f"for (int e = threadIdx.x; e < {halo * inner}; e += {self.nt}) "
                f"{name}[e] = {name}[{n * inner} + e];"
            ]
        shape = _resized(dims, axis, halo)
        return self.loop(
            shape,
            [f"{self.at(name, dims, shape)} = {self.at(name, dims, shape, {axis: n})};"],
        )

    def land(self, name: str, dims: Sequence[int], axis: int, offset: int, gi: int, n: int) -> List[str]:
        """Land view group ``gi``'s block at ``offset`` on ``axis``."""
        val = self.tap(block_tap(self.kg, gi))
        shape = _resized(dims, axis, n)
        return self.loop(shape, [f"{self.at(name, dims, shape, {axis: offset})} = {val};"])

    # -- kernel -------------------------------------------------------------

    def step(self) -> List[str]:
        """One grid step of the Pallas kernel body, at ``(i0, j)``."""
        lg, kg = self.lg, self.kg
        bh, bw = kg.bh, kg.bw
        sync = "__syncthreads();"
        out: List[str] = []
        if kg.rings:
            # rotate the carried halo (or warm up at the first step), then
            # land the steady block
            for r, ring in enumerate(kg.rings):
                dims, h, ax = self.r_shapes[r], ring.halo, ring.axis
                n, var = (bw, "j") if ring.lane else (bh, "i0")
                out.append(f"if ({var} > 0) {{")
                out += _indent(self.rotate(f"r{r}", dims, ax, h, n))
                out.append("} else {")
                out += _indent(self.land(f"r{r}", dims, ax, 0, ring.prefix, h))
                out.append("}")
            out.append(sync)
            for r, ring in enumerate(kg.rings):
                n = bw if ring.lane else bh
                out += self.land(f"r{r}", self.r_shapes[r], ring.axis, ring.halo, ring.steady, n)
            out.append(sync)
        for si, (sp, key) in enumerate(lg.entries):
            name, dims, lb = f"s{si}", self.s_shapes[si], sp.line_buffer
            if key is None or (isinstance(key, tuple) and key[1] is None):
                # a row line buffer (key None) or a column ring of a lane
                # line buffer (key (row shift, None))
                lane = key is not None
                h = lb.halo
                ax, n, var = (len(dims) - 1, bw, "j") if lane else (0, bh, "i0")
                if lane:
                    warm, steady = (key[0], lb.lo), (key[0], lb.hi)
                    wkw = {"cols": h}
                else:
                    warm, steady = (lb.lo, 0), (lb.hi, 0)
                    wkw = {"rows": h}
                out.append(f"if ({var} > 0) {{")
                out += _indent(self.rotate(name, dims, ax, h, n))
                out.append("}")
                out.append(sync)
                out.append(f"if ({var} == 0) {{")
                out += _indent(self.panel(
                    sp, *warm, lambda sh, v, n=name, d=dims: [f"{self.at(n, d, sh)} = {v};"],
                    **wkw,
                ))
                out.append("}")
                out += self.panel(
                    sp, *steady,
                    lambda sh, v, n=name, d=dims, o={ax: h}: [f"{self.at(n, d, sh, o)} = {v};"],
                )
            else:
                s, t = key if isinstance(key, tuple) else (key, 0)
                out += self.panel(sp, s, t, lambda sh, v, n=name: [f"{n}[e] = {v};"])
            out.append(sync)
        out_sp = kg.output
        ext = out_sp.nstage.pure_extents
        if lg.lane_blocked(out_sp):
            nd = len(ext)
            idx = [f"i0 * {bh} + p0"] + [f"p{d}" for d in range(1, nd - 1)]
            idx.append(f"j * {bw} + p{nd - 1}")
            cond = f"i0 * {bh} + p0 < {kg.e0} && j * {bw} + p{nd - 1} < {kg.e1}"
            target = f"out[{_horner(idx, ext)}]"
        elif lg.streamed(out_sp):
            cond = f"i0 * {bh} + p0 < {kg.e0}"
            target = f"out[i0 * {bh * math.prod(ext[1:])} + e]"
        else:
            cond, target = None, "out[e]"

        def store(_shape, v):
            return [f"if ({cond}) {target} = {v};" if cond else f"{target} = {v};"]
        rg = kg.red_grid
        if rg is None:
            out += self.panel(out_sp, 0, 0, store)
        else:
            init, iv = self.program(lg.init_program)
            chunk, cv = self.program(lg.programs[(out_sp.name, 0, 0)])
            body = ["float acc;", "{"] + _indent(init) + [f"  acc = {iv};", "}"]
            body.append(f"for (int k = 0; k < {rg.steps}; ++k) {{")
            body += _indent(chunk) + [f"  acc = {cv};", "}"]
            out += self.loop(lg.panel_shape(out_sp), body + store(None, "acc"))
        if lg.row_carried or lg.lane_carried:
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
            f"bw={kg.bw}, grid={kg.grid}, rings={len(kg.rings)}, "
            f"line buffers={list(kg.line_buffered)}, "
            f"red_grid={kg.red_grid is not None}, "
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
        if lg.row_carried:
            lines.append(f"  for (int i0 = 0; i0 < {lg.steps}; ++i0) {{")
        elif lg.lane_carried:
            lines.append("  const int i0 = blockIdx.x;")
            lines.append(f"  for (int j = 0; j < {lg.lane_steps}; ++j) {{")
        elif lg.lane:
            lines.append(f"  const int i0 = blockIdx.x / {lg.lane_steps};")
            lines.append(f"  const int j = blockIdx.x % {lg.lane_steps};")
            lines.append("  {")
        else:
            lines.append("  const int i0 = blockIdx.x;")
            lines.append("  {")
        lines += ["    " + ln for ln in self.step()]
        lines += ["  }", "}", ""]
        lines += [
            f'extern "C" int ub_launch_{t}(const void* const* in, void* out, '
            "const long long* dims, void* stream) {",
            f"  UbParams{t} p;",
            f"  for (int b = 0; b < {nb}; ++b) {{",
            f"    p.in[b] = b < {len(lg.buffer_order)} ? (const float*)in[b] : nullptr;",
            f"    for (int a = 0; a < {R}; ++a) p.dims[b][a] = (int)dims[b * {R} + a];",
            "  }",
            "  p.out = (float*)out;",
            f"  cudaError_t err = cudaFuncSetAttribute(ub_kernel_{t}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, {self.smem});",
            "  if (err != cudaSuccess) return (int)err;",
            f"  ub_kernel_{t}<<<dim3({grid_x(lg)}, {kg.batch_steps}), {self.nt}, "
            f"{self.smem}, (cudaStream_t)stream>>>(p);",
            "  return (int)cudaGetLastError();",
            "}",
            "",
        ]
        return "\n".join(lines)


def emit_kernel(kg: KernelGroup, tag: str = "0", lowered: Optional[LoweredGroup] = None) -> str:
    """CUDA C++ for one kernel group: a ``__global__`` kernel and its
    ``extern "C"`` launcher ``ub_launch_<tag>``.  Deterministic in the plan.
    Raises :class:`EmitError` for a plan the port cannot run
    (``eager.check_supported``) or a scratch footprint over the H100's
    shared memory per block."""
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

    It takes CUDA tensors only: it launches the kernel on the current
    stream and counts the launch in ``launches``; a refused launch raises
    :class:`EmitError`, and tensors on any other device raise
    ``ValueError`` (the plain version, ``plain``, is an
    :class:`~repro_torch.backend.eager.EagerKernel` that callers on the
    CPU ask for by name, ``kernels="eager"``)."""

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
        if dev.type != "cuda":
            raise ValueError(
                f"kernel {kg.name!r}: the CUDA kernel takes CUDA tensors, got "
                f"{dev}; use kernels='eager' for the plain version on the CPU"
            )
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
