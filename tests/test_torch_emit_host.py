"""The emitted CUDA kernels, run on the CPU.

``cuda_codegen.emit_library`` writes CUDA C++ that only ``nvcc`` and a card
can build and run.  This harness compiles the same source with ``g++``
against a shim kept in this file: ``threadIdx`` and ``blockIdx`` are
thread-local, each CUDA thread of a block is a host thread, ``__syncthreads``
is a ``std::barrier``, and the launcher's ``<<<grid, block, smem, stream>>>``
becomes a host loop over the blocks (one block after another, so the
kernel's shared memory is one host array, set to NaN before each block: a
block that read what the block before it left would show).  The launcher is called through
ctypes exactly as ``CudaKernel`` calls it, with host pointers, and every
group's output is held bit for bit against ``EagerKernel`` on seeded random
f32 inputs.  ``-ffp-contract=off`` keeps g++ from fusing multiply-adds, as
``-fmad=false`` keeps nvcc.

It checks what the kernel computes for every element and every thread map,
not what the card does with it: the compiler, the memory model and the
timing are the card's tests' and ``chip_smoke.py``'s.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import make_app
from repro_torch.backend import cuda_codegen
from repro_torch.backend.build import CSRC
from repro_torch.backend.cuda_codegen import (
    carries_nothing, element_map, emit_library, hidden_tile, lane_layout, launch_dims, output_shape,
    output_tile, row_bands, shared_bytes, shift_panels, smem_layout, staged_inputs,
)
from repro_torch.backend.eager import EagerKernel, LoweredGroup
from repro_torch.backend.plan import build_pipeline_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

pytestmark = pytest.mark.torch

# (id, app, app kwargs, plan kwargs, element-parallel, band length in row
# steps forced through cuda_codegen.BAND_STEPS or None)
CASES = [
    # a lane grid with a padded lane tail
    ("resnet-lane", "resnet", {"img": 8, "cin": 4, "cout": 4}, {"block_w": 3}, True, None),
    # the full-size plan's shape: one-lane blocks, a tile of 8 output
    # channels, each tap's run of 8 input channels a loop
    ("resnet-bw1", "resnet", {"img": 6, "cin": 8, "cout": 16}, {"block_w": 1}, True, None),
    # one output channel per row step: the weights are the load shared, by
    # a tile of 5 rows
    ("resnet-ytile", "resnet", {"img": 5, "cin": 8, "cout": 11}, {"block_w": 1}, True, None),
    # 11 channels and 11 rows: no tile divides them, one element per thread
    ("resnet-untiled", "resnet", {"img": 11, "cin": 8, "cout": 11},
     {"block_w": 1, "block_h": 11}, True, None),
    # a grid reduction over a resident operand, a masked K-tail, padded rows
    ("matmul-resident", "matmul", {"m": 8, "n": 13, "k": 149},
     {"red_grid_threshold": 64, "block_h": 6}, True, None),
    # a grid reduction over chunk-streamed operands
    ("matmul-streamed", "matmul", {"m": 19, "n": 13, "k": 70},
     {"red_grid_threshold": 64, "red_resident": False}, True, None),
    ("upsample", "upsample", {"size": 16}, {}, True, None),
    # batch slots, the last padded (3 requests in 4 slots)
    ("resnet-batched", "resnet", {"img": 8, "cin": 4, "cout": 4},
     {"block_w": 3, "batch": 3, "batch_capacity": 4}, True, None),
    # a carried group: column rings and a lane line buffer, on the old loop
    ("gaussian-carried", "gaussian", {"size": 26}, {"block_w": 9, "line_buffer": True},
     False, None),
    # harris sch3 carried along its lanes, as at 2048: five row-shifted
    # column rings and three row-shifted lane line buffers a gradient, each
    # set one shared panel; 21 = 2 x 9 + 3 valid rows (the last row step
    # partial) and 21 = 4 x 5 + 1 lanes (the lane tail ragged)
    ("harris-lane-carried", "harris", {"schedule": "sch3", "size": 25},
     {"block_h": 9, "block_w": 5, "line_buffer": True}, False, None),
    # the last row step with one valid row of five, fewer than the largest
    # row shift (4); 26 = 3 x 7 + 5 lanes
    ("harris-lane-partial", "harris", {"schedule": "sch3", "size": 30},
     {"block_h": 5, "block_w": 7, "line_buffer": True}, False, None),
    # batch slots, the last padded; 17 = 3 x 5 + 2 rows, 17 = 2 x 6 + 5 lanes
    ("harris-lane-batched", "harris", {"schedule": "sch3", "size": 21},
     {"block_w": 6, "block_h": 5, "line_buffer": True, "batch": 3, "batch_capacity": 4},
     False, None),
    # mobilenet's full-size plan at small widths: one row a block, nothing
    # carried, both weight buffers staged in shared memory; 40 output
    # channels, which the register tile (32 lanes x 2 columns) does not divide
    ("mobilenet-bh1", "mobilenet", {"img": 6, "cin": 4, "cout": 40}, {"block_h": 1}, False, None),
    # three rows a block, padded (10 = 4 x 3 - 2); 11 channels, so 23
    # groups of 11 lanes and a ragged last pass over the 30 pixels
    ("mobilenet-padded", "mobilenet", {"img": 10, "cin": 8, "cout": 11},
     {"block_h": 3, "line_buffer": False}, False, None),
    # batch slots, the last padded: each block stages its own slot's weights
    ("mobilenet-batched", "mobilenet", {"img": 5, "cin": 4, "cout": 36},
     {"block_h": 1, "batch": 3, "batch_capacity": 4}, False, None),
    # an odd input width (its pointwise rows need no padding) and 33 output
    # channels: the tile's second column holds one channel, 31 lanes idle
    ("mobilenet-odd", "mobilenet", {"img": 7, "cin": 7, "cout": 33},
     {"block_h": 2, "line_buffer": False}, False, None),
    # budgets too small for the fused group's Pallas working set: planned
    # against shared memory, the pointwise weights staged in panels of the
    # input channels its reduction runs over (plan.WeightPanels), every
    # output's sum kept in registers across them.  Two panels of 8, two
    # rows a block
    ("mobilenet-panels", "mobilenet", {"img": 4, "cin": 16, "cout": 64},
     {"vmem_budget": 4000}, False, None),
    # two panels of 4, padded rows (5 = 3 x 2 - 1, the tail rows masked
    # after the chain), a tile of 64 lanes
    ("mobilenet-panels-padded", "mobilenet", {"img": 5, "cin": 8, "cout": 48},
     {"vmem_budget": 2600, "block_h": 2}, False, None),
    # batch slots, the last padded: each block stages its own slot's panels
    ("mobilenet-panels-batched", "mobilenet", {"img": 5, "cin": 8, "cout": 48},
     {"vmem_budget": 2000, "batch": 3, "batch_capacity": 4}, False, None),
    # an odd input width: the whole reduction one panel of 7, unpadded
    ("mobilenet-panels-odd", "mobilenet", {"img": 5, "cin": 7, "cout": 40},
     {"vmem_budget": 2000}, False, None),
    # 10 x 900 outputs a block, more than 256 threads' tiles hold: two
    # passes over the two panels of 2
    ("mobilenet-panels-passes", "mobilenet", {"img": 10, "cin": 4, "cout": 900},
     {"vmem_budget": 12000}, False, None),
]
# groups that chain two reductions through a hidden axis (plan.HiddenChain:
# ConvNeXt's MLP), forced at test sizes by budgets too small for the Pallas
# working set: the hidden stages evaluated one panel of the hidden axis at a
# time into shared memory, the consumer's sums in registers across the
# panels, the depthwise and LayerNorm weights read from global memory.
# Each thread evaluates a register tile of the hidden panel (two positions,
# or two hidden entries), and the consumer's sums take the depthwise panel's
# words.  Eight panels of 4 on four rows a block (fc1's reduction four terms
# a 16-byte load for both positions of a tile); twelve of 2 on a padded grid
# (5 = 2 x 4 - 3, every stage's tail rows masked); four of 10 in batch
# slots, the last padded, two hidden entries a thread; four of 3 on nine
# positions, tiles of two positions, the last tile's second past the panel
CHAIN_CASES = [
    ("convnext-chain", "convnext", {"img": 4, "dim": 8, "hidden": 32},
     {"vmem_budget": 3000}, False, None),
    ("convnext-chain-padded", "convnext", {"img": 5, "dim": 8, "hidden": 24},
     {"vmem_budget": 2200}, False, None),
    ("convnext-chain-batched", "convnext", {"img": 3, "dim": 6, "hidden": 40},
     {"vmem_budget": 3000, "batch": 3, "batch_capacity": 4}, False, None),
    ("convnext-chain-ragged", "convnext", {"img": 3, "dim": 8, "hidden": 12},
     {"vmem_budget": 1300}, False, None),
]
# Swin's block pair (the window-attention tile of each block in shared
# memory, its MLP chained) at a budget that forces the shared-memory plans
# at test sizes: every group of the pipeline, the second block's windows
# wrapping around the map and masked, once in batch slots, once with 64
# channels (the LayerNorm groups' channel sums long enough to be rolled)
WINDOW_CASES = [
    ("swin-pair", "swin", {}, {"vmem_budget": 5000}, False, None),
    ("swin-pair-batched", "swin", {"img": 4, "dim": 12, "heads": 3, "window": 2, "hidden": 24},
     {"vmem_budget": 4000, "batch": 2, "batch_capacity": 3}, False, None),
    ("swin-pair-wide", "swin", {"img": 4, "dim": 64, "heads": 2, "window": 2, "hidden": 64},
     {"vmem_budget": 10000}, False, None),
]
# element-parallel groups on the two-axis tile (cuda_codegen.element_map:
# runs of thread-axis positions by the tile, the weights or A staged a
# block), which test sizes take where the launch need fill one SM with no
# warps to spare (``PATCHES``)
TILED_CASES = [
    # runs of 3 of the 6 x positions, 2 lanes apart, by 8 output channels;
    # each block stages its 8 channels' weights
    ("resnet-bw1-run", "resnet", {"img": 6, "cin": 8, "cout": 16}, {"block_w": 1}, True, None),
    # 3 of 5 positions: the last run position past the row for one lane
    ("resnet-ytile-run", "resnet", {"img": 5, "cin": 8, "cout": 11}, {"block_w": 1}, True, None),
    # no tile: 4 of 11 positions, one output channel's weights a block
    ("resnet-untiled-run", "resnet", {"img": 11, "cin": 8, "cout": 11},
     {"block_w": 1, "block_h": 11}, True, None),
    # 4 of 7 positions
    ("resnet-tail-run", "resnet", {"img": 7, "cin": 8, "cout": 16}, {"block_w": 1}, True, None),
    # one block a chunk, two passes of its threads over the chunk's items
    ("resnet-passes", "resnet", {"img": 24, "cin": 4, "cout": 16}, {"block_w": 1}, True, None),
    # batch slots, the last padded
    ("resnet-run-batched", "resnet", {"img": 6, "cin": 8, "cout": 16},
     {"block_w": 1, "batch": 3, "batch_capacity": 4}, True, None),
    # A staged over the K-tail (its copy 0 past K) by a tile of 6 rows,
    # runs of 4 of the 13 columns, padded rows
    ("matmul-resident-run", "matmul", {"m": 8, "n": 13, "k": 149},
     {"red_grid_threshold": 64, "block_h": 6}, True, None),
    # chunk-streamed operands: the staged A holds every chunk's columns
    ("matmul-streamed-run", "matmul", {"m": 19, "n": 13, "k": 70},
     {"red_grid_threshold": 64, "red_resident": False}, True, None),
    # runs with nothing staged (no room a block): the weights from global
    # memory, each once for the run
    ("resnet-run-unstaged", "resnet", {"img": 7, "cin": 8, "cout": 16}, {"block_w": 1}, True,
     None),
]
CASES += TILED_CASES
# module constants patched while a case's library is emitted
PATCHES = {c[0]: {"SM_COUNT": 1, "WARPS_SM": 0} for c in TILED_CASES}
PATCHES["resnet-passes"]["MAX_BLOCKS_PER_SLOT"] = 2
PATCHES["resnet-run-unstaged"]["TILED_SMEM_MAX"] = 0

# row-carried groups, their sweep cut into bands of 1, 2 and 3 row steps:
# every band after the first warms its rings and line buffers up itself
ROW_CASES = [
    # an input ring (halo 2), 7 row steps
    ("gaussian-ring", "gaussian", {"size": 30}, {"block_h": 4}),
    # row line buffers on grad_x and grad_y beside a ring of halo 4
    ("harris-linebuf", "harris", {"schedule": "sch3", "size": 36},
     {"block_h": 4, "line_buffer": True}),
    # a ring, a line buffer on blur_x and padded rows: 31 = 11 x 3 - 2, so
    # the last row step holds one valid row, fewer than the halo
    ("unsharp-padded", "unsharp", {"size": 33}, {"block_h": 3, "line_buffer": True}),
    # denoise's ring (halo 2) and camera's (halo 1), both groups padded
    ("camera-denoise", "camera", {"size": 16}, {"block_h": 3}),
    # 3 requests in 4 slots
    ("unsharp-batched", "unsharp", {"size": 15},
     {"block_h": 3, "line_buffer": True, "batch": 3, "batch_capacity": 4}),
]
CASES += [
    (f"{cid}-band{steps}", name, kw, ckw, False, steps)
    for cid, name, kw, ckw in ROW_CASES for steps in (1, 2, 3)
]

SHIM = r"""
#pragma once
// Host stand-in for the CUDA runtime: just enough of it for the emitted
// kernels, ub_kernel.cuh and the SIMT kernels (matmul, flash attention, the
// SSD gram).
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* ub_block_barrier = nullptr;
// the block's dynamic shared memory: blocks run one after another
alignas(16) float ub_smem[232448 / 4];

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline void __syncthreads() { ub_block_barrier->arrive_and_wait(); }
// a warp shuffle through a block-wide exchange array: every thread of the
// block calls it together (as the kernels do), so two barriers frame it
inline float ub_exchange[1024];
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  ub_exchange[threadIdx.x] = v;
  __syncthreads();
  const float out = ub_exchange[threadIdx.x ^ lane_mask];
  __syncthreads();
  return out;
}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int min(int a, int b) { return a < b ? a : b; }
inline const char* cudaGetErrorString(cudaError_t) { return "host shim"; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

// every block of the grid, one after another; each CUDA thread of a block
// is a host thread, and the block ends (every thread past its last
// statement) before the next begins, which finds shared memory all NaN
template <class K, class... P>
void ub_host_launch(K kernel, dim3 grid, dim3 block, const P&... params) {
  gridDim = grid;
  blockDim = block;
  std::barrier<> bar(block.x);
  ub_block_barrier = &bar;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < block.x; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          for (unsigned z = 0; z < grid.z; ++z) {
            // a block finds nothing of the block before it in shared memory
            if (t == 0) std::fill(ub_smem, ub_smem + sizeof(ub_smem) / 4, NAN);
            bar.arrive_and_wait();
            blockIdx = dim3(x, y, z);
            kernel(params...);
            bar.arrive_and_wait();
          }
        }
    });
  for (auto& th : pool) th.join();
}
"""

# kernel (a template's arguments included), grid (dim3(...) with one level
# of inner parentheses, or an expression without commas), block, then the
# arguments
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<(dim3\((?:[^()]|\([^()]*\))*\)|[^<>,;]+), ([\w:]+), [^>]*>>>"
    r"\(([^;]*)\);"
)


def host_source(cuda_source: str) -> str:
    """A CUDA source with each ``<<<grid, block, ...>>>(args)`` launch made
    a host launch."""
    out, n = _LAUNCH.subn(r"ub_host_launch(\1, \2, dim3(\3), \4);", cuda_source)
    assert n == cuda_source.count("<<<"), "a launch the shim does not know"
    return out


def _plan(name, kw, ckw):
    ckw = {"vmem_budget": H100_SMEM_PER_BLOCK, **ckw}
    return build_pipeline_plan(make_app(name, **kw).pipeline, **ckw)


@pytest.fixture(scope="module")
def gxx():
    found = shutil.which("g++")
    if found is None:
        pytest.skip("g++ is not on PATH: the emitted kernels cannot be built on the host")
    return found


@pytest.fixture(scope="module")
def libraries(gxx, tmp_path_factory):
    """Every case's library, one g++ each, all started together."""
    root = tmp_path_factory.mktemp("emit_host")
    (root / "cuda_runtime.h").write_text(SHIM)
    jobs = {}
    for cid, name, kw, ckw, _ep, band in CASES + CHAIN_CASES + WINDOW_CASES:
        lowered = [LoweredGroup(kg) for kg in _plan(name, kw, ckw).kernels]
        src = root / f"{cid}.cpp"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_codegen, "BAND_STEPS", band)
            for k, v in PATCHES.get(cid, {}).items():
                mp.setattr(cuda_codegen, k, v)
            src.write_text(host_source(emit_library(lowered)))
        so = root / f"lib{cid}.so"
        cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
               "-pthread", "-w", "-I", str(root), "-I", str(CSRC), "-o", str(so), str(src)]
        jobs[cid] = (lowered, so, cmd)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        runs = dict(zip(jobs, pool.map(
            lambda cmd: subprocess.run(cmd, capture_output=True, text=True),
            [job[2] for job in jobs.values()],
        )))
    out = {}
    for cid, (lowered, so, _cmd) in jobs.items():
        run = runs[cid]
        assert run.returncode == 0, f"g++ failed for {cid}:\n{run.stderr[-4000:]}"
        out[cid] = (lowered, ctypes.CDLL(str(so)))
    return out


def host_launch(lib, tag: str, lg: LoweredGroup, bufs) -> torch.Tensor:
    """Call ``ub_launch_<tag>`` as ``CudaKernel`` does, on host tensors."""
    ts = [bufs[b] for b in lg.buffer_order]
    out = torch.full(output_shape(lg.kg), float("nan"), dtype=torch.float32)
    fn = getattr(lib, f"ub_launch_{tag}")
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    dims = launch_dims(lg, ts)
    ptrs = (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])
    cdims = (ctypes.c_longlong * max(len(dims), 1))(*dims)
    assert fn(ptrs, out.data_ptr(), cdims, None) == 0
    return out


def random_inputs(app, seed: int, batch=None, capacity=None):
    """Random normal f32 inputs; with ``capacity``, ``batch`` requests in
    that many slots, the rest zero as the runner pads them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in app.input_extents.items():
        shape = ((capacity,) if capacity else ()) + tuple(shape)
        arr = rng.standard_normal(shape).astype(np.float32)
        if capacity:
            arr[batch:] = 0.0
        out[name] = torch.from_numpy(arr)
    return out


@pytest.mark.parametrize("cid,name,kw,ckw,ep,band", CASES, ids=[c[0] for c in CASES])
def test_emitted_kernel_equals_plain_version_bit_for_bit(libraries, cid, name, kw, ckw, ep, band):
    lowered, lib = libraries[cid]
    app = make_app(name, **kw)
    bufs = random_inputs(app, 0, ckw.get("batch"), ckw.get("batch_capacity"))
    for i, lg in enumerate(lowered):
        assert (element_map(lg) is not None) == ep
        if band is not None:
            # the sweep is cut where the case says: several bands a slot
            assert lg.row_carried
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(cuda_codegen, "BAND_STEPS", band)
                bands = row_bands(lg)
            assert len(bands) > 1 and bands[0] == (0, band)
        got = host_launch(lib, str(i), lg, bufs)
        want = EagerKernel(lg)(bufs)
        assert got.shape == want.shape
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert diff == 0, (
            f"{cid}/{lg.kg.name}: {diff} elements differ, max abs "
            f"{float((got - want).abs().max())}"
        )
        bufs[lg.kg.name] = got


def _host_unop(fn_name: str):
    """``fn_name`` (``erff``, ``expf``) of each element by the host C
    library, the function the g++-built kernel calls."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), fn_name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]

    def apply(t: torch.Tensor) -> torch.Tensor:
        return torch.tensor([fn(v) for v in t.reshape(-1).tolist()],
                            dtype=torch.float32).reshape(t.shape)

    return apply


@pytest.mark.parametrize("cid", [c[0] for c in CHAIN_CASES])
def test_chained_group_equals_plain_version_bit_for_bit(libraries, cid, monkeypatch):
    """Each chained group, bit for bit with the plain version where both
    call the same C library: the plain version's ``erf`` is torch's own
    (within a few ulp of the host's ``erff``, which the g++-built kernel
    calls), so here it calls the host's ``erff`` too; every other op,
    ``sqrt`` included, is IEEE's on both sides.  The hidden axis is walked
    in several panels, and no group writes a hidden stage to memory."""
    from repro_torch.backend import eager

    monkeypatch.setitem(eager._UNOPS, "erf", _host_unop("erff"))
    lowered, lib = libraries[cid]
    (_c, name, kw, ckw, _ep, _band), = [c for c in CHAIN_CASES if c[0] == cid]
    app = make_app(name, **kw)
    bufs = random_inputs(app, 1, ckw.get("batch"), ckw.get("batch_capacity"))
    (lg,) = lowered
    ch = lg.kg.chain
    assert ch is not None and ch.count > 1 and ch.hidden == ("fc1", "gelu")
    assert ch.tile[0] * ch.tile[1] == 2 and ch.reuse == (("fc2", "dw_conv"),)
    ht = hidden_tile(lg)
    ragged = ht.groups * ht.rows > ht.outer or ht.lanes * ht.cols > ht.inner
    assert ragged == (cid == "convnext-chain-ragged")
    # the first case's fc1 reads its reduction four terms a 16-byte load
    vector = "reinterpret_cast<const float4*>" in emit_library(lowered)
    assert vector == (cid == "convnext-chain")
    assert shared_bytes(lg) == lg.kg.ws[0] * lg.kg.bh + lg.kg.ws[1]
    got = host_launch(lib, "0", lg, bufs)
    want = EagerKernel(lg)(bufs)
    diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert diff == 0, f"{cid}: {diff} elements differ, max abs {float((got - want).abs().max())}"


@pytest.mark.parametrize("cid", [c[0] for c in WINDOW_CASES])
def test_window_groups_equal_plain_version_bit_for_bit(libraries, cid, monkeypatch):
    """Every group of Swin's block pair, bit for bit with the plain version
    where both call the same C library (``erff``, ``expf`` and ``sqrtf`` the
    host's on both sides: torch's CPU square root of a vector is not always
    the correctly rounded one, and a pair's LayerNorms take many): each
    block's window-attention group holds its score tile and row statistics
    in shared memory, one head a block, and its MLP is chained."""
    from repro_torch.backend import eager

    for op, fn in (("erf", "erff"), ("exp", "expf"), ("sqrt", "sqrtf")):
        monkeypatch.setitem(eager._UNOPS, op, _host_unop(fn))
    lowered, lib = libraries[cid]
    (_c, name, kw, ckw, _ep, _band), = [c for c in WINDOW_CASES if c[0] == cid]
    app = make_app(name, **kw)
    bufs = random_inputs(app, 2, ckw.get("batch"), ckw.get("batch_capacity"))
    windows = [lg.kg.window for lg in lowered if lg.kg.window is not None]
    assert [w.score for w in windows] == ["b1_score", "b2_score"]
    assert [w.masked for w in windows] == [0, 3]
    assert sum(lg.kg.chain is not None for lg in lowered) == 2
    # a LayerNorm group's channel sums are rolled from ROLL_PANEL_MIN terms
    ln1 = next(lg for lg in lowered if lg.kg.name == "b1_ln1")
    rolled = [sp.name for sp, key in ln1.entries
              if len((cuda_codegen._chain(ln1.programs[(sp.name, key, 0)]) or (0, ()))[1])
              >= cuda_codegen.ROLL_PANEL_MIN]
    assert rolled == (["b1_ln1_sum", "b1_ln1_var_sum"] if cid == "swin-pair-wide" else [])
    for i, lg in enumerate(lowered):
        got = host_launch(lib, str(i), lg, bufs)
        want = EagerKernel(lg)(bufs)
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        assert diff == 0, (f"{cid}/{lg.kg.name}: {diff} elements differ, max abs "
                           f"{float((got - want).abs().max())}")
        bufs[lg.kg.name] = want


@pytest.mark.parametrize("cid", [c[0] for c in TILED_CASES])
def test_tiled_cases_take_runs_and_stage(libraries, cid):
    """Under their patches the tiled cases take runs of thread-axis
    positions and stage the input read along the tile (the weights, A) in
    shared memory, one chunk's values of it a block (but the case left no
    room to stage); where the runs' lanes overshoot the thread axis, the
    last run positions are guarded."""
    lowered, _lib = libraries[cid]
    (lg,) = lowered
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PATCHES[cid].items():
            mp.setattr(cuda_codegen, k, v)
        em = element_map(lg)
        assert em.tiled and em.run > 1
        assert [st.buffer for st in em.staged] == (
            [] if cid == "resnet-run-unstaged" else ["A"] if lg.kg.name == "matmul"
            else ["weights"])
        assert shared_bytes(lg) == sum(st.nbytes for st in em.staged)
        assert em.work == em.lanes * math.prod(e for _v, e in em.axes[1:]) * em.chunks
        ragged = em.lanes * em.run > em.extent
        assert ragged == (cid in ("resnet-ytile-run", "resnet-untiled-run", "resnet-tail-run",
                                  "matmul-resident-run", "matmul-streamed-run",
                                  "resnet-run-unstaged"))
        if cid == "resnet-passes":
            assert em.blocks == em.chunks and em.work // em.chunks > em.threads


@pytest.mark.parametrize("cid", ["harris-lane-carried", "harris-lane-partial",
                                 "harris-lane-batched"])
def test_lane_carried_panels_share_rows(libraries, cid):
    """A lane-carried harris keeps one shared panel for the input's five
    row-shifted column rings (bh + 4 rows) and one for each gradient's three
    row-shifted lane line buffers (bh + 2 rows), so its shared memory is
    below the plan's scratch (a ring or line buffer per shift), and its lane
    step has four barriers (rotation, rings, gradients, their products)
    where one phase per ring set, line buffer and stage had 18."""
    lowered, _lib = libraries[cid]
    (lg,) = lowered
    kg = lg.kg
    assert lg.lane_carried
    lbs, rings = shift_panels(kg)
    assert [pan.rows for pan in rings] == [kg.bh + 4]
    assert [pan.rows for pan in lbs] == [kg.bh + 2, kg.bh + 2]
    smem, barriers = lane_layout(lg)
    assert smem < kg.scratch_bytes
    assert barriers == 4 < 18


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_occupancy_query_binds(libraries, cid):
    """``CudaKernel.blocks_per_sm`` calls each group's
    ``ub_occupancy_<tag>`` in the library (the shim's occupancy calculator
    answers 1 block an SM)."""
    lowered, lib = libraries[cid]
    for i, lg in enumerate(lowered):
        assert cuda_codegen.CudaKernel(lg, lib, str(i)).blocks_per_sm() == 1


def test_harris_2048_lane_layout():
    """chip_smoke.py's harris 2048 group: 39,168 bytes of shared memory
    (72,320 with a ring or line buffer per row shift) and 4 barriers a lane
    step (18 before)."""
    (kg,) = _plan("harris", {"schedule": "sch3", "size": 2048},
                  {"batch": 8, "batch_capacity": 8}).kernels
    lg = LoweredGroup(kg)
    assert (kg.bh, kg.bw, lg.steps, lg.lane_steps) == (5, 256, 409, 8)
    assert kg.scratch_bytes == 72320
    assert lane_layout(lg) == (39168, 4)


@pytest.mark.parametrize("cid", ["mobilenet-bh1", "mobilenet-padded", "mobilenet-batched",
                                 "mobilenet-odd"])
def test_mobilenet_cases_take_the_staged_tiled_path(libraries, cid):
    """The mobilenet cases carry nothing, stage both weight buffers whole
    over their required extents, each extent after the first padded to an
    odd count, and evaluate their output panel in register tiles."""
    lowered, _lib = libraries[cid]
    (lg,) = lowered
    assert carries_nothing(lg)
    staged = staged_inputs(lg)
    req = lg.kg.required_extents()
    assert [(st.buffer, st.extents) for st in staged] == [
        (b, tuple(req[b])) for b in ("dw_weights", "pw_weights")]
    for st in staged:
        assert all(s % 2 for s in st.strides[:-1])
    assert output_tile(lg) is not None


def test_mobilenet_full_size_stages_its_weights():
    """chip_smoke.py's mobilenet group (112 x 112, 32 -> 64 channels, batch
    8): both weight buffers staged, 1,152 and 8,192 bytes a slot (8,448 with
    the pointwise rows padded to 33 floats), beside 14,336 bytes of scratch,
    within the H100's 227 KiB; a 7 x 2 register tile a thread, one output
    row a block in two passes."""
    (kg,) = _plan("mobilenet", {"img": 112, "cin": 32, "cout": 64},
                  {"batch": 8, "batch_capacity": 8}).kernels
    lg = LoweredGroup(kg)
    assert kg.bh == 1 and carries_nothing(lg)
    dw, pw = staged_inputs(lg)
    assert (dw.buffer, dw.extents, dw.strides, dw.nbytes, dw.smem_bytes) == (
        "dw_weights", (32, 3, 3), (9, 3, 1), 1152, 1152)
    assert (pw.buffer, pw.extents, pw.strides, pw.nbytes, pw.smem_bytes) == (
        "pw_weights", (64, 32), (33, 1), 8192, 8448)
    assert smem_layout(kg)[2] == 14336
    assert shared_bytes(lg) == 14336 + 1152 + 8448 <= H100_SMEM_PER_BLOCK
    ot = output_tile(lg)
    assert (ot.lanes, ot.cols, ot.groups, ot.rows, ot.outer, ot.inner) == (32, 2, 8, 7, 112, 64)


@pytest.mark.parametrize("name,kw,ckw", [
    ("gaussian", {"size": 1082, "width": 1922}, {}),
    ("harris", {"schedule": "sch3", "size": 1024}, {}),
    ("unsharp", {"size": 1024}, {}),
    ("camera", {"size": 512}, {}),
    ("harris", {"schedule": "sch3", "size": 2048}, {}),
    ("gaussian", {"size": 26}, {"block_w": 9, "line_buffer": True}),
], ids=["gaussian", "harris", "unsharp", "camera", "harris2048", "gaussian-lane"])
def test_stencil_groups_stage_nothing(name, kw, ckw):
    """The served stencils' groups at full size (row-carried, and camera's
    second group, which carries nothing but reads no weight), harris 2048
    and a lane-carried gaussian stage no input and have no output tile:
    they emit what they emitted before."""
    plan = _plan(name, kw, {"batch": 8, "batch_capacity": 8, **ckw})
    for kg in plan.kernels:
        lg = LoweredGroup(kg)
        assert lg.row_carried or lg.lane_carried or kg.name == "camera"
        assert staged_inputs(lg) == [] and output_tile(lg) is None
        assert shared_bytes(lg) == smem_layout(kg)[2]
