"""The CUDA emitter and the port's execution contract, on the CPU.

No ``nvcc`` and no card here: these tests check what the CPU can check.
``cuda_codegen`` writes deterministic sources for every plan of the port,
in the launch geometry of each variant, with shared memory exactly the
plan's scratch; it refuses, with :class:`EmitError`, an input ring on a
non-leading axis and a scratch footprint over the H100's shared memory per
block; the kernel wrapper refuses CPU tensors; and ``compile_pipeline``
defaults to the card and raises without one instead of running on the
CPU.  The tests that build and launch the kernels are marked ``gpu`` and
skip here.
"""

import dataclasses
import math
import re
import types

import numpy as np
import pytest
import torch

from conftest import sweep_inputs
from repro_torch.apps import make_app
from repro_torch.backend import EmitError, compile_pipeline
from repro_torch.backend.build import build_many
from repro_torch.backend import cuda_codegen
from repro_torch.backend.cuda_codegen import (
    CudaKernel, _flit, element_map, emit_kernel, emit_library, grid_x, row_bands, shared_bytes,
    smem_layout,
)
from repro_torch.backend.eager import LoweredGroup
from repro_torch.backend.plan import build_pipeline_plan
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK

pytestmark = pytest.mark.torch

SLICE_PLANS = [
    ("gaussian", {"size": 34}, {}),
    ("harris", {"schedule": "sch3", "size": 36}, {}),
    ("unsharp", {"size": 34}, {}),
    ("camera", {"size": 16}, {}),
    ("upsample", {"size": 32}, {}),
    ("gaussian", {"size": 1082, "width": 1922}, {"batch": 8, "batch_capacity": 8}),
    ("harris", {"schedule": "sch3", "size": 1024}, {"batch": 8, "batch_capacity": 8}),
    ("unsharp", {"size": 1024}, {"batch": 8, "batch_capacity": 8}),
    ("camera", {"size": 512}, {"batch": 8, "batch_capacity": 8}),
    ("upsample", {"size": 1024}, {"batch": 8, "batch_capacity": 8}),
    ("unsharp", {"size": 15}, {"line_buffer": True, "batch": 3, "batch_capacity": 4}),
    ("camera", {"size": 7}, {"block_h": 3}),
]


# the small lane-grid, column-carry and grid-reduction plans chip_smoke.py
# holds against the reference interpreter
LANE_RED_PLANS = [
    ("gaussian", {"size": 26}, {"block_w": 9, "line_buffer": True}),
    ("harris", {"schedule": "sch3", "size": 25}, {"block_h": 9, "block_w": 5, "line_buffer": True}),
    ("resnet", {"img": 8, "cin": 4, "cout": 4}, {"block_w": 3}),
    ("matmul", {"m": 8, "n": 13, "k": 149}, {"red_grid_threshold": 64, "block_h": 6}),
    ("matmul", {"m": 19, "n": 13, "k": 70}, {"red_grid_threshold": 64, "red_resident": False}),
    ("harris", {"schedule": "sch3", "size": 21},
     {"block_w": 6, "block_h": 5, "line_buffer": True, "batch": 3, "batch_capacity": 4}),
]


def _ids(cases):
    return ["-".join([n] + [str(v) for v in kw.values()] + [f"{k}{v}" for k, v in ckw.items()])
            for n, kw, ckw in cases]


def _plan(name, kw, ckw):
    ckw = {"vmem_budget": H100_SMEM_PER_BLOCK, **ckw}
    return build_pipeline_plan(make_app(name, **kw).pipeline, **ckw)


@pytest.mark.parametrize("name,kw,ckw", SLICE_PLANS, ids=_ids(SLICE_PLANS))
def test_source_is_deterministic_for_slice_plans(name, kw, ckw):
    plan = _plan(name, kw, ckw)
    src = emit_library([LoweredGroup(kg) for kg in plan.kernels])
    again = emit_library([LoweredGroup(kg) for kg in _plan(name, kw, ckw).kernels])
    assert src == again
    assert src.count('#include "ub_kernel.cuh"') == 1
    for i, kg in enumerate(plan.kernels):
        assert f'extern "C" int ub_launch_{i}(' in src
        assert f'extern "C" int ub_occupancy_{i}(int* blocks_per_sm)' in src
        _s, _r, smem = smem_layout(kg)
        assert smem == kg.scratch_bytes <= H100_SMEM_PER_BLOCK
        # the launch carries exactly the plan's scratch as dynamic smem
        assert f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});" in src
        carried = bool(kg.rings or kg.line_buffered)
        em = element_map(LoweredGroup(kg))
        if em is not None:
            # an element-parallel group: threads stride over its work items
            assert not carried
            assert f"<<<dim3({em.blocks}, {kg.batch_steps}), {em.threads}," in src
            assert f"w < {em.work}; w += gridDim.x * {em.threads})" in src
        else:
            bands = row_bands(LoweredGroup(kg)) if carried else None
            grid_x = len(bands) if carried else kg.steps0
            assert f"<<<dim3({grid_x}, {kg.batch_steps})," in src
        # carried groups sweep a band of row steps in order inside each block
        body = emit_kernel(kg, str(i))
        assert ("for (int i0 = band_begin; i0 < band_end; ++i0)" in body) == carried
        if carried:
            assert (f"band_end = blockIdx.x == {len(bands) - 1} ? {kg.steps0} : "
                    f"band_begin + {bands[0][1]};") in body
    assert "fmaf" not in src and "__fdividef" not in src


def _row_carried(cases):
    """Every row-carried group of the plans of ``cases``."""
    out = []
    for name, kw, ckw in cases:
        for kg in _plan(name, kw, ckw).kernels:
            lg = LoweredGroup(kg)
            if lg.row_carried:
                out.append(lg)
    return out


@pytest.mark.parametrize("band", [None, 1, 2, 3, 5])
def test_row_bands_cover_each_step_once(band, monkeypatch):
    """A row-carried launch runs every row step of every slot exactly once:
    its bands are consecutive, none empty, and together ``[0, steps)``.  No
    band after the first starts at a step with fewer valid rows than a
    line buffer's halo, and a band chosen by the emitter holds at least
    ``BAND_HALO_RATIO`` times the halo it warms up again."""
    monkeypatch.setattr(cuda_codegen, "BAND_STEPS", band)
    groups = _row_carried(SLICE_PLANS)
    assert len(groups) >= 9
    for lg in groups:
        kg = lg.kg
        bands = row_bands(lg)
        covered = [i0 for b, e in bands for i0 in range(b, e)]
        assert covered == list(range(lg.steps)), (kg.name, bands)
        assert all(e > b for b, e in bands) and grid_x(lg) == len(bands)
        length = bands[0][1]
        assert all(e - b == length for b, e in bands[:-1])
        if band is not None:
            assert length == min(band, lg.steps)
        elif len(bands) > 1:
            ring, lb = cuda_codegen._row_halos(kg)
            assert cuda_codegen.BAND_HALO_RATIO * max(ring, lb) <= length * kg.bh
        lb_halo = cuda_codegen._row_halos(kg)[1]
        assert all(b * kg.bh + lb_halo <= kg.e0 for b, _e in bands[1:])


FULL_ROW = [
    ("gaussian", {"size": 1082, "width": 1922}),
    ("harris", {"schedule": "sch3", "size": 1024}),
    ("unsharp", {"size": 1024}),
    ("camera", {"size": 512}),
]


@pytest.mark.parametrize("name,kw", FULL_ROW, ids=[c[0] for c in FULL_ROW])
def test_row_carried_launch_at_full_size(name, kw):
    """At the served sizes a row-carried group fills the card: at batch 8
    at least 128 blocks, and a single request more than one band; the rows
    warmed up again at band starts stay under an eighth of each band."""
    for batch, least in ((8, 128), (None, 2)):
        ckw = {"batch": batch, "batch_capacity": batch} if batch else {}
        groups = _row_carried([(name, kw, ckw)])
        assert groups
        for lg in groups:
            kg = lg.kg
            bands = row_bands(lg)
            assert grid_x(lg) * kg.batch_steps >= least, (kg.name, batch, len(bands))
            ring, lb = cuda_codegen._row_halos(kg)
            assert 8 * max(ring, lb) <= bands[0][1] * kg.bh
            assert f"<<<dim3({len(bands)}, {kg.batch_steps}), 512," in emit_kernel(kg)


@pytest.mark.parametrize("name,kw,ckw,variant", [
    ("gaussian", {"size": 33, "width": 255}, {"block_w": 128, "line_buffer": False}, "lane"),
    ("matmul", {"m": 19, "n": 13, "k": 70}, {"red_grid_threshold": 64}, "red"),
    ("harris", {"schedule": "sch3", "size": 20}, {"block_w": 8, "line_buffer": True}, "lane-carry"),
], ids=["lane-grid", "red-grid", "lane-carry"])
def test_ported_variants_emit(name, kw, ckw, variant):
    """The grid-reduction, lane-grid and column-carry plans emit
    deterministic sources in their launch geometry: the threads of a lane
    grid that carries nothing stride over (element, lane step, row step)
    work items, fastest along the lanes; a column-carried group gets a
    block per (row step, slot) looping over its lane steps; each block of
    a grid reduction holds one row step, whose tile of A's rows it stages,
    and its threads stride over the columns, each looping over the chunks
    for its tile of rows.  Dynamic shared memory is the plan's scratch,
    column rings included, less the rows that row-shifted rings and line
    buffers of a column-carried group share, and the staged A."""
    plan = build_pipeline_plan(make_app(name, **kw).pipeline, **ckw)
    kg = next(k for k in plan.kernels if k.lane_grid is not None or k.red_grid is not None)
    src = emit_kernel(kg)
    assert src == emit_kernel(next(
        k for k in build_pipeline_plan(make_app(name, **kw).pipeline, **ckw).kernels
        if k.name == kg.name
    ))
    _s, r_off, smem = smem_layout(kg)
    if variant == "lane-carry":
        # the row-shifted column rings of the input, and each stage's lane
        # line buffers, share one shared-memory panel each
        assert smem < kg.scratch_bytes
    else:
        assert smem == kg.scratch_bytes
    smem = shared_bytes(LoweredGroup(kg))
    assert f"cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});" in src
    steps, lanes = kg.steps0, kg.lane_steps
    em = element_map(LoweredGroup(kg))
    if variant == "lane":
        assert not (kg.rings or kg.line_buffered) and lanes > 1
        assert em.thread_axis == "p1" and em.tile == 1
        assert em.work == steps * lanes * kg.bh * kg.bw
        assert f"<<<dim3({em.blocks}, 1), {em.threads}," in src
        assert f"const int p1 = rem % {kg.bw}; rem /= {kg.bw};" in src
        assert f"const int j = rem % {lanes}; rem /= {lanes};" in src
        assert "for (int j" not in src and "for (int k" not in src
    elif variant == "red":
        rg = kg.red_grid
        assert rg is not None and rg.steps > 1
        assert em.thread_axis == "p1" and em.tile_axis == "p0" and em.tile == kg.bh
        assert f"<<<dim3({em.blocks}, 1), {em.threads}," in src
        # a block holds one row step and stages its 5 rows of A (70 wide)
        assert em.chunk == (("i0", steps),) and "const int i0 = blockIdx.x;" in src
        assert smem == 4 * kg.bh * 70
        assert f"for (int k = 0; k < {rg.steps}; ++k) {{" in src
        assert "for (int j" not in src and "for (int i0" not in src
    else:
        assert kg.rings and all(r.lane for r in kg.rings) and kg.line_buffered
        assert f"<<<dim3({steps}, 1), 512," in src
        assert f"for (int j = 0; j < {lanes}; ++j) {{" in src
        assert "for (int i0" not in src and "for (int k" not in src
        # the column rings sit after the scratch at (bh, ..., bw + halo)
        assert smem > 4 * r_off[0]
        assert all(
            r.ring_shape(kg.bh, kg.bw)[r.axis] == kg.bw + r.halo for r in kg.rings
        )
    # the plain version runs the same plans
    pp = compile_pipeline(make_app(name, **kw).pipeline, device="cpu", kernels="eager", **ckw)
    assert any(k.kg.lane_grid is not None or k.kg.red_grid is not None for k in pp.kernels)


# (app, app kwargs, thread axis, tile axis, tile, staged input and its
#  bytes, least blocks at batch 1 and at batch 8): chip_smoke.py's
#  full-size resnet and matmul groups
FULL_ELEMENT_PARALLEL = [
    ("resnet", {"img": 56, "cin": 64, "cout": 64}, "j", "p0", 8, ("weights", 8 * 64 * 9 * 4),
     (132, 8 * 132)),
    ("matmul", {"m": 256, "n": 256, "k": 1000}, "p1", "p0", 8, ("A", 8 * 1024 * 4), (64, 512)),
]
# (app, batch): the run of thread-axis positions a thread and the threads a
# block.  resnet at batch 8 has work for runs of 2 (24 warps an SM) and
# blocks of 96 give 8 an SM; at batch 1, and matmul at either, a run of 2
# would leave an SM under 20 warps
RUNS = {("resnet", 1): (1, 128), ("resnet", 8): (2, 96),
        ("matmul", 1): (1, 128), ("matmul", 8): (1, 128)}


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize(
    "name,kw,thread,tile_axis,tile,staged,least", FULL_ELEMENT_PARALLEL,
    ids=[c[0] for c in FULL_ELEMENT_PARALLEL],
)
def test_element_parallel_launch_at_full_size(name, kw, thread, tile_axis, tile, staged, least,
                                              batch):
    """resnet's lane grid and matmul's grid reduction at the sizes
    ``chip_smoke.py`` serves: threads run along the axis on which the
    heavy input reads consecutive floats (resnet's x, matmul's columns),
    each thread evaluates a run of those positions by a tile of output
    elements along the axis on which that input does not vary (output
    channels, rows), the other input (weights, A) staged in shared memory
    a block, one chunk's tile of it, and the launch fills the card at
    batch 1 and at batch 8.  Every output element of a slot is one work
    item's, and the source is deterministic."""
    ckw = {"batch": batch, "batch_capacity": batch} if batch > 1 else {}
    (kg,) = _plan(name, kw, ckw).kernels
    assert not (kg.rings or kg.line_buffered) and (kg.red_grid is None) == (name == "resnet")
    lg = LoweredGroup(kg)
    em = element_map(lg)
    assert (em.thread_axis, em.tile_axis, em.tile) == (thread, tile_axis, tile)
    assert (em.run, em.threads) == RUNS[(name, batch)] and em.tiled
    assert [(st.buffer, st.nbytes, st.entries) for st in em.staged] == [(*staged, tile)]
    assert em.chunks == math.prod(lg.panel_shape(kg.output)[:1]) // tile * lg.steps
    assert em.blocks * kg.batch_steps >= least[batch > 1]
    assert em.work * em.run * em.tile == (
        math.prod(lg.panel_shape(kg.output)) * lg.steps * lg.lane_steps
    )
    src = emit_kernel(kg)
    assert src == emit_kernel(_plan(name, kw, ckw).kernels[0])
    assert f"<<<dim3({em.blocks}, {kg.batch_steps}), {em.threads}, {staged[1]}," in src
    # a reduction term issues one load of the input read along the thread
    # axis (ifmap, B) per run position, for the whole tile, and reads the
    # tile's values of the staged input (weights, A) as 16-byte shared
    # loads, for the whole run; the staged input's one global read is its
    # copy
    heavy, light = (0, 1) if name == "resnet" else (1, 0)
    body = src[src.index("__syncthreads();"):]
    loops = body.count("for (int r = 0;")
    assert body.count(f"g{heavy}[") + body.count(f"ub_load(g{heavy},") == loops * em.run
    assert body.count(f"reinterpret_cast<const float4*>(w{light} + ") == loops * tile // 4
    assert f"g{light}" not in body and src.count(f"ub_copy_async(w{light} + ") == 1
    assert f"const int {tile_axis}_{tile - 1} = " in src
    # the reduction's runs of terms are loops: resnet's 64 input channels
    # for each of the 9 taps; matmul's 1000 = 7 x 128 + 104 in chunks of
    # 128, the last 24 terms of a chunk bounded by the K-tail
    runs = [int(n) for n in re.findall(r"for \(int r = 0; r < (\d+); \+\+r\)", src)]
    assert runs == ([64] * 9 if name == "resnet" else [104, 24])
    if name == "resnet":
        # every load of the launch lies inside its buffer: none is bounded
        assert "ub_load" not in src


@pytest.mark.parametrize("batch", [1, 8])
def test_element_parallel_without_a_reduction_keeps_the_one_axis_map(batch):
    """upsample at its full size: no reduction, so no load a run could
    share; one output position a thread by its tile of 2 output rows,
    nothing staged, no barrier, as before the two-axis tile."""
    ckw = {"batch": batch, "batch_capacity": batch} if batch > 1 else {}
    (kg,) = _plan("upsample", {"size": 1024}, ckw).kernels
    em = element_map(LoweredGroup(kg))
    assert (em.thread_axis, em.tile_axis, em.tile) == ("p3", "p1", 2)
    assert (em.run, em.staged, em.chunk, em.threads) == (1, (), (), 128) and not em.tiled
    src = emit_kernel(kg)
    assert "__syncthreads" not in src and "ub_copy_async" not in src
    assert f"<<<dim3({em.blocks}, {kg.batch_steps}), 128, 0," in src


def test_input_ring_on_a_non_leading_axis_raises():
    """No plan puts an input ring on a non-leading axis; a hand-built one
    is refused by both versions."""
    plan = build_pipeline_plan(make_app("gaussian", size=13).pipeline, block_h=4)
    (kg,) = plan.kernels
    assert kg.rings and kg.rings[0].axis == 0
    kg = dataclasses.replace(kg, rings=[dataclasses.replace(kg.rings[0], axis=1)] + kg.rings[1:])
    with pytest.raises(EmitError, match="non-leading axis"):
        emit_kernel(kg)
    with pytest.raises(EmitError, match="non-leading axis"):
        LoweredGroup(kg)


def test_over_budget_scratch_raises():
    plan = build_pipeline_plan(
        make_app("gaussian", size=200, width=1000).pipeline,
        block_h=64, vmem_budget=96 * 1024 * 1024,
    )
    (kg,) = plan.kernels
    assert kg.scratch_bytes > H100_SMEM_PER_BLOCK
    with pytest.raises(EmitError, match="shared memory per block"):
        emit_kernel(kg)


@pytest.mark.parametrize("v", [0.0, -0.0, 1 / 3, 0.299, 255.0, 1e-30, -2.5, 3.4e38, 1e39])
def test_float_literals_are_exact_f32(v):
    lit = _flit(v)
    with np.errstate(over="ignore"):
        f32 = float(np.float32(v))
    if math.isinf(f32):
        assert lit == "__int_as_float(0x7f800000)"
    else:
        assert lit.endswith("f") and float.fromhex(lit[:-1]) == f32
        assert math.copysign(1, float.fromhex(lit[:-1])) == math.copysign(1, v)


def test_default_device_needs_a_gpu():
    """The entry point defaults to the card; without one it raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the no-GPU contract")
    app = make_app("gaussian", size=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_pipeline(app.pipeline)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_pipeline(app.pipeline, kernels="eager")


def test_kernel_choice_contract():
    app = make_app("gaussian", size=9)
    with pytest.raises(ValueError, match="kernels='cuda' needs device='cuda'"):
        compile_pipeline(app.pipeline, device="cpu")
    with pytest.raises(ValueError, match="kernels must be one of"):
        compile_pipeline(app.pipeline, device="cpu", kernels="compiled")


def test_wrapper_refuses_cpu_tensors():
    """``CudaKernel`` takes CUDA tensors only: CPU tensors (and any other
    non-CUDA device) raise, with no launch counted; callers on the CPU ask
    for the plain version by name."""
    app = make_app("unsharp", size=12)
    plan = build_pipeline_plan(app.pipeline, vmem_budget=H100_SMEM_PER_BLOCK)
    (kg,) = plan.kernels
    fake_lib = types.SimpleNamespace(
        ub_launch_0=types.SimpleNamespace(), ub_error_string=types.SimpleNamespace()
    )
    k = CudaKernel(LoweredGroup(kg), fake_lib, "0")
    ins = sweep_inputs(app, 2, "u4")
    bufs = {"input": torch.from_numpy(ins["input"])}
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k(bufs)
    assert k.launches == 0
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        k({"input": bufs["input"].to("meta")})
    assert k.launches == 0


@pytest.mark.gpu
def test_cuda_kernels_match_plain_version_on_card():
    """Build and launch the generated kernels; hold every materialized
    buffer against the plain version's on the same CUDA inputs (bit for
    bit), with one launch per kernel group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    cases = SLICE_PLANS[:5] + SLICE_PLANS[10:] + LANE_RED_PLANS
    # every library at once, one nvcc each
    build_many([
        emit_library([LoweredGroup(kg) for kg in _plan(name, kw, ckw).kernels])
        for name, kw, ckw in cases
    ])
    for name, kw, ckw in cases:
        app = make_app(name, **kw)
        pp = compile_pipeline(app.pipeline, **ckw)
        plain = compile_pipeline(app.pipeline, kernels="eager", **ckw)
        ins = sweep_inputs(app, 4, "f32", batch=ckw.get("batch"))
        got, want = pp.run(ins), plain.run(ins)
        for k in pp.kernels:
            assert got[k.name].is_cuda and k.launches == 1
            assert torch.equal(got[k.name], want[k.name]), (name, k.name)


# (app, app kwargs, batch): the two-axis tile's groups at full size, at
# batch 1 and 8, and a resnet whose 57 x positions are no multiple of its
# run of 2 (each run's second position past the row for the last lane)
TILED_ON_CARD = [
    ("resnet", {"img": 56, "cin": 64, "cout": 64}, 1),
    ("resnet", {"img": 56, "cin": 64, "cout": 64}, 8),
    ("matmul", {"m": 256, "n": 256, "k": 1000}, 1),
    ("matmul", {"m": 256, "n": 256, "k": 1000}, 8),
    ("resnet", {"img": 57, "cin": 64, "cout": 64}, 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw,batch", TILED_ON_CARD,
                         ids=[f"{c[0]}{c[1].get('img', '')}-b{c[2]}" for c in TILED_ON_CARD])
def test_tiled_element_map_matches_plain_version_on_card(name, kw, batch):
    """resnet's and matmul's groups on the two-axis tile (runs of
    thread-axis positions by the tile, the weights or A staged a block by
    ``cp.async``), one launch each, bit for bit with the plain version on
    the same real-valued CUDA inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app(name, **kw)
    ckw = {"batch": batch, "batch_capacity": batch} if batch > 1 else {}
    pp = compile_pipeline(app.pipeline, **ckw)
    plain = compile_pipeline(app.pipeline, kernels="eager", **ckw)
    (k,) = pp.kernels
    em = element_map(k.lg)
    assert em.tiled and em.staged
    if kw.get("img") == 57:
        assert em.run > 1 and em.lanes * em.run > em.extent
    ins = sweep_inputs(app, 6, "f32", batch=ckw.get("batch"))
    got, want = pp.run(ins), plain.run(ins)
    assert got[k.name].is_cuda and k.launches == 1
    assert torch.equal(got[k.name], want[k.name])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [None, 8])
def test_row_bands_match_plain_version_on_card(batch):
    """A row-carried group cut into bands across the SMs (unsharp 199: an
    input ring, a line buffer on blur_x, padded rows), one request and 8
    slots: bit for bit against the plain version, with one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the GPU machine")
    app = make_app("unsharp", size=199)
    ckw = {"batch": batch, "batch_capacity": batch} if batch else {}
    pp = compile_pipeline(app.pipeline, **ckw)
    plain = compile_pipeline(app.pipeline, kernels="eager", **ckw)
    (k,) = pp.kernels
    assert k.kg.rings and k.kg.line_buffered and k.kg.padded and len(row_bands(k.lg)) > 1
    ins = sweep_inputs(app, 4, "f32", batch=batch)
    got, want = pp.run(ins), plain.run(ins)
    assert got[k.name].is_cuda and k.launches == 1
    assert torch.equal(got[k.name], want[k.name])


def test_ptxas_usage_reads_the_build_log(tmp_path, monkeypatch):
    """Registers and spills per kernel, as ``ptxas -v`` printed them into
    the library's build log; nothing when the library was never built."""
    from repro_torch.backend import build

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    src = "// a library"
    assert build.ptxas_usage(src) == {}
    log = build.library_path(src).parent / "nvcc.log"
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : Compiling entry function '_Z11ub_kernel_09UbParams0' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z11ub_kernel_09UbParams0\n"
        "    0 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 70 registers, used 0 barriers, 392 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z12ub_kernel_1010UbParams10' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 392 bytes cmem[0]\n"
    )
    assert build.ptxas_usage(src) == {
        "ub_kernel_0": {"registers": 70, "spill_stores": 8, "spill_loads": 16},
        "ub_kernel_10": {"registers": 40, "spill_stores": 0, "spill_loads": 0},
    }


@pytest.mark.parametrize("mangled,name", [
    ("_ZN43_GLOBAL__N__8e2dd006_10_kernels_cu_3b2fb43b19matmul_wgmma_kernelE14CUtensorMap_stS0_P13__nv_bfloat16iii",
     "matmul_wgmma_kernel"),
    ("_ZN43_GLOBAL__N__8e2dd006_10_kernels_cu_3b2fb43b18flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiifi",
     "flash_wgmma_kernel<128>"),
    ("_ZN43_GLOBAL__N__8e2dd006_10_kernels_cu_3b2fb43b12flash_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_iiifi",
     "flash_kernel<__nv_bfloat16, 64>"),
    ("_ZN43_GLOBAL__N__8e2dd006_10_kernels_cu_3b2fb43b13matmul_kernelIfEEvPKT_S3_PS1_iii", "matmul_kernel<float>"),
    ("_Z12ub_kernel_1010UbParams10", "ub_kernel_10"),
], ids=["plain", "int-template", "type-and-int", "builtin", "generated"])
def test_ptxas_usage_names_hand_written_kernels(mangled, name, tmp_path, monkeypatch):
    """The hand-written kernels sit in an anonymous namespace and are
    templates: each is read under its own name and template arguments."""
    from repro_torch.backend import build

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    src = "// a hand-written library"
    log = build.library_path(src).parent / "nvcc.log"
    log.parent.mkdir(parents=True)
    log.write_text(
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 154 registers, used 1 barriers, 384 bytes cmem[0]\n"
    )
    assert build.ptxas_usage(src) == {name: {"registers": 154, "spill_stores": 0, "spill_loads": 0}}


@pytest.mark.parametrize("name,kw,ckw,runs", [
    # the 3x3 x 64 reduction: nine runs of 64 channels
    ("resnet", {"img": 8, "cin": 64, "cout": 8}, {}, [64] * 9),
    # a stencil's balanced adder tree is not a chain: nothing is rolled
    ("gaussian", {"size": 33, "width": 255}, {"block_w": 128, "line_buffer": False}, []),
    # no reduction
    ("upsample", {"size": 16}, {}, []),
    # the carries-nothing register tile: the pointwise reduction's one run
    # of 32 input channels
    ("mobilenet", {"img": 112, "cin": 32, "cout": 64}, {"batch": 8, "batch_capacity": 8}, [32]),
    # the panel chain: one run of 512 input channels, rolled over a panel's
    # 64 inside the loop over the staged panels
    ("mobilenet", {"img": 14, "cin": 512, "cout": 512}, {"batch": 32, "batch_capacity": 32},
     [64]),
], ids=["resnet", "gaussian", "upsample", "mobilenet-tile", "mobilenet-panels"])
def test_reduction_runs_become_loops(name, kw, ckw, runs):
    """Only an accumulation chain's runs of terms that differ in constants
    alone are rolled; any other program is emitted straight."""
    (kg,) = _plan(name, kw, ckw).kernels
    src = emit_kernel(kg)
    assert [int(n) for n in re.findall(r"for \(int r = 0; r < (\d+); \+\+r\)", src)] == runs
    assert src.count("#pragma unroll") == len(runs)
