#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

The path is the paper's compiler serving image tiles: the five stencil apps
of the paper's Table III, its two DNN layers (resnet, mobilenet) and a
matmul tile are lowered, planned, certified and compiled to one
hand-written CUDA kernel per planned kernel group
(``repro_torch.backend.cuda_codegen``, built with nvcc for ``sm_90a``), and
served through ``repro_torch.backend.PipelineServer``.  Phases:

1. device: the card's name and power limit; a CUDA device is required.
2. build: every pipeline's CUDA library, one nvcc per library, all started
   together (seconds printed per build).
3. small-size reference: each app at a small tile, run through its CUDA
   kernels and held against the reference interpreter — bit-exact for
   gaussian, upsample, resnet and matmul on integer inputs, ``rtol=1e-4,
   atol=1e-3`` for harris, unsharp and camera.  The cases cover every
   variant of the generated kernel: row rings and line buffers, lane grids
   with padded lane tails, column rings, lane line buffers, and grid
   reductions with a masked K-tail over resident or chunk-streamed operands.
4. full size, kernel vs plain: each configuration at full size, batch 8, on
   the H100's shared memory per block; every kernel group's output is
   compared with its plain PyTorch version on the same CUDA inputs (max
   abs diff, 0 expected); the kernel is timed with CUDA events (median of
   10, and per call over replays of a CUDA graph behind an L2-evicting
   write, as in phase 7), the plain version over its comparison call.
   Each group's launch (blocks, threads, the thread map of an
   element-parallel group and its tile, the bands of row steps a
   row-carried group's sweep is cut into, a lane-carried group's barriers
   a lane step, the inputs a group that carries nothing stages in shared
   memory and its output's register tile), its shared memory, its blocks
   an SM by the CUDA
   runtime's occupancy calculator, its registers and spills as ``ptxas
   -v`` reported them, and its library's nvcc seconds are printed.  Each
   is also held against a computation that shares no code with the port:
   gaussian against ``F.conv2d`` (atol 1e-3), upsample against
   ``expand().contiguous()`` (exact), resnet against ``F.conv2d`` and
   matmul against ``torch.matmul`` (all three timed as the library call,
   one call and replayed as the kernel is),
   mobilenet against a depthwise and a pointwise ``F.conv2d`` (two calls,
   so no one-call library time: the two are timed together as
   ``two_call_ms``), and harris (1024 and 2048), unsharp and camera's
   two groups, on one slot, against the app's math written as whole-image
   torch expressions (``rtol=1e-4, atol=1e-3``), and ConvNeXt-T's
   stage-3 block (one group, its MLP's hidden axis walked in panels,
   printed with its chain) against the benchmark's plain reference
   (``F.conv2d``, ``F.layer_norm``, ``F.linear``, ``F.gelu``; 1e-5 of
   each slot's widest output), and Swin-T's stage-3 block pair (batch 32,
   its cell's; eleven groups, each held bit for bit against its plain
   version) by its output against the benchmark's plain reference
   (``torch.roll``, window partition, ``F.softmax`` and the rest; 1e-5 of
   each slot's widest output).  The DNN configurations
   take integers in [0, 16), so every sum stays below 2**24 and any
   summation order gives the same f32 result; ConvNeXt and Swin take their
   configurations' draws (normal ifmap, He-normal weights).
5. serve: per configuration a ``PipelineServer(pipe, batch_slots=8)``
   answers 20 seeded requests (three dispatches, the last ragged); every
   served tile must equal the per-tile pipeline's result, and ConvNeXt's
   and Swin's answers the plain reference's within 1e-5 of each one's
   widest output.  After one
   warm-up round, every kernel's launch count is zeroed just before the
   timed round and read just after; CUDA events around each dispatch's
   kernels give their share of the wall time.
6. hand-written kernels, small shapes: ``stencil3x3``, ``matmul``,
   ``flash_attention`` and ``ssd_scan`` (``repro_torch.kernels``, CUDA C++
   in ``kernels/csrc/``, built in phase 2) at the shapes of the JAX
   package's kernel tests, each held against its plain version and its
   oracle at the JAX tolerances (stencil also bit for bit against its
   plain version, f32 and bf16, also on ragged shapes and on inputs whose
   data starts off 16 bytes (``STENCIL_CASES``); SSD also invariant to the
   chunk length).  Each matmul
   and attention call must launch the expected kernel and no other (read
   from the launch counts): bf16 ``matmul`` and
   ``flash_attention`` take the tensor cores (``matmul_wgmma``,
   ``flash_attention_wgmma``, head dims 32 to 256), also where the shapes
   cut their tiles (Sq 96; Skv 192; at D 256 too), while bf16 with K or N
   not a multiple of 8, or a head dim not a multiple of 8 (30), and every
   f32 call take the SIMT kernels (a SIMT matmul that splits K also
   ``matmul_reduce``); the SIMT attention is also held at f32 where its
   own 64-row tiles are cut (Sq 96, Skv 192), at D 136 and 256 and at
   D 30, and the SSD op at N 20 and at P 40, N 18.  The
   tensor-core matmul's operand layout is checked first: the identity
   times a 64×64 B of distinct residues must give B bit for bit.
7. hand-written kernels at model widths: a 1080p gaussian (f32 and bf16), tinyllama-1.1b's
   MLP up-projection (bf16 and f32) and prefill attention (bf16 and f32),
   qwen3-14b's prefill attention, gemma3-1b's global-layer prefill
   attention (bf16, D 256, on the tensor cores),
   mamba2-2.7b's SSD prefill and the matmul tile of phase 4.  Each configuration is driven once through its
   ``repro_torch.kernels.ops`` entry point with every launch count zeroed
   just before and read just after; then each kernel is held against its
   plain version, its oracle and, for the f32 gaussian and the matmul tile,
   the generated kernel on the same input (bit for bit), and timed with
   CUDA events (median of 10 calls, and per call over 50 replays of a CUDA
   graph of one call behind an L2-evicting write, which leaves out the host
   work of a call and reads the inputs from HBM) beside its plain version,
   its bound and the one PyTorch call computing the same function where
   there is one, timed both ways.  Each configuration names the kernels its
   call must launch, and no other may launch: the bf16 MLP up-projection
   ``matmul_wgmma``, the tinyllama, qwen3-14b and gemma3-1b bf16 prefills
   ``flash_attention_wgmma``, the f32 calls the SIMT kernels.  A stencil
   row prints ``stencil.plan`` (threads, outputs a thread, band rows,
   strips, bands, blocks) and, from the CUDA runtime, its blocks an SM.  A tensor-core row also launches the SIMT kernel
   on the same call (directly, into a buffer of its own, after the launch
   counts were read), holds its output against the same plain version and
   oracle at the same tolerance, and times it.
   The SSD op launches four kernels, C Bᵀ per chunk (``ssd_gram``), each
   chunk's own state and the cumulative log-decay (``ssd_chunk_state``),
   the states entering the chunks (``ssd_state_pass``) and y
   (``ssd_chunk_out``); each is timed alone on its own row against its
   plain version and an oracle (f64 for the gram and the states,
   ``ref.ssd_ref`` for y), and the op is timed whole.  An f32 matmul prints the SIMT kernel's
   tile and K split (``matmul.simt_plan``), and every attention row the
   SIMT attention kernel's tile, blocks and blocks an SM on its inputs
   (``flash_attention.simt_plan``), a tensor-core attention row also its
   own (``flash_attention.wgmma_plan``: tile, blocks, blocks an SM,
   shared bytes); where K is split (the matmul
   tile) the call launches ``matmul`` and ``matmul_reduce``, each timed
   alone on its own row, and the whole call too.  Then three context-plan
   shards (``models/layers.py:on_local_heads``): the last of 16 model
   ranks' query rows of qwen3-14b (40 heads, 256 rows at offset 3840 of
   4096, D 128) and gemma3-1b (D 256, 128 rows at 1920 of 2048) in bf16 on
   the tensor cores, and of tinyllama-1.1b in f32 (D 64) on the SIMT
   kernel, each through ``ops.attention_op(q_offset=...)``, launching its
   one kernel, held against the plain version and the oracle at the
   offset and against the rows of the whole-sequence call, and timed
   beside that whole call (one call and replayed), its bound
   ``kernel_work`` at the offset.  The f32 matmuls are bit
   for bit on their integer inputs and are also held at the JAX package's
   f32 tolerance (1e-4) on normal inputs of the same shapes.  Every row
   carries its library's registers and spills as ``ptxas -v`` reported
   them.

8. compiler: the port's backend demo (``repro_torch.backend.demo``, every
   app of ``DEMO_APPS`` on its generated CUDA kernels: plan shapes and
   line-buffer decisions against the golden tables, every buffer against
   the reference interpreter, two launches a kernel, the plan cache hit on
   a re-compile; one row per app with its shared memory, compile, cold and
   warm µs), ``compile_stage`` on the 1080p gaussian's stage (bit for bit
   with its plain version and the pipeline's kernel), the port's
   quickstart (``repro_torch.quickstart``: the paper's schedule, unified
   buffers, mapping and simulation on the host, then ``stencil3x3`` on the
   card, one launch, bit for bit with its plain version), and seeded fault
   injection (``repro_torch.backend.faults``) on the gaussian 1082×1922
   and resnet 56² 64→64 servers, batch 8, 20 requests: a marked tile's
   outputs poisoned (it fails closed with ``PoisonedTileError``, the other
   19 bit for bit with the per-tile pipeline), a kernel raise at dispatch
   2 and a poisoned plan-cache entry (both recover by a recompile, all 20
   bit for bit), a NaN tile (refused at submit with
   ``NonFiniteInputError``), a dispatch slower than one request's deadline
   (``DeadlineExceededError``); each case prints its ``fault_counters``,
   wall seconds and launches.

9. tune: the autotuner (``repro_torch.backend.autotune.search``) on the
   gaussian 1082×1922 and harris sch3 1024² configurations, batch 8, at
   most 32 candidates, 8 measured, 5 timed runs each: every certified
   survivor's library built in one parallel nvcc batch, each candidate's
   ``pp.run`` timed by CUDA events on inputs resident on the card, one
   line per candidate (schedule, modeled cycles, µs a run, launches a
   run) and per rejection (the verifier's rules); the winner stored in a
   database under a temporary directory, then served through
   ``compile_pipeline(tune=db)`` (the winner's plan) bit for bit with the
   heuristic plan on integer inputs.
10. models: ``repro_torch.models`` at full width and depth, random weights
   from a seeded generator on the card, B 1, S 2048: tinyllama-1.1b bf16
   and f32, gemma3-1b bf16, mamba2-2.7b bf16.  Each ``forward_prefill``
   runs with every launch count zeroed just before and read just after:
   22 ``flash_attention_wgmma`` (tinyllama bf16), 22 ``flash_attention``
   (f32), 4 ``flash_attention_wgmma`` and 22 windowed layers (gemma3), 64
   of each SSD kernel (mamba2), no other kernel.  Its logits are held
   against ``kernels="eager"`` on the same weights (``MODEL_TOL``) and,
   in bf16, both routes against the f32 eager route; it is timed (CUDA
   events, median of 5) beside 2 × non-embedding parameters × tokens over
   the peak.  Then 16 greedy ``decode_step``s of tinyllama bf16 from an
   empty cache, ms a token beside the weight-byte bound, the last step
   held against an eager prefill of the same tokens.
11. train: ``repro_torch.launch.train.main`` on tinyllama-1.1b at full width
   and depth in f32 (3 steps, B 2, S 1024, 2 microbatches, a checkpoint
   after step 2); a step again through ``make_train_step`` with every
   launch count zeroed just before and read just after (88
   ``flash_attention``: 22 layers x 2 microbatches x the forward and
   remat's recompute; the Functions' backward is the plain version's
   gradient and launches nothing), timed by CUDA events beside 8 ×
   non-embedding parameters × tokens over 67 TFLOP/s, split into each
   microbatch's forward+backward and forward, the plain attention backward
   and the optimizer (beside 7 × 4 B × parameters over 3.35 TB/s), peak
   memory; each microbatch's loss and gradients held against
   ``kernels="eager"`` (``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_TOL``); the
   launcher run again restores the step-2 checkpoint and must give step
   3's loss and parameters (``RESUME_TOL``).  mamba2-2.7b at full width, 4
   of its 64 layers: 2 steps, B 2, S 1024, 16 launches of each SSD kernel a
   step (4 layers x 2 rows x 2), held against eager, the SSD plain
   backward timed.  Then ``ServeEngine`` on the trained tinyllama (4
   slots, prompts of 8, 8 new tokens): no hand-written launch; every
   greedy token equals the eager prefill's argmax of its context, or is a
   near-tie within the decode route's measured error.

12. distributed: the port's ``distributed/`` on a world of one NCCL rank
   (``launch.mesh.init_distributed`` from a ``FileStore``, the (1, 1) host
   mesh on the card): tinyllama-1.1b bf16 prefill at full depth (22
   ``flash_attention_wgmma``) and mamba2-2.7b bf16 prefill on 4 layers (4 of
   each SSD kernel), S 2048, laid out by ``param_shardings`` under the
   plan's hints, the kernels on each rank's local shards; a tinyllama-1.1b
   f32 train step (4 layers, B 2, S 1024, 2 microbatches, 16
   ``flash_attention``) with ZeRO gradient layouts, its state saved and
   restored with ``shardings``; 8 decode steps with the cache placed by
   ``kv_cache_specs``; each bit for bit with the unsharded route and timed
   beside it (DTensor's overhead); ``ring_attention`` on a 1-rank ring at
   tinyllama's f32 prefill shape within 1e-5 of ``chunked_gqa_attention``
   (plain and window 512); ``pipeline_forward`` on a 1-stage ``pod`` mesh
   equal to the stage.

13. dryrun: the dry run (``repro_torch.launch.dryrun``) in subprocesses:
   phase 10's tinyllama-1.1b bf16 prefill (B 1, S 2048) on a fake (1, 1)
   world, its modelled compute, memory and collective terms (H100
   data-sheet constants) printed beside phase 10's measured ms, its
   argument bytes exactly its parameters' and tokens'; then
   ``DRYRUN_CELL`` (qwen3-14b ``train_4k``) at full size on a fake (16, 16)
   world and on a fake (2, 16, 16) world (the batch over (pod, data))
   through the CLI, each compute term at least 6 x active parameters x
   tokens over the ranks and the bf16 peak, each fitting this card's
   memory (the (2, 16, 16) cell's vocab-parallel loss keeps its logits
   gradient on the rank's own rows and columns); each traced as the rank
   with the last ``model`` coordinate (its ``context`` plan's heaviest
   query rows), printed with its compute term, f32 FLOPs and attention
   launches beside the figures with the attention replicated over
   ``model`` (``DRYRUN_REPLICATED``).

14. examples: the three ``repro_torch.examples`` scripts through their
   ``main`` on the card, each with the launch counts zeroed just before and
   read just after.  ``serve_demo`` as the JAX script sizes it (reduced
   tinyllama, 4 slots, 4 prompts of 8, 24 new tokens, no hand-written
   launch; then the four failure paths on gaussian 13 at batch 4 through
   the generated kernel, each failing closed by name, the healthy tiles
   bit for bit with the per-tile pipeline and with the plain version).
   ``train_lm`` on llama-100m for its default 150 steps (batch 4, seq 128,
   2 microbatches, remat): 48 ``flash_attention`` launches a step (12
   layers x 2 microbatches x the forward and remat's recompute), the loss
   trajectory and tok/s, the loss falling (``LEARNING``); the first step's
   loss and gradients held against ``kernels="eager"`` microbatch by
   microbatch (phase 11's ``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_TOL``), that
   step split as phase 11 splits it.
   ``schedule_explorer`` measured on its default apps (harris, unsharp,
   matmul) into a temporary db: every measured candidate's run launches
   the generated kernel, each winner no slower than the heuristic, one
   row each of mode ``cuda`` and this card's name.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12   # dense, tensor cores
L2_FLUSH_BYTES = 128 << 20   # 2.5x the H100's 50 MB L2

# (app, app kwargs, compile kwargs, bit-exact against the reference)
SMALL = [
    ("gaussian", {"size": 34}, {}, True),
    ("harris", {"schedule": "sch3", "size": 36}, {}, False),
    ("unsharp", {"size": 34}, {}, False),
    ("camera", {"size": 16}, {}, False),
    ("upsample", {"size": 32}, {}, True),
    # column rings under a lane grid with a padded lane tail
    ("gaussian", {"size": 26}, {"block_w": 9, "line_buffer": True}, True),
    # lane line buffers, column rings and lane recompute panels
    ("harris", {"schedule": "sch3", "size": 25},
     {"block_h": 9, "block_w": 5, "line_buffer": True}, False),
    # a lane grid with a padded lane tail
    ("resnet", {"img": 8, "cin": 4, "cout": 4}, {"block_w": 3}, True),
    # a grid reduction over a resident operand, with a masked K-tail
    ("matmul", {"m": 8, "n": 13, "k": 149}, {"red_grid_threshold": 64, "block_h": 6}, True),
    # a grid reduction over chunk-streamed operands
    ("matmul", {"m": 19, "n": 13, "k": 70},
     {"red_grid_threshold": 64, "red_resident": False}, True),
]
# (label, app, app kwargs, integer inputs)
FULL = [
    ("gaussian", "gaussian", {"size": 1082, "width": 1922}, False),
    ("harris", "harris", {"schedule": "sch3", "size": 1024}, False),
    ("unsharp", "unsharp", {"size": 1024}, False),
    ("camera", "camera", {"size": 512}, False),
    ("upsample", "upsample", {"size": 1024}, False),
    # ResNet-18/34 conv2_x: 3x3, 64 -> 64 channels on 56x56 (a lane grid)
    ("resnet", "resnet", {"img": 56, "cin": 64, "cout": 64}, True),
    # MobileNet v1: depthwise 3x3 on 112x112x32, then pointwise 32 -> 64
    ("mobilenet", "mobilenet", {"img": 112, "cin": 32, "cout": 64}, True),
    # MobileNet v1's 14x14x512 block: one fused group planned against shared
    # memory, the pointwise weights staged in panels of output channels
    ("mobilenet14x512", "mobilenet", {"img": 14, "cin": 512, "cout": 512}, True),
    # a grid reduction with a masked K-tail (1000 = 7 x 128 + 104)
    ("matmul", "matmul", {"m": 256, "n": 256, "k": 1000}, True),
    # a 2K stencil: lane grid, column rings and lane line buffers
    ("harris2048", "harris", {"schedule": "sch3", "size": 2048}, False),
    # ConvNeXt-T's stage-3 block: one group whose MLP chains its two
    # reductions through the 1536-wide hidden axis, a panel at a time
    ("convnext", "convnext", {"img": 14, "dim": 384, "hidden": 1536}, False),
    # Swin-T's stage-3 block pair: each block's window-attention groups (the
    # score tile in shared memory, the max combiner, expf), the LayerNorm
    # groups, the one-hot rolls of the shifted block and the chained MLP
    ("swin", "swin", {"img": 14, "dim": 384, "heads": 12, "window": 7, "hidden": 1536,
                      "shift": 3}, False),
]
# phase 4's batch slots where a configuration's cell runs another batch than
# BATCH (Swin's cell dispatches 32 images)
FULL_BATCH = {"swin": 32}
# Swin's inputs are drawn as its benchmark configuration draws them (each
# slot its own weights)
SWIN_CONFIG = Path(__file__).resolve().parent / "portbench" / "configs" / "swin-t-stage3-14x384.json"
# ConvNeXt's inputs as its benchmark configuration draws them, (mean, std)
# of a normal draw: a signed ifmap, He-normal weights, small biases,
# LayerNorm's affine near (1, 0), a layer scale near 1
CONVNEXT_DRAWS = {
    "ifmap": (0.0, 1.0), "dw_weights": (0.0, (2 / 49) ** 0.5), "dw_bias": (0.0, 0.02),
    "ln_weight": (1.0, 0.05), "ln_bias": (0.0, 0.05), "w1": (0.0, (2 / 384) ** 0.5),
    "b1": (0.0, 0.02), "w2": (0.0, (2 / 1536) ** 0.5), "b2": (0.0, 0.02),
    "layer_scale": (1.0, 0.25),
}
# the stencil's ragged and misaligned shapes (phase 6): (H, W, bytes its
# input's data starts past a 16-byte boundary, 1 for one element): odd W
# with H not a multiple of a band, W + 2 a multiple of neither 4 nor 8, one
# output, 16-byte output rows, a view off 16 by an element pair (pair
# loads) and by one element (single loads), W past one strip
STENCIL_CASES = [(13, 37, 0), (16, 20, 0), (1, 1, 0), (9, 24, 0), (12, 30, 8), (12, 30, 1),
                 (6, 1030, 0)]
BATCH = 8
N_REQUESTS = 20
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def inputs_for(app, rng, batch=None, integer=False):
    import numpy as np

    out = {}
    for name, shape in app.input_extents.items():
        shape = ((batch,) if batch else ()) + tuple(shape)
        if app.name == "convnext":
            mean, std = CONVNEXT_DRAWS[name]
            arr = mean + std * rng.standard_normal(shape)
        elif app.name == "swin":
            d = json.loads(SWIN_CONFIG.read_text())["inputs"][name]
            if d["draw"] == "uniform":
                arr = rng.uniform(d["low"], d["high"], shape)
            else:
                arr = d["std"] * rng.standard_normal(shape)
        elif integer:
            arr = rng.integers(0, 16, shape)
        else:
            arr = rng.uniform(0.0, 256.0, shape)
        out[name] = np.asarray(arr, np.float32)
    return out


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``reps`` calls, each between CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int = 50) -> float:
    """Device milliseconds per call of ``fn``, its inputs read from HBM: the
    call is captured in a CUDA graph behind a write of a buffer 2.5x the
    L2's size, which evicts what the replay before left in L2, and replayed
    ``reps`` times between two CUDA events; the same replays of the write
    alone, before and after, are averaged and subtracted.  The host work of
    a call (argument checks, allocation, the ctypes launch), which a
    one-call reading counts while the card waits, is left out."""
    import torch

    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up on the capture stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    flush, both = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(flush, stream=side, capture_error_mode="relaxed"):
        flush_buf.zero_()
    with torch.cuda.graph(both, stream=side, capture_error_mode="relaxed"):
        flush_buf.zero_()
        fn()

    def replay_ms(graph) -> float:
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    before = replay_ms(flush)
    total = replay_ms(both)
    return total - (before + replay_ms(flush)) / 2


def variants(kg) -> list:
    out = ["(a) streamed panels" if kg.streamed else "(a) unstreamed"]
    if kg.padded_grid is not None:
        out.append("(a) padded rows")
    keys = [key for _sp, key in kg.scratch_entries()]
    if any(key is not None and not (isinstance(key, tuple) and key[1] is None) for key in keys):
        out.append("(b) fused recompute")
    rg = kg.red_grid
    if rg is not None:
        out.append("(c) grid reduction")
        if rg.padded:
            out.append("(c) masked K-tail")
        for g in kg.groups:
            if g.red_axis is not None:
                out.append("(c) resident operand" if g.resident else "(c) streamed chunks")
    if any(not r.lane for r in kg.rings):
        out.append("(d) input ring")
    if any(key is None for key in keys):
        out.append("(d) line buffer")
    if kg.lane_grid is not None:
        out.append("(e) lane grid")
        if kg.lane_grid.pad:
            out.append("(e) padded lanes")
    if any(r.lane for r in kg.rings):
        out.append("(f) column ring")
    if any(isinstance(key, tuple) and key[1] is None for key in keys):
        out.append("(f) lane line buffer")
    if kg.batch_grid is not None:
        out.append("(g) batch grid")
    return sorted(set(out), key=out.index)


def _bsum(terms):
    """The apps' balanced adder tree (``paper_apps.balanced_sum``), on tensors."""
    terms = list(terms)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def independent(name: str, a):
    """Each app's math written directly as whole-image torch expressions on
    one tile ``a`` (``[y, x]``), in the apps' order of operations.  Shares
    no code with the lowering, the plan or the kernels; returns
    ``{kernel name: tensor}`` in the kernels' loop-order layouts."""
    import torch

    def sh(t, dx, dy, h, w):
        return t[dy:dy + h, dx:dx + w]

    if name == "harris":
        n = a.shape[0] - 4
        g = n + 2
        gx = _bsum([sh(a, 0, 0, g, g) * -1, sh(a, 2, 0, g, g) * 1,
                    sh(a, 0, 1, g, g) * -2, sh(a, 2, 1, g, g) * 2,
                    sh(a, 0, 2, g, g) * -1, sh(a, 2, 2, g, g) * 1])
        gy = _bsum([sh(a, 0, 0, g, g) * -1, sh(a, 1, 0, g, g) * -2,
                    sh(a, 2, 0, g, g) * -1, sh(a, 0, 2, g, g) * 1,
                    sh(a, 1, 2, g, g) * 2, sh(a, 2, 2, g, g) * 1])

        def box3(t):
            return _bsum([sh(t, dx, dy, n, n) for dy in range(3) for dx in range(3)])

        sxx, syy, sxy = box3(gx * gx / 64), box3(gy * gy / 64), box3(gx * gy / 64)
        trace = sxx + syy
        resp = (sxx * syy - sxy * sxy) - (trace * trace) / 16
        return {"harris": torch.where(resp > 100, resp, torch.zeros_like(resp))}
    if name == "unsharp":
        n = a.shape[0] - 2
        bx = (sh(a, 0, 0, n + 2, n) + sh(a, 1, 0, n + 2, n) * 2 + sh(a, 2, 0, n + 2, n)) / 4
        by = (sh(bx, 0, 0, n, n) + sh(bx, 0, 1, n, n) * 2 + sh(bx, 0, 2, n, n)) / 4
        c = sh(a, 1, 1, n, n)
        ratio = (c * 2 - by) / torch.maximum(c, torch.ones_like(c))
        zero, top = torch.zeros_like(c), torch.full_like(c, 255)
        return {"unsharp": torch.minimum(torch.maximum(ratio * c, zero), top)}
    if name == "camera":
        d = a.shape[0] - 2                  # denoise extent, 2 * s + 2
        s = (d - 2) // 2
        r = lambda dx, dy: sh(a, dx, dy, d, d)  # noqa: E731
        nmax = torch.maximum(torch.maximum(r(0, 1), r(2, 1)), torch.maximum(r(1, 0), r(1, 2)))
        nmin = torch.minimum(torch.minimum(r(0, 1), r(2, 1)), torch.minimum(r(1, 0), r(1, 2)))
        dn = torch.minimum(torch.maximum(r(1, 1), nmin), nmax)

        def at(dx, dy):        # dn[2y + dy, 2x + dx] as [y, 1, x, 1]
            return dn[dy:dy + 2 * s:2, dx:dx + 2 * s:2][:, None, :, None]

        xi = torch.arange(2, dtype=a.dtype, device=a.device).view(1, 1, 1, 2)
        yi = xi.view(1, 2, 1, 1)

        def phase(px, py):
            return (xi if px else 1 - xi) * (yi if py else 1 - yi)

        g = (phase(0, 0) * at(0, 0) + phase(1, 1) * at(1, 1)
             + (phase(1, 0) + phase(0, 1)) * ((at(0, 0) + at(1, 1)) / 2))
        rr = phase(1, 0) * at(1, 0) + (1 - phase(1, 0)) * ((at(1, 0) + at(3, 0)) / 2)
        b = phase(0, 1) * at(0, 1) + (1 - phase(0, 1)) * ((at(0, 1) + at(0, 3)) / 2)
        cr = (rr * 14 + g * 2 - b) / 16
        cg = (rr * -1 + g * 14 + b * 2) / 16
        cb = (rr * 2 - g + b * 14) / 16
        lum = (cr * 5 + cg * 9 + cb * 2) / 16
        v = lum + lum * lum / 256
        out = torch.minimum(torch.maximum(v, torch.zeros_like(v)), torch.full_like(v, 255))
        return {"denoise": dn, "camera": out}
    raise KeyError(name)


def bytes_and_ops(k) -> tuple:
    """Bytes the group must move (each input region read once, the output
    written once) and the f32 operations its stages do on this run's
    shapes (each fused row evaluated once; a grid reduction's terms over
    its whole extent, without the masked K-tail's padding terms)."""
    import math

    kg = k.kg
    nb = kg.batch_steps
    nbytes = 4 * nb * math.prod(kg.output.nstage.pure_extents)
    for need in kg.required_extents().values():
        nbytes += 4 * nb * math.prod(need)
    per_stage = {}
    for (name, _shift, _lshift), prog in k.lg.programs.items():
        n = sum(1 for op in prog if op[0] in ("bin", "sel", "un"))
        rg = kg.red_grid
        if rg is not None and name == kg.output.name:
            n = n * rg.extent / rg.chunk     # one chunk's program holds chunk terms
        per_stage[name] = n
    ops = sum(
        n * nb * math.prod(kg.stage_plan(name).nstage.pure_extents)
        for name, n in per_stage.items()
    )
    return nbytes, ops


def library_check(label: str, bufs, out, kname: str = ""):
    """The one PyTorch call computing the same function where there is one
    (timed as ``library_ms``), else None, and a check of ``out`` (kernel
    ``kname``'s output) against a computation sharing no code with the
    port: ``(call, ok, message)``."""
    import torch
    import torch.nn.functional as F

    if label == "gaussian":
        x = bufs["input"].unsqueeze(1)
        w = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]],
                         dtype=torch.float32, device=x.device).view(1, 1, 3, 3) / 16
        call = lambda: F.conv2d(x, w)  # noqa: E731
        err = float((call()[:, 0] - out).abs().max())
        return call, err <= 1e-3, (f"max|cuda - F.conv2d| = {err!r} "
                                   "(atol 1e-3; another summation order)")
    if label == "upsample":
        x = bufs["input"]
        b_, h_, w_ = x.shape
        call = lambda: x[:, :, None, :, None].expand(b_, h_, 2, w_, 2).contiguous()  # noqa: E731
        return call, torch.equal(call(), out), "cuda == expand().contiguous() (exact)"
    if label == "resnet":
        # ifmap [slot][ci][y][x], weights [slot][co][ci][ky][kx]: one grouped
        # convolution over the slots
        x, w = bufs["ifmap"], bufs["weights"]
        nb, ci = x.shape[:2]
        xs = x.reshape(1, nb * ci, *x.shape[2:])
        ws = w.reshape(-1, *w.shape[2:])
        call = lambda: F.conv2d(xs, ws, groups=nb).view(out.shape)  # noqa: E731
        ok = torch.allclose(out, call(), rtol=1e-5, atol=1e-3)
        err = float((call() - out).abs().max())
        return call, ok, f"max|cuda - F.conv2d| = {err!r} (rtol=1e-5 atol=1e-3)"
    if label == "matmul":
        a, b = bufs["A"], bufs["B"]
        call = lambda: torch.matmul(a, b)  # noqa: E731
        err = float((call() - out).abs().max())
        return call, torch.equal(call(), out), f"max|cuda - torch.matmul| = {err!r} (exact)"
    if label.startswith("mobilenet"):
        # ifmap [slot][y][x][c] -> NCHW; depthwise 3x3 per channel, then a
        # 1x1 convolution per slot; the output is [slot][y][x][co]
        x, wd, wp = bufs["ifmap"], bufs["dw_weights"], bufs["pw_weights"]
        nb, _, _, c = x.shape
        xs = x.permute(0, 3, 1, 2).reshape(1, nb * c, x.shape[1], x.shape[2])
        dw = F.conv2d(xs, wd.reshape(nb * c, 1, 3, 3), groups=nb * c)
        pw = F.conv2d(dw, wp.reshape(-1, c, 1, 1), groups=nb)
        want = pw.view(nb, -1, *pw.shape[2:]).permute(0, 2, 3, 1)
        err = float((want - out).abs().max())
        ok = torch.allclose(out, want, rtol=1e-5, atol=1e-3)
        return None, ok, (f"max|cuda - depthwise + pointwise F.conv2d| = {err!r} "
                          "(rtol=1e-5 atol=1e-3; two calls, no one-call library time)")
    if label == "convnext":
        # the benchmark's plain reference: F.conv2d, F.layer_norm, F.linear
        # and F.gelu a slot, TF32 off
        from portbench.reference import convnext

        want = convnext.reference(bufs)["convnext"]
        gap = float(((out - want).abs().flatten(1).amax(1)
                     / want.abs().flatten(1).amax(1)).max())
        return None, gap <= 1e-5, (f"max|cuda - F.conv2d, F.layer_norm, F.linear, F.gelu| / "
                                   f"max|want| = {gap!r} (1e-5 a slot; several calls)")
    if label == "swin":
        if kname != "swin":
            # an inner group of the pair has no separate oracle: it is held
            # bit for bit against its plain version, the pair's output below
            return None, True, "inner group: the pair's output is held against the reference"
        # the benchmark's plain reference (torch.roll, window partition,
        # F.layer_norm, F.linear, F.softmax, F.gelu a slot, TF32 off), at
        # the cell's limit
        from portbench.reference import swin

        want = swin.reference(bufs)["swin"]
        gap = float(((out - want).abs().flatten(1).amax(1)
                     / want.abs().flatten(1).amax(1)).max())
        return None, gap <= 1e-5, (f"max|cuda - Swin's modules in torch| / max|want| = {gap!r} "
                                   f"(1e-5 a slot, {out.shape[0]} slots; several calls)")
    return None, None, None


def two_calls(label: str, bufs):
    """mobilenet's depthwise and pointwise ``F.conv2d`` as two calls on the
    group's inputs (what ``library_check`` holds it against), for timing
    beside the group: no one PyTorch call computes the group, so this is
    not a ``library_ms``; None for any other configuration."""
    import torch.nn.functional as F

    if not label.startswith("mobilenet"):
        return None
    x, wd, wp = bufs["ifmap"], bufs["dw_weights"], bufs["pw_weights"]
    nb, _, _, c = x.shape
    xs = x.permute(0, 3, 1, 2).reshape(1, nb * c, x.shape[1], x.shape[2]).contiguous()
    wds, wps = wd.reshape(nb * c, 1, 3, 3), wp.reshape(-1, c, 1, 1)
    return lambda: F.conv2d(F.conv2d(xs, wds, groups=nb * c), wps, groups=nb)


GAUSS_W = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]


def held(tag: str, got, plain, want, tol, exact: bool = False, row_tol=None):
    """Hold a hand-written kernel's output against its plain version and
    its oracle (bit for bit, or at ``rtol = atol = tol``, or at ``tol =
    (rtol, atol)``); with ``row_tol``, also each output row's error over
    that row's norm; log the max abs differences; raise on a miss.  Returns
    the difference from the plain version."""
    import torch

    if got.shape != want.shape or got.dtype != plain.dtype or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{tag}: bad output {tuple(got.shape)} {got.dtype}")
    g = got.float()
    e_plain = float((g - plain.float()).abs().max())
    e_ref = float((g - want.float()).abs().max())
    rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
    if exact:
        ok = torch.equal(got, plain) and torch.equal(got, want)
    else:
        ok = (torch.allclose(g, plain.float(), rtol=rtol, atol=atol)
              and torch.allclose(g, want.float(), rtol=rtol, atol=atol))
    rows = ""
    if row_tol is not None:
        # a deep causal row averages thousands of values, so its outputs are
        # small and an absolute limit alone is loose there
        r_plain, r_ref = (float(((g - w.float()).norm(dim=-1) / w.float().norm(dim=-1)).max())
                          for w in (plain, want))
        ok = ok and max(r_plain, r_ref) <= row_tol
        rows = (f"; max per-row |cuda - plain| / |plain| = {r_plain!r}, "
                f"/ |ref| = {r_ref!r} (limit {row_tol})")
    log(f"{tag}: max|cuda - plain| = {e_plain!r}, max|cuda - ref| = {e_ref!r} "
        f"({'exact' if exact else f'rtol={rtol} atol={atol}'}){rows} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the CUDA kernel disagrees")
    return e_plain


def kernels_small() -> None:
    """Phase 6: each hand-written kernel at the JAX package's test shapes,
    against its plain version and its oracle at the JAX tolerances."""
    import numpy as np
    import torch

    from repro_torch.kernels import KERNELS, ops, ref as kref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.matmul import matmul, matmul_plain, simt_plan
    from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
    from repro_torch.kernels.stencil import stencil3x3, stencil3x3_plain

    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(shape, dtype=f32):
        return ops.to_tensor(rng.standard_normal(shape).astype(np.float32), dtype)

    def launched(tag, want, call):
        """``call()``, which must launch the kernel ``want`` and no other
        (a SIMT matmul that splits K: it and ``matmul_reduce``)."""
        before = {name: k.launches for name, k in KERNELS.items()}
        out = call()
        rose = [name for name, k in KERNELS.items() if k.launches != before[name]]
        wants = [want] if isinstance(want, str) else list(want)
        if rose != wants:
            raise AssertionError(f"{tag}: launched {rose}, must launch {wants}")
        return out

    # the tensor-core matmul's operand layout: I @ B must be B, every entry
    # of B a distinct residue, so a misplaced element shows where it went
    i = np.arange(64)
    b = ops.to_tensor(((7 * i[:, None] + 13 * i[None, :]) % 251 - 125).astype(np.float32), bf16)
    eye = ops.to_tensor(np.eye(64, dtype=np.float32), bf16)
    tag = "[kernels-small] matmul I @ B (64, 64, 64) bf16 (matmul_wgmma)"
    got = launched(tag, "matmul_wgmma", lambda: matmul(eye, b))
    bad = (got != b).nonzero()
    log(f"{tag}: {len(bad)} of "
        f"4096 entries differ (exact) {'FAIL ' + str(bad[:4].tolist()) if len(bad) else 'ok'}")
    if len(bad):
        raise AssertionError("matmul: the identity does not give B back")

    blocks = dict(block_m=16, block_n=16, block_k=16)
    # bf16 goes to the tensor cores unless TMA cannot read a row: K or N
    # not a multiple of 8 keeps it on the SIMT kernel
    mm_cases = [((m, n, k), blocks, dtype, tol, "matmul_wgmma" if dtype == bf16 else "matmul")
                for m, n, k in [(32, 32, 32), (64, 128, 32), (128, 64, 256), (16, 16, 64)]
                for dtype, tol in ((f32, 1e-4), (bf16, 2e-2))]
    mm_cases += [((64, 84, 48), {}, bf16, 2e-2, "matmul"), ((64, 80, 44), {}, bf16, 2e-2, "matmul")]
    for (m, n, k), kw, dtype, tol, want in mm_cases:
        if want == "matmul" and simt_plan(m, n, k)[2] > 1:
            want = ("matmul", "matmul_reduce")
        a, b = rand((m, k), dtype), rand((k, n), dtype)
        tag = f"[kernels-small] matmul {(m, n, k)} {dtype} ({want})"
        held(tag, launched(tag, want, lambda: matmul(a, b, **kw)), matmul_plain(a, b, **kw),
             kref.matmul_ref(a, b), tol)
    def off16(t, off):
        """``t``'s values in a view whose data starts ``off`` bytes past a
        16-byte boundary (``off`` 1: one element)."""
        size = t.element_size()
        flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
        lead = (-flat.data_ptr() % 16) // size + (1 if off == 1 else off // size)
        return flat[lead:lead + t.numel()].view(t.shape).copy_(t)

    wts = ops.to_tensor(np.array(GAUSS_W, np.float32) / 16)
    st_cases = [(h, w, 0, f32) for h, w in [(16, 16), (32, 64), (64, 62)]]
    st_cases += [(h, w, off, dtype) for h, w, off in STENCIL_CASES for dtype in (f32, bf16)]
    for h, w, off, dtype in st_cases:
        x = off16(rand((h + 2, w + 2), dtype), off)
        tag = f"[kernels-small] stencil3x3 {(h, w)} {dtype} data {x.data_ptr() % 16} B past 16"
        got = launched(tag, "stencil3x3", lambda: stencil3x3(x, wts, block_h=8))
        plain = stencil3x3_plain(x, wts, block_h=8)
        # the oracle's f32 sums cast once to x's dtype, as the kernel stores them
        held(tag, got, plain, kref.stencil3x3_ref(x, wts).to(dtype), 1e-5)
        if not torch.equal(got, plain):
            raise AssertionError(f"{tag}: not bit-equal to the plain version")
    # (batch, Sq, Skv, D): the JAX package's shapes, query and KV extents
    # that cut the tensor cores' 128-row tiles, and bf16 head dims above 128,
    # which the D 256 tensor-core kernel takes, its 64-row tiles cut too
    fa_cases = [((b, s, s, d), causal, dtype, tol,
                 "flash_attention_wgmma" if dtype == bf16 else "flash_attention")
                for b, s, d in [(2, 128, 64), (1, 256, 32), (4, 64, 128)]
                for causal in (True, False) for dtype, tol in ((f32, 2e-3), (bf16, 3e-2))]
    fa_cases += [((2, 96, 96, 64), True, bf16, 3e-2, "flash_attention_wgmma"),
                 ((2, 64, 192, 32), False, bf16, 3e-2, "flash_attention_wgmma"),
                 ((2, 64, 64, 136), True, bf16, 3e-2, "flash_attention_wgmma"),
                 ((2, 64, 128, 136), False, bf16, 3e-2, "flash_attention_wgmma"),
                 ((1, 128, 128, 256), True, bf16, 3e-2, "flash_attention_wgmma"),
                 ((2, 96, 96, 256), True, bf16, 3e-2, "flash_attention_wgmma"),
                 ((2, 64, 192, 256), False, bf16, 3e-2, "flash_attention_wgmma"),
                 ((1, 320, 320, 256), True, bf16, 3e-2, "flash_attention_wgmma")]
    # the SIMT kernel's own cuts: f32 at the 256 instantiation (D 136 and
    # 256), query and KV extents that cut its 64-row tiles, and D 30, whose
    # rows neither cp.async nor 8-byte bf16 loads can take
    fa_cases += [((1, 128, 128, 136), True, f32, 2e-3, "flash_attention"),
                 ((1, 64, 128, 256), False, f32, 2e-3, "flash_attention"),
                 ((2, 96, 96, 64), True, f32, 2e-3, "flash_attention"),
                 ((2, 96, 192, 64), False, f32, 2e-3, "flash_attention"),
                 ((2, 96, 96, 30), True, f32, 2e-3, "flash_attention"),
                 ((1, 64, 192, 30), False, bf16, 3e-2, "flash_attention")]
    for (b, sq, skv, d), causal, dtype, tol, want in fa_cases:
        q, k, v = rand((b, sq, d), dtype), rand((b, skv, d), dtype), rand((b, skv, d), dtype)
        kw = dict(causal=causal, block_q=32, block_kv=32)
        tag = (f"[kernels-small] flash_attention q {(b, sq, d)} kv {(b, skv, d)} "
               f"causal={causal} {dtype} ({want})")
        held(tag, launched(tag, want, lambda: flash_attention(q, k, v, **kw)),
             flash_attention_plain(q, k, v, **kw), kref.attention_ref(q, k, v, causal=causal), tol)
    q, k, v = rand((2, 64, 32)), rand((2, 256, 32)), rand((2, 256, 32))
    kw = dict(causal=False, block_q=32, block_kv=64)
    held("[kernels-small] flash_attention q (2, 64, 32) kv (2, 256, 32)",
         flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw),
         kref.attention_ref(q, k, v, causal=False), 2e-3)

    def ssd_inputs(s, h, p, n):
        x = rand((s, h, p))
        dt = ops.to_tensor((np.abs(rng.standard_normal((s, h))) * 0.1 + 0.01).astype(np.float32))
        a = ops.to_tensor((-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32))
        return x, dt, a, rand((s, n)), rand((s, n))

    # N 20: the gram kernel's 64-wide slice of N cut; (96, 3, 40, 18): the
    # state's P tile cut and B through registers
    for shape in [(64, 2, 8, 16), (128, 4, 16, 32), (32, 1, 4, 8), (64, 2, 8, 20), (96, 3, 40, 18)]:
        ins = ssd_inputs(*shape)
        held(f"[kernels-small] ssd_scan {shape} chunk 16", ssd_scan(*ins, chunk=16),
             ssd_scan_plain(*ins, chunk=16), kref.ssd_ref(*ins), 1e-3)
    ins = ssd_inputs(64, 2, 8, 16)
    y8, y32 = ssd_scan(*ins, chunk=8), ssd_scan(*ins, chunk=32)
    err = float((y8 - y32).abs().max())
    ok = torch.allclose(y8, y32, rtol=1e-4, atol=1e-4)
    log(f"[kernels-small] ssd_scan (64, 2, 8, 16) chunk 8 vs 32: max diff = {err!r} "
        f"(rtol=atol=1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ssd_scan depends on its chunk length")
    torch.cuda.synchronize()


def kernels_full(full_apps, rows) -> None:
    """Phase 7: each hand-written kernel at a model's width, driven through
    ``repro_torch.kernels.ops`` with the launch counts zeroed just before
    and read just after, then checked and timed; adds one row per kernel
    and configuration to ``rows``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.backend import compile_pipeline
    from repro_torch.backend.build import ptxas_usage
    from repro_torch.core.ubplan import plan_ssd
    from repro_torch.kernels import KERNELS, ops, ref as kref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.matmul import matmul_plain, matmul_reduce_plain, simt_plan
    from repro_torch.roofline.kernel_cost import kernel_work
    from repro_torch.kernels.ssd import (
        ssd_chunk_out, ssd_chunk_out_plain, ssd_chunk_state, ssd_chunk_state_plain, ssd_gram,
        ssd_gram_plain, ssd_scan_plain, ssd_state_pass, ssd_state_pass_plain,
    )
    from repro_torch.kernels import stencil
    from repro_torch.kernels.stencil import stencil3x3_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def randint(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).to(dtype)

    def attention(heads, kv_heads, s, d, dtype):
        # grouped-query attention folded for a kernel without GQA: query head
        # h reads KV head h // (heads // kv_heads), repeated before the call
        q = randn((heads, s, d), dtype)
        k, v = (randn((kv_heads, s, d), dtype).repeat_interleave(heads // kv_heads, dim=0)
                for _ in range(2))
        return q, k, v

    def mamba(s, h, p, n):
        # the distributions of the JAX package's SSD tests
        x = randn((s, h, p), f32)
        dt = randn((s, h), f32).abs() * 0.1 + 0.01
        a = -randn((h,), f32).abs() - 0.1
        return x, dt, a, randn((s, n), f32), randn((s, n), f32)

    entry = {
        # the oracle's f32 sums cast once to x's dtype, as the kernel stores them
        "stencil3x3": (ops.stencil3x3_op, stencil3x3_plain,
                       lambda x, w: kref.stencil3x3_ref(x, w).to(x.dtype), {}),
        "matmul": (ops.matmul_op, matmul_plain, kref.matmul_ref, {}),
        "flash_attention": (ops.attention_op, flash_attention_plain, kref.attention_ref,
                            {"causal": True}),
        "ssd_scan": (ops.ssd_op, ssd_scan_plain, kref.ssd_ref, {}),
    }
    entry["matmul_wgmma"] = entry["matmul"]
    entry["flash_attention_wgmma"] = entry["flash_attention"]
    # the CUDA kernels each configuration's call must launch, and only they
    path = {"ssd_scan": ("ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")}

    def simt_call(kname, args, scratch, q_offset=0):
        """The SIMT kernel of a tensor-core kernel's op on the same inputs,
        launched directly into ``scratch``: the comparison the tensor cores
        are for."""
        if kname == "matmul_wgmma":
            a, b = args
            return lambda: mm.launch_simt(a, b, scratch)
        q, k, v = args
        heads, s, d = q.shape
        return lambda: KERNELS["flash_attention"](
            dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), scratch.data_ptr(),
            heads, s, k.shape[1], d, 1.0 / d ** 0.5, 1, q_offset, 1)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=True)[0]

    def conv(x, w):
        return F.conv2d(x[None, None], w[None, None].to(x.dtype))[0, 0]

    # bf16 attention: one bf16 ulp (2**-7 of the value at most) apart from
    # the f32 plain version and oracle, each rounded once; the row check
    # holds the small outputs of deep causal rows
    flash_bf16 = dict(tol=(1.6e-2, 8e-3), row_tol=8e-3)
    flash_f32 = dict(tol=2e-3, row_tol=1e-4)
    # (label, kernel, inputs, {tol: None for bit for bit, row_tol}, (library
    #  call name, call, (rtol, atol) it must meet or None), generated app and its inputs)
    configs = [
        ("gaussian-1080p", "stencil3x3",
         lambda: (randint(0, 256, (1082, 1922), f32),
                  torch.tensor(GAUSS_W, dtype=f32, device=dev) / 16),
         dict(tol=None), ("F.conv2d", conv, (1e-5, 1e-3)), ("gaussian", ("input",))),
        # the same image in bf16 (integers below 256 are exact in it, the
        # weights / 16 dyadic); F.conv2d on bf16 operands within one bf16 ulp
        ("gaussian-1080p", "stencil3x3",
         lambda: (randint(0, 256, (1082, 1922), bf16),
                  torch.tensor(GAUSS_W, dtype=f32, device=dev) / 16),
         dict(tol=None), ("F.conv2d", conv, (7.8e-3, 0.0)), None),
        ("tinyllama-mlp-up", "matmul_wgmma",
         lambda: (randint(-8, 8, (2048, 2048), bf16), randint(-8, 8, (2048, 5632), bf16)),
         dict(tol=None), ("torch.matmul", torch.matmul, None), None),
        ("tinyllama-mlp-up", "matmul",
         lambda: (randint(-8, 8, (2048, 2048), f32), randint(-8, 8, (2048, 5632), f32)),
         dict(tol=None), ("torch.matmul", torch.matmul, None), None),
        ("matmul-tile", "matmul",
         lambda: (randint(0, 16, (256, 1000), f32), randint(0, 16, (1000, 256), f32)),
         dict(tol=None), ("torch.matmul", torch.matmul, None), ("matmul", ("A", "B"))),
        ("tinyllama-prefill", "flash_attention_wgmma", lambda: attention(32, 4, 2048, 64, bf16),
         flash_bf16, ("F.scaled_dot_product_attention", sdpa, None), None),
        ("tinyllama-prefill", "flash_attention", lambda: attention(32, 4, 2048, 64, f32),
         flash_f32, ("F.scaled_dot_product_attention", sdpa, None), None),
        ("qwen3-14b-prefill", "flash_attention_wgmma",
         lambda: attention(40, 8, 4096, 128, bf16),
         flash_bf16, ("F.scaled_dot_product_attention", sdpa, None), None),
        # gemma3-1b's global layer (1 in 6; the kernel has no sliding
        # window): 4 query heads over 1 KV head, D 256, on the tensor cores
        ("gemma3-1b-prefill", "flash_attention_wgmma", lambda: attention(4, 1, 2048, 256, bf16),
         flash_bf16, ("F.scaled_dot_product_attention", sdpa, None), None),
        ("mamba2-2.7b-prefill", "ssd_scan", lambda: mamba(2048, 80, 64, 128), dict(tol=1e-3),
         None, None),
    ]

    def measure(kname, label, dname, launches, out, call, plain_call, want, check,
                library, work, simt=None):
        """Check ``out``, kernel ``kname``'s output on these inputs; time
        ``call`` (one launch of it) and its plain version; add its row, with
        the registers and spills of every kernel in its library.  ``simt``,
        for a tensor-core kernel: the SIMT kernel of its op launched on the
        same inputs into a buffer of its own, checked as ``out`` is and
        timed beside it."""
        tag = f"[kernels-full] {label} {kname} {dname}"
        kernel = KERNELS[kname]
        # the plain version, timed over its comparison call
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        a_ev.record()
        plain = plain_call()
        b_ev.record()
        b_ev.synchronize()
        plain_ms = a_ev.elapsed_time(b_ev)
        err = held(tag, out, plain, want, check["tol"], exact=check["tol"] is None,
                   row_tol=check.get("row_tol"))
        if simt is not None:
            simt_run, scratch = simt
            simt_run()
            torch.cuda.synchronize()
            simt_err = held(f"{tag} the SIMT kernel on the same call", scratch, plain, want,
                            check["tol"], exact=check["tol"] is None,
                            row_tol=check.get("row_tol"))
        del plain
        ms = time_ms(call, 10)
        device_ms = graph_ms(call)
        library_ms = library_device_ms = None
        if library is not None:
            lib_name, lib_call, lib_tol, project = (library + (None,))[:4]
            lib_out = lib_call()
            lib_out = project(lib_out) if project else lib_out
            lib_err = float((lib_out.float() - out.float()).abs().max())
            lib_ok = lib_tol is None or torch.allclose(
                out.float(), lib_out.float(), rtol=lib_tol[0], atol=lib_tol[1])
            del lib_out
            library_ms = time_ms(lib_call, 10)
            library_device_ms = graph_ms(lib_call)
            log(f"{tag}: {lib_name} {library_ms:.4f} ms ({library_device_ms:.4f} ms replayed), "
                f"max|cuda - {lib_name}| = {lib_err!r}"
                + (f" (rtol={lib_tol[0]} atol={lib_tol[1]}) {'ok' if lib_ok else 'FAIL'}"
                   if lib_tol else " (reported)"))
            if not lib_ok:
                raise AssertionError(f"{tag}: disagrees with {lib_name}")
        else:
            log(f"{tag}: no single PyTorch call computes it; library_ms null")
        nbytes, nops, peak = work
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * nops / peak
        usage = ptxas_usage(kernel.source())
        row = rows[f"{kname}/{label}/{dname}"] = {
            "name": f"{kname}/{label}/{dname}",
            "route": "cuda",
            "source": str(kernel.path.relative_to(ROOT)),
            "replaces": kernel.replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "dev_ms": device_ms,
            "library_device_ms": library_device_ms,
            "ptxas": usage,
        }
        if simt is not None:
            row["simt_max_abs_err"] = simt_err
            row["simt_ms"] = time_ms(simt_run, 3)
            row["simt_device_ms"] = graph_ms(simt_run, 5)
            log(f"{tag}: the SIMT kernel on the same call {row['simt_ms']:.4f} ms "
                f"({row['simt_device_ms']:.4f} ms replayed), "
                f"{row['simt_device_ms'] / device_ms:.1f}x the tensor-core kernel's replayed time")
        log(f"{tag}: {ms:.4f} ms/launch ({device_ms:.4f} ms replayed, L2 flushed), "
            f"launches {launches}, plain {plain_ms:.2f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, {nops} flop), "
            f"library {library_ms if library_ms is None else round(library_ms, 4)} ms; "
            f"ptxas {usage}")
        return row

    for label, kname, make, check, library, generated in configs:
        t0 = time.perf_counter()
        args = make()
        op, plain_fn, ref_fn, kw = entry[kname]
        dname = "bf16" if args[0].dtype == bf16 else "f32"
        names = path.get(kname, (kname,))
        if kname == "matmul":
            # the SIMT kernel's tile and K split, from the shape alone
            (m, kd), n = args[0].shape, args[1].shape[1]
            tile, k_split, splits = simt_plan(m, n, kd)
            if splits > 1:
                names = ("matmul", "matmul_reduce")
        # the main path: the ops entry point, every launch count zeroed just
        # before and read just after
        for k in KERNELS.values():
            k.launches = 0
        out = op(*args, **kw)
        torch.cuda.synchronize()
        launches = {name: KERNELS[name].launches for name in names}
        others = {name: k.launches for name, k in KERNELS.items()
                  if k.launches and name not in launches}
        # the SSD op launches each of its four kernels exactly once
        once = kname != "ssd_scan" or set(launches.values()) == {1}
        if not all(launches.values()) or others or not once:
            raise AssertionError(f"[kernels-full] {label}: the main path must launch "
                                 f"{list(launches)} and nothing else; it launched {launches}, "
                                 f"and besides {others}")
        if kname == "matmul":
            log(f"[kernels-full] {label} matmul {dname}: SIMT plan {tile}x{tile} output tiles, "
                f"K {kd} in {splits} split(s) of {k_split}, "
                f"{-(-m // tile) * -(-n // tile) * splits} blocks; launches per call {launches}")
        if kname == "matmul" and splits > 1:
            # two kernels, each timed alone: the split partial sums into an
            # f32 workspace, then their reduction; the whole call is timed too
            ws = torch.empty((splits, m, n), dtype=f32, device=dev)
            part = lambda: mm.KERNEL(dev, args[0].data_ptr(), args[1].data_ptr(),  # noqa: E731
                                     ws.data_ptr(), m, n, kd, 0, tile, k_split, splits)
            part()
            row = measure("matmul", label, dname, launches["matmul"], out, part,
                          lambda: plain_fn(*args, **kw), ref_fn(*args, **kw), check,
                          (library[0], lambda: library[1](*args), library[2]),
                          kernel_work("matmul", args, out))
            row["call_ms"] = time_ms(lambda: op(*args), 10)
            row["call_device_ms"] = graph_ms(lambda: op(*args))
            red = measure("matmul_reduce", label, dname, launches["matmul_reduce"], out,
                          lambda: mm.REDUCE(dev, ws.data_ptr(), out.data_ptr(), m * n, splits, 0),
                          lambda: matmul_reduce_plain(ws, out.dtype), ws.sum(0), dict(tol=None),
                          ("torch.sum over the splits", lambda: ws.sum(0), None),
                          kernel_work("matmul_reduce", (ws,), out))
            red["shape"], red["dtype"] = [list(ws.shape)], dname
            log(f"[kernels-full] {label} matmul op (matmul + matmul_reduce): "
                f"{row['call_ms']:.4f} ms ({row['call_device_ms']:.4f} ms replayed, L2 flushed)")
            del ws
        elif kname != "ssd_scan":
            lib = library and (library[0], lambda: library[1](*args), library[2])
            simt = None
            if kname.endswith("_wgmma"):
                scratch = torch.empty_like(out)
                simt = (simt_call(kname, args, scratch), scratch)
            row = measure(kname, label, dname, launches[kname], out,
                          lambda: op(*args, **kw), lambda: plain_fn(*args, **kw),
                          ref_fn(*args, **kw), check, lib, kernel_work(kname, args, out), simt)
            if kname.startswith("flash_attention"):
                # the SIMT kernel's tile and residency on these inputs (the
                # row's own kernel, or the one launched on the same call)
                row["simt_plan"] = plan = fa.simt_plan(*args)
                log(f"[kernels-full] {label} {kname} {dname}: SIMT plan "
                    f"{plan['block_q']}x{plan['block_kv']} tile (D compiled for {plan['dmax']}), "
                    f"{plan['threads']} threads, {plan['blocks']} blocks, "
                    f"{plan['blocks_per_sm']} a SM ({plan['smem_bytes']} B of shared memory "
                    f"each), K and V by {plan['copy']}")
            if kname == "stencil3x3":
                x = args[0]
                row["plan"] = plan = dict(stencil.plan(x.shape[0] - 2, x.shape[1] - 2, x.dtype),
                                          blocks_per_sm=stencil.blocks_per_sm(x))
                log(f"[kernels-full] {label} {kname} {dname}: plan {plan['threads']} threads x "
                    f"{plan['v']} outputs a thread, bands of {plan['rows']} rows, "
                    f"{plan['strips']} strips x "
                    f"{plan['bands']} bands = {plan['blocks']} blocks, "
                    f"{plan['blocks_per_sm']} a SM")
            if kname == "flash_attention_wgmma":
                row["wgmma_plan"] = plan = fa.wgmma_plan(*args)
                log(f"[kernels-full] {label} {kname} {dname}: tensor-core plan "
                    f"{plan['block_q']}x{plan['block_kv']} tile (D compiled for {plan['dmax']}), "
                    f"{plan['consumers']} consumer warpgroup(s), "
                    f"{plan['threads']} threads, {plan['blocks']} blocks, "
                    f"{plan['blocks_per_sm']} a SM ({plan['smem_bytes']} B of shared memory each)")
        else:
            # four kernels, each timed alone on the outputs of the ones
            # before it: C B^T of every chunk, each chunk's own state and s,
            # the states entering the chunks, y; the whole call is timed too
            x, dt, a, b, c = args
            s_len, h, p = x.shape
            n = b.shape[1]
            chunk = min(plan_ssd(s_len, h, p, n).notes["chunk"], s_len)
            nc = s_len // chunk
            g = ssd_gram(b, c, chunk)
            g64 = torch.matmul(c.double().view(-1, chunk, n),
                               b.double().view(-1, chunk, n).transpose(1, 2)).tril()
            cc, bt = c.view(-1, chunk, n), b.view(-1, chunk, n).transpose(1, 2)
            measure("ssd_gram", label, dname, launches["ssd_gram"], g,
                    lambda: ssd_gram(b, c, chunk), lambda: ssd_gram_plain(b, c, chunk),
                    g64, dict(tol=1e-4),
                    ("torch.bmm (the whole square)", lambda: torch.bmm(cc, bt), None, torch.tril),
                    kernel_work("ssd_gram", (b, c), g, chunk))
            del g64
            # f64 oracles of the two state kernels, the Pallas body's formulas
            s64 = torch.cumsum(a.double()[None, None] * dt.double().view(nc, chunk, h), dim=1)
            w64 = torch.exp(s64[:, -1:] - s64) * dt.double().view(nc, chunk, h)
            st64 = torch.einsum("clh,clhp,cln->chnp", w64, x.double().view(nc, chunk, h, p),
                                b.double().view(nc, chunk, n))
            states, sl = ssd_chunk_state(x, dt, a, b, chunk)
            held(f"[kernels-full] {label} ssd_chunk_state {dname}: s", sl,
                 ssd_chunk_state_plain(x, dt, a, b, chunk)[1], s64.reshape(s_len, h), 1e-4)
            measure("ssd_chunk_state", label, dname, launches["ssd_chunk_state"], states,
                    lambda: ssd_chunk_state(x, dt, a, b, chunk),
                    lambda: ssd_chunk_state_plain(x, dt, a, b, chunk)[0], st64, dict(tol=1e-3),
                    None, kernel_work("ssd_chunk_state", (x, dt, a, b), states, chunk))
            decay64 = torch.exp(s64[:, -1])
            enter64 = torch.zeros_like(st64)
            for ci in range(1, nc):
                enter64[ci] = decay64[ci - 1][:, None, None] * enter64[ci - 1] + st64[ci - 1]
            del s64, w64, st64
            entering = ssd_state_pass(states.clone(), sl, chunk)
            spare = states.clone()          # rewritten by every timed launch
            measure("ssd_state_pass", label, dname, launches["ssd_state_pass"], entering,
                    lambda: ssd_state_pass(spare, sl, chunk),
                    lambda: ssd_state_pass_plain(states, sl, chunk), enter64, dict(tol=1e-3),
                    None, kernel_work("ssd_state_pass", (states, sl), entering, chunk))
            del enter64, spare, states
            row = measure("ssd_chunk_out", label, dname, launches["ssd_chunk_out"], out,
                          lambda: ssd_chunk_out(x, dt, c, g, sl, entering, chunk),
                          lambda: ssd_chunk_out_plain(x, dt, c, g, sl, entering, chunk),
                          ref_fn(*args), check, None,
                          kernel_work("ssd_chunk_out", (x, dt, c, g, sl, entering), out, chunk))
            row["call_ms"] = time_ms(lambda: op(*args), 10)
            row["call_device_ms"] = graph_ms(lambda: op(*args))
            log(f"[kernels-full] {label} ssd_op (ssd_gram + ssd_chunk_state + ssd_state_pass + "
                f"ssd_chunk_out): {row['call_ms']:.4f} ms ({row['call_device_ms']:.4f} ms "
                "replayed, L2 flushed)")
            del g, sl, entering
        if generated is not None:
            app_label, names = generated
            (gk,) = compile_pipeline(full_apps[app_label].pipeline).kernels
            bufs = dict(zip(names, args))
            same = torch.equal(gk(bufs), out)
            row["generated_ms"] = time_ms(lambda: gk(bufs), 10)
            row["generated_device_ms"] = graph_ms(lambda: gk(bufs))
            log(f"[kernels-full] {label} {kname} {dname}: generated vs hand-written, batch 1: "
                f"generated {app_label} kernel {row['generated_ms']:.4f} ms "
                f"({row['generated_device_ms']:.4f} ms replayed), {kname} {row['ms']:.4f} ms "
                f"({row['dev_ms']:.4f} ms replayed); bit for bit {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"{label}: differs from the generated {app_label} kernel")
        if kname == "matmul":
            row["simt_plan"] = {"tile": tile, "k_split": k_split, "splits": splits}
            # random inputs of the same shapes: the fused multiply-adds round
            # otherwise than the plain version's products, so the JAX
            # package's f32 tolerance, not bit for bit
            ra, rb = randn(args[0].shape, f32), randn(args[1].shape, f32)
            row["normal_max_abs_err"] = held(
                f"[kernels-full] {label} matmul {dname}, normal inputs", op(ra, rb),
                matmul_plain(ra, rb), kref.matmul_ref(ra, rb), 1e-4)
            del ra, rb
        row["shape"] = [list(t.shape) for t in args]
        row["dtype"] = dname
        log(f"[kernels-full] {label} {kname} {dname} {[tuple(t.shape) for t in args]}: "
            f"{time.perf_counter() - t0:.1f} s")
        del args, out
        torch.cuda.empty_cache()

    # A context plan's shard (models/layers.py:on_local_heads): the query
    # rows of the last of 16 model ranks, over the whole sequence's keys at
    # their offset, through the ops entry; held against the plain version
    # and the oracle at the offset and against the whole call's rows, and
    # timed beside the whole call.  qwen3-14b (40 heads, D 128) and
    # gemma3-1b (D 256) have a context plan over 16; tinyllama's f32 rows
    # take the SIMT kernel at D 64.
    shards = [
        ("qwen3-14b-shard", "flash_attention_wgmma", (40, 8, 4096, 128, bf16), flash_bf16),
        ("gemma3-1b-shard", "flash_attention_wgmma", (4, 1, 2048, 256, bf16), flash_bf16),
        ("tinyllama-shard", "flash_attention", (32, 4, 2048, 64, f32), flash_f32),
    ]
    for label, kname, (heads, kv_heads, s, d, dtype), check in shards:
        t0 = time.perf_counter()
        q, k, v = attention(heads, kv_heads, s, d, dtype)
        sq = s // 16
        off = s - sq
        rows_q = q[:, off:].contiguous()
        kw = {"causal": True, "q_offset": off}
        dname = "bf16" if dtype == bf16 else "f32"
        for kk in KERNELS.values():
            kk.launches = 0
        out = ops.attention_op(rows_q, k, v, **kw)
        torch.cuda.synchronize()
        launched = {name: kk.launches for name, kk in KERNELS.items() if kk.launches}
        if launched != {kname: 1}:
            raise AssertionError(f"[kernels-full] {label}: the shard call must launch {kname} "
                                 f"once and nothing else; it launched {launched}")
        whole = ops.attention_op(q, k, v, causal=True)
        torch.cuda.synchronize()
        tag = f"[kernels-full] {label} {kname} {dname} rows {off}..{s - 1} of {s}"
        want = kref.attention_ref(rows_q, k, v, q_offset=off)
        whole_err = held(f"{tag} against the whole call's rows", out, whole[:, off:], want,
                         check["tol"], row_tol=check.get("row_tol"))
        same = torch.equal(out, whole[:, off:])
        del whole
        keep = (torch.arange(s, device=dev)[None, :]
                <= (off + torch.arange(sq, device=dev))[:, None])
        lib = ("F.scaled_dot_product_attention (boolean mask)",
               lambda: F.scaled_dot_product_attention(rows_q[None], k[None], v[None],
                                                      attn_mask=keep)[0], None)
        simt = None
        if kname.endswith("_wgmma"):
            scratch = torch.empty_like(out)
            simt = (simt_call(kname, (rows_q, k, v), scratch, off), scratch)
        row = measure(kname, label, dname, launched[kname], out,
                      lambda: ops.attention_op(rows_q, k, v, **kw),
                      lambda: flash_attention_plain(rows_q, k, v, **kw), want, check, lib,
                      kernel_work(kname, (rows_q, k, v), out, q_offset=off), simt)
        plan = fa.wgmma_plan(rows_q, k, v) if kname.endswith("_wgmma") else fa.simt_plan(
            rows_q, k, v)
        row.update(q_offset=off, blocks=plan["blocks"], whole_max_abs_err=whole_err,
                   whole_bit_for_bit=same, shape=[list(t.shape) for t in (rows_q, k, v)],
                   dtype=dname)
        row["whole_ms"] = time_ms(lambda: ops.attention_op(q, k, v, causal=True), 10)
        row["whole_device_ms"] = graph_ms(lambda: ops.attention_op(q, k, v, causal=True))
        log(f"{tag}: {plan['blocks']} blocks of {plan['block_q']} query rows "
            f"({plan.get('blocks_per_sm')} a SM, 132 SMs); shard call {row['ms']:.4f} ms "
            f"({row['dev_ms']:.4f} ms replayed) against the whole call's {row['whole_ms']:.4f} ms "
            f"({row['whole_device_ms']:.4f} ms replayed): "
            f"{row['dev_ms'] / row['whole_device_ms']:.3f} of it replayed; bound at the offset "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); against the whole call's rows "
            f"{whole_err!r}{' (bit for bit)' if same else ''}; {time.perf_counter() - t0:.1f} s")
        del q, k, v, rows_q, out, want, keep
        torch.cuda.empty_cache()


# phase 8's fault cases: (label of a FULL configuration)
FAULT_CONFIGS = ["gaussian", "resnet"]


def stage_of(pipe):
    """A one-stage pipeline's normalized stage and its buffer shapes, the
    arguments ``compile_stage`` takes."""
    from repro_torch.frontend.lower import normalize_pipeline

    (ns,) = normalize_pipeline(pipe)
    return ns, {b: tuple(box.extents) for b, box in pipe.buffer_boxes.items()}


def compiler_phase(full_apps, rng) -> None:
    """Phase 8: the port's demo on the CUDA kernels, its quickstart on the
    card, and seeded fault injection through ``PipelineServer`` at full
    width.  Each part zeroes the launch counts it reads just before it
    runs and reads them just after; any failure raises."""
    import warnings

    import numpy as np
    import torch

    from repro_torch import quickstart
    from repro_torch.backend import (
        DeadlineExceededError, DegradedModeWarning, NonFiniteInputError, PipelineServer,
        PoisonedTileError, compile_pipeline, compile_stage, demo,
    )
    from repro_torch.backend.faults import (
        FaultClock, kernel_raise, mark_poison, nan_input, poison_cache_entry, poison_output,
        slow_dispatch,
    )
    from repro_torch.kernels import KERNELS

    # (a) the demo, every app on its generated CUDA kernels (the demo
    # compiles fresh pipelines, whose kernels start at 0 launches)
    t0 = time.perf_counter()
    rows = demo.run_demo(kernels="cuda")
    log("[compiler] demo: app,stages,kernels,linebuf,rings,smem_kib,hbm_kib,compile_us,"
        "run_us_cold,run_us_warm,launches,max_err,status")
    for r in rows:
        log(f"[compiler] demo: {r['app']},{r['stages']},{r['kernels']},{r['linebuf']},"
            f"{r['rings']},{r['smem_kib']:.2f},{r['hbm_kib']},{r['compile_us']},"
            f"{r['run_us_cold']},{r['run_us_warm']},{r['launches']},{r['max_err']!r},"
            f"{'OK' if r['ok'] else 'MISMATCH ' + '; '.join(r['plan_notes'])}")
        if not r["ok"]:
            raise AssertionError(f"demo {r['app']}: {r['plan_notes']} max_err {r['max_err']}")
        if not all(n == 2 for n in r["launches"].values()):
            raise AssertionError(f"demo {r['app']}: launches {r['launches']}, 2 a kernel expected")
    log(f"[compiler] demo: {len(rows)} apps ok on kernels='cuda', "
        f"{time.perf_counter() - t0:.1f} s")

    # (a, continued) compile_stage: the 1080p gaussian's stage alone, against
    # its plain version and the whole pipeline's kernel on the same input
    app = full_apps["gaussian"]
    ck = compile_stage(*stage_of(app.pipeline))
    ins = inputs_for(app, rng)
    bufs = {n: torch.from_numpy(a).cuda() for n, a in ins.items()}
    got = ck(bufs)
    launched = ck.launches
    plain = ck.plain(bufs)
    whole = compile_pipeline(app.pipeline).run(ins)[ck.name]
    if launched != 1 or not (torch.equal(got, plain) and torch.equal(got, whole)):
        raise AssertionError(f"compile_stage {ck.name}: launches {launched}, "
                             f"max|cuda - plain| {float((got - plain).abs().max())!r}")
    log(f"[compiler] compile_stage {ck.name} {tuple(got.shape)} grid={ck.grid} bh={ck.bh}: "
        "bit for bit with its plain version and the pipeline's kernel, 1 launch")

    # (b) the quickstart: steps 1-4 on the host, step 5 on the card
    t0 = time.perf_counter()
    stencil = KERNELS["stencil3x3"]
    stencil.launches = 0
    res = quickstart.run("cuda", out=lambda line: log(f"[compiler] quickstart: {line}"))
    launched = stencil.launches
    if res["problems"] or res["kernels"] != "cuda" or res["plain_err"] != 0.0 or launched != 1:
        raise AssertionError(f"quickstart: {res['problems']}, stencil3x3 launches {launched}")
    log(f"[compiler] quickstart: ok, stencil3x3 launches {launched}, "
        f"{time.perf_counter() - t0:.1f} s")

    # (c) fault injection at full width, batch 8, 20 seeded requests
    for label in FAULT_CONFIGS:
        name = next(n for lab, n, _kw, _i in FULL if lab == label)
        integer = next(i for lab, _n, _kw, i in FULL if lab == label)
        app = full_apps[label]
        tiles = [inputs_for(app, rng, integer=integer) for _ in range(N_REQUESTS)]
        tile_pp = compile_pipeline(app.pipeline)
        want = []
        for t in tiles:
            got = tile_pp.run(t)
            want.append({k.name: got[k.name].cpu().numpy() for k in tile_pp.kernels})
        out_names = [k.name for k in tile_pp.kernels]

        def exact(req, i):
            return req.ok and all(np.array_equal(req.outputs[k], want[i][k]) for k in out_names)

        def case(title, body, **server_kw):
            srv = PipelineServer(app.pipeline, batch_slots=BATCH, **server_kw)
            first = srv.pipeline
            for k in first.kernels:
                k.launches = 0
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                detail = body(srv, [dict(t) for t in tiles])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pps = [first] + ([srv.pipeline] if srv.pipeline is not first else [])
            launches = {k.name: sum(p.stage(k.name).launches for p in pps)
                        for k in first.kernels}
            if not all(launches.values()):
                raise AssertionError(f"faults {label} {title}: launches {launches}")
            degraded = sum(issubclass(w.category, DegradedModeWarning) for w in caught)
            log(f"[compiler] faults {label} {title}: {detail}; fault_counters "
                f"{srv.fault_counters}; DegradedModeWarning x{degraded}; wall {wall:.4f} s; "
                f"launches {launches}")
            return srv

        def poisoned(srv, reqs):
            bad = int(rng.integers(N_REQUESTS))
            mark_poison(reqs[bad])
            with poison_output(srv):
                done = srv.run(reqs)
            if not isinstance(done[bad].error, PoisonedTileError):
                raise AssertionError(f"faults {label}: marked tile {bad} got {done[bad].error!r}")
            if not all(exact(r, i) for i, r in enumerate(done) if i != bad):
                raise AssertionError(f"faults {label}: a healthy tile differs under poison_output")
            return f"tile {bad} failed closed ({done[bad].error.code}), 19 bit for bit"

        def transient(srv, reqs):
            with kernel_raise(srv, at_dispatch=2):
                done = srv.run(reqs)
            if not all(exact(r, i) for i, r in enumerate(done)):
                raise AssertionError(f"faults {label}: kernel_raise did not recover bit for bit")
            return "dispatch 2 raised, recovered, 20 bit for bit"

        def nonfinite(srv, reqs):
            (bad,) = nan_input(reqs, frac=1 / N_REQUESTS, seed=int(rng.integers(1 << 16)))
            done = []
            for i, r in enumerate(reqs):
                try:
                    done.append((i, srv.submit(r)))
                except NonFiniteInputError as e:
                    if i != bad:
                        raise AssertionError(f"faults {label}: tile {i} refused: {e}")
                    code = e.code
            while srv.pending:
                srv.step()
            if len(done) != N_REQUESTS - 1 or not all(exact(r, i) for i, r in done):
                raise AssertionError(f"faults {label}: nan_input neighbours not bit for bit")
            return f"tile {bad} refused at submit ({code}), 19 bit for bit"

        def slow(srv, reqs):
            tight = srv.submit(reqs[0], deadline=5.0)
            rest = [srv.submit(r, deadline=1000.0) for r in reqs[1:]]
            with slow_dispatch(srv, srv._clock, dispatch_s=10.0):
                while srv.pending:
                    srv.step()
            if not isinstance(tight.error, DeadlineExceededError):
                raise AssertionError(f"faults {label}: slow dispatch gave {tight.error!r}")
            if not all(exact(r, i + 1) for i, r in enumerate(rest)):
                raise AssertionError(f"faults {label}: a roomy tile differs under slow_dispatch")
            return f"tile 0 failed closed ({tight.error.code}), 19 bit for bit"

        def cache_poison(srv, reqs):
            broken = srv.pipeline
            with poison_cache_entry(broken):
                done = srv.run(reqs)
            if srv.pipeline is broken or not all(exact(r, i) for i, r in enumerate(done)):
                raise AssertionError(f"faults {label}: poisoned cache entry did not recover")
            return "poisoned entry dropped and recompiled, 20 bit for bit"

        case("poison_output", poisoned)
        case("kernel_raise(at_dispatch=2)", transient)
        case("nan_input", nonfinite)
        case("slow_dispatch", slow, clock=FaultClock())
        case("poison_cache_entry", cache_poison)
        del want
        torch.cuda.empty_cache()


# phase 9's searches: (label of a FULL configuration), batch 8
TUNE_CONFIGS = ["gaussian", "harris"]
TUNE_SEARCH = dict(max_candidates=32, measure_top=8, reps=5)


def tune_phase(full_apps, rng) -> None:
    """Phase 9: the verifier-gated autotuner on the card.  For each
    configuration, ``autotune.search`` at full size and batch 8 builds every
    certified survivor's library in one parallel nvcc batch, times each
    candidate's ``pp.run`` by CUDA events (median of 5 after a warm-up)
    and stores the winner in a database under a temporary directory; then
    ``compile_pipeline(tune=db)`` must serve the winner's plan, and its
    output must equal the heuristic plan's bit for bit on integer inputs."""
    import tempfile

    import torch

    from repro_torch.backend import compile_pipeline
    from repro_torch.backend.autotune import _plan_fingerprint, search

    fixed = {"batch": BATCH, "batch_capacity": BATCH}
    with tempfile.TemporaryDirectory() as tmp:
        db = str(Path(tmp) / "schedule_db_torch.json")
        for label in TUNE_CONFIGS:
            app = full_apps[label]
            t0 = time.perf_counter()
            r = search(app.pipeline, label=label, db=db, plan_kwargs=fixed, seed=SEED,
                       log=lambda msg: log(f"[tune] {msg}"), **TUNE_SEARCH)
            wall = time.perf_counter() - t0
            for c in r.measured:
                log(f"[tune] {label} {c.schedule or '{heuristic}'}: model_cycles "
                    f"{c.model_cycles}, {c.warm_us:.1f} us a run (median of "
                    f"{TUNE_SEARCH['reps']}, CUDA events; first run {c.cold_us:.0f} us), "
                    f"launches a run {c.launches}")
            for c in r.rejected:
                log(f"[tune] {label} {c.schedule}: rejected by {list(c.rules)}")
            winner = next(c for c in r.measured if c.schedule == r.schedule)
            log(f"[tune] {label}: winner {r.schedule or '{heuristic}'} {r.warm_us:.1f} us, "
                f"heuristic {r.heuristic_warm_us:.1f} us, speedup {r.heuristic_warm_us / r.warm_us:.3f}; "
                f"{len(r.candidates)} candidates, {len(r.measured)} measured, "
                f"{len(r.rejected)} rejected; nvcc batch build {r.build_s:.1f} s; "
                f"search wall {wall:.1f} s")
            tuned = compile_pipeline(app.pipeline, tune=db, **fixed)
            heur = compile_pipeline(app.pipeline, **fixed)
            if _plan_fingerprint(tuned.plan) != _plan_fingerprint(winner.plan):
                raise AssertionError(f"[tune] {label}: compile_pipeline(tune=db) does not "
                                     f"serve the stored winner {r.schedule}")
            ins = {n: torch.from_numpy(a).cuda()
                   for n, a in inputs_for(app, rng, batch=BATCH, integer=True).items()}
            for k in tuned.kernels:
                k.launches = 0
            got = tuned.run(ins)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in tuned.kernels}
            want = heur.run(ins)
            same = all(torch.equal(got[k.name], want[k.name]) for k in heur.kernels)
            log(f"[tune] {label}: compile_pipeline(tune=db) serves {r.schedule or '{heuristic}'} "
                f"(bh {[k.bh for k in tuned.kernels]}, grid {[k.grid for k in tuned.kernels]}), "
                f"launches {launches}; bit for bit with the heuristic plan on integer inputs: "
                f"{'ok' if same else 'FAIL'}")
            if not same or not all(launches.values()):
                raise AssertionError(f"[tune] {label}: the tuned plan differs from the heuristic's")


# phase 10's models: (label, arch, dtype name, the kernels one prefill must
# launch and how often, the windowed layers), B 1, S 2048, full width and depth
MODEL_CASES = [
    ("tinyllama-1.1b", "tinyllama_1_1b", "bf16", {"flash_attention_wgmma": 22}, 0),
    ("tinyllama-1.1b", "tinyllama_1_1b", "f32", {"flash_attention": 22}, 0),
    ("gemma3-1b", "gemma3_1b", "bf16", {"flash_attention_wgmma": 4}, 22),
    ("mamba2-2.7b", "mamba2_2_7b", "bf16",
     dict.fromkeys(("ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"), 64), 0),
]
# the rows of phase 7 whose kernels and shapes each model's prefill runs
MODEL_ROWS = {
    ("tinyllama-1.1b", "bf16"): ["flash_attention_wgmma/tinyllama-prefill/bf16"],
    ("tinyllama-1.1b", "f32"): ["flash_attention/tinyllama-prefill/f32"],
    ("gemma3-1b", "bf16"): ["flash_attention_wgmma/gemma3-1b-prefill/bf16"],
    ("mamba2-2.7b", "bf16"): [f"{k}/mamba2-2.7b-prefill/f32" for k in (
        "ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")],
}
PROMPT = 2048
DECODE_TOKENS = 16
# logits of the kernel route against the eager route on the card, relative
# to the largest eager logit
MODEL_TOL = {"f32": 1e-3, "bf16": 5e-2}
# mamba2-2.7b in bf16: the eager route alone lies 9.4e-2 x max|logit| from
# the f32 eager route of the same weights (64 layers of bf16 rounding; the
# kernel route 1.05e-1, and 8.2e-2 from the eager route), so two bf16
# routes cannot agree within 5e-2 there
MODEL_TOL_BF16 = {"mamba2-2.7b": 1e-1}
# a bf16 kernel route must be no less accurate than the eager route: its
# distance from the f32 eager route at most this many times the eager's
BF16_ACCURACY_RATIO = 1.25


def models_phase(rows) -> None:
    """Phase 10: the port's model package on the card.  Each model at full
    width and depth, random weights from a seeded generator on the card,
    one prompt of 2048 tokens: ``forward_prefill`` through the hand-written
    kernels with every launch count zeroed just before and read just after
    (the expected kernels exactly as often as the route rule says, no
    other), held against the same weights with ``kernels="eager"`` and
    timed (CUDA events, median of 5) beside its FLOP bound; then 16 greedy
    ``decode_step``s of tinyllama-1.1b bf16 from an empty cache, timed per
    token beside the weight-byte bound and held against an eager prefill of
    the same 16 tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.models import decode_step, forward_prefill, init_kv_cache, init_params
    from repro_torch.models.layers import ROUTES
    from repro_torch.models.model import _leaves, _map, param_count

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    weights = {}
    for label, arch, dname, expect, windowed in MODEL_CASES:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if (arch, "bf16") in weights and dname == "f32":
            # the same weights in f32
            params = _map(lambda t: t.float(), weights[(arch, "bf16")])
        else:
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            params = init_params(cfg, gen, dtypes[dname], "cuda")
        if arch == "tinyllama_1_1b":
            weights[(arch, dname)] = params
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, PROMPT), generator=gen, device="cuda")}
        with torch.no_grad():
            for k in KERNELS.values():
                k.launches = 0
            ROUTES.clear()
            got = forward_prefill(cfg, params, batch)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
            routes = dict(ROUTES)
            if launches != expect or routes.get("windowed", 0) != windowed:
                raise AssertionError(f"[models] {label} {dname}: prefill launched {launches} "
                                     f"with routes {routes}; expected {expect} and {windowed} "
                                     "windowed layers")
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = forward_prefill(cfg, params, batch, kernels="eager")
            b.record()
            b.synchronize()
            eager_ms = a.elapsed_time(b)
            ms = time_ms(lambda: forward_prefill(cfg, params, batch), 5)
        if not (torch.isfinite(got).all() and got.shape == (1, cfg.vocab)):
            raise AssertionError(f"[models] {label} {dname}: bad logits {tuple(got.shape)}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = MODEL_TOL_BF16.get(label, MODEL_TOL[dname]) if dname == "bf16" else MODEL_TOL[dname]
        same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
        ok = err <= tol * scale and (dname == "f32" or same_argmax)
        accuracy = ""
        if dname == "bf16":
            # both bf16 routes against the f32 eager route of the same weights
            with torch.no_grad():
                truth = forward_prefill(cfg, _map(lambda t: t.float(), params), batch,
                                        kernels="eager")
            e_kernel = float((got - truth).abs().max())
            e_eager = float((want - truth).abs().max())
            # random weights give near-uniform logits: where the f32 top-2 gap
            # is below bf16's own error, an argmax among the near-ties is as
            # good as the eager route's
            near_tie = float(truth.max() - truth[0, got.argmax(-1)]) <= e_eager
            ok = (err <= tol * scale and e_kernel <= BF16_ACCURACY_RATIO * e_eager
                  and (same_argmax or near_tie))
            accuracy = (f"; against the f32 eager route: kernel {e_kernel!r}, eager {e_eager!r} "
                        f"(limit {BF16_ACCURACY_RATIO} x eager's), the kernel's argmax "
                        f"{float(truth.max() - truth[0, got.argmax(-1)])!r} below the f32 max "
                        f"({'a near-tie within the eager error' if near_tie else 'not a near-tie'})")
            del truth
        n_body = param_count(params) - cfg.vocab * cfg.d_model
        flops = 2 * n_body * PROMPT
        peak = PEAK_BF16_FLOPS if dname == "bf16" else PEAK_F32_FLOPS
        bound = 1e3 * flops / peak
        log(f"[models] {label} {dname} prefill B 1 S {PROMPT}: {ms:.2f} ms (median of 5, CUDA "
            f"events), eager {eager_ms:.2f} ms; FLOP bound {bound:.3f} ms (2 x {n_body} "
            f"non-embedding parameters x {PROMPT} tokens over {peak / 1e12:g} TFLOP/s), "
            f"{ms / bound:.1f}x it; launches {launches}, routes {routes}; max|cuda - eager| "
            f"= {err!r} (limit {tol} x max|logit| {scale!r}), argmax "
            f"{'equal' if same_argmax else 'differs'}{accuracy} {'ok' if ok else 'FAIL'}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not ok:
            raise AssertionError(f"[models] {label} {dname}: the kernel route disagrees with eager")
        for key in MODEL_ROWS[(label, dname)]:
            kname = key.split("/")[0]
            rows[key].setdefault("model_launches", {})[f"{label} {dname} prefill"] = launches[kname]
            rows[key].setdefault("model_prefill_ms", {})[f"{label} {dname} prefill"] = ms
        del got, want, params
        torch.cuda.empty_cache()

    # -- decode: tinyllama-1.1b bf16, greedy from an empty cache
    cfg = get_config("tinyllama_1_1b")
    params = weights[("tinyllama_1_1b", "bf16")]
    weights.clear()
    cache = init_kv_cache(cfg, 1, DECODE_TOKENS, torch.bfloat16, "cuda")
    tok = torch.ones((1,), dtype=torch.long, device="cuda")
    seq, steps = [], []
    with torch.no_grad():
        for pos in range(DECODE_TOKENS):
            seq.append(tok)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            logits, cache = decode_step(cfg, params, cache, tok, pos)
            b.record()
            b.synchronize()
            steps.append(a.elapsed_time(b))
            tok = logits.argmax(-1)
        ref = forward_prefill(cfg, params, {"tokens": torch.stack(seq, 1)}, kernels="eager")
    err = float((logits - ref).abs().max())
    ok = bool(torch.isfinite(logits).all()) and err <= MODEL_TOL["bf16"] * float(ref.abs().max())
    # every weight is read once a token: the layers', and the embedding for the logits
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    bound = 1e3 * nbytes / PEAK_BYTES_PER_S
    tok_ms = statistics.median(steps[1:])
    log(f"[models] tinyllama-1.1b bf16 decode, {DECODE_TOKENS} greedy steps from an empty cache: "
        f"{tok_ms:.2f} ms a token (median of steps 2-{DECODE_TOKENS}, CUDA events; the first "
        f"{steps[0]:.2f}); weight-byte bound {bound:.3f} ms ({nbytes} B over 3.35 TB/s), "
        f"{tok_ms / bound:.1f}x it; last step's logits against an eager prefill of the same "
        f"{DECODE_TOKENS} tokens: max|diff| = {err!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[models] tinyllama-1.1b decode disagrees with its prefill")



# phase 11's training: tinyllama-1.1b at full width and depth through the
# launcher, f32 (the JAX launcher's dtype), B 2, S 1024, 2 microbatches;
# mamba2-2.7b at full width with 4 of its 64 layers (an earlier-path depth
# cut), B 2, S 1024, 1 microbatch; then serving on the trained tinyllama
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 2, 1024, 2
MAMBA_LAYERS = 4
# the kernel route against the eager route, one state and one batch: the
# loss relative to itself, each gradient leaf relative to its largest value
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# the resumed step against the uninterrupted one, relative to each leaf's
# largest value (0 expected: no kernel of the step uses atomics)
RESUME_TOL = 1e-6
SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 8


def _events_ms(fn):
    """(fn's result, its milliseconds between two CUDA events)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _worst_leaf(got, want):
    """(path, largest |got - want| / max|want| over the leaves)."""
    worst = ("", 0.0)
    for (path, g), w in zip(got, want):
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if rel > worst[1]:
            worst = (path, rel)
    return worst


def _held_against_eager(label, cfg, params, batch, micro, kv_chunk):
    """Each microbatch's loss and gradients on the kernel route against
    ``kernels="eager"``; returns the split of a step's work in ms: each
    microbatch's forward+backward (kernel route), its forward alone."""
    import torch

    from repro_torch.models import forward_train
    from repro_torch.models.model import _leaves
    from repro_torch.train.train_step import microbatch_grads

    paths = [p for p, _ in _leaves(params)]
    mbs = batch["tokens"].shape[0] // micro
    split = {"fwd_bwd_ms": [], "fwd_ms": []}
    for i in range(micro):
        mb = {k: v[i * mbs : (i + 1) * mbs] for k, v in batch.items()}
        (loss, grads), ms = _events_ms(lambda: microbatch_grads(cfg, params, mb, kv_chunk=kv_chunk))
        split["fwd_bwd_ms"].append(ms)
        with torch.no_grad():
            _, ms = _events_ms(lambda: forward_train(cfg, params, mb, kv_chunk=kv_chunk))
        split["fwd_ms"].append(ms)
        (loss_e, grads_e), eager_ms = _events_ms(
            lambda: microbatch_grads(cfg, params, mb, kv_chunk=kv_chunk, kernels="eager"))
        loss_rel = abs(float(loss) - float(loss_e)) / abs(float(loss_e))
        path, grad_rel = _worst_leaf(zip(paths, grads), grads_e)
        ok = loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL and all(
            bool(torch.isfinite(g).all()) for g in grads)
        log(f"[train] {label} microbatch {i}: kernel route against eager: loss {float(loss)!r} "
            f"vs {float(loss_e)!r}, relative {loss_rel!r} (limit {TRAIN_LOSS_TOL}); worst "
            f"gradient leaf {path}: max|cuda - eager| / max|eager| = {grad_rel!r} (limit "
            f"{TRAIN_GRAD_TOL}); eager forward+backward {eager_ms:.1f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[train] {label}: the kernel route's gradient disagrees with eager")
        del grads, grads_e
    return split


def _plain_backward_ms(plain, shapes, kw, reps=3):
    """(ms, peak MiB above the inputs) of one backward of a kernel's
    Function: the plain version's forward and ``autograd.grad`` on seeded
    inputs of ``shapes``, as ``kernels.grad`` runs it."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ins = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    if len(ins) == 5:                                         # SSD: dt > 0, a < 0
        ins[1] = ins[1].abs() * 0.1 + 0.01
        ins[2] = -ins[2].abs() - 0.1
    cot = torch.randn(shapes[0], generator=gen, device="cuda")

    def run():
        leaves = [t.clone().requires_grad_() for t in ins]
        return torch.autograd.grad(plain(*leaves, **kw), leaves, cot)

    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(_events_ms(run)[1] for _ in range(reps))
    return ms, (torch.cuda.max_memory_allocated() - base) / 2**20


def train_phase(rows) -> None:
    """Phase 11: the training path on the card.  tinyllama-1.1b at full
    width and depth in f32 through ``launch.train.main`` (3 steps, B 2, S
    1024, 2 microbatches, a checkpoint after step 2), a step taken again
    through ``make_train_step`` with every launch count zeroed just before
    and read just after (``flash_attention`` twice a layer and microbatch:
    the forward and remat's recompute; the backward is the plain version's
    gradient and launches nothing), timed by CUDA events and split, held
    against the eager route microbatch by microbatch; the launcher run
    again resumes from the step-2 checkpoint and must give step 3's loss
    and parameters.  mamba2-2.7b at full width, 4 layers: two steps, each
    SSD kernel twice a layer and batch row, held against eager.  Then
    ``ServeEngine`` on the trained tinyllama: no hand-written kernel, each
    greedy token checked against an eager prefill of the same context."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssd import ssd_scan_plain
    from repro_torch.launch import train as train_launch
    from repro_torch.models import decode_step, forward_prefill, init_kv_cache, init_params
    from repro_torch.models.model import _leaves, param_count
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import (
        AdamWConfig, DataPipeline, TrainState, adamw_init, adamw_update, make_train_step,
    )
    from repro_torch.train.train_step import batch_grads

    def zero_counts():
        for k in KERNELS.values():
            k.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in KERNELS.items() if k.launches}

    # -- tinyllama-1.1b through the launcher ---------------------------------
    t0 = time.perf_counter()
    cfg = get_config("tinyllama_1_1b")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    argv = ["--arch", "tinyllama-1.1b", "--steps", "3", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--microbatches", str(TRAIN_MICRO), "--ckpt-dir", ckpt,
            "--ckpt-every", "2", "--log-every", "1"]
    try:
        t1 = time.perf_counter()
        state, hist = train_launch.main(argv)
        launcher_s = time.perf_counter() - t1
        for h in hist:
            log(f"[train] tinyllama-1.1b f32 launcher step {h['step']}: loss {h['loss']!r}, "
                f"grad norm {h['grad_norm']!r}, {1e3 * h['s']:.1f} ms (host clock to the loss's "
                "read, which waits for the step)")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
            raise AssertionError("[train] tinyllama-1.1b: a loss or grad norm is not finite")

        # one step again, from the launcher's state and the next batch
        n_params = param_count(state.params)
        n_body = n_params - cfg.vocab * cfg.d_model
        tokens = TRAIN_BATCH * TRAIN_SEQ
        data = DataPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0, start_step=3)
        batch = train_launch.to_device(next(data), torch.device("cuda"))
        data.close()
        opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20)          # the launcher's
        kv_chunk = min(128, TRAIN_SEQ)
        step = make_train_step(cfg, opt_cfg, microbatches=TRAIN_MICRO, kv_chunk=kv_chunk)
        zero_counts()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (new_state, metrics), step_ms = _events_ms(lambda: step(state, batch))
        peak = torch.cuda.max_memory_allocated()
        launches = counts()
        want = {"flash_attention": 2 * cfg.n_layers * TRAIN_MICRO}
        flop_bound = 1e3 * 8 * n_body * tokens / PEAK_F32_FLOPS
        opt_bound = 1e3 * 7 * 4 * n_params / PEAK_BYTES_PER_S
        log(f"[train] tinyllama-1.1b f32 step (make_train_step, B {TRAIN_BATCH} S {TRAIN_SEQ}, "
            f"{TRAIN_MICRO} microbatches): {step_ms:.1f} ms (CUDA events), loss "
            f"{float(metrics['loss'])!r}, grad norm {float(metrics['grad_norm'])!r}; FLOP bound "
            f"{flop_bound:.1f} ms (8 x {n_body} non-embedding parameters x {tokens} tokens over "
            f"{PEAK_F32_FLOPS / 1e12:g} TFLOP/s: forward 2, backward 4, recompute 2), "
            f"{step_ms / flop_bound:.2f}x it; peak {peak / 2**30:.2f} GiB ({resident / 2**30:.2f} "
            f"resident before); launches {launches} (expected {want}: 2 x {cfg.n_layers} layers "
            f"x {TRAIN_MICRO} microbatches)")
        if launches != want:
            raise AssertionError(f"[train] tinyllama-1.1b: a step launched {launches}, not {want}")
        if not (math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))):
            raise AssertionError("[train] tinyllama-1.1b: the step's loss or grad norm is not finite")
        del new_state, metrics

        split = _held_against_eager("tinyllama-1.1b f32", cfg, state.params, batch, TRAIN_MICRO,
                                    kv_chunk)
        _, grads = batch_grads(cfg, state.params, batch, microbatches=TRAIN_MICRO,
                               kv_chunk=kv_chunk)
        _, opt_ms = _events_ms(lambda: adamw_update(opt_cfg, state.params, grads, state.opt))
        del grads
        attn_ms, attn_mib = _plain_backward_ms(
            flash_attention_plain, [(cfg.n_heads, TRAIN_SEQ, cfg.head_dim)] * 3,
            {"causal": True})
        fb, fw = sum(split["fwd_bwd_ms"]), sum(split["fwd_ms"])
        n_bwd = cfg.n_layers * TRAIN_MICRO
        log(f"[train] tinyllama-1.1b f32 step split (CUDA events): forward+backward "
            f"{' + '.join(f'{m:.1f}' for m in split['fwd_bwd_ms'])} ms (the microbatches), of "
            f"which forward alone {' + '.join(f'{m:.1f}' for m in split['fwd_ms'])} ms and "
            f"backward {fb - fw:.1f} ms (remat's recompute, about one forward, among it); the "
            f"attention Function's plain backward {attn_ms:.2f} ms a layer (B·H {cfg.n_heads}, "
            f"S {TRAIN_SEQ}, D {cfg.head_dim}; {attn_mib:.0f} MiB peak), x {n_bwd} = "
            f"{attn_ms * n_bwd:.1f} ms, {100 * attn_ms * n_bwd / step_ms:.1f}% of the step; "
            f"optimizer {opt_ms:.1f} ms against its byte bound {opt_bound:.2f} ms (7 x 4 B x "
            f"{n_params} parameters over 3.35 TB/s), {opt_ms / opt_bound:.1f}x it")
        for key in ("flash_attention/tinyllama-prefill/f32",):
            rows[key]["train_launches"] = {"tinyllama-1.1b f32 train step": want["flash_attention"]}
            rows[key]["train_step_ms"] = {"tinyllama-1.1b f32 train step": step_ms}
            rows[key]["plain_backward_ms"] = attn_ms

        # the launcher again: it restores the step-2 checkpoint and takes step 3
        meta = json.loads((Path(ckpt) / "step-00000002.json").read_text())
        t1 = time.perf_counter()
        resumed, hist_r = train_launch.main(argv)
        resume_s = time.perf_counter() - t1
        path, rel = _worst_leaf(_leaves(resumed.params), [t for _, t in _leaves(state.params)])
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_leaves(resumed.params), _leaves(state.params)))
        ok = ([h["step"] for h in hist_r] == [2] and meta["data"]["step"] == 2
              and abs(hist_r[0]["loss"] - hist[2]["loss"]) <= RESUME_TOL * abs(hist[2]["loss"])
              and rel <= RESUME_TOL)
        log(f"[train] tinyllama-1.1b f32 resumed from the step-2 checkpoint (data cursor "
            f"{meta['data']}): step 3 loss {hist_r[0]['loss']!r} against {hist[2]['loss']!r} "
            f"uninterrupted; parameters {'bit for bit' if same else f'worst leaf {path} {rel!r}'} "
            f"(limit {RESUME_TOL} of each leaf's largest); launcher wall {launcher_s:.1f} s "
            f"(3 steps, one checkpoint of {sum(f.stat().st_size for f in Path(ckpt).iterdir()) / 2**30:.2f} GiB), "
            f"resumed {resume_s:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[train] tinyllama-1.1b: the resumed step differs")
        del resumed
        params = state.params
        del state
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[train] tinyllama-1.1b phase {time.perf_counter() - t0:.1f} s")

    # -- mamba2-2.7b, full width, 4 layers ---------------------------------------
    t0 = time.perf_counter()
    mcfg = dataclasses.replace(get_config("mamba2_2_7b"), n_layers=MAMBA_LAYERS)
    mparams = init_params(mcfg, torch.Generator(device="cuda").manual_seed(SEED), torch.float32,
                          "cuda")
    mstate = TrainState(mparams, adamw_init(mparams), torch.Generator(device="cuda").manual_seed(1))
    del mparams
    data = DataPipeline(mcfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    mstep = make_train_step(mcfg, AdamWConfig(lr=3e-3, warmup_steps=20), kv_chunk=128)
    ssd = ("ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
    for i in range(2):
        batch = train_launch.to_device(next(data), torch.device("cuda"))
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        (mstate, metrics), ms = _events_ms(lambda: mstep(mstate, batch))
        launches = counts()
        want = dict.fromkeys(ssd, 2 * MAMBA_LAYERS * TRAIN_BATCH)
        log(f"[train] mamba2-2.7b f32, {MAMBA_LAYERS} of 64 layers (depth cut), step {i} (B "
            f"{TRAIN_BATCH} S {TRAIN_SEQ}, 1 microbatch): {ms:.1f} ms (CUDA events), loss "
            f"{float(metrics['loss'])!r}, grad norm {float(metrics['grad_norm'])!r}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} (expected "
            f"{want}: 2 x {MAMBA_LAYERS} layers x {TRAIN_BATCH} batch rows)")
        if launches != want:
            raise AssertionError(f"[train] mamba2-2.7b: step {i} launched {launches}, not {want}")
        if not (math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))):
            raise AssertionError(f"[train] mamba2-2.7b: step {i}'s loss or grad norm is not finite")
    data.close()
    _held_against_eager(f"mamba2-2.7b f32 ({MAMBA_LAYERS} layers)", mcfg, mstate.params, batch, 1,
                        128)
    chunk = min(256, TRAIN_SEQ)
    h, p_, n = mcfg.ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state
    ssd_ms, ssd_mib = _plain_backward_ms(
        ssd_scan_plain, [(TRAIN_SEQ, h, p_), (TRAIN_SEQ, h), (h,), (TRAIN_SEQ, n), (TRAIN_SEQ, n)],
        {"chunk": chunk})
    n_bwd = MAMBA_LAYERS * TRAIN_BATCH
    log(f"[train] mamba2-2.7b SSD Function's plain backward: {ssd_ms:.2f} ms a call (S "
        f"{TRAIN_SEQ}, H {h}, P {p_}, N {n}, chunk {chunk}; {ssd_mib:.0f} MiB peak), x {n_bwd} = "
        f"{ssd_ms * n_bwd:.1f} ms, {100 * ssd_ms * n_bwd / ms:.1f}% of the step")
    for k in ssd:
        key = f"{k}/mamba2-2.7b-prefill/f32"
        rows[key]["train_launches"] = {f"mamba2-2.7b f32 {MAMBA_LAYERS}-layer train step": want[k]}
        rows[key]["train_step_ms"] = {f"mamba2-2.7b f32 {MAMBA_LAYERS}-layer train step": ms}
        rows[key]["plain_backward_ms"] = ssd_ms
    del mstate, metrics
    torch.cuda.empty_cache()
    log(f"[train] mamba2-2.7b phase {time.perf_counter() - t0:.1f} s")

    # -- serving the trained tinyllama ------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (SERVE_SLOTS, SERVE_PROMPT), generator=gen,
                            device="cuda").tolist()
    engine = ServeEngine(cfg, params, SERVE_SLOTS, max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    zero_counts()
    done, serve_ms = _events_ms(lambda: engine.run(
        [Request(prompt=pr, max_new=SERVE_NEW) for pr in prompts]))
    launches = counts()
    steps = SERVE_PROMPT + SERVE_NEW - 1
    seqs = torch.tensor([r.prompt + r.generated for r in done], device="cuda")
    # the decode route's error: the same sequences teacher-forced through
    # decode_step against eager prefills of each context
    cache = init_kv_cache(cfg, SERVE_SLOTS, seqs.shape[1], torch.float32, "cuda")
    err, mismatches = 0.0, []
    with torch.no_grad():
        for pos in range(seqs.shape[1] - 1):
            logits, cache = decode_step(cfg, params, cache, seqs[:, pos], pos)
            if pos + 1 < SERVE_PROMPT:
                continue
            want = forward_prefill(cfg, params, {"tokens": seqs[:, : pos + 1]}, kernels="eager")
            err = max(err, float((logits - want).abs().max()))
            for i in range(SERVE_SLOTS):
                got_tok = int(seqs[i, pos + 1])
                best = int(want[i].argmax())
                if got_tok != best:
                    mismatches.append((i, pos + 1, float(want[i, best] - want[i, got_tok])))
    ties_ok = all(gap <= err for _, _, gap in mismatches)
    nbytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    bound = 1e3 * nbytes / PEAK_BYTES_PER_S
    tok_ms = serve_ms / steps
    ok = (not launches and ties_ok and all(len(r.generated) == SERVE_NEW for r in done))
    log(f"[train] serving the trained tinyllama-1.1b f32: ServeEngine, {SERVE_SLOTS} slots, "
        f"prompts of {SERVE_PROMPT}, {SERVE_NEW} new tokens each: {serve_ms:.1f} ms for {steps} "
        f"decode steps, {tok_ms:.2f} ms a step (CUDA events around the run); weight-byte bound "
        f"{bound:.3f} ms ({nbytes} B over 3.35 TB/s), {tok_ms / bound:.1f}x it; hand-written "
        f"launches {launches or 'none'}; teacher-forced decode against eager prefills: max|diff| "
        f"{err!r}, {len(mismatches)} greedy tokens differ from the eager argmax "
        f"{[(i, p, round(g, 6)) for i, p, g in mismatches]} (each allowed only as a near-tie, its "
        f"gap within that error) {'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise AssertionError("[train] serving the trained tinyllama failed its checks")


# phase 12's sharded runs on a world of one NCCL rank, each against the
# unsharded route of phases 10-11 on the same weights and inputs
DIST_PREFILL = 2048
DIST_MAMBA_LAYERS = 4
DIST_TRAIN_LAYERS, DIST_TRAIN_BATCH, DIST_TRAIN_SEQ, DIST_TRAIN_MICRO = 4, 2, 1024, 2
DIST_DECODE_STEPS = 8
# ring attention against chunked_gqa_attention, f32, max abs difference
RING_TOL = 1e-5


def _dist_equal(label, got, want, tol=0.0):
    """Max |got - want| over two tensors or two lists of them, asserted
    within ``tol`` (0: bit for bit)."""
    import torch

    pairs = list(zip(got, want)) if isinstance(got, (list, tuple)) else [(got, want)]
    err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
    if not all(g.shape == w.shape for g, w in pairs) or not err <= tol:
        raise AssertionError(f"[distributed] {label}: sharded differs from unsharded by {err!r} "
                             f"(limit {tol})")
    return err


def distributed_phase(rows) -> None:
    """Phase 12: the port's ``distributed/`` on a world of one NCCL rank
    (``launch.mesh.init_distributed`` from a ``FileStore``, the (1, 1) host
    mesh with the production axis names on the card), each run held against
    the unsharded route on the same weights and inputs: tinyllama-1.1b bf16
    prefill at full depth and mamba2-2.7b bf16 prefill on 4 layers, S 2048,
    parameters laid out by ``param_shardings`` under the plan's sharding
    context, the kernels launched on each rank's local shards (counts zeroed
    just before, read just after); a tinyllama-1.1b f32 train step (4
    layers, B 2, S 1024, 2 microbatches) with ZeRO gradient layouts
    (``zero_shardings``), then its state saved and restored with
    ``shardings``; 8 greedy decode steps with the cache placed by
    ``kv_cache_specs``; ``ring_attention`` on a 1-rank ``model`` ring
    against ``chunked_gqa_attention``; ``pipeline_forward`` on a 1-stage
    ``pod`` mesh against the stage applied directly.  Each sharded run is
    timed by CUDA events beside the unsharded one: DTensor's overhead."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import make_plan, param_shardings
    from repro_torch.distributed.context import sharding_context
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.distributed.sharding import (
        P, distribute_batch, distribute_tree, gather_tree, named, zero_shardings,
    )
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import init_distributed, make_host_mesh, make_mesh
    from repro_torch.models import forward_prefill, init_kv_cache, init_params
    from repro_torch.models.layers import chunked_gqa_attention
    from repro_torch.models.model import _leaves
    from repro_torch.serve.engine import make_serve_step, place_cache
    from repro_torch.train import AdamWConfig, TrainState, adamw_init, make_train_step
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    def zero_counts():
        for k in KERNELS.values():
            k.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in KERNELS.items() if k.launches}

    def leaves(tree):
        return [t for _, t in _leaves(tree)]

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dist_", dir=ROOT / "build")
    card = card_line()
    init_distributed(init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        log(f"[distributed] {card}: a world of 1 NCCL rank (backend {dist.get_backend()}), the "
            f"(1, 1) host mesh {tuple(mesh.mesh_dim_names)} on {mesh.device_type}; several NCCL "
            "ranks on one card are not tried, so no collective moves data here (the multi-rank "
            "semantics are the gloo tests' on the CPU)")

        # -- prefill: tinyllama-1.1b full depth, mamba2-2.7b 4 layers, bf16
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        for label, cfg, expect, keys in (
            ("tinyllama-1.1b", get_config("tinyllama_1_1b"),
             {"flash_attention_wgmma": 22}, ["flash_attention_wgmma/tinyllama-prefill/bf16"]),
            (f"mamba2-2.7b ({DIST_MAMBA_LAYERS} of 64 layers)",
             dataclasses.replace(get_config("mamba2_2_7b"), n_layers=DIST_MAMBA_LAYERS),
             dict.fromkeys(("ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"),
                           DIST_MAMBA_LAYERS),
             [f"{k}/mamba2-2.7b-prefill/f32" for k in (
                 "ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")]),
        ):
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                 torch.bfloat16, "cuda")
            batch = {"tokens": torch.randint(0, cfg.vocab, (1, DIST_PREFILL), generator=gen,
                                             device="cuda")}
            plan = make_plan(cfg, mesh)
            dparams = distribute_tree(params, param_shardings(plan, params))
            dbatch = distribute_batch(plan, batch)
            with torch.no_grad():
                want = forward_prefill(cfg, params, batch)
                with sharding_context(mesh, plan):
                    zero_counts()
                    got = forward_prefill(cfg, dparams, dbatch)
                    launches = counts()
                    ms = time_ms(lambda: forward_prefill(cfg, dparams, dbatch), 3)
                plain_ms = time_ms(lambda: forward_prefill(cfg, params, batch), 3)
            if launches != expect:
                raise AssertionError(f"[distributed] {label} prefill launched {launches}, not "
                                     f"{expect}")
            err = _dist_equal(f"{label} prefill", got.full_tensor(), want)
            log(f"[distributed] {label} bf16 prefill B 1 S {DIST_PREFILL} (plan "
                f"{plan.attn_strategy}/{plan.moe_strategy}): sharded {ms:.2f} ms, unsharded "
                f"{plain_ms:.2f} ms (CUDA events, median of 3), DTensor overhead "
                f"{ms - plain_ms:.2f} ms ({ms / plain_ms:.2f}x); launches {launches}; logits "
                f"max|sharded - unsharded| = {err!r} (bit for bit) ok")
            for key in keys:
                rows[key]["sharded_launches"] = {f"{label} bf16 sharded prefill":
                                                 launches[key.split("/")[0]]}
                rows[key]["sharded_prefill_ms"] = ms
            del params, dparams, got, want
            torch.cuda.empty_cache()

        # -- a ZeRO-grad train step, then save and restore with shardings
        cfg = dataclasses.replace(get_config("tinyllama_1_1b"), n_layers=DIST_TRAIN_LAYERS)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                             torch.float32, "cuda")
        batch = {k: torch.randint(0, cfg.vocab, (DIST_TRAIN_BATCH, DIST_TRAIN_SEQ),
                                  generator=gen, device="cuda") for k in ("tokens", "labels")}
        opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20)
        plan = make_plan(cfg, mesh)
        psh = param_shardings(plan, params)
        kw = dict(microbatches=DIST_TRAIN_MICRO, kv_chunk=128)
        step = make_train_step(cfg, opt_cfg, grad_shardings=zero_shardings(plan, params), **kw)
        plain = make_train_step(cfg, opt_cfg, **kw)
        dparams = distribute_tree(params, psh)
        dstate = TrainState(dparams, adamw_init(dparams), torch.Generator(device="cuda"))
        state = TrainState(params, adamw_init(params), torch.Generator(device="cuda"))
        dbatch = distribute_batch(plan, batch)
        (want, met_u), plain_ms = _events_ms(lambda: plain(state, batch))
        with sharding_context(mesh, plan):
            zero_counts()
            (new, met), first_ms = _events_ms(lambda: step(dstate, dbatch))
            launches = counts()
            # the same step again, DTensor's sharding propagation cached
            del new, met
            (new, met), ms = _events_ms(lambda: step(dstate, dbatch))
        expect = {"flash_attention": 2 * DIST_TRAIN_LAYERS * DIST_TRAIN_MICRO}
        if launches != expect:
            raise AssertionError(f"[distributed] train step launched {launches}, not {expect}")
        got_p = gather_tree(new.params)
        err = _dist_equal("train step", [met["loss"].full_tensor(),
                                         met["grad_norm"].full_tensor(), *leaves(got_p)],
                          [met_u["loss"], met_u["grad_norm"], *leaves(want.params)])
        log(f"[distributed] tinyllama-1.1b f32 train step ({DIST_TRAIN_LAYERS} layers, B "
            f"{DIST_TRAIN_BATCH} S {DIST_TRAIN_SEQ}, {DIST_TRAIN_MICRO} microbatches, ZeRO "
            f"gradient layouts): sharded {ms:.1f} ms (the first call {first_ms:.1f} ms, sharding "
            f"propagation uncached), unsharded {plain_ms:.1f} ms (CUDA events), DTensor overhead "
            f"{ms - plain_ms:.1f} ms ({ms / plain_ms:.2f}x); launches {launches} (the first call); "
            f"loss {float(met_u['loss'])!r}, grad norm {float(met_u['grad_norm'])!r}, loss, grad "
            f"norm and every updated parameter max|sharded - unsharded| = {err!r} (bit for bit) ok")
        rows["flash_attention/tinyllama-prefill/f32"]["sharded_launches"] = {
            f"tinyllama-1.1b f32 {DIST_TRAIN_LAYERS}-layer sharded train step":
            expect["flash_attention"]}
        rows["flash_attention/tinyllama-prefill/f32"]["sharded_train_step_ms"] = ms
        ckpt = f"{tmp}/ckpt"
        t0 = time.perf_counter()
        save_checkpoint(ckpt, 1, new.params, new.opt, {"step": 1})
        osh = {"m": psh, "v": psh, "step": named(mesh, P())}
        rp, ro, meta = restore_checkpoint(ckpt, 1, params, state.opt, shardings=(psh, osh))
        same = all(type(a) is type(b) and torch.equal(a.full_tensor(), b.full_tensor())
                   for a, b in zip(leaves(rp) + leaves(ro["m"]) + leaves(ro["v"]),
                                   leaves(new.params) + leaves(new.opt["m"])
                                   + leaves(new.opt["v"])))
        if not (same and meta["step"] == 1):
            raise AssertionError("[distributed] the restored sharded state differs from the saved")
        log(f"[distributed] the sharded state saved and restored with shardings: "
            f"{len(leaves(rp)) * 3} tensors bit for bit, placements kept, "
            f"{time.perf_counter() - t0:.1f} s ok")
        del params, dparams, new, want, got_p, rp, ro, state, dstate
        torch.cuda.empty_cache()

        # -- decode with the cache placed by kv_cache_specs
        cfg = get_config("tinyllama_1_1b")
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                             torch.bfloat16, "cuda")
        plan = make_plan(cfg, mesh)
        dparams = distribute_tree(params, param_shardings(plan, params))
        serve = make_serve_step(cfg)
        cache = init_kv_cache(cfg, 4, DIST_DECODE_STEPS, torch.float32, "cuda")
        dcache = place_cache(plan, init_kv_cache(cfg, 4, DIST_DECODE_STEPS, torch.float32,
                                                 "cuda"))
        tok = dtok = torch.arange(1, 5, device="cuda")
        toks, dtoks, step_ms, dstep_ms = [], [], [], []
        with torch.no_grad():
            for pos in range(DIST_DECODE_STEPS):
                (tok, cache), t_ms = _events_ms(lambda: serve(params, cache, tok, pos))
                with sharding_context(mesh, plan):
                    zero_counts()
                    (dtok, dcache), d_ms = _events_ms(lambda: serve(dparams, dcache, dtok, pos))
                    if counts():
                        raise AssertionError("[distributed] decode launched a hand-written kernel")
                toks.append(tok.tolist())
                dtoks.append(dtok.tolist())
                step_ms.append(t_ms)
                dstep_ms.append(d_ms)
        err = _dist_equal("decode cache", [dcache[k].full_tensor() for k in sorted(cache)],
                          [cache[k] for k in sorted(cache)])
        if toks != dtoks:
            raise AssertionError(f"[distributed] decode tokens differ: {dtoks} vs {toks}")
        log(f"[distributed] tinyllama-1.1b bf16 decode, 4 slots, {DIST_DECODE_STEPS} greedy steps, "
            f"cache placed by kv_cache_specs ({ {k: str(v.placements) for k, v in dcache.items()} }): "
            f"sharded {statistics.median(dstep_ms[1:]):.2f} ms a step, unsharded "
            f"{statistics.median(step_ms[1:]):.2f} ms (CUDA events, median of steps 2-"
            f"{DIST_DECODE_STEPS}); tokens equal ({toks[-1]} last), cache max|diff| = {err!r} ok")
        del params, dparams, cache, dcache
        torch.cuda.empty_cache()

        # -- ring attention on a 1-rank model ring, tinyllama's f32 prefill shape
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        q = torch.randn(1, DIST_PREFILL, 32, 64, generator=gen, device="cuda")
        k = torch.randn(1, DIST_PREFILL, 4, 64, generator=gen, device="cuda")
        v = torch.randn(1, DIST_PREFILL, 4, 64, generator=gen, device="cuda")
        with torch.no_grad():
            for window in (None, 512):
                got, ms = _events_ms(lambda: ring_attention(q, k, v, mesh, window=window))
                want, plain_ms = _events_ms(
                    lambda: chunked_gqa_attention(q, k, v, window=window, kv_chunk=512))
                err = _dist_equal(f"ring attention window {window}", got.full_tensor(), want,
                                  RING_TOL)
                log(f"[distributed] ring_attention, 1-rank model ring, B 1 S {DIST_PREFILL} 32/4 "
                    f"heads D 64 f32, window {window}: {ms:.2f} ms, chunked_gqa_attention "
                    f"{plain_ms:.2f} ms (CUDA events, one call); max|ring - chunked| = {err!r} "
                    f"(limit {RING_TOL}) ok")

        # -- the GPipe schedule on a 1-stage pod mesh
        pod = make_mesh((1,), ("pod",))
        w = torch.randn(1, 2048, 2048, generator=gen, device="cuda") * 0.02
        micro = torch.randn(4, 8, 2048, generator=gen, device="cuda")
        fn = pipeline_forward(lambda ws, x, stage: torch.tanh(x @ ws), pod)
        with torch.no_grad():
            got, ms = _events_ms(lambda: fn(w, micro))
            want, plain_ms = _events_ms(lambda: torch.tanh(micro @ w[0]))
        err = _dist_equal("pipeline", got, want)
        log(f"[distributed] pipeline_forward, 1-stage pod mesh, 4 microbatches of 8 x 2048: "
            f"{ms:.2f} ms, the stage applied directly {plain_ms:.2f} ms; max|diff| = {err!r} "
            "(bit for bit) ok")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


DRYRUN_CELL = ("qwen3_14b", "train_4k")
# phase 10's tinyllama-1.1b bf16 prefill (B 1, S 2048) on a fake world of one
# rank: its report, the bytes of its parameters and tokens, its launches
DRYRUN_CALIBRATION = r"""
import json, torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import init_params, param_count
with dryrun.fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"), device_type="fake")
    cost, rep = dryrun.lower_cell("tinyllama_1_1b", "prefill_2k", mesh=mesh,
                                  info=dict(kind="prefill", seq=2048, batch=1))
cfg = dryrun.get_config("tinyllama_1_1b")
rep["params_and_tokens_bytes"] = (2 * param_count(init_params(cfg, None, torch.bfloat16, "meta"))
                                  + 4 * 2048)
rep["launches"] = cost.kernels
print(json.dumps(rep))
"""


def dryrun_phase(rows) -> None:
    """Phase 13: the dry run (``repro_torch.launch.dryrun``), each run in a
    subprocess of its own (this process owns the default NCCL group of
    phase 12): (1) phase 10's tinyllama-1.1b bf16 prefill, B 1, S 2048, on a
    fake (1, 1) world, its modelled terms (H100 data-sheet constants)
    printed beside phase 10's measured ms, its argument bytes exactly its
    parameters' and tokens', 22 attention kernels charged; (2) one
    production cell at full size on the fake (16, 16) and (2, 16, 16)
    worlds through the CLI (``_dryrun_cell``).  The fit test reads the
    card's own memory."""
    import os

    import torch

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    props = torch.cuda.get_device_properties(0)
    log(f"[dryrun] {torch.cuda.get_device_name(0)}: total_memory {props.total_memory} B, "
        "the dry run's fit test on this card")
    measured = [ms for r in rows.values()
                for k, ms in r.get("model_prefill_ms", {}).items()
                if k == "tinyllama-1.1b bf16 prefill"]
    if not measured:
        raise AssertionError("[dryrun] phase 10's tinyllama-1.1b bf16 prefill time is missing")
    res = subprocess.run([sys.executable, "-c", DRYRUN_CALIBRATION], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    if res.returncode:
        raise AssertionError(f"[dryrun] calibration failed:\n{res.stderr[-3000:]}")
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    r, mem = rep["roofline"], rep["memory"]
    if mem["argument_bytes_per_chip"] != rep["params_and_tokens_bytes"]:
        raise AssertionError(f"[dryrun] argument bytes {mem['argument_bytes_per_chip']} are not "
                             f"the parameters' and tokens' {rep['params_and_tokens_bytes']}")
    if rep["launches"] != {"flash_attention": 22}:
        raise AssertionError(f"[dryrun] calibration charged {rep['launches']}, want 22 attention")
    bound_ms = 1e3 * max(r["t_compute"], r["t_memory"], r["t_collective"])
    useful_ms = 1e3 * r["model_flops"] / PEAK_BF16_FLOPS
    log(f"[dryrun] calibration tinyllama-1.1b bf16 prefill B 1 S 2048, fake (1, 1) world "
        f"(modelled, data-sheet peaks): compute {1e3 * r['t_compute']:.3f} ms, memory "
        f"{1e3 * r['t_memory']:.3f} ms, collective {1e3 * r['t_collective']:.3f} ms, "
        f"{r['dominant']}-bound at {bound_ms:.3f} ms, roofline_fraction "
        f"{r['roofline_fraction']:.3f}; FLOPs {r['flops']:.6g}, HBM bytes {r['hbm_bytes']:.6g}, "
        f"arguments {mem['argument_bytes_per_chip']} B (= parameters + tokens), temp "
        f"{mem['temp_bytes_per_chip']} B, launches {rep['launches']}, trace {rep['trace_s']} s | "
        f"phase 10 measured {measured[0]:.3f} ms on this card: {measured[0] / bound_ms:.2f}x the "
        f"modelled bound, useful compute {useful_ms:.3f} ms = {useful_ms / measured[0]:.3f} of it")
    arch, shape = DRYRUN_CELL
    for multi_pod in (False, True):
        _dryrun_cell(arch, shape, multi_pod, env)


# qwen3-14b train_4k when every model rank of its context plan ran the
# attention on the whole sequence, not its own query rows: the dry run's
# report then, torch 2.13 (PERF.md section 6)
DRYRUN_REPLICATED = {
    False: "t_compute 6.934 s, f32 FLOPs 4.12e14, 320 flash_attention launches",
    True: "t_compute 3.467 s, f32 FLOPs 2.06e14, 320 flash_attention launches",
}


def _dryrun_cell(arch, shape, multi_pod, env) -> None:
    """One production cell at full size through the dry run's CLI, on the
    fake (16, 16) world or, ``multi_pod``, the (2, 16, 16) one: its compute
    term at least 6 x active parameters x tokens over the ranks and the
    bf16 peak, and its peak within this card's memory."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--force"] + (["--multi-pod"] if multi_pod else []),
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    world = "(2, 16, 16)" if multi_pod else "(16, 16)"
    out = ROOT / "results" / "dryrun_torch" / f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}.json"
    if res.returncode or not out.exists():
        raise AssertionError(f"[dryrun] {arch} {shape} {world} failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-3000:]}")
    rep = json.loads(out.read_text())
    if rep["status"] != "ok":
        raise AssertionError(f"[dryrun] {arch} {shape} {world}: {rep['status']} "
                             f"{rep.get('error')}")
    r, mem = rep["roofline"], rep["memory"]
    # 6 x active parameters x tokens a rank over the bf16 peak: the compute
    # term's floor before remat's recompute
    floor = r["model_flops"] / rep["chips"] / PEAK_BF16_FLOPS
    if r["t_compute"] < floor:
        raise AssertionError(f"[dryrun] {arch} {shape} {world}: compute term {r['t_compute']} s, "
                             f"want at least {floor:.4f} s")
    log(f"[dryrun] {arch} {shape} at full size, fake {world} world, torch {rep['torch']} "
        f"(modelled, data-sheet peaks): compute {r['t_compute']:.4f} s (floor "
        f"{floor:.4f}), memory {r['t_memory']:.4f} s, collective "
        f"{r['t_collective']:.4f} s, {r['dominant']}-bound; FLOPs {r['flops_by_unit']}, "
        f"collective bytes {r['collective_bytes']} ({r['network_bytes']} across nodes); "
        f"per rank {mem['peak_gb_per_chip']} GB, fits {mem['fits_80gb']} against "
        f"{mem['budget_bytes']} B of {mem['budget_of']}; microbatches {rep['microbatches']}, "
        f"trace {rep['trace_s']} s, wall {wall:.1f} s")
    log(f"[dryrun] {arch} {shape} {world}: traced as rank {rep['rank']['rank']} at "
        f"{rep['rank']['coordinate']} ({rep['plan']['attn']} plan): t_compute "
        f"{r['t_compute']:.4f} s, f32 FLOPs {r['flops_by_unit'].get('f32', 0.0):.4g}, launches "
        f"{r['trace_cost']['kernels']}; with the attention replicated over model: "
        f"{DRYRUN_REPLICATED[multi_pod]}")
    if not mem["fits_80gb"]:
        raise AssertionError(f"[dryrun] {arch} {shape} {world}: {mem['peak_gb_per_chip']} GB a "
                             f"rank does not fit {mem['budget_bytes']} B")


# phase 14's examples: train_lm at its defaults (llama-100m, batch 4, seq
# 128, 2 microbatches, the JAX script's 150 steps)
EXAMPLE_STEPS = 150
EXAMPLE_LOSS_EVERY = 10


def examples_phase(rows, kind: str) -> None:
    """Phase 14: the three ``repro_torch.examples`` scripts through their
    ``main`` on the card (see the module docstring), each with every
    launch count zeroed just before it runs and read just after."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.apps.paper_apps import make_app
    from repro_torch.backend import compile_pipeline
    from repro_torch.backend.runner import clear_pipeline_cache
    from repro_torch.examples import schedule_explorer, serve_demo, train_lm
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.launch.train import to_device
    from repro_torch.models import init_params
    from repro_torch.models.model import param_count
    from repro_torch.train import DataPipeline, adamw_init, adamw_update
    from repro_torch.train.train_step import batch_grads

    def zero_counts():
        for k in KERNELS.values():
            k.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in KERNELS.items() if k.launches}

    # -- serve_demo: decoding, then the serve bridge's failure paths ----------
    clear_pipeline_cache()            # the failure paths' kernels start at 0 launches
    zero_counts()
    t0 = time.perf_counter()
    res = serve_demo.main([])
    wall = time.perf_counter() - t0
    launches = counts()
    serve, faults = res["serve"], res["faults"]
    srv, ref = faults["server"], faults["ref"]
    served = {k.name: k.launches for k in srv.pipeline.kernels}
    per_tile = {k.name: k.launches for k in ref.kernels}
    app = make_app("gaussian", size=13)
    plain = compile_pipeline(app.pipeline, block_h=4, kernels="eager")
    name = app.pipeline.output
    vs_plain = all(np.array_equal(r.outputs[name], plain.run(t)[name].cpu().numpy())
                   for r, t in zip(faults["healthy"], (faults["tiles"][0], faults["tiles"][2])))
    codes = {k: e.code for k, e in faults["errors"].items()}
    s = faults["stats"]
    ok = (serve["deterministic"] and serve["tokens"] == 4 * serve_demo.MAX_NEW and not launches
          and faults["exact"] and vs_plain and len(codes) == 4 and all(served.values())
          and sum(per_tile.values()) == 2
          and (s["poisoned_tiles"], s["deadline_misses"], s["served"], s["failed"]) == (1, 1, 7, 2))
    log(f"[examples] serve_demo: {serve['tokens']} greedy tokens in {serve['s']:.3f} s "
        f"({serve['tokens'] / serve['s']:.1f} tok/s, host clock, as the script times it), "
        f"deterministic {serve['deterministic']}, hand-written launches {launches or 'none'}; "
        f"failure paths on gaussian 13 at batch 4: {codes}; counters poisoned "
        f"{s['poisoned_tiles']} deadline {s['deadline_misses']} rejected "
        f"{s['validation_rejects']}+{s['backpressure_rejects']} served {s['served']} failed "
        f"{s['failed']}, dispatches {s['dispatches']}; generated-kernel launches {served} "
        f"served, {per_tile} per tile; healthy tiles bit for bit with the per-tile pipeline "
        f"{faults['exact']} and with the plain version {vs_plain}; wall {wall:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[examples] serve_demo failed its checks")
    key = next(k for k in rows if k.startswith("gaussian/"))
    rows[key].setdefault("example_launches", {})["serve_demo failure paths (gaussian 13, batch "
                                                  "4)"] = sum(served.values())

    # -- train_lm: the first step held against eager, then the 150 steps ------
    cfg = train_lm.config()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.float32, "cuda")
    data = DataPipeline(cfg.vocab, 4, 128, seed=0)
    batch = to_device(next(data), torch.device("cuda"))
    data.close()
    split = _held_against_eager("llama-100m f32 (train_lm's first step)", cfg, params, batch,
                                train_lm.MICROBATCHES, train_lm.KV_CHUNK)
    _, grads = batch_grads(cfg, params, batch, microbatches=train_lm.MICROBATCHES,
                           kv_chunk=train_lm.KV_CHUNK)
    opt_state = adamw_init(params)
    _, opt_ms = _events_ms(lambda: adamw_update(train_lm.OPT, params, grads, opt_state))
    mb_rows = batch["tokens"].shape[0] // train_lm.MICROBATCHES
    attn_ms, _ = _plain_backward_ms(
        flash_attention_plain, [(mb_rows * cfg.n_heads, 128, cfg.head_dim)] * 3, {"causal": True})
    n_attn = cfg.n_layers * train_lm.MICROBATCHES
    fb, fw = sum(split["fwd_bwd_ms"]), sum(split["fwd_ms"])
    log(f"[examples] train_lm llama-100m first step split (CUDA events): forward+backward "
        f"{' + '.join(f'{m:.1f}' for m in split['fwd_bwd_ms'])} ms (the microbatches), of which "
        f"forward alone {' + '.join(f'{m:.1f}' for m in split['fwd_ms'])} ms and backward "
        f"{fb - fw:.1f} ms (remat's recompute among it); the attention Function's plain "
        f"backward {attn_ms:.2f} ms a call (B·H {mb_rows * cfg.n_heads}, S 128, D "
        f"{cfg.head_dim}) x {n_attn} = {attn_ms * n_attn:.1f} ms; optimizer {opt_ms:.1f} ms")
    n_body = param_count(params) - cfg.vocab * cfg.d_model
    del params, batch, grads, opt_state
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    res = train_lm.main(["--steps", str(EXAMPLE_STEPS)])
    wall = time.perf_counter() - t0
    launches = counts()
    per_step = 2 * cfg.n_layers * train_lm.MICROBATCHES
    want = {"flash_attention": per_step * EXAMPLE_STEPS}
    losses = res["losses"]
    step_ms = 1e3 * res["wall_s"] / EXAMPLE_STEPS
    flop_bound = 1e3 * 8 * n_body * 4 * 128 / PEAK_F32_FLOPS
    ok = (launches == want and res["verdict"] == "LEARNING"
          and all(math.isfinite(x) for x in losses) and len(losses) == EXAMPLE_STEPS)
    log(f"[examples] train_lm llama-100m f32, {EXAMPLE_STEPS} steps of batch 4 x seq 128, "
        f"{train_lm.MICROBATCHES} microbatches, remat: loss every {EXAMPLE_LOSS_EVERY} steps "
        f"{[round(x, 4) for x in losses[::EXAMPLE_LOSS_EVERY]]}, last {losses[-1]!r}; "
        f"first 10 {res['first']:.4f} -> last 10 {res['last']:.4f} ({res['verdict']}); "
        f"{res['tok_s']:.0f} tok/s, {step_ms:.2f} ms a step (host clock over the run, each "
        f"step ending in the loss's read); FLOP bound {flop_bound:.3f} ms a step (8 x {n_body} "
        f"non-embedding parameters x 512 tokens over {PEAK_F32_FLOPS / 1e12:g} TFLOP/s), "
        f"{step_ms / flop_bound:.1f}x it; launches {launches} (expected {want}: {per_step} a "
        f"step, {cfg.n_layers} layers x {train_lm.MICROBATCHES} microbatches x the forward and "
        f"remat's recompute); wall {wall:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[examples] train_lm failed its checks")
    rows["flash_attention/tinyllama-prefill/f32"].setdefault("example_launches", {})[
        "train_lm llama-100m step"] = launches["flash_attention"] // EXAMPLE_STEPS
    rows["flash_attention/tinyllama-prefill/f32"]["example_step_ms"] = step_ms
    del res
    torch.cuda.empty_cache()

    # -- schedule_explorer: measured on its default apps into a temporary db ---
    with tempfile.TemporaryDirectory() as tmp:
        db = Path(tmp) / "schedule_db_torch.json"
        t0 = time.perf_counter()
        res = schedule_explorer.main(["--db", str(db)])
        wall = time.perf_counter() - t0
        entries = json.loads(db.read_text())["entries"]
    ok = res["rc"] == 0 and len(entries) == len(res["results"]) == 3 and all(
        e["mode"] == "cuda" and e["device"] == kind for e in entries.values())
    for app_name, r in res["results"].items():
        good = all(c.launches for c in r.measured) and r.warm_us <= r.heuristic_warm_us
        ok = ok and good
        log(f"[examples] schedule_explorer {app_name}: {len(r.candidates)} candidates, "
            f"{len(r.measured)} measured (launches a run {[c.launches for c in r.measured]}), "
            f"{len(r.rejected)} rejected; winner {r.schedule or '{heuristic}'} {r.warm_us:.1f} us "
            f"against the heuristic's {r.heuristic_warm_us:.1f} us (CUDA events, median of 3), "
            f"{r.speedup:.3f}x; nvcc batch {r.build_s:.1f} s {'ok' if good else 'FAIL'}")
    log(f"[examples] schedule_explorer: {len(entries)} rows in the temporary db, modes "
        f"{sorted({e['mode'] for e in entries.values()})}, devices "
        f"{sorted({e['device'] for e in entries.values()})}; wall {wall:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[examples] schedule_explorer failed its checks")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible", file=sys.stderr)
        return 2

    from repro_torch.apps import make_app
    from repro_torch.backend import (
        PipelineServer, compile_pipeline, compile_stage, reference_arrays,
    )
    from repro_torch.backend.build import build_many, digest, ptxas_usage
    from repro_torch.backend.demo import DEMO_APPS, make_demo_app
    from repro_torch.backend.cuda_codegen import (
        REPLACES, block_threads, chain_tile, element_map, emit_library, grid_x, lane_layout,
        output_tile, row_bands, shared_bytes, staged_inputs,
    )
    from repro_torch.backend.eager import LoweredGroup
    from repro_torch.backend.plan import build_pipeline_plan
    from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK
    from repro_torch.kernels import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device -----------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build: every library at once ---------------------------------------
    configs = []
    for name, kw, ckw, _exact in SMALL:
        configs.append((make_app(name, **kw).pipeline, ckw))
    full_apps = {}
    for label, name, kw, _int in FULL:
        app = make_app(name, **kw)
        full_apps[label] = app
        configs.append((app.pipeline, {"batch": BATCH, "batch_capacity": BATCH}))
        configs.append((app.pipeline, {}))
        if label in FULL_BATCH:
            nb = FULL_BATCH[label]
            configs.append((app.pipeline, {"batch": nb, "batch_capacity": nb}))
    # the demo's apps (phase 8), planned as the demo compiles them
    for name, kw in DEMO_APPS:
        configs.append((make_demo_app(name, kw).pipeline, {}))
    sources = []
    for pipe, ckw in configs:
        plan = build_pipeline_plan(pipe, vmem_budget=H100_SMEM_PER_BLOCK, **ckw)
        sources.append(emit_library([LoweredGroup(kg) for kg in plan.kernels]))
    # phase 14's serve_demo: gaussian 13 served at batch 4 and per tile, block_h 4
    for ckw in ({"block_h": 4, "batch": 4, "batch_capacity": 4}, {"block_h": 4}):
        configs.append((make_app("gaussian", size=13).pipeline, ckw))
    # phase 8's compile_stage group (planned here; its plain version lowers it)
    staged = compile_stage(*stage_of(full_apps["gaussian"].pipeline), device="cpu", kernels="eager")
    sources.append(emit_library([staged.lg]))
    # the hand-written kernels' sources join the same parallel build
    sources += list(dict.fromkeys(k.source() for k in KERNELS.values()))
    t0 = time.perf_counter()
    build_secs = build_many(sources)
    log(f"[build] {len(build_secs)} nvcc builds in parallel, wall "
        f"{time.perf_counter() - t0:.1f} s; per build: "
        + ", ".join(f"{s:.1f}" for s in build_secs.values()))

    # -- 3. small-size reference -----------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    for name, kw, ckw, exact in SMALL:
        app = make_app(name, **kw)
        pp = compile_pipeline(app.pipeline, **ckw)
        ins = inputs_for(app, rng, integer=True)
        got = pp.run(ins)
        torch.cuda.synchronize()
        want = reference_arrays(app.pipeline, ins)
        for k in pp.kernels:
            g = got[k.name].cpu().numpy().astype(np.float64)
            w = want[k.name]
            err = float(np.max(np.abs(g - w)))
            if exact:
                ok = np.array_equal(g, w)
            else:
                ok = np.allclose(g, w, rtol=1e-4, atol=1e-3)
            log(f"[small] {name}/{k.name} {kw} {ckw} [{', '.join(variants(k.kg))}]: "
                f"max|cuda - reference| = {err!r} "
                f"({'exact' if exact else 'rtol=1e-4 atol=1e-3'}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}/{k.name} disagrees with the reference")
    log(f"[small] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 4. full size: kernel vs plain -----------------------------------------
    rows = {}
    t_phase = time.perf_counter()
    for label, name, _kw, integer in FULL:
        app = full_apps[label]
        t0 = time.perf_counter()
        nb = FULL_BATCH.get(label, BATCH)
        pp = compile_pipeline(app.pipeline, batch=nb, batch_capacity=nb, cache=True)
        compile_s = time.perf_counter() - t0
        ins = inputs_for(app, rng, batch=nb, integer=integer)
        bufs = {n: torch.from_numpy(a).cuda() for n, a in ins.items()}
        lib_src = emit_library([k.lg for k in pp.kernels])
        nvcc_s = build_secs.get(digest(lib_src))
        usage = ptxas_usage(lib_src)
        for gi, k in enumerate(pp.kernels):
            out = k(bufs)
            torch.cuda.synchronize()
            # the plain version is timed over its comparison call
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            plain = k.plain(bufs)
            b.record()
            b.synchronize()
            plain_ms = a.elapsed_time(b)
            bufs[k.name] = out
            if out.shape != plain.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{label}/{k.name}: bad output {tuple(out.shape)}")
            err = float((out - plain).abs().max())
            ms = time_ms(lambda: k(bufs), 10)
            dev_ms = graph_ms(lambda: k(bufs))
            em = element_map(k.lg)
            bands = row_bands(k.lg) if k.lg.row_carried else None
            blocks = grid_x(k.lg) * k.kg.batch_steps
            threads = block_threads(k.lg)
            regs = usage.get(f"ub_kernel_{gi}", {})
            smem = shared_bytes(k.lg)
            staged = staged_inputs(k.lg)
            ot = output_tile(k.lg)
            per_sm = k.blocks_per_sm()
            lane = lane_layout(k.lg)
            nbytes, ops = bytes_and_ops(k)
            t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
            t_ops = 1e3 * ops / PEAK_F32_FLOPS
            # the one PyTorch call computing the same function, where there is
            # one: it is also a check that shares no code with the port
            library, lib_ok, msg = library_check(label, bufs, out, k.name)
            library_ms = library_device_ms = None
            if library is not None:
                library_ms = time_ms(library, 10)
                library_device_ms = graph_ms(library)
            pair = two_calls(label, bufs)
            two_ms = two_device_ms = None
            if pair is not None:
                two_ms = time_ms(pair, 10)
                two_device_ms = graph_ms(pair)
                log(f"[full] {label}/{k.name} depthwise + pointwise F.conv2d, two calls: "
                    f"{two_ms:.4f} ms ({two_device_ms:.4f} ms replayed)")
            if lib_ok is None:
                # the last slot, whole image, held against the app's math
                # written as whole-image torch expressions
                (src,) = app.input_extents
                want = independent(name, bufs[src][nb - 1])[k.name]
                got = out[nb - 1]
                lib_err = float((got - want).abs().max())
                lib_ok = got.shape == want.shape and torch.allclose(got, want, rtol=1e-4, atol=1e-3)
                msg = (f"slot {nb - 1}: max|cuda - torch expression| = {lib_err!r} "
                       "(rtol=1e-4 atol=1e-3)")
            log(f"[full] {label}/{k.name} {msg} {'ok' if lib_ok else 'FAIL'}")
            if not lib_ok:
                raise AssertionError(f"{label}/{k.name}: CUDA kernel disagrees with an independent computation")
            rows[f"{label}/{k.name}"] = {
                "name": f"{label}/{k.name}",
                "route": "cuda",
                "source": "src/repro_torch/backend/cuda_codegen.py",
                "replaces": REPLACES,
                "launches": 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms,
                "dev_ms": dev_ms,
                "library_device_ms": library_device_ms,
                "blocks": blocks,
                "threads": threads,
                "bands": len(bands) if bands else None,
                "band_steps": bands[0][1] if bands else None,
                "tile": em.tile if em is not None else None,
                "run": em.run if em is not None else None,
                "tiled_staged_bytes": (sum(st.nbytes for st in em.staged)
                                       if em is not None else None),
                "smem_bytes": smem,
                "blocks_per_sm": per_sm,
                "barriers_per_lane_step": lane[1] if lane else None,
                "staged": [{"buffer": st.buffer, "bytes": st.nbytes, "smem_bytes": st.smem_bytes,
                            "strides": list(st.strides)} for st in staged],
                "output_tile": [ot.rows, ot.cols] if ot is not None else None,
                "two_call_ms": two_ms,
                "two_call_device_ms": two_device_ms,
                "regs_per_thread": regs.get("registers"),
                "spill_bytes": regs.get("spill_stores"),
                "nvcc_s": nvcc_s,
                "plan_hbm_bound_ms": 1e3 * k.kg.hbm_bytes() / PEAK_BYTES_PER_S,
                "variants": variants(k.kg),
                "app": label,
            }
            if em is not None:
                thread_map = (f"element-parallel, thread axis {em.thread_axis}, tile {em.tile} "
                              f"along {em.tile_axis}, run {em.run} ({em.lanes} lanes apart), "
                              f"staged {[(st.buffer, st.nbytes) for st in em.staged]}")
            elif bands:
                thread_map = (f"element loop, row sweep in {len(bands)} bands of "
                              f"{bands[0][1]} row steps ({k.lg.steps} in all) a slot")
            elif lane:
                thread_map = (f"element loop, {k.lg.lane_steps} lane steps a block, "
                              f"{lane[1]} barriers a lane step")
            elif k.kg.chain is not None:
                ch, ct = k.kg.chain, chain_tile(k.lg)
                thread_map = (
                    f"hidden chain {list(ch.hidden)} -> {ch.consumer}: {ch.count} panels of "
                    f"{ch.block} of {ch.extent}, hidden tile {ch.tile[0]}x{ch.tile[1]} a thread, "
                    f"consumer tile {ct.rows}x{ct.cols} a thread ({ct.lanes} lanes), panels "
                    f"reused {list(ch.reuse)}; staged "
                    + ", ".join(f"{st.buffer} {st.smem_bytes} B"
                                + (" a panel" if st.panel else "") for st in staged))
            elif ot is not None or staged:
                thread_map = (
                    "element loop; staged "
                    + (", ".join(f"{st.buffer} {st.nbytes} B ({st.smem_bytes} B, strides "
                                 f"{list(st.strides)})" for st in staged) or "nothing")
                    + (f"; output tile {ot.rows}x{ot.cols} a thread ({ot.lanes} lanes x "
                       f"{ot.groups} groups)" if ot is not None else ""))
            else:
                thread_map = "element loop"
            log(f"[full] {label}/{k.name} grid={k.kg.grid} bh={k.kg.bh} bw={k.kg.bw} "
                f"smem={smem} B (plan scratch {k.kg.scratch_bytes} B) "
                f"[{', '.join(variants(k.kg))}]: "
                f"max|cuda - plain| = {err!r} (tolerance 0); "
                f"{ms:.4f} ms/launch ({dev_ms:.4f} ms replayed, L2 flushed), "
                f"plain {plain_ms:.2f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}), "
                f"library {library_ms if library_ms is None else round(library_ms, 4)} ms "
                f"({library_device_ms if library_device_ms is None else round(library_device_ms, 4)}"
                f" ms replayed), compile {compile_s:.2f} s; {thread_map}: {blocks} blocks of {threads} "
                f"threads, {per_sm} a SM, {regs.get('registers')} registers, "
                f"{regs.get('spill_stores')} B spilled, nvcc {nvcc_s} s")
            if err != 0.0:
                raise AssertionError(f"{label}/{k.name}: CUDA kernel differs from plain by {err}")
    log(f"[full] phase wall {time.perf_counter() - t_phase:.1f} s")

    # -- 5. serve ----------------------------------------------------------------
    t_phase = time.perf_counter()
    for label, name, _kw, integer in FULL:
        app = full_apps[label]
        server = PipelineServer(app.pipeline, batch_slots=BATCH)
        tile_pp = compile_pipeline(app.pipeline)
        reqs = [inputs_for(app, rng, integer=integer) for _ in range(N_REQUESTS)]
        server.run(reqs)                     # warm-up: allocator, first copies
        # time the kernels of each dispatch through the server's one seam
        spans = []
        seam = server._run_pipeline

        def timed(pp, ins, seam=seam, spans=spans):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = seam(pp, ins)
            b.record()
            spans.append((a, b))
            return out

        server._run_pipeline = timed
        before = server.stats()["dispatches"]
        for k in server.pipeline.kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = server.run(reqs)
        secs = time.perf_counter() - t0
        counts = {k.name: k.launches for k in server.pipeline.kernels}
        dispatches = server.stats()["dispatches"] - before
        if dispatches != 3 or not all(r.ok for r in done):
            raise AssertionError(f"{label}: serve stats {server.stats()}")
        kernel_ms = sum(a.elapsed_time(b) for a, b in spans)
        for k in server.pipeline.kernels:
            if counts[k.name] == 0:
                raise AssertionError(f"{label}/{k.name}: kernel never launched while serving")
            rows[f"{label}/{k.name}"]["launches"] = counts[k.name]
            rows[f"{label}/{k.name}"]["launches_per_dispatch"] = counts[k.name] / dispatches
        for req, ins in zip(done, reqs):
            want = tile_pp.run(ins)
            for kname, arr in req.outputs.items():
                if not np.array_equal(arr, want[kname].cpu().numpy()):
                    raise AssertionError(f"{label}/{kname}: served tile differs from the per-tile pipeline")
        if label in ("convnext", "swin"):
            # the served answers against the benchmark's plain reference
            from portbench import reference

            gaps = []
            for req, ins in zip(done, reqs):
                one = {n: torch.from_numpy(a[None]).cuda() for n, a in ins.items()}
                want = reference.get(label)(one)[label][0]
                got = torch.from_numpy(req.outputs[label]).cuda()
                gaps.append(float((got - want).abs().max() / want.abs().max()))
            if max(gaps) > 1e-5:
                raise AssertionError(f"{label}: served answers off the reference by {max(gaps)}")
            log(f"[serve] {label}: every answer within {max(gaps)!r} of the plain reference "
                "(max|got - want| / max|want|, limit 1e-5)")
        log(f"[serve] {label}: {N_REQUESTS} requests in {dispatches} dispatches, "
            f"{secs:.4f} s, {N_REQUESTS / secs:.1f} img/s; kernels {kernel_ms:.3f} ms "
            f"({100 * kernel_ms / (1e3 * secs):.1f}% of wall); launches {counts}; "
            "every tile equals the per-tile pipeline")
    log(f"[serve] phase wall {time.perf_counter() - t_phase:.1f} s")

    # -- 6. hand-written kernels, small shapes -----------------------------------
    t0 = time.perf_counter()
    kernels_small()
    log(f"[kernels-small] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 7. hand-written kernels at model widths ---------------------------------
    t0 = time.perf_counter()
    kernels_full(full_apps, rows)
    log(f"[kernels-full] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 8. compiler: the demo, the quickstart, fault injection ------------------
    t0 = time.perf_counter()
    compiler_phase(full_apps, rng)
    log(f"[compiler] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 9. tune: the autotuner's searches, served through tune=... -------------
    t0 = time.perf_counter()
    tune_phase(full_apps, rng)
    log(f"[tune] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 10. models: prefill through the kernels, decode --------------------------
    t0 = time.perf_counter()
    models_phase(rows)
    log(f"[models] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 11. train: the training path through the kernels, then serving --------
    t0 = time.perf_counter()
    train_phase(rows)
    log(f"[train] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 12. distributed: the sharded path on one NCCL rank ----------------------
    t0 = time.perf_counter()
    distributed_phase(rows)
    log(f"[distributed] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 13. dryrun: the production cells on a fake world, modelled ------------
    t0 = time.perf_counter()
    dryrun_phase(rows)
    log(f"[dryrun] phase wall {time.perf_counter() - t0:.1f} s")

    # -- 14. examples: serve_demo, train_lm, schedule_explorer on the card -------
    t0 = time.perf_counter()
    examples_phase(rows, kind)
    log(f"[examples] phase wall {time.perf_counter() - t0:.1f} s")

    # every variant of the generated kernel, with the configurations that
    # launched it at full size and its largest difference from the plain version
    by_variant = {}
    for row in rows.values():
        for v in row.get("variants", ()):
            apps, err = by_variant.get(v, ([], 0.0))
            by_variant[v] = (apps + [row["name"]], max(err, row["max_abs_err"]))
    for v, (apps, err) in sorted(by_variant.items()):
        log(f"[variants] {v}: {', '.join(apps)}; max|cuda - plain| = {err!r}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
