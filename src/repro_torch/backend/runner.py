"""Whole-pipeline compilation and execution on the card.

``compile_pipeline`` plans a lowered :class:`~repro_torch.frontend.lower.Pipeline`
(``plan.build_pipeline_plan``), certifies the plan (``verify``) and turns
each planned :class:`~repro_torch.backend.plan.KernelGroup` into one
executable kernel, run in topological order.  Only kernel outputs are
materialized in device memory; fused intermediates live in shared memory.

The execution contract is explicit, with no fallback:

* ``device="cuda"`` (the default) runs on the card and raises when no GPU
  is visible; ``device="cpu"`` runs on the CPU.
* ``kernels="cuda"`` (the default) runs each group as its hand-written
  CUDA kernel (``cuda_codegen``, built by ``build``); it needs a CUDA
  device.  ``kernels="eager"`` runs the plain PyTorch version
  (``eager.EagerKernel``) on the named device — what the CPU tests and the
  on-card comparisons ask for.

``compile_pipeline(..., cache=True)`` keys whole compiled pipelines on a
content hash of the lowered pipeline, every plan-affecting keyword, the
device and the kernel choice (:func:`plan_cache_key`).  ``reference_arrays``
converts the reference interpreter's value tables into zero-based dense
arrays for differential comparison.
"""

from __future__ import annotations

import hashlib
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.ubplan import H100_SMEM_PER_BLOCK
from repro_torch.frontend.expr import refs_in
from repro_torch.frontend.lower import (
    NormalizedStage, Pipeline, execute_pipeline, normalize_pipeline,
)

from .access import UnsupportedAccessError, decompose_stage
from .build import load_library
from .cuda_codegen import CudaKernel, element_map, emit_library
from .eager import EagerKernel, GroupKernel, LoweredGroup
from .errors import LaneCarryDegradeWarning, TunedModeMismatchWarning
from .plan import (
    PipelinePlan, RED_GRID_THRESHOLD, _build_kernel_group, _stream_ok, build_pipeline_plan,
)
from .verify import assert_plan_verified

KERNEL_CHOICES = ("cuda", "eager")


def _warn_lane_carry_degrades(plan: PipelinePlan) -> None:
    """An explicit ``line_buffer=True`` that the planner cannot honor on a
    lane-blocked kernel must not pass silently.  The planner records its
    reason in ``KernelGroup.notes["lane_carry"]`` (and partial sheds in
    ``notes["lane_carry_shed"]``); surface each one as a named warning,
    attributed to the caller of ``compile_pipeline``."""
    for kg in plan.kernels:
        if kg.lane_grid is None:
            continue
        reason = kg.notes.get("lane_carry")
        shed = kg.notes.get("lane_carry_shed")
        out = kg.stages[-1].name
        if reason not in (None, "carried"):
            warnings.warn(
                f"kernel {out!r}: line_buffer=True requested but the "
                f"lane-blocked plan degraded to recompute mode "
                f"(reason: {reason})",
                LaneCarryDegradeWarning,
                stacklevel=3,
            )
        elif shed:
            stages = ", ".join(shed.get("stages", ())) or "<none>"
            warnings.warn(
                f"kernel {out!r}: line_buffer=True requested but the "
                f"lane-blocked plan shed part of the carry "
                f"(stages: {stages}; ring classes dropped: "
                f"{shed.get('ring_classes', 0)}) — halo exceeds the lane "
                f"block width for the shed members",
                LaneCarryDegradeWarning,
                stacklevel=3,
            )


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a pipeline runs on; ``cuda`` without a visible GPU raises
    (the port never carries on on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is visible; pass "
                "device='cpu' to run the plain version on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def inputs_to_torch(
    inputs: Mapping[str, object],
    device: Union[str, torch.device],
    pipeline: Optional[Pipeline] = None,
    batch: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Turn the JAX package's input convention — a dict of arrays in loop
    order (outermost first), with a leading batch dim when batched — into
    contiguous f32 tensors on ``device``.  With ``pipeline`` given, every
    input it declares must be present with exactly its declared extents
    (plus the leading ``batch`` dim)."""
    dev = torch.device(device)
    names = list(pipeline.inputs) if pipeline is not None else list(inputs)
    out: Dict[str, torch.Tensor] = {}
    for name in names:
        if name not in inputs:
            raise KeyError(
                f"missing input {name!r}; the plan requires {sorted(names)}"
            )
        arr = inputs[name]
        if isinstance(arr, torch.Tensor):
            t = arr.to(device=dev, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev)
        t = t.contiguous()
        if pipeline is not None:
            want = tuple(pipeline.buffer_boxes[name].extents)
            if batch is not None:
                want = (batch,) + want
            if t.ndim != len(want):
                raise ValueError(
                    f"input {name!r}: rank {t.ndim} (shape {tuple(t.shape)}) "
                    f"!= plan's declared rank {len(want)} (extents {want}"
                    + (f", leading dim = batch {batch})" if batch else ")")
                )
            if tuple(t.shape) != want:
                raise ValueError(
                    f"input {name!r}: shape {tuple(t.shape)} != the plan's "
                    f"declared extents {want}"
                    + (f" (leading dim = batch {batch})" if batch else "")
                )
        out[name] = t
    return out


@dataclass
class TorchPipeline:
    """Executable pipeline: one kernel per planned group, in dependency
    order (``CudaKernel``s or ``EagerKernel``s, per ``kernels``)."""

    pipeline: Pipeline
    kernels: List[GroupKernel]
    plan: PipelinePlan
    device: torch.device
    kernel_choice: str = "cuda"
    cache_key: Optional[str] = None

    @property
    def stages(self) -> List[GroupKernel]:
        """The kernels (the JAX package's name; one kernel may cover
        several fused stages)."""
        return self.kernels

    def stage(self, name: str) -> GroupKernel:
        """The kernel writing buffer ``name``, or the one that fuses stage
        ``name``."""
        for k in self.kernels:
            if k.name == name:
                return k
        for k in self.kernels:
            if name in k.stage_names:
                return k
        raise KeyError(name)

    kernel = stage

    def run(self, inputs: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        """Execute every kernel; returns every *materialized* buffer
        (zero-based tensors on the pipeline's device): the inputs plus one
        buffer per kernel.

        A batched pipeline takes every input with one extra leading dim of
        exactly ``batch`` tiles; when the plan's slot capacity exceeds it,
        the inputs are zero-padded to capacity before the sweep and every
        returned buffer is sliced back to the ``batch`` valid tiles.

        Span: ``pipeline.run``, the host's time in this call (the kernels
        are enqueued, not waited for)."""
        with telemetry.span("pipeline.run"):
            batch = self.plan.notes.get("batch")
            cap = self.plan.notes.get("batch_capacity", batch)
            buffers = inputs_to_torch(inputs, self.device, self.pipeline, batch)
            if batch is not None and cap > batch:
                buffers = {
                    n: torch.cat([a, a.new_zeros((cap - batch,) + tuple(a.shape[1:]))])
                    for n, a in buffers.items()
                }
            for k in self.kernels:
                buffers[k.name] = k(buffers)
            if batch is not None and cap > batch:
                buffers = {n: a[:batch] for n, a in buffers.items()}
            return buffers

    def __call__(self, inputs: Mapping[str, object]) -> torch.Tensor:
        return self.run(inputs)[self.pipeline.output]


# ---------------------------------------------------------------------------
# Plan-keyed pipeline cache
# ---------------------------------------------------------------------------

_PIPELINE_CACHE: "OrderedDict[str, TorchPipeline]" = OrderedDict()
_PIPELINE_CACHE_MAX = 128
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}

# the planner's own defaults, except the budget, which is the port's: an
# entry equal to its default is dropped before hashing, so an explicit
# default and an omitted keyword share one cache entry
_PLAN_KWARG_DEFAULTS: Dict[str, object] = dict(
    block_h=None,
    block_w=None,
    lane_block="auto",
    fuse=True,
    grid_reduction=True,
    red_grid_threshold=RED_GRID_THRESHOLD,
    vmem_budget=H100_SMEM_PER_BLOCK,
    cost_model="scheduler",
    align_tpu=False,
    line_buffer="auto",
    red_resident=True,
    batch=None,
    batch_capacity=None,
    red_chunk=None,
    lane_price="joint",
)

# the schedule knobs (as opposed to the problem: budgets, batching); the
# serve bridge's heuristic recompile strips them
TUNABLE_KEYS = frozenset(
    {"block_h", "block_w", "line_buffer", "red_chunk", "fuse", "lane_price"}
)


def _normalize_plan_kwargs(plan_kwargs: Mapping) -> Dict[str, object]:
    return {
        k: v
        for k, v in plan_kwargs.items()
        if not (k in _PLAN_KWARG_DEFAULTS and v == _PLAN_KWARG_DEFAULTS[k])
    }


def _hash_pipeline_content(h, pipe: Pipeline) -> None:
    h.update(repr(pipe.output).encode())
    h.update(repr(sorted(pipe.inputs)).encode())
    for name, box in sorted(pipe.buffer_boxes.items()):
        h.update(f"{name}:{box.dims}:{box.intervals};".encode())
    for ns in normalize_pipeline(pipe):
        h.update(repr((
            ns.name, ns.pure_dims, ns.pure_extents, ns.red_dims,
            ns.red_extents, ns.value, ns.init, ns.loads, ns.dim_lower,
            ns.on_host,
        )).encode())
    h.update(b"elem:f32")


def plan_cache_key(
    pipe: Pipeline, device: Union[str, torch.device], kernels: str,
    plan_kwargs: Mapping,
) -> str:
    """Content hash of a compiled pipeline: the lowered pipeline, every
    non-default plan keyword, the device and the kernel choice.  Planning
    itself is not run to compute it."""
    h = hashlib.sha256()
    h.update(f"{torch.device(device)}|{kernels}".encode())
    norm = _normalize_plan_kwargs(plan_kwargs)
    h.update(repr(sorted(norm.items(), key=lambda kv: kv[0])).encode())
    _hash_pipeline_content(h, pipe)
    return h.hexdigest()


def schedule_db_key(pipe: Pipeline, plan_kwargs: Mapping = ()) -> str:
    """Key a pipeline into the autotuner's schedule database: the content
    hash of :func:`plan_cache_key` minus the *tunable* keywords
    (``TUNABLE_KEYS``, the schedule itself), the device and the kernel
    choice.  Two compiles that pose the same planning problem — identical
    lowered content, budget, batching — look up the same stored schedule
    whatever schedule knobs, device or kernels they run with.  The prefix
    is the port's own: keywords are normalized against the port's defaults
    (``vmem_budget`` is the H100's), so the JAX package's key of the same
    keywords poses another problem and must never name a port row."""
    fixed = {
        k: v for k, v in dict(plan_kwargs).items() if k not in TUNABLE_KEYS
    }
    h = hashlib.sha256()
    h.update(b"repro_torch-schedule-db:")
    h.update(repr(sorted(
        _normalize_plan_kwargs(fixed).items(), key=lambda kv: kv[0]
    )).encode())
    _hash_pipeline_content(h, pipe)
    return h.hexdigest()


def clear_pipeline_cache(reset_stats: bool = False) -> None:
    """Evict every cached pipeline (counters kept unless ``reset_stats``)."""
    _PIPELINE_CACHE.clear()
    if reset_stats:
        _CACHE_STATS.update(hits=0, misses=0, evictions=0)


def drop_pipeline_cache_entry(key: Optional[str]) -> bool:
    """Evict one entry by its :func:`plan_cache_key` (the serve bridge's
    retry-with-recompile path); returns whether it was present."""
    if key is None:
        return False
    return _PIPELINE_CACHE.pop(key, None) is not None


def pipeline_cache_size() -> int:
    """The number of live cache entries."""
    return len(_PIPELINE_CACHE)


def pipeline_cache_stats() -> Dict[str, int]:
    """Hit/miss/eviction counters plus the live entry count."""
    return {**_CACHE_STATS, "entries": len(_PIPELINE_CACHE)}


def _kernels(groups, kernels: str) -> List[GroupKernel]:
    """One kernel of the chosen version per planned group; the CUDA kernels
    of one call share one library.  Counter ``compile.build_s``: seconds
    spent here (lowering, then the plain version's kernels, or the CUDA
    library's emit, nvcc build and load).  Counters ``compile.ep_groups``
    and ``compile.ep_tiled_groups``: the groups the CUDA emitter maps as
    element-parallel, and those of them that take its two-axis tile
    (``cuda_codegen.element_map``), counted for either version, as the
    plan decides them."""
    t = time.perf_counter()
    lowered = [LoweredGroup(kg) for kg in groups]
    maps = [m for m in map(element_map, lowered) if m is not None]
    telemetry.add("compile.ep_groups", len(maps))
    telemetry.add("compile.ep_tiled_groups", sum(m.tiled for m in maps))
    if kernels == "eager":
        out = [EagerKernel(lg) for lg in lowered]
    else:
        lib = load_library(emit_library(lowered))
        out = [CudaKernel(lg, lib, str(i)) for i, lg in enumerate(lowered)]
    telemetry.add("compile.build_s", time.perf_counter() - t)
    return out


def _check_contract(device, kernels: str) -> torch.device:
    if kernels not in KERNEL_CHOICES:
        raise ValueError(f"kernels must be one of {KERNEL_CHOICES}: {kernels!r}")
    dev = resolve_device(device)
    if kernels == "cuda" and dev.type != "cuda":
        raise ValueError(
            "kernels='cuda' needs device='cuda'; use kernels='eager' for "
            "the plain version on the CPU"
        )
    return dev


def compile_stage(
    nstage: NormalizedStage,
    buffer_shapes: Mapping[str, Tuple[int, ...]],
    *,
    device: Union[str, torch.device] = "cuda",
    kernels: str = "cuda",
    block_h: Optional[int] = None,
    block_w: Optional[int] = None,
    vmem_budget: int = H100_SMEM_PER_BLOCK,
    grid_reduction: bool = False,
    red_grid_threshold: int = RED_GRID_THRESHOLD,
    cost_model: str = "scheduler",
    line_buffer: object = "auto",
    red_resident: bool = True,
) -> GroupKernel:
    """Plan one normalized stage as a kernel group of its own and compile
    it to one kernel of the chosen version (the JAX package's
    ``codegen.compile_stage``, with the execution contract of
    :func:`compile_pipeline`).  A reduction init that reads buffers is
    refused, as the JAX package refuses it."""
    if nstage.init is not None and refs_in(nstage.init):
        raise UnsupportedAccessError(
            f"{nstage.name}: reduction init with buffer reads is not supported"
        )
    _check_contract(device, kernels)
    accesses = decompose_stage(nstage)
    streamed = _stream_ok(accesses, nstage.pure_dims[0])
    kg = _build_kernel_group(
        [(nstage, accesses, streamed)],
        buffer_shapes,
        block_h=block_h,
        block_w=block_w,
        vmem_budget=vmem_budget,
        cost_model=cost_model,
        grid_reduction=grid_reduction,
        red_grid_threshold=red_grid_threshold,
        line_buffer=line_buffer,
        red_resident=red_resident,
    )
    return _kernels([kg], kernels)[0]


def compile_pipeline(
    pipe: Pipeline,
    *,
    device: Union[str, torch.device] = "cuda",
    kernels: str = "cuda",
    cache: bool = False,
    block_h: Optional[int] = None,
    block_w: Optional[int] = None,
    lane_block: object = "auto",
    fuse: bool = True,
    grid_reduction: bool = True,
    red_grid_threshold: int = RED_GRID_THRESHOLD,
    vmem_budget: int = H100_SMEM_PER_BLOCK,
    cost_model: str = "scheduler",
    align_tpu: bool = False,
    line_buffer: object = "auto",
    red_resident: bool = True,
    batch: Optional[int] = None,
    batch_capacity: Optional[int] = None,
    red_chunk: Optional[int] = None,
    lane_price: str = "joint",
    verify: object = "auto",
    tune: object = False,
) -> TorchPipeline:
    """Plan, certify and emit ``pipe``.  The plan keywords are the JAX
    package's (``repro.backend.compile_pipeline``), with the H100's shared
    memory per block as the default ``vmem_budget``.  ``device`` and
    ``kernels`` are the execution contract of the module docstring;
    ``verify`` gates static plan certification (``"auto"``: fresh plans
    only, ``True``: cache hits too, ``False``: never).

    ``tune`` consults the autotuner's schedule database
    (``backend/autotune``) before planning: ``"auto"`` (or ``True``) the
    default db, a path or a ``ScheduleDB`` that db, ``False`` (default) no
    lookup.  A stored winner fills only the tunable keywords the caller
    left at their defaults (an explicit ``block_h=...`` beats the db), and
    the filled keywords enter the plan cache key.  A miss plans the
    heuristic schedule silently; a row measured with other kernels or on
    another device warns ``TunedModeMismatchWarning``; a corrupt db or row
    degrades to the heuristic schedule with ``ScheduleDBCorruptWarning``.

    A compile that misses the cache adds its seconds to the counters
    ``compile.plan_s``, ``compile.verify_s`` and ``compile.build_s``
    (:func:`repro_torch.telemetry.counters`), 1 to ``compile.plans``, the
    plan's :meth:`~repro_torch.backend.plan.PipelinePlan.spill_bytes` to
    ``compile.spill_bytes_per_img``, its groups that chain two reductions
    through a hidden axis (``KernelGroup.chain``) to
    ``compile.chain_groups``, those whose hidden panel takes a register
    tile of two or more elements a thread to ``compile.chain_tiled_groups``
    and the hidden panels a block of those walks to
    ``compile.chain_panels``, its groups that keep a window-attention score
    tile in shared memory (``KernelGroup.window``) to
    ``compile.window_groups``, the heads a block of those holds at once to
    ``compile.window_heads`` and their windows whose keys fall in more than
    one region of the mask to ``compile.masked_windows``; a hit adds
    nothing."""
    if verify not in (True, False, "auto"):
        raise ValueError(f"verify must be True, False, or 'auto': {verify!r}")
    dev = _check_contract(device, kernels)
    plan_kwargs = dict(
        block_h=block_h,
        block_w=block_w,
        lane_block=lane_block,
        fuse=fuse,
        grid_reduction=grid_reduction,
        red_grid_threshold=red_grid_threshold,
        vmem_budget=vmem_budget,
        cost_model=cost_model,
        align_tpu=align_tpu,
        line_buffer=line_buffer,
        red_resident=red_resident,
        batch=batch,
        batch_capacity=batch_capacity,
        red_chunk=red_chunk,
        lane_price=lane_price,
    )
    if tune is not False and tune is not None:
        from .autotune import lookup_schedule_entry

        entry = lookup_schedule_entry(pipe, plan_kwargs, db=tune)
        if entry:
            here = {
                "mode": kernels,
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            }
            for field, value in here.items():
                stored = entry.get(field)
                if stored is not None and stored != value:
                    warnings.warn(
                        f"serving a schedule measured with {field} {stored!r} "
                        f"to a compile with {field} {value!r}; its ranking may "
                        f"not transfer — re-tune with kernels={kernels!r} on "
                        f"this device",
                        TunedModeMismatchWarning,
                        stacklevel=2,
                    )
                    break
            for k, v in entry.get("schedule", {}).items():
                if (
                    k in TUNABLE_KEYS
                    and plan_kwargs[k] == _PLAN_KWARG_DEFAULTS[k]
                ):
                    plan_kwargs[k] = v
    key: Optional[str] = None
    if cache:
        key = plan_cache_key(pipe, dev, kernels, plan_kwargs)
        hit = _PIPELINE_CACHE.get(key)
        if hit is not None:
            _CACHE_STATS["hits"] += 1
            _PIPELINE_CACHE.move_to_end(key)
            if verify is True:
                assert_plan_verified(hit.plan)
            return hit
        _CACHE_STATS["misses"] += 1
    t = time.perf_counter()
    plan = build_pipeline_plan(pipe, **plan_kwargs)
    telemetry.add("compile.plan_s", time.perf_counter() - t)
    telemetry.add("compile.plans", 1)
    telemetry.add("compile.spill_bytes_per_img", plan.spill_bytes())
    chains = [kg.chain for kg in plan.kernels if kg.chain is not None]
    telemetry.add("compile.chain_groups", len(chains))
    telemetry.add("compile.chain_tiled_groups",
                  sum(ch.tile[0] * ch.tile[1] >= 2 for ch in chains))
    telemetry.add("compile.chain_panels", sum(ch.count for ch in chains))
    windows = [kg for kg in plan.kernels if kg.window is not None]
    telemetry.add("compile.window_groups", len(windows))
    telemetry.add("compile.window_heads", sum(kg.bh for kg in windows))
    telemetry.add("compile.masked_windows", sum(kg.window.masked for kg in windows))
    if plan_kwargs.get("line_buffer") is True:
        _warn_lane_carry_degrades(plan)
    if verify is not False:
        t = time.perf_counter()
        assert_plan_verified(plan)
        telemetry.add("compile.verify_s", time.perf_counter() - t)
    pp = TorchPipeline(pipe, _kernels(plan.kernels, kernels), plan, dev, kernels, cache_key=key)
    if cache:
        _PIPELINE_CACHE[key] = pp
        while len(_PIPELINE_CACHE) > _PIPELINE_CACHE_MAX:
            _PIPELINE_CACHE.popitem(last=False)
            _CACHE_STATS["evictions"] += 1
    return pp


def reference_arrays(
    pipe: Pipeline, inputs: Mapping[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Reference interpreter results as zero-based dense arrays."""
    values = execute_pipeline(pipe, inputs)
    out: Dict[str, np.ndarray] = {}
    for name, tbl in values.items():
        box = pipe.buffer_boxes[name]
        lo = tuple(l for l, _ in box.intervals)
        arr = np.zeros(box.extents, np.float64)
        for idx, v in tbl.items():
            arr[tuple(i - l for i, l in zip(idx, lo))] = v
        out[name] = arr
    return out


def max_abs_error(
    pp: TorchPipeline,
    inputs: Mapping[str, np.ndarray],
    got: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, float]:
    """Per-kernel max |generated - reference| over every materialized
    buffer; for a batched pipeline the per-tile reference runs once per
    slot and the error is the max over slots."""
    if got is None:
        got = pp.run(inputs)
    host = {k.name: got[k.name].detach().cpu().numpy() for k in pp.kernels}
    batch = pp.plan.notes.get("batch")
    if batch is not None:
        errs = {k.name: 0.0 for k in pp.kernels}
        for b in range(batch):
            tile_in = {n: np.asarray(a)[b] for n, a in inputs.items()}
            want = reference_arrays(pp.pipeline, tile_in)
            for k in pp.kernels:
                w = want[k.name]
                if w.size:
                    e = float(np.max(np.abs(host[k.name][b] - w)))
                    errs[k.name] = max(errs[k.name], e)
        return errs
    want = reference_arrays(pp.pipeline, inputs)
    return {
        k.name: float(np.max(np.abs(host[k.name] - want[k.name])))
        if want[k.name].size
        else 0.0
        for k in pp.kernels
    }


__all__ = [
    "KERNEL_CHOICES",
    "TUNABLE_KEYS",
    "TorchPipeline",
    "clear_pipeline_cache",
    "compile_pipeline",
    "compile_stage",
    "drop_pipeline_cache_entry",
    "inputs_to_torch",
    "max_abs_error",
    "pipeline_cache_size",
    "pipeline_cache_stats",
    "plan_cache_key",
    "reference_arrays",
    "resolve_device",
    "schedule_db_key",
]
