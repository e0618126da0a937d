"""Multi-pod dry run: trace every (arch x shape x mesh) cell of the port's
production steps on one rank of a fake world — the port of the JAX
package's ``launch/dryrun.py``.

The JAX dry run lowers and compiles each cell's SPMD program for 256 / 512
TPU chips it does not have.  Here each cell runs the port's own step, the
one a user would run, on ``meta`` tensors (nothing is allocated on any
device, nothing is computed) as one rank of a fake world of 256 ranks, the
(16, 16) ``(data, model)`` mesh, or 512, the (2, 16, 16) ``(pod, data,
model)`` mesh (``launch.mesh.init_distributed("fake", ...)``), the one with
the most work (``trace_rank``: rank 0, but for a ``context`` plan, whose
model ranks run their own query rows of a causal attention, the last
``model`` coordinate's, which the report names): the port's
planner lays the parameters out (``param_shardings``; ZeRO gradient layouts
``zero_shardings``), DTensor runs every op on the rank's local shards, and
``roofline.dispatch_cost`` counts what that rank dispatches:

* ``train``: ``train.make_train_step`` (microbatches, remat, ZeRO gradient
  layouts, AdamW) with the kernels' route (``kernels="cuda"``: the
  attention and SSD operators' fake implementations, charged the kernels'
  work; their backward the plain version's gradient, traced once for each
  input signature, ``roofline.dispatch_cost``);
* ``prefill``: ``models.forward_prefill``;
* ``decode``: ``serve.engine.make_serve_step`` against a cache laid out by
  ``kv_cache_specs``.

Each report gives the rank's FLOPs, HBM bytes (unfused eager ops, so more
than XLA's fused count) and collective bytes, the three roofline terms on
H100 data-sheet constants (``roofline.analysis``), and its memory: the
local bytes of its arguments and outputs and the peak of the storages the
step makes (``temp``), against the H100's 80 GB.  All of it is modelled
from shapes and data-sheet figures; none of it is measured.

``SHAPES`` and the tables below are the JAX dry run's, verbatim: they were
tuned there for a TPU with 16 GB a chip and are not retuned here.  The
port's optimizer keeps AdamW's moments in their parameter's layout (the
JAX dry run gives them ZeRO layouts), and its step is functional: the new
state is made beside the old one, where XLA reuses the donated buffers.

Usage (a fake world lives in this process, so run it as its own process)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import traceback
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.context import sharding_context
from repro_torch.distributed.sharding import (
    _zip_map, dp_axes, make_plan, param_shardings, placements, zero_shardings,
)
from repro_torch.launch.mesh import init_distributed, make_abstract_mesh, make_production_mesh
from repro_torch.models import forward_prefill, init_kv_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import PREFIX_LEN, _leaves
from repro_torch.roofline.analysis import H100_MEMORY_BYTES
from repro_torch.roofline.dispatch_cost import report, trace_cost
from repro_torch.serve.engine import kv_cache_specs, make_serve_step
from repro_torch.train import AdamWConfig, TrainState, adamw_init, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# per-arch train_4k settings (hillclimbed in EXPERIMENTS.md §Perf):
# fewer microbatches => fewer per-microbatch gradient reductions (the
# dominant collective) at the price of activation memory — the II-search
# trade of paper §V-B at pod scale
MICROBATCHES = {
    "dbrx_132b": 16,     # + bf16 grad accumulator (see TRAIN_OVERRIDES)
    "qwen3_14b": 4,
    "pixtral_12b": 16,
    "glm4_9b": 8,
    "zamba2_7b": 16,
    "qwen2_moe_a2_7b": 8,
    "mamba2_2_7b": 8,
    "default": 8,
}

# extra per-arch train-step options (EXPERIMENTS.md §Perf iteration log)
TRAIN_OVERRIDES = {
    "dbrx_132b": {"grad_acc_dtype": "bfloat16"},
}

# multi-pod microbatch overrides: the microbatch must divide the doubled
# data parallelism (pod x data = 32) for full batch sharding
MICROBATCHES_MP = {
    "dbrx_132b": 8,
}

# per-arch sharding-plan overrides (§Perf B4: the sequence-parallel residual
# stream reshards dbrx's vocab-sharded embedding gather through full
# replication under FSDP — 29.9 GB/chip vs 6.9 GB — so it is off for dbrx)
PLAN_OVERRIDES = {
    "dbrx_132b": {"seq_parallel": False},
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, (
            "skipped: pure full-attention arch — 500k-token contexts need "
            "sub-quadratic attention (DESIGN.md §4)"
        )
    return True, ""


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0) -> Iterator[None]:
    """A fake world of ``size`` ranks in this process, this process its
    rank ``rank``, destroyed on exit."""
    init_distributed("fake", rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def traced_coordinate(plan) -> Dict[str, int]:
    """The mesh coordinate whose work a cell reports: the heaviest rank's.
    Under a ``context`` plan each model rank runs its own query rows of a
    causal attention, and the last rows keep the most scores: the last
    ``model`` coordinate, every other 0.  Under any other plan the ranks'
    work is the same: every coordinate 0."""
    coord = {a: 0 for a in plan.axes}
    if plan.attn_strategy == "context":
        coord["model"] = plan.axes["model"] - 1
    return coord


def trace_rank(arch: str, multi_pod: bool = False) -> int:
    """The rank of the production fake world (row-major over its mesh)
    that holds ``traced_coordinate`` of ``arch``'s plan: 15 for a
    ``context`` plan on either mesh, else 0."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    key = arch.replace("-", "_").replace(".", "_")
    plan = make_plan(get_config(arch), make_abstract_mesh(shape, names),
                     **PLAN_OVERRIDES.get(key, {}))
    coord = traced_coordinate(plan)
    return sum(coord[a] * math.prod(shape[i + 1:]) for i, a in enumerate(names))


def _distribute(tree: Mapping, shardings: Mapping) -> Dict:
    """Each meta leaf as a DTensor laid out by its ``NamedSharding``: each
    rank takes its own shard, with no collective (``src_data_rank=None``)."""
    return _zip_map(lambda sh, v: distribute_tensor(v, sh.mesh, sh.placements,
                                                    src_data_rank=None), shardings, tree)


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree (or tensor, or tuple) of
    tensors: a DTensor's local shard."""
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    if isinstance(tree, Mapping):
        return sum(local_bytes(t) for _, t in _leaves(tree))
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(t) for t in tree)
    return 0


def batch_specs(cfg: ModelConfig, plan, batch: int, seq: int) -> Tuple[Dict, Dict]:
    """(meta tensors, placements) of a train/prefill batch, tokens and
    labels int32 as the JAX batch's."""
    mesh = plan.mesh
    toks = seq - (PREFIX_LEN if cfg.frontend != "none" else 0)
    specs = {
        "tokens": torch.empty((batch, toks), dtype=torch.int32, device="meta"),
        "labels": torch.empty((batch, toks), dtype=torch.int32, device="meta"),
    }
    if cfg.frontend != "none":
        specs["prefix_embeds"] = torch.empty((batch, PREFIX_LEN, cfg.d_model),
                                             dtype=torch.bfloat16, device="meta")
    shardings = {k: placements(plan.batch_spec(k, tuple(v.shape)), mesh)
                 for k, v in specs.items()}
    return specs, shardings


def _dist_batch(mesh, specs: Dict, shardings: Dict) -> Dict:
    return {k: distribute_tensor(v, mesh, shardings[k], src_data_rank=None)
            for k, v in specs.items()}


def memory_budget() -> Tuple[int, str]:
    """The bytes a rank may hold and where that figure comes from: the
    card's own total memory where a GPU is visible, else the H100 80GB
    HBM3's (``roofline.analysis.H100_MEMORY_BYTES``)."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return H100_MEMORY_BYTES, "H100_MEMORY_BYTES"


def lower_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    mesh=None,
    kv_chunk: int = 512,
    microbatches: Optional[int] = None,
    remat: bool = True,
    plan_overrides: Optional[Dict] = None,
    zero_grads: bool = True,
    grad_comm_dtype=None,
    grad_acc_dtype=None,
    info: Optional[Dict] = None,
):
    """Build and trace one cell on this rank of the current fake world
    (``mesh``: the production mesh of that world by default), which must
    hold the plan's ``traced_coordinate`` (``fake_world(size,
    rank=trace_rank(arch))``).  ``info``: the shape's ``kind``, ``seq`` and
    ``batch`` (``SHAPES[shape]`` by default).  Returns (the rank's
    ``Cost``, the report dict)."""
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, {"arch": arch, "shape": shape, "status": "skipped", "why": why}

    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device_type="fake")
    key = arch.replace("-", "_").replace(".", "_")
    merged_overrides = dict(PLAN_OVERRIDES.get(key, {}))
    merged_overrides.update(plan_overrides or {})
    plan = make_plan(cfg, mesh, **merged_overrides)
    coord = dict(zip(mesh.mesh_dim_names, (int(c) for c in mesh.get_coordinate())))
    if coord != traced_coordinate(plan):
        raise ValueError(
            f"{arch} {shape}: a {plan.attn_strategy!r} plan's figures are the rank at "
            f"{traced_coordinate(plan)}'s, and this one is at {coord}; trace it in "
            "fake_world(size, rank=trace_rank(arch))"
        )
    info = info or SHAPES[shape]
    seq, batch = info["seq"], info["batch"]
    chips = mesh.size()

    params = init_params(cfg, None, torch.bfloat16, "meta")
    p_shardings = param_shardings(plan, params)
    dparams = _distribute(params, p_shardings)
    extra = {}

    with sharding_context(mesh, plan):
        if info["kind"] == "train":
            mb = microbatches or (
                MICROBATCHES_MP.get(key) if multi_pod and key in MICROBATCHES_MP
                else MICROBATCHES.get(key, MICROBATCHES["default"])
            )
            ov = TRAIN_OVERRIDES.get(key, {})
            if grad_acc_dtype is None and "grad_acc_dtype" in ov:
                grad_acc_dtype = getattr(torch, ov["grad_acc_dtype"])
            step = make_train_step(
                cfg, AdamWConfig(), microbatches=mb, kv_chunk=kv_chunk, remat=remat,
                grad_shardings=zero_shardings(plan, params) if zero_grads else None,
                comm_dtype=grad_comm_dtype, acc_dtype=grad_acc_dtype, kernels="cuda",
            )
            state = TrainState(dparams, adamw_init(dparams), torch.Generator())
            bspecs, bshard = batch_specs(cfg, plan, batch, seq)
            args = (state.params, state.opt, _dist_batch(mesh, bspecs, bshard))
            out, cost, trace_s = trace_cost(step, state, args[2])
            outputs = (out[0].params, out[0].opt)
            model_flops = 6.0 * cfg.active_param_count() * batch * seq
            extra["microbatches"] = mb
        elif info["kind"] == "prefill":
            bspecs, bshard = batch_specs(cfg, plan, batch, seq)
            bspecs.pop("labels")
            bshard.pop("labels")
            args = (dparams, _dist_batch(mesh, bspecs, bshard))
            with torch.no_grad():
                outputs, cost, trace_s = trace_cost(forward_prefill, cfg, *args,
                                                    kv_chunk=kv_chunk, kernels="cuda")
            model_flops = 2.0 * cfg.active_param_count() * batch * seq
        else:  # decode
            cache = init_kv_cache(cfg, batch, seq, torch.bfloat16, "meta")
            cspecs = kv_cache_specs(plan, cache)
            dcache = {k: distribute_tensor(v, mesh, placements(cspecs[k], mesh),
                                           src_data_rank=None) for k, v in cache.items()}
            dpn = 1
            for a in dp_axes(mesh):
                dpn *= plan.axes[a]
            tok_pl = placements((dp_axes(mesh),) if batch % dpn == 0 else (), mesh)
            tokens = distribute_tensor(torch.empty((batch,), dtype=torch.int32, device="meta"),
                                       mesh, tok_pl, src_data_rank=None)
            args = (dparams, dcache, tokens)
            # the last position: attention reads the whole cache, as JAX's
            # step does at any position
            outputs, cost, trace_s = trace_cost(make_serve_step(cfg, kernels="cuda"),
                                                *args, seq - 1)
            model_flops = 2.0 * cfg.active_param_count() * batch

    arg_bytes, out_bytes = local_bytes(args), local_bytes(outputs)
    budget, budget_of = memory_budget()
    rep = report(f"{arch}/{shape}", cost, chips, model_flops)
    out = {
        "arch": arch,
        "shape": shape,
        "status": "ok",
        "multi_pod": multi_pod,
        "chips": chips,
        "mesh": dict(zip(mesh.mesh_dim_names, (int(v) for v in mesh.shape))),
        "rank": {"rank": dist.get_rank(), "coordinate": coord},
        "plan": {
            "attn": plan.attn_strategy,
            "moe": plan.moe_strategy,
            "fsdp": plan.fsdp,
            **plan.notes,
        },
        **extra,
        "trace_s": round(trace_s, 2),
        "torch": torch.__version__,
        "memory": {
            "argument_bytes_per_chip": arg_bytes,
            "output_bytes_per_chip": out_bytes,
            "temp_bytes_per_chip": cost.peak_live_bytes,
            "peak_gb_per_chip": round((arg_bytes + cost.peak_live_bytes) / 1e9, 3),
            "fits_80gb": arg_bytes + cost.peak_live_bytes < budget,
            "budget_bytes": budget,
            "budget_of": budget_of,
        },
        "roofline": rep.as_dict(),
    }
    return cost, out


def run_cell_cached(arch, shape, multi_pod=False, force=False, **kw):
    """One production cell's report: the cached one unless ``force``, else
    the cell traced in a fake world of its own as its ``trace_rank`` (an
    ``error`` report if anything raises), written to ``RESULTS_DIR``."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
    path = os.path.join(RESULTS_DIR, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        with fake_world(512 if multi_pod else 256, rank=trace_rank(arch, multi_pod)):
            _, out = lower_cell(arch, shape, multi_pod=multi_pod, **kw)
    except Exception as e:  # record the failure — these are bugs to fix
        out = {
            "arch": arch, "shape": shape, "status": "error",
            "multi_pod": multi_pod,
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:],
        }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> int:
    """Run the cells; prints one line each and returns 1 if any cell is
    an ``error``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        a = a.replace("-", "_").replace(".", "_")
        for s in shapes:
            cells.append((a, s))

    errors = 0
    for a, s in cells:
        out = run_cell_cached(a, s, multi_pod=args.multi_pod, force=args.force)
        status = out["status"]
        if status == "ok":
            r = out["roofline"]
            print(
                f"{a:18s} {s:12s} {'MP' if args.multi_pod else 'SP'} OK  "
                f"mem={out['memory']['peak_gb_per_chip']:6.2f}GB "
                f"tc={r['t_compute']*1e3:8.3f}ms tm={r['t_memory']*1e3:8.3f}ms "
                f"tcoll={r['t_collective']*1e3:8.3f}ms dom={r['dominant']:10s} "
                f"frac={r['roofline_fraction']:.3f} trace={out['trace_s']:.1f}s",
                flush=True,
            )
        elif status == "skipped":
            print(f"{a:18s} {s:12s} SKIP ({out['why'][:60]}...)", flush=True)
        else:
            errors += 1
            print(f"{a:18s} {s:12s} ERROR {out['error'][:300]}", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
