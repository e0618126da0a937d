"""Multi-rank cases of the port's ``distributed/`` on gloo, one process per
rank (``torch.multiprocessing.spawn``), rendezvous through a ``FileStore``
under the case's directory (no TCP port, so parallel test workers cannot
collide).  Imports torch and the port only, never JAX: the tests
(``tests/test_torch_distributed_*.py``) write the inputs, run this script in
a subprocess with a timeout, and hold what rank 0 writes against JAX and
against the unsharded port.

    python tests/torch_dist_worker.py CASE DIR

CASE is one of ``CASES``; DIR holds ``inputs.npz`` (and, for ``restore``,
the checkpoint ``train`` wrote) and receives ``out.npz``.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (case, mesh shape, axis names)
CASES = {
    "ring": ((4,), ("model",)),
    "pipeline": ((4,), ("pod",)),
    "models-2x2": ((2, 2), ("data", "model")),
    "models-1x3": ((1, 3), ("data", "model")),
    "train": ((2, 2), ("data", "model")),
    "train-moe": ((2, 2), ("data", "model")),
    "restore": ((1, 3), ("data", "model")),
    "multipod": ((2, 2, 2), ("pod", "data", "model")),
    "train-context": ((1, 3), ("data", "model")),
}
# the reduced models of each models case: (label, arch, attention impl,
# overrides of ``reduced()``).  gemma3's single KV head is replicated under
# the heads strategy; a window of 8 and a global layer every 2 put one
# layer on each route (the reduced default's window exceeds the sequence
# and its global layer never comes)
GEMMA3 = {"sliding_window": 8, "global_every": 2}
MODEL_RUNS = {
    "models-2x2": [("tinyllama", "tinyllama_1_1b", "xla", {}),
                   ("gemma3", "gemma3_1b", "xla", GEMMA3),
                   ("dbrx", "dbrx_132b", "xla", {}), ("mamba2", "mamba2_2_7b", "xla", {})],
    "models-1x3": [("tinyllama", "tinyllama_1_1b", "xla", {}),
                   ("tinyllama-ring", "tinyllama_1_1b", "ring", {}),
                   ("qwen2moe", "qwen2_moe_a2_7b", "xla", {})],
}
B, S = 2, 24
KV_CHUNK = 8
# the step's model: reduced tinyllama with a d_ff that both meshes divide,
# so the 1x3 restore really re-shards the MLP weights
TRAIN_ARCH, TRAIN_OVER, TRAIN_MICRO = "tinyllama_1_1b", {"d_ff": 96}, 2
# the MoE step: reduced dbrx, its 4 experts over the 2 model ranks (``ep``:
# the expert pass on each rank's own experts, ``moe._on_local_experts``)
MOE_ARCH = "dbrx_132b"
# the (2, 2, 2) case: a batch of 4 rows, one on each (pod, data) rank pair,
# through reduced tinyllama (loss, gradients, decode), the same with one KV
# head (whole on the model ranks, which split the q heads) and mamba2 (its
# 4 heads over the model ranks): (label, arch, overrides of ``reduced()``)
MULTIPOD_RUNS = (("tinyllama", "tinyllama_1_1b", {}),
                 ("tinyllama-kv1", "tinyllama_1_1b", {"n_kv_heads": 1}),
                 ("mamba2", "mamba2_2_7b", {}))
MULTIPOD_B = 4
# the context case: reduced tinyllama, whose 4 q heads do not divide the 3
# model ranks (the ``context`` plan: each rank's own S/3 query rows)
CONTEXT_ARCH = "tinyllama_1_1b"


def tree_from_flat(flat, prefix):
    """{"a/b/c": array} (keys under ``prefix/``) as a nested dict of tensors."""
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr))
    return out


def flat_from_tree(tree, prefix):
    from repro_torch.models.model import _leaves

    return {f"{prefix}/{path}": t.detach().cpu().numpy() for path, t in _leaves(tree)}


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _batch(ins, tag):
    return {k[len(tag) + 1:]: torch.from_numpy(np.array(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.array(v)) for k, v in ins.items() if k.startswith(tag + "/")}


def case_ring(mesh, ins, out):
    from repro_torch.distributed.ring_attention import ring_attention

    q, k, v = (torch.from_numpy(ins[n]) for n in ("q", "k", "v"))
    with torch.no_grad():
        out["plain"] = ring_attention(q, k, v, mesh).full_tensor().numpy()
        out["window"] = ring_attention(q, k, v, mesh, window=16).full_tensor().numpy()


def case_pipeline(mesh, ins, out):
    from repro_torch.distributed.pipeline import pipeline_forward

    fn = pipeline_forward(lambda w, x, stage: torch.tanh(x @ w), mesh)
    with torch.no_grad():
        out["outs"] = fn(torch.from_numpy(ins["ws"]), torch.from_numpy(ins["micro"])).numpy()


def case_models(mesh, ins, out, runs):
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_plan, param_shardings
    from repro_torch.distributed.context import sharding_context
    from repro_torch.distributed.sharding import distribute_batch, distribute_tree
    from repro_torch.models import model as tm
    from repro_torch.models import layers

    for label, arch, impl, over in runs:
        cfg = get_config(arch).reduced(**over)
        params = tree_from_flat(ins, f"params-{label}")
        batch = _batch(ins, f"batch-{label}")
        plan = make_plan(cfg, mesh)
        dparams = distribute_tree(params, param_shardings(plan, params))
        dbatch = distribute_batch(plan, batch)
        layers.set_attention_impl(impl)
        layers.ROUTES.clear()
        try:
            with sharding_context(mesh, plan), torch.no_grad():
                loss, met = tm.forward_train(cfg, dparams, dbatch, kv_chunk=KV_CHUNK, remat=False,
                                             kernels="eager")
                logits = tm.forward_prefill(cfg, dparams, dbatch, kv_chunk=KV_CHUNK,
                                            kernels="eager")
        finally:
            layers.set_attention_impl("xla")
        routes = dict(layers.ROUTES)
        with torch.no_grad():
            loss_u, _ = tm.forward_train(cfg, params, batch, kv_chunk=KV_CHUNK, remat=False,
                                         kernels="eager")
            logits_u = tm.forward_prefill(cfg, params, batch, kv_chunk=KV_CHUNK, kernels="eager")
        out[f"{label}/loss"] = _full(loss).numpy()
        out[f"{label}/aux"] = _full(met["aux"]).numpy()
        out[f"{label}/logits"] = _full(logits).numpy()
        out[f"{label}/loss_unsharded"] = loss_u.numpy()
        out[f"{label}/logits_unsharded"] = logits_u.numpy()
        out[f"{label}/strategy"] = np.array(f"{plan.attn_strategy}/{plan.moe_strategy}")
        out[f"{label}/routes"] = np.array(",".join(f"{k}={n}" for k, n in sorted(routes.items())))


def _zero_step(mesh, ins, out, cfg, tag="batch", prefix=""):
    """One AdamW step on the batch under ``tag`` with ZeRO gradient layouts
    against the unsharded step on the same values; writes both's metrics,
    parameters and first moments (keys after ``prefix``); returns (plan,
    the sharded state, its gradient layouts, the gathered parameters)."""
    from repro_torch.distributed import make_plan, param_shardings
    from repro_torch.distributed.context import sharding_context
    from repro_torch.distributed.sharding import (
        distribute_batch, distribute_tree, gather_tree, zero_shardings,
    )
    from repro_torch.train import AdamWConfig, TrainState, adamw_init, make_train_step

    params = tree_from_flat(ins, "params")
    batch = _batch(ins, tag)
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    plan = make_plan(cfg, mesh)
    psh = param_shardings(plan, params)
    gsh = zero_shardings(plan, params)
    step = make_train_step(cfg, opt_cfg, microbatches=TRAIN_MICRO, kv_chunk=KV_CHUNK,
                           kernels="eager", grad_shardings=gsh)
    plain = make_train_step(cfg, opt_cfg, microbatches=TRAIN_MICRO, kv_chunk=KV_CHUNK,
                            kernels="eager")
    dparams = distribute_tree(params, psh)
    state = TrainState(dparams, adamw_init(dparams), torch.Generator().manual_seed(0))
    with sharding_context(mesh, plan):
        new, met = step(state, distribute_batch(plan, batch))
    want, met_u = plain(TrainState(params, adamw_init(params), torch.Generator()), batch)
    full = gather_tree(new.params)
    out.update(flat_from_tree(full, prefix + "params"))
    out.update(flat_from_tree(gather_tree(new.opt["m"]), prefix + "m"))
    out.update(flat_from_tree(want.params, prefix + "params_unsharded"))
    out.update(flat_from_tree(want.opt["m"], prefix + "m_unsharded"))
    out[prefix + "loss"] = _full(met["loss"]).numpy()
    out[prefix + "grad_norm"] = _full(met["grad_norm"]).numpy()
    out[prefix + "loss_unsharded"] = met_u["loss"].numpy()
    out[prefix + "grad_norm_unsharded"] = met_u["grad_norm"].numpy()
    out[prefix + "strategy"] = np.array(f"{plan.attn_strategy}/{plan.moe_strategy}")
    return plan, new, gsh, full


def case_train_moe(mesh, ins, out):
    """The MoE step on two batches: ``batch`` (a microbatch is one token
    group, whole on every data rank) and ``batch-long`` (two groups a
    microbatch, one on each data rank)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH).reduced()
    for tag in ("batch", "batch-long"):
        _zero_step(mesh, ins, out, cfg, tag, prefix=f"{tag}/")


def case_train(mesh, ins, out, root):
    from repro_torch.configs import get_config
    from repro_torch.train.checkpoint import save_checkpoint

    cfg = get_config(TRAIN_ARCH).reduced(**TRAIN_OVER)
    plan, new, gsh, full = _zero_step(mesh, ins, out, cfg)
    # the ZeRO layouts of the moments follow their parameters'; the
    # accumulator's are the data split on top (spot-checked on one leaf)
    wq = new.opt["m"]["layers"]["attn"]["wq"]
    out["m_wq_placements"] = np.array([repr(p) for p in wq.placements])
    out["zero_wq_spec"] = np.array(str(gsh["layers"]["attn"]["wq"].spec))
    save_checkpoint(str(root / "ckpt"), 1, new.params, new.opt, {"step": 1})
    dist.barrier()
    # greedy decoding of the stepped weights with the cache placed by
    # kv_cache_specs (batch over data, the sequence over model), against the
    # unsharded engine on the same values
    from repro_torch.serve.engine import Request, ServeEngine

    def reqs():
        return [Request(prompt=[1 + i, 7, 3], max_new=5) for i in range(4)]

    engine = ServeEngine(cfg, new.params, 4, 12, kernels="eager", plan=plan)
    out["decode_tokens"] = np.array([r.generated for r in engine.run(reqs())])
    out["decode_tokens_unsharded"] = np.array(
        [r.generated for r in ServeEngine(cfg, full, 4, 12, kernels="eager").run(reqs())])
    out["cache_k_placements"] = np.array([repr(p) for p in engine.cache["k"].placements])


def case_multipod(mesh, ins, out):
    """Loss and gradients of one batch split over (pod, data), the vocab
    over ``model``: the loss is the vocab-parallel cross-entropy
    (``model._vocab_parallel_nll``), mamba2's convolutions are made like
    their input (``ssm.causal_conv1d``); greedy decoding with the cache's
    batch over (pod, data) and its positions over ``model``
    (``layers.decode_attention``); each against the unsharded port."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_plan, param_shardings
    from repro_torch.distributed.context import sharding_context
    from repro_torch.distributed.sharding import distribute_batch, distribute_tree
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.train_step import microbatch_grads

    for label, arch, over in MULTIPOD_RUNS:
        cfg = get_config(arch).reduced(**over)
        params = tree_from_flat(ins, f"params-{label}")
        batch = _batch(ins, f"batch-{label}")
        plan = make_plan(cfg, mesh)
        dparams = distribute_tree(params, param_shardings(plan, params))
        with sharding_context(mesh, plan):
            loss, grads = microbatch_grads(cfg, dparams, distribute_batch(plan, batch),
                                           kv_chunk=KV_CHUNK, remat=False, kernels="eager")
        loss_u, grads_u = microbatch_grads(cfg, params, batch, kv_chunk=KV_CHUNK, remat=False,
                                           kernels="eager")
        out[f"{label}/loss"] = _full(loss).numpy()
        out[f"{label}/loss_unsharded"] = loss_u.numpy()
        for i, (g, gu) in enumerate(zip(grads, grads_u)):
            out[f"{label}/grad/{i}"] = _full(g).numpy()
            out[f"{label}/grad_unsharded/{i}"] = gu.numpy()
        if label != "tinyllama":
            continue

        def reqs():
            return [Request(prompt=[1 + i, 7, 3], max_new=5) for i in range(MULTIPOD_B)]

        engine = ServeEngine(cfg, dparams, MULTIPOD_B, 12, kernels="eager", plan=plan)
        out[f"{label}/decode_tokens"] = np.array([r.generated for r in engine.run(reqs())])
        out[f"{label}/decode_tokens_unsharded"] = np.array(
            [r.generated for r in ServeEngine(cfg, params, MULTIPOD_B, 12,
                                              kernels="eager").run(reqs())])
        out[f"{label}/cache_k_placements"] = np.array(
            [repr(p) for p in engine.cache["k"].placements])


def case_train_context(mesh, ins, out):
    """Loss and gradients of one batch under the ``context`` plan, each
    against the unsharded port; every rank's attention calls (query rows,
    keys, offset), gathered to rank 0: each model rank runs its own S/3
    query rows at their offset (``layers.on_local_heads``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_plan, param_shardings
    from repro_torch.distributed.context import sharding_context
    from repro_torch.distributed.sharding import distribute_batch, distribute_tree
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import microbatch_grads

    cfg = get_config(CONTEXT_ARCH).reduced()
    params = tree_from_flat(ins, "params-context")
    batch = _batch(ins, "batch-context")
    plan = make_plan(cfg, mesh)
    dparams = distribute_tree(params, param_shardings(plan, params))
    calls, attention_op = set(), ops.attention_op

    def noted(q, k, v, *a, **kw):
        calls.add((q.shape[1], k.shape[1], kw.get("q_offset")))
        return attention_op(q, k, v, *a, **kw)

    ops.attention_op = noted
    try:
        with sharding_context(mesh, plan):
            loss, grads = microbatch_grads(cfg, dparams, distribute_batch(plan, batch),
                                           kv_chunk=KV_CHUNK, remat=False, kernels="eager")
    finally:
        ops.attention_op = attention_op
    loss_u, grads_u = microbatch_grads(cfg, params, batch, kv_chunk=KV_CHUNK, remat=False,
                                       kernels="eager")
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, sorted(calls))
    out["strategy"] = np.array(f"{plan.attn_strategy}/{plan.moe_strategy}")
    out["attention_calls"] = np.array(ranks)
    out["loss"] = _full(loss).numpy()
    out["loss_unsharded"] = loss_u.numpy()
    for i, (g, gu) in enumerate(zip(grads, grads_u)):
        out[f"grad/{i}"] = _full(g).numpy()
        out[f"grad_unsharded/{i}"] = gu.numpy()


def case_restore(mesh, ins, out, root):
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_plan, param_shardings
    from repro_torch.distributed.sharding import gather_tree, named, P
    from repro_torch.models import model as tm
    from repro_torch.train import adamw_init
    from repro_torch.train.checkpoint import restore_checkpoint

    cfg = get_config(TRAIN_ARCH).reduced(**TRAIN_OVER)
    template = tm.init_params(cfg, torch.Generator().manual_seed(1), torch.float32, "cpu")
    opt_t = adamw_init(template)
    plan = make_plan(cfg, mesh)
    psh = param_shardings(plan, template)
    osh = {"m": psh, "v": psh, "step": named(mesh, P())}
    params, opt, meta = restore_checkpoint(str(root / "ckpt"), 1, template, opt_t,
                                           shardings=(psh, osh))
    w1 = params["layers"]["mlp"]["w1"]
    out["w1_placements"] = np.array([repr(p) for p in w1.placements])
    out["w1_local_shape"] = np.array(w1.to_local().shape)
    out.update(flat_from_tree(gather_tree(params), "params"))
    out.update(flat_from_tree(gather_tree(opt["m"]), "m"))
    out["step"] = _full(opt["step"]).numpy()
    out["meta_step"] = np.array(meta["step"])


def _rank(rank, world, case, root):
    from repro_torch.launch.mesh import init_distributed, make_mesh

    root = Path(root)
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{root / f'store-{case}'}", rank=rank,
                     world_size=world)
    try:
        shape, names = CASES[case]
        mesh = make_mesh(shape, names, device_type="cpu")
        with np.load(root / "inputs.npz", allow_pickle=False) as z:
            ins = {k: z[k] for k in z.files}
        out = {}
        if case == "ring":
            case_ring(mesh, ins, out)
        elif case == "pipeline":
            case_pipeline(mesh, ins, out)
        elif case in MODEL_RUNS:
            case_models(mesh, ins, out, MODEL_RUNS[case])
        elif case == "train":
            case_train(mesh, ins, out, root)
        elif case == "train-moe":
            case_train_moe(mesh, ins, out)
        elif case == "multipod":
            case_multipod(mesh, ins, out)
        elif case == "train-context":
            case_train_context(mesh, ins, out)
        else:
            case_restore(mesh, ins, out, root)
        if rank == 0:
            np.savez(root / "out.npz", **out)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    case, root = argv[0], Path(argv[1])
    if case not in CASES:
        raise SystemExit(f"unknown case {case!r}; one of {sorted(CASES)}")
    world = int(np.prod(CASES[case][0]))
    # a store file left by an earlier world would hand this one its keys
    (root / f"store-{case}").unlink(missing_ok=True)
    mp.spawn(_rank, args=(world, case, str(root)), nprocs=world)
    print(f"DIST_OK {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
