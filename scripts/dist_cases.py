#!/usr/bin/env python3
"""Run the port's multi-rank worker cases (``tests/torch_dist_worker.py``)
on a machine without JAX, and check them where JAX is.

The tests (``tests/test_torch_distributed_{ranks,train}.py``) write each
case's inputs from the JAX package, run the worker and check what its rank
0 wrote, all in one process.  A machine with another torch release but no
JAX (the GPU machine) can run only the middle step, so this script splits
them:

    python scripts/dist_cases.py write DIR                  # needs JAX
    python scripts/dist_cases.py run DIR OUT [--tree T] [--anomaly] [--cases a,b]
    python scripts/dist_cases.py check DIR OUT              # needs JAX

``write`` puts ``DIR/<case>/inputs.npz`` and the JAX references
``DIR/<case>/refs.npz`` there (cases ``models-2x2``, ``train``,
``train-moe``, ``multipod``, the (2, 2, 2) world of 8 ranks, whose
references are the JAX losses, and ``train-context``, reduced tinyllama's
loss and gradients on 1×3 under the ``context`` plan, whose references are
the JAX loss and gradient leaves).
``run`` runs each case's gloo ranks with the rendezvous store under a fresh
directory of the system's temporary directory (a store under a copied
tree has hung every case on the GPU machine) and copies rank 0's
``out.npz`` to ``OUT/<case>/``; ``--tree`` runs another checkout's worker
and package (e.g. a parent commit unpacked with ``git archive``);
``--anomaly`` turns on autograd's anomaly detection in every rank, so a
failing backward op names the forward line that made it, and records the
ops of rank 0 with ``torch.profiler`` (the last ones before a failure go
to ``OUT/<case>/ops.txt``).  ``check`` holds each case's output to the
tests' own tolerances and prints each error beside its limit.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CASES = ("models-2x2", "train", "train-moe", "multipod", "train-context")


def write(root: Path) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as jm
    from torch_dist_cases import flat, model_inputs
    from torch_dist_worker import (
        B, CONTEXT_ARCH, KV_CHUNK, MODEL_RUNS, MOE_ARCH, MULTIPOD_B, MULTIPOD_RUNS, S, TRAIN_ARCH,
        TRAIN_OVER,
    )

    inputs, refs = {}, {}
    for i, (label, arch, _impl, over) in enumerate(MODEL_RUNS["models-2x2"]):
        cfg, params, batch, ins = model_inputs(label, arch, over, i, B, S)
        inputs.update(ins)
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        loss, met = jm.forward_train(cfg, params, jb, kv_chunk=KV_CHUNK, remat=False)
        refs[f"{label}/loss"], refs[f"{label}/aux"] = np.asarray(loss), np.asarray(met["aux"])
        refs[f"{label}/logits"] = np.asarray(jm.forward_prefill(cfg, params, jb,
                                                                kv_chunk=KV_CHUNK))
    _save(root / "models-2x2", inputs, refs)
    # the train case's inputs, as tests/test_torch_distributed_train.py makes them
    cfg = jax_get_config(TRAIN_ARCH).reduced(**TRAIN_OVER)
    params = jm.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    inputs = flat(params, "params")
    inputs["batch/tokens"] = rng.integers(0, cfg.vocab, (2 * B, S)).astype(np.int64)
    inputs["batch/labels"] = rng.integers(0, cfg.vocab, (2 * B, S)).astype(np.int64)
    _save(root / "train", inputs, {})
    # the MoE step's, as the same test file makes them
    cfg = jax_get_config(MOE_ARCH).reduced()
    params = jm.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    rng = np.random.default_rng(6)
    inputs = flat(params, "params")
    for tag, s in (("batch", S), ("batch-long", 512)):
        for k in ("tokens", "labels"):
            inputs[f"{tag}/{k}"] = rng.integers(0, cfg.vocab, (2 * B, s)).astype(np.int64)
    _save(root / "train-moe", inputs, {})
    # the (2, 2, 2) case's, as tests/test_torch_dryrun_multipod.py makes them
    inputs, refs = {}, {}
    for i, (label, arch, over) in enumerate(MULTIPOD_RUNS):
        cfg, params, batch, ins = model_inputs(label, arch, over, 10 + i, MULTIPOD_B, S)
        inputs.update(ins)
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        loss, _ = jm.forward_train(cfg, params, jb, kv_chunk=KV_CHUNK, remat=False)
        refs[f"{label}/loss"] = np.asarray(loss)
    _save(root / "multipod", inputs, refs)
    # the context case's, as tests/test_torch_distributed_train.py makes them
    cfg, params, batch, inputs = model_inputs("context", CONTEXT_ARCH, {}, 20, B, S)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: jm.forward_train(cfg, p, jb, kv_chunk=KV_CHUNK, remat=False)[0])(params)
    refs = {"loss": np.asarray(loss)}
    leaves = jax.tree_util.tree_leaves(grads)
    refs.update({f"grad/{i}": np.asarray(g) for i, g in enumerate(leaves)})
    _save(root / "train-context", inputs, refs)


def _save(d: Path, inputs: dict, refs: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "inputs.npz", **inputs)
    np.savez(d / "refs.npz", **refs)
    print(f"wrote {d}")


def _traced_rank(rank, world, case, store_dir, tree, out_dir):
    """One rank of the worker's case, with anomaly detection and, on rank
    0, a profiler record of its ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(tree) / "tests"))
    import torch_dist_worker

    # no NaN check: DTensor has no rule for its aten._is_any_true (torch 2.11)
    torch.autograd.set_detect_anomaly(True, check_nan=False)
    if rank:
        return torch_dist_worker._rank(rank, world, case, store_dir)
    prof = profile(activities=[ProfilerActivity.CPU], record_shapes=True)
    try:
        with prof:
            torch_dist_worker._rank(rank, world, case, store_dir)
    finally:
        events = sorted(prof.events(), key=lambda e: e.time_range.start)
        lines = [f"{e.name} {e.input_shapes}" for e in events if e.name.startswith("aten::")]
        (Path(out_dir) / "ops.txt").write_text("\n".join(lines[-60:]) + "\n")


def run(root: Path, out: Path, tree: Path, cases, anomaly: bool) -> int:
    failed = 0
    for case in cases:
        store = Path(tempfile.mkdtemp(prefix=f"dist-{case}-"))
        shutil.copy(root / case / "inputs.npz", store / "inputs.npz")
        dest = out / case
        dest.mkdir(parents=True, exist_ok=True)
        if anomaly:
            import torch.multiprocessing as mp

            sys.path.insert(0, str(tree / "tests"))
            from torch_dist_worker import CASES as WORKER_CASES

            world = int(np.prod(WORKER_CASES[case][0]))
            try:
                mp.spawn(_traced_rank, args=(world, case, str(store), str(tree), str(dest)),
                         nprocs=world)
                ok = True
            except Exception:
                traceback.print_exc()
                ok = False
        else:
            res = subprocess.run([sys.executable, str(tree / "tests" / "torch_dist_worker.py"),
                                  case, str(store)], capture_output=True, text=True,
                                 timeout=600)
            print(res.stdout[-4000:], res.stderr[-12000:], sep="\n")
            ok = f"DIST_OK {case}" in res.stdout
        if (store / "out.npz").exists():
            shutil.copy(store / "out.npz", dest / "out.npz")
        print(f"case {case}: {'ran' if ok else 'FAILED'}", flush=True)
        failed += not ok
        shutil.rmtree(store, ignore_errors=True)
    return 1 if failed else 0


def check(root: Path, out: Path) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    from torch_dist_cases import JAX_TOL, SHARD_TOL, close
    from torch_dist_worker import MODEL_RUNS

    bad = 0

    def held(what, got, want, tol):
        nonlocal bad
        try:
            err = close(got, want, tol)
            print(f"  {what}: {err:.3e} (limit {tol:g})")
        except AssertionError as e:
            bad += 1
            print(f"  {what}: FAILS {e} (limit {tol:g})")

    got = dict(np.load(out / "models-2x2" / "out.npz"))
    refs = dict(np.load(root / "models-2x2" / "refs.npz"))
    print("models-2x2 (2x2 gloo ranks, the sharded port against the unsharded port and JAX):")
    for label, *_ in MODEL_RUNS["models-2x2"]:
        print(f" {label}: {got[f'{label}/strategy']} {got[f'{label}/routes']}")
        for k in ("loss", "logits"):
            held(f"{k} vs unsharded", got[f"{label}/{k}"], got[f"{label}/{k}_unsharded"],
                 SHARD_TOL)
        for k in ("loss", "aux", "logits"):
            held(f"{k} vs JAX", got[f"{label}/{k}"], refs[f"{label}/{k}"], JAX_TOL)
    def step(got, prefix=""):
        for k in ("loss", "grad_norm"):
            held(prefix + k, got[prefix + k], got[f"{prefix}{k}_unsharded"], SHARD_TOL)
        for tree, tol in (("params", JAX_TOL), ("m", SHARD_TOL)):
            keys = [k for k in got if k.startswith(prefix + tree + "/")]
            worst = max(keys, key=lambda k: float(np.max(np.abs(got[k] - got[
                f"{prefix}{tree}_unsharded/{k[len(prefix + tree) + 1:]}"]))))
            held(f"{tree} (worst leaf {worst})", got[worst],
                 got[f"{prefix}{tree}_unsharded/{worst[len(prefix + tree) + 1:]}"], tol)

    got = dict(np.load(out / "train-moe" / "out.npz"))
    print("train-moe (2x2 gloo ranks, reduced dbrx's ZeRO-layout step, experts over model):")
    for tag in ("batch", "batch-long"):
        print(f" {tag}: {got[tag + '/strategy']}")
        step(got, tag + "/")
    got = dict(np.load(out / "train" / "out.npz"))
    print("train (2x2 gloo ranks, a ZeRO-layout AdamW step against the unsharded step):")
    step(got)
    same = np.array_equal(got["decode_tokens"], got["decode_tokens_unsharded"])
    print(f"  sharded-cache decode tokens equal: {same}")
    bad += not same
    if (out / "multipod" / "out.npz").exists():
        from torch_dist_worker import MULTIPOD_RUNS

        got = dict(np.load(out / "multipod" / "out.npz"))
        refs = dict(np.load(root / "multipod" / "refs.npz"))
        print("multipod ((2, 2, 2) gloo ranks, the batch over (pod, data), against the "
              "unsharded port and JAX):")
        for label, *_ in MULTIPOD_RUNS:
            held(f"{label} loss vs unsharded", got[f"{label}/loss"],
                 got[f"{label}/loss_unsharded"], SHARD_TOL)
            held(f"{label} loss vs JAX", got[f"{label}/loss"], refs[f"{label}/loss"], JAX_TOL)
            # each gradient leaf relative to its own largest value, as the test holds it
            rel = {k: float(np.max(np.abs(got[k] - got[k.replace("/grad/", "/grad_unsharded/")]))
                            / np.max(np.abs(got[k.replace("/grad/", "/grad_unsharded/")])))
                   for k in got if k.startswith(f"{label}/grad/")}
            worst = max(rel, key=rel.get)
            ok = rel[worst] <= SHARD_TOL
            bad += not ok
            print(f"  {label} gradient (worst leaf {worst}, of its largest value): "
                  f"{rel[worst]:.3e} (limit {SHARD_TOL:g}){'' if ok else ' FAILS'}")
        same = np.array_equal(got["tinyllama/decode_tokens"],
                              got["tinyllama/decode_tokens_unsharded"])
        print(f"  tinyllama decode tokens equal: {same}")
        bad += not same
    if (out / "train-context" / "out.npz").exists():
        from torch_dist_worker import S

        got = dict(np.load(out / "train-context" / "out.npz"))
        refs = dict(np.load(root / "train-context" / "refs.npz"))
        calls = got["attention_calls"].tolist()
        want = [[[S // 3, S, r * S // 3]] for r in range(3)]
        print(f"train-context (1x3 gloo ranks, {got['strategy']}): attention calls "
              f"(rows, keys, offset) by rank {calls}{'' if calls == want else ' FAILS'}")
        bad += calls != want
        held("loss vs unsharded", got["loss"], got["loss_unsharded"], SHARD_TOL)
        held("loss vs JAX", got["loss"], refs["loss"], JAX_TOL)
        for against, tol in (("unsharded", SHARD_TOL), ("JAX", JAX_TOL)):
            # each gradient leaf relative to its own largest value, as the test holds it
            keys = [k for k in got if k.startswith("grad/")]
            rel = {}
            for k in keys:
                w = refs[k] if against == "JAX" else got[k.replace("grad/", "grad_unsharded/")]
                rel[k] = float(np.max(np.abs(got[k] - w)) / np.max(np.abs(w)))
            worst = max(rel, key=rel.get)
            ok = rel[worst] <= tol
            bad += not ok
            print(f"  gradient vs {against} (worst leaf {worst} of {len(keys)}, of its largest "
                  f"value): {rel[worst]:.3e} (limit {tol:g}){'' if ok else ' FAILS'}")
    print("check:", "OK" if not bad else f"{bad} FAILED")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write")
    w.add_argument("dir", type=Path)
    r = sub.add_parser("run")
    r.add_argument("dir", type=Path)
    r.add_argument("out", type=Path)
    r.add_argument("--tree", type=Path, default=ROOT)
    r.add_argument("--anomaly", action="store_true")
    r.add_argument("--cases", default=",".join(CASES))
    c = sub.add_parser("check")
    c.add_argument("dir", type=Path)
    c.add_argument("out", type=Path)
    args = ap.parse_args(argv)
    if args.cmd == "write":
        write(args.dir)
        return 0
    if args.cmd == "run":
        return run(args.dir, args.out, args.tree.resolve(), args.cases.split(","), args.anomaly)
    return check(args.dir, args.out)


if __name__ == "__main__":
    sys.exit(main())
