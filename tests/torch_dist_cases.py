"""Shared helpers of the port's multi-rank tests
(``tests/test_torch_distributed_*.py``): run a case of
``tests/torch_dist_worker.py`` (gloo ranks in a subprocess) or a JAX script
on forced host devices (a subprocess: the device count must be set before
JAX initialises), each with its own timeout, and build the reduced models'
inputs from the JAX package's parameters."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import model as jm

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
TIMEOUT = 300


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_worker(case: str, root: Path, inputs: dict) -> dict:
    """Write ``inputs`` to ``root``, run the worker's ``case`` and return
    what its rank 0 wrote."""
    root.mkdir(parents=True, exist_ok=True)
    np.savez(root / "inputs.npz", **inputs)
    res = subprocess.run([sys.executable, str(WORKER), case, str(root)], env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)
    assert f"DIST_OK {case}" in res.stdout, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(root / "out.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def run_jax(script: str, root: Path, devices: int = 4) -> dict:
    """Run a JAX ``script`` on ``devices`` forced host devices; it reads
    ``ROOT_DIR/inputs.npz`` and writes ``ROOT_DIR/jax_out.npz``."""
    code = (f"import os\nos.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n"
            f"ROOT_DIR = {str(root)!r}\n" + script)
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=ROOT)
    assert "JAX_OK" in res.stdout, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(root / "jax_out.npz", allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def flat(tree, prefix: str) -> dict:
    """A JAX (or numpy) tree's leaves as ``{prefix/a/b: array}``."""
    return {
        prefix + "/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def model_inputs(label: str, arch: str, over: dict, seed: int, b: int, s: int):
    """(JAX config, JAX params, numpy batch, the worker's inputs for them):
    the reduced config with ``over``, f32 parameters from the JAX package's
    init, a seeded batch."""
    cfg = jax_get_config(arch).reduced(**over)
    params = jm.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed + 1)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
        "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
    }
    inputs = flat(params, f"params-{label}")
    inputs.update({f"batch-{label}/{k}": v for k, v in batch.items()})
    return cfg, params, batch, inputs


def close(got, want, tol: float) -> float:
    """Max |got - want| relative to max(1, max |want|), asserted within
    ``tol``; returns it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err <= tol, err
    return err


SHARD_TOL, JAX_TOL = 1e-5, 1e-4


def models_case(case: str, root: Path):
    """Run a models case of the worker on the JAX package's parameters;
    returns (what rank 0 wrote, {label: JAX (loss, aux, prefill logits)})."""
    from torch_dist_worker import B, KV_CHUNK, MODEL_RUNS, S

    inputs, refs = {}, {}
    for i, (label, arch, _impl, over) in enumerate(MODEL_RUNS[case]):
        cfg, params, batch, ins = model_inputs(label, arch, over, i, B, S)
        inputs.update(ins)
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        loss, met = jm.forward_train(cfg, params, jb, kv_chunk=KV_CHUNK, remat=False)
        refs[label] = (np.asarray(loss), np.asarray(met["aux"]),
                       np.asarray(jm.forward_prefill(cfg, params, jb, kv_chunk=KV_CHUNK)))
    return run_worker(case, root, inputs), refs


def check_model(got: dict, refs: dict, label: str, strategy: str, routes: str) -> None:
    """A sharded model run: its plan's strategies, its routes, and its loss,
    aux loss and prefill logits against the unsharded port and JAX."""
    assert str(got[f"{label}/strategy"]) == strategy
    assert str(got[f"{label}/routes"]) == routes
    close(got[f"{label}/loss"], got[f"{label}/loss_unsharded"], SHARD_TOL)
    close(got[f"{label}/logits"], got[f"{label}/logits_unsharded"], SHARD_TOL)
    loss, aux, logits = refs[label]
    close(got[f"{label}/loss"], loss, JAX_TOL)
    close(got[f"{label}/aux"], aux, JAX_TOL)
    close(got[f"{label}/logits"], logits, JAX_TOL)
