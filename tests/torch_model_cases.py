"""Shared cases of the model parity tests (``tests/test_torch_models_*.py``):
one reduced architecture run through both packages on the same seeded
inputs and the same parameters (the JAX package's, carried over by
``params_from_jax``), in f32."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro_torch.configs import get_config
from repro_torch.models import model as tm

TOL = 1e-4          # relative to the largest reference value
B, S, KV_CHUNK, DECODE_STEPS = 2, 32, 16, 4


def close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


def batch_np(cfg, seed: int, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
    }
    if cfg.frontend != "none":
        batch["prefix_embeds"] = (
            rng.standard_normal((b, jm.PREFIX_LEN, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def both_params(arch: str, seed: int):
    """(reduced config, JAX params, the same params as the port's tree)."""
    cfg = jax_get_config(arch).reduced()
    pj = jm.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    pt = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg, get_config(arch).reduced(), pj, pt


def check_train_prefill_decode(arch: str, seed: int = 0) -> None:
    """forward_train's loss, nll and aux, forward_prefill's logits and
    DECODE_STEPS decode steps (logits and every cache tensor after each),
    port against JAX within TOL."""
    cfg_j, cfg, pj, pt = both_params(arch, seed)
    bn = batch_np(cfg, seed + 1)
    loss, met = tm.forward_train(cfg, pt, to_torch(bn), kv_chunk=KV_CHUNK, remat=False,
                                 kernels="eager")
    loss_j, met_j = jm.forward_train(cfg_j, pj, to_jax(bn), kv_chunk=KV_CHUNK, remat=False)
    close(loss, loss_j)
    close(met["nll"], met_j["nll"])
    close(met["aux"], met_j["aux"])
    close(tm.forward_prefill(cfg, pt, to_torch(bn), kv_chunk=KV_CHUNK, kernels="eager"),
          jm.forward_prefill(cfg_j, pj, to_jax(bn), kv_chunk=KV_CHUNK))

    smax = 8
    cache = tm.init_kv_cache(cfg, B, smax, torch.float32, "cpu")
    cache_j = jm.init_kv_cache(cfg_j, B, smax, dtype=jnp.float32)
    assert sorted(cache) == sorted(cache_j)
    toks = np.asarray(bn["tokens"][:, 0])
    for pos in range(DECODE_STEPS):
        lg, cache = tm.decode_step(cfg, pt, cache, torch.from_numpy(toks).long(), pos,
                                   kernels="eager")
        lg_j, cache_j = jm.decode_step(cfg_j, pj, cache_j, jnp.asarray(toks), pos)
        close(lg, lg_j)
        for k in cache_j:
            close(cache[k], cache_j[k])
        toks = np.asarray(jnp.argmax(lg_j, -1)).astype(np.int32)


def check_decode_matches_forward(arch: str, seed: int) -> None:
    """The JAX ``test_decode_matches_forward_*`` on the port: greedy decode
    logits at each position equal a teacher-forced forward pass."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    params = tm.init_params(cfg, gen, torch.float32, "cpu")
    s = 8
    tokens = torch.randint(0, cfg.vocab, (B, s), generator=gen)
    x = tm.embed_inputs(cfg, params, {"tokens": tokens})
    h, _ = tm._backbone(cfg, params, x, kv_chunk=8, kernels="eager")
    h = tm.rms_norm(h, params["final_norm"], cfg.norm_eps)
    full = torch.einsum("bsd,vd->bsv", h, params["embed"]).float()
    cache = tm.init_kv_cache(cfg, B, s, torch.float32, "cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode_step(cfg, params, cache, tokens[:, t], t, kernels="eager")
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def check_tree_matches_jax(arch: str) -> None:
    """The full configuration's parameter tree, built on ``meta`` (nothing
    allocated), has the JAX tree's leaves with the same shapes
    (``jax.eval_shape``, nothing allocated there either)."""
    cfg = get_config(arch)
    shapes_j = jax.eval_shape(
        lambda: jm.init_params(jax_get_config(arch), jax.random.PRNGKey(0), jnp.bfloat16)
    )
    flat_j = {
        "/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes_j)
    }
    pt = tm.init_params(cfg, None, torch.bfloat16, "meta")
    flat_t = {name: tuple(t.shape) for name, t in tm._leaves(pt)}
    assert flat_t == flat_j
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for _, t in tm._leaves(pt))


def count_routes(arch: str, monkeypatch, **overrides):
    """One eager prefill of the reduced config: the ``ops`` calls it made
    (attention, SSD) and ``layers.ROUTES``."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as tl

    calls = {"attention_op": 0, "ssd_op": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    cfg = get_config(arch).reduced(**overrides)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    tl.ROUTES.clear()
    tm.forward_prefill(cfg, params, to_torch(batch_np(cfg, 0)), kv_chunk=KV_CHUNK,
                       kernels="eager")
    return calls, dict(tl.ROUTES)
