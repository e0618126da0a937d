"""The port's training stack (``repro_torch.train``) on the CPU: the JAX
package's training tests (``tests/test_train.py``) replayed on
``device="cpu", kernels="eager"``, the lifecycle of
``tests/test_system.py::test_framework_train_checkpoint_restore_serve``,
and parity with the JAX package on the same inputs (numpy from a seed,
parameters carried by ``params_from_jax``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward_train as jax_forward_train, init_params as jax_init_params
from repro import train as jtrain
from repro.train import checkpoint as jckpt, optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.models import init_params, params_from_jax
from repro_torch.models.model import _leaves, _map
from repro_torch.train import (
    AdamWConfig,
    DataPipeline,
    TrainState,
    adamw_init,
    adamw_update,
    global_norm,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    stochastic_round_bf16,
)
from repro_torch.train.checkpoint import latest_steps
from repro_torch.train.fault import SimulatedFailure, StragglerMonitor, run_with_restarts
from repro_torch.train.train_step import batch_grads

pytestmark = pytest.mark.torch

TINY = dict(n_layers=2, d_model=32, vocab=64, d_ff=64)


def tiny_cfg():
    return get_config("tinyllama_1_1b").reduced(**TINY)


def make_state(cfg, seed=0):
    params = init_params(cfg, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return TrainState(params, adamw_init(params), torch.Generator().manual_seed(1))


def batch_np(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def make_batch(cfg, b=4, s=16, seed=0):
    return {k: torch.from_numpy(v).long() for k, v in batch_np(cfg, b, s, seed).items()}


def step_fn(cfg, opt, microbatches=1):
    return make_train_step(cfg, opt, microbatches=microbatches, kv_chunk=8, kernels="eager")


def leaves(tree):
    return [t for _, t in _leaves(tree)]


def close_rel(got, want, tol):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want), initial=0.0) <= tol * max(np.max(np.abs(want), initial=0.0),
                                                                 1e-30)


# ---------------------------------------------------------------------------
# tests/test_train.py, replayed on the port
# ---------------------------------------------------------------------------


def test_train_step_decreases_loss():
    cfg = tiny_cfg()
    step = step_fn(cfg, AdamWConfig(lr=1e-2, warmup_steps=1), microbatches=2)
    state = make_state(cfg)
    batch = make_batch(cfg)   # same batch -> loss must drop fast
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatching_matches_single_batch():
    """Gradient accumulation must equal the full-batch gradient step."""
    cfg = tiny_cfg()
    batch = make_batch(cfg, b=4)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    s1, _ = step_fn(cfg, opt, 1)(make_state(cfg), batch)
    s2, _ = step_fn(cfg, opt, 4)(make_state(cfg), batch)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_grad_compression_still_learns():
    cfg = tiny_cfg()
    step = step_fn(cfg, AdamWConfig(lr=1e-2, warmup_steps=1, compress_grads=True))
    state = make_state(cfg)
    batch = make_batch(cfg)
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_stochastic_rounding_unbiased():
    x = torch.full((20000,), 1.0 + 2 ** -10, dtype=torch.float32)  # between bf16 grid points
    r = stochastic_round_bf16(x, torch.Generator().manual_seed(0)).float()
    assert abs(float(r.mean()) - float(x[0])) < 1e-4
    assert len(torch.unique(r)) == 2


def test_data_pipeline_deterministic_and_resumable():
    cfg = tiny_cfg()
    d1 = DataPipeline(cfg.vocab, 2, 8, seed=3)
    b1 = [next(d1) for _ in range(3)]
    d1.close()
    # resume from step 2
    d2 = DataPipeline(cfg.vocab, 2, 8, seed=3, start_step=2)
    b2 = next(d2)
    d2.close()
    np.testing.assert_array_equal(b1[2]["tokens"], b2["tokens"])


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny_cfg()
    state = make_state(cfg)
    save_checkpoint(str(tmp_path), 7, state.params, state.opt, {"step": 7})
    assert latest_step(str(tmp_path)) == 7
    p, o, meta = restore_checkpoint(str(tmp_path), 7, state.params, state.opt)
    assert meta["step"] == 7
    for a, b in zip(leaves(state.params), leaves(p)):
        assert torch.equal(a, b)


def test_checkpoint_retention(tmp_path):
    cfg = tiny_cfg()
    state = make_state(cfg)
    for s in [10, 20, 30, 40]:
        save_checkpoint(str(tmp_path), s, state.params, state.opt, {}, keep_last=2)
    assert latest_steps(str(tmp_path)) == [30, 40]


def test_run_with_restarts_recovers():
    """Driver survives injected failures and finishes all steps."""
    cfg = tiny_cfg()
    step = step_fn(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    saved = {}

    def make_state_fn():
        if "state" in saved:
            return saved["state"], saved["data"], saved["step"]
        data = iter(lambda: make_batch(cfg, seed=np.random.randint(1 << 30)), None)
        return make_state(cfg), data, 0

    def run_step(state, batch, step_no):
        return step(state, batch)

    def save(state, data, step_no):
        saved.update(state=state, data=data, step=step_no)

    fails = {5: True, 12: True}

    def fault_hook(step_no):
        if fails.pop(step_no, None):
            raise SimulatedFailure(f"injected at {step_no}")

    out = run_with_restarts(
        total_steps=15, make_state=make_state_fn, run_step=run_step,
        save=save, ckpt_every=3, fault_hook=fault_hook,
    )
    assert out["final_step"] == 15
    assert out["restarts"] == 2


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(threshold=3.0)
    for i in range(10):
        m.observe(i, 0.1)
    assert m.observe(10, 1.0)          # 10x slower than EWMA
    assert m.flagged == [10]


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.full((4,), 2.0)}
    assert abs(float(global_norm(t)) - np.sqrt(3 + 16)) < 1e-6


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _random_tree(rng):
    shapes = {"embed": (16, 8), "layers": {"attn": {"wq": (2, 8, 8)}, "ln1": (2, 8)},
              "final_norm": (8,)}
    return _map_shapes(lambda s: rng.standard_normal(s).astype(np.float32), shapes)


def _map_shapes(fn, tree):
    return {k: _map_shapes(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("grad_scale,step", [(0.05, 0), (3.0, 4)])
def test_adamw_update_matches_jax(grad_scale, step):
    """One update of a random tree from random moments: params and moments
    within 1e-6 of JAX's (relative to each leaf's largest value), the grad
    norm and lr too; ``grad_scale`` 3 puts the norm above the clip."""
    rng = np.random.default_rng(7)
    p, g, m = (_random_tree(rng) for _ in range(3))
    g = _map_shapes(lambda a: a * grad_scale, g)
    v = _map_shapes(lambda a: np.abs(a) * 0.1, _random_tree(rng))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3)
    jstate = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.asarray(step, jnp.int32)}
    jp, jo, jm = jopt.adamw_update(jopt.AdamWConfig(lr=1e-2, warmup_steps=3),
                                   jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                                   jstate)
    t = lambda tree: params_from_jax(tree, "cpu")
    tp, to, tm = adamw_update(cfg, t(p), t(g), {"m": t(m), "v": t(v),
                                                "step": torch.tensor(step, dtype=torch.int32)})
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for (path, a), b in zip(_leaves(got), jax.tree.leaves(want)):
            close_rel(a.numpy(), b, 1e-6)
    assert int(to["step"]) == int(jo["step"]) == step + 1 and to["step"].dtype == torch.int32
    close_rel(tm["grad_norm"], jm["grad_norm"], 1e-6)
    close_rel(tm["lr"], jm["lr"], 1e-6)


def test_stochastic_round_bf16_matches_jax_bit_for_bit():
    """With JAX's own noise the port's rounding gives JAX's bits, on
    normal values, signs, subnormals, infinities and values whose rounding
    carries into the exponent."""
    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4096),
        np.array([0.0, -0.0, 1e-40, -1e-40, np.inf, -np.inf, 3.3895e38, -3.3895e38,
                  1.9999999, -1.9999999], np.float32),
    ]).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jopt.stochastic_round_bf16(jnp.asarray(x), key)).view(np.uint16)
    noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16, dtype=jnp.uint32))
    got = stochastic_round_bf16(torch.from_numpy(x), noise=torch.from_numpy(noise.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


def test_train_step_matches_jax():
    """One step with two microbatches from the JAX package's parameters:
    the loss within 1e-5, every gradient within 1e-4 of its leaf's largest
    (``torch.autograd.grad`` beside ``jax.value_and_grad`` of
    ``forward_train``), the updated params as the microbatching test holds
    them (rtol 2e-4, atol 2e-5)."""
    cfg_j = jax_get_config("tinyllama_1_1b").reduced(**TINY)
    cfg = tiny_cfg()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    bn = batch_np(cfg, seed=4)
    bj = {k: jnp.asarray(v) for k, v in bn.items()}
    bt = {k: torch.from_numpy(v).long() for k, v in bn.items()}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)

    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jax_forward_train(cfg_j, p, bj, kv_chunk=8, remat=True), has_aux=True)(pj)
    loss_t, grads_t = batch_grads(cfg, pt, bt, kv_chunk=8, kernels="eager")
    close_rel(loss_t, loss_j, 1e-5)
    for (path, g), w in zip(_leaves(grads_t), jax.tree.leaves(grads_j)):
        close_rel(g.numpy(), w, 1e-4)

    step_j = jax.jit(jtrain.make_train_step(cfg_j, jopt.AdamWConfig(lr=1e-3, warmup_steps=1),
                                            microbatches=2, kv_chunk=8))
    sj, mj = step_j(jtrain.TrainState(pj, jtrain.adamw_init(pj), jax.random.PRNGKey(1)), bj)
    st = TrainState(pt, adamw_init(pt), torch.Generator().manual_seed(1))
    st, mt = make_train_step(cfg, opt, microbatches=2, kv_chunk=8, kernels="eager")(st, bt)
    close_rel(mt["loss"], mj["loss"], 1e-5)
    close_rel(mt["grad_norm"], mj["grad_norm"], 1e-4)
    close_rel(mt["lr"], mj["lr"], 1e-6)
    for a, b in zip(leaves(st.params), jax.tree.leaves(sj.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


def test_data_pipeline_matches_jax():
    """The same batches as the JAX package's pipeline for three steps and
    after a resume, prefix embeddings included."""
    from repro.train.data import DataPipeline as JaxPipeline

    for start, n in ((0, 3), (2, 1)):
        pipes = [P(64, 2, 8, seed=5, start_step=start, prefix_dim=4, prefix_len=3)
                 for P in (DataPipeline, JaxPipeline)]
        try:
            for _ in range(n):
                got, want = (next(p) for p in pipes)
                assert sorted(got) == sorted(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
                    assert got[k].dtype == want[k].dtype
            assert pipes[0].state() == pipes[1].state()
        finally:
            for p in pipes:
                p.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(writer, tmp_path):
    """A checkpoint written by either package restores in the other: every
    leaf equal, the meta equal."""
    cfg_j = jax_get_config("tinyllama_1_1b").reduced(**TINY)
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(2), dtype=jnp.float32)
    oj = jtrain.adamw_init(pj)
    oj["step"] = jnp.asarray(5, jnp.int32)
    pt = params_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    ot = {"m": _map(torch.zeros_like, pt), "v": _map(torch.zeros_like, pt),
          "step": torch.tensor(5, dtype=torch.int32)}
    data = {"step": 5, "seed": 0}
    if writer == "jax":
        jckpt.save_checkpoint(str(tmp_path), 5, pj, oj, data)
        p, o, meta = restore_checkpoint(str(tmp_path), 5, pt, ot)
        got, want = leaves({"p": p, "o": o}), jax.tree.leaves({"p": pj, "o": oj})
    else:
        save_checkpoint(str(tmp_path), 5, pt, ot, data)
        p, o, meta = jckpt.restore_checkpoint(str(tmp_path), 5, pj, oj)
        got, want = jax.tree.leaves({"p": p, "o": o}), leaves({"p": pt, "o": ot})
    assert meta == {"step": 5, "data": data}
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bf16_checkpoint_round_trip_bit_for_bit(tmp_path):
    cfg = tiny_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(3), torch.bfloat16, "cpu")
    opt = adamw_init(params)
    save_checkpoint(str(tmp_path), 1, params, opt, {"step": 1})
    p, o, meta = restore_checkpoint(str(tmp_path), 1, params, opt)
    assert meta == {"step": 1, "data": {"step": 1}}
    for a, b in zip(leaves({"p": params, "o": opt}), leaves({"p": p, "o": o})):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(a, b)


def test_torch_framework_lifecycle(tmp_path):
    """Full lifecycle on the port: train a reduced model, checkpoint,
    restore into a new state, keep training (loss continues down), then
    serve."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = tiny_cfg()
    step = step_fn(cfg, AdamWConfig(lr=5e-3, warmup_steps=1), microbatches=2)
    state = make_state(cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))

    save_checkpoint(str(tmp_path), 6, state.params, state.opt, {"step": 6})
    assert latest_step(str(tmp_path)) == 6
    p, o, meta = restore_checkpoint(str(tmp_path), 6, state.params, state.opt)
    state2 = TrainState(p, o, torch.Generator().manual_seed(1))
    state2, m2 = step(state2, batch)
    assert float(m2["loss"]) < losses[0]     # resumed training continues down

    engine = ServeEngine(cfg, state2.params, batch_slots=2, max_seq=24, kernels="eager")
    done = engine.run([Request(prompt=[1, 2, 3], max_new=4)])
    assert len(done[0].generated) == 4
