"""The port's decode engine (``repro_torch.serve.engine``) and launchers
(``repro_torch.launch.{train,serve}``) on the CPU, held against the JAX
package's engine on the same parameters (``params_from_jax``), in f32."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro.serve import engine as jengine
from repro_torch.launch import serve as serve_launch, train as train_launch
from repro_torch.models import init_kv_cache
from repro_torch.models.model import _leaves
from repro_torch.serve import Request, ServeEngine, make_serve_step, pad_to_slots
from repro_torch.serve import engine as tengine
from repro_torch.train import latest_step
from torch_model_cases import both_params, close

pytestmark = pytest.mark.torch

GAP = 1e-4   # a greedy token is compared only where JAX's top-2 gap exceeds it


def _requests(cls, vocab, seed):
    """Three requests of different prompt lengths and ``max_new``."""
    rng = np.random.default_rng(seed)
    return [cls(prompt=[int(t) for t in rng.integers(0, vocab, n)], max_new=m)
            for n, m in ((5, 4), (2, 6), (7, 3))]


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mamba2_2_7b"])
def test_engine_matches_jax(arch):
    """Four slots, three requests (one padded slot): the port's greedy
    tokens equal the JAX engine's, each after asserting that JAX's top-2
    logit gap at that token exceeds ``GAP`` (a near-tie would let f32
    noise pick either)."""
    cfg_j, cfg, pj, pt = both_params(arch, 0)
    max_seq = 14
    ej = jengine.ServeEngine(cfg_j, pj, batch_slots=4, max_seq=max_seq)
    gaps = []

    def recording(params, cache, tokens, pos):
        logits, cache = jm.decode_step(cfg_j, params, cache, tokens, pos)
        top2 = jnp.sort(logits, axis=-1)[:, -2:]
        gaps.append(np.asarray(top2[:, 1] - top2[:, 0]))
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache

    ej.step_fn = recording
    want = ej.run(_requests(jengine.Request, cfg.vocab, 1))
    got = ServeEngine(cfg, pt, batch_slots=4, max_seq=max_seq, kernels="eager").run(
        _requests(Request, cfg.vocab, 1))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.prompt == w.prompt and len(g.generated) == len(w.generated) == w.max_new
        for k, tok in enumerate(w.generated):
            gap = float(gaps[len(w.prompt) - 1 + k][i])
            assert gap > GAP, f"slot {i} token {k}: JAX's top-2 gap {gap} is a near-tie"
            assert g.generated[k] == tok, (i, k, g.generated, w.generated)
        assert g.done == w.done


def test_serve_step_matches_jax():
    """``make_serve_step``: the same next tokens and cache as the JAX
    step, three steps from an empty cache."""
    cfg_j, cfg, pj, pt = both_params("qwen3_14b", 2)
    step_j = jax.jit(jengine.make_serve_step(cfg_j))
    step_t = make_serve_step(cfg, kernels="eager")
    cache_j = jm.init_kv_cache(cfg_j, 2, 6, dtype=jnp.float32)
    cache_t = init_kv_cache(cfg, 2, 6, torch.float32, "cpu")
    toks = np.array([3, 9], np.int32)
    for pos in range(3):
        nj, cache_j = step_j(pj, cache_j, jnp.asarray(toks), pos)
        nt, cache_t = step_t(pt, cache_t, torch.from_numpy(toks).long(), pos)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        for name in cache_j:
            close(cache_t[name], cache_j[name], 1e-5)
        toks = np.array(nj)


def test_engine_reexports_one_pad_to_slots():
    from repro_torch.serve import slots

    assert pad_to_slots is tengine.pad_to_slots is slots.pad_to_slots
    with pytest.raises(ValueError, match="exceed"):
        pad_to_slots([1, 2, 3], 2, lambda: 0)


def test_serve_launcher_on_cpu(capsys):
    done = serve_launch.main(["--arch", "tinyllama-1.1b", "--batch", "3", "--max-new", "4",
                              "--prompt-len", "5", "--device", "cpu", "--kernels", "eager"])
    assert [len(r.prompt) for r in done] == [5] * 3
    assert all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "[serve] req2: prompt=" in out and "12 tokens in" in out


@pytest.mark.parametrize("launch", [serve_launch, train_launch])
def test_launchers_refuse_cuda_kernels_on_cpu(launch):
    with pytest.raises(ValueError, match="--kernels cuda needs --device cuda"):
        launch.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--kernels", "cuda"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-2.7b"])
def test_train_launcher_resumes_from_its_checkpoint(arch, tmp_path, capsys):
    """Three steps with a checkpoint after step 2; a second run restores
    it, resumes the data cursor and gives step 3's loss and parameters
    exactly."""
    args = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
            "--microbatches", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1", "--device", "cpu", "--kernels", "eager"]
    state, hist = train_launch.main(args)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert latest_step(str(tmp_path)) == 2
    state2, hist2 = train_launch.main(args)
    assert "[train] restored step 2" in capsys.readouterr().out
    assert [h["step"] for h in hist2] == [2]
    assert hist2[0]["loss"] == hist[2]["loss"]
    for (_, a), (_, b) in zip(_leaves(state.params), _leaves(state2.params)):
        assert torch.equal(a, b)
    assert int(state2.opt["step"]) == 3
