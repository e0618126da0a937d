"""The port's dense architectures held against the JAX package, in f32.

Each of qwen3-14b, gemma3-1b, glm4-9b and tinyllama-1.1b at its
``reduced()`` width, with the JAX package's parameters carried over by
``params_from_jax``: ``forward_train``'s loss, nll and aux,
``forward_prefill``'s logits and 4 ``decode_step``s with their caches,
within 1e-4 relative (``torch_model_cases``).  Also the configurations
(``dataclasses.asdict`` of all ten equal to the JAX package's), the full
parameter trees built on ``meta``, the replayed
``test_decode_matches_forward_dense``, ``test_gemma3_local_global_pattern``
and param-count tests of ``tests/test_arch_smoke.py``, the dense routes
(every layer with no window through ``ops.attention_op``), ``remat``, the
``LM`` module and the no-fallback contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCH_IDS, DASHED, get_config
from repro_torch.models import LM, forward_prefill, forward_train, init_kv_cache, init_params
from repro_torch.models import model as tm
from repro_torch.models.model import _layer_window, _window_for_layer, param_count

from torch_model_cases import (
    batch_np,
    check_decode_matches_forward,
    check_train_prefill_decode,
    check_tree_matches_jax,
    close,
    count_routes,
    to_torch,
)

pytestmark = pytest.mark.torch

DENSE = ["qwen3_14b", "gemma3_1b", "glm4_9b", "tinyllama_1_1b"]


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_train_prefill_decode_match_jax(arch):
    check_train_prefill_decode(arch)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == dataclasses.asdict(
        jax_get_config(arch).reduced()
    )


def test_arch_ids_and_lookup():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert get_config("tinyllama-1.1b") is get_config("tinyllama_1_1b")
    assert DASHED["gemma3-1b"] == "gemma3_1b"
    with pytest.raises(KeyError):
        get_config("llama-9000")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_tree_on_meta_matches_jax(arch):
    check_tree_matches_jax(arch)


def test_all_head_dims_within_the_kernel_bound():
    from repro_torch.kernels.flash_attention import MAX_HEAD_DIM

    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert cfg.attention_free or cfg.head_dim <= MAX_HEAD_DIM, arch


def test_decode_matches_forward_dense():
    check_decode_matches_forward("tinyllama_1_1b", 4)


def test_gemma3_local_global_pattern():
    """Replays the JAX test, and the route the port takes from the rule:
    the global layer (``1 << 30``) has no window, so it runs the kernel."""
    cfg = get_config("gemma3_1b")
    assert cfg.sliding_window == 1024 and cfg.global_every == 6
    assert _window_for_layer(cfg, 5) == 1 << 30
    assert _window_for_layer(cfg, 0) == 1024
    assert [i for i in range(cfg.n_layers) if _layer_window(cfg, i) is None] == [5, 11, 17, 23]
    assert _layer_window(get_config("tinyllama_1_1b"), 0) is None


def test_param_counts_roughly_match_names():
    """Replays the JAX test, and counts the meta-built trees: each within
    0.01% of the config's approximate count."""
    approx = {
        "qwen3_14b": (12e9, 16e9), "gemma3_1b": (0.7e9, 1.6e9), "glm4_9b": (8e9, 11e9),
        "tinyllama_1_1b": (0.9e9, 1.4e9), "dbrx_132b": (110e9, 150e9),
        "mamba2_2_7b": (2.0e9, 3.3e9), "zamba2_7b": (5.5e9, 9e9),
        "musicgen_medium": (1.2e9, 2.4e9), "pixtral_12b": (10e9, 14e9),
        "qwen2_moe_a2_7b": (12e9, 16e9),
    }
    for arch, (lo, hi) in approx.items():
        cfg = get_config(arch)
        n = cfg.param_count()
        assert lo < n < hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9}, {hi/1e9}]"
        built = param_count(init_params(cfg, None, torch.bfloat16, "meta"))
        assert abs(built - n) <= 1e-4 * n, (arch, built, n)


def test_moe_active_params_much_smaller():
    cfg = get_config("qwen2_moe_a2_7b")
    assert cfg.active_param_count() < 0.4 * cfg.param_count()


def test_dense_routes(monkeypatch):
    """Every dense layer has no window: one ``ops.attention_op`` a layer."""
    calls, routes = count_routes("tinyllama_1_1b", monkeypatch)
    assert calls == {"attention_op": 2, "ssd_op": 0}
    assert routes == {"attention_op": 2}


def test_gemma3_routes(monkeypatch):
    """gemma3 at 12 layers: layers 5 and 11 are global and run the kernel
    route, the other 10 the plain windowed attention."""
    calls, routes = count_routes("gemma3_1b", monkeypatch, n_layers=12)
    assert calls == {"attention_op": 2, "ssd_op": 0}
    assert routes == {"attention_op": 2, "windowed": 10}


def test_init_params_distributions():
    cfg = get_config("tinyllama_1_1b").reduced(d_model=256, vocab=1024)
    p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    assert float(p["final_norm"].abs().max()) == 0.0
    again = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert torch.equal(p["layers"]["attn"]["wq"], again["layers"]["attn"]["wq"])


def test_remat_is_the_same_function_and_differentiates():
    """``remat=True`` checkpoints each layer when grad is enabled: the same
    loss, and gradients that reach every layer."""
    cfg = get_config("tinyllama_1_1b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(1), torch.float32, "cpu")
    batch = to_torch(batch_np(cfg, 2))
    plain, _ = forward_train(cfg, p, batch, kv_chunk=16, remat=False, kernels="eager")
    wq = p["layers"]["attn"]["wq"].requires_grad_(True)
    loss, _ = forward_train(cfg, p, batch, kv_chunk=16, remat=True, kernels="eager")
    close(loss, plain.detach(), 1e-6)
    loss.backward()
    assert wq.grad is not None and bool(torch.isfinite(wq.grad).all())
    assert all(float(g.abs().sum()) > 0 for g in wq.grad)


def test_loss_mask_matches_jax():
    import jax.numpy as jnp

    from repro.models import model as jm
    from torch_model_cases import both_params, to_jax

    cfg_j, cfg, pj, pt = both_params("qwen3_14b", 3)
    bn = batch_np(cfg, 4)
    bn["loss_mask"] = (np.arange(32)[None, :] % 3 != 0).astype(np.float32).repeat(2, 0)
    loss, met = forward_train(cfg, pt, to_torch(bn), kv_chunk=16, remat=False, kernels="eager")
    loss_j, met_j = jm.forward_train(cfg_j, pj, to_jax(bn), kv_chunk=16, remat=False)
    close(loss, loss_j)
    close(met["nll"], met_j["nll"])
    assert jnp.isfinite(loss_j)


def test_lm_module_holds_the_tree():
    cfg = get_config("glm4_9b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
    lm = LM(cfg, p)
    assert sum(t.numel() for t in lm.parameters()) == param_count(p)
    batch = to_torch(batch_np(cfg, 6))
    assert torch.equal(lm(batch, kernels="eager"), forward_prefill(cfg, p, batch, kernels="eager"))
    cache = init_kv_cache(cfg, 2, 4, torch.float32, "cpu")
    lg, _ = lm.decode_step(cache, batch["tokens"][:, 0], 0, kernels="eager")
    assert lg.shape == (2, cfg.vocab)


def test_no_fallback_to_the_cpu(monkeypatch):
    """The defaults ask for the card: ``kernels="cuda"`` on CPU tensors
    raises in every entry point, and ``device="cuda"`` without a GPU raises."""
    cfg = get_config("tinyllama_1_1b").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    batch = to_torch(batch_np(cfg, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        forward_prefill(cfg, p, batch)
    with pytest.raises(ValueError, match="CUDA tensors"):
        forward_train(cfg, p, batch)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tm.decode_step(cfg, p, init_kv_cache(cfg, 2, 4, torch.float32, "cpu"),
                       batch["tokens"][:, 0], 0)
    with pytest.raises(ValueError, match="kernels must be"):
        forward_prefill(cfg, p, batch, kernels="ref")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_cache(cfg, 1, 4)

