"""The model package on the card (``gpu``; skipped where no CUDA device is
visible): reduced models whose prefill runs through the hand-written
kernels, each held against the same weights with ``kernels="eager"`` and
its launches counted.  No JAX import: a card test runs where only
PyTorch is installed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import KERNELS
from repro_torch.models import forward_prefill, init_params

pytestmark = [pytest.mark.torch, pytest.mark.gpu]

SSD = ("ssd_gram", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the model's kernels run only there)")


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).cuda()}


def test_tinyllama_prefill_on_card_matches_eager():
    """Reduced tinyllama in bf16 at head dim 64: the kernel route (one
    ``flash_attention_wgmma`` a layer) within 5e-2 of the largest logit of
    the eager route, with the same argmax."""
    _card()
    cfg = get_config("tinyllama_1_1b").reduced(n_layers=3, head_dim=64, n_heads=4)
    p = init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda")
    batch = _tokens(cfg, 1, 256)
    before = KERNELS["flash_attention_wgmma"].launches
    got = forward_prefill(cfg, p, batch)
    assert KERNELS["flash_attention_wgmma"].launches - before == 3
    want = forward_prefill(cfg, p, batch, kernels="eager")
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_mamba2_prefill_on_card_matches_eager():
    """Reduced mamba2 in f32: one launch of each of the four SSD kernels a
    layer and batch row, within 1e-3 of the largest logit of the eager
    route."""
    _card()
    cfg = get_config("mamba2_2_7b").reduced(n_layers=3)
    p = init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.float32, "cuda")
    batch = _tokens(cfg, 2, 64)
    before = {n: KERNELS[n].launches for n in SSD}
    got = forward_prefill(cfg, p, batch)
    assert {n: KERNELS[n].launches - before[n] for n in SSD} == dict.fromkeys(SSD, 6)
    want = forward_prefill(cfg, p, batch, kernels="eager")
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_kernel_route_refuses_a_gradient():
    """A direct kernel call records no backward: given a tensor that needs
    a gradient it raises, naming the differentiable route; a train forward
    on the kernel route goes through that route (``ops``) and
    differentiates, as the eager route does."""
    _card()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import forward_train

    q = torch.zeros((1, 64, 64), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="ops.attention_op"):
        flash_attention(q, q, q)
    cfg = get_config("tinyllama_1_1b").reduced()
    p = init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.float32, "cuda")
    p["layers"]["attn"]["wq"].requires_grad_(True)
    batch = _tokens(cfg, 2, 32)
    batch["labels"] = batch["tokens"]
    for kernels in ("cuda", "eager"):
        p["layers"]["attn"]["wq"].grad = None
        loss, _ = forward_train(cfg, p, batch, remat=False, kernels=kernels)
        loss.backward()
        assert bool(torch.isfinite(p["layers"]["attn"]["wq"].grad).all())


@pytest.mark.parametrize("arch,kernels,rows", [
    ("tinyllama_1_1b", ("flash_attention",), 1), ("mamba2_2_7b", SSD, 2),
])
@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_grads_on_card_match_eager(arch, kernels, rows, remat):
    """Reduced models in f32: ``forward_train``'s loss within 1e-5 and
    every parameter's gradient within 1e-4 of its leaf's largest, on the
    kernel route against ``kernels="eager"``; each kernel launched once a
    layer (and batch row, for the SSD scan) in the forward and once more in
    each layer's recompute under remat, and no other kernel."""
    _card()
    from repro_torch.models.model import _leaves
    from repro_torch.train.train_step import microbatch_grads

    cfg = get_config(arch).reduced(n_layers=2)
    p = init_params(cfg, torch.Generator("cuda").manual_seed(0), torch.float32, "cuda")
    batch = _tokens(cfg, rows, 129)
    batch["labels"] = batch["tokens"][:, 1:]
    batch["tokens"] = batch["tokens"][:, :-1]
    for k in KERNELS.values():
        k.launches = 0
    loss, grads = microbatch_grads(cfg, p, batch, remat=remat)
    torch.cuda.synchronize()
    launched = {n: k.launches for n, k in KERNELS.items() if k.launches}
    assert launched == dict.fromkeys(kernels, cfg.n_layers * rows * (2 if remat else 1))
    want_loss, want = microbatch_grads(cfg, p, batch, remat=remat, kernels="eager")
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for (path, _), g, w in zip(_leaves(p), grads, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-30), (path, err)
