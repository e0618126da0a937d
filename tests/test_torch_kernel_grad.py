"""Gradients through the hand-written kernels (``repro_torch.kernels.grad``)
on the CPU.  The CUDA kernels do not run here, so the Functions' forward
entries (``flash_attention.flash_attention``, ``ssd.ssd_scan``) are swapped
for their plain versions; the Functions, the routing of ``ops`` and the
model's remat then run as on the card.  The backward (the plain version's
gradient) is held bit for bit against native autograd of the plain version,
and against ``jax.vjp`` of the JAX oracles at the kernels' tolerances."""

from __future__ import annotations

import types
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _cuda, flash_attention as fa_mod, ops, ssd as ssd_mod
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
from repro_torch.models import init_params, model as model_mod

pytestmark = pytest.mark.torch

# f32 tolerances of the kernels, relative to the largest reference value
ATTN_TOL, SSD_TOL = 1e-5, 1e-4


@pytest.fixture
def calls(monkeypatch):
    """The Functions' forward entries swapped for the plain versions, each
    call counted by name."""
    n = Counter()

    def counted(name, fn):
        def run(*a, **kw):
            n[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(fa_mod, "flash_attention", counted("attention", flash_attention_plain))
    monkeypatch.setattr(ssd_mod, "ssd_scan", counted("ssd", ssd_scan_plain))
    return n


def _attention_inputs(bh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32))
            for _ in range(4)]


def _ssd_inputs(s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal((s, h, p)),
        np.abs(rng.standard_normal((s, h))) * 0.1 + 0.01,
        -np.abs(rng.standard_normal(h)) - 0.1,
        rng.standard_normal((s, n)),
        rng.standard_normal((s, n)),
        rng.standard_normal((s, h, p)),                      # the cotangent
    ]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


def _grads(fn, inputs, cot):
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves, cot)


# GQA folded: (batch x heads, S, D); blocks that divide S, and the plan's
@pytest.mark.parametrize("bh,s,d,causal,blk", [
    (6, 64, 16, True, 16), (4, 128, 32, True, None), (3, 64, 8, False, 32),
])
def test_attention_grad_is_the_plain_versions(bh, s, d, causal, blk, calls):
    q, k, v, cot = _attention_inputs(bh, s, d)
    kw = dict(causal=causal, block_q=blk, block_kv=blk)
    out, got = _grads(lambda *t: ops.attention_op(*t, kernels="cuda", **kw), (q, k, v), cot)
    want_out, want = _grads(lambda *t: flash_attention_plain(*t, **kw), (q, k, v), cot)
    assert calls["attention"] == 1
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("s,h,p,n,chunk", [(64, 2, 8, 16, 16), (128, 4, 16, 32, 32), (32, 1, 4, 8, None)])
def test_ssd_grad_is_the_plain_versions(s, h, p, n, chunk, calls):
    *ins, cot = _ssd_inputs(s, h, p, n)
    out, got = _grads(lambda *t: ops.ssd_op(*t, kernels="cuda", chunk=chunk), ins, cot)
    want_out, want = _grads(lambda *t: ssd_scan_plain(*t, chunk=chunk), ins, cot)
    assert calls["ssd"] == 1
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_grad_reaches_the_callers_dtypes(calls):
    """The kernel reads dt, a, b and c as f32: their gradients come back
    through that cast, in the caller's dtypes (f64 here), x's in bf16; an
    input that needs no gradient gets none."""
    x, dt, a, b, c, cot = _ssd_inputs(64, 2, 8, 16)
    x = x.to(torch.bfloat16).requires_grad_()
    dt, b = dt.double().requires_grad_(), b.double().requires_grad_()
    y = ops.ssd_op(x, dt, a, b, c.double(), kernels="cuda", chunk=16)
    gx, gdt, gb = torch.autograd.grad(y, (x, dt, b), cot.to(torch.bfloat16))
    assert (gx.dtype, gdt.dtype, gb.dtype) == (torch.bfloat16, torch.float64, torch.float64)
    ref = [t.detach().clone().requires_grad_() for t in (x, dt, b)]
    want = torch.autograd.grad(ssd_scan_plain(ref[0], ref[1], a, ref[2], c.double(), chunk=16),
                               ref, cot.to(torch.bfloat16))
    for g, w in zip((gx, gdt, gb), want):
        assert torch.equal(g, w)


def test_attention_grad_matches_jax_oracle(calls):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import attention_ref

    q, k, v, cot = _attention_inputs(8, 64, 16, seed=1)     # (B 2 x H 4, S, D)
    _, got = _grads(lambda *t: ops.attention_op(*t, kernels="cuda", block_q=16, block_kv=32),
                    (q, k, v), cot)
    _, vjp = jax.vjp(lambda *t: attention_ref(*t, causal=True),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(cot.numpy()))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATTN_TOL * np.abs(w).max())


def test_ssd_grad_matches_jax_oracle(calls):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import ssd_ref

    *ins, cot = _ssd_inputs(64, 2, 8, 16, seed=2)
    _, got = _grads(lambda *t: ops.ssd_op(*t, kernels="cuda", chunk=16), ins, cot)
    _, vjp = jax.vjp(ssd_ref, *(jnp.asarray(t.numpy()) for t in ins))
    for g, w in zip(got, vjp(jnp.asarray(cot.numpy()))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=SSD_TOL * np.abs(w).max())


@pytest.mark.parametrize("kernels", ["cuda", "eager"])
def test_ssd_grad_is_finite_where_the_decay_overflows(kernels, calls):
    """mamba2's decay at init (a = -exp(0) = -1, dt = softplus(0) = log 2) over a
    chunk of 256 puts the exponent above the diagonal past f32's range
    (0.69 x 255 > 88.7): the gradient stays finite on both routes and
    equals ``jax.vjp`` of the JAX oracle, a sequential scan."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.kernels.ref import ssd_ref

    x, _, _, b, c, cot = _ssd_inputs(256, 2, 4, 8, seed=3)
    dt = torch.full((256, 2), float(np.log(2.0)), dtype=torch.float32)
    a = torch.full((2,), -1.0)
    _, got = _grads(lambda *t: ops.ssd_op(*t, kernels=kernels, chunk=256), (x, dt, a, b, c), cot)
    _, vjp = jax.vjp(ssd_ref, *(jnp.asarray(t.numpy()) for t in (x, dt, a, b, c)))
    for g, w in zip(got, vjp(jnp.asarray(cot.numpy()))):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=SSD_TOL * np.abs(w).max())


def test_direct_kernel_calls_still_refuse_a_gradient():
    """The CUDA entries record nothing for autograd: a tensor that needs a
    gradient raises, and the message names the differentiable route.  On
    the CPU the device check refuses first; the guard itself is read
    through stand-ins of CUDA tensors."""
    q = torch.zeros((1, 16, 8), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q)
    x, dt, a, b, c, _ = _ssd_inputs(16, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(x.requires_grad_(), dt, a, b, c)
    fake = types.SimpleNamespace(device=torch.device("cuda"), requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"ops\.attention_op / kernels\.ops\.ssd_op"):
        _cuda.require_cuda("flash_attention", fake)
    fake.requires_grad = False
    assert _cuda.require_cuda("flash_attention", fake) == torch.device("cuda")


def test_cuda_route_without_grad_calls_the_kernel(calls, monkeypatch):
    """Without a gradient to record the op calls the CUDA entry itself,
    which refuses CPU tensors (no plain version in its place)."""
    q, k, v, _ = _attention_inputs(2, 32, 8)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.attention_op(q.requires_grad_(), k, v, kernels="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_op(*_ssd_inputs(16, 1, 4, 8)[:5], kernels="cuda")
    assert not calls
    assert not _cuda.needs_grad(q.detach(), k)


@pytest.mark.parametrize("arch,kernel,per_layer", [
    ("tinyllama_1_1b", "attention", 1), ("mamba2_2_7b", "ssd", 2),
])
@pytest.mark.parametrize("remat", [True, False])
def test_forward_train_on_the_kernel_route(arch, kernel, per_layer, remat, calls, monkeypatch):
    """``forward_train(kernels="cuda")``'s loss and every parameter's
    gradient equal the eager route's bit for bit when the kernels' forward
    is the plain version; the forward entry runs once a layer (and batch
    row, for the SSD scan), twice under remat (the layer's recompute)."""
    monkeypatch.setattr(model_mod, "_check_kernels", lambda kernels, t: None)
    cfg = get_config(arch).reduced(n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (per_layer, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(kernels):
        p = model_mod._map(lambda t: t.clone().requires_grad_(), params)
        loss, _ = model_mod.forward_train(cfg, p, batch, kv_chunk=16, remat=remat,
                                          kernels=kernels)
        leaves = [t for _, t in model_mod._leaves(p)]
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

    loss, got = run("cuda")
    assert calls[kernel] == cfg.n_layers * per_layer * (2 if remat else 1)
    want_loss, want = run("eager")
    assert torch.equal(loss, want_loss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
