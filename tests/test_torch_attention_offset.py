"""The attention's query offset (``q_offset``) on the CPU.

A rank of a ``context`` plan holds query rows [o, o + n) of a causal
self-attention over the whole sequence's keys and runs them at
``q_offset=o`` (``models.layers.on_local_heads``), as the JAX attention's
``chunked_gqa_attention(q_offset=...)`` runs the rows XLA gives each rank.
Here, on seeded numpy inputs: the plain version at an offset is bit for bit
the whole call's rows at the same blocks (f32 and bf16, offsets on and off
the blocks); it matches the JAX Pallas kernel's whole call (interpret
mode), sliced, at the JAX kernel tests' tolerances, and the JAX
``chunked_gqa_attention`` at the same offset within 1e-5 (f32, GQA folded
as the layer folds it); the oracle at an offset agrees with its end-aligned
default where the offset is Skv - Sq; ``KernelAttention``'s gradients at an
offset are the plain version's VJP (its forward swapped for the plain
version, as in ``test_torch_kernel_grad.py``); offsets that run past the
keys or are negative raise ``ValueError``; the roofline charges the kept
scores at the offset (the kernel's forward and, keyed on the offset, the
plain backward).  The CUDA kernels at an offset: the host cases of
``test_torch_kernels.py`` (the SIMT source under g++) and the card test
``test_torch_attention_offset_gpu.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod, ops, ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.models import layers as tl
from repro_torch.roofline.kernel_cost import kernel_work

pytestmark = pytest.mark.torch

B, S, D = 3, 64, 16
BLOCKS = dict(block_q=8, block_kv=16)
# (offset, rows): the first rank's, offsets off the query block (13) and off
# the KV block (40), the last rows
SLICES = [(0, 24), (8, 24), (13, 16), (40, 24), (56, 8)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(dtype, b=B, s=S, d=D, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3)]
    return arrs, [ops.to_tensor(a, DTYPES[dtype], "cpu") for a in arrs]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("off,n", SLICES)
def test_plain_rows_at_an_offset_are_the_whole_calls_rows(dtype, off, n):
    _, (q, k, v) = _qkv(dtype)
    whole = flash_attention_plain(q, k, v, **BLOCKS)
    got = flash_attention_plain(q[:, off : off + n], k, v, q_offset=off, **BLOCKS)
    assert got.dtype == DTYPES[dtype] and got.shape == (B, n, D)
    assert torch.equal(got, whole[:, off : off + n])
    op = ops.attention_op(q[:, off : off + n], k, v, kernels="eager", q_offset=off, **BLOCKS)
    assert torch.equal(op, got)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("off,n", SLICES)
def test_rows_at_an_offset_match_the_jax_kernels_whole_call(dtype, off, n):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention as jax_flash

    arrs, (q, k, v) = _qkv(dtype, seed=1)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    want = jax_flash(*(jnp.asarray(a, jdt) for a in arrs), causal=True, block_q=16,
                     block_kv=16, interpret=True)
    want = np.asarray(want, np.float32)[:, off : off + n]
    tol = 2e-3 if dtype == "f32" else 3e-2
    got = flash_attention_plain(q[:, off : off + n], k, v, q_offset=off, **BLOCKS)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("off,n", SLICES)
def test_layer_rows_at_an_offset_match_jax_chunked_attention(off, n):
    """The kernel route's local attention (GQA: 4 q heads on 2 KV heads,
    folded and repeated as ``layers._local_kernel_attention`` does, blocks
    from each sequence's own length) and the oracle route, at the offset,
    against the JAX ``chunked_gqa_attention(q_offset=off)`` within 1e-5."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as jl

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, n, 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, D)).astype(np.float32) for _ in range(2))
    want = np.asarray(jl.chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               q_offset=off, kv_chunk=16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for kernels in ("eager", "ref"):
        got = tl._local_kernel_attention(tq, tk, tv, kernels, off)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got = tl.chunked_gqa_attention(tq, tk, tv, q_offset=off, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_a_ranks_blocks_divide_its_own_sequences(monkeypatch):
    """S 24 over 3 ranks: the last rank's 8 query rows at offset 16 over 24
    keys take the plan's query block (8) and a KV block of 8, 24's largest
    power of two; one block for both (the plan's 16 for 8 rows) would not
    divide 24.  Bit for bit the whole sequence's rows, whose blocks are 8."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, D)).astype(np.float32))
            for _ in range(2))
    seen, real = [], ops.attention_op

    def spy(*a, **kw):
        seen.append((a[0].shape[1], a[1].shape[1], kw["block_q"], kw["block_kv"], kw["q_offset"]))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "attention_op", spy)
    got = tl._local_kernel_attention(q[:, 16:], k, v, "eager", 16)
    whole = tl._local_kernel_attention(q, k, v, "eager")
    assert seen == [(8, 24, None, 8, 16), (24, 24, 8, 8, 0)]
    assert torch.equal(got, whole[:, 16:])


@pytest.mark.parametrize("off", [0, 13, 40])
def test_oracle_at_an_offset(off):
    """``attention_ref``'s query rows at ``q_offset``: its default is the
    end-aligned diagonal (``Skv - Sq``), and at any offset it matches the
    plain version at that offset within 1e-5 (f32)."""
    _, (q, k, v) = _qkv("f32", seed=4)
    rows = q[:, off : off + 24]
    got = ref.attention_ref(rows, k, v, q_offset=off)
    want = flash_attention_plain(rows, k, v, q_offset=off, **BLOCKS)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    tail = q[:, S - 24 :]
    assert torch.equal(ref.attention_ref(tail, k, v), ref.attention_ref(tail, k, v,
                                                                        q_offset=S - 24))
    assert torch.equal(ops.attention_op(rows, k, v, kernels="ref", q_offset=off), got)


@pytest.fixture
def plain_forward(monkeypatch):
    """``KernelAttention``'s forward entry swapped for the plain version
    (the CUDA kernel does not run here), its calls' offsets noted."""
    offsets = []

    def run(*a, **kw):
        offsets.append(kw["q_offset"])
        return flash_attention_plain(*a, **kw)

    monkeypatch.setattr(fa_mod, "flash_attention", run)
    return offsets


@pytest.mark.parametrize("off,n", [(0, 16), (13, 16), (40, 24)])
def test_kernel_attention_grads_at_an_offset_are_the_plain_versions(off, n, plain_forward):
    _, (q, k, v) = _qkv("f32", seed=5)
    rows = q[:, off : off + n].contiguous()
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal((B, n, D)).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (rows, k, v)]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, cot)

    out, got = grads(lambda *t: ops.attention_op(*t, kernels="cuda", q_offset=off, **BLOCKS))
    want_out, want = grads(lambda *t: flash_attention_plain(*t, q_offset=off, **BLOCKS))
    assert plain_forward == [off]
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_attention_grads_at_the_last_offset_match_jax_oracle(plain_forward):
    """At offset Skv - Sq the rows' diagonal is the JAX oracle's end-aligned
    one: the Function's gradients against ``jax.vjp`` of it at the kernel
    gradient tests' tolerance (1e-5 of each gradient's largest value)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.ref import attention_ref as jax_ref

    _, (q, k, v) = _qkv("f32", seed=7)
    rows = q[:, S - 16 :].contiguous()
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal((B, 16, D)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (rows, k, v)]
    out = ops.attention_op(*leaves, kernels="cuda", q_offset=S - 16, **BLOCKS)
    got = torch.autograd.grad(out, leaves, cot)
    _, vjp = jax.vjp(lambda *t: jax_ref(*t, causal=True),
                     *(jax.numpy.asarray(t.numpy()) for t in (rows, k, v)))
    for g, w in zip(got, vjp(jax.numpy.asarray(cot.numpy()))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("fn", [flash_attention, flash_attention_plain, ops.attention_op])
def test_offsets_past_the_keys_or_negative_raise(fn):
    _, (q, k, v) = _qkv("f32")
    with pytest.raises(ValueError, match="q_offset"):
        fn(q[:, :24], k, v, q_offset=41)
    with pytest.raises(ValueError, match="q_offset"):
        fn(q[:, :24], k, v, q_offset=-1)
    # no offset keeps the JAX kernel's causal contract, Sq == Skv
    with pytest.raises(ValueError, match="Sq == Skv"):
        fn(q[:, :24], k, v)


def test_kernel_work_counts_the_kept_scores_at_the_offset():
    """qwen3-14b's shard of ``train_4k`` on 16 model ranks: 40 heads of 256
    rows; the last rank (offset 3840) keeps 256·3840 + 256·257/2 scores a
    head, 12.1% of the whole sequence's 4096·4097/2, rank 0 0.4%; the 16
    ranks' scores sum to the whole call's."""
    def work(sq, off):
        args = [torch.empty((40, n, 128), dtype=torch.bfloat16, device="meta")
                for n in (sq, 4096, 4096)]
        return kernel_work("flash_attention", args, torch.empty_like(args[0]), q_offset=off)[1]

    whole = work(4096, 0)
    assert whole == 4 * 128 * 40 * (4096 * 4097 // 2)
    last = work(256, 3840)
    assert last == 4 * 128 * 40 * (256 * 3840 + 256 * 257 // 2)
    assert round(last / whole, 3) == 0.121 and round(work(256, 0) / whole, 3) == 0.004
    assert sum(work(256, 256 * r) for r in range(16)) == whole


def test_dry_run_charges_the_offset():
    """On meta tensors (the dry run): the kernel's forward is charged
    ``kernel_work`` at the offset, and its plain backward is traced once
    for each offset (a key of its own), the last rows' dearer than the
    first's."""
    from repro_torch.roofline.dispatch_cost import DispatchCostMode, _tracing_plain_vjps

    def meta(n):
        return torch.empty((4, n, 32), dtype=torch.float32, device="meta", requires_grad=True)

    mode = DispatchCostMode()
    flops = {}
    with mode, _tracing_plain_vjps(mode):
        for off in (0, 48, 48):
            q, k, v = meta(16), meta(64), meta(64)
            before = mode.cost.flops.get("f32", 0.0)
            out = ops.attention_op(q, k, v, kernels="cuda", q_offset=off, **BLOCKS)
            fwd = mode.cost.flops.get("f32", 0.0) - before
            torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
            flops[off] = (fwd, mode.cost.flops["f32"] - before - fwd)
    for off, (fwd, _) in flops.items():
        want = kernel_work("flash_attention", (q, k, v), out, q_offset=off)[1]
        assert fwd == want
    assert flops[48][1] > flops[0][1] > 0
    offsets = sorted(dict(key[-1])["q_offset"] for key in mode._vjps)
    assert offsets == [0, 48]
    assert mode.cost.kernels == {"flash_attention": 3}
