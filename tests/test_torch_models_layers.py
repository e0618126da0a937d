"""The port's model layers held against the JAX package's, in f32.

Every function of ``repro_torch.models.{layers, ssm, moe}`` runs on the
same seeded numpy inputs as its JAX counterpart in ``repro.models`` and
must agree within ``TOL`` (1e-5) relative to the largest reference value:
GQA, a ``q_offset``, a window, ``kv_chunk`` smaller than S, qk-norm, an
``h0`` state, decode with and without the current token's K/V, and the MoE
dispatch with tied router probabilities and dropped tokens (the kept mask
must be equal, not only the outputs).  The route tests check that a layer
with no window calls ``ops.attention_op`` and a windowed one does not, and
that a mamba2 block calls ``ops.ssd_op`` once per batch row.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

pytestmark = pytest.mark.torch

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), err


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_jax():
    rng = _rng(1)
    x, w = _n(rng, 2, 5, 3, 16), _n(rng, 16, scale=0.1)
    close(tl.rms_norm(_t(x), _t(w), 1e-6), jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    pos = np.arange(7, 12)
    close(tl.rope(_t(x), _t(pos), 10_000.0), jl.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    close(tl.rope(_t(x), _t(pos), 1e6), jl.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize(
    "hq,hkv,sq,skv,q_offset,window,kv_chunk",
    [
        (4, 4, 16, 16, 0, None, 16),      # MHA, one chunk
        (4, 2, 16, 16, 0, None, 4),       # GQA, kv_chunk < S
        (6, 2, 8, 24, 16, None, 8),       # q_offset: the last 8 of 24 positions
        (4, 1, 24, 24, 0, 5, 8),          # window, GQA to one KV head
        (4, 2, 12, 12, 0, 1 << 30, 4),    # a global layer's window
    ],
)
def test_chunked_gqa_attention_matches_jax(hq, hkv, sq, skv, q_offset, window, kv_chunk):
    rng = _rng(2)
    q, k, v = _n(rng, 2, sq, hq, 16), _n(rng, 2, skv, hkv, 16), _n(rng, 2, skv, hkv, 16)
    got = tl.chunked_gqa_attention(_t(q), _t(k), _t(v), q_offset=q_offset, window=window,
                                   kv_chunk=kv_chunk)
    want = jl.chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    q_offset=q_offset, window=window, kv_chunk=kv_chunk)
    close(got, want)


def test_score_dtype_bf16_matches_jax():
    """Scores in bf16 on both sides (``set_score_dtype``), within bf16's
    rounding: 2^-7 relative."""
    rng = _rng(3)
    q, k, v = _n(rng, 1, 16, 4, 16), _n(rng, 1, 16, 2, 16), _n(rng, 1, 16, 2, 16)
    tl.set_score_dtype(torch.bfloat16)
    jl.set_score_dtype(jnp.bfloat16)
    try:
        got = tl.chunked_gqa_attention(_t(q), _t(k), _t(v), kv_chunk=8)
        want = jl.chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_chunk=8)
    finally:
        tl.set_score_dtype(torch.float32)
        jl.set_score_dtype(jnp.float32)
    close(got, want, 2.0 ** -7)


def _attn_params(rng, d, hq, hkv, hd, qk_norm):
    p = {
        "wq": _n(rng, d, hq * hd, scale=0.1), "wk": _n(rng, d, hkv * hd, scale=0.1),
        "wv": _n(rng, d, hkv * hd, scale=0.1), "wo": _n(rng, hq * hd, d, scale=0.1),
    }
    if qk_norm:
        p["q_norm"], p["k_norm"] = _n(rng, hd, scale=0.1), _n(rng, hd, scale=0.1)
    return p


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("window", [None, 6])
def test_attention_block_matches_jax(qk_norm, window):
    """Both routes of a layer: no window through ``ops.attention_op`` (the
    plain version on the CPU), a window through the plain chunked path."""
    rng = _rng(4)
    x = _n(rng, 2, 16, 32)
    p = _attn_params(rng, 32, 4, 2, 8, qk_norm)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=10_000.0, qk_norm=qk_norm,
              norm_eps=1e-6, window=window, kv_chunk=8)
    tl.ROUTES.clear()
    got = tl.attention_block(_t(x), {k: _t(a) for k, a in p.items()},
                             positions=torch.arange(16), kernels="eager", **kw)
    assert tl.ROUTES == {("attention_op" if window is None else "windowed"): 1}
    want = jl.attention_block(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()},
                              positions=jnp.arange(16), **kw)
    close(got, want)


def test_attention_route_calls_the_op_only_without_window(monkeypatch):
    """The kernel route folds (B·Hq, S, D) with the KV heads repeated and
    asks the op for ``kernels``; a windowed layer never calls the op; and
    ``kernels="cuda"`` on CPU tensors raises (no fallback)."""
    calls = []
    real = ops.attention_op

    def spy(q, k, v, causal=True, kernels="cuda", **kw):
        calls.append((tuple(q.shape), tuple(k.shape), causal, kernels))
        return real(q, k, v, causal=causal, kernels=kernels, **kw)

    monkeypatch.setattr(ops, "attention_op", spy)
    rng = _rng(5)
    x = _t(_n(rng, 2, 16, 32))
    p = {k: _t(a) for k, a in _attn_params(rng, 32, 4, 2, 8, False).items()}
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1e4, qk_norm=False,
              norm_eps=1e-6, positions=torch.arange(16))
    tl.attention_block(x, p, window=None, kernels="eager", **kw)
    assert calls == [((8, 16, 8), (8, 16, 8), True, "eager")]
    tl.attention_block(x, p, window=4, kernels="eager", **kw)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        tl.attention_block(x, p, window=None, kernels="cuda", **kw)


def test_kernel_attention_blocks_divide_any_sequence():
    """A sequence that is not a power of two (a 256-position prefix plus
    32 tokens) still meets the kernel's block rule, and equals the plain
    chunked attention."""
    rng = _rng(6)
    q, k, v = _n(rng, 1, 288, 4, 8), _n(rng, 1, 288, 2, 8), _n(rng, 1, 288, 2, 8)
    got = tl.kernel_attention(_t(q), _t(k), _t(v), "eager")
    want = jl.chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_chunk=16)
    close(got, want)


def test_set_attention_impl_refuses_ring():
    """``"ring"`` is taken (ring attention came with the port of
    ``distributed/``), but without a sharding context a layer does not take
    the ring, as the JAX package's does not: its output and route stay the
    default's.  An unknown implementation is refused."""
    rng = _rng(6)
    x = _t(_n(rng, 2, 16, 32))
    p = {k: _t(a) for k, a in _attn_params(rng, 32, 4, 2, 8, False).items()}
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1e4, qk_norm=False,
              norm_eps=1e-6, positions=torch.arange(16), window=None, kernels="eager")
    tl.set_attention_impl("xla")
    want = tl.attention_block(x, p, **kw)
    tl.ROUTES.clear()
    tl.set_attention_impl("ring")
    try:
        got = tl.attention_block(x, p, **kw)
    finally:
        tl.set_attention_impl("xla")
    assert tl.ROUTES == {"attention_op": 1}
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tl.set_attention_impl("flash")


def test_swiglu_mlp_matches_jax():
    rng = _rng(7)
    x = _n(rng, 2, 5, 16)
    p = {"w1": _n(rng, 16, 24, scale=0.2), "w3": _n(rng, 16, 24, scale=0.2),
         "w2": _n(rng, 24, 16, scale=0.2)}
    close(tl.swiglu_mlp(_t(x), {k: _t(a) for k, a in p.items()}),
          jl.swiglu_mlp(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()}))


@pytest.mark.parametrize("with_new,window", [(False, None), (True, None), (True, 3)])
def test_decode_attention_matches_jax(with_new, window):
    rng = _rng(8)
    q = _n(rng, 2, 1, 4, 8)
    kc, vc = _n(rng, 2, 2, 10, 8), _n(rng, 2, 2, 10, 8)
    kn, vn = _n(rng, 2, 2, 1, 8), _n(rng, 2, 2, 1, 8)
    extra_t = dict(k_new=_t(kn), v_new=_t(vn)) if with_new else {}
    extra_j = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if with_new else {}
    got = tl.decode_attention(_t(q), _t(kc), _t(vc), 6, window=window, **extra_t)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 6,
                               window=window, **extra_j)
    close(got, want)


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------


def test_causal_conv1d_matches_jax():
    rng = _rng(9)
    x, w, tail = _n(rng, 2, 7, 6), _n(rng, 4, 6, scale=0.3), _n(rng, 2, 3, 6)
    for t_tail, j_tail in ((None, None), (_t(tail), jnp.asarray(tail))):
        y, nt = tssm.causal_conv1d(_t(x), _t(w), tail=t_tail)
        yj, ntj = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), tail=j_tail)
        close(y, yj)
        close(nt, ntj)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_chunked_matches_jax(h0, chunk):
    rng = _rng(10)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = _n(rng, b, s, h, p)
    dt = np.log1p(np.exp(_n(rng, b, s, h))).astype(np.float32)
    a = -np.exp(_n(rng, h, scale=0.5)).astype(np.float32)
    bm, cm = _n(rng, b, s, n), _n(rng, b, s, n)
    st = _n(rng, b, h, p, n) if h0 else None
    y, hT = tssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk,
                             h0=None if st is None else _t(st))
    yj, hTj = jssm.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
                               jnp.asarray(cm), chunk=chunk,
                               h0=None if st is None else jnp.asarray(st))
    close(y, yj)
    close(hT, hTj)


def _mamba_params(rng, d, di, n, h, w=4):
    return {
        "z_proj": _n(rng, d, di, scale=0.1), "x_proj": _n(rng, d, di, scale=0.1),
        "b_proj": _n(rng, d, n, scale=0.1), "c_proj": _n(rng, d, n, scale=0.1),
        "dt_proj": _n(rng, d, h, scale=0.1), "out_proj": _n(rng, di, d, scale=0.1),
        "conv_x": _n(rng, w, di, scale=0.2), "conv_b": _n(rng, w, n, scale=0.2),
        "conv_c": _n(rng, w, n, scale=0.2), "dt_bias": _n(rng, h, scale=0.1),
        "a_log": _n(rng, h, scale=0.1), "d_skip": _n(rng, h, scale=0.5) + 1.0,
    }


MAMBA = dict(d_inner=16, ssm_heads=4, ssm_head_dim=4, ssm_state=8, conv_width=4)


@pytest.mark.parametrize("chunk", [8, 0])
def test_mamba2_block_matches_jax(chunk):
    """The block's scan runs ``ops.ssd_op`` (the plain version here) once
    per batch row; ``chunk=0`` takes ``set_ssd_chunk``'s length, cut to S."""
    rng = _rng(11)
    x = _n(rng, 3, 16, 12)
    p = _mamba_params(rng, 12, 16, 8, 4)
    tl.ROUTES.clear()
    got = tssm.mamba2_block(_t(x), {k: _t(a) for k, a in p.items()}, chunk=chunk,
                            kernels="eager", **MAMBA)
    assert tl.ROUTES == {"ssd_op": 3}
    want = jssm.mamba2_block(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()},
                             chunk=chunk, **MAMBA)
    close(got, want)


def test_set_ssd_chunk_reaches_the_op(monkeypatch):
    seen = []
    real = ops.ssd_op

    def spy(*args, kernels="cuda", chunk=None):
        seen.append((tuple(args[0].shape), kernels, chunk))
        return real(*args, kernels=kernels, chunk=chunk)

    monkeypatch.setattr(ops, "ssd_op", spy)
    rng = _rng(12)
    x = _t(_n(rng, 2, 16, 12))
    p = {k: _t(a) for k, a in _mamba_params(rng, 12, 16, 8, 4).items()}
    tssm.set_ssd_chunk(4)
    try:
        tssm.mamba2_block(x, p, kernels="eager", **MAMBA)
    finally:
        tssm.set_ssd_chunk(256)
    assert seen == [((16, 4, 4), "eager", 4)] * 2
    tssm.mamba2_block(x, p, kernels="eager", **MAMBA)
    assert seen[-1] == ((16, 4, 4), "eager", 16)


def test_mamba2_decode_step_matches_jax():
    rng = _rng(13)
    x = _n(rng, 2, 1, 12)
    p = _mamba_params(rng, 12, 16, 8, 4)
    state = {"h": _n(rng, 2, 4, 4, 8), "conv_x": _n(rng, 2, 3, 16),
             "conv_b": _n(rng, 2, 3, 8), "conv_c": _n(rng, 2, 3, 8)}
    y, st = tssm.mamba2_decode_step(_t(x), {k: _t(a) for k, a in p.items()},
                                    {k: _t(a) for k, a in state.items()}, **MAMBA)
    yj, stj = jssm.mamba2_decode_step(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()},
                                      {k: jnp.asarray(a) for k, a in state.items()}, **MAMBA)
    close(y, yj)
    for k in stj:
        close(st[k], stj[k])


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------


def _jax_route(xg, router, n_experts, top_k, capacity_factor):
    """The JAX block's dispatch decision (``moe.py:40-54``), spelled out."""
    _, gsz, _ = xg.shape
    logits = jnp.einsum("gtd,de->gte", xg, router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, top_k)
    cap = max(1, int(capacity_factor * gsz * top_k / n_experts))
    onehot = jax.nn.one_hot(gate_idx, n_experts, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], gsz * top_k, n_experts)
    pos_in_expert = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.einsum("gte,gte->gt", pos_in_expert, flat).reshape(xg.shape[0], gsz, top_k)
    return gate_idx, pos, pos < cap


@pytest.mark.parametrize("capacity_factor,group_size", [(1.25, 512), (0.5, 8), (4.0, 2)])
def test_moe_block_matches_jax(capacity_factor, group_size):
    """Tied router columns (experts 0 and 1, 4 and 5 route alike), so the
    order of the top-k on ties decides the dispatch; a small capacity drops
    tokens.  The expert ids, queue positions and kept mask must be equal."""
    rng = _rng(14)
    e, k, d, ff = 6, 2, 8, 12
    x = _n(rng, 2, 8, d)
    router = _n(rng, d, e, scale=0.5)
    router[:, 1] = router[:, 0]
    router[:, 5] = router[:, 4]
    p = {"router": router, "w1": _n(rng, e, d, ff, scale=0.2),
         "w3": _n(rng, e, d, ff, scale=0.2), "w2": _n(rng, e, ff, d, scale=0.2)}
    kw = dict(n_experts=e, top_k=k, capacity_factor=capacity_factor)
    gsz = min(group_size, 16)
    xg = x.reshape(-1, gsz, d)
    _, _, idx, pos, keep, _ = tmoe.route_tokens(_t(xg), _t(router), **kw)
    idx_j, pos_j, keep_j = _jax_route(jnp.asarray(xg), jnp.asarray(router), **kw)
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))
    assert np.array_equal(pos.numpy(), np.asarray(pos_j))
    assert np.array_equal(keep.numpy(), np.asarray(keep_j))
    if capacity_factor < 1:
        assert not keep.all()                      # the case drops tokens
    out, aux = tmoe.moe_block(_t(x), {n: _t(a) for n, a in p.items()}, group_size=group_size, **kw)
    out_j, aux_j = jmoe.moe_block(jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()},
                                  group_size=group_size, **kw)
    close(out, out_j)
    close(aux, aux_j)
