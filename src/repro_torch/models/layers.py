"""Transformer building blocks: RMSNorm, RoPE, chunked GQA attention, MLP,
decode attention — the port of the JAX package's ``models/layers.py``.

``chunked_gqa_attention`` is the plain blockwise running-softmax attention
(only one KV chunk of scores live at a time), with the JAX function's
causal mask, window and f32 statistics.  ``attention_block`` routes by the
layer's window, which the model decides from its configuration: a layer
with no window runs the hand-written attention kernel through
``kernels.ops.attention_op`` (batch and heads folded, the KV heads repeated
to the query heads); a windowed layer runs ``chunked_gqa_attention``, as
the kernel has no window.  Each routed call is counted in ``ROUTES``.

The sharding hints (``distributed.context.hint``) sit at the JAX module's
sites.  Under a sharding context with DTensor operands both routes first
redistribute q, k and v to a layout where each rank's attention is
independent (batch over the data axes, heads over ``model`` where they
divide it, else a ``context`` plan's query rows over ``model`` at their
offset; keys and values whole along the sequence), run on the local shards
and rewrap the result (``on_local_heads``).  ``set_attention_impl("ring")``
sends a ``context``-strategy plan's attention to ``distributed.ring_attention``
under the JAX module's conditions.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.distributed import context as _ctx
from repro_torch.distributed.context import (
    batch_rows, from_local_rows, grad_whole_along, hint, local_rows, max_over, seq_whole,
    sum_over, whole_along,
)
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.distributed.sharding import P, dp_axes, placements
from repro_torch.kernels import ops

NEG_INF = -1e30

# attention score precision of the chunked path: f32 by default; bf16
# halves the score traffic (the running max and sums stay f32)
_SCORE_DTYPE = torch.float32

# calls by route since the last ROUTES.clear(): "attention_op" (the kernel
# route), "windowed" (chunked_gqa_attention with a window), "ssd_op" (one
# per batch row of a mamba2 block)
ROUTES: Counter = Counter()


def set_score_dtype(dtype: torch.dtype) -> None:
    global _SCORE_DTYPE
    _SCORE_DTYPE = dtype


_ATTN_IMPL = "xla"


def set_attention_impl(impl: str) -> None:
    """``"xla"`` (the JAX package's name for the default path) or
    ``"ring"``: ring attention over the sequence for a plan whose
    attention strategy is ``context`` (``distributed.ring_attention``)."""
    global _ATTN_IMPL
    if impl not in ("xla", "ring"):
        raise ValueError(f"unknown attention impl {impl!r}; the port has 'xla' and 'ring'")
    _ATTN_IMPL = impl


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    half = x.shape[-1] // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions[..., None].float() * freqs                      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                              # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _heads_divide(t: torch.Tensor, dim: int, heads: int) -> torch.Tensor:
    """``t``, gathered along ``dim`` where it is a DTensor split along it
    over a number of ranks that ``heads`` does not divide: DTensor cannot
    unflatten such a dim into (heads, ...) (tinyllama's 4 KV heads over 16
    model ranks), nor flatten a dim of ``heads`` so split (musicgen's 24),
    which XLA reshards for the JAX package."""
    if isinstance(t, DTensor):
        dim %= t.ndim
        ranks = math.prod(t.device_mesh.size(i) for i, pl in enumerate(t.placements)
                          if pl.is_shard(dim))
        if heads % ranks:
            return whole_along(t, dim)
    return t


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads·head_dim) as (B, S, heads, head_dim), gathered first
    where the heads do not divide its split (``_heads_divide``)."""
    t = _heads_divide(t, -1, heads)
    return t.reshape(t.shape[0], t.shape[1], heads, head_dim)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) as (B, S, H·D), ``split_heads``' inverse.  Under a
    sharding context whose ``model`` axis H does not divide, the gradient
    coming back from the product that follows (split along H·D over
    ``model``) is gathered along H·D before this view's backward unflattens
    it, for the same reason as ``split_heads``."""
    b, s, h, d = t.shape
    flat = t.reshape(b, s, h * d)
    c = _ctx.current()
    if c is not None and h % c.plan.axes["model"]:
        flat = grad_whole_along(flat, 2)
    return flat


def chunked_gqa_attention(
    q: torch.Tensor,            # (B, Sq, Hq, D)
    k: torch.Tensor,            # (B, Skv, Hkv, D)
    v: torch.Tensor,            # (B, Skv, Hkv, D)
    *,
    q_offset: int = 0,          # global position of q[0]
    window: Optional[int] = None,   # attend to (pos - window, pos]
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Causal blockwise attention with running softmax over KV chunks;
    O(Sq * kv_chunk) score memory.  GQA by head grouping.  ``window`` of
    None means full causal attention."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    scale = 1.0 / (d ** 0.5)
    n_chunks = max(1, skv // kv_chunk)
    assert skv % n_chunks == 0
    c = skv // n_chunks
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)                 # (Sq,)

    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kc = k[:, ci * c : (ci + 1) * c].float()
        vc = v[:, ci * c : (ci + 1) * c]
        s = torch.einsum("bshgd,bchd->bshgc", qg, kc).to(_SCORE_DTYPE)
        s = s * torch.tensor(scale, dtype=_SCORE_DTYPE, device=dev)     # (B,Sq,Hkv,G,c)
        k_pos = ci * c + torch.arange(c, device=dev)
        mask = k_pos[None, :] <= q_pos[:, None]                     # (Sq, c)
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.tensor(NEG_INF, dtype=s.dtype, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        p = torch.exp(s - m_new[..., None].to(s.dtype))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, dtype=torch.float32)
        acc = acc * alpha[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(vc.dtype).float(), vc.float()
        )
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _kernel_blocks(s: int) -> Optional[int]:
    """The attention kernel's blocks for a sequence of ``s``: its own plan
    where ``s`` is a power of two, else the largest power of two dividing
    ``s`` (the plan's blocks must divide the sequence)."""
    return None if s & (s - 1) == 0 else s & -s


def _local_kernel_attention(q, k, v, kernels: str, q_offset: int = 0) -> torch.Tensor:
    """(B, Sq, Hq, D) queries, their row r at position ``q_offset + r``,
    over (B, Skv, Hkv, D) keys and values through ``ops.attention_op``,
    each sequence with its own blocks."""
    b, sq, hq, d = q.shape
    g = hq // k.shape[2]

    def fold(t):
        return t.transpose(1, 2).reshape(b * hq, t.shape[1], d).contiguous()

    o = ops.attention_op(
        fold(q), fold(k.repeat_interleave(g, dim=2)), fold(v.repeat_interleave(g, dim=2)),
        causal=True, kernels=kernels, block_q=_kernel_blocks(sq),
        block_kv=_kernel_blocks(k.shape[1]), q_offset=q_offset,
    )
    return o.reshape(b, hq, sq, d).transpose(1, 2)


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, q_offset)``, a causal attention of (B, Sq, Hq, D)
    queries, row r at position ``q_offset + r``, over (B, S, Hkv, D) keys
    and values, on each rank's shards.

    DTensor operands under a sharding context are first redistributed so
    that each rank's work is independent: the batch over the data axes
    where it divides them, the q heads over ``model`` where they divide it
    (the KV heads too where they divide it; else each rank takes the KV
    heads of its own q heads), and K and V whole along the sequence.  A
    ``context`` plan's q arrives split along S over ``model``; it stays so,
    and each model rank runs only its own query rows at their offset (the
    JAX route's ``q_offset``, on the rows XLA gives each rank), its output
    split the same way.  Other q is whole along S (offset 0).  Where K and
    V are whole on the model ranks that split the q heads or the query
    rows, a rank's gradient of K and V is its part of a sum over those
    ranks.  Plain tensors go to ``fn`` as they are, at offset 0."""
    c = _ctx.current()
    if c is None or not isinstance(q, DTensor):
        return fn(q, k, v, 0)
    b, _, hq, _ = q.shape
    hkv = k.shape[2]
    msize = c.plan.axes["model"]
    lead = c.plan.batch_spec("q", (b,))[0]
    heads = hq % msize == 0
    m = list(c.plan.axes).index("model")
    rows = c.plan.attn_strategy == "context" and q.placements[m].is_shard(1)
    q_pl = placements(P(lead, "model" if rows else None, "model" if heads else None, None),
                      c.mesh)
    kv_pl = placements(P(lead, None, "model" if heads and hkv % msize == 0 else None, None),
                       c.mesh)
    # K and V whole on the model ranks that split the q heads or rows: each
    # rank's gradient of K and V is its own heads' or rows' part of a sum
    kv_grad = [Partial() if i == m and (rows or heads and hkv % msize) else p
               for i, p in enumerate(kv_pl)]
    offset = compute_local_shape_and_global_offset(q.shape, c.mesh, q_pl)[1][1] if rows else 0
    ql = q.redistribute(c.mesh, q_pl).to_local()
    kl = k.redistribute(c.mesh, kv_pl).to_local(grad_placements=kv_grad)
    vl = v.redistribute(c.mesh, kv_pl).to_local(grad_placements=kv_grad)
    if heads and hkv % msize:
        # the KV head of each local q head (head // g), not the first ones
        hq_loc = ql.shape[2]
        first = c.mesh.get_local_rank("model") * hq_loc
        idx = (first + torch.arange(hq_loc, device=ql.device)) // (hq // hkv)
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    return DTensor.from_local(fn(ql, kl, vl, offset), c.mesh, q_pl, run_check=False)


def kernel_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernels: str
) -> torch.Tensor:
    """Causal attention of (B, S, Hq, D) queries over (B, S, Hkv, D) keys
    and values through the hand-written kernel: batch and heads folded to
    (B·Hq, S, D), each KV head repeated for its query group; DTensor
    operands on each rank's shards (``on_local_heads``)."""
    o = on_local_heads(lambda ql, kl, vl, off: _local_kernel_attention(ql, kl, vl, kernels, off),
                       q, k, v)
    ROUTES["attention_op"] += 1
    return o


def attention_block(
    x: torch.Tensor,                 # (B, S, D)
    p: dict,                         # attn params
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    qk_norm: bool,
    norm_eps: float,
    positions: torch.Tensor,         # (S,)
    window: Optional[int] = None,
    kv_chunk: int = 512,
    kernels: str = "cuda",
) -> torch.Tensor:
    """Self-attention of a layer.  ``window=None`` (a layer with no window)
    runs the attention kernel through ``ops.attention_op(kernels=...)``;
    a window runs the plain ``chunked_gqa_attention``."""
    b, s, _ = x.shape
    x = seq_whole(x)
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k = split_heads(x @ p["wk"], n_kv_heads, head_dim)
    v = split_heads(x @ p["wv"], n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    q = hint(q, "q_heads")
    c = _ctx.current()
    if (
        _ATTN_IMPL == "ring"
        and c is not None
        and c.plan.attn_strategy == "context"
        and s % c.plan.axes["model"] == 0
        and b % max(1, _dp_size(c.plan)) == 0
    ):
        o = ring_attention(q, k, v, c.mesh, axis="model", dp=dp_axes(c.mesh), window=window)
        ROUTES["ring"] += 1
        o = hint(o, "q_heads")
        return merge_heads(seq_whole(o)) @ p["wo"]
    k = hint(k, "kv_heads")
    v = hint(v, "kv_heads")
    if window is None:
        o = kernel_attention(q, k, v, kernels)
    else:
        o = on_local_heads(lambda ql, kl, vl, off: chunked_gqa_attention(
            ql, kl, vl, q_offset=off, window=window, kv_chunk=min(kv_chunk, s)), q, k, v)
        ROUTES["windowed"] += 1
    o = hint(o, "q_heads")
    return merge_heads(seq_whole(o)) @ p["wo"]


def _dp_size(plan) -> int:
    n = 1
    for a in dp_axes(plan.mesh):
        n *= plan.axes[a]
    return n


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    x = seq_whole(x)
    h = hint(F.silu(x @ p["w1"]) * (x @ p["w3"]), "mlp_hidden")
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# decode-time attention against a KV cache
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,          # (B, 1, Hq, D)
    k_cache: torch.Tensor,    # (B, Hkv, Smax, D) — holds positions < pos
    v_cache: torch.Tensor,    # (B, Hkv, Smax, D)
    pos: int,                 # index of the *current* token
    *,
    window: Optional[int] = None,
    k_new: Optional[torch.Tensor] = None,   # (B, Hkv, 1, D): the current
    v_new: Optional[torch.Tensor] = None,   # token's K/V, not yet in the cache
) -> torch.Tensor:
    """One query token against the cache, (B, H, S, D) layout; the current
    token's own term is merged by explicit max/sum algebra when its K/V are
    passed apart from the cache (the cache is written after all layers).

    A DTensor cache runs on each rank's own rows of the batch and its own
    positions of the cache (flash-decoding): the token's query, K and V are
    taken to the cache's batch layout, whole elsewhere (one token), and
    ``_decode_local`` reduces the softmax's max, its sum of ``exp`` and the
    weighted sum of V over the mesh dims that split the positions
    (``model``) before they meet the token's own term.  DTensor's rules
    would take a batch split over two mesh dims, (pod, data), to the
    partial layout of those sums, which torch 2.11 refuses.  The output is
    laid out as the cache's batch, whole on every other mesh dim."""
    if not isinstance(k_cache, DTensor):
        return _decode_local(q, k_cache, v_cache, pos, window, k_new, v_new)
    mesh = k_cache.device_mesh
    rows = batch_rows(k_cache)
    sdims = [i for i, p in enumerate(k_cache.placements) if p.is_shard(2)]
    _, offset = compute_local_shape_and_global_offset(k_cache.shape, mesh, k_cache.placements)
    kn, vn = (None if t is None else local_rows(t, mesh, rows) for t in (k_new, v_new))
    o = _decode_local(local_rows(q, mesh, rows), k_cache.to_local(), v_cache.to_local(), pos,
                      window, kn, vn, mesh, sdims, offset[2])
    b, _, hq, d = q.shape
    return from_local_rows(o, mesh, rows, (b, 1, hq * d))


def _decode_local(q, kc, vc, pos, window, k_new, v_new, mesh=None, sdims=(), start=0):
    """``decode_attention`` on local tensors whose cache holds the positions
    ``start ..`` of the sequence; the statistics are reduced over ``mesh``'s
    dims ``sdims`` (none: the whole cache is here)."""
    b, _, hq, d = q.shape
    hkv, sl = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, kc.float()) * scale        # (B,Hkv,G,S)
    k_pos = start + torch.arange(sl, device=kc.device)
    mask = k_pos < pos if k_new is not None else k_pos <= pos
    if window is not None:
        mask = mask & (pos - k_pos < window)
    s = torch.where(mask[None, None, None, :], s, torch.tensor(NEG_INF, device=kc.device))
    m = max_over(s.amax(dim=-1, keepdim=True), mesh, sdims)
    if k_new is not None:
        s_self = torch.einsum("bhgd,bhsd->bhgs", qg, k_new.float()) * scale   # (B,Hkv,G,1)
        m = torch.maximum(m, s_self)
    p = torch.exp(s - m)
    denom = sum_over(p.sum(dim=-1, keepdim=True), mesh, sdims)
    acc = sum_over(torch.einsum("bhgs,bhsd->bhgd", p.to(vc.dtype).float(), vc.float()),
                   mesh, sdims)
    if k_new is not None:
        p_self = torch.exp(s_self - m)
        denom = denom + p_self
        acc = acc + p_self * v_new.float()
    return (acc / denom).reshape(b, 1, hq * d).to(q.dtype)


__all__ = [
    "NEG_INF",
    "ROUTES",
    "attention_block",
    "chunked_gqa_attention",
    "decode_attention",
    "kernel_attention",
    "merge_heads",
    "on_local_heads",
    "rms_norm",
    "rope",
    "set_attention_impl",
    "set_score_dtype",
    "split_heads",
    "swiglu_mlp",
]
