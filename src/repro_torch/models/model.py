"""Unified LM: init / train-forward / prefill / decode for all ten archs —
the port of the JAX package's ``models/model.py``.

The parameter tree is the JAX package's: nested dicts of tensors with the
layers stacked on a leading ``L`` axis, so every leaf has its counterpart
(``params_from_jax`` carries a JAX tree over).  Families:

  * dense / vlm / audio — GQA transformer (RoPE, optional qk-norm, optional
    sliding window with periodic global layers); vlm/audio take a prefix of
    precomputed patch/frame embeddings (the stubbed modality frontend).
  * moe   — attention + grouped top-k expert MLPs (+ always-on shared experts).
  * ssm   — Mamba2 (SSD) mixer stack, attention-free.
  * hybrid — Mamba2 stack with one weight-shared attention block applied
    every ``shared_attn_every`` layers (Zamba2).

``forward_train``, ``forward_prefill`` and ``decode_step`` take
``kernels="cuda" | "eager"`` (default ``"cuda"``), the contract of
``compile_pipeline`` and ``kernels.ops``: ``"cuda"`` needs CUDA tensors
and raises on others (meta tensors give shapes only, through the kernels'
fake implementations: the dry run's); nothing falls back.  The route is
fixed by the configuration: train and prefill attention of every layer
with no window (``_layer_window``) runs the hand-written attention
kernel, windowed layers the plain ``chunked_gqa_attention``, and every
mamba2 block the hand-written SSD kernels (``ops.ssd_op`` per batch
row); decode runs the plain ``decode_attention`` and
``mamba2_decode_step``, and projections, expert products and logits
stay ``torch.matmul`` / ``einsum``, as the JAX model computes them
outside any Pallas kernel.  ``layers.ROUTES`` counts
the routed calls.  ``forward_train`` is differentiable on both routes: on
the kernel route ``ops.attention_op`` / ``ops.ssd_op`` launch the kernel in
the forward and take the plain version's gradient in the backward
(``kernels.grad``); ``kernels="eager"`` differentiates natively.

Sharded runs: with DTensor parameters and batch (``distributed.sharding``)
under a ``distributed.context.sharding_context``, the same functions run
through DTensor's sharding propagation with the JAX model's hints at its
sites; the kernels run on each rank's local shards (``layers``, ``ssm``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.distributed.context import (
    batch_rows, from_local_rows, hint, local_rows, max_over, seq_whole, sum_over, whole_along,
)
from repro_torch.distributed.sharding import write_region
from repro_torch.kernels.ops import to_tensor

from .config import ModelConfig
from .layers import attention_block, decode_attention, rms_norm, rope, split_heads, swiglu_mlp
from .moe import moe_block
from .ssm import mamba2_block, mamba2_decode_step

PREFIX_LEN = 256   # stubbed modality frontends contribute this many positions

KERNEL_CHOICES = ("cuda", "eager")

Params = Dict[str, object]


def _resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is visible; pass device='cpu' "
            "(or 'meta' to build shapes only)"
        )
    return dev


def _check_kernels(kernels: str, t: torch.Tensor) -> None:
    if kernels not in KERNEL_CHOICES:
        raise ValueError(f"kernels must be one of {KERNEL_CHOICES}: {kernels!r}")
    if kernels == "cuda" and t.device.type not in ("cuda", "meta"):
        raise ValueError(
            f"kernels='cuda' needs CUDA tensors (or meta tensors, which give shapes "
            f"only), got {t.device}; use kernels='eager' for the plain version"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """The JAX package's tree and distributions (normal · 0.02, convs · 0.2,
    zero norms and biases, ones for ``d_skip``), drawn in f32 from
    ``generator`` on its own device and cast to ``dtype`` on ``device``.
    The values differ from JAX's.  ``device="meta"`` builds the shapes and
    allocates nothing (no generator needed)."""
    dev = _resolve_device(device)
    meta = dev.type == "meta"
    if generator is None and not meta:
        raise ValueError("init_params draws from a seeded torch.Generator; pass one")
    d = cfg.d_model
    L = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def dense(*shape, scale=0.02):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    def attn_params(*pre):
        p = {
            "wq": dense(*pre, d, cfg.q_dim),
            "wk": dense(*pre, d, cfg.kv_dim),
            "wv": dense(*pre, d, cfg.kv_dim),
            "wo": dense(*pre, cfg.q_dim, d),
        }
        if cfg.qk_norm:
            p["q_norm"] = zeros(*pre, cfg.head_dim)
            p["k_norm"] = zeros(*pre, cfg.head_dim)
        return p

    def mlp_params(ff, *pre):
        return {"w1": dense(*pre, d, ff), "w3": dense(*pre, d, ff), "w2": dense(*pre, ff, d)}

    def mamba_params(*pre):
        n, h, w = cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
        return {
            "z_proj": dense(*pre, d, cfg.d_inner),
            "x_proj": dense(*pre, d, cfg.d_inner),
            "b_proj": dense(*pre, d, n),
            "c_proj": dense(*pre, d, n),
            "dt_proj": dense(*pre, d, h),
            "out_proj": dense(*pre, cfg.d_inner, d),
            "conv_x": dense(*pre, w, cfg.d_inner, scale=0.2),
            "conv_b": dense(*pre, w, n, scale=0.2),
            "conv_c": dense(*pre, w, n, scale=0.2),
            "dt_bias": zeros(*pre, h),
            "a_log": zeros(*pre, h),
            "d_skip": ones(*pre, h),
        }

    params: Params = {"embed": dense(cfg.vocab, d), "final_norm": zeros(d)}
    if cfg.family in ("dense", "vlm", "audio"):
        params["layers"] = {
            "ln1": zeros(L, d), "ln2": zeros(L, d),
            "attn": attn_params(L), "mlp": mlp_params(cfg.d_ff, L),
        }
    elif cfg.family == "moe":
        e, ff = cfg.n_experts, cfg.moe_d_ff
        layers = {
            "ln1": zeros(L, d), "ln2": zeros(L, d), "attn": attn_params(L),
            "moe": {
                "router": dense(L, d, e), "w1": dense(L, e, d, ff),
                "w3": dense(L, e, d, ff), "w2": dense(L, e, ff, d),
            },
        }
        if cfg.n_shared_experts:
            layers["shared_mlp"] = mlp_params(ff * cfg.n_shared_experts, L)
        params["layers"] = layers
    elif cfg.family in ("ssm", "hybrid"):
        params["layers"] = {"ln": zeros(L, d), "mixer": mamba_params(L)}
        if cfg.family == "hybrid":
            params["shared_attn"] = {
                "ln": zeros(d), "ln2": zeros(d),
                "attn": attn_params(), "mlp": mlp_params(cfg.d_ff),
            }
    else:
        raise ValueError(cfg.family)
    return params


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in the JAX package's tree order: dict keys
    sorted, depth first."""
    for k, v in sorted(tree.items()):
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _map(fn, tree: Mapping) -> Dict:
    return {k: _map(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def params_from_jax(
    params_np: Mapping, device: Union[str, torch.device], dtype: Optional[torch.dtype] = None
) -> Params:
    """The JAX package's parameter tree (numpy leaves, or anything
    ``numpy.asarray`` takes) as the port's, leaf for leaf; bf16 is carried
    bit for bit (``kernels.ops.to_tensor``), ``dtype`` casts."""
    return _map(lambda a: to_tensor(a, dtype, device), params_np)


def param_count(params: Mapping) -> int:
    """The number of parameters in a tree (meta tensors count too)."""
    return sum(t.numel() for _, t in _leaves(params))


def _layers(stacked: Mapping) -> List[Dict]:
    """Each layer's slice of a tree stacked on a leading L axis, every leaf
    split by one ``torch.unbind``: autograd then stacks a leaf's layer
    gradients once, where an index per layer would make each layer's
    backward fill a zero gradient of the whole stacked leaf."""
    split = _map(lambda t: t.unbind(0), stacked)
    n = len(next(t for _, t in _leaves(split)))
    return [_map(lambda ts, i=i: ts[i], split) for i in range(n)]


# ---------------------------------------------------------------------------
# layer application (shared by train/prefill)
# ---------------------------------------------------------------------------


def _window_for_layer(cfg: ModelConfig, idx: int) -> Optional[int]:
    """The JAX model's sliding-window size per layer (gemma3 runs 5 local :
    1 global; a global layer gets ``1 << 30``, never None)."""
    if not cfg.sliding_window:
        return None
    if not cfg.global_every:
        return cfg.sliding_window
    is_global = (idx % cfg.global_every) == (cfg.global_every - 1)
    return (1 << 30) if is_global else cfg.sliding_window


def _layer_window(cfg: ModelConfig, idx: int) -> Optional[int]:
    """The window a layer's attention is routed by: None for a layer with
    no window by ``_window_for_layer``'s rule (no sliding window, or a
    global layer, whose ``1 << 30`` masks nothing a sequence can reach),
    which runs the attention kernel."""
    if not cfg.sliding_window:
        return None
    if cfg.global_every and idx % cfg.global_every == cfg.global_every - 1:
        return None
    return cfg.sliding_window


def _attn(cfg: ModelConfig, x, ap, positions, window, kv_chunk, kernels, qk_norm):
    return attention_block(
        x, ap,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, qk_norm=qk_norm, norm_eps=cfg.norm_eps,
        positions=positions, window=window, kv_chunk=kv_chunk, kernels=kernels,
    )


def _residual(x, y):
    """``x + y``: the residual stream ``x`` and a block's output ``y``, ``y``
    first laid out as the stream (``hint(y, "act")``, a sum over ``model``
    scattered along S under sequence parallelism).  The backward of that
    scatter gathers the gradient along S, so the gradient reaching the
    block's last product is whole along S, where its (B, S) rows are
    flattened (Megatron-SP's backward all-gather; torch 2.11's view rules
    refuse to flatten a sequence-sharded gradient, which the sum alone
    would hand back).  In decode it spares torch 2.11 a sum of a partial
    and a batch-split operand, which its rules would take to the partial
    layout and cannot."""
    return x + hint(y, "act")


def _transformer_layer(cfg: ModelConfig, x, lp, idx, positions, kv_chunk, kernels):
    h = _residual(x, _attn(cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), lp["attn"], positions,
                           _layer_window(cfg, idx), kv_chunk, kernels, cfg.qk_norm))
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in lp:
        y, aux = moe_block(
            hn, lp["moe"], n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
        )
        if "shared_mlp" in lp:
            y = y + swiglu_mlp(hn, lp["shared_mlp"])
    else:
        y = swiglu_mlp(hn, lp["mlp"])
    return hint(_residual(h, y), "act"), aux


def _mamba_layer(cfg: ModelConfig, x, lp, kernels):
    return _residual(hint(x, "act"), mamba2_block(
        rms_norm(x, lp["ln"], cfg.norm_eps), lp["mixer"],
        d_inner=cfg.d_inner, ssm_heads=cfg.ssm_heads, ssm_head_dim=cfg.ssm_head_dim,
        ssm_state=cfg.ssm_state, conv_width=cfg.conv_width, kernels=kernels,
    ))


def _shared_attn(cfg: ModelConfig, x, sp, positions, kv_chunk, kernels):
    h = _residual(x, _attn(cfg, rms_norm(x, sp["ln"], cfg.norm_eps), sp["attn"], positions,
                           None, kv_chunk, kernels, False))
    return _residual(h, swiglu_mlp(rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"]))


# ---------------------------------------------------------------------------
# embedding (with stubbed modality frontends)
# ---------------------------------------------------------------------------


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` by ``F.embedding``, not indexing: DTensor's
    embedding rules take a vocab-sharded table in the forward and the
    backward (torch 2.11's index rules fail on the indexing route's
    backward, and on tokens split over two mesh axes).  A sharded lookup is
    a masked partial sum, which DTensor reduces only once and only on its
    own layout: it is reduced here, before anything reads or reshards it.
    A table split along D as well (FSDP over the data axes) is gathered
    along D first, FSDP's gather (torch 2.11's embedding backward cannot
    take the split)."""
    x = F.embedding(tokens, whole_along(table, 1))
    if isinstance(x, DTensor):
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    return x


def embed_inputs(cfg: ModelConfig, params, batch: Mapping) -> torch.Tensor:
    """batch: {"tokens": (B,S)} and, for vlm/audio, {"prefix_embeds":
    (B, PREFIX_LEN, D)} produced by the (stubbed) modality frontend."""
    tok = hint(_embed(params["embed"], batch["tokens"]), "act")
    if cfg.frontend != "none":
        return torch.cat([batch["prefix_embeds"].to(tok.dtype), tok], dim=1)
    return tok


def _backbone(
    cfg: ModelConfig, params, x: torch.Tensor, *, kv_chunk: int, remat: bool = False,
    kernels: str = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the layers in order; returns (hidden, aux_loss).  ``remat``
    wraps each layer in ``torch.utils.checkpoint`` when grad is enabled."""
    _check_kernels(kernels, x)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = remat and torch.is_grad_enabled()

    def run(fn, *args):
        if ckpt:
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        for i, lp in enumerate(_layers(params["layers"])):
            x, a = run(lambda xc, i=i, lp=lp: _transformer_layer(
                cfg, xc, lp, i, positions, kv_chunk, kernels), x)
            aux = aux + a
    elif cfg.family in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        for i, lp in enumerate(_layers(params["layers"])):

            def body(xc, i=i, lp=lp):
                y = _mamba_layer(cfg, xc, lp, kernels)
                if cfg.family == "hybrid" and i % every == every - 1:
                    y = _shared_attn(cfg, y, params["shared_attn"], positions, kv_chunk, kernels)
                return y

            x = run(body, x)
    else:
        raise ValueError(cfg.family)
    return x, aux


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's ``logsumexp(logits) - logits[label]``, (B, S).

    The label's logit is a masked sum over the vocabulary (one term is not
    zero, so the sum is that logit exactly).  DTensor logits go to
    ``_vocab_parallel_nll``."""
    if isinstance(logits, DTensor):
        return _vocab_parallel_nll(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    hit = labels[..., None].long() == torch.arange(logits.shape[-1], device=logits.device)
    return logz - torch.where(hit, logits, 0.0).sum(-1)


def _vocab_parallel_nll(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """``_token_nll`` of (B, S, V) logits split along V over some mesh dims
    (``model``) and along B over others (the data axes), on each rank's own
    shard: a local max reduced by ``max_over``, a local sum of ``exp`` and
    the label's logit among the rank's own columns, each reduced by
    ``sum_over`` (Megatron's vocab-parallel cross-entropy); logits whole
    along V take the plain path on the rank's rows (one rank gives the
    unsharded loss bit for bit).  The result is split along B as the
    logits are.  The logits' gradient stays on each
    rank's (B_local, S, V_local) shard: DTensor's ``logsumexp`` takes a B
    split over two mesh dims, (pod, data), through replication, a logits
    gradient whole over B and V on every rank."""
    mesh = logits.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    rows = batch_rows(logits)
    vdims = [i for i, p in enumerate(pl) if p.is_shard(2)]
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, pl)
    lg, lab = logits.to_local(), local_rows(labels, mesh, rows)
    if vdims:
        m = max_over(lg.amax(-1, keepdim=True), mesh, vdims)
        logz = torch.log(sum_over(torch.exp(lg - m).sum(-1), mesh, vdims)) + m[..., 0]
        hit = (lab[..., None].long() - offset[2]) == torch.arange(lg.shape[-1], device=lg.device)
        nll = logz - sum_over(torch.where(hit, lg, 0.0).sum(-1), mesh, vdims)
    else:                                      # the vocabulary whole on this rank
        nll = _token_nll(lg, lab)
    return from_local_rows(nll, mesh, rows, labels.shape)


def forward_train(
    cfg: ModelConfig,
    params,
    batch: Mapping,
    *,
    kv_chunk: int = 512,
    remat: bool = True,
    kernels: str = "cuda",
) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss over the batch.  Returns (loss, metrics)."""
    x = hint(embed_inputs(cfg, params, batch), "act")
    h, aux = _backbone(cfg, params, x, kv_chunk=kv_chunk, remat=remat, kernels=kernels)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.frontend != "none":
        h = h[:, PREFIX_LEN:]           # loss only over token positions
    logits = hint(torch.einsum("bsd,vd->bsv", seq_whole(h), params["embed"]).float(), "logits")
    nll = _token_nll(logits, batch["labels"])
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    loss = nll.sum() / denom + 0.01 * aux
    return loss, {"nll": nll.sum() / denom, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with caches
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, torch.Tensor]:
    """The JAX package's cache layout: (L, B, H, S, D) K/V for attention
    families, f32 SSM states and conv tails for mamba2 blocks, and one K/V
    per shared-attention application for the hybrid family."""
    dev = _resolve_device(device)
    L = cfg.n_layers

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache: Dict[str, torch.Tensor] = {}
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        cache["k"] = zeros((L, batch, cfg.n_kv_heads, max_seq, cfg.head_dim))
        cache["v"] = zeros((L, batch, cfg.n_kv_heads, max_seq, cfg.head_dim))
    if cfg.family in ("ssm", "hybrid"):
        w = cfg.conv_width - 1
        cache["ssm_h"] = zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32
        )
        cache["conv_x"] = zeros((L, batch, w, cfg.d_inner))
        cache["conv_b"] = zeros((L, batch, w, cfg.ssm_state))
        cache["conv_c"] = zeros((L, batch, w, cfg.ssm_state))
    if cfg.family == "hybrid":
        napp = (cfg.n_layers + cfg.shared_attn_every - 1) // cfg.shared_attn_every
        cache["shared_k"] = zeros((napp, batch, cfg.n_kv_heads, max_seq, cfg.head_dim))
        cache["shared_v"] = zeros((napp, batch, cfg.n_kv_heads, max_seq, cfg.head_dim))
    return cache


def _proj_qkv(cfg: ModelConfig, x, ap, pos):
    q = split_heads(x @ ap["wq"], cfg.n_heads, cfg.head_dim)
    k = split_heads(x @ ap["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(x @ ap["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in ap:
        q = rms_norm(q, ap["q_norm"], cfg.norm_eps)
        k = rms_norm(k, ap["k_norm"], cfg.norm_eps)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _decode_attn(cfg, x, ap, kc, vc, pos, posv, window):
    """One layer's decode attention; returns (attention output projected,
    the token's K and V as (B, Hkv, 1, D) in the cache's dtype)."""
    q, k, v = _proj_qkv(cfg, x, ap, posv)
    kn = k.transpose(1, 2).to(kc.dtype)
    vn = v.transpose(1, 2).to(vc.dtype)
    o = decode_attention(q, kc, vc, pos, window=window, k_new=kn, v_new=vn)
    return o @ ap["wo"], kn, vn


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,     # (B,) current token ids
    pos: int,                 # position being generated
    *,
    kernels: str = "cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: returns (logits (B, V), the cache).  Every layer
    reads the cache as it was; the token's K/V are written after all
    layers, one slice write a cache tensor, into the cache's own tensors
    (in place, as the JAX model updates its donated buffer), and the SSM
    states and conv tails likewise.  Decode launches no hand-written kernel
    (the JAX model's decode reaches no Pallas kernel)."""
    x = _embed(params["embed"], tokens[:, None])                       # (B, 1, D)
    _check_kernels(kernels, x)
    posv = torch.tensor([pos], device=x.device)

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        ks, vs = [], []
        for i, lp in enumerate(_layers(params["layers"])):
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            o, kn, vn = _decode_attn(cfg, hn, lp["attn"], cache["k"][i], cache["v"][i],
                                     pos, posv, _window_for_layer(cfg, i))
            h = _residual(x, o)
            hn2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
            if "moe" in lp:
                y, _ = moe_block(
                    hn2, lp["moe"], n_experts=cfg.n_experts, top_k=cfg.top_k,
                    capacity_factor=4.0, group_size=hn2.shape[0],
                )
                if "shared_mlp" in lp:
                    y = y + swiglu_mlp(hn2, lp["shared_mlp"])
            else:
                y = swiglu_mlp(hn2, lp["mlp"])
            x = _residual(h, y)
            ks.append(kn)
            vs.append(vn)
        write_region(cache["k"], torch.stack(ks), {3: pos})
        write_region(cache["v"], torch.stack(vs), {3: pos})

    elif cfg.family in ("ssm", "hybrid"):
        sp = params.get("shared_attn")
        every = cfg.shared_attn_every
        states, shared = [], {}
        for i, lp in enumerate(_layers(params["layers"])):
            hn = rms_norm(x, lp["ln"], cfg.norm_eps)
            y, st = mamba2_decode_step(
                hn, lp["mixer"],
                {"h": cache["ssm_h"][i], "conv_x": cache["conv_x"][i],
                 "conv_b": cache["conv_b"][i], "conv_c": cache["conv_c"][i]},
                d_inner=cfg.d_inner, ssm_heads=cfg.ssm_heads, ssm_head_dim=cfg.ssm_head_dim,
                ssm_state=cfg.ssm_state, conv_width=cfg.conv_width,
            )
            x = _residual(x, y)
            states.append(st)
            if cfg.family == "hybrid" and i % every == every - 1:
                app = i // every
                hn2 = rms_norm(x, sp["ln"], cfg.norm_eps)
                o, kn, vn = _decode_attn(cfg, hn2, sp["attn"], cache["shared_k"][app],
                                         cache["shared_v"][app], pos, posv, None)
                x = _residual(x, o)
                x = _residual(x, swiglu_mlp(rms_norm(x, sp["ln2"], cfg.norm_eps), sp["mlp"]))
                shared[app] = (kn, vn)
        for name, key in (("ssm_h", "h"), ("conv_x", "conv_x"), ("conv_b", "conv_b"),
                          ("conv_c", "conv_c")):
            cache[name].copy_(torch.stack([st[key] for st in states]))
        for app, (kn, vn) in shared.items():
            write_region(cache["shared_k"], kn[None], {0: app, 3: pos})
            write_region(cache["shared_v"], vn[None], {0: app, 3: pos})
    else:
        raise ValueError(cfg.family)

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", h, params["embed"])[:, 0].float()
    return logits, cache


def forward_prefill(
    cfg: ModelConfig,
    params,
    batch: Mapping,
    *,
    kv_chunk: int = 512,
    kernels: str = "cuda",
) -> torch.Tensor:
    """Prefill forward: the last position's logits (B, V), no cache
    write-out (as the JAX function)."""
    x = embed_inputs(cfg, params, batch)
    h, _ = _backbone(cfg, params, x, kv_chunk=kv_chunk, remat=False, kernels=kernels)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bd,vd->bv", h[:, -1], params["embed"]).float()


class LM(nn.Module):
    """A thin module holding one model's parameter tree (frozen tensors,
    one submodule per dict), with the functions above as methods."""

    def __init__(self, cfg: ModelConfig, params: Mapping):
        super().__init__()
        self.cfg = cfg
        self.tree = _to_module(params)

    def params(self) -> Params:
        return _from_module(self.tree)

    def forward(self, batch: Mapping, **kw) -> torch.Tensor:
        return forward_prefill(self.cfg, self.params(), batch, **kw)

    def forward_train(self, batch: Mapping, **kw):
        return forward_train(self.cfg, self.params(), batch, **kw)

    def decode_step(self, cache, tokens, pos: int, **kw):
        return decode_step(self.cfg, self.params(), cache, tokens, pos, **kw)


def _to_module(tree: Mapping) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, Mapping):
            m.add_module(k, _to_module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _from_module(m: nn.Module) -> Params:
    out: Params = {k: p for k, p in m.named_parameters(recurse=False)}
    out.update({k: _from_module(c) for k, c in m.named_children()})
    return out


__all__ = [
    "LM",
    "PREFIX_LEN",
    "decode_step",
    "embed_inputs",
    "forward_prefill",
    "forward_train",
    "init_kv_cache",
    "init_params",
    "param_count",
    "params_from_jax",
]
