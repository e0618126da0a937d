"""Mamba2 (SSD) block: chunked state-space scan, causal conv, gating — the
port of the JAX package's ``models/ssm.py``.

``ssd_chunked`` is the plain chunked dual form with an optional initial
state, as the JAX function.  ``mamba2_block`` (the train and prefill path)
runs the scan through the hand-written SSD kernels instead:
``kernels.ops.ssd_op`` once per batch row, with ``chunk=min(chunk, S)``
(``ssd_gram``, ``ssd_chunk_state``, ``ssd_state_pass``, ``ssd_chunk_out``
on the card), which is ``ssd_chunked``'s math from a zero state.
``mamba2_decode_step`` is the plain one-token recurrence.

Projections are kept as separate weights (z/x/B/C/dt and per-stream convs),
as the JAX module keeps them.  The sharding hints sit at the JAX module's
sites; under a sharding context with DTensor operands the scan's operands
are first redistributed so that each rank's scan is independent (batch rows
over the data axes, heads over ``model`` where they divide it, ``B`` and
``C`` gathered along N, which C Bᵀ contracts), and the kernels run on the
local shards (``_ssd_rows``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial

from repro_torch.distributed import context as _ctx
from repro_torch.distributed.context import hint, seq_whole
from repro_torch.distributed.sharding import P, placements
from repro_torch.kernels import ops

from .layers import ROUTES, split_heads

# SSD chunk length: intra-chunk cost grows with L, carried-state passes
# shrink with L
_SSD_CHUNK = 256


def set_ssd_chunk(n: int) -> None:
    global _SSD_CHUNK
    _SSD_CHUNK = n


def causal_conv1d(
    x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), w: (W, C).  ``tail``: (B, W-1, C)
    carried context for decode.  Returns (y, new_tail).

    The zero tail and the accumulator are made ``like`` ``x``: a DTensor
    ``x`` gives them its layout, where a plain tensor of the global shape
    would be whole on every rank (an f32 (B, S, C) on each) and would take
    ``x`` to its layout in the ``cat``."""
    s = x.shape[1]
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros_like(x[:, :1]).expand(-1, width - 1, -1)
    xp = torch.cat([tail, x], dim=1)                                # (B, S+W-1, C)
    y = torch.zeros_like(x, dtype=torch.float32)
    for i in range(width):
        y = y + w[i].float() * xp[:, i : i + s].float()
    new_tail = xp[:, s:]
    return F.silu(y).to(x.dtype), new_tail


def ssd_chunked(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)  (post-softplus, > 0)
    a: torch.Tensor,     # (H,) negative decay
    bmat: torch.Tensor,  # (B, S, N)
    cmat: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final state (B,H,P,N)).  f32 scan math."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    l = min(chunk, s)
    assert s % l == 0
    nc = s // l
    xf = x.float().reshape(b, nc, l, h, p)
    dtf = dt.float().reshape(b, nc, l, h)
    bf = bmat.float().reshape(b, nc, l, n)
    cf = cmat.float().reshape(b, nc, l, n)
    af = a.float()
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    hstate = (
        torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
        if h0 is None else h0.float()
    )
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        sgl = torch.cumsum(af[None, None, :] * dtc, dim=1)                  # (B,l,H)
        g = torch.einsum("bln,bmn->blm", cc, bc)                            # (B,l,l)
        gap = sgl[:, :, None, :] - sgl[:, None, :, :]                       # (B,l,l,H)
        # the exponent masked before exp: an overflowed exp above the diagonal
        # would make the gradient through torch.where NaN (0 * inf)
        m = torch.exp(torch.where(mask[None, :, :, None], gap, -torch.inf)) * dtc[:, None, :, :]
        y_intra = torch.einsum("blm,blmh,bmhp->blhp", g, m, xc)
        y_inter = torch.exp(sgl)[..., None] * torch.einsum("bln,bhpn->blhp", cc, hstate)
        tail = torch.exp(sgl[:, -1][:, None, :] - sgl) * dtc               # (B,l,H)
        hstate = torch.exp(sgl[:, -1])[:, :, None, None] * hstate + torch.einsum(
            "blh,blhp,bln->bhpn", tail, xc, bc
        )
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), hstate


def _project(x, p):
    """Separate z/x/B/C/dt projections."""
    return x @ p["z_proj"], x @ p["x_proj"], x @ p["b_proj"], x @ p["c_proj"], x @ p["dt_proj"]


def _ssd_rows(xh, dt, a, bm, cm, kernels: str, chunk: int) -> torch.Tensor:
    """``ops.ssd_op`` once per batch row: y (B, S, H, P).  DTensor operands
    under a sharding context are redistributed first: rows over the data
    axes, heads over ``model`` where they divide it, ``bm`` / ``cm`` whole
    along N; the kernels then run on each rank's rows and heads.  A rank's
    gradient of what it holds whole is its own part of a sum (``Partial``):
    of ``bm`` / ``cm`` over the model ranks, whose heads all read them, and
    of ``a`` over the ranks that split the rows."""
    c = _ctx.current()
    sharded = c is not None and isinstance(xh, DTensor)
    if sharded:
        lead = c.plan.batch_spec("x", (xh.shape[0],))[0]
        heads = "model" if xh.shape[2] % c.plan.axes["model"] == 0 else None
        x_pl = placements(P(lead, None, heads, None), c.mesh)
        bc_pl = placements(P(lead, None, None), c.mesh)
        m = list(c.plan.axes).index("model")
        bc_grad = [Partial() if i == m and heads else q for i, q in enumerate(bc_pl)]
        a_pl = placements(P(heads), c.mesh)
        a_grad = [Partial() if x_pl[i].is_shard(0) else q for i, q in enumerate(a_pl)]
        xh, dt, a, bm, cm = (
            t.redistribute(c.mesh, pl).to_local(grad_placements=g) for t, pl, g in (
                (xh, x_pl, None), (dt, placements(P(lead, None, heads), c.mesh), None),
                (a, a_pl, a_grad), (bm, bc_pl, bc_grad), (cm, bc_pl, bc_grad)))
    y = torch.stack([ops.ssd_op(xh[i], dt[i], a, bm[i], cm[i], kernels=kernels, chunk=chunk)
                     for i in range(xh.shape[0])])
    ROUTES["ssd_op"] += xh.shape[0]
    return DTensor.from_local(y, c.mesh, x_pl, run_check=False) if sharded else y


def mamba2_block(
    x: torch.Tensor,          # (B, S, D)
    p: Dict,
    *,
    d_inner: int,
    ssm_heads: int,
    ssm_head_dim: int,
    ssm_state: int,
    conv_width: int,
    chunk: int = 0,
    kernels: str = "cuda",
) -> torch.Tensor:
    """Full Mamba2 mixer (training/prefill path); the scan runs through
    ``ops.ssd_op(kernels=...)`` per batch row."""
    chunk = chunk or _SSD_CHUNK
    b, s, d = x.shape
    z, xs, bm, cm, dt = _project(seq_whole(x), p)
    xs = hint(xs, "ssm_inner")
    z = hint(z, "ssm_inner")
    xs, _ = causal_conv1d(xs, p["conv_x"])
    bm, _ = causal_conv1d(bm, p["conv_b"])
    cm, _ = causal_conv1d(cm, p["conv_c"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                                     # (H,)
    xh = hint(split_heads(xs, ssm_heads, ssm_head_dim), "ssm_heads")
    y = _ssd_rows(xh, dt, a, bm, cm, kernels, min(chunk, s))
    y = hint(y, "ssm_heads")
    y = y.float() + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"]


def mamba2_decode_step(
    x: torch.Tensor,          # (B, 1, D)
    p: Dict,
    state: Dict,              # {"h": (B,H,P,N) fp32, "conv_*": (B, W-1, C)}
    *,
    d_inner: int,
    ssm_heads: int,
    ssm_head_dim: int,
    ssm_state: int,
    conv_width: int,
) -> Tuple[torch.Tensor, Dict]:
    b, _, d = x.shape
    z, xs, bm, cm, dt = _project(x, p)
    xs, tail_x = causal_conv1d(xs, p["conv_x"], tail=state["conv_x"])
    bm, tail_b = causal_conv1d(bm, p["conv_b"], tail=state["conv_b"])
    cm, tail_c = causal_conv1d(cm, p["conv_c"], tail=state["conv_c"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    xh = xs.reshape(b, ssm_heads, ssm_head_dim).float()
    decay = torch.exp(a[None, :, None, None] * dt[:, 0, :, None, None])   # (B,H,1,1)
    upd = dt[:, 0, :, None, None] * (xh[:, :, :, None] * bm[:, 0, None, None, :].float())
    h_new = decay * state["h"] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, cm[:, 0].float())
    y = y + p["d_skip"].float()[None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"], {"h": h_new, "conv_x": tail_x, "conv_b": tail_b, "conv_c": tail_c}


__all__ = ["causal_conv1d", "mamba2_block", "mamba2_decode_step", "set_ssd_chunk", "ssd_chunked"]
