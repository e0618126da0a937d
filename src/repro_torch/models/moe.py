"""Mixture-of-experts block: grouped GShard-style top-k dispatch — the port
of the JAX package's ``models/moe.py``.

Tokens are split into groups, routed top-k with a capacity limit, pushed
through the experts with einsums whose FLOPs equal the active compute, and
combined with the router gates.  Overflowing tokens are dropped; an
auxiliary load-balance loss is returned for training.  The sharding hints
sit at the JAX module's sites (groups over the data axes, experts over
``model`` under expert parallelism).  ``jax.lax.top_k``
puts the lower expert first on tied probabilities; ``torch.topk`` promises
no order, so the port takes a stable descending sort.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.context import hint, seq_whole


def route_tokens(
    xg: torch.Tensor,         # (G, T, D) grouped tokens
    router: torch.Tensor,     # (D, E)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
) -> Tuple[torch.Tensor, ...]:
    """The dispatch decision: (probs (G,T,E), gate values (G,T,k) with the
    dropped slots zeroed, expert ids (G,T,k), queue positions (G,T,k), kept
    mask (G,T,k), capacity).  A slot's queue position is its place in its
    expert's queue over the token-major (T·k) order of its group."""
    ng, gsz, _ = xg.shape
    logits = torch.einsum("gtd,de->gte", xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    cap = max(1, int(capacity_factor * gsz * top_k / n_experts))
    onehot = F.one_hot(gate_idx, n_experts).float()                  # (G,T,k,E)
    flat = onehot.reshape(ng, gsz * top_k, n_experts)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat                 # (G, T*k, E)
    pos = torch.einsum("gte,gte->gt", pos_in_expert, flat).reshape(ng, gsz, top_k)
    keep = pos < cap
    return probs, gate_vals * keep, gate_idx, pos, keep, cap


def moe_block(
    x: torch.Tensor,          # (B, S, D)
    p: dict,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balance loss scalar)."""
    b, s, d = x.shape
    tokens = seq_whole(x).reshape(-1, d)
    t = tokens.shape[0]
    gsz = min(group_size, t)
    assert t % gsz == 0, (t, gsz)
    # pin the grouped-token layout once: groups ride the data axes
    xg = hint(tokens.reshape(t // gsz, gsz, d), "moe_groups")
    probs, gate_vals, gate_idx, pos, keep, cap = route_tokens(
        xg, p["router"], n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor
    )
    onehot = F.one_hot(gate_idx, n_experts).float()                  # (G,T,k,E)
    # a position past capacity has no slot (jax.nn.one_hot gives zeros)
    cap_oh = (pos.long()[..., None] == torch.arange(cap, device=x.device)).float()
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None], cap_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, cap_oh, gate_vals)

    expert_in = hint(torch.einsum("gtec,gtd->gecd", dispatch, xg.float()).to(x.dtype),
                     "expert_in")                                     # (G, E, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w1"])) * torch.einsum(
        "gecd,edf->gecf", expert_in, p["w3"]
    )
    h = hint(h, "expert_hidden")
    expert_out = hint(torch.einsum("gecf,efd->gecd", h, p["w2"]), "expert_in")
    out = torch.einsum("gtec,gecd->gtd", combine, expert_out.float()).to(x.dtype)

    # Switch-style load-balance auxiliary loss
    frac_tokens = onehot[:, :, 0, :].mean(dim=1)                     # top-1 share
    frac_probs = probs.mean(dim=1)
    aux = n_experts * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return out.reshape(b, s, d), aux.float()


__all__ = ["moe_block", "route_tokens"]
