"""Mixture-of-experts block: grouped GShard-style top-k dispatch — the port
of the JAX package's ``models/moe.py``.

Tokens are split into groups, routed top-k with a capacity limit, pushed
through the experts with einsums whose FLOPs equal the active compute, and
combined with the router gates.  Overflowing tokens are dropped; an
auxiliary load-balance loss is returned for training.  The sharding hints
sit at the JAX module's sites (groups over the data axes, experts over
``model`` under expert parallelism); under expert parallelism the expert
pass runs on each rank's own experts (``_on_local_experts``).  ``jax.lax.top_k``
puts the lower expert first on tied probabilities; ``torch.topk`` promises
no order, so the port takes a stable descending sort.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed import context as _ctx
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


def _experts(xg, onehot, keep, cap_oh, gate_vals, p, dtype, constrain):
    """The expert pass: the dispatch and combine weights of each (token,
    expert, capacity slot) from the routing, tokens dispatched into each
    expert's slots, the SwiGLU experts, the combine with the gates;
    ``constrain(t, kind)`` lays out the intermediates (the JAX module's hint
    sites)."""
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None], cap_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, cap_oh, gate_vals)
    expert_in = constrain(torch.einsum("gtec,gtd->gecd", dispatch, xg.float()).to(dtype),
                          "expert_in")                                # (G, E, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w1"])) * torch.einsum(
        "gecd,edf->gecf", expert_in, p["w3"]
    )
    h = constrain(h, "expert_hidden")
    expert_out = constrain(torch.einsum("gecf,efd->gecd", h, p["w2"]), "expert_in")
    return torch.einsum("gtec,gecd->gtd", combine, expert_out.float()).to(dtype)


def _on_local_experts(c, xg, onehot, keep, cap_oh, gate_vals, p, dtype):
    """The expert pass under expert parallelism (``expert_in`` split over
    ``model``) on each rank's own experts: the routing's one-hot and the
    expert weights taken along E over ``model`` (the weights whole over the
    data axes, FSDP's gather), everything else as it is on ``model``, and
    ``_experts`` on the local shards; the combine's sum over experts is then
    partial over ``model``.  As XLA partitions the JAX module's einsums by
    its hints: no rank computes another rank's experts, and nothing is
    flattened across a sharded E (which torch 2.11's view rules refuse)."""
    mesh = c.mesh
    m = list(c.plan.axes).index("model")

    def local(t, dim=None, keep_data=True):
        """``t``'s local shard with E (``dim``) over ``model``, or whole on
        ``model``; whole over the data axes unless ``keep_data``.  Its
        gradient is this rank's part of a sum over the ranks that did not
        compute it: the other experts' (on ``model``, for what is whole
        there), the other tokens' (on a data axis that splits the tokens,
        for what is whole there: the weights)."""
        pl = [(Replicate() if dim is None else Shard(dim)) if i == m
              else (q if keep_data else Replicate()) for i, q in enumerate(t.placements)]
        grad_pl = [Partial() if (i == m and dim is None) or (
            i != m and not keep_data and xg.placements[i].is_shard()) else q
            for i, q in enumerate(pl)]
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    w = {k: local(p[k], 0, keep_data=False) for k in ("w1", "w3", "w2")}
    out = _experts(local(xg), local(onehot, 3), local(keep), local(cap_oh), local(gate_vals),
                   w, dtype, lambda t, _kind: t)
    pl = [Partial() if i == m else q for i, q in enumerate(xg.placements)]
    return DTensor.from_local(out, mesh, pl, run_check=False)


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
    routing = (onehot, keep, cap_oh, gate_vals)
    c = _ctx.current()
    if c is not None and isinstance(xg, DTensor) and c.plan.activation_spec(
            "expert_in", (1, n_experts, 1, 1))[1] == "model":
        out = _on_local_experts(c, xg, *routing, p, x.dtype)
    else:
        out = _experts(xg, *routing, p, x.dtype, hint)

    # Switch-style load-balance auxiliary loss
    frac_tokens = onehot[:, :, 0, :].mean(dim=1)                     # top-1 share
    frac_probs = probs.mean(dim=1)
    aux = n_experts * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return out.reshape(b, s, d), aux.float()


__all__ = ["moe_block", "route_tokens"]
