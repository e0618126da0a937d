"""Ring attention over a mesh axis (context parallelism without all-gather)
— the port of the JAX package's ``distributed/ring_attention.py``.

The KV blocks rotate around the axis by point-to-point sends while every
rank keeps only its own Q rows and one in-flight KV block — the paper's
shift-register chain (Fig. 8a) lifted to pod scale: a static schedule pushes
each KV block through every rank exactly once, so peak KV memory per rank
is O(S/n) instead of O(S) and the all-gather disappears.

The JAX rotation ``ppermute(perm=[(i, (i - 1) % n)])`` sends to rank
``me - 1`` of the axis and receives from ``me + 1``, so at step t a rank
holds the block of rank ``(me + t) % n``; here one ``batch_isend_irecv``
in the axis's process group does it (group ranks mapped to global ranks
for the peers).  The rotation after the last step is skipped: its blocks
are never read, and a 1-rank ring then sends nothing (torch refuses a send
to one's own rank).  The per-step products are ``torch.einsum``, as the
JAX module's, which reaches no Pallas kernel.

Forward only, as the JAX module is documented: under autograd it raises
``NotImplementedError`` (ROADMAP.md Queue 3 records the difference).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from .sharding import P, placements

NEG_INF = -1e30


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor is the same global value on every rank: replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _rotate(kc: torch.Tensor, vc: torch.Tensor, group, me: int, n: int) -> Tuple[torch.Tensor, ...]:
    """Send (kc, vc) to axis rank ``me - 1``, receive the next pair from
    ``me + 1``."""
    to = dist.get_global_rank(group, (me - 1) % n)
    frm = dist.get_global_rank(group, (me + 1) % n)
    k_in, v_in = torch.empty_like(kc), torch.empty_like(vc)
    ops = [
        dist.P2POp(dist.isend, kc, to, group),
        dist.P2POp(dist.isend, vc, to, group),
        dist.P2POp(dist.irecv, k_in, frm, group),
        dist.P2POp(dist.irecv, v_in, frm, group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k_in, v_in


def ring_attention(
    q: torch.Tensor,    # (B, S, H, D) — S sharded over ``axis``
    k: torch.Tensor,    # (B, S, Hkv, D)
    v: torch.Tensor,    # (B, S, Hkv, D)
    mesh,
    *,
    axis: str = "model",
    dp: tuple = (),
    window: Optional[int] = None,
) -> DTensor:
    """Causal (optionally windowed) GQA attention with the sequence sharded
    over ``axis`` and the batch over ``dp``.  ``q``, ``k``, ``v`` are
    DTensors on ``mesh`` (any layout: each is redistributed to that one) or
    plain tensors holding the global value on every rank.  Returns a
    DTensor in the same layout: (B, S, H, D), S over ``axis``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "ring_attention is forward only, as the JAX package's is documented "
            "(ROADMAP.md Queue 3); run it under torch.no_grad()"
        )
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if s % n:
        raise ValueError(f"sequence {s} does not split over {axis}={n}")
    s_loc = s // n
    scale = 1.0 / (d ** 0.5)
    pl = placements(P(dp if dp else None, axis, None, None), mesh)
    q_loc, kc, vc = (
        _as_dtensor(t, mesh).redistribute(mesh, pl).to_local().contiguous() for t in (q, k, v)
    )
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    dev = q_loc.device
    b_loc = q_loc.shape[0]
    q_pos = me * s_loc + torch.arange(s_loc, device=dev)             # global rows
    qg = q_loc.reshape(b_loc, s_loc, hkv, g, d).float()

    m = torch.full((b_loc, s_loc, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b_loc, s_loc, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b_loc, s_loc, hkv, g, d), dtype=torch.float32, device=dev)
    for t in range(n):
        src = (me + t) % n                                           # block owner
        k_pos = src * s_loc + torch.arange(s_loc, device=dev)
        sco = torch.einsum("bshgd,bchd->bshgc", qg, kc.float()) * scale
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        sco = torch.where(mask[None, :, None, None, :], sco,
                          torch.tensor(NEG_INF, dtype=sco.dtype, device=dev))
        m_new = torch.maximum(m, sco.amax(dim=-1))
        p = torch.exp(sco - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, dtype=torch.float32)
        acc = acc * alpha[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(vc.dtype).float(), vc.float()
        )
        m = m_new
        if t + 1 < n:
            kc, vc = _rotate(kc, vc, group, me, n)
    out = acc / torch.clamp(l[..., None], min=1e-20)
    out = out.reshape(b_loc, s_loc, hq, d).to(q_loc.dtype)
    return DTensor.from_local(out, mesh, pl, run_check=False)


__all__ = ["ring_attention"]
