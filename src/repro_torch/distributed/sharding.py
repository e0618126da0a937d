"""Per-architecture sharding planner (DP/TP/EP/SP selection) — the port of
the JAX package's ``distributed/sharding.py``, rule for rule.

The planner is the pod-scale twin of the paper's buffer-mapping step: given
declarative "port" requirements (which tensor dims must stream together) and
hardware divisibility constraints, it picks a legal layout:

  * **DP** over ``pod`` x ``data`` for the batch,
  * **TP** over ``model`` for every weight whose last/contracting dim divides
    the axis (Megatron-style column/row split pairs),
  * **attention strategy**: ``heads`` when the q-head count divides the model
    axis (KV replicated when the KV-head count does not — GQA KV is small);
    otherwise ``context`` (sequence/context parallelism — q rows sharded,
    KV gathered), which is the paper's *banking* fallback,
  * **EP** for MoE when n_experts divides the model axis (dbrx), else TP
    inside each expert (qwen2-moe),
  * KV caches shard their *sequence* dim over ``model`` (flash-decoding
    style) — the paper's *chaining* (Eqs. 5-6) across chips.

Every rule checks divisibility before sharding.  JAX rejects uneven shards;
DTensor accepts them, so these checks are the only guard, and they are the
JAX package's verbatim.

A spec is the port's ``PartitionSpec`` (a tuple, normalised as JAX's: an
empty tuple entry is ``None``, a one-name tuple the name).  ``placements``
turns it into DTensor placements on a mesh, which is a ``DeviceMesh`` or a
``launch.mesh.AbstractMesh`` (spec math needs no devices).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

if TYPE_CHECKING:   # the model package imports this one (its hints)
    from repro_torch.models.config import ModelConfig


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (the dim split over those axes, in mesh order)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def placements(spec, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: a mesh dim named in the
    spec's entry ``d`` gives ``Shard(d)``, every other ``Replicate()``.  A
    tuple entry must name its axes in mesh order (DTensor splits a dim
    sharded over several mesh dims in mesh-dim order).  A mesh dim of size
    1 gives ``Replicate()`` whatever the spec: the same layout, which
    DTensor's view rules accept where they refuse to reshape a dim
    "sharded" one way."""
    sizes = axis_sizes(mesh)
    order = list(sizes)
    out: List = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [order.index(n) if n in order else -1 for n in names]
        if min(idx) < 0:
            raise ValueError(f"{spec}: axis {names[idx.index(-1)]!r} is not in the mesh {order}")
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"{spec}: entry {names} is not in mesh order {order}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{spec}: axis {order[i]!r} shards two dims")
            out[i] = Shard(d)
    return [Replicate() if sizes[a] == 1 else pl for a, pl in zip(order, out)]


@dataclass
class ShardingPlan:
    cfg: ModelConfig
    mesh: object                          # DeviceMesh or AbstractMesh
    attn_strategy: str                    # "heads" | "context"
    moe_strategy: str                     # "ep" | "tp" | "none"
    fsdp: bool = False                    # also shard params over 'data'
    seq_parallel: bool = False            # Megatron-SP residual stream
    notes: Dict[str, str] = field(default_factory=dict)

    @property
    def axes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    # -- activations ---------------------------------------------------------
    def activation_spec(self, kind: str, shape: Tuple[int, ...]) -> Optional[P]:
        dp = dp_axes(self.mesh)
        model = "model"
        msize = self.axes[model]

        def dv(dim: int) -> bool:
            return shape[dim] % msize == 0 if dim < len(shape) else False

        def dp_ok(dim: int = 0) -> Tuple[str, ...]:
            # try the full dp tuple, then drop leading axes (e.g. a multi-pod
            # microbatch that divides 'data' but not 'pod' x 'data')
            for k in range(len(dp)):
                axes = dp[k:]
                n = 1
                for a in axes:
                    n *= self.axes[a]
                if shape[dim] % n == 0 and shape[dim] >= n:
                    return axes
            return ()

        if kind == "act":                 # (B, S, D) between blocks:
            # sequence-parallel residual stream (Megatron-SP): the TP
            # all-reduce decomposes into reduce-scatter + all-gather, halving
            # collective bytes and sharding the norms
            if self.seq_parallel and len(shape) == 3 and dv(1):
                return P(dp_ok(), model, None)
            return P(dp_ok(), None, None)
        if kind == "q_heads":             # (B, S, H, dh)
            if self.attn_strategy == "heads" and dv(2):
                return P(dp_ok(), None, model, None)
            if dv(1):
                return P(dp_ok(), model, None, None)
            return P(dp_ok(), None, None, None)
        if kind == "kv_heads":            # (B, S, Hkv, dh) — gathered over model
            return P(dp_ok(), None, model if self.attn_strategy == "heads" and dv(2) else None, None)
        if kind == "attn_out":            # (B, S, H*dh)
            return P(dp_ok(), None, None)
        if kind == "logits":              # (B, S, V)
            return P(dp_ok(), None, model if dv(2) else None)
        if kind == "mlp_hidden":          # (B, S, F)
            return P(dp_ok(), None, model if dv(2) else None)
        if kind == "moe_groups":          # (G, gsz, D)
            return P(dp_ok(), None, None)
        if kind == "expert_in":           # (G, E, C, D)
            if self.moe_strategy == "ep" and dv(1):
                return P(dp_ok(), model, None, None)
            return P(dp_ok(), None, None, None)
        if kind == "expert_hidden":       # (G, E, C, F)
            if self.moe_strategy == "ep" and dv(1):
                return P(dp_ok(), model, None, None)
            if dv(3):
                return P(dp_ok(), None, None, model)
            return P(dp_ok(), None, None, None)
        if kind == "ssm_inner":           # (B, S, d_inner)
            return P(dp_ok(), None, model if dv(2) else None)
        if kind == "ssm_heads":           # (B, S, H, P)
            return P(dp_ok(), None, model if dv(2) else None, None)
        if kind == "kv_cache":            # (L, B, Smax, Hkv, dh) — chaining
            return P(None, dp_ok(1), model if dv(2) else None, None, None)
        if kind == "decode_tokens":       # (B,)
            return P(dp_ok())
        return None

    # -- parameters ------------------------------------------------------------
    def param_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> P:
        msize = self.axes["model"]

        def last_if_div(*, dim=-1):
            d = dim % len(shape)
            specs = [None] * len(shape)
            if shape[d] % msize == 0:
                specs[d] = "model"
            return P(*specs)

        name = path[-1]
        joined = "/".join(path)
        if name == "embed":
            spec = P("model" if shape[0] % msize == 0 else None, None)
            return self._maybe_fsdp(spec, shape)
        # attention: column-split (wq/wk/wv), row-split (wo)
        if name in ("wq", "wk", "wv"):
            return self._maybe_fsdp(last_if_div(), shape)
        if name == "wo":
            return self._maybe_fsdp(last_if_div(dim=-2), shape)
        # MLP: column-split w1/w3, row-split w2
        if name in ("w1", "w3"):
            if "moe" in joined:
                if self.moe_strategy == "ep" and shape[-3] % msize == 0:
                    return self._maybe_fsdp(
                        P(*([None] * (len(shape) - 3)), "model", None, None), shape
                    )
                return self._maybe_fsdp(last_if_div(), shape)
            return self._maybe_fsdp(last_if_div(), shape)
        if name == "w2":
            if "moe" in joined:
                if self.moe_strategy == "ep" and shape[-3] % msize == 0:
                    return self._maybe_fsdp(
                        P(*([None] * (len(shape) - 3)), "model", None, None), shape
                    )
                return self._maybe_fsdp(last_if_div(dim=-2), shape)
            return self._maybe_fsdp(last_if_div(dim=-2), shape)
        # mamba projections
        if name in ("z_proj", "x_proj"):
            return last_if_div()
        if name in ("b_proj", "c_proj", "dt_proj"):
            return last_if_div()
        if name == "out_proj":
            return last_if_div(dim=-2)
        if name in ("conv_x",):
            return last_if_div()
        # small: router, norms, convs for b/c, biases — replicated
        return P(*([None] * len(shape)))

    def _maybe_fsdp(self, spec: P, shape: Tuple[int, ...]) -> P:
        """FSDP: additionally shard the largest unsharded dim over 'data'
        (weights are gathered per layer during the forward pass)."""
        if not self.fsdp:
            return spec
        dsize = self.axes.get("data", 1)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        cands = [
            (shape[i], i) for i in range(len(shape))
            if entries[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize
        ]
        if not cands:
            return spec
        _, i = max(cands)
        entries[i] = "data"
        return P(*entries)

    def zero_spec(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Optimizer-state (and gradient-accumulator) spec: the parameter's
        TP spec plus a data-parallel split on the largest divisible dim —
        the distributed-optimizer / ZeRO sharding."""
        dsize = self.axes.get("data", 1)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        flat = [e for ent in entries if ent for e in (ent if isinstance(ent, tuple) else (ent,))]
        if "data" in flat:
            return P(*entries)   # already data-sharded (FSDP params)
        cands = [
            (shape[i], i) for i in range(len(shape))
            if entries[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize
        ]
        if not cands:
            return P(*entries)
        _, i = max(cands)
        entries[i] = "data"
        return P(*entries)

    def batch_spec(self, name: str, shape: Tuple[int, ...]) -> P:
        dp = dp_axes(self.mesh)
        lead: Tuple[str, ...] = ()
        for k in range(len(dp)):
            axes = dp[k:]
            n = 1
            for a in axes:
                n *= self.axes[a]
            if shape[0] % n == 0 and shape[0] >= n:
                lead = axes
                break
        return P(lead, *([None] * (len(shape) - 1)))


def make_plan(
    cfg: ModelConfig, mesh, *, fsdp: Optional[bool] = None,
    seq_parallel: bool = True,
) -> ShardingPlan:
    msize = axis_sizes(mesh)["model"]
    notes = {}
    if seq_parallel:
        notes["sp"] = "sequence-parallel residual stream (RS+AG instead of AR)"
    if fsdp is None:
        # bf16 params per chip beyond ~4 GB after TP -> shard over data too
        fsdp = cfg.param_count() * 2 / msize > 4e9
    if fsdp:
        notes["fsdp"] = "params sharded over data axis as well (per-chip budget)"

    if cfg.attention_free:
        attn = "none"
    elif cfg.n_heads % msize == 0:
        attn = "heads"
        if cfg.n_kv_heads % msize:
            notes["kv"] = f"kv heads {cfg.n_kv_heads} replicated (not divisible by {msize})"
    else:
        attn = "context"
        notes["attn"] = (
            f"q heads {cfg.n_heads} not divisible by model={msize}: "
            "context parallelism (q rows sharded over seq)"
        )
    if cfg.n_experts == 0:
        moe = "none"
    elif cfg.n_experts % msize == 0:
        moe = "ep"
    else:
        moe = "tp"
        notes["moe"] = (
            f"{cfg.n_experts} experts not divisible by model={msize}: "
            f"TP inside experts (d_ff {cfg.moe_d_ff})"
        )
    return ShardingPlan(cfg, mesh, attn, moe, fsdp, seq_parallel, notes)


class NamedSharding(NamedTuple):
    """A leaf's mesh, spec and DTensor placements (JAX's ``NamedSharding``
    with the placements it stands for)."""
    mesh: object
    spec: PartitionSpec
    placements: List


def named(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec, placements(spec, mesh))


def param_shardings(plan: ShardingPlan, params: Mapping, _path: Tuple[str, ...] = ()) -> Dict:
    """A tree keyed as ``params`` (tensors, meta tensors among them) of
    each leaf's ``NamedSharding``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = param_shardings(plan, v, _path + (k,))
        else:
            out[k] = named(plan.mesh, plan.param_spec(_path + (k,), tuple(v.shape)))
    return out


def zero_shardings(plan: ShardingPlan, params: Mapping) -> Dict:
    """A tree keyed as ``params`` of each leaf's ZeRO sharding: ``zero_spec``
    of its parameter spec (the gradient accumulator's layout)."""
    return _zip_map(
        lambda sh, v: named(plan.mesh, plan.zero_spec(sh.spec, tuple(v.shape))),
        param_shardings(plan, params), params,
    )


def _zip_map(fn, a: Mapping, b: Mapping) -> Dict:
    return {k: _zip_map(fn, v, b[k]) if isinstance(v, Mapping) else fn(v, b[k])
            for k, v in a.items()}


def distribute_tree(tree: Mapping, shardings: Mapping) -> Dict:
    """Each leaf of ``tree`` (the same value on every rank) as a DTensor
    laid out by its ``NamedSharding``."""
    return _zip_map(lambda sh, v: distribute_tensor(v, sh.mesh, sh.placements), shardings, tree)


def distribute_batch(plan: ShardingPlan, batch: Mapping) -> Dict[str, DTensor]:
    """Each array of a batch as a DTensor laid out by its ``batch_spec``."""
    return {
        k: distribute_tensor(v, plan.mesh, placements(plan.batch_spec(k, tuple(v.shape)),
                                                      plan.mesh))
        for k, v in batch.items()
    }


def write_region(t: torch.Tensor, value: torch.Tensor, starts: Mapping[int, int]) -> None:
    """``t[region] = value`` in place, the region starting at ``starts`` (dim
    -> index; 0 elsewhere) with ``value``'s extents.  A DTensor ``t`` is
    written on each rank's local shard, where the region meets it (an
    in-place write through a slice of a sharded dim would land in a
    redistributed copy)."""
    region = [slice(starts.get(d, 0), starts.get(d, 0) + value.shape[d]) for d in range(t.ndim)]
    if not isinstance(t, DTensor):
        t[tuple(region)] = value
        return
    if isinstance(value, DTensor):
        value = value.full_tensor()
    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    dst, src = [], []
    for d, r in enumerate(region):
        lo, hi = max(r.start, offset[d]), min(r.stop, offset[d] + shape[d])
        if lo >= hi:
            return                      # the region lies on other ranks
        dst.append(slice(lo - offset[d], hi - offset[d]))
        src.append(slice(lo - r.start, hi - r.start))
    t.to_local()[tuple(dst)] = value[tuple(src)]


def gather_tree(tree: Mapping) -> Dict:
    """Every DTensor leaf as its full tensor (a collective: every rank
    calls it); other leaves as they are."""
    return {
        k: gather_tree(v) if isinstance(v, Mapping)
        else v.full_tensor() if isinstance(v, DTensor) else v
        for k, v in tree.items()
    }


__all__ = [
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardingPlan",
    "axis_sizes",
    "distribute_batch",
    "distribute_tree",
    "dp_axes",
    "gather_tree",
    "make_plan",
    "named",
    "param_shardings",
    "placements",
    "write_region",
    "zero_shardings",
]
