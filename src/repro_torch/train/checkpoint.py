"""Checkpointing: atomic, async-capable, device-independent restore — the
port of the JAX package's ``train/checkpoint.py``, in its on-disk format.

Arrays are saved *logically* (host copies, flattened tree paths in one
``.npz``): keys ``params||<path>`` and ``opt||<path>``, the path's parts
joined by ``SEP`` in the JAX package's tree order (sorted dict keys), so a
file written by either package restores in the other.  Writes go to a temp
file + atomic rename, a ``step-XXXXXXXX.json`` carries the step and the
data cursor, and ``keep_last`` old checkpoints are retained for corruption
fallback.  numpy has no bfloat16 here, so a bf16 leaf is stored as its
16-bit pattern (``uint16``) and its key listed under ``"bf16"`` in the
JSON; restore reads it back bit for bit.

Sharded states: ``save_checkpoint`` gathers each DTensor leaf with
``full_tensor()`` on every rank (the call is a collective) and writes on
rank 0 only, so the file stays logical and unsharded;
``restore_checkpoint(..., shardings=...)`` lays each leaf out on its
target mesh (any mesh: the file knows none).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.model import _leaves

SEP = "||"
_BF16 = "bf16"


def _flatten(prefix: str, tree: Mapping) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Host copies of every leaf by its key, ``prefix`` and the path joined
    by ``SEP``, and the keys of the bf16 leaves (stored as ``uint16``)."""
    flat, bf16 = {}, []
    for path, leaf in _leaves(tree):
        key = SEP.join([prefix, *path.split("/")])
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, bf16


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    params: Mapping,
    opt_state: Mapping,
    data_state: Dict,
    *,
    keep_last: int = 3,
    async_save: bool = False,
) -> Optional[threading.Thread]:
    """Every tensor is copied to the host before this returns (or before
    the writer thread starts, under ``async_save``), so the caller may
    update its tensors in place at once.  In a process group every rank
    calls this (DTensor leaves are gathered collectively) and rank 0 alone
    writes; the others return None."""
    arrays, bf16 = _flatten("params", params)
    opt_arrays, opt_bf16 = _flatten("opt", opt_state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays.update(opt_arrays)
    meta = {"step": step, "data": data_state}
    if bf16 or opt_bf16:
        meta[_BF16] = bf16 + opt_bf16

    def write():
        tmp = os.path.join(ckpt_dir, f".tmp-{step}.npz")
        final = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
        np.savez(tmp, **arrays)
        # verify readable before commit
        with np.load(tmp) as z:
            if len(z.files) != len(arrays):
                raise OSError(f"checkpoint {tmp}: {len(z.files)} arrays read, {len(arrays)} written")
        os.replace(tmp, final)
        with open(os.path.join(ckpt_dir, f"step-{step:08d}.json"), "w") as f:
            json.dump(meta, f)
        _gc(ckpt_dir, keep_last)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step-{s:08d}{ext}"))
            except FileNotFoundError:
                pass


def latest_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("step-") and f.endswith(".npz"):
            out.append(int(f[5:13]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(
    ckpt_dir: str,
    step: int,
    params_template: Mapping,
    opt_template: Mapping,
    shardings: Optional[Tuple[Optional[Mapping], Optional[Mapping]]] = None,
) -> Tuple[Dict, Dict, Dict]:
    """Rebuild (params, opt_state, meta): each array in its template leaf's
    dtype, on its device; ``meta`` as it was saved (``{"step", "data"}``).
    ``shardings``: optional (params, opt) trees of ``NamedSharding``s
    matching the templates (either may be None) for the target mesh; each
    leaf is then a DTensor laid out by its sharding."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    with open(os.path.join(ckpt_dir, f"step-{step:08d}.json")) as f:
        meta = json.load(f)
    bf16 = set(meta.pop(_BF16, ()))

    def leaf(key: str, template: torch.Tensor, sh) -> torch.Tensor:
        arr = data[key]
        if key in bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if sh is None:
            return t.to(device=template.device, dtype=template.dtype)
        t = t.to(device=sh.mesh.device_type, dtype=template.dtype)
        return distribute_tensor(t, sh.mesh, sh.placements)

    def rebuild(prefix: str, template: Mapping, shards: Optional[Mapping], at: str = "") -> Dict:
        return {
            k: rebuild(prefix, v, None if shards is None else shards[k], f"{at}{k}{SEP}")
            if isinstance(v, Mapping)
            else leaf(f"{prefix}{SEP}{at}{k}", v, None if shards is None else shards[k])
            for k, v in template.items()
        }

    p_sh, o_sh = shardings if shardings is not None else (None, None)
    return (rebuild("params", params_template, p_sh), rebuild("opt", opt_template, o_sh),
            meta)


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "latest_steps"]
