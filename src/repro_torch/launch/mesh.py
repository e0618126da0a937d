"""Process groups and meshes — the port of the JAX package's
``launch/mesh.py`` on ``torch.distributed``.

Defined as functions (never module-level constants), so importing this
module starts no process group.  Single pod: 16x16 = 256 ranks (data,
model); multi-pod: 2x16x16 = 512 ranks (pod, data, model), the ``pod`` axis
an outer data-parallel axis by default (optionally a pipeline axis, see
``distributed/pipeline.py``).  These are the JAX shapes, so the planner's
specs compare spec for spec with the JAX package's.

A device mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over an
initialised process group of exactly its size (``init_distributed``: NCCL
for ``"cuda"``, gloo for ``"cpu"``, and for ``"fake"`` PyTorch's fake
backend: a world of any size in one process, this process its rank 0,
whose collectives move nothing — the dry run's, ``launch/dryrun.py``, on
meta tensors).  ``make_abstract_mesh`` is the
device-free counterpart of JAX's ``AbstractMesh`` for spec math: the
planner runs on either.  The entry points run on the card unless the
caller asks for the CPU, and raise where no GPU is visible.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import ContextManager, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo", "fake": "fake"}
# the DeviceMesh device type of each: a fake world's mesh holds no data
MESH_DEVICE = {"cuda": "cuda", "cpu": "cpu", "fake": "cpu"}


def _check_device_type(device_type: str) -> None:
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {tuple(BACKENDS)}: {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type='cuda' but no CUDA device is visible; pass device_type='cpu' "
            "for a gloo group on the CPU"
        )


def init_distributed(
    device_type: str = "cuda", *, init_method: Optional[str] = None,
    rank: int = -1, world_size: int = -1,
) -> None:
    """Initialise the default process group: NCCL for ``"cuda"`` (each rank
    on card ``rank % device_count``), gloo for ``"cpu"``; never gloo for
    CUDA tensors.  ``init_method`` is ``torch.distributed``'s
    (``"file:///path"`` or ``"tcp://localhost:<port>"``; ``None`` reads the
    ``env://`` variables), as are ``rank`` and ``world_size`` (-1: from the
    environment).  ``"fake"``: a world of ``world_size`` ranks in this one
    process, as rank ``rank`` (0 when -1), through PyTorch's fake backend
    and its in-process store (``torch.testing._internal.distributed.
    fake_pg``); no other process takes part and no collective moves data.
    Raises when ``"cuda"`` is asked and no GPU is visible, or when a group
    is already initialised."""
    _check_device_type(device_type)
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    if device_type == "fake":
        # importing the module registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if world_size < 1:
            raise ValueError("a fake world needs its world_size")
        dist.init_process_group("fake", store=FakeStore(), rank=max(rank, 0),
                                world_size=world_size)
        return
    dist.init_process_group(
        BACKENDS[device_type], init_method=init_method, rank=rank, world_size=world_size
    )
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(
    axis_shapes: Sequence[int], axis_names: Sequence[str], *, device_type: str = "cuda"
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    initialised process group, which must have exactly ``prod(axis_shapes)``
    ranks."""
    _check_device_type(device_type)
    shape, names = tuple(axis_shapes), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"{len(shape)} axis sizes for {len(names)} names")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_distributed)")
    if (device_type == "fake") != (dist.get_backend() == "fake"):
        raise RuntimeError(
            f"a {device_type!r} mesh over a {dist.get_backend()!r} process group; "
            "init_distributed with the same device_type"
        )
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"a {shape} mesh needs {math.prod(shape)} ranks; the process group has "
            f"{dist.get_world_size()}"
        )
    return init_device_mesh(MESH_DEVICE[device_type], shape, mesh_dim_names=names)


class AbstractMesh:
    """A device-free mesh for spec math, as JAX's ``AbstractMesh``:
    ``.shape`` maps each axis name to its size (in mesh order),
    ``.axis_names`` and ``.size``."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"{len(axis_shapes)} axis sizes for {len(axis_names)} names")
        self.shape = OrderedDict(zip(axis_names, (int(n) for n in axis_shapes)))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


def make_abstract_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(axis_shapes, axis_names)


def mesh_context(mesh: DeviceMesh) -> ContextManager:
    """The mesh as the current one (``DeviceMesh``'s own context manager,
    the counterpart of ``jax.set_mesh``)."""
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1-rank mesh with the production axis names."""
    return make_mesh((1, 1), ("data", "model"), device_type=device_type)


__all__ = [
    "AbstractMesh",
    "init_distributed",
    "make_abstract_mesh",
    "make_host_mesh",
    "make_mesh",
    "make_production_mesh",
    "mesh_context",
]
