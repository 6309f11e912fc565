"""Production mesh definitions.

A mesh here is a description, axis names and sizes, with no device behind
it: the sharding rules (``launch/sharding.py``) key on it and the dry run
(``launch/dryrun.py``) counts bytes against it. The reference's production
meshes are kept: 16×16 ``("data", "model")`` = 256 devices, and the
multi-pod mesh with a leading ``"pod"`` axis, 2×16×16 = 512.
:func:`device_mesh` builds a ``torch.distributed`` ``DeviceMesh`` of the
same shape over the process group the caller has initialized (the dry run's
fake one), for DTensor placement.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh() -> Mesh:
    """The local cards (one device where there is none): 1-D data mesh."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return Mesh(("data",), (max(n, 1),))


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(mesh.shape)


def device_mesh(mesh: Mesh):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over the default
    process group, whose world size must be ``mesh.size``. Its device type
    is "cpu": DTensor's sharding propagation builds fake tensors of the
    mesh's device type, which a CPU-only torch cannot make for "cuda"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialized process group")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"process group of {dist.get_world_size()} ranks, "
                         f"mesh {mesh.axis_sizes} of {mesh.size}")
    ranks = torch.arange(mesh.size).reshape(mesh.axis_sizes)
    return DeviceMesh("cpu", ranks, mesh_dim_names=mesh.axis_names)
