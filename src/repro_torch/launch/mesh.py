"""Mesh builders (port of ``repro/launch/mesh.py``) on ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the ranks of the default process group,
which the caller has initialised (``torchrun``'s environment, or a file
store in the tests): one rank per device, ``device_type`` the entry
point's device (``"cuda"`` with NCCL, ``"cpu"`` with gloo).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed process group "
                           "(run under torchrun)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's target mesh: one pod = 16x16 = 256 ranks (data,
    model); multi-pod = 2 pods x 256 = 512 ranks (pod, data, model). Built
    only where the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = _world()
    if world != need:
        raise RuntimeError(f"mesh {shape} needs {need} devices, found {world}")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device_type: str = "cuda") -> DeviceMesh:
    """Arbitrary mesh over the first prod(shape) ranks, for elastic
    re-configuration and debug runs. Every rank of the world calls it."""
    need = math.prod(shape)
    if _world() < need:
        raise RuntimeError(f"mesh {tuple(shape)} needs {need} devices")
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(*, device_type: str = "cpu") -> DeviceMesh:
    """Debug mesh over every rank: (data=N, model=1)."""
    return make_mesh((_world(), 1), ("data", "model"), device_type=device_type)
