"""Placing whole tensors on a ``DeviceMesh`` by DTensor placements, with no
communication: every rank holds (or memory-maps) the whole value and keeps
its own slice. The counterpart of ``jax.make_array_from_callback``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard


def local_index(shape: Sequence[int], mesh, placements) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of ``shape``: a dim sharded over
    several mesh dims is split by them in mesh-dim order, as DTensor splits
    it. Every split must be even (the rules' divisibility guards)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    offs, sizes = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if sizes[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not split over "
                                 f"{n} ranks of mesh dim {i}")
            sizes[pl.dim] //= n
            offs[pl.dim] += coord[i] * sizes[pl.dim]
    return tuple(slice(o, o + s) for o, s in zip(offs, sizes))


def _contiguous_stride(shape) -> tuple:
    if len(shape) == 0:
        return ()
    return tuple(int(x) for x in np.cumprod((list(shape)[1:] + [1])[::-1])[::-1])


def from_full(full, mesh, placements, *, device=None, dtype=None, copy: bool = True) -> DTensor:
    """A DTensor of ``full`` (a tensor or numpy array, e.g. memory-mapped)
    from a copy of this rank's slice of it. ``copy=False``: where the slice
    is all of ``full`` (and has the device and dtype), ``full`` itself."""
    piece = full[local_index(full.shape, mesh, placements)]
    if not isinstance(piece, torch.Tensor):
        piece = torch.from_numpy(np.ascontiguousarray(piece))
    copy = copy or tuple(piece.shape) != tuple(full.shape)  # a part must not hold the whole
    local = piece.to(device=device or piece.device, dtype=dtype or piece.dtype, copy=copy)
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(full.shape), stride=_contiguous_stride(full.shape))


def is_sharded(t) -> bool:
    """A DTensor whose local tensor is less than the whole."""
    return isinstance(t, DTensor) and any(
        isinstance(pl, Shard) and t.device_mesh.size(i) > 1 for i, pl in enumerate(t.placements))


def full_value(t) -> torch.Tensor:
    """The whole value of a tensor or DTensor (an all-gather where it is
    sharded over more than one rank)."""
    if not isinstance(t, DTensor):
        return t
    return t.full_tensor() if is_sharded(t) else t.to_local()
