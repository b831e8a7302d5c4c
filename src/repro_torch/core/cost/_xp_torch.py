"""A numpy-shaped namespace over torch for the engine's array programs.

The cost cores of :mod:`repro_torch.core.cost.analysis` and the cost
models' terms programs are written against the numpy calls they make
(``xp.maximum``, ``xp.take_along_axis``, ``axis=`` reductions...).
:func:`namespace` gives them the same calls on float64/int64 tensors of
one device, so the cores run unchanged on the card.

Bit-identity with numpy rests on three rules the cores keep and this
namespace does not break:

* every call is one eager torch op (or a view), so each ``a * b`` and
  each ``acc + a`` of a core is its own kernel and is rounded on its own:
  nothing contracts a multiply and an add into an FMA;
* no float reduction runs over fractional values (``sum``, ``mean``),
  whose CUDA tree order differs from numpy's pairwise sum: fractional
  accumulations go through ``ordered_sum`` one add at a time, and
  ``prod``/``cumprod`` only ever see integer-valued float64 below
  ``BATCH_EXACT_LIMIT``, where every order gives the same exact product;
* a host constant a core divides by becomes a 0-dim tensor on the device
  (:meth:`TorchNamespace.scalar`): torch's CUDA division by a CPU scalar
  multiplies by its reciprocal instead, which is not IEEE division.

Importing this module imports torch; :mod:`analysis` imports it only when
a torch backend is asked for, so the numpy engine and spawned sweep
workers never load torch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_DTYPES = {bool: torch.bool, float: torch.float64}


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


class TorchNamespace:
    """The numpy calls of the array programs, on one torch device."""

    float64 = torch.float64

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        # device copies of host constants, by value: the cores divide by
        # the same few bandwidths, frequencies and PE counts every dispatch.
        # Made at a program's first (eager) dispatch, they are read, never
        # copied, by the CUDA graph captured after it.
        self._scalars: Dict[float, torch.Tensor] = {}
        self._indices: Dict[tuple, torch.Tensor] = {}

    def _dtype(self, dtype):
        return _DTYPES.get(dtype, dtype) if dtype is not None else None

    # -- values that enter the program ---------------------------------- #
    def scalar(self, v) -> torch.Tensor:
        """A 0-dim float64 tensor on the device (a tensor passes through)."""
        if isinstance(v, torch.Tensor):
            return v
        key = float(v)
        t = self._scalars.get(key)
        if t is None:
            t = self._scalars[key] = torch.tensor(key, dtype=torch.float64,
                                                  device=self.device)
        return t

    def index(self, idx) -> torch.Tensor:
        """A host index list as an int64 tensor on the device, memoized by
        value like :meth:`scalar`."""
        key = tuple(int(i) for i in idx)
        t = self._indices.get(key)
        if t is None:
            t = self._indices[key] = torch.tensor(key, dtype=torch.int64,
                                                  device=self.device)
        return t

    def asarray(self, a, dtype=None) -> torch.Tensor:
        dtype = self._dtype(dtype)
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype or a.dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @staticmethod
    def astype(a, dtype):
        return a.to(dtype)

    # -- constructors --------------------------------------------------- #
    def ones(self, shape, dtype=torch.float64):
        return torch.ones(_shape(shape), dtype=self._dtype(dtype), device=self.device)

    def zeros(self, shape, dtype=torch.float64):
        return torch.zeros(_shape(shape), dtype=self._dtype(dtype), device=self.device)

    def full(self, shape, v, dtype=torch.float64):
        if isinstance(v, torch.Tensor):
            return v.to(self._dtype(dtype)).expand(_shape(shape)).clone()
        return torch.full(_shape(shape), v, dtype=self._dtype(dtype), device=self.device)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)

    # -- elementwise ---------------------------------------------------- #
    @staticmethod
    def maximum(a, b):
        if not isinstance(a, torch.Tensor):
            a, b = b, a
        if isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        return torch.clamp(a, min=b)

    @staticmethod
    def minimum(a, b):
        if not isinstance(a, torch.Tensor):
            a, b = b, a
        if isinstance(b, torch.Tensor):
            return torch.minimum(a, b)
        return torch.clamp(a, max=b)

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def ceil(a):
        return torch.ceil(a)

    # -- shape ---------------------------------------------------------- #
    @staticmethod
    def reshape(a, shape):
        return a.reshape(shape)

    @staticmethod
    def broadcast_to(a, shape):
        return a.expand(_shape(shape))

    @staticmethod
    def concatenate(seq, axis=0):
        return torch.cat(list(seq), dim=axis)

    @staticmethod
    def stack(seq, axis=0):
        return torch.stack(list(seq), dim=axis)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return torch.gather(a, axis, idx)

    # -- reductions and scans (integer-valued or exact: see the docstring) #
    @staticmethod
    def prod(a, axis):
        return torch.prod(a, dim=axis)

    @staticmethod
    def cumprod(a, axis):
        return torch.cumprod(a, dim=axis)

    @staticmethod
    def cummax(a, axis):
        return torch.cummax(a, dim=axis).values

    @staticmethod
    def max(a, axis=None):
        return torch.amax(a) if axis is None else torch.amax(a, dim=axis)

    @staticmethod
    def any(a, axis):
        return torch.any(a, dim=axis)

    @staticmethod
    def argmax(a, axis):
        return torch.argmax(a, dim=axis)


_NAMESPACES: Dict[str, TorchNamespace] = {}


def namespace(device) -> TorchNamespace:
    """The (memoized) namespace of one device: ``"cuda"``, ``"cpu"``..."""
    key = str(torch.device(device))
    ns = _NAMESPACES.get(key)
    if ns is None:
        ns = _NAMESPACES[key] = TorchNamespace(key)
    return ns
