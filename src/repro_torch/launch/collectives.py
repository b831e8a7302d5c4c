"""Collective traffic of a traced step (the counterpart of
``repro/launch/hloparse.py``; the roofline's third term).

The reference sums the output arrays of every collective in the compiled
HLO text. The port produces no HLO, so nothing here parses text: the
collectives are recorded as the step issues them. :class:`CollectiveCounter`
is a ``TorchDispatchMode`` that sees every ``c10d`` and ``_c10d_functional``
op (a ``torch.distributed`` call, a DTensor redistribution), with its kind,
its output bytes and the size of its group, read from the op's process
group. The byte conventions per kind are the reference's ring conventions:

  all-gather        bytes_out x (n-1)/n      (each device receives the rest)
  all-reduce        bytes    x 2(n-1)/n      (reduce-scatter + all-gather)
  reduce-scatter    bytes_in x (n-1)/n  == bytes_out x (n-1)
  all-to-all        bytes    x (n-1)/n
  collective-permute bytes_out              (one hop; a point-to-point send)

Broadcasts and receives are not among these kinds and are not counted.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

#: op name -> (kind, where its output is: "arg0" (the first argument,
#: written in place) or "result")
_OPS = {
    "allreduce_": ("all-reduce", "arg0"),
    "allreduce_coalesced_": ("all-reduce", "arg0"),
    "all_reduce": ("all-reduce", "result"),
    "all_reduce_": ("all-reduce", "arg0"),
    "all_reduce_coalesced": ("all-reduce", "result"),
    "all_reduce_coalesced_": ("all-reduce", "arg0"),
    "allgather_": ("all-gather", "arg0"),
    "_allgather_base_": ("all-gather", "arg0"),
    "allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "all_gather_into_tensor": ("all-gather", "result"),
    "all_gather_into_tensor_out": ("all-gather", "result"),
    "all_gather_into_tensor_coalesced": ("all-gather", "result"),
    "reduce_scatter_": ("reduce-scatter", "arg0"),
    "_reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "reduce_scatter_tensor": ("reduce-scatter", "result"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "result"),
    "alltoall_": ("all-to-all", "arg0"),
    "alltoall_base_": ("all-to-all", "arg0"),
    "all_to_all_single": ("all-to-all", "result"),
    "send": ("collective-permute", "arg0"),
}


def link_bytes(kind: str, bytes_out: float, n: int) -> float:
    """Bytes one device moves over its links for a collective of ``kind``
    whose output holds ``bytes_out`` bytes, in a group of ``n``."""
    if kind == "all-gather":
        return bytes_out * (n - 1) / max(1, n)
    if kind == "all-reduce":
        return bytes_out * 2 * (n - 1) / max(1, n)
    if kind == "reduce-scatter":
        return bytes_out * (n - 1)
    if kind == "all-to-all":
        return bytes_out * (n - 1) / max(1, n)
    if kind == "collective-permute":
        return bytes_out
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    raw_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    link_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # the reference's tally of HLO dtypes it cannot size; every torch dtype
    # has a size, so it stays empty (its row() keys are kept for the readers)
    unknown_dtypes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())

    @property
    def skipped_bytes(self) -> float:
        return float(sum(self.unknown_dtypes.values()))

    def add(self, kind: str, bytes_out: float, n: int) -> None:
        """One collective of ``kind`` with ``bytes_out`` output bytes in a
        group of ``n``."""
        link = link_bytes(kind, bytes_out, n)
        self.counts[kind] += 1
        self.raw_bytes[kind] += bytes_out
        self.link_bytes[kind] += link

    def row(self) -> Dict[str, float]:
        out = {"collective_bytes": self.total_link_bytes}
        for k in _COLLECTIVES:
            out[f"{k}_count"] = self.counts.get(k, 0)
            out[f"{k}_bytes"] = self.link_bytes.get(k, 0.0)
        out["unknown_dtype_count"] = len(self.unknown_dtypes)
        out["skipped_bytes"] = self.skipped_bytes
        return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _group_size(func, args, kwargs) -> int:
    """The size of the op's group: its ``group_size`` argument, else its
    process group's (a ``ProcessGroup`` argument, or one named by
    ``group_name``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    if "process_group" in named:  # a ScriptObject boxing the group
        return dist.ProcessGroup.unbox(named["process_group"]).size()
    raise ValueError(f"{func}: no process group among its arguments")


def record(stats: CollectiveStats, func, args, kwargs, out) -> None:
    """Add ``func`` to ``stats`` if it is a collective."""
    if func.namespace not in _NAMESPACES or func._opname not in _OPS:
        return
    kind, where = _OPS[func._opname]
    if where == "result":
        got = out
    else:
        got = args[0] if args else next(iter(kwargs.values()))
    stats.add(kind, float(_nbytes(got)), _group_size(func, args, kwargs or {}))


class CollectiveCounter(TorchDispatchMode):
    """Records every collective issued under it into ``self.stats``.
    DTensor ops are left to DTensor, so a redistribution is seen as the
    collectives it issues."""

    def __init__(self) -> None:
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        record(self.stats, func, args, kwargs, out)
        return out
