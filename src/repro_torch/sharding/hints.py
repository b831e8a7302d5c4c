"""Activation-sharding hints for model code (port of ``repro/sharding/hints.py``).

Model code is mesh-agnostic; the launcher installs a hint context (dp
axes / tp axis / sp axis + mesh axis sizes) and the model calls
``shard_hint(x, "dp", None, "tp")`` where a layout matters (logits, MoE
dispatch buffers, the residual stream). Outside a hint context, and on a
plain tensor, a hint is a no-op; on a ``DTensor`` it redistributes to the
resolved placements. Divisibility-guarded per dim.

Unlike the reference's ``with_sharding_constraint``, which swallows any
error, a redistribute that fails raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

from repro_torch.sharding.specs import P, placements

_STATE = {"enabled": False, "dp": None, "tp": None, "sp": None, "sizes": {}}


def set_hints(dp=None, tp=None, sp=None, sizes: Optional[Dict[str, int]] = None) -> None:
    _STATE.update(enabled=True, dp=dp, tp=tp, sp=sp, sizes=dict(sizes or {}))


def clear_hints() -> None:
    _STATE.update(enabled=False, dp=None, tp=None, sp=None, sizes={})


@contextlib.contextmanager
def hints(dp=None, tp=None, sp=None, sizes: Optional[Dict[str, int]] = None):
    old = dict(_STATE)
    set_hints(dp, tp, sp, sizes)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)


def hints_from_mesh(mesh, rules=None) -> None:
    """Install hints matching a ``DeviceMesh`` + ShardingRules."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    fsdp_only = rules is not None and getattr(rules, "fsdp_only", False)
    pool = ("pod", "data", "model") if fsdp_only else ("pod", "data")
    dp = tuple(a for a in pool if a in sizes)
    tp = "model" if ("model" in sizes and not fsdp_only) else None
    sp = tp if (rules is not None and getattr(rules, "seq_shard_activations", False)) else None
    _STATE["mesh"] = mesh
    _STATE["ep_shardmap"] = bool(rules is not None and getattr(rules, "ep_shardmap", False))
    set_hints(dp=dp if dp else None, tp=tp, sp=sp, sizes=sizes)


def _resolve(token):
    if token is None:
        return None
    if isinstance(token, str) and token in ("dp", "tp", "sp"):
        return _STATE[token]
    return token  # literal axis name or tuple


def hint_spec(shape, *pattern) -> P:
    """The spec ``shard_hint`` resolves for a tensor of ``shape`` under the
    installed hints: each axis used at most once, a dim not divisible by
    its axes' product replicated."""
    sizes = _STATE["sizes"]
    spec_entries = []
    used: set = set()
    for dim, token in zip(shape, pattern):
        ax = _resolve(token)
        if ax is None:
            spec_entries.append(None)
            continue
        axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,)) if a not in used)
        if not axes:
            spec_entries.append(None)
            continue
        n = math.prod(sizes.get(a, 1) for a in axes)
        if n > 0 and dim % n == 0:
            used.update(axes)
            spec_entries.append(axes if len(axes) > 1 else axes[0])
        else:
            spec_entries.append(None)
    spec_entries += [None] * (len(shape) - len(spec_entries))
    return P(*spec_entries)


def shard_hint(x, *pattern):
    """pattern entries: 'dp' | 'tp' | 'sp' | None | literal axis name."""
    if not _STATE["enabled"]:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements(hint_spec(tuple(x.shape), *pattern), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
