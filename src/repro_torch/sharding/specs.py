"""Partition rules for every architecture family (port of
``repro/sharding/specs.py``).

These rules are a Union mapping projected onto the mesh levels: the
spatial tile at the 'pod'/'data' levels is the batch split (DP), the
spatial tile at the 'model' level is the head/expert/ff split (TP/EP), and
FSDP shards a weight's remaining big dim over 'data' (ZeRO-3).
Divisibility-guarded: a dim not divisible by its mesh axis size is
replicated.

A spec is a :class:`P`: a tuple with one entry per tensor dim, each
``None``, an axis name or a tuple of axis names (the reference's
``PartitionSpec``, entry for entry). The rules themselves need no torch;
``placements`` translates a spec into DTensor placements on a
``DeviceMesh`` and ``named`` does so for a whole tree.

The rules are keyed on the reference's parameter paths and shapes: the
repeating units stacked on a leading ``units`` axis, dense weights
``(in, out)``. A port parameter ``blocks.<i>.<rest>`` is unit ``i // P``
of the reference leaf ``units.b<i % P>.<rest>`` (P = len(block_pattern)),
the map of ``models/convert.py`` and of the checkpoint format. So each
port leaf's spec is its reference leaf's spec, judged on the stacked
shape (``fsdp_min_elems`` counts every unit), with the unit dim dropped:
the one dim that differs. ``Dense.w`` is ``(in, out)`` in both packages,
so no dim is transposed. Decode caches map the same way: the port's list
of per-layer dicts, prefix layers first, is the reference's ``prefix``
list and ``units.b<j>`` stack.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``. As in
    ``PartitionSpec``, a one-axis tuple is that axis and an empty one None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """Knobs for the sharding strategy (the reference's fields and defaults)."""

    fsdp: bool = True  # shard params' non-TP dim over 'data' (train)
    fsdp_min_elems: int = 65536  # replicate small tensors
    # weight-gathered serving: at inference, also shard weights over 'data'
    # when the TP-sharded weights alone would exceed this budget
    inference_weight_budget: int = 8 * (1 << 30)
    # sequence parallelism on the residual stream (batch specs put the
    # sequence over 'model')
    seq_shard_activations: bool = True
    shard_cache_heads: bool = True  # prefer head-sharding of KV caches
    expert_axis: str = "model"  # EP axis
    tp_axis: str = "model"
    dp_over_pod: bool = True  # batch also split over 'pod'
    # pure-FSDP (ZeRO-3) mode: 'model' joins data parallelism, no TP
    fsdp_only: bool = False
    # route MoE layers through the all-to-all expert-parallel layer
    # (models/moe_ep.py)
    ep_shardmap: bool = False
    # remat policy of the unit stack: 'full' or 'save_block_outputs'
    remat_policy: str = "full"


# dense-param orientation sets (keys are the owning module names)
_COL = {
    "wq", "wk", "wv", "gate", "up", "in_z", "in_x", "in_dt", "lm_head",
    "kv_up", "kv_down", "w_i", "w_f", "wx", "ffn_up", "l1",
}
_ROW = {"wo", "down", "out_proj", "ffn_down", "l2", "frontend_proj"}
_REPL = {"router", "in_B", "in_C"}


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``, ``shape``)
    or of any object with the reference mesh's ``axis_names`` and
    ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh, rules: ShardingRules):
    pool = ("pod", "data", "model") if rules.fsdp_only else ("pod", "data")
    names = _axis_sizes(mesh)
    axes = [a for a in pool if a in names]
    if not rules.dp_over_pod:
        axes = [a for a in axes if a != "pod"]
    return tuple(axes)


def _maybe(axis: Optional[str], dim: int, sizes: Dict[str, int]) -> Optional[str]:
    if axis is None or axis not in sizes:
        return None
    return axis if dim % sizes[axis] == 0 else None


def _maybe_dp(axes: Tuple[str, ...], dim: int, sizes: Dict[str, int]):
    if not axes:
        return None
    n = math.prod(sizes[a] for a in axes)
    return axes if dim % n == 0 else None


def _maybe_any(ax, dim: int, sizes: Dict[str, int]):
    """_maybe for either a single axis name or a tuple of axes."""
    if ax is None:
        return None
    if isinstance(ax, tuple):
        return _maybe_dp(ax, dim, sizes)
    return _maybe(ax, dim, sizes)


# --------------------------------------------------------------------- #
# the port's leaves in the reference's layout
# --------------------------------------------------------------------- #
def _reference_keys(name: str, n_pattern: int) -> Tuple[list, bool]:
    """Port parameter name -> (the reference path's keys as the rules read
    them, stacked over units). List indices read as ``[i]``, as
    ``str(SequenceKey)`` does."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ["units", f"b{int(parts[1]) % n_pattern}", *parts[2:]], True
    if parts[0] == "prefix":
        return ["prefix", f"[{int(parts[1])}]", *parts[2:]], False
    return parts, False


def _shapes(tree) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a module's parameters or of a {name: tensor/shape} dict."""
    items = tree.named_parameters() if hasattr(tree, "named_parameters") else tree.items()
    return {k: tuple(getattr(v, "shape", v)) for k, v in items}


def _stacked_shape(cfg: ModelConfig, shape: Tuple[int, ...], stacked: bool) -> Tuple[int, ...]:
    if not stacked:
        return shape
    n_units = (cfg.n_layers - cfg.first_k_dense) // len(cfg.block_pattern)
    return (n_units, *shape)


# --------------------------------------------------------------------- #
# parameter specs
# --------------------------------------------------------------------- #
def param_specs(
    params,  # a Model, or {port parameter name: tensor or shape}
    cfg: ModelConfig,
    mesh,
    rules: ShardingRules = ShardingRules(),
    for_training: bool = True,
) -> Dict[str, P]:
    """{port parameter name: spec}, by the reference's rules on the
    reference leaf (see the module docstring)."""
    sizes = _axis_sizes(mesh)
    tp = None if rules.fsdp_only else rules.tp_axis
    fsdp_ax = "data" if (rules.fsdp and for_training and "data" in sizes) else None
    if rules.fsdp_only:
        fsdp_ax = tuple(a for a in ("data", "model") if a in sizes) or None
    if not for_training and "data" in sizes:
        # weight-gathered serving for models whose TP-sharded weights
        # exceed the per-chip budget
        tp_n = max(1, sizes.get(tp, 1))
        e = cfg.n_routed_experts
        expert_p = (
            (cfg.n_layers - cfg.first_k_dense) * e * 3 * cfg.d_model * cfg.d_expert
            if e else 0
        )
        dense_p = cfg.num_params() - expert_p
        eff = dense_p / tp_n + expert_p / (tp_n if (e and e % tp_n == 0) else 1)
        if 2 * eff > rules.inference_weight_budget:
            fsdp_ax = "data"

    def leaf_spec(keys, shape) -> P:
        stacked = keys and keys[0] == "units"  # leading unit axis
        off = 1 if stacked else 0
        body = shape[off:]
        name = keys[-1]
        owner = keys[-2] if name in ("w", "b") and len(keys) >= 2 else name

        def wrap(*spec_body):
            return P(*([None] * off), *spec_body)

        big = math.prod(shape) >= rules.fsdp_min_elems

        # ---- embeddings & head ---------------------------------------- #
        if name == "embed":
            return wrap(_maybe(tp, body[0], sizes),
                        _maybe_any(fsdp_ax, body[1], sizes) if big else None)
        # ---- norm scales / small vectors ------------------------------- #
        if len(body) == 1:
            if owner in _COL and name == "b":
                return wrap(_maybe(tp, body[0], sizes))
            if name in ("A_log", "D", "dt_bias", "conv_x_b"):
                return wrap(_maybe(tp, body[0], sizes))
            return wrap(None)
        # ---- MoE expert banks (E, d, de) / (E, de, d) ------------------- #
        if owner in ("w_gate", "w_up", "w_down") or name in ("w_gate", "w_up", "w_down"):
            e_ax = (None if rules.fsdp_only
                    else _maybe(rules.expert_axis, body[0], sizes))
            d_ax = _maybe_any(fsdp_ax, body[1], sizes) if big else None
            return wrap(e_ax, d_ax, None)
        # ---- depthwise convs (W, C) ------------------------------------ #
        if name.startswith("conv_") and name.endswith("_w"):
            ch_ax = _maybe(tp, body[1], sizes) if name == "conv_x_w" else None
            return wrap(None, ch_ax)
        if name == "conv_w":
            return wrap(None, _maybe(tp, body[1], sizes))
        # ---- sLSTM recurrent (4, nh, hd, hd) ---------------------------- #
        if name == "r":
            return wrap(None, None, _maybe(tp, body[2], sizes), None)
        # ---- dense weights ---------------------------------------------- #
        if owner in _COL:
            col = _maybe(tp, body[-1], sizes)
            row = _maybe_any(fsdp_ax, body[0], sizes) if (big and col != fsdp_ax) else None
            return wrap(row, *([None] * (len(body) - 2)), col)
        if owner in _ROW:
            row = _maybe(tp, body[0], sizes)
            col = _maybe_any(fsdp_ax, body[-1], sizes) if (big and row != fsdp_ax) else None
            return wrap(row, *([None] * (len(body) - 2)), col)
        # _REPL and everything else: replicate
        return wrap(*([None] * len(body)))

    n_pattern = len(cfg.block_pattern)
    out = {}
    for name, shape in _shapes(params).items():
        keys, stacked = _reference_keys(name, n_pattern)
        spec = leaf_spec(keys, _stacked_shape(cfg, shape, stacked))
        out[name] = P(*spec[1:]) if stacked else spec  # the unit dim dropped
    return out


# --------------------------------------------------------------------- #
# batch / cache / state specs
# --------------------------------------------------------------------- #
def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules: ShardingRules = ShardingRules()) -> Dict[str, P]:
    dp = dp_axes(mesh, rules)
    seq_ax = (rules.tp_axis if rules.seq_shard_activations else None)
    if rules.fsdp_only:
        seq_ax = None  # 'model' already consumed by the batch axis
    sizes = _axis_sizes(mesh)
    # divisibility guard: when the global batch cannot split over the full
    # dp pool, keep batch on (pod, data) and move 'model' back to the
    # sequence axis
    if _maybe_dp(dp, shape.global_batch, sizes) is None:
        narrower = tuple(a for a in dp if a != rules.tp_axis)
        if rules.fsdp_only and _maybe_dp(narrower, shape.global_batch, sizes):
            dp, seq_ax = narrower, rules.tp_axis
        else:
            dp = None

    def tok_spec(ndim: int) -> P:
        return P(dp if dp else None, seq_ax, *([None] * (ndim - 2)))

    specs: Dict[str, P] = {}
    if cfg.frontend == "audio_stub":
        specs["frames"] = tok_spec(3)
        specs["labels"] = tok_spec(2)
    else:
        specs["tokens"] = tok_spec(2)
        if cfg.frontend == "vision_stub" and shape.kind in ("train", "prefill"):
            specs["patch_embeds"] = tok_spec(3)
    return specs


def cache_specs(cache, cfg: ModelConfig, mesh,
                rules: ShardingRules = ShardingRules()) -> list:
    """Specs of the port's decode cache (``models.model.init_cache``: a list
    of per-layer dicts, prefix layers first), one dict per layer."""
    sizes = _axis_sizes(mesh)
    tp = None if rules.fsdp_only else rules.tp_axis
    dp = dp_axes(mesh, rules)

    def leaf_spec(name, shape, stacked) -> P:
        off = 1 if stacked else 0
        body = shape[off:]

        def wrap(*spec_body):
            return P(*([None] * off), *spec_body)

        bdp = _maybe_dp(dp, body[0], sizes)
        # batch-1 long-context decode: the cache sequence axis takes the dp axes
        seq_dp = None if bdp else _maybe_dp(dp, body[1] if len(body) > 1 else 0, sizes)
        if name in ("k", "v"):
            # (b, S, hkv, hd): heads over model if divisible, else sequence
            if rules.shard_cache_heads and body[2] % sizes.get(tp, 1) == 0:
                return wrap(bdp, seq_dp, tp, None)
            return wrap(bdp, seq_dp or _maybe(tp, body[1], sizes), None, None)
        if name in ("ckv", "krope"):
            return wrap(bdp, seq_dp or _maybe(tp, body[1], sizes), None)
        if name in ("conv", "conv_x", "conv_B", "conv_C"):
            return wrap(bdp, None, _maybe(tp, body[2], sizes))
        if name == "state":  # (b, nh, hp, n)
            return wrap(bdp, _maybe(tp, body[1], sizes), None, None)
        if name == "C":  # (b, nh, dk, dv)
            if body[1] % sizes.get(tp, 1) == 0:
                return wrap(bdp, tp, None, None)
            return wrap(bdp, None, _maybe(tp, body[2], sizes), None)
        if name in ("n", "c", "h"):  # (b, nh, dk)
            if body[1] % sizes.get(tp, 1) == 0:
                return wrap(bdp, tp, None)
            return wrap(bdp, None, _maybe(tp, body[2], sizes))
        if name == "m":  # (b, nh)
            return wrap(bdp, _maybe(tp, body[1], sizes))
        return wrap(bdp, *([None] * (len(body) - 1)))

    out = []
    for i, layer in enumerate(cache):
        stacked = i >= cfg.first_k_dense  # a unit's layer: a slice of units.b<j>
        specs = {}
        for name, t in layer.items():
            spec = leaf_spec(name, _stacked_shape(cfg, tuple(t.shape), stacked), stacked)
            specs[name] = P(*spec[1:]) if stacked else spec
        out.append(specs)
    return out


def state_specs(state, cfg: ModelConfig, mesh, rules: ShardingRules = ShardingRules()) -> Dict:
    """Train-state specs for the port's ``{"model", "opt"}``, in the
    reference's ``{"params", "opt"}`` structure: optimizer moments and
    master mirror the parameter specs; the step is a scalar."""
    pspecs = param_specs(state["model"], cfg, mesh, rules, for_training=True)
    out = {"params": pspecs, "opt": {}}
    for k, sub in state["opt"].items():
        out["opt"][k] = P() if k == "step" else param_specs(sub, cfg, mesh, rules,
                                                              for_training=True)
    return out


# --------------------------------------------------------------------- #
# specs -> DTensor placements
# --------------------------------------------------------------------- #
def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on each mesh dim that the spec names at tensor dim ``d``, ``Replicate()``
    on the others. A tuple of axes at one dim shards it over those mesh dims
    major to minor, which DTensor does in mesh-dim order: such a tuple must
    list its axes in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} at dim {d} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(tree_specs, mesh):
    """Each spec of a tree -> ``(mesh, placements)``."""
    if isinstance(tree_specs, P):
        return (mesh, placements(tree_specs, mesh))
    if isinstance(tree_specs, dict):
        return {k: named(v, mesh) for k, v in tree_specs.items()}
    if isinstance(tree_specs, (list, tuple)):
        return type(tree_specs)(named(v, mesh) for v in tree_specs)
    raise TypeError(f"not a spec tree: {tree_specs!r}")
