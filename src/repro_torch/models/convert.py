"""Fill the port's ``Model`` from a JAX params pytree (as numpy arrays).

Torch cannot reproduce ``jax.random``'s draws, so tests that hold the port
against the JAX package build the weights once in JAX and convert them
here. The module names of ``Model`` mirror the JAX pytree keys, so the map
is by name: ``units.b<j>.<rest>`` (pattern slot j, stacked over units by
``jax.vmap``) becomes ``blocks.<i * len(pattern) + j>.<rest>`` for each unit
``i``; the list of ``first_k_dense`` prefix blocks becomes ``prefix.<i>.<rest>``
(the ``ModuleList`` index); every other key keeps its name. Each leaf keeps its own dtype: bf16
weights stay bf16 and float32 leaves (Mamba-2's ``A_log``, ``D``,
``dt_bias``) stay float32.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPE
from repro_torch.models.model import Model, n_units

_UNIT = re.compile(r"units\.b(\d+)\.(.*)")


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _tensor(arr, device) -> torch.Tensor:
    dtype = torch.float32 if np.asarray(arr).dtype == np.float32 else DTYPE
    # a copy (the model is updated in place; the array may be JAX's
    # read-only buffer); bf16 -> f32 -> bf16 is exact
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)


def params_from_jax(np_params: Dict, cfg: ModelConfig, device="cuda", *, mesh=None,
                    rules=None) -> Model:
    """The port's Model holding the JAX params. With a ``mesh``, each
    parameter is then distributed by ``sharding.specs.param_specs`` (under
    ``rules``, default ``ShardingRules()``): a DTensor of which each rank
    keeps its own slice."""
    if mesh is not None:
        return distribute_model(params_from_jax(np_params, cfg, "cpu"), cfg, mesh, rules,
                                device=device)
    model = Model(cfg, generator=None, device="meta")
    P = len(cfg.block_pattern)
    state = {}
    for path, arr in _flatten(np_params):
        t = _tensor(arr, device)
        m = _UNIT.fullmatch(path)
        if m:
            for i in range(n_units(cfg)):
                state[f"blocks.{i * P + int(m.group(1))}.{m.group(2)}"] = t[i]
        else:
            state[path] = t
    model.load_state_dict(state, strict=True, assign=True)
    return model


def distribute_model(model: Model, cfg: ModelConfig, mesh, rules=None, *, device=None,
                     for_training: bool = True) -> Model:
    """Each parameter of ``model`` (whole on every rank) becomes a DTensor
    placed by ``param_specs`` (the serving layout where not
    ``for_training``); this rank keeps only its slice (the tensor itself
    where the slice is all of it), on ``device`` (default: where the
    parameter is)."""
    from repro_torch.sharding.place import from_full
    from repro_torch.sharding.specs import ShardingRules, param_specs, placements

    specs = param_specs(model, cfg, mesh, rules or ShardingRules(), for_training=for_training)
    state = {n: from_full(p.detach(), mesh, placements(specs[n], mesh), device=device, copy=False)
             for n, p in model.named_parameters()}
    out = Model(cfg, generator=None, device="meta")
    out.load_state_dict(state, strict=True, assign=True)
    return out


def layer_from_jax(layer_cls, np_params: Dict, cfg: ModelConfig, device="cuda") -> nn.Module:
    """One layer (``MLA``, ``MoE``, ...) from its JAX params subtree, by
    name, with each leaf's dtype."""
    layer = layer_cls(cfg, generator=None, device="meta")
    layer.load_state_dict({p: _tensor(a, device) for p, a in _flatten(np_params)},
                          strict=True, assign=True)
    return layer


# ------------------------------------------------------------------ #
# The training state in the reference's layout (the checkpoint format)
# ------------------------------------------------------------------ #
# The reference's state is ``{"params": <pytree, units stacked by jax.vmap>,
# "opt": {"step": int32, "m", "v", "master"}}``; a checkpoint names each
# leaf by its ``jax.tree_util.keystr`` path and numbers the leaves in
# ``jax.tree`` order (dict keys sorted, list items in order). The port's
# state is ``{"model": Model, "opt": {"step": int, <name>: {parameter name:
# tensor}}}``. Both directions go through one map: a reference key, and
# the port tensors that make its leaf (one, or one per unit, stacked on a
# new leading axis).

Leaf = Tuple[str, Tuple[int, ...], torch.dtype, list, bool]
# (key, shape, dtype, the port tensors that make it, stacked over units)
_OPT_STEP = "['opt']['step']"
_ROOT = re.compile(r"\['params'\]|\['opt'\]\['(\w+)'\]")


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k!r}]" for k in path)


def _reference_path(name: str, P: int) -> Tuple[tuple, Optional[int]]:
    """Port parameter name -> (reference path under ``params``, unit index
    or None)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        i = int(parts[1])
        return ("units", f"b{i % P}", *parts[2:]), i // P
    if parts[0] == "prefix":
        return ("prefix", int(parts[1]), *parts[2:]), None
    return tuple(parts), None


def _tree_order(path) -> tuple:
    # jax.tree flattens dict keys sorted and list items in order; at each
    # level the keys are all strings or all list indices
    return tuple((isinstance(k, int), k) for k in path)


def reference_leaves(state: Dict, cfg: ModelConfig) -> List[Leaf]:
    """The leaves of ``state`` in the reference's layout and order: for each,
    its key, shape and dtype, the port tensors that make it (a leaf stacked
    over units lists one tensor per unit, in unit order) and whether it is
    stacked. ``opt["step"]`` is an int32 scalar and lists the int itself."""
    P = len(cfg.block_pattern)
    trees = {("params",): dict(state["model"].named_parameters())}
    trees.update({("opt", name): sub for name, sub in state["opt"].items() if name != "step"})
    groups: Dict[tuple, list] = {}
    for root, tensors in trees.items():
        for name, t in tensors.items():
            path, unit = _reference_path(name, P)
            groups.setdefault(root + path, []).append((unit, t))
    out = [(("opt", "step"), (), torch.int32, [state["opt"]["step"]], False)]
    for path, members in groups.items():
        stacked = members[0][0] is not None
        ts = [t for _, t in sorted(members, key=lambda m: m[0])] if stacked else [members[0][1]]
        shape = (len(ts), *ts[0].shape) if stacked else tuple(ts[0].shape)
        out.append((path, shape, ts[0].dtype, ts, stacked))
    out.sort(key=lambda leaf: _tree_order(leaf[0]))
    return [(keystr(path), *rest) for path, *rest in out]


def state_to_reference_layout(state: Dict, cfg: ModelConfig, device=None) -> Dict[str, torch.Tensor]:
    """{reference key: tensor} in the reference's leaf order: units stacked
    into ``units.b<j>``, the prefix blocks in the ``prefix`` list, and
    ``opt.step`` an int32 scalar. Every tensor is a copy, on ``device``
    (default: where the state lives)."""
    out = {}
    for key, shape, dtype, ts, stacked in reference_leaves(state, cfg):
        if key == _OPT_STEP:
            out[key] = torch.tensor(int(ts[0]), dtype=torch.int32, device=device)
            continue
        leaf = torch.empty(shape, dtype=dtype, device=ts[0].device if device is None else device)
        for dst, src in zip(leaf if stacked else [leaf], ts):
            dst.copy_(src.detach())
        out[key] = leaf
    return out


def state_from_reference_layout(leaves: Dict, cfg: ModelConfig, device="cuda",
                                place=None) -> Dict:
    """Inverse of ``state_to_reference_layout``: the port's training state
    from {reference key: array or tensor}: ``params``, ``opt.step`` and
    whatever optimizer trees the leaves hold (Adam's m/v/master, Lion's
    m/master, SGD's m). Each leaf keeps its dtype; each parameter's tensor
    is one copy on ``device`` (the leaves are never changed or aliased), or
    what ``place(root, name, value)`` makes of the value (root None for a
    parameter, else the optimizer tree's name; e.g. a DTensor of a slice)."""
    P = len(cfg.block_pattern)
    model = Model(cfg, generator=None, device="meta")
    names = [n for n, _ in model.named_parameters()]
    port_of = {}
    for name in names:
        path, unit = _reference_path(name, P)
        port_of.setdefault(keystr(path), []).append((name, unit))
    trees: Dict[Optional[str], Dict[str, torch.Tensor]] = {}
    step = 0
    for key, arr in leaves.items():
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
        if key == _OPT_STEP:
            step = int(t)
            continue
        root = _ROOT.match(key)
        if root is None or key[root.end():] not in port_of:
            raise KeyError(f"{key}: no parameter of {cfg.name} has this reference key")
        tree = trees.setdefault(root.group(1), {})  # None: the params
        for name, unit in port_of[key[root.end():]]:
            piece = t if unit is None else t[unit]
            tree[name] = (piece.to(device=device, copy=True) if place is None
                          else place(root.group(1), name, piece))
    model.load_state_dict(trees.pop(None), strict=True, assign=True)
    opt = {"step": step}
    for opt_name, tree in trees.items():
        missing = set(names) - set(tree)
        if missing:
            raise KeyError(f"opt.{opt_name}: no leaves for {sorted(missing)[:3]}")
        opt[opt_name] = {n: tree[n] for n in names}
    return {"model": model, "opt": opt}
