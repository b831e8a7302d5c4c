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
from typing import Dict, Iterator, Tuple

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


def params_from_jax(np_params: Dict, cfg: ModelConfig, device="cuda") -> Model:
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


def layer_from_jax(layer_cls, np_params: Dict, cfg: ModelConfig, device="cuda") -> nn.Module:
    """One layer (``MLA``, ``MoE``, ...) from its JAX params subtree, by
    name, with each leaf's dtype."""
    layer = layer_cls(cfg, generator=None, device="meta")
    layer.load_state_dict({p: _tensor(a, device) for p, a in _flatten(np_params)},
                          strict=True, assign=True)
    return layer
