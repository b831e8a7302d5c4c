"""Fill the port's ``Model`` from a JAX params pytree (as numpy arrays).

Torch cannot reproduce ``jax.random``'s draws, so tests that hold the port
against the JAX package build the weights once in JAX and convert them
here. The module names of ``Model`` mirror the JAX pytree keys, so the map
is by name: ``units.b0.<rest>`` (stacked over units by ``jax.vmap``) becomes
``blocks.<i>.<rest>`` for each unit ``i``; every other key keeps its name.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPE
from repro_torch.models.model import Model


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def params_from_jax(np_params: Dict, cfg: ModelConfig, device="cuda") -> Model:
    model = Model(cfg, generator=None, device="meta")
    unit = "units.b0."
    state = {}
    for path, arr in _flatten(np_params):
        # bf16 -> f32 -> bf16 is exact
        t = torch.from_numpy(np.asarray(arr, dtype=np.float32)).to(device=device, dtype=DTYPE)
        if path.startswith(unit):
            for i in range(cfg.n_units):
                state[f"blocks.{i}.{path[len(unit):]}"] = t[i]
        else:
            state[path] = t
    model.load_state_dict(state, strict=True, assign=True)
    return model
