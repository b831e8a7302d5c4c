"""Optimizers with float32 state (port of ``repro/optim/optimizers.py``).

The interface mirrors JAX's optax-style ``Optimizer(init, update)``. State
is a dict of per-parameter f32 tensors keyed by parameter name: ``m``
(and ``v`` for Adam) and an f32 ``master`` copy when the parameters are
bf16 (mixed-precision training). ``update(grads, state, params)`` takes
dicts of tensors keyed alike, writes the new parameter values into
``params`` IN PLACE (JAX returns new arrays) and returns the new state.
It works leaf by leaf, so at most one leaf's f32 gradient exists at once,
and every step keeps JAX's order of float32 operations.

An update can be resumed: ``committed`` is a set of parameter names whose
update this step has already written; they are skipped, and each leaf is
added to it once its parameter and state are written (the new values of a
leaf are computed before any of them is stored). An update that fails
halfway and is called again with the same grads, state and set ends where
an unfailed update ends, bit for bit; the step counter moves only at the
end.

``norm`` (optional) is the global gradient norm to clip by, where
``grads`` are one rank's shards of gradients whose whole norm the caller
knows (``launch.steps.make_sharded_train_step``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable  # (params) -> state
    update: Callable  # (grads, state, params, committed=None, norm=None) -> new state; params in place


def _lr_fn(lr):
    return lr if callable(lr) else (lambda step: lr)


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / (gn + 1e-9), 1.0)


def _clipped(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """One leaf of ``clip_by_global_norm`` (f32 product, rounded back to the
    gradient's dtype), widened to f32 for the update."""
    if scale is None:
        return g.float()
    return (g.float() * scale).to(g.dtype).float()


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """The JAX function for a whole gradient dict: (clipped grads, norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


def _f32_zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _pending(params: Tensors, committed):
    """The (name, parameter) pairs an update still has to write."""
    return [(k, p) for k, p in params.items() if committed is None or k not in committed]


def _commit(committed, name: str) -> None:
    if committed is not None:
        committed.add(name)


def _master(params: Tensors) -> Tensors:
    return {k: p.detach().float().clone() for k, p in params.items()}


def adamw(
    lr: Callable | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params: Tensors) -> Dict:
        return {"step": 0, "m": _f32_zeros(params), "v": _f32_zeros(params),
                "master": _master(params)}

    @torch.no_grad()
    def update(grads: Tensors, state: Dict, params: Tensors, committed=None, norm=None) -> Dict:
        step = state["step"] + 1
        gn = global_norm(grads) if norm is None else norm
        scale = _clip_scale(gn, grad_clip) if grad_clip is not None else None
        lr_t = lr_fn(step)
        # f32 scalars, as JAX computes them from its int32 step
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        m, v, master = state["m"], state["v"], state["master"]
        for k, p in _pending(params, committed):
            g = _clipped(grads[k], scale)
            m_k = b1 * m[k] + (1 - b1) * g
            v_k = b2 * v[k] + (1 - b2) * g * g
            mh = m_k / bc1
            vh = v_k / bc2
            ma_k = master[k] - lr_t * (mh / (torch.sqrt(vh) + eps) + weight_decay * master[k])
            m[k], v[k], master[k] = m_k, v_k, ma_k
            p.copy_(ma_k)
            _commit(committed, k)
        return {"step": step, "m": m, "v": v, "master": master}

    return Optimizer(init, update)


def lion(
    lr: Callable | float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.1,
    grad_clip: Optional[float] = 1.0,
) -> Optimizer:
    """Lion: sign-momentum optimizer -- 1/3 the optimizer memory of Adam
    (one f32 moment instead of two + no bias correction)."""
    lr_fn = _lr_fn(lr)

    def init(params: Tensors) -> Dict:
        return {"step": 0, "m": _f32_zeros(params), "master": _master(params)}

    @torch.no_grad()
    def update(grads: Tensors, state: Dict, params: Tensors, committed=None, norm=None) -> Dict:
        step = state["step"] + 1
        gn = global_norm(grads) if norm is None else norm
        scale = _clip_scale(gn, grad_clip) if grad_clip is not None else None
        lr_t = lr_fn(step)
        m, master = state["m"], state["master"]
        for k, p in _pending(params, committed):
            g = _clipped(grads[k], scale)
            u = torch.sign(b1 * m[k] + (1 - b1) * g)
            ma_k = master[k] - lr_t * (u + weight_decay * master[k])
            m_k = b2 * m[k] + (1 - b2) * g
            m[k], master[k] = m_k, ma_k
            p.copy_(ma_k)
            _commit(committed, k)
        return {"step": step, "m": m, "master": master}

    return Optimizer(init, update)


def sgd(lr: Callable | float = 1e-2, momentum: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params: Tensors) -> Dict:
        return {"step": 0, "m": _f32_zeros(params)}

    @torch.no_grad()
    def update(grads: Tensors, state: Dict, params: Tensors, committed=None, norm=None) -> Dict:
        step = state["step"] + 1  # no clipping: ``norm`` is not read
        lr_t = lr_fn(step)
        m = state["m"]
        for k, p in _pending(params, committed):
            m_k = momentum * m[k] + grads[k].float()
            p_k = p.float() - lr_t * m_k
            m[k] = m_k
            p.copy_(p_k)
            _commit(committed, k)
        return {"step": step, "m": m}

    return Optimizer(init, update)
