"""LR schedules (port of ``repro/optim/schedules.py``). Values are computed
in float32, as JAX computes them from an int32 step, and returned as
Python floats."""

from __future__ import annotations

import numpy as np

_F = np.float32


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step) -> float:
        return float(_F(peak_lr) * np.minimum(_F(1.0), _F(step) / _F(max(1, warmup_steps))))

    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step) -> float:
        step = _F(step)
        if step < warmup_steps:
            return float(_F(peak_lr) * np.minimum(_F(1.0), step / _F(max(1, warmup_steps))))
        t = np.clip((step - _F(warmup_steps)) / _F(max(1, total_steps - warmup_steps)),
                    _F(0.0), _F(1.0))
        cos = _F(1.0) + np.cos(_F(np.pi) * t)
        return float(_F(peak_lr) * (_F(final_frac) + _F(1 - final_frac) * _F(0.5) * cos))

    return fn
