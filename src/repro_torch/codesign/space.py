"""Tile arithmetic shared by the port's kernel wrappers (a copy of the
jax-free helpers of ``repro/codesign/space.py``)."""

from __future__ import annotations

from typing import Optional


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return (x + m - 1) // m * m


def repair_tile(
    b: int,
    dim: int,
    default: int,
    *,
    min_tile: int = 128,
    cap: Optional[int] = None,
) -> int:
    """Keep ``b`` when it is an exact divisor of ``dim`` with
    ``b >= min_tile`` (and ``b <= cap`` when given); otherwise fall back to
    the largest divisor of ``dim`` reachable from ``min(default, dim)`` by
    halving. Always returns a divisor tile >= 1 for any ``dim >= 1``."""
    if b >= min_tile and dim % b == 0 and (cap is None or b <= cap):
        return int(b)
    d = min(default, dim)
    while d > 1 and dim % d != 0:
        d //= 2
    return max(int(d), 1)
