"""Plain PyTorch version of the matmul kernel: the function it computes,
which the CPU path runs and the card's kernel is held against."""

from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ y`` accumulated in float32 and cast to ``out_dtype`` (x's
    dtype by default), as the kernel and ``jnp.dot(...,
    preferred_element_type=float32)`` compute it."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), y.float()).to(out_dtype)
