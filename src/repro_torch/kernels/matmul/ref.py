"""Plain PyTorch version of the matmul kernel: the function it computes,
which the CPU path runs and the card's kernel is held against."""

from __future__ import annotations

import math
from typing import Optional

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ y`` accumulated in float32 and cast to ``out_dtype`` (x's
    dtype by default), as the kernel and ``jnp.dot(...,
    preferred_element_type=float32)`` compute it."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), y.float()).to(out_dtype)


F32_U = 2.0 ** -24  # unit roundoff of float32
# a bf16 product against matmul_ref: one bf16 rounding of the output, under
# numpy's allclose rule |got - want| <= tol + tol |want|
BF16_TOL = 2e-2


def f32_product_ratio(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """Worst |got - a b| / (sqrt(K) u (|a| |b|)) for a product of f32
    operands K deep, a b evaluated in float64. A K-term f32 sum in any order
    is within K u (|a| |b|) of the exact one; rounding errors that do not line
    up, as with random operands, give about sqrt(K) u (|a| |b|) at most,
    whatever the order. At most 1 passes; operands rounded to TF32 miss it
    by two orders of magnitude and more."""
    a64, b64 = a.double(), b.double()
    limit = math.sqrt(a.shape[-1]) * F32_U * (a64.abs() @ b64.abs())
    return ((got.double() - a64 @ b64).abs() / limit.clamp_min(1e-300)).max().item()


def product_check(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None):
    """How far ``got`` is from the product a b: (max abs error, worst error
    over its limit, the rule). The check passes where the second is at most
    1 (a NaN fails it). F32 operands are held to a float64 evaluation
    within sqrt(K) u |a||b| (:func:`f32_product_ratio`), others to
    :func:`matmul_ref` within rtol = atol = ``BF16_TOL``."""
    if a.dtype == torch.float32:
        err = (got.double() - a.double() @ b.double()).abs().max().item()
        return err, f32_product_ratio(got, a, b), "vs float64, within sqrt(K) u |a||b|"
    want = matmul_ref(a, b, out_dtype).double()
    d = (got.double() - want).abs()
    return (d.max().item(), (d / (BF16_TOL + BF16_TOL * want.abs())).max().item(),
            f"rtol = atol = {BF16_TOL}")
