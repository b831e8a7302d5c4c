"""Public flash-attention op in the model layout (b, S, h, d).

The CTA tile comes from a fixed rule, :func:`plan_blocks`: one query row
per CTA for decode (Sq == 1, so no CTA computes padding rows), 64 rows
otherwise, and the largest KV tile of at most 128 that divides the KV
length rounded up to a warp (so the last KV tile is not mostly padding).
Planning the tile on an H100 hierarchy comes with the port's codesign
layer.

On a CUDA tensor the op launches the kernel; on a CPU tensor it runs the
plain version (``ref.attention_ref``). Any other device raises.

Gradients: the forward runs the kernel; the backward recomputes through
``ref.attention_ref`` under autograd, as ``_fa_bwd`` does in the JAX op. It
materialises the (b, hq, Sq, Skv) f32 scores; a fused backward kernel is
later work.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.codesign import repair_tile, round_up
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS,
    MAX_BK,
    check_blocks,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref


def plan_blocks(Sq: int, Skv: int) -> Tuple[int, int]:
    """(bq, bk) for a per-head problem of Sq queries over Skv keys."""
    bq = 1 if Sq == 1 else 64
    bk = repair_tile(MAX_BK, round_up(Skv, 32), MAX_BK, min_tile=32)
    return bq, bk


def flash_attention(
    q: torch.Tensor,  # (b, Sq, hq, d) -- model layout (see models/layers.py)
    k: torch.Tensor,  # (b, Skv, hkv, d)
    v: torch.Tensor,  # (b, Skv, hkv, d)
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    sm_scale: Optional[float] = None,
    blocks: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Drop-in for ``models.layers.mha``'s math; GQA-native, no padding.
    ``kv_len`` (valid cache prefix) and ``q_offset`` (global position of
    q[:, 0]) are Python ints."""
    b, Sq, hq, d = q.shape
    _, Skv, hkv, dv = v.shape
    if d not in HEAD_DIMS or dv != d:
        raise ValueError(f"head dims d={d}, dv={dv}: the kernel takes d == dv in {HEAD_DIMS}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv or q_offset < 0:
        raise ValueError(f"kv_len={kv_len} must lie in [0, {Skv}] and q_offset={q_offset} >= 0")
    bq, bk = blocks if blocks is not None else plan_blocks(Sq, Skv)
    check_blocks(bq, bk)
    if not (q.is_cuda or q.device.type == "cpu"):
        raise ValueError(f"flash attention has no path for device {q.device}")
    return _FlashAttention.apply(q, k, v, causal, scale, int(q_offset), kv_len, bq, bk)


def _plain(q, k, v, causal, scale, q_offset, kv_len):
    out = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len,
    )
    return out.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_len, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, q_offset, kv_len)
        if q.is_cuda:
            return flash_attention_cuda(
                q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                kv_len=kv_len, bq=bq, bk=bk,
            )
        return _plain(q, k, v, causal, scale, q_offset, kv_len)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _plain(*inputs, *ctx.args)
        return (*torch.autograd.grad(out, inputs, g), None, None, None, None, None, None)
