"""Public flash-attention op in the model layout (b, S, h, d).

The CTA tile (bq, bk) comes from the co-design layer:
:class:`FlashAttentionSpace` registers the per-head score GEMM (einsum
``qd,kd->qk``) with ``repro_torch.codesign`` under the name
``flash_attention_h100``, and :func:`plan_blocks` is a cached call of
``codesign.plan``, as in the JAX op. The space's ``legalize`` is binding on
the compiled kernel: a one-row tile for decode (Sq == 1, so no CTA computes
padding rows), 64 rows otherwise, and a KV tile that is a multiple of 32 in
[32, ``MAX_BK``] whose CTA fits the shared-memory budget.

On a CUDA tensor the op launches the kernel; on a CPU tensor it runs the
plain version (``ref.attention_ref``). Any other device raises.

Gradients: the forward runs the kernel; the backward recomputes through
``ref.attention_ref`` under autograd, as ``_fa_bwd`` does in the JAX op. It
materialises the (b, hq, Sq, Skv) f32 scores; a fused backward kernel is
later work.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch import codesign
from repro_torch.codesign import KernelSpace, round_up
from repro_torch.core.constraints import tc_aligned
from repro_torch.core.problem import Problem
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS,
    MAX_BK,
    ROW_TILES,
    check_blocks,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

KV_ALIGN = 32  # the KV tile is a multiple of a warp


def smem_bytes(bq: int, bk: int, d: int) -> int:
    """Dynamic shared memory of one CTA, by the kernel's formula: Q
    (bq x d), K (bk x d+1), V (bk x d), scores (bq x bk), m, l, alpha."""
    return 4 * (bq * d + bk * (d + 1) + bk * d + bq * bk + 3 * bq)


class FlashAttentionSpace(KernelSpace):
    """Co-design space of the CUDA flash-attention kernel: shape =
    (Sq, Skv, D) per head, BlockConfig = (bq, bk)."""

    name = "flash_attention_h100"
    decode_dims = ("q", "k")
    grid_dims = ("q",)
    search_budget = 200

    def problem(self, shape):
        Sq, Skv, D = shape
        return Problem.from_einsum(
            "attn_scores", "qd,kd->qk", {"q": Sq, "k": Skv, "d": D}, "GEMM", 4
        )

    def constraints(self, shape):
        return tc_aligned({"q": ROW_TILES[-1], "k": KV_ALIGN}, spatial_dims=self.grid_dims)

    def legalize(self, config, shape, smem_budget=None):
        """BINDING repair into a compiled tile: bq = 1 for decode (Sq == 1)
        and 64 otherwise; bk the proposal rounded down to a multiple of 32,
        within [32, min(MAX_BK, Skv rounded up to 32)], shrunk until the
        CTA fits ``smem_budget``. Never raises."""
        _bq, bk = (int(c) for c in config)
        Sq, Skv, D = (int(s) for s in shape)
        budget = int(smem_budget or self.smem_budget)
        bq = ROW_TILES[0] if Sq == 1 else ROW_TILES[-1]
        bk = min(max(bk // KV_ALIGN * KV_ALIGN, KV_ALIGN), MAX_BK, round_up(Skv, KV_ALIGN))
        while bk > KV_ALIGN and smem_bytes(bq, bk, D) > budget:
            bk -= KV_ALIGN
        return (bq, bk)

    def default_config(self, shape):
        return (ROW_TILES[-1], MAX_BK)

    def launched_shape(self, shape, config):
        Sq, Skv, D = shape
        bq, bk = config
        return (round_up(Sq, bq), round_up(Skv, bk), D)

    def example_inputs(self, shape, device, generator):
        Sq, Skv, D = shape
        return tuple(
            torch.randn((1, S, 1, D), generator=generator, device=device)
            for S in (Sq, Skv, Skv)
        )

    def run(self, inputs, config):
        q, k, v = inputs
        return flash_attention(q, k, v, causal=False, blocks=tuple(config))

    def reference(self, inputs, config):
        q, k, v = inputs
        return _plain(q, k, v, causal=False, scale=1.0 / math.sqrt(q.shape[-1]),
                      q_offset=0, kv_len=None)


FLASH_ATTENTION_H100 = codesign.register_space(FlashAttentionSpace())


def planned_shape(Sq: int, Skv: int, D: int) -> Tuple[int, int, int]:
    """The shape attention is planned at: Sq rounded up to a row tile
    (decode stays at 1), Skv to a warp."""
    return (1 if Sq == 1 else round_up(Sq, ROW_TILES[-1]), round_up(Skv, KV_ALIGN), D)


@functools.lru_cache(maxsize=256)
def plan_blocks(Sq: int, Skv: int, D: int) -> Tuple[int, int]:
    """Plan the per-head score GEMM (Sq x Skv x D) via ``codesign.plan``;
    return (bq, bk)."""
    return codesign.plan(FLASH_ATTENTION_H100, planned_shape(Sq, Skv, D)).config


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
    bq, bk = blocks if blocks is not None else plan_blocks(Sq, Skv, d)
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
