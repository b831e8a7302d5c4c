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
plain version (``ref.attention_ref``). Any other device raises. Like the
JAX op it takes any head dims d (q, k) and dv (v): the CUDA path zero-pads
q and k along d and v along dv to the smallest compiled D that holds both
(:func:`pad_head_dims`; zero columns change no score and give zero output
columns), launches, and slices the output back to dv. It raises for d or
dv above ``HEAD_DIMS[-1]`` = 192.

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
    MAX_BK,
    ROW_TILES,
    SMEM_OPT_IN,
    check_blocks,
    compiled_dim,
    flash_attention_cuda,
    max_bk,
    smem_formula,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

KV_ALIGN = 32  # the KV tile is a multiple of a warp
BACKWARD_RANGE = "flash_attention.backward"  # profiler range around the plain backward
_DTYPES = (torch.float32, torch.bfloat16)


def smem_bytes(bq: int, bk: int, d: int, dtype: Optional[torch.dtype] = None) -> int:
    """Dynamic shared memory of one CTA, by the kernel's formula
    (:func:`~repro_torch.kernels.flash_attention.flash_attention.smem_formula`);
    with no ``dtype``, the larger of the float32 and bfloat16 instances
    (what ``legalize`` binds)."""
    if dtype is None:
        return max(smem_bytes(bq, bk, d, t) for t in _DTYPES)
    return smem_formula(bq, bk, d, dtype)


class FlashAttentionSpace(KernelSpace):
    """Co-design space of the CUDA flash-attention kernel: shape =
    (Sq, Skv, D) per head, BlockConfig = (bq, bk). Calibrated in bf16, the
    dtype both models launch, and held to its plain version within
    ``tolerance`` (one bf16 rounding of P and of the output)."""

    name = "flash_attention_h100"
    dtype = torch.bfloat16
    tolerance = 3e-2
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
        within [32, min(the largest tile compiled for D in both dtypes, Skv
        rounded up to 32)], shrunk until the CTA fits ``smem_budget`` (at
        most the 227 KB opt-in) in both dtypes. Never raises."""
        _bq, bk = (int(c) for c in config)
        Sq, Skv, D = (int(s) for s in shape)
        budget = min(int(smem_budget or self.smem_budget), SMEM_OPT_IN)
        bq = ROW_TILES[0] if Sq == 1 else ROW_TILES[-1]
        most = min(max_bk(bq, D, t) for t in _DTYPES)
        bk = min(max(bk // KV_ALIGN * KV_ALIGN, KV_ALIGN), most, round_up(Skv, KV_ALIGN))
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
            torch.randn((1, S, 1, D), generator=generator, device=device).to(self.dtype)
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
    return_lse: bool = False,
):
    """Drop-in for ``models.layers.mha``'s math; GQA-native, no padding of
    the sequence. ``kv_len`` (valid cache prefix) and ``q_offset`` (global
    position of q[:, 0]) are Python ints. v may be narrower or wider than q
    and k (dv != d); ``scale`` defaults to 1 / sqrt(d). The tile is planned
    at the compiled D that the CUDA path pads to. ``return_lse`` (decode,
    no autograd): ``(out, lse)``, lse the rows' f32 log-sum-exp (b, Sq, hq)
    of their scaled live scores, -inf where a row has no live key (its
    output zeros); :func:`merge_lse` merges such partials."""
    b, Sq, hq, d = q.shape
    _, Skv, hkv, dv = v.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Skv or q_offset < 0:
        raise ValueError(f"kv_len={kv_len} must lie in [0, {Skv}] and q_offset={q_offset} >= 0")
    if not (q.is_cuda or q.device.type == "cpu"):
        raise ValueError(f"flash attention has no path for device {q.device}")
    if blocks is None and q.is_cuda:
        blocks = plan_blocks(Sq, Skv, compiled_dim(d, dv))
    if blocks is not None:
        check_blocks(*blocks)
    args = (causal, scale, int(q_offset), kv_len, blocks)
    if return_lse:
        if Sq != 1:
            raise ValueError(f"Sq={Sq}: the log-sum-exp comes from the decode instance (Sq = 1)")
        return _forward(q, k, v, *args, lse=True)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, *args)
    return _forward(q, k, v, *args)  # no graph to record: skip autograd's dispatch


def pad_head_dims(q, k, v, D: int):
    """q and k zero-padded along d, and v along dv, to D (the tensors
    themselves where nothing is padded). The scores and the output's first
    dv columns are unchanged."""
    d, dv = q.shape[-1], v.shape[-1]
    if d != D:
        q, k = (torch.nn.functional.pad(t, (0, D - d)) for t in (q, k))
    if dv != D:
        v = torch.nn.functional.pad(v, (0, D - dv))
    return q, k, v


def _forward(q, k, v, causal, scale, q_offset, kv_len, blocks, lse=False):
    if q.is_cuda:
        dv = v.shape[-1]
        qp, kp, vp = pad_head_dims(q, k, v, compiled_dim(q.shape[-1], dv))
        res = flash_attention_cuda(qp, kp, vp, causal=causal, scale=scale, q_offset=q_offset,
                                   kv_len=kv_len, bq=blocks[0], bk=blocks[1], lse=lse)
        out, rows = res if lse else (res, None)
        out = out if out.shape[-1] == dv else out[..., :dv]
        return (out, rows) if lse else out
    return _plain(q, k, v, causal, scale, q_offset, kv_len, lse)


def _plain(q, k, v, causal, scale, q_offset, kv_len, lse=False):
    res = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len, return_lse=lse,
    )
    if lse:
        return res[0].transpose(1, 2), res[1].transpose(1, 2)
    return res.transpose(1, 2)


def merge_lse(parts: torch.Tensor) -> torch.Tensor:
    """Attention over a cache split into shards, from each shard's partial:
    ``parts`` (n, ..., dv + 1) f32, each shard's output over its keys with
    its log-sum-exp in the last column (-inf: no live key, output zeros) ->
    (..., dv + 1), the whole cache's output and log-sum-exp. Each output is
    weighed by exp(lse - max lse); a row no shard has a key for is zeros and
    -inf. Plain elementwise arithmetic: the reduction over the shards."""
    out, lse = parts[..., :-1], parts[..., -1:]
    top = lse.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.exp(lse - top)  # 0 for a shard with no live key
    total = w.sum(dim=0)
    merged = (out * w).sum(dim=0) / torch.where(total > 0, total, 1.0)
    return torch.cat([merged, top + torch.log(total)], dim=-1)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_len, blocks):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, q_offset, kv_len)
        return _forward(q, k, v, causal, scale, q_offset, kv_len, blocks)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        # the range lets a profile attribute the plain backward's device time
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            out = _plain(*inputs, *ctx.args)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None, None, None)
