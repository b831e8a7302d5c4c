"""Plain PyTorch version of flash attention (materializes the score matrix);
the port of ``repro/kernels/flash_attention/ref.py``."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, Dv)
    *,
    causal: bool,
    scale: float,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dv = v.shape
    g = Hq // Hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    # bf16 products are exact in f32, so this is the f32-accumulated score
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if kv_len is not None:
        mask &= kpos < kv_len
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with every key masked (decode padding): emit zeros like the kernel
    any_live = mask.any(dim=-1)[:, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return torch.where(any_live, out, 0.0).to(q.dtype)
