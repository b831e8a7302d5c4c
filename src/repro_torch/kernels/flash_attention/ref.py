"""Plain PyTorch version of flash attention (materializes the score matrix);
the port of ``repro/kernels/flash_attention/ref.py``. ``split_kv_ref`` is
the split decode's arithmetic written plainly, for the tests."""

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
    return_lse: bool = False,
):
    """With ``return_lse``, also each row's log-sum-exp of its scaled live
    scores in f32 (B, Hq, Sq), -inf for a row with none."""
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
    out = torch.where(any_live, torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v), 0.0).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.where(any_live[..., 0], torch.logsumexp(s, dim=-1), -torch.inf)


def split_kv_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, Dv)
    *,
    causal: bool,
    scale: float,
    bk: int,
    parts: int,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention as the split decode computes it: the live keys (the valid
    prefix, cut at the last row's causal frontier) come in n tiles of
    ``bk``, and part s takes the tiles [s * n // parts, (s + 1) * n // parts).
    Each part gives a partial (m, l, acc) in f32 over its live keys (P
    rounded to v's dtype before PV, l summing the f32 values; a part with no
    live key gives m = NEG_INF, l = 0, acc = 0), and the partials are merged
    by log-sum-exp. A row whose l is 0 in total is zeros."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dv = v.shape
    valid = Skv if kv_len is None else kv_len
    live_keys = min(valid, q_offset + Sq) if causal else valid
    n = -(-live_keys // bk)
    bounds = [(s * n // parts * bk, min((s + 1) * n // parts * bk, live_keys))
              for s in range(parts)]
    g = Hq // Hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if kv_len is not None:
        mask &= kpos < kv_len
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        live = mask & (kpos >= lo) & (kpos < hi)
        sp = torch.where(live, s, NEG_INF)
        m = sp.amax(dim=-1, keepdim=True)
        e = torch.where(live, torch.exp(sp - m), 0.0)
        ms.append(m)
        ls.append(e.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype), v).float())
    m_all = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - m_all) for m in ms]
    l_all = sum(l * wi for l, wi in zip(ls, w))
    acc = sum(a * wi for a, wi in zip(accs, w))
    out = torch.where(l_all > 0, acc / torch.where(l_all > 0, l_all, 1.0), 0.0)
    return out.to(q.dtype)
