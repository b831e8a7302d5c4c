"""Mixture-of-Experts FFN: shared + routed experts, top-k gating,
capacity-based dispatch (GShard/Switch-style) with the load-balance aux loss.

Port of ``repro/models/moe.py``, step for step. Dispatch is index-based
(cumsum positions, then a scatter into an (E, C, d) buffer), and the
routed experts are three batched products over the leading E axis. The
combine adds each token's k weighted expert outputs left to right over
its k slots, in the activation dtype: the order in which the reference's
``.at[tok_of].add`` applies its row-major updates, and the same bits on
every device (``index_add_`` on CUDA adds in no fixed order).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPE, Dense, act_fn
from repro_torch.sharding.hints import shard_hint


def top_k_gates(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits (T, E) f32 -> (renormalised gates (T, k), expert
    indices (T, k), probabilities (T, E)). The k largest in descending
    order and, on an exact tie, the lower expert index first, as
    ``lax.top_k`` orders them: a stable sort, where ``torch.topk`` leaves
    the order of ties open. Ties are common: the router's logits are bf16
    before the f32 softmax."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = gate_vals[:, :k], eidx[:, :k]
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True), eidx, probs


class SharedExperts(nn.Module):
    """The always-active experts, fused into one SwiGLU of width
    ``n_shared_experts * d_expert``."""

    def __init__(self, d: int, width: int, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.gate = Dense(d, width, **kw)
        self.up = Dense(d, width, **kw)
        self.down = Dense(width, d, **kw)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        d, e, de = cfg.d_model, cfg.n_routed_experts, cfg.d_expert
        self.cfg = cfg
        self.router = Dense(d, e, generator=generator, device=device)

        def stacked(shape, scale):
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            return nn.Parameter((x * scale).to(DTYPE))

        # routed experts, stacked: (E, d, de) / (E, de, d)
        self.w_gate = stacked((e, d, de), 1.0 / math.sqrt(d))
        self.w_up = stacked((e, d, de), 1.0 / math.sqrt(d))
        self.w_down = stacked((e, de, d), 1.0 / math.sqrt(de))
        self.shared = (SharedExperts(d, cfg.n_shared_experts * de, generator=generator,
                                     device=device) if cfg.n_shared_experts else None)

    def route(self, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """xt: (T, d) -> (renormalised gates (T, k) f32, expert indices
        (T, k), router probabilities (T, E) f32)."""
        return top_k_gates(self.router(xt).float(), self.cfg.top_k)

    def capacity(self, T: int, dropless: bool = False) -> int:
        """Slots per expert for T tokens: ceil(T k capacity_factor / E), or
        T k (``dropless``)."""
        k, e = self.cfg.top_k, self.cfg.n_routed_experts
        return T * k if dropless else max(1, int(math.ceil(T * k * self.cfg.capacity_factor / e)))

    def forward(self, x: torch.Tensor, dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (b, s, d) -> (y, aux_loss). ``dropless=True`` sizes the expert
        buffers at T*k so no assignment is dropped (the decode path)."""
        cfg = self.cfg
        b, s, d = x.shape
        e, k = cfg.n_routed_experts, cfg.top_k
        T = b * s
        xt = x.reshape(T, d)
        gates, eidx, probs = self.route(xt)

        # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
        f_e = nn.functional.one_hot(eidx[:, 0], e).float().mean(dim=0)
        aux = e * torch.sum(f_e * probs.mean(dim=0)) * cfg.router_aux_coef

        # capacity-based dispatch: each assignment's position within its
        # expert, in row-major (token, slot) order; overflow parks in slot C
        C = self.capacity(T, dropless)
        flat_e = eidx.reshape(T * k)
        pos = torch.cumsum(nn.functional.one_hot(flat_e, e), dim=0) - 1  # (T*k, E)
        slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
        keep = slot < C
        slot_c = torch.where(keep, slot, C)
        tok_of = torch.arange(T, device=x.device).repeat_interleave(k)
        buf = torch.zeros((e, C + 1, d), dtype=x.dtype, device=x.device)
        buf[flat_e, slot_c] = xt[tok_of]  # kept (expert, slot) pairs are unique
        buf = shard_hint(buf[:, :C], "tp", None, None)  # expert-parallel dispatch buffer

        f = act_fn(cfg.act)
        h = f(torch.bmm(buf, self.w_gate)) * torch.bmm(buf, self.w_up)
        out = torch.bmm(h, self.w_down)  # (E, C, d)

        # combine: the parked slot reads zeros
        out = torch.cat([out, torch.zeros((e, 1, d), dtype=out.dtype, device=out.device)], dim=1)
        gathered = out[flat_e, slot_c]  # (T*k, d)
        w = (gates.reshape(T * k) * keep.float()).to(gathered.dtype)
        weighted = (gathered * w[:, None]).reshape(T, k, d)
        y = weighted[:, 0]
        for j in range(1, k):
            y = y + weighted[:, j]

        if self.shared is not None:
            sh = self.shared
            y = y + sh.down(f(sh.gate(xt)) * sh.up(xt))
        return y.reshape(b, s, d), aux
