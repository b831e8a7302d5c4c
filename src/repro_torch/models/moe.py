"""Mixture-of-Experts FFN: shared + routed experts, top-k gating,
capacity-based dispatch (GShard/Switch-style) with the load-balance aux loss.

Port of ``repro/models/moe.py``, step for step. Dispatch is index-based
(cumsum positions, then a scatter into an (E, C, d) buffer), and the
routed experts are three batched products over the leading E axis. The
combine adds each token's k weighted expert outputs left to right over
its k slots, in the activation dtype: the order in which the reference's
``.at[tok_of].add`` applies its row-major updates, and the same bits on
every device (``index_add_`` on CUDA adds in no fixed order).

Under the partitioned train step (``sharding/partition.py``) a call sees
one dp group's rows; the reference's jitted step counts over the global
batch, and so does the layer given that batch (``Batch``): the capacity
of all the groups' tokens, each assignment's slot in global row-major
order, f_e and P_e over all tokens. With tensor-parallel ``Products`` it
also runs only this rank's experts (see ``MoE.forward``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPE, WHOLE, Dense, Products, act_fn
from repro_torch.sharding.hints import shard_hint

# assignments past the capacity, summed over the calls that count over a
# global batch (their counts reach the host there anyway)
DROPPED = {"assignments": 0}


class Batch:
    """The tokens over which a MoE call counts its capacity, its slot order
    and its load-balance terms: the call's own, here (one group). The
    partitioned train step passes its dp groups' global batch: ``groups``
    equal blocks of tokens, ``sum_counts`` summing integer counts over the
    groups and ``sum`` summing an f32 tensor over them with an all-reduce
    as its backward. A call's tokens are ``pieces`` equal runs, each
    consecutive in the global batch's row-major order, at the global run
    indices ``index`` (of ``groups * pieces``): one run of whole rows, or
    one run a row where the sequence is split over ranks too."""

    groups, index, pieces = 1, (0,), 1

    @staticmethod
    def sum_counts(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def sum(x: torch.Tensor) -> torch.Tensor:
        return x


ONE = Batch()


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

    def forward(self, x: torch.Tensor, dropless: bool = False, products: Products = WHOLE,
                over: Batch = ONE) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (b, s, d) -> (y, aux_loss). ``dropless=True`` sizes the expert
        buffers at T*k so no assignment is dropped (the decode path).

        ``over`` with more than one group: the capacity, slots and aux of
        the global batch (``_global``); the expert buffers hold this group's
        kept assignments at their positions among its own. Tensor-parallel
        ``products``: ``x`` is this rank's sequence shard and the banks hold
        this rank's experts; every rank routes the whole sequence, runs its
        experts, and the gathered outputs of all experts combine as above;
        the shared experts are a column / row split MLP."""
        cfg = self.cfg
        e, k = cfg.n_routed_experts, cfg.top_k
        xw = products.whole(x)
        b, s, d = xw.shape
        T = b * s
        xt = xw.reshape(T, d)
        gates, eidx, probs = self.route(xt)
        flat_e = eidx.reshape(T * k)
        # each assignment's position within its expert, in row-major (token,
        # slot) order; overflow parks in slot C
        pos = torch.cumsum(nn.functional.one_hot(flat_e, e), dim=0) - 1  # (T*k, E)
        slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
        if over.groups == 1:
            # load-balance auxiliary loss (Switch): E * sum_e f_e * P_e
            f_e = nn.functional.one_hot(eidx[:, 0], e).float().mean(dim=0)
            aux = e * torch.sum(f_e * probs.mean(dim=0)) * cfg.router_aux_coef
            C = self.capacity(T, dropless)
            keep = slot < C
        else:
            if over.pieces not in (1, b):
                raise ValueError(f"{b} rows in a call whose global batch has {over.pieces} runs "
                                 f"of its rows")
            aux, cap, C, first = self._global(eidx, probs, pos, over, dropless)
            keep = slot + first < cap  # the global slot within the global capacity
        slot_c = torch.where(keep, slot, C)
        tok_of = torch.arange(T, device=x.device).repeat_interleave(k)
        n_loc = self.w_gate.shape[0]
        if n_loc == e:
            buf = torch.zeros((e, C + 1, d), dtype=x.dtype, device=x.device)
            buf[flat_e, slot_c] = xt[tok_of]  # kept (expert, slot) pairs are unique
        else:  # this rank's experts; the other assignments park
            lo = products.first(n_loc)
            mine = (flat_e >= lo) & (flat_e < lo + n_loc)
            buf = torch.zeros((n_loc, C + 1, d), dtype=x.dtype, device=x.device)
            buf[torch.where(mine, flat_e - lo, 0), torch.where(mine, slot_c, C)] = xt[tok_of]
        buf = shard_hint(buf[:, :C], "tp", None, None)  # expert-parallel dispatch buffer

        f = act_fn(cfg.act)
        h = f(torch.bmm(buf, self.w_gate)) * torch.bmm(buf, self.w_up)
        out = products.experts(torch.bmm(h, self.w_down))  # (E, C, d)

        # combine: the parked slot reads zeros
        out = torch.cat([out, torch.zeros((e, 1, d), dtype=out.dtype, device=out.device)], dim=1)
        gathered = out[flat_e, slot_c]  # (T*k, d)
        w = (gates.reshape(T * k) * keep.float()).to(gathered.dtype)
        weighted = (gathered * w[:, None]).reshape(T, k, d)
        y = weighted[:, 0]
        for j in range(1, k):
            y = y + weighted[:, j]
        y = products.routed(y)
        split = xw is not x  # a shard in: the shard of the routed sum out
        if split:
            y = products.shard(y.reshape(b, s, d))

        if self.shared is not None:  # on this rank's shard, or the folded tokens
            sh = self.shared
            gs, us = products.columns(x if split else xt, (sh.gate, sh.up))
            y = y + products.rows(f(gs) * us, sh.down)
        return y.reshape(x.shape), aux

    def _global(self, eidx: torch.Tensor, probs: torch.Tensor, pos: torch.Tensor,
                over: Batch, dropless: bool) -> Tuple[torch.Tensor, int, int, torch.Tensor]:
        """The global batch's aux loss (f_e and P_e means over all tokens,
        summed over the groups in f32 before their product), this group's
        buffer slots and each assignment's offset to its global slot.
        ``pos``: (T k, E) this group's running count of each expert's
        assignments. Returns (aux, the capacity of all tokens, slots: the
        most this group keeps on one expert under it, a host int, at least
        1, first (T k,): the global slots before this run's on its expert,
        less this group's own before it)."""
        cfg = self.cfg
        e, G, R = cfg.n_routed_experts, over.groups, over.pieces
        T = eidx.shape[0]
        ends = pos.view(R, -1, e)[:, -1] + 1  # the group's counts at each run's end
        counts = torch.diff(ends, dim=0, prepend=torch.zeros_like(ends[:1]))
        table = torch.zeros((G * R + 1, e), dtype=torch.int64, device=eidx.device)
        table[list(over.index)] = counts  # each run's counts; the last row: top-1 counts
        table[G * R] = nn.functional.one_hot(eidx[:, 0], e).sum(dim=0)
        table = over.sum_counts(table)
        f_e = table[G * R].float() / (T * G)
        P_e = over.sum(probs.sum(dim=0)) / (T * G)
        aux = e * torch.sum(f_e * P_e) * cfg.router_aux_coef
        C = self.capacity(T * G, dropless)
        before = torch.cumsum(table[:G * R], dim=0) - table[:G * R]
        first = before[list(over.index)]  # (R, E): the global slots before each run's
        kept = torch.clamp(torch.minimum(counts, C - first), min=0).sum(dim=0)
        first = (first - (ends - counts)).repeat_interleave(pos.shape[0] // R, dim=0)
        first = torch.gather(first, 1, eidx.reshape(-1, 1))[:, 0]
        if kept.is_meta:  # no values (the dry-run): a group within the capacity factor
            return aux, C, min(C, self.capacity(T, dropless)), first
        most, dropped = torch.stack([kept.max(), (table[:G * R].sum(dim=0) - C).clamp(min=0)
                                     .sum()]).tolist()
        DROPPED["assignments"] += dropped
        return aux, C, max(1, most), first
