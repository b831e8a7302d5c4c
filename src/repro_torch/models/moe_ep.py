"""Expert-parallel MoE: all-to-all dispatch between token-sharded and
expert-sharded layouts (port of ``repro/models/moe_ep.py``, whose
``shard_map`` body this is, run on each rank).

Layout contract (the activation layout of the hint context,
``sharding.hints.hints_from_mesh``):
  tokens: batch over the dp axes, sequence over the tp axis
  experts: padded to a multiple of tp_n, sharded over the tp axis
Per rank: route local tokens -> bucket by owning rank (capacity
``cap_send``) -> all-to-all -> local-expert capacity dispatch (``cap_own``)
-> compute -> all-to-all back -> gate-weighted combine. Empty slots carry
zeros with local expert id 0 (gateless SwiGLU maps 0 -> 0). The aux loss
is the mean of the routing statistics over every rank of the mesh; the
shared experts run outside the exchange.

``moe_apply_ep(moe, cfg, x)`` takes the port's ``MoE`` (plain, replicated
parameters) and a ``DTensor`` ``x`` laid out by the contract (each rank's
block is its tokens), returning ``y`` alike. Its gradients: the router and
expert weights' grads are summed over the tp group (each rank's grads then
cover its tp group's tokens); the aux loss back-propagates 1/tp_n of its
gradient on each rank. The partitioned train step
(``sharding/partition.py``) calls ``moe_ep_local`` instead, on its own
token block with its own expert slices, under its own gradient
convention: each rank's share, summed over the ranks by the step.

The exchange is ``all_to_all_single`` over the tp group's process group,
differentiable (its backward is the inverse exchange). gloo has no
all-to-all or all-gather for CUDA tensors: with a gloo group, CUDA buffers
are copied to the host for those collectives and back (counted in
``HOST_STAGED``). NCCL groups exchange on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense
from repro_torch.models.moe import MoE, top_k_gates
from repro_torch.sharding import hints as hints_mod
from repro_torch.sharding.specs import P, placements

# collectives of this module: all-to-all calls and the bytes each rank sent,
# and the collectives that went through host memory (a gloo group given CUDA
# tensors): this module's all-to-alls and all-gathers, and the partitioned
# train step's all-gathers and reduce-scatters (``sharding/partition.py``)
EXCHANGE = {"calls": 0, "bytes": 0}
HOST_STAGED = {"calls": 0, "bytes": 0}
# this rank's routed assignments dropped by either capacity (at the sender's
# cap_send or the owner's cap_own), summed on the device (no sync): a tensor
# once a layer has run; set it to 0 to start a count
DROPPED = {"assignments": 0}


def _dp_tuple(st) -> tuple:
    dp = st.get("dp") or ()
    return dp if isinstance(dp, tuple) else (dp,)


def ep_available(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """The reference's guards on the global (b, s): a mesh with tp > 1, b
    divisible by the dp ranks and s by tp. A plain tensor is taken as one
    dp rank's rows (``moe_apply_ep`` itself takes a DTensor only)."""
    st = hints_mod._STATE
    if not (st.get("enabled") and st.get("tp") and st.get("mesh") is not None):
        return False
    from torch.distributed.tensor import DTensor

    sizes = st["sizes"]
    tp_n = sizes.get(st["tp"], 1)
    dp_n = math.prod(sizes.get(a, 1) for a in _dp_tuple(st))
    b, s, _ = x.shape
    if not isinstance(x, DTensor):
        b *= max(1, dp_n)
    return tp_n > 1 and b % max(1, dp_n) == 0 and s % tp_n == 0


# ------------------------------------------------------------------ #
# collectives (host-staged on gloo for CUDA tensors)
# ------------------------------------------------------------------ #
def _staged(group, *tensors) -> bool:
    if any(t.is_cuda for t in tensors) and dist.get_backend(group) == "gloo":
        HOST_STAGED["calls"] += 1
        HOST_STAGED["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
        return True
    return False


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits along dim 0: row block j goes to rank j of ``group``."""
    EXCHANGE["calls"] += 1
    EXCHANGE["bytes"] += x.numel() * x.element_size()
    x = x.contiguous()
    if _staged(group, x):
        out = torch.empty_like(x, device="cpu")
        dist.all_to_all_single(out, x.cpu(), group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (a new tensor; gloo reduces CUDA tensors itself)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _ToTpRegion(torch.autograd.Function):
    """Identity; the backward sums the gradient over the tp group."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _MeshMean(torch.autograd.Function):
    """Mean over every rank of the mesh; the backward scales this rank's
    gradient by ``1 / tp_n`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, groups, tp_n):
        ctx.tp_n = tp_n
        n = 1
        for g in groups:
            x = _all_reduce(x, g)
            n *= dist.get_world_size(g)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.tp_n, None, None


# ------------------------------------------------------------------ #
def _capacity_dispatch(xt, eids, n_buckets: int, cap: int):
    """Assign slot-within-bucket for each row; returns (buf, slot, keep).

    xt: (N, d) rows; eids: (N,) bucket ids. buf: (n_buckets, cap, d);
    overflow rows park at slot == cap (dropped)."""
    d = xt.shape[1]
    onehot = nn.functional.one_hot(eids, n_buckets)
    pos = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(pos, 1, eids[:, None])[:, 0]
    keep = slot < cap
    slot_c = torch.where(keep, slot, cap)
    buf = torch.zeros((n_buckets, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[eids, slot_c] = xt  # kept (bucket, slot) pairs are unique
    return buf[:, :cap], slot_c, keep


def _capacities(cfg: ModelConfig, t_loc: int, tp_n: int, e_loc: int) -> Tuple[int, int]:
    k = cfg.top_k
    cap_send = max(1, int(math.ceil(t_loc * k * cfg.capacity_factor / tp_n)))
    cap_own = max(1, int(math.ceil(tp_n * cap_send * cfg.capacity_factor / e_loc)))
    return cap_send, cap_own


def _local_bank(w: torch.Tensor, tp_rank: int, tp_n: int) -> torch.Tensor:
    """This rank's e_loc experts of a whole bank, zero-padded to a multiple of tp_n."""
    e = w.shape[0]
    e_pad = (e + tp_n - 1) // tp_n * tp_n
    e_loc = e_pad // tp_n
    w = nn.functional.pad(w, (0, 0) * (w.dim() - 1) + (0, e_pad - e))
    return w[tp_rank * e_loc:(tp_rank + 1) * e_loc]


def _ep_block(cfg: ModelConfig, x_blk: torch.Tensor, banks, router: torch.Tensor, group,
              tp_n: int, mesh_groups, t_loc: int, aux_div: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's shard_map body on this rank's token block; ``banks``
    this rank's (w_gate, w_up, w_down) experts, ``router`` the whole router;
    the aux statistics' mean back-propagates 1/``aux_div`` of its gradient."""
    e, k = cfg.n_routed_experts, cfg.top_k
    e_loc = (e + tp_n - 1) // tp_n
    cap_send, cap_own = _capacities(cfg, t_loc, tp_n, e_loc)
    f = act_fn(cfg.act)
    b_l, s_l, d = x_blk.shape
    T = b_l * s_l
    xt = x_blk.reshape(T, d)
    wg, wu, wd = banks
    gates, eidx, probs = top_k_gates(dense(xt, router).float(), k)  # real experts only

    # aux loss over the global batch
    f_e = nn.functional.one_hot(eidx[:, 0], e).float().mean(dim=0)
    p_e = probs.mean(dim=0)
    f_e, p_e = _MeshMean.apply(torch.stack([f_e, p_e]), mesh_groups, aux_div).unbind(0)
    aux = e * torch.sum(f_e * p_e) * cfg.router_aux_coef

    flat_e = eidx.reshape(T * k)
    flat_g = gates.reshape(T * k)
    tok_of = torch.arange(T, device=x_blk.device).repeat_interleave(k)
    dest = flat_e // e_loc  # owning rank along tp
    local_e = flat_e % e_loc

    # bucket rows by destination rank (capacity cap_send each)
    send_x, slot1, keep1 = _capacity_dispatch(xt[tok_of], dest, tp_n, cap_send)
    # the local-expert id of each slot travels the same way, plus one: an
    # empty slot reads 0 (the owner sends it to local expert 0, as the
    # reference does, and knows it for empty)
    ebuf = torch.zeros((tp_n, cap_send + 1), dtype=torch.int32, device=x_blk.device)
    ebuf[dest, slot1] = torch.where(keep1, local_e + 1, 0).to(torch.int32)
    send_e = ebuf[:, :cap_send]

    recv_x = _Exchange.apply(send_x, group)
    recv_e = _all_to_all(send_e, group)
    rx = recv_x.reshape(tp_n * cap_send, d)
    re = recv_e.reshape(tp_n * cap_send).long()
    real = re > 0
    re = (re - 1).clamp_min(0)

    # local-expert capacity dispatch + expert FFNs
    buf, slot2, keep2 = _capacity_dispatch(rx, re, e_loc, cap_own)
    DROPPED["assignments"] = DROPPED["assignments"] + (~keep1).sum() + (real & ~keep2).sum()
    h = f(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd)  # (e_loc, cap_own, d)

    # route results back to the original rows
    out_pad = torch.cat([out, out.new_zeros((e_loc, 1, d))], dim=1)
    back = out_pad[re, slot2].reshape(tp_n, cap_send, d)  # dropped rows read zeros
    ret = _Exchange.apply(back, group)
    ret_pad = torch.cat([ret, ret.new_zeros((tp_n, 1, d))], dim=1)
    vals = ret_pad[dest, slot1]  # (T*k, d); parked slots read zeros
    w = (flat_g * keep1.float()).to(vals.dtype)
    weighted = (vals * w[:, None]).reshape(T, k, d)
    y = weighted[:, 0]  # slot by slot, as the reference's .at[].add applies them
    for j in range(1, k):
        y = y + weighted[:, j]
    return y.reshape(b_l, s_l, d), aux


def _shared(cfg: ModelConfig, x: torch.Tensor, wts) -> torch.Tensor:
    """The shared experts (gate, up, down weights) on x's tokens."""
    f = act_fn(cfg.act)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    return dense(f(dense(xt, wts[0])) * dense(xt, wts[1]), wts[2]).reshape(b, s, d)


def moe_apply_ep(moe: MoE, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``MoE.forward`` (same parameters, same (y, aux))."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(p_, DTensor) for p_ in moe.parameters()):
        raise ValueError("moe_apply_ep takes a MoE with plain (replicated) parameters")
    if not isinstance(x, DTensor):
        raise TypeError("moe_apply_ep takes x as a DTensor laid out by the contract")
    st = hints_mod._STATE
    mesh, tp, sizes = st["mesh"], st["tp"], st["sizes"]
    tp_n = sizes[tp]
    group = mesh.get_group(tp)
    tp_rank = mesh.get_local_rank(tp)
    mesh_groups = [mesh.get_group(a) for a in mesh.mesh_dim_names]
    dp = tuple(a for a in _dp_tuple(st) if a in sizes)
    router = _ToTpRegion.apply(moe.router.w, group)
    banks = [_local_bank(_ToTpRegion.apply(w, group), tp_rank, tp_n)
             for w in (moe.w_gate, moe.w_up, moe.w_down)]
    shared = [] if moe.shared is None else [moe.shared.gate.w, moe.shared.up.w, moe.shared.down.w]
    spec = P(dp if dp else None, tp, None)  # the contract's layout: this rank's block
    layout = placements(spec, x.device_mesh)
    x_blk = x.redistribute(x.device_mesh, layout).to_local()
    t_loc = x_blk.shape[0] * x_blk.shape[1]
    y, aux = _ep_block(cfg, x_blk, banks, router, group, tp_n, mesh_groups, t_loc, tp_n)
    if shared:
        y = y + _shared(cfg, x_blk, [_ToTpRegion.apply(w, group) for w in shared])
    return DTensor.from_local(y, x.device_mesh, layout, run_check=False), aux


def moe_ep_local(cfg: ModelConfig, x: torch.Tensor, w, group, tp_rank: int, tp_n: int,
                 mesh_groups) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer inside the partitioned train step (``sharding/partition.py``):
    ``x`` is this rank's token block (its dp rows, its sequence shard) and
    ``w`` the layer's compute weights by name: each expert bank this rank's
    experts where its placement splits them over the tp group, else whole
    (padded and sliced here); the router and shared experts whole. The
    gradients follow the step's convention (each rank's share, which the
    step sums over the ranks), so nothing is summed here and the aux
    statistics' mean back-propagates its whole gradient."""
    e = cfg.n_routed_experts
    banks = [w[k] if w[k].shape[0] != e else _local_bank(w[k], tp_rank, tp_n)
             for k in ("w_gate", "w_up", "w_down")]
    b, s, _ = x.shape
    y, aux = _ep_block(cfg, x, banks, w["router.w"], group, tp_n, mesh_groups, b * s, 1)
    if cfg.n_shared_experts:
        y = y + _shared(cfg, x, [w[f"shared.{k}.w"] for k in ("gate", "up", "down")])
    return y, aux
