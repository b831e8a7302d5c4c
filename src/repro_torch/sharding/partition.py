"""Partitioned compute of the mesh train step (``launch/steps.py``
``make_sharded_train_step``): the port's counterpart of GSPMD partitioning
the reference's jitted step by its ``in_shardings``.

The state keeps ``state_specs``' placements at rest. A rank computes on
explicit local tensors with explicit collectives:

- **FSDP per unit** (ZeRO-3 over the dp mesh dims, HSDP over "pod"): the
  leaves of a unit (``n_units(cfg)`` groups of ``len(block_pattern)``
  blocks; the prefix blocks, ``embed``, ``final_norm``, ``lm_head`` and
  ``frontend_proj`` form one root group) are all-gathered along the dims
  their placements shard, one coalesced all-gather per mesh dim, just
  before the unit's forward, and freed after it; the remat recompute
  gathers them again (without a unit checkpoint, under ``--no-remat`` or
  ``save_block_outputs``, autograd keeps them for the backward). When the
  unit's backward ends, its grads are
  reduce-scattered back to each rank's slices (all-reduced over the mesh
  dims that replicate a leaf), in f32, one buffer per mesh dim: no buffer
  holds more than one unit's grads.
- **Tensor parallelism over "model"**, Megatron style with sequence
  parallelism: the residual stream holds this rank's sequence shard (the
  batch's layout, ``batch_specs``). Before a TP'd branch the normed
  sequence is all-gathered; column weights (``wq``, ``wk``, ``wv``,
  ``gate``, ``up``) keep their output-feature split and row weights
  (``wo``, ``down``) their input-feature split, and the row product's
  partial sums are reduce-scattered along the sequence into the residual.
  Attention runs on this rank's heads; where ``wk``/``wv`` split a kv head
  (fewer kv heads than ranks) the whole columns are gathered and this rank
  takes the kv heads its q heads read. MLA runs on this rank's heads too
  (``wq``, ``kv_up`` columns, ``wo`` rows); ``kv_down`` is gathered whole
  and the latent and the shared rope key are computed whole on each rank.
  Mamba-2 runs on this rank's SSD heads (``in_z``/``in_x``/``in_dt``
  columns, the x conv's channels, ``A_log``/``D``/``dt_bias``,
  ``out_proj`` rows; ``in_B``/``in_C`` and their convs whole, or the
  groups its heads read), its gated norm's sum of squares summed over
  "model" in f32 and its weight this rank's slice. mLSTM runs on this
  rank's heads (``up``'s channels of them in each half, ``w_i``/``w_f``,
  ``wq``/``wk``/``wv`` columns, ``down`` rows): its cell input is computed
  on this rank's channels and all-gathered over "model" (every q/k/v head
  reads every channel of it and of its conv, which runs whole), its
  output norm's sum of squares summed over "model". sLSTM runs its loop
  over positions on this rank's heads (``wx``'s z/i/f/o columns of them,
  ``r[:, heads]``): no collective inside the loop; its output norm summed
  likewise, its normed output all-gathered over the channels for the
  column / row FFN. The non-EP MoE routes
  the whole sequence on every rank, runs this rank's experts (the banks'
  split at rest), gathers every rank's expert outputs for the unmeshed
  combine, and keeps its shard; its shared experts are a column / row
  MLP. The model's own ``Block.forward``, ``_CoreBlock.forward`` and
  modules run the branches: the step passes them a ``split`` and its
  ``layers.Products``.
- **The MoE over the global batch**: a non-EP MoE counts its capacity,
  each assignment's slot (in the global batch's row-major order: a dp
  group's per-expert offsets are the earlier groups' counts) and its
  load-balance terms over all the dp groups' tokens, as the reference's
  jitted step does (``_GlobalBatch``; the counts all-reduced over the dp
  dims, P_e summed over them in f32 with an all-reduce as its backward:
  every dp group back-propagates the global aux of its own copy of the
  loss, and the sum of those shares is the gradient of the mean).
- **Rounded as the unmeshed step rounds.** A sum that the split spreads
  over the ranks is reduced in f32 and rounded to bf16 once, where the
  unmeshed step rounds it once: the row product's partial sums, each
  column product's input grad (each product's reduce-scattered and
  rounded, then added in autograd's order) and each norm weight's grad.
  A rank's bf16 values then differ from the unmeshed step's only where
  two orders of the same f32 sum round to different bf16 values, and the
  dp dims add the dp mean's own rounding, as before tensor parallelism.
- **The vocabulary over "model"**: the embedding is looked up per vocab
  shard (masked) and reduce-scattered into the residual; the logits stay
  vocab-sharded and the loss's logsumexp and target logit are summed over
  the shards, so the whole logits are never made.
- **Heads x rows** (mode ``"rows"``) for an attention (not MLA), mLSTM or
  sLSTM block whose heads do not divide over "model" (n ranks): h, the
  largest divisor of n dividing its head counts (h > 1), and r = n / h
  row groups, where r divides the dp group's rows. The "model" ranks
  ``k r + j`` (k < h) form row group j: its h ranks compute its b / r of
  the dp group's rows, each on its own 1/h of the heads. The r
  consecutive ranks ``k r .. k r + r - 1`` exchange by one all-to-all
  (``_Regroup``) their sequence shards of all b rows for row block j's
  b / r rows over their r shards, the sequence chunk k of n / r shards;
  inside the row group the block then runs the tensor parallelism above
  over h ranks (``_TensorParallel`` on that group). The inverse
  all-to-all returns each rank's sequence shard; each all-to-all is the
  other's backward. The weights are gathered whole over "model" and each
  rank takes its heads' slices (``Leaf.cols``): their grads sum over
  the row groups where the whole block's summed over every rank.
- Where a module has no TP here (SSD heads that do not divide, a block
  whose heads fit no row split, a MoE whose experts do not divide over
  "model", the frontends, a vocabulary that does not divide) its leaves are
  gathered whole over "model" too, and it computes the whole gathered
  sequence and keeps this rank's shard (a per-token frontend or head
  computes its shard alone). The expert-parallel MoE (``ep_shardmap``)
  takes this rank's tokens as they are, with this rank's experts.
- **The sequence split with no tensor parallelism** (``fsdp_only``, where
  ``batch_specs`` puts the sequence on "model" because the rows do not
  divide over the whole dp pool; ``Partition``'s sequence dim, ``seq_dim``
  of the batch): the residual is this rank's sequence shard and every
  weight is gathered per unit. Attention and MLA run context parallel
  (mode "context", ``_Context``): q on the shard, k and v (MLA: the latent
  and the rope key, 576 values a token against 4,096 of deepseek's
  up-projected keys and values, so gathered before ``kv_up``, which every
  rank then applies to the whole sequence) all-gathered over the sequence
  group, their grads reduce-scattered in f32 and rounded once; the flash
  kernel runs with the model's mask, ``q_offset`` the shard's start and
  every key. The MLP and the MoE run per token on the shard (mode
  "tokens"); the MoE counts capacity, slots and aux over the global batch
  with each row's shard a run of its own in the global row-major order
  (``_GlobalBatch`` with ``seq``). Mamba-2, mLSTM, sLSTM, the vision
  projector and the head run whole (the sequence gathered, the shard
  kept).

Gradient convention: every rank back-propagates its own copy of its dp
group's loss, and each collective's backward is its transpose
(all-gather <-> reduce-scatter, all-reduce -> all-reduce). Each rank's
gradient of a leaf is then its share of ``world`` times the gradient of
the mean loss over the dp groups; the per-unit reduction sums the shares
and divides by the world size in f32. Where no mesh dim has more than one
rank there is no collective and nothing is divided: the step is the
unmeshed one op for op.

Serving (``launch/steps.py`` ``make_sharded_prefill_step`` and
``make_sharded_serve_step``) computes on the inference layout
(``param_specs(for_training=False)``: TP over "model", FSDP over "data"
only where the TP'd weights exceed ``inference_weight_budget``; the
decode cache by ``cache_specs``), without autograd:

- **Prefill** (``Partition.prefill``) is the train step's forward on the
  sequence-sharded residual (units gathered over "data" where the weights
  are FSDP'd), ending in the final norm and this rank's vocab shard of the
  logits of the last position, which the last "model" rank's shard holds.
- **Decode** (``Partition.decode``, a plan of its own: ``decode=True``):
  the residual is this rank's rows (b, 1, d), the same on every "model"
  rank; there is no sequence to shard. Column products compute this
  rank's features; row products' partial sums are all-reduced in f32 and
  rounded once (``_Decode``). Attention and MLA compute the new token's
  q/k/v (q and the latent) on this rank's columns and gather them whole,
  write the cache where this rank's shard holds ``pos`` and attend: a
  cache split by kv head with this rank's q heads; a cache split by
  sequence (over "model", or over the dp dims for a batch of one) with
  every q head over this rank's shard, the shards' (output, log-sum-exp)
  partials gathered and merged (``ops.merge_lse``); each rank then keeps
  the output columns its ``wo`` rows take. MLA up-projects its latent
  shard with ``kv_up`` gathered whole. Mamba-2 runs on this rank's heads;
  its B/C conv windows, split by channel in the cache, step on this
  rank's channels and their outputs are gathered. The MoE routes every
  token droplessly on every rank, runs this rank's experts, and sums the
  ranks' routed outputs over "model" in f32; experts that do not divide
  run whole (gathered over "data" where FSDP'd). mLSTM and sLSTM follow
  their cache (``_xlstm_decode``): by head (mode "tp": this rank's heads
  of every state, as in training, the cell input and conv output gathered
  over the channels, the norms' sums and the row products reduced), or
  along dk where the heads do not divide (mode "dk": every head's dk slice
  of the mLSTM's q/k, C and n, its partial q . C and q . n all-reduced in
  f32 before the stabiliser's max, m whole; the sLSTM's c/n/h slices
  gathered for the recurrent product and the cell run whole). Under
  ``fsdp_only`` there is no tp group: each rank computes its rows (every
  row, where they do not divide over the pool) at full width with the
  weights gathered per unit (a vocabulary matrix split along d stays so:
  each rank looks its tokens up and sums the logits' partial products on
  its slice, ``vocab_d``), writes the new entry where its shard of the
  cache's sequence (split over the dp dims) holds ``pos``, and merges the
  shards' partials by log-sum-exp. The greedy token of
  vocab-sharded logits is each rank's largest logit and its first index,
  gathered, the largest taken and a tie going to the lowest index, as
  ``jnp.argmax`` does.

A group of ranks sharing a card over gloo exchanges CUDA buffers through
host memory for the all-gathers and reduce-scatters
(``moe_ep.HOST_STAGED`` counts them with the expert-parallel layer's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import merge_lse
from repro_torch.models.layers import DTYPE, Products, dense, gelu, mha, normed, rms_norm
from repro_torch.models.model import (Block, Mamba2Block, MLSTMBlock, SLSTMBlock, cross_entropy,
                                      n_units)
from repro_torch.models.moe import Batch
from repro_torch.models.moe_ep import _staged, moe_ep_local
from repro_torch.sharding import hints as hints_mod

_AG = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_RS = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ------------------------------------------------------------------ #
# collectives on flat buffers (a gloo group's CUDA buffers through host
# memory, counted in ``moe_ep.HOST_STAGED``)
# ------------------------------------------------------------------ #
def _host(x: torch.Tensor, group) -> torch.Tensor:
    return x.cpu() if _staged(group, x) else x


def _gather_flat(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' flat ``x`` side by side, rank order."""
    src = _host(x.contiguous(), group)
    out = src.new_empty(n * src.numel())
    _AG(out, src, group=group)
    return out.to(x.device)


def _scatter_flat(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """This rank's 1/n chunk of the sum of the ranks' flat ``x``."""
    src = _host(x.contiguous(), group)
    out = src.new_empty(src.numel() // n)
    _RS(out, src, group=group)
    return out.to(x.device)


def _sum_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce in place (gloo reduces CUDA tensors itself)."""
    dist.all_reduce(x, op=op, group=group)
    return x


def _gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    m = x.movedim(dim, 0)
    return _gather_flat(m.reshape(-1), group, n).view(n * m.shape[0], *m.shape[1:]).movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    m = x.movedim(dim, 0)
    return _scatter_flat(m.reshape(-1), group, n).view(m.shape[0] // n, *m.shape[1:]).movedim(0, dim)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal blocks along dim 0: block j goes to rank j of ``group``."""
    src = _host(x.contiguous(), group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def _regroup(x: torch.Tensor, group, r: int, to_rows: bool) -> torch.Tensor:
    """Over a row group's ``r`` ranks: ``to_rows`` (b, s, ...) this rank's
    sequence shard of the b rows -> (b / r, r s, ...) row block j's rows
    (j this rank's place in ``group``) over the r ranks' shards, in order;
    else the inverse."""
    if to_rows:
        b, s, *rest = x.shape
        out = _all_to_all(x.reshape(r, b // r, s, *rest), group)  # block k from rank k
        return out.transpose(0, 1).reshape(b // r, r * s, *rest)
    b, rs, *rest = x.shape
    send = x.reshape(b, r, rs // r, *rest).transpose(0, 1)  # shard k to rank k
    return _all_to_all(send, group).reshape(r * b, rs // r, *rest)


class _Regroup(torch.autograd.Function):
    """``_regroup`` as a differentiable exchange: the backward is the
    inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, r, to_rows):
        ctx.args = group, r, to_rows
        return _regroup(x, group, r, to_rows)

    @staticmethod
    def backward(ctx, g):
        group, r, to_rows = ctx.args
        return _regroup(g, group, r, not to_rows), None, None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters the ranks'
    partial grads in f32 and rounds their sum once."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = dim, group, n
        return _gather_dim(x, dim, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _scatter_dim(g.float(), dim, group, n).to(g.dtype).contiguous(), None, None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` in ``x``'s dtype, rounded to ``dtype``
    after; the backward all-gathers in ``dtype``."""

    @staticmethod
    def forward(ctx, x, dim, group, n, dtype):
        ctx.args = dim, group, n, x.dtype
        return _scatter_dim(x, dim, group, n).to(dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n, dtype = ctx.args
        return _gather_dim(g, dim, group, n).to(dtype).contiguous(), None, None, None, None


def _mm_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight grad of ``x @ w`` as autograd computes it (one mm of the
    folded rows)."""
    return x.reshape(-1, x.shape[-1]).t().mm(g.reshape(-1, g.shape[-1]))


class _Columns(torch.autograd.Function):
    """(this rank's sequence shard ``x``, group, n, w0, b0, w1, b1, ...) ->
    ``dense(x_whole, w_i, b_i)`` for each column-split weight, on the whole
    gathered sequence. The backward gives each weight its grad as the
    unmeshed step does, and the input its grad rounded as the unmeshed
    step rounds it: each product's input grad is this rank's partial sum
    in f32, reduce-scattered in f32 (one product after another: one f32
    partial lives at a time) and rounded once, as one bf16 dot over all
    the features rounds it, and the products' grads are added in the order
    autograd adds them."""

    @staticmethod
    def forward(ctx, x, group, n, *wb):
        xw = _gather_dim(x, 1, group, n)
        ws, bs = wb[0::2], wb[1::2]
        ctx.args = group, n, x.dtype, [b is not None for b in bs]
        ctx.save_for_backward(xw, *ws)
        return tuple(dense(xw, w, b) for w, b in zip(ws, bs))

    @staticmethod
    def backward(ctx, *gs):
        group, n, dtype, biased = ctx.args
        xw, *ws = ctx.saved_tensors
        b, s, _ = xw.shape
        shards = []
        for g, w in zip(gs, ws):  # the partial sequence-major: each rank's chunk contiguous
            part = g.transpose(0, 1).float() @ w.float().t()
            out = _scatter_flat(part.reshape(-1), group, n)
            shards.append(out.view(s // n, b, -1).transpose(0, 1).to(dtype))
        gx = shards[-1]
        for t in reversed(shards[:-1]):  # the last product's grad arrives first
            gx = gx + t
        grads = []
        for g, w, has_b in zip(gs, ws, biased):
            grads += [_mm_grads(xw.to(w.dtype), w, g.to(w.dtype)),
                      g.sum((0, 1)) if has_b else None]
        return (gx.contiguous(), None, None, *grads)


class _RowPartial(torch.autograd.Function):
    """``y @ w`` with its f32 sums kept (a row-split weight: this rank's
    partial sums, reduced across the ranks before their one rounding); the
    backward computes both grads as autograd computes those of the bf16
    product. Its own function, apart from the reduction, so that a unit's
    recompute stops at it (it saves its inputs) before the collective."""

    @staticmethod
    def forward(ctx, y, w):  # sequence-major (s, b, d): each rank's chunk contiguous
        ctx.save_for_backward(y, w)
        return y.transpose(0, 1).float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.transpose(0, 1).to(w.dtype)
        gy = g.reshape(-1, g.shape[-1]).mm(w.t()).view(*y.shape[:-1], w.shape[0])
        return gy.to(y.dtype), _mm_grads(y.to(w.dtype), w, g)


class _Scale(torch.autograd.Function):
    """``x * w`` of a norm weight ``w`` that each rank of a group holds
    whole, applied to this rank's tokens or heads. The backward sums the
    weight's grad (the products of ``g`` and ``x`` rounded as autograd
    rounds them) over the ranks in f32 and rounds it once, as the unmeshed
    step's one sum over every token and head does: each rank gets the
    group's sum, which the step's grad reduction then sums over the other
    mesh dims only (``Partition.summed``)."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.group = group
        ctx.save_for_backward(x, w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        part = (g * x).float().sum(dim=tuple(range(g.dim() - 1)))
        return g * w, _sum_(part, ctx.group).to(w.dtype), None


class _TensorParallel(Products):
    """``layers.Products`` over the tp group: the columns gather this
    rank's sequence shard and compute its heads / features; the row product
    reduce-scatters its partial sums into this rank's shard."""

    def __init__(self, group, n: int, rank: int, norm_group=None) -> None:
        self.group, self.n, self.rank = group, n, rank
        # the ranks whose tokens or heads share a norm weight (a row
        # group's: every "model" rank's)
        self.norm_group = group if norm_group is None else norm_group

    def norm(self, x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
        return _Scale.apply(normed(x, eps), w, self.norm_group)

    def wide_norm(self, x: torch.Tensor, w: torch.Tensor, eps: float, width: int) -> torch.Tensor:
        """The RMS norm over all the ranks' features (``width``): each
        token's sum of squares summed over the tp group in f32; ``w`` is
        this rank's slice of the weight (its grad complete here)."""
        xf = x.float()
        var = _Sum.apply((xf * xf).sum(dim=-1, keepdim=True), self.group) / width
        return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherSeq.apply(x, 1, self.group, self.n)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's features side by side (the last dim, rank order)."""
        return _GatherSeq.apply(x, x.dim() - 1, self.group, self.n)

    def shard(self, y: torch.Tensor) -> torch.Tensor:
        s = y.shape[1] // self.n
        return y.narrow(1, self.rank * s, s)

    def first(self, n_local: int) -> int:
        return self.rank * n_local

    def experts(self, out: torch.Tensor) -> torch.Tensor:
        """Every rank's expert outputs side by side (dim 0, rank order); the
        backward reduce-scatters their grads in f32."""
        return _GatherSeq.apply(out, 0, self.group, self.n)

    @staticmethod
    def routed(y: torch.Tensor) -> torch.Tensor:
        return y  # every expert's outputs are gathered (``experts``)

    def columns(self, x: torch.Tensor, mods) -> list:
        wb = [t for m in mods for t in (m.w, m.b)]
        return list(_Columns.apply(x, self.group, self.n, *wb))

    def rows(self, y: torch.Tensor, mod) -> torch.Tensor:
        if mod.b is not None:
            raise ValueError("a row-split weight with a bias")
        return _ScatterSeq.apply(_RowPartial.apply(y, mod.w), 0, self.group, self.n,
                                 torch.promote_types(y.dtype, mod.w.dtype)).transpose(0, 1)


class _Context(Products):
    """``layers.Products`` of context parallelism: attention or MLA on the
    sequence split with no tensor parallelism (``fsdp_only``). The
    projections run per token on this rank's sequence shard of the
    ``n`` ranks' (``group``); the keys and values (MLA: the latent and the
    shared rope key, up-projected after) are all-gathered over the group,
    their grads reduce-scattered in f32 and rounded once; the queries of
    this rank's shard, at its global positions, attend every key under
    the model's own mask (causal, or none for an encoder) with
    ``q_offset`` the shard's first position."""

    def __init__(self, group, n: int, rank: int) -> None:
        self.group, self.n, self.rank = group, n, rank

    def positions(self, positions: torch.Tensor, S: int) -> torch.Tensor:
        return positions.narrow(0, self.rank * S, S)

    def keys(self, *ts: torch.Tensor) -> tuple:
        b, s = ts[0].shape[:2]  # one all-gather for all of them, sequence-major per rank
        flat = [t.reshape(b, s, -1) for t in ts]
        every = _GatherSeq.apply(torch.cat(flat, dim=-1), 1, self.group, self.n)
        return tuple(part.reshape(b, self.n * s, *t.shape[2:])
                     for part, t in zip(every.split([f.shape[-1] for f in flat], dim=-1), ts))

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
        return mha(q, k, v, causal=causal, q_offset=self.rank * q.shape[1], sm_scale=sm_scale)


class _Sum(torch.autograd.Function):
    """All-reduce sum (in f32); the backward all-reduces too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_(x.float().clone(), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.float().clone(), ctx.group).to(g.dtype), None


@dataclass(frozen=True)
class CacheLayout:
    """How a decode cache leaf lies on the mesh: ``start`` the first
    position of this rank's sequence shard, ``seq`` the (group, size) of
    each mesh dim that splits the sequence (major to minor), ``heads``
    whether "model" splits its kv heads, ``kind`` its name in a dry-run
    artifact ("whole": no mesh dim splits it)."""

    start: int = 0
    seq: Tuple[Tuple[object, int], ...] = ()
    heads: bool = False
    kind: str = "whole"

    @property
    def parts(self) -> int:
        return math.prod(n for _, n in self.seq)


class _Decode(Products):
    """``layers.Products`` of the partitioned decode step, for one branch.
    The input is this rank's rows (b, S, d), the same on every rank of the
    tp group. ``split``: the branch's weights keep their split over it
    (columns this rank's output features, rows its input features);
    ``gather_cols``: the column products' outputs are gathered whole
    (attention and MLA: the new token's q/k/v, or q and the latent);
    ``layout``: {cache leaf: ``CacheLayout``} of the branch's layer;
    ``picks``: {column module: the ranges of its whole output this branch
    computes with} of modules kept at their split at rest whose compute
    slice is another (the xLSTM's): their outputs are gathered and
    narrowed, a token's few values in place of the weight; ``dk``: an
    xLSTM whose recurrent cache is split along each head's dk (sLSTM: hd),
    whose contractions over it are summed (``contracted``) and whose
    states are gathered (``whole_dk``) and cut back (``slice_dk``)."""

    def __init__(self, group, n: int, rank: int, split: bool, gather_cols: bool = False,
                 layout: Optional[Dict[str, CacheLayout]] = None, picks=None,
                 dk: bool = False) -> None:
        self.group, self.n, self.rank = group, n, rank
        self.split, self.gather_cols = split and n > 1, gather_cols
        self.dk = dk and self.split
        self.layout = layout or {}
        self.picks = picks or {}
        self.cols = None  # the columns ``attend``'s output holds: ((c0, c1), of width)

    @staticmethod
    def norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(x, w, eps)

    def wide_norm(self, x: torch.Tensor, w: torch.Tensor, eps: float, width: int) -> torch.Tensor:
        if not self.split:
            return rms_norm(x, w, eps)
        xf = x.float()
        var = _sum_((xf * xf).sum(dim=-1, keepdim=True), self.group) / width
        return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w

    @staticmethod
    def whole(x: torch.Tensor) -> torch.Tensor:
        return x

    def first(self, n_local: int) -> int:
        return self.rank * n_local if self.split else 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's features side by side (the last dim, rank order)."""
        return _gather_dim(x, x.dim() - 1, self.group, self.n) if self.n > 1 else x

    def experts(self, out: torch.Tensor) -> torch.Tensor:
        """This rank's experts' outputs in every expert's place (the others
        zeros): the combine gives this rank's partial routed sum."""
        if not self.split:
            return out
        full = out.new_zeros((out.shape[0] * self.n, *out.shape[1:]))
        full[self.rank * out.shape[0]:(self.rank + 1) * out.shape[0]] = out
        return full

    def _reduce(self, y: torch.Tensor, dtype) -> torch.Tensor:
        return _sum_(y.float().contiguous(), self.group).to(dtype)

    def routed(self, y: torch.Tensor) -> torch.Tensor:
        return self._reduce(y, y.dtype) if self.split else y

    def contracted(self, *xs: torch.Tensor) -> tuple:
        """The ranks' partial sums over their slices of dk, summed in f32
        (one all-reduce for all of ``xs``)."""
        if not self.dk:
            return xs
        flat = self._reduce(torch.cat([x.reshape(-1) for x in xs]), xs[0].dtype)
        return tuple(t.view_as(x) for t, x in zip(flat.split([x.numel() for x in xs]), xs))

    def whole_dk(self, *xs: torch.Tensor) -> tuple:
        """Every rank's slices of the states' last dim (one all-gather)."""
        if not self.dk:
            return xs
        return tuple(self.gather(torch.stack(xs, dim=1)).unbind(1))

    def slice_dk(self, x: torch.Tensor) -> torch.Tensor:
        if not self.dk:
            return x
        w = x.shape[-1] // self.n
        return x.narrow(-1, self.rank * w, w)

    def columns(self, x: torch.Tensor, mods) -> list:
        outs = [dense(x, m.w, m.b) for m in mods]
        for i, m in enumerate(mods):
            if self.split and m in self.picks:  # every rank's columns, then this call's ranges
                every = _gather_dim(outs[i], outs[i].dim() - 1, self.group, self.n)
                outs[i] = torch.cat([every[..., a:b] for a, b in self.picks[m]], dim=-1)
        if not (self.split and self.gather_cols):
            return outs
        # one all-gather for all the products: (n, ..., every product's columns)
        every = _gather_dim(torch.cat(outs, dim=-1)[None], 0, self.group, self.n)
        parts = every.split([o.shape[-1] for o in outs], dim=-1)
        return [t.movedim(0, -2).reshape(*t.shape[1:-1], -1) for t in parts]

    def rows(self, y: torch.Tensor, mod) -> torch.Tensor:
        w, partial = mod.w, self.split
        if mod.b is not None:
            raise ValueError("a row-split weight with a bias")
        if self.cols is not None and y.shape[-1] != w.shape[0]:
            (c0, c1), width = self.cols
            if w.shape[0] == width:  # whole rows, this rank's heads
                w, partial = w[c0:c1], True
            else:  # every head; this rank's rows
                r0 = self.rank * w.shape[0]
                y, partial = y[..., r0:r0 + w.shape[0]], True
        self.cols = None
        if not partial or self.n == 1:
            return dense(y, w)
        return self._reduce(y.float() @ w.float(), torch.promote_types(y.dtype, w.dtype))

    def cache_write(self, cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                    cache_len: int) -> int:
        """Each of ``new`` (b, S, ...) at ``cache_len`` where this rank's
        shard holds those positions (this rank's kv heads of it where the
        heads split); returns the number of live keys of this rank's
        shard."""
        for name, t in new.items():
            lay, c = self.layout[name], cache[name]
            if lay.heads:
                hl = c.shape[2]
                t = t[:, :, self.rank * hl:(self.rank + 1) * hl]
            S, n_loc = t.shape[1], c.shape[1]
            if cache_len + S > n_loc * lay.parts:
                raise ValueError(f"cache of {n_loc * lay.parts} slots cannot take {S} "
                                 f"token(s) at position {cache_len}")
            a, e = max(cache_len, lay.start), min(cache_len + S, lay.start + n_loc)
            if a < e:
                c[:, a - lay.start:e - lay.start] = t[:, a - cache_len:e - cache_len]
        return max(0, min(cache_len + S - lay.start, n_loc))

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int,
               kv_len: int, sm_scale: Optional[float] = None) -> torch.Tensor:
        """This rank's q heads over its kv heads (a cache split by head),
        or every q head over its shard of the sequence, the shards' partials
        gathered and merged by log-sum-exp."""
        lay = next(iter(self.layout.values()))
        hq, dv = q.shape[2], v.shape[-1]
        c0, c1 = 0, hq * dv
        if lay.heads:
            hl = hq // self.n
            q = q[:, :, self.rank * hl:(self.rank + 1) * hl]
            c0, c1 = self.rank * hl * dv, (self.rank + 1) * hl * dv
        self.cols = ((c0, c1), hq * dv)
        if not lay.seq:
            return mha(q, k, v, causal=False, q_offset=q_offset, kv_len=kv_len, sm_scale=sm_scale)
        out, lse = mha(q, k, v, causal=False, kv_len=kv_len, sm_scale=sm_scale, return_lse=True)
        parts = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
        for group, n in lay.seq:
            parts = _gather_dim(parts, 0, group, n)
        return merge_lse(parts)[..., :-1].to(q.dtype)


class _GlobalBatch(Batch):
    """``moe.Batch`` of the dp groups: the rows are split over mesh dims
    ``dims`` (major to minor), this rank's group at ``index``; the counts and
    sums are all-reduced over each of those dims' groups in turn. With
    ``seq`` (the mesh dim that splits the sequence, where the MoE runs on
    this rank's shard) and ``rows`` (this rank's rows), each of the rows
    is a run of its own: row j's shard is run ``(g rows + j) n + k`` of
    the global row-major order, g the row group and k this rank's place
    among the n ranks of ``seq``."""

    def __init__(self, pgs, sizes, coord, dims, seq: Optional[int] = None,
                 rows: int = 1) -> None:
        self.pgs = [pgs[i] for i in dims]
        self.groups = math.prod(sizes[i] for i in dims)
        g = 0
        for i in dims:
            g = g * sizes[i] + coord[i]
        self.index = (g,)
        if seq is not None:
            n, k = sizes[seq], coord[seq]
            self.pgs.append(pgs[seq])
            self.groups *= n
            self.pieces = rows
            self.index = tuple((g * rows + j) * n + k for j in range(rows))

    def sum_counts(self, x: torch.Tensor) -> torch.Tensor:
        for pg in self.pgs:
            _sum_(x, pg)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        for pg in self.pgs:
            x = _Sum.apply(x, pg)
        return x


# ------------------------------------------------------------------ #
# per-unit gathers
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class Leaf:
    """How one parameter enters the compute: ``gather`` the (mesh dim,
    tensor dim) pairs it is all-gathered along (its grad reduce-scattered
    back), ``reduce`` the mesh dims whose ranks hold it whole (its grad
    all-reduced over them), ``cols`` the slice of the gathered tensor this
    rank computes with: (tensor dim, its (start, end) ranges, joined in
    order) (kv heads, a row group's heads; None: all)."""

    name: str
    gather: Tuple[Tuple[int, int], ...]
    reduce: Tuple[int, ...]
    cols: Optional[Tuple[int, Tuple[Tuple[int, int], ...]]] = None


@dataclass(frozen=True)
class Group:
    """A unit's (or the root's) leaves and the mesh's groups and sizes."""

    leaves: Tuple[Leaf, ...]
    pgs: Tuple
    sizes: Tuple[int, ...]
    scale: float  # the grads' divisor: the world size

    @property
    def collective(self) -> bool:
        """More than one rank (else a group's compute tensors are its slices)."""
        return self.scale > 1


class _GroupGather(torch.autograd.Function):
    """(group, *local slices) -> the group's compute tensors. Forward: one
    all-gather per mesh dim of the leaves it shards, minor dims first
    (DTensor splits a dim over several mesh dims major to minor); backward:
    per mesh dim in order one reduce-scatter of those leaves' grads and one
    all-reduce of the leaves it replicates, in f32, then the divisor."""

    @staticmethod
    def forward(ctx, group: Group, *shards):
        outs = list(shards)
        for i in reversed(range(len(group.sizes))):
            todo = [(k, d) for k, leaf in enumerate(group.leaves) for (mi, d) in leaf.gather
                    if mi == i]
            for dtype in dict.fromkeys(outs[k].dtype for k, _ in todo):  # a fixed order
                part = [(k, d) for k, d in todo if outs[k].dtype == dtype]
                moved = [outs[k].movedim(d, 0) for k, d in part]
                n = group.sizes[i]
                full = _gather_flat(torch.cat([m.reshape(-1) for m in moved]), group.pgs[i],
                                    n).view(n, -1)
                off = 0
                for (k, d), m in zip(part, moved):
                    block = full[:, off:off + m.numel()]
                    off += m.numel()
                    outs[k] = block.reshape(n * m.shape[0], *m.shape[1:]).movedim(0, d).contiguous()
        ctx.group = group
        ctx.meta = [(o.shape, o.dtype, o.device) for o in outs]
        return tuple(o.view_as(o) if o is s else o for o, s in zip(outs, shards))

    @staticmethod
    def backward(ctx, *grads):
        group = ctx.group
        g = [gr.float() if gr is not None else torch.zeros(sh, dtype=torch.float32, device=dev)
             for gr, (sh, _, dev) in zip(grads, ctx.meta)]
        for i, n in enumerate(group.sizes):
            todo = [(k, d) for k, leaf in enumerate(group.leaves) for (mi, d) in leaf.gather
                    if mi == i]
            if todo:  # each leaf's rank chunks side by side: (n, sum of chunk sizes)
                moved = [g[k].movedim(d, 0) for k, d in todo]
                flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
                out = _scatter_flat(flat.reshape(-1), group.pgs[i], n)
                off = 0
                for (k, d), m in zip(todo, moved):
                    size = m.numel() // n
                    g[k] = out[off:off + size].view(m.shape[0] // n, *m.shape[1:]).movedim(0, d)
                    off += size
            rest = [k for k, leaf in enumerate(group.leaves) if i in leaf.reduce]
            if rest:
                flat = _sum_(torch.cat([g[k].reshape(-1) for k in rest]), group.pgs[i])
                off = 0
                for k in rest:
                    size = g[k].numel()
                    g[k] = flat[off:off + size].view(g[k].shape)
                    off += size
        return (None, *((x / group.scale if group.scale != 1 else x).to(dt).contiguous()
                        for x, (_, dt, _) in zip(g, ctx.meta)))


def gather_group(group: Group, shards: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{name: local slice} -> {name: compute tensor} for one group."""
    if not group.collective:
        outs = [shards[leaf.name] for leaf in group.leaves]
    else:
        outs = _GroupGather.apply(group, *(shards[leaf.name] for leaf in group.leaves))
    res = {}
    for leaf, t in zip(group.leaves, outs):
        if leaf.cols is not None:
            dim, ranges = leaf.cols
            parts = [t.narrow(dim, a, b - a) for a, b in ranges]
            t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
        res[leaf.name] = t
    return res


# ------------------------------------------------------------------ #
# the plan of a step
# ------------------------------------------------------------------ #
def dp_rows(batch: Dict, mesh, rules) -> int:
    """The rows of a dp group in ``batch`` (DTensors by ``batch_specs``):
    its rows over the mesh dims other than the tp axis that split them."""
    from torch.distributed.tensor import Shard

    v = next(iter(batch.values()))
    names = tuple(mesh.mesh_dim_names)
    return v.shape[0] // math.prod(mesh.size(i) for i, pl in enumerate(v.placements)
                                   if isinstance(pl, Shard) and pl.dim == 0
                                   and names[i] != rules.tp_axis)


def seq_dim(batch: Dict) -> Optional[int]:
    """The mesh dim that splits the sequence of ``batch`` (DTensors by
    ``batch_specs``; under ``fsdp_only`` "model" where the rows do not
    divide over the whole dp pool), or None."""
    from torch.distributed.tensor import Shard

    v = next(iter(batch.values()))
    return next((i for i, pl in enumerate(v.placements) if isinstance(pl, Shard) and pl.dim == 1
                 and v.device_mesh.size(i) > 1), None)


def _sub(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    n = len(prefix)
    return {k[n:]: v for k, v in weights.items() if k.startswith(prefix)}


class Partition:
    """The partitioned compute of one model on one mesh, made from the
    parameters' placements (``state_specs``) and the rules' tp axis:
    which branches are TP'd, each leaf's gathers and reductions, the
    groups. ``loss(model, shards, batch)`` is this rank's loss of its dp
    group's rows (the same on the ranks that split its sequence), computed from
    its parameter slices ``shards`` and its block of the batch. ``rows``,
    the dp group's rows in a (micro)batch, decides where heads x rows
    fits (None: wherever the heads allow it). ``seq``: under
    ``fsdp_only``, the mesh dim that splits the sequence (``seq_dim`` of
    the batch; the tp dim otherwise). ``decode``: the plan of the
    partitioned decode step (``decode``), whose residual is one token
    replicated over "model": attention, MLA, the MLP, Mamba-2 and the
    expert banks in mode "tp" where their weights keep a split over it,
    else "whole"; mLSTM and sLSTM by their cache's split
    (``_xlstm_decode``). ``prefill`` runs the train plan's forward."""

    def __init__(self, cfg: ModelConfig, model, mesh, rules, rows: Optional[int] = None,
                 decode: bool = False, seq: Optional[int] = None) -> None:
        from torch.distributed.tensor import Shard

        self.cfg = cfg
        names = tuple(mesh.mesh_dim_names)
        self.sizes = tuple(mesh.size(i) for i in range(mesh.ndim))
        self.pgs = tuple(mesh.get_group(i) if n > 1 else None for i, n in enumerate(self.sizes))
        self.world = math.prod(self.sizes)
        self.coord = tuple(mesh.get_coordinate())
        tp_dim = None
        if not rules.fsdp_only and rules.tp_axis in names:
            tp_dim = names.index(rules.tp_axis)
        if tp_dim is not None and self.sizes[tp_dim] == 1:
            tp_dim = None
        self.tp_dim = tp_dim
        self.tp = self.sizes[tp_dim] if tp_dim is not None else 1
        self.tp_rank = self.coord[tp_dim] if tp_dim is not None else 0
        self.tp_pg = self.pgs[tp_dim] if tp_dim is not None else None
        self.products = _TensorParallel(self.tp_pg, self.tp, self.tp_rank)
        # the ranks that split the sequence: the tp group, or under
        # ``fsdp_only`` the dim the batch puts the sequence on (``seq_dim``)
        sp_dim = seq if rules.fsdp_only else tp_dim
        self.sp_dim = sp_dim if sp_dim is not None and self.sizes[sp_dim] > 1 else None
        self.sp = self.sizes[self.sp_dim] if self.sp_dim is not None else 1
        self.sp_rank = self.coord[self.sp_dim] if self.sp_dim is not None else 0
        self.sp_pg = self.pgs[self.sp_dim] if self.sp_dim is not None else None
        self.context = _Context(self.sp_pg, self.sp, self.sp_rank)
        self.mesh_pgs = [pg for pg in self.pgs if pg is not None]
        # the MoE's global batch: the rows split over the other dims (the
        # batch's placements refine it, ``local_batch``)
        self.over = _GlobalBatch(self.pgs, self.sizes, self.coord,
                                 [i for i, n in enumerate(self.sizes) if n > 1 and i != tp_dim])
        self.ep = bool(self.tp > 1 and hints_mod._STATE.get("ep_shardmap")) and not decode
        self.layouts: list = []  # the decode cache's {leaf: CacheLayout} by layer (``local_cache``)
        self.picks: Dict = {}  # the decode's column modules whose outputs are gathered (``_Decode``)

        params = dict(model.named_parameters())
        place = {k: tuple(p.placements) for k, p in params.items()}

        def on_tp(name: str, dim: int) -> bool:  # split along ``dim`` over the tp dim at rest
            pl = place[name][tp_dim] if tp_dim is not None else None
            return isinstance(pl, Shard) and pl.dim == dim % params[name].dim()

        # the modes: "local" (no split), "tp", "rows", "ep", "vocab", "whole"; the
        # sequence split alone: "context" (attention, MLA), "tokens" (MLP, MoE);
        # the decode's xLSTM: "tp" (by head), "dk"
        self.modes: Dict[str, str] = {}
        keep: set = set()  # leaves whose tp split the compute keeps
        cols: Dict[str, Tuple[int, Tuple[Tuple[int, int], ...]]] = {}
        self.rows = rows
        self.regroups: Dict[int, tuple] = {}  # h -> (row group, r, its products)
        self.block_h: Dict[str, int] = {}  # a "rows" branch -> its h

        def take(name: str, dim: int, ranges, r: int) -> None:
            """The ``ranges`` of leaf ``name`` along ``dim`` are this rank's
            compute slice: its split at rest where that is the slice (r ==
            1), else the leaf gathered whole and narrowed."""
            size, ranges = params[name].shape[dim], tuple(ranges)
            mine = ((self.tp_rank * size // self.tp, (self.tp_rank + 1) * size // self.tp),)
            if r == 1 and on_tp(name, dim) and ranges == mine:
                keep.add(name)
            elif ranges != ((0, size),):
                cols[name] = (dim, ranges)

        def pick(mod: str, ranges) -> None:
            """The decode's column module ``mod`` computes with the
            ``ranges`` of its output: its weight (and bias) kept at their
            column split at rest, the outputs gathered and narrowed
            (``_Decode.columns``); where that split is the slice or there is
            none, ``take``'s."""
            names = [f"{mod}.{leaf}" for leaf in ("w", "b") if f"{mod}.{leaf}" in params]
            size, ranges = params[names[0]].shape[-1], tuple(ranges)
            mine = ((self.tp_rank * size // self.tp, (self.tp_rank + 1) * size // self.tp),)
            if ranges != mine and all(on_tp(name, -1) for name in names):
                keep.update(names)
                self.picks[model.get_submodule(mod)] = ranges
            else:
                for name in names:
                    take(name, -1, ranges, 1)

        blocks = [(f"prefix.{j}", b) for j, b in enumerate(model.prefix)]
        blocks += [(f"blocks.{j}", b) for j, b in enumerate(model.blocks)]
        alone = {"attn": "context", "ffn": "tokens", "moe": "tokens", "core": "whole"}
        for pre, blk in blocks:
            for part in ("attn", "ffn", "moe", "core"):
                if getattr(blk, part, None) is not None:
                    self.modes[f"{pre}.{part}"] = (
                        "whole" if self.tp > 1 else alone[part] if self.sp > 1 else "local")
            if self.tp > 1 and isinstance(blk, Mamba2Block):
                self._mamba2(pre, params, on_tp, keep, cols, groups=not decode)
            if self.tp > 1 and isinstance(blk, (MLSTMBlock, SLSTMBlock)):
                if decode:
                    self._xlstm_decode(pre, blk, take, pick)
                else:
                    self._xlstm(pre, blk, mesh, take)
            if self.tp == 1 or not isinstance(blk, Block):
                continue
            if decode:
                self._decode_attention(pre, params, on_tp, keep)
            elif cfg.use_mla and cfg.n_heads % self.tp == 0 and all(
                    on_tp(f"{pre}.attn.{w}.w", -1) for w in ("wq", "kv_up")) \
                    and on_tp(f"{pre}.attn.wo.w", 0):  # heads; kv_down and the latent whole
                self.modes[f"{pre}.attn"] = "tp"
                keep.update(f"{pre}.attn.{w}.w" for w in ("wq", "kv_up", "wo"))
            elif not cfg.use_mla and cfg.n_heads % self.tp == 0 and on_tp(f"{pre}.attn.wq.w", -1) \
                    and on_tp(f"{pre}.attn.wo.w", 0):
                self.modes[f"{pre}.attn"] = "tp"
                keep.update(k for k in params if k.startswith(f"{pre}.attn.w")
                            and not k.startswith((f"{pre}.attn.wk", f"{pre}.attn.wv")))
                hd, g = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
                hq = cfg.n_heads // self.tp
                kv = [q // g for q in range(self.tp_rank * hq, (self.tp_rank + 1) * hq)]
                if cfg.n_kv_heads % self.tp == 0:  # each rank's kv columns are its heads'
                    keep.update(k for k in params if k.startswith((f"{pre}.attn.wk",
                                                                     f"{pre}.attn.wv")))
                else:  # the kv heads this rank's q heads read, from the whole columns
                    if len({kv.count(h) for h in kv}) > 1:
                        raise ValueError(f"{cfg.name}: a rank's {hq} q heads do not group "
                                         f"evenly over kv heads {sorted(set(kv))}")
                    for k in params:
                        if k.startswith((f"{pre}.attn.wk", f"{pre}.attn.wv")):
                            cols[k] = (-1, ((kv[0] * hd, (kv[-1] + 1) * hd),))
            elif not cfg.use_mla:  # heads x rows, where a row split fits
                split = self._heads_rows(f"{pre}.attn", (cfg.n_heads, cfg.n_kv_heads), mesh)
                if split is not None and split[1] > 1:
                    h, r = split
                    k, hd = self.tp_rank // r, cfg.head_dim
                    for w, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                                     ("wv", cfg.n_kv_heads), ("wo", cfg.n_heads)):
                        span = ((k * heads // h * hd, (k + 1) * heads // h * hd),)
                        for leaf in ("w", "b"):
                            if f"{pre}.attn.{w}.{leaf}" in params:
                                take(f"{pre}.attn.{w}.{leaf}", 0 if w == "wo" else -1, span, r)
            if blk.ffn is not None and all(on_tp(f"{pre}.ffn.{w}.w", -1)
                                           for w in ("gate", "up") if getattr(blk.ffn, w)) \
                    and on_tp(f"{pre}.ffn.down.w", 0):
                self.modes[f"{pre}.ffn"] = "tp"
                keep.update(k for k in params if k.startswith(f"{pre}.ffn."))
            if blk.moe is not None and self.ep:
                self.modes[f"{pre}.moe"] = "ep"
                keep.update(f"{pre}.moe.{w}" for w in ("w_gate", "w_up", "w_down")
                            if on_tp(f"{pre}.moe.{w}", 0))
            elif blk.moe is not None and all(on_tp(f"{pre}.moe.{w}", 0)
                                             for w in ("w_gate", "w_up", "w_down")) and (
                    blk.moe.shared is None or (all(on_tp(f"{pre}.moe.shared.{w}.w", -1)
                                                   for w in ("gate", "up"))
                                               and on_tp(f"{pre}.moe.shared.down.w", 0))):
                # this rank's experts (the banks' split at rest) and shared columns / rows
                self.modes[f"{pre}.moe"] = "tp"
                keep.update(k for k in params if k.startswith(f"{pre}.moe.")
                            and not k.startswith(f"{pre}.moe.router"))
        embed = "embed" in params
        self.modes["embed"] = "local" if self.sp == 1 else (
            "vocab" if embed and on_tp("embed", 0) else "whole")
        head = "embed" if cfg.tie_embeddings else "lm_head.w"
        self.modes["head"] = "local" if self.sp == 1 else (
            "vocab" if on_tp(head, 0 if cfg.tie_embeddings else -1) else "whole")
        for name, mode in (("embed", self.modes["embed"]), (head, self.modes["head"])):
            if mode == "vocab" and name in params:
                keep.add(name)
        # the norm weights whose grads ``_Scale`` sums over the tp group itself
        self.summed = set()
        if self.tp > 1:
            self.summed = {k for k in params if k.rsplit(".", 1)[-1] in ("ln", "ln1", "ln2")
                           or k == "final_norm"}
            self.summed.update(k for k in params if k.endswith((".attn.q_norm", ".attn.k_norm",
                                                                 ".attn.latent_norm"))
                               and self.modes[k.rsplit(".", 2)[0] + ".attn"] in ("tp", "rows"))

        def leaf(name: str) -> Leaf:
            gather, reduce = [], []
            for i, pl in enumerate(place[name]):
                if self.sizes[i] == 1:
                    continue
                if isinstance(pl, Shard):
                    if i == tp_dim and name in self.summed:
                        raise ValueError(f"{name}: a norm weight split over the tp axis")
                    if not (i == tp_dim and name in keep):
                        gather.append((i, pl.dim))
                elif not (i == tp_dim and name in self.summed):
                    reduce.append(i)
            return Leaf(name, tuple(gather), tuple(reduce), cols.get(name))

        scale = float(self.world)
        P = len(cfg.block_pattern)

        def group(names) -> Group:
            return Group(tuple(leaf(k) for k in names), self.pgs, self.sizes, scale)

        self.root = group([k for k in params if not k.startswith("blocks.")])
        self.units = [group([k for k in params if k.startswith("blocks.")
                             and i * P <= int(k.split(".")[1]) < (i + 1) * P])
                      for i in range(n_units(cfg))]
        # the decode's vocabulary matrices split along d (FSDP, no vocab
        # split): {leaf: the mesh dims it is split over, major to minor};
        # a step looks its tokens up and computes its logits' partial sums
        # on this rank's d slice instead of gathering the matrix
        self.vocab_d: Dict[str, Tuple[int, ...]] = {}
        for name, d_dim, mode in (("embed", 1, self.modes["embed"]),
                                  ("lm_head.w", 0, self.modes["head"])):
            lf = next((x for x in self.root.leaves if x.name == name), None)
            if decode and mode != "vocab" and lf is not None and lf.gather and lf.cols is None \
                    and all(d == d_dim % params[name].dim() for _, d in lf.gather):
                self.vocab_d[name] = tuple(sorted(i for i, _ in lf.gather))
        self.root_decode = Group(tuple(x for x in self.root.leaves if x.name not in self.vocab_d),
                                 self.pgs, self.sizes, scale)

    def _decode_attention(self, pre: str, params, on_tp, keep: set) -> None:
        """The decode plan's mode "tp" for the attention (MLA) of block
        ``pre``: ``wq``, ``wk`` and ``wv`` (``wq`` and ``kv_down``) split
        by columns and ``wo`` by rows at rest, kept so; ``kv_up`` gathered
        whole."""
        mods = ("wq", "kv_down") if self.cfg.use_mla else ("wq", "wk", "wv")
        if all(on_tp(f"{pre}.attn.{w}.w", -1) for w in mods) and on_tp(f"{pre}.attn.wo.w", 0):
            self.modes[f"{pre}.attn"] = "tp"
            keep.update(k for k in params for w in (*mods, "wo")
                        if k.startswith(f"{pre}.attn.{w}."))

    def _xlstm_decode(self, pre: str, blk, take, pick) -> None:
        """The decode plan of the mLSTM or sLSTM core of block ``pre``, by
        its cache's split (``cache_specs``): mode "tp" where the heads
        divide over "model" (the cache by head: this rank's heads of every
        leaf, as in training), "dk" where each head's dk (sLSTM: hd) does
        (the cache along it), else "whole". mLSTM: ``up``'s channels of this
        rank's heads in each half, the conv's taps, ``out_norm`` and
        ``down`` rows of them; by head ``wq``/``wk``/``wv`` and the gates of
        its heads; along dk every head's dk slice of ``wq``/``wk``, the rest
        whole. sLSTM: ``ffn_up`` columns, ``ffn_down`` rows and ``out_norm``
        of this rank's channels; by head ``wx``'s z/i/f/o columns and ``r``
        of its heads; along hd those whole. The column products whose slice is not their split
        at rest (``up``, ``wx``; along dk ``wq``/``wk``/``wv``) gather their
        outputs (``pick``)."""
        cfg, c, n, k = self.cfg, f"{pre}.core.", self.tp, self.tp_rank
        nh = cfg.n_heads
        if isinstance(blk, MLSTMBlock):
            di = cfg.d_inner
            dh = di // nh
            if nh % n and dh % n:
                if di % n == 0:  # the conv window split by channel, nothing else
                    raise ValueError(f"{cfg.name}: {nh} heads of {dh} on {n} ranks")
                return
            ch = (k * di // n, (k + 1) * di // n)  # this rank's heads' channels
            pick(c + "up", (ch, (di + ch[0], di + ch[1])))
            take(c + "conv_w", -1, (ch,), 1)
            take(c + "conv_b", 0, (ch,), 1)
            take(c + "down.w", 0, (ch,), 1)
            take(c + "out_norm", 0, (ch,), 1)
            if nh % n == 0:
                for w in ("wq.w", "wk.w", "wv.w"):
                    take(c + w, -1, (ch,), 1)
                for w in ("w_i.w", "w_i.b", "w_f.w", "w_f.b"):
                    take(c + w, -1, ((k * nh // n, (k + 1) * nh // n),), 1)
            else:
                sl = (k * dh // n, (k + 1) * dh // n)
                for w in ("wq", "wk"):
                    pick(c + w, tuple((h * dh + sl[0], h * dh + sl[1]) for h in range(nh)))
                pick(c + "wv", ((0, di),))
        else:
            d, ffw = cfg.d_model, blk.core.ffn_up.w.shape[-1]
            hd = d // nh
            if nh % n and hd % n:
                return
            ch = (k * d // n, (k + 1) * d // n)
            take(c + "out_norm", 0, (ch,), 1)
            if nh % n == 0:
                pick(c + "wx", tuple((g * d + ch[0], g * d + ch[1]) for g in range(4)))
                take(c + "r", 1, ((k * nh // n, (k + 1) * nh // n),), 1)
            else:
                pick(c + "wx", ((0, 4 * d),))
            f = ((k * ffw // n, (k + 1) * ffw // n),)
            take(c + "ffn_up.w", -1, f, 1)
            take(c + "ffn_down.w", 0, f, 1)
        self.modes[f"{pre}.core"] = "tp" if nh % n == 0 else "dk"

    def _mamba2(self, pre: str, params, on_tp, keep: set, cols: dict, groups: bool = True) -> None:
        """Mode "tp" for the Mamba-2 core of block ``pre`` where its SSD heads
        divide over the ranks, each rank's heads read whole B/C groups or
        share one, and the leaves split by head are split so at rest.
        ``groups``: narrow ``in_B``/``in_C`` and their convs to the groups
        this rank's heads read (the decode step keeps them whole)."""
        cfg, c = self.cfg, f"{pre}.core."
        nh, g, n = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_state
        if nh % self.tp:
            return
        hl, per = nh // self.tp, nh // g  # this rank's heads; heads per group
        if hl % per and per % hl:
            return
        split = {f"{c}{w}.w": -1 for w in ("in_z", "in_x", "in_dt")}
        split.update({f"{c}out_proj.w": 0, f"{c}conv_x_w": -1, f"{c}conv_x_b": 0,
                      f"{c}A_log": 0, f"{c}D": 0, f"{c}dt_bias": 0})
        if not all(on_tp(k, dim) for k, dim in split.items()):
            return
        self.modes[f"{pre}.core"] = "tp"
        keep.update(split)
        r, di = self.tp_rank, cfg.d_inner // self.tp
        cols[f"{c}gate_norm"] = (-1, ((r * di, (r + 1) * di),))
        if g > 1 and groups:  # the groups this rank's heads read
            g0, g1 = r * hl // per, ((r + 1) * hl - 1) // per + 1
            for w in ("in_B.w", "in_C.w", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b"):
                cols[c + w] = (-1, ((g0 * n, g1 * n),))

    def _heads_rows(self, branch: str, heads: Tuple[int, ...], mesh) -> Optional[Tuple[int, int]]:
        """(h, r) of a branch whose head counts ``heads`` (and any width
        split like them) do not all divide over "model": h the largest
        divisor of the "model" size n dividing each, r = n / h; its mode
        "rows", the row groups made. None (whole) where h is 1 or r does
        not divide the dp group's rows."""
        n = self.tp
        h = max(k for k in range(1, n + 1) if n % k == 0 and all(c % k == 0 for c in heads))
        r = n // h
        if h == 1 or (r > 1 and self.rows is not None and self.rows % r):
            return None
        if r > 1:
            self.modes[branch], self.block_h[branch] = "rows", h
            self._row_groups(h, mesh)
        return h, r

    def _row_groups(self, h: int, mesh) -> None:
        """The process groups of ``h`` x r: along every "model" line of the
        mesh, the r consecutive ranks of each sequence chunk (the
        all-to-all's) and the h ranks of each row group (stride r), made in
        the same order on every rank."""
        if h in self.regroups:
            return
        n, r = self.tp, self.tp // h
        lines = mesh.mesh.movedim(self.tp_dim, -1).reshape(-1, n).tolist()
        me = dist.get_rank()
        for line in lines:
            for k in range(h):
                pg = dist.new_group(line[k * r:(k + 1) * r])
                if me in line[k * r:(k + 1) * r]:
                    exchange = pg
            for j in range(r):
                pg = dist.new_group(line[j::r])
                if me in line[j::r]:
                    heads = pg
        self.regroups[h] = (exchange, r, _TensorParallel(heads, h, self.tp_rank // r,
                                                         norm_group=self.tp_pg))

    def _xlstm(self, pre: str, blk, mesh, take) -> None:
        """Mode "tp" or "rows" for the mLSTM or sLSTM core of block ``pre``:
        this rank's heads (of its row group's split), their slices of the
        leaves."""
        cfg, c = self.cfg, f"{pre}.core."
        nh = cfg.n_heads
        if isinstance(blk, MLSTMBlock):
            di = cfg.d_inner
            split = self._heads_rows(f"{pre}.core", (nh,), mesh)
            if split is None:
                return
            h, r = split
            k = self.tp_rank // r
            ch = ((k * di // h, (k + 1) * di // h),)  # this rank's heads' channels
            take(c + "up.w", -1, (ch[0], (di + ch[0][0], di + ch[0][1])), r)
            for w in ("wq.w", "wk.w", "wv.w"):
                take(c + w, -1, ch, r)
            for w in ("w_i.w", "w_i.b", "w_f.w", "w_f.b"):
                take(c + w, -1, ((k * nh // h, (k + 1) * nh // h),), r)
            take(c + "out_norm", 0, ch, r)
            take(c + "down.w", 0, ch, r)
        else:
            d, ffw = cfg.d_model, blk.core.ffn_up.w.shape[-1]
            split = self._heads_rows(f"{pre}.core", (nh, ffw), mesh)
            if split is None:
                return
            h, r = split
            k = self.tp_rank // r
            ch = (k * d // h, (k + 1) * d // h)
            for w in ("wx.w", "wx.b"):  # the z, i, f, o paths of this rank's heads
                take(c + w, -1, tuple((g * d + ch[0], g * d + ch[1]) for g in range(4)), r)
            take(c + "r", 1, ((k * nh // h, (k + 1) * nh // h),), r)
            take(c + "out_norm", 0, (ch,), r)
            take(c + "ffn_up.w", -1, ((k * ffw // h, (k + 1) * ffw // h),), r)
            take(c + "ffn_down.w", 0, ((k * ffw // h, (k + 1) * ffw // h),), r)
        if r == 1:
            self.modes[f"{pre}.core"] = "tp"

    # -------------------------------------------------------------- #
    def local_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """This rank's block of each batch DTensor: its dp group's rows and,
        where the sequence is split, its sequence shard (dim 1)."""
        from torch.distributed.tensor import Replicate, Shard

        out = {}
        for k, v in batch.items():
            want = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                    for pl in v.placements]
            if self.sp_dim is not None:
                want[self.sp_dim] = Shard(1)
            out[k] = (v if tuple(want) == tuple(v.placements)
                      else v.redistribute(v.device_mesh, want)).to_local()
            rows = [i for i, pl in enumerate(want)
                    if i != self.sp_dim and isinstance(pl, Shard) and self.sizes[i] > 1]
        if batch:  # the dims that split the rows (not all of them where the batch does not divide)
            # a MoE on this rank's sequence shard (no tp) counts each row's shard as a run
            seq = self.sp_dim if self.tp == 1 else None
            self.over = _GlobalBatch(self.pgs, self.sizes, self.coord, rows, seq,
                                     next(iter(out.values())).shape[0])
        return out

    def _gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return _GatherSeq.apply(x, dim, self.sp_pg, self.sp)

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        s = x.shape[1] // self.sp
        return x.narrow(1, self.sp_rank * s, s)

    def _ids(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence of this rank's rows of a batch tensor (an
        input: no autograd)."""
        return _gather_dim(x, 1, self.sp_pg, self.sp) if self.sp > 1 else x

    def split(self, pre: str, w: Dict[str, torch.Tensor]):
        """The ``split`` of block ``pre`` (``models.model.Block``): each
        branch ``fn`` applied to this rank's sequence shard ``h`` of its
        normed input by the branch's mode; returns this rank's shard of the
        branch's output. ``w`` the block's group's compute weights."""

        def run(name: str, fn, h: torch.Tensor, ln: torch.Tensor, eps: float):
            mode = self.modes[f"{pre}.{name}"]
            # a MoE counts over the dp groups' global batch
            kw = {"over": self.over} if name == "moe" and self.over.groups > 1 else {}
            if mode in ("local", "tokens"):  # per token, on this rank's shard
                return fn(rms_norm(h, ln, eps), **kw)
            if mode == "context":  # this rank's queries over every rank's keys
                return fn(rms_norm(h, ln, eps), products=self.context)
            h = self.products.norm(h, ln, eps) if self.tp > 1 else rms_norm(h, ln, eps)
            if mode == "tp":  # this rank's heads / features / experts, partial sums reduced
                return fn(h, products=self.products, **kw)
            if mode == "ep":  # this rank's tokens, with this rank's experts
                return moe_ep_local(self.cfg, h, _sub(w, f"{pre}.moe."), self.tp_pg,
                                    self.tp_rank, self.tp, self.mesh_pgs)
            if mode == "rows":  # the row group's rows on this rank's heads
                group, r, products = self.regroups[self.block_h[f"{pre}.{name}"]]
                out = fn(_Regroup.apply(h, group, r, True), products=products)
                return _Regroup.apply(out, group, r, False)
            out = fn(self._gather_seq(h), **kw)  # whole; this rank's shard kept
            if name == "moe":
                return self._shard(out[0]), out[1]
            return self._shard(out)

        return run

    # -------------------------------------------------------------- #
    def embed(self, w, batch) -> Tuple[torch.Tensor, int]:
        """(this rank's sequence shard of the embedded inputs, text start):
        ``models.model.embed_inputs`` partitioned."""
        cfg, mode = self.cfg, self.modes["embed"]
        if cfg.frontend == "audio_stub":  # per token: this rank's frames alone
            return dense(batch["frames"].to(DTYPE), w["frontend_proj.w"]), 0
        vision = cfg.frontend == "vision_stub" and "patch_embeds" in batch
        if mode == "local":
            tok = w["embed"][batch["tokens"]]
        elif mode == "vocab":  # this rank's vocab rows: partial sums over the tp group
            ids = self._ids(batch["tokens"]) - self.tp_rank * w["embed"].shape[0]
            inside = (ids >= 0) & (ids < w["embed"].shape[0])
            tok = torch.where(inside[..., None], w["embed"][ids.clamp(0, w["embed"].shape[0] - 1)],
                              0.0)
            if not vision:
                # one rank's term is nonzero at each element: exact in bf16
                return _ScatterSeq.apply(tok, 1, self.tp_pg, self.tp, tok.dtype), 0
            tok = _Sum.apply(tok, self.tp_pg)
        else:
            tok = w["embed"][self._ids(batch["tokens"]) if vision else batch["tokens"]]
        if not vision:
            return tok, 0
        p = batch["patch_embeds"]
        p = self._ids(p) if mode != "local" else p
        img = dense(gelu(dense(p.to(DTYPE), w["frontend_proj.l1.w"])), w["frontend_proj.l2.w"])
        x = torch.cat([img, tok], dim=1)
        return (x if mode == "local" else self._shard(x)), img.shape[1]

    def ce(self, w, x, x0: int, batch) -> torch.Tensor:
        """The cross-entropy of ``models.model.loss_fn`` from this rank's
        sequence shard of the final residual; the same on every rank that
        splits its rows' sequence."""
        cfg, mode = self.cfg, self.modes["head"]
        h = (rms_norm if self.tp == 1 else self.products.norm)(x, w["final_norm"], cfg.rms_eps)
        head = (lambda a: a @ w["embed"].T) if cfg.tie_embeddings else (
            lambda a: dense(a, w["lm_head.w"]))
        per_position = cfg.frontend == "audio_stub" or cfg.encoder_only
        if mode == "local":
            return cross_entropy(cfg, head(h), batch)
        if per_position:
            labels = self._ids(batch["labels"]).long()
        else:
            labels = self._ids(batch["tokens"])[:, 1:].long()
        if mode == "vocab":  # every position, this rank's vocab shard
            w_head = w["embed"].T if cfg.tie_embeddings else w["lm_head.w"]
            lg = _Columns.apply(h, self.tp_pg, self.tp, w_head, None)[0]
            return self._vocab_ce((lg if per_position else lg[:, x0:-1]).float(), labels)
        # the whole vocabulary at this rank's positions
        lg = head(h).float()
        s = h.shape[1]
        pos = torch.arange(self.sp_rank * s, (self.sp_rank + 1) * s, device=h.device)
        if per_position:
            lab, valid = labels[:, pos], pos >= 0
        else:  # position p predicts text token p - x0 + 1
            lab = labels[:, (pos - x0).clamp(0, labels.shape[1] - 1)]
            valid = (pos >= x0) & (pos < s * self.sp - 1)
        lse = torch.logsumexp(lg, dim=-1)
        tgt = torch.gather(lg, -1, lab[..., None])[..., 0]
        return _Sum.apply(torch.where(valid, lse - tgt, 0.0).sum(), self.sp_pg) / labels.numel()

    def _vocab_ce(self, lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy of vocab-sharded f32 logits (b, n, V / tp)."""
        v = lg.shape[-1]
        with torch.no_grad():  # the max cancels out of the gradient
            m = _sum_(lg.amax(dim=-1), self.tp_pg, dist.ReduceOp.MAX)
        se = _Sum.apply(torch.exp(lg - m[..., None]).sum(dim=-1), self.tp_pg)
        ids = labels - self.tp_rank * v
        inside = (ids >= 0) & (ids < v)
        tgt = torch.gather(lg, -1, ids.clamp(0, v - 1)[..., None])[..., 0]
        tgt = _Sum.apply(torch.where(inside, tgt, 0.0), self.tp_pg)
        return (m + torch.log(se) - tgt).mean()

    def _block(self, blk, pre: str, w, x, positions, remat: bool):
        """Block ``pre``'s own ``forward`` on this rank's sequence shard, with
        its group's compute weights and its split."""
        return functional_call(blk, _sub(w, pre + "."), (x, positions),
                               {"remat": remat, "split": self.split(pre, w)})

    # -------------------------------------------------------------- #
    def loss(self, model, shards: Dict[str, torch.Tensor], batch: Dict, *, remat: bool = True,
             remat_policy: str = "full") -> torch.Tensor:
        """``models.model.loss_fn`` partitioned: ``shards`` {name: this
        rank's slice} (leaves that require grad), ``batch`` this rank's
        block (``local_batch``)."""
        cfg = self.cfg
        root = gather_group(self.root, shards)
        x, x0 = self.embed(root, batch)
        positions = torch.arange(x.shape[1] * self.sp, device=x.device)
        aux = 0.0
        for j, blk in enumerate(model.prefix):  # no remat, as in the reference
            x, a = self._block(blk, f"prefix.{j}", root, x, positions, False)
            aux = aux + a
        remat = remat and torch.is_grad_enabled()
        per_branch = remat and remat_policy == "save_block_outputs"
        P = len(cfg.block_pattern)

        def unit_fn(x: torch.Tensor, aux, i: int):
            w = gather_group(self.units[i], shards)
            for j in range(i * P, (i + 1) * P):
                x, a = self._block(model.blocks[j], f"blocks.{j}", w, x, positions, per_branch)
                aux = aux + a
            return x, aux

        for i in range(n_units(cfg)):
            if remat and not per_branch:
                x, aux = checkpoint(unit_fn, x, aux, i, use_reentrant=False)
            else:
                x, aux = unit_fn(x, aux, i)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        return self.ce(root, x, x0, batch) + aux

    # -------------------------------------------------------------- #
    # serving
    # -------------------------------------------------------------- #
    def _last_logits(self, w, x: torch.Tensor) -> torch.Tensor:
        """``models.model.lm_logits`` of one position ``x`` (b, 1, d), the
        same on every rank of the tp group: this rank's vocab shard where
        the head is vocab-parallel, else the whole vocabulary (in decode,
        from this rank's d slice of a head split along d, ``vocab_d``)."""
        h = rms_norm(x, w["final_norm"], self.cfg.rms_eps)
        name = "embed" if self.cfg.tie_embeddings else "lm_head.w"
        if name in self.vocab_d:  # this rank's d slice: partial sums in f32, reduced
            wt = w[name].T if self.cfg.tie_embeddings else w[name]
            idx = 0
            for i in self.vocab_d[name]:
                idx = idx * self.sizes[i] + self.coord[i]
            part = h[..., idx * wt.shape[0]:(idx + 1) * wt.shape[0]].float() @ wt.float()
            for i in self.vocab_d[name]:
                _sum_(part, self.pgs[i])
            return part.to(torch.promote_types(h.dtype, wt.dtype))
        return h @ w["embed"].T if self.cfg.tie_embeddings else dense(h, w["lm_head.w"])

    @torch.no_grad()
    def prefill(self, model, shards: Dict[str, torch.Tensor], batch: Dict) -> torch.Tensor:
        """``launch.steps.make_prefill_step`` partitioned: the train plan's
        forward on the sequence-sharded residual, no remat; returns the
        last position's logits (b, V / tp) or (b, V) (``_last_logits``).
        ``batch`` this rank's block (``local_batch``)."""
        cfg = self.cfg
        root = gather_group(self.root, shards)
        x, _ = self.embed(root, batch)
        positions = torch.arange(x.shape[1] * self.sp, device=x.device)
        for j, blk in enumerate(model.prefix):
            x, _ = self._block(blk, f"prefix.{j}", root, x, positions, False)
        P = len(cfg.block_pattern)
        for i in range(n_units(cfg)):
            w = gather_group(self.units[i], shards)
            for j in range(i * P, (i + 1) * P):
                x, _ = self._block(model.blocks[j], f"blocks.{j}", w, x, positions, False)
            del w
        last = x[:, -1:]
        if self.sp > 1:  # the last position lies on the last sequence rank's shard
            last = _gather_dim(last.contiguous(), 1, self.sp_pg, self.sp)[:, -1:]
        return self._last_logits(root, last)[:, 0]

    def local_cache(self, cache: list) -> list:
        """A decode cache of DTensors placed by ``cache_specs`` -> this
        rank's local tensors (the DTensors' own storage), recording each
        leaf's layout in ``layouts``."""
        from torch.distributed.tensor import Shard

        self.layouts, out = [], []
        for layer in cache:
            lays, local = {}, {}
            for name, t in layer.items():
                pl = tuple(t.placements)
                local[name] = t.to_local()
                on = [i for i, p in enumerate(pl) if isinstance(p, Shard) and self.sizes[i] > 1]
                tp_dim = pl[self.tp_dim].dim if self.tp_dim in on else None
                if name in ("k", "v", "ckv", "krope"):
                    seq = [i for i in on if pl[i].dim == 1]
                    idx = 0
                    for i in seq:
                        idx = idx * self.sizes[i] + self.coord[i]
                    heads = name in ("k", "v") and tp_dim == 2
                    kind = [k for k, there in (("heads", heads),
                                               ("sequence", self.tp_dim in seq),
                                               ("sequence over dp",
                                                any(i != self.tp_dim for i in seq))) if there]
                    lays[name] = CacheLayout(idx * local[name].shape[1],
                                             tuple((self.pgs[i], self.sizes[i]) for i in seq),
                                             heads, ", ".join(kind) or "whole")
                else:  # recurrent states: by head or along dk (hd), conv windows by channel
                    split = "dk" if name in ("C", "n", "c", "h") else "channels"
                    lays[name] = CacheLayout(kind={None: "whole", 1: "heads"}.get(tp_dim, split))
            self.layouts.append(lays)
            out.append(local)
        return out

    def cache_kinds(self) -> Dict[str, int]:
        """The decode cache's leaves by layout (``CacheLayout.kind``)."""
        counts: Dict[str, int] = {}
        for lays in self.layouts:
            for lay in lays.values():
                counts[lay.kind] = counts.get(lay.kind, 0) + 1
        return dict(sorted(counts.items()))

    def _decode_split(self, pre: str, layer: int):
        """The ``split`` of block ``pre`` in the decode step: each branch
        on this rank's rows, attention (which holds the layer's cache)
        through ``_Decode`` always, the others where their mode is "tp"."""

        def run(name: str, fn, h: torch.Tensor, ln: torch.Tensor, eps: float):
            mode = self.modes[f"{pre}.{name}"]
            a = rms_norm(h, ln, eps)
            if name == "attn":
                return fn(a, products=_Decode(self.tp_pg, self.tp, self.tp_rank, mode == "tp",
                                              True, self.layouts[layer]))
            if mode in ("tp", "dk"):
                return fn(a, products=_Decode(self.tp_pg, self.tp, self.tp_rank, True,
                                              picks=self.picks, dk=mode == "dk"))
            return fn(a)

        return run

    def _embed_tokens(self, w, tokens: torch.Tensor) -> torch.Tensor:
        if "embed" in self.vocab_d:  # this rank's d slice of each token's row, gathered
            tok = w["embed"][tokens]
            for i in reversed(self.vocab_d["embed"]):  # minor dims first, as the leaf's gather
                tok = _gather_dim(tok, tok.dim() - 1, self.pgs[i], self.sizes[i])
            return tok
        if self.modes["embed"] != "vocab":
            return w["embed"][tokens]
        v = w["embed"].shape[0]  # this rank's vocab rows; one rank's term nonzero: exact
        ids = tokens - self.tp_rank * v
        inside = (ids >= 0) & (ids < v)
        tok = torch.where(inside[..., None], w["embed"][ids.clamp(0, v - 1)], 0.0)
        return _sum_(tok.float(), self.tp_pg).to(tok.dtype)

    @torch.no_grad()
    def decode(self, model, shards: Dict[str, torch.Tensor], cache: list, tokens: torch.Tensor,
               pos: int) -> torch.Tensor:
        """``models.model.decode_step`` partitioned (a plan made with
        ``decode=True``): ``cache`` this rank's local cache (``local_cache``;
        written in place, a recurrent block's new states put in its dict),
        ``tokens`` this rank's rows (b, 1), ``pos`` the tokens already in
        the cache. Returns the new token's logits (``_last_logits``)."""
        cfg = self.cfg
        root = gather_group(self.root_decode, shards)
        root.update({name: shards[name] for name in self.vocab_d})
        x = self._embed_tokens(root, tokens)
        positions = torch.arange(pos, pos + 1, device=x.device)

        def block(blk, pre: str, w, layer: int):
            return functional_call(blk, _sub(w, pre + "."), (x, positions, cache[layer], pos),
                                   {"split": self._decode_split(pre, layer)})[0]

        for j, blk in enumerate(model.prefix):
            x = block(blk, f"prefix.{j}", root, j)
        P, k0 = len(cfg.block_pattern), cfg.first_k_dense
        for i in range(n_units(cfg)):
            w = gather_group(self.units[i], shards)
            for j in range(i * P, (i + 1) * P):
                x = block(model.blocks[j], f"blocks.{j}", w, k0 + j)
            del w
        return self._last_logits(root, x)[:, 0]

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The next token (b, 1) of ``decode``'s logits: with a vocab-sharded
        head each rank's largest logit and its first index, gathered over
        "model", the largest taken, a tie going to the lowest index."""
        idx = logits.argmax(dim=-1)
        if self.modes["head"] != "vocab":
            return idx[:, None]
        val = logits.gather(-1, idx[:, None])[:, 0]
        pair = torch.stack([val.double(), (idx + self.tp_rank * logits.shape[-1]).double()], -1)
        every = _gather_dim(pair[None], 0, self.tp_pg, self.tp)  # (tp, b, 2), rank order
        best = every[..., 0].argmax(dim=0)  # the first rank with the largest value
        return every[..., 1].gather(0, best[None])[0].long()[:, None]
