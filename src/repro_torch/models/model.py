"""Model assembly: embedding/frontends + prefix layers + repeating-unit
block stack + head.

Port of ``repro/models/model.py`` for every block kind of the ten configs:
attention (GQA or MLA) with a dense MLP or a Mixture-of-Experts FFN,
Mamba-2, mLSTM and sLSTM, DeepSeek's ``first_k_dense`` prefix of dense MLA
layers (``model.prefix``, outside the units), and the two stub frontends:
``audio_stub`` (precomputed frames through ``frontend_proj``, no token
embedding) and ``vision_stub`` (precomputed patch embeddings through the
two-layer projector ``frontend_proj.{l1, l2}``, placed before the text
tokens). JAX stacks the per-unit params and runs the units under
``jax.lax.scan``; here each layer is its own module in one flat
``model.blocks`` list, in layer order (unit i, pattern slot j is
``blocks[i * len(pattern) + j]``), and the stack is a Python loop over
units. ``remat`` checkpoints each unit, as ``jax.checkpoint(unit_fn)``
does, or, with ``remat_policy="save_block_outputs"``, each residual branch
inside the units. Every block returns its router aux loss (zero without
MoE), summed over the layers. The decode cache is a list of per-layer dicts, prefix
layers first (``{"k", "v"}`` for attention, ``{"ckv", "krope"}`` for MLA,
the conv windows and SSM state for Mamba-2, the conv window and (C, n, m)
for mLSTM, (c, n, h, m) for sLSTM), updated in place by ``decode_step``;
MoE decodes droplessly, ``forward`` drops past capacity.

Public API (the JAX names):
  init_params(cfg, generator, device)           -> Model
  forward(cfg, model, batch, remat=True)        -> (logits, aux_loss)
  loss_fn(cfg, model, batch, remat=True)        -> scalar loss
  init_cache(cfg, batch, max_len, device)       -> decode cache
  decode_step(cfg, model, cache, tokens, pos)   -> (logits, cache)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.layers import (
    DTYPE,
    MLA,
    MLP,
    Attention,
    Dense,
    _ones,
    _randn,
    gelu,
    rms_norm,
)
from repro_torch.models.moe import MoE
from repro_torch.sharding import hints as hints_mod
from repro_torch.sharding.hints import shard_hint

Cache = List[Dict[str, torch.Tensor]]
REMAT_POLICIES = ("full", "save_block_outputs")
# (x, the block's router aux loss: a 0-d f32 tensor from a MoE FFN, else 0.0,
# which costs the decode step no device work)
BlockOut = Tuple[torch.Tensor, Union[torch.Tensor, float]]


def n_units(cfg: ModelConfig) -> int:
    """Units of ``block_pattern`` after the ``first_k_dense`` prefix layers
    (``cfg.n_units`` counts the prefix too)."""
    n_scanned = cfg.n_layers - cfg.first_k_dense
    if n_scanned % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: {n_scanned} layers after the prefix do not divide "
                         f"into units of {cfg.block_pattern}")
    return n_scanned // len(cfg.block_pattern)


def _branch(fn, x: torch.Tensor, remat: bool):
    """One residual branch ``fn(x)``; with ``remat`` its output is kept for
    the backward and everything inside it is recomputed (the reference's
    ``checkpoint_name(..., "block_out")`` under ``save_only_these_names``)."""
    return checkpoint(fn, x, use_reentrant=False) if remat else fn(x)


def _whole(name: str, fn, h: torch.Tensor, w: torch.Tensor, eps: float):
    """A block's branch ``fn`` applied to its input ``h`` normed by ``w``,
    as it is: the default ``split`` of ``Block`` and ``_CoreBlock``. The
    partitioned train step passes its own (``sharding/partition.py``),
    which takes the branch's ``name`` ("attn", "ffn", "moe", "core") and
    this rank's sequence shard ``h``, and may give ``fn`` its
    tensor-parallel ``products`` by keyword."""
    return fn(rms_norm(h, w, eps))


class Block(nn.Module):
    """Pre-norm attention block (GQA or MLA): x + attn(ln1(x)), then
    x + ffn(ln2(x)) with a MoE FFN where the config has routed experts and
    ``moe`` is set (the units), else a dense MLP where it has ``d_ff``."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device,
                 moe: bool = True) -> None:
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.rms_eps = cfg.rms_eps
        self.ln1 = _ones(cfg.d_model, device)
        self.attn = MLA(cfg, **kw) if cfg.use_mla else Attention(cfg, **kw)
        self.ffn = self.moe = None
        if moe and cfg.n_routed_experts:
            self.ln2 = _ones(cfg.d_model, device)
            self.moe = MoE(cfg, **kw)
        elif cfg.d_ff:
            self.ln2 = _ones(cfg.d_model, device)
            self.ffn = MLP(cfg, **kw)

    def forward(self, x, positions, cache=None, cache_len=None, remat: bool = False,
                split=_whole) -> BlockOut:
        x = x + _branch(lambda h: split(
            "attn", lambda a, **kw: self.attn(a, positions, cache, cache_len, **kw),
            h, self.ln1, self.rms_eps), x, remat)
        aux = 0.0
        if self.moe is not None:
            y, aux = _branch(lambda h: split("moe", lambda a, **kw: self._moe(a, cache, **kw),
                                             h, self.ln2, self.rms_eps), x, remat)
            x = x + y
        elif self.ffn is not None:
            x = x + _branch(lambda h: split("ffn", lambda a, **kw: self.ffn(a, **kw),
                                            h, self.ln2, self.rms_eps), x, remat)
        return x, aux

    def _moe(self, h: torch.Tensor, cache, **kw) -> BlockOut:
        """The expert-parallel layer under a mesh with ``ep_shardmap`` (no
        cache; ``moe_ep.ep_available``), else the MoE FFN (given the
        partitioned step's ``products`` and global batch ``over`` by
        keyword); decode (cache present) routes droplessly, as the
        reference does."""
        from repro_torch.models import moe_ep

        if (cache is None and hints_mod._STATE.get("ep_shardmap")
                and moe_ep.ep_available(self.moe.cfg, h)):
            return moe_ep.moe_apply_ep(self.moe, self.moe.cfg, h)
        return self.moe(h, dropless=cache is not None, **kw)


class _CoreBlock(nn.Module):
    """Pre-norm recurrent block: x + core(ln(x)); the core updates a decode
    cache in place."""

    core_cls: type

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        self.cfg = cfg
        self.ln = _ones(cfg.d_model, device)
        self.core = self.core_cls(cfg, generator=generator, device=device)

    def forward(self, x, positions, cache=None, cache_len=None, remat: bool = False,
                split=_whole) -> BlockOut:
        y = _branch(lambda h: split("core", lambda a, **kw: self.core(a, cache, **kw)[0],
                                    h, self.ln, self.cfg.rms_eps), x, remat)
        return x + y, 0.0


class Mamba2Block(_CoreBlock):
    core_cls = ssm.Mamba2


class MLSTMBlock(_CoreBlock):
    core_cls = ssm.MLSTM


class SLSTMBlock(_CoreBlock):
    core_cls = ssm.SLSTM


_BLOCKS = {"attn": Block, "mamba2": Mamba2Block, "mlstm": MLSTMBlock, "slstm": SLSTMBlock}
_CACHES = {"mamba2": ssm.init_mamba2_cache, "mlstm": ssm.init_mlstm_cache,
           "slstm": ssm.init_slstm_cache}


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(generator=generator, device=device)
        if cfg.frontend == "audio_stub":  # frames in, no token embedding
            self.embed = None
            self.frontend_proj = Dense(cfg.d_frontend, d, **kw)
        else:
            self.embed = _randn((cfg.vocab, d), 0.02, generator, device)
            if cfg.frontend == "vision_stub":
                self.frontend_proj = nn.ModuleDict(
                    {"l1": Dense(cfg.d_frontend, d, **kw), "l2": Dense(d, d, **kw)})
        # the dense prefix layers: attention blocks with an MLP, no MoE
        self.prefix = nn.ModuleList(
            Block(cfg, generator=generator, device=device, moe=False)
            for _ in range(cfg.first_k_dense)
        )
        self.blocks = nn.ModuleList(
            _BLOCKS[kind](cfg, generator=generator, device=device)
            for _ in range(n_units(cfg)) for kind in cfg.block_pattern
        )
        self.final_norm = _ones(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab, generator=generator, device=device)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Model:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), with the JAX init's scales and dtypes."""
    return Model(cfg, generator=generator, device=device)


def embed_inputs(cfg: ModelConfig, model: Model, batch: Dict) -> Tuple[torch.Tensor, int]:
    """Returns (x, text_start): x (b, S, d); text_start is the index where
    the text tokens begin (after a vision prefix; for the loss's mask).
    Audio: ``batch["frames"]`` (b, S, d_frontend), cast to bf16, projected.
    Vision: ``l2(gelu(l1(patch_embeds)))`` before the token embeddings
    where the batch has ``patch_embeds``, else the text alone."""
    if cfg.frontend == "audio_stub":
        return model.frontend_proj(batch["frames"].to(DTYPE)), 0
    tok = model.embed[batch["tokens"]]  # (b, s_text, d)
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        fp = model.frontend_proj
        img = fp["l2"](gelu(fp["l1"](batch["patch_embeds"].to(DTYPE))))
        return torch.cat([img, tok], dim=1), img.shape[1]
    return tok, 0


def lm_logits(cfg: ModelConfig, model: Model, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, cfg.rms_eps)
    logits = x @ model.embed.T if cfg.tie_embeddings else model.lm_head(x)
    # keep the vocab dim model-sharded: the single biggest activation
    return shard_hint(logits, "dp", None, "tp")


def forward(
    cfg: ModelConfig,
    model: Model,
    batch: Dict,
    *,
    remat: bool = True,
    remat_policy: str = "full",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """With autograd recording, ``remat`` recomputes in the backward, by
    ``remat_policy``: ``"full"`` checkpoints each unit (the backward re-runs
    the unit's forward, kernels included, from the unit's input);
    ``"save_block_outputs"`` checkpoints each residual branch of each unit
    (attention, FFN/MoE, recurrent core), so the residual stream between
    branches is kept and each branch's inside is recomputed. The prefix
    layers are never rematerialised, as in the reference."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r}: one of {REMAT_POLICIES}")
    x, _ = embed_inputs(cfg, model, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    P = len(cfg.block_pattern)
    aux = 0.0  # a float until a MoE block adds its tensor: no device work without MoE
    x = shard_hint(x, "dp", "sp", None)
    for blk in model.prefix:  # outside the units, as in the reference: no remat
        x, a = blk(x, positions)
        aux = aux + a
    remat = remat and torch.is_grad_enabled()
    per_branch = remat and remat_policy == "save_block_outputs"

    def unit_fn(x: torch.Tensor, aux, i: int) -> BlockOut:
        for blk in model.blocks[i * P:(i + 1) * P]:
            x, a = blk(x, positions, remat=per_branch)
            x = shard_hint(x, "dp", "sp", None)
            aux = aux + a
        return x, aux

    for i in range(n_units(cfg)):
        if remat and not per_branch:
            x, aux = checkpoint(unit_fn, x, aux, i, use_reentrant=False)
        else:
            x, aux = unit_fn(x, aux, i)
    return lm_logits(cfg, model, x), torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, model: Model, batch: Dict, *, remat: bool = True,
            remat_policy: str = "full") -> torch.Tensor:
    """Cross-entropy with logits in f32 (logsumexp minus the target logit,
    mean over positions) plus the aux loss: against ``batch["labels"]`` at
    every position for the audio / encoder-only configs, else next-token
    over the text positions (after any image prefix)."""
    logits, aux = forward(cfg, model, batch, remat=remat, remat_policy=remat_policy)
    return cross_entropy(cfg, logits, batch) + aux


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """``loss_fn``'s cross-entropy of the whole logits (b, S, vocab)."""
    if cfg.frontend == "audio_stub" or cfg.encoder_only:
        lg32, labels = logits.float(), batch["labels"].long()
    else:
        x0 = logits.shape[1] - batch["tokens"].shape[1]  # text start (VLM prefix)
        lg32, labels = logits[:, x0:-1].float(), batch["tokens"][:, 1:].long()
    lg32 = shard_hint(lg32, "dp", None, "tp")
    lse = torch.logsumexp(lg32, dim=-1)
    tgt = torch.gather(lg32, -1, labels[..., None])[..., 0]
    return (lse - tgt).mean()


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    if kind == "attn" and cfg.use_mla:
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=DTYPE, device=device),
                "krope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=DTYPE,
                                     device=device)}
    if kind == "attn":
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=DTYPE, device=device),
                "v": torch.zeros(shape, dtype=DTYPE, device=device)}
    if kind not in _CACHES:
        raise ValueError(f"unknown block kind {kind!r}")
    # recurrent caches keep their initial values: the m-stabilisers of
    # mLSTM and sLSTM start at -1e30, not 0
    return _CACHES[kind](cfg, batch, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Cache:
    """Per-layer caches in layer order: the prefix layers', then the units'."""
    prefix = [_init_block_cache(cfg, "attn", batch, max_len, device)
              for _ in range(cfg.first_k_dense)]
    return prefix + [_init_block_cache(cfg, kind, batch, max_len, device)
                     for _ in range(n_units(cfg)) for kind in cfg.block_pattern]


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    model: Model,
    cache: Cache,
    tokens: torch.Tensor,  # (b, 1) int
    pos: int,  # number of tokens already in the cache
) -> Tuple[torch.Tensor, Cache]:
    """One token for every sequence; updates ``cache`` in place (attention
    K/V or MLA latents at ``pos``, the recurrent blocks' conv windows and
    states) and returns (logits (b, vocab), cache). MoE routes droplessly."""
    assert cfg.supports_decode, f"{cfg.name} is encoder-only"
    x = model.embed[tokens]
    positions = torch.arange(pos, pos + 1, device=x.device)
    for blk, c in zip([*model.prefix, *model.blocks], cache, strict=True):
        x, _ = blk(x, positions, c, pos)
    return lm_logits(cfg, model, x)[:, 0], cache
