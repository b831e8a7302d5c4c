"""Model assembly: token embedding + repeating-unit block stack + head.

Port of ``repro/models/model.py`` for attention and Mamba-2 blocks. JAX
stacks the per-unit params and runs the units under ``jax.lax.scan``; here
each layer is its own module in one flat ``model.blocks`` list, in layer
order (unit i, pattern slot j is ``blocks[i * len(pattern) + j]``), and the
stack is a Python loop over units. ``remat`` checkpoints each unit, as
``jax.checkpoint(unit_fn)`` does. The decode cache is a list of per-layer
dicts (``{"k", "v"}`` for attention, the conv windows and SSM state for
Mamba-2), updated in place by ``decode_step``.

Public API (the JAX names):
  init_params(cfg, generator, device)           -> Model
  forward(cfg, model, batch, remat=True)        -> (logits, aux_loss)
  loss_fn(cfg, model, batch, remat=True)        -> scalar loss
  init_cache(cfg, batch, max_len, device)       -> decode cache
  decode_step(cfg, model, cache, tokens, pos)   -> (logits, cache)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPE, MLP, Attention, Dense, _ones, _randn, rms_norm
from repro_torch.models.ssm import Mamba2, init_mamba2_cache

Cache = List[Dict[str, torch.Tensor]]


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of ``repro.models`` this port does not have yet
    (named by their ROADMAP queue item)."""
    missing = []
    if any(kind not in ("attn", "mamba2") for kind in cfg.block_pattern):
        missing.append(f"blocks {cfg.block_pattern} (mlstm/slstm: ROADMAP A8)")
    if cfg.n_routed_experts:
        missing.append("MoE (ROADMAP A9)")
    if cfg.first_k_dense:
        missing.append("first_k_dense prefix layers (ROADMAP A9)")
    if cfg.use_mla:
        missing.append("MLA attention (ROADMAP A5)")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend (ROADMAP A10)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: " + "; ".join(missing))


class Block(nn.Module):
    """Pre-norm attention block: x + attn(ln1(x)), then x + ffn(ln2(x))."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        self.rms_eps = cfg.rms_eps
        self.ln1 = _ones(cfg.d_model, device)
        self.attn = Attention(cfg, generator=generator, device=device)
        if cfg.d_ff:
            self.ln2 = _ones(cfg.d_model, device)
            self.ffn = MLP(cfg, generator=generator, device=device)
        else:
            self.ffn = None

    def forward(self, x, positions, cache=None, cache_len=None) -> torch.Tensor:
        x = x + self.attn(rms_norm(x, self.ln1, self.rms_eps), positions, cache, cache_len)
        if self.ffn is not None:
            x = x + self.ffn(rms_norm(x, self.ln2, self.rms_eps))
        return x


class Mamba2Block(nn.Module):
    """Pre-norm Mamba-2 block: x + mamba2(ln(x))."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        self.cfg = cfg
        self.ln = _ones(cfg.d_model, device)
        self.core = Mamba2(cfg, generator=generator, device=device)

    def forward(self, x, positions, cache=None, cache_len=None) -> torch.Tensor:
        y, _ = self.core(rms_norm(x, self.ln, self.cfg.rms_eps), cache)
        return x + y


_BLOCKS = {"attn": Block, "mamba2": Mamba2Block}


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator], device) -> None:
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = _randn((cfg.vocab, cfg.d_model), 0.02, generator, device)
        self.blocks = nn.ModuleList(
            _BLOCKS[kind](cfg, generator=generator, device=device)
            for _ in range(cfg.n_units) for kind in cfg.block_pattern
        )
        self.final_norm = _ones(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab, generator=generator, device=device)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Model:
    """Random weights drawn from ``generator`` (which must live on
    ``device``), with the JAX init's scales and dtypes."""
    return Model(cfg, generator=generator, device=device)


def embed_inputs(cfg: ModelConfig, model: Model, batch: Dict) -> Tuple[torch.Tensor, int]:
    """Returns (x, text_start): x (b, S, d). Tokens only for now."""
    return model.embed[batch["tokens"]], 0


def lm_logits(cfg: ModelConfig, model: Model, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, cfg.rms_eps)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return model.lm_head(x)


def forward(
    cfg: ModelConfig,
    model: Model,
    batch: Dict,
    *,
    remat: bool = True,
    remat_policy: str = "full",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``remat`` checkpoints each unit when autograd records (full remat: the
    backward re-runs the unit's forward, kernels included)."""
    if remat and remat_policy != "full":
        raise NotImplementedError(f"remat_policy={remat_policy!r}: only 'full' is ported "
                                  f"(save_block_outputs: ROADMAP A6)")
    x, _ = embed_inputs(cfg, model, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    P = len(cfg.block_pattern)

    def unit_fn(x: torch.Tensor, i: int) -> torch.Tensor:
        for blk in model.blocks[i * P:(i + 1) * P]:
            x = blk(x, positions)
        return x

    for i in range(cfg.n_units):
        if remat and torch.is_grad_enabled():
            x = checkpoint(unit_fn, x, i, use_reentrant=False)
        else:
            x = unit_fn(x, i)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)  # no MoE: no router loss
    return lm_logits(cfg, model, x), aux


def loss_fn(cfg: ModelConfig, model: Model, batch: Dict, *, remat: bool = True,
            remat_policy: str = "full") -> torch.Tensor:
    """Next-token cross-entropy of the token LM: logits in f32, logsumexp
    minus the target logit, mean over positions, plus the aux loss."""
    logits, aux = forward(cfg, model, batch, remat=remat, remat_policy=remat_policy)
    lg32 = logits[:, :-1].float()
    labels = batch["tokens"][:, 1:].long()
    lse = torch.logsumexp(lg32, dim=-1)
    tgt = torch.gather(lg32, -1, labels[..., None])[..., 0]
    return (lse - tgt).mean() + aux


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    if kind == "attn":
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=DTYPE, device=device),
                "v": torch.zeros(shape, dtype=DTYPE, device=device)}
    return init_mamba2_cache(cfg, batch, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Cache:
    return [_init_block_cache(cfg, kind, batch, max_len, device)
            for _ in range(cfg.n_units) for kind in cfg.block_pattern]


@torch.no_grad()
def decode_step(
    cfg: ModelConfig,
    model: Model,
    cache: Cache,
    tokens: torch.Tensor,  # (b, 1) int
    pos: int,  # number of tokens already in the cache
) -> Tuple[torch.Tensor, Cache]:
    """One token for every sequence; updates ``cache`` in place (attention
    K/V at ``pos``, Mamba-2 conv windows and state) and returns
    (logits (b, vocab), cache)."""
    assert cfg.supports_decode, f"{cfg.name} is encoder-only"
    x = model.embed[tokens]
    positions = torch.arange(pos, pos + 1, device=x.device)
    for blk, c in zip(model.blocks, cache):
        x = blk(x, positions, c, pos)
    return lm_logits(cfg, model, x)[:, 0], cache
