"""Step functions shared by the entry points (port of ``repro/launch/steps.py``,
serving half). PyTorch runs them eagerly: there is no ``jax.jit`` here."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward


def make_prefill_step(cfg: ModelConfig):
    """Forward over the full prompt (logits of the last position)."""

    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _ = forward(cfg, model, batch)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: next token given a KV cache of ``pos`` tokens."""

    def serve_step(model, cache, tokens, pos):
        logits, cache = decode_step(cfg, model, cache, tokens, pos)
        return logits.argmax(dim=-1, keepdim=True), cache

    return serve_step
