"""Step functions shared by the entry points (port of ``repro/launch/steps.py``).
PyTorch runs them eagerly: there is no ``jax.jit`` here.

The training state is ``{"model": Model, "opt": optimizer state}``; a train
step updates the model's parameters and the optimizer state in place and
returns the new state (a retried step ends where an unfailed one ends: see
``make_train_step``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward, init_params, loss_fn
from repro_torch.optim.optimizers import Optimizer


def make_init_state(cfg: ModelConfig, optimizer: Optimizer, device="cuda"):
    def init_state(generator: torch.Generator) -> Dict:
        model = init_params(cfg, generator, device)
        return {"model": model, "opt": optimizer.init(dict(model.named_parameters()))}

    return init_state


def make_grads_fn(cfg: ModelConfig, *, remat: bool = True, microbatches: int = 1,
                  remat_policy: str = "full"):
    """(model, batch) -> (loss, grads by parameter name). ``microbatches > 1``
    = gradient accumulation: the batch is split along axis 0 and the grads
    are summed into f32 accumulators, each microbatch's divided by the
    count (the ``lax.scan`` of JAX's train step)."""

    def grads_of(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if microbatches == 1:
            loss = loss_fn(cfg, model, batch, remat=remat, remat_policy=remat_policy)
            loss.backward()
            return loss.detach(), {k: p.grad for k, p in params.items()}
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch {n} % microbatches {microbatches} != 0")
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
        for mb in zip(*(v.chunk(microbatches) for v in batch.values())):
            loss = loss_fn(cfg, model, dict(zip(batch, mb)), remat=remat,
                           remat_policy=remat_policy)
            loss.backward()
            with torch.no_grad():
                for k, p in params.items():
                    acc[k] += p.grad.float() / microbatches
                    p.grad = None
            loss_acc = loss_acc + loss.detach() / microbatches
        return loss_acc, acc

    return grads_of


class _Progress(set):
    """The parameters a step's update has written; ``hook(n)`` runs after
    the n-th (the fault-injection point of the tests and chip_smoke.py)."""

    def __init__(self, hook: Optional[Callable[[int], None]]) -> None:
        super().__init__()
        self.hook = hook

    def add(self, name: str) -> None:
        super().add(name)
        if self.hook is not None:
            self.hook(len(self))


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    remat: bool = True,
    microbatches: int = 1,
    remat_policy: str = "full",
    update_hook: Optional[Callable[[int], None]] = None,
):
    """One optimizer step: (state, batch) -> (state, {"loss", "step"}).

    The update is written in place, so a step that fails partway is
    recorded on the ``state`` dict it was given, and calling it again with
    the same (state, batch) -- a retry -- ends where one unfailed call
    ends, bit for bit: the grads are computed once (a failure before the
    update leaves the state untouched) and kept under ``state["pending"]``
    with the set of parameters already written; a retry skips the grads
    and finishes the update. A finished step leaves nothing behind, so a
    call after it is the next step. ``update_hook(n)`` runs after the n-th
    parameter is written."""
    grads_of = make_grads_fn(cfg, remat=remat, microbatches=microbatches,
                             remat_policy=remat_policy)

    def train_step(state: Dict, batch: Dict):
        model = state["model"]
        if "pending" not in state:
            loss, grads = grads_of(model, batch)
            for p in model.parameters():
                p.grad = None
            state["pending"] = {"loss": loss, "grads": grads, "written": _Progress(update_hook)}
        pending = state["pending"]
        opt = optimizer.update(pending["grads"], state["opt"], dict(model.named_parameters()),
                               committed=pending["written"])
        del state["pending"]
        return {"model": model, "opt": opt}, {"loss": pending["loss"], "step": opt["step"]}

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(model, batch):
        return loss_fn(cfg, model, batch, remat=False)

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    """Forward over the full prompt (logits of the last position)."""

    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _ = forward(cfg, model, batch, remat=False)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: next token given a KV/SSM cache of ``pos`` tokens."""

    def serve_step(model, cache, tokens, pos):
        logits, cache = decode_step(cfg, model, cache, tokens, pos)
        return logits.argmax(dim=-1, keepdim=True), cache

    return serve_step
