"""Step functions shared by the entry points (port of ``repro/launch/steps.py``).
PyTorch runs them eagerly: there is no ``jax.jit`` here.

The training state is ``{"model": Model, "opt": optimizer state}``; a train
step updates the model's parameters and the optimizer state in place and
returns the new state (a retried step ends where an unfailed one ends: see
``make_train_step``).
"""

from __future__ import annotations

import math
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


def _grads(loss_of, params: Dict[str, torch.Tensor], batch: Dict, microbatches: int
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads by name) of ``loss_of(batch)`` with respect to the
    leaves ``params``. ``microbatches > 1`` = gradient accumulation: the
    batch is split along axis 0 and the grads are summed into f32
    accumulators, each microbatch's divided by the count (the ``lax.scan``
    of JAX's train step)."""
    for p in params.values():
        p.grad = None
    if microbatches == 1:
        loss = loss_of(batch)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in params.items()}
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch {n} % microbatches {microbatches} != 0")
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
    for mb in zip(*(v.chunk(microbatches) for v in batch.values())):
        loss = loss_of(dict(zip(batch, mb)))
        loss.backward()
        with torch.no_grad():
            for k, p in params.items():
                acc[k] += p.grad.float() / microbatches
                p.grad = None
        loss_acc = loss_acc + loss.detach() / microbatches
    return loss_acc, acc


def make_grads_fn(cfg: ModelConfig, *, remat: bool = True, microbatches: int = 1,
                  remat_policy: str = "full"):
    """(model, batch) -> (loss, grads by parameter name), accumulated over
    ``microbatches`` (``_grads``)."""

    def grads_of(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return _grads(lambda b: loss_fn(cfg, model, b, remat=remat, remat_policy=remat_policy),
                      dict(model.named_parameters()), batch, microbatches)

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


# ------------------------------------------------------------------ #
# on a mesh
# ------------------------------------------------------------------ #
def distribute_state(state: Dict, cfg: ModelConfig, mesh, rules) -> Dict:
    """A training state made whole on every rank (the same seed) -> the
    same state of DTensors placed by ``sharding.specs.state_specs``: each
    rank keeps its slice of every parameter, moment and master weight."""
    from repro_torch.models.convert import distribute_model
    from repro_torch.sharding.place import from_full
    from repro_torch.sharding.specs import named, param_specs

    model = distribute_model(state["model"], cfg, mesh, rules)
    opt = {"step": state["opt"]["step"]}
    for k, tree in state["opt"].items():
        if k != "step":  # the moments and master mirror the parameters' specs
            sh = named(param_specs(tree, cfg, mesh, rules), mesh)
            opt[k] = {n: from_full(t, *sh[n], copy=False) for n, t in tree.items()}
    return {"model": model, "opt": opt}


def init_distributed_state(cfg: ModelConfig, optimizer: Optimizer, generator: torch.Generator,
                           mesh, rules, device="cuda") -> Dict:
    """``make_init_state`` on a mesh, as ``distribute_state`` of it places
    it: the whole weights drawn on every rank from the same generator, each
    rank keeping its slices, and the optimizer state made from those
    slices (the same values; no rank holds the whole moments or master
    weights, which at 12 bytes a parameter would not fit several ranks on
    one card)."""
    from torch.distributed.tensor import DTensor

    state = distribute_state({"model": init_params(cfg, generator, device),
                              "opt": optimizer.init({})}, cfg, mesh, rules)
    params = dict(state["model"].named_parameters())
    local = optimizer.init({k: p.to_local() for k, p in params.items()})
    state["opt"] = {k: (v if k == "step" else {
        n: DTensor.from_local(t, mesh, params[n].placements, run_check=False,
                              shape=params[n].shape, stride=params[n].stride())
        for n, t in v.items()}) for k, v in local.items()}
    return state


class _InPlace(dict):
    """{name: tensor} whose assignments copy into the tensors it holds: the
    optimizer's new moments land in the DTensors' local storage."""

    def __setitem__(self, key, value) -> None:
        self[key].copy_(value)


def make_agree(device):
    """agree(ok) -> whether every rank of the world passed True (an
    all-reduce of a flag: the ranks settle each attempt's outcome together)."""
    import torch.distributed as dist

    def agree(ok: bool) -> bool:
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    return agree


def make_sharded_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    mesh,
    *,
    agree: Callable[[bool], bool],
    rules=None,
    remat: bool = True,
    microbatches: int = 1,
    remat_policy: str = "full",
    update_hook: Optional[Callable[[int], None]] = None,
):
    """``make_train_step`` on a mesh, for a state of DTensors placed by
    ``state_specs`` (under ``rules``, default ``ShardingRules()``) and
    batches placed by ``batch_specs``.

    Between steps every rank holds only its slices of the parameters,
    moments and master weights. A step computes partitioned
    (``sharding/partition.py``): FSDP per unit over the dp mesh dims (a
    unit's leaves gathered along their sharded dims before its forward and
    its recompute, its grads reduce-scattered to this rank's slices in f32
    when its backward ends), tensor and sequence parallelism over the tp
    dim for attention, MLP and the vocabulary, and the expert-parallel MoE
    where the hints ask for it (``ep_shardmap``). The rank's grads come
    out as its slices of the dp mean's grads, rounded to the grads' dtype.
    The clip norm is the whole grads', summed from the slices. Each rank
    updates its own slice of every parameter, moment and master weight:
    no collective. Where every mesh dim has one rank there is no
    collective and nothing is divided, so at world size 1 a step is the
    unmeshed one bit for bit.

    The retry contract of ``make_train_step`` holds, and the ranks agree
    (``agree``) once the update is written, before it commits: a rank whose
    update failed, or whose peer's did, raises and keeps its
    ``state["pending"]``, and every rank's retry finishes the update."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.runtime import PeerStepError
    from repro_torch.sharding.partition import Partition, dp_rows, seq_dim
    from repro_torch.sharding.specs import ShardingRules

    rules = rules or ShardingRules()

    def grads_phase(model, batch):
        part = getattr(train_step, "partition", None)
        if part is None:  # the plan is the state's and the batch's placements': made once
            part = train_step.partition = Partition(
                cfg, model, mesh, rules, rows=dp_rows(batch, mesh, rules) // microbatches,
                seq=seq_dim(batch))
        # this rank's slices as leaves of the step (the state's storage)
        shards = {k: p.to_local().detach().requires_grad_(True)
                  for k, p in model.named_parameters()}
        loss, grads = _grads(lambda b: part.loss(model, shards, b, remat=remat,
                                                 remat_policy=remat_policy),
                             shards, part.local_batch(batch), microbatches)
        # the loss of the dp groups' mean: the ranks that split the sequence hold the same
        rest = [i for i in range(mesh.ndim) if mesh.size(i) > 1 and i != part.sp_dim]
        if rest:
            flat = loss.float().reshape(1)
            for i in rest:
                dist.all_reduce(flat, group=mesh.get_group(i))
            loss = flat[0] / math.prod(mesh.size(i) for i in rest)
        # the whole grads' norm: each slice's squares over the ranks that hold it
        layouts = {k: tuple(p.placements) for k, p in model.named_parameters()}
        reps = {k: mesh.size() // math.prod(mesh.size(i) for i, pl in enumerate(layouts[k])
                                             if isinstance(pl, Shard)) for k in grads}
        sq = sum(torch.sum(torch.square(g.float())) / reps[k] for k, g in grads.items())
        if mesh.size() > 1:
            sq = sq.reshape(1)
            for i in range(mesh.ndim):
                if mesh.size(i) > 1:
                    dist.all_reduce(sq, group=mesh.get_group(i))
            sq = sq[0]
        return loss, grads, torch.sqrt(sq)

    def train_step(state: Dict, batch: Dict):
        model = state["model"]
        if "pending" not in state:
            loss, grads, norm = grads_phase(model, batch)
            state["pending"] = {"loss": loss, "grads": grads, "norm": norm,
                                "written": _Progress(update_hook)}
        pending, opt = state["pending"], state["opt"]
        err = None
        with torch.no_grad():
            params = {k: p.to_local() for k, p in model.named_parameters()}
            views = {k: (v if k == "step" else _InPlace({n: t.to_local() for n, t in v.items()}))
                     for k, v in opt.items()}
            try:
                new = optimizer.update(pending["grads"], views, params,
                                       committed=pending["written"], norm=pending["norm"])
            except Exception as e:  # noqa: BLE001 -- the ranks hear of it first
                err = e
        if not agree(err is None):
            raise err or PeerStepError("another rank's update failed: every rank retries")
        del state["pending"]
        new_opt = {k: (new["step"] if k == "step" else opt[k]) for k in opt}
        return {"model": model, "opt": new_opt}, {"loss": pending["loss"], "step": new["step"]}

    # (model, batch) -> (loss, this rank's grad shards, the whole grads' norm);
    # ``train_step.partition`` is the plan once a step has run
    train_step.grads = grads_phase
    return train_step


# ------------------------------------------------------------------ #
# serving on a mesh
# ------------------------------------------------------------------ #
def distribute_params(model, cfg: ModelConfig, mesh, rules=None):
    """The whole weights on every rank -> the same Model of DTensors placed
    by the serving layout, ``param_specs(..., for_training=False)``: tensor
    parallel over "model", and FSDP over "data" where the TP'd weights
    exceed ``rules.inference_weight_budget`` (weight-gathered serving)."""
    from repro_torch.models.convert import distribute_model

    return distribute_model(model, cfg, mesh, rules, for_training=False)


def distribute_cache(cache, cfg: ModelConfig, mesh, rules=None) -> list:
    """A decode cache made whole on every rank -> DTensors placed by
    ``cache_specs``: K/V by head over "model" where the kv heads divide
    (and ``shard_cache_heads``), else by sequence; MLA latents by sequence;
    a batch that does not divide over the dp dims puts the sequence over
    them; recurrent states by head, conv windows by channel."""
    from repro_torch.sharding.place import from_full
    from repro_torch.sharding.specs import ShardingRules, cache_specs, named

    sh = named(cache_specs(cache, cfg, mesh, rules or ShardingRules()), mesh)
    return [{n: from_full(t, *sh[i][n], copy=False) for n, t in layer.items()}
            for i, layer in enumerate(cache)]


def _placed_out(local: torch.Tensor, mesh, rows, tp_dim, vocab: bool, shape):
    """A DTensor of this rank's output block: rows placed as ``rows`` (the
    input's placements, Shard(0) kept), the last dim over the tp dim where
    ``vocab``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in rows]
    if vocab:
        pl[tp_dim] = Shard(len(shape) - 1)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(pl), run_check=False, shape=torch.Size(shape),
                              stride=stride)


def make_sharded_prefill_step(cfg: ModelConfig, mesh, rules=None):
    """``make_prefill_step`` on a mesh: weights placed by
    ``distribute_params``, the batch by ``batch_specs`` (the prompt's
    sequence over "model"). (model, batch) -> the last position's logits,
    a DTensor placed as the reference's out-sharding ``P(bdp, v_ax)``:
    this rank's rows and, where the head is vocab-parallel, its vocab
    shard (``Partition.prefill``). ``prefill_step.partition`` is the plan
    once a step has run."""
    from repro_torch.sharding.partition import Partition, dp_rows, seq_dim
    from repro_torch.sharding.specs import ShardingRules

    rules = rules or ShardingRules()

    @torch.no_grad()
    def prefill_step(model, batch):
        part = getattr(prefill_step, "partition", None)
        if part is None:
            part = prefill_step.partition = Partition(cfg, model, mesh, rules,
                                                      rows=dp_rows(batch, mesh, rules),
                                                      seq=seq_dim(batch))
        shards = {k: p.to_local() for k, p in model.named_parameters()}
        logits = part.prefill(model, shards, part.local_batch(batch))
        first = next(iter(batch.values()))
        return _placed_out(logits, mesh, first.placements, part.tp_dim,
                           part.modes["head"] == "vocab", (first.shape[0], cfg.vocab))

    return prefill_step


def make_sharded_serve_step(cfg: ModelConfig, mesh, rules=None):
    """``make_serve_step`` on a mesh: weights placed by
    ``distribute_params``, the cache by ``distribute_cache``, the tokens
    ``P(bdp, None)``. (model, cache, tokens, pos) -> (next_tok, cache):
    next_tok placed as the tokens, the cache's DTensors updated in place
    (``Partition.decode``, the vocab-sharded greedy token
    ``Partition.greedy``). ``logits=True`` also returns the logits, placed
    as the prefill step's. ``serve_step.partition`` is the plan once a
    step has run."""
    from repro_torch.sharding.partition import Partition
    from repro_torch.sharding.specs import ShardingRules

    rules = rules or ShardingRules()

    @torch.no_grad()
    def serve_step(model, cache, tokens, pos, *, logits: bool = False):
        part = getattr(serve_step, "partition", None)
        if part is None:
            part = serve_step.partition = Partition(cfg, model, mesh, rules, decode=True)
        shards = {k: p.to_local() for k, p in model.named_parameters()}
        local = part.local_cache(cache)
        held = [dict(layer) for layer in local]
        lg = part.decode(model, shards, local, tokens.to_local(), int(pos))
        for layer, before in zip(local, held):  # a recurrent block's new states
            for n, t in layer.items():
                if t is not before[n]:
                    before[n].copy_(t)
        tok = part.greedy(lg)
        next_tok = _placed_out(tok, mesh, tokens.placements, part.tp_dim, False,
                               (tokens.shape[0], 1))
        if not logits:
            return next_tok, cache
        return next_tok, cache, _placed_out(lg, mesh, tokens.placements, part.tp_dim,
                                            part.modes["head"] == "vocab",
                                            (tokens.shape[0], cfg.vocab))

    return serve_step
