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
    remat: bool = True,
    microbatches: int = 1,
    remat_policy: str = "full",
    update_hook: Optional[Callable[[int], None]] = None,
):
    """``make_train_step`` on a mesh, for a state of DTensors placed by
    ``state_specs`` and batches placed by ``batch_specs``.

    Between steps every rank holds only its slices of the parameters,
    moments and master weights. Compute is data parallel over the mesh
    dims that split the batch: a step gathers the parameters whole into a
    plain compute model (an all-gather per sharded leaf),
    gathers the batch's sequence shards and computes this dp rank's loss
    and grads. The ranks of a tp group compute the same ones, but for an
    expert-parallel MoE layer (``models/moe_ep.py``), which splits its
    tokens over them. The grads are reduced straight to this rank's slices
    in f32 (a reduce-scatter over each dp mesh dim that shards a leaf, an
    all-reduce over one that replicates it, this rank's part along the
    others), averaged and rounded back to the grads' dtype; then the
    gathered weights and the whole grads are dropped. The clip norm is the
    whole grads', summed from the slices. Each rank updates its own slice
    of every parameter, moment and master weight: no collective. Where a
    mesh dim has one rank its collectives are skipped (they are the
    identity), so at world size 1 a step is the unmeshed one bit for bit.

    The retry contract of ``make_train_step`` holds, and the ranks agree
    (``agree``) once the update is written, before it commits: a rank whose
    update failed, or whose peer's did, raises and keeps its
    ``state["pending"]``, and every rank's retry finishes the update."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.model import Model
    from repro_torch.runtime import PeerStepError
    from repro_torch.sharding.place import full_value, is_sharded

    grads_of = make_grads_fn(cfg, remat=remat, microbatches=microbatches,
                             remat_policy=remat_policy)
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    coord = mesh.get_coordinate()
    work: Dict = {}

    def compute_model(model):
        """The plain model of the step, with the parameters whole: a sharded
        leaf gathered, an unsharded one (every leaf at world size 1) its
        DTensor's local tensor itself. The module is made on the first call
        (a few hundred ms for qwen3-0.6b) and kept; its tensors are this
        step's (see ``release``)."""
        with torch.no_grad():
            if "model" not in work:
                w = Model(cfg, generator=None, device="meta")
                w.load_state_dict({n: full_value(p) for n, p in model.named_parameters()},
                                  strict=True, assign=True)
                work["model"] = w
                return w
            w = work["model"]
            for dst, src in zip(w.parameters(), model.parameters()):
                dst.data = full_value(src)  # the same storage where src is unsharded
        return w

    def release(w, model):
        """Drop the step's grads and gathered weights from the kept module:
        between steps a rank holds only its slices."""
        for dst, src in zip(w.parameters(), model.parameters()):
            dst.grad = None
            if is_sharded(src):
                dst.data = torch.empty(0, dtype=dst.dtype, device=dst.device)

    def local_batch(batch):
        """This dp rank's rows, whole sequences; the mesh dims that split them."""
        out, dp_dims = {}, None
        for k, v in batch.items():
            # keep the rows' split, gather the rest (where a dim has > 1 rank)
            layout = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                      for pl in v.placements]
            gather = any(isinstance(pl, Shard) and pl.dim != 0 and mesh.size(i) > 1
                         for i, pl in enumerate(v.placements))
            out[k] = (v.redistribute(mesh, layout) if gather else v).to_local()
            dims = tuple(i for i, pl in enumerate(layout)
                         if isinstance(pl, Shard) and mesh.size(i) > 1)
            if dp_dims is not None and dims != dp_dims:
                raise ValueError(f"batch key {k}: rows split over mesh dims {dims}, "
                                 f"the others' over {dp_dims}")
            dp_dims = dims
        return out, dp_dims or ()

    def to_slices(grads, layouts, dp_dims):
        """Whole grads of this dp rank -> this rank's slices of their dp
        mean. Mesh dims are taken in order (DTensor's order of splits):
        on a dp dim, one all-reduce of the leaves it replicates and one
        reduce-scatter of those it shards, each through one f32 buffer;
        on another dim, this rank's chunk of the leaves it shards."""
        x = dict(grads)
        for i in range(mesh.ndim):
            n = mesh.size(i)
            if n == 1:
                continue
            split = {k: pl[i].dim for k, pl in layouts.items() if isinstance(pl[i], Shard)}
            if i not in dp_dims:
                x.update({k: x[k].chunk(n, dim=d)[coord[i]].clone() for k, d in split.items()})
                continue
            group = mesh.get_group(i)
            rest = [k for k in x if k not in split]
            if rest:
                shapes = [x[k].shape for k in rest]
                flat = torch.cat([x[k].float().reshape(-1) for k in rest])
                dist.all_reduce(flat, group=group)
                parts = flat.split([math.prod(sh) for sh in shapes])
                x.update({k: v.view(sh) for k, v, sh in zip(rest, parts, shapes)})
            if split:  # each leaf's rank chunks side by side: (n, sum of chunk sizes)
                moved = [x[k].float().movedim(d, 0) for k, d in split.items()]
                flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1)
                out = flat.new_empty(flat.shape[1])
                reduce_scatter(out, flat.reshape(-1), group=group)
                parts = out.split([m.numel() // n for m in moved])
                for (k, d), m, v in zip(split.items(), moved, parts):
                    x[k] = v.view((m.shape[0] // n,) + tuple(m.shape[1:])).movedim(0, d)
        n_dp = math.prod(mesh.size(i) for i in dp_dims)
        return {k: (v / n_dp if n_dp > 1 else v).to(grads[k].dtype).contiguous()
                for k, v in x.items()}

    def grads_phase(model, batch):
        local, dp_dims = local_batch(batch)
        w = compute_model(model)
        loss, grads = grads_of(w, local)
        release(w, model)
        if dp_dims:
            flat = loss.float().reshape(1)
            for i in dp_dims:
                dist.all_reduce(flat, group=mesh.get_group(i))
            loss = flat[0] / math.prod(mesh.size(i) for i in dp_dims)
        layouts = {k: tuple(p.placements) for k, p in model.named_parameters()}
        shards = to_slices(grads, layouts, dp_dims)
        del grads
        # the whole grads' norm: each slice's squares over the ranks that hold it
        reps = {k: mesh.size() // math.prod(mesh.size(i) for i, pl in enumerate(layouts[k])
                                             if isinstance(pl, Shard)) for k in shards}
        sq = sum(torch.sum(torch.square(g.float())) / reps[k] for k, g in shards.items())
        if mesh.size() > 1:
            sq = sq.reshape(1)
            for i in range(mesh.ndim):
                if mesh.size(i) > 1:
                    dist.all_reduce(sq, group=mesh.get_group(i))
            sq = sq[0]
        return loss, shards, torch.sqrt(sq)

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

    # (model, batch) -> (loss, this rank's grad shards, the whole grads' norm)
    train_step.grads = grads_phase
    return train_step

