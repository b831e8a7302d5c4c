"""input_specs(): shape-only stand-ins for every input of every (arch x
shape) cell (port of ``repro/launch/specs.py``): tensors on the ``meta``
device, which have a shape and a dtype and no storage, so a 110 B model
costs nothing. The reference's ``ShapeDtypeStruct`` trees are the port's
own: the ``Model``'s parameters, the ``{"model", "opt"}`` training state of
``launch/steps.py`` and the list-of-dicts decode cache of ``models/model.py``
(``models/convert.py`` maps them onto the reference's leaf paths).

Also assembles the dry-run cell, ``(fn, args, in_placements,
out_placements)``: ``fn`` is the step the port runs, the placements are
``(mesh, DTensor placements)`` from ``sharding/specs.py`` through ``named``.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.models import init_cache
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import adamw
from repro_torch.sharding.hints import hints_from_mesh
from repro_torch.sharding.specs import (
    P,
    ShardingRules,
    _axis_sizes,
    batch_specs,
    cache_specs,
    dp_axes,
    named,
    param_specs,
    state_specs,
)

META = "meta"

#: what each kind of cell's artifact describes: the port's step as it runs
#: (a key with "/fsdp_only" under ``ShardingRules(fsdp_only=True)``)
COMPUTE = {
    "train": "FSDP per unit over the dp dims; tensor and sequence parallel over model for "
             "attention, MLA, Mamba-2, mLSTM, sLSTM, the MLP, the expert banks and the "
             "vocabulary; other blocks whole over model; the MoE over the global batch",
    "prefill": "the inference layout (param_specs for_training=False): tensor and sequence "
               "parallel over model on the prompt's sequence shards, units gathered over data "
               "where the TP'd weights pass the budget; the last position's logits "
               "vocab-sharded",
    "decode": "the inference layout: tensor parallel over model on this rank's rows (one "
              "token), row products all-reduced; the cache by cache_specs (kv heads or the "
              "sequence over model, the sequence over the dp axes for a batch of one; the "
              "mLSTM and sLSTM states by head, or along dk where the heads do not divide, "
              "their partial sums all-reduced), sequence shards merged by log-sum-exp; the "
              "greedy token vocab-sharded",
    "train/fsdp_only": "FSDP (ZeRO-3) per unit over every mesh dim, no tensor parallelism; "
                       "where the rows do not divide over the whole pool, the sequence over "
                       "model: attention and MLA context parallel (keys and values gathered "
                       "over model, this rank's queries), the MLP and the MoE per token on the "
                       "shard (the MoE over the global batch's row runs), other blocks whole "
                       "over model",
    "prefill/fsdp_only": "weights FSDP over every mesh dim, gathered per unit; the prompt's "
                         "sequence over model where its rows do not divide over the pool: "
                         "attention and MLA context parallel, the rest as in train; the last "
                         "position's logits whole",
    "decode/fsdp_only": "weights FSDP over every mesh dim, gathered per unit; each rank's rows "
                        "(every row where the batch does not divide over the pool) at full "
                        "width; the cache's sequence over the dp axes, its shards' partials "
                        "merged by log-sum-exp",
}


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _cfg(arch: Union[str, ModelConfig]) -> ModelConfig:
    return get_config(arch) if isinstance(arch, str) else arch


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Stand-ins for one global batch of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _sds((B, 1), torch.int32)}
    if cfg.frontend == "audio_stub":
        return {
            "frames": _sds((B, S, cfg.d_frontend), torch.bfloat16),
            "labels": _sds((B, S), torch.int32),
        }
    if cfg.frontend == "vision_stub":
        n_img = cfg.n_frontend_tokens
        return {
            "tokens": _sds((B, S - n_img), torch.int32),
            "patch_embeds": _sds((B, n_img, cfg.d_frontend), torch.bfloat16),
        }
    return {"tokens": _sds((B, S), torch.int32)}


def params_struct(cfg: ModelConfig) -> Model:
    return Model(cfg, generator=None, device=META)


def state_struct(cfg: ModelConfig, optimizer=None) -> Dict:
    optimizer = optimizer or adamw(1e-4)
    return steps_mod.make_init_state(cfg, optimizer, META)(None)


def cache_struct(cfg: ModelConfig, shape: ShapeConfig) -> list:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def input_specs(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
                optimizer=None) -> Dict:
    """All inputs of the cell's step function, as stand-ins."""
    cfg = _cfg(arch)
    shape = _shape(shape_name)
    if shape.kind == "decode":
        return {
            "params": params_struct(cfg),
            "cache": cache_struct(cfg, shape),
            "tokens": _sds((shape.global_batch, 1), torch.int32),
            "pos": _sds((), torch.int32),
        }
    if shape.kind == "prefill":
        return {"params": params_struct(cfg), "batch": batch_struct(cfg, shape)}
    return {"state": state_struct(cfg, optimizer), "batch": batch_struct(cfg, shape)}


# --------------------------------------------------------------------- #
# the dry-run cell
# --------------------------------------------------------------------- #
def _replicated(mesh):
    return named(P(), mesh)


def _placed(tree, sh):
    """Whole stand-ins -> DTensors of this rank's slices, by ``(mesh,
    placements)``; a Model's parameters are placed by name."""
    from repro_torch.sharding.place import from_full

    if isinstance(tree, torch.Tensor):
        return from_full(tree, *sh, copy=False)
    if isinstance(tree, dict):
        return {k: _placed(v, sh[k]) for k, v in tree.items()}
    return [_placed(v, s) for v, s in zip(tree, sh)]


def row_dp(shape: ShapeConfig, mesh, rules: ShardingRules):
    """The dp axes that split the batch rows, or None where the batch does
    not divide over them (batch-1 long-context cells: replicated, as the
    reference's divisibility guard does)."""
    sizes = _axis_sizes(mesh)
    dp = dp_axes(mesh, rules)
    dp_total = math.prod(sizes.get(a, 1) for a in dp)
    return dp if (dp and shape.global_batch % dp_total == 0) else None


def reference_layout(arch, shape_name, mesh, args, rules: ShardingRules = ShardingRules()):
    """The reference's in-shardings of the cell's arguments, as ``(mesh,
    placements)``: what its ``build_cell`` gives ``jax.jit`` and what
    ``dryrun.analytic_memory`` divides by. They are the port's own: the
    train layout (``state_specs``, ``batch_specs``), and for serving the
    inference layout (``param_specs(for_training=False)``, ``batch_specs``,
    ``cache_specs``), on which the port partitions prefill and decode."""
    cfg = _cfg(arch)
    shape = _shape(shape_name)
    if shape.kind == "train":
        state, _ = args
        return (named(state_specs(state, cfg, mesh, rules), mesh),
                named(batch_specs(cfg, shape, mesh, rules), mesh))
    model = args[0]
    p_sh = named(param_specs(model, cfg, mesh, rules, for_training=False), mesh)
    if shape.kind == "prefill":
        return (p_sh, named(batch_specs(cfg, shape, mesh, rules), mesh))
    bdp = row_dp(shape, mesh, rules)
    return (p_sh, named(cache_specs(args[1], cfg, mesh, rules), mesh),
            named(P(bdp, None), mesh), _replicated(mesh))


def build_cell(
    arch: Union[str, ModelConfig],
    shape_name: Union[str, ShapeConfig],
    mesh,
    rules: ShardingRules = ShardingRules(),
    *,
    remat: bool = True,
    cfg: ModelConfig | None = None,
    microbatches: int = 1,
):
    """Returns ``(fn, args, in_placements, out_placements)``: ``fn(*args)``
    runs one step of the cell as the port runs it, on this rank, with
    shape-only stand-ins (``meta`` tensors; DTensors of them where placed).
    Every cell is partitioned (``sharding/partition.py``):

    - train: ``make_sharded_train_step`` on the state ``distribute_state``
      places by ``state_specs`` and the batch placed by ``batch_specs``;
      the ranks' agreement is taken as given (a shape-only flag has no
      value).
    - prefill: ``make_sharded_prefill_step`` on the weights
      ``distribute_params`` places by ``param_specs(for_training=False)``
      and the batch placed by ``batch_specs`` (the prompt's sequence over
      "model"); out-sharding ``P(bdp, v_ax)``.
    - decode: ``make_sharded_serve_step`` on the same weights, the cache
      placed by ``cache_specs`` and the tokens ``P(bdp, None)``, at the
      last position of the cache (``pos = seq_len - 1``).

    ``fn.compute`` keys ``COMPUTE``: the kind, with "/fsdp_only" under
    ``rules.fsdp_only``. ``cfg`` overrides the registry config;
    ``microbatches`` enables gradient accumulation for train cells. Like
    the reference's, a cell installs the mesh's activation hints
    (``hints_from_mesh``)."""
    cfg = cfg or _cfg(arch)
    shape = _shape(shape_name)
    optimizer = adamw(1e-4)
    hints_from_mesh(mesh, rules)
    compute = shape.kind + ("/fsdp_only" if rules.fsdp_only else "")
    if shape.kind == "train":
        fn = steps_mod.make_sharded_train_step(
            cfg, optimizer, mesh, agree=lambda ok: ok, rules=rules, remat=remat,
            microbatches=microbatches, remat_policy=rules.remat_policy,
        )
        fn.compute = compute
        whole = state_struct(cfg, optimizer)
        st_sh = named(state_specs(whole, cfg, mesh, rules), mesh)
        b_sh = named(batch_specs(cfg, shape, mesh, rules), mesh)
        state = steps_mod.distribute_state(whole, cfg, mesh, rules)
        batch = _placed(batch_struct(cfg, shape), b_sh)
        rep = _replicated(mesh)
        return fn, (state, batch), (st_sh, b_sh), (st_sh, {"loss": rep, "step": rep})
    bdp = row_dp(shape, mesh, rules)
    model = steps_mod.distribute_params(params_struct(cfg), cfg, mesh, rules)
    p_sh = named(param_specs(model, cfg, mesh, rules, for_training=False), mesh)
    tp = None if rules.fsdp_only else rules.tp_axis
    v_ax = tp if tp and cfg.vocab % _axis_sizes(mesh).get(tp, 1) == 0 else None
    if shape.kind == "prefill":
        b_sh = named(batch_specs(cfg, shape, mesh, rules), mesh)
        batch = _placed(batch_struct(cfg, shape), b_sh)
        fn = steps_mod.make_sharded_prefill_step(cfg, mesh, rules)
        fn.compute = compute
        return fn, (model, batch), (p_sh, b_sh), named(P(bdp, v_ax), mesh)
    fn = steps_mod.make_sharded_serve_step(cfg, mesh, rules)
    fn.compute = compute
    cache = steps_mod.distribute_cache(cache_struct(cfg, shape), cfg, mesh, rules)
    c_sh = [{n: (mesh, tuple(t.placements)) for n, t in layer.items()} for layer in cache]
    tok_sh = named(P(bdp, None), mesh)
    tokens = _placed(_sds((shape.global_batch, 1), torch.int32), tok_sh)
    args = (model, cache, tokens, shape.seq_len - 1)
    return fn, args, (p_sh, c_sh, tok_sh, _replicated(mesh)), (tok_sh, c_sh)
