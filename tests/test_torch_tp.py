"""The partitioned mesh step's tensor parallelism (``repro_torch.sharding.
partition``) on gloo ranks of the CPU, in f32, against the same modules and
the same model unsharded.

Each world (2 ranks: mesh (1, 2); 4 ranks: meshes (1, 4) and (2, 2)) is
spawned once; every rank records its errors and shapes, and the tests read
them. Tolerances: outputs and grads within 1e-5 of the largest entry of the
unsharded value (f32: the shards' sums differ from the whole's in order
only; measured under 5e-6), the whole model's grads within 1e-4 of it
(``test_torch_train.py``'s f32 bound), its loss within rtol 1e-6.

* Module by module on (1, 2) and (1, 4): qwen3-0.6b_smoke's attention (4 q
  heads, 2 kv heads: on 4 ranks one q head a rank and each kv head read by
  two, as qwen3 at 16-way) and MLP, starcoder2-15b_smoke's attention (q/k/v
  bias, 4/2 heads), deepseek-v2-lite-16b_smoke's MLA (this rank's heads,
  the latent whole) and expert banks (this rank's of 8 experts, their
  outputs gathered; the aux too), zamba2-2.7b_smoke's Mamba-2 (this
  rank's of 8 SSD heads; also with 2 B/C groups, whole on 2 ranks and
  shared by two ranks on 4), the vocab-parallel embedding and loss (tied
  and untied heads), each rank's sequence shard of the output and of the
  input's grad, and each weight's grad (the shares summed over the ranks,
  times the world: the step divides by it) against the unsharded
  module's. xlstm-1.3b_smoke's mLSTM (block 0) and sLSTM (block 5) on
  their heads (4 heads: 2 and 1 a rank), and a 2-head variant on 1 head
  a rank over 2 ranks and in heads x rows over 4 (2 row groups of 2
  ranks, the all-to-alls between them). A head count that does not
  divide (6 heads on 4 ranks) runs heads x rows (h = 2, r = 2); a
  vocabulary that does not (510 on 4 ranks) is computed whole.
* The whole model through ``make_sharded_train_step(...).grads`` on all
  three meshes against ``loss_fn`` on the whole batch: qwen3 (FSDP on,
  ``fsdp_min_elems`` 256 at these widths), the non-dividing config,
  llava-next-34b_smoke (vision), hubert-xlarge_smoke (audio; also with
  510 labels, which do not divide over 4 ranks: the head on each rank's
  positions), zamba2-2.7b_smoke and deepseek-v2-lite-16b_smoke (Mamba-2,
  MLA and the expert banks in mode "tp"), xlstm-1.3b_smoke and its 2-head
  variant (mLSTM and sLSTM in mode "tp", the variant in "rows" on (1,
  4)), qwen2-moe-a2.7b_smoke on (2, 2); the two MoE configs on (2, 1) too, and deepseek and qwen3 on (2, 2)
  with ``fsdp_only`` (4 dp groups of one row, nothing TP'd). Where there
  are several dp groups the MoE counts capacity and aux over the global
  batch, as ``loss_fn`` on the whole batch does, and drops assignments.
* On mesh (2, 1), no tensor parallelism, each of the ten smoke configs in
  bf16: ``Partition.loss`` of a rank's rows is ``loss_fn``'s bit for bit
  (the model's own blocks, embedding and cross-entropy); for the two MoE
  configs, which count over both ranks' rows, the cross-entropy of its
  rows of ``forward`` on the whole batch plus that batch's aux, bit for
  bit, with assignments dropped.
* Each rank's local parameter, grad and moment shapes after a step equal
  its slice by ``param_specs`` (qwen3, (2, 2), FSDP on).
* Collectives of one step counted by the dry-run's ``StepCounter``: the
  per-unit all-gathers and reduce-scatters (qwen3 at 4 layers less qwen3
  at 2, halved) are the plan's: forward and recompute each gather the
  unit's FSDP leaves once over "data" and the sequence twice (attention,
  MLP), and reduce-scatter the branches' partial sums (the recompute stops
  before the MLP's: nothing after it is saved for the backward); the
  backward reduce-scatters the unit's grads once over "data" and each
  column product's input grad, gathers each scattered sequence, and
  all-reduces each norm's weight grad over "model" and the unit's over
  "data". No parameter all-gather
  outputs more than one unit's (or the root group's) weights, and no grad
  reduce-scatter takes more than one unit's grads.
* Teeth: with one TP reduce-scatter skipped (the MLP's row partial sums
  kept unreduced), the MLP output is off by far more than the bound; so
  is Mamba-2's with its gated norm's sum-of-squares all-reduce skipped,
  the mLSTM's and the sLSTM's with their output norm's skipped, the
  MoE's with the expert outputs' all-gather skipped, and the 2-head
  mLSTM's in heads x rows with the inverse all-to-all skipped.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT_TOL, GRAD_REL, LOSS_RTOL = 1e-5, 1e-4, 1e-6
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
MOE = "deepseek-v2-lite-16b_smoke"
B, S = 2, 16
FSDP_ON = 256  # fsdp_min_elems at which the smoke widths' matrices are FSDP-sharded


def _cfg(name):
    from repro_torch.configs import get_config

    if name == "odd":  # a head count and a vocabulary that do not divide over 4 ranks
        return dataclasses.replace(get_config("qwen3-0.6b_smoke"), name="odd", n_heads=6,
                                   n_kv_heads=2, vocab=510)
    if name == "hubert-odd":  # per-position labels, a head that does not divide over 4
        return dataclasses.replace(get_config("hubert-xlarge_smoke"), name=name, vocab=510)
    if name == "zamba2-g2":  # two B/C groups of 4 heads: whole groups on 2 ranks, shared on 4
        return dataclasses.replace(get_config("zamba2-2.7b_smoke"), name=name, ssm_groups=2)
    if name == "xlstm-h2":  # 2 heads: a head a rank on 2 ranks, heads x rows (2 x 2) on 4
        return dataclasses.replace(get_config("xlstm-1.3b_smoke"), name=name, n_heads=2,
                                   n_kv_heads=2)
    return get_config(name)


def _rel(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max()
                 / (want.detach().float().abs().max() + 1e-30))


def _setup(cfg, mesh, rules):
    """The whole f32 model (the same on every rank), its distributed copy,
    the plan and this rank's leaves."""
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding.partition import Partition

    whole = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu").float()
    opt = adamw(1e-3)
    state = steps.distribute_state(
        {"model": Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu").float(),
         "opt": opt.init({})}, cfg, mesh, rules)
    part = Partition(cfg, state["model"], mesh, rules)
    shards = {k: p.to_local().detach().requires_grad_(True)
              for k, p in state["model"].named_parameters()}
    return whole, state, part, shards


LN = {"attn": "ln1", "ffn": "ln2", "moe": "ln2", "core": "ln"}


def _call(which: str, mod, a, pos, kw=None):
    """Branch ``which`` of block 0 -> (output, aux loss or 0)."""
    kw = kw or {}
    if which == "attn":
        return mod(a, pos, **kw), 0.0
    if which == "core":
        return mod(a, **kw)[0], 0.0
    if which == "moe":
        return mod(a, **kw)
    return mod(a, **kw), 0.0


def _branch_case(cfg, mesh, which: str, seed: int, block: int = 0) -> dict:
    """Block ``block``'s attention, MLP, MoE or recurrent core (Mamba-2,
    mLSTM, sLSTM) branch on this rank's sequence shard against the
    unsharded module: output (and MoE aux), input grad and weight grads."""
    from torch.func import functional_call

    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding.partition import gather_group
    from repro_torch.sharding.place import local_index
    from repro_torch.sharding.specs import ShardingRules

    whole, state, part, shards = _setup(cfg, mesh, ShardingRules())
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float().requires_grad_(True)
    c = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float()
    pos = torch.arange(S)
    mod = getattr(whole.blocks[block], which)
    ln = LN[which]
    hn = rms_norm(h, getattr(whole.blocks[block], ln), cfg.rms_eps)
    y, aux = _call(which, mod, hn, pos)
    ((y * c).sum() + aux).backward()
    w = gather_group(part.units[block // len(cfg.block_pattern)], shards)
    blk = f"blocks.{block}"
    pre = f"{blk}.{which}."
    sub = {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}
    dmod = getattr(state["model"].blocks[block], which)
    h_loc = part._shard(h.detach()).clone().requires_grad_(True)
    mode = part.modes[f"{blk}.{which}"]

    def fn(a, **kw):  # the branch as the block passes it: MoE (y, aux), else y
        out = _call(which, lambda *x, **k: functional_call(dmod, sub, x, k), a, pos, kw)
        return out if which == "moe" else out[0]

    out = part.split(blk, w)(which, fn, h_loc, w[f"{blk}.{ln}"], cfg.rms_eps)
    y_loc, aux_loc = out if which == "moe" else (out, 0.0)
    # each rank's share of the objective: its shard's products, 1/tp of the aux
    ((y_loc * part._shard(c)).sum() + aux_loc / part.tp).backward()
    params = dict(state["model"].named_parameters())
    grads, leaf = {}, {}
    for k, p in whole.named_parameters():
        if k.startswith(pre) or k == f"{blk}.{ln}":
            idx = local_index(params[k].shape, mesh, params[k].placements)
            grads[k] = _rel(shards[k].grad * part.world, p.grad[idx])
            # against the largest entry of the whole leaf's grad
            leaf[k] = grads[k] * float(p.grad[idx].abs().max() / (p.grad.abs().max() + 1e-30))
    return {"mode": mode, "y": _rel(y_loc, part._shard(y)), "dx": _rel(h_loc.grad, part._shard(h.grad)),
            "aux": abs(float(aux_loc) - float(aux)) / max(abs(float(aux)), 1e-30),
            "grads": grads, "grads_leaf": leaf,
            "shapes": {k: tuple(v.shape) for k, v in sub.items()}}


def _vocab_case(cfg, mesh, seed: int) -> dict:
    """The embedding of this rank's tokens and the loss of a final residual
    against the unsharded lookup and ``loss_fn``'s arithmetic."""
    from repro_torch.models.layers import dense, rms_norm
    from repro_torch.sharding.partition import gather_group
    from repro_torch.sharding.place import local_index
    from repro_torch.sharding.specs import ShardingRules

    whole, state, part, shards = _setup(cfg, mesh, ShardingRules())
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    r = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float().requires_grad_(True)
    hn = rms_norm(r, whole.final_norm, cfg.rms_eps)
    logits = hn @ whole.embed.T if cfg.tie_embeddings else dense(hn, whole.lm_head.w)
    lg = logits[:, :-1].float()
    want = (torch.logsumexp(lg, -1) - torch.gather(lg, -1, tokens[:, 1:, None])[..., 0]).mean()
    x = whole.embed[tokens]
    (want + (x * r.detach()).sum()).backward()
    w = gather_group(part.root, shards)
    tok = part._shard(tokens)
    x_loc, x0 = part.embed(w, {"tokens": tok})
    r_loc = part._shard(r.detach()).clone().requires_grad_(True)
    loss = part.ce(w, r_loc, x0, {"tokens": tok})
    # each rank's copy of the loss, and its shard of the embedding's probe
    (loss + (x_loc * part._shard(r.detach())).sum() * part.tp).backward()
    params = dict(state["model"].named_parameters())
    grads = {}
    for k, p in whole.named_parameters():
        if p.grad is not None and k in shards:
            idx = local_index(params[k].shape, mesh, params[k].placements)
            grads[k] = _rel(shards[k].grad * part.world / part.tp, p.grad[idx])
    return {"mode": (part.modes["embed"], part.modes["head"]), "x": _rel(x_loc, part._shard(x)),
            "loss": abs(float(loss) - float(want)) / abs(float(want)),
            "dr": _rel(r_loc.grad / part.tp, part._shard(r.grad)), "grads": grads}


def _local_case(cfg, mesh, seed: int) -> bool:
    """On a mesh with no tensor parallelism, ``Partition.loss`` of this
    rank's rows in bf16 against ``loss_fn`` of the same rows: bit for bit
    (the same forward, embedding and cross-entropy). A MoE counts its
    capacity and aux over the global batch (both ranks' rows, as the
    reference's step does): against the cross-entropy of this rank's rows
    of ``forward`` on the whole batch plus its aux, bit for bit, with some
    assignment dropped."""
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models.model import Model, cross_entropy, forward, loss_fn
    from repro_torch.optim import adamw
    from repro_torch.sharding.partition import Partition
    from repro_torch.sharding.specs import ShardingRules

    rules = ShardingRules(fsdp_min_elems=FSDP_ON)
    whole = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = steps.distribute_state(
        {"model": Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
         "opt": adamw(1e-3).init({})}, cfg, mesh, rules)
    part = Partition(cfg, state["model"], mesh, rules)
    shards = {k: p.to_local().detach().requires_grad_(True)
              for k, p in state["model"].named_parameters()}
    n = 4 // mesh.size(0)
    r = mesh.get_coordinate()[0]
    full = {k: torch.from_numpy(v) for k, v in _batch(cfg, np.random.default_rng(seed)).items()}
    rows = {k: v[r * n:(r + 1) * n] for k, v in full.items()}
    assert set(part.modes.values()) == {"local"}
    before = moe.DROPPED["assignments"]
    got = part.loss(state["model"], shards, rows)
    if not cfg.n_routed_experts:
        return bool(torch.equal(got, loss_fn(cfg, whole, rows)))
    logits, aux = forward(cfg, whole, full)
    want = cross_entropy(cfg, logits[r * n:(r + 1) * n], rows) + aux
    return bool(torch.equal(got, want)) and moe.DROPPED["assignments"] > before


def _batch(cfg, rng):
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((4, S, cfg.d_frontend)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (4, S)).astype(np.int32)}
    n_img = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
    out = {"tokens": rng.integers(0, cfg.vocab, (4, S - n_img)).astype(np.int32)}
    if n_img:
        out["patch_embeds"] = rng.standard_normal((4, n_img, cfg.d_frontend)).astype(np.float32)
    return out


def _model_case(cfg, mesh, rules, seed: int, count: bool = False) -> dict:
    """``make_sharded_train_step(...).grads`` against ``loss_fn`` on the
    whole batch (4 rows), in f32."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import _place
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import moe
    from repro_torch.models.model import loss_fn
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition
    from repro_torch.sharding.hints import clear_hints, hints_from_mesh
    from repro_torch.sharding.place import local_index
    from repro_torch.sharding.specs import batch_specs

    hints_from_mesh(mesh, rules)
    try:
        whole, state, _, _ = _setup(cfg, mesh, rules)
        batch_np = _batch(cfg, np.random.default_rng(seed))
        want = loss_fn(cfg, whole, {k: torch.from_numpy(v) for k, v in batch_np.items()})
        want.backward()
        specs = batch_specs(cfg, ShapeConfig("t", S, 4, "train"), mesh, rules)
        batch = _place(batch_np, mesh, specs, "cpu")
        opt = adamw(1e-3)
        state["opt"] = steps.distribute_state(
            {"model": whole, "opt": opt.init(dict(whole.named_parameters()))}, cfg, mesh,
            rules)["opt"]
        fn = steps.make_sharded_train_step(cfg, opt, mesh, agree=steps.make_agree("cpu"),
                                           rules=rules)
        gathers, scatters = [], []
        flat_g, flat_s = partition._gather_flat, partition._scatter_flat
        partition._gather_flat = lambda x, g, n: gathers.append(n * x.numel()) or flat_g(x, g, n)
        partition._scatter_flat = lambda x, g, n: scatters.append(x.numel()) or flat_s(x, g, n)
        before = moe.DROPPED["assignments"]
        try:
            if count:
                with dryrun.StepCounter() as c:
                    loss, grads, _ = fn.grads(state["model"], batch)
            else:
                loss, grads, _ = fn.grads(state["model"], batch)
        finally:
            partition._gather_flat, partition._scatter_flat = flat_g, flat_s
        params = dict(state["model"].named_parameters())
        whole_grads = dict(whole.named_parameters())
        idx = {k: local_index(params[k].shape, mesh, params[k].placements) for k in grads}
        out = {"loss": abs(float(loss) - float(want)) / abs(float(want)),
               "grads": {k: _rel(g, whole_grads[k].grad[idx[k]]) for k, g in grads.items()},
               # against the largest entry of the whole leaf's grad
               "grads_leaf": {k: float((g.float() - whole_grads[k].grad[idx[k]]).abs().max()
                                       / (whole_grads[k].grad.abs().max() + 1e-30))
                              for k, g in grads.items()},
               "modes": dict(fn.partition.modes), "groups": fn.partition.over.groups,
               "dropped": moe.DROPPED["assignments"] - before}
        if count:
            part = fn.partition
            out["counts"] = {k: c.collectives.counts.get(k, 0)
                             for k in ("all-gather", "reduce-scatter", "all-reduce")}
            out["group_elems"] = max(sum(math.prod(t) for t in _compute_shapes(part, g, state))
                                     for g in [part.root, *part.units])
            out["gathers"], out["scatters"] = gathers, scatters
            out["model_elems"] = sum(p.numel() for p in whole.parameters())
        # one update: each rank's local shapes by its specs
        _, _ = fn(state, batch)
        out["shapes"] = _shapes_ok(cfg, mesh, rules, state, grads)
        return out
    finally:
        clear_hints()


def _compute_shapes(part, group, state):
    """The shapes of a group's gathered weights (before any kv-column slice)."""
    params = dict(state["model"].named_parameters())
    for leaf in group.leaves:
        shape = list(params[leaf.name].to_local().shape)
        for i, d in leaf.gather:
            shape[d] *= part.sizes[i]
        yield tuple(shape)


def _shapes_ok(cfg, mesh, rules, state, grads) -> bool:
    from repro_torch.sharding.place import local_index
    from repro_torch.sharding.specs import named, param_specs

    want = {k: tuple(s.stop - s.start for s in local_index(p.shape, mesh, pl))
            for k, (_, pl), p in ((k, v, dict(state["model"].named_parameters())[k])
                                  for k, v in named(param_specs(state["model"], cfg, mesh, rules),
                                                    mesh).items())}
    ok = all(tuple(p.to_local().shape) == want[k] for k, p in state["model"].named_parameters())
    ok &= all(tuple(g.shape) == want[k] for k, g in grads.items())
    for k in ("m", "v", "master"):
        ok &= all(tuple(t.to_local().shape) == want[n] for n, t in state["opt"][k].items())
    return bool(ok)


def _teeth(cfg, mesh, seed: int) -> float:
    """The MLP branch with its row product's reduce-scatter skipped once:
    each rank keeps its own partial sums' shard unreduced."""
    from repro_torch.sharding import partition

    scatter = partition._scatter_dim

    def skipped(x, dim, group, n):
        partition._scatter_dim = scatter  # only this once
        s = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * s, s).contiguous()

    partition._scatter_dim = skipped
    try:
        return _branch_case(cfg, mesh, "ffn", seed)["y"]
    finally:
        partition._scatter_dim = scatter


def _teeth_norm(cfg, mesh, seed: int, block: int = 0) -> float:
    """Mamba-2's gated norm, or an mLSTM's or sLSTM's output norm, with its
    sum-of-squares all-reduce skipped: each rank normalises over its own
    channels."""
    from repro_torch.sharding import partition

    class Skipped:  # the branch's only all-reduce over "model"
        apply = staticmethod(lambda x, group: x)

    summed, partition._Sum = partition._Sum, Skipped
    try:
        return _branch_case(cfg, mesh, "core", seed, block)["y"]
    finally:
        partition._Sum = summed


def _teeth_regroup(cfg, mesh, seed: int, block: int = 0) -> float:
    """Heads x rows with the inverse all-to-all skipped: each rank keeps
    its row group's rows of its sequence chunk where its own rows' shard
    belongs."""
    from repro_torch.sharding import partition

    regroup = partition._regroup

    def skipped(x, group, r, to_rows):
        if to_rows:
            return regroup(x, group, r, to_rows)
        b, rs = x.shape[:2]
        return x.reshape(b, r, rs // r, *x.shape[2:]).reshape(b * r, rs // r, *x.shape[2:])

    partition._regroup = skipped
    try:
        return _branch_case(cfg, mesh, "core", seed, block)["y"]
    finally:
        partition._regroup = regroup


def _teeth_experts(cfg, mesh, seed: int) -> float:
    """The expert banks with their outputs' all-gather skipped: the other
    ranks' experts read zeros."""
    from repro_torch.sharding.partition import _TensorParallel

    gather = _TensorParallel.experts
    _TensorParallel.experts = lambda self, out: torch.cat(
        [out if r == self.rank else torch.zeros_like(out) for r in range(self.n)])
    try:
        return _branch_case(cfg, mesh, "moe", seed)["y"]
    finally:
        _TensorParallel.experts = gather


def _rows_fit(mesh) -> dict:
    """The modes of the 6-head config's attention on 4 ranks (h = 2, r = 2)
    and of a 3-head one (h = 1) for dp groups of 1, 2 and any rows."""
    from repro_torch.models.model import Model
    from repro_torch.sharding.partition import Partition
    from repro_torch.sharding.specs import ShardingRules

    out = {}
    for name, cfg in (("odd", _cfg("odd")),
                      ("3 heads", dataclasses.replace(_cfg("odd"), n_heads=3, n_kv_heads=1))):
        model = _setup(cfg, mesh, ShardingRules())[1]["model"]
        for rows in (1, 2, None):
            out[(name, rows)] = Partition(cfg, model, mesh, ShardingRules(), rows=rows).modes[
                "blocks.0.attn"]
    return out


def _worker(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg{world}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.specs import ShardingRules

    res = {}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        m = "x".join(map(str, shape))
        if shape[0] == 1:
            for arch in ("qwen3-0.6b_smoke", "starcoder2-15b_smoke", "odd"):
                res[("attn", arch, m)] = _branch_case(_cfg(arch), mesh, "attn", 1)
            res[("ffn", "qwen3-0.6b_smoke", m)] = _branch_case(_cfg("qwen3-0.6b_smoke"), mesh,
                                                              "ffn", 2)
            for arch in ("qwen3-0.6b_smoke", "starcoder2-15b_smoke", "odd"):
                res[("vocab", arch, m)] = _vocab_case(_cfg(arch), mesh, 3)
            res[("teeth", m)] = _teeth(_cfg("qwen3-0.6b_smoke"), mesh, 2)
            # MLA, the expert banks, Mamba-2 (one B/C group, and two)
            res[("attn", MOE, m)] = _branch_case(_cfg(MOE), mesh, "attn", 1)
            res[("moe", MOE, m)] = _branch_case(_cfg(MOE), mesh, "moe", 6)
            for arch in ("zamba2-2.7b_smoke", "zamba2-g2"):
                res[("core", arch, m)] = _branch_case(_cfg(arch), mesh, "core", 7)
            res[("teeth-norm", m)] = _teeth_norm(_cfg("zamba2-2.7b_smoke"), mesh, 7)
            res[("teeth-experts", m)] = _teeth_experts(_cfg(MOE), mesh, 6)
            # mLSTM (block 0) and sLSTM (block 5) on their heads, or heads x rows
            for arch in ("xlstm-1.3b_smoke", "xlstm-h2"):
                for which, blk in XLSTM:
                    res[(which, arch, m)] = _branch_case(_cfg(arch), mesh, "core", 8, blk)
            for which, blk in XLSTM:
                res[(f"teeth-{which}-norm", m)] = _teeth_norm(_cfg("xlstm-1.3b_smoke"), mesh,
                                                              8, blk)
            if shape == (1, 4):
                res[("teeth-regroup", m)] = _teeth_regroup(_cfg("xlstm-h2"), mesh, 8)
                res[("rows-fit", m)] = _rows_fit(mesh)
        fsdp = ShardingRules(fsdp_min_elems=FSDP_ON)
        archs = ["qwen3-0.6b_smoke", "odd", "llava-next-34b_smoke", "hubert-xlarge_smoke",
                 "hubert-odd", "zamba2-2.7b_smoke", MOE, "xlstm-1.3b_smoke", "xlstm-h2"] + (
                     ["qwen2-moe-a2.7b_smoke"] if shape == (2, 2) else [])
        for arch in archs:
            res[("model", arch, m)] = _model_case(_cfg(arch), mesh, fsdp, 4,
                                                  count=arch == "qwen3-0.6b_smoke")
        if shape == (2, 2):  # the per-unit counts: 4 layers less 2
            deep = dataclasses.replace(_cfg("qwen3-0.6b_smoke"), n_layers=4)
            res[("model", "qwen3-4layers", m)] = _model_case(deep, mesh, fsdp, 4, count=True)
            # "model" joins the dp dims: 4 dp groups of one row, nothing TP'd
            only = ShardingRules(fsdp_only=True, fsdp_min_elems=FSDP_ON)
            for arch in ("qwen3-0.6b_smoke", MOE):
                res[("model", arch, "2x2-fsdp_only")] = _model_case(_cfg(arch), mesh, only, 4)
    if world == 2:  # no tensor parallelism: the model's own arithmetic
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        for arch in LOCAL:
            res[("local", arch)] = _local_case(_cfg(arch), mesh, 5)
        for arch in (MOE, "qwen2-moe-a2.7b_smoke"):  # two dp groups, one global batch
            res[("model", arch, "2x1")] = _model_case(_cfg(arch), mesh,
                                                      ShardingRules(fsdp_min_elems=FSDP_ON), 4)
    torch.save(res, d / f"{world}_{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    out = {}
    for world in MESHES:
        mp.spawn(_worker, args=(world, d), nprocs=world)
        for rank in range(world):
            for k, v in torch.load(d / f"{world}_{rank}.pt", weights_only=False).items():
                out[(*k, rank)] = v
    return out


XLSTM = (("mlstm", 0), ("slstm", 5))  # the branch, its block in xlstm's unit
LOCAL = [f"{a}_smoke" for a in ("qwen3-0.6b", "codeqwen1.5-7b", "starcoder2-15b", "qwen1.5-110b",
                                 "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                                 "xlstm-1.3b", "hubert-xlarge", "llava-next-34b")]


def _ranks(m):
    return range(int(np.prod([int(x) for x in m.split("-")[0].split("x")])))


BRANCH = [(w, a, m, r) for w, a in (("attn", "qwen3-0.6b_smoke"), ("attn", "starcoder2-15b_smoke"),
                                    ("attn", "odd"), ("ffn", "qwen3-0.6b_smoke"), ("attn", MOE),
                                    ("moe", MOE), ("core", "zamba2-2.7b_smoke"),
                                    ("core", "zamba2-g2"))
          for m in ("1x2", "1x4") for r in _ranks(m)]


@pytest.mark.parametrize("which,arch,mesh,rank", BRANCH)
def test_tp_branch_matches_the_unsharded_module(results, which, arch, mesh, rank):
    r = results[(which, arch, mesh, rank)]
    rows = arch == "odd" and mesh == "1x4"  # 6 heads on 4 ranks: 2 row groups of 2 ranks
    assert r["mode"] == ("rows" if rows else "tp")
    assert r["y"] <= OUT_TOL and r["dx"] <= OUT_TOL and r["aux"] <= LOSS_RTOL, (r["y"], r["dx"],
                                                                                r["aux"])
    bad = {k: v for k, v in r["grads"].items() if v > OUT_TOL}
    assert not bad and r["grads"], bad
    tp = int(mesh.split("x")[1])
    cfg = _cfg(arch)
    if which == "attn" and not cfg.use_mla:  # its q heads, the kv heads they read
        hd = cfg.head_dim
        tp = 2 if rows else tp  # a row group's ranks
        hq = cfg.n_heads // tp
        assert r["shapes"]["wq.w"] == (cfg.d_model, hq * hd) and r["shapes"]["wo.w"] == (hq * hd,
                                                                                        cfg.d_model)
        assert r["shapes"]["wk.w"] == (cfg.d_model, max(1, cfg.n_kv_heads // tp) * hd)
    if which == "attn" and cfg.use_mla:  # this rank's heads; the latent's projection whole
        h = cfg.n_heads // tp
        assert r["shapes"]["wq.w"] == (cfg.d_model, h * (cfg.nope_head_dim + cfg.rope_head_dim))
        assert r["shapes"]["kv_up.w"] == (cfg.kv_lora_rank,
                                          h * (cfg.nope_head_dim + cfg.v_head_dim))
        assert r["shapes"]["kv_down.w"] == (cfg.d_model, cfg.kv_lora_rank + cfg.rope_head_dim)
    if which == "moe":  # this rank's experts
        assert r["shapes"]["w_gate"][0] == cfg.n_routed_experts // tp
    if which == "core":  # this rank's heads and channels, the groups they read
        nh, di, n, g = cfg.n_ssm_heads // tp, cfg.d_inner // tp, cfg.ssm_state, cfg.ssm_groups
        assert r["shapes"]["in_dt.w"] == (cfg.d_model, nh) and r["shapes"]["gate_norm"] == (di,)
        assert r["shapes"]["in_x.w"] == (cfg.d_model, di) and r["shapes"]["out_proj.w"][0] == di
        assert r["shapes"]["in_B.w"] == (cfg.d_model, max(1, g // tp) * n)


XLSTM_BRANCH = [(w, a, m, r) for w, _ in XLSTM for a in ("xlstm-1.3b_smoke", "xlstm-h2")
                for m in ("1x2", "1x4") for r in _ranks(m)]


@pytest.mark.parametrize("which,arch,mesh,rank", XLSTM_BRANCH)
def test_xlstm_branch_matches_the_unsharded_module(results, which, arch, mesh, rank):
    """mLSTM and sLSTM on this rank's heads (4 heads on 2 and 4 ranks, 2 on
    2), or heads x rows (2 heads on 4 ranks: 2 row groups of 2): output,
    input grad and every weight's grad within 1e-5 of the largest entry of
    the unsharded value (a grad: of the whole leaf's, since a rank's slice
    of ``w_i.b``/``w_f.b`` can be one entry, a sum over every position that
    cancels to 0.37 beside the leaf's 3-18); the local shapes are the
    heads'."""
    r = results[(which, arch, mesh, rank)]
    cfg = _cfg(arch)
    n = int(mesh.split("x")[1])
    h = math.gcd(n, cfg.n_heads)
    assert r["mode"] == ("tp" if h == n else "rows")
    assert r["y"] <= OUT_TOL and r["dx"] <= OUT_TOL, (r["y"], r["dx"])
    bad = {k: v for k, v in r["grads_leaf"].items() if v > OUT_TOL}
    assert not bad and len(r["grads_leaf"]) >= 7, bad
    d, di, nh, sh = cfg.d_model, cfg.d_inner, cfg.n_heads, r["shapes"]
    if which == "mlstm":
        assert sh["up.w"] == (d, 2 * di // h) and sh["wq.w"] == (di, di // h)
        assert sh["w_i.w"] == (d, nh // h) and sh["down.w"] == (di // h, d)
        assert sh["out_norm"] == (di // h,) and sh["conv_w"][1] == di
    else:
        hd, ffw = d // nh, cfg.d_model  # the smoke FFN: round(4 d / 3 / 64) * 64 = d
        assert sh["wx.w"] == (d, 4 * d // h) and sh["r"] == (4, nh // h, hd, hd)
        assert sh["ffn_up.w"] == (d, ffw // h) and sh["ffn_down.w"] == (ffw // h, d)


VOCAB = [(a, m, r) for a in ("qwen3-0.6b_smoke", "starcoder2-15b_smoke", "odd")
         for m in ("1x2", "1x4") for r in _ranks(m)]


@pytest.mark.parametrize("arch,mesh,rank", VOCAB)
def test_vocab_parallel_embedding_and_loss(results, arch, mesh, rank):
    r = results[("vocab", arch, mesh, rank)]
    whole = arch == "odd" and mesh == "1x4"  # vocab 510 on 4 ranks: whole
    assert r["mode"] == (("whole", "whole") if whole else ("vocab", "vocab"))
    assert r["x"] <= OUT_TOL and r["loss"] <= LOSS_RTOL and r["dr"] <= OUT_TOL, r
    bad = {k: v for k, v in r["grads"].items() if v > OUT_TOL}
    assert not bad and r["grads"], bad


MODEL = [(a, m, r) for m in ("1x2", "1x4", "2x2")
         for a in ("qwen3-0.6b_smoke", "odd", "llava-next-34b_smoke", "hubert-xlarge_smoke",
                   "hubert-odd", "zamba2-2.7b_smoke", MOE, "xlstm-1.3b_smoke", "xlstm-h2")
         + (("qwen2-moe-a2.7b_smoke",) if m == "2x2" else ())
         for r in _ranks(m)]
MODEL += [(a, "2x1", r) for a in (MOE, "qwen2-moe-a2.7b_smoke") for r in range(2)]
MODEL += [(a, "2x2-fsdp_only", r) for a in ("qwen3-0.6b_smoke", MOE) for r in range(4)]


@pytest.mark.parametrize("arch,mesh,rank", MODEL)
def test_partitioned_model_matches_loss_fn(results, arch, mesh, rank):
    """Loss and grads against ``loss_fn``: a rank's slice of each grad
    within 1e-4 of the slice's largest entry; xLSTM's of the whole leaf's,
    as ``test_torch_train.py`` holds them, since the i gate's slice of
    ``wx.b`` (its grad ~1e-5 of the leaf's: the stabiliser takes the
    input gate's step) and a one-entry slice of ``w_f.b`` are sums that
    cancel."""
    r = results[("model", arch, mesh, rank)]
    assert r["loss"] <= LOSS_RTOL, r["loss"]
    grads = r["grads_leaf"] if arch.startswith("xlstm") else r["grads"]
    bad = {k: v for k, v in grads.items() if v > GRAD_REL}
    assert not bad and len(r["grads"]) > 10, bad
    assert r["shapes"]  # parameters, grads and moments: this rank's slices by param_specs
    modes = r["modes"]
    if mesh == "2x2-fsdp_only":  # nothing TP'd; four dp groups
        assert set(modes.values()) == {"local"} and r["groups"] == 4
    elif arch == "qwen3-0.6b_smoke":
        assert set(modes.values()) == {"tp", "vocab"}
    if mesh in ("1x2", "1x4", "2x2") and arch in ("zamba2-2.7b_smoke", MOE,
                                                  "qwen2-moe-a2.7b_smoke"):
        # Mamba-2, MLA and the expert banks on this rank's heads and experts
        assert all(v == "tp" for k, v in modes.items()
                   if k.endswith((".core", ".attn", ".moe", ".ffn"))), modes
    if arch.startswith("xlstm") and "fsdp" not in mesh:
        # every mLSTM and sLSTM on its heads; heads x rows for 2 heads on 4 ranks
        want = "rows" if (arch, mesh) == ("xlstm-h2", "1x4") else "tp"
        assert {v for k, v in modes.items() if k.endswith(".core")} == {want}, modes
    if arch == "odd":  # 6 heads: on their ranks over 2, heads x rows (2 x 2) over 4
        want = "rows" if mesh == "1x4" else "tp"
        assert {v for k, v in modes.items() if k.endswith(".attn")} == {want}, modes
    if _cfg(arch).n_routed_experts and mesh != "1x2" and mesh != "1x4":
        # capacity over the global batch of the dp groups, and it binds
        assert r["groups"] == int(mesh[0]) * (2 if "fsdp" in mesh else 1) and r["dropped"] > 0


@pytest.mark.parametrize("arch,rank", [(a, r) for a in LOCAL for r in range(2)])
def test_partition_without_tp_is_loss_fn_bit_for_bit(results, arch, rank):
    assert results[("local", arch, rank)]


@pytest.mark.parametrize("rank", range(4))
def test_collectives_per_unit(results, rank):
    two = results[("model", "qwen3-0.6b_smoke", "2x2", rank)]
    four = results[("model", "qwen3-4layers", "2x2", rank)]
    per_unit = {k: (four["counts"][k] - two["counts"][k]) / 2 for k in two["counts"]}
    # forward: 1 FSDP gather, 2 sequence gathers, 2 partial-sum scatters;
    # the recompute the same, but for the MLP's scatter (it stops after the
    # last tensor the backward saves); backward: 1 grad scatter over "data",
    # one scatter of each column product's input grad (q, k, v; gate, up),
    # 2 gathers; all-reduces: the replicated norms' grads over "data" (one
    # for the unit) and each of the four norms' (ln1, ln2, q_norm, k_norm)
    # over "model"
    assert per_unit == {"all-gather": 3 + 3 + 2, "reduce-scatter": 2 + 1 + 1 + 3 + 2,
                        "all-reduce": 1 + 4}, per_unit
    for r in (two, four):
        # no gather of more than one group's weights, no grad buffer of more than one group's
        assert max(r["gathers"]) <= r["group_elems"] < r["model_elems"] / 2
        assert max(r["scatters"]) <= r["group_elems"]


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_skipping_a_tp_reduce_scatter_fails_the_check(results, mesh):
    for rank in _ranks(mesh):
        assert results[("teeth", mesh, rank)] > 100 * OUT_TOL


@pytest.mark.parametrize("which", ["teeth-norm", "teeth-experts", "teeth-mlstm-norm",
                                   "teeth-slstm-norm"])
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_skipping_a_new_collective_fails_the_check(results, which, mesh):
    """The gated norm's, the mLSTM's or the sLSTM's output norm's sum of
    squares not summed over "model", or the expert outputs not gathered:
    the branch's output is off by far more than the bound."""
    for rank in _ranks(mesh):
        assert results[(which, mesh, rank)] > 100 * OUT_TOL


@pytest.mark.parametrize("rank", range(4))
def test_heads_x_rows_only_where_the_rows_divide(results, rank):
    """6 heads on 4 ranks: 2 row groups of 2 where the dp group's rows
    divide by 2 (or are not known), else whole; 3 heads (h = 1): whole."""
    fit = results[("rows-fit", "1x4", rank)]
    assert fit == {("odd", 1): "whole", ("odd", 2): "rows", ("odd", None): "rows",
                   ("3 heads", 1): "whole", ("3 heads", 2): "whole", ("3 heads", None): "whole"}


@pytest.mark.parametrize("rank", range(4))
def test_skipping_the_inverse_regroup_fails_the_check(results, rank):
    """Heads x rows (2 x 2 on 4 ranks) with the inverse all-to-all skipped:
    each rank keeps another row group's rows in place of its own shard."""
    assert results[("teeth-regroup", "1x4", rank)] > 100 * OUT_TOL
