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
  bias, 4/2 heads), the vocab-parallel embedding and loss (tied and untied
  heads), each rank's sequence shard of the output and of the input's grad,
  and each weight's grad (the shares summed over the ranks, times the
  world: the step divides by it) against the unsharded module's. A head
  count and a vocabulary that do not divide (6 heads, vocab 510 on 4
  ranks) are computed whole; that config's attention is checked too.
* The whole model through ``make_sharded_train_step(...).grads`` on all
  three meshes against ``loss_fn`` on the whole batch: qwen3 (FSDP on,
  ``fsdp_min_elems`` 256 at these widths), the non-dividing config,
  llava-next-34b_smoke (vision), hubert-xlarge_smoke (audio; also with
  510 labels, which do not divide over 4 ranks: the head on each rank's
  positions),
  zamba2-2.7b_smoke (Mamba-2 whole over "model"), deepseek-v2-lite-16b_smoke
  (MLA and MoE whole; (1, 4) only: capacity counts per dp group).
* On mesh (2, 1), no tensor parallelism, each of the ten smoke configs in
  bf16: ``Partition.loss`` of a rank's rows is ``loss_fn``'s bit for bit
  (the model's own blocks, embedding and cross-entropy).
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
  kept unreduced), the MLP output is off by far more than the bound.
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
B, S = 2, 16
FSDP_ON = 256  # fsdp_min_elems at which the smoke widths' matrices are FSDP-sharded


def _cfg(name):
    from repro_torch.configs import get_config

    if name == "odd":  # a head count and a vocabulary that do not divide over 4 ranks
        return dataclasses.replace(get_config("qwen3-0.6b_smoke"), name="odd", n_heads=6,
                                   n_kv_heads=2, vocab=510)
    if name == "hubert-odd":  # per-position labels, a head that does not divide over 4
        return dataclasses.replace(get_config("hubert-xlarge_smoke"), name=name, vocab=510)
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


def _branch_case(cfg, mesh, which: str, seed: int) -> dict:
    """Block 0's attention or MLP branch on this rank's sequence shard
    against the unsharded module: output, input grad and weight grads."""
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
    mod = getattr(whole.blocks[0], which)
    ln = "ln1" if which == "attn" else "ln2"
    hn = rms_norm(h, getattr(whole.blocks[0], ln), cfg.rms_eps)
    y = mod(hn, pos) if which == "attn" else mod(hn)
    (y * c).sum().backward()
    w = gather_group(part.units[0], shards)
    pre = f"blocks.0.{which}."
    sub = {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}
    dmod = getattr(state["model"].blocks[0], which)
    h_loc = part._shard(h.detach()).clone().requires_grad_(True)
    args = (pos,) if which == "attn" else ()
    mode = part.modes[f"blocks.0.{which}"]
    y_loc = part.split("blocks.0", w)(
        which, lambda a, **kw: functional_call(dmod, sub, (a, *args), kw), h_loc,
        w[f"blocks.0.{ln}"], cfg.rms_eps)
    (y_loc * part._shard(c)).sum().backward()
    params = dict(state["model"].named_parameters())
    grads = {}
    for k, p in whole.named_parameters():
        if k.startswith(pre) or k == f"blocks.0.{ln}":
            idx = local_index(params[k].shape, mesh, params[k].placements)
            grads[k] = _rel(shards[k].grad * part.world, p.grad[idx])
    return {"mode": mode, "y": _rel(y_loc, part._shard(y)), "dx": _rel(h_loc.grad, part._shard(h.grad)),
            "grads": grads, "shapes": {k: tuple(v.shape) for k, v in sub.items()}}


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
    (the same forward, embedding and cross-entropy)."""
    from repro_torch.launch import steps
    from repro_torch.models.model import Model, loss_fn
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
    rows = {k: torch.from_numpy(v[r * n:(r + 1) * n]) for k, v in
            _batch(cfg, np.random.default_rng(seed)).items()}
    assert set(part.modes.values()) == {"local"}
    return bool(torch.equal(part.loss(state["model"], shards, rows), loss_fn(cfg, whole, rows)))


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
        out = {"loss": abs(float(loss) - float(want)) / abs(float(want)),
               "grads": {k: _rel(g, whole_grads[k].grad[local_index(params[k].shape, mesh,
                                                                       params[k].placements)])
                         for k, g in grads.items()},
               "modes": dict(fn.partition.modes)}
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
        fsdp = ShardingRules(fsdp_min_elems=FSDP_ON)
        archs = ["qwen3-0.6b_smoke", "odd", "llava-next-34b_smoke", "hubert-xlarge_smoke",
                 "hubert-odd", "zamba2-2.7b_smoke"] + (
                     ["deepseek-v2-lite-16b_smoke"] if shape[0] == 1 else [])
        for arch in archs:
            res[("model", arch, m)] = _model_case(_cfg(arch), mesh, fsdp, 4,
                                                  count=arch == "qwen3-0.6b_smoke")
        if shape == (2, 2):  # the per-unit counts: 4 layers less 2
            deep = dataclasses.replace(_cfg("qwen3-0.6b_smoke"), n_layers=4)
            res[("model", "qwen3-4layers", m)] = _model_case(deep, mesh, fsdp, 4, count=True)
    if world == 2:  # no tensor parallelism: the model's own arithmetic
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        for arch in LOCAL:
            res[("local", arch)] = _local_case(_cfg(arch), mesh, 5)
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


LOCAL = [f"{a}_smoke" for a in ("qwen3-0.6b", "codeqwen1.5-7b", "starcoder2-15b", "qwen1.5-110b",
                                 "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-2.7b",
                                 "xlstm-1.3b", "hubert-xlarge", "llava-next-34b")]


def _ranks(m):
    return range(int(np.prod([int(x) for x in m.split("x")])))


BRANCH = [(w, a, m, r) for w, a in (("attn", "qwen3-0.6b_smoke"), ("attn", "starcoder2-15b_smoke"),
                                    ("attn", "odd"), ("ffn", "qwen3-0.6b_smoke"))
          for m in ("1x2", "1x4") for r in _ranks(m)]


@pytest.mark.parametrize("which,arch,mesh,rank", BRANCH)
def test_tp_branch_matches_the_unsharded_module(results, which, arch, mesh, rank):
    r = results[(which, arch, mesh, rank)]
    whole = arch == "odd" and mesh == "1x4"  # 6 heads on 4 ranks: computed whole
    assert r["mode"] == ("whole" if whole else "tp")
    assert r["y"] <= OUT_TOL and r["dx"] <= OUT_TOL, (r["y"], r["dx"])
    bad = {k: v for k, v in r["grads"].items() if v > OUT_TOL}
    assert not bad and r["grads"], bad
    if which == "attn" and not whole:  # this rank's heads: its q heads, the kv heads they read
        tp = int(mesh.split("x")[1])
        cfg = _cfg(arch)
        hd = cfg.head_dim
        hq = cfg.n_heads // tp
        assert r["shapes"]["wq.w"] == (cfg.d_model, hq * hd) and r["shapes"]["wo.w"] == (hq * hd,
                                                                                        cfg.d_model)
        assert r["shapes"]["wk.w"] == (cfg.d_model, max(1, cfg.n_kv_heads // tp) * hd)


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
                   "hubert-odd", "zamba2-2.7b_smoke")
         + (("deepseek-v2-lite-16b_smoke",) if m != "2x2" else ())
         for r in _ranks(m)]


@pytest.mark.parametrize("arch,mesh,rank", MODEL)
def test_partitioned_model_matches_loss_fn(results, arch, mesh, rank):
    r = results[("model", arch, mesh, rank)]
    assert r["loss"] <= LOSS_RTOL, r["loss"]
    bad = {k: v for k, v in r["grads"].items() if v > GRAD_REL}
    assert not bad and len(r["grads"]) > 10, bad
    assert r["shapes"]  # parameters, grads and moments: this rank's slices by param_specs
    if arch == "qwen3-0.6b_smoke":
        assert set(r["modes"].values()) == {"tp", "vocab"}


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
