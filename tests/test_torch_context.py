"""The sequence split over "model" under ``fsdp_only`` on gloo ranks of the
CPU, in f32: context-parallel attention (``sharding/partition.py``
``_Context``) in the partitioned train, prefill and decode steps, against
the reference's steps jitted with its ``fsdp_only`` in-shardings on the
same numpy weights. The decode keeps the embedding and the head split along
d (``Partition.vocab_d``): each rank looks its tokens up and sums its
logits' partial products on its slice.

Under ``ShardingRules(fsdp_only=True)`` "model" joins the dp pool; where
the global batch does not divide over the whole pool, ``batch_specs`` keeps
the rows on "data" and puts the sequence on "model". The cases: 2 rows on
(2, 2) and 1 row on (1, 2) and (1, 4), so every "model" rank holds 1/2 or
1/4 of each row's positions, for qwen3 (attention in mode "context", the
MLP per token), deepseek (MLA context parallel with its latent gathered,
the dense prefix layer, the MoE per token counting capacity, slots and aux
over the global batch's runs; also 6 rows on (2, 2): 3 rows, 3 runs, a
rank) and zamba2 (Mamba-2 whole over "model" beside context attention).
``fsdp_min_elems`` 256 puts the smoke widths' matrices under FSDP over
(data, model), gathered per unit.

The reference runs once, in a subprocess with 4 fake XLA devices: for each
case ``jax.value_and_grad(loss_fn)`` and ``forward``'s last-position
logits, jitted with ``param_specs``/``batch_specs`` in-shardings on the
case's mesh, and for qwen3 and deepseek on (2, 2) with a batch of 2 (the
cache's sequence over (data, model): bdp is None, 4 slots a rank) a wave
of ``decode_step`` (the prompt fed one token at a time, then greedy
tokens) unjitted and jitted with ``cache_specs``. The port's steps run on
2 ranks (mesh (1, 2)) and 4 ranks (meshes (1, 4) and (2, 2)), each world
spawned once.

Tolerances: the loss within 1e-5, each rank's slice of each grad within
1e-4 of the leaf's largest entry (``test_torch_train_mesh.py``'s f32
per-leaf limit), logits within 1e-5 of the largest. Teeth: with the k/v
gather's backward reduce-scatter skipped (each rank keeps its own partial
grads of its keys), qwen3's grads on (1, 2) are off by far more than the
bound; with the decode's merge over the dp dims skipped (every rank takes
the first shard's partial), the logits are.
"""

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LOSS_TOL, GRAD_REL, TOL = 1e-5, 1e-4, 1e-5
SRC = str(Path(__file__).resolve().parent.parent / "src")
S, STEPS, MAX_LEN = 16, 6, 16  # train/prefill length; decode: an 8-token prompt, 6 greedy steps
PROMPT = 8
RULES = {"fsdp_only": True, "fsdp_min_elems": 256}
ARCHS = {"qwen3": "qwen3-0.6b_smoke", "deepseek": "deepseek-v2-lite-16b_smoke",
         "zamba2": "zamba2-2.7b_smoke"}
# (arch, mesh, rows): train and prefill
CASES = [(a, m, 2 if m == "2x2" else 1) for m in ("2x2", "1x2", "1x4") for a in ARCHS]
CASES.append(("deepseek", "2x2", 6))  # 3 rows a rank: 3 runs of the global order
DECODE = ["qwen3", "deepseek"]  # on (2, 2), a batch of 2
MESHES = {2: ["1x2"], 4: ["1x4", "2x2"]}

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_config
from repro.models.model import decode_step, forward, init_cache, init_params, loss_fn
from repro.sharding.hints import clear_hints, hints_from_mesh
from repro.sharding.specs import ShardingRules, batch_specs, cache_specs, named, param_specs

out, archs, cases, decode, S, PROMPT, STEPS, L, rules = (
    sys.argv[1], *map(json.loads, sys.argv[2:5]), *map(int, sys.argv[5:9]), json.loads(sys.argv[9]))
r = ShardingRules(**rules)
flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, t)


def mesh_of(m):
    shape = tuple(int(x) for x in m.split("x"))
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, ("data", "model"))


for seed, name in enumerate(archs):
    cfg = get_config(archs[name])
    params = f32(init_params(cfg, jax.random.PRNGKey(seed)))
    np.savez(os.path.join(out, name + ".npz"), **{"p" + k: v for k, v in flat(params).items()})
    for arch, m, b in cases:
        if arch != name:
            continue
        toks = np.random.default_rng(seed * 10 + b).integers(0, cfg.vocab, (b, S)).astype(np.int32)
        mesh = mesh_of(m)
        hints_from_mesh(mesh, r)
        ps = named(param_specs(params, cfg, mesh, r), mesh)
        ps_inf = named(param_specs(params, cfg, mesh, r, for_training=False), mesh)
        bs = named(batch_specs(cfg, ShapeConfig("t", S, b, "train"), mesh, r), mesh)
        bp = named(batch_specs(cfg, ShapeConfig("p", S, b, "prefill"), mesh, r), mesh)
        batch = {"tokens": jnp.asarray(toks)}
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(lambda p, x: loss_fn(cfg, p, x, remat=True)),
                                  in_shardings=(ps, bs))(params, batch)
            pre = jax.jit(lambda p, x: forward(cfg, p, x, remat=False)[0][:, -1],
                          in_shardings=(ps_inf, bp))(params, batch)
        clear_hints()
        np.savez(os.path.join(out, f"{name}_{m}_{b}.npz"), toks=toks, loss=np.asarray(loss),
                 prefill=np.asarray(pre), **{"g" + k: v for k, v in flat(grads).items()})
    if name in decode:  # a wave on (2, 2), batch 2: the cache's sequence over (data, model)
        b, mesh = 2, mesh_of("2x2")
        toks = np.random.default_rng(seed * 10 + 7).integers(0, cfg.vocab, (b, PROMPT)).astype(np.int32)
        hints_from_mesh(mesh, r)
        ps = named(param_specs(params, cfg, mesh, r, for_training=False), mesh)
        cs = named(cache_specs(f32(init_cache(cfg, b, L)), cfg, mesh, r), mesh)
        rep = NamedSharding(mesh, P())
        fed, plain, jitted = [], [], []
        c0, c1, tok = f32(init_cache(cfg, b, L)), f32(init_cache(cfg, b, L)), toks[:, :1]
        step = jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos),
                       in_shardings=(ps, cs, rep, rep))
        with mesh:
            for pos in range(PROMPT + STEPS):
                lg, c0 = decode_step(cfg, params, c0, jnp.asarray(tok), jnp.int32(pos))
                lj, c1 = step(params, c1, jnp.asarray(tok), jnp.int32(pos))
                fed.append(tok)
                plain.append(np.asarray(lg))
                jitted.append(np.asarray(lj))
                nxt = np.asarray(jnp.argmax(lg, axis=-1)).astype(np.int32)[:, None]
                tok = toks[:, pos + 1:pos + 2] if pos + 1 < PROMPT else nxt
        clear_hints()
        np.savez(os.path.join(out, f"{name}_decode.npz"), fed=np.stack(fed),
                 decode=np.stack(plain), jit_decode=np.stack(jitted))
"""


def _unflatten(flat: dict, prefix: str) -> dict:
    """{"p['a']['b']": array} -> {"a": {"b": array}} (list indices as ints)."""
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "["):
            continue
        parts = [k.strip("'") for k in key[len(prefix) + 1:-1].split("][")]
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return _lists(tree)


def _lists(t):
    if isinstance(t, dict):
        if t and all(k.isdigit() for k in t):
            return [_lists(t[str(i)]) for i in range(len(t))]
        return {k: _lists(v) for k, v in t.items()}
    return t


def _by_port_name(cfg, tree) -> dict:
    """A reference params/grads tree -> {port parameter name: array}."""
    P, n_units = len(cfg.block_pattern), (cfg.n_layers - cfg.first_k_dense) // len(cfg.block_pattern)
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
        elif path[0] == "units":
            for i in range(n_units):
                out[".".join(["blocks", str(i * P + int(path[1][1:])), *path[2:]])] = t[i]
        else:
            out[".".join(path)] = t

    walk(tree, [])
    return out


def _cfg(name):
    from repro_torch.configs import get_config

    return get_config(ARCHS[name])


def _model(name, d):
    from repro_torch.models.convert import params_from_jax

    ref = np.load(d / f"{name}.npz")
    return params_from_jax(_unflatten(dict(ref), "p"), _cfg(name), "cpu").float()


def _rules():
    from repro_torch.sharding.specs import ShardingRules

    return ShardingRules(**RULES)


def _train_case(name, mesh, b, d) -> dict:
    """``make_sharded_train_step(...).grads`` on this rank: the loss, the
    worst grad error against the reference's (of the leaf's largest
    entry), the plan's modes and the MoE's global batch."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import _place
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.sharding.hints import clear_hints, hints_from_mesh
    from repro_torch.sharding.place import local_index
    from repro_torch.sharding.specs import batch_specs

    cfg, rules, m = _cfg(name), _rules(), "x".join(map(str, mesh.shape))
    ref = dict(np.load(d / f"{name}_{m}_{b}.npz"))
    want = _by_port_name(cfg, _unflatten(ref, "g"))
    hints_from_mesh(mesh, rules)
    try:
        whole = _model(name, d)
        opt = adamw(1e-3)
        state = steps.distribute_state({"model": whole, "opt": opt.init({})}, cfg, mesh, rules)
        batch = _place({"tokens": ref["toks"]}, mesh,
                       batch_specs(cfg, ShapeConfig("t", S, b, "train"), mesh, rules), "cpu")
        fn = steps.make_sharded_train_step(cfg, opt, mesh, agree=steps.make_agree("cpu"),
                                           rules=rules)
        before = moe.DROPPED["assignments"]
        loss, grads, _ = fn.grads(state["model"], batch)
        params = dict(state["model"].named_parameters())
        errs = {}
        for k, g in grads.items():
            w = want[k]
            idx = local_index(params[k].shape, mesh, params[k].placements)
            errs[k] = float(np.abs(g.float().numpy() - w[idx]).max() / (np.abs(w).max() + 1e-30))
        part = fn.partition
        return {"loss": abs(float(loss) - float(ref["loss"])), "grads": errs,
                "n_grads": len(want), "modes": dict(part.modes), "groups": part.over.groups,
                "pieces": part.over.pieces, "sp": part.sp, "tp": part.tp,
                "dropped": moe.DROPPED["assignments"] - before}
    finally:
        clear_hints()


def _prefill_case(name, mesh, b, d) -> dict:
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import _place
    from repro_torch.launch import steps
    from repro_torch.sharding.specs import batch_specs

    cfg, rules, m = _cfg(name), _rules(), "x".join(map(str, mesh.shape))
    ref = dict(np.load(d / f"{name}_{m}_{b}.npz"))
    model = steps.distribute_params(_model(name, d), cfg, mesh, rules)
    batch = _place({"tokens": ref["toks"]}, mesh,
                   batch_specs(cfg, ShapeConfig("p", S, b, "prefill"), mesh, rules), "cpu")
    fn = steps.make_sharded_prefill_step(cfg, mesh, rules)
    got = fn(model, batch).full_tensor()
    want = torch.from_numpy(ref["prefill"])
    return {"err": float((got - want).abs().max() / want.abs().max()),
            "modes": dict(fn.partition.modes)}


def _decode_case(name, mesh, d) -> dict:
    """The wave through ``make_sharded_serve_step``: each step's logits
    against the reference's unjitted and jitted ``decode_step``, the cache
    kinds, and whether each rank's local cache is its slice by
    ``cache_specs``."""
    from repro_torch.launch import steps
    from repro_torch.models import init_cache
    from repro_torch.sharding.place import from_full, local_index
    from repro_torch.sharding.specs import P, cache_specs, placements

    cfg, rules = _cfg(name), _rules()
    ref = dict(np.load(d / f"{name}_decode.npz"))
    b = ref["fed"].shape[1]
    model = steps.distribute_params(_model(name, d), cfg, mesh, rules)
    whole = [{n: t.float() for n, t in layer.items()} for layer in init_cache(cfg, b, MAX_LEN, "cpu")]
    cache = steps.distribute_cache([dict(layer) for layer in whole], cfg, mesh, rules)
    csh = cache_specs(whole, cfg, mesh, rules)
    shapes_ok = all(
        tuple(t.to_local().shape) == tuple(
            len(range(*sl.indices(n))) for sl, n in zip(
                local_index(t.shape, mesh, placements(csh[i][k], mesh)), t.shape))
        and t.to_local().numel() * mesh.size() == t.numel()  # no rank holds more than its share
        for i, layer in enumerate(cache) for k, t in layer.items())
    serve = steps.make_sharded_serve_step(cfg, mesh, rules)
    errs = {"plain": 0.0, "jit": 0.0}
    for pos in range(PROMPT + STEPS):
        tok = from_full(torch.from_numpy(ref["fed"][pos]).long(), mesh, placements(P(), mesh))
        _, cache, lg = serve(model, cache, tok, pos, logits=True)
        lg = lg.full_tensor()
        for k, key in (("plain", "decode"), ("jit", "jit_decode")):
            want = torch.from_numpy(ref[key][pos])
            errs[k] = max(errs[k], float((lg - want).abs().max() / want.abs().max()))
    return {**errs, "shapes_ok": shapes_ok, "cache": serve.partition.cache_kinds(),
            "modes": set(serve.partition.modes.values()),
            "vocab_d": sorted(serve.partition.vocab_d)}


def _teeth_kv(mesh, d) -> float:
    """qwen3's step with the k/v gather's backward reduce-scatter skipped:
    each rank keeps its own queries' partial grads of its keys' shard."""
    from repro_torch.sharding import partition

    scatter = partition._scatter_dim

    def skipped(x, dim, group, n):
        s = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * s, s).contiguous()

    partition._scatter_dim = skipped
    try:
        return max(_train_case("qwen3", mesh, 1, d)["grads"].values())
    finally:
        partition._scatter_dim = scatter


def _teeth_merge(mesh, d) -> float:
    """qwen3's decode with the merge of the sequence shards' partials over
    the dp dims skipped: every rank takes the first shard's."""
    from repro_torch.sharding import partition

    merge = partition.merge_lse
    partition.merge_lse = lambda parts: parts[0]
    try:
        return _decode_case("qwen3", mesh, d)["plain"]
    finally:
        partition.merge_lse = merge


def _worker(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg{world}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh

    res = {}
    for m in MESHES[world]:
        mesh = make_mesh(tuple(int(x) for x in m.split("x")), ("data", "model"),
                         device_type="cpu")
        for name, mm, b in CASES:
            if mm == m:
                res[("train", name, m, b)] = _train_case(name, mesh, b, d)
                res[("prefill", name, m, b)] = _prefill_case(name, mesh, b, d)
        if m == "2x2":
            for name in DECODE:
                res[("decode", name)] = _decode_case(name, mesh, d)
            res[("teeth-merge",)] = _teeth_merge(mesh, d)
        if m == "1x2":
            res[("teeth-kv",)] = _teeth_kv(mesh, d)
    torch.save(res, d / f"{world}_{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("context")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d), json.dumps(ARCHS), json.dumps(CASES),
         json.dumps(DECODE), str(S), str(PROMPT), str(STEPS), str(MAX_LEN), json.dumps(RULES)],
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin:/usr/local/bin", "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for world in MESHES:
        mp.spawn(_worker, args=(world, d), nprocs=world)
        for rank in range(world):
            for k, v in torch.load(d / f"{world}_{rank}.pt", weights_only=False).items():
                out[(*k, rank)] = v
    yield out
    shutil.rmtree(d, ignore_errors=True)


def _ranks(m):
    return range(math.prod(int(x) for x in m.split("x")))


RUNS = [(n, m, b, r) for n, m, b in CASES for r in _ranks(m)]


@pytest.mark.parametrize("name,mesh,rows,rank", RUNS)
def test_sequence_split_training_matches_the_reference_jitted(runs, name, mesh, rows, rank):
    """Loss and every grad slice against ``jax.value_and_grad`` jitted with
    the ``fsdp_only`` in-shardings; the sequence over "model", attention
    (MLA) context parallel, the MLP and MoE per token, Mamba-2 whole."""
    r = runs[("train", name, mesh, rows, rank)]
    assert r["loss"] <= LOSS_TOL, r["loss"]
    bad = {k: v for k, v in r["grads"].items() if v > GRAD_REL}
    assert not bad and len(r["grads"]) == r["n_grads"] > 10, bad
    n = int(mesh.split("x")[1])
    assert r["sp"] == n and r["tp"] == 1
    modes = r["modes"]
    assert {v for k, v in modes.items() if k.endswith(".attn")} == {"context"}, modes
    assert {v for k, v in modes.items() if k.endswith((".ffn", ".moe"))} <= {"tokens"}
    assert {v for k, v in modes.items() if k.endswith(".core")} <= {"whole"}
    assert modes["embed"] == modes["head"] == "whole"
    if name == "deepseek":  # the global batch: every rank's runs, capacity binding
        assert r["groups"] == math.prod(int(x) for x in mesh.split("x"))
        assert r["pieces"] == rows // int(mesh[0]) and r["dropped"] > 0


@pytest.mark.parametrize("name,mesh,rows,rank", RUNS)
def test_sequence_split_prefill_matches_the_reference_jitted(runs, name, mesh, rows, rank):
    r = runs[("prefill", name, mesh, rows, rank)]
    assert r["err"] <= TOL, r["err"]
    assert {v for k, v in r["modes"].items() if k.endswith(".attn")} == {"context"}


@pytest.mark.parametrize("name,rank", [(n, r) for n in DECODE for r in range(4)])
def test_fsdp_only_decode_matches_the_reference(runs, name, rank):
    """Decode under ``fsdp_only`` on (2, 2) with a batch of 2: every rank
    computes both rows at full width with the weights gathered per unit,
    attends its quarter of the cache's sequence and merges the partials;
    against the reference's ``decode_step`` unjitted and jitted with
    ``cache_specs``."""
    r = runs[("decode", name, rank)]
    assert r["plain"] <= TOL and r["jit"] <= TOL, r
    assert r["shapes_ok"] and r["cache"] == {"sequence over dp": 4}  # 2 layers' k/v or latents
    assert r["modes"] == {"local"}
    # the vocabulary matrices stay split along d: tokens looked up and
    # logits summed on each rank's slice
    assert r["vocab_d"] == (["embed"] if name == "qwen3" else ["embed", "lm_head.w"])


@pytest.mark.parametrize("which", ["teeth-kv", "teeth-merge"])
def test_skipping_a_context_collective_fails_the_check(runs, which):
    """The k/v gather's backward reduce-scatter, or the decode's merge over
    the dp dims, skipped: far outside the bound."""
    ranks = range(2) if which == "teeth-kv" else range(4)
    bound = GRAD_REL if which == "teeth-kv" else TOL
    for rank in ranks:
        assert runs[(which, rank)] > 100 * bound
