"""Partitioned serving on gloo ranks of the CPU, in f32
(``launch/steps.py`` ``make_sharded_prefill_step`` and
``make_sharded_serve_step``; ``sharding/partition.py`` ``Partition.prefill``
and ``Partition.decode``), against the port unmeshed and against the
reference on the same numpy weights.

The reference runs once, in a subprocess with 4 fake XLA devices: for each
case its ``init_params`` (cast to f32) give the weights, its ``forward``
the last position's logits of a prompt, and its ``decode_step`` the logits
of every step of a wave (the prompt fed one token at a time, then greedy
tokens), which every path is fed; the same steps through ``jax.jit`` with
its inference in-shardings (``param_specs(for_training=False)``,
``batch_specs``, ``cache_specs``) on a (2, 2) mesh for qwen3. The port's
unmeshed prefill and ``decode_step`` run in the test process, the meshed
steps on 2 ranks (mesh (1, 2)) and 4 ranks (meshes (1, 4) and (2, 2)),
each world spawned once.

Tolerance: every logit within 1e-5 of the largest of the port's unmeshed
logits (``test_torch_tp.py``'s bound: the shards' sums differ from the
whole's in order only) and of the reference's. The meshed greedy token
equals the unmeshed port's wherever the unmeshed top two logits are more
than that bound apart.

Cases: qwen3 (kv heads 2: the cache by head on (1, 2) and (2, 2), by
sequence on (1, 4); and by sequence everywhere with
``shard_cache_heads=False``, some steps with an empty shard), starcoder2
(q/k/v bias), deepseek (MLA latents by sequence, the dense prefix layer,
this rank's experts), qwen2-moe with weight-gathered serving (a small
``inference_weight_budget`` and ``fsdp_min_elems``: every unit gathered
over "data" on (2, 2)), and with 5 experts, which divide over no "model"
size (the banks whole), zamba2 (Mamba-2 on this rank's heads, B/C conv
windows by channel; with a batch of one the attention cache's sequence
over "data" on (2, 2)), and prefill alone for llava (patch embeddings
before the text), hubert (frames, bidirectional) and xlstm (mLSTM and
sLSTM on their heads). Also: each rank's local parameter and cache shapes
are its slices by the specs; the vocab-sharded greedy token takes the
lowest index of a tie, across ranks and within one.
"""

import dataclasses
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

TOL = 1e-5
SRC = str(Path(__file__).resolve().parent.parent / "src")
S, STEPS, MAX_LEN = 8, 6, 16  # prompt, greedy steps, cache slots (4 a shard on 4 ranks)
FSDP = {"inference_weight_budget": 1000, "fsdp_min_elems": 256}
# name -> (arch, config overrides, rules, batch, decode)
CASES = {
    "qwen3": ("qwen3-0.6b_smoke", {}, {}, 4, True),
    "qwen3-seq": ("qwen3-0.6b_smoke", {}, {"shard_cache_heads": False}, 4, True),
    "starcoder2": ("starcoder2-15b_smoke", {}, {}, 4, True),
    "deepseek": ("deepseek-v2-lite-16b_smoke", {}, {}, 4, True),
    "qwen2-moe-gathered": ("qwen2-moe-a2.7b_smoke", {}, FSDP, 4, True),
    "qwen2-moe-whole": ("qwen2-moe-a2.7b_smoke", {"n_routed_experts": 5}, FSDP, 4, True),
    "zamba2": ("zamba2-2.7b_smoke", {}, {}, 4, True),
    "zamba2-b1": ("zamba2-2.7b_smoke", {}, {}, 1, True),
    "llava": ("llava-next-34b_smoke", {}, {}, 4, False),
    "hubert": ("hubert-xlarge_smoke", {}, {}, 4, False),
    "xlstm": ("xlstm-1.3b_smoke", {}, {}, 4, False),
}
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
JIT_CASE = "qwen3"  # held to the reference's jitted steps on its (2, 2) mesh

REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_config
from repro.models.model import decode_step, forward, init_cache, init_params
from repro.sharding.hints import clear_hints, hints_from_mesh
from repro.sharding.specs import ShardingRules, batch_specs, cache_specs, named, param_specs

out, cases, S, STEPS, L, jit_case = (sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:6]),
                                     sys.argv[6])
flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, t)
for seed, (name, (arch, over, rules, b, dec)) in enumerate(cases.items()):
    cfg = dataclasses.replace(get_config(arch), **over)
    params = f32(init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        batch = {"frames": rng.standard_normal((b, S, cfg.d_frontend)).astype(np.float32)}
    else:
        n_img = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" else 0
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
        if n_img:
            batch["patch_embeds"] = rng.standard_normal((b, n_img, cfg.d_frontend)).astype(np.float32)
    fwd = jax.jit(lambda p, x: forward(cfg, p, x, remat=False)[0][:, -1])
    res = {"prefill": np.asarray(fwd(params, {k: jnp.asarray(v) for k, v in batch.items()}))}
    if dec:
        cache, toks, fed, lg = f32(init_cache(cfg, b, L)), batch["tokens"], [], []
        tok, dstep = toks[:, :1], jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos))
        for pos in range(S + STEPS):
            logits, cache = dstep(params, cache, jnp.asarray(tok), jnp.int32(pos))
            fed.append(tok)
            lg.append(np.asarray(logits))
            nxt = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)[:, None]
            tok = toks[:, pos + 1:pos + 2] if pos + 1 < S else nxt
        res["fed"], res["decode"] = np.stack(fed), np.stack(lg)
    if name == jit_case:  # the jitted steps with the inference in-shardings on (2, 2)
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
        r = ShardingRules(**rules)
        hints_from_mesh(mesh, r)
        ps = named(param_specs(params, cfg, mesh, r, for_training=False), mesh)
        bs = named(batch_specs(cfg, ShapeConfig("p", S, b, "prefill"), mesh, r), mesh)
        out_sh = NamedSharding(mesh, P(("data",), "model"))
        with mesh:
            pre = jax.jit(lambda p, x: forward(cfg, p, x, remat=False)[0][:, -1],
                          in_shardings=(ps, bs), out_shardings=out_sh)
            res["jit_prefill"] = np.asarray(pre(params, {k: jnp.asarray(v) for k, v in batch.items()}))
            cache = f32(init_cache(cfg, b, L))
            cs = named(cache_specs(cache, cfg, mesh, r), mesh)
            tok_sh, rep = NamedSharding(mesh, P(("data",), None)), NamedSharding(mesh, P())
            step = jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos),
                           in_shardings=(ps, cs, tok_sh, rep), out_shardings=(out_sh, cs))
            lg = []
            for pos in range(S + STEPS):
                logits, cache = step(params, cache, jnp.asarray(res["fed"][pos]), jnp.int32(pos))
                lg.append(np.asarray(logits))
            res["jit_decode"] = np.stack(lg)
        clear_hints()
    np.savez(os.path.join(out, name + ".npz"), **{"p" + k: v for k, v in flat(params).items()},
             **{"in_" + k: v for k, v in batch.items()}, **res)
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


def _cfg(name):
    from repro_torch.configs import get_config

    arch, over = CASES[name][:2]
    return dataclasses.replace(get_config(arch), **over)


def _model(name, d):
    from repro_torch.models.convert import params_from_jax

    ref = np.load(d / f"{name}.npz")
    return params_from_jax(_unflatten(dict(ref), "p"), _cfg(name), "cpu").float(), ref


def _inputs(ref) -> dict:
    return {k[3:]: ref[k] for k in ref.files if k.startswith("in_")}


def _f32_cache(cfg, b):
    from repro_torch.models import init_cache

    return [{n: t.float() for n, t in layer.items()} for layer in init_cache(cfg, b, MAX_LEN, "cpu")]


def _serve_case(name, mesh, d) -> dict:
    """This rank's meshed prefill logits and decode logits and tokens (whole
    tensors), and whether its local parameter and cache shapes are its
    slices by the specs."""
    from repro_torch.data.pipeline import _place
    from repro_torch.launch import steps
    from repro_torch.configs import ShapeConfig
    from repro_torch.sharding.place import from_full, local_index
    from repro_torch.sharding.specs import (P, ShardingRules, batch_specs, cache_specs,
                                            param_specs, placements)

    cfg, (_, _, rules_kw, b, dec) = _cfg(name), CASES[name]
    rules = ShardingRules(**rules_kw)
    whole, ref = _model(name, d)
    model = steps.distribute_params(_model(name, d)[0], cfg, mesh, rules)
    specs = param_specs(whole, cfg, mesh, rules, for_training=False)
    shapes_ok = all(
        tuple(p.to_local().shape) == tuple(
            len(range(*sl.indices(n))) for sl, n in zip(local_index(p.shape, mesh, placements(
                specs[k], mesh)), p.shape))
        and tuple(p.placements) == placements(specs[k], mesh)
        for k, p in model.named_parameters())
    batch = _place(_inputs(ref), mesh, batch_specs(cfg, ShapeConfig("p", S, b, "prefill"), mesh,
                                                   rules), "cpu")
    prefill = steps.make_sharded_prefill_step(cfg, mesh, rules)
    out = {"prefill": prefill(model, batch).full_tensor(),
           "modes": dict(prefill.partition.modes)}
    if not dec:
        out["shapes_ok"] = shapes_ok
        return out
    whole_cache = _f32_cache(cfg, b)
    cache = steps.distribute_cache(_f32_cache(cfg, b), cfg, mesh, rules)
    csh = cache_specs(whole_cache, cfg, mesh, rules)
    shapes_ok &= all(
        tuple(t.to_local().shape) == tuple(
            len(range(*sl.indices(n))) for sl, n in zip(local_index(t.shape, mesh, placements(
                csh[i][k], mesh)), t.shape))
        for i, layer in enumerate(cache) for k, t in layer.items())
    serve = steps.make_sharded_serve_step(cfg, mesh, rules)
    rows = P(("data",) if b % mesh.size(0) == 0 else None, None)
    logits, toks = [], []
    for pos in range(S + STEPS):
        tok = from_full(torch.from_numpy(ref["fed"][pos]).long(), mesh, placements(rows, mesh))
        nxt, cache, lg = serve(model, cache, tok, pos, logits=True)
        logits.append(lg.full_tensor())
        toks.append(nxt.full_tensor())
    out.update(decode=torch.stack(logits), tokens=torch.stack(toks), shapes_ok=shapes_ok,
               decode_modes=dict(serve.partition.modes), cache=serve.partition.cache_kinds())
    return out


def _tie_case(mesh, d) -> bool:
    """``Partition.greedy`` on crafted vocab-sharded logits: a tie across
    two ranks' shards, the largest on the last rank alone, a tie inside one
    shard; the lowest global index of the largest every time."""
    from repro_torch.launch import steps
    from repro_torch.sharding.partition import Partition
    from repro_torch.sharding.specs import ShardingRules

    cfg = _cfg("qwen3")
    model = steps.distribute_params(_model("qwen3", d)[0], cfg, mesh, ShardingRules())
    part = Partition(cfg, model, mesh, ShardingRules(), decode=True)
    n, V = part.tp, cfg.vocab
    g = torch.zeros(3, V)
    g[0, 5], g[0, V // n + 3] = 2.0, 2.0  # ranks 0 and 1
    g[1, V - 1] = 3.0  # the last rank alone
    g[2, V // n + 7], g[2, V // n + 9] = 1.5, 1.5  # inside rank 1's shard
    vl = V // n
    got = part.greedy(g[:, part.tp_rank * vl:(part.tp_rank + 1) * vl])[:, 0]
    return torch.equal(got, torch.tensor([5, V - 1, V // n + 7]))


def _worker(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg{world}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh

    res = {}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        m = "x".join(map(str, shape))
        for name in CASES:
            res[(name, m)] = _serve_case(name, mesh, d)
        res[("tie", m)] = _tie_case(mesh, d)
    torch.save(res, d / f"{world}_{rank}.pt")
    dist.destroy_process_group()


def _plain(name, d) -> dict:
    """The port unmeshed on the same weights and inputs."""
    from repro_torch.launch import steps
    from repro_torch.models import decode_step

    cfg, (_, _, _, b, dec) = _cfg(name), CASES[name]
    model, ref = _model(name, d)
    out = {"prefill": steps.make_prefill_step(cfg)(
        model, {k: torch.from_numpy(v) for k, v in _inputs(ref).items()})}
    if dec:
        cache, lg = _f32_cache(cfg, b), []
        for pos in range(S + STEPS):
            logits, cache = decode_step(cfg, model, cache, torch.from_numpy(ref["fed"][pos]).long(),
                                        pos)
            lg.append(logits)
        out["decode"] = torch.stack(lg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_mesh")
    cases = {k: [v[0], v[1], v[2], v[3], v[4]] for k, v in CASES.items()}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d), json.dumps(cases), str(S),
                           str(STEPS), str(MAX_LEN), JIT_CASE],
                          env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin:/usr/local/bin",
                               "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for world in MESHES:
        mp.spawn(_worker, args=(world, d), nprocs=world)
        for rank in range(world):
            for k, v in torch.load(d / f"{world}_{rank}.pt", weights_only=False).items():
                out[(*k, rank)] = v
    plain = {name: _plain(name, d) for name in CASES}
    refs = {name: dict(np.load(d / f"{name}.npz")) for name in CASES}
    yield out, plain, refs
    shutil.rmtree(d, ignore_errors=True)


def _rel(got, want) -> float:
    want = torch.as_tensor(want).float()
    return float((torch.as_tensor(got).float() - want).abs().max() / want.abs().max())


RUNS = [(n, m, r) for m in ("1x2", "1x4", "2x2") for n in CASES
        for r in range(math.prod(int(x) for x in m.split("x")))]
DECODE = [(n, m, r) for n, m, r in RUNS if CASES[n][4]]


@pytest.mark.parametrize("name,mesh,rank", RUNS)
def test_meshed_prefill_matches_the_port_and_the_reference(runs, name, mesh, rank):
    out, plain, refs = runs
    got = out[(name, mesh, rank)]
    assert _rel(got["prefill"], plain[name]["prefill"]) <= TOL
    assert _rel(got["prefill"], refs[name]["prefill"]) <= TOL
    assert got["shapes_ok"]
    # every block's branches are tensor parallel where their weights divide
    if name != "qwen2-moe-whole":
        assert {v for k, v in got["modes"].items() if k.startswith(("blocks.", "prefix."))} \
            == {"tp"}, got["modes"]


@pytest.mark.parametrize("name,mesh,rank", DECODE)
def test_meshed_decode_matches_the_port_and_the_reference(runs, name, mesh, rank):
    out, plain, refs = runs
    got, want = out[(name, mesh, rank)], plain[name]["decode"]
    for step in range(S + STEPS):
        assert _rel(got["decode"][step], want[step]) <= TOL, step
        assert _rel(got["decode"][step], refs[name]["decode"][step]) <= TOL, step
    # the greedy token where the unmeshed top two logits are apart
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > TOL * want.abs().amax(dim=-1)
    assert decisive.float().mean() >= 0.9
    mine = got["tokens"][..., 0]
    assert torch.equal(mine[decisive], want.argmax(dim=-1)[decisive])


def test_the_cache_layouts_are_the_ones_named(runs):
    out, _, _ = runs
    kinds = {(n, m): out[(n, m, 0)]["cache"] for n, m, r in DECODE if r == 0}
    assert kinds[("qwen3", "1x2")] == {"heads": 4}
    assert kinds[("qwen3", "1x4")] == {"sequence": 4}  # 2 kv heads on 4 ranks
    assert kinds[("qwen3", "2x2")] == {"heads": 4}
    assert all(kinds[("qwen3-seq", m)] == {"sequence": 4} for m in ("1x2", "1x4", "2x2"))
    assert all(kinds[("deepseek", m)] == {"sequence": 4} for m in ("1x2", "1x4", "2x2"))
    assert kinds[("zamba2-b1", "2x2")] == {"channels": 15, "heads": 5,
                                           "heads, sequence over dp": 2}
    assert kinds[("zamba2", "2x2")] == {"channels": 15, "heads": 7}
    modes = out[("qwen2-moe-whole", "2x2", 0)]["decode_modes"]
    assert {v for k, v in modes.items() if k.endswith(".moe")} == {"whole"}
    modes = out[("deepseek", "1x4", 0)]["decode_modes"]
    assert {v for k, v in modes.items() if k.endswith((".moe", ".attn"))} == {"tp"}


@pytest.mark.parametrize("mesh,rank", [(m, r) for m in ("1x2", "1x4", "2x2")
                                       for r in range(math.prod(int(x) for x in m.split("x")))])
def test_vocab_sharded_greedy_takes_the_lowest_index_of_a_tie(runs, mesh, rank):
    assert runs[0][("tie", mesh, rank)]


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_meshed_steps_match_the_reference_jitted_on_its_mesh(runs, which):
    """qwen3 on (2, 2): the reference's ``jax.jit`` with its inference
    in-shardings on 4 fake XLA devices against the port's meshed steps."""
    out, _, refs = runs
    want = refs[JIT_CASE][f"jit_{which}"]
    for rank in range(4):
        got = out[(JIT_CASE, "2x2", rank)][which]
        assert _rel(got, want) <= TOL
