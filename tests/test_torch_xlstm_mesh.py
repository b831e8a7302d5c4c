"""The partitioned xLSTM decode (``sharding/partition.py``
``Partition._xlstm_decode``; ``models/ssm.py``'s cache branches) on gloo
ranks of the CPU, in f32, against the port unmeshed and against the
reference's ``decode_step``, unjitted and jitted with its inference
in-shardings (``param_specs(for_training=False)``, ``cache_specs``) on the
same mesh, on the same numpy weights.

The cache's split decides the plan, as ``cache_specs`` decides it:

* xlstm-1.3b_smoke (4 heads) on (1, 2), (1, 4) and (2, 2): by head (mode
  "tp"). The mLSTM's ``C``/``n``/``m`` and the sLSTM's ``c``/``n``/``h``/
  ``m`` hold this rank's heads, the conv window its channels; the cell
  input and the conv's output are gathered over "model", ``out_norm``'s
  sum of squares summed over it, ``down``'s and ``ffn_down``'s rows
  all-reduced in f32.
* xlstm-h2 (2 heads: ``test_torch_tp.py``'s variant) on (1, 4): along dk
  (mode "dk"). The mLSTM takes every head's dk slice of ``wq``/``wk``
  (v and the gates whole), updates its ``C[:, :, dk]`` and ``n[..., dk]``
  with ``m`` whole, and sums the partial ``q . C`` and ``q . n`` over
  "model" before the stabiliser's max; the sLSTM gathers its state's hd
  slices, runs the cell whole and keeps its slices. Both cut their whole
  output to this rank's channels for the ``out_norm`` slice, as by head.
  On (1, 2) its heads divide: by head.

The reference runs once in a subprocess with 4 fake XLA devices: a wave
of ``decode_step`` from the initial caches (an 8-token prompt fed one
token at a time, then 6 greedy tokens) for a batch of 2, and the same
steps jitted with the in-shardings on each mesh the port runs. Every path
is fed the reference's tokens.

Tolerance: the partitioned decode's logits within 1e-5 of the largest
of the port's unmeshed decode on the same weights (``SPLIT_TOL``: what
the split itself changes), and within 3e-5 of the reference's unjitted
and jitted steps (``TOL``). The mLSTM's output is
``num / max(|q . n|, exp(-m))`` (and the sLSTM's ``c / max(n, 1)``), which
magnifies the f32 rounding of a reordered sum wherever ``|q . n|`` is
small: on these weights the port's own unmeshed decode is 9.4e-6 of the
largest logit from the reference's (``test_torch_xlstm.py`` holds them
at 1e-4 absolute), and the partitioned decode, its sums in another
order, 1.1e-5 from the reference's at worst. Each
rank's local cache is its slice by ``cache_specs``. Teeth: with the dk
partial sums not summed, or the sLSTM's state slices not gathered (each
rank's own slice in every rank's place), the logits on (1, 4) are off by
far more than the bound.
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

TOL, SPLIT_TOL = 3e-5, 1e-5
SRC = str(Path(__file__).resolve().parent.parent / "src")
PROMPT, STEPS, MAX_LEN, B = 8, 6, 16, 2
# name -> (heads, the meshes it runs on)
CASES = {"xlstm": (4, ["1x2", "1x4", "2x2"]), "xlstm-h2": (2, ["1x2", "1x4"])}
MESHES = {2: ["1x2"], 4: ["1x4", "2x2"]}

REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.models.model import decode_step, init_cache, init_params
from repro.sharding.hints import clear_hints, hints_from_mesh
from repro.sharding.specs import ShardingRules, cache_specs, named, param_specs

out, cases, PROMPT, STEPS, L, b = sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:7])
flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, t)
for seed, (name, (heads, meshes)) in enumerate(cases.items()):
    cfg = dataclasses.replace(get_config("xlstm-1.3b_smoke"), n_heads=heads, n_kv_heads=heads)
    params = f32(init_params(cfg, jax.random.PRNGKey(seed)))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, PROMPT)).astype(np.int32)
    cache, tok, fed, lg = f32(init_cache(cfg, b, L)), toks[:, :1], [], []
    dstep = jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos))
    for pos in range(PROMPT + STEPS):
        logits, cache = dstep(params, cache, jnp.asarray(tok), jnp.int32(pos))
        fed.append(tok)
        lg.append(np.asarray(logits))
        nxt = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)[:, None]
        tok = toks[:, pos + 1:pos + 2] if pos + 1 < PROMPT else nxt
    res = {"fed": np.stack(fed), "decode": np.stack(lg)}
    r = ShardingRules()
    for m in meshes:  # the jitted step with the inference in-shardings
        shape = tuple(int(x) for x in m.split("x"))
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
        hints_from_mesh(mesh, r)
        ps = named(param_specs(params, cfg, mesh, r, for_training=False), mesh)
        cs = named(cache_specs(f32(init_cache(cfg, b, L)), cfg, mesh, r), mesh)
        tok_sh = NamedSharding(mesh, P(("data",) if b % shape[0] == 0 else None, None))
        rep = NamedSharding(mesh, P())
        step = jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos),
                       in_shardings=(ps, cs, tok_sh, rep), out_shardings=(rep, cs))
        cache, jl = f32(init_cache(cfg, b, L)), []
        with mesh:
            for pos in range(PROMPT + STEPS):
                logits, cache = step(params, cache, jnp.asarray(res["fed"][pos]), jnp.int32(pos))
                jl.append(np.asarray(logits))
        clear_hints()
        res["jit_" + m] = np.stack(jl)
    np.savez(os.path.join(out, name + ".npz"), **{"p" + k: v for k, v in flat(params).items()},
             **res)
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

    heads = CASES[name][0]
    return dataclasses.replace(get_config("xlstm-1.3b_smoke"), n_heads=heads, n_kv_heads=heads)


def _model(name, d):
    from repro_torch.models.convert import params_from_jax

    ref = np.load(d / f"{name}.npz")
    return params_from_jax(_unflatten(dict(ref), "p"), _cfg(name), "cpu").float(), dict(ref)


def _f32_cache(cfg):
    from repro_torch.models import init_cache

    return [{n: t.float() for n, t in layer.items()} for layer in init_cache(cfg, B, MAX_LEN, "cpu")]


def _decode_case(name, mesh, d) -> dict:
    """The wave through ``make_sharded_serve_step``: the logits of every
    step (whole), the plan's core modes, the cache kinds and whether each
    rank's local parameters and cache are its slices by the specs."""
    from repro_torch.launch import steps
    from repro_torch.sharding.place import from_full, local_index
    from repro_torch.sharding.specs import P, ShardingRules, cache_specs, param_specs, placements

    cfg, rules = _cfg(name), ShardingRules()
    whole, ref = _model(name, d)
    model = steps.distribute_params(whole, cfg, mesh, rules)
    specs = param_specs(model, cfg, mesh, rules, for_training=False)

    def sliced(t, spec):
        return tuple(t.to_local().shape) == tuple(
            len(range(*sl.indices(n))) for sl, n in zip(
                local_index(t.shape, mesh, placements(spec, mesh)), t.shape))

    shapes_ok = all(sliced(p, specs[k]) for k, p in model.named_parameters())
    whole_cache = _f32_cache(cfg)
    csh = cache_specs(whole_cache, cfg, mesh, rules)
    cache = steps.distribute_cache(_f32_cache(cfg), cfg, mesh, rules)
    shapes_ok &= all(sliced(t, csh[i][k]) for i, layer in enumerate(cache)
                     for k, t in layer.items())
    serve = steps.make_sharded_serve_step(cfg, mesh, rules)
    rows = P(("data",) if B % mesh.size(0) == 0 else None, None)
    logits = []
    for pos in range(PROMPT + STEPS):
        tok = from_full(torch.from_numpy(ref["fed"][pos]).long(), mesh, placements(rows, mesh))
        _, cache, lg = serve(model, cache, tok, pos, logits=True)
        logits.append(lg.full_tensor())
    modes = {v for k, v in serve.partition.modes.items() if k.endswith(".core")}
    return {"decode": torch.stack(logits), "modes": modes, "shapes_ok": shapes_ok,
            "cache": serve.partition.cache_kinds()}


def _teeth_contracted(mesh, d) -> torch.Tensor:
    """The mLSTM's dk partial sums not summed over "model"."""
    from repro_torch.sharding.partition import _Decode

    summed = _Decode.contracted
    _Decode.contracted = lambda self, *xs: xs
    try:
        return _decode_case("xlstm-h2", mesh, d)["decode"]
    finally:
        _Decode.contracted = summed


def _teeth_state(mesh, d) -> torch.Tensor:
    """The sLSTM's state slices not gathered: each rank's own slice in
    every rank's place."""
    from repro_torch.sharding.partition import _Decode

    gathered = _Decode.whole_dk
    _Decode.whole_dk = lambda self, *xs: (tuple(torch.cat([x] * self.n, dim=-1) for x in xs)
                                          if self.dk else xs)
    try:
        return _decode_case("xlstm-h2", mesh, d)["decode"]
    finally:
        _Decode.whole_dk = gathered


def _worker(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/pg{world}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh

    res = {}
    for m in MESHES[world]:
        mesh = make_mesh(tuple(int(x) for x in m.split("x")), ("data", "model"),
                         device_type="cpu")
        for name, (_, meshes) in CASES.items():
            if m in meshes:
                res[(name, m)] = _decode_case(name, mesh, d)
        if m == "1x4":
            res[("teeth-contracted", m)] = _teeth_contracted(mesh, d)
            res[("teeth-state", m)] = _teeth_state(mesh, d)
    torch.save(res, d / f"{world}_{rank}.pt")
    dist.destroy_process_group()


def _plain(name, d) -> torch.Tensor:
    """The port unmeshed on the same weights and tokens."""
    from repro_torch.models import decode_step

    cfg = _cfg(name)
    model, ref = _model(name, d)
    cache, lg = _f32_cache(cfg), []
    for pos in range(PROMPT + STEPS):
        logits, cache = decode_step(cfg, model, cache, torch.from_numpy(ref["fed"][pos]).long(),
                                    pos)
        lg.append(logits)
    return torch.stack(lg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("xlstm_mesh")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d), json.dumps(CASES),
                           str(PROMPT), str(STEPS), str(MAX_LEN), str(B)],
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


def _ranks(m):
    return range(math.prod(int(x) for x in m.split("x")))


RUNS = [(n, m, r) for n, (_, meshes) in CASES.items() for m in meshes for r in _ranks(m)]


@pytest.mark.parametrize("name,mesh,rank", RUNS)
def test_xlstm_decode_on_a_mesh_matches_the_port_and_the_reference(runs, name, mesh, rank):
    out, plain, refs = runs
    got = out[(name, mesh, rank)]
    for step in range(PROMPT + STEPS):
        assert _rel(got["decode"][step], plain[name][step]) <= SPLIT_TOL, step
        assert _rel(got["decode"][step], refs[name]["decode"][step]) <= TOL, step
        assert _rel(got["decode"][step], refs[name][f"jit_{mesh}"][step]) <= TOL, step
    assert got["shapes_ok"]


@pytest.mark.parametrize("name,mesh", [(n, m) for n, (_, ms) in CASES.items() for m in ms])
def test_the_xlstm_cache_splits_by_head_or_along_dk(runs, name, mesh):
    """By head where the heads divide over "model", along dk (hd) where they
    do not: the mLSTM's C and n and the sLSTM's c, n and h; m then whole;
    the mLSTM's conv window by channel."""
    got = runs[0][(name, mesh, 0)]
    n = int(mesh.split("x")[1])
    if CASES[name][0] % n == 0:  # 5 mLSTM layers (conv; C, n, m) and 1 sLSTM (c, n, h, m)
        assert got["modes"] == {"tp"} and got["cache"] == {"channels": 5, "heads": 19}
    else:  # C, n (x 5) and c, n, h along dk; m whole in each layer
        assert got["modes"] == {"dk"}
        assert got["cache"] == {"channels": 5, "dk": 13, "whole": 6}


@pytest.mark.parametrize("which", ["teeth-contracted", "teeth-state"])
def test_skipping_a_new_collective_fails_the_check(runs, which):
    out, plain, _ = runs
    for rank in range(4):
        assert _rel(out[(which, "1x4", rank)], plain["xlstm-h2"]) > 100 * TOL
