"""The port's qwen3 model, and the two MoE configs (deepseek-v2-lite with
MLA and a dense prefix layer, qwen2-moe), against the JAX package on the
CPU.

Weights are drawn once by JAX (torch cannot reproduce ``jax.random``) and
converted with ``params_from_jax``; tokens come from a seeded numpy
generator. Logit tolerances, stated once:

* bf16 weights: 2e-2 absolute. The logits of the smoke model reach ~0.7,
  where one bf16 ulp is 2^-8; the two frameworks round some intermediate
  bf16 results differently (fused vs separate elementwise ops, exp/softmax
  implementations), which moves logits by up to ~3 ulps (1.2e-2 measured).
* float32 weights: 1e-3. Everything but the bf16 KV cache is float32; a
  one-ulp flip of a cache entry moves a logit by up to ~1e-3.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jax_kernels
from repro.configs.base import get_config as jax_get_config
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch import kernels as torch_kernels
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_cache, loss_fn
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
ARCH = "qwen3-0.6b_smoke"


def jax_and_torch_params(seed: int, dtype: str):
    """The same weights in both packages (float32 casts the bf16 init)."""
    jp = jm.init_params(jax_get_config(ARCH), jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jp), get_config(ARCH), "cpu")
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        model = model.float()
    return jp, model


@pytest.fixture
def kernel_switches():
    """Yields a setter for both packages' kernel switches; resets both."""
    def set_both(on: bool):
        jax_kernels.enable_pallas(on, interpret=True)
        torch_kernels.enable_kernels(on)
    try:
        yield set_both
    finally:
        jax_kernels.enable_pallas(False, interpret=False)
        torch_kernels.enable_kernels(False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen3-0.6b_smoke"])
def test_config_fields_match_jax(name):
    ours, theirs = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.head_dim, ours.n_units, ours.supports_decode) == (
        theirs.head_dim, theirs.n_units, theirs.supports_decode)


def test_primitives_match_jax_bitwise():
    """rms_norm, RoPE, silu, gelu and dense round exactly where JAX does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32) * 2
    w = rng.standard_normal((16,)).astype(np.float32)
    W = rng.standard_normal((16, 24)).astype(np.float32) * 0.25
    xj, wj, Wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, W))
    xt, wt, Wt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, W))
    cj, sj = jl.rope_cos_sin(jnp.arange(6) + 300, 16, 1e6)
    ct, st = tl.rope_cos_sin(torch.arange(6) + 300, 16, 1e6)
    pairs = [
        (jl.rms_norm(xj, wj), tl.rms_norm(xt, wt)),
        (jl.apply_rope(xj, cj, sj), tl.apply_rope(xt, ct, st)),
        (jax.nn.silu(xj), tl.act_fn("silu")(xt)),
        (jax.nn.gelu(xj), tl.act_fn("gelu")(xt)),
        (jl.dense({"w": Wj}, xj), tl.dense(xt, Wt)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_logits_match_jax(dtype, kernels_on, kernel_switches):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(0, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    kernel_switches(kernels_on)
    want, _ = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)}, remat=False)
    with torch.no_grad():
        got, aux = forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=LOGIT_TOL[dtype])


def test_untied_biased_gelu_variant_matches_jax():
    """The layer options qwen3 leaves off (qkv bias, an lm_head, a plain
    gelu MLP) convert and compute like JAX's."""
    kw = dict(qkv_bias=True, tie_embeddings=False, act="gelu")
    jcfg = dataclasses.replace(jax_get_config(ARCH), **kw)
    cfg = dataclasses.replace(get_config(ARCH), **kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3))
    jp["units"]["b0"]["attn"]["wq"]["b"] = jnp.full_like(jp["units"]["b0"]["attn"]["wq"]["b"], 0.5)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert model.blocks[0].ffn.gate is None
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    want, _ = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)}, remat=False)
    with torch.no_grad():
        got, _ = forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    # the untied head at 1/sqrt(d_model) scale gives logits up to ~4: the
    # bf16 tolerance is per unit of the largest logit
    atol = LOGIT_TOL["bfloat16"] * max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.mark.parametrize("kernels_on", [False, True])
def test_decode_logits_match_jax(kernels_on, kernel_switches):
    """Four decode steps over a KV cache, bf16 weights."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(1, "bfloat16")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 4))
    kernel_switches(kernels_on)
    jcache, cache = jm.init_cache(jcfg, 2, 16), init_cache(cfg, 2, 16, "cpu")
    for t in range(4):
        want, jcache = jm.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                      jnp.int32(t))
        got, cache = decode_step(cfg, model, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=LOGIT_TOL["bfloat16"])
    # the cache was written in place: slots 0..3 filled, the rest still zero
    k0 = cache[0]["k"]
    assert torch.count_nonzero(k0[:, :4]) > 0 and torch.count_nonzero(k0[:, 4:]) == 0
    np.testing.assert_array_equal(_np(k0), _np(jcache["units"]["b0"]["k"][0]))


def test_decode_past_the_cache_raises():
    cfg = get_config(ARCH)
    _, model = jax_and_torch_params(1, "bfloat16")
    cache = init_cache(cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="cache of 4 slots"):
        decode_step(cfg, model, cache, torch.zeros((1, 1), dtype=torch.long), 4)


def test_params_from_jax_maps_every_leaf():
    jp, model = jax_and_torch_params(2, "bfloat16")
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    np.testing.assert_array_equal(
        _np(model.blocks[1].attn.wq.w), _np(jp["units"]["b0"]["attn"]["wq"]["w"][1]))


@pytest.mark.parametrize("over", [{"block_pattern": ("mlstm", "slstm")},
                                  {"frontend": "vision_stub"}, {"frontend": "audio_stub"}])
def test_formerly_unported_variants_build(over):
    """qwen3's smoke config with xLSTM blocks or a stub frontend builds (it
    raised NotImplementedError before those were ported), leaf for leaf
    with the JAX init's parameter count."""
    cfg = dataclasses.replace(get_config(ARCH), d_frontend=32, **over)
    jcfg = dataclasses.replace(jax_get_config(ARCH), d_frontend=32, **over)
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k), jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in Model(cfg, generator=None, device="meta").parameters()) == n_jax


# --------------------------------------------------------------------- #
# MoE and MLA: deepseek-v2-lite (1 dense MLA prefix layer, then MLA + MoE)
# and qwen2-moe (GQA with qkv bias + MoE, d_ff = 0)
# --------------------------------------------------------------------- #
MOE_ARCHS = ["deepseek-v2-lite-16b_smoke", "qwen2-moe-a2.7b_smoke"]


def moe_params(arch, seed, dtype, **over):
    """JAX params and the port's model of ``arch`` (fields ``over``
    replaced in both configs), float32 casting the bf16 init."""
    jcfg = dataclasses.replace(jax_get_config(arch), **over)
    cfg = dataclasses.replace(get_config(arch), **over)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        model = model.float()
    return jcfg, cfg, jp, model


def _per_largest_logit(want, dtype) -> float:
    """The bf16 logit tolerance per unit of the largest logit (float32: as is)."""
    scale = max(1.0, float(np.abs(_np(want)).max())) if dtype == "bfloat16" else 1.0
    return LOGIT_TOL[dtype] * scale


@pytest.fixture
def jax_routes(monkeypatch):
    """Records the expert indices of every ``moe_apply`` call of the JAX
    model, op by op (``jax.disable_jit``: ``lax.scan`` runs its body
    eagerly), in layer order."""
    from repro.models import moe as jmoe
    from repro.models.layers import dense as jdense

    routes, orig = [], jmoe.moe_apply

    def spy(p, cfg, x, **kw):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jdense(p["router"], xt).astype(jnp.float32), axis=-1)
        routes.append(np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
        return orig(p, cfg, x, **kw)

    monkeypatch.setattr(jmoe, "moe_apply", spy)
    with jax.disable_jit():
        yield routes


def torch_routes(model):
    """Hooks recording the expert indices of every ``MoE`` call, in call
    order; returns (routes, handles)."""
    from repro_torch.models.moe import MoE

    routes = []

    def hook(m, args, out):
        routes.append(m.route(args[0].reshape(-1, args[0].shape[-1]))[1].numpy())

    return routes, [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, MoE)]


def test_moe_configs_build_every_layer():
    """``first_k_dense`` prefix layers sit outside the units: deepseek has
    1 + 26 attention layers, not 1 + 27; qwen2-moe (d_ff = 0) gets a MoE
    in each of its 24."""
    for name, prefix, units in (("deepseek-v2-lite-16b", 1, 26), ("qwen2-moe-a2.7b", 0, 24)):
        cfg = get_config(name)
        model = Model(cfg, generator=None, device="meta")
        assert (len(model.prefix), len(model.blocks)) == (prefix, units)
        assert prefix + units == cfg.n_layers
        assert all(b.moe is not None and b.ffn is None for b in model.blocks)
        assert all(b.moe is None and b.ffn is not None for b in model.prefix)
        assert all(type(b.attn).__name__ == ("MLA" if cfg.use_mla else "Attention")
                   for b in [*model.prefix, *model.blocks])
        assert len(init_cache(cfg, 1, 4, "meta")) == cfg.n_layers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_from_jax_maps_every_leaf(arch):
    jcfg, cfg, jp, model = moe_params(arch, 4, "bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for _, a in leaves)
    for path, arr in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]
        if keys[0] == "units":
            for i in range(arr.shape[0]):
                t = model.get_parameter(".".join(["blocks", str(i), *keys[2:]]))
                np.testing.assert_array_equal(_np(t), _np(arr[i]))
        else:
            np.testing.assert_array_equal(_np(model.get_parameter(".".join(keys))), _np(arr))
    assert ("prefix" in jp) == bool(cfg.first_k_dense)


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_aux_and_loss_match_jax(arch, dtype, kernels_on, kernel_switches):
    """Logits, the summed router aux loss and ``loss_fn``, with capacity
    dropping on (``forward`` is not dropless). In bf16 the reference is
    JAX op by op: under ``lax.scan`` XLA fuses the unit and skips bf16
    roundings, which moves these logits by up to 0.055 (ROADMAP C, as for
    zamba2); op by op the two agree to 0.004. The untied heads give logits
    up to ~4.5, so the tolerance is per unit of the largest logit, as for
    the untied variant above (kernels on: the two kernels' plain versions
    round P to bf16 at other points, up to 0.055 measured)."""
    jcfg, cfg, jp, model = moe_params(arch, 0, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    batch_j, batch_t = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    kernel_switches(kernels_on)
    with jax.disable_jit(dtype == "bfloat16"):
        want, want_aux = jm.forward(jcfg, jp, batch_j, remat=False)
        want_loss = jm.loss_fn(jcfg, jp, batch_j, remat=False)
    with torch.no_grad():
        got, aux = forward(cfg, model, batch_t)
        loss = loss_fn(cfg, model, batch_t)
    assert got.shape == (2, 24, cfg.vocab) and float(aux) > 0
    atol = _per_largest_logit(want, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)
    # f32: the routes are equal (test_moe_routes_equal_jax). bf16: the bf16
    # router logits tie, so one token's top-1 and top-2 may trade places
    # (same experts, other order), moving aux by E * coef * |P_a - P_b| / T
    # at most E * coef / T (measured with kernels on: 1.8e-5 of 0.03)
    T = toks.size
    aux_tol = dict(rtol=1e-5) if dtype == "float32" else dict(
        rtol=0, atol=cfg.n_routed_experts * cfg.router_aux_coef / T)
    np.testing.assert_allclose(float(aux), float(want_aux), **aux_tol)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0, atol=LOGIT_TOL[dtype])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routes_equal_jax(arch, jax_routes):
    """Every layer's expert indices, forward and four decode steps, equal
    JAX's (float32 weights: no bf16 router ties to break by rounding)."""
    jcfg, cfg, jp, model = moe_params(arch, 2, "float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    routes, hooks = torch_routes(model)
    jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)}, remat=False)
    with torch.no_grad():
        forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    jcache, cache = jm.init_cache(jcfg, 2, 8), init_cache(cfg, 2, 8, "cpu")
    for t in range(4):
        jcache = jm.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                jnp.int32(t))[1]
        decode_step(cfg, model, cache, torch.from_numpy(toks[:, t:t + 1]), t)
    for h in hooks:
        h.remove()
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert len(routes) == len(jax_routes) == 5 * n_moe
    for got, want in zip(routes, jax_routes):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_logits_match_jax(arch, kernels_on, kernel_switches):
    """Four dropless decode steps over the (MLA or GQA) caches, bf16,
    against JAX op by op (see the forward test)."""
    jcfg, cfg, jp, model = moe_params(arch, 1, "bfloat16")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 4))
    kernel_switches(kernels_on)
    jcache, cache = jm.init_cache(jcfg, 2, 16), init_cache(cfg, 2, 16, "cpu")
    for t in range(4):
        with jax.disable_jit():
            want, jcache = jm.decode_step(jcfg, jp, jcache,
                                          jnp.asarray(toks[:, t:t + 1], jnp.int32), jnp.int32(t))
        got, cache = decode_step(cfg, model, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=_per_largest_logit(want, "bfloat16"))
    # the prefix layers' caches come first, in layer order
    jc = [*jcache.get("prefix", []),
          *({k: v[i] for k, v in jcache["units"]["b0"].items()} for i in range(
              cfg.n_layers - cfg.first_k_dense))]
    assert [sorted(c) for c in cache] == [sorted(c) for c in jc]
    # the first layer's entries within one bf16 ulp; later layers' inherit
    # the activations' bf16 noise: the logits' tolerance per largest entry
    for i, (c, want) in enumerate(zip(cache, jc)):
        for name in c:
            tol = dict(rtol=2.0 ** -7, atol=0) if i == 0 else dict(
                rtol=0, atol=_per_largest_logit(want[name], "bfloat16"))
            np.testing.assert_allclose(_np(c[name]), _np(want[name]), **tol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward(arch):
    """The twin of ``tests/test_arch_smoke.py::test_decode_matches_forward``:
    eight dropless decode steps against one forward with capacity >= E
    (so the forward drops nothing either), float32 weights, 2e-3."""
    _, cfg, _, model = moe_params(arch, 0, "float32", capacity_factor=100.0)
    assert cfg.capacity_factor >= cfg.n_routed_experts
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        full, _ = forward(cfg, model, {"tokens": toks})
    cache = init_cache(cfg, 2, 16, "cpu")
    for c in cache:
        for k in c:
            c[k] = c[k].float()
    steps = [decode_step(cfg, model, cache, toks[:, t:t + 1], t)[0] for t in range(8)]
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full), rtol=2e-3, atol=2e-3)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), f"{f}:{node.lineno} {mod}"
    code = ("import sys, repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.models.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
