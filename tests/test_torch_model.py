"""The port's qwen3 model against the JAX package on the CPU.

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
from repro_torch.models import decode_step, forward, init_cache
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


def test_unported_configs_raise():
    base = get_config(ARCH)
    for cfg in (dataclasses.replace(base, block_pattern=("mlstm",)),
                dataclasses.replace(base, n_routed_experts=4, top_k=2),
                dataclasses.replace(base, use_mla=True)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            Model(cfg, generator=None, device="meta")


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
