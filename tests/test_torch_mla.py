"""The port's MLA attention against ``repro.models.layers.mla_apply``.

Weights come from the JAX init (``init_mla``) of ``deepseek-v2-lite-16b_smoke``
(4 heads of nope 16 + rope 8, v 16, latent rank 32) and are loaded by name;
activations come from a seeded numpy generator. Kernels off and on: the
JAX side runs its Pallas kernel in interpret mode, the port its kernel's
plain version (the CPU path of the flash-attention op). Tolerances:

* bf16 weights: 2e-2 absolute on outputs of magnitude ~1, as for the
  port's GQA attention (``tests/test_torch_model.py``): the frameworks
  round a few intermediate bf16 results differently;
* float32 weights: 1e-4 absolute (the bf16 cache entries are equal, the
  f32 sums run in other orders);
* the caches: the latent and the rope key written at each step are bit for
  bit JAX's in float32 weights, and within one bf16 ulp in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jax_kernels
from repro.configs.base import get_config as jax_get_config
from repro.models import layers as jl
from repro_torch import kernels as torch_kernels
from repro_torch.configs import get_config
from repro_torch.models.convert import layer_from_jax
from repro_torch.models import layers as tl
from repro_torch.models.layers import MLA

ARCH = "deepseek-v2-lite-16b_smoke"
B, S, SMAX = 2, 10, 16
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def kernel_switches():
    def set_both(on: bool):
        jax_kernels.enable_pallas(on, interpret=True)
        torch_kernels.enable_kernels(on)
    try:
        yield set_both
    finally:
        jax_kernels.enable_pallas(False, interpret=False)
        torch_kernels.enable_kernels(False)


def _setup(seed, dtype):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jp = jax.tree.map(lambda a: a.astype(jdt), jl.init_mla(jax.random.PRNGKey(seed), jcfg))
    model = layer_from_jax(MLA, jax.tree.map(np.asarray, jp), cfg, "cpu")
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, model, x, jdt


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mla_forward_matches_jax(dtype, kernels_on, kernel_switches):
    jcfg, cfg, jp, model, x, jdt = _setup(0, dtype)
    kernel_switches(kernels_on)
    want, none = jl.mla_apply(jp, jcfg, jnp.asarray(x).astype(jdt), jnp.arange(S))
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(dtype), torch.arange(S))
    assert none is None and got.shape == (B, S, cfg.d_model) and got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mla_decode_steps_and_caches_match_jax(dtype, kernels_on, kernel_switches):
    """A 3-token prefill into the cache, then four one-token steps: the
    outputs and the ``ckv``/``krope`` caches after every call."""
    jcfg, cfg, jp, model, x, jdt = _setup(1, dtype)
    kernel_switches(kernels_on)
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    jcache = {"ckv": jnp.zeros((B, SMAX, r), jnp.bfloat16),
              "krope": jnp.zeros((B, SMAX, dr), jnp.bfloat16)}
    cache = {"ckv": torch.zeros((B, SMAX, r), dtype=torch.bfloat16),
             "krope": torch.zeros((B, SMAX, dr), dtype=torch.bfloat16)}
    ulp = 0 if dtype == torch.float32 else 2.0 ** -7
    for start, n in ((0, 3), (3, 1), (4, 1), (5, 1), (6, 1)):
        xs = x[:, start:start + n]
        want, jcache = jl.mla_apply(jp, jcfg, jnp.asarray(xs).astype(jdt),
                                    start + jnp.arange(n), jcache, start)
        with torch.no_grad():
            got = model(torch.from_numpy(xs).to(dtype), start + torch.arange(n), cache, start)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
        for name in ("ckv", "krope"):
            w = _np(jcache[name])
            np.testing.assert_allclose(_np(cache[name]), w, rtol=ulp, atol=0)
    # written in place up to position 7, zero past it
    assert torch.count_nonzero(cache["ckv"][:, 7:]) == 0
    assert torch.count_nonzero(cache["ckv"][:, :7]) > 0


def test_mla_decode_past_the_cache_raises():
    _, cfg, _, model, x, _ = _setup(2, torch.bfloat16)
    cache = {"ckv": torch.zeros((B, 4, cfg.kv_lora_rank), dtype=torch.bfloat16),
             "krope": torch.zeros((B, 4, cfg.rope_head_dim), dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="cache of 4 slots"):
        model(torch.from_numpy(x[:, :2]).to(torch.bfloat16), torch.arange(3, 5), cache, 3)


def test_mla_shares_one_rope_key_across_heads(monkeypatch):
    """The key ``mha`` gets holds one rope key for all heads (the reference's
    ``broadcast_to``), after each head's own nope part."""
    _, cfg, _, model, x, _ = _setup(3, torch.float32)
    seen = {}

    def spy(q, k, v, **kw):
        seen["k"] = k
        return orig(q, k, v, **kw)

    orig = tl.mha
    monkeypatch.setattr(tl, "mha", spy)
    with torch.no_grad():
        model(torch.from_numpy(x[:, :4]), torch.arange(4))
    k, dn = seen["k"], cfg.nope_head_dim
    assert k.shape == (B, 4, cfg.n_heads, dn + cfg.rope_head_dim)
    assert torch.equal(k[..., dn:], k[:, :, :1, dn:].expand_as(k[..., dn:]))
    assert not torch.equal(k[:, :, 0, :dn], k[:, :, 1, :dn])
