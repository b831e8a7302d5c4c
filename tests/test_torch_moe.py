"""The port's Mixture-of-Experts FFN against ``repro.models.moe.moe_apply``.

Weights come from the JAX init (``init_moe``) and are loaded by name into
the port's ``MoE``; activations come from a seeded numpy generator. Both
packages route in float32 (router logits, softmax, top-k, renormalised
gates), so the expert indices must be equal. The router's logits are
bf16 in the bf16 case, so exact ties of two probabilities occur (the test
checks that some do): both packages put the lower expert index first
(``lax.top_k``'s order; the port sorts stably). Tolerances:

* gates and router probabilities: 1e-6 absolute (two f32 softmax
  implementations, a few ulps of values below 1);
* aux loss: 1e-6 relative;
* y, bf16 without shared experts: bit for bit. The dispatch copies, the
  three batched products round once per output element in both
  frameworks, and the combine adds each token's k contributions left to
  right, as the reference's ``.at[tok_of].add`` does;
* y, bf16 with shared experts: one bf16 ulp of the largest |y| (2^-8
  there): the shared SwiGLU's elementwise steps round one element in
  ~1000 the other way (measured: 1-2 elements of 1536);
* y, float32: 1e-6 absolute. The products' f32 sums run in another order
  (XLA's dot against torch's ``bmm``): ~2e-7 measured.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models.convert import layer_from_jax
from repro_torch.models.moe import MoE

ARCHS = ["deepseek-v2-lite-16b_smoke", "qwen2-moe-a2.7b_smoke"]
B, S = 2, 12


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _setup(arch, seed, dtype, **over):
    jcfg = dataclasses.replace(jax_get_config(arch), **over)
    cfg = dataclasses.replace(get_config(arch), **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    jp = jax.tree.map(lambda a: a.astype(jdt), jp)
    model = layer_from_jax(MoE, jax.tree.map(np.asarray, jp), cfg, "cpu")
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, model, jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)


def _jax_route(jp, jcfg, xj):
    xt = xj.reshape(-1, xj.shape[-1])
    probs = jax.nn.softmax(jl.dense(jp["router"], xt).astype(jnp.float32), axis=-1)
    gates, eidx = jax.lax.top_k(probs, jcfg.top_k)
    return gates / jnp.sum(gates, axis=-1, keepdims=True), eidx, probs


def _dropped(cfg, eidx, dropless):
    """Assignments past capacity, counted from the routes (numpy)."""
    T = eidx.shape[0]
    C = T * cfg.top_k if dropless else max(1, int(np.ceil(T * cfg.top_k * cfg.capacity_factor
                                                         / cfg.n_routed_experts)))
    counts = np.bincount(eidx.reshape(-1), minlength=cfg.n_routed_experts)
    return int(np.maximum(counts - C, 0).sum())


# (dropless, capacity_factor, shared experts): capacity 0.5 overflows
CASES = [(True, 1.25, True), (False, 1.25, True), (False, 0.5, True),
         (True, 1.25, False), (False, 0.5, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("dropless,capacity_factor,shared", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_moe_apply(arch, dropless, capacity_factor, shared, dtype):
    over = dict(capacity_factor=capacity_factor)
    if not shared:
        over["n_shared_experts"] = 0
    jcfg, cfg, jp, model, xj, xt = _setup(arch, 3, dtype, **over)
    assert (model.shared is None) == (not shared) == ("shared" not in jp)

    want_g, want_e, want_p = _jax_route(jp, jcfg, xj)
    got_g, got_e, got_p = model.route(xt.reshape(-1, cfg.d_model))
    top = np.sort(_np(want_p), axis=-1)[:, ::-1]
    if dtype == torch.bfloat16:  # ties at or next to the k chosen: their order is tested
        assert (top[:, :cfg.top_k] == top[:, 1:cfg.top_k + 1]).any()
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(_np(got_g), _np(want_g), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(got_p), _np(want_p), rtol=0, atol=1e-6)

    want_y, want_aux = jmoe.moe_apply(jp, jcfg, xj, dropless=dropless)
    with torch.no_grad():
        got_y, got_aux = model(xt, dropless=dropless)
    if capacity_factor == 0.5:
        assert _dropped(cfg, np.asarray(want_e), dropless) > 0, "the overflow case dropped nothing"
    assert got_y.shape == (B, S, cfg.d_model) and got_y.dtype == dtype
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    if dtype == torch.bfloat16 and not shared:
        np.testing.assert_array_equal(_np(got_y), _np(want_y))
    else:
        atol = (2.0 ** -8 * max(1.0, float(np.abs(_np(want_y)).max()))
                if dtype == torch.bfloat16 else 1e-6)
        np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=0, atol=atol)


def test_dropped_assignments_contribute_nothing():
    """With capacity 1 per expert, only the first assignment of each expert
    in (token, slot) order is kept: y is the shared experts plus those."""
    arch = ARCHS[1]
    jcfg, cfg, jp, model, xj, xt = _setup(arch, 5, torch.float32, capacity_factor=1e-3,
                                          n_shared_experts=0)
    with torch.no_grad():
        y, _ = model(xt)
        gates, eidx, _ = model.route(xt.reshape(-1, cfg.d_model))
    flat = eidx.reshape(-1).tolist()
    first = {e: i for i, e in reversed(list(enumerate(flat)))}  # expert -> first assignment
    kept_tokens = {i // cfg.top_k for i in first.values()}
    y = y.reshape(-1, cfg.d_model)
    for t in range(y.shape[0]):
        assert bool(y[t].abs().sum() > 0) == (t in kept_tokens)
    want, _ = jmoe.moe_apply(jp, jcfg, xj)
    np.testing.assert_allclose(_np(y), _np(want).reshape(-1, cfg.d_model), rtol=0, atol=1e-6)
