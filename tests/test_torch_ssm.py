"""The port's Mamba-2 block and the zamba2 model against the JAX package on
the CPU, at ``zamba2-2.7b_smoke``.

Weights are drawn once by JAX and converted with ``params_from_jax``;
inputs come from seeded numpy. Tolerances, stated once:

* the conv primitives are bitwise: both round every bf16 step alike;
* softplus in f32: 2 ulps, 4.8e-7 relative (XLA's exp/log1p differ from
  torch's by one);
* one Mamba-2 block in bf16: 1 bf16 ulp of its largest output, 2^-8 of
  it; in f32, 1e-5;
* model logits in f32: 1e-4. Decode with kernels on, and decode against
  the full pass: 1e-2, because the KV cache is bf16 and P meets it in bf16,
  rounded after normalising in the plain version and before in JAX's
  kernel (one bf16 rounding, 2^-8 relative, of attention outputs);
* model logits in bf16: 5% of the largest logit. JAX's forward runs the
  unit under ``lax.scan``, where XLA fuses elementwise chains and skips
  bf16 roundings that its own op-by-op evaluation makes; on these weights
  JAX's jitted logits differ from JAX's op-by-op logits by up to 3.4% of
  the largest. The port rounds op by op and is held to 1% of the largest
  logit against JAX's op-by-op blocks (``test_zamba2_blocks_match_jax_op_by_op``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jax_kernels
from repro.configs.base import get_config as jax_get_config
from repro.models import model as jm
from repro.models import ssm as js
from repro_torch import kernels as torch_kernels
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_cache, loss_fn
from repro_torch.models import model as tm
from repro_torch.models import ssm as ts
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

ARCH = "zamba2-2.7b_smoke"
BF16_LOGIT_REL = 0.05
F32_LOGIT_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


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


@pytest.mark.parametrize("name", ["zamba2-2.7b", "zamba2-2.7b_smoke"])
def test_config_fields_match_jax(name):
    ours, theirs = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.d_inner, ours.n_ssm_heads, ours.n_units, ours.subquadratic) == (
        theirs.d_inner, theirs.n_ssm_heads, theirs.n_units, theirs.subquadratic)


def test_full_width_parameter_count_matches_jax():
    """zamba2-2.7b at full width: 2.90 B parameters, leaf by leaf as
    ``init_params`` builds them (shapes only: meta tensors, eval_shape)."""
    cfg = get_config("zamba2-2.7b")
    shapes = jax.eval_shape(lambda k: jm.init_params(jax_get_config("zamba2-2.7b"), k),
                            jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in Model(cfg, generator=None, device="meta").parameters())
    assert n_port == n_jax and round(n_port / 1e9, 2) == 2.90


def test_conv_primitives_match_jax_bitwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.1
    b = rng.standard_normal((24,)).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    xj, wj, bj, sj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b, st))
    xt, wt, bt, stt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b, st))
    np.testing.assert_array_equal(_np(ts.causal_conv1d(xt, wt, bt)),
                                  _np(js.causal_conv1d(xj, wj, bj)))
    (win_j, y_j), (win_t, y_t) = js.conv_step(sj, xj[:, 0], wj, bj), ts.conv_step(stt, xt[:, 0], wt, bt)
    np.testing.assert_array_equal(_np(y_t), _np(y_j))
    np.testing.assert_array_equal(_np(win_t), _np(win_j))


def test_softplus_matches_jax():
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 8
    got, want = ts.softplus(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.softplus(x))
    np.testing.assert_allclose(got, want, rtol=4.8e-7, atol=0)


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba2_apply_matches_jax(dtype, kernels_on, kernel_switches):
    """One Mamba-2 block, full-sequence pass (the kernel switch routes the
    SSD through the op) and a decode step from its final cache."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(0, dtype)
    pj = jax.tree.map(lambda a: a[0], jp["units"]["b0"]["core"])
    pt = model.blocks[0].core
    u = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    uj, ut = jnp.asarray(u).astype(getattr(jnp, dtype)), torch.from_numpy(u).to(getattr(torch, dtype))
    kernel_switches(kernels_on)
    want, _ = js.mamba2_apply(pj, jcfg, uj)
    with torch.no_grad():
        got, cache = ts.mamba2_apply(pt, cfg, ut)
    assert cache is None and got.dtype == ut.dtype
    tol = 2.0 ** -8 * float(np.abs(_np(want)).max()) if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)

    # three decode steps through the recurrent branch
    jc, tc = js.init_mamba2_cache(jcfg, 2), ts.init_mamba2_cache(cfg, 2, "cpu")
    for t in range(3):
        want, jc = js.mamba2_apply(pj, jcfg, uj[:, t:t + 1], jc)
        with torch.no_grad():
            got, tc = ts.mamba2_apply(pt, cfg, ut[:, t:t + 1], tc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
        np.testing.assert_allclose(_np(tc["state"]), _np(jc["state"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_zamba2_forward_and_loss_match_jax(dtype, kernels_on, kernel_switches):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(0, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    kernel_switches(kernels_on)
    jb, tb = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    want, _ = jm.forward(jcfg, jp, jb, remat=False)
    with torch.no_grad():
        got, aux = forward(cfg, model, tb)
        loss = loss_fn(cfg, model, tb)
    assert got.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    tol = BF16_LOGIT_REL * float(np.abs(_np(want)).max()) if dtype == "bfloat16" else F32_LOGIT_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    # the loss is a mean over 62 positions: the logit differences average
    # out to ~2e-3 in bf16 (JAX's jitted vs op-by-op rounding again)
    want_loss = float(jm.loss_fn(jcfg, jp, jb))
    assert abs(float(loss) - want_loss) <= (5e-3 if dtype == "bfloat16" else 1e-5)


def test_zamba2_blocks_match_jax_op_by_op():
    """bf16 weights: each block and the logits against JAX's blocks applied
    one by one (no scan, so no fusion across the unit); 1% of the largest
    logit."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(1, "bfloat16")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 32))
    xj = jp["embed"][jnp.asarray(toks)]
    pos = jnp.arange(32)
    for j, kind in enumerate(jcfg.block_pattern):
        xj, _, _ = jm.apply_block(jcfg, kind, jax.tree.map(lambda a: a[0], jp["units"][f"b{j}"]),
                                  xj, pos, None, None)
    want = jm.lm_logits(jcfg, jp, xj)
    with torch.no_grad():
        got, _ = forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=0.01 * float(np.abs(_np(want)).max()))


@pytest.mark.parametrize("kernels_on", [False, True])
def test_zamba2_decode_logits_match_jax(kernels_on, kernel_switches):
    """Four decode steps over the attention KV cache and the Mamba-2 conv
    windows and states, f32 weights (the KV cache is bf16)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(2, "float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 4))
    kernel_switches(kernels_on)
    jcache, cache = jm.init_cache(jcfg, 2, 16), init_cache(cfg, 2, 16, "cpu")
    assert [set(c) for c in cache[:2]] == [{"conv_x", "conv_B", "conv_C", "state"}] * 2
    for t in range(4):
        want, jcache = jm.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                      jnp.int32(t))
        got, cache = decode_step(cfg, model, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=1e-2 if kernels_on else F32_LOGIT_TOL)
    np.testing.assert_allclose(_np(cache[0]["state"]), _np(jcache["units"]["b0"]["state"][0]),
                               rtol=1e-5, atol=1e-6)


def test_decode_continues_the_full_sequence_pass():
    """The recurrent decode after a prefix equals the full pass over it,
    for the port alone (f32 weights, bf16 KV cache): the two Mamba-2
    branches agree."""
    cfg = get_config(ARCH)
    _, model = jax_and_torch_params(3, "float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        full, _ = forward(cfg, model, {"tokens": toks})
    cache = init_cache(cfg, 2, 8, "cpu")
    for t in range(8):
        step, cache = decode_step(cfg, model, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(step), _np(full[:, t]), rtol=0, atol=1e-2)


def test_params_from_jax_maps_every_leaf_with_its_dtype():
    jp, model = jax_and_torch_params(4, "bfloat16")
    cfg = get_config(ARCH)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for _, a in leaves)
    P = len(cfg.block_pattern)
    for path, arr in leaves:
        keys = [k.key for k in path]
        if keys[0] == "units":
            j = int(keys[1][1:])
            for i in range(cfg.n_units):
                t = model.get_parameter(".".join(["blocks", str(i * P + j), *keys[2:]]))
                assert t.dtype == (torch.float32 if arr.dtype == jnp.float32 else torch.bfloat16)
                np.testing.assert_array_equal(_np(t), _np(arr[i]))
        else:
            np.testing.assert_array_equal(_np(model.get_parameter(".".join(keys))), _np(arr))
    core = model.blocks[0].core
    assert {core.A_log.dtype, core.D.dtype, core.dt_bias.dtype} == {torch.float32}
    assert core.in_x.w.dtype == torch.bfloat16


def test_init_params_dtypes_and_layout():
    cfg = get_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    model = tm.init_params(cfg, gen, "cpu")
    kinds = [type(b).__name__ for b in model.blocks]
    assert kinds == ["Mamba2Block"] * 5 + ["Block"]
    core = model.blocks[0].core
    assert core.A_log.dtype == core.D.dtype == core.dt_bias.dtype == torch.float32
    assert torch.equal(core.D.detach(), torch.ones(cfg.n_ssm_heads))
    assert torch.count_nonzero(core.A_log.detach()) == 0


def test_remat_save_block_outputs_raises():
    """``save_block_outputs`` is ported (its grads: test_torch_train.py);
    a policy that is neither it nor ``full`` raises, naming both."""
    cfg = get_config(ARCH)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    logits, _ = forward(cfg, model, batch, remat_policy="save_block_outputs")
    assert torch.equal(logits, forward(cfg, model, batch)[0])
    with pytest.raises(ValueError, match="save_block_outputs"):
        forward(cfg, model, batch, remat_policy="save_block_output")
