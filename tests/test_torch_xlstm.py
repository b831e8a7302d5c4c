"""The port's mLSTM and sLSTM blocks and the xlstm model against the JAX
package on the CPU, at ``xlstm-1.3b_smoke`` (6 layers: 5 mLSTM + 1 sLSTM,
d 64, 4 heads, d_inner 128).

Weights are drawn once by JAX and converted with ``params_from_jax``;
inputs come from seeded numpy. Tolerances, stated once:

* one mLSTM or sLSTM block in float32, chunked and recurrent, and the
  decode caches (C, n, m; c, n, h, m): 1e-5 of the largest |output| (f32
  sums in other orders: 1.5e-6 of 5.4 measured);
* one block in bf16: 1 bf16 ulp of its largest output, 2^-8 of it (the
  chunked mLSTM differs by at most one rounding of the bf16 output; the
  recurrent steps and the sLSTM agree bit for bit);
* model logits in float32: 1e-4; in bf16, against JAX op by op
  (``jax.disable_jit``: under ``lax.scan`` XLA fuses the unit and skips
  bf16 roundings, ROADMAP C): 3% of the largest logit. Each block fed
  JAX's own input agrees within 2^-8 of its largest output (teacher
  forced, below), but chained through six layers the one-ulp differences
  grow to 1.6% of the residual stream and 2.0% of the largest logit
  (measured);
* decode against the port's own chunked forward, float32 weights: 2e-3,
  ``tests/test_arch_smoke.py::test_decode_matches_forward``'s bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import model as jm
from repro.models import ssm as js
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_cache, loss_fn
from repro_torch.models import model as tm
from repro_torch.models import ssm as ts
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

ARCH = "xlstm-1.3b_smoke"
BLOCK_F32_REL = 1e-5
F32_LOGIT_TOL = 1e-4
BF16_LOGIT_REL = 0.03
DECODE_TOL = 2e-3


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


def _block_tol(want, dtype) -> float:
    scale = float(np.abs(_np(want)).max())
    return (2.0 ** -8 if dtype == "bfloat16" else BLOCK_F32_REL) * scale


@pytest.mark.parametrize("name", ["xlstm-1.3b", "xlstm-1.3b_smoke"])
def test_config_fields_match_jax(name):
    ours, theirs = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.d_inner, ours.n_units, ours.supports_decode) == (
        theirs.d_inner, theirs.n_units, theirs.supports_decode)


def test_full_width_parameter_count_matches_jax():
    """xlstm-1.3b at full width: 3.49 B parameters, leaf by leaf as JAX's
    ``init_params`` builds them (meta tensors against ``jax.eval_shape``).
    The config's name and ``num_params`` (1.21 B) count the mLSTM's q, k
    and v as d x d; the reference's init makes them d_inner x d_inner."""
    shapes = jax.eval_shape(lambda k: jm.init_params(jax_get_config("xlstm-1.3b"), k),
                            jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = Model(get_config("xlstm-1.3b"), generator=None, device="meta")
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_jax and round(n_port / 1e9, 2) == 3.49


def test_init_params_layout_and_caches():
    cfg = get_config(ARCH)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [type(b).__name__ for b in model.blocks] == ["MLSTMBlock"] * 5 + ["SLSTMBlock"]
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    cache = init_cache(cfg, 2, 16, "cpu")
    dh = cfg.d_inner // cfg.n_heads
    assert cache[0]["C"].shape == (2, cfg.n_heads, dh, dh) and cache[0]["C"].dtype == torch.float32
    assert cache[0]["conv"].shape == (2, cfg.conv_width - 1, cfg.d_inner)
    assert set(cache[5]) == {"c", "n", "h", "m"}
    for c in (cache[0], cache[5]):  # the stabilisers start at -1e30, not 0 and not -inf
        assert torch.all(c["m"] == -1e30)
    jcache = jm.init_cache(jax_get_config(ARCH), 2, 16)
    for i, c in enumerate(cache[:6]):
        for k, t in c.items():
            np.testing.assert_array_equal(_np(t), _np(jcache["units"][f"b{i}"][k][0]))


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
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(_np(t), _np(arr[i]))
        else:
            np.testing.assert_array_equal(_np(model.get_parameter(".".join(keys))), _np(arr))


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("nc", [1, 2])
def test_mlstm_chunked_matches_jax(nc, with_init):
    """``_mlstm_chunked`` alone in float32: one chunk, and two (the chunk
    carry); from m = -inf (no init) and from a carried (C, n, m)."""
    b, cl, nh, dh = 2, 16, 3, 8
    rng = np.random.default_rng(nc + 2 * with_init)
    q, k, v = (rng.standard_normal((b, nc * cl, nh, dh)).astype(np.float32) for _ in range(3))
    ilog = rng.standard_normal((b, nc * cl, nh)).astype(np.float32)
    flog = -np.log1p(np.exp(-rng.standard_normal((b, nc * cl, nh)))).astype(np.float32)
    init = None
    if with_init:
        init = (rng.standard_normal((b, nh, dh, dh)).astype(np.float32),
                rng.standard_normal((b, nh, dh)).astype(np.float32),
                rng.standard_normal((b, nh)).astype(np.float32))
    args = (q, k, v, ilog, flog)
    want, wstate = js._mlstm_chunked(*map(jnp.asarray, args), chunk=cl,
                                     init=None if init is None else tuple(map(jnp.asarray, init)))
    got, gstate = ts._mlstm_chunked(*map(torch.from_numpy, args), chunk=cl,
                                    init=None if init is None else tuple(map(torch.from_numpy, init)))
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=_block_tol(want, "float32"))
    for g, w in zip(gstate, wstate):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=_block_tol(w, "float32"))


def test_mlstm_chunk_must_divide_the_sequence():
    _, model = jax_and_torch_params(0, "float32")
    cfg = get_config(ARCH)
    u = torch.zeros((1, 48, cfg.d_model))
    with pytest.raises(ValueError, match="% chunk"):
        ts.mlstm_apply(model.blocks[0].core, cfg, u, chunk=32)


@pytest.mark.parametrize("chunk", [32, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlstm_apply_matches_jax(dtype, chunk):
    """One mLSTM block over 32 positions in one chunk and in two (the
    carry), then three recurrent steps from the -1e30 cache (the first
    step separately checked: its m is the input gate)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(0, dtype)
    pj = jax.tree.map(lambda a: a[0], jp["units"]["b0"]["core"])
    pt = model.blocks[0].core
    u = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    uj, ut = jnp.asarray(u).astype(getattr(jnp, dtype)), torch.from_numpy(u).to(getattr(torch, dtype))
    with jax.disable_jit():
        want, _ = js.mlstm_apply(pj, jcfg, uj, chunk=chunk)
    with torch.no_grad():
        got, cache = ts.mlstm_apply(pt, cfg, ut, chunk=chunk)
    assert cache is None and got.dtype == ut.dtype
    tol = _block_tol(want, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)

    jc, tc = js.init_mlstm_cache(jcfg, 2), ts.init_mlstm_cache(cfg, 2, "cpu")
    for t in range(3):
        with jax.disable_jit():
            want, jc = js.mlstm_apply(pj, jcfg, uj[:, t:t + 1], jc)
        with torch.no_grad():
            got, tc = ts.mlstm_apply(pt, cfg, ut[:, t:t + 1], tc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
        if t == 0:  # m_new = max(f - 1e30, i) = i: the input gate, finite
            np.testing.assert_array_equal(_np(tc["m"]), _np(pt.w_i(ut[:, 0]).float()))
        for k in ("C", "n", "m", "conv"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=0,
                                       atol=_block_tol(jc[k], "float32" if k != "conv" else dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_slstm_apply_matches_jax(dtype):
    """One sLSTM block: the loop over 32 positions from (0, 0, 0, -1e30),
    then three recurrent steps from the cache."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(1, dtype)
    pj = jax.tree.map(lambda a: a[0], jp["units"]["b5"]["core"])
    pt = model.blocks[5].core
    u = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    uj, ut = jnp.asarray(u).astype(getattr(jnp, dtype)), torch.from_numpy(u).to(getattr(torch, dtype))
    with jax.disable_jit():
        want, _ = js.slstm_apply(pj, jcfg, uj)
    with torch.no_grad():
        got, cache = ts.slstm_apply(pt, cfg, ut)
    assert cache is None and got.dtype == ut.dtype
    tol = _block_tol(want, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    jc, tc = js.init_slstm_cache(jcfg, 2), ts.init_slstm_cache(cfg, 2, "cpu")
    for t in range(3):
        with jax.disable_jit():
            want, jc = js.slstm_apply(pj, jcfg, uj[:, t:t + 1], jc)
        with torch.no_grad():
            got, tc = ts.slstm_apply(pt, cfg, ut[:, t:t + 1], tc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
        for k in ("c", "n", "h", "m"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=0,
                                       atol=_block_tol(jc[k], "float32"))


def test_xlstm_blocks_match_jax_teacher_forced():
    """bf16: each of the six blocks, fed JAX's op-by-op input to it, within
    2^-8 of its largest output."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(0, "bfloat16")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    xj, pos = jp["embed"][jnp.asarray(toks)], jnp.arange(32)
    for j, kind in enumerate(jcfg.block_pattern):
        with jax.disable_jit():
            yj, _, _ = jm.apply_block(jcfg, kind, jax.tree.map(lambda a: a[0], jp["units"][f"b{j}"]),
                                      xj, pos, None, None)
        with torch.no_grad():
            yt, _ = model.blocks[j](torch.tensor(_np(xj)).bfloat16(), torch.arange(32))
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=_block_tol(yj, "bfloat16"))
        xj = yj


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_xlstm_forward_and_loss_match_jax(dtype):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(0, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    jb, tb = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    with jax.disable_jit(dtype == "bfloat16"):
        want, _ = jm.forward(jcfg, jp, jb, remat=False)
        want_loss = float(jm.loss_fn(jcfg, jp, jb, remat=False))
    with torch.no_grad():
        got, aux = forward(cfg, model, tb)
        loss = float(loss_fn(cfg, model, tb))
    assert got.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    tol = (BF16_LOGIT_REL * float(np.abs(_np(want)).max()) if dtype == "bfloat16"
           else F32_LOGIT_TOL)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    assert abs(loss - want_loss) <= (BF16_LOGIT_REL if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_xlstm_decode_logits_match_jax(dtype):
    """Four decode steps over the mLSTM and sLSTM caches (bf16: JAX op by
    op); every cache entry against JAX's after them."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp, model = jax_and_torch_params(2, dtype)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 4))
    jcache, cache = jm.init_cache(jcfg, 2, 16), init_cache(cfg, 2, 16, "cpu")
    for t in range(4):
        with jax.disable_jit(dtype == "bfloat16"):
            want, jcache = jm.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                          jnp.int32(t))
        got, cache = decode_step(cfg, model, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        tol = (BF16_LOGIT_REL * float(np.abs(_np(want)).max()) if dtype == "bfloat16"
               else F32_LOGIT_TOL)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)
    for i, c in enumerate(cache):
        for k, t in c.items():
            w = jcache["units"][f"b{i}"][k][0]
            np.testing.assert_allclose(_np(t), _np(w), rtol=0, atol=max(
                _block_tol(w, "float32"), BF16_LOGIT_REL * float(np.abs(_np(w)).max())
                if dtype == "bfloat16" else 0.0))


@pytest.mark.parametrize("b,L", [(2, 8), (1, 512)])
def test_decode_matches_forward(b, L):
    """The twin of ``tests/test_arch_smoke.py::test_decode_matches_forward``
    for xlstm: L decode steps from the -1e30 caches against one chunked
    forward, float32 weights and caches, 2e-3. At L = 512 the forward's
    mLSTM runs two chunks of 256 (the carry)."""
    cfg = get_config(ARCH)
    _, model = jax_and_torch_params(3, "float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (b, L)))
    with torch.no_grad():
        full, _ = forward(cfg, model, {"tokens": toks})
    cache = [{k: t.float() for k, t in c.items()} for c in init_cache(cfg, b, L, "cpu")]
    steps = [decode_step(cfg, model, cache, toks[:, t:t + 1], t)[0] for t in range(L)]
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
