"""The port's optimizers, schedules and data pipeline against the JAX package.

The same numpy parameters and gradients go through both packages.
Tolerances: the updates repeat JAX's float32 operations in its order, so
without clipping parameters and state agree to 1 f32 ulp of the values
(rtol 2.4e-7, atol 1e-9) and a bf16 parameter bit for bit. When the
gradients are clipped, the global norm is a sum over every element taken
in another order than XLA's: the clip scale may differ by an f32 ulp, and
a clipped bf16 gradient may then round the other way. There the bound is
one bf16 ulp (2^-7) of each leaf's largest value in bf16, and 1e-5 of it
in f32.
Schedules: 2 f32 ulps (XLA's cos against numpy's). Batches: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import TokenFileDataset as JaxTokenFileDataset
from repro.optim import optimizers as jo
from repro.optim import schedules as jsched
from repro_torch.data import DataConfig, SyntheticLM, TokenFileDataset, make_pipeline
from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule, linear_warmup, lion, sgd

RTOL, ATOL = 2.4e-7, 1e-9
CLIPPED = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SHAPES = {"w": (64, 32), "b": (32,), "scale": (8, 8)}


def _params_and_grads(seed, dtype, grad_scale):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * grad_scale
              for k, s in SHAPES.items()} for _ in range(2)]
    jp = {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in params.items()}
    # a copy: the port updates parameters in place, and jnp.asarray may share
    # the numpy buffer with JAX's array
    tp = {k: torch.tensor(v, dtype=getattr(torch, dtype)) for k, v in params.items()}
    jg = [{k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in g.items()} for g in grads]
    tg = [{k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in g.items()} for g in grads]
    return jp, tp, jg, tg


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check_tree(got: dict, want: dict, clipped_grads_dtype=None):
    """Unclipped: 1 f32 ulp, bf16 bit for bit. After clipping gradients of
    ``clipped_grads_dtype``: that dtype's bound from ``CLIPPED``."""
    for k in want:
        g, w = _f32(got[k]), _f32(want[k])
        if clipped_grads_dtype is not None:
            atol = CLIPPED[clipped_grads_dtype] * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
        elif got[k].dtype == torch.bfloat16:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


_PORT = {"adamw": adamw, "lion": lion, "sgd": sgd}


@pytest.mark.parametrize("grad_scale", [0.1, 30.0])  # under and over the clip norm 1.0
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "lion", "sgd"])
def test_two_steps_match_jax(name, dtype, grad_scale):
    jp, tp, jgs, tgs = _params_and_grads(0, dtype, grad_scale)
    if name == "adamw":
        jopt = jo.adamw(jsched.cosine_schedule(1e-2, 1, 4))
        topt = adamw(cosine_schedule(1e-2, 1, 4))
    elif name == "lion":
        jopt, topt = jo.lion(3e-3), lion(3e-3)
    else:
        jopt, topt = jo.sgd(1e-2), sgd(1e-2)
    # sgd never clips; adamw and lion clip at global norm 1.0
    clipped = getattr(torch, dtype) if grad_scale > 1 and name != "sgd" else None
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for jg, tg in zip(jgs, tgs):
        jp, jstate = jopt.update(jg, jstate, jp)
        tstate = topt.update(tg, tstate, tp)
        _check_tree(tp, jp, clipped)
        assert tstate["step"] == int(jstate["step"])
        for key in ("m", "v", "master"):
            if key in jstate:
                _check_tree(tstate[key], jstate[key], clipped)


def test_update_is_in_place_and_keeps_dtypes():
    _, tp, _, tgs = _params_and_grads(1, "bfloat16", 0.1)
    w = tp["w"]
    opt = adamw(1e-2)
    state = opt.init(tp)
    opt.update(tgs[0], state, tp)
    assert tp["w"] is w and w.dtype == torch.bfloat16
    assert {t.dtype for s in ("m", "v", "master") for t in state[s].values()} == {torch.float32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_jax(dtype):
    _, _, jgs, tgs = _params_and_grads(2, dtype, 3.0)
    want, want_norm = jo.clip_by_global_norm(jgs[0], 1.0)
    got, norm = clip_by_global_norm(tgs[0], 1.0)
    # a sum of 2112 squares in another order than XLA's
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-5)
    _check_tree(got, want, getattr(torch, dtype))


def test_schedules_match_jax():
    cos_j, cos_t = jsched.cosine_schedule(3e-4, 20, 100), cosine_schedule(3e-4, 20, 100)
    warm_j, warm_t = jsched.linear_warmup(1e-3, 7), linear_warmup(1e-3, 7)
    for step in [0, 1, 2, 7, 19, 20, 21, 50, 99, 100, 150]:
        s = jnp.int32(step)
        np.testing.assert_allclose(cos_t(step), float(cos_j(s)), rtol=4.8e-7, atol=0)
        np.testing.assert_allclose(warm_t(step), float(warm_j(s)), rtol=4.8e-7, atol=0)
    assert cos_t(20) == pytest.approx(3e-4) and cos_t(100) == pytest.approx(3e-5)


def test_synthetic_lm_batches_bit_for_bit():
    ours, theirs = SyntheticLM(512, seed=3), JaxSyntheticLM(512, seed=3)
    for step in (0, 1, 17):
        np.testing.assert_array_equal(ours.batch(step, 4, 64)["tokens"],
                                      theirs.batch(step, 4, 64)["tokens"])


def test_token_file_batches_bit_for_bit(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(4).integers(0, 70000, 5000, dtype=np.int32).tofile(path)
    ours, theirs = TokenFileDataset(path, 32000, seed=5), JaxTokenFileDataset(path, 32000, seed=5)
    for step in (0, 3):
        np.testing.assert_array_equal(ours.batch(step, 3, 128)["tokens"],
                                      theirs.batch(step, 3, 128)["tokens"])


def test_pipeline_yields_the_source_batches_in_order():
    src = SyntheticLM(256, seed=6)
    pipe = make_pipeline(src, 2, 16, device="cpu", start_step=5, data_cfg=DataConfig(prefetch=3))
    for step in (5, 6, 7):
        b = next(pipe)
        assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["tokens"].numpy(), src.batch(step, 2, 16)["tokens"])
    pipe.close()


def test_jax_state_layout_is_mirrored():
    """The port's state has JAX's keys, with parameters keyed by name."""
    jp, tp, _, _ = _params_and_grads(7, "float32", 0.1)
    for name in ("adamw", "lion", "sgd"):
        jstate = getattr(jo, name)(1e-3).init(jp)
        tstate = _PORT[name](1e-3).init(tp)
        assert set(tstate) == set(jstate)
        assert all(set(tstate[k]) == set(SHAPES) for k in tstate if k != "step")
    assert jax.tree.structure(jstate["m"]) == jax.tree.structure(jp)
