"""The port's training path against the JAX package on the CPU, at
``zamba2-2.7b_smoke`` with float32 weights.

Grads are compared, not post-Adam parameters: Adam's first step is about
lr * sign(g), so a near-zero gradient whose sign differs in the last ulp
would move a parameter by 2 * lr. Tolerances: the loss to 1e-5; each
gradient leaf to 1e-4 of that leaf's largest gradient (f32 throughout,
sums taken in another order, and the SSD/attention backwards recompute
through their plain versions in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jax_kernels
from repro.configs.base import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import model as jm
from repro.optim import optimizers as jo
from repro_torch import kernels as torch_kernels
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.models import loss_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import sgd

ARCH = "zamba2-2.7b_smoke"
LOSS_TOL = 1e-5
GRAD_REL = 1e-4


def _setup(seed):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu").float()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def _by_port_name(cfg, tree):
    """JAX params/grads pytree -> {port parameter name: numpy array}."""
    P, out = len(cfg.block_pattern), {}
    for path, arr in jax.tree_util.tree_leaves_with_path(tree):
        keys = [k.key for k in path]
        if keys[0] == "units":
            for i in range(cfg.n_units):
                out[".".join(["blocks", str(i * P + int(keys[1][1:])), *keys[2:]])] = np.asarray(arr[i])
        else:
            out[".".join(keys)] = np.asarray(arr)
    return out


def _check_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()) + 1e-12,
                                   err_msg=k)


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


@pytest.mark.parametrize("kernels_on", [False, True])
def test_train_step_loss_and_grads_match_jax(kernels_on, kernel_switches):
    jcfg, cfg, jp, model, toks = _setup(0)
    kernel_switches(kernels_on)
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}))(jp)
    loss, grads = steps.make_grads_fn(cfg)(model, {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    _check_grads(grads, _by_port_name(cfg, want))


def test_microbatches_agree_with_one_batch():
    """microbatches=2 sums half-batch grads into f32 accumulators (JAX's
    scan): the same loss and grads as one batch, to the same tolerances."""
    _, cfg, _, model, toks = _setup(1)
    batch = {"tokens": torch.from_numpy(toks)}
    loss1, g1 = steps.make_grads_fn(cfg)(model, batch)
    g1 = {k: v.clone() for k, v in g1.items()}
    loss2, g2 = steps.make_grads_fn(cfg, microbatches=2)(model, batch)
    assert abs(float(loss1) - float(loss2)) <= LOSS_TOL
    assert {v.dtype for v in g2.values()} == {torch.float32}
    _check_grads(g2, {k: v.numpy() for k, v in g1.items()})


def test_remat_recomputes_the_same_grads():
    _, cfg, _, model, toks = _setup(2)
    batch = {"tokens": torch.from_numpy(toks)}
    _, g_remat = steps.make_grads_fn(cfg, remat=True)(model, batch)
    g_remat = {k: v.clone() for k, v in g_remat.items()}
    _, g_plain = steps.make_grads_fn(cfg, remat=False)(model, batch)
    for k in g_plain:
        torch.testing.assert_close(g_remat[k], g_plain[k], rtol=0, atol=0)


def test_sgd_train_step_matches_jax():
    """A whole ``make_train_step`` step with SGD (linear in the gradient,
    no clipping): parameters after one step agree with JAX's."""
    jcfg, cfg, jp, model, toks = _setup(3)
    jstep = jax_steps.make_train_step(jcfg, jo.sgd(0.5))
    jopt = jo.sgd(0.5)
    jstate, jmetrics = jstep({"params": jp, "opt": jopt.init(jp)}, {"tokens": jnp.asarray(toks)})
    opt = sgd(0.5)
    state = {"model": model, "opt": opt.init(dict(model.named_parameters()))}
    state, metrics = steps.make_train_step(cfg, opt)(state, {"tokens": torch.from_numpy(toks)})
    assert metrics["step"] == 1 and abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
    want = _by_port_name(cfg, jstate["params"])
    for k, p in state["model"].named_parameters():
        # a parameter moves by 0.5 * grad: the grad bound, scaled
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=0.5 * GRAD_REL * float(np.abs(want[k]).max()) + 1e-6,
                                   err_msg=k)
        assert p.grad is None


def test_eval_step_is_the_loss_without_remat():
    _, cfg, _, model, toks = _setup(4)
    batch = {"tokens": torch.from_numpy(toks)}
    got = steps.make_eval_step(cfg)(model, batch)
    with torch.no_grad():
        want = loss_fn(cfg, model, batch, remat=False)
    assert float(got) == float(want) and not got.requires_grad


def test_train_main_runs_on_the_cpu():
    out = train_main(["--device", "cpu", "--arch", ARCH, "--steps", "3", "--batch", "2",
                      "--seq", "32", "--warmup", "1", "--log-every", "1"])
    assert out["steps"] == 3 and len(out["losses"]) == len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"])) and out["first_loss"] == out["losses"][0]


def test_train_main_microbatches_and_lion_on_the_cpu():
    out = train_main(["--device", "cpu", "--arch", ARCH, "--steps", "2", "--batch", "4",
                      "--seq", "16", "--microbatches", "2", "--optimizer", "lion", "--no-remat"])
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("flag,item", [(["--mesh", "1,4"], "A12"), (["--ckpt-dir", "ck"], "A10")])
def test_train_main_raises_for_what_is_not_ported(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        train_main(["--device", "cpu", "--arch", ARCH, "--steps", "1", *flag])


def test_train_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", ARCH, "--steps", "1"])
