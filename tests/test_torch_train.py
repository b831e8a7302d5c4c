"""The port's training path against the JAX package on the CPU, at
``zamba2-2.7b_smoke`` with float32 weights, and at both MoE smoke configs
(deepseek-v2-lite with MLA and a dense prefix layer, qwen2-moe); the
``save_block_outputs`` remat policy; ``--ckpt-dir`` resume through the
entry point; the two example twins.

Grads are compared, not post-Adam parameters: Adam's first step is about
lr * sign(g), so a near-zero gradient whose sign differs in the last ulp
would move a parameter by 2 * lr. Tolerances: the loss to 1e-5; each
gradient leaf to 1e-4 of that leaf's largest gradient (f32 throughout,
sums taken in another order, and the SSD/attention backwards recompute
through their plain versions in both packages).
"""

import dataclasses
import filecmp
import json
import socket
import time

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
from repro_torch.checkpoint import latest_step
from repro_torch.launch import serve_batched, steps, train_lm
from repro_torch.launch.train import main as train_main
from repro_torch.models import forward, loss_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.moe import MoE
from repro_torch.optim import adamw, sgd

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


@pytest.mark.parametrize("flag,item", [(["--mesh", "1,4"], "needs 4 ranks; the world has 1")])
def test_train_main_raises_for_what_is_not_ported(flag, item, tmp_path, monkeypatch):
    """--mesh is ported (tests/test_torch_train_mesh.py); a world whose size
    is not the mesh's raises, and the process group made for it is gone."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost"}.items():
        monkeypatch.setenv(k, v)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        monkeypatch.setenv("MASTER_PORT", str(s.getsockname()[1]))
    with pytest.raises(RuntimeError, match=item):
        train_main(["--device", "cpu", "--arch", ARCH, "--steps", "1", *flag])
    assert not torch.distributed.is_initialized()


def test_train_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", ARCH, "--steps", "1"])


# --------------------------------------------------------------------- #
# --ckpt-dir: checkpoint, kill, resume
# --------------------------------------------------------------------- #
class _Killed(BaseException):
    """Stands for SIGKILL: not an Exception, so the runner does not retry it."""


def test_train_main_resumes_from_ckpt_dir(tmp_path):
    """6 steps straight, and 6 steps killed after step 4's checkpoint at 3
    then run again on the same directory: the second run restores step 3,
    its pipeline starts at batch 3, and its losses and step-6 checkpoint
    equal the straight run's bit for bit. Run again past the target, it
    has nothing to do."""
    args = ["--device", "cpu", "--arch", "qwen3-0.6b_smoke", "--steps", "6", "--batch", "2",
            "--seq", "32", "--warmup", "2", "--ckpt-every", "3", "--deterministic"]
    straight = train_main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert straight["steps"] == 6 and [r["step"] for r in straight["checkpoints"]] == [3, 6]

    def kill(step):
        if step == 4:
            raise _Killed

    with pytest.raises(_Killed):
        train_main(args + ["--ckpt-dir", str(tmp_path / "b")], fault_hook=kill)
    deadline = time.monotonic() + 60
    while latest_step(tmp_path / "b") != 3:  # the async writer of step 3
        assert time.monotonic() < deadline
        time.sleep(0.01)
    resumed = train_main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--metrics-out", str(tmp_path / "m.json")])
    assert resumed["start_step"] == 3 and resumed["steps"] == 3
    assert resumed["losses"] == straight["losses"][3:]
    assert json.loads((tmp_path / "m.json").read_text())["losses"] == resumed["losses"]
    a, b = tmp_path / "a" / "step_000000006", tmp_path / "b" / "step_000000006"
    files = sorted(p.name for p in a.glob("*.npy"))
    assert files and all(filecmp.cmp(a / f, b / f, shallow=False) for f in files)
    again = train_main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert again["steps"] == 0 and again["start_step"] == 6


# --------------------------------------------------------------------- #
# remat_policy="save_block_outputs"
# --------------------------------------------------------------------- #
def _jax_setup(arch, seed, **over):
    """f32 JAX params and the port's model of ``arch``, and a token batch."""
    jcfg = dataclasses.replace(jax_get_config(arch), **over)
    cfg = dataclasses.replace(get_config(arch), **over)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu").float()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    return jcfg, cfg, jp, model, toks


def _jax_grads_by_name(cfg, grads):
    """JAX grads pytree -> {port parameter name: array}: the grads made into
    a model by the same map as the weights (prefix lists included)."""
    return {k: v.detach().numpy() for k, v in
            params_from_jax(jax.tree.map(np.asarray, grads), cfg, "cpu").named_parameters()}


@pytest.mark.parametrize("arch", ["zamba2-2.7b_smoke", "deepseek-v2-lite-16b_smoke",
                                  "xlstm-1.3b_smoke"])
def test_save_block_outputs_grads_match_full_and_jax(arch):
    """Per-branch checkpoints recompute the same ops as whole-unit ones:
    loss and grads equal ``"full"``'s bit for bit on the CPU, and
    ``jax.grad`` under the reference's ``save_block_outputs`` to
    GRAD_REL."""
    jcfg, cfg, jp, model, toks = _jax_setup(arch, 5)
    batch = {"tokens": torch.from_numpy(toks)}
    loss_full, g_full = steps.make_grads_fn(cfg, remat_policy="full")(model, batch)
    g_full = {k: v.clone() for k, v in g_full.items()}
    loss, grads = steps.make_grads_fn(cfg, remat_policy="save_block_outputs")(model, batch)
    assert float(loss) == float(loss_full)
    assert all(torch.equal(grads[k], g_full[k]) for k in g_full)
    want_loss, want = jax.value_and_grad(lambda p: jm.loss_fn(
        jcfg, p, {"tokens": jnp.asarray(toks)}, remat=True,
        remat_policy="save_block_outputs"))(jp)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    _check_grads(grads, _jax_grads_by_name(cfg, want))


# --------------------------------------------------------------------- #
# MoE training
# --------------------------------------------------------------------- #
MOE_ARCHS = ["deepseek-v2-lite-16b_smoke", "qwen2-moe-a2.7b_smoke"]


def _dropped(cfg, model, toks) -> int:
    """Assignments the MoE layers drop past capacity in one forward."""
    drops = []

    def hook(m, args, out):
        if m.cfg.n_routed_experts:
            xt = args[0].reshape(-1, args[0].shape[-1])
            eidx = m.route(xt)[1].reshape(-1)
            C = max(1, int(np.ceil(xt.shape[0] * m.cfg.top_k * m.cfg.capacity_factor
                                   / m.cfg.n_routed_experts)))
            counts = torch.bincount(eidx, minlength=m.cfg.n_routed_experts)
            drops.append(int((counts - C).clamp_min(0).sum()))

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, MoE)]
    with torch.no_grad():
        forward(cfg, model, {"tokens": torch.from_numpy(toks)}, remat=False)
    for h in hooks:
        h.remove()
    return sum(drops)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_jax(arch, capacity_factor):
    """f32 loss and grads of every leaf -- router, routed experts, shared
    experts, attention, prefix -- against ``jax.grad`` of the reference's
    ``loss_fn``, with the Switch aux term in the loss, at the config's
    capacity and at a capacity that drops assignments (a dropped row's
    gradient must not reach its expert, while the router keeps the aux
    term's)."""
    over = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jcfg, cfg, jp, model, toks = _jax_setup(arch, 6, **over)
    if capacity_factor is not None:
        assert _dropped(cfg, model, toks) > 0
    want_loss, want = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}))(jp)
    loss, grads = steps.make_grads_fn(cfg)(model, {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    _check_grads(grads, _jax_grads_by_name(cfg, want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dropped_assignments_get_no_gradient(arch):
    """One MoE layer, no shared experts, a capacity of one slot per expert:
    a token whose every assignment is dropped gets no gradient from the
    layer's output, and the router still gets the aux term's."""
    cfg = dataclasses.replace(get_config(arch), n_shared_experts=0, capacity_factor=1e-6)
    moe = MoE(cfg, generator=torch.Generator().manual_seed(0), device="cpu").float()
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y, aux = moe(x)
    eidx = moe.route(x.detach()[0])[1]
    kept = torch.zeros(16, dtype=torch.bool)  # C = 1: each expert keeps its first assignment
    first = {}
    for i, e in enumerate(eidx.reshape(-1).tolist()):
        first.setdefault(e, i // cfg.top_k)
    kept[list(first.values())] = True
    assert (~kept).any()
    (gx,) = torch.autograd.grad(y.sum(), x, retain_graph=True)
    assert torch.count_nonzero(gx[0, ~kept]) == 0 and torch.count_nonzero(gx[0, kept]) > 0
    (g_router,) = torch.autograd.grad(aux, moe.router.w)
    assert torch.count_nonzero(g_router) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_microbatched_step_matches_full(arch):
    """tests/test_arch_smoke.py's microbatch rule on the port: the router's
    aux statistics are per microbatch, so two microbatches give JAX's
    two-microbatch loss (f32, LOSS_TOL) and, against one batch, the
    reference's tolerances: loss rtol 5e-2, f32 masters atol 4e-3."""
    jcfg, cfg, jp, model, toks = _jax_setup(arch, 7)
    batch = {"tokens": torch.from_numpy(toks)}
    jopt = jo.adamw(1e-3, grad_clip=None)
    jstate = {"params": jp, "opt": jopt.init(jp)}
    _, jm2 = jax_steps.make_train_step(jcfg, jopt, remat=False, microbatches=2)(
        jstate, {"tokens": jnp.asarray(toks)})
    masters, losses = [], []
    for mb in (1, 2):
        m = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")  # bf16, as the reference
        opt = adamw(1e-3, grad_clip=None)
        state = {"model": m, "opt": opt.init(dict(m.named_parameters()))}
        state, metrics = steps.make_train_step(cfg, opt, remat=False, microbatches=mb)(state, batch)
        masters.append(state["opt"]["master"])
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=5e-2)
    for k in masters[0]:
        np.testing.assert_allclose(masters[1][k].numpy(), masters[0][k].numpy(), atol=4e-3,
                                   err_msg=k)
    loss_f32, _ = steps.make_grads_fn(cfg, microbatches=2)(model, batch)
    assert abs(float(loss_f32) - float(jm2["loss"])) <= LOSS_TOL


# --------------------------------------------------------------------- #
# the example twins
# --------------------------------------------------------------------- #
def test_train_lm_twin_at_smoke_size(tmp_path):
    """``examples/train_lm.py``'s twin on the reduced lm-100m config: trains,
    checkpoints and passes its own loss-drop check; run again, it resumes
    at the end and has nothing to do."""
    args = ["--device", "cpu", "--smoke", "--steps", "30", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    out = train_lm.main(args)
    assert out["steps"] == 30 and out["first_loss"] - out["last_loss"] > 0.02
    assert latest_step(tmp_path) == 30
    assert train_lm.main(args)["steps"] == 0


def test_serve_batched_twin_at_smoke_size():
    done = serve_batched.main(["--device", "cpu"])
    assert len(done) == 10 and all(len(r.out) == 24 for r in done)
