"""The port's two stub frontends against the JAX package on the CPU:
``hubert-xlarge_smoke`` (``audio_stub``: frames through ``frontend_proj``,
no token embedding, encoder-only, bidirectional attention) and
``llava-next-34b_smoke`` (``vision_stub``: patch embeddings through the
``l2(gelu(l1(.)))`` projector, placed before the text tokens).

Weights are drawn once by JAX and converted with ``params_from_jax``; the
batches have ``tests/test_arch_smoke.py``'s shapes (B = 2, S = 32; llava:
8 image positions and 24 text tokens), drawn from seeded numpy. Both
packages' kernel switches are set alike: on, JAX runs its Pallas kernel in
interpret mode and the port the kernel's plain version (no card here).
Tolerances, stated once:

* float32 weights: logits 1e-4, the loss 1e-5 (f32 sums in other orders);
* bf16 weights, against JAX op by op (``jax.disable_jit``, as the MoE and
  zamba2 tests compare): 2% of the largest logit, the loss 5e-3. Both
  frameworks round the same bf16 steps, but XLA's and torch's bf16
  matmuls and exp/softmax differ by an ulp at some elements (kernels on:
  the plain version and JAX's kernel also round P at other points).
  Measured: 0.39-0.78% (hubert), 0.48-1.22% (llava, the larger with
  kernels on); the loss within 9.0e-4.
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
from repro_torch import kernels as torch_kernels
from repro_torch.configs import get_config
from repro_torch.models import decode_step, embed_inputs, forward, init_cache, loss_fn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

AUDIO, VISION = "hubert-xlarge_smoke", "llava-next-34b_smoke"
ARCHS = [AUDIO, VISION]
B, S = 2, 32
F32_LOGIT_TOL, F32_LOSS_TOL = 1e-4, 1e-5
BF16_LOGIT_REL, BF16_LOSS_TOL = 0.02, 5e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


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


def params(arch, seed, dtype):
    """The same weights in both packages (float32 casts the bf16 init)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        model = model.float()
    return jcfg, cfg, jp, model


def batches(cfg, seed):
    """test_arch_smoke's batch shapes from seeded numpy: (JAX, torch)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        frames = rng.standard_normal((B, S, cfg.d_frontend)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab, (B, S))
        return ({"frames": jnp.asarray(frames).astype(jnp.bfloat16),
                 "labels": jnp.asarray(labels, jnp.int32)},
                {"frames": torch.from_numpy(frames).bfloat16(), "labels": torch.from_numpy(labels)})
    n_img = cfg.n_frontend_tokens
    toks = rng.integers(0, cfg.vocab, (B, S - n_img))
    patches = rng.standard_normal((B, n_img, cfg.d_frontend)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "patch_embeds": jnp.asarray(patches).astype(jnp.bfloat16)},
            {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(patches).bfloat16()})


def _logit_tol(want, dtype) -> float:
    return (BF16_LOGIT_REL * float(np.abs(_np(want)).max()) if dtype == "bfloat16"
            else F32_LOGIT_TOL)


@pytest.mark.parametrize("name", ["hubert-xlarge", AUDIO, "llava-next-34b", VISION])
def test_config_fields_match_jax(name):
    ours, theirs = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.head_dim, ours.supports_decode) == (theirs.head_dim, theirs.supports_decode)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_maps_the_frontends(arch):
    """Audio: ``frontend_proj`` is one dense leaf and there is no ``embed``;
    vision: ``frontend_proj.{l1, l2}`` beside ``embed``. Every leaf by name,
    ``strict=True``."""
    jcfg, cfg, jp, model = params(arch, 4, "bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for _, a in leaves)
    for path, arr in leaves:
        keys = [k.key for k in path]
        if keys[0] == "units":
            for i in range(arr.shape[0]):
                t = model.get_parameter(".".join(["blocks", str(i), *keys[2:]]))
                np.testing.assert_array_equal(_np(t), _np(arr[i]))
        else:
            np.testing.assert_array_equal(_np(model.get_parameter(".".join(keys))), _np(arr))
    names = {n for n, _ in model.named_parameters()}
    if arch == AUDIO:
        assert "embed" not in jp and "embed" not in names and model.embed is None
        assert {n for n in names if n.startswith("frontend_proj")} == {"frontend_proj.w"}
    else:
        assert {n for n in names if n.startswith("frontend_proj")} == {
            "frontend_proj.l1.w", "frontend_proj.l2.w"}


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, dtype, kernels_on, kernel_switches):
    jcfg, cfg, jp, model = params(arch, 0, dtype)
    jb, tb = batches(cfg, 0)
    kernel_switches(kernels_on)
    with jax.disable_jit(dtype == "bfloat16"):
        want, _ = jm.forward(jcfg, jp, jb, remat=False)
        want_loss = float(jm.loss_fn(jcfg, jp, jb, remat=False))
    with torch.no_grad():
        got, aux = forward(cfg, model, tb)
        loss = float(loss_fn(cfg, model, tb))
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=_logit_tol(want, dtype))
    assert abs(loss - want_loss) <= (BF16_LOSS_TOL if dtype == "bfloat16" else F32_LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_match_jax(arch):
    """The frontend's output and the text start: 0 for audio, the image
    length for vision (float32 weights: 1e-5 of the largest entry)."""
    jcfg, cfg, jp, model = params(arch, 1, "float32")
    jb, tb = batches(cfg, 1)
    want, x0_j = jm.embed_inputs(jcfg, jp, jb)
    got, x0 = embed_inputs(cfg, model, tb)
    assert x0 == x0_j == (0 if arch == AUDIO else cfg.n_frontend_tokens)
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=1e-5 * float(np.abs(_np(want)).max()))


def test_vision_without_patches_embeds_text_only():
    """Without ``patch_embeds`` the vision config is a text LM: its forward
    and loss match JAX's over the text alone."""
    jcfg, cfg, jp, model = params(VISION, 2, "float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, 16))
    jb, tb = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    want, _ = jm.forward(jcfg, jp, jb, remat=False)
    with torch.no_grad():
        got, _ = forward(cfg, model, tb)
        loss = float(loss_fn(cfg, model, tb))
    assert got.shape == (B, 16, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_LOGIT_TOL)
    assert abs(loss - float(jm.loss_fn(jcfg, jp, jb, remat=False))) <= F32_LOSS_TOL


def test_vision_loss_covers_the_text_positions_only():
    """The image prefix's logits do not enter the loss; the text's do."""
    _, cfg, _, model = params(VISION, 3, "float32")
    _, tb = batches(cfg, 3)
    with torch.no_grad():
        logits, _ = forward(cfg, model, tb)
        x0 = cfg.n_frontend_tokens
        lg = logits[:, x0:-1]
        want = (torch.logsumexp(lg, -1) - torch.gather(lg, -1, tb["tokens"][:, 1:, None])[..., 0])
        assert torch.allclose(loss_fn(cfg, model, tb), want.mean(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernels_on", [False, True])
def test_audio_attention_is_bidirectional(kernels_on, kernel_switches):
    """hubert is encoder-only: a change to the last frame moves the first
    position's logits (a causal mask would leave them as they were), and
    the port moves them as JAX does."""
    jcfg, cfg, jp, model = params(AUDIO, 5, "float32")
    jb, tb = batches(cfg, 5)
    kernel_switches(kernels_on)
    frames = tb["frames"].clone()
    frames[:, -1] = -frames[:, -1]
    jb2 = {**jb, "frames": jnp.asarray(_np(frames)).astype(jnp.bfloat16)}
    with torch.no_grad():
        a, _ = forward(cfg, model, tb)
        b, _ = forward(cfg, model, {**tb, "frames": frames})
    moved = (b[:, 0] - a[:, 0]).abs().max().item()
    assert moved > 1e-2, moved
    want = jm.forward(jcfg, jp, jb2, remat=False)[0][:, 0] - jm.forward(jcfg, jp, jb, remat=False)[0][:, 0]
    np.testing.assert_allclose(_np(b[:, 0] - a[:, 0]), _np(want), rtol=0, atol=2 * F32_LOGIT_TOL)


def test_audio_config_has_no_decode():
    cfg = get_config(AUDIO)
    model = Model(cfg, generator=None, device="meta")
    assert not cfg.supports_decode and model.embed is None
    with pytest.raises(AssertionError, match="encoder-only"):
        decode_step(cfg, model, init_cache(cfg, 1, 4, "meta"),
                    torch.zeros((1, 1), dtype=torch.long, device="meta"), 0)


@pytest.mark.parametrize("name", ["hubert-xlarge", "llava-next-34b"])
def test_full_width_parameter_count_matches_jax(name):
    """hubert-xlarge 0.95 B and llava-next-34b 34.45 B parameters, leaf by
    leaf as JAX's ``init_params`` builds them (meta tensors against
    ``jax.eval_shape``)."""
    shapes = jax.eval_shape(lambda k: jm.init_params(jax_get_config(name), k),
                            jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in Model(get_config(name), generator=None,
                                          device="meta").parameters())
    assert n_port == n_jax
    assert round(n_port / 1e9, 2) == {"hubert-xlarge": 0.95, "llava-next-34b": 34.45}[name]
