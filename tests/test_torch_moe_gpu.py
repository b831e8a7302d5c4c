"""MLA and the MoE FFN on the card against the same modules on the CPU.

Marked ``gpu``: each test skips without an NVIDIA GPU. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_moe_gpu.py

The modules are deepseek-v2-lite's at full width (MLA: 16 heads of nope
128 + rope 64, v 128, latent rank 512; MoE: 64 routed experts of 1408,
top-6, 2 shared), with random weights from a seeded CPU generator, copied
to the card. On the card the kernels are on, so MLA's attention is the
flash-attention kernel's D = 192 instance (d = 192 and dv = 128, zero-padded);
on the CPU it is the plain version. Tolerances:

* MLA in bf16: 3e-2 of the largest |output| (the kernel and the plain
  version round P and the output to bf16 at other points;
  ``tests/test_kernels.py``'s bf16 bound, per unit of the output);
* MoE in float32 (TF32 off, PyTorch's default for matmul): routes equal,
  y within 1e-4 of the largest |y| (f32 sums in other orders, over
  d = 2048 and d_expert = 1408).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda, reset_launches
from repro_torch.models.layers import MLA
from repro_torch.models.moe import MoE

CFG = get_config("deepseek-v2-lite-16b")
B, S, SMAX = 2, 48, 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash-attention kernel has no CPU mode")
    try:
        yield
    finally:
        kernels.enable_kernels(False)


def _pair(layer_cls, cfg, dtype):
    cpu = layer_cls(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(dtype)
    return cpu, copy.deepcopy(cpu).to("cuda")


def _close(got, want, rel):
    got, want = got.float().cpu(), want.float()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), f"max abs err {err}, |want| max {want.abs().max()}"


def _run(module, x, positions, device, cache=None, cache_len=None, kernels_on=False):
    kernels.enable_kernels(kernels_on)
    with torch.no_grad():
        return module(x.to(device), positions.to(device), cache, cache_len)


@pytest.mark.gpu
def test_mla_on_the_card_matches_the_cpu(card):
    """A causal prefill of S tokens, then four decode steps over the latent
    cache; every attention call launches the D = 192 instance."""
    cpu, gpu = _pair(MLA, CFG, torch.bfloat16)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, S + 4, CFG.d_model), np.float32)).bfloat16()
    reset_launches()
    _close(_run(gpu, x[:, :S], torch.arange(S), "cuda", kernels_on=True),
           _run(cpu, x[:, :S], torch.arange(S), "cpu"), 3e-2)
    caches = {dev: {"ckv": torch.zeros((B, SMAX, CFG.kv_lora_rank), dtype=torch.bfloat16,
                                       device=dev),
                    "krope": torch.zeros((B, SMAX, CFG.rope_head_dim), dtype=torch.bfloat16,
                                         device=dev)} for dev in ("cpu", "cuda")}
    for pos, n in ((0, S), (S, 1), (S + 1, 1), (S + 2, 1), (S + 3, 1)):
        xs, p = x[:, pos:pos + n], torch.arange(pos, pos + n)
        got = _run(gpu, xs, p, "cuda", caches["cuda"], pos, kernels_on=True)
        want = _run(cpu, xs, p, "cpu", caches["cpu"], pos)
        _close(got, want, 3e-2)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == flash_attention_cuda.launches_by_dim[192] == 6
    _close(caches["cuda"]["ckv"], caches["cpu"]["ckv"], 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dropless,tokens", [(True, 8), (False, 256)])
def test_moe_on_the_card_matches_the_cpu(card, dropless, tokens):
    """Dropless decode (8 tokens: every expert's buffer is T*k long) and a
    capacity-bounded forward (256 tokens, capacity 1.25)."""
    cfg = dataclasses.replace(CFG, capacity_factor=1.25)
    cpu, gpu = _pair(MoE, cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, tokens, cfg.d_model), np.float32))
    with torch.no_grad():
        want_y, want_aux = cpu(x, dropless=dropless)
        got_y, got_aux = gpu(x.cuda(), dropless=dropless)
        want_e = cpu.route(x[0])[1]
        got_e = gpu.route(x[0].cuda())[1].cpu()
    assert torch.equal(got_e, want_e)
    _close(got_y, want_y, 1e-4)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
