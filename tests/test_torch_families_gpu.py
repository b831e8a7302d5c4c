"""The flash-attention kernel at the shapes of hubert-xlarge and
llava-next-34b, and the mLSTM and sLSTM blocks of xlstm-1.3b on the card
against the same blocks on the CPU.

Marked ``gpu``: each test skips without an NVIDIA GPU. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_families_gpu.py

Flash attention, against its plain version, with ``tests/test_kernels.py``'s
tolerances (2e-4 in float32, 3e-2 in bf16):

* hubert's encode: 8 x 1499 frames, 16/16 heads of 80, non-causal. 1499
  is no multiple of a row or KV tile: the last 64-row tile holds 27 rows
  and the last KV tile is partial, so only the kv_len mask keeps its
  missing keys out of the softmax. k and v are views of a longer buffer
  whose rows past 1499 hold 99, which a read past the end would pick up;
* llava's prefill: 1 x 3008 positions (2880 image + 128 text), 56/8 heads
  of 128 (GQA group 7), causal;
* group 7 in the split decode (bq = 1, where a CTA holds up to 8 q-heads
  of one kv-head), at kv_len 1, 37 and a full 3009 of a 3072-slot cache.

The blocks are xlstm-1.3b's at full width (mLSTM: d 2048, d_inner 4096,
4 heads of 1024; sLSTM: 4 heads of 512, FFN 2752), random weights from a
seeded CPU generator, copied to the card: the chunked forward (mLSTM over
512 positions, two chunks of 256; sLSTM over 64) and three recurrent steps
from the initial caches. Tolerances, per unit of the largest |output| of
the CPU run: float32 1e-4 (f32 sums in other orders; TF32 off, PyTorch's
default for matmul); bf16 2^-6, four bf16 ulps of it (the bf16 projections
round once each on either device, from sums in other orders).
"""

import copy
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda, reset_launches
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import ssm

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
BLOCK_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
CFG = get_config("xlstm-1.3b")
# (b, sq, skv, hq, hkv, d, causal, q_offset, kv_len, dtype)
CASES = [
    (8, 1499, 1499, 16, 16, 80, False, 0, None, "bfloat16"),
    (8, 1499, 1499, 16, 16, 80, False, 0, None, "float32"),
    (1, 3008, 3008, 56, 8, 128, True, 0, None, "bfloat16"),
] + [(1, 1, 3072, 56, 8, 128, False, kv - 1, kv, dtype)
     for kv in (1, 37, 3009) for dtype in ("bfloat16", "float32")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash-attention kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,q_offset,kv_len,dtype", CASES)
def test_flash_kernel_at_the_family_shapes(card, b, sq, skv, hq, hkv, d, causal, q_offset, kv_len,
                                           dtype):
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    pad = 64 if kv_len is None else 0  # rows past the sequence, never to be read
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, d), np.float32)).to("cuda", dt)
    kv = torch.from_numpy(rng.standard_normal((b, skv + pad, 2, hkv, d), np.float32)).to("cuda", dt)
    kv[:, skv:] = 99.0
    k, v = kv[:, :skv, 0], kv[:, :skv, 1]
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == flash_attention_cuda.launches_by_dim[d] == 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                         scale=1.0 / math.sqrt(d), q_offset=q_offset,
                         kv_len=kv_len).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if kv_len is not None:  # cache slots past kv_len are never read
        k[:, kv_len:] = 99.0
        v[:, kv_len:] = 99.0
        assert torch.equal(flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                           kv_len=kv_len), got)


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float()
    err = (got - want).abs().max().item()
    assert err <= BLOCK_REL[dtype] * want.abs().max().item(), (
        f"max abs err {err}, |want| max {want.abs().max().item()}")


def _blocks(cls, dtype):
    cpu = cls(CFG, generator=torch.Generator().manual_seed(0), device="cpu").to(getattr(torch, dtype))
    return cpu, copy.deepcopy(cpu).to("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,L", [("mlstm", 512), ("slstm", 64)])
def test_xlstm_block_on_the_card_matches_the_cpu(card, kind, L, dtype):
    cls, apply, init = {"mlstm": (ssm.MLSTM, ssm.mlstm_apply, ssm.init_mlstm_cache),
                        "slstm": (ssm.SLSTM, ssm.slstm_apply, ssm.init_slstm_cache)}[kind]
    cpu, gpu = _blocks(cls, dtype)
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((1, L + 3, CFG.d_model), np.float32)).to(
        getattr(torch, dtype))
    with torch.no_grad():
        want, _ = apply(cpu, CFG, u[:, :L])
        got, _ = apply(gpu, CFG, u[:, :L].cuda())
        _close(got, want, dtype)
        caches = {"cpu": init(CFG, 1, "cpu"), "cuda": init(CFG, 1, "cuda")}
        for t in range(L, L + 3):
            want, _ = apply(cpu, CFG, u[:, t:t + 1], caches["cpu"])
            got, _ = apply(gpu, CFG, u[:, t:t + 1].cuda(), caches["cuda"])
            _close(got, want, dtype)
        for name, t in caches["cuda"].items():
            if name != "conv":
                _close(t, caches["cpu"][name], dtype)
