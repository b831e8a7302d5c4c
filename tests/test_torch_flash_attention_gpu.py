"""The CUDA flash-attention kernel against its plain version, on the card.

Marked ``gpu``: each test skips without an NVIDIA GPU (the kernel has no
CPU mode). This file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_flash_attention_gpu.py

Tolerances are ``tests/test_kernels.py``'s: 2e-4 in float32, 3e-2 in bf16.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SWEEP = [  # (b, sq, skv, hq, hkv, d, causal): test_flash_attention_sweep's shapes
    (2, 128, 128, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, True),  # GQA 4:1
    (1, 256, 256, 4, 1, 32, True),  # MQA
    (2, 64, 192, 4, 2, 64, False),  # bidirectional, cross-length
    (1, 100, 100, 2, 2, 16, True),  # ragged
]
CASES = [(b, sq, skv, hq, hkv, d, causal, 0, None, dtype)
         for (b, sq, skv, hq, hkv, d, causal) in SWEEP
         for dtype in ("float32", "bfloat16")] + [
    # the serving decode shape: q at position kv_len-1 over a 512-slot cache
    (8, 1, 512, 16, 8, 128, False, kv - 1, kv, "bfloat16") for kv in (1, 37, 300, 512)
] + [(2, 1024, 1024, 16, 8, 128, True, 0, None, "bfloat16")]  # causal prefill


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,q_offset,kv_len,dtype", CASES)
def test_flash_kernel_matches_plain_on_gpu(b, sq, skv, hq, hkv, d, causal, q_offset,
                                           kv_len, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device="cuda", dtype=getattr(torch, dtype))
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=causal, scale=1.0 / math.sqrt(d), q_offset=q_offset,
                         kv_len=kv_len).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if kv_len is not None:  # slots past kv_len are never read
        k[:, kv_len:] = 99.0
        v[:, kv_len:] = 99.0
        again = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
        assert torch.equal(again, got)
