"""The port's flash-attention op and ``mha`` against the JAX package.

On the CPU the op runs its plain version; the same seeded numpy inputs go
through the JAX Pallas kernel in interpret mode. Tolerances are those of
``tests/test_kernels.py``: 2e-4 in float32, 3e-2 in bfloat16 (one bf16
rounding of P and of the output).
``test_torch_flash_attention_gpu.py`` holds the CUDA kernel against its
plain version on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models.layers import mha as jax_mha
from repro_torch import kernels as torch_kernels
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch import codesign
from repro_torch.codesign import H100_SMEM_BUDGET
from repro_torch.kernels.flash_attention.flash_attention import check_blocks
from repro_torch.kernels.flash_attention.ops import (
    FLASH_ATTENTION_H100,
    plan_blocks,
    planned_shape,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import mha

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SWEEP = [  # (b, sq, skv, hq, hkv, d, causal): test_flash_attention_sweep's shapes
    (2, 128, 128, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, True),  # GQA 4:1
    (1, 256, 256, 4, 1, 32, True),  # MQA
    (2, 64, 192, 4, 2, 64, False),  # bidirectional, cross-length
    (1, 100, 100, 2, 2, 16, True),  # ragged
]


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture
def kernels_off():
    torch_kernels.enable_kernels(False)
    yield
    torch_kernels.enable_kernels(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", SWEEP)
def test_flash_attention_sweep_matches_jax(b, sq, skv, hq, hkv, d, causal, dtype):
    arrs = _qkv(0, b, sq, skv, hq, hkv, d)
    want = jax_flash_attention(*_jax(arrs, dtype), causal=causal, blocks=(64, 64),
                               interpret=True)
    got = flash_attention(*_torch(arrs, dtype), causal=causal)
    assert got.shape == (b, sq, hq, d) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_decode_kv_len_mask_matches_jax():
    """Decode: 1 query over a 512-slot cache with only 300 valid entries."""
    arrs = _qkv(1, 2, 1, 512, 8, 2, 64)
    want = jax_flash_attention(*_jax(arrs, "float32"), causal=False, q_offset=299,
                               kv_len=jnp.int32(300), blocks=(8, 128), interpret=True)
    q, k, v = _torch(arrs, "float32")
    got = flash_attention(q, k, v, causal=False, q_offset=299, kv_len=300)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    # changing masked-out cache slots must not change the output
    k2 = k.clone()
    k2[:, 300:] = 99.0
    got2 = flash_attention(q, k2, v, causal=False, q_offset=299, kv_len=300)
    np.testing.assert_array_equal(_np(got2), _np(got))


def test_attention_ref_zeros_fully_masked_rows():
    q, k, v = _torch(_qkv(2, 1, 3, 8, 2, 2, 16), "float32")
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=False, scale=0.25, kv_len=0)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax(kernels_on, dtype, kernels_off):
    """Port ``mha`` (chunked reference, or the kernel op when switched on)
    against JAX ``mha``'s chunked reference, causal GQA."""
    arrs = _qkv(3, 2, 128, 128, 8, 2, 32)
    want = jax_mha(*_jax(arrs, dtype), causal=True, q_chunk=64)
    torch_kernels.enable_kernels(kernels_on)
    got = mha(*_torch(arrs, dtype), causal=True, q_chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_mha_decode_matches_jax(kernels_off):
    arrs = _qkv(4, 2, 1, 64, 4, 2, 16)
    want = jax_mha(*_jax(arrs, "float32"), causal=False, q_offset=40, kv_len=41)
    got = mha(*_torch(arrs, "float32"), causal=False, q_offset=40, kv_len=41)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,skv,d,want", [
    (1, 512, 128, (1, 96)),  # the serving decode shape: 128 keys would overrun the budget
    (1024, 1024, 64, (64, 128)),
    (64, 192, 32, (64, 32)),
    (100, 100, 16, (64, 32)),  # ragged: planned at (128, 128)
    (1, 160, 128, (1, 96)),
    (1, 96, 64, (1, 96)),
])
def test_plan_blocks_rule(sq, skv, d, want):
    """The tile is the planner's (codesign.plan on the H100 hierarchy), legal
    for the compiled kernel, and its CTA fits the shared-memory budget."""
    got = plan_blocks(sq, skv, d)
    assert got == want
    assert got == codesign.plan(FLASH_ATTENTION_H100, planned_shape(sq, skv, d)).config
    check_blocks(*got)
    assert smem_bytes(*got, d) <= H100_SMEM_BUDGET


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_qkv(5, 1, 4, 4, 2, 2, 16), "float32")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q[..., :12], k[..., :12], v[..., :12], causal=True)
    with pytest.raises(ValueError, match="bq="):
        flash_attention(q, k, v, causal=True, blocks=(8, 128))
    with pytest.raises(ValueError, match="bk="):
        flash_attention(q, k, v, causal=True, blocks=(64, 256))
    with pytest.raises(ValueError, match="kv_len=5 must lie in"):
        flash_attention(q, k, v, causal=False, q_offset=4, kv_len=5)
    with pytest.raises(ValueError, match="no path for device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), causal=True)
    # the kernel's launcher takes CUDA tensors only: no silent CPU fallback
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, k, v, causal=True, scale=0.25, q_offset=0, kv_len=4,
                             bq=64, bk=32)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 64, 64, 4, 4, 80, True),  # zamba2's head dim
    (2, 64, 64, 8, 2, 32, True),  # GQA 4:1
    (1, 32, 96, 2, 2, 16, False),  # bidirectional, cross-length
])
def test_flash_attention_grads_match_jax(b, sq, skv, hq, hkv, d, causal):
    """Grads through the op (forward on the plain path here, backward by
    recompute through ``attention_ref``) against ``jax.grad`` of the JAX op
    with its Pallas kernel in interpret mode; f32, 2e-4."""
    arrs = _qkv(9, b, sq, skv, hq, hkv, d)
    cot = np.random.default_rng(10).standard_normal((b, sq, hq, d)).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash_attention(q, k, v, causal=causal, blocks=(32, 32),
                                                    interpret=True) * cot),
        argnums=(0, 1, 2))(*_jax(arrs, "float32"))
    ts = [t.requires_grad_() for t in _torch(arrs, "float32")]
    got = torch.autograd.grad(flash_attention(*ts, causal=causal), ts, torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-4)


def test_flash_attention_d80_forward_matches_jax():
    """Head dim 80, the zamba2 width, is a compiled instance; bf16, causal."""
    arrs = _qkv(11, 1, 128, 128, 4, 4, 80)
    want = jax_flash_attention(*_jax(arrs, "bfloat16"), causal=True, blocks=(64, 64),
                               interpret=True)
    got = flash_attention(*_torch(arrs, "bfloat16"), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
