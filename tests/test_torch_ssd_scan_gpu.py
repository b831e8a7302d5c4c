"""The CUDA SSD kernel and the flash-attention kernel's D = 80 instance
against their plain versions on the card.

Marked ``gpu``: they skip without a card. The file imports neither jax nor
``repro``, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_ssd_scan_gpu.py

Tolerances: 1e-4 for the SSD scan (``tests/test_kernels.py``'s bound; all
f32, sums taken in another order); 2e-4 in float32 and 3e-2 in bf16 for
flash attention (one bf16 rounding of P and of the output).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref, ssd_recurrent_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (
    shares_scores,
    smem_bytes,
    smem_formula,
    ssd_intra_chunk_cuda,
)

SSD_TOL = 1e-4
FA_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# (b, l, nh, hp, n, chunk): test_ssd_sweep's shapes, then zamba2-2.7b's
# training shape (b=2, 2048 steps, 80 heads of 64, state 64, chunk 256)
SSD_SHAPES = [
    (2, 128, 3, 16, 8, 32),
    (1, 64, 2, 8, 4, 64),
    (2, 96, 1, 32, 16, 16),
    (2, 2048, 80, 64, 64, 256),
]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _ssd_inputs(b, l, nh, hp, n, shared_bc, seed=0):
    """dt-scaled x, dA = -softplus(N(0,1)) and B/C as the model builds them;
    with ``shared_bc`` one group's B/C is expanded over heads with stride 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, hp), np.float32) * 0.5
    dA = -np.log1p(np.exp(rng.standard_normal((b, l, nh), np.float32)))
    bc_heads = 1 if shared_bc else nh
    B = rng.standard_normal((b, l, bc_heads, n), np.float32) * 0.5
    C = rng.standard_normal((b, l, bc_heads, n), np.float32) * 0.5
    x, dA, B, C = (torch.from_numpy(a).cuda() for a in (x, dA, B, C))
    if shared_bc:
        B, C = B.expand(b, l, nh, n), C.expand(b, l, nh, n)
    return x, dA, B, C


@pytest.mark.gpu
@pytest.mark.parametrize("shared_bc", [False, True])
@pytest.mark.parametrize("b,l,nh,hp,n,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain_on_gpu(b, l, nh, hp, n, chunk, shared_bc):
    _cuda_or_skip()
    x, dA, B, C = _ssd_inputs(b, l, nh, hp, n, shared_bc)
    before = ssd_intra_chunk_cuda.launches
    got = ssd_intra_chunk_cuda(x, dA, B, C, chunk)
    torch.cuda.synchronize()
    # the score kernel, where B/C are shared by the heads, then the main kernel
    assert ssd_intra_chunk_cuda.launches == before + (2 if shares_scores(B, C) else 1)
    want = ssd_intra_chunk_ref(x, dA, B, C, chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=SSD_TOL, atol=SSD_TOL)


def _check_ssd(x, dA, B, C, chunk):
    before = ssd_intra_chunk_cuda.launches
    got = ssd_intra_chunk_cuda(x, dA, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_cuda.launches == before + (2 if shares_scores(B, C) else 1)
    want = ssd_intra_chunk_ref(x, dA, B, C, chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=SSD_TOL, atol=SSD_TOL)


# every compiled instance: scores from the score kernel (B/C shared by the
# heads, stride 0) or built per CTA (per-head B/C), state dims up to 64 and
# up to 128
@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_every_instance(shared, n):
    _cuda_or_skip()
    x, dA, B, C = _ssd_inputs(2, 512, 8, 64, n, shared, seed=n)
    assert shares_scores(B, C) == shared
    _check_ssd(x, dA, B, C, 256)


@pytest.mark.gpu
def test_compiled_smem_equals_the_formula():
    """The compiled ssd_smem_bytes equals the Python formula (which the
    space's legalize binds) for both instances."""
    _cuda_or_skip()
    for shared in (False, True):
        for n in (1, 64, 65, 128):
            for cl in (1, 31, 256, 1024):
                assert smem_bytes(cl, n, shared) == smem_formula(cl, n, shared), (cl, n, shared)


# head and state dims up to 128, not multiples of 8 (zero-filled tails) or
# of 4 (rows not 16-byte aligned: 4-byte copies), hp in two 64-wide slices
@pytest.mark.gpu
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("hp,n", [(128, 128), (96, 96), (8, 8), (20, 12), (10, 6), (128, 20),
                                  (72, 100)])
def test_ssd_head_and_state_dims(hp, n, shared):
    _cuda_or_skip()
    _check_ssd(*_ssd_inputs(2, 256, 4, hp, n, shared, seed=hp + n), 128)


# chunk lengths from 16 to the longest the kernel takes, and ones that are
# not multiples of 16 or 32
@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 32, 64, 256, 1024, 1, 7, 40, 100])
def test_ssd_chunk_lengths(chunk):
    _cuda_or_skip()
    l = chunk * max(1, 2048 // chunk // 2)
    _check_ssd(*_ssd_inputs(1, l, 4, 64, 64, True, seed=chunk), chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,nh,hp,n,chunk", SSD_SHAPES[:3])
def test_ssd_chunked_matches_recurrence_on_gpu(b, l, nh, hp, n, chunk):
    _cuda_or_skip()
    x, dA, B, C = _ssd_inputs(b, l, nh, hp, n, shared_bc=False, seed=1)
    y, S = ssd_chunked(x, dA, B, C, chunk=chunk)
    y_r, S_r = ssd_recurrent_ref(x, dA, B, C)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(S.cpu().numpy(), S_r.cpu().numpy(), rtol=SSD_TOL, atol=SSD_TOL)


FA_CASES = [  # (b, sq, skv, hq, hkv, d, causal, dtype)
    (2, 2048, 2048, 32, 32, 80, True, "bfloat16"),  # zamba2-2.7b training shape
    (2, 128, 128, 4, 4, 80, True, "float32"),
    (2, 128, 128, 8, 2, 80, True, "float32"),
    (1, 100, 100, 2, 2, 80, True, "float32"),
    (2, 64, 192, 4, 2, 80, False, "float32"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,dtype", FA_CASES)
def test_flash_kernel_d80_matches_plain_on_gpu(b, sq, skv, hq, hkv, d, causal, dtype):
    _cuda_or_skip()
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device="cuda", dtype=getattr(torch, dtype))
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=causal, scale=1.0 / math.sqrt(d)).transpose(1, 2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


@pytest.mark.gpu
def test_flash_backward_matches_plain_on_gpu():
    """Grads through the op (kernel forward, recompute backward) equal the
    plain version's grads, float32."""
    _cuda_or_skip()
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).cuda().requires_grad_()
               for s in ((2, 64, 4, 80), (2, 64, 2, 80), (2, 64, 2, 80)))
    g = torch.from_numpy(rng.standard_normal((2, 64, 4, 80), np.float32)).cuda()
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), g)
    want = torch.autograd.grad(
        attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                      scale=1.0 / math.sqrt(80)).transpose(1, 2), (q, k, v), g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("shared_bc", [False, True])
def test_ssd_kernel_within_tolerance_of_exact_at_training_shape(shared_bc, seed):
    """At zamba2-2.7b's training shape, where the chunk's cumulative decay
    reaches ~-180, the kernel is held to the plain version evaluated in
    float64 (the exact answer) within rtol = atol = 1e-4, on several
    seeded inputs."""
    _cuda_or_skip()
    shape = SSD_SHAPES[-1]
    x, dA, B, C = _ssd_inputs(*shape[:5], shared_bc, seed=seed)
    got = ssd_intra_chunk_cuda(x, dA, B, C, shape[5])
    want = ssd_intra_chunk_ref(x, dA, B, C, shape[5], dtype=torch.float64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.double().cpu().numpy(), w.cpu().numpy(),
                                   rtol=SSD_TOL, atol=SSD_TOL)
