"""The CUDA matmul kernel against its plain version on the card: every
compiled CTA tile, both input types, ragged and transposed operands, and
the autograd wrapper's grads.

Marked ``gpu``: they skip without a card. The file imports neither jax nor
``repro``, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_matmul_gpu.py

Tolerances (numpy's allclose rule, rtol = atol): 2e-5 in float32 (IEEE f32
FMA, sums in another order than cuBLAS), 2e-2 in bf16 (one bf16 rounding of
the output), as ``tests/test_kernels.py`` holds the TPU kernel.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.matmul.matmul import TILES, check_tiles, lib_smem_bytes, matmul_cuda, smem_bytes
from repro_torch.kernels.matmul.ops import plan_tiles
from repro_torch.kernels.matmul.ref import matmul_ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SWEEP = [(128, 128, 128), (256, 128, 384), (300, 200, 100), (64, 512, 256), (1, 257, 33)]
ALL_TILES = list(itertools.product(TILES, TILES))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _xy(m, n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).cuda().to(dtype)
    y = torch.from_numpy(rng.standard_normal((k, n), np.float32)).cuda().to(dtype)
    return x, y


def _close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", SWEEP)
def test_matmul_kernel_sweep_planned(m, n, k, dtype):
    _cuda_or_skip()
    x, y = _xy(m, n, k, dtype)
    before = matmul_cuda.launches
    got = matmul(x, y)
    assert matmul_cuda.launches == before + 1
    _close(got, matmul_ref(x, y), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,bn", ALL_TILES)
def test_matmul_kernel_every_tile(bm, bn, dtype):
    """Each compiled instance, at a ragged shape (every edge masked) and at
    the deepest K slice its shared memory allows."""
    _cuda_or_skip()
    x, y = _xy(300, 200, 100, dtype, seed=bm + bn)
    for bk in (16, 48):
        check_tiles(bm, bn, bk)
        assert lib_smem_bytes(bm, bn, bk) == smem_bytes(bm, bn, bk)
        got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=dtype)
        _close(got, matmul_ref(x, y), TOL[dtype])
    got = matmul_cuda(x, y, bm=bm, bn=bn, bk=32, out_dtype=torch.float32)
    _close(got, matmul_ref(x, y, torch.float32), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_reads_transposes_in_place(dtype):
    _cuda_or_skip()
    x, y = _xy(96, 160, 72, dtype)
    xt, yt = x.t().contiguous().t(), y.t().contiguous().t()  # column-major views
    assert xt.stride() == (1, 96) and yt.stride() == (1, 72)
    got = matmul_cuda(xt, yt, bm=64, bn=128, bk=32, out_dtype=dtype)
    _close(got, matmul_ref(x, y), TOL[dtype])


@pytest.mark.gpu
def test_matmul_kernel_leading_dims():
    _cuda_or_skip()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 32), np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal((32, 48), np.float32)).cuda()
    got = matmul(x, y)
    assert got.shape == (2, 3, 64, 48)
    _close(got, matmul_ref(x, y), TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_grads(dtype):
    """Forward and both backward products on the kernel (three launches),
    against autograd through the plain version."""
    _cuda_or_skip()
    x, y = _xy(128, 128, 64, dtype, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((128, 128), np.float32))
    g = g.cuda().to(dtype)
    xa, ya = x.clone().requires_grad_(), y.clone().requires_grad_()
    before = matmul_cuda.launches
    gx, gy = torch.autograd.grad(matmul(xa, ya), (xa, ya), g)
    assert matmul_cuda.launches == before + 3
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    rx, ry = torch.autograd.grad(matmul_ref(xr, yr), (xr, yr), g)
    _close(gx, rx, TOL[dtype])
    _close(gy, ry, TOL[dtype])


@pytest.mark.gpu
def test_matmul_kernel_rejects_what_it_does_not_take():
    _cuda_or_skip()
    x, y = _xy(64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="compiled CTA tiles"):
        matmul_cuda(x, y, bm=32, bn=64, bk=16, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        matmul_cuda(x, y, bm=64, bn=64, bk=24, out_dtype=torch.float32)
    with pytest.raises(TypeError):
        matmul_cuda(x, y.half(), bm=64, bn=64, bk=16, out_dtype=torch.float32)
    assert plan_tiles(64, 64, 64)[0] in TILES
