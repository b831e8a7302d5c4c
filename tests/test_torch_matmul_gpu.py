"""The CUDA matmul kernel's two instances against their plain version on the
card: the bf16 wgmma + TMA instance at every compiled tile, in every operand
orientation, with both output types; the f32 FMA instance at every compiled
tile and K slice, with aligned, unaligned and transposed operands in both
input types; the rule that routes a product to one of them; the autograd
wrapper's grads.

Marked ``gpu``: they skip without a card. The file imports neither jax nor
``repro``, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_matmul_gpu.py

Tolerances (numpy's allclose rule, rtol = atol): 2e-5 in float32 (IEEE f32
FMA, sums in another order than cuBLAS), 2e-2 in bf16 (one bf16 rounding of
the output), as ``tests/test_kernels.py`` holds the TPU kernel.
"""

import itertools
import math
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels.matmul import instance_for, matmul, plan_for
from repro_torch.kernels.matmul.matmul import (
    TC_BK,
    TC_BM,
    TC_BN,
    TILES,
    check_tiles,
    fma_tiles,
    lib_smem_bytes,
    lib_tc_smem_bytes,
    matmul_cuda,
    smem_bytes,
    tc_smem_bytes,
)
from repro_torch.kernels.matmul.ops import MATMUL_BF16_H100, plan_tiles
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.launch import quickstart

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SWEEP = [(128, 128, 128), (256, 128, 384), (300, 200, 100), (64, 512, 256), (1, 257, 33)]
ALL_TILES = list(itertools.product(TILES, TILES))
TC_TILES = list(itertools.product(TC_BM, TC_BN))
# (A M-major, B N-major): the forward is (False, True); g . y^T gives a
# K-major B, x^T . g an M-major A
ORIENTS = [(False, True), (False, False), (True, True), (True, False)]
TIMED = quickstart.MATMUL_SHAPES  # the shapes the co-design loop calibrates and chip_smoke times
HANG_S = 30.0


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _xy(m, n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).cuda().to(dtype)
    y = torch.from_numpy(rng.standard_normal((k, n), np.float32)).cuda().to(dtype)
    return x, y


def _orient(x, y, a_mn, b_mn):
    """The same matrices, A laid out M-major and B K-major where asked."""
    return (x.t().contiguous().t() if a_mn else x), (y if b_mn else y.t().contiguous().t())


def _close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


def _deepest(bm, bn):
    """The most K a wgmma ring of this tile holds within the opt-in."""
    return MATMUL_BF16_H100.legalize((bm, bn, 1 << 20), (1 << 20,) * 3)[2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", SWEEP)
def test_matmul_kernel_sweep_planned(m, n, k, dtype):
    """The planned tile on the instance the rule picks: bf16 (128, 128,
    128), (256, 128, 384) and (64, 512, 256) on wgmma; (300, 200, 100) and
    (1, 257, 33), whose rows are not 16-byte aligned, and all f32 on fma."""
    _cuda_or_skip()
    x, y = _xy(m, n, k, dtype)
    inst = instance_for(x, y)
    aligned = dtype == torch.bfloat16 and (m, n, k) not in ((300, 200, 100), (1, 257, 33))
    assert inst == ("wgmma" if aligned else "fma")
    before, by = matmul_cuda.launches, dict(matmul_cuda.launches_by_instance)
    got = matmul(x, y)
    assert matmul_cuda.launches == before + 1
    assert matmul_cuda.launches_by_instance[inst] == by[inst] + 1
    _close(got, matmul_ref(x, y), TOL[dtype])


def _f32_rounding_ratio(got, x, y) -> float:
    """Worst |got - x y| / (sqrt(K) u (|x| |y|)), x y in float64 and u =
    2^-24: the rounding estimate of a K-term f32 sum in any order, whose
    errors do not line up."""
    x64, y64 = x.double(), y.double()
    limit = math.sqrt(x.shape[-1]) * 2.0 ** -24 * (x64.abs() @ y64.abs())
    return ((got.double() - x64 @ y64).abs() / limit.clamp_min(1e-300)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("m,n,k", SWEEP)
def test_f32_within_rounding_limit_of_exact(m, n, k, seed):
    """The f32 FMA instance against a float64 evaluation, on several draws:
    within sqrt(K) u (|x| |y|), a limit that does not depend on where the
    outputs cancel; operands rounded to TF32 miss it."""
    _cuda_or_skip()
    x, y = _xy(m, n, k, torch.float32, seed=seed)
    got = matmul(x, y)
    torch.cuda.synchronize()
    assert _f32_rounding_ratio(got, x, y) <= 1.0
    tf32 = [(t.view(torch.int32) & ~0x1FFF).view(torch.float32) for t in (x, y)]
    assert _f32_rounding_ratio(matmul_ref(*tf32), x, y) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("bm,bn", TC_TILES)
def test_wgmma_first_launch_finishes(bm, bn):
    """Each wgmma tile in each orientation, once at 64x64x64, must finish
    within a host-side time limit (a wrong mbarrier parity would hang the
    CTA; the kernel also traps after 10 s in any wait)."""
    _cuda_or_skip()
    for a_mn, b_mn in ORIENTS:
        x, y = _orient(*_xy(64, 64, 64, torch.bfloat16), a_mn, b_mn)
        got = matmul_cuda(x, y, bm=bm, bn=bn, bk=TC_BK, out_dtype=torch.float32)
        done = torch.cuda.Event()
        done.record()
        t0 = time.monotonic()
        while not done.query():
            if time.monotonic() - t0 > HANG_S:
                pytest.fail(f"wgmma tile ({bm}, {bn}) A M-major {a_mn} B N-major {b_mn}: not "
                            f"done within {HANG_S} s")
            time.sleep(1e-3)
        _close(got, matmul_ref(x, y, torch.float32), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("a_mn,b_mn", ORIENTS)
@pytest.mark.parametrize("bm,bn", TC_TILES)
def test_wgmma_every_tile_and_orientation(bm, bn, a_mn, b_mn):
    """Ragged but TMA-legal (304 x 200 x 360: M, N and K all cut a tile),
    f32 and bf16 outputs, rings of one, two and the most stages."""
    _cuda_or_skip()
    x, y = _orient(*_xy(304, 200, 360, torch.bfloat16, seed=bm + bn), a_mn, b_mn)
    assert instance_for(x, y) == "wgmma"
    for out in (torch.float32, torch.bfloat16):
        for bk in (TC_BK, 2 * TC_BK, _deepest(bm, bn)):
            got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out)
            assert got.dtype == out
            _close(got, matmul_ref(x, y, out), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", TIMED)
def test_wgmma_timed_shapes_every_orientation(m, n, k):
    """The planned tile at the loop's calibration shapes, in all four operand
    orientations (the forward and both backward products)."""
    _cuda_or_skip()
    x0, y0 = _xy(m, n, k, torch.bfloat16, seed=3)
    bm, bn, bk = plan_tiles(m, n, k, dtype=torch.bfloat16)
    for a_mn, b_mn in ORIENTS:
        x, y = _orient(x0, y0, a_mn, b_mn)
        got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=torch.bfloat16)
        _close(got, matmul_ref(x, y), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", TIMED)
def test_bf16_tolerance_has_teeth_at_the_timed_shapes(m, n, k):
    """The bf16 tolerance passes the kernel and fails the plain version
    with its last 64-deep K slice dropped: a stage lost by the ring would be
    caught."""
    _cuda_or_skip()
    x, y = _xy(m, n, k, torch.bfloat16, seed=4)
    want = matmul_ref(x, y)
    _close(matmul(x, y), want, TOL[torch.bfloat16])
    dropped = matmul_ref(x[:, :k - TC_BK], y[:k - TC_BK])
    with pytest.raises(AssertionError):
        _close(dropped, want, TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,bn", ALL_TILES)
def test_matmul_kernel_every_tile(bm, bn, dtype):
    """Each compiled FMA instance, at a ragged shape (every edge masked)
    and at every K slice compiled for the tile; f32 and bf16 outputs."""
    _cuda_or_skip()
    x, y = _xy(300, 200, 100, dtype, seed=bm + bn)
    assert instance_for(x, y) == "fma"
    bks = [t[2] for t in fma_tiles() if t[:2] == (bm, bn)]
    assert 16 in bks and 32 in bks
    for bk in bks:
        check_tiles(bm, bn, bk)
        assert lib_smem_bytes(bm, bn, bk) == smem_bytes(bm, bn, bk)
        got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=dtype)
        _close(got, matmul_ref(x, y), TOL[dtype])
    got = matmul_cuda(x, y, bm=bm, bn=bn, bk=32, out_dtype=torch.float32)
    _close(got, matmul_ref(x, y, torch.float32), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("bm,bn,bk", fma_tiles())
def test_fma_every_tile_and_slice_in_every_layout(bm, bn, bk):
    """Every compiled FMA (bm, bn, bk) in the four operand orientations:
    f32 at 300x200x100 (16-byte loads: cp.async along M/N, registers along
    K), f32 and bf16 at 257x130x77 (odd strides: element loads), and a bf16
    operand 2 bytes off 16-byte alignment."""
    _cuda_or_skip()
    cases = [(300, 200, 100, torch.float32), (257, 130, 77, torch.float32),
             (257, 130, 77, torch.bfloat16)]
    for m, n, k, dtype in cases:
        for a_mn, b_mn in ORIENTS:
            x, y = _orient(*_xy(m, n, k, dtype, seed=bk), a_mn, b_mn)
            assert instance_for(x, y) == "fma"
            got = matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=dtype)
            _close(got, matmul_ref(x, y), TOL[dtype])
    buf = torch.zeros(128 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    x = buf[1:].view(128, 64).copy_(_xy(128, 96, 64, torch.bfloat16)[0])
    y = _xy(128, 96, 64, torch.bfloat16)[1]
    assert x.data_ptr() % 16 == 2 and instance_for(x, y) == "fma"
    _close(matmul_cuda(x, y, bm=bm, bn=bn, bk=bk, out_dtype=torch.float32),
           matmul_ref(x, y, torch.float32), TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_reads_transposes_in_place(dtype):
    _cuda_or_skip()
    x, y = _xy(96, 160, 72, dtype)
    xt, yt = x.t().contiguous().t(), y.t().contiguous().t()  # column-major views
    assert xt.stride() == (1, 96) and yt.stride() == (1, 72)
    bm, bn, bk = plan_for(xt, yt)
    got = matmul_cuda(xt, yt, bm=bm, bn=bn, bk=bk, out_dtype=dtype)
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
    """Forward and both backward products on the kernel (three launches,
    all on the instance of the dtype: dx = g . y^T reads a K-major B and dy
    = x^T . g an M-major A in place), against autograd through the plain
    version."""
    _cuda_or_skip()
    x, y = _xy(128, 128, 64, dtype, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((128, 128), np.float32))
    g = g.cuda().to(dtype)
    xa, ya = x.clone().requires_grad_(), y.clone().requires_grad_()
    inst = "wgmma" if dtype == torch.bfloat16 else "fma"
    before, by = matmul_cuda.launches, dict(matmul_cuda.launches_by_instance)
    gx, gy = torch.autograd.grad(matmul(xa, ya), (xa, ya), g)
    assert matmul_cuda.launches == before + 3
    assert matmul_cuda.launches_by_instance[inst] == by[inst] + 3
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    rx, ry = torch.autograd.grad(matmul_ref(xr, yr), (xr, yr), g)
    _close(gx, rx, TOL[dtype])
    _close(gy, ry, TOL[dtype])


@pytest.mark.gpu
def test_smem_formulas_match_the_compiled_kernels():
    _cuda_or_skip()
    for bm, bn, bk in fma_tiles():
        assert lib_smem_bytes(bm, bn, bk) == smem_bytes(bm, bn, bk)
    for bm, bn in TC_TILES:
        for bk in range(TC_BK, _deepest(bm, bn) + 1, TC_BK):
            assert lib_tc_smem_bytes(bm, bn, bk) == tc_smem_bytes(bm, bn, bk)


@pytest.mark.gpu
def test_matmul_kernel_rejects_what_it_does_not_take():
    _cuda_or_skip()
    x, y = _xy(64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="compiled CTA tiles"):
        matmul_cuda(x, y, bm=32, bn=64, bk=16, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        matmul_cuda(x, y, bm=64, bn=64, bk=24, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="compiled for"):
        matmul_cuda(x, y, bm=128, bn=128, bk=48, out_dtype=torch.float32)
    with pytest.raises(TypeError):
        matmul_cuda(x, y.half(), bm=64, bn=64, bk=16, out_dtype=torch.float32)
    xb, yb = x.bfloat16(), y.bfloat16()
    with pytest.raises(ValueError, match="compiled wgmma tiles"):
        matmul_cuda(xb, yb, bm=64, bn=32, bk=64, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 64"):
        matmul_cuda(xb, yb, bm=64, bn=64, bk=32, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="opt-in"):
        matmul_cuda(xb, yb, bm=128, bn=256, bk=5 * TC_BK, out_dtype=torch.float32)
    assert plan_tiles(64, 64, 64)[0] in TILES
