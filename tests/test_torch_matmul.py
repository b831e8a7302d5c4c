"""The port's matmul op on the CPU (its plain version) against the JAX
package's ``matmul(..., interpret=True)``, the quickstart loop, and the
op's checks.

Inputs come from a seeded numpy generator and pass between the packages as
numpy arrays. Tolerances are ``tests/test_kernels.py``'s (numpy's allclose
rule, rtol = atol): 2e-5 in float32, 2e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul as jax_matmul

from repro_torch.kernels.matmul import MATMUL_H100, matmul, plan_tiles
from repro_torch.kernels.matmul.matmul import TILES, matmul_cuda
from repro_torch.kernels.matmul.ops import planned_shape
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.launch import quickstart

SWEEP = [(128, 128, 128), (256, 128, 384), (300, 200, 100), (64, 512, 256), (1, 257, 33)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _xy(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), np.float32), rng.standard_normal((k, n), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", SWEEP)
def test_matmul_matches_jax(m, n, k, dtype):
    x, y = _xy(m, n, k)
    want = jax_matmul(jnp.asarray(x).astype(_J[dtype]), jnp.asarray(y).astype(_J[dtype]),
                      interpret=True)
    got = matmul(torch.from_numpy(x).to(_T[dtype]), torch.from_numpy(y).to(_T[dtype]))
    assert got.dtype == _T[dtype] and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_matmul_leading_dims_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64, 32), np.float32)
    y = rng.standard_normal((32, 48), np.float32)
    want = jax_matmul(jnp.asarray(x), jnp.asarray(y), interpret=True)
    got = matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 3, 64, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_matmul_grads_match_jax():
    x, y = _xy(128, 128, 64, seed=2)
    gx, gy = jax.grad(lambda a, b: jax_matmul(a, b, interpret=True).sum(), (0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    matmul(xt, yt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), rtol=2e-5, atol=2e-5)


def test_plain_path_launches_nothing_and_plans_aligned_shapes():
    before = matmul_cuda.launches
    x, y = _xy(300, 200, 100)
    matmul(torch.from_numpy(x), torch.from_numpy(y))
    assert matmul_cuda.launches == before
    assert planned_shape(300, 200, 100) == (320, 256, 112)
    bm, bn, bk = plan_tiles(300, 200, 100)
    assert bm in TILES and bn in TILES and bk % 16 == 0
    assert MATMUL_H100.legalize((bm, bn, bk), planned_shape(300, 200, 100)) == (bm, bn, bk)


def test_matmul_checks_its_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="inner dims"):
        matmul(x, torch.zeros(7, 3))
    with pytest.raises(ValueError, match="no path for device"):
        matmul(x.to("meta"), torch.zeros(8, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(x, torch.zeros(8, 3), bm=64, bn=64, bk=16, out_dtype=torch.float32)
    assert torch.equal(matmul_ref(x, torch.ones(8, 3)), torch.zeros(4, 3))


def test_quickstart_runs_on_the_cpu(capsys):
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Union-planned CTA tile" in out and "loop nest" in out
    assert tuple(res["tiles"]) == plan_tiles(*quickstart.GEMM)
    assert max(res["max_abs_err"].values()) <= quickstart.TOL


def test_quickstart_calibrates_every_space_on_the_cpu():
    shapes = {"matmul_h100": [(128, 128, 128)], "flash_attention_h100": [(1, 64, 16)],
              "ssd_scan_h100": [(16, 8)]}
    rows, scales = quickstart.calibrate("cpu", shapes, repeats=1, iters=1)
    assert [r["kernel"] for r in rows] == list(shapes)
    for r in rows:
        assert r["interpret"] and r["measured_s"] > 0 and r["predicted_s"] > 0
        assert r["default_over_planned"] >= 1.0 and np.isfinite(r["error_pct"])
        assert r["launches"] == 0  # the CPU runs the plain versions
    assert set(scales) == set(shapes) and all(s > 0 for s in scales.values())
