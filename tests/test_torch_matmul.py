"""The port's matmul op on the CPU (its plain version) against the JAX
package's ``matmul(..., interpret=True)``, the quickstart loop, the op's
checks, the rule that routes a product to the wgmma or the FMA instance,
and the bf16 space (``matmul_bf16_h100``) that plans the wgmma instance.

Inputs come from a seeded numpy generator and pass between the packages as
numpy arrays. Tolerances are ``tests/test_kernels.py``'s (numpy's allclose
rule, rtol = atol): 2e-5 in float32, 2e-2 in bf16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul as jax_matmul

from repro_torch import codesign
from repro_torch.core.cost.store import ResultStore
from repro_torch.kernels.matmul import (
    MATMUL_BF16_H100,
    MATMUL_H100,
    instance_for,
    matmul,
    plan_for,
    plan_tiles,
)
from repro_torch.kernels.matmul.matmul import (
    SMEM_OPTIN,
    TC_BK,
    TILES,
    check_tc_tiles,
    check_tiles,
    fma_tiles,
    matmul_cuda,
    tc_smem_bytes,
)
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


# ------------------------------------------------------------------ #
# the two instances: routing, the bf16 space, planning per dtype
# ------------------------------------------------------------------ #
def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _offset(*shape):
    """A bf16 matrix whose base sits 2 bytes past 16-byte alignment."""
    buf = torch.zeros(math.prod(shape) + 1, dtype=torch.bfloat16)
    return buf[1:].view(*shape)


ROUTES = {
    "bf16 row-major": (lambda: (_bf(128, 64), _bf(64, 96)), "wgmma"),
    "bf16 A M-major (x^T . g)": (lambda: (_bf(64, 128).t(), _bf(64, 96)), "wgmma"),
    "bf16 B K-major (g . y^T)": (lambda: (_bf(128, 64), _bf(96, 64).t()), "wgmma"),
    "bf16 both transposed": (lambda: (_bf(64, 128).t(), _bf(96, 64).t()), "wgmma"),
    "bf16 one row": (lambda: (_bf(1, 64), _bf(64, 96)), "wgmma"),
    "bf16 on meta": (lambda: (torch.empty(128, 64, dtype=torch.bfloat16, device="meta"),
                              torch.empty(64, 96, dtype=torch.bfloat16, device="meta")), "wgmma"),
    "bf16 ragged rows (300x200x100)": (lambda: (_bf(300, 100), _bf(100, 200)), "fma"),
    "bf16 (1, 257, 33)": (lambda: (_bf(1, 33), _bf(33, 257)), "fma"),
    "bf16 base off 16 bytes": (lambda: (_offset(128, 64), _bf(64, 96)), "fma"),
    "bf16 broadcast (stride 0)": (lambda: (_bf(1, 64).expand(128, 64), _bf(64, 96)), "fma"),
    "bf16 strided rows": (lambda: (_bf(128, 128)[:, ::2], _bf(64, 96)), "fma"),
    "f32 row-major": (lambda: (torch.zeros(128, 64), torch.zeros(64, 96)), "fma"),
    "mixed dtypes": (lambda: (_bf(128, 64), torch.zeros(64, 96)), "fma"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_instance_for_routes_by_layout(case):
    make, want = ROUTES[case]
    x, y = make()
    assert instance_for(x, y) == want


def test_plan_for_plans_in_the_routed_instances_space():
    x, y = _bf(512, 768), _bf(768, 3072)
    assert plan_for(x, y) == plan_tiles(512, 3072, 768, dtype=torch.bfloat16)
    check_tc_tiles(*plan_for(x, y))
    x, y = _bf(300, 100), _bf(100, 200)  # TMA cannot read x: the FMA instance's space
    assert plan_for(x, y) == plan_tiles(300, 200, 100)
    check_tiles(*plan_for(x, y))


@pytest.mark.parametrize("seed", range(4))
def test_bf16_legalize_is_binding(seed):
    """Any proposal at any shape becomes a compiled wgmma tile whose CTA
    (stages, mbarriers, alignment slack) fits the opt-in, and legalize is
    idempotent."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        shape = tuple(int(v) for v in rng.integers(1, 20_000, 3))
        prop = tuple(int(v) for v in rng.integers(0, 5_000, 3))
        cfg = MATMUL_BF16_H100.legalize(prop, shape)
        check_tc_tiles(*cfg)
        assert MATMUL_BF16_H100.legalize(cfg, shape) == cfg
        assert tc_smem_bytes(*cfg) <= MATMUL_BF16_H100.smem_budget == SMEM_OPTIN
        assert cfg[2] <= max(TC_BK, -(-shape[2] // TC_BK) * TC_BK)
        f32 = MATMUL_H100.legalize(prop, shape)
        assert f32 in fma_tiles()


def test_bf16_smem_formula():
    # 1024 B alignment slack, 4 stages of (128 + 256) rows of 128 B, 8 mbarriers
    assert tc_smem_bytes(128, 256, 256) == 1024 + 4 * 384 * 128 + 64 == 197_696
    assert MATMUL_BF16_H100.legalize((128, 256, 1 << 20), (1 << 20,) * 3) == (128, 256, 256)
    assert MATMUL_BF16_H100.legalize((64, 64, 1 << 20), (1 << 20,) * 3)[2] == 14 * TC_BK


@pytest.mark.parametrize("shape", quickstart.MATMUL_SHAPES)
def test_bf16_plans_at_the_calibration_shapes(shape):
    p = codesign.plan(MATMUL_BF16_H100, shape, store=ResultStore())
    check_tc_tiles(*p.config)
    assert MATMUL_BF16_H100.legalize(p.config, shape) == p.config
    assert tc_smem_bytes(*p.config) <= SMEM_OPTIN
    assert p.source in ("search", "default")
    assert plan_tiles(*shape, dtype=torch.bfloat16) == p.config
    assert planned_shape(*shape, dtype=torch.bfloat16) == shape
    check_tiles(*plan_tiles(*shape))  # the f32 plan is an FMA tile


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 384), (64, 512, 256)])
def test_bf16_matmul_at_the_bf16_plan_matches_jax(m, n, k):
    x, y = _xy(m, n, k, seed=5)
    tiles = plan_tiles(m, n, k, dtype=torch.bfloat16)
    check_tc_tiles(*tiles)
    xb, yb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    assert instance_for(xb, yb) == "wgmma"
    want = jax_matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y).astype(jnp.bfloat16),
                      interpret=True)
    got = matmul(xb, yb, tiles=tiles)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def test_quickstart_calibrates_both_matmul_spaces_on_the_cpu():
    assert set(quickstart.CALIBRATION_SHAPES) == {
        "matmul_h100", "matmul_bf16_h100", "flash_attention_h100", "ssd_scan_h100"}
    assert quickstart.CALIBRATION_SHAPES["matmul_bf16_h100"] == quickstart.MATMUL_SHAPES
    shapes = {"matmul_h100": [(128, 128, 128)], "matmul_bf16_h100": [(128, 128, 128)],
              "flash_attention_h100": [(1, 64, 16)], "ssd_scan_h100": [(16, 8)]}
    rows, scales = quickstart.calibrate("cpu", shapes, repeats=1, iters=1)
    assert [r["kernel"] for r in rows] == list(shapes)
    check_tiles(*rows[0]["config"])
    check_tc_tiles(*rows[1]["config"])
    for r in rows:
        assert r["interpret"] and r["measured_s"] > 0 and r["launches"] == 0
    assert set(scales) == set(shapes) and all(s > 0 for s in scales.values())


def test_run_matmul_plans_per_dtype():
    res = quickstart.run_matmul(128, 256, 192, "cpu")
    tiles = res["tiles_by_dtype"]
    assert tiles["float32"] == res["tiles"] == list(plan_tiles(128, 256, 192))
    assert tiles["bfloat16"] == list(plan_tiles(128, 256, 192, dtype=torch.bfloat16))
    check_tiles(*tiles["float32"])
    check_tc_tiles(*tiles["bfloat16"])
    assert max(res["max_abs_err"].values()) <= quickstart.TOL
    assert res["launches"] == 0 and res["launches_by_instance"] == {"wgmma": 0, "fma": 0}


def test_run_matmul_plans_a_product_tma_cannot_read_in_the_fma_space():
    """K = 33 gives bf16 rows of 66 bytes, which TMA cannot read: step 4
    routes that product to the FMA instance and plans it there."""
    res = quickstart.run_matmul(64, 128, 33, "cpu")
    assert res["tiles_by_dtype"]["bfloat16"] == list(plan_tiles(64, 128, 33))
    assert max(res["max_abs_err"].values()) <= quickstart.TOL


def test_bf16_space_runs_only_on_the_wgmma_instance():
    gen = torch.Generator().manual_seed(0)
    ok = MATMUL_BF16_H100.example_inputs((64, 128, 64), "cpu", gen)
    got = MATMUL_BF16_H100.run(ok, (64, 128, 64))
    assert torch.equal(got, matmul_ref(*ok))
    x, y = MATMUL_BF16_H100.example_inputs((64, 128, 33), "cpu", gen)
    assert instance_for(x, y) == "fma"
    with pytest.raises(ValueError, match="FMA instance"):
        MATMUL_BF16_H100.run((x, y), (64, 128, 64))


def test_tiles_from_mapping_reads_the_leaf_level_as_jax():
    """``tiles_from_mapping`` on the same search in both packages (the
    reference's ``test_tiles_from_mapping_reads_leaf_level``): the heuristic
    mapper under the timeloop-like model on ``tpu_chip()``, latency, MXU
    aligned; the leaf level's (bm, bn, bk) agree."""
    from repro.core.architecture import tpu_chip as jax_tpu_chip
    from repro.core.constraints import mxu_aligned as jax_mxu_aligned
    from repro.core.optimizer import union_opt as jax_union_opt
    from repro.core.problem import Problem as JaxProblem
    from repro.kernels.matmul.ops import tiles_from_mapping as jax_tiles_from_mapping

    from repro_torch.core.architecture import tpu_chip
    from repro_torch.core.constraints import mxu_aligned
    from repro_torch.core.optimizer import union_opt
    from repro_torch.core.problem import Problem
    from repro_torch.kernels.matmul import tiles_from_mapping

    p, jp = Problem.gemm(1024, 1024, 1024), JaxProblem.gemm(1024, 1024, 1024)
    sol = union_opt(p, tpu_chip(), mapper="heuristic", cost_model="timeloop",
                    metric="latency", constraints=mxu_aligned(["m", "n", "k"]))
    jsol = jax_union_opt(jp, jax_tpu_chip(), mapper="heuristic", cost_model="timeloop",
                         metric="latency", constraints=jax_mxu_aligned(["m", "n", "k"]))
    tiles = tiles_from_mapping(sol.mapping, p)
    assert tiles == jax_tiles_from_mapping(jsol.mapping, jp)
    assert tiles[0] == sol.mapping.levels[-1].tt("m")
    assert all(t % 128 == 0 for t in tiles)
