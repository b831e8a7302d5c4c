"""The port's co-design layer (``src/repro_torch/core``, ``codesign``) against
the JAX package's, on the CPU.

* ``union_opt``: the same problem on the same hierarchy gives the same best
  mapping and cost, bit for bit (both run the numpy engine).
* ``codesign.plan``: test-local copies of the JAX kernel spaces, built on
  the port's ``tpu_chip``, plan the same config at the same predicted
  cycles as ``repro.kernels.*.ops``.
* The port's copies of ``test_codesign.py``'s plan-store, key, fallback and
  calibration-table tests, on the H100 spaces.
* The H100 spaces' ``legalize`` is binding (hypothesis over shapes and
  proposals), and their canonical mapping spreads the CTA grid over the SMs.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.codesign import plan as jax_plan, repair_tile
from repro.core.architecture import cloud_accelerator as jax_cloud, tpu_chip as jax_tpu
from repro.core.mapping import mapping_signature as jax_signature
from repro.core.optimizer import union_opt as jax_union_opt
from repro.core.problem import Problem as JaxProblem
from repro.kernels.flash_attention.ops import FLASH_ATTENTION_SPACE
from repro.kernels.matmul.ops import MATMUL_SPACE
from repro.kernels.ssd_scan.ops import SSD_SCAN_SPACE

from repro_torch import codesign
from repro_torch.codesign import (
    H100_SMEM_BUDGET,
    CalibrationScale,
    CalibrationTable,
    KernelSpace,
    plan,
    planner_stats,
    reset_planner_stats,
)
from repro_torch.core.architecture import cloud_accelerator, h100_sm, tpu_chip
from repro_torch.core.constraints import mxu_aligned
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.cost.maestro_like import MaestroLikeModel
from repro_torch.core.cost.store import ResultStore
from repro_torch.core.cost.timeloop_like import TimeloopLikeModel
from repro_torch.core.mappers import MAPPER_REGISTRY
from repro_torch.core.mapping import mapping_signature
from repro_torch.core.optimizer import union_opt
from repro_torch.core.problem import Problem
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS, ROW_TILES, check_blocks
from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION_H100
from repro_torch.kernels.flash_attention.ops import smem_bytes as fa_smem
from repro_torch.kernels.matmul.matmul import check_tiles
from repro_torch.kernels.matmul.matmul import smem_bytes as mm_smem
from repro_torch.kernels.matmul.ops import MATMUL_H100
from repro_torch.kernels.ssd_scan.ops import SSD_SCAN_H100
from repro_torch.kernels.ssd_scan.ops import smem_bytes as ssd_smem

ROOT = Path(__file__).resolve().parents[1]
V8 = 8 * (1 << 20)  # the JAX spaces' VMEM budget


# ------------------------------------------------------------------ #
# union_opt: the port's core against the JAX package's, bit for bit
# ------------------------------------------------------------------ #
def _problems(P):
    return {
        "gemm": P.gemm(128, 256, 64),
        "conv2d": P.conv2d(1, 16, 8, 8, 8, 3, 3),
    }


@pytest.mark.parametrize("arch", ["cloud", "tpu_chip"])
@pytest.mark.parametrize("model", ["timeloop", "maestro"])
@pytest.mark.parametrize("kind", ["gemm", "conv2d"])
def test_union_opt_matches_jax_package(kind, model, arch):
    archs = {"cloud": (cloud_accelerator, jax_cloud), "tpu_chip": (tpu_chip, jax_tpu)}[arch]
    got = union_opt(_problems(Problem)[kind], archs[0](), mapper="heuristic",
                    cost_model=model, metric="edp", climb_steps=60)
    want = jax_union_opt(_problems(JaxProblem)[kind], archs[1](), mapper="heuristic",
                         cost_model=model, metric="edp", climb_steps=60)
    dims = tuple(got.problem.dims)
    assert mapping_signature(got.mapping, dims) == jax_signature(want.mapping, dims)
    for f in ("latency_cycles", "energy_pj", "utilization", "macs", "frequency_hz"):
        assert getattr(got.cost, f) == getattr(want.cost, f), f
    assert got.search.considered == want.search.considered


def test_engine_backends_agree_and_jax_raises():
    problem, arch = Problem.gemm(128, 256, 64), cloud_accelerator()
    costs = {}
    for backend in ("numpy", None):
        sol = union_opt(problem, arch, mapper="heuristic", cost_model="timeloop",
                        metric="edp", engine_backend=backend, climb_steps=60)
        costs[backend] = (sol.cost.latency_cycles, sol.cost.energy_pj)
    assert costs["numpy"] == costs[None]
    for bad in ("jax", "torch", "bogus"):
        with pytest.raises(ValueError, match="engine backend"):
            EvaluationEngine(TimeloopLikeModel(), problem, arch, backend=bad)


def test_unported_mappers_and_models_raise():
    with pytest.raises(KeyError, match="still to be ported"):
        MAPPER_REGISTRY["genetic"]
    with pytest.raises(KeyError, match="heuristic"):
        union_opt(Problem.gemm(64, 64, 64), cloud_accelerator(), mapper="random")
    with pytest.raises(KeyError):
        union_opt(Problem.gemm(64, 64, 64), cloud_accelerator(), cost_model="tpu_roofline")


# ------------------------------------------------------------------ #
# codesign.plan: the JAX spaces, copied onto the port's tpu_chip
# ------------------------------------------------------------------ #
class _TpuSpace(KernelSpace):
    smem_budget = V8

    def arch(self, smem_budget=None):
        return tpu_chip(vmem_tile_budget=int(smem_budget or self.smem_budget))


class _JaxMatmulSpace(_TpuSpace):
    name = "matmul"
    decode_dims = ("m", "n", "k")
    search_budget = 400

    def problem(self, shape):
        return Problem.gemm(*shape)

    def constraints(self, shape):
        return mxu_aligned(["m", "n", "k"], 128)

    def legalize(self, config, shape, smem_budget=None):
        (bm, bn, bk), (M, N, K) = config, shape
        return repair_tile(bm, M, 256), repair_tile(bn, N, 256), repair_tile(bk, K, 512)


class _JaxFlashSpace(_TpuSpace):
    name = "flash_attention"
    decode_dims = ("q", "k")
    search_budget = 200

    def problem(self, shape):
        Sq, Skv, D = shape
        return Problem.from_einsum("attn_scores", "qd,kd->qk", {"q": Sq, "k": Skv, "d": D}, "GEMM")

    def constraints(self, shape):
        return mxu_aligned(["q", "k"], 128)

    def legalize(self, config, shape, smem_budget=None):
        (bq, bk), (Sq, Skv, _D) = config, shape
        return repair_tile(bq, Sq, 512, cap=1024), repair_tile(bk, Skv, 512, cap=1024)


class _JaxSsdSpace(_TpuSpace):
    name = "ssd_scan"
    decode_dims = ("l",)
    search_budget = 200

    def problem(self, shape):
        hp, n = shape
        return Problem.from_einsum("ssd_scores", "ln,mn->lm", {"l": 1024, "m": 1024, "n": n}, "GEMM")

    def legalize(self, config, shape, smem_budget=None):
        hp, n = shape
        budget, cl = int(smem_budget or self.smem_budget), 1024
        while cl > 64:
            if 4 * (2 * cl * cl + cl * (hp + 2 * n + 2) + n * hp) <= budget:
                return (cl,)
            cl //= 2
        return (64,)

    def block_tiles(self, shape, config):
        return {"l": config[0], "m": config[0]}


@pytest.mark.parametrize("local,ref,shape", [
    (_JaxMatmulSpace(), MATMUL_SPACE, (128, 128, 128)),
    (_JaxMatmulSpace(), MATMUL_SPACE, (256, 128, 384)),
    (_JaxMatmulSpace(), MATMUL_SPACE, (512, 256, 256)),
    (_JaxFlashSpace(), FLASH_ATTENTION_SPACE, (128, 128, 64)),
    (_JaxFlashSpace(), FLASH_ATTENTION_SPACE, (256, 512, 64)),
    (_JaxSsdSpace(), SSD_SCAN_SPACE, (64, 64)),
    (_JaxSsdSpace(), SSD_SCAN_SPACE, (16, 8)),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else getattr(v, "name", None))
def test_plan_matches_jax_package_on_tpu_chip(local, ref, shape):
    got = plan(local, shape, store=ResultStore())
    want = jax_plan(ref, shape)
    assert got.config == want.config
    assert got.cost.latency_cycles == want.cost.latency_cycles
    assert got.cost.energy_pj == want.cost.energy_pj


# ------------------------------------------------------------------ #
# the H100 spaces: binding legalize, grid spread over the SMs
# ------------------------------------------------------------------ #
def test_h100_legalize_is_binding_for_any_shape_and_proposal():
    pytest.importorskip("hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
    from hypothesis import given, settings, strategies as st

    dim, prop = st.integers(1, 10_000), st.integers(0, 10_000)

    @given(dim, dim, dim, prop, prop, prop, st.sampled_from(HEAD_DIMS))
    @settings(max_examples=300, deadline=None)
    def check(a, b, c, p, q, r, d):
        bm, bn, bk = MATMUL_H100.legalize((p, q, r), (a, b, c))
        check_tiles(bm, bn, bk)  # a compiled instance; the kernel masks ragged edges
        assert bk <= max(16, -(-c // 16) * 16)
        assert mm_smem(bm, bn, bk) <= H100_SMEM_BUDGET
        bq, bkv = FLASH_ATTENTION_H100.legalize((p, q), (a, b, d))
        check_blocks(bq, bkv)
        assert bq in ROW_TILES and (bq == 1) == (a == 1)
        assert fa_smem(bq, bkv, d) <= H100_SMEM_BUDGET
        (cl,) = SSD_SCAN_H100.legalize((r,), (min(a, 64), min(b, 64)))
        assert cl & (cl - 1) == 0 and 64 <= cl <= 1024
        assert ssd_smem(cl) <= H100_SMEM_BUDGET

    check()


def test_h100_hierarchy_is_the_data_sheet():
    arch = h100_sm()
    assert [c.name for c in arch.clusters] == ["HBM", "CTA", "SMEM"]
    assert arch.clusters[1].fanout == 132 and arch.clusters[1].virtual
    assert arch.clusters[2].memory_bytes == H100_SMEM_BUDGET == 232_448 // 2
    peak = 2 * arch.peak_macs_per_cycle * arch.frequency_hz
    assert peak == pytest.approx(989e12)


def test_canonical_mapping_spreads_the_grid_over_the_sms():
    shape, config = (512, 3072, 768), (64, 128, 64)
    problem, mapping, arch = MATMUL_H100.canonical_mapping(shape, config)
    fan = mapping.spatial_fanout(0, problem)
    assert fan.get("k", 1) == 1  # the reduction stays inside the CTA
    assert fan["m"] * fan["n"] == 96  # 8 x 24 tiles: the most that divides and fits 132
    assert mapping.is_legal(problem, arch)
    # a tile that leaves SMs idle costs more in the model
    wide = codesign.predict_cost(MATMUL_H100, (128, 128, 768), (64, 64, 64))
    narrow = codesign.predict_cost(MATMUL_H100, (128, 128, 768), (128, 128, 64))
    assert wide.latency_cycles < narrow.latency_cycles


@pytest.mark.parametrize("space,shape", [
    (MATMUL_H100, (512, 3072, 768)),
    (MATMUL_H100, (1024, 1024, 1024)),
    (MATMUL_H100, (4096, 10240, 2560)),
    (FLASH_ATTENTION_H100, (2048, 2048, 80)),
    (SSD_SCAN_H100, (64, 64)),
])
def test_h100_plan_is_never_rated_slower_than_the_default(space, shape):
    # the plan is scored as launched (the grid spread over the SMs), and the
    # default replaces the searched tile where that mapping costs less
    p = codesign.plan(space, shape, store=ResultStore())
    default = space.legalize(space.default_config(shape), shape)
    d_cost = codesign.predict_cost(space, shape, default)
    assert p.cost.latency_cycles <= d_cost.latency_cycles
    assert p.cost.latency_cycles == codesign.predict_cost(space, shape, p.config).latency_cycles
    if p.source == "default":
        assert p.config == default and p.searched not in (None, default)
        s_cost = codesign.predict_cost(space, shape, p.searched)
        assert s_cost.latency_cycles > d_cost.latency_cycles
    else:
        assert p.source == "search" and p.searched is None


@pytest.mark.parametrize("space,shape", [
    (MATMUL_H100, (300, 200, 100)),
    (FLASH_ATTENTION_H100, (100, 192, 64)),
    (SSD_SCAN_H100, (16, 8)),
])
def test_space_run_matches_its_reference_on_the_cpu(space, shape):
    p = codesign.plan(space, shape, store=ResultStore())
    inputs = space.example_inputs(shape, "cpu", torch.Generator().manual_seed(0))
    got, want = space.run(inputs, p.config), space.reference(inputs, p.config)
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_canonical_mapping_on_tpu_chip_is_the_jax_one():
    shape, config = (256, 256, 256), (128, 128, 128)
    _p, got, _a = _JaxMatmulSpace().canonical_mapping(shape, config)
    _p, want, _a = MATMUL_SPACE.canonical_mapping(shape, config)
    assert mapping_signature(got, ("m", "k", "n")) == jax_signature(want, ("m", "k", "n"))


def test_space_names_differ_from_the_tpu_spaces():
    spaces = codesign.all_spaces()
    assert {"matmul_h100", "flash_attention_h100", "ssd_scan_h100"} <= set(spaces)
    for name in spaces:
        assert codesign.get_space(name) is spaces[name]
    assert not {"matmul", "flash_attention", "ssd_scan"} & set(spaces)


# ------------------------------------------------------------------ #
# plan store, keys, fallbacks (copies of test_codesign.py's, on the H100)
# ------------------------------------------------------------------ #
def test_warm_plan_query_skips_search():
    store = ResultStore()
    reset_planner_stats()
    p1 = plan(MATMUL_H100, (128, 128, 128), store=store)
    assert (planner_stats()["plan_searches"], planner_stats()["plan_store_hits"]) == (1, 0)
    p2 = plan(MATMUL_H100, (128, 128, 128), store=store)
    assert (planner_stats()["plan_searches"], planner_stats()["plan_store_hits"]) == (1, 1)
    assert p2.source == "store" and p2.config == p1.config
    assert p2.cost.latency_cycles == p1.cost.latency_cycles


def test_plan_cache_round_trips_disk(tmp_path):
    store = ResultStore(tmp_path)
    p1 = plan(MATMUL_H100, (256, 128, 384), store=store)
    store.flush()
    reset_planner_stats()
    p2 = plan(MATMUL_H100, (256, 128, 384), store=ResultStore(tmp_path))
    s = planner_stats()
    assert s["plan_searches"] == 0 and s["plan_store_hits"] == 1
    assert p2.source == "store" and p2.config == p1.config


def test_plan_key_is_constraints_and_model_inclusive():
    cons = MATMUL_H100.constraints((128, 128, 128))
    m = TimeloopLikeModel()
    keys = {
        codesign.plan_space_key(MATMUL_H100, cons, "heuristic", 400, "latency", m),
        codesign.plan_space_key(MATMUL_H100, cons, "heuristic", 100, "latency", m),
        codesign.plan_space_key(MATMUL_H100, mxu_aligned(["m", "n", "k"], 256), "heuristic",
                                400, "latency", m),
        codesign.plan_space_key(MATMUL_H100, cons, "heuristic", 400, "latency",
                                TimeloopLikeModel().set_calibration(CalibrationScale(2.0, 1, "t"))),
        codesign.plan_space_key(_JaxMatmulSpace(), cons, "heuristic", 400, "latency", m),
    }
    assert len(keys) == 5


class _Mac3Space(KernelSpace):
    """Non-conformable with the timeloop model (unit op mac3): every search
    raises ValueError -- the EXPECTED failure class."""

    name = "_test_mac3"
    decode_dims = ("i", "j")

    def problem(self, shape):
        return Problem.mttkrp(*shape)

    def legalize(self, config, shape, smem_budget=None):
        return (repair_tile(config[0], shape[0], 64), repair_tile(config[1], shape[1], 64))


class _BrokenSpace(_Mac3Space):
    name = "_test_broken"

    def problem(self, shape):
        raise KeyError("not a search failure")


def test_expected_search_failure_counts_fallback():
    reset_planner_stats()
    p = plan(_Mac3Space(), (64, 64, 64, 64), store=ResultStore(), predict=False)
    assert planner_stats()["plan_fallbacks"] == 1
    assert p.source == "fallback" and p.fallback
    assert all(64 % c == 0 for c in p.config)


def test_unexpected_errors_propagate():
    with pytest.raises(KeyError):
        plan(_BrokenSpace(), (64, 64, 64, 64), store=ResultStore(), predict=False)


def test_fallback_plan_is_cached_with_flag():
    store = ResultStore()
    plan(_Mac3Space(), (64, 64, 64, 64), store=store, predict=False)
    reset_planner_stats()
    p = plan(_Mac3Space(), (64, 64, 64, 64), store=store, predict=False)
    assert planner_stats()["plan_searches"] == 0
    assert p.source == "store" and p.fallback


def test_calibrated_plan_keys_apart_in_store():
    store = ResultStore()
    raw = TimeloopLikeModel()
    cal = TimeloopLikeModel().set_calibration(CalibrationScale(3.0, 1, "t"))
    p_raw = plan(MATMUL_H100, (128, 128, 128), store=store, model=raw)
    reset_planner_stats()
    p_cal = plan(MATMUL_H100, (128, 128, 128), store=store, model=cal)
    assert planner_stats()["plan_searches"] == 1
    assert p_cal.cost.latency_cycles == pytest.approx(3.0 * p_raw.cost.latency_cycles)


# ------------------------------------------------------------------ #
# calibration table and the measurement loop
# ------------------------------------------------------------------ #
def test_calibration_table_round_trip(tmp_path):
    path = tmp_path / "cal.json"
    t = CalibrationTable(path)
    t.record("matmul_h100", (128, 128, 128), (64, 64, 32), ("timeloop_like", "mac2"),
             predicted_cycles=1e6, frequency_hz=1e9, measured_s=2e-3, interpret=False)
    t.record("matmul_h100", (256, 256, 256), (64, 64, 32), ("timeloop_like", "mac2"),
             predicted_cycles=8e6, frequency_hz=1e9, measured_s=1.6e-2, interpret=False)
    assert t.flush() == 2
    t2 = CalibrationTable(path)
    assert len(t2.rows) == 2 and t2.corrupt_payloads == 0
    sc = t2.scale_for("matmul_h100", interpret=False)
    assert sc.n_records == 2 and sc.scale == pytest.approx(2.0) and sc.source == "device:matmul_h100"
    rep = t2.model_error_report("matmul_h100", interpret=False)
    assert len(rep) == 2 and all(r["abs_error_pct"] == pytest.approx(0.0, abs=1e-9) for r in rep)


def test_calibration_table_tolerates_corruption(tmp_path):
    path = tmp_path / "cal.json"
    path.write_text("{ not json !!")
    assert CalibrationTable(path).corrupt_payloads == 1
    path.write_text(json.dumps({"version": 999, "rows": []}))
    assert CalibrationTable(path).version_mismatches == 1
    good = {"kernel": "k", "shape": [8], "config": [8], "model": ["m"], "predicted_cycles": 1e6,
            "frequency_hz": 1e9, "predicted_s": 1e-3, "measured_s": 2e-3, "interpret": True,
            "repeats": 1, "ts": 0.0}
    path.write_text(json.dumps({"version": 1, "rows": [good, {"kernel": 5}, "junk"]}))
    t = CalibrationTable(path)
    assert len(t.rows) == 1 and t.corrupt_payloads == 2


def test_scale_never_mixes_interpret_and_device():
    t = CalibrationTable()
    t.record("k", (8,), (8,), ("m",), 1e6, 1e9, 2e-3, interpret=True)
    t.record("k", (8,), (8,), ("m",), 1e6, 1e9, 5e-3, interpret=False)
    assert t.scale_for("k", interpret=True).scale == pytest.approx(2.0)
    assert t.scale_for("k", interpret=False).scale == pytest.approx(5.0)
    assert t.scale_for("other") is None


@pytest.mark.parametrize("model_cls", [TimeloopLikeModel, MaestroLikeModel])
def test_calibrated_model_rescales_on_the_h100(model_cls):
    problem, mapping, arch = MATMUL_H100.canonical_mapping((256, 256, 256), (64, 64, 32))
    raw, cal = model_cls(), model_cls().set_calibration(CalibrationScale(2.5, 1, "device:t"))
    assert raw.store_key_parts() != cal.store_key_parts()
    c_raw, c_cal = raw.evaluate(problem, mapping, arch), cal.evaluate(problem, mapping, arch)
    assert c_cal.latency_cycles == pytest.approx(2.5 * c_raw.latency_cycles)
    assert c_cal.energy_pj == c_raw.energy_pj
    from repro_torch.core.cost.analysis import get_context

    sig = mapping_signature(mapping, get_context(problem, arch).dims)
    (c_batch,) = cal.evaluate_signature_batch(problem, arch, [sig])
    assert (c_batch.latency_cycles, c_batch.energy_pj) == (c_cal.latency_cycles, c_cal.energy_pj)


def test_calibrate_kernel_on_the_cpu_records_interpret_rows():
    table = codesign.calibrate_kernel(MATMUL_H100, [(128, 128, 128)], device="cpu",
                                      store=ResultStore(), repeats=1, iters=2)
    (row,) = table.rows
    assert row["kernel"] == "matmul_h100" and row["measured_s"] > 0 and row["interpret"]
    assert table.scale_for("matmul_h100", interpret=False) is None
    sc = table.scale_for("matmul_h100")
    assert "calibrated" in TimeloopLikeModel().set_calibration(sc).store_key_parts()


def test_measure_kernel_on_cuda_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be exercised")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codesign.measure_kernel(MATMUL_H100, (64, 64, 64), (64, 64, 32), device="cuda")


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.codesign, repro_torch.core.optimizer, "
            "repro_torch.kernels.matmul, repro_torch.launch.quickstart; "
            "repro_torch.codesign.all_spaces(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
