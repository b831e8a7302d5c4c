"""The port's TPU roofline cost model, TTGT rewriting and co-design
exploration twin against the JAX package's, on the CPU.

* ``TPURooflineModel``: ``evaluate``, ``lower_bound`` and the batch paths
  (admission bound and costs over a stacked batch) give the reference's
  numbers bit for bit on random mappings of a TPU chip and a small v5e pod
  (whose mesh levels carry collective terms), with and without a
  calibration scale; ``RooflineReport`` gives the reference's row.
* TTGT: ``enumerate_ttgt_plans``, ``best_ttgt_plan`` and ``transpose_cost``
  equal the reference's on the paper's Table III contractions.
* ``repro_torch.launch.codesign_explore``: sections (b), (c) and (c')
  print what ``examples/codesign_explore.py`` prints; the closing step runs
  the plain versions on the CPU and raises for ``--device cuda`` without a
  card.
"""

import dataclasses
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.codesign import CalibrationScale as JaxCalibrationScale
from repro.core.architecture import (
    chiplet_accelerator as jax_chiplet,
    cloud_accelerator as jax_cloud,
    tpu_chip as jax_tpu,
    tpu_v5e_pod as jax_pod,
)
from repro.core.cost.roofline import RooflineReport as JaxReport
from repro.core.cost.roofline import TPURooflineModel as JaxRoofline
from repro.core.ir.ttgt import best_ttgt_plan as jax_best
from repro.core.ir.ttgt import enumerate_ttgt_plans as jax_enumerate
from repro.core.ir.ttgt import transpose_cost as jax_transpose_cost
from repro.core.mapping import Mapping as JaxMapping
from repro.core.mapping import mapping_signature as jax_signature
from repro.core.problem import Problem as JaxProblem

from repro_torch.codesign import CalibrationScale
from repro_torch.core.architecture import (
    chiplet_accelerator,
    cloud_accelerator,
    tpu_chip,
    tpu_v5e_pod,
)
from repro_torch.core.cost import TPURooflineModel
from repro_torch.core.cost.roofline import RooflineReport
from repro_torch.core.ir import best_ttgt_plan, enumerate_ttgt_plans
from repro_torch.core.ir.ttgt import transpose_cost
from repro_torch.core.mapping import mapping_signature
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.problem import Problem
from repro_torch.launch import codesign_explore

ROOT = Path(__file__).resolve().parents[1]

ARCHS = {
    "tpu_chip": (tpu_chip, jax_tpu),
    "pod_2x2": (lambda: tpu_v5e_pod(data=2, model=2), lambda: jax_pod(data=2, model=2)),
}
PROBLEMS = {
    "gemm": lambda P: P.gemm(256, 512, 128),
    "conv": lambda P: P.conv2d(2, 16, 8, 8, 8, 3, 3),
}


def _mappings(problem, arch, n=24, seed=0):
    space = MapSpace(problem, arch)
    rng = random.Random(seed)
    return [space.random_mapping(rng) for _ in range(n)]


def _cost_key(c):
    return (c.latency_cycles, c.energy_pj, c.utilization, c.macs, c.frequency_hz, c.breakdown)


def _models(scale):
    if scale is None:
        return TPURooflineModel(), JaxRoofline()
    return (TPURooflineModel().set_calibration(CalibrationScale(scale, source="test")),
            JaxRoofline().set_calibration(JaxCalibrationScale(scale, source="test")))


# ------------------------------------------------------------------ #
# TPURooflineModel and RooflineReport
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("scale", [None, 1.7])
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_roofline_costs_match_reference(kind, arch, scale):
    pt, pj = PROBLEMS[kind](Problem), PROBLEMS[kind](JaxProblem)
    at, aj = ARCHS[arch][0](), ARCHS[arch][1]()
    mt, mj = _models(scale)
    maps = _mappings(pt, at)
    dims = tuple(pt.dims)
    for m in maps:
        jm = JaxMapping.from_dict(m.to_dict())
        assert mapping_signature(m, dims) == jax_signature(jm, dims)
        assert _cost_key(mt.evaluate(pt, m, at)) == _cost_key(mj.evaluate(pj, jm, aj))
        assert mt.lower_bound(pt, m, at) == mj.lower_bound(pj, jm, aj)
    # the batch paths equal the reference's batch paths and the scalar evaluate
    sigs = [mapping_signature(m, dims) for m in maps]
    got = mt.evaluate_signature_batch(pt, at, sigs)
    want = mj.evaluate_signature_batch(pj, aj, sigs)
    assert got is not None and want is not None
    assert [_cost_key(c) for c in got] == [_cost_key(c) for c in want]
    assert [_cost_key(c) for c in got] == [_cost_key(mt.evaluate(pt, m, at)) for m in maps]
    lb_t = mt.lower_bound_batch_fn(pt, at)(sigs)
    lb_j = mj.lower_bound_batch_fn(pj, aj)(sigs)
    for a, b in zip(lb_t, lb_j):
        assert a.tolist() == b.tolist()
    assert list(zip(*(v.tolist() for v in lb_t))) == [mt.lower_bound(pt, m, at) for m in maps]
    assert mt.store_key_parts() == mj.store_key_parts()


def test_roofline_collective_terms_are_exercised():
    """The pod's random mappings split data spaces over the mesh: some
    costs carry a collective term, so the parity above covers it."""
    p, a = PROBLEMS["gemm"](Problem), ARCHS["pod_2x2"][0]()
    costs = [TPURooflineModel().evaluate(p, m, a) for m in _mappings(p, a)]
    assert any(c.breakdown["collective_s"] > 0 for c in costs)
    assert {c.breakdown["bound"] for c in costs} >= {1.0}


@pytest.mark.parametrize("corrected", [False, True])
def test_roofline_report_matches_reference(corrected):
    raw = {"flops_per_device": 3.1e12, "bytes_per_device": 4.5e10,
           "collective_bytes_per_device": 2.0e9}
    art = {"chips": 16, "model_flops": 4.0e13, "extras": {"temp_bytes": 7}, **raw}
    if corrected:
        art["corrected"] = {k: v * 1.5 for k, v in raw.items()}
    want = JaxReport.from_artifact("cell", art)
    # the record's own fields; the peak and bandwidths are the port's v5e defaults
    got = RooflineReport(**{k: getattr(want, k) for k in (
        "name", "chips", "flops_per_chip", "hbm_bytes_per_chip", "collective_bytes_per_chip",
        "model_flops_total", "extras")})
    assert got.row() == want.row()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for field in ("compute_s", "memory_s", "collective_s", "bound", "step_time_s",
                  "useful_flops_fraction", "roofline_fraction"):
        assert getattr(got, field) == getattr(want, field), field


# ------------------------------------------------------------------ #
# TTGT on the paper's Table III contractions (tests/test_ir.py's cases)
# ------------------------------------------------------------------ #
TC_CASES = [("tc_intensli2", 64), ("tc_intensli2", 16), ("tc_ccsd7", 64), ("tc_ccsd7", 16),
            ("tc_ccsd_t4", 32), ("tc_ccsd_t4", 16)]


@pytest.mark.parametrize("word_bytes", [1, 2])
@pytest.mark.parametrize("mk,tds", TC_CASES)
def test_ttgt_matches_reference(mk, tds, word_bytes):
    pt, pj = getattr(Problem, mk)(tds), getattr(JaxProblem, mk)(tds)
    got, want = enumerate_ttgt_plans(pt), jax_enumerate(pj)
    assert got and [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    assert dataclasses.asdict(best_ttgt_plan(pt)) == dataclasses.asdict(jax_best(pj))
    archs = [(cloud_accelerator(), jax_cloud()),
             (chiplet_accelerator(fill_bandwidth=4e9), jax_chiplet(fill_bandwidth=4e9))]
    for at, aj in archs:
        for a, b in zip(got, want):
            assert transpose_cost(a, at, word_bytes) == jax_transpose_cost(b, aj, word_bytes)
    g = best_ttgt_plan(pt).gemm_problem(word_bytes)
    assert (g.name, dict(g.dims), g.macs) == (lambda h: (h.name, dict(h.dims), h.macs))(
        jax_best(pj).gemm_problem(word_bytes))


# ------------------------------------------------------------------ #
# the codesign_explore twin
# ------------------------------------------------------------------ #
def _sections(text):
    """The lines of sections (b), (c) and (c'): everything before the loop
    is closed on a device."""
    return text.split("== closing the loop")[0].rstrip().splitlines()


def test_codesign_explore_prints_the_reference_numbers(capsys):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, str(ROOT / "examples" / "codesign_explore.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    P = codesign_explore.ffn_problem()
    codesign_explore.explore_mappers(P)
    codesign_explore.explore_hardware(P)
    got = _sections(capsys.readouterr().out)
    want = _sections(ref.stdout)
    assert len(want) == 17 and got == want


def test_codesign_explore_closes_the_loop_on_the_cpu():
    rows = codesign_explore.close_loop(256, 384, 128, "cpu")
    assert set(rows) == {"bfloat16", "float32"}
    assert rows["bfloat16"]["instance"] == "wgmma" and rows["float32"]["instance"] == "fma"
    for r in rows.values():
        assert r["kernel_ms"] is None and r["torch_matmul_ms"] is None  # nothing timed here
        assert len(r["tiles"]) == 3
    assert codesign_explore.GEMM == (4096, 9216, 2048)


def test_codesign_explore_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be exercised")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codesign_explore.main(["--device", "cuda"])
