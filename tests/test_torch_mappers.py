"""The port's five mappers against the JAX package's, on the CPU.

Each mapper x each cost model (timeloop, maestro, tpu_roofline) must give
the same best mapping, cost (cycles, pJ, utilization), ``search.evaluated``,
engine counters and trajectory as ``repro``'s ``union_opt(...,
engine_backend="numpy")``, bit for bit; both ``seed_version`` streams of
the sampling mappers too, and the exhaustive mapper's vectorized stream
against its scalar one.

Two standing behaviours of the reference hold in the port as well:

* ``codesign.plan(space, shape, mapper=m)`` raises ``TypeError`` for every
  mapper but the heuristic: the planner passes ``climb_steps`` to any
  mapper, and only the heuristic takes it;
* under a kernel space's tile-multiple constraints the sampling mappers
  (random, genetic, decoupled) find only the trivial all-ones mapping;
  the exhaustive mapper finds the legal tile, on its slow scalar path.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from repro import codesign as jax_codesign
from repro.core import optimizer as jax_optimizer
from repro.core.architecture import cloud_accelerator as jax_cloud, tpu_chip as jax_tpu
from repro.core.constraints import mxu_aligned as jax_mxu_aligned
from repro.core.cost.store import ResultStore as JaxResultStore
from repro.core.mapping import mapping_signature as jax_signature
from repro.core.problem import Problem as JaxProblem
from repro.kernels.matmul.ops import MATMUL_SPACE

from repro_torch import codesign
from repro_torch.core import optimizer
from repro_torch.core.architecture import cloud_accelerator, tpu_chip
from repro_torch.core.constraints import mxu_aligned
from repro_torch.core.cost.store import ResultStore
from repro_torch.core.mapping import mapping_signature
from repro_torch.core.problem import Problem
from repro_torch.kernels.matmul.ops import MATMUL_H100

ROOT = Path(__file__).resolve().parents[1]

PROBLEMS = {
    "gemm": lambda P: P.gemm(64, 32, 16, word_bytes=1),
    "conv": lambda P: P.conv2d(2, 8, 8, 7, 7, 3, 3, stride=2, name="conv_t", word_bytes=1),
}
# small budgets, so that each search takes tenths of a second
MAPPER_KW = {
    "exhaustive": {"max_mappings": 1500},
    "random": {"samples": 300},
    "genetic": {"generations": 5},
    "decoupled": {"offchip_samples": 80, "onchip_samples": 120},
    "heuristic": {"climb_steps": 60},
}
COUNTERS = ("evaluated", "considered", "analyzed", "cache_hits", "pruned", "trajectory")


def _both(kind, mapper, model, metric="edp", arch=("cloud", None), **kw):
    """The same search in the port and in the reference: (port, reference)."""
    mk = {"cloud": (cloud_accelerator, jax_cloud), "tpu": (tpu_chip, jax_tpu)}[arch[0]]
    cons = arch[1]
    got = optimizer.union_opt(PROBLEMS[kind](Problem) if isinstance(kind, str) else kind[0],
                              mk[0](), mapper=mapper, cost_model=model, metric=metric,
                              constraints=None if cons is None else cons[0], **kw)
    want = jax_optimizer.union_opt(
        PROBLEMS[kind](JaxProblem) if isinstance(kind, str) else kind[1], mk[1](),
        mapper=mapper, cost_model=model, metric=metric,
        constraints=None if cons is None else cons[1], engine_backend="numpy", **kw)
    return got, want


def _assert_same(got, want):
    dims = tuple(got.problem.dims)
    assert mapping_signature(got.mapping, dims) == jax_signature(want.mapping, dims)
    for f in ("latency_cycles", "energy_pj", "utilization", "macs", "frequency_hz", "breakdown"):
        assert getattr(got.cost, f) == getattr(want.cost, f), f
    for c in COUNTERS:
        assert getattr(got.search, c) == getattr(want.search, c), c


@pytest.mark.parametrize("kind", list(PROBLEMS))
@pytest.mark.parametrize("model", ["timeloop", "maestro", "tpu_roofline"])
@pytest.mark.parametrize("mapper", list(MAPPER_KW))
def test_mapper_matches_reference(mapper, model, kind):
    _assert_same(*_both(kind, mapper, model, **MAPPER_KW[mapper]))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("seed_version", [1, 2])
@pytest.mark.parametrize("mapper", ["random", "genetic", "decoupled"])
def test_seed_versions_match_reference(mapper, seed_version, seed):
    got, want = _both("gemm", mapper, "timeloop", seed=seed, seed_version=seed_version,
                      **MAPPER_KW[mapper])
    _assert_same(got, want)


@pytest.mark.parametrize("mapper", ["random", "genetic", "decoupled"])
def test_seed_versions_draw_different_streams(mapper):
    """Each version is its own candidate stream; each is reproducible."""
    runs = {v: [optimizer.union_opt(PROBLEMS["conv"](Problem), cloud_accelerator(), mapper=mapper,
                                    cost_model="timeloop", seed_version=v, **MAPPER_KW[mapper])
                for _ in range(2)] for v in (1, 2)}
    for a, b in runs.values():
        assert a.cost.latency_cycles == b.cost.latency_cycles
        assert a.search.trajectory == b.search.trajectory
    assert runs[1][0].search.trajectory != runs[2][0].search.trajectory


@pytest.mark.parametrize("metric", ["edp", "latency"])
@pytest.mark.parametrize("max_mappings", [400, 1100])
def test_exhaustive_vectorized_equals_scalar(max_mappings, metric):
    """The mixed-radix stream reproduces the recursive DFS stream: the same
    best mapping, cost and engine counters, in the port and against the
    reference's scalar path."""
    vec, ref_scalar = _both("gemm", "exhaustive", "timeloop", metric=metric,
                            max_mappings=max_mappings, vectorized=False)
    scalar = optimizer.union_opt(PROBLEMS["gemm"](Problem), cloud_accelerator(),
                                 mapper="exhaustive", cost_model="timeloop", metric=metric,
                                 max_mappings=max_mappings, vectorized=False)
    fast = optimizer.union_opt(PROBLEMS["gemm"](Problem), cloud_accelerator(),
                               mapper="exhaustive", cost_model="timeloop", metric=metric,
                               max_mappings=max_mappings)
    _assert_same(vec, ref_scalar)
    dims = tuple(fast.problem.dims)
    assert mapping_signature(fast.mapping, dims) == mapping_signature(scalar.mapping, dims)
    assert fast.cost.latency_cycles == scalar.cost.latency_cycles
    for c in ("evaluated", "analyzed", "cache_hits", "pruned", "considered"):
        assert getattr(fast.search, c) == getattr(scalar.search, c), c


# ------------------------------------------------------------------ #
# the reference's standing behaviours, reproduced
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mapper", ["random", "genetic", "decoupled", "exhaustive"])
def test_plan_with_another_mapper_raises_type_error_in_both(mapper):
    """``plan`` hands ``climb_steps`` to the mapper; only the heuristic
    takes it, and TypeError is not a search failure the planner falls back
    on."""
    with pytest.raises(TypeError, match="climb_steps"):
        codesign.plan(MATMUL_H100, (256, 256, 256), mapper=mapper, store=ResultStore())
    with pytest.raises(TypeError, match="climb_steps"):
        jax_codesign.plan(MATMUL_SPACE, (256, 256, 256), mapper=mapper,
                          store=JaxResultStore())


@pytest.mark.parametrize("mapper", ["random", "genetic", "decoupled", "exhaustive"])
def test_constrained_search_matches_reference(mapper):
    """A 16x32x16 GEMM on tpu_chip with every tile a multiple of 16, as the
    kernel spaces constrain their tiles: the sampling mappers find only the
    trivial all-ones mapping in both packages; the exhaustive mapper (its
    scalar path, a few seconds here) finds the legal 16-tile."""
    cons = (mxu_aligned(["m", "n", "k"], 16), jax_mxu_aligned(["m", "n", "k"], 16))
    got, want = _both((Problem.gemm(16, 32, 16), JaxProblem.gemm(16, 32, 16)), mapper,
                      "timeloop", metric="latency", arch=("tpu", cons))
    _assert_same(got, want)
    leaf = got.mapping.levels[-1].temporal_tile_sizes
    trivial = all(v == 1 for lvl in got.mapping.levels for v in lvl.temporal_tile_sizes.values())
    if mapper == "exhaustive":
        assert not trivial and leaf["m"] == leaf["k"] == 16
    else:
        assert trivial


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core.genome_batch, repro_torch.core.mappers, "
            "repro_torch.core.cost.roofline, repro_torch.core.ir.ttgt, "
            "repro_torch.launch.codesign_explore; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
