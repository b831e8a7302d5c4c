"""The device-resident search loops on the torch backend, on the CPU (the
twin of ``tests/test_device_loop.py``).

The mega-batch random/exhaustive precompute and the generation-resident
GA scorer must reproduce the host loop EXACTLY -- best mapping, best
cost, trajectory, engine counters and memo contents -- against the torch
host loop, the port's numpy engine and the reference's numpy engine,
while syncing the host once per ``UNION_DEVICE_K`` batches/generations.
"""

import math

import numpy as np
import pytest

from repro.core.architecture import cloud_accelerator as jax_cloud
from repro.core.cost import EvaluationEngine as JaxEngine
from repro.core.cost import TimeloopLikeModel as JaxTimeloop
from repro.core.mappers.exhaustive import ExhaustiveMapper as JaxExhaustive
from repro.core.mappers.genetic import GeneticMapper as JaxGenetic
from repro.core.mappers.random_search import RandomMapper as JaxRandom
from repro.core.mapspace import MapSpace as JaxMapSpace
from repro.core.problem import Problem as JaxProblem

from repro_torch.core.architecture import cloud_accelerator, edge_accelerator
from repro_torch.core.cost import EvaluationEngine, MaestroLikeModel, TimeloopLikeModel
from repro_torch.core.cost.roofline import TPURooflineModel
from repro_torch.core.device_loop import (
    DeviceGAScorer,
    device_loop_enabled,
    device_precompute,
    sync_cadence,
)
from repro_torch.core.genome_batch import random_genome_batch
from repro_torch.core.mappers.exhaustive import ExhaustiveMapper
from repro_torch.core.mappers.genetic import GeneticMapper
from repro_torch.core.mappers.random_search import RandomMapper
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.problem import Problem

DEV = "cpu"
GEMM = Problem.gemm(64, 32, 16, word_bytes=1)


# ------------------------------------------------------------------ #
# knobs + gating
# ------------------------------------------------------------------ #
def test_sync_cadence_env(monkeypatch):
    monkeypatch.delenv("UNION_DEVICE_K", raising=False)
    assert sync_cadence() == 8
    monkeypatch.setenv("UNION_DEVICE_K", "3")
    assert sync_cadence() == 3
    monkeypatch.setenv("UNION_DEVICE_K", "0")
    assert sync_cadence() == 1
    monkeypatch.setenv("UNION_DEVICE_K", "garbage")
    assert sync_cadence() == 8


def test_device_loop_gating(monkeypatch):
    arch = edge_accelerator()
    eng_np = EvaluationEngine(TimeloopLikeModel(), GEMM, arch, backend="numpy")
    eng_t = EvaluationEngine(TimeloopLikeModel(), GEMM, arch, backend="torch", device=DEV)
    monkeypatch.delenv("UNION_DEVICE_LOOP", raising=False)
    assert not device_loop_enabled(eng_np)
    assert device_loop_enabled(eng_t)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    assert not device_loop_enabled(eng_t)


def test_device_primitives_degrade_to_none_on_numpy(monkeypatch):
    monkeypatch.delenv("UNION_DEVICE_LOOP", raising=False)
    arch = edge_accelerator()
    eng = EvaluationEngine(TimeloopLikeModel(), GEMM, arch, backend="numpy")
    gb = random_genome_batch(MapSpace(GEMM, arch), np.random.default_rng(0), 8)
    assert device_precompute(eng, [gb]) is None
    scorer = DeviceGAScorer(eng, lambda g, cs: None)
    assert not scorer.active and scorer.score(gb) is None
    scorer.flush()
    assert eng.stats.device_syncs == 0 and eng.stats.n_traces == 0


def test_roofline_has_no_device_loop(monkeypatch):
    """The roofline model has no shape-generic program, so its torch
    engine keeps the per-batch fused dispatch: the primitives decline."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    arch = cloud_accelerator()
    eng = EvaluationEngine(TPURooflineModel(), GEMM, arch, backend="torch", device=DEV)
    gb = random_genome_batch(MapSpace(GEMM, arch), np.random.default_rng(0), 8)
    assert device_precompute(eng, [gb]) is None
    assert not DeviceGAScorer(eng, lambda g, cs: None).active


# ------------------------------------------------------------------ #
# host-loop equivalence
# ------------------------------------------------------------------ #
def _run(mapper, backend, cm_cls=TimeloopLikeModel):
    arch = cloud_accelerator()
    space = MapSpace(GEMM, arch)
    cm = cm_cls()
    engine = EvaluationEngine(cm, GEMM, arch, metric="edp", backend=backend, device=DEV)
    return mapper.search(space, cm, metric="edp", engine=engine), engine


def _run_reference(mapper):
    problem, arch = JaxProblem.gemm(64, 32, 16, word_bytes=1), jax_cloud()
    cm = JaxTimeloop()
    engine = JaxEngine(cm, problem, arch, metric="edp", backend="numpy")
    return mapper.search(JaxMapSpace(problem, arch), cm, metric="edp", engine=engine), engine


def _assert_results_equal(a, b, same_backend=True):
    assert a.best_cost.latency_cycles == b.best_cost.latency_cycles
    assert a.best_cost.energy_pj == b.best_cost.energy_pj
    assert a.best_cost.utilization == b.best_cost.utilization
    assert a.best_cost.breakdown == b.best_cost.breakdown
    assert a.best_mapping.to_dict() == b.best_mapping.to_dict()
    for c in ("trajectory", "evaluated", "considered", "pruned", "analyzed", "cache_hits"):
        assert getattr(a, c) == getattr(b, c), c
    if same_backend:
        # the device loop's replay counts each batch exactly like a fresh
        # host dispatch (numpy runs report 0, so torch-vs-torch only)
        assert a.fused_dispatches == b.fused_dispatches


def _assert_memos_equal(ea, eb):
    ka, kb = list(ea._cache.keys()), list(eb._cache.keys())
    assert ka == kb
    for k in ka:
        ca, cb = ea._cache[k], eb._cache[k]
        assert (ca.latency_cycles, ca.energy_pj, ca.utilization, ca.breakdown) == (
            cb.latency_cycles, cb.energy_pj, cb.utilization, cb.breakdown)


@pytest.mark.parametrize("patience", [0, 60], ids=["no-patience", "patience"])
def test_random_device_loop_matches_host(monkeypatch, patience):
    def mk(cls=RandomMapper):
        return cls(samples=192, seed=3, batch_size=32, probe=8, patience=patience)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_host, eng_host = _run(mk(), "torch")
    assert res_host.device_syncs == 0 and res_host.fused_dispatches > 0
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    res_dev, eng_dev = _run(mk(), "torch")
    assert not eng_dev._ctx._torch_failed and res_dev.backend_fallbacks == 0
    assert res_dev.device_syncs >= 1
    _assert_results_equal(res_dev, res_host)
    _assert_memos_equal(eng_dev, eng_host)
    res_np, eng_np = _run(mk(), "numpy")
    _assert_results_equal(res_dev, res_np, same_backend=False)
    _assert_memos_equal(eng_dev, eng_np)
    res_ref, _ = _run_reference(mk(JaxRandom))
    _assert_results_equal(res_dev, res_ref, same_backend=False)


def test_random_device_sync_cadence(monkeypatch):
    """10 chunks at K=3 is exactly ceil(10/3) = 4 mega dispatches."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    monkeypatch.setenv("UNION_DEVICE_K", "3")
    res, eng = _run(RandomMapper(samples=320, seed=7, batch_size=32, patience=0), "torch")
    assert not eng._ctx._torch_failed
    assert res.device_syncs == math.ceil(10 / 3)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_host, eng_host = _run(RandomMapper(samples=320, seed=7, batch_size=32, patience=0),
                              "torch")
    _assert_results_equal(res, res_host)
    _assert_memos_equal(eng, eng_host)


def test_exhaustive_device_loop_matches_host(monkeypatch):
    def mk(cls=ExhaustiveMapper):
        return cls(max_mappings=200, batch_size=32)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_host, eng_host = _run(mk(), "torch")
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    res_dev, eng_dev = _run(mk(), "torch")
    assert not eng_dev._ctx._torch_failed and res_dev.device_syncs >= 1
    _assert_results_equal(res_dev, res_host)
    _assert_memos_equal(eng_dev, eng_host)
    res_np, _ = _run(mk(), "numpy")
    _assert_results_equal(res_dev, res_np, same_backend=False)
    res_ref, _ = _run_reference(mk(JaxExhaustive))
    _assert_results_equal(res_dev, res_ref, same_backend=False)


def test_genetic_device_loop_matches_host(monkeypatch):
    def mk(cls=GeneticMapper):
        return cls(population=16, generations=8, seed=5)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_host, eng_host = _run(mk(), "torch")
    assert res_host.device_syncs == 0
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    res_dev, eng_dev = _run(mk(), "torch")
    assert not eng_dev._ctx._torch_failed
    # initial pop + 8 generations = 9 scored batches, K=8 -> <= 2 syncs
    assert 1 <= res_dev.device_syncs <= math.ceil(9 / sync_cadence()) + 1
    _assert_results_equal(res_dev, res_host)
    _assert_memos_equal(eng_dev, eng_host)
    res_np, eng_np = _run(mk(), "numpy")
    _assert_results_equal(res_dev, res_np, same_backend=False)
    _assert_memos_equal(eng_dev, eng_np)
    res_ref, _ = _run_reference(mk(JaxGenetic))
    _assert_results_equal(res_dev, res_ref, same_backend=False)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_genetic_sync_cadence(monkeypatch, k):
    """One host sync per K generations: 9 scored batches at cadence K give
    ceil(9 / K) flushes (the last one at the search's end)."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    monkeypatch.setenv("UNION_DEVICE_K", str(k))
    res, _ = _run(GeneticMapper(population=16, generations=8, seed=5), "torch")
    assert res.device_syncs == math.ceil(9 / k)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_host, _ = _run(GeneticMapper(population=16, generations=8, seed=5), "torch")
    _assert_results_equal(res, res_host)


def test_device_loop_maestro_matches_numpy(monkeypatch):
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    res_dev, _ = _run(RandomMapper(samples=192, seed=1, batch_size=32), "torch",
                      MaestroLikeModel)
    assert res_dev.device_syncs >= 1
    res_np, _ = _run(RandomMapper(samples=192, seed=1, batch_size=32), "numpy",
                     MaestroLikeModel)
    _assert_results_equal(res_dev, res_np, same_backend=False)


def test_genetic_device_fitness_is_engine_metric(monkeypatch):
    """The fitness vector fetched per generation is the engine metric of
    the replayed costs, bit for bit."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    arch = cloud_accelerator()
    eng = EvaluationEngine(TimeloopLikeModel(), GEMM, arch, metric="edp", backend="torch",
                           device=DEV)
    gb = random_genome_batch(MapSpace(GEMM, arch), np.random.default_rng(1), 16)
    got = {}
    scorer = DeviceGAScorer(eng, lambda g, cs: got.__setitem__("costs", cs))
    assert scorer.active
    fitness = scorer.score(gb)
    assert fitness is not None and fitness.dtype == np.float64
    scorer.flush()
    costs = got["costs"]
    assert len(costs) == len(gb) and all(c is not None for c in costs)
    host = np.asarray([c.metric("edp") for c in costs], dtype=np.float64)
    assert np.array_equal(fitness, host)
    assert eng.stats.device_syncs == 1


def test_device_precompute_views_equal_per_batch_dispatch(monkeypatch):
    """A mega dispatch's row slices equal each batch's own dispatch bit for
    bit (per-row values do not depend on the batch's composition)."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    arch = cloud_accelerator()
    space = MapSpace(GEMM, arch)
    rng = np.random.default_rng(4)
    batches = [random_genome_batch(space, rng, n) for n in (8, 13, 32)]
    eng = EvaluationEngine(TimeloopLikeModel(), GEMM, arch, backend="torch", device=DEV)
    views = device_precompute(eng, batches)
    assert views is not None and eng.stats.device_syncs == 1
    runner = eng._get_fused_runner()
    for gb, v in zip(batches, views):
        _admit, _lb, lat, en, ut, _s, extras = runner(gb.stacked(), math.inf)
        assert np.array_equal(v.latency, lat) and np.array_equal(v.energy, en)
        assert np.array_equal(v.util, ut) and np.array_equal(v.lb_cyc, extras["lb_cycles"])
