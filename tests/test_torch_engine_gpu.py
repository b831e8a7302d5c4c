"""The engine's torch backend on the card, against its numpy backend.

The same array programs the CPU tests hold on ``device="cpu"``
(``tests/test_torch_engine_backend.py``, ``test_torch_device_loop.py``,
``test_torch_mapping_service.py``) run here as float64/int64 tensors on
CUDA, where torch's kernels differ from its CPU ones: a CUDA tensor divided
by a CPU scalar is multiplied by the reciprocal, reductions run in tree
order. Every result must still equal ``backend="numpy"`` bit for bit --
arrays, Costs, admission decisions, best mappings, counters, trajectories
and memo contents -- through the fused runners (shape-generic and
per-context), both device loops and the mapping service.

Marked ``gpu``: they skip without a card. The file imports neither jax nor
``repro``, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_engine_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.architecture import cloud_accelerator, edge_accelerator, h100_sm
from repro_torch.core.cost import EvaluationEngine, MaestroLikeModel, TimeloopLikeModel
from repro_torch.core.cost import _xp_torch
from repro_torch.core.cost.analysis import device_scalar, exact_divisor, get_context
from repro_torch.core.cost.roofline import TPURooflineModel
from repro_torch.core.genome_batch import random_genome_batch
from repro_torch.core.mappers.exhaustive import ExhaustiveMapper
from repro_torch.core.mappers.genetic import GeneticMapper
from repro_torch.core.mappers.random_search import RandomMapper
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.optimizer import union_opt
from repro_torch.core.problem import Problem
from repro_torch.serve.mapping_service import MappingService

GEMM = Problem.gemm(64, 32, 16, word_bytes=1)
CONV = Problem.conv2d(2, 8, 8, 7, 7, 3, 3, stride=2, name="conv_t", word_bytes=1)
PREFILL_HEAD = Problem.gemm(4096, 151936, 1024, name="prefill_head", word_bytes=2)
MODELS = {"timeloop": TimeloopLikeModel, "maestro": MaestroLikeModel,
          "tpu_roofline": TPURooflineModel}
MAPPER_KW = {
    "exhaustive": {"max_mappings": 600, "batch_size": 64},
    "random": {"samples": 256, "batch_size": 32},
    "genetic": {"population": 16, "generations": 4},
    "decoupled": {"offchip_samples": 40, "onchip_samples": 60},
    "heuristic": {"climb_steps": 40},
}
COUNTERS = ("evaluated", "considered", "analyzed", "cache_hits", "pruned", "trajectory")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these tests hold the CUDA programs")
    return "cuda"


def _costs_equal(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in (
        "latency_cycles", "energy_pj", "utilization", "macs", "frequency_hz", "breakdown"))


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
def test_device_scalars_give_ieee_division(cuda):
    """The rule the cores rest on: dividing by a device scalar is IEEE
    division, as numpy's; the namespace never hands torch a CPU scalar to
    divide by."""
    ns = _xp_torch.namespace(cuda)
    rng = np.random.default_rng(0)
    x = rng.uniform(1.0, 1e9, 1 << 16).round()
    t = ns.asarray(x)
    for c in (3.0, 940e6, 1.7, 2.0 ** 30 * 3, 7e11):
        assert _eq((t / exact_divisor(ns, c)).cpu(), x / c), c
        assert _eq((device_scalar(ns, c) / t).cpu(), c / x), c


@pytest.mark.gpu
@pytest.mark.parametrize("problem", [GEMM, CONV], ids=["gemm", "conv"])
@pytest.mark.parametrize("mk_arch", [edge_accelerator, cloud_accelerator, h100_sm],
                         ids=["edge", "cloud", "h100_sm"])
def test_batch_programs_on_cuda_match_numpy(cuda, problem, mk_arch):
    arch = mk_arch()
    ctx = get_context(problem, arch)
    space = MapSpace(problem, arch)
    gb = random_genome_batch(space, np.random.default_rng(3), 300)
    sb = gb.stacked()
    bt_n = ctx.signature_traffic_batch(stacked=sb)
    bt_c = ctx.signature_traffic_batch(stacked=sb, backend="torch", device=cuda)
    assert not ctx._torch_failed
    for f in ("compute_cycles", "total_trips", "par", "inst_at", "tt", "st", "fans"):
        assert _eq(getattr(bt_c, f), getattr(bt_n, f)), f
    for rc, rn in zip(bt_c.rows, bt_n.rows):
        for a, b in zip(rc, rn):
            assert _eq(a, b)
    lb_n = ctx.lower_bound_batch(stacked=sb)
    lb_c = ctx.lower_bound_batch(stacked=sb, backend="torch", device=cuda)
    assert (lb_n is None) == (lb_c is None)
    if lb_n is not None:
        assert _eq(lb_c[0], lb_n[0]) and _eq(lb_c[1], lb_n[1])
    for model, cls in MODELS.items():
        got = cls().evaluate_signature_batch(problem, arch, None, backend="torch",
                                             stacked=sb, device=cuda)
        want = cls().evaluate_signature_batch(problem, arch, None, stacked=sb)
        assert (got is None) == (want is None), model
        if got is not None:
            assert all(_costs_equal(a, b) for a, b in zip(got, want)), model


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("metric", ["edp", "latency", "energy"])
def test_fused_runner_on_cuda_matches_numpy(cuda, model, metric):
    """One fused dispatch per miss-batch on the card: decisions, costs and
    counters equal the numpy engine's at a real incumbent."""
    arch = cloud_accelerator()
    space = MapSpace(GEMM, arch)
    engines = {be: EvaluationEngine(MODELS[model](), GEMM, arch, metric=metric, backend=be,
                                    device=cuda) for be in ("numpy", "torch")}
    for seed in (1, 2, 3):
        gb = random_genome_batch(space, np.random.default_rng(seed), 256)
        best = {}
        for be, eng in engines.items():
            first = eng.evaluate_batch(gb.select(slice(0, 32)))
            inc = min(c.metric(metric) for c in first)
            best[be] = eng.evaluate_batch(gb.select(slice(32, 256)), incumbent=inc)
        for a, b in zip(best["numpy"], best["torch"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert _costs_equal(a, b)
    n, t = engines["numpy"].stats, engines["torch"].stats
    assert (n.evaluated, n.pruned, n.cache_hits) == (t.evaluated, t.pruned, t.cache_hits)
    assert t.backend_fallbacks == 0 and t.fused_dispatches > 0
    assert get_context(GEMM, arch).device_dispatches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("mapper", sorted(MAPPER_KW))
def test_search_on_cuda_matches_numpy(cuda, monkeypatch, mapper, model):
    monkeypatch.setenv("UNION_DEVICE_K", "3")
    kw = MAPPER_KW[mapper]
    got = union_opt(GEMM, cloud_accelerator(), mapper=mapper, cost_model=model,
                    engine_backend="torch", engine_device=cuda, **kw)
    want = union_opt(GEMM, cloud_accelerator(), mapper=mapper, cost_model=model, **kw)
    assert got.mapping.to_dict() == want.mapping.to_dict()
    assert _costs_equal(got.cost, want.cost)
    for c in COUNTERS:
        assert getattr(got.search, c) == getattr(want.search, c), c
    assert got.search.backend_fallbacks == 0 and got.search.fused_dispatches > 0


def _run(mapper, backend, device, problem=GEMM, arch=None):
    arch = arch or cloud_accelerator()
    cm = TimeloopLikeModel()
    engine = EvaluationEngine(cm, problem, arch, metric="edp", backend=backend, device=device)
    return mapper.search(MapSpace(problem, arch), cm, metric="edp", engine=engine), engine


def _assert_same_search(a, b, ea, eb):
    assert a.best_mapping.to_dict() == b.best_mapping.to_dict()
    assert _costs_equal(a.best_cost, b.best_cost)
    for c in COUNTERS:
        assert getattr(a, c) == getattr(b, c), c
    assert list(ea._cache) == list(eb._cache)
    assert all(_costs_equal(ea._cache[k], eb._cache[k]) for k in ea._cache)


@pytest.mark.gpu
@pytest.mark.parametrize("mk", [
    lambda: RandomMapper(samples=640, seed=3, batch_size=64, probe=8, patience=0),
    lambda: RandomMapper(samples=640, seed=3, batch_size=64, probe=8, patience=60),
    lambda: ExhaustiveMapper(max_mappings=800, batch_size=64),
    lambda: GeneticMapper(population=32, generations=10, seed=5),
], ids=["random", "random-patience", "exhaustive", "genetic"])
def test_device_loops_on_cuda_match_numpy(cuda, monkeypatch, mk):
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    monkeypatch.setenv("UNION_DEVICE_K", "4")
    res_d, eng_d = _run(mk(), "torch", cuda)
    assert res_d.device_syncs >= 1 and res_d.backend_fallbacks == 0
    res_n, eng_n = _run(mk(), "numpy", cuda)
    _assert_same_search(res_d, res_n, eng_d, eng_n)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_h, eng_h = _run(mk(), "torch", cuda)
    assert res_h.device_syncs == 0
    _assert_same_search(res_d, res_h, eng_d, eng_h)
    assert res_d.fused_dispatches == res_h.fused_dispatches


@pytest.mark.gpu
def test_exhaustive_at_the_prefill_head_matches_numpy(cuda, monkeypatch):
    """Large miss-batches on h100_sm() (the prefill head GEMM, 4096 x
    151936 x 1024): the device loop's mega dispatches equal numpy's host
    scoring at every argmin, counter and memo entry."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    mk = lambda: ExhaustiveMapper(max_mappings=6000)  # noqa: E731
    res_d, eng_d = _run(mk(), "torch", cuda, PREFILL_HEAD, h100_sm())
    res_n, eng_n = _run(mk(), "numpy", cuda, PREFILL_HEAD, h100_sm())
    _assert_same_search(res_d, res_n, eng_d, eng_n)
    assert res_d.device_syncs >= 1 and res_d.backend_fallbacks == 0


@pytest.mark.gpu
def test_service_on_cuda_answers_as_numpy(cuda, tmp_path):
    KW = {"genetic": {"generations": 6}, "exhaustive": {"max_mappings": 2000}}
    # the service's defaults: the torch backend on the card
    svc_c = MappingService(str(tmp_path / "c"), deadline_s=None)
    assert (svc_c.backend, svc_c.device) == ("torch", cuda)
    svc_n = MappingService(str(tmp_path / "n"), backend="numpy", deadline_s=None)
    for i, mapper in enumerate(["random", "genetic", "exhaustive", "random"]):
        q = {"problem": {"kind": "gemm", "m": 64 + 32 * i, "n": 96, "k": 48},
             "arch": {"kind": "edge"}, "mapper": {"name": mapper, "kw": KW.get(mapper, {})}, "budget": 200}
        ec, en = svc_c.handle_query(q), svc_n.handle_query(q)
        assert ec["ok"] and ec["backend"] == "torch"
        assert ec["record"]["mapping"] == en["record"]["mapping"]
        assert ec["record"]["cost"] == en["record"]["cost"]
        assert ec["record"]["counters"]["backend_fallbacks"] == 0
    assert svc_c.metrics()["device"].startswith("cuda")
    assert math.isfinite(svc_c.metrics()["neighbor_distance_avg"])
