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

On the card each (program, pow2 bucket) runs eagerly once and is then
captured as a CUDA graph that every later dispatch replays: the graph
tests below hold replay to numpy at every model x metric over several
buckets, at a changing incumbent, for two contexts alternating on one
shared graph, across buffered device-loop generations, and check that one
trace is one graph and that an injected fault still degrades a cached
graph's engine.

Marked ``gpu``: they skip without a card. The file imports neither jax nor
``repro``, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_engine_gpu.py
"""

import gc
import math
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core.architecture import (
    cloud_accelerator,
    edge_accelerator,
    h100_sm,
    tpu_chip,
)
from repro_torch.core.cost import EvaluationEngine, MaestroLikeModel, TimeloopLikeModel
from repro_torch.core.cost import _xp_torch
from repro_torch.core.cost import analysis
from repro_torch.core.cost.analysis import (
    device_scalar,
    exact_divisor,
    get_context,
    global_trace_count,
    graph_count,
    graph_pool_bytes,
    reset_trace_registry,
)
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


# ------------------------------------------------------------------ #
# the programs as CUDA graphs: one capture per (program, bucket), replays
# ------------------------------------------------------------------ #
GEMM_B = Problem.gemm(128, 64, 48, word_bytes=2)  # GEMM's shape class, other content
BUCKETS = (20, 40, 100)  # pads to 32, 64, 128


def _numpy_fused(cm, problem, arch, sb, metric, incumbent):
    """The per-context fused admit+score program on numpy."""
    ctx = get_context(problem, arch)
    core = ctx._make_fused_core(np, cm.batch_admit_core_builder(problem, arch),
                                cm.batch_cost_terms_fn(problem, arch), metric)
    return core(sb.tt, sb.st, sb.perm, incumbent)


def _fused_equal(got, want):
    admit, lb_mx, lat, en, ut, smx, extras = got
    assert _eq(admit, want[0]) and float(lb_mx) == float(want[1])
    assert _eq(lat, want[2]) and _eq(en, want[3]) and _eq(ut, want[4])
    assert float(smx) == float(want[5])
    for k in set(extras) & set(want[6]):
        assert _eq(extras[k], want[6][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("metric", ["edp", "latency", "energy"])
def test_graph_replay_matches_numpy_at_every_bucket(cuda, model, metric):
    """Every program a search runs -- the fused admit+score program
    (shape-generic for the hierarchical models, per-context for the
    roofline), the traffic program and the bound program -- at three pow2
    buckets: the first dispatch at a bucket captures its graph, the next
    two (other candidates) replay it, each equal to numpy."""
    reset_trace_registry()
    arch = cloud_accelerator()
    cm = MODELS[model]()
    space = MapSpace(GEMM, arch)
    ctx = get_context(GEMM, arch)
    eng = EvaluationEngine(cm, GEMM, arch, metric=metric, backend="torch", device=cuda)
    runner = eng._get_fused_runner()
    for rows in BUCKETS:
        for seed in (1, 2, 3):
            sb = random_genome_batch(space, np.random.default_rng(100 * rows + seed),
                                     rows).stacked()
            _fused_equal(runner(sb, math.inf), _numpy_fused(cm, GEMM, arch, sb, metric,
                                                            math.inf))
            bt_c = ctx.signature_traffic_batch(stacked=sb, backend="torch", device=cuda)
            bt_n = ctx.signature_traffic_batch(stacked=sb)
            for f in ("compute_cycles", "total_trips", "par", "inst_at", "tt", "st", "fans"):
                assert _eq(getattr(bt_c, f), getattr(bt_n, f)), f
            for rc, rn in zip(bt_c.rows, bt_n.rows):
                assert all(_eq(a, b) for a, b in zip(rc, rn))
            lb_c = ctx.lower_bound_batch(stacked=sb, backend="torch", device=cuda)
            lb_n = ctx.lower_bound_batch(stacked=sb)
            assert _eq(lb_c[0], lb_n[0]) and _eq(lb_c[1], lb_n[1])
    assert not ctx._torch_failed
    # three programs at three buckets: nine traces, nine graphs
    assert global_trace_count() == graph_count() == 9
    assert graph_pool_bytes() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
def test_replay_admits_against_the_current_incumbent(cuda, model):
    """The incumbent is an input of the graph (a 0-dim device tensor), not
    a constant of the capture: replays at other incumbents admit exactly
    the rows numpy admits at each. (The roofline's admission bound takes
    two values at most on these candidates, on ``tpu_chip()``.)"""
    reset_trace_registry()
    arch = tpu_chip() if model == "tpu_roofline" else cloud_accelerator()
    cm = MODELS[model]()
    eng = EvaluationEngine(cm, GEMM, arch, metric="edp", backend="torch", device=cuda)
    runner = eng._get_fused_runner()
    sb = random_genome_batch(MapSpace(GEMM, arch), np.random.default_rng(5), 200).stacked()
    lb_cyc, lb_en, _mx = cm.batch_admit_core_builder(GEMM, arch)(np)(sb.tt, sb.st, sb.perm)
    scores = eng._scalarize_batch(lb_cyc, lb_en)
    u = np.unique(scores)  # an incumbent at u[i] admits the rows below it
    q25, q50, q75 = (float(u[int(q * (len(u) - 1))]) for q in (0.25, 0.5, 1.0))
    counts = set()
    for inc in (q25, q75, q50, math.inf, q25, 0.0):
        got = runner(sb, inc)
        want = _numpy_fused(cm, GEMM, arch, sb, "edp", inc)
        _fused_equal(got, want)
        counts.add(int(got[0].sum()))
    # the incumbents made the admit bits differ
    assert len(counts) >= (3 if model == "tpu_roofline" else 5)
    assert graph_count() == global_trace_count() == 1


@pytest.mark.gpu
def test_contexts_of_one_shape_class_alternate_on_one_graph(cuda):
    """GEMM and GEMM_B (one shape class, other sizes and word bytes) share
    the shape-generic program and so its graph; alternating on it, each
    dispatch equals its own context's numpy result: every value of a
    context enters through the parameter pack."""
    reset_trace_registry()
    arch = cloud_accelerator()
    cm = TimeloopLikeModel()
    problems = (GEMM, GEMM_B)
    runners = [EvaluationEngine(cm, p, arch, metric="edp", backend="torch",
                                device=cuda)._get_fused_runner() for p in problems]
    assert runners[0]._pkey == runners[1]._pkey
    for i in range(6):
        p = problems[i % 2]
        sb = random_genome_batch(MapSpace(p, arch), np.random.default_rng(i), 64).stacked()
        _fused_equal(runners[i % 2](sb, math.inf),
                     _numpy_fused(cm, p, arch, sb, "edp", math.inf))
    assert graph_count() == global_trace_count() == 1


@pytest.mark.gpu
def test_device_loop_buffers_generations_across_replays(cuda, monkeypatch):
    """The GA's device loop keeps K = 4 generations of raw outputs before
    it reads them; each generation after the first replays one graph, so
    the buffered outputs must be copies: the search equals the host loop's
    and numpy's."""
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1")
    monkeypatch.setenv("UNION_DEVICE_K", "4")
    reset_trace_registry()
    mk = lambda: GeneticMapper(population=32, generations=12, seed=7)  # noqa: E731
    res_d, eng_d = _run(mk(), "torch", cuda)
    assert res_d.device_syncs >= 3 and res_d.backend_fallbacks == 0
    assert graph_count() == global_trace_count() == res_d.n_traces
    res_n, eng_n = _run(mk(), "numpy", cuda)
    _assert_same_search(res_d, res_n, eng_d, eng_n)
    monkeypatch.setenv("UNION_DEVICE_LOOP", "0")
    res_h, eng_h = _run(mk(), "torch", cuda)
    _assert_same_search(res_d, res_h, eng_d, eng_h)


@pytest.mark.gpu
@pytest.mark.parametrize("mapper", sorted(MAPPER_KW))
def test_graphs_captured_equal_n_traces(cuda, mapper):
    """One trace is one graph: after a cold search, the graphs captured,
    the process's traces and the search's ``n_traces`` agree; a warm
    rerun captures nothing."""
    reset_trace_registry()
    kw = MAPPER_KW[mapper]
    sol = union_opt(GEMM_B, edge_accelerator(), mapper=mapper, cost_model="timeloop",
                    engine_backend="torch", engine_device=cuda, **kw)
    assert sol.search.backend_fallbacks == 0
    assert graph_count() == global_trace_count() == sol.search.n_traces >= 1
    again = union_opt(GEMM_B, edge_accelerator(), mapper=mapper, cost_model="timeloop",
                      engine_backend="torch", engine_device=cuda, **kw)
    assert again.search.n_traces == 0 and graph_count() == sol.search.n_traces


@pytest.mark.gpu
def test_graphs_of_evicted_contexts_are_freed(cuda):
    """The graphs of a per-context program live on its context: when the
    context cache evicts it, they are freed with it (and their pool
    memory with them), while each graph replays equal to numpy."""
    reset_trace_registry()
    arch = edge_accelerator()
    n = analysis._CTX_CACHE_SIZE + 4
    held = []
    for i in range(n):
        problem = Problem.gemm(16 * (i + 1), 32, 16, word_bytes=1)
        sb = random_genome_batch(MapSpace(problem, arch), np.random.default_rng(i), 8).stacked()
        ctx = get_context(problem, arch)
        want = ctx.lower_bound_batch(stacked=sb)
        for _ in range(2):  # captured, then replayed
            got = ctx.lower_bound_batch(stacked=sb, backend="torch", device=cuda)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        graphs = [weakref.ref(g.graph) for g in ctx._torch_graphs.values()]
        held.append((weakref.ref(ctx), graphs))
    del ctx, sb, problem, graphs
    gc.collect()
    evicted, kept = held[:n - analysis._CTX_CACHE_SIZE], held[n - analysis._CTX_CACHE_SIZE:]
    assert all(c() is None and g() is None for c, gs in evicted for g in gs)
    assert all(c() is not None and gs and all(g() is not None for g in gs) for c, gs in kept)
    assert graph_count() == global_trace_count() == n
    reset_trace_registry()
    assert all(not c()._torch_graphs for c, _gs in kept)


@pytest.mark.gpu
def test_injected_fault_against_a_cached_graph_degrades_and_counts(cuda, monkeypatch):
    """``UNION_FAULT_JAX`` is read on the host before every dispatch, so a
    search whose graphs are all cached still degrades to numpy, once,
    counted, with numpy's results; the graphs stay untouched."""
    reset_trace_registry()
    arch = edge_accelerator()
    kw = {"samples": 256, "batch_size": 32, "seed": 3}
    first = union_opt(GEMM_B, arch, mapper="random", engine_backend="torch",
                      engine_device=cuda, **kw)
    captured = graph_count()
    assert captured >= 1 and first.search.backend_fallbacks == 0
    want = union_opt(GEMM_B, arch, mapper="random", **kw)
    monkeypatch.setenv("UNION_FAULT_JAX", "1")
    ctx = get_context(GEMM_B, arch)
    try:
        got = union_opt(GEMM_B, arch, mapper="random", engine_backend="torch",
                        engine_device=cuda, **kw)
    finally:
        ctx._torch_failed = False
    assert got.search.backend_fallbacks == 1 and got.search.fused_dispatches == 0
    assert got.mapping.to_dict() == want.mapping.to_dict()
    assert _costs_equal(got.cost, want.cost)
    assert graph_count() == captured
