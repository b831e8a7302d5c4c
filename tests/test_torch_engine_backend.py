"""The engine's torch backend against its numpy backend and the JAX
package's numpy backend, on the CPU (twins of ``tests/test_batch_analysis.py``,
``tests/test_shape_generic.py`` and ``tests/test_engine.py``).

``backend="torch"`` runs the engine's array programs -- the traffic core,
the lower-bound core, the per-context and shape-generic fused admit+score
programs -- as float64/int64 tensors on a torch device (``device="cpu"``
here; the same programs on the card are held in
``tests/test_torch_engine_gpu.py``). Every result must equal
``backend="numpy"`` bit for bit: arrays, Costs (breakdowns included),
admission decisions, best mappings and every search counter and
trajectory, for the five mappers under the three cost models. The
reference's own jax backend is no oracle here: without
``jax.experimental.enable_x64`` it silently runs numpy, so the reference's
numpy backend stands in for it.

Also twinned: one program per shape class (a second problem of the class
adds no program), warmup covering the class, the per-engine trace
counter, the circuit breaker's degrade -> open -> probe -> closed walk,
and the engine's warm start from a seeded incumbent on both backends.

On the card each (program, pow2 bucket) is captured once as a CUDA graph
and replayed; here, on the CPU, the programs stay eager and no graph is
built. The trace counts of whole searches are held against the
reference's own jit traces (its jax backend run for real, with jax's
``enable_x64`` under the name the reference imports), and every program a
search runs a second time is run under a dispatch mode that fails on what
a CUDA-graph capture forbids (a sync with the host, a copy from it).
"""

import gc
import math
import random
import weakref

import jax
import jax.experimental
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.architecture import cloud_accelerator as jax_cloud
from repro.core.architecture import edge_accelerator as jax_edge
from repro.core.cost import analysis as jax_analysis
from repro.core.cost.analysis import get_context as jax_get_context
from repro.core.mapping import mapping_signature as jax_signature
from repro.core.optimizer import union_opt as jax_union_opt
from repro.core.problem import Problem as JaxProblem

from repro_torch.codesign import CalibrationScale
from repro_torch.core.architecture import (
    cloud_accelerator,
    edge_accelerator,
    h100_sm,
    tpu_chip,
    tpu_v5e_pod,
)
from repro_torch.core.cost import EvaluationEngine, MaestroLikeModel, TimeloopLikeModel
from repro_torch.core.cost import _xp_torch
from repro_torch.core.cost import analysis
from repro_torch.core.cost.analysis import (
    _make_generic_fused_core,
    exact_divisor,
    get_context,
    global_trace_count,
    graph_count,
    reset_trace_registry,
)
from repro_torch.core.cost.engine import BACKENDS
from repro_torch.core.cost.roofline import TPURooflineModel
from repro_torch.core.genome_batch import random_genome_batch
from repro_torch.core.mapping import mapping_signature
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.optimizer import union_opt
from repro_torch.core.problem import Problem
from repro_torch.runtime import CircuitBreaker

DEV = "cpu"
PROBLEMS = {
    "gemm": lambda P: P.gemm(64, 32, 16, word_bytes=1),
    "conv": lambda P: P.conv2d(2, 8, 8, 7, 7, 3, 3, stride=2, name="conv_t", word_bytes=1),
}
GEMM = PROBLEMS["gemm"](Problem)
# same shape class as GEMM, different content (the sharing tests hinge on it)
GEMM_B = Problem.gemm(128, 64, 48, word_bytes=2)
ARCHS = {"edge": (edge_accelerator, jax_edge), "cloud": (cloud_accelerator, jax_cloud)}
MODELS = [TimeloopLikeModel, MaestroLikeModel]
ALL_MODELS = {"timeloop": TimeloopLikeModel, "maestro": MaestroLikeModel,
              "tpu_roofline": TPURooflineModel}
NS = _xp_torch.namespace(DEV)


def _costs_equal(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in (
        "latency_cycles", "energy_pj", "utilization", "macs", "frequency_hz", "breakdown"))


def _sigs(problem, arch, seed=11, n=13):
    space = MapSpace(problem, arch)
    rng = random.Random(seed)
    return [space.random_genome(rng).signature(tuple(problem.dims)) for _ in range(n)]


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ #
# the namespace's ops
# ------------------------------------------------------------------ #
def test_namespace_ops_follow_numpy():
    x = np.array([[0.5, 3.0, -1.0], [2.0, 7.0, 1.0]])
    t = NS.asarray(x)
    assert t.dtype == torch.float64 and t.device == torch.device(DEV)
    assert _eq(NS.maximum(1.0, t), np.maximum(1.0, x))
    assert _eq(NS.maximum(t, 1.0), np.maximum(x, 1.0))
    assert _eq(NS.minimum(4.0, t), np.minimum(4.0, x))
    assert _eq(NS.cummax(NS.asarray(np.array([3, 1, 4, 1, 5])), axis=0), [3, 3, 4, 4, 5])
    assert _eq(NS.full(3, NS.scalar(2.5)), np.full(3, 2.5))
    assert NS.ones(4).dtype == torch.float64 and NS.zeros(2, dtype=bool).dtype == torch.bool
    assert _eq(NS.argmax(NS.asarray(np.array([[1.0, 3.0], [3.0, 1.0]])), axis=0), [1, 0])
    # host constants become device scalars once, by value
    assert NS.scalar(3.0) is NS.scalar(3.0) and exact_divisor(np, 3.0) == 3.0
    assert exact_divisor(NS, 3.0) is NS.scalar(3.0)


# ------------------------------------------------------------------ #
# the array programs, one by one
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_traffic_and_bound_batches_match_numpy_and_reference(kind, arch_name):
    """The traffic core and the lower-bound core on torch == numpy == the
    reference's numpy cores, array by array."""
    problem, arch = PROBLEMS[kind](Problem), ARCHS[arch_name][0]()
    jproblem, jarch = PROBLEMS[kind](JaxProblem), ARCHS[arch_name][1]()
    ctx, jctx = get_context(problem, arch), jax_get_context(jproblem, jarch)
    sigs = _sigs(problem, arch)
    bt_np = ctx.signature_traffic_batch(sigs)
    bt_t = ctx.signature_traffic_batch(sigs, backend="torch", device=DEV)
    bt_ref = jctx.signature_traffic_batch(sigs)
    assert not ctx._torch_failed
    for f in ("compute_cycles", "total_trips", "par", "inst_at", "tt", "st", "fans"):
        assert _eq(getattr(bt_t, f), getattr(bt_np, f)), f
        assert _eq(getattr(bt_t, f), getattr(bt_ref, f)), f
    for rt, rn, rr in zip(bt_t.rows, bt_np.rows, bt_ref.rows):
        for a, b, c in zip(rt, rn, rr):
            assert _eq(a, b) and _eq(a, c)
    sel = [0, 3, 4, 11]
    bt_sel = ctx.signature_traffic_batch(None, backend="torch", device=DEV,
                                         stacked=ctx.stacked_batch(sigs), select=sel)
    assert _eq(bt_sel.compute_cycles, bt_np.compute_cycles[sel])
    lb_np = ctx.lower_bound_batch(sigs)
    lb_t = ctx.lower_bound_batch(sigs, backend="torch", device=DEV)
    lb_ref = jctx.lower_bound_batch(sigs)
    for a, b, c in zip(lb_t, lb_np, lb_ref):
        assert _eq(a, b) and _eq(a, c)


@pytest.mark.parametrize("model", sorted(ALL_MODELS))
def test_evaluate_signature_batch_matches_numpy(model):
    """Each model's batched Costs on torch == numpy == the scalar path."""
    arch = cloud_accelerator()
    sigs = _sigs(GEMM, arch, seed=3, n=24)
    cm = ALL_MODELS[model]()
    got = cm.evaluate_signature_batch(GEMM, arch, sigs, backend="torch", device=DEV)
    want = cm.evaluate_signature_batch(GEMM, arch, sigs)
    assert got is not None and len(got) == len(sigs)
    for a, b, sig in zip(got, want, sigs):
        assert _costs_equal(a, b)
        scalar = cm.evaluate_signature(GEMM, arch, sig)
        if scalar is not None:
            assert _costs_equal(a, scalar)


# ------------------------------------------------------------------ #
# the fused programs: per-context and shape-generic
# ------------------------------------------------------------------ #
def _stacked(problem, arch, seed, B=24):
    return random_genome_batch(MapSpace(problem, arch), np.random.default_rng(seed), B).stacked()


def _generic_out(cm, problem, arch, sb, metric, xp, incumbent=math.inf):
    ctx = get_context(problem, arch)
    model_key, model_params, terms = cm.batch_cost_terms_generic(problem, arch)
    p = dict(ctx.shape_params())
    p.update(model_params)
    if xp is not np:
        p = {k: xp.asarray(v) for k, v in p.items()}
        sb = [xp.asarray(a) for a in (sb.tt, sb.st, sb.perm)]
    else:
        sb = [sb.tt, sb.st, sb.perm]
    core = _make_generic_fused_core(ctx.shape_class_key(), terms, metric, xp)
    return _host(core(*sb, incumbent, p))


def _context_out(cm, problem, arch, sb, metric, incumbent=math.inf):
    ctx = get_context(problem, arch)
    core = ctx._make_fused_core(np, cm.batch_admit_core_builder(problem, arch),
                                cm.batch_cost_terms_fn(problem, arch), metric)
    return core(sb.tt, sb.st, sb.perm, incumbent)


def _host(out):
    def h(a):
        return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    admit, lb_mx, lat, en, ut, smx, extras = out
    return (h(admit), h(lb_mx), h(lat), h(en), h(ut), h(smx),
            {k: h(v) for k, v in extras.items()})


def _assert_fused_equal(g, c):
    for i in (0, 2, 3, 4):
        assert _eq(g[i], c[i]), i
    assert float(g[1]) == float(c[1]) and float(g[5]) == float(c[5])
    for k in set(g[6]) & set(c[6]):
        assert _eq(g[6][k], c[6][k]), k


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("model_cls", MODELS)
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
@pytest.mark.parametrize("metric", ["edp", "latency", "energy"])
def test_generic_core_on_torch_bit_identical_to_per_context(kind, model_cls, arch_name, metric):
    """The shape-generic fused core on torch tensors (values as a
    parameter pack of device tensors) == the per-context fused core on
    numpy, bit for bit, with no incumbent and with a median-bound one
    that makes the admit bits non-trivial."""
    problem, arch, cm = PROBLEMS[kind](Problem), ARCHS[arch_name][0](), model_cls()
    for seed in (0, 7):
        sb = _stacked(problem, arch, seed)
        g = _generic_out(cm, problem, arch, sb, metric, NS)
        _assert_fused_equal(g, _context_out(cm, problem, arch, sb, metric))
        _assert_fused_equal(g, _generic_out(cm, problem, arch, sb, metric, np))
        lb_cyc, lb_en = g[6]["lb_cycles"], g[6]["lb_energy"]
        scores = {"latency": lb_cyc, "energy": lb_en,
                  "edp": (lb_en * 1e-12) * (lb_cyc / arch.frequency_hz)}[metric]
        inc = float(np.median(scores))
        g2 = _generic_out(cm, problem, arch, sb, metric, NS, incumbent=inc)
        _assert_fused_equal(g2, _context_out(cm, problem, arch, sb, metric, incumbent=inc))
        assert not g2[0].all()
        # the device-scalarized score is the host engine's metric, bit for bit
        eng = EvaluationEngine(cm, problem, arch, metric=metric)
        assert _eq(g[6]["metric_score"], eng._scalarize_batch(g[2], g[3]))


@pytest.mark.parametrize("model_cls", MODELS)
def test_generic_core_calibrated_scale_bit_identical(model_cls):
    arch = cloud_accelerator()
    cm = model_cls().set_calibration(CalibrationScale(1.7, 1, "test"))
    sb = _stacked(GEMM, arch, 3)
    g = _generic_out(cm, GEMM, arch, sb, "edp", NS)
    _assert_fused_equal(g, _context_out(cm, GEMM, arch, sb, "edp"))
    raw = _generic_out(model_cls(), GEMM, arch, sb, "edp", NS)
    assert not _eq(g[2], raw[2])


@pytest.mark.parametrize("model_cls", MODELS)
def test_one_generic_program_serves_the_shape_class(model_cls):
    """GEMM and GEMM_B share a shape class: ONE torch core built from
    GEMM's terms, fed each problem's parameter pack, reproduces each
    problem's per-context numpy core bit for bit."""
    arch = cloud_accelerator()
    cm = model_cls()
    ctx_a, ctx_b = get_context(GEMM, arch), get_context(GEMM_B, arch)
    skey = ctx_a.shape_class_key()
    assert skey == ctx_b.shape_class_key()
    _k, _p, terms_a = cm.batch_cost_terms_generic(GEMM, arch)
    core = _make_generic_fused_core(skey, terms_a, "edp", NS)
    for problem, ctx in ((GEMM, ctx_a), (GEMM_B, ctx_b)):
        _mk, model_params, _t = cm.batch_cost_terms_generic(problem, arch)
        p = {k: NS.asarray(v) for k, v in {**ctx.shape_params(), **model_params}.items()}
        sb = _stacked(problem, arch, 11)
        got = _host(core(*(NS.asarray(a) for a in (sb.tt, sb.st, sb.perm)), math.inf, p))
        _assert_fused_equal(got, _context_out(cm, problem, arch, sb, "edp"))


# ------------------------------------------------------------------ #
# the engine on the torch backend
# ------------------------------------------------------------------ #
def _engine_costs(cm, problem, arch, backend, seed=5, B=32):
    eng = EvaluationEngine(cm, problem, arch, metric="edp", backend=backend, device=DEV)
    gb = random_genome_batch(MapSpace(problem, arch), np.random.default_rng(seed), B)
    costs = eng.evaluate_batch(gb)
    assert all(c is not None for c in costs)
    return eng, costs


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("model", sorted(ALL_MODELS))
def test_torch_engine_matches_numpy(kind, model):
    """Engine results through the fused torch runner (shape-generic for
    the hierarchical models, per-context for the roofline) == numpy."""
    problem, arch = PROBLEMS[kind](Problem), cloud_accelerator()
    _e, costs_np = _engine_costs(ALL_MODELS[model](), problem, arch, "numpy")
    eng, costs_t = _engine_costs(ALL_MODELS[model](), problem, arch, "torch")
    assert eng.backend == "torch" and not eng._ctx._torch_failed
    assert eng.stats.fused_dispatches == 1 and eng.stats.backend_fallbacks == 0
    generic = getattr(eng._fused_runner, "supports_precompute", False)
    assert generic == (model != "tpu_roofline")
    for a, b in zip(costs_np, costs_t):
        assert _costs_equal(a, b)


@pytest.mark.parametrize("model_cls", MODELS)
def test_calibrated_torch_engine_matches_numpy(model_cls):
    arch = cloud_accelerator()
    mk = lambda: model_cls().set_calibration(CalibrationScale(1.7, 1, "test"))  # noqa: E731
    _e, costs_np = _engine_costs(mk(), GEMM, arch, "numpy")
    eng, costs_t = _engine_costs(mk(), GEMM, arch, "torch")
    assert not eng._ctx._torch_failed
    for a, b in zip(costs_np, costs_t):
        assert _costs_equal(a, b)
    assert all("calibration_scale" in c.breakdown for c in costs_t)


def test_second_problem_in_class_adds_zero_traces():
    """After GEMM's first dispatch, a content-different problem of the
    same shape class dispatches with ZERO new programs."""
    reset_trace_registry()
    arch = cloud_accelerator()
    eng_a, _ = _engine_costs(TimeloopLikeModel(), GEMM, arch, "torch")
    assert eng_a.stats.n_traces >= 1
    before = global_trace_count()
    eng_b, costs_b = _engine_costs(TimeloopLikeModel(), GEMM_B, arch, "torch")
    assert global_trace_count() == before and eng_b.stats.n_traces == 0
    _, costs_np = _engine_costs(TimeloopLikeModel(), GEMM_B, arch, "numpy")
    for a, b in zip(costs_np, costs_b):
        assert _costs_equal(a, b)


def test_warmup_covers_the_whole_shape_class():
    reset_trace_registry()
    arch = cloud_accelerator()
    eng_a = EvaluationEngine(TimeloopLikeModel(), GEMM, arch, backend="torch", device=DEV)
    before = get_context(GEMM, arch).device_dispatches
    assert eng_a.warmup([16, 64]) == 2
    assert eng_a.stats.n_traces == 2
    assert get_context(GEMM, arch).device_dispatches == before + 2
    assert eng_a.stats.evaluated == eng_a.stats.fused_dispatches == 0  # counters untouched
    assert eng_a.warmup([16, 64]) == 0
    eng_b = EvaluationEngine(TimeloopLikeModel(), GEMM_B, arch, backend="torch", device=DEV)
    assert eng_b.warmup([16, 64]) == 0 and eng_b.stats.n_traces == 0
    # numpy and scalar engines have nothing to warm
    assert EvaluationEngine(TimeloopLikeModel(), GEMM, arch).warmup([16, 64]) == 0


def test_trace_counter_attributes_per_engine():
    reset_trace_registry()
    arch = edge_accelerator()
    eng, _ = _engine_costs(MaestroLikeModel(), GEMM, arch, "torch", B=16)
    first = eng.stats.n_traces
    assert first >= 1
    eng.evaluate_batch(random_genome_batch(MapSpace(GEMM, arch), np.random.default_rng(9), 16))
    assert eng.stats.n_traces == first


# ------------------------------------------------------------------ #
# whole searches: five mappers x three models x device loops on/off
# ------------------------------------------------------------------ #
MAPPER_KW = {
    "exhaustive": {"max_mappings": 600, "batch_size": 64},
    "random": {"samples": 256, "batch_size": 32},
    "genetic": {"population": 16, "generations": 4},
    "decoupled": {"offchip_samples": 40, "onchip_samples": 60},
    "heuristic": {"climb_steps": 40},
}
COUNTERS = ("evaluated", "considered", "analyzed", "cache_hits", "pruned", "trajectory")


def _assert_solutions_equal(got, want):
    dims = tuple(got.problem.dims)
    assert mapping_signature(got.mapping, dims) == jax_signature(want.mapping, dims)
    assert _costs_equal(got.cost, want.cost)
    for c in COUNTERS:
        assert getattr(got.search, c) == getattr(want.search, c), c


@pytest.mark.parametrize("loop", ["device-loop", "host-loop"])
@pytest.mark.parametrize("model", sorted(ALL_MODELS))
@pytest.mark.parametrize("mapper", sorted(MAPPER_KW))
def test_search_on_torch_matches_numpy_and_reference(monkeypatch, mapper, model, loop):
    monkeypatch.setenv("UNION_DEVICE_LOOP", "1" if loop == "device-loop" else "0")
    monkeypatch.setenv("UNION_DEVICE_K", "3")
    kw = MAPPER_KW[mapper]
    got = union_opt(GEMM, cloud_accelerator(), mapper=mapper, cost_model=model,
                    engine_backend="torch", engine_device=DEV, **kw)
    want = union_opt(GEMM, cloud_accelerator(), mapper=mapper, cost_model=model, **kw)
    ref = jax_union_opt(PROBLEMS["gemm"](JaxProblem), jax_cloud(), mapper=mapper,
                        cost_model=model, engine_backend="numpy", **kw)
    _assert_solutions_equal(got, want)
    _assert_solutions_equal(got, ref)
    assert got.search.backend_fallbacks == 0 and got.search.fused_dispatches > 0
    loops = mapper in ("random", "exhaustive", "genetic") and model != "tpu_roofline"
    assert (got.search.device_syncs > 0) == (loops and loop == "device-loop")


@pytest.mark.parametrize("metric", ["latency", "energy"])
@pytest.mark.parametrize("mapper", ["random", "genetic"])
def test_search_metrics_on_torch_match_numpy(mapper, metric):
    kw = MAPPER_KW[mapper]
    got = union_opt(GEMM, edge_accelerator(), mapper=mapper, cost_model="maestro",
                    metric=metric, engine_backend="torch", engine_device=DEV, **kw)
    ref = jax_union_opt(PROBLEMS["gemm"](JaxProblem), jax_edge(), mapper=mapper,
                        cost_model="maestro", metric=metric, engine_backend="numpy", **kw)
    _assert_solutions_equal(got, ref)


# ------------------------------------------------------------------ #
# backends, devices, the breaker hook
# ------------------------------------------------------------------ #
def test_backends_and_devices():
    assert BACKENDS == ("numpy", "torch", None)
    with pytest.raises(ValueError, match='"torch" in the port'):
        EvaluationEngine(TimeloopLikeModel(), GEMM, edge_accelerator(), backend="jax")
    eng = EvaluationEngine(TimeloopLikeModel(), GEMM, edge_accelerator(), backend="torch",
                           device=DEV)
    assert eng.device == "cpu"
    assert EvaluationEngine(TimeloopLikeModel(), GEMM, edge_accelerator()).device is None


def test_default_device_is_cuda_and_raises_without_a_card():
    """The torch backend defaults to the card, and never falls back to the
    host quietly: without a card the engine, union_opt and the sweep raise
    before any search."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    arch = edge_accelerator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvaluationEngine(TimeloopLikeModel(), GEMM, arch, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        union_opt(GEMM, arch, mapper="random", engine_backend="torch", samples=8)


def test_engine_breaker_degrade_open_then_probe_recovers():
    from repro_torch.core.mappers import RandomMapper

    arch = edge_accelerator()
    cm = TimeloopLikeModel()
    space = MapSpace(GEMM, arch)
    br = CircuitBreaker(failure_threshold=1, probe_interval=1)
    eng = EvaluationEngine(cm, GEMM, arch, metric="edp", backend="torch", device=DEV,
                           breaker=br)
    ctx = get_context(GEMM, arch)
    prior = ctx._torch_failed
    try:
        ctx._torch_failed = True  # poison: next batch degrades
        res = RandomMapper(samples=64, seed=2).search(space, cm, "edp", engine=eng)
        assert res.best_mapping is not None  # numpy path kept answering
        assert eng.backend == "numpy"
        assert eng.stats.backend_fallbacks == 1
        assert br.state == CircuitBreaker.OPEN
        ctx._torch_failed = False
        assert eng.maybe_restore_backend() is True
        assert eng.backend == "torch" and br.state == CircuitBreaker.HALF_OPEN
        before = eng.stats.fused_dispatches
        res2 = RandomMapper(samples=64, seed=4).search(space, cm, "edp", engine=eng)
        assert res2.best_mapping is not None
        assert eng.stats.fused_dispatches > before  # real torch evidence
        assert br.state == CircuitBreaker.CLOSED and br.recovered == 1
        assert br.transitions == ["closed->open", "open->half_open", "half_open->closed"]
    finally:
        ctx._torch_failed = prior


def test_maybe_restore_backend_noop_paths():
    arch = edge_accelerator()
    cm = TimeloopLikeModel()
    plain = EvaluationEngine(cm, GEMM, arch, backend="numpy")
    assert plain.maybe_restore_backend() is False
    br = CircuitBreaker(failure_threshold=1, probe_interval=1)
    live = EvaluationEngine(cm, GEMM, arch, backend="torch", device=DEV, breaker=br)
    assert live.maybe_restore_backend() is False  # never degraded
    br2 = CircuitBreaker(failure_threshold=1, probe_interval=3)
    eng = EvaluationEngine(cm, GEMM, arch, backend="torch", device=DEV, breaker=br2)
    eng.backend = "numpy"
    br2.record_failure()
    assert br2.state == CircuitBreaker.OPEN
    assert eng.maybe_restore_backend() is False  # denied call 1 of 3
    assert eng.backend == "numpy"


def test_injected_backend_failure_degrades_and_counts(monkeypatch):
    """``UNION_FAULT_JAX`` (the reference's knob) breaks the torch backend
    at its choke point: the engine degrades once, counted, and its
    results stay the numpy engine's."""
    arch = edge_accelerator()
    _e, costs_np = _engine_costs(TimeloopLikeModel(), GEMM_B, arch, "numpy", seed=2)
    monkeypatch.setenv("UNION_FAULT_JAX", "1")
    ctx = get_context(GEMM_B, arch)
    try:
        eng, costs_t = _engine_costs(TimeloopLikeModel(), GEMM_B, arch, "torch", seed=2)
        assert eng.backend == "numpy" and eng.stats.backend_fallbacks == 1
        assert eng.stats.fused_dispatches == 0
    finally:
        ctx._torch_failed = False
    for a, b in zip(costs_np, costs_t):
        assert _costs_equal(a, b)


@pytest.mark.parametrize("path", ["generic-fused", "per-context-fused", "traffic", "bound"])
def test_programming_error_in_a_program_propagates(monkeypatch, path):
    """Only an import or a device failure degrades the backend: a TypeError
    raised on the way into a program is a bug, and the search fails with
    it instead of finishing on numpy."""
    from repro_torch.core.cost.analysis import AnalysisContext

    def broken(*_a, **_k):
        raise TypeError("a shape bug on the way into a program")

    monkeypatch.setattr(AnalysisContext, "_torch_device_padded", broken)
    problem, arch = Problem.gemm(96, 40, 24, word_bytes=1), cloud_accelerator()
    ctx = get_context(problem, arch)
    with pytest.raises(TypeError, match="a shape bug"):
        if path in ("generic-fused", "per-context-fused"):
            model = "timeloop" if path == "generic-fused" else "tpu_roofline"
            union_opt(problem, arch, mapper="random", cost_model=model, samples=64,
                      engine_backend="torch", engine_device=DEV)
        elif path == "traffic":
            ctx.signature_traffic_batch(_sigs(problem, arch), backend="torch", device=DEV)
        else:
            ctx.lower_bound_batch(_sigs(problem, arch), backend="torch", device=DEV)
    assert not ctx._torch_failed


# ------------------------------------------------------------------ #
# nearest-neighbour incumbent seeding (the service's warm start)
# ------------------------------------------------------------------ #
def _engine(backend, **kw):
    return EvaluationEngine(TimeloopLikeModel(), GEMM, edge_accelerator(), metric="edp",
                            backend=backend, device=DEV, **kw)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_seed_incumbent_prunes_early_but_never_changes_results(backend):
    from repro_torch.core.mappers import RandomMapper

    space = MapSpace(GEMM, edge_accelerator())
    plain = _engine(backend)
    ref = RandomMapper(samples=200, seed=3).search(space, plain.cost_model, "edp", engine=plain)
    assert ref.best_mapping is not None
    seeded = _engine(backend)
    seeded.seed_incumbent = ref.best_metric * 2.0  # a sound upper bound
    res = RandomMapper(samples=200, seed=3).search(space, seeded.cost_model, "edp",
                                                   engine=seeded)
    assert res.best_metric == ref.best_metric
    assert res.best_mapping.to_dict() == ref.best_mapping.to_dict()
    assert seeded.stats.seeded_batches > 0
    assert seeded.stats.pruned >= plain.stats.pruned


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_seed_incumbent_too_optimistic_prunes_everything(backend):
    from repro_torch.core.mappers import RandomMapper

    eng = _engine(backend)
    eng.seed_incumbent = 1e-300
    res = RandomMapper(samples=100, seed=5).search(MapSpace(GEMM, edge_accelerator()),
                                                   eng.cost_model, "edp", engine=eng)
    assert res.best_mapping is None and eng.stats.pruned > 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_seed_incumbent_ignored_by_population_fitness_calls(backend):
    from repro_torch.core.mappers import GeneticMapper

    ref = union_opt(GEMM, edge_accelerator(), mapper="genetic", cost_model="timeloop")
    eng = _engine(backend)
    eng.seed_incumbent = 1e-300  # would prune EVERYTHING if consumed
    res = GeneticMapper().search(MapSpace(GEMM, edge_accelerator()), eng.cost_model, "edp",
                                 engine=eng)
    assert res.best_mapping is not None and res.best_metric == ref.search.best_metric
    assert eng.stats.seeded_batches == 0


def test_seed_incumbent_ignored_with_finite_incumbent_or_no_prune():
    eng = _engine("torch")
    eng.seed_incumbent = 123.0
    assert eng._seed_for(math.inf, 8) == 123.0
    assert eng._seed_for(50.0, 8) is None
    assert eng._seed_for(math.inf, 0) is None
    eng2 = _engine("torch", prune=False)
    eng2.seed_incumbent = 123.0
    assert eng2._seed_for(math.inf, 8) is None
    eng.seed_incumbent = math.inf
    assert eng._seed_for(math.inf, 8) is None


# ------------------------------------------------------------------ #
# the programs' dispatch: eager here, one CUDA graph per trace on the card
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("model", ["timeloop", "tpu_roofline"])
@pytest.mark.parametrize("mapper", sorted(MAPPER_KW))
def test_cpu_dispatch_is_eager_and_traces_as_the_reference(monkeypatch, mapper, model):
    """The same search on the reference's jax backend (jit, x64) and on
    the port's torch backend on the CPU: the process-wide trace counts and
    the search's ``n_traces`` agree, and the CPU captured no graph."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True),
                        raising=False)
    kw = MAPPER_KW[mapper]
    jproblem, jarch = PROBLEMS["gemm"](JaxProblem), jax_cloud()
    jax_get_context(jproblem, jarch)._jax_failed = False  # an earlier run without x64
    jax_analysis.reset_trace_registry()
    reset_trace_registry()
    ref = jax_union_opt(jproblem, jarch, mapper=mapper, cost_model=model,
                        engine_backend="jax", **kw)
    got = union_opt(GEMM, cloud_accelerator(), mapper=mapper, cost_model=model,
                    engine_backend="torch", engine_device=DEV, **kw)
    assert ref.search.backend_fallbacks == 0 and got.search.backend_fallbacks == 0
    assert jax_analysis.global_trace_count() == global_trace_count() >= 1
    assert ref.search.n_traces == got.search.n_traces == global_trace_count()
    assert graph_count() == 0
    _assert_solutions_equal(got, ref)


# what a CUDA-graph capture cannot run: a read of a device value on the
# host (item, a data-dependent shape) or a tensor made from host data
_HOST_OPS = {"_local_scalar_dense", "item", "nonzero", "masked_select", "unique",
             "_unique", "_unique2", "unique_consecutive", "unique_dim", "repeat_interleave",
             "is_nonzero", "equal", "lift_fresh", "lift_fresh_copy"}


class _CaptureRules(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        idx = args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else ()
        masked = name.startswith("index") and any(
            isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in idx)
        if name in _HOST_OPS or masked:
            raise AssertionError(f"{func} cannot run inside a CUDA-graph capture")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mk_arch", [cloud_accelerator, tpu_chip, tpu_v5e_pod, h100_sm],
                         ids=["cloud", "tpu_chip", "tpu_v5e_pod", "h100_sm"])
@pytest.mark.parametrize("model", sorted(ALL_MODELS))
def test_every_program_can_be_captured(monkeypatch, model, mk_arch):
    """On the card a program's second dispatch at a key replays the graph
    captured from it, so from then on its body may neither read a device
    value on the host nor copy host data in (a new constant, an index
    list). Here every repeat dispatch of every program the searches run --
    traffic, bound, per-context and shape-generic fused, the device loops'
    -- runs under a dispatch mode that fails on either."""
    monkeypatch.setenv("UNION_DEVICE_K", "2")
    seen, repeats = set(), [0]
    real = analysis._dispatch_program

    def dispatch(pkey, core, args, **kw):
        key = (pkey, int(args[0].shape[1]))
        if key not in seen:
            seen.add(key)
            return real(pkey, core, args, **kw)

        def body(*a):
            repeats[0] += 1
            with _CaptureRules():
                return core(*a)
        return real(pkey, body, args, **kw)

    monkeypatch.setattr(analysis, "_dispatch_program", dispatch)
    problem, arch = Problem.gemm(512, 256, 128, word_bytes=1), mk_arch()
    for mapper in ("random", "genetic", "heuristic"):
        kw = {"random": {"samples": 300, "batch_size": 32},
              "genetic": {"population": 16, "generations": 5}}.get(mapper, {})
        sol = union_opt(problem, arch, mapper=mapper, cost_model=model,
                        engine_backend="torch", engine_device=DEV, **kw)
        assert sol.search.backend_fallbacks == 0
    sb = _stacked(problem, arch, 3, B=40)
    for _ in range(2):
        get_context(problem, arch).signature_traffic_batch(stacked=sb, backend="torch",
                                                           device=DEV)
        get_context(problem, arch).lower_bound_batch(stacked=sb, backend="torch", device=DEV)
    assert repeats[0] >= 2


def test_incumbent_enters_the_program_as_a_device_scalar():
    """As the reference's ``jnp.asarray(float(incumbent))``: a program
    sees the incumbent as a 0-dim float64 tensor on its device (on the
    card, an input of the graph that each replay refills), and its output
    tree comes back whole as host arrays."""
    seen = []

    def core(tt, st, perm, incumbent, p):
        seen.append(incumbent)
        return (tt.sum(dim=(1, 2)) < incumbent, {"x": p["a"] * 2.0, "n": perm[:, 0, 0]})

    stk = NS.asarray(np.arange(3 * 4 * 2).reshape(3, 4, 2, 1) % 5)
    p = {"a": NS.asarray(np.array([1.5, 2.5]))}
    for inc in (3.0, math.inf):
        admit, extras = analysis._dispatch_program(("spy", DEV), core, (stk, inc, p))
        assert isinstance(admit, np.ndarray) and admit.dtype == bool and admit.shape == (4,)
        assert _eq(admit, (np.arange(24).reshape(3, 4, 2) % 5)[0].sum(axis=1) < inc)
        assert _eq(extras["x"], [3.0, 5.0]) and extras["n"].dtype == np.int64
    assert all(isinstance(i, torch.Tensor) and i.dim() == 0 and i.dtype == torch.float64
               for i in seen)
    assert [float(i) for i in seen] == [3.0, math.inf] and graph_count() == 0


class _EagerGraph:
    """A CUDA graph's stand-in on the CPU: it captures by running the
    program and replays by running it again on the inputs loaded last."""

    def __init__(self, core, args):
        self.core, self.graph = core, self
        self.args = analysis._device_args(args)
        self.flat, self.layout = analysis._run_packed(core, self.args)

    def load(self, args):
        self.args = analysis._device_args(args)

    def replay(self):
        self.flat, _ = analysis._run_packed(self.core, self.args)


def test_graphs_of_evicted_contexts_are_freed(monkeypatch):
    """A per-context program's graphs live on its context, so the context
    cache's eviction frees them with it, and a registry reset frees those
    of live contexts; none is kept process-wide. Run through the capture
    path with a stand-in graph: each trace is one graph, each replay
    equals numpy."""
    monkeypatch.setattr(analysis, "_captures", lambda device: True)
    monkeypatch.setattr(analysis, "_Graph", _EagerGraph)
    reset_trace_registry()
    arch = edge_accelerator()
    n = analysis._CTX_CACHE_SIZE + 6
    held = []
    for i in range(n):
        problem = Problem.gemm(16 * (i + 1), 32, 16, word_bytes=1)
        sb = _stacked(problem, arch, i, B=8)
        ctx = get_context(problem, arch)
        want = ctx.lower_bound_batch(stacked=sb)
        for _ in range(2):  # captured, then replayed
            got = ctx.lower_bound_batch(stacked=sb, backend="torch", device=DEV)
            assert _eq(got[0], want[0]) and _eq(got[1], want[1])
        assert len(ctx._torch_graphs) == 1
        graphs = [weakref.ref(g.graph) for g in ctx._torch_graphs.values()]
        held.append((weakref.ref(ctx), graphs))
    del ctx, sb, problem, graphs
    gc.collect()
    evicted, kept = held[:n - analysis._CTX_CACHE_SIZE], held[n - analysis._CTX_CACHE_SIZE:]
    assert all(c() is None and g() is None for c, gs in evicted for g in gs)
    assert all(c() is not None and g() is not None for c, gs in kept for g in gs)
    assert not analysis._GRAPHS
    assert graph_count() == global_trace_count() == n
    reset_trace_registry()
    assert all(not c()._torch_graphs for c, _gs in kept)
    assert graph_count() == global_trace_count() == 0
