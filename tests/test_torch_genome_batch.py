"""The port's array-native candidate generation (``repro_torch.core.
genome_batch``) against the JAX package's, on the CPU.

The same seed on the same map-space must give the same ``tt``/``st``/
``perm`` arrays and the same legality masks, exactly:

* ``random_genome_batch`` (and its parts: chain sampling, fanout repair,
  order sampling);
* ``exhaustive_genome_batches``: the same chunks in the same order;
* ``resample_inner_rows`` (the decoupled mapper's phase 2);
* ``legal_batch`` with and without each constraint set of
  ``tests/test_genome_batch.py``.

The problems are a GEMM, a strided conv and a tensor contraction on
``edge_accelerator`` and ``cloud_accelerator``. The port's own invariants
that ``tests/test_genome_batch.py`` checks on the reference (round trip,
batch legality == scalar legality, the vectorized exhaustive stream ==
the recursive one) are checked here on the port.
"""

import random
from itertools import islice

import numpy as np
import pytest

from repro.core import genome_batch as jgb
from repro.core import constraints as jcons
from repro.core.architecture import cloud_accelerator as jax_cloud, edge_accelerator as jax_edge
from repro.core.mapspace import MapSpace as JaxMapSpace
from repro.core.problem import Problem as JaxProblem

from repro_torch.core import constraints as tcons
from repro_torch.core import genome_batch as gbm
from repro_torch.core.architecture import cloud_accelerator, edge_accelerator
from repro_torch.core.cost import MaestroLikeModel, TimeloopLikeModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.problem import Problem

PROBLEMS = {
    "gemm": lambda P: P.gemm(64, 32, 16, word_bytes=1),
    "conv": lambda P: P.conv2d(2, 8, 8, 7, 7, 3, 3, stride=2, name="conv_t", word_bytes=1),
    "tc": lambda P: P.tc_ccsd7(4, word_bytes=1),
}
ARCHS = {"edge": (edge_accelerator, jax_edge), "cloud": (cloud_accelerator, jax_cloud)}

# the constraint sets of tests/test_genome_batch.py's legality test, by
# name, built in either package (C: the constraints module, arch: its cloud)
CONSTRAINTS = {
    "none": lambda C, arch: None,
    "nvdla": lambda C, arch: C.nvdla_style(("m", "n")),
    "cap1": lambda C, arch: C.Constraints(name="cap1", max_concurrent_spatial=1),
    "mxu": lambda C, arch: C.mxu_aligned(["m"], 8),
    "ws": lambda C, arch: C.weight_stationary(["k"], arch.clusters[1].name),
    "util": lambda C, arch: C.Constraints(name="util", min_utilization=0.01,
                                          max_utilization=0.9),
}


def _spaces(kind, arch, cons="none"):
    """(port space, reference space) for one problem, arch and constraint set."""
    mk_t, mk_j = ARCHS[arch]
    at, aj = mk_t(), mk_j()
    return (MapSpace(PROBLEMS[kind](Problem), at, CONSTRAINTS[cons](tcons, at)),
            JaxMapSpace(PROBLEMS[kind](JaxProblem), aj, CONSTRAINTS[cons](jcons, aj)))


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _rows(gb):
    return gb.tt, gb.st, gb.perm


# ------------------------------------------------------------------ #
# the samplers against the reference's, bit for bit
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_random_genome_batch_matches_reference(kind, arch, seed):
    ts, js = _spaces(kind, arch)
    rt, rj = gbm.philox_rng(seed), jgb.philox_rng(seed)
    for B in (1, 37, 128):  # consecutive calls on one stream, as the mappers draw
        _same(_rows(ts.random_genome_batch(rt, B)), _rows(js.random_genome_batch(rj, B)))
    # the parts: chains, fanout repair, orders
    rt, rj = gbm.philox_rng(seed, salt=3), jgb.philox_rng(seed, salt=3)
    t = gbm.sample_chains_batch(ts, rt, 64)
    j = jgb.sample_chains_batch(js, rj, 64)
    _same(t, j)
    gbm.repair_fanout_batch(ts, rt, *t)
    jgb.repair_fanout_batch(js, rj, *j)
    _same(t, j)
    pt, okt = gbm.sample_orders_batch(ts, rt, 64)
    pj, okj = jgb.sample_orders_batch(js, rj, 64)
    _same((pt,), (pj,))
    assert okt == okj
    _same(gbm.trivial_rows(ts, 5), jgb.trivial_rows(js, 5))


@pytest.mark.parametrize("max_mappings,batch_size", [(3000, 256), (700, 256), (333, 100)])
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_exhaustive_genome_batches_match_reference(kind, arch, max_mappings, batch_size):
    ts, js = _spaces(kind, arch)
    got = list(ts.enumerate_genome_batches(max_mappings=max_mappings, batch_size=batch_size))
    want = list(js.enumerate_genome_batches(max_mappings=max_mappings, batch_size=batch_size))
    assert [len(g) for g in got] == [len(w) for w in want]  # the same chunk boundaries
    for g, w in zip(got, want):
        _same(_rows(g), _rows(w))
    # the first decoded row blocks too, at another block size
    for (tt, st), (jt, js_) in zip(islice(gbm.exhaustive_row_blocks(ts, block=97), 8),
                                   islice(jgb.exhaustive_row_blocks(js, block=97), 8)):
        _same((tt, st), (jt, js_))


RESAMPLE_CASES = ([(kind, split, "none") for kind in PROBLEMS for split in (0, 1, 2)]
                  + [("gemm", split, cons) for cons in ("nvdla", "ws") for split in (1, 2)])


@pytest.mark.parametrize("kind,split,cons", RESAMPLE_CASES)
def test_resample_inner_rows_matches_reference(kind, split, cons):
    ts, js = _spaces(kind, "cloud", cons)
    base = ts.random_genome_batch(gbm.philox_rng(1), 4)
    for b in range(len(base)):
        rt, rj = gbm.philox_rng(10 + b), jgb.philox_rng(10 + b)
        got = gbm.resample_inner_rows(ts, rt, base.tt[b], base.st[b], base.perm[b], split, 50)
        want = jgb.resample_inner_rows(js, rj, base.tt[b], base.st[b], base.perm[b], split, 50)
        _same(got, want)
        _same((gbm.legal_batch(ts, *got, structured=True),),
              (jgb.legal_batch(js, *want, structured=True),))


@pytest.mark.parametrize("cons", list(CONSTRAINTS))
def test_legal_batch_matches_reference(cons):
    ts, js = _spaces("gemm", "cloud", cons)
    rng = gbm.philox_rng(3)
    tt, st = gbm.sample_chains_batch(ts, rng, 200)
    gbm.repair_fanout_batch(ts, rng, tt, st)
    perm, _ = gbm.sample_orders_batch(ts, rng, 200)
    # rows that break nesting too, for the full (structured=False) check
    broken = tt.copy()
    broken[::7, 0, 0] += 1
    for t in (tt, broken):
        _same((gbm.chains_legal_batch(ts, t, st),), (jgb.chains_legal_batch(js, t, st),))
        _same((gbm.constraints_ok_batch(ts, t, st, perm),),
              (jgb.constraints_ok_batch(js, t, st, perm),))
        for structured in (False, True):
            _same((gbm.legal_batch(ts, t, st, perm, structured=structured),),
                  (jgb.legal_batch(js, t, st, perm, structured=structured),))


# ------------------------------------------------------------------ #
# the port's own invariants (tests/test_genome_batch.py on the port)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_genome_batch_round_trip(kind, arch):
    space, _ = _spaces(kind, arch)
    rng = random.Random(0)
    genomes = [space.random_genome(rng) for _ in range(40)]
    gb = gbm.GenomeBatch.from_genomes(space, genomes)
    assert len(gb) == len(genomes)
    for i, g in enumerate(genomes):
        back = gb.genome(i)
        assert back.chains == g.chains and back.orders == g.orders
        assert gb.signature(i) == g.signature(space.dims)
        assert gbm.GenomeBatch.from_genomes(space, [back]).row_key(0) == gb.row_key(i)


@pytest.mark.parametrize("cons", list(CONSTRAINTS))
def test_batch_legality_matches_scalar(cons):
    space, _ = _spaces("gemm", "cloud", cons)
    arch, problem, c = space.arch, space.problem, space.constraints
    rng = gbm.philox_rng(3)
    tt, st = gbm.sample_chains_batch(space, rng, 200)
    gbm.repair_fanout_batch(space, rng, tt, st)
    perm, ok = gbm.sample_orders_batch(space, rng, 200)
    assert ok
    gb = gbm.GenomeBatch(space, tt, st, perm)
    legal = gbm.chains_legal_batch(space, tt, st)
    cok = gbm.constraints_ok_batch(space, tt, st, perm)
    for b in range(200):
        g = gb.genome(b)
        assert bool(legal[b]) == space._chains_legal(g.chains), b
        if legal[b] and c is not None:
            assert bool(cok[b]) == c.ok(g.to_mapping(), problem, arch), b
    ones = (1,) * (2 * arch.n_levels)
    gb2 = space.random_genome_batch(gbm.philox_rng(5), 80)
    for b in range(80):
        g = gb2.genome(b)
        if all(g.chains[d] == ones for d in space.dims):
            continue  # the documented trivial fallback
        m = g.to_mapping()
        assert m.is_legal(problem, arch)
        assert c is None or c.ok(m, problem, arch)


@pytest.mark.parametrize("kind", list(PROBLEMS))
def test_exhaustive_vectorized_stream_equals_recursive(kind):
    space, _ = _spaces(kind, "cloud")
    scalar = list(space.enumerate_genomes(max_mappings=900))
    rows = [g for gb in space.enumerate_genome_batches(max_mappings=900, batch_size=128)
            for g in (gb.genome(i) for i in range(len(gb)))]
    assert [(g.chains, g.orders) for g in rows] == [(g.chains, g.orders) for g in scalar]


@pytest.mark.parametrize("backend", ["numpy", None])
@pytest.mark.parametrize("model", ["timeloop", "maestro"])
def test_engine_genome_batch_matches_list_path_and_reference(model, backend):
    """The engine serves a GenomeBatch (with duplicate rows) exactly as the
    list of its genomes, and as the reference's engine serves the same rows:
    costs and counters."""
    from repro.core.cost import MaestroLikeModel as JaxMaestro, TimeloopLikeModel as JaxTimeloop
    from repro.core.cost.engine import EvaluationEngine as JaxEngine

    models = {"timeloop": (TimeloopLikeModel, JaxTimeloop), "maestro": (MaestroLikeModel, JaxMaestro)}
    ts, js = _spaces("gemm", "cloud")
    idx = np.concatenate([np.arange(120), np.arange(0, 120, 9)])  # duplicates
    gb = ts.random_genome_batch(gbm.philox_rng(1), 120).select(idx)
    jb = js.random_genome_batch(jgb.philox_rng(1), 120).select(idx)
    genomes = [gb.genome(i) for i in range(len(gb))]
    mt, mj = models[model]
    inc = mt().evaluate(ts.problem, genomes[0].to_mapping(), ts.arch).metric("edp")
    engines = [EvaluationEngine(mt(), ts.problem, ts.arch, metric="edp", backend=backend)
               for _ in range(2)]
    ej = JaxEngine(mj(), js.problem, js.arch, metric="edp", backend=backend)
    outs = [engines[0].evaluate_batch(genomes, incumbent=inc, probe=8),
            engines[1].evaluate_batch(gb, incumbent=inc, probe=8),
            ej.evaluate_batch(jb, incumbent=inc, probe=8)]

    def key(c):
        return None if c is None else (c.latency_cycles, c.energy_pj, c.utilization, c.breakdown)

    assert [key(c) for c in outs[0]] == [key(c) for c in outs[1]] == [key(c) for c in outs[2]]
    for attr in ("evaluated", "cache_hits", "pruned", "considered", "store_hits"):
        got = [getattr(e.stats, attr) for e in (*engines, ej)]
        assert len(set(got)) == 1, (attr, got)
