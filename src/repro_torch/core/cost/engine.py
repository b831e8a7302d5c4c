"""Batched, cached, bound-pruned mapping-evaluation engine.

Every mapper's inner loop is "score this candidate mapping with that cost
model". The paper's plug-and-play matrix (any mapper x any model) lives or
dies on the throughput of that loop, so this module centralizes it:

  * **Canonical signatures** -- ``mapping_signature`` collapses a Mapping to
    the (effective loop order, TT, ST) tuple per level that the analytical
    models actually consume. Two mappings with the same signature have
    byte-identical costs, so genetic/heuristic searches stop re-analyzing
    the neighborhoods they revisit (an LRU memo keyed on the signature).
  * **Lower-bound admission** -- a chain-only bound (compute cycles +
    compulsory boundary bytes; see ``CostModel.lower_bound``) rejects
    candidates that provably cannot beat the incumbent BEFORE the expensive
    reuse analysis runs. The bound never exceeds the true metric, so
    pruning never discards a candidate better than the incumbent.
  * **Batching** -- ``evaluate_batch`` deduplicates, prunes, and evaluates a
    population at once. Cache misses are scored as ONE vectorized array
    program (``CostModel.evaluate_signature_batch`` over the stacked
    signature matrices in numpy, bit-identical to the scalar path; or
    ``backend=None`` for the per-candidate scalar path).

The engine is the single evaluation path for all mappers (see
``repro_torch.core.mappers``) and reports evaluated / cache-hit / pruned counters
through ``SearchResult`` so speedups stay observable.
"""

from __future__ import annotations

import logging
import math
from collections import OrderedDict
from dataclasses import dataclass, replace
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.architecture import Architecture
from repro_torch.core.cost.analysis import StackedBatch, get_context
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.cost.store import ResultStore
from repro_torch.core.genome_batch import GenomeBatch, RowCandidate
from repro_torch.core.mapping import Mapping, mapping_signature  # noqa: F401 (re-export)
from repro_torch.core.problem import Problem

log = logging.getLogger("repro_torch.engine")

Signature = Tuple[Tuple[Tuple[str, ...], Tuple[int, ...], Tuple[int, ...]], ...]

# Minimum miss-batch size worth routing through the vectorized array-program
# path; below this the per-candidate scalar path is cheaper.
_BATCH_MIN = 4

#: engine backends of the port: the numpy array programs, or None for the
#: per-candidate scalar path
BACKENDS = ("numpy", None)

# Candidates are either Mapping objects or chain-level genomes
# (``repro_torch.core.mapspace.Genome``): anything with .signature(dims) and
# .to_mapping(). Genomes let the samplers defer Mapping materialization to
# actual cache misses.


@dataclass
class EngineStats:
    """Counters for one engine lifetime (one search, in practice)."""

    evaluated: int = 0  # full cost-model analyses (cache misses everywhere)
    cache_hits: int = 0  # served by the in-engine signature memo
    store_hits: int = 0  # served by the cross-search ResultStore
    pruned: int = 0  # candidates rejected by the lower-bound filter
    batches: int = 0
    # candidate instances submitted by the mapper (pre-dedup, regardless of
    # how they were served). The mapper's candidate stream is unchanged by
    # cache/store warmth, so -- unlike the evaluated/pruned split -- this
    # total is warm/cold invariant.
    considered: int = 0
    admit_s: float = 0.0  # wall-clock spent in the admission (bound) stage
    score_s: float = 0.0  # wall-clock spent scoring admitted misses

    def snapshot(self) -> "EngineStats":
        return replace(self)

    @property
    def candidates(self) -> int:
        return self.evaluated + self.cache_hits + self.store_hits + self.pruned

    @property
    def cache_hit_rate(self) -> float:
        seen = self.evaluated + self.cache_hits + self.store_hits
        return self.cache_hits / seen if seen else 0.0


class EvaluationEngine:
    """Single evaluation path for (one cost model, one problem, one arch).

    Parameters
    ----------
    metric:      the search objective; used to scalarize lower bounds.
    cache_size:  LRU memo capacity (signatures -> Cost).
    prune:       enable the lower-bound admission filter.
    backend:     array backend for the vectorized miss-batch analysis AND
                 the batched admission bound: "numpy" (default) or None
                 (per-candidate scalar path). Any other name raises
                 ValueError: the port has no jax backend, and a torch one
                 is still to come.
    store:       optional cross-search :class:`ResultStore`; probed on
                 memo misses (before the admission filter) and fed every
                 fresh evaluation, so repeated sweeps over the same
                 (problem, arch, model) space stop re-scoring identical
                 signatures across searches and processes.
    """

    def __init__(
        self,
        cost_model: CostModel,
        problem: Problem,
        arch: Architecture,
        metric: str = "edp",
        cache_size: int = 1 << 16,
        prune: bool = True,
        backend: Optional[str] = "numpy",
        store: Optional[ResultStore] = None,
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(
                f"engine backend {backend!r}: the port has {BACKENDS}"
            )
        self.cost_model = cost_model
        self.problem = problem
        self.arch = arch
        self.metric = metric
        self.cache_size = cache_size
        self.prune = prune
        self.backend = backend
        self.stats = EngineStats()
        self._dims: Tuple[str, ...] = tuple(problem.dims.keys())
        self._cache: "OrderedDict[Signature, Cost]" = OrderedDict()
        self._ctx = get_context(problem, arch)
        self._freq = arch.frequency_hz
        self._lb_fn = cost_model.lower_bound_fn(problem, arch)
        self._lb_chains_fn = cost_model.lower_bound_chains_fn(problem, arch)
        self._lb_batch_fn = cost_model.lower_bound_batch_fn(problem, arch)
        self._store = store
        self._store_skey = (
            store.space_key(cost_model, problem, arch) if store is not None else None
        )

    # -------------------------------------------------------------- #
    def signature(self, cand) -> Signature:
        if isinstance(cand, Mapping):
            cached = cand.__dict__.get("_sig_cache")
            if cached is not None and cached[0] == self._dims:
                return cached[1]
            sig = mapping_signature(cand, self._dims)
            # mappings are treated as immutable once they reach the engine
            cand._sig_cache = (self._dims, sig)
            return sig
        return cand.signature(self._dims)

    @staticmethod
    def _materialize(cand) -> Mapping:
        return cand if isinstance(cand, Mapping) else cand.to_mapping()

    def _key_of(self, cand):
        """Memo-cache key. Mappings use the canonical signature; genomes
        use their (orders, chains) tuple, which determines the signature
        1:1 but is much cheaper to build."""
        if isinstance(cand, Mapping):
            return self.signature(cand)
        return cand.cache_key(self._dims)

    def _scalarize(self, lb_cycles: float, lb_energy: float) -> float:
        if self.metric == "latency":
            return lb_cycles
        if self.metric == "energy":
            return lb_energy
        if self.metric == "edp":
            # same association as Cost.edp so lb==true components can never
            # round above the true metric
            return (lb_energy * 1e-12) * (lb_cycles / self._freq)
        return 0.0

    def _scalarize_batch(self, lb_cycles, lb_energy):
        """Vector form of :meth:`_scalarize` -- identical float operations
        per element, so batched admit/reject decisions are bit-identical
        to the scalar filter."""
        if self.metric == "latency":
            return lb_cycles
        if self.metric == "energy":
            return lb_energy
        if self.metric == "edp":
            return (lb_energy * 1e-12) * (lb_cycles / self._freq)
        return lb_cycles * 0.0

    def _should_prune(self, cand, incumbent: float) -> bool:
        if self._lb_chains_fn is not None and not isinstance(cand, Mapping):
            lc, le = self._lb_chains_fn(
                cand.chain_list, cand.orders, incumbent, self._scalarize
            )
        else:
            lc, le = self._lb_fn(self.signature(cand))
        return self._scalarize(lc, le) >= incumbent

    def lower_bound(self, cand, sig: Optional[Signature] = None) -> float:
        """Metric lower bound from the chain alone (no reuse analysis).

        Guaranteed <= ``evaluate(cand).metric(self.metric)``; 0.0 when
        the cost model declines to provide a bound.
        """
        if sig is None:
            sig = self.signature(cand)
        return self._scalarize(*self._lb_fn(sig))

    # -------------------------------------------------------------- #
    def _cache_get(self, sig: Signature) -> Optional[Cost]:
        c = self._cache.get(sig)
        if c is not None:
            self._cache.move_to_end(sig)
            self.stats.cache_hits += 1
        return c

    def _cache_put(self, sig: Signature, cost: Cost) -> None:
        self._cache[sig] = cost
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def _store_get(self, key, cand) -> Optional[Cost]:
        """Cross-search store probe (memo misses only). A hit is promoted
        into the memo so in-batch duplicates become plain cache hits."""
        if self._store is None:
            return None
        c = self._store.get(self._store_skey, self.signature(cand))
        if c is not None:
            self.stats.store_hits += 1
            self._cache_put(key, c)
        return c

    def _store_put(self, cand, cost: Cost) -> None:
        if self._store is not None:
            self._store.put(self._store_skey, self.signature(cand), cost)

    def _evaluate_one(self, cand) -> Cost:
        c = self.cost_model.evaluate_signature(
            self.problem, self.arch, self.signature(cand)
        )
        if c is None:
            c = self.cost_model.evaluate(self.problem, self._materialize(cand), self.arch)
        return c

    # -------------------------------------------------------------- #
    def evaluate(self, cand) -> Cost:
        """Memoized single evaluation (always admits)."""
        self.stats.considered += 1
        key = self._key_of(cand)
        c = self._cache_get(key)
        if c is not None:
            return c
        c = self._store_get(key, cand)
        if c is not None:
            return c
        c = self._evaluate_one(cand)
        self.stats.evaluated += 1
        self._cache_put(key, c)
        self._store_put(cand, c)
        return c

    def evaluate_admit(self, cand, incumbent: float) -> Optional[Cost]:
        """Evaluate unless the lower bound proves the candidate cannot beat
        ``incumbent`` (returns None in that case). Cached/stored candidates
        are returned directly -- a hit is cheaper than the bound."""
        self.stats.considered += 1
        key = self._key_of(cand)
        c = self._cache_get(key)
        if c is not None:
            return c
        c = self._store_get(key, cand)
        if c is not None:
            return c
        if self.prune and incumbent != math.inf:
            t0 = perf_counter()
            dominated = self._should_prune(cand, incumbent)
            self.stats.admit_s += perf_counter() - t0
            if dominated:
                self.stats.pruned += 1
                return None
        t0 = perf_counter()
        c = self._evaluate_one(cand)
        self.stats.score_s += perf_counter() - t0
        self.stats.evaluated += 1
        self._cache_put(key, c)
        self._store_put(cand, c)
        return c

    def evaluate_genome_batch(
        self,
        gb: GenomeBatch,
        incumbent: float = math.inf,
        probe: int = 0,
    ) -> List[Optional[Cost]]:
        """Array-native :meth:`evaluate_batch` over a dense
        :class:`GenomeBatch`: in-batch dedup is one ``np.unique`` row-hash
        program, memo keys are raw row bytes (same granularity as the
        per-genome tuple keys), and the miss-batch's ``StackedBatch`` is a
        row SLICE of the batch matrices -- no per-candidate signature
        tuples, Genome or Mapping objects are built on the batched
        backends (scalar fallbacks materialize rows lazily). Counter
        semantics match the list path exactly: every occurrence of a
        memo-cached candidate counts a cache hit, a store hit counts once
        and promotes (duplicates become cache hits), duplicates of a miss
        or pruned candidate count once per batch.
        """
        if probe and incumbent == math.inf and len(gb) > probe:
            head = self.evaluate_genome_batch(gb.select(slice(0, probe)))
            inc = incumbent
            for c in head:
                if c is not None:
                    s = c.metric(self.metric)
                    if s < inc:
                        inc = s
            return head + self.evaluate_genome_batch(
                gb.select(slice(probe, len(gb))), incumbent=inc
            )

        self.stats.batches += 1
        self.stats.considered += len(gb)
        results: List[Optional[Cost]] = [None] * len(gb)
        rows2d = gb.key_rows()
        pending: Dict = {}
        order: List[Tuple[object, object]] = []
        miss_rows: List[int] = []
        for idx in range(len(gb)):
            key = rows2d[idx].tobytes()
            c = self._cache_get(key)
            if c is not None:
                results[idx] = c
                continue
            dup = pending.get(key)
            if dup is not None:
                dup.append(idx)
                continue
            cand = RowCandidate(gb, idx)
            c = self._store_get(key, cand)
            if c is not None:
                results[idx] = c
                continue
            pending[key] = [idx]
            order.append((key, cand))
            miss_rows.append(idx)

        stacked = (
            gb.stacked(miss_rows) if (order and self.backend is not None) else None
        )
        self._serve_order(order, incumbent, results, pending, stacked=stacked)
        return results

    def evaluate_batch(
        self,
        candidates: Sequence,
        incumbent: float = math.inf,
        probe: int = 0,
    ) -> List[Optional[Cost]]:
        """Evaluate a population: dedup within the batch, serve memo/store
        hits, reject bound-dominated candidates (entries come back
        ``None``), and evaluate the misses -- the admission bound runs as
        ONE masked array program over the whole batch (bit-identical
        decisions and counters to the per-candidate filter), the survivors
        as one scoring program (sharing the admission stage's stacked
        matrices), or on the worker pool.

        ``incumbent=inf`` disables pruning for this batch (population
        mappers that need a true fitness for every member use this).
        ``probe`` is the engine-level warm start: while no incumbent
        exists, the first ``probe`` candidates are scored unpruned and the
        best of them becomes the incumbent for the rest of the batch --
        the candidate stream is untouched and the bound is exact, so
        results are identical for any ``probe``.

        In-batch duplicates of a PRUNED candidate are tracked the same way
        duplicates of a miss are: the bound runs once and ``stats.pruned``
        counts the candidate once per batch, mirroring the dedup semantics
        of ``evaluated``.

        A :class:`GenomeBatch` is dispatched to the array-native
        :meth:`evaluate_genome_batch` (identical semantics, dedup and
        stacking as array programs).
        """
        if isinstance(candidates, GenomeBatch):
            return self.evaluate_genome_batch(candidates, incumbent, probe)
        if probe and incumbent == math.inf and len(candidates) > probe:
            head = self.evaluate_batch(candidates[:probe])
            inc = incumbent
            for c in head:
                if c is not None:
                    s = c.metric(self.metric)
                    if s < inc:
                        inc = s
            return head + self.evaluate_batch(candidates[probe:], incumbent=inc)

        self.stats.batches += 1
        self.stats.considered += len(candidates)
        results: List[Optional[Cost]] = [None] * len(candidates)
        pending: Dict = {}
        order: List[Tuple[object, object]] = []  # unique non-hit (key, cand)
        for idx, cand in enumerate(candidates):
            key = self._key_of(cand)
            c = self._cache_get(key)
            if c is not None:
                results[idx] = c
                continue
            dup = pending.get(key)
            if dup is not None:
                dup.append(idx)
                continue
            c = self._store_get(key, cand)
            if c is not None:
                results[idx] = c
                continue
            pending[key] = [idx]
            order.append((key, cand))

        self._serve_order(order, incumbent, results, pending)
        return results

    def _serve_order(
        self,
        order: List[Tuple[object, object]],
        incumbent: float,
        results: List[Optional[Cost]],
        pending: Dict,
        stacked=None,
    ) -> None:
        """Admission + scoring for one batch's unique non-hit candidates:
        the shared tail of :meth:`evaluate_batch` (which stacks lazily
        from signatures) and :meth:`evaluate_genome_batch` (which hands in
        the row-sliced ``StackedBatch``). ``pending`` maps each key to its
        duplicate result slots."""
        def commit(misses, costs):
            for (key, cand), c in zip(misses, costs):
                self.stats.evaluated += 1
                self._cache_put(key, c)
                self._store_put(cand, c)
                for idx in pending[key]:
                    results[idx] = c

        misses = order
        select: Optional[List[int]] = None
        if self.prune and incumbent != math.inf and order:
            t0 = perf_counter()
            admit, stacked = self._admit_batch(order, incumbent, stacked=stacked)
            misses, select = self._partition_admitted(order, admit)
            self.stats.admit_s += perf_counter() - t0

        if misses:
            t0 = perf_counter()
            commit(
                misses,
                self._evaluate_misses(
                    misses,
                    stacked=stacked,
                    select=select if stacked is not None else None,
                ),
            )
            self.stats.score_s += perf_counter() - t0

    def _partition_admitted(self, order, admit):
        """Split a batch's unique candidates by admit flag, counting one
        ``pruned`` tick per rejected candidate -- the single accounting
        path of the admission flow."""
        misses: List[Tuple[object, object]] = []
        select: List[int] = []
        for pos, ((key, cand), ok) in enumerate(zip(order, admit)):
            if ok:
                misses.append((key, cand))
                select.append(pos)
            else:
                self.stats.pruned += 1
        return misses, select

    def _admit_batch(self, order, incumbent: float, stacked=None):
        """Admission decisions for the unique non-hit candidates of one
        batch: True = evaluate, False = prune. One vectorized bound program
        when the model provides it (returning the shared StackedBatch for
        the scoring stage); the per-candidate scalar bound otherwise --
        decisions are bit-identical either way."""
        sb = stacked
        if (
            self.backend is not None
            and self._lb_batch_fn is not None
            and len(order) >= _BATCH_MIN
        ):
            if sb is None:
                sb = self._ctx.stacked_batch(
                    [self.signature(cand) for _key, cand in order]
                )
            lb = self._lb_batch_fn(None, stacked=sb)
            if lb is not None:
                scal = self._scalarize_batch(*lb)
                return [bool(v < incumbent) for v in scal], sb
        # scalar fallback (tiny batch, no batched bound, or exactness guard
        # tripped); an already-built StackedBatch is still handed to the
        # scoring stage so the batch is never stacked twice
        return [not self._should_prune(cand, incumbent) for _key, cand in order], sb

    # -------------------------------------------------------------- #
    def _evaluate_misses(
        self,
        misses: List[Tuple[object, object]],
        stacked=None,
        select=None,
    ) -> List[Cost]:
        if self.backend is not None and (
            stacked is not None or len(misses) >= _BATCH_MIN
        ):
            # with a pre-stacked batch the models never touch the
            # signatures -- the array program runs off the matrices
            sigs = (
                None
                if stacked is not None
                else [self.signature(cand) for _key, cand in misses]
            )
            costs = self.cost_model.evaluate_signature_batch(
                self.problem,
                self.arch,
                sigs,
                stacked=stacked,
                select=select,
            )
            if costs is not None:
                return list(costs)
        return [self._evaluate_one(cand) for _key, cand in misses]
