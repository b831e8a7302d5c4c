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
    signature matrices; numpy by default, float64 tensors on a torch device
    via ``backend="torch"`` -- one fused admit+score program per
    miss-batch, bit-identical to the scalar path either way; or
    ``backend=None`` for the per-candidate scalar path), or optionally
    fanned out to a process pool (``workers > 0``).

The engine is the single evaluation path for all mappers (see
``repro_torch.core.mappers``) and reports evaluated / cache-hit / pruned counters
through ``SearchResult`` so speedups stay observable.
"""

from __future__ import annotations

import logging
import math
import pickle
from collections import OrderedDict
from dataclasses import dataclass, replace
from time import perf_counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.architecture import Architecture
from repro_torch.core.cost.analysis import (
    BATCH_EXACT_LIMIT,
    StackedBatch,
    get_context,
    global_trace_count,
)
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.cost.store import ResultStore
from repro_torch.core.genome_batch import GenomeBatch, RowCandidate
from repro_torch.core.mapping import Mapping, mapping_signature  # noqa: F401 (re-export)
from repro_torch.core.problem import Problem

log = logging.getLogger("repro_torch.engine")

Signature = Tuple[Tuple[Tuple[str, ...], Tuple[int, ...], Tuple[int, ...]], ...]

# Minimum miss-batch size worth routing through the vectorized array-program
# path; below this the per-candidate fused scalar path is cheaper.
_BATCH_MIN = 4

#: engine backends of the port: the numpy array programs, the same programs
#: on float64 tensors of a torch device, or None for the per-candidate
#: scalar path
BACKENDS = ("numpy", "torch", None)

# Candidates are either Mapping objects or chain-level genomes
# (``repro_torch.core.mapspace.Genome``): anything with .signature(dims) and
# .to_mapping(). Genomes let the samplers defer Mapping materialization to
# actual cache misses.


class _FusedOutcome(NamedTuple):
    """Result of one fused admit+score attempt (see
    ``EvaluationEngine._fused_admit_score``)."""

    decided: bool  # admission decisions were made on device
    misses: Optional[List[Tuple[object, object]]]  # admitted (key, cand)
    select: Optional[List[int]]  # admitted row indices into the batch
    stacked: Optional[object]  # StackedBatch to reuse on any fallback
    arrays: Optional[tuple]  # (latency, energy, util, extras) or None


class PrecomputedScores:
    """Host-materialized results of one mega-batch generic-fused dispatch
    (see ``repro_torch.core.device_loop``): per-row admission-bound and score
    arrays for one :class:`GenomeBatch`, in row order. ``_serve_order``
    consumes them in place of a dispatch -- admission is recomputed
    host-side from the bound arrays against the CURRENT incumbent, so
    decisions (and therefore memo/store/counters) match a per-batch
    dispatch exactly even when the scoring ran generations earlier."""

    __slots__ = ("lb_cyc", "lb_en", "latency", "energy", "util", "extras")

    def __init__(self, lb_cyc, lb_en, latency, energy, util, extras) -> None:
        self.lb_cyc = lb_cyc
        self.lb_en = lb_en
        self.latency = latency
        self.energy = energy
        self.util = util
        self.extras = extras

    def select(self, rows) -> "PrecomputedScores":
        """Row-sliced view (slice object or index list), mirroring
        ``GenomeBatch.select`` for the probe recursion."""
        return PrecomputedScores(
            self.lb_cyc[rows],
            self.lb_en[rows],
            self.latency[rows],
            self.energy[rows],
            self.util[rows],
            {k: v[rows] for k, v in self.extras.items()},
        )


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
    # miss-batches served by the single-dispatch fused admit+score program
    # (torch backend): one device dispatch covered bound + mask + traffic +
    # energy for the whole batch.
    fused_dispatches: int = 0
    # the torch backend broke mid-flight (a device, dispatch or import
    # failure) and the engine degraded itself to the numpy batch path --
    # results are bit-identical by the backend contract, so this is a
    # warning-level event, not an error (at most 1 per engine unless a
    # circuit breaker re-arms the torch path and it fails again).
    backend_fallbacks: int = 0
    # batches whose incumbent was warm-started from ``seed_incumbent``
    # (nearest-neighbor warm start): admission pruned from candidate #1
    # instead of bootstrapping via an unpruned probe head.
    seeded_batches: int = 0
    # NEW (program, pow2 bucket) combinations first dispatched on behalf of
    # this engine (sampled as deltas of the process-global trace registry
    # around every dispatch site, so shape-generic cache hits -- a program
    # first run by ANOTHER engine of the same shape class -- count zero).
    # On a CUDA device each is one captured graph.
    n_traces: int = 0
    # host<->device synchronization points of the device-resident search
    # loops (one per mega-batch precompute / deferred-generation flush);
    # stays 0 on the host-loop paths.
    device_syncs: int = 0
    # the process pool (``workers > 0``) could not start and the engine
    # scores its misses in-process instead, as the reference does quietly;
    # counted (and logged) so a run can assert it did not happen
    pool_failed: int = 0
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


# ------------------------------------------------------------------ #
# Process-pool plumbing. Workers hold the (cost model, problem, arch)
# triple in module state (shipped once via the initializer) and receive
# only mapping dicts per task. A spawned worker imports this module and
# numpy, and torch only for an engine on the torch backend.
# ------------------------------------------------------------------ #
_POOL_STATE: Optional[Tuple[CostModel, Problem, Architecture]] = None


def _pool_init(payload: bytes) -> None:
    global _POOL_STATE
    _POOL_STATE = pickle.loads(payload)


def _pool_eval(mapping_dicts: List[dict]) -> List[Cost]:
    cm, problem, arch = _POOL_STATE  # type: ignore[misc]
    return [cm.evaluate(problem, Mapping.from_dict(d), arch) for d in mapping_dicts]


class EvaluationEngine:
    """Single evaluation path for (one cost model, one problem, one arch).

    Parameters
    ----------
    metric:      the search objective; used to scalarize lower bounds.
    cache_size:  LRU memo capacity (signatures -> Cost).
    prune:       enable the lower-bound admission filter.
    workers:     >0 fans cache misses of ``evaluate_batch`` out to a
                 spawned process pool (beneficial for expensive models /
                 large batches; 0 keeps everything in-process). A pool
                 that cannot be built (a payload that does not pickle, a
                 host without process queues) leaves the engine serial,
                 counted in ``stats.pool_failed`` and logged; a worker that
                 then fails to spawn raises from the batch, as in the
                 reference.
    backend:     array backend for the vectorized miss-batch analysis AND
                 the batched admission bound: "numpy" (default), "torch"
                 (the fused device path: float64/int64 tensors on
                 ``device``) or None (per-candidate scalar path). Any other
                 name raises ValueError (the reference's "jax" included).
    device:      the torch backend's device, "cuda" by default; "cpu"
                 runs the same programs on the host (the tests do). A CUDA
                 device that torch cannot see raises RuntimeError here,
                 before any search.
    store:       optional cross-search :class:`ResultStore`; probed on
                 memo misses (before the admission filter) and fed every
                 fresh evaluation, so repeated sweeps over the same
                 (problem, arch, model) space stop re-scoring identical
                 signatures across searches and processes.
    breaker:     optional circuit breaker (``runtime.fault_tolerance.
                 CircuitBreaker``, duck-typed so core stays free of the
                 runtime package). ``_check_backend_degraded`` reports a
                 torch failure to it, and :meth:`maybe_restore_backend`
                 re-arms the torch path when the breaker's probe schedule
                 admits a half-open retry -- turning the one-way
                 degradation into a recoverable state machine for
                 long-lived processes (the mapping-service daemon).

    ``seed_incumbent`` (attribute, default None) warm-starts a search:
    when a batch arrives with ``probe`` set and no incumbent yet
    (``incumbent == inf``), the seed is used as the incumbent for the
    whole batch INSTEAD of the unpruned probe head -- admission prunes
    from candidate #1. Sound by the lower-bound contract: any candidate
    whose true metric beats the seed has ``lb <= true < seed`` and is
    always admitted, so the best found is unchanged whenever the space
    can beat the seed at all; a too-optimistic seed prunes everything
    (every result None) and the CALLER must fall back to an unseeded
    retry. Population calls that disable pruning (``incumbent=inf``
    without ``probe``, e.g. genetic fitness batches) never consume it.
    """

    def __init__(
        self,
        cost_model: CostModel,
        problem: Problem,
        arch: Architecture,
        metric: str = "edp",
        cache_size: int = 1 << 16,
        prune: bool = True,
        workers: int = 0,
        backend: Optional[str] = "numpy",
        store: Optional[ResultStore] = None,
        breaker: Optional[object] = None,
        device: str = "cuda",
    ) -> None:
        if backend not in BACKENDS:
            hint = " (the reference's jax backend is \"torch\" in the port)" if (
                backend == "jax") else ""
            raise ValueError(
                f"engine backend {backend!r}: the port has {BACKENDS}{hint}"
            )
        self.cost_model = cost_model
        self.problem = problem
        self.arch = arch
        self.metric = metric
        self.cache_size = cache_size
        self.prune = prune
        self.workers = max(0, int(workers))
        self.backend = backend
        self.device = _torch_device(device) if backend == "torch" else None
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
        self._pool = None
        self._pool_failed = False
        # fused single-dispatch admit+score (torch backend only; lazy)
        self._fused_runner = None
        self._fused_failed = False
        # nearest-neighbor warm start (see class docstring)
        self.seed_incumbent: Optional[float] = None
        # circuit-breaker hook (duck-typed; see class docstring)
        self._breaker = breaker
        self._requested_backend = self.backend
        self._probe_pending = False  # restored torch path awaiting evidence
        self._probe_baseline = 0  # fused_dispatches at restore time

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

    def _seed_for(self, incumbent: float, probe: int) -> Optional[float]:
        """The effective warm-start incumbent for a batch, or None.

        Consumed ONLY on the probe path (``probe > 0`` and no incumbent
        yet) with pruning enabled -- exactly the situation where the
        engine would otherwise bootstrap the incumbent from an unpruned
        probe head. Population fitness calls (``incumbent=inf`` without
        ``probe``) and batches that already carry a finite incumbent are
        never touched, so genetic search semantics are preserved.
        """
        s = self.seed_incumbent
        if (
            probe
            and incumbent == math.inf
            and self.prune
            and s is not None
            and math.isfinite(s)
            and s > 0.0
        ):
            return float(s)
        return None

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
        precomputed: Optional[PrecomputedScores] = None,
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

        ``precomputed`` hands in this batch's rows of an earlier
        mega-batch device dispatch (:class:`PrecomputedScores`, built by
        ``repro_torch.core.device_loop``): memo/store/dedup/admission run
        exactly as usual, but miss scoring reads the precomputed arrays
        instead of dispatching -- results, counters, and side effects are
        identical to a fresh dispatch by construction.
        """
        seed = self._seed_for(incumbent, probe)
        if seed is not None:
            self.stats.seeded_batches += 1
            return self.evaluate_genome_batch(
                gb, incumbent=seed, precomputed=precomputed
            )
        if probe and incumbent == math.inf and len(gb) > probe:
            head = self.evaluate_genome_batch(
                gb.select(slice(0, probe)),
                precomputed=(
                    precomputed.select(slice(0, probe))
                    if precomputed is not None
                    else None
                ),
            )
            inc = incumbent
            for c in head:
                if c is not None:
                    s = c.metric(self.metric)
                    if s < inc:
                        inc = s
            return head + self.evaluate_genome_batch(
                gb.select(slice(probe, len(gb))),
                incumbent=inc,
                precomputed=(
                    precomputed.select(slice(probe, len(gb)))
                    if precomputed is not None
                    else None
                ),
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
            gb.stacked(miss_rows)
            if (order and self.backend is not None and precomputed is None)
            else None
        )
        self._serve_order(
            order,
            incumbent,
            results,
            pending,
            stacked=stacked,
            precomputed=precomputed,
        )
        return results

    def evaluate_batch(
        self,
        candidates: Sequence,
        incumbent: float = math.inf,
        probe: int = 0,
        precomputed: Optional[PrecomputedScores] = None,
    ) -> List[Optional[Cost]]:
        """Evaluate a population: dedup within the batch, serve memo/store
        hits, reject bound-dominated candidates (entries come back
        ``None``), and evaluate the misses -- the admission bound runs as
        ONE masked array program over the whole batch (bit-identical
        decisions and counters to the per-candidate filter), the survivors
        as one scoring program (sharing the admission stage's stacked --
        and, on torch, device-resident -- matrices), or on the worker pool.

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
            return self.evaluate_genome_batch(
                candidates, incumbent, probe, precomputed=precomputed
            )
        seed = self._seed_for(incumbent, probe)
        if seed is not None:
            self.stats.seeded_batches += 1
            return self.evaluate_batch(candidates, incumbent=seed)
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
        precomputed: Optional[PrecomputedScores] = None,
    ) -> None:
        """Admission + scoring for one batch's unique non-hit candidates:
        the shared tail of :meth:`evaluate_batch` (which stacks lazily
        from signatures) and :meth:`evaluate_genome_batch` (which hands in
        the row-sliced ``StackedBatch``). ``pending`` maps each key to its
        duplicate result slots. ``precomputed`` replaces the dispatch with
        already-materialized arrays (see :class:`PrecomputedScores`)."""
        before = global_trace_count()
        try:
            self._serve_order_impl(
                order, incumbent, results, pending, stacked, precomputed
            )
        finally:
            # delta-sample the process-global trace registry: only programs
            # first dispatched DURING this batch count against this engine
            # (a shape-generic cache hit -- a program another engine of the
            # same class ran first -- correctly counts zero)
            self.stats.n_traces += global_trace_count() - before

    def _serve_order_impl(
        self,
        order: List[Tuple[object, object]],
        incumbent: float,
        results: List[Optional[Cost]],
        pending: Dict,
        stacked=None,
        precomputed: Optional[PrecomputedScores] = None,
    ) -> None:
        def commit(misses, costs):
            for (key, cand), c in zip(misses, costs):
                self.stats.evaluated += 1
                self._cache_put(key, c)
                self._store_put(cand, c)
                for idx in pending[key]:
                    results[idx] = c

        if precomputed is not None and order:
            # device-resident loop replay: the scoring ran generations ago
            # as one mega-batch dispatch; admission is recomputed here from
            # the precomputed bound arrays against the CURRENT incumbent,
            # so decisions/counters/side effects equal a fresh dispatch.
            pre = precomputed
            rows = [cand.row for _key, cand in order]
            # count the batches a host loop would have served via its own
            # fused dispatch (>= _BATCH_MIN; smaller ones go scalar there)
            # so the counter is invariant between device and host runs
            if len(order) >= _BATCH_MIN:
                self.stats.fused_dispatches += 1
            if self.prune and incumbent != math.inf:
                t0 = perf_counter()
                scal = self._scalarize_batch(pre.lb_cyc[rows], pre.lb_en[rows])
                admit = [bool(v < incumbent) for v in scal]
                misses, select = self._partition_admitted(order, admit)
                self.stats.admit_s += perf_counter() - t0
            else:
                misses, select = list(order), list(range(len(order)))
            if misses:
                t0 = perf_counter()
                commit(
                    misses,
                    self.cost_model.costs_from_batch(
                        self.problem,
                        self.arch,
                        pre.latency,
                        pre.energy,
                        pre.util,
                        pre.extras,
                        indices=[rows[pos] for pos in select],
                    ),
                )
                self.stats.score_s += perf_counter() - t0
            # precomputed rows exist only because the device mega-dispatch
            # actually served: that is torch evidence too (probe recovery),
            # and a flag tripped since then must still degrade us
            self._check_backend_degraded()
            return

        misses = order
        select: Optional[List[int]] = None
        decided = False  # admission decisions already made by the fused path

        if order and self.backend == "torch" and len(order) >= _BATCH_MIN:
            fused = self._fused_admit_score(order, incumbent, stacked=stacked)
            stacked = fused.stacked  # reused by every fallback below
            self._check_backend_degraded()  # fused path may have broken torch
            if fused.decided:
                decided = True
                misses, select = fused.misses, fused.select
                if misses and fused.arrays is not None:
                    latency, energy, util, extras = fused.arrays
                    t0 = perf_counter()
                    commit(
                        misses,
                        self.cost_model.costs_from_batch(
                            self.problem,
                            self.arch,
                            latency,
                            energy,
                            util,
                            extras,
                            indices=select,
                        ),
                    )
                    self.stats.score_s += perf_counter() - t0
                    return
                # score guard tripped (arrays is None): the decisions
                # stand and the shared scoring path below re-scores the
                # admitted subset through the numpy/scalar flow.

        if not decided and self.prune and incumbent != math.inf and order:
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
        # scoring (or the batched bound) may have tripped the context's torch
        # flag: degrade now so subsequent batches skip the broken path
        self._check_backend_degraded()

    def _check_backend_degraded(self) -> bool:
        """Degrade a torch engine to the numpy batch path once the analysis
        context has flagged a torch failure (import, device, or dispatch --
        the context records all of them as ``_torch_failed``).

        The numpy and torch array programs are bit-identical by the repo's
        backend contract, so the search continues with unchanged results;
        the event is counted (``stats.backend_fallbacks``) and warned once
        per engine so sweep summaries surface the degradation instead of
        it hiding behind silent per-batch fallbacks.
        """
        if self.backend == "torch" and self._ctx._torch_failed:
            self.backend = "numpy"
            self.stats.backend_fallbacks += 1
            self._probe_pending = False
            if self._breaker is not None:
                self._breaker.record_failure()
            log.warning(
                "torch backend failed for engine (%s on %s); degraded to the "
                "numpy path -- results identical by the backend contract",
                type(self.cost_model).__name__,
                getattr(self.problem, "name", "?"),
            )
            return True
        if (
            self._probe_pending
            and self.backend == "torch"
            and self.stats.fused_dispatches > self._probe_baseline
        ):
            # the restored torch path actually served a fused dispatch
            # without tripping the context flag: report recovery
            self._probe_pending = False
            if self._breaker is not None:
                self._breaker.record_success()
        return False

    def maybe_restore_backend(self) -> bool:
        """Half-open retry of a degraded torch backend, gated by the
        engine's circuit breaker.

        A breaker-less engine keeps the one-way degradation (this is a
        no-op). With a breaker, once its deterministic probe schedule
        admits a retry (``allow()``), the engine clears the analysis
        context's failure flag and re-arms the torch fused path; the next
        fused dispatch that completes without re-tripping the flag
        reports ``record_success`` (breaker closes), while a repeat
        failure reports ``record_failure`` through the normal degradation
        path (breaker re-opens). Returns True when a restore was armed.
        Safe to call between batches at any cadence -- long-lived callers
        (the mapping-service daemon) invoke it per query.
        """
        if (
            self._breaker is None
            or self._requested_backend != "torch"
            or self.backend == "torch"
        ):
            return False
        if not self._breaker.allow():
            return False
        self._ctx._torch_failed = False
        self.backend = "torch"
        self._fused_failed = False
        self._fused_runner = None
        self._probe_pending = True
        self._probe_baseline = self.stats.fused_dispatches
        log.info(
            "circuit breaker admitted a torch probe for engine (%s on %s); "
            "re-armed the fused path",
            type(self.cost_model).__name__,
            getattr(self.problem, "name", "?"),
        )
        return True

    def _partition_admitted(self, order, admit):
        """Split a batch's unique candidates by admit flag, counting one
        ``pruned`` tick per rejected candidate -- the single accounting
        path shared by the fused and two-stage admission flows."""
        misses: List[Tuple[object, object]] = []
        select: List[int] = []
        for pos, ((key, cand), ok) in enumerate(zip(order, admit)):
            if ok:
                misses.append((key, cand))
                select.append(pos)
            else:
                self.stats.pruned += 1
        return misses, select

    def _fused_admit_score(
        self, order, incumbent: float, stacked=None
    ) -> "_FusedOutcome":
        """Single-dispatch fused admit+score for one miss-batch (torch
        backend): one device program covers bound -> admit mask ->
        traffic -> energy; only per-candidate scalars return to host, and
        decisions/costs/counters are bit-identical to the two-stage flow
        by construction.

        ``decided=False`` means the caller must run its own admission
        (runner unavailable, torch broke mid-flight, or the lower-bound
        exactness guard tripped -- the two-stage bound falls back to the
        scalar bound the same way); any already-stacked batch is returned
        for reuse either way. With ``decided=True``, ``arrays`` holds the
        on-device score results -- or None when the score guard tripped,
        in which case the admitted subset must be re-scored host-side.
        The fused dispatch (and mask derivation) is accounted to
        ``admit_s``; Cost materialization is the caller's ``score_s``.
        """
        runner = self._get_fused_runner()
        if runner is None:
            return _FusedOutcome(False, None, None, stacked, None)
        t0 = perf_counter()
        sb = stacked
        if sb is None:
            sigs = [self.signature(cand) for _key, cand in order]
            sb = self._ctx.stacked_batch(sigs)
        inc = incumbent if (self.prune and incumbent != math.inf) else math.inf
        out = runner(sb, inc)
        if out is None:
            self._fused_failed = True  # torch broke: stop trying
            self.stats.admit_s += perf_counter() - t0
            return _FusedOutcome(False, None, None, sb, None)
        admit, lb_mx, latency, energy, util, score_mx, extras = out
        if not (lb_mx < BATCH_EXACT_LIMIT):
            self.stats.admit_s += perf_counter() - t0
            return _FusedOutcome(False, None, None, sb, None)
        self.stats.fused_dispatches += 1
        misses, select = self._partition_admitted(order, admit)
        self.stats.admit_s += perf_counter() - t0
        arrays = (
            (latency, energy, util, extras)
            if score_mx < BATCH_EXACT_LIMIT
            else None
        )
        return _FusedOutcome(True, misses, select, sb, arrays)

    def _get_fused_runner(self):
        """Lazily build (and memoize) the single-dispatch device
        admit+score runner for this (model, metric). None when the model
        does not provide array-generic bound/terms programs or the torch
        backend is broken -- the engine then keeps the two-stage flow."""
        if self._fused_failed:
            return None
        if self._fused_runner is None:
            cache_key = (repr(self.cost_model.store_key_parts()), self.metric,
                         self.device)
            # shape-generic first: one process-wide program serves every
            # (problem, arch) of this shape class, so engines after the
            # first add no program at all
            generic = self.cost_model.batch_cost_terms_generic(
                self.problem, self.arch
            )
            if generic is not None:
                runner = self._ctx.build_generic_fused_runner(
                    generic, self.metric, self.device, cache_key=cache_key
                )
                if runner is not None:
                    self._fused_runner = runner
                    return runner
            terms = self.cost_model.batch_cost_terms_fn(self.problem, self.arch)
            lb_builder = self.cost_model.batch_admit_core_builder(
                self.problem, self.arch
            )
            if terms is None or lb_builder is None:
                self._fused_failed = True
                return None
            runner = self._ctx.build_fused_runner(
                lb_builder, terms, self.metric, self.device, cache_key=cache_key
            )
            if runner is None:
                self._fused_failed = True
                return None
            self._fused_runner = runner
        return self._fused_runner

    def warmup(self, batch_sizes: Sequence[int]) -> int:
        """Bucketed warmup: dispatch the fused torch admit+score program
        once at each pow2 bucket the given miss-batch sizes pad to, so the
        first-dispatch costs (device context, kernel loading, allocator
        growth and, on CUDA, the capture of the bucket's graph) leave
        ``admit_s``/``score_s`` of the timed search. No-op on
        non-torch backends or when the model has no fused path. Warmup rows
        are synthetic (the all-serial trivial candidate, tiled): results
        are discarded and neither the memo, the store nor the engine
        counters are touched -- only the context's ``device_dispatches``
        advances. Returns the number of buckets dispatched (buckets the
        shape class already ran are skipped, so calling this repeatedly is
        safe)."""
        if self.backend != "torch":
            return 0
        runner = self._get_fused_runner()
        if runner is None:
            # a broken torch backend surfaces here first in warmed-up sweeps
            self._check_backend_degraded()
            return 0
        n = self.arch.n_levels
        D = len(self._dims)
        buckets = sorted(
            {
                1 << max(0, (int(b) - 1).bit_length())
                for b in batch_sizes
                if b and int(b) >= _BATCH_MIN
            }
        )
        # shape-generic runners consult the process-wide trace registry:
        # a bucket this shape class already ran (by this engine, a prior
        # engine, or a prior warmup) is skipped -- one warmup covers the
        # whole class
        is_traced = getattr(runner, "is_traced", None)
        done = 0
        before = global_trace_count()
        try:
            for b in buckets:
                if is_traced is not None and is_traced(b):
                    continue
                tt = np.ones((b, n, D), dtype=np.int64)
                st = np.ones((b, n, D), dtype=np.int64)
                perm = np.tile(np.arange(D, dtype=np.int64), (b, n, 1))
                if runner(StackedBatch(tt, st, perm), math.inf) is None:
                    # torch broke mid-flight: degrade immediately rather than
                    # rediscovering the failure on the first timed batch
                    self._fused_failed = True
                    self._check_backend_degraded()
                    break
                done += 1
        finally:
            self.stats.n_traces += global_trace_count() - before
        return done

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
            lb = self._lb_batch_fn(None, backend=self.backend, stacked=sb,
                                   device=self.device)
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
        pool = self._get_pool() if (self.workers and len(misses) >= 8) else None
        if pool is None:
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
                    backend=self.backend,
                    stacked=stacked,
                    select=select,
                    device=self.device,
                )
                if costs is not None:
                    return list(costs)
            return [self._evaluate_one(cand) for _key, cand in misses]
        mappings = [self._materialize(cand) for _key, cand in misses]
        nchunks = min(len(mappings), self.workers * 4)
        step = math.ceil(len(mappings) / nchunks)
        chunks = [mappings[i : i + step] for i in range(0, len(mappings), step)]
        futs = [pool.submit(_pool_eval, [m.to_dict() for m in ch]) for ch in chunks]
        out: List[Cost] = []
        for f in futs:
            out.extend(f.result())
        return out

    def _get_pool(self):
        if self._pool is not None or self._pool_failed:
            return self._pool
        try:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            payload = pickle.dumps((self.cost_model, self.problem, self.arch))
            # spawn, not fork: a parent holding a CUDA context or other
            # threads must not be forked
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_pool_init,
                initargs=(payload,),
            )
        except Exception as e:  # noqa: BLE001 - the reference's fall-back
            # an unpicklable model or a host without the semaphores a
            # process queue needs: degrade to serial, counted. Workers start
            # at the first submit; one that cannot start raises from it, as
            # in the reference
            self._pool_failed = True
            self._pool = None
            self.stats.pool_failed += 1
            log.warning("engine process pool failed to start (%s: %s); "
                        "scoring in-process", type(e).__name__, e)
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "EvaluationEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass


def _torch_device(device) -> str:
    """The torch backend's device as a string key; a CUDA device torch
    cannot see raises here, before any search (no quiet fall-back to the
    host)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"engine device {device!r}: torch sees no CUDA device; pass "
            "device='cpu' to run the torch backend on the host"
        )
    return str(dev)
