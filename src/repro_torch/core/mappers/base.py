"""Mapper interface and search bookkeeping.

All mappers score candidates through one :class:`EvaluationEngine`
(``repro_torch.core.cost.engine``): a signature-keyed memo cache, a lower-bound
admission filter, and a batch API. ``SearchResult`` surfaces the engine's
cache-hit / pruned counters next to the classic evaluated count so search
throughput stays observable.
"""

from __future__ import annotations

import abc
import math
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.architecture import Architecture
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.mapping import Mapping
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.problem import Problem


@dataclass
class SearchResult:
    best_mapping: Optional[Mapping]
    best_cost: Optional[Cost]
    metric: str
    evaluated: int
    elapsed_s: float
    trajectory: List[Tuple[int, float]] = field(default_factory=list)  # (eval#, best metric)
    # engine counters (0 when a mapper bypasses the engine)
    cache_hits: int = 0
    pruned: int = 0
    analyzed: int = 0  # full cost-model analyses (cache misses)
    store_hits: int = 0  # served by the cross-search ResultStore
    # candidate instances the mapper submitted to the engine, before dedup
    # and regardless of how they were served (analysis / memo / store /
    # bound rejection). A store hit turns a would-be pruned or analyzed
    # candidate into a served one -- the evaluated/pruned SPLIT shifts
    # between warm and cold runs -- but the submitted stream is identical,
    # so this total is warm/cold INVARIANT.
    considered: int = 0
    fused_dispatches: int = 0  # miss-batches served by one device dispatch
    # engine degraded torch -> numpy mid-search (counted warning; results
    # unchanged by the backend bit-identity contract)
    backend_fallbacks: int = 0
    # (program, pow2 bucket) combinations first dispatched by this search
    # (0 when the shape-generic process cache already held every program
    # -- the one-program-per-shape-class property this counter observes)
    n_traces: int = 0
    # host<->device sync points of the device-resident search loops (one
    # per mega-batch precompute / K-generation flush; 0 on host loops)
    device_syncs: int = 0
    admit_s: float = 0.0  # engine wall-clock in the admission (bound) stage
    score_s: float = 0.0  # engine wall-clock scoring admitted misses

    @property
    def best_metric(self) -> float:
        return self.best_cost.metric(self.metric) if self.best_cost else float("inf")

    @property
    def candidates(self) -> int:
        """Candidates the search considered: scored + bound-pruned."""
        return self.evaluated + self.pruned

    @property
    def scored(self) -> int:
        """Throughput numerator: the warm/cold-invariant ``considered``
        total MINUS store-served candidates (a store hit costs a dict
        probe, not an evaluation -- counting it would inflate warm-run
        rows against cold baselines). Falls back to the classic
        scored+pruned count for mappers that bypass the engine
        (``considered == 0``). The single definition both
        :attr:`evals_per_s` and ``benchmarks/mappers_bench.py`` use."""
        return (
            self.considered - self.store_hits if self.considered else self.candidates
        )

    @property
    def evals_per_s(self) -> float:
        return self.scored / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def stats_dict(self) -> dict:
        """JSON-ready engine-counter summary (figure benchmarks attach this
        next to their metrics so cache-hit / pruned / throughput stay
        observable per experiment).

        With ``UNION_DETERMINISTIC_STATS`` set, only warm/cold-INVARIANT
        fields are emitted (the mapper's submitted candidate stream and
        the search outcome) and every timing is zeroed: the crash/resume
        byte-identity check compares figure JSONs from a killed+resumed
        sweep against an uninterrupted run, and the evaluated/pruned/
        store-hit split plus wall-clocks legitimately differ with store
        warmth while ``considered`` and the best mapping/cost do not.
        """
        if os.environ.get("UNION_DETERMINISTIC_STATS"):
            # NOT ``evaluated``: a store-served candidate is offered to the
            # tracker where a cold run would have bound-pruned it, so the
            # offer count shifts with warmth even though the best
            # mapping/cost cannot.
            return {
                "considered": self.considered,
                "backend_fallbacks": self.backend_fallbacks,
                "elapsed_s": 0.0,
                "evals_per_s": 0.0,
            }
        return {
            "evaluated": self.evaluated,
            "analyzed": self.analyzed,
            "cache_hits": self.cache_hits,
            "store_hits": self.store_hits,
            "pruned": self.pruned,
            "candidates": self.candidates,
            "considered": self.considered,
            "fused_dispatches": self.fused_dispatches,
            "backend_fallbacks": self.backend_fallbacks,
            "n_traces": self.n_traces,
            "device_syncs": self.device_syncs,
            "elapsed_s": round(self.elapsed_s, 4),
            "evals_per_s": round(self.evals_per_s, 1),
            "admit_s": round(self.admit_s, 4),
            "score_s": round(self.score_s, 4),
        }


class Mapper(abc.ABC):
    name: str = "base"

    @abc.abstractmethod
    def search(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str = "edp",
        engine: Optional[EvaluationEngine] = None,
    ) -> SearchResult:
        ...

    def _mk_engine(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str,
        engine: Optional[EvaluationEngine],
    ) -> EvaluationEngine:
        if engine is not None:
            return engine
        return EvaluationEngine(cost_model, space.problem, space.arch, metric=metric)

    def _mk_result(
        self, metric: str, engine: Optional[EvaluationEngine] = None
    ) -> "_Tracker":
        return _Tracker(metric, engine)

    def batch_hints(self) -> List[int]:
        """Miss-batch sizes this mapper's searches are likely to dispatch
        -- consumed by ``EvaluationEngine.warmup`` (bucketed pre-tracing
        of the fused torch program) before a sweep's timed searches. Purely
        advisory: an empty list just skips warmup."""
        return []


class _Tracker:
    """Shared incumbent tracking for all mappers.

    The engine's counters are snapshotted at construction and reported as
    DIFFS, so a shared engine (``union_opt_sweep`` reuses one engine --
    memo cache, compiled runners and all -- across every search over the
    same space) still yields correct per-search stats. For the classic
    one-engine-per-search flow the snapshot is all zeros and nothing
    changes."""

    def __init__(self, metric: str, engine: Optional[EvaluationEngine] = None) -> None:
        self.metric = metric
        self.engine = engine
        self._stats_base = engine.stats.snapshot() if engine is not None else None
        self.best_mapping: Optional[Mapping] = None
        self.best_cost: Optional[Cost] = None
        self.best_metric_value: float = math.inf
        self.evaluated = 0
        self.t0 = time.time()
        self.trajectory: List[Tuple[int, float]] = []

    def offer(self, mapping: Mapping, cost: Cost) -> bool:
        self.evaluated += 1
        score = cost.metric(self.metric)
        if self.best_cost is None or score < self.best_metric_value:
            self.best_mapping = mapping
            self.best_cost = cost
            self.best_metric_value = score
            self.trajectory.append((self.evaluated, score))
            return True
        return False

    def offer_lazy(self, make, cost: Cost, score: Optional[float] = None) -> bool:
        """:meth:`offer` for array-native batches: ``make()`` materializes
        the candidate (a GenomeBatch row -> Genome) ONLY when it improves
        the incumbent, so scanning a batch's costs touches no per-row
        Python objects for the non-improving majority. ``score`` passes an
        already-computed metric value (callers that also need the fitness
        avoid scoring twice)."""
        self.evaluated += 1
        if score is None:
            score = cost.metric(self.metric)
        if self.best_cost is None or score < self.best_metric_value:
            self.best_mapping = make()
            self.best_cost = cost
            self.best_metric_value = score
            self.trajectory.append((self.evaluated, score))
            return True
        return False

    def result(self) -> SearchResult:
        stats = self.engine.stats if self.engine is not None else None
        base = self._stats_base

        def delta(attr, zero=0):
            if stats is None:
                return zero
            return getattr(stats, attr) - getattr(base, attr)

        best = self.best_mapping
        if best is not None and not isinstance(best, Mapping):
            best = best.to_mapping()  # chain-level genome -> Mapping
        return SearchResult(
            best_mapping=best,
            best_cost=self.best_cost,
            metric=self.metric,
            evaluated=self.evaluated,
            elapsed_s=time.time() - self.t0,
            trajectory=self.trajectory,
            cache_hits=delta("cache_hits"),
            pruned=delta("pruned"),
            analyzed=delta("evaluated"),
            store_hits=delta("store_hits"),
            considered=delta("considered"),
            fused_dispatches=delta("fused_dispatches"),
            backend_fallbacks=delta("backend_fallbacks"),
            n_traces=delta("n_traces"),
            device_syncs=delta("device_syncs"),
            admit_s=delta("admit_s", 0.0),
            score_s=delta("score_s", 0.0),
        )
