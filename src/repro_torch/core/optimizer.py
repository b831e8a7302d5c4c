"""Union-opt (paper Sec. III-B): the end-to-end mapping optimizer.

Given a problem (or a LayerOp to be lowered), a target architecture, a
constraint file, a mapper choice and a cost-model choice, Union-opt:

  1. runs the conformability pass for the chosen cost model,
  2. builds the map-space,
  3. searches it with the chosen mapper,
  4. returns the best Union mapping + cost (+ the loop-nest rendering,
     Fig. 5(e)/Fig. 9 style).

This is the entry point the co-design planner (``repro_torch.codesign``)
maps every kernel's problem through: any of the five mappers of
``MAPPER_REGISTRY`` against any of the three cost models of
:data:`COST_MODEL_REGISTRY`.

:func:`union_opt_sweep` is the MULTI-SEARCH form whole-model and figure
runs go through: a list of :class:`SweepTask` points shares one
:class:`~repro_torch.core.cost.engine.EvaluationEngine` per distinct
(cost model, problem, arch, metric) space -- memo cache, array programs
and fused device runners included -- plus one optional
:class:`ResultStore` and a bucketed warmup pass on the torch backend, so
first dispatches and repeated scoring amortize across the whole sweep
instead of per call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union as TUnion

from repro_torch.core.architecture import Architecture
from repro_torch.core.constraints import Constraints
from repro_torch.core.cost import MaestroLikeModel, TimeloopLikeModel, TPURooflineModel
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.cost.store import ResultStore
from repro_torch.core.ir.conformability import conformable_models
from repro_torch.core.ir.dialects import LayerOp
from repro_torch.core.ir.lowering import lower_layer_to_problem
from repro_torch.core.mappers import MAPPER_REGISTRY, Mapper
from repro_torch.core.mappers.base import SearchResult
from repro_torch.core.mapping import Mapping
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.problem import Problem

COST_MODEL_REGISTRY = {
    "timeloop": TimeloopLikeModel,
    "maestro": MaestroLikeModel,
    "tpu_roofline": TPURooflineModel,
}


@dataclass
class UnionSolution:
    problem: Problem
    mapping: Mapping
    cost: Cost
    search: SearchResult
    mapper: str
    cost_model: str
    metric: str

    def loop_nest(self) -> str:
        return self.mapping.loop_nest_str(self.problem)


def union_opt(
    workload: TUnion[Problem, LayerOp],
    arch: Architecture,
    mapper: TUnion[str, Mapper] = "heuristic",
    cost_model: TUnion[str, CostModel] = "timeloop",
    metric: str = "edp",
    constraints: Optional[Constraints] = None,
    engine_workers: int = 0,
    engine_cache: int = 1 << 16,
    engine_prune: bool = True,
    engine_backend: Optional[str] = "numpy",
    result_store: Optional[ResultStore] = None,
    engine_device: str = "cuda",
    **mapper_kw,
) -> UnionSolution:
    """Run one end-to-end mapping search.

    ``engine_workers`` / ``engine_cache`` / ``engine_prune`` /
    ``engine_backend`` configure the shared :class:`EvaluationEngine` all
    mappers score candidates through (process-pool fan-out, memo-cache
    capacity, lower-bound admission, and the vectorized miss-batch
    backend: "numpy" default, None for the per-candidate scalar path; any
    other name raises ValueError). ``engine_backend="torch"`` runs the
    SINGLE-DISPATCH fused pipeline on ``engine_device`` ("cuda" by
    default; "cpu" runs it on the host): one program of float64 tensors
    per miss-batch covers lower-bound -> admit mask -> traffic -> energy
    on the device, returning only per-candidate ``(cycles, energy_pj,
    util)`` scalars (plus small breakdown arrays) to host, with Cost
    objects materialized for admitted rows only -- costs, decisions, and
    counters bit-identical to the numpy and scalar paths; the random,
    exhaustive and genetic mappers then also run their device-resident
    loops (``repro_torch.core.device_loop``). The program is cached on the
    (problem, arch) analysis context, so repeated ``union_opt`` calls
    over the same space reuse it. ``result_store`` is an optional
    persistent cross-search cache shared between calls (see
    ``repro_torch.core.cost.store.ResultStore``; construct it with
    ``max_entries_per_space=`` for LRU-capped tiers): benchmark sweeps
    pass one store so identical signatures are scored once across runs;
    callers own ``flush()``.
    """
    problem = (
        lower_layer_to_problem(workload) if isinstance(workload, LayerOp) else workload
    )
    cm = (
        COST_MODEL_REGISTRY[cost_model]() if isinstance(cost_model, str) else cost_model
    )
    rep = conformable_models(problem, [cm])
    ok, why = rep.results.get(cm.name, (cm.conformable(problem), "model check"))
    if not ok:
        raise ValueError(
            f"problem {problem.name!r} is not conformable to cost model "
            f"{cm.name!r}: {why}"
        )
    mp = MAPPER_REGISTRY[mapper](**mapper_kw) if isinstance(mapper, str) else mapper
    space = MapSpace(problem, arch, constraints)
    engine = EvaluationEngine(
        cm,
        problem,
        arch,
        metric=metric,
        cache_size=engine_cache,
        prune=engine_prune,
        workers=engine_workers,
        backend=engine_backend,
        store=result_store,
        device=engine_device,
    )
    try:
        res = mp.search(space, cm, metric, engine=engine)
    finally:
        engine.close()
    if res.best_mapping is None:
        raise RuntimeError(f"mapper {mp.name} found no legal mapping for {problem.name}")
    return UnionSolution(
        problem=problem,
        mapping=res.best_mapping,
        cost=res.best_cost,
        search=res,
        mapper=mp.name,
        cost_model=cm.name,
        metric=metric,
    )


# --------------------------------------------------------------------- #
# Multi-problem fused sweeps
# --------------------------------------------------------------------- #
@dataclass
class SweepTask:
    """One point of a :func:`union_opt_sweep`: the same knobs one
    ``union_opt`` call takes, as data. ``tag`` is an opaque caller label:
    solutions come back in task order, so callers recover it by zipping
    tasks with the result."""

    workload: "TUnion[Problem, LayerOp]"
    arch: Architecture
    mapper: "TUnion[str, Mapper]" = "heuristic"
    cost_model: "TUnion[str, CostModel]" = "timeloop"
    metric: str = "edp"
    constraints: Optional[Constraints] = None
    mapper_kw: dict = field(default_factory=dict)
    tag: Optional[object] = None


@dataclass
class SweepResult:
    """Solutions (in task order) + sweep-level sharing/throughput stats."""

    solutions: List[UnionSolution]
    stats: dict

    def __iter__(self):
        return iter(self.solutions)

    def __getitem__(self, i):
        return self.solutions[i]

    def __len__(self):
        return len(self.solutions)


def union_opt_sweep(
    tasks: Sequence["TUnion[SweepTask, dict]"],
    *,
    engine_backend: Optional[str] = "numpy",
    engine_workers: int = 0,
    engine_cache: int = 1 << 16,
    engine_prune: bool = True,
    result_store: Optional[ResultStore] = None,
    engine_device: str = "cuda",
    warmup: bool = True,
    workers: int = 0,
    pool: str = "auto",
    group_timeout_s: Optional[float] = None,
    max_group_retries: int = 2,
    group_backoff_s: float = 0.05,
    journal=None,
    resume: bool = False,
    fault_spec: Optional[str] = None,
) -> SweepResult:
    """Run a whole sweep through SHARED evaluation machinery.

    Tasks are grouped by their persistent-store space key -- the digest of
    (cost model config, problem content, arch content) -- plus metric and
    backend, and each group shares ONE :class:`EvaluationEngine`: its memo
    cache carries results between that group's searches, so a second
    search over the same space starts warm, and its array programs /
    fused device runners are built once. Content-equal problems and archs
    from different constructor calls alias the same analysis context (see
    ``get_context``), so even cross-group tasks reuse programs where
    shapes and constants agree. Per-task ``SearchResult`` counters stay
    per-search (the tracker diffs engine snapshots).

    ``engine_backend="torch"`` runs every group's engine on
    ``engine_device`` (see :func:`union_opt`). ``warmup=True`` then
    dispatches each group's fused runner once at the pow2 buckets its
    mappers' ``batch_hints`` pad to (no-op on numpy/scalar backends), so
    first-dispatch costs leave the timed searches' ``admit_s``/``score_s``.

    ``result_store`` is shared by every task and flushed ONCE at the end
    (one atomic multi-space write pass; see ``ResultStore.flush``) --
    callers that keep the store open may flush again later, flushing here
    is not destructive.

    Execution is delegated to the fault-tolerant
    :class:`~repro_torch.core.sweep_exec.SweepExecutor` (see that module
    for the failure taxonomy):

    ``workers``/``pool``
        ``workers > 1`` dispatches independent groups concurrently --
        ``pool="process"`` (the ``"auto"`` default; spawned interpreters
        that import numpy and ``repro_torch.core`` -- torch only for the
        torch backend -- the load-bearing path since the numpy engine is
        GIL-bound) or ``pool="thread"``.
    ``group_timeout_s``/``max_group_retries``/``group_backoff_s``
        per-group watchdog deadline and bounded retries with exponential
        backoff + deterministic jitter; a hung or failed group attempt is
        abandoned and re-run instead of killing the sweep.
    ``journal``/``resume``
        a :class:`~repro_torch.core.cost.store.SweepJournal` (or a path)
        makes the sweep crash-safe: completed groups' solution records are
        flushed atomically, and ``resume=True`` replays them instead of
        re-searching. All solutions round-trip through the journal's
        record form either way, so resumed and uninterrupted sweeps are
        identical by construction.
    ``fault_spec``
        deterministic fault injection (defaults to ``UNION_FAULT_SPEC``
        from the environment), e.g. ``"fail:1@0;hang:2@0:3"``.
    """
    from repro_torch.core.sweep_exec import SweepExecutor

    resolved = []
    for t in tasks:
        if isinstance(t, dict):
            t = SweepTask(**t)
        problem = (
            lower_layer_to_problem(t.workload)
            if isinstance(t.workload, LayerOp)
            else t.workload
        )
        cm = (
            COST_MODEL_REGISTRY[t.cost_model]()
            if isinstance(t.cost_model, str)
            else t.cost_model
        )
        rep = conformable_models(problem, [cm])
        ok, why = rep.results.get(cm.name, (cm.conformable(problem), "model check"))
        if not ok:
            raise ValueError(
                f"problem {problem.name!r} is not conformable to cost model "
                f"{cm.name!r}: {why}"
            )
        if isinstance(t.mapper, str):
            # fail fast on unknown mappers / bad kwargs, then ship the SPEC:
            # the executor builds a FRESH instance per group attempt so a
            # retried group replays the exact seeded candidate stream
            mp_name = MAPPER_REGISTRY[t.mapper](**t.mapper_kw).name
            mapper_spec = (t.mapper, dict(t.mapper_kw))
        else:
            mp_name = t.mapper.name
            mapper_spec = t.mapper
        resolved.append((t, problem, cm, mapper_spec, mp_name))

    executor = SweepExecutor(
        engine_backend=engine_backend,
        engine_workers=engine_workers,
        engine_cache=engine_cache,
        engine_prune=engine_prune,
        result_store=result_store,
        engine_device=engine_device,
        warmup=warmup,
        workers=workers,
        pool=pool,
        group_timeout_s=group_timeout_s,
        max_group_retries=max_group_retries,
        group_backoff_s=group_backoff_s,
        journal=journal,
        resume=resume,
        fault_spec=fault_spec,
    )
    results, agg = executor.run([r[:4] for r in resolved])

    solutions = [
        UnionSolution(
            problem=problem,
            mapping=res.best_mapping,
            cost=res.best_cost,
            search=res,
            mapper=mp_name,
            cost_model=cm.name,
            metric=t.metric,
        )
        for (t, problem, cm, _spec, mp_name), res in zip(resolved, results)
    ]
    return SweepResult(solutions, agg)
