"""Union-opt (paper Sec. III-B): the end-to-end mapping optimizer.

Given a problem (or a LayerOp to be lowered), a target architecture, a
constraint file, a mapper choice and a cost-model choice, Union-opt:

  1. runs the conformability pass for the chosen cost model,
  2. builds the map-space,
  3. searches it with the chosen mapper,
  4. returns the best Union mapping + cost (+ the loop-nest rendering,
     Fig. 5(e)/Fig. 9 style).

This is the entry point the co-design planner (``repro_torch.codesign``)
maps every kernel's problem through. The port has the heuristic mapper and
the timeloop-like and maestro-like cost models; multi-search sweeps
(``union_opt_sweep``) are still to be ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union as TUnion

from repro_torch.core.architecture import Architecture
from repro_torch.core.constraints import Constraints
from repro_torch.core.cost import MaestroLikeModel, TimeloopLikeModel
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
    engine_cache: int = 1 << 16,
    engine_prune: bool = True,
    engine_backend: Optional[str] = "numpy",
    result_store: Optional[ResultStore] = None,
    **mapper_kw,
) -> UnionSolution:
    """Run one end-to-end mapping search.

    ``engine_cache`` / ``engine_prune`` / ``engine_backend`` configure
    the shared :class:`EvaluationEngine` all mappers score candidates
    through (memo-cache capacity, lower-bound admission, and the vectorized miss-batch
    backend: "numpy" default, None for the per-candidate scalar path; any
    other name raises ValueError). ``result_store`` is an optional
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
        backend=engine_backend,
        store=result_store,
    )
    res = mp.search(space, cm, metric, engine=engine)
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
