"""The single plan path every kernel of the port tiles through.

:func:`plan` searches the kernel's :class:`~repro_torch.codesign.space.
KernelSpace` once via ``union_opt`` -> ``EvaluationEngine`` (a copy of the
reference package's planner, on the port's own core), applies one
``legalize`` repair, keeps one fallback ledger, and caches finished plans.

Plan caching rides the persistent :class:`~repro_torch.core.cost.store.
ResultStore` (same corruption-tolerant versioned JSON tier, same atomic
flush discipline): finished plans are stored under a
**constraints-inclusive space key** -- the digest of (planner version,
kernel space identity, constraints content, mapper, search budget,
metric, cost-model ``store_key_parts()``) -- with the shape and the
shared-memory budget in the entry signature. A warm query therefore answers in O(ms)
from memory or disk without invoking a mapper search; plan records can
never collide with mapping-cost records because the space-key digests
live in disjoint namespaces (``"plan"`` marker + planner fields).

Failure discipline: only the EXPECTED search
failures (:data:`PLAN_SEARCH_ERRORS`: a mapper exhausting its budget
without a legal mapping, or a degenerate/non-conformable space) fall back
to ``space.default_config``; each fallback is counted in the
``plan_fallbacks`` ledger. Anything else propagates.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core.constraints import Constraints
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.cost.store import ResultStore
from repro_torch.codesign.space import BlockConfig, KernelSpace

log = logging.getLogger("repro_torch.codesign")

#: bump when decode/legalize/key semantics change: cached plans from older
#: planner revisions are then keyed apart and re-searched, never misread.
PLANNER_VERSION = 2

#: The EXPECTED ways a mapping search can fail: ``union_opt`` raises
#: RuntimeError when the mapper finds no legal mapping within its budget
#: and ValueError when the (problem, model) pair is degenerate or
#: non-conformable. Only these fall back to default tiles -- anything
#: else is a real bug and propagates.
PLAN_SEARCH_ERRORS = (RuntimeError, ValueError)


@dataclass
class Plan:
    """One finished plan: the legal BlockConfig plus its provenance."""

    space: str
    shape: Tuple[int, ...]
    config: BlockConfig
    cost: Optional[Cost]  # model cost of the LEGALIZED config (predict)
    source: str  # "search" | "default" | "store" | "fallback"
    fallback: bool = False
    #: with source "default": the legalized tile the search decoded, which
    #: the model rates slower than the default once launched
    searched: Optional[BlockConfig] = None


# ---------------------------------------------------------------------- #
# ledger (same style as the engine's backend_fallbacks counter)
# ---------------------------------------------------------------------- #
_STATS_LOCK = threading.Lock()
_STATS = {
    "plan_requests": 0,
    "plan_searches": 0,
    "plan_store_hits": 0,
    "plan_fallbacks": 0,
}


def planner_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_planner_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str) -> None:
    with _STATS_LOCK:
        _STATS[key] += 1


# ---------------------------------------------------------------------- #
# plan store
# ---------------------------------------------------------------------- #
_default_store = ResultStore()
_default_store_lock = threading.Lock()


def get_plan_store() -> ResultStore:
    return _default_store


def set_plan_store(store: "Union[ResultStore, str, None]") -> ResultStore:
    """Replace the process-wide default plan store. Pass a directory path
    for a persistent disk tier, a ready :class:`ResultStore`, or ``None``
    to reset to a fresh in-memory store."""
    global _default_store
    with _default_store_lock:
        if store is None:
            _default_store = ResultStore()
        elif isinstance(store, ResultStore):
            _default_store = store
        else:
            _default_store = ResultStore(str(store))
        return _default_store


# ---------------------------------------------------------------------- #
# keys
# ---------------------------------------------------------------------- #
def _canon_constraints(cons: Constraints) -> dict:
    return {
        "name": cons.name,
        "allowed_spatial": sorted(
            (k, sorted(v)) for k, v in cons.allowed_spatial_dims.items()
        ),
        "required_spatial": sorted(
            (k, sorted(v)) for k, v in cons.required_spatial_dims.items()
        ),
        "loop_orders": sorted(
            (k, list(v)) for k, v in cons.loop_orders.items()
        ),
        "allowed_tile_sizes": sorted(
            (list(k), sorted(v)) for k, v in cons.allowed_tile_sizes.items()
        ),
        "tile_multiples": sorted(cons.tile_multiples.items()),
        "max_concurrent_spatial": cons.max_concurrent_spatial,
        "min_utilization": cons.min_utilization,
        "max_utilization": cons.max_utilization,
    }


def plan_space_key(
    space: KernelSpace,
    cons: Constraints,
    mapper: str,
    budget: int,
    metric: str,
    model: CostModel,
) -> str:
    """Constraints-inclusive plan-cache space key (disjoint from mapping-
    cost space keys by construction: those digest problem/arch content,
    this digests the ``"plan"`` marker + planner identity)."""
    desc = json.dumps(
        {
            "plan": PLANNER_VERSION,
            "space": space.name,
            "decode_dims": list(space.decode_dims),
            "constraints": _canon_constraints(cons),
            "mapper": mapper,
            "budget": int(budget),
            "metric": metric,
            "model": [repr(p) for p in model.store_key_parts()],
        },
        sort_keys=True,
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:32]


def _plan_sig(shape: Sequence[int], smem_budget: int):
    """Store-entry signature for one (shape, budget) plan. Shaped like a
    one-level mapping signature -- ``(order, tt, st)`` -- so it round-trips
    the store's JSON codec unchanged."""
    return ((("plan",), tuple(int(s) for s in shape), (int(smem_budget),)),)


def _plan_record(config: BlockConfig, cost: Optional[Cost], fallback: bool) -> Cost:
    """Encode a finished plan as a Cost record (the store's value type):
    predicted scalars in the Cost fields, the BlockConfig + flags in the
    ``str -> float`` breakdown."""
    breakdown = {f"plan::{i}": float(b) for i, b in enumerate(config)}
    breakdown["plan::n"] = float(len(config))
    breakdown["plan::fallback"] = 1.0 if fallback else 0.0
    if cost is not None:
        return Cost(
            latency_cycles=cost.latency_cycles,
            energy_pj=cost.energy_pj,
            utilization=cost.utilization,
            macs=cost.macs,
            frequency_hz=cost.frequency_hz,
            breakdown=breakdown,
        )
    return Cost(0.0, 0.0, 0.0, 0, 1.0, breakdown)


def _record_to_plan(space: KernelSpace, shape, rec: Cost) -> Optional[Plan]:
    bd = rec.breakdown
    try:
        n = int(bd["plan::n"])
        config = tuple(int(bd[f"plan::{i}"]) for i in range(n))
    except (KeyError, TypeError, ValueError):
        return None  # not a plan record (or truncated): treat as a miss
    fallback = bool(bd.get("plan::fallback", 0.0))
    cost = (
        Cost(
            latency_cycles=rec.latency_cycles,
            energy_pj=rec.energy_pj,
            utilization=rec.utilization,
            macs=rec.macs,
            frequency_hz=rec.frequency_hz,
        )
        if rec.frequency_hz > 1.0
        else None
    )
    return Plan(
        space=space.name,
        shape=tuple(int(s) for s in shape),
        config=config,
        cost=cost,
        source="store",
        fallback=fallback,
    )


# ---------------------------------------------------------------------- #
# prediction
# ---------------------------------------------------------------------- #
def predict_cost(
    space: KernelSpace,
    shape: Sequence[int],
    config: BlockConfig,
    model: "Union[str, CostModel, None]" = None,
    smem_budget: Optional[int] = None,
) -> Cost:
    """The cost model's prediction for the EXACT launched BlockConfig (via
    the canonical full-problem/block-tile mapping) -- the number the
    calibration table compares measured kernel time against. A calibrated
    model returns rescaled predictions here, which is precisely how
    calibration reaches the planner."""
    cm = _resolve_model(space, model)
    problem, mapping, arch = space.canonical_mapping(
        shape, config, arch=space.arch(smem_budget)
    )
    return cm.evaluate(problem, mapping, arch)


def _resolve_model(
    space: KernelSpace, model: "Union[str, CostModel, None]"
) -> CostModel:
    if isinstance(model, CostModel):
        return model
    from repro_torch.core.optimizer import COST_MODEL_REGISTRY

    return COST_MODEL_REGISTRY[model or space.cost_model]()


# ---------------------------------------------------------------------- #
# the plan path
# ---------------------------------------------------------------------- #
def plan(
    space: KernelSpace,
    shape: Sequence[int],
    *,
    mapper: Optional[str] = None,
    budget: Optional[int] = None,
    metric: Optional[str] = None,
    model: "Union[str, CostModel, None]" = None,
    smem_budget: Optional[int] = None,
    store: Optional[ResultStore] = None,
    predict: bool = True,
) -> Plan:
    """Plan a legal BlockConfig for ``space`` at ``shape``.

    Resolution order: (1) probe the plan store under the constraints-
    inclusive space key -- a hit returns without any search; (2) run one
    ``union_opt`` search with the space's mapper/model/constraints over
    ``arch(smem_budget)`` and ``decode`` the C1 temporal tile -- expected
    search failures (:data:`PLAN_SEARCH_ERRORS`) fall back to
    ``default_config`` and count in the ``plan_fallbacks`` ledger;
    (3) ``legalize`` whatever came out -- on a hierarchy whose CTA level
    spreads over SMs, the legalized default replaces it when the model
    rates the default's launched mapping cheaper (source ``"default"``);
    (4) with ``predict=True`` attach
    the model's cost for the legalized config; (5) store the finished
    plan. ``store`` defaults to the process-wide plan store
    (:func:`get_plan_store`); the same store also warms the search's
    mapping-cost entries. Callers own ``flush()``.
    """
    shape = tuple(int(s) for s in shape)
    mapper = mapper or space.mapper
    budget = int(budget if budget is not None else space.search_budget)
    metric = metric or space.metric
    vb = int(smem_budget or space.smem_budget)
    cm = _resolve_model(space, model)
    cons = space.constraints(shape)
    store = store if store is not None else _default_store

    _bump("plan_requests")
    skey = plan_space_key(space, cons, mapper, budget, metric, cm)
    sig = _plan_sig(shape, vb)
    rec = store.get(skey, sig)
    if rec is not None:
        cached = _record_to_plan(space, shape, rec)
        if cached is not None:
            _bump("plan_store_hits")
            return cached

    # cold: one real mapper search through the shared evaluation machinery
    _bump("plan_searches")
    fallback = False
    try:
        from repro_torch.core.optimizer import union_opt

        sol = union_opt(
            space.problem(shape),
            space.arch(vb),
            mapper=mapper,
            cost_model=cm,
            metric=metric,
            constraints=cons,
            result_store=store,
            climb_steps=budget,
        )
        raw = space.decode(sol.mapping, shape)
    except PLAN_SEARCH_ERRORS as e:
        _bump("plan_fallbacks")
        log.warning(
            "codesign.plan %s%s: search failed (%s: %s); using default "
            "config", space.name, shape, type(e).__name__, e,
        )
        raw = space.default_config(shape)
        fallback = True

    config = space.legalize(raw, shape, vb)
    source = "fallback" if fallback else "search"
    cost = searched = None
    arch = space.arch(vb)
    if not fallback and arch.n_levels > 1 and arch.clusters[1].fanout > 1:
        # The search scores free mappings, whose split of the CTA level
        # over the SMs need not be the grid the kernel launches
        # (``canonical_mapping``); so score the launched mapping of the
        # searched tile and of the default tile and keep the cheaper. On a
        # grid level of fanout 1 (the TPU's) the two mappings coincide.
        cost = predict_cost(space, shape, config, cm, vb)
        default = space.legalize(space.default_config(shape), shape, vb)
        if default != config:
            d_cost = predict_cost(space, shape, default, cm, vb)
            if d_cost.metric(metric) < cost.metric(metric):
                searched = config
                config, cost, source = default, d_cost, "default"
    if predict and cost is None:
        cost = predict_cost(space, shape, config, cm, vb)
    store.put(skey, sig, _plan_record(config, cost if predict else None, fallback))
    return Plan(
        space=space.name,
        shape=shape,
        config=config,
        cost=cost if predict else None,
        source=source,
        fallback=fallback,
        searched=searched,
    )
