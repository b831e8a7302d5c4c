"""Marvel-style decoupled mapper (paper [13]).

Phase 1 decouples the OFF-CHIP map-space: choose the outer-level tiling
that minimizes DRAM (outermost-memory) traffic. Phase 2 searches the
ON-CHIP levels conditioned on each of the top-k off-chip prefixes.

``seed_version=2`` (default) runs both phases ARRAY-NATIVE: phase 1 draws
its sample population as one vectorized
:class:`~repro_torch.core.genome_batch.GenomeBatch` and ranks DRAM traffic with
ONE ``signature_traffic_batch`` array program (previously each sample paid
a full per-candidate ``analyze``); phase 2 re-samples the on-chip levels
below each retained prefix as a conditional batch draw and submits the
legal rows as one GenomeBatch per prefix. Generation is all-numpy
(counter-based Philox draws), so fixed-seed searches are bit-identical
across the scalar and numpy engines. ``seed_version=1`` preserves the
historical per-candidate stream exactly.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import genome_batch as gbm
from repro_torch.core.cost.analysis import BATCH_EXACT_LIMIT, analyze, get_context
from repro_torch.core.cost.base import CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.mappers.base import Mapper, SearchResult
from repro_torch.core.mapping import Mapping
from repro_torch.core.mapspace import MapSpace


class DecoupledMapper(Mapper):
    name = "decoupled"

    def __init__(
        self,
        offchip_samples: int = 400,
        onchip_samples: int = 400,
        top_k: int = 4,
        seed: int = 0,
        probe: int = 8,
        seed_version: int = 2,
    ) -> None:
        """``probe``: the engine-level warm start (see
        ``EvaluationEngine.evaluate_batch``) -- while the incumbent is
        still infinite, the first ``probe`` candidates of a phase-2 batch
        are scored unpruned and their best seeds the bound filter for the
        rest (0 disables). Candidate order is unchanged and pruning is
        exact, so results are identical for any ``probe``.
        ``seed_version``: 2 for the vectorized batch pipeline (default),
        1 for the historical scalar stream."""
        self.offchip_samples = offchip_samples
        self.onchip_samples = onchip_samples
        self.top_k = top_k
        self.seed = seed
        self.probe = probe
        self.seed_version = seed_version

    def batch_hints(self) -> List[int]:
        per_prefix = max(1, self.onchip_samples // max(1, self.top_k))
        return [self.probe, per_prefix, per_prefix - self.probe]

    # ------------------------------------------------------------------ #
    def _split_level(self, space: MapSpace) -> int:
        """The off-chip boundary: everything above the first level with
        fanout > 1."""
        split = next(
            (i for i, f in enumerate(space.child_fanout) if f > 1),
            1,
        )
        return max(1, split)

    def _dram_traffic(self, space: MapSpace, m: Mapping) -> float:
        prof = analyze(space.problem, m, space.arch)
        total = 0.0
        # traffic served by the outermost (DRAM) level = parent_reads/writes
        # of the first non-virtual level below it
        for ds in space.problem.data_spaces:
            for i in range(1, space.arch.n_levels):
                lt = prof.traffic.get((ds.name, i))
                if lt is None:
                    continue
                total += (lt.parent_reads + lt.parent_writes) * ds.word_bytes
                break  # first real level below DRAM only
        return total

    def _dram_traffic_batch(self, space: MapSpace, gb) -> np.ndarray:
        """Phase-1 ranking criterion for a whole GenomeBatch as ONE array
        program: the stacked reuse analysis already exposes per-level
        parent reads/writes, so the per-candidate ``analyze`` walk
        disappears. Falls back per candidate when the batch program
        declines or any consumed value reaches the float64-exact limit
        (the same BATCH_EXACT_LIMIT guard every other batch consumer
        applies), so the ranking always equals the scalar walk's."""
        ctx = get_context(space.problem, space.arch)
        bt = ctx.signature_traffic_batch(stacked=gb.stacked())
        total = None
        if bt is not None:
            lvl = next((i for i in ctx.real_levels if i >= 1), None)
            if lvl is None:
                return np.zeros(len(gb))
            pos = ctx.real_levels.index(lvl)
            total = np.zeros(len(gb), dtype=np.float64)
            mx = 0.0
            for k, ds in enumerate(space.problem.data_spaces):
                r = bt.rows[k]
                term = (
                    r.parent_reads[:, pos] + r.parent_writes[:, pos]
                ) * ds.word_bytes
                mx = max(
                    mx,
                    float(r.parent_reads[:, pos].max(initial=0.0)),
                    float(r.parent_writes[:, pos].max(initial=0.0)),
                    float(term.max(initial=0.0)),
                )
                total += term
            if not (mx < BATCH_EXACT_LIMIT):
                total = None  # exactness not guaranteed: scalar walk
        if total is None:
            return np.asarray(
                [
                    self._dram_traffic(space, gb.genome(b).to_mapping())
                    for b in range(len(gb))
                ]
            )
        return total

    # ------------------------------------------------------------------ #
    def _search_v2(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str,
        engine: Optional[EvaluationEngine],
    ) -> SearchResult:
        engine = self._mk_engine(space, cost_model, metric, engine)
        tr = self._mk_result(metric, engine)
        rng = gbm.philox_rng(self.seed)
        split = self._split_level(space)
        # Phase 1: one vectorized sample batch, one traffic array program
        gb = gbm.random_genome_batch(space, rng, self.offchip_samples)
        traffic = self._dram_traffic_batch(space, gb)
        ranked = np.argsort(traffic, kind="stable")
        seen_prefix = set()
        prefix_rows: List[int] = []
        for b in ranked.tolist():
            key = gb.tt[b, :split].tobytes() + gb.st[b, :split].tobytes()
            if key not in seen_prefix:
                seen_prefix.add(key)
                prefix_rows.append(b)
            if len(prefix_rows) >= self.top_k:
                break
        # Phase 2: conditional on-chip batches per prefix
        per_prefix = max(1, self.onchip_samples // max(1, len(prefix_rows)))
        for b in prefix_rows:
            tt, st, perm = gbm.resample_inner_rows(
                space, rng, gb.tt[b], gb.st[b], gb.perm[b], split, per_prefix
            )
            ok = gbm.legal_batch(space, tt, st, perm, structured=True)
            keep = np.flatnonzero(ok)
            if keep.size == 0:
                continue
            sub = gbm.GenomeBatch(space, tt[keep], st[keep], perm[keep])
            costs = engine.evaluate_batch(
                sub, incumbent=tr.best_metric_value, probe=self.probe
            )
            for i, c in enumerate(costs):
                if c is not None:
                    tr.offer_lazy(lambda r=i, g=sub: g.genome(r), c)
        if tr.best_mapping is None:  # fall back to the best phase-1 candidate
            b = int(ranked[0])
            g = gb.genome(b)
            tr.offer(g, engine.evaluate(g))
        return tr.result()

    # ------------------------------------------------------------------ #
    def _resample_inner(
        self, space: MapSpace, base: Mapping, rng: random.Random, split_level: int
    ) -> Mapping:
        """Keep levels [0, split_level) of `base`, resample the rest."""
        m = base.clone()
        for d in space.dims:
            cur = m.levels[split_level - 1].st(d) if split_level > 0 else space.problem.dims[d]
            for i in range(split_level, space.n_levels):
                tt = rng.choice([v for v in space._divs(cur)])
                spatial_ok = (
                    space.child_fanout[i] > 1
                    and i < space.n_levels - 1
                    and (space.constraints is None
                         or space.constraints._spatial_ok(space.arch.clusters[i].name, d))
                )
                st = rng.choice([v for v in space._divs(tt)]) if spatial_ok else tt
                if i == space.n_levels - 1:
                    st = tt
                m.levels[i].temporal_tile_sizes[d] = tt
                m.levels[i].spatial_tile_sizes[d] = st
                cur = st
        for i in range(split_level, space.n_levels):
            order = list(space.dims)
            rng.shuffle(order)
            m.levels[i].temporal_order = tuple(order)
        return m

    def search(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str = "edp",
        engine: Optional[EvaluationEngine] = None,
    ) -> SearchResult:
        if self.seed_version >= 2:
            return self._search_v2(space, cost_model, metric, engine)
        engine = self._mk_engine(space, cost_model, metric, engine)
        rng = random.Random(self.seed)
        tr = self._mk_result(metric, engine)
        split = self._split_level(space)
        # Phase 1: rank off-chip prefixes by DRAM traffic
        cands: List[Tuple[float, Mapping]] = []
        for _ in range(self.offchip_samples):
            m = space.random_mapping(rng)
            cands.append((self._dram_traffic(space, m), m))
        cands.sort(key=lambda t: t[0])
        seen_prefix = set()
        prefixes: List[Mapping] = []
        for _, m in cands:
            key = tuple(
                (m.levels[i].tt(d), m.levels[i].st(d))
                for i in range(split)
                for d in space.dims
            )
            if key not in seen_prefix:
                seen_prefix.add(key)
                prefixes.append(m)
            if len(prefixes) >= self.top_k:
                break
        # Phase 2: on-chip search conditioned on each prefix. Candidates are
        # generated (RNG-only) and legality-filtered first, then the batch is
        # admitted against the incumbent and evaluated through the engine.
        per_prefix = max(1, self.onchip_samples // max(1, len(prefixes)))
        for base in prefixes:
            batch: List[Mapping] = []
            for _ in range(per_prefix):
                m = self._resample_inner(space, base, rng, split)
                if not m.is_legal(space.problem, space.arch):
                    continue
                if space.constraints is not None and not space.constraints.ok(
                    m, space.problem, space.arch
                ):
                    continue
                batch.append(m)
            costs = engine.evaluate_batch(
                batch, incumbent=tr.best_metric_value, probe=self.probe
            )
            for m, cost in zip(batch, costs):
                if cost is not None:
                    tr.offer(m, cost)
        if tr.best_mapping is None:  # fall back to the best phase-1 candidate
            m = cands[0][1]
            tr.offer(m, engine.evaluate(m))
        return tr.result()
