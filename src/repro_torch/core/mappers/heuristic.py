"""Heuristic mapper: utilization-first greedy seed + local hill-climb.

The greedy seed spreads the largest problem dims spatially across the
spatial-capable levels (maximizing PE utilization, which Fig. 10 of the
paper shows dominates EDP), then temporal tiles are chosen to saturate
each level's memory. Hill-climbing refines with the shared mutation
operator, accepting only improvements.

The climb is chunked through ``EvaluationEngine.evaluate_batch`` so it
hits the batched admission bound and the shared StackedBatch --
previously each step went through scalar ``evaluate_admit``. Chunks
are SPECULATIVE: all ``chunk`` candidates are mutations of the current
incumbent, results are scanned in order, and the tail past the first
accepted move is discarded while the RNG is rewound to the state the
serial walk would have -- so the ACCEPTED-MOVE SEQUENCE (every accepted
mapping and score, in order) and the final best mapping are identical to
the one-at-a-time climb for any fixed seed (A/B-asserted in
``tests/test_mappers.py``). Work counters are NOT part of that contract:
speculated candidates past an accepted move were evaluated and cached,
so a later re-draw the serial walk would bound-prune can instead be
served from cache and offered -- ``SearchResult.evaluated`` and
trajectory step indices may differ slightly from ``chunk=1``.

The neighbor batches themselves are ARRAY-NATIVE: mutations are drawn at
the genome level (``mutate_genome`` -- the identical RNG stream
``space.mutate`` consumes, so the serial-equivalence contract is
untouched) and each chunk is submitted as one dense
:class:`~repro_torch.core.genome_batch.GenomeBatch`, so the engine dedups by
row hash and slices the admission/scoring StackedBatch straight out of
the chunk matrices instead of building per-candidate signature tuples.
No seed-versioning applies here: the climb's stream is pinned by the
accepted-move contract.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

from repro_torch.core.cost.base import CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.genome_batch import GenomeBatch
from repro_torch.core.mappers.base import Mapper, SearchResult
from repro_torch.core.mapping import LevelMapping, Mapping
from repro_torch.core.mapspace import MapSpace


class HeuristicMapper(Mapper):
    name = "heuristic"

    def __init__(
        self,
        climb_steps: int = 300,
        restarts: int = 3,
        seed: int = 0,
        chunk: int = 8,
        probe: int = 8,
    ) -> None:
        """``chunk``: climb steps speculated per ``evaluate_batch`` call
        (<=1 restores the serial scalar walk -- the A/B reference).
        ``probe``: the engine-level warm start passed through to
        ``evaluate_batch`` like random/exhaustive do; the climb always has
        a finite incumbent (the seed mapping), so it only engages if a
        cost model ever yields an infinite seed metric."""
        self.climb_steps = climb_steps
        self.restarts = restarts
        self.seed = seed
        self.chunk = chunk
        self.probe = probe

    def batch_hints(self):
        return [self.chunk, self.probe]

    # ------------------------------------------------------------------ #
    def _greedy_seed(self, space: MapSpace, rng: random.Random) -> Mapping:
        problem, arch = space.problem, space.arch
        dims = dict(problem.dims)
        n = space.n_levels
        # remaining sizes to tile, per dim
        chains: Dict[str, List[int]] = {d: [] for d in dims}
        cur = dict(dims)
        for i in range(n):
            fan = space.child_fanout[i]
            # choose spatial factors for this level greedily from big dims
            st_factors = {d: 1 for d in dims}
            if fan > 1 and i < n - 1:
                budget = fan
                # sort dims by remaining size, prefer non-reduction dims for
                # outputs-stationarity but allow all
                for d in sorted(dims, key=lambda d: -cur[d]):
                    if budget <= 1:
                        break
                    if space.constraints is not None and not space.constraints._spatial_ok(
                        arch.clusters[i].name, d
                    ):
                        continue
                    f = math.gcd(cur[d], budget)
                    # largest divisor of cur[d] that divides budget
                    best = 1
                    for v in space._divs(cur[d]):
                        if budget % v == 0 and v > best:
                            best = v
                    f = best
                    if f > 1:
                        st_factors[d] = f
                        budget //= f
            for d in dims:
                tt = cur[d]  # temporal tile = whole remaining (stream at this level)
                st = tt // st_factors[d]
                chains[d].extend((tt, st))
                cur[d] = st
        levels = []
        for i, cl in enumerate(arch.clusters):
            tt = {d: chains[d][2 * i] for d in dims}
            st = {d: chains[d][2 * i + 1] for d in dims}
            levels.append(LevelMapping(cl.name, tuple(dims), tt, st))
        m = Mapping(levels, problem.name)
        # repair memory violations: shrink temporal tiles at offending levels
        for i, cl in enumerate(arch.clusters):
            if cl.virtual or cl.memory_bytes is None or i == 0:
                continue
            guard = 0
            while True:
                tile = {d: m.levels[i].tt(d) for d in dims}
                need = sum(ds.footprint_bytes(tile) for ds in problem.data_spaces)
                if need <= cl.memory_bytes or guard > 64:
                    break
                guard += 1
                # halve the biggest temporal tile dim (keeping divisibility)
                d = max(dims, key=lambda d: m.levels[i].tt(d))
                tt = m.levels[i].tt(d)
                smaller = [v for v in space._divs(tt) if v < tt]
                if not smaller:
                    break
                new_tt = max(smaller)
                # keep inner chain nested
                m.levels[i].temporal_tile_sizes[d] = new_tt
                m.levels[i].spatial_tile_sizes[d] = min(m.levels[i].st(d), new_tt)
                for j in range(i + 1, space.n_levels):
                    m.levels[j].temporal_tile_sizes[d] = min(
                        m.levels[j].tt(d), m.levels[j - 1].st(d)
                    )
                    m.levels[j].spatial_tile_sizes[d] = min(
                        m.levels[j].st(d), m.levels[j].tt(d)
                    )
        if m.is_legal(problem, arch):
            return m
        return space.random_mapping(rng)

    def search(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str = "edp",
        engine: Optional[EvaluationEngine] = None,
    ) -> SearchResult:
        engine = self._mk_engine(space, cost_model, metric, engine)
        rng = random.Random(self.seed)
        tr = self._mk_result(metric, engine)
        steps_per_restart = self.climb_steps // self.restarts
        for r in range(self.restarts):
            m = self._greedy_seed(space, rng) if r == 0 else space.random_mapping(rng)
            if space.constraints is not None and not space.constraints.ok(
                m, space.problem, space.arch
            ):
                m = space.random_mapping(rng)
            best = engine.evaluate(m)
            tr.offer(m, best)
            best_s = best.metric(metric)
            if self.chunk <= 1:
                # serial reference walk (exact historical behavior)
                for _ in range(steps_per_restart):
                    cand = space.mutate(m, rng)
                    # prune against the LOCAL incumbent: a candidate whose
                    # bound is >= the climb's best can neither be an
                    # accepted move nor improve the global best (global <=
                    # local), so the walk is unchanged vs. evaluating
                    # everything.
                    c = engine.evaluate_admit(cand, incumbent=best_s)
                    if c is None:
                        continue
                    tr.offer(cand, c)
                    s = c.metric(metric)
                    if s < best_s:
                        m, best, best_s = cand, c, s
                continue
            g = space._genome_of(m)
            steps = 0
            while steps < steps_per_restart:
                k = min(self.chunk, steps_per_restart - steps)
                # Speculate k mutations of the CURRENT incumbent. The RNG
                # state before each draw is recorded so an accepted move
                # can rewind to exactly where the serial walk would be
                # (mutate is deterministic in (genome, rng state), so the
                # replayed prefix is byte-identical). Genome-level draws
                # consume the identical stream ``space.mutate`` would.
                states = []
                cands = []
                for _ in range(k):
                    states.append(rng.getstate())
                    cands.append(space.mutate_genome(g, rng))
                costs = engine.evaluate_batch(
                    GenomeBatch.from_genomes(space, cands),
                    incumbent=best_s,
                    probe=self.probe,
                )
                accepted = None
                for j, (cand, c) in enumerate(zip(cands, costs)):
                    if c is None:
                        continue  # bound-pruned: provably not an accepted move
                    tr.offer(cand, c)
                    s = c.metric(metric)
                    if s < best_s:
                        accepted = j
                        g, best, best_s = cand, c, s
                        break
                if accepted is None:
                    steps += k
                else:
                    # the serial walk would now mutate the NEW incumbent:
                    # count only the steps up to the accepted move and
                    # rewind the RNG past it, discarding the speculated tail
                    steps += accepted + 1
                    if accepted + 1 < k:
                        rng.setstate(states[accepted + 1])
        return tr.result()
