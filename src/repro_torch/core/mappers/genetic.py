"""GAMMA-style genetic-algorithm mapper (paper [15]).

Standard GA over the unified mapping genome (per-dim divisor chains +
per-level loop orders): tournament selection, chain crossover, tile/order
mutation, elitism. Works with ANY cost model -- in the paper's framing
this is the previously-impossible "GAMMA driving Timeloop" combination.

``seed_version=2`` (default) runs the GA ARRAY-NATIVE: the population
lives as dense :class:`~repro_torch.core.genome_batch.GenomeBatch` matrices and
every generation's selection (tournament index draws), crossover
(per-dim/per-level parent masks), mutation (masked order-swap / chain
re-sample) and legality checks run as masked array programs over the
whole population with a counter-based (Philox) RNG -- one draw sequence
per generation instead of thousands of per-candidate ``random.Random``
calls. Generation is all-numpy, so for a fixed seed the search is
bit-identical across the scalar, numpy and torch engine backends.
``seed_version=1`` preserves the historical per-candidate stream exactly.

Fitness is computed through the evaluation engine: each generation's
children are generated first (only the RNG advances) and then scored as
one batch, so the signature cache absorbs the heavy candidate re-visiting
of mutate/crossover and pool fan-out applies when enabled. Selection
needs a true fitness for every member, so the lower-bound filter is NOT
applied here -- population dynamics, and therefore results for fixed
seeds, are identical to serial evaluation.
"""

from __future__ import annotations

import random
from operator import itemgetter
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import genome_batch as gbm
from repro_torch.core.cost.base import CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.device_loop import DeviceGAScorer, device_loop_enabled
from repro_torch.core.mappers.base import Mapper, SearchResult
from repro_torch.core.mapspace import MapSpace, fast_sample


class GeneticMapper(Mapper):
    name = "genetic"

    def __init__(
        self,
        population: int = 40,
        generations: int = 20,
        elite: int = 4,
        tournament: int = 3,
        mutation_rate: float = 0.35,
        seed: int = 0,
        seed_version: int = 2,
    ) -> None:
        self.population = population
        self.generations = generations
        self.elite = elite
        self.tournament = tournament
        self.mutation_rate = mutation_rate
        self.seed = seed
        self.seed_version = seed_version

    def batch_hints(self) -> List[int]:
        return [self.population, self.population - self.elite]

    def search(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str = "edp",
        engine: Optional[EvaluationEngine] = None,
    ) -> SearchResult:
        if self.seed_version < 2:
            return self._search_v1(space, cost_model, metric, engine)
        return self._search_v2(space, cost_model, metric, engine)

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
        P = self.population
        n, D = space.n_levels, len(space.dims)

        # Device-resident scoring: each generation's fitness comes off one
        # fused dispatch with results left ON DEVICE; the buffered results
        # replay through the engine (and the tracker, in generation order)
        # every sync_cadence() generations. Selection reads only the
        # fitness vector and the GA never consults the tracker mid-loop,
        # so deferring the offers is observationally equivalent -- best,
        # trajectory, memo and store contents equal the host loop's.
        def on_costs(g, cs):
            for i, c in enumerate(cs):
                tr.offer_lazy(
                    lambda b=i, gg=g: gg.genome(b), c, score=c.metric(metric)
                )

        scorer = DeviceGAScorer(engine, on_costs) if device_loop_enabled(engine) else None

        def score_batch(g):
            """Per-row fitness; offers immediate (host) or deferred
            (device, replayed in order at the K-generation sync)."""
            if scorer is not None and scorer.active:
                f = scorer.score(g)
                if f is not None:
                    return f
            cs = engine.evaluate_batch(g)
            out = np.empty(len(g), dtype=np.float64)
            for i, c in enumerate(cs):
                s = c.metric(metric)
                tr.offer_lazy(lambda b=i, gg=g: gg.genome(b), c, score=s)
                out[i] = s
            return out

        tt, st, perm = gbm.random_rows_batch(space, rng, P)
        gb = gbm.GenomeBatch(space, tt, st, perm)
        fitness = score_batch(gb)

        T = min(self.tournament, P)
        elite = min(self.elite, P)
        C = P - elite
        for _gen in range(self.generations):
            order = np.argsort(fitness, kind="stable")
            tt, st, perm, fitness = tt[order], st[order], perm[order], fitness[order]
            if C <= 0:
                break
            # tournament selection: per (child, parent), T distinct
            # population indices via the smallest-keys trick, winner by
            # fitness
            keys = rng.random((C, 2, P))
            contenders = np.argpartition(keys, T - 1, axis=2)[:, :, :T]
            cfit = fitness[contenders]
            winner = np.take_along_axis(
                contenders, np.argmin(cfit, axis=2)[:, :, None], axis=2
            )[:, :, 0]
            pa, pb = winner[:, 0], winner[:, 1]
            # FUSED child construction: per-dim uniform chain crossover +
            # per-level order choice, mutation applied in the same round
            # (mutated children: one order swap or one chain re-sample),
            # ONE legality program per round over all still-illegal
            # children, which redraw their masks/moves against the same
            # parents
            ctt = np.empty((C, n, D), dtype=np.int64)
            cst = np.empty_like(ctt)
            cperm = np.empty_like(ctt)
            mut = rng.random(C) < self.mutation_rate
            todo = np.arange(C)
            for _try in range(3):
                V = todo.size
                sa, sb = pa[todo], pb[todo]
                md = (rng.random((V, D)) < 0.5)[:, None, :]
                mo = (rng.random((V, n)) < 0.5)[:, :, None]
                t2 = np.where(md, tt[sa], tt[sb])
                s2 = np.where(md, st[sa], st[sb])
                p2 = np.where(mo, perm[sa], perm[sb])
                mrows = np.flatnonzero(mut[todo])
                if mrows.size:
                    move = rng.random(mrows.size) < 0.3
                    om = mrows[move]
                    if om.size and D >= 2:
                        lvl = rng.integers(0, n, om.size)
                        a = rng.integers(0, D, om.size)
                        b = rng.integers(0, D - 1, om.size)
                        b = b + (b >= a)
                        swp = p2[om, lvl, a].copy()
                        p2[om, lvl, a] = p2[om, lvl, b]
                        p2[om, lvl, b] = swp
                    cmr = mrows[~move]
                    if cmr.size:
                        dsel = rng.integers(0, D, cmr.size)
                        for j in range(D):
                            rr = cmr[dsel == j]
                            if rr.size == 0:
                                continue
                            tcol, scol = gbm.sample_chain_cols(
                                space, rng, j, rr.size
                            )
                            t2[rr, :, j] = tcol
                            s2[rr, :, j] = scol
                # two-phase legality: pass the (majority) already-legal
                # children untouched -- duplicate children stay exact
                # duplicates and keep hitting the engine memo -- then
                # repair ONLY the failures' fanout (the dominant failure
                # mode of cross-dim mixing) and re-check that small subset
                ok = gbm.legal_batch(space, t2, s2, p2, structured=True)
                bad = np.flatnonzero(~ok)
                if bad.size:
                    bt, bs, bp = t2[bad], s2[bad], p2[bad]
                    gbm.repair_fanout_batch(space, rng, bt, bs)
                    ok2 = gbm.legal_batch(space, bt, bs, bp, structured=True)
                    fixed = np.flatnonzero(ok2)
                    t2[bad[fixed]] = bt[fixed]
                    s2[bad[fixed]] = bs[fixed]
                    ok[bad[fixed]] = True
                ctt[todo], cst[todo], cperm[todo] = t2, s2, p2
                todo = todo[~ok]
                if todo.size == 0:
                    break
            # Fallback after the bounded retry rounds: parent a wholesale.
            # Deliberately a DUPLICATE of an already-scored candidate --
            # it shows up as a memo hit, costing a dict probe instead of
            # an array-program evaluation (the scalar GA converged to the
            # same behavior through its per-candidate fallbacks).
            if todo.size:
                ctt[todo], cst[todo], cperm[todo] = (
                    tt[pa[todo]],
                    st[pa[todo]],
                    perm[pa[todo]],
                )
            cgb = gbm.GenomeBatch(space, ctt, cst, cperm)
            cfit2 = score_batch(cgb)
            tt = np.concatenate([tt[:elite], ctt])
            st = np.concatenate([st[:elite], cst])
            perm = np.concatenate([perm[:elite], cperm])
            fitness = np.concatenate([fitness[:elite], cfit2])
        if scorer is not None:
            scorer.flush()  # replay any still-buffered generations
        return tr.result()

    # ------------------------------------------------------------------ #
    def _search_v1(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str,
        engine: Optional[EvaluationEngine],
    ) -> SearchResult:
        """The historical per-candidate stream (``seed_version=1``),
        bit-exact with pre-batch releases for fixed seeds."""
        engine = self._mk_engine(space, cost_model, metric, engine)
        rng = random.Random(self.seed)
        tr = self._mk_result(metric, engine)

        seeds = [space.random_genome(rng) for _ in range(self.population)]
        costs = engine.evaluate_batch(seeds)
        pop: List[Tuple[float, object]] = []
        for m, c in zip(seeds, costs):
            tr.offer(m, c)
            pop.append((c.metric(metric), m))

        fitness = itemgetter(0)
        tournament = min(self.tournament, self.population)
        for _gen in range(self.generations):
            pop.sort(key=fitness)
            nxt: List[Tuple[float, object]] = pop[: self.elite]

            def pick():
                contenders = fast_sample(rng, pop, min(tournament, len(pop)))
                return min(contenders, key=fitness)[1]

            children = []
            while len(nxt) + len(children) < self.population:
                child = space.crossover_genome(pick(), pick(), rng)
                if rng.random() < self.mutation_rate:
                    child = space.mutate_genome(child, rng)
                children.append(child)
            ccosts = engine.evaluate_batch(children)
            for m, c in zip(children, ccosts):
                tr.offer(m, c)
                nxt.append((c.metric(metric), m))
            pop = nxt
        return tr.result()
