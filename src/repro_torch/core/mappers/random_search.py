"""Random-sampling mapper (Timeloop's default search [11]).

Samples are drawn in chunks and scored through the evaluation engine:
bound-dominated candidates are pruned before the reuse analysis, the rest
are batch-evaluated (pool fan-out when the engine has workers).

``seed_version`` selects the candidate generator:

  * ``2`` (default) -- ARRAY-NATIVE: each chunk is one
    :class:`~repro_torch.core.genome_batch.GenomeBatch` drawn by the vectorized
    counter-based (Philox) sampler -- chain choices, fanout repair,
    order shuffles and legality run as array programs over the whole
    chunk, and the engine consumes the dense rows directly (row-hash
    dedup, sliced StackedBatch). Candidates depend only on
    ``(seed, chunk sequence)``; generation never touches the engine
    backend, so results are bit-identical across scalar/numpy/torch.
  * ``1`` -- the historical per-candidate ``random.Random`` stream
    (bit-exact with every pre-batch release for fixed seeds).

Within a version, chunking preserves the exact sample stream -- and a
pruned candidate provably cannot improve the incumbent -- so results are
identical to one-at-a-time evaluation for fixed seeds.
"""

from __future__ import annotations

import random
from typing import List, Optional

from repro_torch.core.cost.base import CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.device_loop import (
    device_loop_enabled,
    device_precompute,
    sync_cadence,
)
from repro_torch.core.genome_batch import philox_rng, random_genome_batch
from repro_torch.core.mappers.base import Mapper, SearchResult
from repro_torch.core.mapspace import MapSpace


class RandomMapper(Mapper):
    name = "random"

    def __init__(
        self,
        samples: int = 2000,
        seed: int = 0,
        patience: int = 0,
        batch_size: int = 128,
        probe: int = 8,
        seed_version: int = 2,
    ) -> None:
        """``patience``: stop after this many consecutive non-improving
        samples (0 = never early-stop), mirroring Timeloop's victory
        condition. ``probe``: the engine-level warm start (see
        ``EvaluationEngine.evaluate_batch``) -- while no incumbent exists,
        the first ``probe`` candidates of a batch are scored unpruned and
        their best seeds the bound filter for the rest (0 disables). The
        sample stream is independent of chunking and pruning is exact, so
        results are identical for any ``probe``. ``seed_version``: 2 for
        the vectorized batch sampler (default), 1 for the historical
        scalar stream."""
        self.samples = samples
        self.seed = seed
        self.patience = patience
        self.batch_size = batch_size
        self.probe = probe
        self.seed_version = seed_version

    def batch_hints(self) -> List[int]:
        first = min(self.batch_size, self.samples)
        tail = self.samples % self.batch_size
        return [self.probe, first - self.probe, first, tail]

    def search(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str = "edp",
        engine: Optional[EvaluationEngine] = None,
    ) -> SearchResult:
        engine = self._mk_engine(space, cost_model, metric, engine)
        tr = self._mk_result(metric, engine)
        v2 = self.seed_version >= 2
        rng = philox_rng(self.seed) if v2 else random.Random(self.seed)
        # device-resident window: pre-draw up to K chunks (the sample
        # stream is generation-independent, so the draws are the exact
        # chunks the host loop would draw) and score them as ONE fused
        # device dispatch; each chunk then replays through the engine with
        # its precomputed rows -- admission against the then-current
        # incumbent, memo/store and counters identical to the host loop.
        # A patience stop mid-window discards the unconsumed chunks.
        window = sync_cadence() if (v2 and device_loop_enabled(engine)) else 1
        stale = 0
        remaining = self.samples
        stop = False
        while remaining > 0 and not stop:
            sizes = []
            rem2 = remaining
            while rem2 > 0 and len(sizes) < window:
                k = min(self.batch_size, rem2)
                rem2 -= k
                sizes.append(k)
            remaining = rem2
            if v2:
                batches = [random_genome_batch(space, rng, k) for k in sizes]
            else:
                batches = [
                    [space.random_genome(rng) for _ in range(k)] for k in sizes
                ]
            pres = device_precompute(engine, batches) if window > 1 else None
            if pres is None:
                pres = [None] * len(batches)
            for batch, pre in zip(batches, pres):
                costs = engine.evaluate_batch(
                    batch,
                    incumbent=tr.best_metric_value,
                    probe=self.probe,
                    precomputed=pre,
                )
                for i, c in enumerate(costs):
                    if c is not None and (
                        tr.offer_lazy(lambda b=i, g=batch: g.genome(b), c)
                        if v2
                        else tr.offer(batch[i], c)
                    ):
                        stale = 0
                    else:
                        # pruned candidates are provably non-improving
                        stale += 1
                        if self.patience and stale >= self.patience:
                            stop = True
                            break
                if stop:
                    break
        return tr.result()
