"""Exhaustive (capped) map-space search.

Tilings stream out of the map-space in chunks; each chunk is admitted
against the current incumbent (a bound-dominated tiling can never become
the running minimum) and the survivors are batch-evaluated. The argmin
over the stream -- and the reported best mapping -- is exactly the one
serial evaluation finds.

Candidate generation is ARRAY-NATIVE whenever the space allows it
(canonical orders, no constraint set): the per-dim legal chain lists are
combined by vectorized mixed-radix index decoding + one masked legality
program per block (``genome_batch.exhaustive_genome_batches``), which
reproduces the recursive enumerator's candidate stream AND chunk
boundaries bit-for-bit -- results and engine counters are identical, no
seed-versioning needed. Sampled orders or constraints fall back to the
scalar generator."""

from __future__ import annotations

import itertools
from typing import List, Optional

from repro_torch.core.cost.base import CostModel
from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.device_loop import (
    device_loop_enabled,
    device_precompute,
    sync_cadence,
)
from repro_torch.core.mappers.base import Mapper, SearchResult
from repro_torch.core.mapspace import MapSpace


class ExhaustiveMapper(Mapper):
    name = "exhaustive"

    def __init__(
        self,
        max_mappings: Optional[int] = 50_000,
        orders: str = "canonical",
        batch_size: int = 256,
        probe: int = 8,
        vectorized: bool = True,
    ) -> None:
        """``probe``: the engine-level warm start (see
        ``EvaluationEngine.evaluate_batch``) -- while no incumbent exists,
        the first ``probe`` candidates of a chunk are scored unpruned and
        their best seeds the bound filter for the rest (0 disables). The
        enumeration stream and the argmin are unaffected. ``vectorized``:
        use the array-native enumerator where applicable (bit-identical
        stream; False forces the scalar generator, the A/B reference)."""
        self.max_mappings = max_mappings
        self.orders = orders
        self.batch_size = batch_size
        self.probe = probe
        self.vectorized = vectorized

    def batch_hints(self) -> List[int]:
        return [self.probe, self.batch_size - self.probe, self.batch_size]

    def search(
        self,
        space: MapSpace,
        cost_model: CostModel,
        metric: str = "edp",
        engine: Optional[EvaluationEngine] = None,
    ) -> SearchResult:
        engine = self._mk_engine(space, cost_model, metric, engine)
        tr = self._mk_result(metric, engine)
        if self.vectorized and self.orders == "canonical" and space.constraints is None:
            # device-resident window: buffer up to K enumerated chunks and
            # score them as ONE fused dispatch; each chunk replays through
            # the engine with its precomputed rows (admission against the
            # then-current incumbent), so the argmin and every counter
            # equal the chunk-at-a-time host loop. The enumeration stream
            # and chunk boundaries are untouched.
            window = sync_cadence() if device_loop_enabled(engine) else 1
            stream = space.enumerate_genome_batches(
                max_mappings=self.max_mappings, batch_size=self.batch_size
            )
            while True:
                batches = list(itertools.islice(stream, window))
                if not batches:
                    break
                pres = device_precompute(engine, batches) if window > 1 else None
                if pres is None:
                    pres = [None] * len(batches)
                for gb, pre in zip(batches, pres):
                    costs = engine.evaluate_batch(
                        gb,
                        incumbent=tr.best_metric_value,
                        probe=self.probe,
                        precomputed=pre,
                    )
                    for i, c in enumerate(costs):
                        if c is not None:
                            tr.offer_lazy(lambda b=i, g=gb: g.genome(b), c)
            return tr.result()
        stream = space.enumerate_genomes(max_mappings=self.max_mappings, orders=self.orders)
        while True:
            chunk = list(itertools.islice(stream, self.batch_size))
            if not chunk:
                break
            costs = engine.evaluate_batch(
                chunk, incumbent=tr.best_metric_value, probe=self.probe
            )
            for m, c in zip(chunk, costs):
                if c is not None:
                    tr.offer(m, c)
        return tr.result()
