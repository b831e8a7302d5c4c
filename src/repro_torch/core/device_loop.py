"""Device-resident search loops over the shape-generic fused program.

The evaluation engine's per-batch torch path round-trips host<->device every
miss-batch: stack, upload, dispatch, materialize, commit. For the search
loops whose candidate streams do not depend on the engine (random and
exhaustive sampling) or need only a scalar fitness per candidate (the
GA's selection), that cadence is pure overhead -- the candidates of many
batches can be scored by ONE mega-batch dispatch (or left on device and
materialized every K generations) with the host touched only at the sync
points for memo/ResultStore commits and incumbent export.

Two primitives, both strictly RESULT-PRESERVING:

``device_precompute(engine, batches)``
    Scores a window of pre-generated :class:`GenomeBatch` chunks as one
    fused dispatch of the shape-generic runner and hands each chunk its
    row-slice of the results as a :class:`PrecomputedScores`. The engine
    then replays each chunk through ``evaluate_batch(precomputed=...)``:
    dedup, memo/store probes, admission against the CURRENT incumbent and
    every counter run exactly as in the per-batch flow -- only the array
    dispatch is skipped (per-row values are batch-composition independent,
    so the mega-batch rows equal the per-batch rows bit for bit).

``DeviceGAScorer``
    Generation-resident GA scoring: each generation is dispatched with
    results left ON DEVICE; only the scalarized fitness vector (and the
    exactness guards) is fetched per generation -- population dynamics
    need nothing else. Every ``sync_cadence()`` generations the buffered
    device results are materialized and replayed through the engine in
    generation order, so incumbent tracking, trajectory, memo and store
    contents are identical to the host loop's (the GA never reads the
    tracker mid-generation and never prunes, so deferring the offers by K
    generations is observationally equivalent).

Every primitive degrades to ``None``/host-loop behavior when the runner
is unavailable (numpy backend, no generic terms, torch broken mid-flight)
or an exactness guard trips -- callers fall through to the unchanged
per-batch path, and results are identical either way.

Env knobs: ``UNION_DEVICE_LOOP=0`` disables the device loops wholesale;
``UNION_DEVICE_K`` sets the sync cadence (default 8 batches/generations
per host sync).
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.cost.analysis import (
    BACKEND_ERRORS,
    BATCH_EXACT_LIMIT,
    StackedBatch,
    global_trace_count,
    to_host,
)
from repro_torch.core.cost.engine import EvaluationEngine, PrecomputedScores
from repro_torch.core.genome_batch import GenomeBatch

__all__ = [
    "sync_cadence",
    "device_loop_enabled",
    "device_precompute",
    "DeviceGAScorer",
]


def sync_cadence() -> int:
    """Batches/generations per host synchronization point (>=1).

    ``UNION_DEVICE_K`` overrides the default of 8; malformed values fall
    back to the default rather than crashing a sweep."""
    try:
        k = int(os.environ.get("UNION_DEVICE_K", "8"))
    except ValueError:
        return 8
    return max(1, k)


def device_loop_enabled(engine: EvaluationEngine) -> bool:
    """Whether the device-resident loops should even be attempted for
    this engine: torch backend and not globally disabled. The runner
    capability check happens lazily in the primitives (they return None
    and the caller keeps the host loop)."""
    return (
        os.environ.get("UNION_DEVICE_LOOP", "1") != "0"
        and engine.backend == "torch"
    )


def _precompute_runner(engine: EvaluationEngine):
    """The engine's fused runner iff it supports precompute (the
    shape-generic runner does; per-context closures do not)."""
    if not device_loop_enabled(engine):
        return None
    runner = engine._get_fused_runner()
    if runner is None or not getattr(runner, "supports_precompute", False):
        return None
    return runner


def _materialize(buf) -> List[Optional[PrecomputedScores]]:
    """Host :class:`PrecomputedScores` for each buffered ``(gb, raw
    device output)`` generation -- None where exactness cannot be
    honoured -- from ONE device-to-host copy per dtype over the whole
    buffer (the K-generation sync)."""
    flat, layout = [], []
    for gb, out in buf:
        _admit, lb_mx, latency, energy, util, score_mx, extras = out
        keys = list(extras)
        layout.append((len(gb), keys))
        flat += [lb_mx, score_mx, latency, energy, util] + [extras[k] for k in keys]
    host = to_host(flat)
    pres: List[Optional[PrecomputedScores]] = []
    off = 0
    for B, keys in layout:
        lb_mx, score_mx, latency, energy, util = host[off: off + 5]
        ex = host[off + 5: off + 5 + len(keys)]
        off += 5 + len(keys)
        if not (float(lb_mx) < BATCH_EXACT_LIMIT and float(score_mx) < BATCH_EXACT_LIMIT):
            pres.append(None)
            continue
        extras_h = {k: v[:B] for k, v in zip(keys, ex)}
        pres.append(PrecomputedScores(
            extras_h["lb_cycles"],
            extras_h["lb_energy"],
            latency[:B],
            energy[:B],
            util[:B],
            extras_h,
        ))
    return pres


def device_precompute(
    engine: EvaluationEngine, batches: Sequence[GenomeBatch]
) -> Optional[List[PrecomputedScores]]:
    """Score a window of batches as ONE fused dispatch; returns each
    batch's :class:`PrecomputedScores` row-slice, or None (caller keeps
    the per-batch host flow -- results identical either way).

    The dispatch runs with ``incumbent=inf`` (every row scored); the
    engine replays admission per batch against the then-current incumbent
    from the returned bound arrays, which equals the per-batch decision
    bit for bit. One host sync per window (``stats.device_syncs``)."""
    runner = _precompute_runner(engine)
    if runner is None or not batches:
        return None
    sbs = [gb.stacked() for gb in batches]
    mega = StackedBatch(
        np.ascontiguousarray(np.concatenate([s.tt for s in sbs])),
        np.ascontiguousarray(np.concatenate([s.st for s in sbs])),
        np.ascontiguousarray(np.concatenate([s.perm for s in sbs])),
    )
    total = int(mega.tt.shape[0])
    before = global_trace_count()
    try:
        out = runner(mega, math.inf)
    finally:
        engine.stats.n_traces += global_trace_count() - before
    if out is None:
        return None
    _admit, lb_mx, latency, energy, util, score_mx, extras = out
    if not (lb_mx < BATCH_EXACT_LIMIT and score_mx < BATCH_EXACT_LIMIT):
        return None
    engine.stats.device_syncs += 1
    whole = PrecomputedScores(
        extras["lb_cycles"][:total],
        extras["lb_energy"][:total],
        latency[:total],
        energy[:total],
        util[:total],
        {k: v[:total] for k, v in extras.items()},
    )
    views: List[PrecomputedScores] = []
    off = 0
    for gb in batches:
        views.append(whole.select(slice(off, off + len(gb))))
        off += len(gb)
    return views


class DeviceGAScorer:
    """Generation-resident GA fitness with K-deferred host replay.

    ``score(gb)`` dispatches one generation and returns its float64
    fitness vector (the engine metric, scalarized on device) -- the only
    host transfer is that vector plus two guard scalars. The full device
    results are buffered; every :func:`sync_cadence` generations (and at
    :meth:`flush`) they are materialized and replayed IN ORDER through
    ``engine.evaluate_batch(gb, precomputed=...)``, with ``on_costs(gb,
    costs)`` invoked per generation so the caller's incumbent tracking
    sees the exact host-loop offer sequence.

    ``score`` returns None once the device path is unavailable (no
    generic runner, guard trip, torch failure); buffered generations are
    replayed first -- falling back to plain engine evaluation if their
    device buffers can no longer be read -- so no offer is ever lost and
    the caller can continue with the host loop mid-search."""

    def __init__(
        self,
        engine: EvaluationEngine,
        on_costs: Callable[[GenomeBatch, List], None],
    ) -> None:
        self._engine = engine
        self._on_costs = on_costs
        self._runner = _precompute_runner(engine)
        self._buf: List[tuple] = []  # (gb, raw device out)
        self._k = sync_cadence()

    @property
    def active(self) -> bool:
        return self._runner is not None

    def _disable(self) -> None:
        self.flush()
        self._runner = None

    def score(self, gb: GenomeBatch) -> Optional[np.ndarray]:
        if self._runner is None:
            return None
        runner = self._runner
        if getattr(runner, "dispatch_device", None) is None:
            self._disable()
            return None
        before = global_trace_count()
        try:
            out = runner.dispatch_device(gb.stacked())
        finally:
            self._engine.stats.n_traces += global_trace_count() - before
        if out is None:
            self._disable()
            return None
        _admit, lb_mx, _lat, _en, _ut, score_mx, extras = out
        # guards + fitness are the ONLY per-generation host transfer (one
        # float64 copy); a device fault surfaces here, at the sync
        try:
            lb_mx, score_mx, fitness = to_host([lb_mx, score_mx, extras["metric_score"]])
        except BACKEND_ERRORS:
            self._engine._ctx._backend_failure("a device-loop fitness sync")
            self._disable()
            return None
        if not (float(lb_mx) < BATCH_EXACT_LIMIT and float(score_mx) < BATCH_EXACT_LIMIT):
            self._disable()
            return None
        fitness = fitness[: len(gb)]
        self._buf.append((gb, out))
        if len(self._buf) >= self._k:
            self.flush()
        return fitness

    def flush(self) -> None:
        """Materialize and replay every buffered generation, in order.
        One host sync for the whole buffer."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        self._engine.stats.device_syncs += 1
        try:
            pres = _materialize(buf)
        except BACKEND_ERRORS:  # device buffers gone: re-evaluate on the host
            self._engine._ctx._backend_failure("a device-loop flush")
            pres = [None] * len(buf)
        for (gb, _out), pre in zip(buf, pres):
            costs = self._engine.evaluate_batch(gb, precomputed=pre)
            self._on_costs(gb, costs)
