"""Mapping-as-a-service: a crash-safe, deadline-enforced query daemon.

Union's pitch is that mappings are REUSABLE ARTIFACTS: once a (problem,
arch, metric) space has been searched, the answer should be served, not
recomputed. The sweep side of that story is ``repro_torch.core.sweep_exec``
(concurrent groups, journal + resume, fault injection); this module is
the daemon half -- a long-running process that accepts mapping queries
over local HTTP and answers

* from the **answer journal** in O(ms) when warm (a previously answered
  query replays its journaled solution record verbatim -- byte-identical
  across restarts and kill -9 by construction), or
* by a **bounded search** on miss, warm-started from the store's
  nearest-neighbor space and flushed store-ahead-of-journal exactly like
  the sweep executor.

Robustness is the product, not a feature:

* **Backpressure** -- a bounded admission queue; a full queue sheds the
  request with HTTP 429 + ``Retry-After`` (``shed`` counter, live
  ``queue_depth`` in ``/metrics``) instead of queueing unboundedly.
* **Per-query deadlines** -- the cold search runs in budget slices, each
  under :func:`~repro_torch.runtime.fault_tolerance.call_with_deadline`; a
  missed deadline returns the best incumbent found so far flagged
  ``budget_exhausted`` (never an error), falling back to one
  deterministic candidate when no slice finished.
* **Circuit breaker** -- a service-wide
  :class:`~repro_torch.runtime.fault_tolerance.CircuitBreaker` wraps the
  torch engine backend (``backend="torch"``, the default: each cold
  search scores its candidates with float64 programs on ``device``,
  "cuda" by default):
  consecutive torch failures open the circuit (queries run the
  bit-identical numpy path), the deterministic probe schedule admits
  half-open probes, and a clean torch query closes it again -- the
  stateful, recoverable form of the sweep executor's one-way
  degradation.
* **Nearest-neighbor warm start** -- a cold query seeds the engine's
  incumbent from the best stored cost of the content-nearest space
  (same model + arch, scaled by the iteration-space ratio with slack),
  so admission prunes from candidate #1; a too-optimistic seed is
  detected (no survivor) and the slice re-runs unseeded
  (``seed_misfires``).
* **Crash safety** -- every completed search flushes the ResultStore
  BEFORE its journal record (the sweep executor's ordering), the daemon
  drains gracefully on SIGTERM (stop accepting, finish + journal
  in-flight queries, flush, exit 0), and a kill -9'd daemon restarted on
  the same state directory answers previously-answered queries from the
  journal with zero re-search.

Deterministic fault injection reuses the ``UNION_FAULT_SPEC`` grammar
(see ``repro_torch.core.sweep_exec``), with the group index reinterpreted as
the QUERY ORDINAL (0-based arrival order of cold searches):

    jaxfail:Q        query Q's engine sees an array-backend (torch)
                     failure -> breaker records it, engine degrades to
                     numpy mid-search
    slow:Q@K:S       query Q sleeps S seconds before budget slice K --
                     deadline-with-partial-result paths fire
                     deterministically

HTTP API (all JSON, the reference's schemas):

    POST /v1/mapping   {problem, arch, metric?, mapper?, budget?,
                        deadline_s?}  ->  answer envelope
    GET  /metrics      service counters + breaker/store/journal stats
    GET  /healthz      {"ok": true, "draining": false}

Run it: ``python -m repro_torch.serve.mapping_service --state-dir DIR``
(the torch backend on ``--device cuda``, the defaults, which raise
without a card; ``--device cpu`` runs the torch programs on the host,
``--backend numpy`` scores on the host without torch).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
import os
import queue
import random
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from repro_torch.core.architecture import (
    chiplet_accelerator,
    cloud_accelerator,
    edge_accelerator,
    tpu_chip,
)
from repro_torch.core.cost.engine import EvaluationEngine, _torch_device
from repro_torch.core.cost.store import (
    ResultStore,
    SweepJournal,
    _canon_arch,
    _canon_problem,
    _problem_features,
)
from repro_torch.core.mappers import MAPPER_REGISTRY
from repro_torch.core.mappers.base import SearchResult
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.optimizer import COST_MODEL_REGISTRY
from repro_torch.core.problem import Problem
from repro_torch.core.sweep_exec import FaultSpec, result_to_record
from repro_torch.runtime.fault_tolerance import (
    CallTimeoutError,
    CircuitBreaker,
    call_with_deadline,
)

log = logging.getLogger("repro_torch.serve")

BACKENDS = ("numpy", "torch")

QUERY_VERSION = 1

# first slice is small so SOME incumbent exists within milliseconds even
# under a tight deadline; later slices amortize mapper/setup overhead
_FIRST_SLICE = 64
_SLICE = 256
# distinct Philox/sample streams per slice (re-sampling slice 0's stream
# would only produce memo hits and waste the budget)
_SLICE_SEED_STRIDE = 100003


class QueryError(ValueError):
    """A query is malformed (unknown kind/mapper/metric, bad sizes)."""


# --------------------------------------------------------------------- #
# Query parsing
# --------------------------------------------------------------------- #
_METRICS = ("edp", "latency", "energy")


def _parse_problem(spec) -> Problem:
    if not isinstance(spec, dict):
        raise QueryError("problem must be an object")
    kind = str(spec.get("kind", "gemm")).lower()
    name = str(spec.get("name", kind))
    wb = int(spec.get("word_bytes", 2))
    try:
        if kind == "gemm":
            return Problem.gemm(
                int(spec["m"]), int(spec["n"]), int(spec["k"]),
                name=name, word_bytes=wb,
            )
        if kind == "conv2d":
            return Problem.conv2d(
                int(spec.get("n", 1)), int(spec["k"]), int(spec["c"]),
                int(spec["x"]), int(spec["y"]), int(spec["r"]),
                int(spec["s"]), stride=int(spec.get("stride", 1)),
                name=name, word_bytes=wb,
            )
        if kind == "mttkrp":
            return Problem.mttkrp(
                int(spec["i"]), int(spec["j"]), int(spec["k"]),
                int(spec["l"]), name=name, word_bytes=wb,
            )
    except QueryError:
        raise
    except Exception as e:
        raise QueryError(f"bad problem spec ({type(e).__name__}: {e})") from None
    raise QueryError(f"unknown problem kind {kind!r}")


def _parse_arch(spec):
    if spec is None:
        return edge_accelerator()
    if not isinstance(spec, dict):
        raise QueryError("arch must be an object")
    kind = str(spec.get("kind", "edge")).lower()
    try:
        if kind == "edge":
            aspect = spec.get("aspect", (16, 16))
            return edge_accelerator(aspect=(int(aspect[0]), int(aspect[1])))
        if kind == "cloud":
            aspect = spec.get("aspect", (32, 64))
            return cloud_accelerator(aspect=(int(aspect[0]), int(aspect[1])))
        if kind == "chiplet":
            return chiplet_accelerator(
                n_chiplets=int(spec.get("n_chiplets", 16))
            )
        if kind == "tpu":
            return tpu_chip()
    except QueryError:
        raise
    except Exception as e:
        raise QueryError(f"bad arch spec ({type(e).__name__}: {e})") from None
    raise QueryError(f"unknown arch kind {kind!r}")


def query_fingerprint(cost_model, problem, arch, metric: str,
                      mapper_name: str, mapper_kw: dict, budget: int) -> str:
    """Stable content fingerprint of one mapping query.

    Built on the store's canonical problem/arch forms, so two queries
    that differ only in display names (which never affect costs) share
    one journal answer. The DEADLINE is deliberately excluded: it shapes
    how long a cold search may run, not what the converged answer is,
    and only complete (non-exhausted) answers are journaled.
    """
    desc = json.dumps(
        {
            "version": QUERY_VERSION,
            "model": [repr(p) for p in cost_model.store_key_parts()],
            "problem": _canon_problem(problem),
            "arch": _canon_arch(arch),
            "metric": metric,
            "mapper": [mapper_name, sorted(mapper_kw.items())],
            "budget": int(budget),
        },
        sort_keys=True,
        default=repr,
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:24]


class _ParsedQuery:
    __slots__ = (
        "problem", "arch", "cost_model", "metric", "mapper_name",
        "mapper_kw", "budget", "deadline_s", "fingerprint",
    )

    def __init__(self, q: dict, default_deadline_s: Optional[float]) -> None:
        if not isinstance(q, dict):
            raise QueryError("query must be a JSON object")
        self.problem = _parse_problem(q.get("problem"))
        self.arch = _parse_arch(q.get("arch"))
        metric = str(q.get("metric", "edp"))
        if metric not in _METRICS:
            raise QueryError(f"unknown metric {metric!r} (want {_METRICS})")
        self.metric = metric
        model = str(q.get("model", "timeloop"))
        if model not in COST_MODEL_REGISTRY:
            raise QueryError(f"unknown cost model {model!r}")
        self.cost_model = COST_MODEL_REGISTRY[model]()
        mspec = q.get("mapper") or {}
        if isinstance(mspec, str):
            mspec = {"name": mspec}
        if not isinstance(mspec, dict):
            raise QueryError("mapper must be a name or an object")
        self.mapper_name = str(mspec.get("name", "random"))
        if self.mapper_name not in MAPPER_REGISTRY:
            raise QueryError(
                f"unknown mapper {self.mapper_name!r} "
                f"(want one of {sorted(MAPPER_REGISTRY)})"
            )
        kw = dict(mspec.get("kw") or {})
        budget = q.get("budget", kw.get("samples", 512))
        try:
            self.budget = max(1, int(budget))
        except (TypeError, ValueError):
            raise QueryError(f"bad budget {budget!r}") from None
        self.mapper_kw = kw
        d = q.get("deadline_s", default_deadline_s)
        self.deadline_s = None if d is None else float(d)
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise QueryError("deadline_s must be positive (or null)")
        self.fingerprint = query_fingerprint(
            self.cost_model, self.problem, self.arch, self.metric,
            self.mapper_name, self.mapper_kw, self.budget,
        )


# --------------------------------------------------------------------- #
# Search-result merging across budget slices
# --------------------------------------------------------------------- #
def _merge_results(a: Optional[SearchResult], b: Optional[SearchResult],
                   metric: str) -> Optional[SearchResult]:
    """Fold slice ``b`` into running result ``a``: keep the better
    incumbent, sum every counter, concatenate trajectories with ``b``'s
    eval indices rebased past ``a``'s -- the record a sliced search
    journals is one coherent SearchResult."""
    if a is None:
        return b
    if b is None:
        return a
    better = b if b.best_metric < a.best_metric else a
    traj = list(a.trajectory) + [
        (i + a.considered, v) for i, v in b.trajectory
    ]
    return SearchResult(
        best_mapping=better.best_mapping,
        best_cost=better.best_cost,
        metric=metric,
        evaluated=a.evaluated + b.evaluated,
        elapsed_s=a.elapsed_s + b.elapsed_s,
        trajectory=traj,
        cache_hits=a.cache_hits + b.cache_hits,
        pruned=a.pruned + b.pruned,
        analyzed=a.analyzed + b.analyzed,
        store_hits=a.store_hits + b.store_hits,
        considered=a.considered + b.considered,
        fused_dispatches=a.fused_dispatches + b.fused_dispatches,
        backend_fallbacks=a.backend_fallbacks + b.backend_fallbacks,
        n_traces=a.n_traces + b.n_traces,
        device_syncs=a.device_syncs + b.device_syncs,
        admit_s=a.admit_s + b.admit_s,
        score_s=a.score_s + b.score_s,
    )


def _slice_plan(total: int) -> List[int]:
    sizes = [min(_FIRST_SLICE, total)]
    rem = total - sizes[0]
    while rem > 0:
        s = min(_SLICE, rem)
        sizes.append(s)
        rem -= s
    return sizes


# --------------------------------------------------------------------- #
# The service
# --------------------------------------------------------------------- #
class MappingService:
    """The daemon's engine room, usable in-process (tests drive
    :meth:`handle_query` directly) or behind the HTTP front
    (:func:`serve`/``main``).

    One ``state_dir`` holds everything a restart needs: the ResultStore
    space files (+ ``_meta.json`` for nearest-neighbor lookup) and the
    answer journal ``answers.journal`` (a :class:`SweepJournal` keyed by
    query fingerprint, always opened with ``resume=True`` -- the journal
    IS the service's memory). Cold searches are serialized by a search
    lock (one ResultStore handle, deterministic store traffic); warm
    journal answers bypass it entirely, so a slow cold search never
    blocks the O(ms) warm path beyond one worker.
    """

    def __init__(
        self,
        state_dir: str,
        *,
        backend: str = "torch",
        device: str = "cuda",
        deadline_s: Optional[float] = 5.0,
        queue_cap: int = 8,
        workers: int = 2,
        store_cap: Optional[int] = None,
        breaker_threshold: int = 2,
        probe_interval: int = 2,
        seed_slack: float = 4.0,
        fault_spec: Optional[str] = None,
    ) -> None:
        self.state_dir = str(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        # read-refresh: a concurrently running sweep's flushes become
        # visible to this long-lived process without a restart
        self.store = ResultStore(
            self.state_dir, max_entries_per_space=store_cap, refresh=True
        )
        self.journal = SweepJournal(
            os.path.join(self.state_dir, "answers.journal"), resume=True
        )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")
        self.backend = backend
        # the torch backend's device, checked here: a service told to use a
        # card it cannot see fails at start, not on its first query
        self.device = _torch_device(device) if backend == "torch" else None
        self.default_deadline_s = deadline_s
        self.queue_cap = int(queue_cap)
        self.n_workers = max(1, int(workers))
        self.seed_slack = float(seed_slack)
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            probe_interval=probe_interval,
            label="torch-backend",
        )
        self.fault = FaultSpec.parse(
            fault_spec if fault_spec is not None
            else os.environ.get("UNION_FAULT_SPEC")
        )
        self.jobs: "queue.Queue" = queue.Queue(maxsize=self.queue_cap)
        self.draining = False
        self._search_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self._search_seq = 0  # cold-search arrival ordinal (fault-spec id)
        # ---- counters (all under _state_lock)
        self.queries = 0
        self.store_hits = 0        # answered from the journal, zero search
        self.searches = 0          # cold searches run
        self.partials = 0          # budget_exhausted answers
        self.fallback_answers = 0  # deadline hit before any slice finished
        self.shed = 0              # 429s from the full admission queue
        self.errors = 0            # malformed queries
        self.seeded = 0            # cold searches warm-started from a neighbor
        self.seed_misfires = 0     # seeds that pruned everything (retried)
        self.neighbor_hits = 0
        self.neighbor_misses = 0
        self.neighbor_distance_sum = 0.0

    # ------------------------------------------------------------- #
    # Worker pool + drain
    # ------------------------------------------------------------- #
    def start_workers(self) -> None:
        for i in range(self.n_workers):
            t = threading.Thread(
                target=self._worker_loop, name=f"mapsvc-w{i}", daemon=True
            )
            t.start()
            self._workers.append(t)

    def _worker_loop(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                self.jobs.task_done()
                return
            try:
                job.result = self.handle_query(job.query)
            except Exception as e:  # noqa: BLE001 -- envelope, never crash
                log.exception("query failed")
                job.result = {
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                }
            finally:
                job.event.set()
                self.jobs.task_done()

    def drain(self) -> None:
        """Graceful shutdown: stop admitting (callers see ``draining``),
        finish + journal every queued and in-flight query, stop the
        workers, flush the store. Idempotent."""
        self.draining = True
        self.jobs.join()  # every admitted job answered (and journaled)
        for _ in self._workers:
            self.jobs.put(None)
        for t in self._workers:
            t.join(timeout=10.0)
        self._workers = []
        self.store.flush()
        self.journal.flush()

    # ------------------------------------------------------------- #
    # Query handling
    # ------------------------------------------------------------- #
    def handle_query(self, q: dict) -> dict:
        t0 = time.perf_counter()
        try:
            parsed = _ParsedQuery(q, self.default_deadline_s)
        except QueryError as e:
            with self._state_lock:
                self.errors += 1
            return {"ok": False, "error": str(e)}
        with self._state_lock:
            self.queries += 1
        env = self._answer(parsed)
        env["elapsed_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return env

    def _warm_answer(self, fp: str) -> Optional[dict]:
        rec = self.journal.get_task(fp)
        if rec is None:
            return None
        with self._state_lock:
            self.store_hits += 1
        return {
            "ok": True,
            "source": "store",
            "fingerprint": fp,
            "budget_exhausted": False,
            "seeded": False,
            "neighbor": None,
            "record": rec,
        }

    def _answer(self, parsed: _ParsedQuery) -> dict:
        env = self._warm_answer(parsed.fingerprint)
        if env is not None:
            return env
        with self._search_lock:
            # a queued duplicate may have been answered while we waited
            env = self._warm_answer(parsed.fingerprint)
            if env is not None:
                return env
            return self._search(parsed)

    # ------------------------------------------------------------- #
    def _neighbor_seed(self, parsed: _ParsedQuery, skey: str):
        """(seed value, info dict) from the nearest registered space, or
        (None, None). The neighbor's best metric is scaled by the
        iteration-space (MAC) ratio -- linear for latency/energy,
        quadratic for EDP -- never scaled DOWN below the neighbor's own
        best, and widened by ``seed_slack``: a conservative upper bound
        for "what should this space be able to beat"."""
        nb = self.store.nearest_space(
            parsed.cost_model, parsed.problem, parsed.arch, exclude=skey
        )
        if nb is None:
            with self._state_lock:
                self.neighbor_misses += 1
            return None, None
        nskey, dist = nb
        base = self.store.best_in_space(nskey, parsed.metric)
        meta = self.store.space_meta(nskey)
        if base is None or base <= 0.0 or meta is None:
            with self._state_lock:
                self.neighbor_misses += 1
            return None, None
        ratio = _problem_features(parsed.problem)["macs"] / max(
            float(meta.get("macs", 1.0)), 1.0
        )
        scale = ratio * ratio if parsed.metric == "edp" else ratio
        seed = base * max(scale, 1.0) * self.seed_slack
        if not math.isfinite(seed) or seed <= 0.0:
            with self._state_lock:
                self.neighbor_misses += 1
            return None, None
        with self._state_lock:
            self.neighbor_hits += 1
            self.neighbor_distance_sum += float(dist)
        return seed, {
            "skey": nskey,
            "distance": round(float(dist), 6),
            "seed": seed,
        }

    def _make_engine(self, parsed: _ParsedQuery) -> Tuple[EvaluationEngine, bool]:
        """Fresh engine for one cold search, backend gated by the
        breaker: torch only when configured AND the circuit admits it
        (closed, or this call is the half-open probe)."""
        use_torch = self.backend == "torch" and self.breaker.allow()
        engine = EvaluationEngine(
            parsed.cost_model,
            parsed.problem,
            parsed.arch,
            metric=parsed.metric,
            backend="torch" if use_torch else "numpy",
            store=self.store,
            breaker=self.breaker if self.backend == "torch" else None,
            device=self.device or "cuda",
        )
        return engine, use_torch

    def _fallback_result(self, parsed: _ParsedQuery, space: MapSpace,
                         engine: EvaluationEngine, t0: float) -> SearchResult:
        """Deadline exhausted before any slice finished: score ONE
        deterministic candidate so the answer still carries an incumbent
        (flagged, never an error)."""
        with self._state_lock:
            self.fallback_answers += 1
        engine.seed_incumbent = None
        g = space.random_genome(random.Random(0))
        cost = engine.evaluate(g)
        return SearchResult(
            best_mapping=g.to_mapping(),
            best_cost=cost,
            metric=parsed.metric,
            evaluated=1,
            elapsed_s=time.monotonic() - t0,
            trajectory=[(1, cost.metric(parsed.metric))],
            considered=1,
        )

    def _search(self, parsed: _ParsedQuery) -> dict:
        with self._state_lock:
            ordinal = self._search_seq
            self._search_seq += 1
            self.searches += 1
        engine, used_torch = self._make_engine(parsed)
        ctx = engine._ctx
        prior_flag = ctx._torch_failed
        if ordinal in self.fault.jaxfail:
            # same choke point run_group poisons; restored in finally so
            # the process-global context cache stays clean
            ctx._torch_failed = True
        skey = engine._store_skey
        self.store.register_space_meta(
            skey, parsed.cost_model, parsed.problem, parsed.arch
        )
        seed, seed_info = self._neighbor_seed(parsed, skey)
        if seed is not None:
            with self._state_lock:
                self.seeded += 1
        space = MapSpace(parsed.problem, parsed.arch)
        t0 = time.monotonic()
        try:
            best, exhausted = self._run_slices(
                parsed, space, engine, seed, ordinal, t0
            )
            if best is None or best.best_mapping is None:
                best = self._fallback_result(parsed, space, engine, t0)
                exhausted = True
            if (
                used_torch
                and engine.backend == "torch"
                and engine.stats.backend_fallbacks == 0
            ):
                # clean torch completion: closes a half-open probe, resets
                # the consecutive-failure count when already closed
                # (failures are recorded by the engine's breaker hook)
                self.breaker.record_success()
        finally:
            if ordinal in self.fault.jaxfail:
                ctx._torch_failed = prior_flag
            engine.close()
        record = result_to_record(best)
        if not exhausted:
            # store-ahead-of-journal, the sweep executor's crash ordering:
            # scored Costs are never lost, at worst the answer is
            # re-derived warm from the store after a crash
            self.store.flush()
            self.journal.record_group(
                parsed.fingerprint, {parsed.fingerprint: record}
            )
        else:
            with self._state_lock:
                self.partials += 1
            self.store.flush()  # partial work is still real scored work
        return {
            "ok": True,
            "source": "search",
            "fingerprint": parsed.fingerprint,
            "budget_exhausted": exhausted,
            "seeded": seed is not None,
            "neighbor": seed_info,
            "backend": engine.backend,
            "record": record,
        }

    def _run_slices(self, parsed: _ParsedQuery, space: MapSpace,
                    engine: EvaluationEngine, seed: Optional[float],
                    ordinal: int, t0: float):
        """The bounded cold search: the mapper's budget in slices, each
        under the remaining deadline. Returns ``(best, exhausted)``."""
        metric = parsed.metric
        best: Optional[SearchResult] = None
        exhausted = False

        def remaining() -> Optional[float]:
            if parsed.deadline_s is None:
                return None
            return parsed.deadline_s - (time.monotonic() - t0)

        if parsed.mapper_name != "random":
            # population/structured mappers own their schedule: one shot
            # under the full deadline (partial-result slicing is the
            # random mapper's contract)
            kw = dict(parsed.mapper_kw)
            mp = MAPPER_REGISTRY[parsed.mapper_name](**kw)
            engine.seed_incumbent = seed
            slow = self.fault.slow_s(ordinal, 0)
            try:
                best = call_with_deadline(
                    lambda: (time.sleep(slow) if slow > 0 else None)
                    or mp.search(space, engine.cost_model, metric, engine=engine),
                    remaining(),
                    label=f"query{ordinal}",
                )
            except CallTimeoutError:
                return None, True
            if best is not None and best.best_mapping is None and seed is not None:
                # seed pruned everything: one unseeded retry
                with self._state_lock:
                    self.seed_misfires += 1
                engine.seed_incumbent = None
                mp = MAPPER_REGISTRY[parsed.mapper_name](**kw)
                try:
                    best = call_with_deadline(
                        lambda: mp.search(
                            space, engine.cost_model, metric, engine=engine
                        ),
                        remaining(),
                        label=f"query{ordinal}.retry",
                    )
                except CallTimeoutError:
                    return None, True
            return best, False

        kw = dict(parsed.mapper_kw)
        base_seed = int(kw.pop("seed", 0))
        kw.pop("samples", None)
        for si, size in enumerate(_slice_plan(parsed.budget)):
            rem = remaining()
            if rem is not None and rem <= 0:
                exhausted = True
                break
            slow = self.fault.slow_s(ordinal, si)
            engine.seed_incumbent = (
                best.best_metric if best is not None and best.best_mapping
                is not None else seed
            )
            mp = MAPPER_REGISTRY["random"](
                samples=size, seed=base_seed + si * _SLICE_SEED_STRIDE, **kw
            )
            try:
                res = call_with_deadline(
                    lambda mp=mp, slow=slow: (
                        time.sleep(slow) if slow > 0 else None
                    )
                    or mp.search(space, engine.cost_model, metric, engine=engine),
                    rem,
                    label=f"query{ordinal}.slice{si}",
                )
            except CallTimeoutError:
                exhausted = True
                break
            if res.best_mapping is None and engine.seed_incumbent is not None:
                # warm-start misfire: the seed bounded out every candidate
                # in this slice; re-run it unseeded (same sample stream --
                # this time candidates admit normally)
                with self._state_lock:
                    self.seed_misfires += 1
                engine.seed_incumbent = None
                mp = MAPPER_REGISTRY["random"](
                    samples=size, seed=base_seed + si * _SLICE_SEED_STRIDE,
                    **kw,
                )
                rem = remaining()
                if rem is not None and rem <= 0:
                    exhausted = True
                    break
                try:
                    res = call_with_deadline(
                        lambda mp=mp: mp.search(
                            space, engine.cost_model, metric, engine=engine
                        ),
                        rem,
                        label=f"query{ordinal}.slice{si}.retry",
                    )
                except CallTimeoutError:
                    exhausted = True
                    break
            best = _merge_results(best, res, metric)
        return best, exhausted

    # ------------------------------------------------------------- #
    def metrics(self) -> dict:
        with self._state_lock:
            m = {
                "queries": self.queries,
                "store_hits": self.store_hits,
                "searches": self.searches,
                "partials": self.partials,
                "fallback_answers": self.fallback_answers,
                "shed": self.shed,
                "errors": self.errors,
                "seeded": self.seeded,
                "seed_misfires": self.seed_misfires,
                "neighbor_hits": self.neighbor_hits,
                "neighbor_misses": self.neighbor_misses,
                "neighbor_distance_avg": round(
                    self.neighbor_distance_sum / self.neighbor_hits, 6
                ) if self.neighbor_hits else 0.0,
                "queue_depth": self.jobs.qsize(),
                "queue_cap": self.queue_cap,
                "draining": self.draining,
                "backend": self.backend,
                "device": self.device,
            }
        m["breaker"] = self.breaker.stats_dict()
        m["store"] = self.store.stats_dict()
        m["journal"] = self.journal.stats_dict()
        return m


# --------------------------------------------------------------------- #
# HTTP front
# --------------------------------------------------------------------- #
class _Job:
    __slots__ = ("query", "event", "result")

    def __init__(self, query: dict) -> None:
        self.query = query
        self.event = threading.Event()
        self.result: Optional[dict] = None


def _make_handler(service: MappingService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A003 - silence stdlib
            log.debug("http: " + fmt, *args)

        def _send(self, code: int, payload: dict,
                  headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib casing
            if self.path == "/healthz":
                self._send(200, {"ok": True, "draining": service.draining})
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            else:
                self._send(404, {"ok": False, "error": "not found"})

        def do_POST(self):  # noqa: N802 - stdlib casing
            if self.path != "/v1/mapping":
                self._send(404, {"ok": False, "error": "not found"})
                return
            if service.draining:
                self._send(
                    503,
                    {"ok": False, "error": "draining"},
                    {"Retry-After": "5"},
                )
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                q = json.loads(self.rfile.read(n) or b"{}")
            except Exception:
                self._send(400, {"ok": False, "error": "bad JSON body"})
                return
            job = _Job(q)
            try:
                service.jobs.put_nowait(job)
            except queue.Full:
                # explicit backpressure: shed with Retry-After instead of
                # queueing unboundedly and timing every caller out
                with service._state_lock:
                    service.shed += 1
                self._send(
                    429,
                    {
                        "ok": False,
                        "error": "admission queue full",
                        "queue_depth": service.jobs.qsize(),
                    },
                    {"Retry-After": "1"},
                )
                return
            # generous wall-clock guard: the worker enforces the real
            # per-query deadline and ALWAYS sets the event
            wait_s = (service.default_deadline_s or 30.0) * 4 + 60.0
            if not job.event.wait(wait_s):
                self._send(504, {"ok": False, "error": "worker stalled"})
                return
            env = job.result or {"ok": False, "error": "no result"}
            self._send(200 if env.get("ok") else 400, env)

    return Handler


def serve(service: MappingService, host: str = "127.0.0.1", port: int = 0):
    """Bind the HTTP front and start the worker pool; returns the
    (already listening, not yet serving) server -- call
    ``serve_forever`` on it (typically in a thread)."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    httpd.daemon_threads = True
    service.start_workers()
    return httpd


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="mapping-as-a-service daemon"
    )
    ap.add_argument("--state-dir", required=True,
                    help="ResultStore + answer-journal directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks an ephemeral port (see --ready-file)")
    ap.add_argument("--backend", default="torch", choices=BACKENDS,
                    help="the engine's array backend (torch, the default: "
                         "float64 programs on --device; numpy: on the host)")
    ap.add_argument("--device", default="cuda",
                    help="the torch backend's device (cuda, the default, "
                         "raises without a card; cpu)")
    ap.add_argument("--deadline-s", type=float, default=5.0,
                    help="default per-query deadline (<=0 disables)")
    ap.add_argument("--queue-cap", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--store-cap", type=int, default=None)
    ap.add_argument("--breaker-threshold", type=int, default=2)
    ap.add_argument("--probe-interval", type=int, default=2)
    ap.add_argument("--fault-spec", default=None,
                    help="overrides UNION_FAULT_SPEC (jaxfail:Q / slow:Q@K:S)")
    ap.add_argument("--ready-file", default=None,
                    help="write {port, pid} JSON here once listening")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    service = MappingService(
        args.state_dir,
        backend=args.backend,
        device=args.device,
        deadline_s=args.deadline_s if args.deadline_s > 0 else None,
        queue_cap=args.queue_cap,
        workers=args.workers,
        store_cap=args.store_cap,
        breaker_threshold=args.breaker_threshold,
        probe_interval=args.probe_interval,
        fault_spec=args.fault_spec,
    )
    httpd = serve(service, args.host, args.port)
    host, port = httpd.server_address[:2]
    log.info("mapping service listening on %s:%d (state %s)",
             host, port, args.state_dir)
    stop = threading.Event()

    def on_signal(signum, frame):  # noqa: ARG001
        log.warning("signal %d: draining", signum)
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    # handlers are live before the ready file appears: a supervisor that
    # signals the instant it sees readiness still gets the graceful drain
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"port": port, "pid": os.getpid()}, f)
        os.replace(tmp, args.ready_file)

    th = threading.Thread(target=httpd.serve_forever, daemon=True,
                          name="mapsvc-http")
    th.start()
    stop.wait()
    # graceful drain: reject new queries, answer + journal everything
    # already admitted, flush, exit 0 -- a SIGKILL instead of this path
    # loses at most the in-flight search (re-run warm after restart),
    # never a journaled answer
    service.draining = True
    service.drain()
    httpd.shutdown()
    th.join(timeout=5.0)
    log.info("drained; final metrics: %s", json.dumps(service.metrics()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
