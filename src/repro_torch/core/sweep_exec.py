"""Fault-tolerant concurrent executor for ``union_opt_sweep`` (the port's
copy of ``repro/core/sweep_exec.py``, on the numpy and torch engines).

``union_opt_sweep`` groups its tasks by persistent-store space key; since
the array-native engine rework the groups are INDEPENDENT by construction
(each owns one :class:`EvaluationEngine`, shares nothing but the
concurrent-writer-safe :class:`ResultStore`). This module turns that
independence into a service-grade execution tier:

* **Concurrent dispatch** -- groups run on a worker pool. ``pool="thread"``
  keeps every engine in-process (shared memo/ctx, but GIL-bound on the
  numpy path); ``pool="process"`` (the default for ``workers > 1``) spawns
  fresh interpreters per group dispatch -- a child imports numpy and
  ``repro_torch.core``/``repro_torch.runtime``, never jax, and torch only
  for an engine on the torch backend; each
  child opens its own ResultStore handle on the shared directory, and the
  store's union-on-flush merges results losslessly.

* **Failure handling** -- every group dispatch is wrapped in
  :func:`repro_torch.runtime.fault_tolerance.retry_call`: a per-attempt
  ``group_timeout_s`` watchdog (hung trace/dispatch -> the attempt is
  abandoned and re-run), bounded retries with exponential backoff and
  deterministic jitter, and a straggler meter over group wall-clocks.
  A failed attempt may already have flushed fresh Costs to the store;
  re-running is safe because scoring is deterministic and the store is
  idempotent.

* **Graceful backend degradation** -- a torch failure inside a group
  (import, device or dispatch) does NOT consume a retry: the engine
  itself degrades to the numpy batch path mid-search
  (:meth:`EvaluationEngine._check_backend_degraded`), bit-identical by
  the backend contract, counted in ``backend_fallbacks``.

* **Counted pool degradation** -- a process pool that cannot take a
  group (a broken pool, a payload that does not pickle, an engine pool
  that cannot be built) runs the work in-process, as the reference does;
  each such fallback is counted in the sweep's ``pool_failed`` and logged,
  so a run can assert that none happened.

* **Crash-safe resume** -- with a :class:`SweepJournal`, every completed
  group's solution records (mapping + cost + search counters) are flushed
  atomically; a SIGKILL'd sweep restarted with ``resume=True`` replays
  finished groups from the journal and re-runs only the rest, warm
  against the store. ALL solutions -- fresh or replayed -- round-trip
  through the same JSON record form, so a resumed sweep's outputs are
  identical to an uninterrupted run's by construction.

* **Deterministic fault injection** -- ``UNION_FAULT_SPEC`` (or the
  ``fault_spec=`` argument) drives every failure path on CPU in CI::

      fail:G@K          raise on group G (first-occurrence order),
                        attempt K (0-based)
      hang:G@K[:SECS]   group G attempt K sleeps SECS (default 5.0)
                        inside the watchdogged region, BEFORE any work --
                        models a wedged dispatch (nothing completes)
      slow:G@K[:SECS]   group G attempt K takes SECS (default 1.0) of
                        EXTRA latency spread evenly across its tasks --
                        work completes, just slowly, so deadline-with-
                        partial-result paths (the mapping service's
                        ``budget_exhausted`` answers) are testable
                        deterministically
      jaxfail:G         the reference's grammar for "group G's array
                        backend fails": its analysis context reports a
                        torch failure -> the engine degrades to numpy
      kill-after:N      SIGKILL this process right after the Nth
                        completed group's Costs are flushed to the store
                        but BEFORE its journal record -- the worst crash
                        ordering; a resumed sweep replays N-1 groups and
                        re-runs the Nth warm against the store

Clauses are ``;``-separated, e.g. ``"fail:1@0;hang:2@0:3;kill-after:2"``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import logging
import os
import pickle
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost.engine import EvaluationEngine
from repro_torch.core.cost.store import (
    ResultStore,
    SweepJournal,
    _cost_from_record,
    _cost_to_record,
    space_key,
)
from repro_torch.core.mappers import MAPPER_REGISTRY
from repro_torch.core.mappers.base import Mapper, SearchResult
from repro_torch.core.mapping import Mapping
from repro_torch.core.mapspace import MapSpace
from repro_torch.runtime.fault_tolerance import (
    CallTimeoutError,
    RetryPolicy,
    RetryStats,
    StragglerMeter,
    call_with_deadline,
    retry_call,
)

log = logging.getLogger("repro_torch.sweep")


# --------------------------------------------------------------------- #
# Fault-injection spec
# --------------------------------------------------------------------- #
@dataclass
class FaultSpec:
    """Parsed ``UNION_FAULT_SPEC`` (see module docstring for grammar)."""

    fails: Dict[Tuple[int, int], bool] = field(default_factory=dict)
    hangs: Dict[Tuple[int, int], float] = field(default_factory=dict)
    slows: Dict[Tuple[int, int], float] = field(default_factory=dict)
    jaxfail: frozenset = frozenset()
    kill_after: Optional[int] = None

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultSpec":
        fs = cls()
        if not spec:
            return fs
        jax_groups = set()
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            kind, _, rest = clause.partition(":")
            try:
                if kind == "fail":
                    g, _, k = rest.partition("@")
                    fs.fails[(int(g), int(k))] = True
                elif kind == "hang":
                    g, _, tail = rest.partition("@")
                    k, _, secs = tail.partition(":")
                    fs.hangs[(int(g), int(k))] = float(secs) if secs else 5.0
                elif kind == "slow":
                    g, _, tail = rest.partition("@")
                    k, _, secs = tail.partition(":")
                    fs.slows[(int(g), int(k))] = float(secs) if secs else 1.0
                elif kind == "jaxfail":
                    jax_groups.add(int(rest))
                elif kind == "kill-after":
                    fs.kill_after = int(rest)
                else:
                    raise ValueError(f"unknown clause kind {kind!r}")
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"bad UNION_FAULT_SPEC clause {clause!r}: {e}"
                ) from None
        fs.jaxfail = frozenset(jax_groups)
        return fs

    def check_fail(self, group: int, attempt: int) -> None:
        if self.fails.get((group, attempt)):
            raise RuntimeError(
                f"injected failure (group {group}, attempt {attempt})"
            )

    def hang_s(self, group: int, attempt: int) -> float:
        return self.hangs.get((group, attempt), 0.0)

    def slow_s(self, group: int, attempt: int) -> float:
        return self.slows.get((group, attempt), 0.0)


# --------------------------------------------------------------------- #
# Canonical fingerprints
# --------------------------------------------------------------------- #
def _canon(obj):
    """JSON-safe canonical form: sets become sorted lists, dicts sort by
    key, dataclasses flatten to dicts -- the pieces whose ``repr`` is
    process-dependent (set iteration order under hash randomization)
    must never leak into a fingerprint."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _canon(
            {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        )
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (set, frozenset)):
        return sorted((_canon(v) for v in obj), key=repr)
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def task_fingerprint(gkey: str, problem, arch, mapper_spec, constraints,
                     tag, ordinal: int) -> str:
    """Stable cross-process fingerprint of one sweep task.

    ``ordinal`` disambiguates tasks that are otherwise identical within
    one sweep (the journal must keep one record per task slot). Problem
    and arch NAMES are included even though the space key excludes them:
    a resumed sweep must hand each record back to the task slot with the
    matching identity.
    """
    desc = json.dumps(
        {
            "gkey": gkey,
            "problem": getattr(problem, "name", ""),
            "arch": getattr(arch, "name", ""),
            "mapper": _canon(mapper_spec),
            "constraints": _canon(constraints),
            "tag": _canon(tag),
            "ordinal": ordinal,
        },
        sort_keys=True,
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:24]


# --------------------------------------------------------------------- #
# Solution records (the single form every sweep result passes through)
# --------------------------------------------------------------------- #
def result_to_record(res: SearchResult) -> dict:
    """SearchResult -> JSON-clean record. ``json`` round-trip applied
    eagerly so a record served live is type-identical (lists, not tuples)
    to one reloaded from the journal -- resumed sweeps must be
    indistinguishable from uninterrupted ones."""
    rec = {
        "mapping": res.best_mapping.to_dict(),
        "cost": _cost_to_record(res.best_cost),
        "metric": res.metric,
        "trajectory": [[int(i), float(v)] for i, v in res.trajectory],
        "counters": {
            "evaluated": res.evaluated,
            "elapsed_s": res.elapsed_s,
            "cache_hits": res.cache_hits,
            "pruned": res.pruned,
            "analyzed": res.analyzed,
            "store_hits": res.store_hits,
            "considered": res.considered,
            "fused_dispatches": res.fused_dispatches,
            "backend_fallbacks": res.backend_fallbacks,
            "n_traces": res.n_traces,
            "device_syncs": res.device_syncs,
            "admit_s": res.admit_s,
            "score_s": res.score_s,
        },
    }
    return json.loads(json.dumps(rec))


def result_from_record(rec: dict) -> SearchResult:
    c = rec["counters"]
    return SearchResult(
        best_mapping=Mapping.from_dict(rec["mapping"]),
        best_cost=_cost_from_record(rec["cost"]),
        metric=rec["metric"],
        evaluated=int(c["evaluated"]),
        elapsed_s=float(c["elapsed_s"]),
        trajectory=[(int(i), float(v)) for i, v in rec["trajectory"]],
        cache_hits=int(c["cache_hits"]),
        pruned=int(c["pruned"]),
        analyzed=int(c["analyzed"]),
        store_hits=int(c["store_hits"]),
        considered=int(c["considered"]),
        fused_dispatches=int(c["fused_dispatches"]),
        backend_fallbacks=int(c.get("backend_fallbacks", 0)),
        n_traces=int(c.get("n_traces", 0)),
        device_syncs=int(c.get("device_syncs", 0)),
        admit_s=float(c["admit_s"]),
        score_s=float(c["score_s"]),
    )


# --------------------------------------------------------------------- #
# Group payloads + the group runner (runs in-process OR in a spawned
# worker -- module-level so it pickles)
# --------------------------------------------------------------------- #
def _resolve_mapper(spec) -> Mapper:
    """``("name", kw)`` -> a FRESH mapper instance (so a retried group
    replays the exact seeded candidate stream); an already-built Mapper
    object passes through (caller-owned state, reuse documented)."""
    if isinstance(spec, Mapper):
        return spec
    name, kw = spec
    return MAPPER_REGISTRY[name](**dict(kw))


def run_group(payload: dict) -> dict:
    """Execute one engine group: build the engine, run each task's
    search, return ``{"records": {fingerprint: record}, ...}``.

    The payload is a plain dict so the same function serves the serial
    path, thread workers, and spawned processes (where it arrives
    pickled). ``store`` is a live ResultStore in-process; ``store_path``
    + ``store_cap`` instead in a child, which opens its own handle on the
    shared directory (lossless union-on-flush).
    """
    hang_s = payload.get("hang_s", 0.0)
    if hang_s > 0:
        time.sleep(hang_s)  # injected hang, inside the watchdogged region
    # injected slowness: spread across tasks so the group makes progress
    # (tasks complete, just late) instead of stalling up front like hang
    slow_per_task = payload.get("slow_s", 0.0) / max(1, len(payload["tasks"]))

    store = payload.get("store")
    own_store = False
    if store is None and payload.get("store_path"):
        store = ResultStore(
            payload["store_path"],
            max_entries_per_space=payload.get("store_cap"),
        )
        own_store = True

    problem = payload["problem"]
    arch = payload["arch"]
    cm = payload["cost_model"]
    engine = EvaluationEngine(
        cm,
        problem,
        arch,
        metric=payload["metric"],
        cache_size=payload["engine_cache"],
        prune=payload["engine_prune"],
        workers=payload["engine_workers"],
        backend=payload["engine_backend"],
        store=store,
        device=payload.get("engine_device", "cuda"),
    )
    ctx = engine._ctx
    prior_flag = ctx._torch_failed
    if payload.get("inject_jax_fail"):
        # simulate a backend failure at the shared choke point every torch
        # path funnels through; restored below so the process-global
        # context cache is not poisoned for later (non-injected) sweeps
        ctx._torch_failed = True
    warmed = 0
    records: Dict[str, dict] = {}
    try:
        for tsk in payload["tasks"]:
            if slow_per_task > 0:
                time.sleep(slow_per_task)
            mp = _resolve_mapper(tsk["mapper"])
            if payload.get("warmup", True):
                warmed += engine.warmup(mp.batch_hints())
            space = MapSpace(problem, arch, tsk["constraints"])
            res = mp.search(space, engine.cost_model, payload["metric"], engine=engine)
            if res.best_mapping is None:
                raise RuntimeError(
                    f"mapper {mp.name} found no legal mapping for {problem.name}"
                )
            records[tsk["fingerprint"]] = result_to_record(res)
    finally:
        engine.close()
        if payload.get("inject_jax_fail"):
            ctx._torch_failed = prior_flag
        if own_store and store is not None:
            store.flush()
    return {
        "records": records,
        "warmed": warmed,
        "backend_fallbacks": engine.stats.backend_fallbacks,
        "pool_failed": engine.stats.pool_failed,
        "engine_backend": engine.backend,
        # a child's store traffic would vanish with its handle; ship the
        # counters home so the parent store's stats cover the whole sweep
        "store_stats": store.stats_dict() if own_store else None,
    }


def _process_group_main(blob: bytes) -> bytes:
    """Spawned-worker entry: payloads cross the boundary pre-pickled so a
    non-picklable group fails in the PARENT (where it can fall back to
    in-process execution) instead of poisoning the pool."""
    return pickle.dumps(run_group(pickle.loads(blob)))


# --------------------------------------------------------------------- #
# The executor
# --------------------------------------------------------------------- #
@dataclass(eq=False)  # identity equality: membership tests, not content
class _Group:
    index: int                      # first-occurrence order (fault-spec id)
    gkey: str                       # journal key
    problem: object                 # canonical group objects (content-equal
    arch: object                    # across the group's tasks)
    cost_model: object
    metric: str
    tasks: List[dict] = field(default_factory=list)  # {fingerprint, mapper, constraints}
    task_slots: List[int] = field(default_factory=list)  # sweep task indices


class SweepExecutor:
    """Dispatch independent engine groups with retries, deadlines,
    straggler accounting, crash-safe journaling, and optional
    thread/process concurrency. See the module docstring for the model.
    """

    def __init__(
        self,
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
    ) -> None:
        self.engine_backend = engine_backend
        self.engine_workers = engine_workers
        self.engine_cache = engine_cache
        self.engine_prune = engine_prune
        self.store = result_store
        self.engine_device = engine_device
        self.warmup = warmup
        self.workers = max(0, int(workers))
        if pool not in ("auto", "thread", "process", "serial"):
            raise ValueError(f"unknown pool kind {pool!r}")
        self.pool_kind = pool
        self.group_timeout_s = group_timeout_s
        self.max_group_retries = max_group_retries
        self.group_backoff_s = group_backoff_s
        if journal is not None and not isinstance(journal, SweepJournal):
            journal = SweepJournal(journal, resume=resume)
        self.journal: Optional[SweepJournal] = journal
        self.fault = FaultSpec.parse(
            fault_spec if fault_spec is not None
            else os.environ.get("UNION_FAULT_SPEC")
        )
        self.retry_stats = RetryStats()
        self.meter = StragglerMeter()
        self._lock = threading.Lock()
        self._completed = 0
        self.pool_failed = 0  # groups a process pool could not take
        self._flush_store_per_group = False  # set per-mode in run()
        self.group_wall: List[dict] = []

    # -------------------------------------------------------------- #
    def _mode(self) -> str:
        if self.workers <= 1 or self.pool_kind == "serial":
            return "serial"
        if self.pool_kind == "auto":
            # measured: the numpy engine path is GIL-bound (threads give
            # ~1.0x), so processes are the load-bearing concurrency path
            return "process"
        return self.pool_kind

    @staticmethod
    def build_groups(resolved: Sequence[tuple], *, engine_backend,
                     engine_prune) -> List[_Group]:
        """Group resolved tasks ``(task, problem, cm, mapper_spec)`` by
        space key + metric + backend + prune -- the same sharing rule the
        serial sweep used, now with a stable string key for the journal
        and a first-occurrence index for fault specs."""
        groups: Dict[str, _Group] = {}
        dup_counts: Dict[str, int] = {}
        for slot, (t, problem, cm, mapper_spec) in enumerate(resolved):
            skey = space_key(cm, problem, t.arch)
            gkey = f"{skey}:{t.metric}:{engine_backend}:{engine_prune}"
            g = groups.get(gkey)
            if g is None:
                g = groups[gkey] = _Group(
                    index=len(groups), gkey=gkey, problem=problem,
                    arch=t.arch, cost_model=cm, metric=t.metric,
                )
            base_fp = task_fingerprint(
                gkey, problem, t.arch, mapper_spec, t.constraints,
                t.tag, 0,
            )
            ordinal = dup_counts.get(base_fp, 0)
            dup_counts[base_fp] = ordinal + 1
            fp = base_fp if ordinal == 0 else task_fingerprint(
                gkey, problem, t.arch, mapper_spec, t.constraints,
                t.tag, ordinal,
            )
            g.tasks.append(
                {"fingerprint": fp, "mapper": mapper_spec,
                 "constraints": t.constraints}
            )
            g.task_slots.append(slot)
        return list(groups.values())

    def _payload(self, g: _Group, attempt: int, for_process: bool) -> dict:
        p = {
            "problem": g.problem,
            "arch": g.arch,
            "cost_model": g.cost_model,
            "metric": g.metric,
            "engine_backend": self.engine_backend,
            "engine_workers": self.engine_workers,
            "engine_cache": self.engine_cache,
            "engine_prune": self.engine_prune,
            "engine_device": self.engine_device,
            "warmup": self.warmup,
            "tasks": g.tasks,
            "hang_s": self.fault.hang_s(g.index, attempt),
            "slow_s": self.fault.slow_s(g.index, attempt),
            "inject_jax_fail": g.index in self.fault.jaxfail,
        }
        if for_process:
            if self.store is not None and self.store.path is not None:
                p["store_path"] = str(self.store.path)
                p["store_cap"] = self.store.max_entries_per_space
        else:
            p["store"] = self.store
        return p

    # -------------------------------------------------------------- #
    def _attempt(self, g: _Group, attempt: int, pool) -> dict:
        """One group dispatch attempt under the deadline."""
        if pool is None:
            return call_with_deadline(
                lambda: run_group(self._payload(g, attempt, False)),
                self.group_timeout_s,
                label=f"group{g.index}",
            )
        # process pool: the deadline is enforced parent-side on the
        # future (a hung child cannot be trusted to watchdog itself); a
        # timed-out dispatch is abandoned like the thread watchdog's --
        # the worker slot frees when the child's work returns
        from concurrent.futures.process import BrokenProcessPool

        blob = pickle.dumps(self._payload(g, attempt, True))
        try:
            fut = pool.submit(_process_group_main, blob)
        except BrokenProcessPool:
            # the pool died (OOM-killed child, broken spawn) and cannot
            # recover; retrying through it would burn the whole budget, so
            # this and subsequent attempts degrade to in-process execution
            log.warning(
                "process pool broken; running group%d in-process", g.index
            )
            with self._lock:
                self.pool_failed += 1
            return call_with_deadline(
                lambda: run_group(self._payload(g, attempt, False)),
                self.group_timeout_s,
                label=f"group{g.index}",
            )
        try:
            return pickle.loads(fut.result(timeout=self.group_timeout_s))
        except cf.TimeoutError:
            fut.cancel()
            raise CallTimeoutError(
                f"group{g.index} exceeded {self.group_timeout_s}s deadline"
            ) from None

    def _dispatch(self, g: _Group, pool) -> dict:
        """Retry loop for one group; returns the group output dict."""
        label = f"group{g.index}"

        def attempt_hook(attempt: int) -> None:
            with self._lock:
                if self.journal is not None:
                    self.journal.note_group_start(g.gkey)
            self.fault.check_fail(g.index, attempt)

        t0 = time.time()
        out, _st = retry_call(
            lambda attempt: self._attempt(g, attempt, pool),
            RetryPolicy(
                max_retries=self.max_group_retries,
                deadline_s=None,  # enforced inside _attempt (pool-aware)
                backoff_s=self.group_backoff_s,
            ),
            label=label,
            attempt_hook=attempt_hook,
            stats=self.retry_stats,
        )
        wall = time.time() - t0
        with self._lock:
            child_store = out.get("store_stats")
            if child_store and self.store is not None:
                # fold a process child's store traffic into the live
                # handle so stats_dict() covers the whole sweep
                for k in ("hits", "misses", "puts", "disk_loaded",
                          "corrupt", "evicted", "stale_tmps"):
                    setattr(self.store, k,
                            getattr(self.store, k) + child_store.get(k, 0))
            straggler = self.meter.note(wall)
            if straggler:
                log.warning("%s straggled: %.2fs (avg %.2fs)",
                            label, wall, self.meter.avg())
            self.group_wall.append({
                "group": g.index,
                "tasks": len(g.tasks),
                "wall_s": round(wall, 4),
                "straggler": straggler,
                "replayed": False,
            })
            if self._flush_store_per_group and self.store is not None:
                # serial mode: persist this group's Costs before its
                # journal record, so a crash loses at most bookkeeping,
                # never scored work (thread mode defers to the end-of-
                # sweep flush -- other groups are mutating the shared
                # store concurrently; process children flush their own
                # handles at group end)
                self.store.flush()
            self._completed += 1
            if (
                self.fault.kill_after is not None
                and self._completed >= self.fault.kill_after
            ):
                # resume smoke: die in the WORST crash window -- the Nth
                # group's Costs are on disk but its journal record is
                # not, so a resumed sweep replays N-1 groups and re-runs
                # this one warm against the store
                log.warning("kill-after:%d reached -- SIGKILL",
                            self.fault.kill_after)
                os.kill(os.getpid(), signal.SIGKILL)
            if self.journal is not None:
                self.journal.record_group(g.gkey, out["records"])
        return out

    # -------------------------------------------------------------- #
    def run(self, resolved: Sequence[tuple]) -> Tuple[List[SearchResult], dict]:
        """Execute the sweep over ``resolved`` tasks (see
        :func:`build_groups` for the tuple shape). Returns per-task
        :class:`SearchResult`s in task order plus the aggregate stats
        dict ``union_opt_sweep`` reports."""
        groups = self.build_groups(
            resolved,
            engine_backend=self.engine_backend,
            engine_prune=self.engine_prune,
        )

        replayed: List[_Group] = []
        pending: List[_Group] = []
        for g in groups:
            if (
                self.journal is not None
                and self.journal.group_done(g.gkey)
                and all(
                    self.journal.get_task(t["fingerprint"]) is not None
                    for t in g.tasks
                )
            ):
                replayed.append(g)
            else:
                pending.append(g)
        if replayed:
            log.warning(
                "resume: replaying %d/%d journaled group(s), re-running %d",
                len(replayed), len(groups), len(pending),
            )

        mode = self._mode()
        self._flush_store_per_group = mode == "serial"
        outputs: Dict[int, dict] = {}
        pool = None
        driver = None
        try:
            if mode == "process" and pending:
                import multiprocessing as mp_mod

                pool = cf.ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=mp_mod.get_context("spawn"),
                )
                # a non-picklable group (caller-built mapper holding a
                # lambda, say) falls back to in-process execution rather
                # than failing the sweep
                inproc = []
                for g in pending:
                    try:
                        pickle.dumps(self._payload(g, 0, True))
                    except Exception as e:  # noqa: BLE001
                        log.warning(
                            "group%d payload not picklable (%s); running "
                            "in-process", g.index, type(e).__name__)
                        inproc.append(g)
                        self.pool_failed += 1
                procable = [g for g in pending if g not in inproc]
                driver = cf.ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="sweepdrv"
                )
                futs = {
                    driver.submit(self._dispatch, g, pool): g for g in procable
                }
                for g in inproc:
                    outputs[g.index] = self._dispatch(g, None)
                for f, g in futs.items():
                    outputs[g.index] = f.result()
            elif mode == "thread" and pending:
                driver = cf.ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="sweepdrv"
                )
                futs = {
                    driver.submit(self._dispatch, g, None): g for g in pending
                }
                for f, g in futs.items():
                    outputs[g.index] = f.result()
            else:
                for g in pending:
                    outputs[g.index] = self._dispatch(g, None)
        finally:
            if driver is not None:
                driver.shutdown(wait=False, cancel_futures=True)
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
            if self.store is not None:
                # flush even when a group ultimately fails: completed
                # groups' fresh Costs persist (flushing is not destructive)
                self.store.flush()

        # ---- assemble per-task results (everything via the record form)
        n_tasks = sum(len(g.tasks) for g in groups)
        results: List[Optional[SearchResult]] = [None] * n_tasks
        pool_failed = self.pool_failed
        warmed = 0
        backend_fallbacks = 0
        for g in groups:
            if g in replayed:
                with self._lock:
                    self.group_wall.append({
                        "group": g.index, "tasks": len(g.tasks),
                        "wall_s": 0.0, "straggler": False, "replayed": True,
                    })
                recs = {
                    t["fingerprint"]: self.journal.get_task(t["fingerprint"])
                    for t in g.tasks
                }
            else:
                out = outputs[g.index]
                pool_failed += out["pool_failed"]
                warmed += out["warmed"]
                backend_fallbacks += out["backend_fallbacks"]
                recs = out["records"]
            for slot, t in zip(g.task_slots, g.tasks):
                results[slot] = result_from_record(recs[t["fingerprint"]])

        agg = self._aggregate(results, groups, replayed, warmed,
                              backend_fallbacks, pool_failed, mode)
        return results, agg  # type: ignore[return-value]

    # -------------------------------------------------------------- #
    def _aggregate(self, results, groups, replayed, warmed,
                   backend_fallbacks, pool_failed, mode) -> dict:
        self.group_wall.sort(key=lambda r: r["group"])
        if os.environ.get("UNION_DETERMINISTIC_STATS"):
            # warm/cold-invariant subset only (see SearchResult.stats_dict)
            return {
                "tasks": len(results),
                "engines": len(groups),
                "engine_backend": self.engine_backend,
                "considered": sum(r.considered for r in results),
                "backend_fallbacks": backend_fallbacks,
                "pool_failed": pool_failed,
                "elapsed_s": 0.0,
                "evals_per_s": 0.0,
            }
        agg = {
            "tasks": len(results),
            "engines": len(groups),
            "engine_backend": self.engine_backend,
            "warmed_buckets": warmed,
            "considered": sum(r.considered for r in results),
            "analyzed": sum(r.analyzed for r in results),
            "cache_hits": sum(r.cache_hits for r in results),
            "store_hits": sum(r.store_hits for r in results),
            "pruned": sum(r.pruned for r in results),
            "fused_dispatches": sum(r.fused_dispatches for r in results),
            "n_traces": sum(r.n_traces for r in results),
            "device_syncs": sum(r.device_syncs for r in results),
            "elapsed_s": round(sum(r.elapsed_s for r in results), 4),
            # robustness ledger
            "workers": self.workers,
            "pool": mode,
            "attempts": self.retry_stats.attempts,
            "retries": self.retry_stats.retries,
            "timeouts": self.retry_stats.timeouts,
            "backend_fallbacks": backend_fallbacks,
            "pool_failed": pool_failed,
            "stragglers": self.meter.flagged,
            "replayed_groups": len(replayed),
            "group_wall": list(self.group_wall),
        }
        if self.journal is not None:
            agg["journal"] = self.journal.stats_dict()
        scored = sum(r.scored for r in results)
        agg["evals_per_s"] = (
            round(scored / agg["elapsed_s"], 1) if agg["elapsed_s"] > 0 else 0.0
        )
        return agg
