"""Persistent cross-search result store.

Figure sweeps (fig3/fig8/fig10/fig11) and ``mappers_bench`` re-run searches
over the same (problem, arch, cost model) spaces -- across aspect ratios,
bandwidth points, repeats, and whole benchmark invocations -- and a large
fraction of the signatures they score are identical between runs. The
:class:`ResultStore` memoizes ``signature -> Cost`` ACROSS searches and
(optionally) across processes:

  * **in-memory tier** -- a dict per *space key*, always on;
  * **on-disk tier** -- one versioned JSON file per space key under a
    directory, loaded lazily on first probe and written by :meth:`flush`
    (atomic tmp+rename under an advisory per-space lock). JSON, not
    pickle: a store directory is meant to be shared (between processes,
    or as a CI cache artifact), and loading it must never be a
    code-execution surface -- the records are plain numbers + a
    ``str -> float`` breakdown dict. Corrupt, truncated, or
    version-mismatched files are ignored (counted, never raised) and
    rewritten on the next flush.

The **space key** digests everything that determines a Cost besides the
mapping signature: problem dims/data-space projections/unit op, every
cost-relevant cluster attribute of the architecture, and the cost model's
``store_key_parts()``. Problem and architecture *names* that do not affect
scoring are excluded, so identical shapes share entries; cluster names ARE
included because they appear in Cost breakdown keys.

Correctness: a store hit returns the exact Cost an evaluation would have
produced (same engine, deterministic models), so search results are
unchanged -- only the ``pruned``/``analyzed`` counter split can shift,
because a stored candidate is served before the admission filter runs.
``SearchResult.considered`` (candidates submitted by the mapper) is the
warm/cold-INVARIANT total to compare runs by; throughput reporting
excludes store-served candidates from its denominator for the same
reason (see ``benchmarks/mappers_bench.py``).

Eviction: with ``max_entries_per_space`` set, each space is an LRU --
``get`` refreshes recency, the in-memory tier evicts past the cap, and
``flush`` compacts the disk tier to the cap AFTER the concurrent-writer
union (prior-file entries rank least recent), so the newest entries
survive and another writer's fresh results are never silently dropped
below the cap.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import math
import os
import time
import uuid
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

import numpy as np

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platform
    fcntl = None

from repro_torch.core.architecture import Architecture
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.problem import Problem

log = logging.getLogger("repro_torch.store")

# Bump whenever the Cost record layout or any scoring semantics change in a
# way older entries cannot represent: mismatched files are discarded whole.
STORE_VERSION = 1

# Journal file format version (see SweepJournal); independent of the Cost
# record layout so store entries survive journal-schema changes.
JOURNAL_VERSION = 1


def _canon_num(v):
    """Canonical digest form for a (possibly numpy) numeric attribute.

    ``repr`` forks the key between equal values of different types --
    ``repr(np.float64(2.0))`` is ``'np.float64(2.0)'`` on numpy>=2 while
    ``repr(2.0)`` is ``'2.0'`` -- silently orphaning disk entries between
    writers that load the same architecture through different code paths.
    Numerics are therefore collapsed to plain Python ints/floats before
    the JSON digest, with explicit ``'inf'``/``'-inf'``/``'nan'`` string
    encodings (JSON has no literal for them). Non-numeric values keep
    their repr.
    """
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if math.isinf(f):
            return "inf" if f > 0 else "-inf"
        if math.isnan(f):
            return "nan"
        return f
    return repr(v)


def _canon_problem(problem: Problem) -> dict:
    return {
        "dims": [(d, _canon_num(s)) for d, s in problem.dims.items()],
        "operation": problem.operation,
        "unit_op": problem.unit_op,
        "data_spaces": [
            {
                "name": ds.name,
                "out": ds.is_output,
                "wb": _canon_num(ds.word_bytes),
                "proj": [
                    [(_canon_num(t.coeff), t.dim) for t in expr.terms]
                    for expr in ds.projection
                ],
            }
            for ds in problem.data_spaces
        ],
    }


def _canon_arch(arch: Architecture) -> dict:
    return {
        "freq": _canon_num(arch.frequency_hz),
        "attrs": sorted((k, _canon_num(v)) for k, v in arch.attrs.items()),
        "clusters": [
            [
                c.name,  # appears in Cost breakdown keys
                _canon_num(c.fanout),
                c.dimension,
                _canon_num(c.memory_bytes),
                _canon_num(c.fill_bandwidth),
                _canon_num(c.read_energy),
                _canon_num(c.write_energy),
                _canon_num(c.macs_per_cycle),
                _canon_num(c.mac_energy),
            ]
            for c in arch.clusters
        ],
    }


def space_key(cost_model: CostModel, problem: Problem, arch: Architecture) -> str:
    """Stable digest of the (cost model, problem, arch) triple."""
    desc = json.dumps(
        {
            "version": STORE_VERSION,
            "model": [repr(p) for p in cost_model.store_key_parts()],
            "problem": _canon_problem(problem),
            "arch": _canon_arch(arch),
        },
        sort_keys=True,
        default=repr,
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:32]


def _cost_to_record(c: Cost) -> list:
    return [
        c.latency_cycles,
        c.energy_pj,
        c.utilization,
        c.macs,
        c.frequency_hz,
        dict(c.breakdown),
    ]


def _cost_from_record(rec) -> Cost:
    latency, energy, util, macs, freq, breakdown = rec
    return Cost(
        latency_cycles=latency,
        energy_pj=energy,
        utilization=util,
        macs=macs,
        frequency_hz=freq,
        breakdown=breakdown,
    )


def _sig_to_key(sig) -> str:
    """Canonical signature tuple -> stable JSON string (dict key form)."""
    return json.dumps(sig, separators=(",", ":"))


def _sig_from_key(s: str):
    """Inverse of :func:`_sig_to_key`: rebuild the exact nested tuples."""
    return tuple(
        (tuple(order), tuple(tt), tuple(st)) for order, tt, st in json.loads(s)
    )


def _model_digest(cost_model: CostModel) -> str:
    return hashlib.sha256(
        json.dumps([repr(p) for p in cost_model.store_key_parts()]).encode()
    ).hexdigest()[:16]


def _arch_digest(arch: Architecture) -> str:
    return hashlib.sha256(
        json.dumps(_canon_arch(arch), sort_keys=True, default=repr).encode()
    ).hexdigest()[:16]


def _problem_features(problem: Problem) -> dict:
    """Content features of a problem for nearest-neighbor space lookup.

    Dim NAMES are deliberately dropped: a 512x512x256 GEMM should be a
    near neighbor of a conv whose iteration space factors the same way,
    because what transfers between spaces is the *scale* of the search
    landscape, not the labels. Sorted log2 sizes make the vector
    permutation-invariant; macs (= iteration-space volume) rides along
    for incumbent scaling at the call site.
    """
    sizes = sorted(max(int(s), 1) for s in problem.dims.values())
    macs = 1.0
    for s in sizes:
        macs *= float(s)
    return {
        "ndims": len(sizes),
        "logdims": [round(math.log2(s), 6) for s in sizes],
        "macs": macs,
    }


def _feature_distance(a: dict, b: dict) -> float:
    """L2 over aligned sorted log2-size vectors + a rank-mismatch penalty.

    Vectors are right-aligned (largest dims paired with largest) and the
    shorter one zero-padded on the left, so a GEMM and a conv with the
    same dominant extents land close while a genuinely different scale
    stays far. Deterministic: pure arithmetic on stored floats.
    """
    la, lb = list(a["logdims"]), list(b["logdims"])
    n = max(len(la), len(lb))
    la = [0.0] * (n - len(la)) + la
    lb = [0.0] * (n - len(lb)) + lb
    d2 = sum((x - y) ** 2 for x, y in zip(la, lb))
    d2 += 4.0 * (a["ndims"] - b["ndims"]) ** 2
    return math.sqrt(d2)


class ResultStore:
    """Cross-search ``(space key, signature) -> Cost`` store.

    One instance is shared across every search of a benchmark sweep (pass
    it to ``union_opt(result_store=...)``); the engine probes it on memo
    misses and feeds every fresh evaluation back. Thread-compatibility
    matches the engine's (single-threaded use per store).

    ``max_entries_per_space`` caps both tiers per space key: the
    in-memory tier evicts least-recently-used entries as it grows past
    the cap (``get`` refreshes recency), and :meth:`flush` compacts the
    disk tier to the cap AFTER unioning with the on-disk file -- prior
    entries another writer flushed rank as least recent, then this
    store's entries in LRU order, and the newest ``cap`` survive. With
    the default (None) both tiers grow without bound, as before.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        max_entries_per_space: Optional[int] = None,
        refresh: bool = False,
    ) -> None:
        self.path = Path(path) if path else None
        self.max_entries_per_space = (
            int(max_entries_per_space) if max_entries_per_space else None
        )
        # read-refresh mode for LONG-LIVED processes (the mapping-service
        # daemon): a get() miss re-stats the space's on-disk file and, when
        # another process's flush has bumped its mtime since our load,
        # reloads and unions the new entries -- daemon warm hits see
        # sweep-written results without a restart. Off by default: batch
        # sweeps load each space once and the extra stat per miss would be
        # pure overhead.
        self.refresh = bool(refresh)
        self._spaces: Dict[str, "OrderedDict[object, Cost]"] = {}
        self._loaded: set = set()  # space keys whose disk tier was read
        self._dirty: set = set()
        self._space_mtime: Dict[str, float] = {}  # disk mtime at last read
        self._meta: Dict[str, dict] = {}  # space key -> problem/arch features
        self._meta_loaded = False
        self._meta_dirty = False
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.disk_loaded = 0  # entries brought in from disk
        self.corrupt = 0  # unreadable or version-mismatched files skipped
        self.evicted = 0  # entries dropped by the per-space LRU cap
        self.stale_tmps = 0  # crashed writers' scratch files cleaned at flush
        self.reloads = 0  # read-refresh reloads of an mtime-bumped space

    # -------------------------------------------------------------- #
    def space_key(
        self, cost_model: CostModel, problem: Problem, arch: Architecture
    ) -> str:
        return space_key(cost_model, problem, arch)

    def _trim(self, d: "OrderedDict[object, Cost]") -> None:
        cap = self.max_entries_per_space
        if cap is not None:
            while len(d) > cap:
                d.popitem(last=False)  # least recently used first
                self.evicted += 1

    def _read_disk_tier(self, skey: str, d: "OrderedDict[object, Cost]") -> None:
        """Read ``{skey}.json`` and union its entries into ``d`` (existing
        signatures keep their in-memory Cost -- identical by construction).
        Records the file's mtime so the read-refresh probe can tell when
        another process's flush has replaced it."""
        f = self.path / f"{skey}.json"
        try:
            self._space_mtime[skey] = f.stat().st_mtime
        except OSError:
            self._space_mtime[skey] = 0.0  # absent: any future flush is news
        try:
            payload = json.loads(f.read_text())
            if (
                isinstance(payload, dict)
                and payload.get("version") == STORE_VERSION
            ):
                for key, rec in payload["costs"].items():
                    sig = _sig_from_key(key)
                    if sig not in d:
                        d[sig] = _cost_from_record(rec)
                        self.disk_loaded += 1
                self._trim(d)
            else:
                self.corrupt += 1  # stale version: discard, rewrite later
        except FileNotFoundError:
            pass
        except Exception:
            self.corrupt += 1  # truncated/garbled file: start fresh

    def _space(self, skey: str) -> "OrderedDict[object, Cost]":
        d = self._spaces.get(skey)
        if d is None:
            d = self._spaces[skey] = OrderedDict()
        if self.path is not None and skey not in self._loaded:
            self._loaded.add(skey)
            self._read_disk_tier(skey, d)
        return d

    def _maybe_reload(self, skey: str, d: "OrderedDict[object, Cost]") -> bool:
        """Read-refresh probe: re-stat the space file and reload when its
        mtime moved past our last read (another process flushed). Returns
        True when a reload actually happened."""
        if self.path is None or skey not in self._loaded:
            return False
        try:
            mtime = (self.path / f"{skey}.json").stat().st_mtime
        except OSError:
            return False
        if mtime <= self._space_mtime.get(skey, 0.0):
            return False
        self.reloads += 1
        self._read_disk_tier(skey, d)
        return True

    def get(self, skey: str, sig) -> Optional[Cost]:
        d = self._space(skey)
        c = d.get(sig)
        if c is None and self.refresh and self._maybe_reload(skey, d):
            c = d.get(sig)
        if c is None:
            self.misses += 1
        else:
            d.move_to_end(sig)  # LRU touch
            self.hits += 1
        return c

    def put(self, skey: str, sig, cost: Cost) -> None:
        d = self._space(skey)
        if sig not in d:
            d[sig] = cost
            self.puts += 1
            self._dirty.add(skey)
            self._trim(d)

    # -------------------------------------------------------------- #
    # Space metadata: nearest-neighbor warm start
    # -------------------------------------------------------------- #
    def _load_meta(self) -> None:
        if self._meta_loaded:
            return
        self._meta_loaded = True
        if self.path is None:
            return
        try:
            payload = json.loads((self.path / "_meta.json").read_text())
            if (
                isinstance(payload, dict)
                and payload.get("version") == STORE_VERSION
            ):
                for skey, rec in payload.get("spaces", {}).items():
                    self._meta.setdefault(skey, rec)
            else:
                self.corrupt += 1
        except FileNotFoundError:
            pass
        except Exception:
            self.corrupt += 1  # tolerated like a garbled space file

    def register_space_meta(
        self, skey: str, cost_model: CostModel, problem: Problem, arch: Architecture
    ) -> None:
        """Record the content features of a space so later queries can find
        it as a nearest neighbor. Idempotent; persisted by :meth:`flush`."""
        self._load_meta()
        if skey in self._meta:
            return
        rec = dict(_problem_features(problem))
        rec["model"] = _model_digest(cost_model)
        rec["arch"] = _arch_digest(arch)
        self._meta[skey] = rec
        self._meta_dirty = True

    def nearest_space(
        self,
        cost_model: CostModel,
        problem: Problem,
        arch: Architecture,
        exclude: Optional[str] = None,
    ) -> Optional[tuple]:
        """Nearest registered space to ``problem`` under the SAME cost model
        and architecture (costs from a different model or machine are not
        comparable, so they never seed an incumbent). Returns
        ``(skey, distance)`` or None; ties break on skey for determinism.
        """
        self._load_meta()
        model, ad = _model_digest(cost_model), _arch_digest(arch)
        q = _problem_features(problem)
        best = None
        for skey in sorted(self._meta):
            if skey == exclude:
                continue
            rec = self._meta[skey]
            if rec.get("model") != model or rec.get("arch") != ad:
                continue
            try:
                dist = _feature_distance(q, rec)
            except Exception:
                continue  # malformed record from a foreign writer
            if best is None or dist < best[1]:
                best = (skey, dist)
        return best

    def space_meta(self, skey: str) -> Optional[dict]:
        self._load_meta()
        rec = self._meta.get(skey)
        return dict(rec) if rec is not None else None

    def best_in_space(self, skey: str, metric: str) -> Optional[float]:
        """Minimum stored ``Cost.metric(metric)`` over a space (loads the
        disk tier), or None when the space is empty/unknown."""
        d = self._space(skey)
        best = None
        for c in d.values():
            try:
                v = float(c.metric(metric))
            except Exception:
                continue
            if math.isfinite(v) and (best is None or v < best):
                best = v
        return best

    # -------------------------------------------------------------- #
    @contextlib.contextmanager
    def _store_lock(self):
        """Advisory exclusive lock serializing read-merge-replace across
        processes (POSIX flock; no-op where unavailable). One lock file
        per DIRECTORY, deliberately never unlinked: unlink-and-recreate
        races would break flock's mutual exclusion, and a single constant
        file cannot litter a long-lived shared store."""
        if fcntl is None:
            yield
            return
        with open(self.path / ".store.lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _clean_stale_tmps(self) -> int:
        """Remove scratch ``.tmp`` files a crashed writer left behind.

        Every tmp is created and renamed away UNDER the directory lock, so
        any tmp visible at lock acquisition belongs to a writer that died
        between write and rename -- a crash window that must not
        accumulate litter in a long-lived shared store. Where flock is
        unavailable (non-POSIX, so writers are not serialized) only tmps
        older than 60s are removed, keeping a live writer's in-flight
        scratch file safe. Returns the number of files removed (also
        accumulated in ``stale_tmps``)."""
        removed = 0
        try:
            candidates = list(self.path.glob(".*.tmp"))
        except OSError:
            return 0
        now = time.time()
        for tmp in candidates:
            try:
                if fcntl is None and now - tmp.stat().st_mtime < 60.0:
                    continue
                tmp.unlink()
                removed += 1
            except OSError:
                pass  # already gone (or unreadable): someone else cleaned it
        if removed:
            self.stale_tmps += removed
            log.warning("result store %s: cleaned %d stale tmp file(s) left "
                        "by crashed writer(s)", self.path, removed)
        return removed

    def flush(self) -> int:
        """Write dirty spaces to the disk tier as ONE atomic write pass:
        the directory lock is acquired once and every dirty space is
        merged and atomically replaced under it -- a figure sweep touching
        many (problem, arch, model) spaces pays one lock round-trip
        instead of one per space, and no interleaving writer can observe
        (or race into) a half-flushed set of spaces. Returns the number of
        entries persisted. No-op without a path.

        Concurrent writers sharing a directory are lossless: under the
        lock, each space's on-disk file is re-read and UNIONED with the
        in-memory view right before its atomic replace, so entries another
        process flushed since our lazy load are preserved (identical keys
        are identical Costs by construction, so merge order is
        immaterial) -- including writers whose dirty sets cover DIFFERENT
        spaces (disjoint files never collide; shared ones union).

        With ``max_entries_per_space`` set, the merged union is LRU-
        compacted to the cap before the replace: prior-file entries not
        in memory rank least recent (in their file order, i.e. the other
        writer's LRU order), this store's entries follow in local LRU
        order, and only the newest ``cap`` survive -- so eviction composes
        with the union guarantee instead of clobbering it."""
        if self.path is None:
            self._dirty.clear()
            self._meta_dirty = False
            return 0
        dirty = sorted(self._dirty)
        if not dirty and not self._meta_dirty:
            return 0
        self.path.mkdir(parents=True, exist_ok=True)
        cap = self.max_entries_per_space
        written = 0
        with self._store_lock():
            self._clean_stale_tmps()
            if self._meta_dirty:
                self._flush_meta_locked()
            for skey in dirty:
                d = self._spaces[skey]
                mem = {_sig_to_key(sig): _cost_to_record(c) for sig, c in d.items()}
                merged: "OrderedDict[str, object]" = OrderedDict()
                try:
                    prior = json.loads((self.path / f"{skey}.json").read_text())
                    if (
                        isinstance(prior, dict)
                        and prior.get("version") == STORE_VERSION
                    ):
                        for key, rec in prior["costs"].items():
                            if key not in mem:
                                merged[key] = rec
                except Exception:
                    pass  # absent/corrupt prior file: nothing to merge
                merged.update(mem)  # in-memory LRU order, most recent last
                if cap is not None and len(merged) > cap:
                    drop = len(merged) - cap
                    for key in list(merged)[:drop]:
                        del merged[key]
                        self.evicted += 1
                payload = {"version": STORE_VERSION, "costs": dict(merged)}
                # writer-unique tmp name: scratch files are never shared
                # even if a non-POSIX platform skipped the lock
                tmp = self.path / f".{skey}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
                tmp.write_text(json.dumps(payload, separators=(",", ":")))
                target = self.path / f"{skey}.json"
                tmp.replace(target)
                written += len(merged)
                # our own replace bumped the mtime; record it so the
                # read-refresh probe doesn't reload what we just wrote
                try:
                    self._space_mtime[skey] = target.stat().st_mtime
                except OSError:
                    pass
        self._dirty.clear()
        return written

    def _flush_meta_locked(self) -> None:
        """Merge + atomically replace ``_meta.json``; caller holds the
        directory lock. Prior records from other writers are preserved
        (identical skeys describe identical spaces, so merge order is
        immaterial)."""
        merged: Dict[str, dict] = {}
        try:
            prior = json.loads((self.path / "_meta.json").read_text())
            if isinstance(prior, dict) and prior.get("version") == STORE_VERSION:
                merged.update(prior.get("spaces", {}))
        except Exception:
            pass  # absent/corrupt prior meta: rewrite from memory
        merged.update(self._meta)
        payload = {"version": STORE_VERSION, "spaces": merged}
        tmp = self.path / f"._meta.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        tmp.write_text(json.dumps(payload, sort_keys=True, separators=(",", ":")))
        tmp.replace(self.path / "_meta.json")
        self._meta = merged
        self._meta_dirty = False

    def stats_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "disk_loaded": self.disk_loaded,
            "corrupt": self.corrupt,
            "evicted": self.evicted,
            "stale_tmps": self.stale_tmps,
            "reloads": self.reloads,
            "spaces": len(self._spaces),
            "entries": sum(len(d) for d in self._spaces.values()),
        }

    def __enter__(self) -> "ResultStore":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()


# --------------------------------------------------------------------- #
# Sweep journal (crash-safe resume)
# --------------------------------------------------------------------- #
class SweepJournal:
    """Crash-safe progress journal for one named sweep.

    The concurrent sweep executor (``repro_torch.core.sweep_exec``) records every
    completed task's SOLUTION RECORD (mapping dict + Cost record + search
    stats -- the exact data a solution is rebuilt from) keyed by a stable
    task fingerprint, plus per-group attempt counts. A sweep killed
    mid-flight and restarted with ``resume=True`` replays the journaled
    records verbatim -- completed groups are skipped entirely, in-flight
    groups re-run warm against the shared :class:`ResultStore` -- so the
    restarted sweep's outputs match an uninterrupted run's.

    File layout (single JSON file, usually next to the store's space
    files)::

        {"version": 1,
         "groups": {group_key: {"attempts": int, "done": bool}},
         "tasks":  {fingerprint: <opaque solution record>}}

    Flush discipline matches :meth:`ResultStore.flush`: writer-unique tmp
    + atomic rename under an advisory flock (``<journal>.lock``), stale
    ``.jtmp`` scratch files cleaned under the lock. The journal is
    flushed at every group START (attempts survive a crash, so "fail
    group N on attempt K" fault specs stay deterministic across restarts)
    and at every group COMPLETION -- a SIGKILL can lose at most the
    in-flight group's work, never corrupt the file.

    A journal opened without ``resume`` IGNORES any existing file and
    starts fresh (first flush replaces it): attempts and done flags from
    an unrelated earlier sweep must not leak into a new cold run.
    Corrupt or version-mismatched files are discarded (counted in
    ``corrupt``), mirroring the store's tolerance.
    """

    def __init__(self, path, resume: bool = False) -> None:
        self.path = Path(path)
        self.groups: Dict[str, dict] = {}
        self.tasks: Dict[str, object] = {}
        self.corrupt = 0
        self.resumed = False  # a prior journal was actually loaded
        if resume:
            try:
                payload = json.loads(self.path.read_text())
                if (
                    isinstance(payload, dict)
                    and payload.get("version") == JOURNAL_VERSION
                ):
                    self.groups = dict(payload.get("groups", {}))
                    self.tasks = dict(payload.get("tasks", {}))
                    self.resumed = True
                else:
                    self.corrupt += 1
            except FileNotFoundError:
                pass  # nothing to resume: behaves like a fresh journal
            except Exception:
                self.corrupt += 1

    # -------------------------------------------------------------- #
    def group_attempts(self, gkey: str) -> int:
        return int(self.groups.get(gkey, {}).get("attempts", 0))

    def group_done(self, gkey: str) -> bool:
        return bool(self.groups.get(gkey, {}).get("done", False))

    def note_group_start(self, gkey: str) -> None:
        g = self.groups.setdefault(gkey, {"attempts": 0, "done": False})
        g["attempts"] = int(g["attempts"]) + 1
        self.flush()

    def record_group(self, gkey: str, records: Dict[str, object]) -> None:
        """Mark ``gkey`` complete with its tasks' solution records."""
        self.tasks.update(records)
        g = self.groups.setdefault(gkey, {"attempts": 0, "done": False})
        g["done"] = True
        self.flush()

    def get_task(self, fingerprint: str):
        return self.tasks.get(fingerprint)

    # -------------------------------------------------------------- #
    @contextlib.contextmanager
    def _lock(self):
        """Advisory flock on ``<journal>.lock`` (constant file, never
        unlinked -- same rationale as the store's directory lock)."""
        if fcntl is None:
            yield
            return
        with open(self.path.with_name(self.path.name + ".lock"), "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "version": JOURNAL_VERSION,
            "groups": self.groups,
            "tasks": self.tasks,
        }
        with self._lock():
            now = time.time()
            for tmp in self.path.parent.glob(f".{self.path.name}.*.jtmp"):
                try:
                    if fcntl is None and now - tmp.stat().st_mtime < 60.0:
                        continue
                    tmp.unlink()  # crashed writer's scratch: clean it
                except OSError:
                    pass
            tmp = self.path.with_name(
                f".{self.path.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.jtmp"
            )
            tmp.write_text(json.dumps(payload, separators=(",", ":")))
            tmp.replace(self.path)

    def stats_dict(self) -> dict:
        return {
            "groups": len(self.groups),
            "groups_done": sum(1 for g in self.groups.values() if g.get("done")),
            "tasks": len(self.tasks),
            "corrupt": self.corrupt,
            "resumed": self.resumed,
        }
