"""The port's fault-tolerant sweep executor against the JAX package's, on
the CPU (the counterpart of ``tests/test_sweep_exec.py``).

``repro_torch.core.optimizer.union_opt_sweep`` must give the same best
mappings, costs, search counters and deterministic sweep stats as
``repro``'s ``union_opt_sweep(engine_backend="numpy")``, bit for bit,
serially and on the thread and process pools; every injected fault
(fail, hang, slow) must converge to the unfaulted sweep; a journal must
resume a sweep byte-identically, SIGKILL included; and the retry core
(``repro_torch.runtime``) must behave as the reference's.

The reference's ``jaxfail:G`` clause reads here as "group G's array
backend (torch) fails": the engine degrades to numpy, bit-identical,
counted in ``backend_fallbacks`` (the two twins below). The circuit
breaker and the mapping service are held in
``tests/test_torch_mapping_service.py``.
"""

import concurrent.futures as cf
import json
import multiprocessing
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro.core.architecture import edge_accelerator as jax_edge
from repro.core.cost.store import _cost_to_record as jax_cost_record
from repro.core.optimizer import SweepTask as JaxSweepTask
from repro.core.optimizer import union_opt_sweep as jax_union_opt_sweep
from repro.core.problem import Problem as JaxProblem
from repro.core.sweep_exec import FaultSpec as JaxFaultSpec
from repro.core.sweep_exec import task_fingerprint as jax_task_fingerprint
from repro.runtime import fault_tolerance as jax_ft

from repro_torch import codesign
from repro_torch.core import sweep_exec
from repro_torch.core.cost import analysis
from repro_torch.core.architecture import edge_accelerator
from repro_torch.core.cost import ResultStore
from repro_torch.core.cost.store import SweepJournal, _cost_to_record
from repro_torch.core.optimizer import (
    COST_MODEL_REGISTRY,
    SweepTask,
    union_opt,
    union_opt_sweep,
)
from repro_torch.core.problem import Problem
from repro_torch.core.sweep_exec import FaultSpec, task_fingerprint
from repro_torch.kernels.matmul.ops import MATMUL_BF16_H100
from repro_torch.runtime import (
    CallTimeoutError,
    RetryPolicy,
    RetryStats,
    StragglerMeter,
    backoff_delay,
    call_with_deadline,
    retry_call,
)

SRC = str(Path(__file__).resolve().parent.parent / "src")
GEMMS = [(64, 64, 64), (128, 64, 32), (96, 48, 64)]
COUNTERS = ("evaluated", "considered", "analyzed", "cache_hits", "store_hits", "pruned",
            "trajectory")


def _tasks(P=Problem, T=SweepTask, edge=edge_accelerator):
    """3 groups (distinct problems) x 2 tasks each, built from either
    package; small enough that a sweep takes tenths of a second."""
    tasks = []
    for i, (m, n, k) in enumerate(GEMMS):
        p = P.gemm(m, n, k, name=f"sweepexec-g{i}")
        arch = edge(aspect=(16, 16))
        tasks.append(T(p, arch, mapper="random", cost_model="timeloop",
                       metric="edp", mapper_kw={"samples": 200}))
        tasks.append(T(p, arch, mapper="heuristic", cost_model="timeloop", metric="edp"))
    return tasks


def _shape(sweep):
    """Comparable view of a sweep's solutions: cost + mapping only."""
    return [(s.cost.edp, s.mapping.to_dict()) for s in sweep]


def _full(sweep, record):
    """Everything deterministic about a sweep's solutions: the mapping, the
    whole cost record and the search counters."""
    return [(s.mapping.to_dict(), record(s.cost), s.mapper, s.cost_model, s.metric,
             tuple(getattr(s.search, c) for c in COUNTERS)) for s in sweep]


@pytest.fixture(scope="module")
def reference():
    return jax_union_opt_sweep(_tasks(JaxProblem, JaxSweepTask, jax_edge),
                               engine_backend="numpy")


@pytest.fixture(scope="module")
def baseline():
    return union_opt_sweep(_tasks())


# ------------------------------------------------------------------ #
# bit for bit against the reference
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mode", [dict(), dict(workers=2, pool="thread"),
                                  dict(workers=2, pool="process")],
                         ids=["serial", "thread", "process"])
def test_sweep_matches_reference(reference, mode):
    sweep = union_opt_sweep(_tasks(), **mode)
    assert _full(sweep, _cost_to_record) == _full(reference, jax_cost_record)
    assert sweep.stats["pool"] == mode.get("pool", "serial")
    assert sweep.stats["pool_failed"] == 0
    for key in ("tasks", "engines", "engine_backend", "considered", "analyzed",
                "cache_hits", "store_hits", "pruned", "attempts", "retries", "timeouts",
                "replayed_groups"):
        assert sweep.stats[key] == reference.stats[key], key


@pytest.mark.parametrize("mode", [dict(), dict(workers=2, pool="thread"),
                                  dict(workers=2, pool="process")],
                         ids=["serial", "thread", "process"])
def test_torch_sweep_matches_reference(reference, mode):
    """The same sweep with every group's engine on the torch backend (on
    the CPU here; a spawned worker imports torch for it): the reference's
    numpy results bit for bit, with no fallback."""
    sweep = union_opt_sweep(_tasks(), engine_backend="torch", engine_device="cpu", **mode)
    assert _full(sweep, _cost_to_record) == _full(reference, jax_cost_record)
    st = sweep.stats
    assert st["engine_backend"] == "torch" and st["pool_failed"] == 0
    assert st["backend_fallbacks"] == 0 and st["fused_dispatches"] > 0
    for key in ("tasks", "engines", "considered", "analyzed", "cache_hits", "pruned"):
        assert st[key] == reference.stats[key], key


def test_deterministic_stats_match_reference(monkeypatch):
    monkeypatch.setenv("UNION_DETERMINISTIC_STATS", "1")
    ref = jax_union_opt_sweep(_tasks(JaxProblem, JaxSweepTask, jax_edge)[:2])
    got = union_opt_sweep(_tasks()[:2])
    # the port adds pool_failed to the run-invariant subset
    assert got.stats == {**ref.stats, "pool_failed": 0}
    assert [s.search.stats_dict() for s in got] == [s.search.stats_dict() for s in ref]
    assert "group_wall" not in got.stats and got.stats["elapsed_s"] == 0.0


def test_deterministic_stats_subset(monkeypatch):
    tasks = _tasks()[:2]
    sweep = union_opt_sweep(tasks)
    full = sweep[0].search.stats_dict()
    assert "elapsed_s" in full and "evaluated" in full
    monkeypatch.setenv("UNION_DETERMINISTIC_STATS", "1")
    det = sweep[0].search.stats_dict()  # stats_dict reads the env per call
    assert set(det) == {"considered", "backend_fallbacks", "elapsed_s", "evals_per_s"}
    assert det["considered"] == full["considered"]


_CHILD_MODULES = ("sorted(m for m in __import__('sys').modules "
                  "if m.split('.')[0] in ('torch', 'jax', 'repro', 'repro_torch'))")


def test_spawned_worker_imports_neither_torch_nor_jax(baseline):
    """A spawned sweep worker runs a whole group (unpickling the problem,
    arch and cost model, searching, returning the records) on numpy and
    ``repro_torch.core`` alone."""
    ex = sweep_exec.SweepExecutor(workers=2, pool="process")
    resolved = [(t, t.workload, COST_MODEL_REGISTRY[t.cost_model](),
                 (t.mapper, dict(t.mapper_kw))) for t in _tasks()[:2]]
    group = ex.build_groups(resolved, engine_backend="numpy", engine_prune=True)[0]
    blob = pickle.dumps(ex._payload(group, 0, True))
    with cf.ProcessPoolExecutor(max_workers=1,
                                mp_context=multiprocessing.get_context("spawn")) as pool:
        out = pickle.loads(pool.submit(sweep_exec._process_group_main, blob).result(120))
        mods = pool.submit(eval, _CHILD_MODULES).result(60)
    assert "torch" not in mods and "jax" not in mods
    assert not any(m == "repro" or m.startswith("repro.") for m in mods)
    assert "repro_torch.core.sweep_exec" in mods
    recs = [sweep_exec.result_from_record(out["records"][t["fingerprint"]])
            for t in group.tasks]
    assert [r.best_mapping.to_dict() for r in recs] == [
        s.mapping.to_dict() for s in baseline][:2]
    assert out["pool_failed"] == 0


def test_engine_workers_match_serial():
    """The engine's own process pool (``union_opt(engine_workers=)``)
    scores cache misses in spawned workers: same search, same counters."""
    p = Problem.gemm(128, 64, 32, name="pool")
    arch = edge_accelerator(aspect=(16, 16))
    serial = union_opt(p, arch, mapper="random", samples=400)
    pooled = union_opt(p, arch, mapper="random", samples=400, engine_workers=2)
    assert pooled.mapping.to_dict() == serial.mapping.to_dict()
    assert _cost_to_record(pooled.cost) == _cost_to_record(serial.cost)
    assert [getattr(pooled.search, c) for c in COUNTERS] == [
        getattr(serial.search, c) for c in COUNTERS]
    sweep = union_opt_sweep(_tasks()[:2], engine_workers=2)
    assert _shape(sweep) == _shape(union_opt_sweep(_tasks()[:2]))
    assert sweep.stats["pool_failed"] == 0


def _pool_refused_sweep():
    p = Problem.gemm(128, 64, 32, name="pool")
    arch = edge_accelerator(aspect=(16, 16))
    sweep = union_opt_sweep([SweepTask(p, arch, mapper="random", mapper_kw={"samples": 400})],
                            engine_workers=2)
    serial = union_opt(p, arch, mapper="random", samples=400)
    assert sweep.stats["pool_failed"] == 1
    assert _shape(sweep) == [(serial.cost.edp, serial.mapping.to_dict())]


def test_engine_pool_failure_is_counted(monkeypatch):
    """A payload that does not pickle leaves the engine serial, as the
    reference does quietly; the port counts it so a run can assert it did
    not."""
    from repro_torch.core.cost import engine as engine_mod

    def refuse(*a, **k):
        raise pickle.PicklingError("cannot pickle this model")

    monkeypatch.setattr(engine_mod.pickle, "dumps", refuse)
    _pool_refused_sweep()


def test_engine_pool_that_cannot_be_built_is_counted(monkeypatch):
    """Any error building the pool (here a host without the semaphores a
    process queue needs, which multiprocessing reports as ImportError)
    degrades to serial, as the reference's ``except Exception`` does, and
    is counted."""

    def refuse(*a, **k):
        raise ImportError("this platform lacks a functioning sem_open implementation")

    monkeypatch.setattr(cf, "ProcessPoolExecutor", refuse)
    _pool_refused_sweep()


# ------------------------------------------------------------------ #
# fault-spec grammar
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("spec", [
    None, "", "fail:1@0; hang:2@1:0.25; kill-after:3", "hang:0@0", "slow:1@0:0.25; slow:2@1",
    "fail:0@0;fail:0@1;hang:3@2:7;slow:4@0;kill-after:1", "jaxfail:0", "fail:1@0;jaxfail:2;jaxfail:4"])
def test_fault_spec_parse_matches_reference(spec):
    got, want = FaultSpec.parse(spec), JaxFaultSpec.parse(spec)
    assert (got.fails, got.hangs, got.slows, got.kill_after, got.jaxfail) == (
        want.fails, want.hangs, want.slows, want.kill_after, want.jaxfail)
    for g in range(5):
        for k in range(3):
            assert got.hang_s(g, k) == want.hang_s(g, k)
            assert got.slow_s(g, k) == want.slow_s(g, k)
            assert bool(got.fails.get((g, k))) == bool(want.fails.get((g, k)))


def test_fault_spec_checks():
    fs = FaultSpec.parse("fail:1@0; hang:2@1:0.25; kill-after:3")
    with pytest.raises(RuntimeError):
        fs.check_fail(1, 0)
    fs.check_fail(1, 1)  # only attempt 0 fails
    fs.check_fail(0, 0)
    assert fs.hang_s(2, 1) == 0.25 and fs.hang_s(2, 0) == 0.0
    assert FaultSpec.parse("hang:0@0").hang_s(0, 0) == 5.0
    assert FaultSpec.parse("slow:2@1").slow_s(2, 1) == 1.0
    empty = FaultSpec.parse(None)
    assert not empty.fails and not empty.hangs and not empty.slows
    assert empty.kill_after is None


@pytest.mark.parametrize("spec", ["explode:1@0", "fail:one@0", "jaxfail:zero",
                                  "fail:1@0;jaxfail:2@1"])
def test_fault_spec_rejects_bad_clause(spec):
    with pytest.raises(ValueError, match="clause"):
        FaultSpec.parse(spec)
    with pytest.raises(ValueError, match="clause"):
        JaxFaultSpec.parse(spec)


def _clear_backend_flags():
    """Re-arm the torch backend of every cached analysis context (a failure
    injected through the environment leaves its contexts flagged)."""
    for ctx in analysis._CTX_BY_CONTENT.values():
        ctx._torch_failed = False


def test_jax_failure_degrades_to_numpy_bit_identical(baseline, monkeypatch):
    """``UNION_FAULT_JAX`` breaks the torch backend at its choke point:
    every group's engine degrades to numpy, with the numpy sweep's
    mappings, costs and search counters bit for bit, one counted fallback
    per group."""
    monkeypatch.setenv("UNION_FAULT_JAX", "1")
    try:
        degraded = union_opt_sweep(_tasks(), engine_backend="torch", engine_device="cpu")
    finally:
        _clear_backend_flags()
    assert _full(degraded, _cost_to_record) == _full(baseline, _cost_to_record)
    assert degraded.stats["backend_fallbacks"] == len(degraded.stats["group_wall"]) == 3
    assert degraded.stats["engine_backend"] == "torch"  # what was REQUESTED
    assert degraded.stats["fused_dispatches"] == 0


def test_jaxfail_spec_hits_only_named_group(baseline):
    """``jaxfail:0`` flips group 0's context only: that group degrades to
    numpy (one fallback), the others run the torch programs; every result
    equals the numpy sweep's."""
    degraded = union_opt_sweep(_tasks(), engine_backend="torch", engine_device="cpu",
                               fault_spec="jaxfail:0")
    assert _full(degraded, _cost_to_record) == _full(baseline, _cost_to_record)
    assert degraded.stats["backend_fallbacks"] == 1
    fused = [s.search.fused_dispatches for s in degraded]
    assert fused[:2] == [0, 0] and all(f > 0 for f in fused[2:]), fused
    assert not any(ctx._torch_failed for ctx in analysis._CTX_BY_CONTENT.values())


# ------------------------------------------------------------------ #
# failure matrix: every injected path converges to baseline results
# ------------------------------------------------------------------ #
def test_slow_injection_completes_and_converges_to_baseline(baseline):
    t0 = time.monotonic()
    slowed = union_opt_sweep(_tasks(), fault_spec="slow:1@0:0.4")
    wall = time.monotonic() - t0
    assert _shape(slowed) == _shape(baseline)
    assert slowed.stats["retries"] == 0 and slowed.stats["timeouts"] == 0
    assert wall >= 0.4  # the injected latency really was served


@pytest.mark.parametrize("pool", ["serial", "process"])
def test_injected_fail_and_hang_converge_to_baseline(baseline, pool):
    faulty = union_opt_sweep(
        _tasks(), fault_spec="fail:1@0;hang:2@0:1", group_timeout_s=0.5,
        max_group_retries=2, group_backoff_s=0.0,
        **({"workers": 2, "pool": "process"} if pool == "process" else {}))
    assert _shape(faulty) == _shape(baseline)
    st = faulty.stats
    assert st["retries"] >= 2  # one for the raise, one for the hang
    assert st["timeouts"] >= 1
    assert st["attempts"] >= len(st["group_wall"]) + 2
    assert st["pool_failed"] == 0


def test_fail_spec_exhausts_retry_budget():
    with pytest.raises(RuntimeError, match="injected failure"):
        union_opt_sweep(_tasks(), fault_spec="fail:0@0;fail:0@1",
                        max_group_retries=1, group_backoff_s=0.0)


# ------------------------------------------------------------------ #
# journal + resume
# ------------------------------------------------------------------ #
def test_journal_resume_replays_groups(tmp_path, monkeypatch):
    jpath = tmp_path / "sweep_journal.json"
    first = union_opt_sweep(_tasks(), journal=str(jpath))
    assert jpath.exists()
    resumed = union_opt_sweep(_tasks(), journal=str(jpath), resume=True)
    assert _full(resumed, _cost_to_record) == _full(first, _cost_to_record)
    assert resumed.stats["replayed_groups"] == len(first.stats["group_wall"]) == 3
    assert resumed.stats["journal"]["resumed"] is True
    monkeypatch.setenv("UNION_DETERMINISTIC_STATS", "1")
    assert [s.search.stats_dict() for s in resumed] == [s.search.stats_dict() for s in first]


def test_journal_without_resume_starts_fresh(tmp_path):
    jpath = tmp_path / "sweep_journal.json"
    union_opt_sweep(_tasks(), journal=str(jpath))
    fresh = union_opt_sweep(_tasks(), journal=str(jpath))  # no resume
    assert fresh.stats["replayed_groups"] == 0


def test_corrupt_journal_discarded(tmp_path):
    jpath = tmp_path / "bad_journal.json"
    jpath.write_text("{not json")
    j = SweepJournal(jpath, resume=True)
    assert j.corrupt == 1 and not j.resumed
    assert not j.groups and not j.tasks
    jpath.write_text(json.dumps({"version": 999, "groups": {}, "tasks": {}}))
    j = SweepJournal(jpath, resume=True)
    assert j.corrupt == 1 and not j.resumed


_DRIVER = '''
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.core.architecture import edge_accelerator
from repro_torch.core.cost import ResultStore
from repro_torch.core.optimizer import SweepTask, union_opt_sweep
from repro_torch.core.problem import Problem

def main():
    out, journal, store_dir, resume = sys.argv[1:5]
    tasks = []
    for i, (m, n, k) in enumerate(
        [(64, 64, 64), (128, 64, 32), (96, 48, 64), (80, 80, 40)]
    ):
        p = Problem.gemm(m, n, k, name=f"killres-g{{i}}")
        tasks.append(SweepTask(p, edge_accelerator(aspect=(16, 16)),
                               mapper="random", cost_model="timeloop",
                               metric="edp", mapper_kw={{"samples": 300}}))
    store = ResultStore(store_dir) if store_dir != "-" else None
    sweep = union_opt_sweep(tasks, result_store=store,
                            journal=None if journal == "-" else journal,
                            resume=resume == "1")
    rows = [{{"edp": s.cost.edp, "mapping": s.mapping.to_dict(),
              "search": s.search.stats_dict()}} for s in sweep]
    with open(out, "w") as f:
        json.dump({{"rows": rows, "sweep": sweep.stats,
                    "modules": sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("torch", "jax", "repro"))}},
                  f, indent=1)
    if store is not None:
        store.flush()
        with open(out + ".store", "w") as f:
            json.dump(store.stats_dict(), f)

if __name__ == "__main__":
    main()
'''


def _run_driver(script, args, env_extra, cwd):
    env = {k: v for k, v in os.environ.items() if k != "UNION_FAULT_SPEC"}
    env.update(UNION_DETERMINISTIC_STATS="1", **env_extra)
    return subprocess.run([sys.executable, str(script)] + args, env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_sigkill_then_resume_is_byte_identical(tmp_path):
    """A sweep SIGKILLed right after its 2nd group's store flush, before
    its journal record, resumed with the same journal + store, emits
    byte-identical JSON to an uninterrupted run, warm against the store."""
    script = tmp_path / "driver.py"
    script.write_text(_DRIVER.format(src=SRC))
    jpath, spath = str(tmp_path / "journal.json"), str(tmp_path / "store")

    r = _run_driver(script, ["ref.json", "-", "-", "0"], {}, tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]

    r = _run_driver(script, ["never.json", jpath, spath, "0"],
                    {"UNION_FAULT_SPEC": "kill-after:2"}, tmp_path)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    assert Path(jpath).exists()
    assert not (tmp_path / "never.json").exists()

    r = _run_driver(script, ["resumed.json", jpath, spath, "1"], {}, tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "replaying 1/4" in (r.stdout + r.stderr)

    ref = (tmp_path / "ref.json").read_bytes()
    assert ref == (tmp_path / "resumed.json").read_bytes()
    assert json.loads(ref)["modules"] == []  # the sweep needs neither torch nor jax
    store_stats = json.loads((tmp_path / "resumed.json.store").read_text())
    assert store_stats["hits"] > 0  # the killed run's flushed Costs were reused


def test_stale_store_tmp_cleaned_at_flush(tmp_path):
    sdir = tmp_path / "store"
    sdir.mkdir()
    stale = sdir / ".deadspace.999.cafef00d.tmp"
    stale.write_text("{}")
    store = ResultStore(sdir)
    union_opt_sweep(_tasks()[:1], result_store=store)
    store.flush()
    assert not stale.exists()
    assert store.stats_dict()["stale_tmps"] >= 1


# ------------------------------------------------------------------ #
# fingerprints
# ------------------------------------------------------------------ #
def test_task_fingerprint_stable_and_matches_reference():
    p, jp = Problem.gemm(64, 64, 64, name="fp"), JaxProblem.gemm(64, 64, 64, name="fp")
    arch, jarch = edge_accelerator(aspect=(16, 16)), jax_edge(aspect=(16, 16))
    f0 = task_fingerprint("gk", p, arch, ("random", {"samples": 10}), None, None, 0)
    assert f0 == task_fingerprint("gk", p, arch, ("random", {"samples": 10}), None, None, 0)
    assert f0 == jax_task_fingerprint("gk", jp, jarch, ("random", {"samples": 10}),
                                      None, None, 0)
    assert f0 != task_fingerprint("gk", p, arch, ("random", {"samples": 10}), None, None, 1)
    assert f0 != task_fingerprint("gk", p, arch, ("random", {"samples": 11}), None, None, 0)
    fa = task_fingerprint("gk", p, arch, ("random", {"dims": {"a", "b", "c"}}), None, None, 0)
    fb = task_fingerprint("gk", p, arch, ("random", {"dims": {"c", "b", "a"}}), None, None, 0)
    assert fa == fb


def test_journal_records_match_reference(tmp_path):
    """The journal holds the same group keys and task fingerprints as the
    reference's for the same sweep, and records of the same form."""
    union_opt_sweep(_tasks(), journal=str(tmp_path / "port.json"))
    jax_union_opt_sweep(_tasks(JaxProblem, JaxSweepTask, jax_edge),
                        journal=str(tmp_path / "ref.json"))
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port["groups"] == ref["groups"]
    assert sorted(port["tasks"]) == sorted(ref["tasks"])
    for fp, rec in port["tasks"].items():
        assert rec["mapping"] == ref["tasks"][fp]["mapping"]
        assert rec["cost"] == ref["tasks"][fp]["cost"]
        assert rec["trajectory"] == ref["tasks"][fp]["trajectory"]
        assert sorted(rec["counters"]) == sorted(ref["tasks"][fp]["counters"])


# ------------------------------------------------------------------ #
# watchdog/retry primitives
# ------------------------------------------------------------------ #
def test_retry_call_retries_then_succeeds():
    stats = RetryStats()
    seen = []

    def fn(attempt):
        seen.append(attempt)
        if attempt < 2:
            raise RuntimeError("flaky")
        return "ok"

    out, _ = retry_call(fn, RetryPolicy(max_retries=3, backoff_s=0.0), label="t", stats=stats)
    assert out == "ok" and seen == [0, 1, 2]
    assert stats.retries == 2 and stats.attempts == 3 and stats.timeouts == 0


def test_retry_call_exhausts_and_raises():
    stats = RetryStats()

    def fn(attempt):
        raise RuntimeError(f"always (attempt {attempt})")

    with pytest.raises(RuntimeError, match="always"):
        retry_call(fn, RetryPolicy(max_retries=2, backoff_s=0.0), label="t", stats=stats)
    assert stats.attempts == 3 and stats.retries == 2 and len(stats.errors) == 3


def test_retry_call_deadline_and_hook():
    """A per-attempt deadline turns a hang into a timeout and a retry; the
    attempt hook runs before each attempt and may raise."""
    stats, slept, hooks = RetryStats(), [], []

    def fn(attempt):
        if attempt == 0:
            time.sleep(0.3)
        return attempt

    def hook(attempt):
        hooks.append(attempt)

    out, _ = retry_call(fn, RetryPolicy(max_retries=2, deadline_s=0.1, backoff_s=0.05),
                        label="g", attempt_hook=hook, stats=stats, sleep=slept.append)
    assert out == 1 and hooks == [0, 1]
    assert stats.timeouts == 1 and stats.retries == 1
    assert slept == [backoff_delay(RetryPolicy(backoff_s=0.05), 1, "g")]
    assert stats.backoff_total_s == slept[0]


def test_call_with_deadline_times_out():
    with pytest.raises(CallTimeoutError):
        call_with_deadline(lambda: time.sleep(1), 0.1, label="hang")
    assert call_with_deadline(lambda: 42, 5.0, label="fast") == 42
    assert call_with_deadline(lambda: 7, None, label="inline") == 7
    with pytest.raises(KeyError):
        call_with_deadline(lambda: {}["missing"], 5.0, label="raises")


@pytest.mark.parametrize("attempt", [1, 2, 3, 9])
@pytest.mark.parametrize("label", ["group0", "group1", "g#7"])
def test_backoff_delay_matches_reference(attempt, label):
    pol = RetryPolicy(max_retries=3, backoff_s=0.1, jitter=0.25, backoff_cap_s=0.5)
    jpol = jax_ft.RetryPolicy(max_retries=3, backoff_s=0.1, jitter=0.25, backoff_cap_s=0.5)
    assert backoff_delay(pol, attempt, label) == jax_ft.backoff_delay(jpol, attempt, label)


def test_backoff_delay_is_deterministic_and_label_diverse():
    pol = RetryPolicy(max_retries=3, backoff_s=0.1, jitter=0.25)
    a1 = backoff_delay(pol, 1, "group0")
    assert a1 == backoff_delay(pol, 1, "group0")
    assert a1 != backoff_delay(pol, 1, "group1")
    assert backoff_delay(pol, 2, "group0") > 0
    assert backoff_delay(RetryPolicy(backoff_s=0.0), 1, "x") == 0.0


def test_straggler_meter_flags_outliers_as_reference():
    durations = [1.0] * 6 + [10.0, 1.0, 0.5, 4.0, 20.0] + [1.0] * 25 + [9.0]
    m, jm = StragglerMeter(window=10, slack=3.0), jax_ft.StragglerMeter(window=10, slack=3.0)
    assert [m.note(d) for d in durations] == [jm.note(d) for d in durations]
    assert m.flagged == jm.flagged >= 3 and m.avg() == jm.avg()
    m = StragglerMeter(window=10, slack=3.0)
    assert m.note(1.0) is False  # no history yet
    for _ in range(5):
        assert m.note(1.0) is False
    assert m.note(10.0) is True and m.flagged == 1
    assert m.note(1.0) is False  # the outlier raised the average


# ------------------------------------------------------------------ #
# the planner's process-wide store
# ------------------------------------------------------------------ #
def test_set_plan_store(tmp_path):
    before = codesign.get_plan_store()
    try:
        disk = codesign.set_plan_store(str(tmp_path / "plans"))
        assert codesign.get_plan_store() is disk and disk.path is not None
        shape = (512, 3072, 768)
        p1 = codesign.plan(MATMUL_BF16_H100, shape)
        assert p1.source in ("search", "default")
        disk.flush()
        # a fresh handle on the same directory answers from disk
        again = codesign.set_plan_store(str(tmp_path / "plans"))
        assert again is not disk
        p2 = codesign.plan(MATMUL_BF16_H100, shape)
        assert p2.source == "store" and p2.config == p1.config
        mem = ResultStore()
        assert codesign.set_plan_store(mem) is mem is codesign.get_plan_store()
        fresh = codesign.set_plan_store(None)
        assert fresh is codesign.get_plan_store() and fresh.path is None
        assert fresh is not mem
    finally:
        codesign.set_plan_store(before)
