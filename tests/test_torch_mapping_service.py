"""The port's mapping-as-a-service daemon (``repro_torch.serve.mapping_service``)
on the CPU, twinned with ``tests/test_mapping_service.py``: query parsing
and fingerprints (equal to the reference's), cold -> warm -> restart
byte-identity, deadline-capped partial answers, nearest-neighbour warm
starts, the circuit breaker's walk under injected torch-backend faults,
HTTP backpressure, and the SIGTERM / kill -9 drills.

The service's torch backend (``device="cpu"`` here) must answer every query
with the mapping and cost of the numpy service and of the reference's
service, bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from repro.core.architecture import edge_accelerator as jax_edge
from repro.core.optimizer import COST_MODEL_REGISTRY as JAX_COST_MODEL_REGISTRY
from repro.core.problem import Problem as JaxProblem
from repro.serve.mapping_service import MappingService as JaxMappingService
from repro.serve.mapping_service import _slice_plan as jax_slice_plan
from repro.serve.mapping_service import query_fingerprint as jax_query_fingerprint

from repro_torch.core.architecture import edge_accelerator
from repro_torch.core.optimizer import COST_MODEL_REGISTRY
from repro_torch.core.problem import Problem
from repro_torch.serve.mapping_service import (
    MappingService,
    QueryError,
    _make_handler,
    _ParsedQuery,
    _slice_plan,
    main,
    query_fingerprint,
    serve,
)

SRC = str(Path(__file__).resolve().parent.parent / "src")
TORCH = {"backend": "torch", "device": "cpu"}
NUMPY = {"backend": "numpy"}


def _gemm_query(m, n, k, *, budget=120, deadline_s=None, metric="edp",
                name=None, mapper=None, **extra):
    q = {
        "problem": {"kind": "gemm", "m": m, "n": n, "k": k},
        "arch": {"kind": "edge", "aspect": [16, 16]},
        "metric": metric,
        "mapper": mapper or {"name": "random", "kw": {"seed": 7}},
        "budget": budget,
    }
    if deadline_s is not None:
        q["deadline_s"] = deadline_s
    if name is not None:
        q["problem"]["name"] = name
    q.update(extra)
    return q


def _rec_bytes(env):
    return json.dumps(env["record"], sort_keys=True).encode()


def _answer(env):
    return env["record"]["mapping"], env["record"]["cost"], env["record"]["trajectory"]


# ------------------------------------------------------------------ #
# parsing + fingerprints
# ------------------------------------------------------------------ #
def test_query_fingerprint_stable_and_matches_reference():
    cm = COST_MODEL_REGISTRY["timeloop"]()
    p = Problem.gemm(64, 32, 16, name="fp-a")
    arch = edge_accelerator(aspect=(16, 16))
    f0 = query_fingerprint(cm, p, arch, "edp", "random", {"seed": 7}, 100)
    assert f0 == query_fingerprint(cm, p, arch, "edp", "random", {"seed": 7}, 100)
    assert f0 != query_fingerprint(cm, p, arch, "edp", "random", {"seed": 8}, 100)
    assert f0 != query_fingerprint(cm, p, arch, "latency", "random", {"seed": 7}, 100)
    assert f0 != query_fingerprint(cm, p, arch, "edp", "random", {"seed": 7}, 101)
    assert f0 == query_fingerprint(cm, Problem.gemm(64, 32, 16, name="fp-OTHER"), arch,
                                   "edp", "random", {"seed": 7}, 100)
    assert f0 == jax_query_fingerprint(
        JAX_COST_MODEL_REGISTRY["timeloop"](), JaxProblem.gemm(64, 32, 16, name="fp-a"),
        jax_edge(aspect=(16, 16)), "edp", "random", {"seed": 7}, 100)
    qa = _ParsedQuery(_gemm_query(64, 32, 16), 5.0)
    qb = _ParsedQuery(_gemm_query(64, 32, 16, deadline_s=0.25), 5.0)
    assert qa.fingerprint == qb.fingerprint and qb.deadline_s == 0.25


@pytest.mark.parametrize(
    "mutate",
    [
        {"problem": {"kind": "wavelet"}},
        {"problem": {"kind": "gemm", "m": 64, "n": 32}},
        {"metric": "carbon"},
        {"mapper": "annealing-imaginary"},
        {"budget": "lots"},
        {"deadline_s": -1},
        {"arch": {"kind": "dyson-sphere"}},
        {"model": "no-such-model"},
    ],
    ids=["kind", "missing-dim", "metric", "mapper", "budget", "deadline", "arch", "model"],
)
def test_malformed_queries_raise_query_error(mutate):
    q = _gemm_query(64, 32, 16)
    q.update(mutate)
    with pytest.raises(QueryError):
        _ParsedQuery(q, 5.0)


def test_slice_plan_covers_budget_exactly():
    for total in (1, 63, 64, 65, 320, 512, 1000):
        plan = _slice_plan(total)
        assert plan == jax_slice_plan(total)
        assert sum(plan) == total and all(s > 0 for s in plan) and plan[0] <= 64


def test_backend_and_device_checks(tmp_path):
    with pytest.raises(ValueError, match="unknown backend"):
        MappingService(str(tmp_path), backend="jax")
    svc = MappingService(str(tmp_path / "numpy"), **NUMPY)
    assert svc.metrics()["backend"] == "numpy" and svc.metrics()["device"] is None
    if not torch.cuda.is_available():
        # the defaults are the torch backend on the card: a service that
        # cannot see one fails at start, never quietly on the host
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MappingService(str(tmp_path))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--state-dir", str(tmp_path / "cli")])


# ------------------------------------------------------------------ #
# the torch backend answers as numpy and the reference do
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mapper", [None, {"name": "genetic", "kw": {"generations": 3}},
                                    {"name": "exhaustive", "kw": {"max_mappings": 300}},
                                    {"name": "heuristic"}],
                         ids=["random", "genetic", "exhaustive", "heuristic"])
def test_torch_service_answers_equal_numpy_and_reference(tmp_path, mapper):
    queries = [_gemm_query(32 + 16 * i, 48, 32, mapper=mapper, budget=150) for i in range(3)]
    svc_t = MappingService(str(tmp_path / "t"), deadline_s=None, **TORCH)
    svc_n = MappingService(str(tmp_path / "n"), deadline_s=None, **NUMPY)
    svc_r = JaxMappingService(str(tmp_path / "r"), deadline_s=None)
    for q in queries:
        et, en, er = svc_t.handle_query(q), svc_n.handle_query(q), svc_r.handle_query(q)
        assert et["ok"] and et["backend"] == "torch"
        assert _answer(et) == _answer(en) == _answer(er)
        c = et["record"]["counters"]
        assert c["backend_fallbacks"] == 0 and c["fused_dispatches"] > 0
        assert c["evaluated"] == en["record"]["counters"]["evaluated"]
    m = svc_t.metrics()
    assert m["backend"] == "torch" and m["device"] == "cpu" and m["searches"] == 3


# ------------------------------------------------------------------ #
# in-process service: cold -> warm -> restart
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_cold_then_warm_then_restart_byte_identical(tmp_path, backend):
    kw = TORCH if backend == "torch" else NUMPY
    svc = MappingService(str(tmp_path), deadline_s=None, **kw)
    q = _gemm_query(64, 48, 32)
    cold = svc.handle_query(q)
    assert cold["ok"] and cold["source"] == "search" and not cold["budget_exhausted"]
    warm = svc.handle_query(q)
    assert warm["ok"] and warm["source"] == "store"
    assert _rec_bytes(warm) == _rec_bytes(cold)
    renamed = svc.handle_query(_gemm_query(64, 48, 32, name="alias"))
    assert renamed["source"] == "store" and _rec_bytes(renamed) == _rec_bytes(cold)
    m = svc.metrics()
    assert m["queries"] == 3 and m["store_hits"] == 2 and m["searches"] == 1
    svc.drain()
    svc2 = MappingService(str(tmp_path), deadline_s=None, **kw)
    again = svc2.handle_query(q)
    assert again["source"] == "store" and _rec_bytes(again) == _rec_bytes(cold)
    assert svc2.metrics()["searches"] == 0


def test_error_envelope_not_exception(tmp_path):
    svc = MappingService(str(tmp_path), **NUMPY)
    env = svc.handle_query({"problem": {"kind": "wavelet"}})
    assert env["ok"] is False and "wavelet" in env["error"]
    assert svc.metrics()["errors"] == 1 and svc.metrics()["queries"] == 0


# ------------------------------------------------------------------ #
# deadlines: partial answers, never errors
# ------------------------------------------------------------------ #
def test_tiny_deadline_returns_flagged_fallback(tmp_path):
    svc = MappingService(str(tmp_path), **TORCH)
    env = svc.handle_query(_gemm_query(96, 96, 96, budget=5000, deadline_s=1e-4))
    assert env["ok"] is True and env["budget_exhausted"] is True
    assert env["record"]["mapping"] and env["record"]["cost"]
    m = svc.metrics()
    assert m["partials"] == 1 and m["fallback_answers"] == 1
    again = svc.handle_query(_gemm_query(96, 96, 96, budget=5000, deadline_s=None))
    assert again["source"] == "search" and not again["budget_exhausted"]


def test_slow_injection_yields_partial_with_real_incumbent(tmp_path):
    svc = MappingService(str(tmp_path), fault_spec="slow:0@1:30", **TORCH)
    env = svc.handle_query(_gemm_query(80, 80, 40, budget=512, deadline_s=1.0))
    assert env["ok"] is True and env["budget_exhausted"] is True
    assert env["record"]["counters"]["considered"] >= 64
    m = svc.metrics()
    assert m["partials"] == 1 and m["fallback_answers"] == 0
    done = svc.handle_query(_gemm_query(80, 80, 40, budget=512, deadline_s=None))
    assert done["source"] == "search" and not done["budget_exhausted"]
    assert svc.handle_query(_gemm_query(80, 80, 40, budget=512))["source"] == "store"


# ------------------------------------------------------------------ #
# nearest-neighbour warm starts
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_neighbor_seed_fires_and_result_matches_unseeded(tmp_path, backend):
    kw = TORCH if backend == "torch" else NUMPY
    svc = MappingService(str(tmp_path), deadline_s=None, **kw)
    first = svc.handle_query(_gemm_query(64, 64, 64))
    assert first["seeded"] is False
    near = svc.handle_query(_gemm_query(64, 64, 48))
    assert near["seeded"] is True and near["neighbor"]["distance"] >= 0.0
    m = svc.metrics()
    assert m["seeded"] == 1 and m["neighbor_hits"] == 1 and m["neighbor_misses"] == 1
    lone = MappingService(str(tmp_path / "lone"), deadline_s=None, **kw)
    ref = lone.handle_query(_gemm_query(64, 64, 48))
    assert near["record"]["cost"] == ref["record"]["cost"]
    assert near["record"]["mapping"] == ref["record"]["mapping"]


# ------------------------------------------------------------------ #
# circuit breaker: open -> half-open -> closed under injected faults
# ------------------------------------------------------------------ #
def test_breaker_opens_degrades_and_recovers(tmp_path):
    svc = MappingService(str(tmp_path), deadline_s=None, breaker_threshold=2,
                         probe_interval=2, fault_spec="jaxfail:0;jaxfail:1", **TORCH)
    plain = MappingService(str(tmp_path / "numpy"), deadline_s=None, **NUMPY)
    envs = [svc.handle_query(_gemm_query(32 + 16 * i, 32, 32, budget=96)) for i in range(4)]
    assert all(e["ok"] for e in envs)
    br = svc.metrics()["breaker"]
    assert br["transitions"] == ["closed->open", "open->half_open", "half_open->closed"]
    assert br["state"] == "closed" and br["opened"] == 1 and br["recovered"] == 1
    # queries 0/1 degraded mid-search; 2 was denied torch (circuit open);
    # 3 was the half-open probe that ran clean and closed the circuit
    assert [e["backend"] for e in envs] == ["numpy", "numpy", "numpy", "torch"]
    fallbacks = [e["record"]["counters"]["backend_fallbacks"] for e in envs]
    assert fallbacks == [1, 1, 0, 0]  # exactly the injected ones
    for i, e in enumerate(envs):  # degradation never changes an answer
        assert _answer(e) == _answer(plain.handle_query(
            _gemm_query(32 + 16 * i, 32, 32, budget=96)))


def test_breaker_open_answers_stay_available_numpy(tmp_path):
    svc = MappingService(str(tmp_path), deadline_s=None, breaker_threshold=1,
                         probe_interval=100,
                         fault_spec=";".join(f"jaxfail:{i}" for i in range(4)), **TORCH)
    for i in range(4):
        env = svc.handle_query(_gemm_query(48 + 16 * i, 32, 32, budget=96))
        assert env["ok"] and env["record"]["mapping"]
    br = svc.metrics()["breaker"]
    assert br["state"] == "open" and br["denied"] >= 1


# ------------------------------------------------------------------ #
# HTTP front: round-trip, 400, and deterministic 429 backpressure
# ------------------------------------------------------------------ #
def _post(port, payload, timeout=60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/mapping",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def test_http_round_trip_and_metrics(tmp_path):
    svc = MappingService(str(tmp_path), deadline_s=None, workers=1, **TORCH)
    httpd = serve(svc)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        st, env, _ = _post(port, _gemm_query(64, 32, 32))
        assert st == 200 and env["ok"] and env["source"] == "search"
        assert env["backend"] == "torch"
        st, warm, _ = _post(port, _gemm_query(64, 32, 32))
        assert st == 200 and warm["source"] == "store"
        assert _rec_bytes(warm) == _rec_bytes(env)
        st, bad, _ = _post(port, {"problem": {"kind": "wavelet"}})
        assert st == 400 and bad["ok"] is False
        m = _get(port, "/metrics")
        assert m["queries"] == 2 and m["store_hits"] == 1 and m["device"] == "cpu"
        assert _get(port, "/healthz") == {"ok": True, "draining": False}
    finally:
        httpd.shutdown()
        svc.drain()
    th.join(timeout=10)
    assert not th.is_alive()


def test_http_queue_full_sheds_with_retry_after(tmp_path):
    """No workers running yet, queue cap 1: the first POST parks in the
    queue, the second MUST be shed with 429 + Retry-After."""
    svc = MappingService(str(tmp_path), deadline_s=None, queue_cap=1, workers=1, **TORCH)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(svc))
    httpd.daemon_threads = True
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    first = {}

    def poster():
        first["out"] = _post(port, _gemm_query(64, 32, 32), timeout=180.0)

    pt = threading.Thread(target=poster, daemon=True)
    pt.start()
    deadline = time.monotonic() + 10.0
    while svc.jobs.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert svc.jobs.qsize() == 1
    st, env, headers = _post(port, _gemm_query(48, 32, 32))
    assert st == 429 and env["error"] == "admission queue full"
    assert headers.get("Retry-After") == "1"
    assert svc.metrics()["shed"] == 1
    svc.start_workers()
    pt.join(timeout=120.0)
    assert not pt.is_alive()
    st, env, _ = first["out"]
    assert st == 200 and env["ok"]
    httpd.shutdown()
    svc.drain()


# ------------------------------------------------------------------ #
# subprocess drills: SIGTERM drain, kill -9 + restart byte-identity
# ------------------------------------------------------------------ #
def _spawn_daemon(state_dir, *extra_args, timeout_s=90.0):
    ready = os.path.join(state_dir, "ready.json")
    if os.path.exists(ready):
        os.unlink(ready)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.mapping_service",
         "--state-dir", str(state_dir), "--ready-file", ready,
         "--deadline-s", "0", "--device", "cpu", *extra_args],
        env=env,
    )
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if os.path.exists(ready):
            with open(ready) as f:
                return proc, json.load(f)["port"]
        if proc.poll() is not None:
            raise AssertionError(f"daemon died at startup rc={proc.returncode}")
        time.sleep(0.05)
    proc.kill()
    raise AssertionError("daemon never became ready")


def test_sigterm_drains_inflight_query_and_exits_zero(tmp_path):
    proc, port = _spawn_daemon(tmp_path)
    q = _gemm_query(72, 72, 36, budget=400)
    out = {}

    def poster():
        out["resp"] = _post(port, q, timeout=120.0)

    pt = threading.Thread(target=poster, daemon=True)
    pt.start()
    time.sleep(0.15)
    proc.send_signal(signal.SIGTERM)
    pt.join(timeout=120.0)
    assert not pt.is_alive()
    st, env, _ = out["resp"]
    assert st == 200 and env["ok"], env
    assert proc.wait(timeout=60.0) == 0
    proc2, port2 = _spawn_daemon(tmp_path)
    try:
        st, warm, _ = _post(port2, q)
        assert st == 200 and warm["source"] == "store"
        assert _rec_bytes(warm) == _rec_bytes(env)
    finally:
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(timeout=60.0) == 0


def test_kill9_restart_answers_byte_identical_from_store(tmp_path):
    proc, port = _spawn_daemon(tmp_path)
    queries = [_gemm_query(64 + 16 * i, 64, 32, budget=150) for i in range(3)]
    before = []
    for q in queries:
        st, env, _ = _post(port, q, timeout=120.0)
        assert st == 200 and env["ok"] and env["source"] == "search"
        assert env["backend"] == "torch"
        before.append(env)
    proc.kill()
    assert proc.wait(timeout=30.0) == -signal.SIGKILL
    proc2, port2 = _spawn_daemon(tmp_path)
    try:
        for q, old in zip(queries, before):
            st, env, _ = _post(port2, q, timeout=120.0)
            assert st == 200 and env["source"] == "store"
            assert _rec_bytes(env) == _rec_bytes(old)
        m = _get(port2, "/metrics")
        assert m["queries"] == len(queries) and m["store_hits"] == m["queries"]
        assert m["searches"] == 0 and m["journal"]["resumed"] is True
    finally:
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(timeout=60.0) == 0


def test_cli_rejects_unknown_backend(capsys):
    with pytest.raises(SystemExit):
        main(["--state-dir", "unused", "--backend", "jax"])
    assert "invalid choice" in capsys.readouterr().err


def test_new_modules_import_neither_jax_nor_repro():
    """The service, the device loops and the torch namespace import no jax
    and nothing of ``repro``; a numpy search imports no torch."""
    code = (
        "import sys\n"
        "from repro_torch.core.optimizer import union_opt\n"
        "from repro_torch.core.architecture import edge_accelerator\n"
        "from repro_torch.core.problem import Problem\n"
        "union_opt(Problem.gemm(64, 32, 16), edge_accelerator(), mapper='random', samples=64)\n"
        "assert 'torch' not in sys.modules, 'a numpy search imported torch'\n"
        "import repro_torch.serve.mapping_service, repro_torch.core.device_loop\n"
        "import repro_torch.core.cost._xp_torch\n"
        "union_opt(Problem.gemm(64, 32, 16), edge_accelerator(), mapper='genetic',\n"
        "          engine_backend='torch', engine_device='cpu', generations=2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
