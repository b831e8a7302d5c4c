"""Time Union's search engine on one card, for whichever ``repro_torch`` is
first on PYTHONPATH, so that two checkouts can be compared on one machine.
``chip_smoke.py``'s search_engine phase measures with the functions below
too, and adds its checks.

    PYTHONPATH=src python3 tools/engine_ab.py --label change

To compare a change with its parent, unpack the parent into a directory git
ignores and run, in one machine allocation, parent, change, change, parent:

    for t in parent change change parent; do
      PYTHONPATH=$DIR_OF_$t/src python3 tools/engine_ab.py --label $t; done

Each run prints, stamped with the card and its power limit, then as one JSON
line (host clock, the card synchronised; ``torch.profiler``):

- the whole-model sweep of ``chip_smoke.py``'s whole_model phase (qwen3-0.6b
  decode and prefill at 8 x 512, zamba2-2.7b train at 2 x 2048; heuristic,
  timeloop, ``h100_sm()``) on numpy, then on torch cold and warm;
- the fused admit+score dispatch of the engine's shape-generic runner
  (timeloop, EDP) on BERT-2's GEMM (256 x 768 x 3072, uint8) on
  ``cloud_accelerator()`` and on qwen3-0.6b's prefill head (4096 x 151936
  x 1024, bf16) on ``h100_sm()``, at 256 and 2048 random candidates: host
  ms a warm dispatch under the profiler and without it, top-level torch
  ops a dispatch (by name), device kernels and busy ms a dispatch, and
  (where the tree captures graphs) the bucket's graph replayed alone: ms
  to launch it on the host, device ms (CUDA events);
- evals/s of ``union_opt`` (timeloop, EDP) on numpy and on torch (cold
  once, then ``--rounds`` warm rounds interleaved): BERT-2 under the random,
  exhaustive (3,000), genetic and heuristic mappers, and the exhaustive
  mapper at 50,000 on the prefill head, device loop on and off;
- cold-query latency of the mapping service over HTTP on 127.0.0.1, torch on
  the card against a numpy service, in turns: ``COLD_QUERIES`` distinct GEMM
  shapes (random mapper, budget 150, ``edge_accelerator``), p50 and p99 a
  backend.

Every torch result is checked equal to numpy's. The script imports nothing
but ``torch``, numpy and the port.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.core.architecture import cloud_accelerator, h100_sm
from repro_torch.core.cost import EvaluationEngine, TimeloopLikeModel
from repro_torch.core.cost import analysis
from repro_torch.core.cost.analysis import get_context
from repro_torch.core.genome_batch import random_genome_batch
from repro_torch.core.mapspace import MapSpace
from repro_torch.core.opstream import build_gemm, build_opstream, stream_sweep_tasks
from repro_torch.core.optimizer import union_opt, union_opt_sweep
from repro_torch.serve.mapping_service import MappingService
from repro_torch.serve.mapping_service import serve as serve_mapping

SEED = 0
# BERT-2's GEMM (benchmarks/workloads.py, dnn_layers(): n 256, nin 3072, non
# 768, uint8) -- copied, that module imports the JAX package -- and the
# prefill head of qwen3-0.6b (4096 tokens x 151936 x 1024, bf16), whose
# exhaustive batches are large enough for the card to matter
BERT2 = dict(M=256, N=768, K=3072, word_bytes=1)
PREFILL_HEAD = dict(M=4096, N=151936, K=1024, word_bytes=2)
# benchmarks/mappers_bench.py's matrix outside smoke mode, timeloop, EDP
MAPPERS = [("random", {}), ("exhaustive", {"max_mappings": 3000}), ("genetic", {}),
           ("heuristic", {})]
HEAD_CAP = 50_000
STREAMS = [("qwen3-0.6b", ShapeConfig("h100_decode", 512, 8, "decode")),
           ("qwen3-0.6b", ShapeConfig("h100_prefill", 512, 8, "prefill")),
           ("zamba2-2.7b", ShapeConfig("h100_train", 2048, 2, "train"))]
# benchmarks/serve_bench.py's query: a GEMM on the edge accelerator, EDP,
# the random mapper at budget 150
SERVE_BUDGET = 150
# cold queries a backend: distinct GEMM shapes, each a search on both
COLD_QUERIES = 120


def graphs() -> int:
    """CUDA graphs captured (0 on a tree that captures none)."""
    count = getattr(analysis, "graph_count", None)
    return count() if count is not None else 0


def pool_bytes() -> int:
    """Bytes of the graphs' memory pool (0 on a tree that captures none)."""
    return getattr(analysis, "graph_pool_bytes", lambda: 0)()


def bert2():
    return build_gemm(BERT2["M"], BERT2["N"], BERT2["K"], name="BERT-2",
                      word_bytes=BERT2["word_bytes"])


def prefill_head():
    return build_gemm(PREFILL_HEAD["M"], PREFILL_HEAD["N"], PREFILL_HEAD["K"],
                      name="prefill_head", word_bytes=PREFILL_HEAD["word_bytes"])


def search_view(sol) -> tuple:
    """Everything a search must reproduce bit for bit on another backend."""
    r = sol.search
    return (sol.mapping.to_dict(), sol.cost.latency_cycles, sol.cost.energy_pj,
            sol.cost.utilization, sol.cost.breakdown, r.evaluated, r.considered, r.analyzed,
            r.cache_hits, r.pruned, tuple(r.trajectory))


def timed_search(problem, arch, mapper, kw, backend, loop=True):
    """One union_opt on ``backend`` (torch: on the card), host clock around
    the search, the card synchronised before the clock stops."""
    prior = os.environ.get("UNION_DEVICE_LOOP")
    os.environ["UNION_DEVICE_LOOP"] = "1" if loop else "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = union_opt(problem, arch, mapper=mapper, cost_model="timeloop", metric="edp",
                        engine_backend=backend, engine_device="cuda", **kw)
        torch.cuda.synchronize()
        return sol, time.perf_counter() - t0
    finally:
        if prior is None:
            del os.environ["UNION_DEVICE_LOOP"]
        else:
            os.environ["UNION_DEVICE_LOOP"] = prior


def profile_dispatch(problem, arch, rows, n=5) -> dict:
    """torch.profiler over ``n`` warm dispatches of the engine's generic
    fused runner (timeloop, EDP) at ``rows`` candidates (the first
    dispatch, outside the window, runs eagerly and, where the tree
    captures graphs, captures the bucket's): host wall ms a dispatch (card
    synchronised) under the profiler and without it, top-level torch ops a
    dispatch and their names, device kernels, device busy ms (None where
    the profiler saw no device kernel), and the bucket's graph alone, where
    there is one: ms to launch it on the host, ms a replay on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = EvaluationEngine(TimeloopLikeModel(), problem, arch, backend="torch", device="cuda")
    runner = eng._get_fused_runner()
    sb = random_genome_batch(MapSpace(problem, arch), np.random.default_rng(SEED), rows).stacked()
    if runner(sb, math.inf) is None:
        raise RuntimeError(f"{problem.name}: the fused runner failed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            runner(sb, math.inf)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    top = collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CPU
                              and e.name.startswith("aten::")
                              and (e.cpu_parent is None
                                   or not e.cpu_parent.name.startswith("aten::")))
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    # the same dispatches without the profiler, whose tracing adds host
    # time to every kernel; then the graph alone, replayed back to back:
    # its launch on the host clock and its device time (CUDA events)
    t0 = time.perf_counter()
    for _ in range(4 * n):
        runner(sb, math.inf)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / (4 * n) * 1e3
    padded = 1 << max(0, (rows - 1).bit_length())
    graph_ms = launch_ms = None
    entry = getattr(analysis, "_GRAPHS", {}).get((runner._pkey, padded))
    if entry is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            entry.graph.replay()
        end.record()
        launch_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        graph_ms = start.elapsed_time(end) / 20
    return {"problem": problem.name, "rows": rows, "padded": padded, "wall_ms": wall,
            "plain_wall_ms": plain_wall, "ops": sum(top.values()) / n,
            "op_names": {k: v / n for k, v in sorted(top.items())},
            "kernels": sum(e.count for e in kern) / n,
            "busy_ms": sum(e.self_device_time_total for e in kern) / n / 1e3 if kern else None,
            "graph_ms": graph_ms, "graph_launch_ms": launch_ms}


def mapper_runs(arch) -> list:
    """(problem, arch, mapper, kw, device loop) of the mapper matrix."""
    runs = [(bert2(), cloud_accelerator(), mp, kw, True) for mp, kw in MAPPERS]
    return runs + [(prefill_head(), arch, "exhaustive", {"max_mappings": HEAD_CAP}, loop)
                   for loop in (True, False)]


def mapper_cell(problem, arch, mp, kw, loop, rounds):
    """One cell of the mapper matrix: the search on numpy, on torch cold,
    then ``rounds`` warm rounds with the two backends interleaved in
    alternating order (so a drift of the shared host clock falls on both).
    Returns ``(row, numpy's solution, torch's solutions, cold first)``."""
    sol_n, _dt = timed_search(problem, arch, mp, kw, "numpy", loop)
    d0, g0 = get_context(problem, arch).device_dispatches, graphs()
    sol_c, dt_c = timed_search(problem, arch, mp, kw, "torch", loop)
    graphs_cold = graphs() - g0
    dispatches = get_context(problem, arch).device_dispatches - d0
    times = {"numpy": [], "torch": []}
    sols = [sol_c]
    g0 = graphs()
    for i in range(rounds):
        for backend in (("numpy", "torch") if i % 2 == 0 else ("torch", "numpy")):
            sol, dt = timed_search(problem, arch, mp, kw, backend, loop)
            times[backend].append(dt)
            if backend == "torch":
                sols.append(sol)
    r = sol_c.search
    ev = {b: sorted(r.scored / t for t in ts) for b, ts in times.items()}
    med = {b: statistics.median(v) for b, v in ev.items()}
    row = {"problem": problem.name, "mapper": mp, "kw": kw, "device_loop": loop,
           "scored": r.scored, "pruned": r.pruned, "rounds": rounds,
           "numpy_evals_per_s": med["numpy"], "torch_warm_evals_per_s": med["torch"],
           "numpy_evals_per_s_range": [ev["numpy"][0], ev["numpy"][-1]],
           "torch_warm_evals_per_s_range": [ev["torch"][0], ev["torch"][-1]],
           "torch_over_numpy": med["torch"] / med["numpy"],
           # resolved when the two backends' ranges do not overlap
           "resolved": ev["torch"][0] > ev["numpy"][-1] or ev["numpy"][0] > ev["torch"][-1],
           "torch_cold_evals_per_s": r.scored / dt_c, "numpy_s": times["numpy"],
           "torch_cold_s": dt_c, "torch_warm_s": times["torch"],
           "fused_dispatches": r.fused_dispatches, "n_traces_cold": r.n_traces,
           "n_traces_warm": sum(s.search.n_traces for s in sols[1:]),
           "graphs_cold": graphs_cold, "graphs_warm": graphs() - g0,
           "pool_bytes": pool_bytes(), "device_syncs": r.device_syncs,
           "device_dispatches": dispatches}
    return row, sol_n, sols


def gemm_query(m, n, k, budget=SERVE_BUDGET, deadline_s=None) -> dict:
    q = {"problem": {"kind": "gemm", "m": m, "n": n, "k": k},
         "arch": {"kind": "edge", "aspect": [16, 16]}, "metric": "edp",
         "mapper": {"name": "random", "kw": {"seed": 7}}, "budget": budget}
    if deadline_s is not None:
        q["deadline_s"] = deadline_s
    return q


def post(port, payload, timeout=120.0):
    """POST a query to the service on 127.0.0.1:``port``: (status, envelope)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/mapping",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def answer(env) -> tuple:
    rec = env["record"]
    return json.dumps(rec["mapping"], sort_keys=True), json.dumps(rec["cost"], sort_keys=True)


def p50_p99(v) -> tuple:
    qs = sorted(v)
    return statistics.median(qs), qs[min(len(qs) - 1, int(0.99 * len(qs)))]


def cold_shapes(n, exclude=()) -> list:
    """``n`` distinct GEMM shapes, multiples of 16 from 32 to 512, drawn
    from a seed, none of them in ``exclude``."""
    rng, seen, out = random.Random(SEED + 1), set(exclude), []
    while len(out) < n:
        s = tuple(16 * rng.randint(2, 32) for _ in range(3))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def cold_series(ports, shapes) -> dict:
    """Each shape a cold query to both services (``ports``: backend ->
    port), in turns: latency on the host clock around the HTTP round trip.
    Returns, a backend, the latencies, p50 and p99 ms, and the envelopes."""
    ms = {b: [] for b in ports}
    envs = {b: [] for b in ports}
    order = list(ports)
    for i, (m, n, k) in enumerate(shapes):
        for backend in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            code, env = post(ports[backend], gemm_query(m, n, k))
            ms[backend].append((time.perf_counter() - t0) * 1e3)
            if code != 200 or not env.get("ok") or env["source"] == "store":
                raise RuntimeError(f"cold query {m}x{n}x{k} on {backend}: {code} {env}")
            envs[backend].append(env)
    return {b: {"ms": v, "p50_ms": p50_p99(v)[0], "p99_ms": p50_p99(v)[1], "envs": envs[b]}
            for b, v in ms.items()}


def _cold_services() -> dict:
    """The cold series against a torch service on the card and a numpy one,
    each over its own HTTP front, after one query each outside the series."""
    state = Path(tempfile.mkdtemp(prefix="engine-ab-"))
    svcs = {"torch": MappingService(str(state / "torch"), backend="torch", device="cuda",
                                    deadline_s=30.0),
            "numpy": MappingService(str(state / "numpy"), backend="numpy", deadline_s=30.0)}
    fronts = {b: serve_mapping(s) for b, s in svcs.items()}
    threads = [threading.Thread(target=h.serve_forever, daemon=True) for h in fronts.values()]
    for t in threads:
        t.start()
    try:
        ports = {b: h.server_address[1] for b, h in fronts.items()}
        for port in ports.values():  # the first query's one-time costs
            post(port, gemm_query(48, 48, 48))
        out = cold_series(ports, cold_shapes(COLD_QUERIES, exclude=[(48, 48, 48)]))
    finally:
        for b, h in fronts.items():
            h.shutdown()
            svcs[b].drain()
        for t in threads:
            t.join(timeout=30)
        shutil.rmtree(state, ignore_errors=True)
    for t, nv in zip(out["torch"].pop("envs"), out["numpy"].pop("envs")):
        assert answer(t) == answer(nv), "a cold query: torch's answer differs from numpy's"
        assert t["record"]["counters"]["backend_fallbacks"] == 0
    return out


def _sweep() -> dict:
    arch = h100_sm()
    tasks, _index = stream_sweep_tasks([build_opstream(m, s) for m, s in STREAMS], arch)
    out = {"tasks": len(tasks)}
    t0 = time.perf_counter()
    ref = union_opt_sweep(tasks)
    out["numpy_s"] = time.perf_counter() - t0
    for label in ("torch_cold_s", "torch_warm_s"):
        g0 = graphs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = union_opt_sweep(tasks, engine_backend="torch", engine_device="cuda")
        torch.cuda.synchronize()
        out[label] = time.perf_counter() - t0
        out[label.replace("_s", "_graphs")] = graphs() - g0
        out[label.replace("_s", "_traces")] = got.stats["n_traces"]
        assert [(s.mapping.to_dict(), s.cost) for s in got] == \
            [(s.mapping.to_dict(), s.cost) for s in ref], "the torch sweep differs"
        assert got.stats["backend_fallbacks"] == 0
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("engine_ab: needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    stamp = f"{args.label}: {smi}"
    t0 = time.perf_counter()
    sweep = _sweep()
    print(f"[{stamp}] sweep of {sweep['tasks']} entries: numpy {sweep['numpy_s']:.3f} s, torch "
          f"cold {sweep['torch_cold_s']:.3f} s ({sweep['torch_cold_graphs']} graphs, "
          f"{sweep['torch_cold_traces']} traces), warm {sweep['torch_warm_s']:.3f} s", flush=True)
    profiles = [profile_dispatch(p, a, r) for p, a in ((bert2(), cloud_accelerator()),
                                                       (prefill_head(), h100_sm()))
                for r in (256, 2048)]
    for p in profiles:
        busy = "not measured" if p["busy_ms"] is None else f"{p['busy_ms']:.3f} ms"
        names = p["op_names"] if len(p["op_names"]) <= 12 else f"{len(p['op_names'])} distinct"
        print(f"[{stamp}] dispatch {p['problem']} {p['rows']} rows: host {p['wall_ms']:.3f} ms "
              f"profiled, {p['plain_wall_ms']:.3f} ms not, {p['ops']:.0f} top-level ops, "
              f"{p['kernels']:.0f} kernels, busy {busy}, the graph alone {p['graph_ms']} ms on "
              f"the device, {p['graph_launch_ms']} ms to launch; ops {names}", flush=True)
        if len(p["op_names"]) > 12:
            p["op_names"] = f"{len(p['op_names'])} distinct"
    evals = []
    for problem, arch, mp, kw, loop in mapper_runs(h100_sm()):
        r, sol_n, sols = mapper_cell(problem, arch, mp, kw, loop, args.rounds)
        for sol in sols:
            assert search_view(sol) == search_view(sol_n), f"{problem.name} {mp}: torch differs"
            assert sol.search.backend_fallbacks == 0
        evals.append(r)
        print(f"[{stamp}] {r['problem']:13s} {r['mapper']:10s} loop {'on ' if loop else 'off'}"
              f" numpy {r['numpy_evals_per_s']:9.0f} torch {r['torch_warm_evals_per_s']:9.0f} "
              f"t/n {r['torch_over_numpy']:.2f}{'' if r['resolved'] else '~'} cold "
              f"{r['torch_cold_s']:.3f} s, {r['n_traces_cold']} traces, {r['graphs_cold']} "
              "graphs", flush=True)
    cold = _cold_services()
    print(f"[{stamp}] cold queries, {COLD_QUERIES} shapes a backend in turns: torch p50 "
          f"{cold['torch']['p50_ms']:.3f} ms p99 {cold['torch']['p99_ms']:.3f} ms, numpy p50 "
          f"{cold['numpy']['p50_ms']:.3f} ms p99 {cold['numpy']['p99_ms']:.3f} ms", flush=True)
    print(json.dumps({"label": args.label, "device": smi, "sweep": sweep, "profiles": profiles,
                      "evals": evals, "cold": cold, "graphs": graphs(), "pool_bytes": pool_bytes(),
                      "seconds": time.perf_counter() - t0}, default=str))


if __name__ == "__main__":
    main()
