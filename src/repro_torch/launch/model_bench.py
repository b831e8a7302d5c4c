"""Whole-model end-to-end bench: ModelConfig -> OpStream -> one sweep -> EDP
(twin of ``benchmarks/model_bench.py``).

Lowers each model (default: one dense-attention, one MoE, one SSM-hybrid)
into its deduplicated operator stream (``repro_torch.core.opstream``),
drives EVERY stream's mappable ops through ONE ``union_opt_sweep`` call --
so content-equal ops across models share engine groups, memo caches and
the persistent ResultStore -- and aggregates multiplicity-weighted per-op
costs into end-to-end latency/energy/EDP per model, with a stacked
per-role breakdown and the stream-vs-MODEL_FLOPS reconciliation ratio.
The models, shapes, architecture (``cloud_accelerator()``) and rows are
the reference's.

Output goes to ``experiments/torch/model.json`` (full rows). The twin
never reads or writes ``BENCH_model.json``: that file and its smoke-mode
evals/s regression gate (``--no-regress-check``, ``--regress-margin``,
``--update-baseline``) belong to the reference, so the gate and its flags
are left out here.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.model_bench [--smoke]
        [--models A,B] [--shape S] [--backend numpy] [--store DIR]
        [--art-dir DIR] [--workers N] [--journal FILE] [--resume]

``--smoke`` uses the ``_smoke`` reduced configs on a small prefill shape
(finishes in seconds on a CPU). The sweep is numpy on the host: nothing
here touches a GPU.

Dry-run artifacts (``<art-dir>/<model>__<shape>__16x16.json``, made by the
reference's ``launch/dryrun.py``), when present, contribute the MEASURED
collective term to each model's end-to-end latency
(``opstream.measured_collective_s``) and an artifact-reconciliation row;
absent artifacts degrade to collective_s=0 with a note, never an error.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.core.architecture import cloud_accelerator
from repro_torch.core.cost import ResultStore
from repro_torch.core.opstream import (
    RECONCILE_BAND,
    aggregate_stream_costs,
    artifact_path,
    build_opstream,
    measured_collective_s,
    reconcile_model_flops,
    reconcile_with_artifact,
    stream_sweep_tasks,
)
from repro_torch.core.optimizer import union_opt_sweep
from repro_torch.launch.sweep_cli import add_sweep_args, deterministic_stats, sweep_kwargs

OUT = Path("experiments/torch")

#: one dense-attention, one MoE, one SSM/attention hybrid
MODELS = ["qwen3-0.6b", "deepseek-v2-lite-16b", "zamba2-2.7b"]

SMOKE_SHAPE = ShapeConfig("smoke_prefill", 256, 2, "prefill")


def run(smoke: bool = False, models=None, shape_name: str | None = None,
        backend: str = "numpy", store_dir: str | None = None,
        sweep_kw: dict | None = None,
        art_dir: str = "experiments/dryrun") -> dict:
    models = list(models or MODELS)
    if smoke and shape_name is None:
        shape = SMOKE_SHAPE
    else:
        shape = SHAPES[shape_name or "decode_32k"]
    arch = cloud_accelerator()
    names = [m + "_smoke" if smoke else m for m in models]

    streams, recon_rows = [], {}
    for name in names:
        cfg = get_config(name)
        s = build_opstream(cfg, shape)
        r = reconcile_model_flops(s, cfg)
        lo, hi = RECONCILE_BAND
        ok = lo <= r["ratio"] <= hi
        if not ok:
            print(f"[model] WARNING: {name} stream/MODEL_FLOPS ratio "
                  f"{r['ratio']:.3f} outside [{lo}, {hi}]")
        recon_rows[cfg.name] = {"ratio": r["ratio"], "in_band": ok}
        streams.append(s)

    tasks, index = stream_sweep_tasks(streams, arch)
    store = ResultStore(store_dir) if store_dir else None
    t0 = time.time()
    res = union_opt_sweep(
        tasks, engine_backend=backend, engine_workers=0,
        result_store=store, **(sweep_kw or {}),
    )
    sweep_s = time.time() - t0
    stats = res.stats

    # measured collective term per model, when a dryrun artifact exists
    coll_s, art_recon = {}, {}
    for s in streams:
        base_model = s.model[:-len("_smoke")] if s.model.endswith("_smoke") else s.model
        p = artifact_path(base_model, s.shape, art_dir=art_dir)
        if not p.exists():
            continue
        art = json.loads(p.read_text())
        coll_s[s.model] = measured_collective_s(art)
        art_recon[s.model] = reconcile_with_artifact(s, art)
    if not coll_s:
        print(f"[model] no dryrun artifacts under {art_dir} for shape "
              f"{shape.name}; collective term = 0 (modeled compute only)")

    costs = aggregate_stream_costs(streams, index, res.solutions, arch,
                                   collective_s=coll_s)
    rows = []
    for s, c in zip(streams, costs):
        row = c.row()
        row.update({
            "kind": s.kind,
            "tokens_per_step": s.meta["tokens_per_step"],
            "n_ops_pre_dedup": s.meta["n_ops_pre_dedup"],
            "stream_flops": s.total_flops(),
            "reconcile": recon_rows[s.model],
        })
        if s.model in art_recon:
            row["artifact_reconcile"] = art_recon[s.model]
        rows.append(row)
        print(f"[model] {s.model:28s} {shape.name:14s} "
              f"ops {row['n_ops_pre_dedup']:4.0f} -> {row['n_unique_ops']:3d} uniq | "
              f"lat {c.latency_s:.3e}s en {c.energy_j:.3e}J "
              f"edp {c.edp:.3e} | flops-ratio {recon_rows[s.model]['ratio']:.3f}")
    print(f"[model] ONE sweep: {len(tasks)} tasks -> {stats['engines']} engine "
          f"groups, cache_hits {stats.get('cache_hits', 0)}, "
          f"store_hits {stats.get('store_hits', 0)}, "
          f"{stats.get('evals_per_s', 0):,.0f} evals/s ({sweep_s:.1f}s)")

    result = {
        "figure": "model",
        "smoke": smoke,
        "shape": shape.name,
        "backend": backend,
        "models": [s.model for s in streams],
        "rows": rows,
        "sweep_stats": {k: v for k, v in stats.items() if k != "group_wall"},
        "sweep_seconds": round(sweep_s, 3),
    }
    if store is not None:
        store.flush()
        if not deterministic_stats():
            result["result_store"] = store.stats_dict()
            print(f"[model] result store: {result['result_store']}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "model.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced (_smoke) configs on a small shape")
    ap.add_argument("--models", default=",".join(MODELS),
                    help="comma list of model config names")
    ap.add_argument("--shape", default=None,
                    help="shape cell name (default: smoke shape / decode_32k)")
    ap.add_argument("--backend", default="numpy",
                    help="evaluation-engine miss-batch backend")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="persistent cross-run ResultStore directory")
    ap.add_argument("--art-dir", default="experiments/dryrun",
                    help="dryrun artifact directory for the measured "
                         "collective term (the port's dry-run writes "
                         "experiments/torch/dryrun)")
    add_sweep_args(ap)
    args = ap.parse_args(argv)
    return run(smoke=args.smoke,
               models=[m.strip() for m in args.models.split(",") if m.strip()],
               shape_name=args.shape, backend=args.backend,
               store_dir=args.store, sweep_kw=sweep_kwargs(args),
               art_dir=args.art_dir)


if __name__ == "__main__":
    main()
