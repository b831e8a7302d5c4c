"""Quickstart: the Union co-design loop on one H100 (twin of
``examples/quickstart.py``).

1. Describe a tensor operation as a Union Problem (here: lower a LayerOp).
2. Describe an accelerator as a cluster hierarchy.
3. Let Union-opt search the map-space with a mapper x any cost model.
4. Read the mapping back as a loop nest -- and, on the H100 hierarchy
   (HBM -> CTAs on 132 SMs -> shared memory), as the CTA tile the CUDA
   matmul kernel launches with; launch it and check it.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

``--device cuda`` (the default) launches the CUDA kernel and raises without
a card; ``--device cpu`` runs the kernel's plain version.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import codesign
from repro_torch.core.architecture import cloud_accelerator, h100_sm
from repro_torch.core.constraints import tc_aligned
from repro_torch.core.ir.dialects import LayerOp, TensorType
from repro_torch.core.ir.lowering import lower_layer_to_problem
from repro_torch.core.optimizer import union_opt
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.matmul import matmul, plan_for
from repro_torch.kernels.matmul.matmul import matmul_cuda
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda

GEMM = (512, 3072, 768)  # step 4's matmul, as in the JAX quickstart
TOL = 2e-4
# what the loop calibrates on the card, per kernel space: step 4's GEMM,
# a cube, qwen3-0.6b's gate/up projection at 4096 tokens and zamba2-2.7b's
# FFN up projection at 2 x 2048 tokens; attention at the serving decode
# shape (qwen3-0.6b, cache 512) and zamba2-2.7b's training shape; zamba2's
# SSD head and state dims
MATMUL_SHAPES = [GEMM, (1024, 1024, 1024), (4096, 3072, 1024), (4096, 10240, 2560)]
CALIBRATION_SHAPES = {
    "matmul_h100": MATMUL_SHAPES,  # the f32 FMA instance
    "matmul_bf16_h100": MATMUL_SHAPES,  # the bf16 wgmma + TMA instance
    "flash_attention_h100": [(1, 512, 128), (2048, 2048, 80)],
    "ssd_scan_h100": [(64, 64)],
}


def kernel_launches() -> int:
    """Launches of the three CUDA kernels so far (0 on the CPU)."""
    return matmul_cuda.launches + flash_attention_cuda.launches + ssd_intra_chunk_cuda.launches


def run_matmul(M: int, N: int, K: int, device: str, seed: int = 0) -> dict:
    """Step 4: plan (M, N, K) on the H100 hierarchy in each dtype's space
    (f32: the FMA instance's ``matmul_h100``; bf16: the wgmma instance's
    ``matmul_bf16_h100``), launch the kernel with each planned tile, and
    check each against its plain version (f32 within ``TOL``; bf16 against
    the plain version on the same bf16 inputs, within ``TOL`` of the
    output's scale). Each product is planned by ``plan_for``, in the space
    of the instance it routes to."""
    before = kernel_launches()
    by_instance = dict(matmul_cuda.launches_by_instance)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device)
    w = torch.randn((K, N), generator=gen, device=device)
    errs, tiles = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dtype), w.to(dtype)
        tiles[dtype] = plan_for(xd, wd)
        got = matmul(xd, wd, tiles=tiles[dtype], out_dtype=torch.float32)
        want = matmul_ref(xd, wd, torch.float32)
        err = (got - want).abs().max().item()
        if not err <= TOL * (1.0 + want.abs().max().item()):
            raise AssertionError(f"matmul {dtype} with tiles {tiles[dtype]}: max abs err {err:.3e}")
        errs[str(dtype).replace("torch.", "")] = err
    return {"shape": [M, N, K], "tiles": list(tiles[torch.float32]),
            "tiles_by_dtype": {str(t)[6:]: list(v) for t, v in tiles.items()},
            "max_abs_err": errs, "launches": kernel_launches() - before,
            "launches_by_instance": {k: v - by_instance[k]
                                     for k, v in matmul_cuda.launches_by_instance.items()}}


def calibrate(device: str, shapes=None, repeats: int = 3, iters: int = 10):
    """Close the loop for every kernel space: plan each shape, predict its
    cost, time the kernel with the planned tile (``calibrate_kernel``) and
    report, per row, the planned and the default config, the plan's
    source, the default's predicted cycles over the plan's, the predicted
    and measured seconds, the model's error after the per-kernel scale and
    the kernel launches the row's calibration made. Returns (rows,
    {space: scale}); CPU rows are ``interpret`` rows."""
    shapes = CALIBRATION_SHAPES if shapes is None else shapes
    on_device = torch.device(device).type == "cuda"
    table = codesign.CalibrationTable()
    rows = []
    for name, shape_list in shapes.items():
        space = codesign.get_space(name)
        for shape in shape_list:
            p = codesign.plan(space, shape)
            default = space.legalize(space.default_config(shape), shape)
            d_cost = codesign.predict_cost(space, shape, default)
            before = kernel_launches()
            codesign.calibrate_kernel(space, [shape], table, device=device, repeats=repeats,
                                      iters=iters)
            rows.append({"kernel": name, "shape": list(shape), "config": list(p.config),
                         "source": p.source, "default_config": list(default),
                         "default_over_planned": d_cost.latency_cycles / p.cost.latency_cycles,
                         "predicted_s": p.cost.latency_s,
                         "launches": kernel_launches() - before})
    report = {(r["kernel"], tuple(r["shape"])): r
              for r in table.model_error_report(interpret=not on_device)}
    for row in rows:
        rep = report[(row["kernel"], tuple(row["shape"]))]
        row.update(measured_s=rep["measured_s"], error_pct=rep["error_pct"],
                   interpret=rep["interpret"])
    scales = {name: table.scale_for(name, interpret=not on_device).scale for name in shapes}
    return rows, scales


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")

    # -- 1. a workload: one BERT FFN GEMM, written as a domain-level LayerOp --
    op = LayerOp(
        "bert_ffn", "linear",
        {"x": TensorType((256, 768)), "w": TensorType((768, 3072))},
        {"y": TensorType((256, 3072))},
    )
    problem = lower_layer_to_problem(op)  # TOSA-ish -> linalg-ish -> affine -> Problem
    print(f"problem: {problem}\n")

    # -- 2+3. one accelerator, two cost models, one mapper API --------------
    for cm in ("timeloop", "maestro"):
        arch = cloud_accelerator()
        sol = union_opt(problem, arch, mapper="heuristic", cost_model=cm, metric="edp")
        print(f"{arch.name} x {cm:8s}: EDP {sol.cost.edp:.3e} J*s, "
              f"utilization {sol.cost.utilization:.0%}")

    # -- 4. the same machinery tiles the CUDA matmul kernel ------------------
    M, N, K = GEMM
    res = run_matmul(M, N, K, args.device)
    print(f"\nUnion-planned CTA tiles for a {M}x{N}x{K} matmul on one H100: "
          f"bm,bn,bk = {tuple(res['tiles'])} (f32, FMA instance), "
          f"{tuple(res['tiles_by_dtype']['bfloat16'])} (bf16, wgmma instance)")
    print(f"kernel ({args.device}) with the planned tile matches the plain version: "
          f"max abs err {res['max_abs_err']}")

    # -- bonus: the mapping rendered as the paper's loop-nest form ------------
    sol = union_opt(problem, h100_sm(), mapper="heuristic", cost_model="timeloop",
                    metric="latency",
                    constraints=tc_aligned({"b": 64, "o": 64, "i": 16}, ("b", "o")))
    print("\nloop nest (paper Fig. 5e form) on the H100 hierarchy:")
    print(sol.loop_nest())
    return res


if __name__ == "__main__":
    main()
