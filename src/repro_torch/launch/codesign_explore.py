"""HW-SW co-design exploration on one H100 (twin of
``examples/codesign_explore.py``): the paper's case studies on one
operator, then the loop closed on the card.

Given one tensor op (a GEMM from an LM FFN), explore:
  (b) mapping     -- mapper/cost-model grid            (paper Sec. V-B)
  (c) hardware    -- aspect ratios + chiplet fill bw   (paper Sec. V-B/C)
on the paper's accelerators (the same numbers the JAX example prints), and
close the loop on the H100: the GEMM, its N padded as the JAX example pads
it, is planned on ``h100_sm()`` in both matmul spaces, launched with each
planned CTA tile (bf16 on the wgmma instance, f32 on the FMA instance),
checked against its plain version and timed beside ``torch.matmul``.

Run:  PYTHONPATH=src python -m repro_torch.launch.codesign_explore [--device cpu]

``--device cuda`` (the default) launches the CUDA kernels and raises
without a card; ``--device cpu`` runs the kernels' plain versions and
times nothing.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.codesign import time_launches
from repro_torch.core.architecture import chiplet_accelerator, cloud_accelerator
from repro_torch.core.optimizer import union_opt
from repro_torch.core.problem import Problem
from repro_torch.kernels.matmul import instance_for, matmul, plan_tiles
from repro_torch.kernels.matmul.matmul import matmul_cuda
from repro_torch.kernels.matmul.ref import product_check

# the operator under study: a d_ff=8960 x d=2048 FFN GEMM at batchxseq=4096
FFN = (4096, 8960, 2048)
# the launched GEMM: N padded by 256 to a multiple of 128, as the JAX example pads it
GEMM = (FFN[0], FFN[1] + 128 * 2, FFN[2])


def ffn_problem() -> Problem:
    M, N, K = FFN
    return Problem.gemm(M, N, K, name="ffn_gemm", word_bytes=1)


def explore_mappers(P: Problem) -> None:
    print("== (b) mapping exploration: mapper x cost model ==")
    for cm in ("timeloop", "maestro"):
        for mp in ("heuristic", "genetic", "random"):
            sol = union_opt(P, cloud_accelerator(), mapper=mp, cost_model=cm, metric="edp")
            print(f"  {cm:9s} x {mp:9s}: EDP {sol.cost.edp:.3e} "
                  f"util {sol.cost.utilization:5.0%} ({sol.search.evaluated} evals)")


def explore_hardware(P: Problem) -> None:
    print("\n== (c) hardware exploration: aspect ratio ==")
    for aspect in ((1, 2048), (8, 256), (32, 64)):
        sol = union_opt(P, cloud_accelerator(aspect=aspect), mapper="heuristic",
                        cost_model="maestro", metric="edp")
        print(f"  {aspect[0]:2d}x{aspect[1]:<4d}: EDP {sol.cost.edp:.3e} "
              f"util {sol.cost.utilization:5.0%}")

    print("\n== (c') hardware exploration: chiplet fill bandwidth ==")
    for bw in (1e9, 4e9, 16e9):
        sol = union_opt(P, chiplet_accelerator(fill_bandwidth=bw),
                        mapper="heuristic", cost_model="timeloop", metric="edp")
        print(f"  fill {bw/1e9:4.0f} GB/s: EDP {sol.cost.edp:.3e}")


def close_loop(M: int, N: int, K: int, device: str, seed: int = 0) -> dict:
    """Plan (M, N, K) on ``h100_sm()`` in each dtype's space, launch the
    product with each planned tile (bf16: the wgmma instance; f32: the FMA
    instance), hold it against its plain version (``product_check``: f32
    within sqrt(K) u |a||b| of a float64 evaluation, bf16 within rtol =
    atol = 2e-2 of ``matmul_ref``) and, on the card, time it beside
    ``torch.matmul`` with CUDA events (best of 3 windows of 10 calls,
    inputs warm in L2). On the
    CPU the plain version runs and nothing is timed. Returns one row per
    dtype."""
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device)
    w = torch.randn((K, N), generator=gen, device=device)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        xd, wd = x.to(dtype), w.to(dtype)
        tiles = plan_tiles(M, N, K, dtype=dtype)
        inst = instance_for(xd, wd)
        before = dict(matmul_cuda.launches_by_instance)
        got = matmul(xd, wd, tiles=tiles)
        if on_card:
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in matmul_cuda.launches_by_instance.items()}
            if launched[inst] != 1:
                raise RuntimeError(f"{dtype}: no launch on the {inst} instance ({launched})")
        err, ratio, rule = product_check(got, xd, wd)
        if not ratio <= 1.0:
            raise AssertionError(f"matmul {M}x{N}x{K} {dtype} tile {tiles}: max abs err {err}, "
                                 f"worst |err| / limit {ratio:.3f} ({rule})")
        row = {"dtype": str(dtype)[6:], "tiles": list(tiles), "instance": inst,
               "max_abs_err": err, "rule": f"{rule}; worst |err| / limit {ratio:.3f}",
               "kernel_ms": None, "torch_matmul_ms": None}
        if on_card:
            row["kernel_ms"] = time_launches(lambda: matmul(xd, wd, tiles=tiles), device) * 1e3
            row["torch_matmul_ms"] = time_launches(lambda: torch.matmul(xd, wd), device) * 1e3
        rows[row["dtype"]] = row
        del got
    return rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False

    P = ffn_problem()
    explore_mappers(P)
    explore_hardware(P)

    print("\n== closing the loop on the H100 ==")
    M, N, K = GEMM
    rows = close_loop(M, N, K, args.device)
    for r in rows.values():
        times = ("not measured (no card)" if r["kernel_ms"] is None else
                 f"kernel {r['kernel_ms']:.4f} ms ({2 * M * N * K / r['kernel_ms'] / 1e9:.1f} "
                 f"TFLOP/s), torch.matmul {r['torch_matmul_ms']:.4f} ms (kernel / torch.matmul "
                 f"{r['kernel_ms'] / r['torch_matmul_ms']:.3f})")
        where = (f"on the {r['instance']} instance" if args.device == "cuda"
                 else f"(cpu: the plain version; the card runs the {r['instance']} instance)")
        print(f"  {M}x{N}x{K} {r['dtype']}: CTA tile (bm,bn,bk) = {tuple(r['tiles'])} {where}; "
              f"vs plain version max abs err "
              f"{r['max_abs_err']:.3g} ({r['rule']}); {times}")
    print("OK")
    return rows


if __name__ == "__main__":
    main()
