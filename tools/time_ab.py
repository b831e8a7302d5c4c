"""Time the port's serving decode and its SSD kernel on one card, for
whichever ``repro_torch`` is first on PYTHONPATH, so that two checkouts can
be compared on one machine.

    PYTHONPATH=src python3 tools/time_ab.py --label change

To compare a change with its parent, unpack the parent into a directory git
ignores and run, in one machine allocation, parent, change, change, parent:

    for t in parent change change parent; do
      PYTHONPATH=$DIR_OF_$t/src python3 tools/time_ab.py --label $t; done

Each run prints, stamped with the card and its power limit, then as one JSON
line (CUDA events; inputs rotated over sets larger than the L2):

- flash attention at qwen3-0.6b's serving decode shape (b=8, 16/8 heads of
  128, a 512-slot cache, kv_len 512, bf16) through the public op, beside
  ``scaled_dot_product_attention``: eager calls (the host's dispatch
  included, as the serving loop pays it) and CUDA-graph replay (device
  time);
- the decode step of qwen3-0.6b at full width (random weights from a seed),
  b=8 at positions 200-219, kernels on and off, in turns;
- the SSD intra-chunk kernel at zamba2-2.7b's training shape (b=2, 2048
  steps, 80 heads of 64, state 64, chunk 256, f32, B/C at stride 0);
- the matmul op (the checkout's planned tile on the instance it routes
  to) at the co-design loop's four calibration shapes, in f32 and bf16,
  beside ``torch.matmul`` (TF32 off).

The script imports nothing but ``torch`` and the port.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda
from repro_torch.models import decode_step, init_cache, init_params

DECODE = dict(b=8, hq=16, hkv=8, d=128, cache=512)
SSD = dict(b=2, l=2048, nh=80, hp=64, n=64, cl=256)
ARCH, SLOTS, MAX_LEN = "qwen3-0.6b", 8, 512
MATMUL_SHAPES = [(512, 3072, 768), (1024, 1024, 1024), (4096, 3072, 1024), (4096, 10240, 2560)]


def _time_ms(fn, n, warmup=10) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _turns(fns: dict, timer) -> dict:
    """Each callable timed in turns (a, b, c, c, b, a); the best of its two."""
    ms = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        ms[name].append(timer(name))
    return {name: min(v) for name, v in ms.items()}


def _graph_ms(fns: dict, n: int, replays: int = 10) -> dict:
    """Device time per call: n calls of each callable captured in one CUDA
    graph (after a warm-up outside it), the graphs replayed in turns."""
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(n):
                fn()

    def replay(name):
        graphs[name].replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * n)

    return _turns(fns, replay)


def _rotating(sets):
    it = iter(range(1 << 30))
    return lambda: sets[next(it) % len(sets)]


def decode_attention(gen) -> dict:
    b, hq, hkv, d, cache = DECODE.values()
    sets = [tuple(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                  for shape in ((b, 1, hq, d), (b, cache, hkv, d), (b, cache, hkv, d)))
            for _ in range(8)]
    pick = _rotating(sets)
    kw = dict(causal=False, q_offset=cache - 1, kv_len=cache)
    fns = {
        "kernel": lambda: flash_attention(*pick(), **kw),
        "sdpa": lambda: (lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True))(*pick()),
    }
    eager = _turns(fns, lambda name: _time_ms(fns[name], n=200))
    graph = _graph_ms(fns, n=100)
    return {"eager_ms": eager, "graph_ms": graph}


def decode_step_ms(gen) -> dict:
    cfg = get_config(ARCH)
    model = init_params(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen, device="cuda")

    def run(on: bool) -> float:
        kernels.enable_kernels(on)
        cache = init_cache(cfg, SLOTS, MAX_LEN, "cuda")
        for _ in range(3):
            decode_step(cfg, model, cache, toks, 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(20):
            decode_step(cfg, model, cache, toks, 200 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 20 * 1e3

    ms = _turns({"kernels_on": True, "kernels_off": False},
                lambda name: run(name == "kernels_on"))
    kernels.enable_kernels(True)
    return ms


def ssd_kernel_ms(gen) -> float:
    b, l, nh, hp, n, cl = SSD.values()

    def inputs():
        x = torch.randn((b, l, nh, hp), generator=gen, device="cuda") * 0.5
        dA = -torch.nn.functional.softplus(torch.randn((b, l, nh), generator=gen, device="cuda"))
        B, C = (torch.randn((b, l, 1, n), generator=gen, device="cuda").mul_(0.5).expand(
            b, l, nh, n) for _ in range(2))
        return x, dA, B, C

    pick = _rotating([inputs() for _ in range(4)])
    return min(_time_ms(lambda: ssd_intra_chunk_cuda(*pick(), cl), n=20, warmup=3)
               for _ in range(2))


def matmul_ms(gen) -> dict:
    """The matmul op and torch.matmul, in turns, at each calibration shape
    and dtype; inputs rotated over sets larger than the L2."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K in MATMUL_SHAPES:
            set_bytes = torch.empty((), dtype=dtype).element_size() * (M * K + K * N + M * N)
            pick = _rotating([
                (torch.randn((M, K), generator=gen, device="cuda").to(dtype),
                 torch.randn((K, N), generator=gen, device="cuda").to(dtype))
                for _ in range(max(2, math.ceil(150e6 / set_bytes)))])
            n = max(3, min(50, int(2e11 / (2 * M * N * K))))
            fns = {"kernel": lambda: matmul(*pick()), "torch": lambda: torch.matmul(*pick())}
            out[f"{M}x{N}x{K} {str(dtype)[6:]}"] = _turns(
                fns, lambda name: _time_ms(fns[name], n=n, warmup=2))
            del pick
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="name of the checkout, printed with its times")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_ab.py needs an NVIDIA GPU")
    stamp = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {"label": args.label, "card": stamp, "decode_attention": decode_attention(gen)}
    res["decode_step_ms"] = decode_step_ms(gen)
    res["ssd_kernel_ms"] = ssd_kernel_ms(gen)
    torch.backends.cuda.matmul.allow_tf32 = False
    res["matmul_ms"] = matmul_ms(gen)
    a = res["decode_attention"]
    print(f"[{stamp}] {args.label}: decode attention eager kernel {a['eager_ms']['kernel']:.4f} "
          f"ms, sdpa {a['eager_ms']['sdpa']:.4f} ms; graph replay kernel "
          f"{a['graph_ms']['kernel']:.4f} ms, sdpa {a['graph_ms']['sdpa']:.4f} ms; decode step "
          f"kernels on {res['decode_step_ms']['kernels_on']:.3f} ms, off "
          f"{res['decode_step_ms']['kernels_off']:.3f} ms; ssd kernel "
          f"{res['ssd_kernel_ms']:.4f} ms")
    for key, ms in res["matmul_ms"].items():
        print(f"[{stamp}] {args.label}: matmul {key}: kernel {ms['kernel']:.4f} ms, torch.matmul "
              f"{ms['torch']:.4f} ms")
    assert all(math.isfinite(x) for x in (a["eager_ms"]["kernel"], res["ssd_kernel_ms"],
                                          *(ms["kernel"] for ms in res["matmul_ms"].values())))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
