"""Serve a small model with batched requests: wave-batched prefill +
lock-step greedy decode through ``WaveServer`` (twin of
``examples/serve_batched.py``).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_batched [--device cpu]

``--device cuda`` (the default) decodes with the flash-attention kernel and
raises without a card; ``--device cpu`` runs its plain version.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, WaveServer
from repro_torch.models import init_params

ARCH = "qwen3-0.6b_smoke"  # reduced config; swap for any decoder arch id


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    kernels.enable_kernels(args.device == "cuda")
    cfg = get_config(ARCH)
    model = init_params(cfg, torch.Generator(device=args.device).manual_seed(0), args.device)
    server = WaveServer(cfg, model, batch_slots=4, max_len=96)

    rng = np.random.default_rng(0)
    n_requests, max_new = 10, 24
    for rid in range(n_requests):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 16))).tolist()
        server.submit(Request(rid, prompt, max_new))

    t0 = time.time()
    done = server.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {args.device})")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:10]}...")
    assert len(done) == n_requests
    print("OK")
    return done


if __name__ == "__main__":
    main()
