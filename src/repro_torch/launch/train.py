"""Training entry point (port of ``repro/launch/train.py``).

Wires config registry -> model -> train step -> deterministic data
pipeline, and runs the steps eagerly on one device. ``--device cuda`` (the
default; raises without a card) switches the CUDA kernels on (flash
attention, the Mamba-2 SSD scan); ``--device cpu`` trains with the plain
versions.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch zamba2-2.7b_smoke --steps 8 --batch 2 --seq 64

Not ported yet: ``--mesh`` (the distributed layer, ROADMAP A12) and
``--ckpt-dir`` (checkpoints and the fault-tolerant runner, ROADMAP A10);
both raise.
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, TokenFileDataset, make_pipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import adamw, cosine_schedule, lion

log = logging.getLogger("repro_torch.train")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", choices=["adamw", "lion"], default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="", help="not ported yet (ROADMAP A12)")
    ap.add_argument("--ckpt-dir", default="", help="not ported yet (ROADMAP A10)")
    ap.add_argument("--data", default="synthetic", help="'synthetic' or a token file path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError("--mesh: the distributed layer is not ported yet (ROADMAP A12)")
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir: checkpoints and the fault-tolerant runner are "
                                  "not ported yet (ROADMAP A10)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    kernels.enable_kernels(args.device == "cuda")
    cfg = get_config(args.arch)

    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    optimizer = {"adamw": adamw, "lion": lion}[args.optimizer](lr)
    step_fn = steps_mod.make_train_step(
        cfg, optimizer, remat=not args.no_remat, microbatches=args.microbatches
    )
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    state = steps_mod.make_init_state(cfg, optimizer, args.device)(gen)

    if args.data == "synthetic":
        source = SyntheticLM(cfg.vocab, seed=args.seed)
    else:
        source = TokenFileDataset(args.data, cfg.vocab, seed=args.seed)
    pipe = make_pipeline(source, args.batch, args.seq, device=args.device,
                         data_cfg=DataConfig(seed=args.seed))

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    losses, step_s = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = next(pipe)
        sync()
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        sync()
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %-5d loss %.4f  (%.2f s/step avg)",
                     step, loss, (time.perf_counter() - t0) / (step + 1))
    pipe.close()
    if not losses:
        return {"first_loss": float("nan"), "last_loss": float("nan"), "steps": 0,
                "losses": [], "step_s": []}
    return {"first_loss": losses[0], "last_loss": losses[-1], "steps": len(losses),
            "losses": losses, "step_s": step_s}


if __name__ == "__main__":
    out = main()
    print(f"train done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"over {out['steps']} steps")
