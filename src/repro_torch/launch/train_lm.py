"""Train a ~100M-param qwen3-family LM on the synthetic pipeline, with
checkpointing and fault tolerance, and report the loss curve (twin of
``examples/train_lm.py``).

The same ``repro_torch.launch.train`` entry point the card's training runs
use; only the config differs. ~100M params:
  14 layers x d_model 576 x heads 8 (GQA kv 4) x d_ff 2048, vocab 32768
  => ~105M params. A few hundred steps of batch 16 x seq 256.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] [--device cpu]

``--device cuda`` (the default) trains on the card with the kernels on and
raises without one. ``--smoke`` trains the config's reduced sibling (4
layers, d_model 64, vocab 512) for a quick check on the CPU. Checkpoints go
to ``--ckpt-dir`` (default ``experiments/torch/lm100m`` under the working
directory); run it again with the same one and it resumes from the latest
checkpoint there.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import ModelConfig, get_config, register
from repro_torch.launch import train as train_mod

CFG_100M = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=14,
    d_model=576,
    n_heads=8,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32768,
    qk_norm=True,
    rope_theta=1e4,
    notes="~100M-param example model (qwen3 family shape)",
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="experiments/torch/lm100m",
                    help="under the working directory unless absolute")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the reduced config (CPU check)")
    args = ap.parse_args(argv)

    register(CFG_100M)
    arch = CFG_100M.name + ("_smoke" if args.smoke else "")
    cfg = get_config(arch)
    print(f"training {cfg.name}: {cfg.num_params() / 1e6:.0f}M params, "
          f"{args.steps} steps x ({args.batch} x {args.seq}) tokens on {args.device}")
    out = train_mod.main([
        "--arch", arch,
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--lr", "6e-4", "--warmup", "40",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "20",
        "--device", args.device,
    ])
    if not out["steps"]:
        print(f"nothing to do: {args.ckpt_dir} holds a checkpoint at or after step {args.steps}")
        return out
    drop = out["first_loss"] - out["last_loss"]
    print(f"\nloss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"(drop {drop:.3f} over {out['steps']} steps)")
    want = 0.3 if args.steps >= 100 else 0.02  # short runs: sanity only
    if drop <= want:
        sys.exit(f"FAIL: expected the loss to drop by > {want}")
    print("OK")
    return out


if __name__ == "__main__":
    main()
