"""Training entry point (port of ``repro/launch/train.py``).

Wires config registry -> model -> train step -> deterministic data
pipeline -> checkpoint manager (atomic, async, in the reference's format)
-> fault-tolerant runner (retry / restore / straggler watchdog), and runs
the steps eagerly on one device. ``--device cuda`` (the default; raises
without a card) switches the CUDA kernels on (flash attention, the Mamba-2
SSD scan); ``--device cpu`` trains with the plain versions.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-0.6b_smoke --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir experiments/torch/run1

Run the same command again and it resumes from the latest checkpoint in
``--ckpt-dir`` (the data pipeline restarts at that step). With
``--deterministic`` a resumed run repeats an unbroken one bit for bit.

``--mesh a,b[,c]`` trains on a ``DeviceMesh`` over ``("pod", "data",
"model")[-len(dims):]``, one rank per process, the process group from
torchrun's environment (NCCL on ``--device cuda``, gloo on ``--device
cpu``; gloo on cuda where the caller initialised it, for ranks sharing a
card); the world size must equal the mesh's. Parameters, moments and
master weights are DTensors placed by the reference's sharding rules
(``sharding.specs.state_specs``), batches by ``batch_specs``; the step is
``steps.make_sharded_train_step``, partitioned: FSDP per unit over "data"
(and "pod"), tensor and sequence parallelism over "model". Checkpoints
keep the reference's format (rank 0 writes) and a resume re-places them
on the mesh.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --arch qwen3-0.6b_smoke --mesh 2,2 --steps 8 --batch 4 --seq 64
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import DataConfig, SyntheticLM, TokenFileDataset, make_pipeline
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk_cuda
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import adamw, cosine_schedule, lion
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig
from repro_torch.sharding.hints import clear_hints, hints_from_mesh
from repro_torch.sharding.specs import ShardingRules, batch_specs, named, state_specs

log = logging.getLogger("repro_torch.train")


def main(argv=None, *, fault_hook: Optional[Callable[[int], None]] = None,
         update_hook: Optional[Callable[[int], None]] = None) -> dict:
    """Train; returns the losses, per-step seconds, the runner's stats, the
    checkpoint records and the kernels' launch counters. ``fault_hook(step)``
    runs before each attempt of a step and ``update_hook(n)`` after the
    n-th parameter of an update is written (fault injection; either may
    raise). Wall-clock marks (``time.time()``): ``t_main`` on entry,
    ``t_loop`` when the first step starts (after init or restore),
    ``t_first_step`` when it ends, ``t_done`` on return."""
    t_main = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", choices=["adamw", "lion"], default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="", help="e.g. '1,1', '2,2' or '2,16,16' (under torchrun)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic", help="'synthetic' or a token file path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--step-timeout", type=float, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms: runs repeat bit for bit")
    ap.add_argument("--metrics-out", default="", help="write the returned dict here as JSON")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    own_group = args.mesh and not dist.is_initialized()
    try:
        return _main(args, t_main, fault_hook, update_hook)
    finally:
        if args.mesh:
            clear_hints()
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def build_mesh(spec: str, device: str):
    """``--mesh`` -> a DeviceMesh over ("pod", "data", "model")[-len(dims):],
    on the process group of torchrun's environment (initialised here unless
    the caller has): NCCL for cuda, gloo for cpu. A caller may initialise
    gloo for cuda: ranks sharing a card (NCCL refuses two ranks on one
    device), rank ``LOCAL_RANK`` on card ``LOCAL_RANK % device_count``."""
    from repro_torch.launch.mesh import make_mesh

    dims = [int(x) for x in spec.split(",")]
    names = ("pod", "data", "model")[-len(dims):]
    backend = {"cuda": "nccl", "cpu": "gloo"}[device]
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    allowed = {backend, "gloo"} if device == "cuda" else {backend}
    if dist.get_backend() not in allowed:
        raise RuntimeError(f"--mesh on {device} needs the {backend} backend; the process group "
                           f"is {dist.get_backend()}")
    if dist.get_world_size() != math.prod(dims):
        raise RuntimeError(f"--mesh {spec} needs {math.prod(dims)} ranks; the world has "
                           f"{dist.get_world_size()}")
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return make_mesh(dims, names, device_type=device)


def _main(args, t_main, fault_hook, update_hook) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.deterministic:
        # cuBLAS reads this when its handle is made, before the first product
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    kernels.enable_kernels(args.device == "cuda")
    cfg = get_config(args.arch)
    mesh = build_mesh(args.mesh, args.device) if args.mesh else None
    rules = ShardingRules()
    if mesh is not None:
        hints_from_mesh(mesh, rules)

    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    optimizer = {"adamw": adamw, "lion": lion}[args.optimizer](lr)
    agree = None
    if mesh is None:
        step_fn = steps_mod.make_train_step(cfg, optimizer, remat=not args.no_remat,
                                            microbatches=args.microbatches,
                                            update_hook=update_hook)
    else:
        agree = steps_mod.make_agree(args.device)
        step_fn = steps_mod.make_sharded_train_step(
            cfg, optimizer, mesh, agree=agree, rules=rules, remat=not args.no_remat,
            microbatches=args.microbatches, update_hook=update_hook)

    # ---- init / restore ------------------------------------------------ #
    state, start_step, restore_s, ckpt, st_sh = None, 0, None, None, None
    meta_state = steps_mod.make_init_state(cfg, optimizer, "meta")(None)
    if mesh is not None:
        st_sh = named(state_specs(meta_state, cfg, mesh, rules), mesh)
    if args.ckpt_dir:
        ckpt = CheckpointManager(Path(args.ckpt_dir), every=args.ckpt_every)
        if latest_step(args.ckpt_dir) is not None:
            # into a structure on the meta device: each leaf (each rank's
            # slice of it, on a mesh) is made once, on the device
            t0 = time.perf_counter()
            state, start_step, _ = ckpt.restore_latest(meta_state, shardings=st_sh,
                                                       device=args.device)
            restore_s = time.perf_counter() - t0
            log.info("restored checkpoint at step %d (%.2f s)", start_step, restore_s)
    if state is None:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        if mesh is None:
            state = steps_mod.make_init_state(cfg, optimizer, args.device)(gen)
        else:  # the same whole weights on every rank; each keeps its slices
            state = steps_mod.init_distributed_state(cfg, optimizer, gen, mesh, rules, args.device)

    # ---- data ----------------------------------------------------------- #
    if args.data == "synthetic":
        source = SyntheticLM(cfg.vocab, seed=args.seed)
    else:
        source = TokenFileDataset(args.data, cfg.vocab, seed=args.seed)
    b_specs = None
    if mesh is not None:
        b_specs = batch_specs(cfg, ShapeConfig("cli", args.seq, args.batch, "train"), mesh, rules)
    pipe = make_pipeline(source, args.batch, args.seq, device=args.device, mesh=mesh,
                         specs=b_specs, start_step=start_step,
                         data_cfg=DataConfig(seed=args.seed))

    def restore_fn():
        # in place: the torn state's tensors (slices) take the checkpoint's values
        st, step, _ = ckpt.restore_latest(state, shardings=st_sh)
        return st, step

    runner = FaultTolerantRunner(step_fn, RunnerConfig(step_timeout_s=args.step_timeout),
                                 checkpoint_manager=ckpt,
                                 restore_fn=restore_fn if ckpt else None,
                                 fault_hook=fault_hook, agree=agree)

    # ---- loop ------------------------------------------------------------ #
    losses, step_s, saved = [], [], None
    t_loop, t_first_step = time.time(), None
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = next(pipe)
        ts = time.perf_counter()
        state, metrics = runner.run_step(state, batch, step)  # waits for the device
        step_s.append(time.perf_counter() - ts)
        t_first_step = t_first_step or time.time()
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            log.info("step %-5d loss %.4f  (%.2f s/step avg)",
                     step, loss, (time.perf_counter() - t0) / (step - start_step + 1))
        if ckpt is not None and ckpt.should_save(step + 1):
            ckpt.save(step + 1, state, extra={"loss": loss})
            saved = step + 1
    pipe.close()
    out = {"steps": len(losses), "start_step": start_step, "losses": losses, "step_s": step_s,
           "stats": [vars(s) for s in runner.stats], "restore_s": restore_s,
           "peak_bytes": torch.cuda.max_memory_allocated() if args.device == "cuda" else None,
           "t_main": t_main, "t_loop": t_loop, "t_first_step": t_first_step,
           "launches": {"flash_attention": flash_attention_cuda.launches,
                        "ssd_scan": ssd_intra_chunk_cuda.launches}}
    if losses:  # else resumed at/after the target step: nothing to do
        if ckpt is not None and saved != args.steps:
            ckpt.save(args.steps, state, extra={"loss": losses[-1]})
        out.update(first_loss=losses[0], last_loss=losses[-1])
    else:
        out.update(first_loss=float("nan"), last_loss=float("nan"))
    if ckpt is not None:
        ckpt.wait()
        if mesh is not None:  # every rank returns once rank 0's writes are complete
            dist.barrier()
        out["checkpoints"] = ckpt.records
    out["t_done"] = time.time()
    if mesh is not None:
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if args.metrics_out and (mesh is None or dist.get_rank() == 0):
        Path(args.metrics_out).write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    out = main()
    print(f"train done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"over {out['steps']} steps")
