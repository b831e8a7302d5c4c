"""The partitioned train step on a 2x2 mesh against the unmeshed step, in
f32 and in bf16, from one seed and one batch: the loss, the grads' global
norm and each leaf's, and the gaps between the four runs (each bf16 run
against the f32 one as well: bf16's own rounding). 4 gloo ranks; on the
card they share it.

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tools/mesh_gap.py xlstm-1.3b 6 2 2048 cuda

Arguments: arch, layers (the config cut in depth), batch, sequence,
device. Prints one JSON object (rank 0)."""
import dataclasses
import json
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.configs.base import register
from repro_torch.data import SyntheticLM
from repro_torch.data.pipeline import _place
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.sharding.hints import clear_hints, hints_from_mesh
from repro_torch.sharding.specs import ShardingRules, batch_specs

arch, n_layers, B, S, dev = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
dist.init_process_group("gloo", init_method="env://")
rank, world = dist.get_rank(), dist.get_world_size()
if dev == "cuda":
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
full = get_config(arch)
cfg = register(dataclasses.replace(full, name=f"{full.name}-{n_layers}l-gap", n_layers=n_layers))
batch_np = SyntheticLM(cfg.vocab, seed=0).batch(0, B, S)
mesh = make_mesh((2, 2), ("data", "model"), device_type=dev)
rules = ShardingRules()
opt = adamw(1e-4)
out = {}


def sync():
    if dev == "cuda":
        torch.cuda.synchronize()


for dt in ("f32", "bf16"):
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    if dt == "f32":
        model = model.float()
    names = [k for k, _ in model.named_parameters()]
    if rank == 0:
        sync()
        t0 = time.perf_counter()
        loss, grads = steps.make_grads_fn(cfg)(model, {"tokens": torch.from_numpy(batch_np["tokens"]).to(dev)})
        sync()
        out[f"plain_{dt}"] = {"loss": float(loss), "s": time.perf_counter() - t0,
                              "leaf": {k: float(grads[k].double().square().sum()) for k in names}}
        del grads
    dist.barrier()
    hints_from_mesh(mesh, rules)
    try:
        state = steps.distribute_state({"model": model, "opt": opt.init({})}, cfg, mesh, rules)
        fn = steps.make_sharded_train_step(cfg, opt, mesh, agree=steps.make_agree(dev), rules=rules)
        placed = _place(batch_np, mesh, batch_specs(cfg, ShapeConfig("p", S, B, "train"), mesh, rules), dev)
        sync()
        t0 = time.perf_counter()
        loss, grads, norm = fn.grads(state["model"], placed)
        sync()
        secs = time.perf_counter() - t0
        params = dict(state["model"].named_parameters())
        sq = []
        for k in names:
            pl = params[k].placements
            reps = world // max(1, int(torch.tensor([mesh.size(i) for i, p in enumerate(pl)
                                                      if isinstance(p, Shard)]).prod()))
            sq.append(float(grads[k].double().square().sum()) / reps)
        sq = torch.tensor(sq, dtype=torch.float64)
        dist.all_reduce(sq)
        out[f"mesh_{dt}"] = {"loss": float(loss), "norm": float(norm), "s": secs,
                             "leaf": dict(zip(names, sq.tolist())),
                             "modes": sorted(set(fn.partition.modes.values()))}
    finally:
        clear_hints()
    del model, state, grads
    if dev == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()

if rank == 0:
    def total(leaf):
        return sum(leaf.values()) ** 0.5
    rep = {}
    for a, b in (("mesh_f32", "plain_f32"), ("plain_bf16", "plain_f32"), ("mesh_bf16", "plain_bf16"),
                 ("mesh_bf16", "plain_f32")):
        la, lb = out[a]["leaf"], out[b]["leaf"]
        gaps = {k: abs(la[k] ** 0.5 - lb[k] ** 0.5) / max(lb[k] ** 0.5, 1e-30) for k in lb}
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
        rep[f"{a} vs {b}"] = {"loss_gap": abs(out[a]["loss"] - out[b]["loss"]) / abs(out[b]["loss"]),
                              "norm_gap": abs(total(la) - total(lb)) / total(lb), "worst_leaves": worst}
    big = sorted(out["plain_f32"]["leaf"].items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({"cfg": cfg.name, "B": B, "S": S,
                      "runs": {k: {"loss": v["loss"], "norm": total(v["leaf"]), "s": v["s"],
                                   **({"modes": v["modes"], "step_norm": v["norm"]} if "modes" in v else {})}
                               for k, v in out.items()},
                      "largest_leaves_f32": [(k, v ** 0.5) for k, v in big], "gaps": rep}, indent=1))
dist.destroy_process_group()
