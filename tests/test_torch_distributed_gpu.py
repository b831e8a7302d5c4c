"""The distributed layer on the card: world size 1 over NCCL, and 4 gloo
ranks sharing one card.

Marked ``gpu``: each test skips without an NVIDIA GPU. This file imports
neither JAX nor the JAX package, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_distributed_gpu.py

* ``train --mesh 1,1`` on one NCCL rank repeats the unmeshed run bit for
  bit (qwen3-0.6b_smoke, kernels on, ``--deterministic``): the losses of
  every step, as ``chip_smoke.py``'s distributed phase holds at full width.
* The expert-parallel MoE on 4 gloo ranks sharing cuda:0 (mesh (1, 4)) at a
  reduced width (d 256, 12 experts top-4, d_expert 128, 2 shared; f32, TF32
  off, capacity factor 16 >= e_loc: no path drops, by the layer's own
  count and the plain MoE's load) against the port's MoE
  on the whole x, at tests/test_moe_ep.py's tolerances: y rtol = atol =
  2e-4, aux rtol 1e-5, grads rtol = atol = 2e-3. gloo exchanges CUDA
  buffers through host memory (``moe_ep.HOST_STAGED``).
* The partitioned step's tensor-parallel attention on 2 gloo ranks sharing
  cuda:0 (mesh (1, 2)): qwen3-0.6b's attention layer at full width (16/8
  heads of 128, d 1024) in f32, each rank its 8 q and 4 kv heads through
  the flash kernel over the gathered sequence (1 x 512), its sequence
  shard of the output, of the input's grad and its shares of the weights'
  grads against the unsharded layer on the CPU (plain attention), within
  tests/test_kernels.py's f32 flash bound (2e-4 of the largest entry).
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARGS = ["--device", "cuda", "--arch", "qwen3-0.6b_smoke", "--steps", "4", "--batch", "2",
        "--seq", "128", "--warmup", "1", "--deterministic", "--log-every", "1"]
Y_TOL, AUX_RTOL, GRAD_TOL = 2e-4, 1e-5, 2e-3
TP_TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CUDA kernels have no CPU mode")


def _mesh_worker(rank, init, out):
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    from repro_torch.launch import train

    meshed = train.main(ARGS + ["--mesh", "1,1"])
    dist.destroy_process_group()
    straight = train.main(ARGS)
    torch.save({"meshed": meshed["losses"], "straight": straight["losses"],
                "launches": meshed["launches"]["flash_attention"]}, out)


@pytest.mark.gpu
def test_train_mesh_world_1_is_the_unmeshed_run_bit_for_bit(card, tmp_path):
    mp.spawn(_mesh_worker, args=(tmp_path / "init", tmp_path / "out.pt"), nprocs=1)
    r = torch.load(tmp_path / "out.pt")
    assert len(r["meshed"]) == 4 and r["meshed"] == r["straight"]
    assert r["launches"] > 0


def _ep_worker(rank, world, init, out):
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    torch.cuda.set_device(0)
    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe_ep
    from repro_torch.models.moe import MoE
    from repro_torch.sharding.hints import hints_from_mesh
    from repro_torch.sharding.place import from_full, local_index

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), d_model=256, n_routed_experts=12,
                              top_k=4, d_expert=128, n_shared_experts=2, capacity_factor=16.0)
    mesh = make_mesh((1, world), ("data", "model"), device_type="cuda")
    hints_from_mesh(mesh, None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    moe = MoE(cfg, generator=gen, device="cuda").float()
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device="cuda")
    xa = x.clone().requires_grad_(True)
    y0, a0 = moe(xa)
    y0.sum().backward()
    g0 = {n: p.grad.clone() for n, p in moe.named_parameters()}
    moe.zero_grad(set_to_none=True)
    layout = (Shard(0), Shard(1))
    xd = from_full(x, mesh, layout)
    xd.requires_grad_(True)
    moe_ep.DROPPED["assignments"] = 0
    y1, a1 = moe_ep.moe_apply_ep(moe, cfg, xd)
    y1.to_local().sum().backward()
    _, eidx, _ = moe.route(x.reshape(-1, cfg.d_model))
    over = int(torch.bincount(eidx.reshape(-1)).max()) - moe.capacity(eidx.shape[0])
    idx = local_index(x.shape, mesh, layout)
    torch.save({"y": (y1.to_local().detach().cpu(), y0[idx].detach().cpu()),
                "aux": (float(a1), float(a0)),
                "gx": (xd.grad.to_local().cpu(), xa.grad[idx].cpu()),
                "grads": {n: (p.grad.cpu(), g0[n].cpu()) for n, p in moe.named_parameters()},
                "staged": dict(moe_ep.HOST_STAGED),
                "dropped": (int(moe_ep.DROPPED["assignments"]), over)},
               f"{out}/{rank}.pt")
    dist.destroy_process_group()


@pytest.mark.gpu
def test_ep_on_4_ranks_sharing_the_card(card, tmp_path):
    mp.spawn(_ep_worker, args=(4, tmp_path / "init", tmp_path), nprocs=4)
    for rank in range(4):
        r = torch.load(tmp_path / f"{rank}.pt")
        torch.testing.assert_close(*r["y"], rtol=Y_TOL, atol=Y_TOL)
        assert abs(r["aux"][0] - r["aux"][1]) <= AUX_RTOL * abs(r["aux"][1])
        torch.testing.assert_close(*r["gx"], rtol=GRAD_TOL, atol=GRAD_TOL)
        for n, (got, want) in r["grads"].items():
            torch.testing.assert_close(got, want, rtol=GRAD_TOL, atol=GRAD_TOL, msg=n)
        assert r["staged"]["calls"] > 0  # gloo: the exchanges went through host memory
        # neither path dropped an assignment: the layer's count, the plain MoE's load
        assert r["dropped"][0] == 0 and r["dropped"][1] <= 0


def _tp_worker(rank, world, init, out):
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    torch.cuda.set_device(0)
    from torch.func import functional_call

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe_ep
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import Model
    from repro_torch.sharding import partition
    from repro_torch.sharding.place import local_index
    from repro_torch.sharding.specs import ShardingRules

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
    mesh = make_mesh((1, world), ("data", "model"), device_type="cuda")
    rules = ShardingRules()
    whole = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu").float()
    gen = torch.Generator().manual_seed(1)
    h = torch.randn((1, 512, cfg.d_model), generator=gen).requires_grad_(True)
    c = torch.randn((1, 512, cfg.d_model), generator=gen)
    pos = torch.arange(512)
    blk = whole.blocks[0]  # the CPU, kernels off: the plain attention
    y = blk.attn(rms_norm(h, blk.ln1, cfg.rms_eps), pos)
    (y * c).sum().backward()
    model = Model(cfg, generator=torch.Generator().manual_seed(0), device="cpu").float().cuda()
    state = steps.distribute_state({"model": model, "opt": {"step": 0}}, cfg, mesh, rules)
    part = partition.Partition(cfg, state["model"], mesh, rules)
    shards = {k: p.to_local().detach().requires_grad_(True)
              for k, p in state["model"].named_parameters()}
    w = partition.gather_group(part.units[0], shards)
    sub = {k[len("blocks.0.attn."):]: v for k, v in w.items() if k.startswith("blocks.0.attn.")}
    attn = state["model"].blocks[0].attn
    h_loc = part._shard(h.detach()).cuda().requires_grad_(True)
    kernels.enable_kernels(True)
    launches = flash_attention_cuda.launches
    y_loc = part.split("blocks.0", w)(
        "attn", lambda a, **kw: functional_call(attn, sub, (a, pos.cuda()), kw), h_loc,
        w["blocks.0.ln1"], cfg.rms_eps)
    (y_loc * part._shard(c).cuda()).sum().backward()
    torch.cuda.synchronize()
    params = dict(state["model"].named_parameters())
    grads = {k: (shards[k].grad.cpu() * world,
                 p.grad[local_index(params[k].shape, mesh, params[k].placements)])
             for k, p in whole.named_parameters()
             if k.startswith("blocks.0.attn.") or k == "blocks.0.ln1"}
    torch.save({"mode": part.modes["blocks.0.attn"], "launches": flash_attention_cuda.launches - launches,
                "heads": (sub["wq.w"].shape[1] // cfg.head_dim, sub["wk.w"].shape[1] // cfg.head_dim),
                "y": (y_loc.detach().cpu(), part._shard(y).detach()),
                "dx": (h_loc.grad.cpu(), part._shard(h.grad)), "grads": grads,
                "staged": dict(moe_ep.HOST_STAGED)}, f"{out}/tp{rank}.pt")
    dist.destroy_process_group()


@pytest.mark.gpu
def test_tp_attention_on_2_ranks_sharing_the_card(card, tmp_path):
    mp.spawn(_tp_worker, args=(2, tmp_path / "init", tmp_path), nprocs=2)
    for rank in range(2):
        r = torch.load(tmp_path / f"tp{rank}.pt")
        assert r["mode"] == "tp" and r["heads"] == (8, 4)
        assert r["launches"] > 0 and r["staged"]["calls"] > 0
        for name, (got, want) in [("y", r["y"]), ("dx", r["dx"]), *r["grads"].items()]:
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= TP_TOL, (name, err)
