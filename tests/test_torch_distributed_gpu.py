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
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARGS = ["--device", "cuda", "--arch", "qwen3-0.6b_smoke", "--steps", "4", "--batch", "2",
        "--seq", "128", "--warmup", "1", "--deterministic", "--log-every", "1"]
Y_TOL, AUX_RTOL, GRAD_TOL = 2e-4, 1e-5, 2e-3


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
