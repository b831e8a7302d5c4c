"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) against
the reference's ``moe_apply_ep`` and against the port's own ``MoE``.

The reference test's config (qwen2-moe reduced to 6 experts, top 2,
d_model 32, d_expert 16, one shared expert, capacity factor 8 so that no
path drops) runs on 8 gloo ranks at mesh (2, 4) ("data", "model"): the 6
experts are padded to 8, two a rank. The reference runs on 8 fake XLA
devices in a subprocess (the main test process is pinned to one) and
hands over its f32 weights, x (4, 8, 32), y, aux and the grads of
``y.sum()``. Tolerances are the reference test's: y rtol = atol = 2e-4,
aux rtol 1e-5, grads rtol = atol = 2e-3.

Both entry points are checked: ``moe_apply_ep`` on a DTensor laid out by
the contract (batch over "data", sequence over "model"; weight grads
summed over "data" by the test, the layer sums them over "model") and the
partitioned train step's ``moe_ep_local`` on each rank's token block (a
dp rank's rows, its sequence shard) with the whole weights (each rank's
grads its share: summed over every rank by the test, as the step sums
them).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = str(Path(__file__).resolve().parent.parent / "src")
WORLD, MESH = 8, (2, 4)
DROP_CFS = (0.5, 1.0, 2.0, 8.0)
Y_TOL, AUX_RTOL, GRAD_TOL = 2e-4, 1e-5, 2e-3

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.models import moe as moe_mod, moe_ep
from repro.sharding.hints import hints_from_mesh

cfg = dataclasses.replace(
    get_config("qwen2-moe-a2.7b").reduced(),
    n_routed_experts=6, top_k=2, d_expert=16, d_model=32, n_shared_experts=1,
    capacity_factor=8.0,
)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
hints_from_mesh(mesh, None)
p = jax.tree.map(lambda a: a.astype(jnp.float32), moe_mod.init_moe(jax.random.PRNGKey(0), cfg))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32), jnp.float32)
assert moe_ep.ep_available(cfg, x)
with mesh:
    y, a = jax.jit(lambda p, x: moe_ep.moe_apply_ep(p, cfg, x))(p, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: moe_ep.moe_apply_ep(p, cfg, x)[0].sum(),
                              argnums=(0, 1)))(p, x)
flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                  for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
np.savez(sys.argv[1], x=np.asarray(x), y=np.asarray(y), aux=np.asarray(a), gx=np.asarray(gx),
         **{"p" + k: v for k, v in flat(p).items()}, **{"g" + k: v for k, v in flat(gp).items()})
"""


def _cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), n_routed_experts=6,
                               top_k=2, d_expert=16, d_model=32, n_shared_experts=1,
                               capacity_factor=8.0)


def _port_name(key: str) -> str:
    """"['shared']['up']['w']" -> "shared.up.w"."""
    return ".".join(k.strip("'") for k in key.strip("[]").split("]["))


def _worker(rank, world, init, ref_path, out):
    import dataclasses

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe_ep
    from repro_torch.models.moe import MoE
    from repro_torch.sharding.hints import clear_hints, hints_from_mesh
    from repro_torch.sharding.place import from_full, local_index

    cfg = _cfg()
    ref = np.load(ref_path)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    hints_from_mesh(mesh, None)
    res = {"ep_available": moe_ep.ep_available(cfg, torch.zeros(4, 8, 32))}

    def fresh():
        moe = MoE(cfg, generator=None, device="meta")
        moe.load_state_dict({_port_name(k[1:]): torch.from_numpy(ref[k].copy())
                             for k in ref.files if k.startswith("p[")}, strict=True, assign=True)
        return moe

    def wgrads(moe):
        out = {}
        for n, p_ in moe.named_parameters():
            g = p_.grad.clone()
            dist.all_reduce(g, group=mesh.get_group("data"))  # the layer summed over "model"
            out[n] = g
        return out

    x = torch.from_numpy(ref["x"].copy())
    # the contract's layout: a DTensor, batch over "data", sequence over "model"
    moe = fresh()
    xd = from_full(x, mesh, (torch.distributed.tensor.Shard(0), torch.distributed.tensor.Shard(1)))
    xd.requires_grad_(True)
    y, aux = moe_ep.moe_apply_ep(moe, cfg, xd)
    y.to_local().sum().backward()
    idx = local_index(x.shape, mesh, xd.placements)
    res["dtensor"] = {"y": y.to_local().detach(), "aux": aux.item(), "idx": idx,
                      "gx": xd.grad.to_local(), "grads": wgrads(moe)}
    # the partitioned train step's layout: this rank's token block, the whole weights
    moe = fresh()
    xb = x[idx].clone().requires_grad_(True)
    y, aux = moe_ep.moe_ep_local(cfg, xb, dict(moe.named_parameters()), mesh.get_group("model"),
                                 mesh.get_local_rank("model"), MESH[1],
                                 [mesh.get_group(a) for a in mesh.mesh_dim_names])
    y.sum().backward()
    grads = {}
    for n, p_ in moe.named_parameters():  # each rank's share, summed over the mesh
        grads[n] = p_.grad.clone()
        dist.all_reduce(grads[n])
    res["rows"] = {"y": y.detach(), "aux": aux.item(), "idx": idx, "gx": xb.grad,
                   "grads": grads}
    # the port's own MoE on the whole x, on every rank
    moe = fresh()
    xa = x.clone().requires_grad_(True)
    y, aux = moe(xa)
    y.sum().backward()
    res["moe"] = {"y": y.detach(), "aux": aux.item(), "gx": xa.grad,
                  "grads": {n: p_.grad for n, p_ in moe.named_parameters()}}
    res["exchange"] = dict(moe_ep.EXCHANGE)
    # the layer's count of dropped assignments at smaller capacity factors
    with torch.no_grad():
        res["routes"] = moe.route(x.reshape(-1, x.shape[-1]))[1].reshape(*x.shape[:2], -1)
        res["dropped"] = {}
        for cf in DROP_CFS:
            c = dataclasses.replace(cfg, capacity_factor=cf)
            moe = fresh()
            moe.cfg = c
            moe_ep.DROPPED["assignments"] = 0
            moe_ep.moe_apply_ep(moe, c, xd)
            res["dropped"][cf] = int(moe_ep.DROPPED["assignments"])
    clear_hints()
    torch.save(res, f"{out}/{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    ref_path = d / "ref.npz"
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(ref_path)],
                          env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin:/usr/local/bin",
                               "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mp.spawn(_worker, args=(WORLD, d / "init", ref_path, d), nprocs=WORLD)
    ref = dict(np.load(ref_path))
    return ref, [torch.load(d / f"{r}.pt", weights_only=False) for r in range(WORLD)]


def _ref_grads(ref):
    return {_port_name(k[1:]): v for k, v in ref.items() if k.startswith("g[")}


@pytest.mark.parametrize("rank", range(WORLD))
def test_ep_dtensor_layout_matches_the_reference(runs, rank):
    ref, res = runs
    r = res[rank]["dtensor"]
    np.testing.assert_allclose(r["y"].numpy(), ref["y"][r["idx"]], rtol=Y_TOL, atol=Y_TOL)
    np.testing.assert_allclose(r["aux"], float(ref["aux"]), rtol=AUX_RTOL)
    np.testing.assert_allclose(r["gx"].numpy(), ref["gx"][r["idx"]], rtol=GRAD_TOL, atol=GRAD_TOL)
    for n, want in _ref_grads(ref).items():
        np.testing.assert_allclose(r["grads"][n].numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=n)
    assert res[rank]["ep_available"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_ep_train_layout_matches_the_reference(runs, rank):
    ref, res = runs
    r = res[rank]["rows"]
    np.testing.assert_allclose(r["y"].numpy(), ref["y"][r["idx"]], rtol=Y_TOL, atol=Y_TOL)
    np.testing.assert_allclose(r["aux"], float(ref["aux"]), rtol=AUX_RTOL)
    np.testing.assert_allclose(r["gx"].numpy(), ref["gx"][r["idx"]], rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    for n, want in _ref_grads(ref).items():
        np.testing.assert_allclose(r["grads"][n].numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=n)


@pytest.mark.parametrize("rank", range(WORLD))
def test_ep_matches_the_ports_moe(runs, rank):
    ref, res = runs
    own, r = res[rank]["moe"], res[rank]["dtensor"]
    np.testing.assert_allclose(r["y"].numpy(), own["y"][r["idx"]].numpy(), rtol=Y_TOL, atol=Y_TOL)
    np.testing.assert_allclose(r["aux"], own["aux"], rtol=AUX_RTOL)
    for n, g in own["grads"].items():
        np.testing.assert_allclose(r["grads"][n].numpy(), g.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)
    # and the port's MoE is the reference's GSPMD baseline's y at these tolerances
    np.testing.assert_allclose(own["y"].numpy(), ref["y"], rtol=Y_TOL, atol=Y_TOL)
    # two exchanges forward and two backward a layout, each rank a part of every one
    assert res[rank]["exchange"]["calls"] == 2 * (2 + 1 + 2)


def test_ep_available_guards():
    from repro_torch.configs import get_config
    from repro_torch.models import moe_ep
    from repro_torch.sharding.hints import clear_hints, hints

    clear_hints()
    # clear_hints keeps the mesh an earlier hints_from_mesh in this process
    # installed (as the reference's does): drop it for "no mesh installed"
    moe_ep.hints_mod._STATE.pop("mesh", None)
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    x = torch.zeros((2, 8, cfg.d_model))
    assert not moe_ep.ep_available(cfg, x)  # no hints installed -> the MoE FFN
    with hints(dp=("data",), tp="model", sizes={"data": 2, "model": 4}):
        assert not moe_ep.ep_available(cfg, x)  # no mesh installed
        moe_ep.hints_mod._STATE["mesh"] = object()
        try:
            assert moe_ep.ep_available(cfg, x)
            assert not moe_ep.ep_available(cfg, torch.zeros((2, 6, cfg.d_model)))  # s % tp
        finally:
            moe_ep.hints_mod._STATE.pop("mesh")
    with hints(dp=("data",), tp="model", sizes={"data": 2, "model": 1}):
        moe_ep.hints_mod._STATE["mesh"] = object()
        try:
            assert not moe_ep.ep_available(cfg, x)  # tp = 1: nothing to exchange
        finally:
            moe_ep.hints_mod._STATE.pop("mesh")


def _simulated_drops(routes: np.ndarray, cf: float, e: int, k: int) -> int:
    """The assignments the reference's layer drops on the mesh, from the
    routes (B, S, k): each sender's rows by destination rank (cap_send a
    rank), then each owner's slots by local expert (cap_own an expert), a
    sender's empty slots counting against local expert 0."""
    dp, tp = MESH
    e_loc = -(-e // tp)
    B, S = routes.shape[:2]
    b_l, s_l = B // dp, S // tp
    cap_send = max(1, int(np.ceil(b_l * s_l * k * cf / tp)))
    cap_own = max(1, int(np.ceil(tp * cap_send * cf / e_loc)))
    total = 0
    for g in range(dp):
        sent = {}
        for src in range(tp):
            flat = routes[g * b_l:(g + 1) * b_l, src * s_l:(src + 1) * s_l].reshape(-1)
            for dst in range(tp):
                ids = flat[flat // e_loc == dst] % e_loc
                total += max(0, len(ids) - cap_send)
                sent[src, dst] = ids[:cap_send]
        for dst in range(tp):
            seen = np.zeros(e_loc, int)
            for src in range(tp):
                ids = sent[src, dst]
                for j, real in zip(np.pad(ids, (0, cap_send - len(ids))),
                                   np.arange(cap_send) < len(ids)):
                    total += int(real and seen[j] >= cap_own)
                    seen[j] += 1
    return total


@pytest.mark.parametrize("cf", DROP_CFS)
def test_ep_counts_its_dropped_assignments(runs, cf):
    _, res = runs
    cfg = _cfg()
    want = _simulated_drops(res[0]["routes"].numpy(), cf, cfg.n_routed_experts, cfg.top_k)
    assert sum(r["dropped"][cf] for r in res) == want
    if cf == min(DROP_CFS):  # the count has something to count
        assert want > 0
    if cf == cfg.capacity_factor:  # the factor of the tests above drops nothing
        assert want == 0
