"""Gradient compression and elastic mesh planning of the port
(``repro_torch.runtime``) against the reference's (``repro.runtime``).

``compress_int8``, ``decompress_int8`` and ``error_feedback_update`` are
held bit for bit on f32 and bf16 inputs that include exact .5 ties of the
quantizer (both round half to even). The compressed all-reduce runs on 4
gloo ranks: its mean equals the mean of the reference's dequantized
values of each rank to f32 rounding of the sum (the ranks' order of
addition is gloo's: rtol 1e-6), lies within the int8 bound of the plain
mean (half the mean of the ranks' scales), and the residual is
``g_eff - deq`` exactly. ``plan_mesh_shape`` equals the reference's
``plan_mesh(...).devices.shape`` for every n in 1..600 and TP in {1, 4, 16};
on the 4 ranks, ``plan_mesh``, ``make_host_mesh`` and the refusals of
``make_production_mesh`` and ``make_mesh`` (the reference's messages).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.runtime import compression as jc
from repro.runtime import elastic as je
from repro_torch import runtime
from repro_torch.runtime import compression as tc
from repro_torch.runtime.elastic import plan_mesh_shape

WORLD = 4


def _draw(seed, n, dtype):
    """Normal draws with exact quantizer ties: values at (j + 0.5) * scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[0] = 127 * 0.5  # max |x| = 63.5 -> scale 0.5: k + 0.5 ties at multiples of 0.25
    x[1:9] = np.array([0.25, -0.25, 0.75, -0.75, 1.25, 2.25, -3.75, 10.25], np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bf16" else x


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:  # exact: every value is a bf16
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", range(4))
def test_compression_bit_for_bit(seed, dtype):
    x = _draw(seed, 1000, dtype)
    q, s = tc.compress_int8(_torch(x))
    jq, js = jc.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    assert np.array_equal(tc.decompress_int8(q, s).numpy(), np.asarray(jc.decompress_int8(jq, js)))
    res = _draw(seed + 10, 1000, "f32") * np.float32(0.01)
    for r in (None, res):
        got = tc.error_feedback_update(_torch(x), None if r is None else torch.from_numpy(r))
        want = jc.error_feedback_update(jnp.asarray(x), None if r is None else jnp.asarray(r))
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    ties = np.abs(np.asarray(x, np.float32) / float(js)) % 1 == 0.5
    assert ties.sum() >= 4  # the quantizer met exact halves


def test_wire_bytes_match_the_reference():
    tree = {"a": torch.zeros(1024), "b": torch.zeros(512, dtype=torch.bfloat16)}
    jtree = {"a": jnp.zeros(1024), "b": jnp.zeros(512, jnp.bfloat16)}
    assert tc.raw_wire_bytes(tree) == jc.raw_wire_bytes(jtree) == 4 * 1024 + 2 * 512
    assert tc.compressed_wire_bytes(tree) == jc.compressed_wire_bytes(jtree) == 1536 + 8


def test_runtime_exports_are_lazy():
    assert runtime.compress_int8 is tc.compress_int8
    assert runtime.plan_mesh_shape is plan_mesh_shape
    with pytest.raises(AttributeError):
        runtime.no_such_export


# --------------------------------------------------------------------- #
# the compressed all-reduce on 4 gloo ranks
# --------------------------------------------------------------------- #
def _grads(rank):
    return _draw(100 + rank, 777, "f32"), _draw(200 + rank, 777, "f32") * np.float32(0.01)


def _allreduce_worker(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    g, res = _grads(rank)
    ar = tc.make_compressed_allreduce()
    avg, new_res = ar(torch.from_numpy(g), torch.from_numpy(res))
    bf, _ = ar(torch.from_numpy(g).bfloat16(), None)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime.elastic import plan_mesh

    meshes = {"host": mesh_mod.make_host_mesh(), "plan": plan_mesh(world, model=2, device_type="cpu")}
    raised = []
    for build in (lambda: mesh_mod.make_production_mesh(device_type="cpu"),
                  lambda: mesh_mod.make_mesh((2, 4), ("data", "model"), device_type="cpu")):
        try:
            build()
        except RuntimeError as e:
            raised.append(str(e))
    torch.save({"avg": avg, "res": new_res, "bf16": bf, "raised": raised,
                "meshes": {k: (tuple(m.shape), m.mesh_dim_names, list(m.get_coordinate()))
                           for k, m in meshes.items()}}, f"{out}/{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    d = tmp_path_factory.mktemp("allreduce")
    mp.spawn(_allreduce_worker, args=(WORLD, d / "init", d), nprocs=WORLD)
    return [torch.load(d / f"{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_allreduce_on_4_ranks(reduced, rank):
    deqs, scales, plain = [], [], []
    for r in range(WORLD):
        g, res = _grads(r)
        _, s, _, deq = jc.error_feedback_update(jnp.asarray(g), jnp.asarray(res))
        deqs.append(np.asarray(deq, np.float64))
        scales.append(float(s))
        plain.append((g + res).astype(np.float64))
    got = reduced[rank]
    np.testing.assert_allclose(got["avg"].numpy(), np.mean(deqs, axis=0), rtol=1e-6, atol=1e-7)
    assert np.abs(got["avg"].numpy() - np.mean(plain, axis=0)).max() <= np.mean(scales) / 2 + 1e-6
    g, res = _grads(rank)
    _, _, want_res, _ = jc.error_feedback_update(jnp.asarray(g), jnp.asarray(res))
    assert np.array_equal(got["res"].numpy(), np.asarray(want_res))
    assert got["bf16"].dtype == torch.bfloat16
    assert all(torch.equal(got["avg"], reduced[r]["avg"]) for r in range(WORLD))


# --------------------------------------------------------------------- #
# elastic planning
# --------------------------------------------------------------------- #
class _D:
    def __init__(self, i):
        self.id = i


_DEVS = [_D(i) for i in range(600)]


@pytest.mark.parametrize("model", [1, 4, 16])
def test_plan_mesh_shape_matches_the_reference(model):
    for n in range(1, 601):
        want = je.plan_mesh(n, model=model, prefer_pods=2, devices=_DEVS[:n]).devices.shape
        assert plan_mesh_shape(n, model=model, prefer_pods=2) == tuple(want), n


@pytest.mark.parametrize("rank", range(WORLD))
def test_mesh_builders_on_4_ranks(reduced, rank):
    got = reduced[rank]
    host, planned = got["meshes"]["host"], got["meshes"]["plan"]
    assert host[:2] == ((4, 1), ("data", "model")) and host[2] == [rank, 0]
    assert planned[:2] == (plan_mesh_shape(4, model=2), ("pod", "data", "model"))
    assert planned[0] == (2, 1, 2) and planned[2] == [rank // 2, 0, rank % 2]
    assert got["raised"] == ["mesh (16, 16) needs 256 devices, found 4",
                             "mesh (2, 4) needs 8 devices"]
