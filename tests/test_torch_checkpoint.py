"""The port's checkpoints: the reference's tests of ``repro.checkpoint``
(roundtrip, atomicity, GC, async manager) on torch tensors, and the
format shared with the JAX package: each package restores the other's
checkpoints of a training state bit for bit.

Tolerances: every comparison here is exact (``torch.equal`` /
``np.array_equal``), apart from the last test, where the port resumes
JAX's f32 training for one step and its loss is held to JAX's to 1e-5 (the
tolerance of test_torch_train.py: f32 throughout, sums taken in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro.checkpoint as jax_ckpt
from repro.configs.base import get_config as jax_get_config
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jax_steps
from repro.optim import optimizers as jo
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps
from repro_torch.models.convert import params_from_jax, state_to_reference_layout
from repro_torch.optim import adamw, lion, sgd

LOSS_TOL = 1e-5


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.randn((16,), generator=g).to(torch.bfloat16)},
        "opt": {"step": 7, "m": {"w": torch.ones((8, 16))}},
    }


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def meta_like(t):
    """The structure of ``t`` with every tensor on the meta device."""
    if isinstance(t, dict):
        return {k: meta_like(v) for k, v in t.items()}
    return torch.empty_like(t, device="meta") if isinstance(t, torch.Tensor) else t


def test_roundtrip(tmp_path):
    t = tree()
    save(tmp_path, 5, t, extra={"loss": 1.5})
    got, step, extra = restore(tmp_path, meta_like(t), device="cpu")
    assert step == 5 and extra["loss"] == 1.5
    assert_tree_equal(t, got)
    # bf16 is stored as uint16 under its logical dtype, as the reference does
    back, _, _ = jax_ckpt.restore(tmp_path, jax.eval_shape(lambda: {
        "params": {"w": jnp.zeros((8, 16)), "b": jnp.zeros((16,), jnp.bfloat16)},
        "opt": {"step": jnp.int32(0), "m": {"w": jnp.zeros((8, 16))}}}))
    assert back["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["params"]["b"], np.float32),
                                  t["params"]["b"].float().numpy())


def test_restore_into_live_tensors_writes_them_in_place(tmp_path):
    save(tmp_path, 1, tree(1))
    target = tree(2)
    w = target["params"]["w"]
    got, _, _ = restore(tmp_path, target)
    assert got["params"]["w"] is w
    assert_tree_equal(got, tree(1))


def test_latest_step_and_multiple(tmp_path):
    for s in (1, 3, 2):
        save(tmp_path, s, tree(s))
    assert latest_step(tmp_path) == 3
    got, step, _ = restore(tmp_path, tree())
    assert step == 3
    assert_tree_equal(tree(3), got)


def test_incomplete_tmp_dir_ignored(tmp_path):
    """Atomicity: a crashed writer's tmp dir is never restored from."""
    save(tmp_path, 1, tree(1))
    fake = tmp_path / "step_000000009.tmp-deadbeef"
    fake.mkdir()
    (fake / "000000.npy").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 1
    # even a completed-looking dir without a manifest is skipped
    nomanifest = tmp_path / "step_000000008"
    nomanifest.mkdir()
    assert latest_step(tmp_path) == 1
    assert latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "absent", tree())


def test_restore_shape_mismatch_raises(tmp_path):
    save(tmp_path, 1, {"w": torch.zeros((4, 4))})
    target = {"w": torch.ones((8, 4))}
    with pytest.raises(ValueError):
        restore(tmp_path, target)
    assert torch.equal(target["w"], torch.ones((8, 4)))  # checked before anything is written


def test_restore_missing_leaf_raises(tmp_path):
    save(tmp_path, 1, {"w": torch.zeros((4, 4))})
    target = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    with pytest.raises(KeyError, match="b"):
        restore(tmp_path, target)
    assert torch.equal(target["w"], torch.ones((4, 4)))


def test_shardings_are_not_ported(tmp_path):
    """shardings= is ported: on a mesh of one gloo rank, a tree on the meta
    device comes back as DTensors of the saved values with the placements
    asked for (the 4-rank case: tests/test_torch_train_mesh.py)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_mesh

    save(tmp_path / "c", 1, tree())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        target = _meta(tree())
        sh = {"params": {"w": (mesh, (Shard(0), Shard(1))), "b": (mesh, (Replicate(), Shard(0)))},
              "opt": {"step": None, "m": {"w": (mesh, (Shard(1), Replicate()))}}}
        for got, step, _ in (restore(tmp_path / "c", target, shardings=sh, device="cpu"),
                             CheckpointManager(tmp_path / "c").restore_latest(
                                 target, shardings=sh, device="cpu")):
            assert step == 1
            for (path, g), (_, want) in zip(_paths(got), _paths(tree())):
                if isinstance(want, torch.Tensor):
                    assert isinstance(g, DTensor) and torch.equal(g.full_tensor(), want), path
                else:
                    assert g == want, path
            assert got["params"]["w"].placements == (Shard(0), Shard(1))
    finally:
        dist.destroy_process_group()


def _meta(t):
    """The tree with every tensor on the meta device."""
    if isinstance(t, dict):
        return {k: _meta(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_meta(v) for v in t]
    return t.to("meta") if isinstance(t, torch.Tensor) else t


def _paths(t, path=()):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _paths(t[k], path + (k,))]
    if isinstance(t, list):
        return [x for i, v in enumerate(t) for x in _paths(v, path + (i,))]
    return [(path, t)]


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, every=10, async_save=True)
    for s in (10, 20, 30, 40):
        assert mgr.should_save(s) and not mgr.should_save(s + 1)
        mgr.save(s, tree(s))
    mgr.wait()
    steps_ = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert steps_ == ["step_000000030", "step_000000040"]
    got, step, _ = mgr.restore_latest(tree())
    assert step == 40
    assert_tree_equal(tree(40), got)
    assert [r["step"] for r in mgr.records] == [10, 20, 30, 40]
    assert all(r["bytes"] == 8 * 16 * 4 * 2 + 16 * 2 + 8 and r["write_s"] >= 0
               for r in mgr.records)


def test_manager_snapshots_before_the_async_write(tmp_path):
    """The next train step writes the state in place while the writer
    thread runs: the checkpoint holds the values at ``save``."""
    t = tree(3)
    mgr = CheckpointManager(tmp_path, keep=1, async_save=True)
    mgr.save(1, t)
    t["params"]["w"].add_(1.0)  # in place, as the optimizer does
    t["params"]["b"].zero_()
    mgr.wait()
    got, _, _ = restore(tmp_path, tree())
    assert_tree_equal(got, tree(3))


def test_manager_surfaces_async_errors(tmp_path):
    mgr = CheckpointManager(tmp_path / "sub", keep=1, async_save=True)
    mgr.save(1, tree())
    mgr.wait()
    # poison: point the manager at a path occupied by a FILE, so the
    # background writer's mkdir fails (chmod tricks don't stop root)
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    mgr.directory = blocked
    mgr.save(2, tree())
    with pytest.raises(Exception):
        mgr.wait()
    mgr.wait()  # raised once
    mgr.save(3, tree())
    with pytest.raises(Exception):
        mgr.save(4, tree())  # the next save raises the last writer's error


# --------------------------------------------------------------------- #
# the format shared with the JAX package
# --------------------------------------------------------------------- #
CROSS_ARCHS = ["zamba2-2.7b_smoke", "deepseek-v2-lite-16b_smoke"]
OPTIMIZERS = {"adamw": (jo.adamw, adamw), "lion": (jo.lion, lion), "sgd": (jo.sgd, sgd)}


def jax_state(arch, opt="adamw", steps_done=0):
    """A JAX training state whose optimizer leaves are moved off their init
    values by a random draw (zeros would hide a leaf read from the wrong
    file) and whose step is ``steps_done``."""
    jcfg = jax_get_config(arch)
    st = jax_steps.make_init_state(jcfg, OPTIMIZERS[opt][0](1e-3))(jax.random.PRNGKey(0))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 4096))
    st["opt"] = {k: (v if k == "step" else jax.tree.map(
        lambda a: a + jax.random.normal(next(keys), a.shape, a.dtype), v))
        for k, v in st["opt"].items()}
    st["opt"]["step"] = jnp.int32(steps_done)
    return st


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_jax_checkpoint_restored_by_the_port(tmp_path, arch):
    """``repro.checkpoint.save`` of a JAX AdamW state, restored by the port:
    the model equals ``params_from_jax`` and every optimizer leaf equals
    JAX's, unstacked the same way, bit for bit."""
    cfg = get_config(arch)
    st = jax_state(arch, steps_done=3)
    jax_ckpt.save(tmp_path, 3, st, extra={"loss": 2.5})
    target = steps.make_init_state(cfg, adamw(1e-3), "meta")(None)
    got, step, extra = restore(tmp_path, target, device="cpu")
    assert (step, extra, got["opt"]["step"]) == (3, {"loss": 2.5}, 3)
    want = params_from_jax(jax.tree.map(np.asarray, st["params"]), cfg, "cpu")
    for (n, p), (n2, q) in zip(want.named_parameters(), got["model"].named_parameters(),
                               strict=True):
        assert n == n2 and p.dtype == q.dtype and torch.equal(p, q), n
    for name in ("m", "v", "master"):
        opt_model = params_from_jax(jax.tree.map(np.asarray, st["opt"][name]), cfg, "cpu")
        for n, p in opt_model.named_parameters():
            q = got["opt"][name][n]
            assert q.dtype == torch.float32 and torch.equal(p.float(), q), (name, n)


class _DeviceCopies(TorchDispatchMode):
    """Counts the bytes that ops make on the meta device (standing for the
    card) from host tensors, and from tensors already made there that way
    (a second device copy of a restored leaf)."""

    def __init__(self):
        super().__init__()
        self.from_host = self.on_device = 0
        self._restored = {}  # id -> tensor (kept alive, so ids stay unique)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor) and o.is_meta]
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        restored = any(id(a) in self._restored for a in ins)
        made = sum(o.numel() * o.element_size() for o in outs)
        if any(not a.is_meta for a in ins):
            self.from_host += made
        elif restored and not view:
            self.on_device += made
        elif not (restored and view):
            return out
        self._restored.update((id(o), o) for o in outs)
        return out


def test_restore_places_each_leaf_on_the_device_once(tmp_path):
    """A restore into a meta target copies each leaf (each unit's slice of
    a stacked one) from the host to the device once and makes no second
    device copy, so it needs no more device memory than the state."""
    cfg = get_config("deepseek-v2-lite-16b_smoke")  # stacked units and a prefix
    opt = adamw(1e-3)
    st = steps.make_init_state(cfg, opt, "cpu")(torch.Generator().manual_seed(0))
    save(tmp_path, 1, st)
    state_bytes = sum(t.numel() * t.element_size() for tree in
                      [dict(st["model"].named_parameters()), st["opt"]["m"], st["opt"]["v"],
                       st["opt"]["master"]] for t in tree.values())
    target = steps.make_init_state(cfg, opt, "meta")(None)
    with _DeviceCopies() as copies:
        got, _, _ = restore(tmp_path, target, device="meta")
    assert (copies.from_host, copies.on_device) == (state_bytes, 0)
    assert all(p.is_meta for p in got["model"].parameters())


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_port_checkpoint_restored_by_jax(tmp_path, arch, opt):
    """The port's save of a state (AdamW, Lion, SGD) restored by
    ``repro.checkpoint.restore`` into ``jax.eval_shape`` of the reference
    state equals that state bit for bit, leaf by leaf and dtype by dtype;
    and the port's leaves come in the reference's order."""
    cfg = get_config(arch)
    st = jax_state(arch, opt, steps_done=5)
    ours, _, _ = restore(_saved_by_jax(tmp_path / "j", st),
                         steps.make_init_state(cfg, OPTIMIZERS[opt][1](1e-3), "meta")(None),
                         device="cpu")
    save(tmp_path / "t", 5, ours)
    back, step, _ = jax_ckpt.restore(tmp_path / "t", jax.eval_shape(lambda: st))
    assert step == 5
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(st)[0]]
    assert list(state_to_reference_layout(ours, cfg)) == paths
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def _saved_by_jax(d, st):
    jax_ckpt.save(d, int(st["opt"]["step"]), st)
    return d


def test_train_resume_is_bitwise_consistent(tmp_path):
    """Integration: train 6 steps straight == train 3, save, restore into a
    fresh structure, train 3 (bit for bit on the CPU)."""
    cfg = get_config("qwen3-0.6b_smoke")
    opt = adamw(1e-3)
    step_fn = steps.make_train_step(cfg, opt, remat=False)
    src = SyntheticLM(cfg.vocab, seed=0)

    def batch(i):
        return {"tokens": torch.from_numpy(src.batch(i, 2, 16)["tokens"])}

    def fresh():
        return steps.make_init_state(cfg, opt, "cpu")(torch.Generator().manual_seed(0))

    s_a = fresh()
    for i in range(6):
        s_a, _ = step_fn(s_a, batch(i))
    s_b = fresh()
    for i in range(3):
        s_b, _ = step_fn(s_b, batch(i))
    save(tmp_path, 3, s_b)
    del s_b
    s_c, start, _ = restore(tmp_path, steps.make_init_state(cfg, opt, "meta")(None), device="cpu")
    for i in range(start, 6):
        s_c, _ = step_fn(s_c, batch(i))
    assert s_c["opt"]["step"] == s_a["opt"]["step"] == 6
    for (n, p), (_, q) in zip(s_a["model"].named_parameters(), s_c["model"].named_parameters()):
        assert torch.equal(p, q), n
    for name in ("m", "v", "master"):
        for n in s_a["opt"][name]:
            assert torch.equal(s_a["opt"][name][n], s_c["opt"][name][n]), (name, n)


def test_port_resumes_jax_training(tmp_path):
    """JAX trains 3 steps (float32 parameters) and saves; the port restores
    that checkpoint and takes step 4 on the same batch: its loss is JAX's
    step-4 loss to 1e-5."""
    arch = "qwen3-0.6b_smoke"
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jopt = jo.adamw(1e-3)
    st = jax_steps.make_init_state(jcfg, jopt)(jax.random.PRNGKey(0))
    st["params"] = jax.tree.map(lambda a: a.astype(jnp.float32), st["params"])
    jstep = jax.jit(jax_steps.make_train_step(jcfg, jopt, remat=False))
    src = JaxSyntheticLM(cfg.vocab, seed=0)
    toks = [src.batch(i, 2, 16)["tokens"] for i in range(4)]
    for i in range(3):
        st, _ = jstep(st, {"tokens": jnp.asarray(toks[i])})
    jax_ckpt.save(tmp_path, 3, st)
    _, jmetrics = jstep(st, {"tokens": jnp.asarray(toks[3])})

    target = steps.make_init_state(cfg, adamw(1e-3), "meta")(None)
    target["model"] = target["model"].float()
    ours, step, _ = restore(tmp_path, target, device="cpu")
    assert step == 3 and ours["opt"]["step"] == 3
    ours, metrics = steps.make_train_step(cfg, adamw(1e-3), remat=False)(
        ours, {"tokens": torch.from_numpy(toks[3])})
    assert metrics["step"] == 4
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
