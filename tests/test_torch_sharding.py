"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``), entry for entry.

Parameter, train-state, batch and decode-cache specs of all ten configs
at full size (the port's on the meta device, the reference's through
``jax.eval_shape``) on shape-only meshes (16, 16), (2, 16, 16) and (2, 4),
under the default rules, ``fsdp_only`` and for inference. A port leaf of
a unit is the reference's stacked ``units.b<j>`` leaf without its unit
dim; every other leaf has the reference's spec. The helpers, and the
activation hints' resolved specs, are compared directly. ``placements``
is held against ``distribute_tensor`` on a (2, 2) mesh of 4 gloo ranks.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.launch.specs import cache_struct, state_struct
from repro.sharding import hints as jhints
from repro.sharding import specs as jspecs
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import steps
from repro_torch.models.model import init_cache
from repro_torch.optim import adamw
from repro_torch.sharding import hints, specs
from repro_torch.sharding.specs import P


class _FakeMesh:
    """Shape-only stand-in: spec builders read axis_names/devices.shape."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), object)


MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
RULES = {"default": ({}, True), "fsdp_only": ({"fsdp_only": True}, True),
         "inference": ({}, False)}
ARCHS = sorted(list_configs())


def _rules(pkg, name):
    kw, _ = RULES[name]
    return pkg.ShardingRules(**kw)


def _flat_ref(tree):
    """{keystr: spec} of a reference spec tree."""
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _ref_key(root: str, name: str, n_pattern: int):
    """Port (root, parameter name) -> (reference keystr, stacked)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        path, stacked = ["units", f"b{int(parts[1]) % n_pattern}", *parts[2:]], True
    elif parts[0] == "prefix":
        path, stacked = ["prefix", int(parts[1]), *parts[2:]], False
    else:
        path, stacked = parts, False
    return root + "".join(f"[{k!r}]" for k in path), stacked


def _compare(port: dict, ref: dict, root: str, cfg) -> int:
    n = len(cfg.block_pattern)
    seen = set()
    for name, spec in port.items():
        key, stacked = _ref_key(root, name, n)
        want = ref[key]
        assert isinstance(spec, P)
        if stacked:
            assert want[0] is None, (key, want)
            want = want[1:]
        assert tuple(spec) == want, (name, key, tuple(spec), want)
        seen.add(key)
    assert seen == {k for k in ref if k.startswith(root)}, set(ref) ^ seen
    return len(seen)


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return state_struct(jax_get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return steps.make_init_state(get_config(arch), adamw(1e-4), "meta")(None)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_the_reference(arch, mesh, rules):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    fake = _FakeMesh(MESHES[mesh])
    jr, pr = _rules(jspecs, rules), _rules(specs, rules)
    training = RULES[rules][1]
    jstate, pstate = _ref_state(arch), _port_state(arch)
    ref = _flat_ref(jspecs.param_specs(jstate["params"], jcfg, fake, jr, for_training=training))
    port = specs.param_specs(pstate["model"], cfg, fake, pr, for_training=training)
    assert _compare(port, ref, "", cfg) == len(ref)
    if training:
        ref = _flat_ref(jspecs.state_specs(jstate, jcfg, fake, jr))
        port = specs.state_specs(pstate, cfg, fake, pr)
        assert port["opt"]["step"] == P() and ref["['opt']['step']"] == ()
        n = _compare(port["params"], ref, "['params']", cfg)
        for k in ("m", "v", "master"):
            n += _compare(port["opt"][k], ref, f"['opt'][{k!r}]", cfg)
        assert n + 1 == len(ref)


@pytest.mark.parametrize("rules", ["default", "fsdp_only"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch, mesh, rules):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    fake = _FakeMesh(MESHES[mesh])
    jr, pr = _rules(jspecs, rules), _rules(specs, rules)
    for name, shape in SHAPES.items():
        ref = jspecs.batch_specs(jcfg, J_SHAPES[name], fake, jr)
        port = specs.batch_specs(cfg, shape, fake, pr)
        assert {k: tuple(v) for k, v in port.items()} == {k: tuple(v) for k, v in ref.items()}
        if shape.kind != "decode" or not cfg.supports_decode:
            continue
        ref = _flat_ref(jspecs.cache_specs(cache_struct(jcfg, J_SHAPES[name]), jcfg, fake, jr))
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        port = specs.cache_specs(cache, cfg, fake, pr)
        n_pattern, k0 = len(cfg.block_pattern), cfg.first_k_dense
        for i, layer in enumerate(port):
            for leaf, spec in layer.items():
                if i < k0:
                    key, want = f"['prefix'][{i}][{leaf!r}]", ref[f"['prefix'][{i}][{leaf!r}]"]
                else:
                    key = f"['units']['b{(i - k0) % n_pattern}'][{leaf!r}]"
                    want = ref[key][1:]
                assert tuple(spec) == want, (name, i, leaf, tuple(spec), want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_helpers_match_the_reference(mesh):
    sizes = MESHES[mesh]
    fake = _FakeMesh(sizes)
    for ax in (None, "data", "model", "pod", ("pod", "data"), ("data", "model")):
        if isinstance(ax, tuple):  # a dp tuple names the mesh's axes only
            ax = tuple(a for a in ax if a in sizes)
        for dim in (1, 2, 4, 6, 8, 16, 56, 60, 64, 96, 512):
            assert specs._maybe_any(ax, dim, sizes) == jspecs._maybe_any(ax, dim, sizes)
            if isinstance(ax, tuple):
                assert specs._maybe_dp(ax, dim, sizes) == jspecs._maybe_dp(ax, dim, sizes)
            else:
                assert specs._maybe(ax, dim, sizes) == jspecs._maybe(ax, dim, sizes)
    for kw in ({}, {"fsdp_only": True}, {"dp_over_pod": False}):
        assert specs.dp_axes(fake, specs.ShardingRules(**kw)) == \
            jspecs.dp_axes(fake, jspecs.ShardingRules(**kw))
    assert specs.ShardingRules().__dict__ == jspecs.ShardingRules().__dict__
    assert specs._COL == jspecs._COL and specs._ROW == jspecs._ROW and specs._REPL == jspecs._REPL


PATTERNS = [("dp", None, "tp"), ("dp", "sp", None), ("tp", None, None), (("pod", "data"), "model"),
            ("dp", "dp"), ("tp", "tp", None), ("data",), (None, "model", "model")]
SHAPES_HINT = [(16, 64, 256), (4, 60, 32), (1, 7, 12), (32, 32, 32)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", [None, "default", "fsdp_only"])
def test_hint_spec_matches_the_reference(mesh, rules, monkeypatch):
    sizes = MESHES[mesh]
    got = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: got.append(tuple(s)) or x)

    class JMesh:
        axis_names = tuple(sizes)
        devices = np.empty(tuple(sizes.values()), object)

    class TMesh:
        mesh_dim_names = tuple(sizes)
        shape = tuple(sizes.values())

    jr = None if rules is None else _rules(jspecs, rules)
    pr = None if rules is None else _rules(specs, rules)
    try:
        jhints.hints_from_mesh(JMesh(), jr)
        hints.hints_from_mesh(TMesh(), pr)
        assert {k: v for k, v in hints._STATE.items() if k != "mesh"} == \
            {k: v for k, v in jhints._STATE.items() if k != "mesh"}
        for shape in SHAPES_HINT:
            for pat in PATTERNS:
                got.clear()
                jhints.shard_hint(jnp.zeros(shape), *pat)
                assert tuple(hints.hint_spec(shape, *pat)) == got[0], (shape, pat)
    finally:
        jhints.clear_hints()
        hints.clear_hints()
    assert hints.shard_hint(torch.ones(3), "dp") is not None  # a no-op outside a context


Q_SHAPES = [(64, 4096, 4096, 32), (8, 2048, 2048, 16), (2, 512, 512, 8), (32, 8192, 8192, 56)]


@pytest.mark.parametrize("dp", [1, 2, 16])
def test_auto_q_chunk_is_the_references_rule_on_one_ranks_shapes(dp):
    """The port's ``mha`` is given one dp rank's rows with every head, so
    its q chunk for (B / dp, hq) is the reference's for (B, hq) on a mesh
    whose "model" axis does not split the heads."""
    from repro.models.layers import _auto_q_chunk as j_q_chunk
    from repro_torch.models.layers import _auto_q_chunk

    sizes = {"data": dp, "model": 1}

    class JMesh:
        axis_names = tuple(sizes)
        devices = np.empty(tuple(sizes.values()), object)

    class TMesh:
        mesh_dim_names = tuple(sizes)
        shape = tuple(sizes.values())

    assert _auto_q_chunk(64, 4096, 4096, 32) == j_q_chunk(64, 4096, 4096, 32) == 1024
    try:
        jhints.hints_from_mesh(JMesh(), None)
        hints.hints_from_mesh(TMesh(), None)
        got = [_auto_q_chunk(B // dp, Sq, Skv, hq) for B, Sq, Skv, hq in Q_SHAPES]
        want = [j_q_chunk(B, Sq, Skv, hq) for B, Sq, Skv, hq in Q_SHAPES]
    finally:
        jhints.clear_hints()
        hints.clear_hints()
    assert got == want and min(got) < 1024


# --------------------------------------------------------------------- #
# placements() on 4 gloo ranks
# --------------------------------------------------------------------- #
PLACE_SPECS = [P("data", "model"), P("model", "data"), P(("data", "model"), None),
               P(None, ("data", "model")), P("data", None), P(None, "model"), P(), P(None, None),
               P("model", None, "data")]


def _place_worker(rank, world, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.place import from_full, local_index
    from repro_torch.sharding.specs import placements

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = []
    for spec in PLACE_SPECS:
        shape = (8, 12, 4)[:max(2, len(spec))]
        full = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
        pl = placements(spec, mesh)
        want = distribute_tensor(full, mesh, pl).to_local()
        mine = from_full(full, mesh, pl)
        res.append((tuple(pl), torch.equal(want, full[local_index(shape, mesh, pl)]),
                    torch.equal(want, mine.to_local()), torch.equal(mine.full_tensor(), full)))
    # shard_hint on a DTensor: redistributed to the resolved spec, values kept
    from repro_torch.sharding.hints import clear_hints, hints_from_mesh, shard_hint

    hints_from_mesh(mesh, specs.ShardingRules())
    x = distribute_tensor(torch.arange(4 * 6 * 8.0).reshape(4, 6, 8), mesh,
                          placements(P(), mesh))
    hinted = [(tuple(y.placements), torch.equal(y.full_tensor(), x.full_tensor()))
              for y in (shard_hint(x, "dp", None, "tp"), shard_hint(x, "dp", "sp", None),
                        shard_hint(x, None, "tp", "tp"))]
    clear_hints()
    torch.save((res, hinted), f"{out}/{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    d = tmp_path_factory.mktemp("place")
    mp.spawn(_place_worker, args=(4, d / "init", d), nprocs=4)
    return [torch.load(d / f"{r}.pt", weights_only=False) for r in range(4)]


@pytest.mark.parametrize("i", range(len(PLACE_SPECS)))
def test_placements_match_distribute_tensor(placed, i):
    from torch.distributed.tensor import Replicate, Shard

    spec = PLACE_SPECS[i]
    want = [Replicate(), Replicate()]
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            want[("data", "model").index(a)] = Shard(d)
    for rank in range(4):
        pl, by_index, by_from_full, whole = placed[rank][0][i]
        assert pl == tuple(want) and by_index and by_from_full and whole


@pytest.mark.parametrize("rank", range(4))
def test_shard_hint_redistributes_a_dtensor(placed, rank):
    from torch.distributed.tensor import Replicate, Shard

    assert placed[rank][1] == [((Shard(0), Shard(2)), True),  # ("dp", None, "tp")
                               ((Shard(0), Shard(1)), True),  # ("dp", "sp", None)
                               ((Replicate(), Shard(1)), True)]  # "tp" once: dim 1 takes it


def test_placements_refuse_axes_out_of_mesh_order():
    class M:
        mesh_dim_names = ("data", "model")

    with pytest.raises(ValueError, match="order"):
        specs.placements(P(("model", "data")), M())
