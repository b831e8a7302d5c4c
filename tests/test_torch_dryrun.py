"""The port's dry-run (``repro_torch.launch.dryrun``, ``.collectives``):
traced smoke cells on fake process groups, the counters' ground truth,
and the collective byte conventions against the reference's
``parse_collectives``.

Smoke configs of three families (qwen3: attention; zamba2: Mamba-2 and
attention; qwen2-moe: MoE), train, prefill and decode, each traced for rank
0 of a fake 2x2 and 2x2x2 mesh (batch 8, so the rows divide over both dp
pools): every key of the reference's artifact (read from
``src/repro/launch/dryrun.py``) is present, FLOPs per device fall with the
pod axis, train cells issue collectives, useful FLOPs of a train cell on
one rank lie in the reference test's band (0.05, 1.05], and the port's
artifact readers read the artifacts. No process group is left behind.
"""

import ast
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.launch.hloparse import parse_collectives
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core.cost.roofline import RooflineReport
from repro_torch.core.opstream import build_opstream, measured_collective_s, reconcile_with_artifact
from repro_torch.launch import collectives, dryrun

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["qwen3-0.6b_smoke", "zamba2-2.7b_smoke", "qwen2-moe-a2.7b_smoke"]
SHAPES = {"train": ShapeConfig("train_s", 64, 8, "train"),
          "prefill": ShapeConfig("prefill_s", 64, 8, "prefill"),
          "decode": ShapeConfig("decode_s", 64, 8, "decode")}
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2), "1x1": (1, 1)}


def _reference_keys():
    """The keys of the reference's artifact and of its ``memory`` block,
    from the dict ``run_cell`` writes."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "art" for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            memory = node.value.values[keys.index("memory")]
            return keys, [k.value for k in memory.keys]
    raise AssertionError("no artifact dict in the reference's dryrun.py")


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")

    @functools.lru_cache(maxsize=None)
    def run(arch, kind, mesh):
        art = dryrun.run_cell(arch, SHAPES[kind], len(MESHES[mesh]) == 3, out_dir=out,
                              mesh_shape=MESHES[mesh])
        assert not dist.is_initialized()
        return art

    return run


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_artifact_has_the_references_keys(cell, arch, kind, mesh):
    art = cell(arch, kind, mesh)
    keys, memory_keys = _reference_keys()
    assert set(keys) <= set(art), set(keys) - set(art)
    assert set(memory_keys) <= set(art["memory"])
    assert art["chips"] == math.prod(MESHES[mesh]) and art["mesh"] == mesh
    assert art["compute"] and art["hlo_lines"] == 0
    assert art["corrected"]["method"] == "traced, every unit"
    assert art["flops_per_device"] > 0 and art["bytes_per_device"] > 0
    m = art["memory"]
    assert m["peak_per_device"] >= m["argument_bytes"] > 0
    assert m["peak_per_device"] == (m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
                                    + m["temp_bytes"])
    assert sum(m["peak_by_category"].values()) == m["peak_per_device"]
    assert art["model_flops"] == dryrun.model_flops(arch, SHAPES[kind])
    assert (dryrun.OUT_DIR.parts[-2:] == ("torch", "dryrun"))


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_per_device_fall_with_the_pod_axis(cell, arch, kind):
    f1 = cell(arch, kind, "2x2")["corrected"]["flops_per_device"]
    f2 = cell(arch, kind, "2x2x2")["corrected"]["flops_per_device"]
    assert f2 < f1 * 0.75


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cells_have_collectives(cell, arch, mesh):
    art = cell(arch, "train", mesh)
    assert art["collectives"]["all-reduce_count"] > 0
    assert art["collective_bytes_per_device"] > 0
    assert {"parameters", "optimizer", "inputs"} <= set(art["memory"]["peak_by_category"])


@pytest.mark.parametrize("arch", ARCHS)
def test_useful_flops_on_one_rank(cell, arch):
    art = cell(arch, "train", "1x1")
    ratio = art["model_flops"] / (art["corrected"]["flops_per_device"] * art["chips"])
    assert 0.05 < ratio <= 1.05, ratio
    assert art["collective_bytes_per_device"] == 0  # one rank: every collective is skipped


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_artifact_readers_read_it(cell, arch, kind):
    art = cell(arch, kind, "2x2")
    rep = RooflineReport.from_artifact(art["cell"], art)
    assert rep.chips == 4 and rep.flops_per_chip == art["flops_per_device"]
    assert rep.collective_s == measured_collective_s(art)
    r = reconcile_with_artifact(build_opstream(get_config(arch), SHAPES[kind]), art)
    assert r["model_flops_artifact"] == art["model_flops"]
    assert r["hlo_flops"] == art["flops_per_device"] * 4
    assert math.isfinite(r["flops_ratio"]) and r["flops_ratio"] > 0


def test_no_process_group_is_left_behind(tmp_path):
    from repro_torch.sharding import hints

    before = dict(hints._STATE)
    dryrun.run_cell("qwen3-0.6b_smoke", SHAPES["train"], False, out_dir=tmp_path,
                    mesh_shape=(2, 2))
    assert not dist.is_initialized()
    assert hints._STATE == before  # the hints the train cell installed are gone
    assert (tmp_path / "qwen3-0.6b_smoke__train_s__2x2.json").exists()
    rows = dryrun.table(tmp_path).splitlines()
    assert len(rows) == 3 and rows[2].startswith("| qwen3-0.6b_smoke train_s | ")


# --------------------------------------------------------------------- #
# the counters' ground truth
# --------------------------------------------------------------------- #
def test_a_dense_layer_counts_2mnk_flops():
    from repro_torch.models.layers import Dense

    M, K, N = 48, 64, 80
    layer = Dense(K, N, generator=None, device="meta")
    x = torch.empty(M, K, dtype=torch.bfloat16, device="meta")
    with dryrun.StepCounter() as c:
        layer(x)
    assert c.flops == 2 * M * N * K


def test_an_elementwise_op_counts_its_input_and_output_bytes():
    x = torch.empty(1000, dtype=torch.float32, device="meta")
    y = torch.empty(1000, dtype=torch.bfloat16, device="meta")
    with dryrun.StepCounter() as c:
        x.view(10, 100)  # a view moves nothing
        z = x + y
    assert z.dtype == torch.float32
    assert c.bytes == 4000 + 2000 + 4000 and c.flops == 0


def test_a_fake_all_gather_counts_the_ring_bytes():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        out = torch.empty(4, 256, dtype=torch.bfloat16, device="meta")
        with collectives.CollectiveCounter() as cc:
            dist.all_gather_into_tensor(out, torch.empty(1, 256, dtype=torch.bfloat16,
                                                         device="meta"))
    finally:
        dist.destroy_process_group()
    row = cc.stats.row()
    assert row["all-gather_count"] == 1
    assert row["all-gather_bytes"] == 4 * 256 * 2 * 3 / 4


def test_the_peak_matches_memtracker_on_a_rematerialised_stack():
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.checkpoint import checkpoint

    def run(mode, layers, x):
        with mode:
            h = x
            for w in layers:
                h = checkpoint(lambda a, w=w: torch.relu(torch.relu(a @ w.weight) @ w.weight),
                               h, use_reentrant=False)
            h.sum().backward()

    x = torch.empty(512, 256, requires_grad=True, device="meta")
    layers = [torch.nn.Linear(256, 256, bias=False, device="meta") for _ in range(6)]
    counter = dryrun.StepCounter(block=1)  # MemTracker rounds CUDA storages only
    for w in layers:
        counter.track(w.weight, "parameters")
    counter.track(x, "inputs")
    run(counter, layers, x)
    for w in layers:
        w.weight.grad = None
    x.grad = None
    tracker = MemTracker()
    tracker.track_external(*layers, x)
    run(tracker, layers, x)
    (snap,) = tracker.get_tracker_snapshot("peak").values()
    assert counter.peak == snap["Total"]


def test_the_flops_are_flopcountermodes():
    """FLOPs by FlopCounterMode's table equal FlopCounterMode's total over
    a train step (its forward, remat recompute and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding import hints

    saved = dict(hints._STATE)  # a train cell installs the mesh's hints
    assert dryrun._fake_world(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        fn, args, _, _ = build_cell("qwen3-0.6b_smoke", SHAPES["train"], mesh)
        with dryrun.StepCounter() as c:
            fn(*args)
        with FlopCounterMode(display=False) as fc:
            fn(*args)
    finally:
        dist.destroy_process_group()
        hints._STATE.clear()
        hints._STATE.update(saved)
    assert c.flops == fc.get_total_flops() > 0


# --------------------------------------------------------------------- #
# collective byte conventions against the reference's HLO parser
# --------------------------------------------------------------------- #
_HLO_DTYPE = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "s8"}
_COLL = [  # (kind, dtype, output shape, group)
    ("all-gather", torch.bfloat16, (4, 256), 4),
    ("all-reduce", torch.float32, (128,), 8),
    ("reduce-scatter", torch.float32, (64,), 4),
    ("all-to-all", torch.bfloat16, (512,), 2),
    ("collective-permute", torch.int8, (100,), 2),
    ("all-reduce", torch.bfloat16, (3, 5), 16),
    ("reduce-scatter", torch.bfloat16, (7, 9), 16),
]


def _hlo(kind, dtype, shape, n, i, iota):
    t = f"{_HLO_DTYPE[dtype]}[{','.join(map(str, shape))}]"
    groups = (f"replica_groups=[{32 // n},{n}]<=[32]" if iota
              else "replica_groups={{" + ",".join(map(str, range(n))) + "}}")
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1}}"
    return f"%c{i} = {t}{{0}} {kind}({t} %x{i}), {groups}"


@pytest.mark.parametrize("iota", [False, True], ids=["brace", "iota"])
def test_collective_rows_match_parse_collectives(iota):
    stats = collectives.CollectiveStats()
    for kind, dtype, shape, n in _COLL:
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        # the reference reads no group off a permute: its default, 2
        stats.add(kind, float(nbytes), 2 if kind == "collective-permute" else n)
    hlo = "\n".join(_hlo(*c, i, iota) for i, c in enumerate(_COLL))
    assert stats.row() == parse_collectives(hlo).row()
    assert stats.row()["reduce-scatter_bytes"] == 64 * 4 * 3 + 7 * 9 * 2 * 15


# --------------------------------------------------------------------- #
# the modules stand alone
# --------------------------------------------------------------------- #
def test_importing_the_dry_run_loads_neither_jax_nor_repro():
    code = ("import os, sys; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.specs, "
            "repro_torch.launch.collectives; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; "
            "assert not bad, bad[:5]; assert dict(os.environ) == before; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


SERVING_CACHE = {"qwen3-0.6b_smoke": {"heads": 4}, "qwen2-moe-a2.7b_smoke": {"heads": 4},
                 "zamba2-2.7b_smoke": {"channels": 15, "heads": 7}}


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cells_are_partitioned_and_name_their_layout(cell, arch, kind, mesh):
    """A serving cell traces the partitioned step on the inference layout:
    its ``partition`` names each branch's mode (every block branch "tp" at
    these widths) and a decode cell's cache leaves by layout; the tp ranks
    no longer repeat the whole model."""
    from repro_torch.launch.specs import COMPUTE

    art = cell(arch, kind, mesh)
    assert art["compute"] == COMPUTE[kind]
    part = art["partition"]
    assert isinstance(part, dict) and part["whole"] == []
    assert set(part["modes"]) <= {"tp", "vocab"}, part
    if kind == "decode":
        assert part["cache"] == SERVING_CACHE[arch]
    else:
        assert "cache" not in part
    assert art["collectives"]["all-reduce_count" if kind == "decode" else "all-gather_count"] > 0


@pytest.mark.parametrize("arch,shape,rules", [
    ("xlstm-1.3b_smoke", "decode", None),
    ("qwen3-0.6b_smoke", "decode", "fsdp_only"),
    ("qwen3-0.6b_smoke", "prefill", "fsdp_only"),
])
def test_unpartitioned_serving_says_replica(tmp_path, arch, shape, rules):
    """The xLSTM decode and ``fsdp_only`` serving, once replicas, trace the
    partitioned step and say so: the xLSTM's mLSTM and sLSTM on their
    heads with the cache by head (conv windows by channel); under
    ``fsdp_only`` a batch of 2, which does not divide over the 4 ranks'
    pool, puts the prompt's sequence over "model" (attention in mode
    "context") and the cache's sequence over both dims."""
    from repro_torch.launch.specs import COMPUTE
    from repro_torch.sharding.specs import ShardingRules

    kind = SHAPES[shape]
    if rules:
        kind = ShapeConfig(kind.name, kind.seq_len, 2, kind.kind)
    art = dryrun.run_cell(arch, kind, False, out_dir=tmp_path, mesh_shape=(2, 2),
                          rules=ShardingRules(fsdp_only=True) if rules else None)
    part = art["partition"]
    assert isinstance(part, dict) and art["compute"] == COMPUTE[
        shape + ("/fsdp_only" if rules else "")]
    if not rules:
        assert part["modes"] == {"tp": 6, "vocab": 2} and part["whole"] == []
        assert part["cache"] == {"channels": 5, "heads": 19}
    elif shape == "decode":
        assert set(part["modes"]) == {"local"} and part["cache"] == {"sequence over dp": 4}
    else:
        assert part["modes"] == {"context": 2, "tokens": 2, "whole": 2}, part
        assert part["whole"] == ["embed", "head"] and "cache" not in part
    assert not dist.is_initialized()
