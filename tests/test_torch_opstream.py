"""The port's whole-model operator streams against the JAX package's, on
the CPU.

Every (config, shape) cell of ``runnable_cells()`` over the 10 configs,
and the three card shapes ``chip_smoke.py``'s ``whole_model`` phase
drives, must lower to the same deduplicated ``OpStream`` as ``repro``'s,
entry by entry (name, role, multiplicity, problem content, ``mappable``,
``meta``, ``backward_factor``); the shared builders, parameter counts,
MODEL_FLOPS formula, artifact readers, end-to-end aggregation and the
``model_bench`` twin must agree with the reference bit for bit. The
port's model code builds every config the streams lower, with the JAX
init's parameter count.
"""

import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the reference's benchmarks/ (model_bench)

from repro.configs import base as jax_configs  # noqa: E402
from repro.core import opstream as jax_opstream  # noqa: E402
from repro.core.architecture import cloud_accelerator as jax_cloud  # noqa: E402
from repro.core.optimizer import union_opt_sweep as jax_union_opt_sweep  # noqa: E402
from repro.core.problem import Problem as JaxProblem  # noqa: E402
from repro.models import model as jax_model  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    SHAPES,
    ShapeConfig,
    get_config,
    list_configs,
    runnable_cells,
)
from repro_torch.core import opstream  # noqa: E402
from repro_torch.core.architecture import cloud_accelerator, h100_sm  # noqa: E402
from repro_torch.core.optimizer import union_opt_sweep  # noqa: E402
from repro_torch.core.problem import Problem  # noqa: E402
from repro_torch.launch import model_bench  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

# chip_smoke.py's whole_model phase: qwen3-0.6b decode and prefill at the
# serve phase's 8 slots x max_len 512, zamba2-2.7b train at 2 x 2048
CARD_CELLS = [
    ("qwen3-0.6b", ("h100_decode", 512, 8, "decode")),
    ("qwen3-0.6b", ("h100_prefill", 512, 8, "prefill")),
    ("zamba2-2.7b", ("h100_train", 2048, 2, "train")),
]
SMOKE_SHAPES = [("t_prefill", 128, 2, "prefill"), ("t_decode", 256, 8, "decode"),
                ("t_train", 128, 4, "train")]
FAMILIES = ["qwen3-0.6b", "deepseek-v2-lite-16b", "zamba2-2.7b"]


def _canon_problem(p):
    """Everything a Problem is made of, as plain data of either package."""
    return (
        p.name,
        tuple(p.dims.items()),
        tuple((ds.name, repr(ds.projection), ds.is_output, ds.word_bytes)
              for ds in p.data_spaces),
        p.operation,
        p.unit_op,
        tuple(sorted((k, repr(v)) for k, v in p.attrs.items())),
    )


def _canon_stream(s):
    return (s.model, s.shape, s.kind, s.backward_factor, s.meta,
            [(_canon_problem(e.problem), e.role, e.multiplicity, e.mappable)
             for e in s.entries])


def _shapes(spec):
    return ShapeConfig(*spec), jax_configs.ShapeConfig(*spec)


# --------------------------------------------------------------------- #
# shared builders
# --------------------------------------------------------------------- #
BUILDERS = [
    ("build_gemm", (512, 1024, 64), {"name": "g", "word_bytes": 1}),
    ("build_gemm", (8, 151936, 1024), {}),
    ("build_conv2d", (32, 64, 64, 56, 56, 3, 3), {"name": "c", "word_bytes": 1}),
    ("build_conv2d", (1, 8, 4, 16, 16, 3, 3), {"stride": 2, "name": "s"}),
    ("build_einsum", ("e", "ij,jk->ik", {"i": 4, "j": 8, "k": 2}, "GEMM", 2), {}),
    ("build_einsum", ("dw", "twc,wc->tc", {"t": 64, "w": 4, "c": 96}, "DWCONV"), {}),
    ("build_tc_intensli2", (16,), {"word_bytes": 1}),
    ("build_tc_ccsd7", (64,), {"word_bytes": 1}),
    ("build_tc_ccsd_t4", (32,), {}),
]


@pytest.mark.parametrize("name,args,kw", BUILDERS,
                         ids=[f"{b[0]}-{i}" for i, b in enumerate(BUILDERS)])
def test_builders_match_reference(name, args, kw):
    got = getattr(opstream, name)(*args, **kw)
    want = getattr(jax_opstream, name)(*args, **kw)
    assert _canon_problem(got) == _canon_problem(want)
    assert got.flops == want.flops
    assert got.total_tensor_bytes() == want.total_tensor_bytes()


def test_builders_match_adhoc_constructors():
    pairs = [
        (opstream.build_gemm(512, 1024, 64, name="g", word_bytes=1),
         Problem.gemm(512, 1024, 64, name="g", word_bytes=1)),
        (opstream.build_conv2d(1, 8, 4, 16, 16, 3, 3, stride=2, name="s"),
         Problem.conv2d(1, 8, 4, 16, 16, 3, 3, stride=2, name="s")),
        (opstream.build_tc_ccsd7(64, word_bytes=1), Problem.tc_ccsd7(64, word_bytes=1)),
    ]
    for built, adhoc in pairs:
        assert built == adhoc and built.attrs == adhoc.attrs
    assert _canon_problem(pairs[0][0]) == _canon_problem(
        JaxProblem.gemm(512, 1024, 64, name="g", word_bytes=1))


# --------------------------------------------------------------------- #
# streams, cell by cell
# --------------------------------------------------------------------- #
def test_configs_and_cells_match_reference():
    assert list_configs() == jax_configs.list_configs()
    assert runnable_cells() == jax_configs.runnable_cells()
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in jax_configs.SHAPES.items()}
    for name in list_configs():
        assert get_config(name).__dict__ == jax_configs.get_config(name).__dict__


@pytest.mark.parametrize("model,shape", runnable_cells())
def test_stream_matches_reference(model, shape):
    got = opstream.build_opstream(model, shape)
    want = jax_opstream.build_opstream(model, shape)
    assert _canon_stream(got) == _canon_stream(want)
    assert got.total_flops() == want.total_flops()
    assert got.total_bytes() == want.total_bytes()
    assert got.flops_by_role() == want.flops_by_role()
    r, jr = opstream.reconcile_model_flops(got), jax_opstream.reconcile_model_flops(want)
    assert r == jr
    lo, hi = opstream.RECONCILE_BAND
    assert lo <= r["ratio"] <= hi


@pytest.mark.parametrize("model,spec", CARD_CELLS, ids=[c[1][0] for c in CARD_CELLS])
def test_card_stream_matches_reference(model, spec):
    sh, jsh = _shapes(spec)
    got = opstream.build_opstream(model, sh)
    assert _canon_stream(got) == _canon_stream(jax_opstream.build_opstream(model, jsh))
    lo, hi = opstream.RECONCILE_BAND
    assert lo <= opstream.reconcile_model_flops(got)["ratio"] <= hi
    # the GEMM entries chip_smoke.py launches: every (b, i, o) linear
    gemms = [e for e in got.mappable_entries()
             if e.problem.attrs.get("einsum") == "bi,io->bo"]
    assert {e.role for e in gemms} <= {"attention", "mlp", "ssm", "head"}
    assert len(gemms) == 6 and gemms[-1].role == "head"


@pytest.mark.parametrize("model", FAMILIES + ["xlstm-1.3b", "hubert-xlarge"])
@pytest.mark.parametrize("spec", SMOKE_SHAPES, ids=[s[0] for s in SMOKE_SHAPES])
def test_smoke_stream_matches_reference(model, spec):
    cfg = get_config(model).reduced()
    if spec[3] == "decode" and not cfg.supports_decode:
        with pytest.raises(ValueError, match="encoder-only"):
            opstream.build_opstream(cfg, ShapeConfig(*spec))
        return
    sh, jsh = _shapes(spec)
    got = opstream.build_opstream(cfg, sh, serving_batch=4)
    want = jax_opstream.build_opstream(jax_configs.get_config(model).reduced(), jsh,
                                       serving_batch=4)
    assert _canon_stream(got) == _canon_stream(want)


@pytest.mark.parametrize("name", jax_configs.list_configs())
def test_param_counts_and_formula_match_reference(name):
    for cfg, jcfg in ((get_config(name), jax_configs.get_config(name)),
                      (get_config(name).reduced(), jax_configs.get_config(name).reduced())):
        assert cfg.num_params() == jcfg.num_params()
        assert cfg.active_params() == jcfg.active_params()
        for key in SHAPES:
            assert opstream.formula_model_flops(cfg, SHAPES[key]) == (
                jax_opstream.formula_model_flops(jcfg, jax_configs.SHAPES[key]))
    if get_config(name).n_routed_experts:
        for tokens in (1, 8, 4096):
            assert opstream.moe_expert_capacity(get_config(name), tokens) == (
                jax_opstream.moe_expert_capacity(jax_configs.get_config(name), tokens))


def _artifact(raw: bool):
    body = {"flops_per_device": 3.25e12, "bytes_per_device": 7.5e10,
            "collective_bytes_per_device": 1.6e9}
    art = {"chips": 256, "model_flops": 6.4e14, "cell": "qwen3-0.6b__decode_32k",
           "extras": {"scan_trips": 28}}
    if raw:
        art.update(body)
    else:
        art["corrected"] = body
        art.update({k: v / 2 for k, v in body.items()})  # raw numbers, ignored
    return art


@pytest.mark.parametrize("raw", [False, True], ids=["corrected", "raw"])
def test_artifact_readers_match_reference(raw, tmp_path):
    art = _artifact(raw)
    s = opstream.build_opstream("qwen3-0.6b", "decode_32k")
    js = jax_opstream.build_opstream("qwen3-0.6b", "decode_32k")
    got = opstream.reconcile_with_artifact(s, art)
    assert got == jax_opstream.reconcile_with_artifact(js, art)
    assert opstream.measured_collective_s(art) == jax_opstream.measured_collective_s(art)
    # and from a file under the reference's path layout
    path = opstream.artifact_path("qwen3-0.6b", "decode_32k", art_dir=tmp_path)
    assert path == jax_opstream.artifact_path("qwen3-0.6b", "decode_32k", art_dir=tmp_path)
    path.write_text(json.dumps(art))
    assert opstream.reconcile_with_artifact(s, path) == got
    assert opstream.measured_collective_s(str(path)) == opstream.measured_collective_s(art)
    assert math.isfinite(got["flops_ratio"]) and got["collective_bytes_per_device"] == 1.6e9


# --------------------------------------------------------------------- #
# one sweep, end to end
# --------------------------------------------------------------------- #
def test_aggregate_stream_costs_match_reference():
    """The three families' smoke streams at three shapes through ONE sweep
    on each package: the same tasks, solutions and per-model, per-role
    end-to-end costs, bit for bit."""
    streams, jstreams = [], []
    for model in FAMILIES:
        for spec in SMOKE_SHAPES[:1] + SMOKE_SHAPES[2:]:
            sh, jsh = _shapes(spec)
            streams.append(opstream.build_opstream(get_config(model).reduced(), sh))
            jstreams.append(jax_opstream.build_opstream(
                jax_configs.get_config(model).reduced(), jsh))
    arch, jarch = cloud_accelerator(), jax_cloud()
    tasks, index = opstream.stream_sweep_tasks(streams, arch)
    jtasks, jindex = jax_opstream.stream_sweep_tasks(jstreams, jarch)
    assert index == jindex and [t.tag for t in tasks] == [t.tag for t in jtasks]
    sweep = union_opt_sweep(tasks)
    jsweep = jax_union_opt_sweep(jtasks, engine_backend="numpy")
    assert [s.mapping.to_dict() for s in sweep] == [s.mapping.to_dict() for s in jsweep]
    coll = {streams[0].model: 1.5e-4}
    got = opstream.aggregate_stream_costs(streams, index, sweep.solutions, arch,
                                          collective_s=coll)
    want = jax_opstream.aggregate_stream_costs(jstreams, jindex, jsweep.solutions, jarch,
                                               collective_s=coll)
    assert [c.row() for c in got] == [c.row() for c in want]
    assert got[0].collective_s == 1.5e-4 and got[0].edp > 0


def test_card_streams_sweep_on_h100_and_aggregate():
    """The whole_model phase's sweep, on the CPU: every mappable entry of
    the three card streams conforms to the timeloop model on h100_sm()
    and aggregates to a finite per-role latency."""
    streams = [opstream.build_opstream(m, ShapeConfig(*spec)) for m, spec in CARD_CELLS]
    arch = h100_sm()
    tasks, index = opstream.stream_sweep_tasks(streams, arch)
    assert len(tasks) == sum(len(s.mappable_entries()) for s in streams) == 29
    sweep = union_opt_sweep(tasks)
    costs = opstream.aggregate_stream_costs(streams, index, sweep.solutions, arch)
    for s, c in zip(streams, costs):
        assert set(c.roles) == {e.role for e in s.entries}
        assert math.isfinite(c.latency_s) and c.latency_s > 0
        assert math.isclose(sum(r["latency_s"] for r in c.roles.values()), c.latency_s)


def test_model_bench_smoke_matches_reference(tmp_path, monkeypatch):
    """The twin's smoke rows equal ``benchmarks/model_bench.py``'s; both
    write under the working directory, here a temporary one."""
    from benchmarks import model_bench as jax_model_bench

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("UNION_DETERMINISTIC_STATS", "1")
    got = model_bench.run(smoke=True)
    want = jax_model_bench.run(smoke=True, regress_check=False)
    assert got["rows"] == want["rows"]
    assert got["models"] == want["models"] and got["shape"] == want["shape"]
    assert got["sweep_stats"]["considered"] == want["sweep_stats"]["considered"]
    assert json.loads((tmp_path / "experiments/torch/model.json").read_text())["rows"] == (
        got["rows"])
    assert not (tmp_path / "BENCH_model.json").exists()


def test_model_bench_cli_flags(tmp_path, monkeypatch):
    """The twin takes the reference's flags, less the regression gate's."""
    monkeypatch.chdir(tmp_path)
    jpath = tmp_path / "journal.json"
    first = model_bench.main(["--smoke", "--models", "qwen3-0.6b", "--journal", str(jpath)])
    again = model_bench.main(["--smoke", "--models", "qwen3-0.6b", "--journal", str(jpath),
                              "--resume", "--workers", "2", "--pool", "thread"])
    assert again["rows"][0]["latency_s"] == first["rows"][0]["latency_s"]
    assert again["sweep_stats"]["replayed_groups"] == first["rows"][0]["n_unique_ops"] - 1
    with pytest.raises(SystemExit):
        model_bench.main(["--smoke", "--no-regress-check"])


# --------------------------------------------------------------------- #
# the model code builds every config the streams lower
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["xlstm-1.3b", "llava-next-34b", "hubert-xlarge"])
def test_model_builds_every_block_kind_and_frontend(name):
    """The three configs with xLSTM blocks or a stub frontend build at full
    width (meta tensors) with exactly the JAX init's parameter count, and
    at smoke size on the CPU."""
    shapes = jax.eval_shape(lambda k: jax_model.init_params(jax_configs.get_config(name), k),
                            jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in init_params(get_config(name), None, "meta").parameters()) == n_jax
    init_params(get_config(name).reduced(), None, "cpu")
