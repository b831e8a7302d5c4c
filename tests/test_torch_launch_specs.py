"""The port's dry-run inputs and analytic counts (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.specs``, ``repro.launch.dryrun``).

``input_specs`` of all 31 runnable cells: every leaf's shape and dtype,
the port's mapped onto the reference's leaf paths (``state_to_reference_layout``
for parameters and training state; decode caches by layer, units stacked)
against ``jax.eval_shape``'s. ``analytic_memory`` and ``model_flops`` on the
16x16 and 2x16x16 production meshes, for every cell (train cells at 1 and 2
microbatches): the reference runs in a subprocess with 512 host devices
(its module sets ``XLA_FLAGS`` when imported; this process keeps one
device), the port on a fake process group of the mesh's size. Both get
``hbm_bytes`` explicitly, so the H100's 80 GB and the TPU's 16 GiB do not
differ.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch.distributed as dist

from repro.launch.specs import input_specs as ref_input_specs
from repro_torch.configs.base import SHAPES, get_config, runnable_cells
from repro_torch.launch import dryrun, specs
from repro_torch.models.convert import state_to_reference_layout

CELLS = runnable_cells()
SRC = Path(__file__).resolve().parent.parent / "src"
HBM = 80 * 10**9


def _sig(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _ref_leaves(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _params(model, cfg):
    lay = state_to_reference_layout({"model": model, "opt": {"step": 0}}, cfg)
    return {k: _sig(v) for k, v in lay.items() if k != "['opt']['step']"}


def _cache(cache, cfg):
    """The port's per-layer cache as the reference's ``{"prefix": [...],
    "units": {"b<j>": stacked}}`` leaves."""
    fk, n_pat = cfg.first_k_dense, len(cfg.block_pattern)
    out, units = {}, {}
    for i, layer in enumerate(cache):
        for name, t in layer.items():
            if i < fk:
                out[f"['prefix'][{i}]['{name}']"] = _sig(t)
            else:
                key = f"['units']['b{(i - fk) % n_pat}']['{name}']"
                units.setdefault(key, []).append(_sig(t))
    for key, sigs in units.items():
        assert len(set(sigs)) == 1, key
        out[key] = ((len(sigs), *sigs[0][0]), sigs[0][1])
    return out


@functools.lru_cache(maxsize=None)
def _inputs(arch, shape):
    return specs.input_specs(arch, shape)


def _port_leaves(arch, shape):
    cfg = get_config(arch)
    inp = _inputs(arch, shape)
    if "state" in inp:
        lay = state_to_reference_layout(inp["state"], cfg)
        out = {"['state']" + k: _sig(v) for k, v in lay.items()}
    else:
        out = _params(inp["params"], cfg)
    if "cache" in inp:
        out.update({"['cache']" + k: v for k, v in _cache(inp["cache"], cfg).items()})
        out["['tokens']"] = _sig(inp["tokens"])
        out["['pos']"] = _sig(inp["pos"])
    else:
        out.update({f"['batch']['{k}']": _sig(v) for k, v in inp["batch"].items()})
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    want = _ref_leaves(ref_input_specs(arch, shape))
    got = _port_leaves(arch, shape)
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]


def test_input_specs_allocate_nothing():
    inp = specs.input_specs("qwen1.5-110b", "train_4k")
    leaves = list(inp["state"]["model"].parameters()) + list(inp["batch"].values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in inp["state"]["model"].parameters()) > 100e9


# --------------------------------------------------------------------- #
# analytic_memory and model_flops on the production meshes
# --------------------------------------------------------------------- #
_REF_SCRIPT = r"""
import json, sys
import repro.launch.dryrun as D  # sets XLA_FLAGS: 512 host devices
from repro.configs.base import SHAPES, runnable_cells
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import build_cell
from repro.sharding.specs import ShardingRules

hbm = int(sys.argv[1])
rules = ShardingRules()
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch, shape in runnable_cells():
        fn, args, in_sh, out_sh = build_cell(arch, shape, mesh, rules)
        mbs = (1, 2) if SHAPES[shape].kind == "train" else (1,)
        out[f"{arch}|{shape}|{int(mp)}"] = {
            "memory": {str(mb): D.analytic_memory(arch, shape, mesh, args, in_sh, mb, rules,
                                                  hbm_bytes=hbm) for mb in mbs},
            "model_flops": D.model_flops(arch, shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_counts():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(HBM)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module", params=[False, True], ids=["16x16", "2x16x16"])
def production_mesh(request):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if request.param else 256)
    try:
        yield request.param, make_production_mesh(multi_pod=request.param, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_memory_and_model_flops_match_the_reference(production_mesh,
                                                             reference_counts, arch, shape):
    mp, mesh = production_mesh
    rules = specs.ShardingRules()
    want = reference_counts[f"{arch}|{shape}|{int(mp)}"]
    inp = _inputs(arch, shape)
    kind = SHAPES[shape].kind
    if kind == "train":
        args = (inp["state"], inp["batch"])
    elif kind == "prefill":
        args = (inp["params"], inp["batch"])
    else:
        args = (inp["params"], inp["cache"], inp["tokens"], inp["pos"])
    in_sh = specs.reference_layout(arch, shape, mesh, args, rules)
    for mb, ref in want["memory"].items():
        got = dryrun.analytic_memory(arch, shape, mesh, args, in_sh, int(mb), rules,
                                     hbm_bytes=HBM)
        assert got == ref, (mb, got, ref)
    assert dryrun.model_flops(arch, shape) == want["model_flops"]


def test_hbm_default_is_the_h100s():
    assert dryrun.HBM_PER_CHIP == 80 * 10**9
