"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): count what one
step of every (architecture x input-shape) cell costs a device on the
reference's production meshes, with no device.

For every cell, on the single-pod 16x16 mesh AND the 2x16x16 multi-pod
mesh, the step the port runs (``launch/specs.build_cell``, partitioned
in every cell: for training FSDP per unit and tensor parallel over
"model"; for serving the inference layout, tensor parallel over "model"
with the cache by ``cache_specs``; under ``fsdp_only`` FSDP over every
dim with the sequence over "model" where the rows do not divide, context
parallel attention) is traced once for rank 0 of a fake
process group of 256 or 512 ranks, on shape-only ``meta`` tensors, with
the hand-written kernels switched off (their plain versions run: a kernel
needs real device memory). One dispatch mode counts, op by op:

- FLOPs, by ``torch.utils.flop_counter``'s table (``flop_registry``, the
  formulas ``FlopCounterMode`` applies): matmul, bmm, convolution and
  attention work; elementwise work is not counted. ``FlopCounterMode``
  itself is not used: its module tracker's backward hooks keep the
  recomputed activations of every rematerialised unit alive until a
  garbage collection, which doubles the traced peak;
- bytes: for each aten op, the bytes of the tensors it reads plus those it
  writes, views counting zero (the eager counterpart of XLA's "bytes
  accessed");
- collectives (``launch/collectives.py``): every ``c10d`` op the step
  issues, by kind, output bytes and group size, at the ring conventions;
- memory: the live storages of the device (rounded up to the CUDA caching
  allocator's 512-byte blocks) from the step's arguments on, and their
  peak, broken down into parameters (the state's slices), optimizer
  state, inputs (batch, tokens, cache), gradients (each parameter's
  ``.grad``), activations (what the step makes outside autograd's
  backward: the forward's activations and gathered weights, the update's
  temporaries) and backward (the backward's recomputed activations,
  regathered weights and temporaries). The counterpart of
  ``memory_analysis()``.

The port's blocks are a Python loop, so every unit is traced: there is no
scan body to correct (the reference's ``corrected_costs``), and the
artifact's ``corrected`` block holds the traced counts. There is no HLO:
``hlo_lines`` is 0. ``lower_s`` is the seconds to build the cell,
``compile_s`` the seconds to trace it. ``memory_tpu_analytic`` keeps the
reference's analytic estimate (its name kept for the readers), checked
against the H100's 80 GB. Artifacts go to experiments/torch/dryrun/*.json.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only] [--jobs 4]
  python -m repro_torch.launch.dryrun --table   # the artifacts as a markdown table
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config, runnable_cells
from repro_torch.core.architecture import H100_SXM
from repro_torch.core.opstream import formula_model_flops
from repro_torch.launch.collectives import CollectiveStats, record
from repro_torch.sharding.specs import ShardingRules, _axis_sizes

# Per-chip HBM capacity of the card the port runs on (H100 SXM, 80 GB).
# Override per call via the hbm_bytes= parameters or the --hbm-gib CLI flag.
HBM_PER_CHIP = int(H100_SXM["hbm_bytes"])
OUT_DIR = Path("experiments/torch/dryrun")
BLOCK = 512  # the CUDA caching allocator's smallest block


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _cfg(arch) -> ModelConfig:
    return get_config(arch) if isinstance(arch, str) else arch


# --------------------------------------------------------------------- #
# the reference's analytic estimate
# --------------------------------------------------------------------- #
def _is_placement(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "mesh_dim_names")


def _as_tree(struct):
    """A Model -> {name: parameter}; a training state -> the reference's
    ``{"params", "opt"}``."""
    if hasattr(struct, "named_parameters"):
        return dict(struct.named_parameters())
    if isinstance(struct, dict) and "model" in struct:
        return {"params": struct["model"], **{k: v for k, v in struct.items() if k != "model"}}
    return struct


def _pairs(struct, sh):
    if _is_placement(sh):
        yield struct, sh
    elif isinstance(sh, dict):
        tree = _as_tree(struct)
        for k, v in sh.items():
            yield from _pairs(tree[k], v)
    else:
        for s, v in zip(struct, sh):
            yield from _pairs(s, v)


def _sharded_nbytes(struct_tree, sharding_tree) -> int:
    """Exact per-device bytes of a tree of stand-ins (whole shapes; a
    DTensor's global one) under ``(mesh, placements)``: each leaf's bytes
    divided by the sizes of the mesh dims that shard it. A Python int (the
    optimizer's step) is the reference's int32 scalar."""
    from torch.distributed.tensor import Shard

    total = 0
    for s, (mesh, pls) in _pairs(struct_tree, sharding_tree):
        nbytes = 4 if isinstance(s, int) else math.prod(s.shape) * s.element_size()
        div = math.prod(mesh.size(i) for i, pl in enumerate(pls) if isinstance(pl, Shard))
        total += nbytes // max(1, div)
    return total


def analytic_memory(arch, shape_name, mesh, args, in_sh,
                    microbatches: int = 1, rules=None,
                    hbm_bytes: int = 0) -> dict:
    """The reference's per-chip memory estimate, its arithmetic copied: the
    arguments' bytes under ``in_sh`` (the reference's layout, see
    ``specs.reference_layout``) plus its activation terms for the
    reference's partitioned step, against ``hbm_bytes`` (default the
    H100's)."""
    cfg = _cfg(arch)
    shape = _shape(shape_name)
    sizes = _axis_sizes(mesh)
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    tp = sizes.get("model", 1)
    args_bytes = sum(_sharded_nbytes(a, s) for a, s in zip(args, in_sh))
    B, S, d, V = shape.global_batch, shape.seq_len, cfg.d_model, cfg.vocab
    tok_local = B * S // dp
    act = 0

    def score_chunk_bytes(factor: int) -> int:
        # mirrors the reference's _auto_q_chunk: the q-chunk shrinks until
        # the f32 score chunk fits per chip
        hq_loc = max(1, cfg.n_heads // tp) if cfg.n_heads % tp == 0 else cfg.n_heads
        b_loc = B // dp if B % dp == 0 else B
        qc = min(1024, S)
        while qc > 128 and b_loc * qc * S * hq_loc * 4 > (1 << 31):
            qc //= 2
        return factor * max(1, b_loc) * qc * S * hq_loc * 4

    if shape.kind == "train":
        mb = max(1, microbatches)
        n_units = (cfg.n_layers - cfg.first_k_dense) // len(cfg.block_pattern)
        sp = tp if (S // 1) % tp == 0 else 1
        act += n_units * (B // min(B, dp)) * (B * S * d // (dp * sp) // (B // min(B, dp))) * 2 // mb  # carry stack bf16
        act += 2 * tok_local * max(1, V // tp) * 4 // mb  # fwd+bwd f32 logits
        act += score_chunk_bytes(2) // mb
        if mb > 1:  # f32 gradient accumulator (sharded like the params)
            act += cfg.num_params() * 4 // (dp * tp)
        if rules is not None and getattr(rules, "remat_policy", "full") == "save_block_outputs":
            # saved per-block residual contributions (bf16, seq-sharded)
            act += cfg.n_layers * (B * S // (dp * sp)) * d * 2 // mb
    elif shape.kind == "prefill":
        sp = tp if (B * S) % (dp * tp) == 0 else 1  # sequence sharding
        act += 12 * tok_local // sp * d * 2
        act += score_chunk_bytes(2)
        act += tok_local * max(1, V // tp) * 2
    else:  # decode
        act += 4 * (B // min(B, dp)) * max(1, V // tp) * 4
    total = args_bytes + act
    hbm = int(hbm_bytes) or HBM_PER_CHIP
    return {
        "args_bytes": int(args_bytes),
        "activation_bytes": int(act),
        "total_bytes": int(total),
        "hbm_per_chip": hbm,
        "fits_hbm": bool(total <= hbm),
    }


def model_flops(arch, shape_name) -> float:
    """MODEL_FLOPS convention (6/2/2 x active params x tokens): one
    definition, shared with the whole-model op streams
    (``repro_torch.core.opstream.formula_model_flops``)."""
    return formula_model_flops(_cfg(arch), _shape(shape_name))


# --------------------------------------------------------------------- #
# the traced step
# --------------------------------------------------------------------- #
def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _storages(t: torch.Tensor):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.untyped_storage()


class StepCounter(TorchDispatchMode):
    """Counts the aten ops run under it: FLOPs, bytes read and written
    (views zero), collectives, and the device's live storages with their
    peak by category. DTensor ops are left to DTensor, so each is counted
    as the local ops and collectives it runs. A leaf tensor that requires
    grad and enters an op (a parameter, or the step's leaf over its
    storage) is filed under parameters, and its ``.grad``, once
    accumulated, under gradients."""

    def __init__(self, block: int = BLOCK) -> None:
        super().__init__()
        self.block = block
        self.ops = 0
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats()
        self.live = 0
        self.peak = 0
        self.by_cat: Dict[str, int] = defaultdict(int)
        self.peak_by_cat: Dict[str, int] = {}
        self._held: Dict[int, list] = {}  # storage key -> [bytes, category, weakref]
        self._params = WeakIdKeyDictionary()  # the parameters met, by identity
        self._hooks: list = []

    def _key(self, st) -> int:
        return st._cdata

    def track(self, t: torch.Tensor, cat: str) -> None:
        st = _storages(t)
        key = self._key(st)
        if key in self._held:
            return
        n = -(-st.nbytes() // self.block) * self.block
        self._held[key] = [n, cat, weakref.ref(st, lambda _, k=key: self._free(k))]
        self.by_cat[cat] += n
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by_cat = dict(self.by_cat)

    def recategorize(self, t: torch.Tensor, cat: str) -> None:
        held = self._held.get(self._key(_storages(t)))
        if held is not None and held[1] != cat:
            self.by_cat[held[1]] -= held[0]
            self.by_cat[cat] += held[0]
            held[1] = cat

    def _free(self, key: int) -> None:
        held = self._held.pop(key, None)
        if held is not None:
            self.by_cat[held[1]] -= held[0]
            self.live -= held[0]

    def keys(self, tree) -> set:
        return {self._key(_storages(t)) for t in _tensors(tree)}

    def bytes_of(self, keys) -> int:
        return sum(self._held[k][0] for k in keys if k in self._held)

    def _parameter(self, p: torch.Tensor) -> None:
        self._params[p] = True
        self.recategorize(p, "parameters")
        self._hooks.append(p.register_post_accumulate_grad_hook(
            lambda q: self.recategorize(q.grad, "gradients")))

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        record(self.collectives, func, args, kwargs, out)
        ins = list(_tensors((args, kwargs)))
        for t in ins:
            if t.is_leaf and t.requires_grad and t not in self._params:
                self._parameter(t)
        outs = list(_tensors(out))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        cat = "backward" if torch._C._current_graph_task_id() != -1 else "activations"
        for t in outs:
            self.track(t, cat)
        return out


def _arg_categories(kind: str, args) -> list:
    if kind == "train":
        state, batch = args
        return [(list(state["model"].parameters()), "parameters"),
                (state["opt"], "optimizer"), (batch, "inputs")]
    return [(list(args[0].parameters()), "parameters"), (args[1:], "inputs")]


def trace_step(kind: str, fn, args) -> dict:
    """Runs ``fn(*args)`` once under the counters; returns the counts."""
    counter = StepCounter()
    trees = _arg_categories(kind, args)
    for tree, cat in trees:
        for t in _tensors(tree):
            counter.track(t, cat)
    arg_keys = counter.keys([tree for tree, _ in trees])
    arg_bytes = counter.bytes_of(arg_keys)
    with counter:
        out = fn(*args)
    out_keys = counter.keys(out)
    out_bytes = sum(-(-st.nbytes() // BLOCK) * BLOCK
                    for st in {counter._key(st): st for st in map(_storages, _tensors(out))}.values())
    alias = counter.bytes_of(out_keys & arg_keys)
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "ops": counter.ops,
        "collectives": counter.collectives,
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "alias_bytes": alias,
        "peak": counter.peak,
        "peak_by_category": {k: v for k, v in sorted(counter.peak_by_cat.items()) if v},
    }


# --------------------------------------------------------------------- #
# a cell
# --------------------------------------------------------------------- #
def _fake_world(world: int) -> bool:
    """Initialise a fake process group of ``world`` ranks (this process is
    rank 0) unless one is initialised; returns whether this call made it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def _mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return make_mesh(tuple(mesh_shape), axes, device_type="cpu")


def _modes(fn):
    """A step's partition: its branches by mode, by name those computed
    whole over "model" (no TP, no heads x rows, no context parallelism),
    and a decode step's cache leaves by layout ("heads", "sequence",
    "sequence over dp", "channels", "dk", "whole", or two of them)."""
    part = getattr(fn, "partition", None)
    if part is None:
        return None
    counts: Dict[str, int] = defaultdict(int)
    for mode in part.modes.values():
        counts[mode] += 1
    out = {"modes": dict(sorted(counts.items())),
           "whole": sorted(k for k, v in part.modes.items() if v == "whole")}
    if part.layouts:
        out["cache"] = part.cache_kinds()
    return out


def run_cell(arch: Union[str, ModelConfig], shape_name: Union[str, ShapeConfig],
             multi_pod: bool, rules=None, out_dir: Path = OUT_DIR, remat: bool = True,
             tag: str = "", hbm_bytes: int = 0,
             mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Traces one step of the cell for rank 0 on the 16x16 mesh (2x16x16
    with ``multi_pod``; ``mesh_shape`` picks another, e.g. ``(1, 1)``) and
    writes its artifact. A fake process group of the mesh's size is made
    where none is initialised, and destroyed after."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.specs import COMPUTE, build_cell, reference_layout
    from repro_torch.sharding import hints as hints_mod

    rules = rules or ShardingRules()
    cfg = _cfg(arch)
    shape = _shape(shape_name)
    hbm = int(hbm_bytes) or HBM_PER_CHIP
    world = math.prod(mesh_shape) if mesh_shape is not None else (512 if multi_pod else 256)
    own = _fake_world(world)
    was_on, old_hints = kernels.kernels_enabled(), dict(hints_mod._STATE)
    try:
        mesh = _mesh(multi_pod, mesh_shape)
        chips = mesh.size()
        mesh_name = "x".join(str(s) for s in mesh.shape)
        cell_name = f"{cfg.name}__{shape.name}__{mesh_name}" + (f"__{tag}" if tag else "")
        kernels.enable_kernels(False)
        t0 = time.time()
        fn, args, in_sh, out_sh = build_cell(cfg, shape, mesh, rules, remat=remat)
        ref_sh = reference_layout(cfg, shape, mesh, args, rules)
        # the smallest power of two whose analytic residency fits (the
        # reference's rule; only the activation terms depend on it)
        microbatches = 1
        while shape.kind == "train" and microbatches < 8:
            if analytic_memory(cfg, shape, mesh, args, ref_sh, microbatches, rules,
                               hbm_bytes=hbm)["fits_hbm"]:
                break
            microbatches *= 2
        if microbatches > 1:
            fn, args, in_sh, out_sh = build_cell(cfg, shape, mesh, rules, remat=remat,
                                                 microbatches=microbatches)
        t_build = time.time() - t0
        analytic = analytic_memory(cfg, shape, mesh, args, ref_sh, microbatches, rules,
                                   hbm_bytes=hbm)
        t1 = time.time()
        tr = trace_step(shape.kind, fn, args)
        t_trace = time.time() - t1
    finally:
        kernels.enable_kernels(was_on)
        hints_mod._STATE.clear()
        hints_mod._STATE.update(old_hints)
        if own:
            dist.destroy_process_group()
    colls = tr["collectives"]
    n_units = (cfg.n_layers - cfg.first_k_dense) // len(cfg.block_pattern)
    arg, out, alias, peak = (tr["argument_bytes"], tr["output_bytes"], tr["alias_bytes"],
                             tr["peak"])
    art = {
        "cell": cell_name,
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "multi_pod": multi_pod,
        "tag": tag,
        "compute": COMPUTE[getattr(fn, "compute", shape.kind)],
        "flops_per_device": tr["flops"],
        "bytes_per_device": tr["bytes"],
        "collective_bytes_per_device": colls.total_link_bytes,
        "collectives": colls.row(),
        # every unit is traced (a Python loop): these are the roofline inputs
        "corrected": {
            "method": "traced, every unit",
            "n_units": n_units,
            "flops_per_device": tr["flops"],
            "bytes_per_device": tr["bytes"],
            "collective_bytes_per_device": colls.total_link_bytes,
            "collectives": colls.row(),
        },
        "memory": {
            "argument_bytes": arg,
            "output_bytes": out,
            "alias_bytes": alias,
            "temp_bytes": max(0, peak - (arg + out - alias)),
            "peak_per_device": peak,
            "peak_by_category": tr["peak_by_category"],
            "hbm_per_chip": hbm,
            "fits_hbm": bool(peak <= hbm),
        },
        "memory_tpu_analytic": analytic,
        "microbatches": microbatches,
        "model_flops": model_flops(cfg, shape),
        "partition": _modes(fn),
        "hlo_lines": 0,
        "aten_ops": tr["ops"],
        "lower_s": t_build,
        "compile_s": t_trace,
    }
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_name}.json").write_text(json.dumps(art, indent=2))
    return art


def table(out_dir: Path = OUT_DIR) -> str:
    """A markdown table of the artifacts under ``out_dir``, a row per cell
    with each mesh's value (16x16 / 2x16x16): the traced peak and the
    analytic estimate against HBM, useful FLOPs (``model_flops /
    (flops_per_device x chips)``), collective bytes per device and the host
    seconds to build and trace."""
    cells: Dict[tuple, list] = defaultdict(list)
    for f in sorted(Path(out_dir).glob("*.json")):
        a = json.loads(f.read_text())
        cells[(a["arch"], a["shape"], a["tag"])].append(a)

    def col(arts, fmt) -> str:
        return " / ".join(fmt(a) for a in sorted(arts, key=lambda a: a["chips"]))

    def fits(ok: bool) -> str:
        return "" if ok else " no"

    rows = ["| Cell | Traced peak GiB | Analytic GiB | Useful FLOPs | Collective GB/device "
            "| Host s |", "| --- | --- | --- | --- | --- | --- |"]
    for (arch, shape, tag), arts in cells.items():
        rows.append(" | ".join([
            f"| {arch} {shape}" + (f" {tag}" if tag else ""),
            col(arts, lambda a: f"{a['memory']['peak_per_device'] / 2**30:.1f}"
                f"{fits(a['memory']['fits_hbm'])}"),
            col(arts, lambda a: f"{a['memory_tpu_analytic']['total_bytes'] / 2**30:.2f}"
                f"{fits(a['memory_tpu_analytic']['fits_hbm'])}"),
            col(arts, lambda a: f"{a['model_flops'] / (a['flops_per_device'] * a['chips']):.4f}"),
            col(arts, lambda a: f"{a['collective_bytes_per_device'] / 1e9:.1f}"),
            col(arts, lambda a: f"{a['lower_s'] + a['compile_s']:.0f}"),
        ]) + " |")
    return "\n".join(rows)


def _timed_cell(arch, shape, multi_pod, kw) -> tuple:
    """(artifact, wall seconds) of one cell; a worker process's task."""
    t0 = time.time()
    return run_cell(arch, shape, multi_pod, **kw), time.time() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--hbm-gib", type=float, default=0.0,
                    help="per-chip HBM override in GiB (default: the H100's 80 GB, "
                    "repro_torch.core.architecture.H100_SXM)")
    ap.add_argument("--rules", default="", help="comma list of ShardingRules "
                    "overrides, e.g. 'fsdp_only=true,dp_over_pod=false'")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the artifacts under --out and exit")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a spawned process of its own "
                    "(default 1: one after another in this process)")
    args = ap.parse_args(argv)
    if args.table:
        print(table(Path(args.out)))
        return

    rules = ShardingRules()
    if args.rules:
        kv = {}
        for item in args.rules.split(","):
            k, v = item.split("=")
            kv[k] = {"true": True, "false": False}.get(v.lower(), v)
        rules = dataclasses.replace(rules, **kv)

    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    out_dir = Path(args.out)
    kw = dict(rules=rules, out_dir=out_dir, remat=not args.no_remat, tag=args.tag,
              hbm_bytes=int(args.hbm_gib * (1 << 30)))
    todo = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            cell = f"{arch}__{shape}__{mesh_name}" + (f"__{args.tag}" if args.tag else "")
            if args.skip_existing and (out_dir / f"{cell}.json").exists():
                print(f"SKIP {cell} (exists)", flush=True)
                continue
            todo.append((cell, (arch, shape, mp, kw)))
    n_ok = n_fail = 0

    def report(cell, result) -> None:
        nonlocal n_ok, n_fail
        try:
            art, seconds = result()
        except Exception as e:
            n_fail += 1
            print(f"FAIL {cell}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
            return
        n_ok += 1
        print(
            f"OK   {cell}: flops/dev={art['flops_per_device']:.3e} "
            f"bytes/dev={art['bytes_per_device']:.3e} "
            f"coll/dev={art['collective_bytes_per_device']:.3e} "
            f"peak={art['memory']['peak_per_device']/2**30:.2f}GiB "
            f"fits={art['memory']['fits_hbm']} "
            f"tpu_est={art['memory_tpu_analytic']['total_bytes']/2**30:.2f}GiB "
            f"est_fits={art['memory_tpu_analytic']['fits_hbm']} "
            f"mb={art['microbatches']} ({seconds:.0f}s)",
            flush=True,
        )

    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            futures = {pool.submit(_timed_cell, *task): cell for cell, task in todo}
            for f in concurrent.futures.as_completed(futures):
                report(futures[f], f.result)
    else:
        for cell, task in todo:
            report(cell, lambda: _timed_cell(*task))
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
