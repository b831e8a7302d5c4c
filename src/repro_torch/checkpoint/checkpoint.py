"""Atomic, async checkpoints in the reference's on-disk format (port of
``repro/checkpoint/checkpoint.py``).

Layout of one checkpoint:

    <dir>/step_000000123.tmp-<nonce>/   (write)
        manifest.json                   {step, leaves: [{key, file, shape, dtype}], time, extra}
        000000.npy ... NNNNNN.npy       one file per leaf
    <dir>/step_000000123/               (atomic rename when complete)

A training state ``{"model": Model, "opt": {...}}`` is written in the
reference's layout (``models.convert.reference_leaves``): keys are
``jax.tree_util.keystr`` paths of ``{"params", "opt"}``, units stacked on a
leading axis, leaves numbered in ``jax.tree`` order, bfloat16 stored as
uint16 with ``"bfloat16"`` as the logical dtype. So either package restores
the other's checkpoints. Any other nested dict/list of tensors, arrays and
numbers is written leaf by leaf under its own keystr paths (and restored
into tensors and numbers).

* Atomicity: a writer fills a tmp dir and ``os.rename``s it into place;
  ``latest_step`` and ``restore`` only look at completed dirs.
* Async save: ``CheckpointManager(async_save=True)`` copies every tensor to
  host memory before its writer thread starts (the next train step updates
  the model in place) and writes in the background, overlapping the next
  steps; a writer's error is raised by the next ``wait`` or ``save``.
* GC: keep the most recent ``keep`` checkpoints.
* On a mesh (a state of DTensors): the format is unchanged. Every rank
  takes part in gathering each leaf whole; rank 0 writes. ``restore(...,
  shardings=named(state_specs(...)))`` re-places a checkpoint on a mesh
  (the reference's elastic re-placement): each rank reads only its own
  slice of each memory-mapped leaf file and builds the DTensors.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.convert import keystr, reference_leaves, state_from_reference_layout

_MANIFEST = "manifest.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# numpy has no bfloat16: it is stored as uint16, the logical dtype recorded
# in the manifest
def _to_native(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_native(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_state(tree) -> bool:
    return isinstance(tree, dict) and isinstance(tree.get("model"), nn.Module)


def _generic_leaves(tree, path=()) -> list:
    """(path, value) of a nested dict/list in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _generic_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, x in enumerate(tree) for leaf in _generic_leaves(x, path + (i,))]
    return [(path, tree)]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _leaves(tree) -> list:
    """(key, shape, dtype, sources, stacked) of every leaf: a training state
    in the reference's layout, anything else by its own paths."""
    if _is_state(tree):
        return reference_leaves(tree, tree["model"].cfg)
    out = []
    for path, x in _generic_leaves(tree):
        t = _as_tensor(x)
        out.append((keystr(path), tuple(t.shape), t.dtype, [x], False))
    return out


def _dtensor_type():
    """``DTensor``, or None where nothing has imported it: then no tensor is
    one, and a process that trains on one card never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def _distributed(leaves) -> bool:
    """A state on a mesh: its leaves are DTensors."""
    dtensor = _dtensor_type()
    return dtensor is not None and any(isinstance(t, dtensor) for leaf in leaves for t in leaf[3])


def _writer(leaves) -> bool:
    """Whether this process writes: always, but on a mesh rank 0 only."""
    import torch.distributed as dist

    return not _distributed(leaves) or dist.get_rank() == 0


def _snapshot(leaves, buffers: Optional[Dict] = None, keep: bool = True) -> Dict[str, torch.Tensor]:
    """A host copy of every leaf (stacked leaves gathered, DTensors
    gathered whole), reusing ``buffers`` of the same shape and dtype.
    Returns once every copy is complete. ``keep=False``: take part in the
    gathers and copy nothing (a rank that does not write)."""
    out, cuda = {}, False
    whole = lambda t: t  # noqa: E731
    if _distributed(leaves):
        from repro_torch.sharding.place import full_value as whole
    for key, shape, dtype, ts, stacked in leaves:
        buf = None if buffers is None else buffers.get(key)
        if keep and (buf is None or tuple(buf.shape) != shape or buf.dtype != dtype):
            buf = torch.empty(shape, dtype=dtype)
        for i, src in enumerate(ts):
            src = whole(_as_tensor(src)).detach()
            if keep:
                cuda |= src.is_cuda
                (buf[i] if stacked else buf).copy_(src, non_blocking=src.is_cuda)
        if keep:
            out[key] = buf
    if cuda:
        torch.cuda.synchronize()
    if buffers is not None:
        buffers.update(out)
    return out


def _write(directory: Path, step: int, host: Dict[str, torch.Tensor],
           extra: Optional[Dict]) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    index = []
    for i, (key, t) in enumerate(host.items()):
        fname = f"{i:06d}.npy"
        np.save(tmp / fname, _to_native(t))
        index.append({"key": key, "file": fname, "shape": list(t.shape),
                      "dtype": _dtype_name(t.dtype)})
    manifest = {"step": int(step), "leaves": index, "time": time.time(), "extra": extra or {}}
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic completion
    return final


def save(directory: str | Path, step: int, tree, *, extra: Optional[Dict] = None) -> Path:
    """Write one complete checkpoint; returns the final path. On a mesh
    every rank calls it and rank 0 writes."""
    leaves = _leaves(tree)
    keep = _writer(leaves)
    host = _snapshot(leaves, keep=keep)
    directory = Path(directory)
    return _write(directory, step, host, extra) if keep else directory / f"step_{step:09d}"


def _complete(directory: Path) -> List[Path]:
    return sorted(p for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_") and ".tmp-" not in p.name)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name[len("step_"):]) for p in _complete(directory)
             if (p / _MANIFEST).exists()]
    return max(steps) if steps else None


def restore(directory: str | Path, target, *, step: Optional[int] = None, shardings=None,
            device=None):
    """Restore into the structure of ``target``: a training state, or a
    nested dict/list of tensors and Python numbers. Returns (tree, step, extra).

    Every key and shape is checked before anything is written (``KeyError``
    on a missing leaf, ``ValueError`` on a shape mismatch); then each
    tensor of ``target`` is overwritten in place and keeps its dtype and
    device, or, where ``target`` is on the meta device, made anew on
    ``device``. Leaf files are memory-mapped, and each leaf (each unit's
    slice of a stacked one) is copied to its device once, so a restore
    needs no more device memory than the state it makes. Numbers come back
    as Python numbers (the optimizer's step as an int).

    ``shardings``: a tree like ``target``'s of ``(mesh, placements)``
    (``sharding.specs.named``; for a training state, of ``state_specs``).
    Each tensor then becomes a DTensor of which this rank reads only its
    slice from the file: DTensors of ``target`` with those placements
    take their slice in place; a target on the meta device is made anew.
    A DTensor of ``target`` is restored by its own placements without
    ``shardings``."""
    directory = Path(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    cdir = directory / f"step_{step:09d}"
    manifest = json.loads((cdir / _MANIFEST).read_text())
    by_key = {e["key"]: e for e in manifest["leaves"]}
    leaves = _leaves(target)
    for key, shape, _, _, _ in leaves:
        if key not in by_key:
            raise KeyError(f"checkpoint {cdir} missing leaf {key}")
        if tuple(by_key[key]["shape"]) != shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(by_key[key]['shape'])} "
                             f"!= target {shape}")
    meta = any(isinstance(t, torch.Tensor) and t.is_meta for leaf in leaves for t in leaf[3])
    if meta and device is None:
        raise ValueError("restore into a target on the meta device needs device=")
    values = {}
    state_shardings = _state_shardings(target, shardings)
    with torch.no_grad():
        for key, _, dtype, ts, stacked in leaves:
            entry = by_key[key]
            arr = _from_native(np.load(cdir / entry["file"], mmap_mode="c"), entry["dtype"])
            if not isinstance(ts[0], torch.Tensor):  # a number: the optimizer's step
                values[key] = type(ts[0])(arr.item())
            elif meta:  # left on the host: state_from_reference_layout places it
                values[key] = arr if shardings is not None else arr.to(dtype)
            else:
                for dst, src in zip(ts, arr if stacked else [arr]):
                    _copy_into(dst, src)
                values[key] = ts[0]
    extra = manifest.get("extra", {})
    if _is_state(target):
        cfg = target["model"].cfg
        if meta:
            place = None
            if state_shardings is not None:
                from repro_torch.sharding.place import from_full

                def place(root, name, host):
                    mesh, pl = state_shardings(root, name)
                    return from_full(host, mesh, pl, device=device)
            return state_from_reference_layout(values, cfg, device, place=place), step, extra
        return {"model": target["model"],
                "opt": {**target["opt"], "step": values[keystr(("opt", "step"))]}}, step, extra
    if shardings is not None and meta:
        return _rebuild(target, values, shardings=shardings, device=device), step, extra
    return _rebuild(target, values), step, extra


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``dst`` takes its own slice of ``src``."""
    dtensor = _dtensor_type()
    if dtensor is not None and isinstance(dst, dtensor):
        from repro_torch.sharding.place import local_index

        dst.to_local().copy_(src[local_index(src.shape, dst.device_mesh, dst.placements)])
    else:
        dst.copy_(src)


def _state_shardings(target, shardings):
    """For a training state: (root, parameter name) -> (mesh, placements),
    root None for the parameters, else the optimizer tree's name; with a
    target of DTensors, checked against their placements."""
    if shardings is None or not _is_state(target):
        return None

    def lookup(root, name):
        return shardings["params"][name] if root is None else shardings["opt"][root][name]

    from torch.distributed.tensor import DTensor

    trees = [(None, dict(target["model"].named_parameters()))]
    trees += [(k, v) for k, v in target["opt"].items() if k != "step"]
    for root, tensors in trees:
        for name, t in tensors.items():
            if isinstance(t, DTensor) and tuple(t.placements) != tuple(lookup(root, name)[1]):
                raise ValueError(f"{root or 'params'}.{name}: the target's placements "
                                 f"{t.placements} differ from shardings' {lookup(root, name)[1]}")
    return lookup


def _rebuild(tree, values, path=(), shardings=None, device=None):
    if shardings is not None and not isinstance(tree, (dict, list, tuple)):
        v = values[keystr(path)]
        if isinstance(v, torch.Tensor):
            from repro_torch.sharding.place import from_full

            mesh, pl = shardings
            return from_full(v, mesh, pl, device=device, dtype=tree.dtype)
        return v
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,), None if shardings is None else shardings[k],
                            device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,),
                                   None if shardings is None else shardings[i], device)
                          for i, v in enumerate(tree))
    return values[keystr(path)]


class CheckpointManager:
    """Save policy + async writes + GC.

    ``records`` holds one dict per save: its step, bytes, the synchronous
    snapshot's seconds, the writer's seconds, and the seconds the next
    ``save``/``wait`` blocked on that writer (the write overlapped training
    for ``write_s - waited_s``)."""

    def __init__(self, directory: str | Path, *, keep: int = 3, every: int = 100,
                 async_save: bool = True) -> None:
        self.directory = Path(directory)
        self.keep = keep
        self.every = every
        self.async_save = async_save
        self.records: List[Dict] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[str, torch.Tensor] = {}

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def wait(self) -> None:
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self.records[-1]["waited_s"] = time.perf_counter() - t0
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, *, extra: Optional[Dict] = None) -> None:
        self.wait()  # one outstanding async save at a time
        t0 = time.perf_counter()
        # a host copy of everything now: the next train step writes the
        # model and the optimizer state in place. On a mesh every rank
        # takes part in the gathers and rank 0 writes.
        leaves = _leaves(tree)
        keep = _writer(leaves)
        host = _snapshot(leaves, self._buffers, keep=keep)
        rec = {"step": step, "bytes": sum(t.numel() * t.element_size() for t in host.values()),
               "snapshot_s": time.perf_counter() - t0, "write_s": None, "waited_s": 0.0}
        self.records.append(rec)
        if not keep:
            rec["write_s"] = 0.0
            return

        def work():
            t1 = time.perf_counter()
            try:
                _write(self.directory, step, host, extra)
                self._gc()
            except BaseException as e:  # raised by the next wait()/save()
                self._error = e
            rec["write_s"] = time.perf_counter() - t1

        if self.async_save:
            self._thread = threading.Thread(target=work, name=f"ckpt-{step}", daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def restore_latest(self, target, *, shardings=None, device=None):
        return restore(self.directory, target, shardings=shardings, device=device)

    def _gc(self) -> None:
        if not self.directory.exists():
            return
        steps = _complete(self.directory)
        for p in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(p, ignore_errors=True)
        # orphaned tmp dirs from crashed writers
        for p in self.directory.iterdir():
            if ".tmp-" in p.name and time.time() - p.stat().st_mtime > 3600:
                shutil.rmtree(p, ignore_errors=True)
