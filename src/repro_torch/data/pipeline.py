"""Deterministic, resumable data pipeline (port of ``repro/data/pipeline.py``).

  * **Deterministic-resumable**: ``batch(step)`` is a pure function of
    (seed, step) -- restarting at step k replays exactly the batches
    k, k+1, ... with no data-loader state to save.
  * **Prefetch**: a background thread keeps ``prefetch`` batches ahead so
    host-side batch assembly overlaps device compute.

The numpy generation is JAX's, so batches are bit-for-bit the JAX
package's. Placement: ``.to(device)``, or on a mesh a ``DTensor`` laid
out by the batch specs, of which each rank builds only its own slice
(``_place``, the counterpart of ``jax.make_array_from_callback``); the
global batch is the unsharded one for each (seed, step). Two sources: ``SyntheticLM`` (seeded Zipf-ish token stream)
and ``TokenFileDataset`` (memory-mapped flat token file).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    prefetch: int = 2


class SyntheticLM:
    """Seeded synthetic LM token stream with a learnable structure
    (repeated n-grams + Zipf marginals) so a model's loss visibly drops
    within a few hundred steps."""

    def __init__(self, vocab: int, seed: int = 0, ngram: int = 3) -> None:
        self.vocab = vocab
        self.seed = seed
        self.ngram = ngram
        # fixed random n-gram successor table: token -> deterministic next
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab, size=(vocab,), dtype=np.int32)
        self._zipf_p = 1.0 / np.arange(1, vocab + 1)
        self._zipf_p /= self._zipf_p.sum()

    def batch(self, step: int, batch: int, seq: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((batch, seq), np.int32)
        # start tokens ~ Zipf; with p=0.8 follow the successor table
        # (predictable), else resample (noise floor)
        toks[:, 0] = rng.choice(self.vocab, size=batch, p=self._zipf_p)
        follow = rng.random((batch, seq)) < 0.8
        fresh = rng.choice(self.vocab, size=(batch, seq), p=self._zipf_p)
        for t in range(1, seq):
            toks[:, t] = np.where(
                follow[:, t], self._succ[toks[:, t - 1]], fresh[:, t]
            )
        return {"tokens": toks}


class TokenFileDataset:
    """Memory-mapped flat token file (int32/int16/uint16). Batch ``step``
    reads a deterministic strided window per sample -- seekable, so resume
    is again (seed, step)-pure."""

    def __init__(self, path: str | Path, vocab: int, dtype=np.int32, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> Dict[str, np.ndarray]:
        n = len(self.tokens) - (seq + 1)
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, n, size=batch)
        out = np.stack([self.tokens[s : s + seq] for s in starts]).astype(np.int32)
        return {"tokens": out % self.vocab}


def _place(batch_np: Dict[str, np.ndarray], mesh, specs, device="cuda") -> Dict:
    """A global numpy batch -> tensors on ``device``; on a mesh, DTensors
    by ``specs`` (replicated where a key has none), each rank copying only
    its own slice to the device."""
    if mesh is None:
        return {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    from repro_torch.sharding.place import from_full
    from repro_torch.sharding.specs import P, placements

    return {k: from_full(arr, mesh, placements((specs or {}).get(k, P()), mesh), device=device)
            for k, arr in batch_np.items()}


def make_pipeline(
    source,
    batch: int,
    seq: int,
    *,
    device="cuda",
    mesh=None,
    specs: Optional[Dict] = None,
    start_step: int = 0,
    data_cfg: DataConfig = DataConfig(),
    extra_fn=None,  # hook: batch_np -> batch_np (labels, frontends, ...)
) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetching iterator of batches on ``device`` (on ``mesh``, sharded
    by ``specs``), starting at start_step. The thread builds numpy batches;
    the caller's thread places them."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, data_cfg.prefetch))
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            b = source.batch(step, batch, seq)
            if extra_fn is not None:
                b = extra_fn(b)
            try:
                q.put((step, b), timeout=1.0)
            except queue.Full:
                continue
            step += 1

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            _, b = q.get()
            yield _place(b, mesh, specs, device)
    finally:
        stop.set()
