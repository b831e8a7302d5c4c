"""Deterministic, resumable data pipeline (port of ``repro/data/pipeline.py``).

  * **Deterministic-resumable**: ``batch(step)`` is a pure function of
    (seed, step) -- restarting at step k replays exactly the batches
    k, k+1, ... with no data-loader state to save.
  * **Prefetch**: a background thread keeps ``prefetch`` batches ahead so
    host-side batch assembly overlaps device compute.

The numpy generation is JAX's, so batches are bit-for-bit the JAX
package's; only placement differs (``.to(device)`` instead of a sharded
``jax.Array``). Two sources: ``SyntheticLM`` (seeded Zipf-ish token stream)
and ``TokenFileDataset`` (memory-mapped flat token file).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator

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


def make_pipeline(
    source,
    batch: int,
    seq: int,
    *,
    device="cuda",
    start_step: int = 0,
    data_cfg: DataConfig = DataConfig(),
    extra_fn=None,  # hook: batch_np -> batch_np (labels, frontends, ...)
) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetching iterator of batches on ``device``, starting at start_step.
    The thread builds numpy batches; the caller's thread places them."""
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
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    finally:
        stop.set()
