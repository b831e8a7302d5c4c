"""The dense population form the heuristic mapper hands the engine.

A :class:`GenomeBatch` holds a population of chain-level candidates as
dense ``[B, n_levels, D]`` int64 matrices -- the exact layout
:class:`repro_torch.core.cost.analysis.StackedBatch` consumes -- so a batch
flows through signature dedup, admission and scoring without
materializing per-candidate Python objects
(:class:`~repro_torch.core.mapspace.Genome` / ``Mapping`` are built lazily, only
for scalar-path fallbacks and search winners).

Dedup is an array program as well: :meth:`GenomeBatch.key_rows` builds a
CANONICAL key matrix in one pass (each level's order reduced to its active
subsequence -- rows differing only in inactive-dim placement provably cost
the same and collapse), :meth:`GenomeBatch.dedup` row-hashes it with
``np.unique``, and :meth:`GenomeBatch.row_key` yields a key row's bytes --
the engine's memo key.

The reference package's vectorized samplers (Philox-drawn random batches,
the exhaustive mixed-radix stream and their legality programs) serve its
random, exhaustive and genetic mappers, which the port has not taken over
yet; they come with those mappers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

if False:  # typing only -- imported lazily to keep this module cycle-free
    from repro_torch.core.cost.analysis import StackedBatch  # noqa: F401


# --------------------------------------------------------------------- #
# GenomeBatch: the dense population representation
# --------------------------------------------------------------------- #
class GenomeBatch:
    """A batch of chain-level candidates as dense int64 matrices.

    ``tt[b, i, j]`` / ``st[b, i, j]`` are the temporal/spatial tile sizes
    of dim ``j`` (problem-dim order) at level ``i``; ``perm[b, i, p]`` is
    the dim index at position ``p`` of level ``i``'s (full) temporal
    order -- exactly the layout ``StackedBatch`` holds, so the evaluation
    engine stacks a miss-batch by slicing rows, with zero per-candidate
    work.
    """

    __slots__ = ("space", "tt", "st", "perm", "_rows2d", "_keys")

    def __init__(self, space, tt: np.ndarray, st: np.ndarray, perm: np.ndarray) -> None:
        self.space = space
        self.tt = np.ascontiguousarray(tt, dtype=np.int64)
        self.st = np.ascontiguousarray(st, dtype=np.int64)
        self.perm = np.ascontiguousarray(perm, dtype=np.int64)
        self._rows2d: Optional[np.ndarray] = None
        self._keys: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return int(self.tt.shape[0])

    @property
    def size(self) -> int:
        return len(self)

    @classmethod
    def from_genomes(cls, space, genomes: Sequence) -> "GenomeBatch":
        """Stack chain-level :class:`Genome` objects (or anything with
        ``chains``/``orders`` in their layout) into one batch."""
        n = space.n_levels
        dims = space.dims
        D = len(dims)
        B = len(genomes)
        count = B * n * D
        tt = np.fromiter(
            (g.chains[d][2 * i] for g in genomes for i in range(n) for d in dims),
            dtype=np.int64,
            count=count,
        ).reshape(B, n, D)
        st = np.fromiter(
            (g.chains[d][2 * i + 1] for g in genomes for i in range(n) for d in dims),
            dtype=np.int64,
            count=count,
        ).reshape(B, n, D)
        dim_index = {d: j for j, d in enumerate(dims)}
        perm = np.fromiter(
            (dim_index[d] for g in genomes for o in g.orders for d in o),
            dtype=np.int64,
            count=count,
        ).reshape(B, n, D)
        return cls(space, tt, st, perm)

    def select(self, idx) -> "GenomeBatch":
        """Row subset (slice or index array) as a new batch."""
        return GenomeBatch(self.space, self.tt[idx], self.st[idx], self.perm[idx])

    # ------------------------------------------------------------------ #
    def rows2d(self) -> np.ndarray:
        """``[B, 3*n*D]`` contiguous row matrix: the hashable identity of
        each candidate (tt, st, perm concatenated)."""
        if self._rows2d is None:
            B = len(self)
            self._rows2d = np.ascontiguousarray(
                np.concatenate(
                    [
                        self.tt.reshape(B, -1),
                        self.st.reshape(B, -1),
                        self.perm.reshape(B, -1),
                    ],
                    axis=1,
                )
            )
        return self._rows2d

    def key_rows(self) -> np.ndarray:
        """``[B, 3*n*D]`` canonical KEY matrix: like :meth:`rows2d` but
        with each level's order reduced to its ACTIVE subsequence (dims
        whose temporal trips exceed 1, in declared order; inactive slots
        pad with -1). The reuse analysis consumes only the active loops,
        so rows with equal key rows have bit-identical costs -- a strictly
        finer dedup than the per-genome ``(orders, chains)`` tuple key,
        computed as one array program over the batch."""
        if self._keys is None:
            B, n, D = self.tt.shape
            sizes = np.asarray(
                [self.space.problem.dims[d] for d in self.space.dims], dtype=np.int64
            )
            ttc = np.maximum(self.tt, 1)
            stc = np.maximum(self.st, 1)
            outer = np.concatenate(
                [np.broadcast_to(sizes, (B, 1, D)), stc[:, :-1, :]], axis=1
            )
            active = (outer // ttc) > 1  # per dim, [B, n, D]
            act_pos = np.take_along_axis(active, self.perm, axis=2)
            pos = np.arange(D, dtype=np.int64)
            rank = np.where(act_pos, pos, pos + D)
            idx = np.argsort(rank, axis=2, kind="stable")
            cperm = np.take_along_axis(self.perm, idx, axis=2)
            cperm = np.where(np.take_along_axis(act_pos, idx, axis=2), cperm, -1)
            self._keys = np.ascontiguousarray(
                np.concatenate(
                    [
                        self.tt.reshape(B, -1),
                        self.st.reshape(B, -1),
                        cperm.reshape(B, -1),
                    ],
                    axis=1,
                )
            )
        return self._keys

    def row_key(self, b: int) -> bytes:
        """Engine memo key for row ``b``: the canonical key-row bytes
        (see :meth:`key_rows`). Equal keys imply bit-identical costs."""
        return self.key_rows()[b].tobytes()

    def dedup(self) -> Tuple[np.ndarray, np.ndarray]:
        """In-batch dedup as ONE array program (``np.unique`` over the row
        matrix) instead of a per-candidate dict probe. Returns
        ``(rep, inverse)``: ``rep`` lists the first-occurrence row index
        of every distinct candidate IN SUBMISSION ORDER, and
        ``inverse[b]`` is the position in ``rep`` representing row ``b``.
        Distinctness is by the canonical :meth:`key_rows` identity (rows
        that provably cost the same are one candidate)."""
        r = self.key_rows()
        _, first, inv = np.unique(r, axis=0, return_index=True, return_inverse=True)
        inv = inv.reshape(-1)
        order = np.argsort(first, kind="stable")
        rep = first[order]
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        return rep, rank[inv]

    def stacked(self, rows=None) -> "StackedBatch":
        """A :class:`StackedBatch` over all rows (or the given subset) --
        shared by the engine's admission and scoring array programs."""
        from repro_torch.core.cost.analysis import StackedBatch

        if rows is None:
            return StackedBatch(self.tt, self.st, self.perm)
        idx = np.asarray(rows, dtype=np.int64)
        return StackedBatch(
            np.ascontiguousarray(self.tt[idx]),
            np.ascontiguousarray(self.st[idx]),
            np.ascontiguousarray(self.perm[idx]),
        )

    # ------------------------------------------------------------------ #
    def orders_of(self, b: int) -> Tuple[Tuple[str, ...], ...]:
        dims = self.space.dims
        return tuple(
            tuple(dims[p] for p in row) for row in self.perm[b].tolist()
        )

    def signature(self, b: int):
        """Canonical signature of row ``b`` -- identical to
        ``Genome.signature`` for the equivalent genome (orders are full)."""
        tt = self.tt[b].tolist()
        st = self.st[b].tolist()
        return tuple(
            (order, tuple(trow), tuple(srow))
            for order, trow, srow in zip(self.orders_of(b), tt, st)
        )

    def genome(self, b: int):
        """Materialize row ``b`` as a chain-level Genome (lazy import: the
        mapspace module does not import this one)."""
        from repro_torch.core.mapspace import Genome

        space = self.space
        n = space.n_levels
        tt = self.tt[b].tolist()
        st = self.st[b].tolist()
        chains = {
            d: tuple(v for i in range(n) for v in (tt[i][j], st[i][j]))
            for j, d in enumerate(space.dims)
        }
        return Genome(space, chains, self.orders_of(b))


class RowCandidate:
    """Lazy per-row view of a :class:`GenomeBatch`: the candidate object
    the engine hands to its scalar fallbacks (bound, per-candidate
    evaluation, store puts) and to the mapper's incumbent tracker. The
    underlying Genome/Mapping is built only when actually consumed."""

    __slots__ = ("gb", "row", "_g", "_sig")

    def __init__(self, gb: GenomeBatch, row: int) -> None:
        self.gb = gb
        self.row = int(row)
        self._g = None
        self._sig = None

    def _genome(self):
        if self._g is None:
            self._g = self.gb.genome(self.row)
        return self._g

    def signature(self, dims):
        if self._sig is None:
            self._sig = self.gb.signature(self.row)
        return self._sig

    def to_mapping(self):
        return self._genome().to_mapping()

    @property
    def chain_list(self):
        return self._genome().chain_list

    @property
    def orders(self):
        return self.gb.orders_of(self.row)
