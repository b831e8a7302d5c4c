"""Array-native candidate generation for the map-space search pipeline
(the port's copy of the reference package's module).

A :class:`GenomeBatch` holds a whole population of chain-level candidates
as dense ``[B, n_levels, D]`` int64 matrices -- the exact layout
:class:`repro_torch.core.cost.analysis.StackedBatch` consumes -- so a batch
flows from the samplers through signature dedup, admission and scoring
without materializing per-candidate Python objects
(:class:`~repro_torch.core.mapspace.Genome` / ``Mapping`` are built lazily,
only for scalar-path fallbacks and search winners).

Dedup is an array program as well: :meth:`GenomeBatch.key_rows` builds a
CANONICAL key matrix in one pass (each level's order reduced to its active
subsequence -- rows differing only in inactive-dim placement provably cost
the same and collapse), :meth:`GenomeBatch.dedup` row-hashes it with
``np.unique``, and :meth:`GenomeBatch.row_key` yields a key row's bytes --
the engine's memo key.

Vectorized generation draws from a COUNTER-BASED RNG (numpy's Philox): one
array draw replaces thousands of per-candidate ``random.Random`` calls.
These draws consume a different stream than the historical samplers, so
the sampling mappers gate them behind ``seed_version=2`` (their default);
``seed_version=1`` keeps the per-candidate ``random.Random`` stream. For a
fixed seed, version-2 candidates depend only on (seed, batch-call
sequence) -- generation is all-numpy and never touches the engine backend,
so searches are bit-identical across the scalar and numpy engines. The
exhaustive enumerator needs no seed version at all: its vectorized
mixed-radix decoding reproduces the DFS candidate stream exactly.

Legality of batch-generated candidates is decided by two array programs:
:func:`chains_legal_batch` (the vectorization of
``MapSpace._chains_legal``: nesting, innermost-serial, per-level fanout,
memory capacity) and :func:`constraints_ok_batch` (the vectorization of
``Constraints.check`` for chain-structured candidates whose constrained
loop orders were forced at generation -- never looser than the scalar
check; equality is asserted in tests).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.mapspace import _divisors_cached

if False:  # typing only -- imported lazily to keep this module cycle-free
    from repro_torch.core.cost.analysis import StackedBatch  # noqa: F401


def philox_rng(seed: int, salt: int = 0) -> np.random.Generator:
    """Counter-based generator for the version-2 samplers. ``salt``
    separates independent phases of one search (population init vs
    per-generation operators) without correlating their streams."""
    return np.random.Generator(np.random.Philox(key=(int(seed) << 32) + int(salt)))


# --------------------------------------------------------------------- #
# Per-(space, dim) divisor tables: the data the vectorized chain sampler
# gathers from. Built once per MapSpace and cached on the instance.
# --------------------------------------------------------------------- #
class _DimTables:
    __slots__ = ("vals", "idx_of", "div_val", "div_cnt", "spf")

    def __init__(self, size: int) -> None:
        vals = np.asarray(_divisors_cached(size), dtype=np.int64)
        nd = len(vals)
        idx_of = np.full(int(size) + 1, -1, dtype=np.int64)
        idx_of[vals] = np.arange(nd)
        rows = [_divisors_cached(int(v)) for v in vals]
        cnt = np.asarray([len(r) for r in rows], dtype=np.int64)
        div_val = np.empty((nd, int(cnt.max())), dtype=np.int64)
        for i, r in enumerate(rows):
            div_val[i, : len(r)] = r
            div_val[i, len(r) :] = r[-1]  # pad with the max: rows stay sorted
        spf = np.ones(nd, dtype=np.int64)
        for i, v in enumerate(vals.tolist()):
            if v > 1:
                f = 2
                while v % f:
                    f += 1
                spf[i] = f
        self.vals = vals
        self.idx_of = idx_of
        self.div_val = div_val  # div_val[i, k] = k-th divisor of vals[i]
        self.div_cnt = cnt
        self.spf = spf  # smallest prime factor of vals[i] (1 for 1)


@functools.lru_cache(maxsize=4096)
def _dim_tables_for_size(size: int) -> _DimTables:
    """Tables depend only on the dim SIZE -- shared process-wide, so the
    thousands of MapSpace instances a benchmark sweep builds pay the
    construction once per distinct size."""
    return _DimTables(size)


def _tables(space) -> Dict[str, _DimTables]:
    tabs = getattr(space, "_gb_tables", None)
    if tabs is None:
        tabs = {d: _dim_tables_for_size(space.problem.dims[d]) for d in space.dims}
        space._gb_tables = tabs
    return tabs


def _axes_idx(space) -> List[Tuple[int, List[List[Tuple[int, int]]]]]:
    """``(word_bytes, [[(|coeff|, dim_index), ...] per axis])`` per data
    space -- the index form of ``MapSpace._ds_axes`` the batched footprint
    program consumes."""
    axes = getattr(space, "_gb_axes", None)
    if axes is None:
        dim_index = {d: j for j, d in enumerate(space.dims)}
        axes = [
            (wb, [[(c, dim_index[d]) for c, d in ax] for ax in ds_axes])
            for wb, ds_axes in space._ds_axes
        ]
        space._gb_axes = axes
    return axes


class _LegalityConsts:
    """Per-space constants of the legality array program, built once.

    Footprints use DENSE coefficient matrices (``spans = 1 +
    (tt - 1) @ coeff.T``, one matmul per data space) -- a reassociation of
    the scalar span sum that is exact here because every quantity is an
    integer-valued float64 below 2**53; the LEGALITY verdicts are
    therefore still bit-equal to ``_chains_legal``. (Cost models never use
    this form: their float-op order is contractual.)"""

    __slots__ = ("sizes", "caps", "mem", "num_pes")

    def __init__(self, space) -> None:
        self.sizes = np.asarray(
            [space.problem.dims[d] for d in space.dims], dtype=np.int64
        )
        self.caps = np.asarray(space.child_fanout, dtype=np.float64)
        D = len(space.dims)
        dense = []
        for wb, ax in _axes_idx(space):
            A = max(1, len(ax))
            coeff = np.zeros((A, D), dtype=np.float64)
            for a, terms in enumerate(ax):
                for c, j in terms:
                    coeff[a, j] += c
            dense.append((float(wb), coeff))
        self.mem = [
            (lvl, float(cap), dense) for lvl, cap in space._mem_levels
        ]
        self.num_pes = max(1, space.arch.num_pes)


def _legality_consts(space) -> _LegalityConsts:
    lc = getattr(space, "_gb_legality", None)
    if lc is None:
        lc = _LegalityConsts(space)
        space._gb_legality = lc
    return lc


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
            lc = _legality_consts(self.space)
            ttc = np.maximum(self.tt, 1)
            stc = np.maximum(self.st, 1)
            outer = np.concatenate(
                [np.broadcast_to(lc.sizes, (B, 1, D)), stc[:, :-1, :]], axis=1
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


# --------------------------------------------------------------------- #
# Vectorized legality: the array form of MapSpace._chains_legal
# --------------------------------------------------------------------- #
def chains_legal_batch(
    space, tt: np.ndarray, st: np.ndarray, structured: bool = False
) -> np.ndarray:
    """Bool mask over the batch: exactly ``MapSpace._chains_legal`` per
    row (nested divisor chains, innermost-serial, per-level fanout caps,
    memory capacity), as one array program. Quantities are integer-valued
    float64 where products could overflow int64 -- exact below 2**53,
    far above any realistic footprint/fanout here.

    ``structured=True`` skips the nesting/positivity/innermost checks:
    valid ONLY for rows assembled from per-dim chain COLUMNS that are
    nested divisor chains by construction (the samplers, fanout repair,
    column crossover, column re-sampling -- everything in this module).
    The verdicts are identical for such rows; arbitrary foreign rows must
    use the full check."""
    B, n, D = tt.shape
    lc = _legality_consts(space)
    ttc = np.maximum(tt, 1)
    stc = np.maximum(st, 1)
    if structured:
        ok = np.ones(B, dtype=bool)
    else:
        outer = np.concatenate(
            [np.broadcast_to(lc.sizes, (B, 1, D)), stc[:, :-1, :]], axis=1
        )
        # nesting + positivity + innermost-serial in one violation matrix
        bad = (tt < 1) | (st < 1) | ((outer % ttc) != 0) | ((ttc % stc) != 0)
        bad[:, -1, :] |= tt[:, -1, :] != st[:, -1, :]
        ok = ~bad.reshape(B, -1).any(axis=1)
    fans = (ttc // stc).astype(np.float64)
    par = fans.prod(axis=2)  # [B, n]
    ok &= (par <= lc.caps).all(axis=1)
    for lvl, cap, dense in lc.mem:
        need = np.zeros(B, dtype=np.float64)
        tm1 = ttc[:, lvl, :].astype(np.float64) - 1.0
        for wb, coeff in dense:
            spans = 1.0 + tm1 @ coeff.T  # [B, A], exact (integer-valued)
            need += spans.prod(axis=1) * wb
        ok &= need <= cap
    return ok


def constraints_ok_batch(
    space, tt: np.ndarray, st: np.ndarray, perm: np.ndarray
) -> np.ndarray:
    """Bool mask: ``Constraints.check`` vectorized for chain-structured
    candidates. For levels with a forced loop order the check requires the
    EXACT forced permutation (the batch samplers force it at generation),
    which is never looser than the scalar active-dims check; every other
    field (allowed/required spatial dims, concurrent-spatial cap, allowed
    tile sizes, tile multiples, utilization bounds) replays the scalar
    comparisons, tolerances included."""
    cons = space.constraints
    B, n, D = tt.shape
    ok = np.ones(B, dtype=bool)
    if cons is None:
        return ok
    dims = space.dims
    dim_index = {d: j for j, d in enumerate(dims)}
    ttc = np.maximum(tt, 1)
    stc = np.maximum(st, 1)
    fan = np.maximum(ttc // stc, 1)
    for i, cl in enumerate(space.arch.clusters):
        name = cl.name
        f = fan[:, i, :]
        for j, d in enumerate(dims):
            if not cons._spatial_ok(name, d):
                ok &= f[:, j] <= 1
        if cons.max_concurrent_spatial is not None:
            ok &= (f > 1).sum(axis=1) <= cons.max_concurrent_spatial
        req = cons.required_spatial_dims.get(name)
        if req:
            for d in req:
                if d in dim_index:
                    ok &= f[:, dim_index[d]] > 1
                else:
                    ok &= False
        want = cons.loop_orders.get(name)
        if want:
            if not set(want) <= set(dims):
                ok &= False
            else:
                forced = np.asarray(
                    [dim_index[d] for d in want]
                    + [j for j, d in enumerate(dims) if d not in want],
                    dtype=np.int64,
                )
                ok &= (perm[:, i, :] == forced).all(axis=1)
        for j, d in enumerate(dims):
            allowed = cons.allowed_tile_sizes.get((name, d))
            if allowed is not None:
                ok &= np.isin(
                    tt[:, i, j], np.asarray(sorted(allowed), dtype=np.int64)
                )
    for d, m in cons.tile_multiples.items():
        if d in dim_index:
            j = dim_index[d]
            tin = tt[:, -1, j]
            ok &= ((tin % m) == 0) | (tin == space.problem.dims[d])
    par = fan.astype(np.float64).reshape(B, -1).prod(axis=1)
    util = par / max(1, space.arch.num_pes)
    ok &= util >= cons.min_utilization - 1e-9
    ok &= util <= cons.max_utilization + 1e-9
    return ok


def legal_batch(space, tt, st, perm, structured: bool = False) -> np.ndarray:
    return chains_legal_batch(space, tt, st, structured=structured) & (
        constraints_ok_batch(space, tt, st, perm)
    )


# --------------------------------------------------------------------- #
# Vectorized samplers (seed_version=2)
# --------------------------------------------------------------------- #
def sample_chain_cols(
    space,
    rng: np.random.Generator,
    j: int,
    B: int,
    start: Optional[np.ndarray] = None,
    from_level: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``B`` nested divisor chains for dim index ``j`` as array draws:
    per level, gather the divisor table of the current value and draw one
    index for TT and -- where the level may parallelize -- one for ST.
    Mirrors ``MapSpace._sample_chain``'s distribution. ``start`` (values,
    per row) and ``from_level`` support conditional resampling below a
    fixed prefix (the decoupled mapper's phase 2); levels before
    ``from_level`` come back as the start value."""
    n = space.n_levels
    d = space.dims[j]
    tb = _tables(space)[d]
    allowed = space._allowed_spatial[d]
    last = n - 1
    tt = np.empty((B, n), dtype=np.int64)
    st = np.empty((B, n), dtype=np.int64)
    if start is None:
        cur = np.full(B, tb.idx_of[space.problem.dims[d]], dtype=np.int64)
    else:
        cur = tb.idx_of[np.asarray(start, dtype=np.int64)]
    # ONE uniform draw covers the whole chain; per level the bounded index
    # is floor(u * count) -- negligible bias, and 2 generator calls per
    # level collapse into one per chain batch
    u = rng.random((B, n, 2))
    for i in range(from_level, n):
        r = (u[:, i, 0] * tb.div_cnt[cur]).astype(np.int64)
        ttv = tb.div_val[cur, r]
        if allowed[i] and i != last:
            ti = tb.idx_of[ttv]
            stv = tb.div_val[ti, (u[:, i, 1] * tb.div_cnt[ti]).astype(np.int64)]
        else:
            stv = ttv
        tt[:, i] = ttv
        st[:, i] = stv
        cur = tb.idx_of[stv]
    return tt, st


def sample_chains_batch(
    space, rng: np.random.Generator, B: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``B`` nested divisor chains for every dim (one
    :func:`sample_chain_cols` pass per dim)."""
    n = space.n_levels
    D = len(space.dims)
    tt = np.empty((B, n, D), dtype=np.int64)
    st = np.empty((B, n, D), dtype=np.int64)
    for j in range(D):
        tcol, scol = sample_chain_cols(space, rng, j, B)
        tt[:, :, j] = tcol
        st[:, :, j] = scol
    return tt, st


def repair_fanout_batch(space, rng: np.random.Generator, tt, st) -> None:
    """In-place vectorized counterpart of ``random_genome``'s repair:
    while any level's parallelism exceeds the child fanout, grow the
    largest-ratio dim's ST toward TT by the smallest sufficient divisor
    (deterministic greedy -- the scalar repair picks a random dim and one
    prime factor per step; the v2 stream is seed-versioned precisely so
    the repair can take the one-shot form), rescaling the chain below to
    keep nesting. ``rng`` is accepted for signature stability; the greedy
    repair consumes no draws."""
    n = space.n_levels
    D = tt.shape[2]
    lc = _legality_consts(space)
    # one pass decides whether ANY row needs repair; the fix loops below
    # then run on the violating subset only (typically a small minority)
    fans = (tt // np.maximum(st, 1)).astype(np.float64)
    sel = np.flatnonzero((fans.prod(axis=2) > lc.caps).any(axis=1))
    if sel.size == 0:
        return
    tabs = [_tables(space)[d] for d in space.dims]
    sub_t = tt[sel]
    sub_s = st[sel]
    for i in range(n):
        while True:
            ratio = sub_t[:, i, :] // np.maximum(sub_s[:, i, :], 1)
            par = ratio.astype(np.float64).prod(axis=1)
            viol = np.flatnonzero(par > space.child_fanout[i])
            if viol.size == 0:
                break
            # greedily serialize the LARGEST-ratio dim by the SMALLEST
            # divisor of its fan ratio that brings the level under the
            # cap (the whole ratio when none suffices): one deterministic
            # pass fixes almost every row, instead of one random dim and
            # one prime factor per iteration
            dimsel = np.argmax(ratio[viol], axis=1)
            needed = np.ceil(par[viol] / space.child_fanout[i])
            for j in range(D):
                rows = viol[dimsel == j]
                if rows.size == 0:
                    continue
                tb = tabs[j]
                rat = sub_t[rows, i, j] // sub_s[rows, i, j]
                want = np.minimum(needed[dimsel == j], rat)
                drows = tb.div_val[tb.idx_of[rat]]  # sorted, max-padded
                pos = (drows < want[:, None]).sum(axis=1)
                g = drows[np.arange(rows.size), pos]
                cur = sub_s[rows, i, j] * g
                sub_s[rows, i, j] = cur
                for lvl in range(i + 1, n):
                    for arr in (sub_t, sub_s):
                        v = arr[rows, lvl, j]
                        v = np.where(v > cur, np.gcd(v, cur), v)
                        arr[rows, lvl, j] = v
                        cur = v
    tt[sel] = sub_t
    st[sel] = sub_s


def sample_orders_batch(
    space, rng: np.random.Generator, B: int
) -> Tuple[np.ndarray, bool]:
    """Per-level random full orders for a batch (one ``permuted`` draw),
    with constrained levels forced to their required prefix order.
    Returns ``(perm, orders_ok)``; ``orders_ok`` is False when a
    constraint order names unknown dims (nothing can be legal, matching
    the scalar sampler's fallback)."""
    n = space.n_levels
    D = len(space.dims)
    perm = rng.permuted(
        np.tile(np.arange(D, dtype=np.int64), (B, n, 1)), axis=2
    )
    ok = True
    cons = space.constraints
    if cons is not None and cons.loop_orders:
        dim_index = {d: j for j, d in enumerate(space.dims)}
        dimset = set(space.dims)
        for i, cl in enumerate(space.arch.clusters):
            want = cons.loop_orders.get(cl.name)
            if want:
                forced = [dim_index[d] for d in want if d in dimset] + [
                    j for j, d in enumerate(space.dims) if d not in want
                ]
                perm[:, i, :] = np.asarray(forced, dtype=np.int64)
                ok &= set(want) <= dimset
    return perm, ok


def trivial_rows(space, B: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The guaranteed-legal all-serial candidate, tiled ``B`` times (the
    batch samplers' fallback, mirroring ``random_genome``'s)."""
    n = space.n_levels
    D = len(space.dims)
    tt = np.ones((B, n, D), dtype=np.int64)
    st = np.ones((B, n, D), dtype=np.int64)
    perm = np.tile(np.arange(D, dtype=np.int64), (B, n, 1))
    return tt, st, perm


def random_rows_batch(
    space, rng: np.random.Generator, B: int, tries: int = 200
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``B`` legal random candidates: sample + repair + legality filter as
    array programs, rejection-resampling only the still-illegal rows.
    Rows that stay illegal after ``tries`` rounds fall back to the
    trivial all-serial candidate (scalar-sampler semantics)."""
    n = space.n_levels
    D = len(space.dims)
    tt = np.empty((B, n, D), dtype=np.int64)
    st = np.empty_like(tt)
    perm = np.empty_like(tt)
    todo = np.arange(B)
    for _ in range(tries):
        t2, s2 = sample_chains_batch(space, rng, todo.size)
        repair_fanout_batch(space, rng, t2, s2)
        p2, orders_ok = sample_orders_batch(space, rng, todo.size)
        tt[todo], st[todo], perm[todo] = t2, s2, p2
        if not orders_ok:
            break
        good = legal_batch(space, t2, s2, p2, structured=True)
        todo = todo[~good]
        if todo.size == 0:
            break
    if todo.size:
        t0, s0, p0 = trivial_rows(space, todo.size)
        tt[todo], st[todo], perm[todo] = t0, s0, p0
    return tt, st, perm


def random_genome_batch(space, rng: np.random.Generator, B: int) -> GenomeBatch:
    return GenomeBatch(space, *random_rows_batch(space, rng, B))


def resample_inner_rows(
    space,
    rng: np.random.Generator,
    tt_base: np.ndarray,
    st_base: np.ndarray,
    perm_base: np.ndarray,
    split: int,
    B: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``B`` candidates keeping levels ``[0, split)`` of one base row and
    re-sampling the on-chip rest (chains conditioned on the prefix's ST,
    fresh below-split orders) -- the decoupled mapper's phase-2 batch."""
    n = space.n_levels
    D = len(space.dims)
    tt = np.tile(tt_base, (B, 1, 1))
    st = np.tile(st_base, (B, 1, 1))
    perm = np.tile(perm_base, (B, 1, 1))
    for j in range(D):
        if split > 0:
            start = np.full(B, st_base[split - 1, j], dtype=np.int64)
        else:
            start = None
        tcol, scol = sample_chain_cols(
            space, rng, j, B, start=start, from_level=split
        )
        tt[:, split:, j] = tcol[:, split:]
        st[:, split:, j] = scol[:, split:]
    sub = rng.permuted(
        np.tile(np.arange(D, dtype=np.int64), (B, n - split, 1)), axis=2
    )
    perm[:, split:, :] = sub
    cons = space.constraints
    if cons is not None and cons.loop_orders:
        dim_index = {d: j for j, d in enumerate(space.dims)}
        dimset = set(space.dims)
        for i in range(split, n):
            want = cons.loop_orders.get(space.arch.clusters[i].name)
            if want:
                forced = [dim_index[d] for d in want if d in dimset] + [
                    j for j, d in enumerate(space.dims) if d not in want
                ]
                perm[:, i, :] = np.asarray(forced, dtype=np.int64)
    return tt, st, perm


# --------------------------------------------------------------------- #
# Vectorized exhaustive enumeration: mixed-radix index decoding over the
# per-dim legal chain lists, in the EXACT order the recursive DFS of
# ``MapSpace.enumerate_genomes`` yields (lexicographic over per-dim chain
# indices, fanout-cap filtered -- prefix pruning removes exactly the
# combos the full per-level check rejects).
# --------------------------------------------------------------------- #
def exhaustive_row_blocks(space, block: int = 2048):
    """Yield ``(tt, st)`` blocks of fanout-feasible chain combos in DFS
    order. The outer dims run as a Python DFS over their (few) prefix
    nodes with incremental fanout products -- pruning whole subtrees like
    the scalar enumerator -- while the innermost dim is decided for ALL
    its chains at once with one masked array comparison per prefix."""
    dims = space.dims
    n = space.n_levels
    D = len(dims)
    per = [
        np.asarray(space._chains_for_dim(d), dtype=np.int64).reshape(-1, n, 2)
        for d in dims
    ]
    fans = [np.maximum(p[:, :, 0] // np.maximum(p[:, :, 1], 1), 1) for p in per]
    caps = np.asarray(space.child_fanout, dtype=np.float64)
    fansf = [f.astype(np.float64) for f in fans]

    buf_idx: List[np.ndarray] = []  # [k, D] index rows awaiting emission
    buffered = 0

    def emit(rows_idx: np.ndarray):
        """Gather chain tuples for a [k, D] block of per-dim indices."""
        k = rows_idx.shape[0]
        tt = np.empty((k, n, D), dtype=np.int64)
        st = np.empty((k, n, D), dtype=np.int64)
        for j in range(D):
            ch = per[j][rows_idx[:, j]]
            tt[:, :, j] = ch[:, :, 0]
            st[:, :, j] = ch[:, :, 1]
        return tt, st

    def dfs(j: int, prefix: List[int], fan_prod: np.ndarray):
        nonlocal buffered
        if j == D - 1:
            okm = (fansf[j] * fan_prod <= caps).all(axis=1)
            last = np.flatnonzero(okm)
            if last.size == 0:
                return
            rows = np.empty((last.size, D), dtype=np.int64)
            rows[:, :-1] = np.asarray(prefix, dtype=np.int64)
            rows[:, -1] = last
            buf_idx.append(rows)
            buffered += last.size
            while buffered >= block:
                yield _drain()
            return
        fj = fansf[j]
        for ci in range(per[j].shape[0]):
            nf = fan_prod * fj[ci]
            if (nf > caps).any():
                continue
            prefix.append(ci)
            yield from dfs(j + 1, prefix, nf)
            prefix.pop()

    def _drain():
        nonlocal buffered
        allrows = np.concatenate(buf_idx, axis=0)
        head, rest = allrows[:block], allrows[block:]
        buf_idx.clear()
        if rest.size:
            buf_idx.append(rest)
        buffered = sum(r.shape[0] for r in buf_idx)
        return emit(head)

    if D == 1:
        okm = (fansf[0] <= caps).all(axis=1)
        idxs = np.flatnonzero(okm)
        for s in range(0, idxs.size, block):
            yield emit(idxs[s : s + block, None])
        return
    yield from dfs(0, [], np.ones(n, dtype=np.float64))
    while buffered:
        yield _drain()


def exhaustive_genome_batches(
    space,
    max_mappings: Optional[int] = None,
    batch_size: int = 256,
    decode_block: int = 2048,
):
    """Stream legal candidates as :class:`GenomeBatch` chunks of EXACTLY
    ``batch_size`` rows (last chunk partial), reproducing the scalar
    enumerator's candidate stream and chunk boundaries bit-for-bit
    (canonical orders, no constraints -- callers gate on that)."""
    n = space.n_levels
    D = len(space.dims)
    canonical = np.arange(D, dtype=np.int64)
    pend_tt: List[np.ndarray] = []
    pend_st: List[np.ndarray] = []
    pending = 0
    emitted = 0
    budget = math.inf if max_mappings is None else int(max_mappings)

    def flush(k: int):
        nonlocal pending
        tt = np.concatenate(pend_tt, axis=0) if len(pend_tt) > 1 else pend_tt[0]
        st = np.concatenate(pend_st, axis=0) if len(pend_st) > 1 else pend_st[0]
        head_t, rest_t = tt[:k], tt[k:]
        head_s, rest_s = st[:k], st[k:]
        pend_tt.clear()
        pend_st.clear()
        if rest_t.shape[0]:
            pend_tt.append(rest_t)
            pend_st.append(rest_s)
        pending = rest_t.shape[0]
        perm = np.tile(canonical, (head_t.shape[0], n, 1))
        return GenomeBatch(space, head_t, head_s, perm)

    for tt, st in exhaustive_row_blocks(space, block=decode_block):
        good = legal_batch(
            space, tt, st, np.tile(canonical, (tt.shape[0], n, 1)), structured=True
        )
        keep = np.flatnonzero(good)
        if keep.size == 0:
            continue
        remaining = budget - emitted - pending
        if keep.size > remaining:
            keep = keep[: int(remaining)]
        pend_tt.append(tt[keep])
        pend_st.append(st[keep])
        pending += keep.size
        while pending >= batch_size:
            gb = flush(batch_size)
            emitted += len(gb)
            yield gb
        if emitted + pending >= budget:
            break
    while pending:
        gb = flush(min(batch_size, pending))
        emitted += len(gb)
        yield gb
