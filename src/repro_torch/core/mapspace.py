"""Map-space definition, enumeration, sampling and mutation.

The map-space of (problem, architecture, constraints) is the set of legal
Union mappings. It is exponential/multiplicative (paper Sec. III-B3), so we
provide:

  * ``enumerate_tilings``  -- systematic divisor-chain enumeration with
    early pruning (fanout, memory, constraints), capped;
  * ``random_mapping``     -- uniform-ish rejection sampling with repair;
  * ``mutate`` / ``crossover`` -- neighborhood operators shared by the
    genetic and heuristic mappers.

All mappers consume THIS interface, which is what makes them interchangeable
across cost models (the paper's core interoperability claim).

Hot-path note: samplers and neighborhood operators work on :class:`Genome`
-- the raw (divisor chains, loop orders) representation -- and only
materialize a :class:`Mapping` object when something actually needs it
(an evaluation cache miss, a constraint check, the final best). Legality
of chain-structured candidates is decided directly on the int tuples
(``_chains_legal``), which is equivalent to ``Mapping.is_legal`` for every
candidate these generators produce but an order of magnitude cheaper. The
RNG call sequence of every operator is part of its contract: genome ops
consume randomness exactly like the historical Mapping-based ops, so fixed
seeds reproduce identical searches.
"""

from __future__ import annotations

import functools
import math
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.architecture import Architecture
from repro_torch.core.constraints import Constraints
from repro_torch.core.mapping import LevelMapping, Mapping
from repro_torch.core.problem import Problem


@functools.lru_cache(maxsize=65536)
def _divisors_cached(n: int) -> Tuple[int, ...]:
    """Sorted divisors of ``n``, memoized process-wide.

    Shared across every MapSpace instance -- benchmark sweeps construct many
    spaces over the same dim sizes, so a per-instance cache wastes work.
    """
    out = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            if i != n // i:
                out.append(n // i)
        i += 1
    return tuple(sorted(out))


def divisors(n: int) -> List[int]:
    return list(_divisors_cached(n))


# ---------------------------------------------------------------------- #
# Stream-identical RNG fast path. ``random.Random.choice`` / ``shuffle``
# spend most of their time in the pure-Python ``_randbelow`` wrapper; the
# samplers below inline the exact same getrandbits-rejection loop, so they
# consume the identical bit stream (fixed seeds reproduce the exact same
# candidates) at a fraction of the call overhead. Verified against the
# stdlib at import time; any mismatch (exotic interpreter) disables the
# fast path and the samplers fall back to the stdlib methods.
# ---------------------------------------------------------------------- #
def _verify_fast_rng() -> bool:
    try:
        ref = random.Random(987654321)
        tst = random.Random(987654321)
        for n in range(1, 40):
            seq = list(range(n))
            want = ref.choice(seq)
            k = n.bit_length()
            r = tst.getrandbits(k)
            while r >= n:
                r = tst.getrandbits(k)
            if seq[r] != want:
                return False
        xs = list(range(17))
        ys = list(xs)
        ref.shuffle(xs)
        gb = tst.getrandbits
        for i in range(len(ys) - 1, 0, -1):
            n = i + 1
            k = n.bit_length()
            r = gb(k)
            while r >= n:
                r = gb(k)
            ys[i], ys[r] = ys[r], ys[i]
        if xs != ys:
            return False
        # sample (both the pool branch and the selection-set branch)
        for n, k in ((10, 3), (40, 3), (60, 8)):
            seq = list(range(n))
            if ref.sample(seq, k) != _fast_sample(tst, seq, k):
                return False
        return True
    except Exception:
        return False


def _fast_choice(gb, seq):
    """``seq[rng._randbelow(len(seq))]`` via a pre-bound ``getrandbits``."""
    n = len(seq)
    k = n.bit_length()
    r = gb(k)
    while r >= n:
        r = gb(k)
    return seq[r]


def fast_sample(rng: random.Random, population, k: int) -> list:
    """Stream-identical ``rng.sample`` (falls back to the stdlib when the
    fast path is unavailable). Shared by the tournament selection in the
    genetic mapper."""
    if _FAST_RNG and type(rng) is random.Random:
        return _fast_sample(rng, population, k)
    return rng.sample(population, k)


def _fast_shuffle(gb, xs) -> None:
    for i in range(len(xs) - 1, 0, -1):
        n = i + 1
        k = n.bit_length()
        r = gb(k)
        while r >= n:
            r = gb(k)
        xs[i], xs[r] = xs[r], xs[i]


def _fast_sample(rng, population, k: int) -> list:
    """``rng.sample(population, k)`` consuming the identical bit stream
    (replicates CPython's pool/selection-set branch choice)."""
    n = len(population)
    if not 0 <= k <= n:
        return rng.sample(population, k)  # let stdlib raise identically
    gb = rng.getrandbits
    result = [None] * k
    setsize = 21
    if k > 5:
        setsize += 4 ** math.ceil(math.log(k * 3, 4))
    if n <= setsize:
        pool = list(population)
        for i in range(k):
            m = n - i
            kb = m.bit_length()
            j = gb(kb)
            while j >= m:
                j = gb(kb)
            result[i] = pool[j]
            pool[j] = pool[m - 1]
    else:
        selected = set()
        selected_add = selected.add
        kb = n.bit_length()
        for i in range(k):
            j = gb(kb)
            while j >= n:
                j = gb(kb)
            while j in selected:
                j = gb(kb)
                while j >= n:
                    j = gb(kb)
            selected_add(j)
            result[i] = population[j]
    return result


_FAST_RNG = _verify_fast_rng()

class Genome:
    """Chain-level candidate: per-dim divisor chains + per-level loop orders.

    ``chains[d]`` is the ``(TT_0, ST_0, ..., TT_{n-1}, ST_{n-1})`` tuple for
    dim ``d``; ``orders[i]`` is the full temporal order of level i. The
    evaluation engine consumes the genome directly (``signature`` for the
    memo cache, ``to_mapping`` only on a miss).
    """

    __slots__ = (
        "space",
        "chains",
        "orders",
        "_mapping",
        "_signature",
        "_sig_dims",
        "_chain_list",
    )

    def __init__(
        self,
        space: "MapSpace",
        chains: Dict[str, Tuple[int, ...]],
        orders: Tuple[Tuple[str, ...], ...],
    ) -> None:
        self.space = space
        self.chains = chains
        self.orders = orders
        self._mapping: Optional[Mapping] = None
        self._signature = None
        self._sig_dims = None
        self._chain_list: Optional[List[Tuple[int, ...]]] = None

    @property
    def chain_list(self) -> List[Tuple[int, ...]]:
        """Per-dim chains in problem-dim order (the form the chain-level
        lower bound consumes)."""
        if self._chain_list is None:
            chains = self.chains
            self._chain_list = [chains[d] for d in self.space.dims]
        return self._chain_list

    def cache_key(self, dims: Sequence[str]):
        """Cheap engine-cache key: (orders, chains) uniquely determine the
        canonical signature, so equal keys imply identical costs."""
        return (self.orders, tuple(self.chain_list))

    def signature(self, dims: Sequence[str]):
        """Same canonical signature ``engine.mapping_signature`` computes
        for the materialized mapping (orders here are always full)."""
        if self._signature is None:
            chains = self.chains
            chain_list = [chains[d] for d in dims]
            self._sig_dims = tuple(dims)
            sig = []
            for i in range(self.space.n_levels):
                k = 2 * i
                k1 = k + 1
                sig.append(
                    (
                        self.orders[i],
                        tuple(ch[k] for ch in chain_list),
                        tuple(ch[k1] for ch in chain_list),
                    )
                )
            self._signature = tuple(sig)
        return self._signature

    def to_mapping(self) -> Mapping:
        if self._mapping is None:
            self._mapping = self.space._chain_to_mapping(self.chains, self.orders)
            if self._signature is not None:
                # let the analysis pick the signature up without re-deriving
                self._mapping._sig_cache = (self._sig_dims, self._signature)
        return self._mapping


@dataclass
class MapSpace:
    problem: Problem
    arch: Architecture
    constraints: Optional[Constraints] = None

    def __post_init__(self) -> None:
        self.dims = list(self.problem.dims.keys())
        self.n_levels = self.arch.n_levels
        # spatial capability per mapping level: fanout of the child cluster
        self.child_fanout = [
            self.arch.clusters[i + 1].fanout if i + 1 < self.n_levels else 1
            for i in range(self.n_levels)
        ]
        self._chain_cache: Dict[str, List[Tuple[int, ...]]] = {}
        # spatial capability per (dim, level) incl. constraints -- fixed for
        # the lifetime of the space, so hoisted out of the samplers
        self._allowed_spatial: Dict[str, List[bool]] = {
            d: [
                self.child_fanout[i] > 1
                and (
                    self.constraints is None
                    or self.constraints._spatial_ok(self.arch.clusters[i].name, d)
                )
                for i in range(self.n_levels)
            ]
            for d in self.dims
        }
        # R3 data for chain-level legality: memory-capped levels + per-data-
        # space projections as (|coeff|, dim) terms
        self._mem_levels: List[Tuple[int, int]] = [
            (i, cl.memory_bytes)
            for i, cl in enumerate(self.arch.clusters)
            if not cl.virtual and cl.memory_bytes is not None and i > 0
        ]
        self._ds_axes: List[Tuple[int, List[List[Tuple[int, str]]]]] = [
            (
                ds.word_bytes,
                [[(abs(t.coeff), t.dim) for t in expr.terms] for expr in ds.projection],
            )
            for ds in self.problem.data_spaces
        ]

    # ------------------------------------------------------------------ #
    def _divs(self, n: int) -> Tuple[int, ...]:
        return _divisors_cached(n)

    def size_log10(self) -> float:
        """Rough log10 of the number of tilings (ignoring orders)."""
        total = 0.0
        for d, s in self.problem.dims.items():
            nd = len(self._divs(s))
            total += 2 * self.n_levels * math.log10(max(nd, 1)) * 0.5
        # loop orders per level
        total += self.n_levels * math.log10(math.factorial(len(self.dims))) * 0.5
        return total

    # ------------------------------------------------------------------ #
    # Chain representation: per dim, a tuple of 2n divisors
    # (TT_0, ST_0, TT_1, ST_1, ..., TT_{n-1}, ST_{n-1}), nested:
    # full >= TT_0 >= ST_0 >= TT_1 >= ... and each divides the previous.
    # ------------------------------------------------------------------ #
    def _chain_to_mapping(
        self,
        chains: Dict[str, Tuple[int, ...]],
        orders: Optional[Sequence[Sequence[str]]] = None,
    ) -> Mapping:
        levels = []
        for i, cl in enumerate(self.arch.clusters):
            tt = {d: chains[d][2 * i] for d in self.dims}
            st = {d: chains[d][2 * i + 1] for d in self.dims}
            order = tuple(orders[i]) if orders else tuple(self.dims)
            levels.append(LevelMapping(cl.name, order, tt, st))
        return Mapping(levels, self.problem.name)

    def _chains_legal(self, chains: Dict[str, Tuple[int, ...]]) -> bool:
        """``Mapping.is_legal`` specialized to chain-structured candidates.

        Valid for any candidate whose per-dim chain is a nested divisor
        chain with full per-level orders -- which is everything the
        samplers, neighborhood operators and the enumerator produce. The
        chain nesting itself is re-verified (cheap int ops), so this is
        equivalent to materializing + ``is_legal``.
        """
        n = self.n_levels
        pars = [1] * n
        for d, size in self.problem.dims.items():
            ch = chains[d]
            prev = size
            i = 0
            for k in range(0, 2 * n, 2):
                tt = ch[k]
                st = ch[k + 1]
                if tt < 1 or st < 1 or prev % tt or tt % st:
                    return False
                pars[i] *= tt // st
                prev = st
                i += 1
            if ch[2 * n - 2] != ch[2 * n - 1]:  # innermost cannot parallelize
                return False
        for i in range(n):
            if pars[i] > self.child_fanout[i]:
                return False
        for i, cap in self._mem_levels:
            need = 0
            for wb, axes in self._ds_axes:
                foot = 1
                for ax in axes:
                    span = 1
                    for coeff, d in ax:
                        span += coeff * (chains[d][2 * i] - 1)
                    foot *= span
                need += foot * wb
            if need > cap:
                return False
        return True

    def _constraints_ok(self, genome: Genome) -> bool:
        if self.constraints is None:
            return True
        return self.constraints.ok(genome.to_mapping(), self.problem, self.arch)

    def _sample_chain(self, rng: random.Random, size: int, spatial_slots: List[bool]) -> Tuple[int, ...]:
        """Sample one nested divisor chain for a dim of the given size."""
        chain: List[int] = []
        cur = size
        last = self.n_levels - 1
        if _FAST_RNG and type(rng) is random.Random:
            gb = rng.getrandbits
            for i in range(self.n_levels):
                divs = _divisors_cached(cur)
                n = len(divs)
                k = n.bit_length()
                r = gb(k)
                while r >= n:
                    r = gb(k)
                tt = divs[r]
                st = tt
                if spatial_slots[i]:
                    divs = _divisors_cached(tt)
                    n = len(divs)
                    k = n.bit_length()
                    r = gb(k)
                    while r >= n:
                        r = gb(k)
                    if i != last:
                        st = divs[r]
                chain.append(tt)
                chain.append(st)
                cur = st
            return tuple(chain)
        for i in range(self.n_levels):
            tt = rng.choice(self._divs(cur))
            if spatial_slots[i]:
                st = rng.choice(self._divs(tt))
            else:
                st = tt
            if i == self.n_levels - 1:
                st = tt  # innermost cannot parallelize
            chain.extend((tt, st))
            cur = st
        return tuple(chain)

    def random_genome(self, rng: random.Random, max_tries: int = 200) -> Genome:
        """Rejection-sample a legal candidate (with spatial repair)."""
        fast = _FAST_RNG and type(rng) is random.Random
        gb = rng.getrandbits if fast else None
        for _ in range(max_tries):
            chains: Dict[str, Tuple[int, ...]] = {}
            for d in self.dims:
                chains[d] = self._sample_chain(
                    rng, self.problem.dims[d], self._allowed_spatial[d]
                )
            # repair: clamp per-level parallelism to child fanout
            for i in range(self.n_levels):
                par = 1
                for d in self.dims:
                    ch = chains[d]
                    par *= ch[2 * i] // ch[2 * i + 1]
                while par > self.child_fanout[i]:
                    cand = [d for d in self.dims if chains[d][2 * i] // chains[d][2 * i + 1] > 1]
                    d = _fast_choice(gb, cand) if fast else rng.choice(cand)
                    c = list(chains[d])
                    # grow ST toward TT by the smallest prime factor
                    ratio = c[2 * i] // c[2 * i + 1]
                    p = min(f for f in self._divs(ratio) if f > 1)
                    newst = c[2 * i + 1] * p
                    # rescale the rest of the chain below to keep nesting
                    c[2 * i + 1] = newst
                    for j in range(2 * i + 2, 2 * self.n_levels):
                        c[j] = math.gcd(c[j], newst) if c[j] > newst else c[j]
                        newst = c[j]
                    chains[d] = tuple(c)
                    par = math.prod(chains[d][2 * i] // chains[d][2 * i + 1] for d in self.dims)
            orders = [list(self.dims) for _ in range(self.n_levels)]
            for o in orders:
                if fast:
                    _fast_shuffle(gb, o)
                else:
                    rng.shuffle(o)
            orders_ok = True
            if self.constraints is not None:
                dimset = set(self.dims)
                for i, cl in enumerate(self.arch.clusters):
                    want = self.constraints.loop_orders.get(cl.name)
                    if want:
                        orders[i] = list(want) + [d for d in self.dims if d not in want]
                        # constraint orders naming unknown dims are illegal
                        # (matches Mapping.is_legal's temporal_order check)
                        orders_ok &= set(want) <= dimset
            g = Genome(self, chains, tuple(tuple(o) for o in orders))
            if orders_ok and self._chains_legal(chains) and self._constraints_ok(g):
                return g
        # guaranteed-legal fallback: the all-serial trivial mapping
        ones = (1,) * (2 * self.n_levels)
        return Genome(
            self,
            {d: ones for d in self.dims},
            tuple(tuple(self.dims) for _ in range(self.n_levels)),
        )

    def random_mapping(self, rng: random.Random, max_tries: int = 200) -> Mapping:
        return self.random_genome(rng, max_tries).to_mapping()

    # ------------------------------------------------------------------ #
    def _chains_for_dim(self, d: str) -> List[Tuple[int, ...]]:
        """All legal nested divisor chains for one dim, cached per instance
        (problem/arch/constraints are fixed for a MapSpace, so repeated
        ``enumerate_tilings`` calls reuse the lists)."""
        cached = self._chain_cache.get(d)
        if cached is not None:
            return cached
        spatial_slots = [f > 1 for f in self.child_fanout]
        size = self.problem.dims[d]
        results: List[Tuple[int, ...]] = []

        def rec(cur: int, i: int, acc: List[int]) -> None:
            if i == self.n_levels:
                results.append(tuple(acc))
                return
            for tt in self._divs(cur):
                st_opts = self._divs(tt) if (spatial_slots[i] and i < self.n_levels - 1) else (tt,)
                if self.constraints is not None and not self.constraints._spatial_ok(
                    self.arch.clusters[i].name, d
                ):
                    st_opts = (tt,)
                for st in st_opts:
                    if tt // st > self.child_fanout[i]:
                        continue
                    rec(st, i + 1, acc + [tt, st])

        rec(size, 0, [])
        self._chain_cache[d] = results
        return results

    def enumerate_genomes(
        self,
        max_mappings: Optional[int] = None,
        orders: str = "canonical",
        rng: Optional[random.Random] = None,
    ) -> Iterator[Genome]:
        """Systematic enumeration of legal tilings with early pruning.

        ``orders``: 'canonical' uses the problem dim order at every level;
        'sampled' draws one random order per tiling (cheap diversification).
        """
        rng = rng or random.Random(0)
        n = self.n_levels
        per_dim = [self._chains_for_dim(d) for d in self.dims]
        # per-chain per-level spatial fanout vectors, precomputed once so the
        # product loop below multiplies ints instead of re-deriving them
        per_dim_fans = [
            [tuple(ch[2 * i] // ch[2 * i + 1] for i in range(n)) for ch in chains]
            for chains in per_dim
        ]
        ones = (1,) * n
        fanout = tuple(self.child_fanout)
        ndims = len(self.dims)
        canonical = tuple(tuple(self.dims) for _ in range(n))

        # depth-first product over per-dim chains with incremental per-level
        # fanout products: a prefix whose parallelism already exceeds the
        # child fanout at any level prunes its whole subtree (the remaining
        # dims can only multiply by >= 1). Yields exactly the combos the
        # naive product + post-filter admits, in the same order.
        def combos(di: int, acc: List[Tuple[int, ...]], fans: Tuple[int, ...]):
            if di == ndims:
                yield tuple(acc)
                return
            chains = per_dim[di]
            cfans = per_dim_fans[di]
            for ci in range(len(chains)):
                nf = tuple(a * b for a, b in zip(fans, cfans[ci]))
                if any(f > cap for f, cap in zip(nf, fanout)):
                    continue
                acc.append(chains[ci])
                yield from combos(di + 1, acc, nf)
                acc.pop()

        count = 0
        for combo in combos(0, [], ones):
            chains = dict(zip(self.dims, combo))
            if orders == "sampled":
                ordset = []
                for _ in range(n):
                    o = list(self.dims)
                    rng.shuffle(o)
                    ordset.append(tuple(o))
                ordset = tuple(ordset)
            else:
                ordset = canonical
            if not self._chains_legal(chains):
                continue
            g = Genome(self, chains, ordset)
            if not self._constraints_ok(g):
                continue
            yield g
            count += 1
            if max_mappings is not None and count >= max_mappings:
                return

    def enumerate_tilings(
        self,
        max_mappings: Optional[int] = None,
        orders: str = "canonical",
        rng: Optional[random.Random] = None,
    ) -> Iterator[Mapping]:
        for g in self.enumerate_genomes(max_mappings, orders, rng):
            yield g.to_mapping()

    # ------------------------------------------------------------------ #
    # Neighborhood operators (used by genetic / heuristic mappers)
    # ------------------------------------------------------------------ #
    def mutate_genome(self, genome: Genome, rng: random.Random, tries: int = 50) -> Genome:
        """Random small move: re-sample one dim's chain, or permute one order."""
        for _ in range(tries):
            chains = dict(genome.chains)
            orders = list(genome.orders)
            move = rng.random()
            if move < 0.3:
                # permute a level's temporal order
                i = rng.randrange(self.n_levels)
                order = list(orders[i])
                if len(order) >= 2:
                    a, b = rng.sample(range(len(order)), 2)
                    order[a], order[b] = order[b], order[a]
                    orders[i] = tuple(order)
            else:
                # re-sample one dim's chain
                if _FAST_RNG and type(rng) is random.Random:
                    d = _fast_choice(rng.getrandbits, self.dims)
                else:
                    d = rng.choice(self.dims)
                chains[d] = self._sample_chain(
                    rng, self.problem.dims[d], self._allowed_spatial[d]
                )
            g = Genome(self, chains, tuple(orders))
            if self._chains_legal(chains) and self._constraints_ok(g):
                return g
        return genome

    def crossover_genome(self, a: Genome, b: Genome, rng: random.Random, tries: int = 20) -> Genome:
        """Per-dim uniform crossover of tile chains; orders from either parent."""
        for _ in range(tries):
            chains: Dict[str, Tuple[int, ...]] = {}
            for d in self.dims:
                src = a if rng.random() < 0.5 else b
                chains[d] = src.chains[d]
            orders = []
            for i in range(self.n_levels):
                src = a if rng.random() < 0.5 else b
                orders.append(src.orders[i])
            g = Genome(self, chains, tuple(orders))
            if self._chains_legal(chains) and self._constraints_ok(g):
                return g
        return a

    # Mapping-object compatibility wrappers (hill-climbers and external
    # callers hold Mappings; the genome ops above are the hot path).
    def _genome_of(self, mapping: Mapping) -> Genome:
        chains = {
            d: tuple(
                int(v)
                for lm in mapping.levels
                for v in (lm.temporal_tile_sizes.get(d, 1), lm.spatial_tile_sizes.get(d, 1))
            )
            for d in self.dims
        }
        orders = tuple(
            tuple(lm.temporal_order)
            + tuple(d for d in self.dims if d not in lm.temporal_order)
            for lm in mapping.levels
        )
        g = Genome(self, chains, orders)
        g._mapping = mapping
        return g

    def mutate(self, mapping: Mapping, rng: random.Random, tries: int = 50) -> Mapping:
        return self.mutate_genome(self._genome_of(mapping), rng, tries).to_mapping()

    def crossover(self, a: Mapping, b: Mapping, rng: random.Random, tries: int = 20) -> Mapping:
        return self.crossover_genome(
            self._genome_of(a), self._genome_of(b), rng, tries
        ).to_mapping()
