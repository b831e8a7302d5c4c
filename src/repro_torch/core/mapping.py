"""Union mapping abstraction (paper Sec. IV-D).

*Cluster-target loop-centric* mapping: for EVERY cluster level C_i the
mapping specifies

  * ``temporal_order``       -- ordering of the temporal loops at this level,
  * ``temporal_tile_sizes``  -- TT_d^i  per problem dimension d,
  * ``spatial_tile_sizes``   -- ST_d^i  per problem dimension d.

Semantics (paper Sec. IV-D "Semantics and characteristics"):

  * The enclosing level hands this level a spatial tile ST^{i+1}
    (for the outermost level, ST^{n+1} := the full problem bounds).
  * That tile is processed in ``steps_i = prod_d ST_d^{i+1} / TT_d^i``
    temporal steps, iterated in ``temporal_order``.
  * Each temporal tile TT^i is split into ``par_i = prod_d TT_d^i / ST_d^i``
    spatial sub-tiles, distributed over the sub-cluster instances.
    Spatial loops at one level iterate CONCURRENTLY -- there is no
    spatial order, and several dims may be parallelized at once
    (this is what memory-target loop-centric abstractions cannot say).

Legality rules (paper Sec. IV-D, verbatim order):

  R1. ST_d^i >= TT_d^{i-1}                (spatial tile can hold the inner
                                           temporal tile)
  R2. TT_d^i / ST_d^i  (product over d) <= fanout of the (i-1) sub-clusters
  R3. non-virtual cluster memory >= sum of data-space footprints of TT^i
  R4. the mapping covers all iteration vectors of the problem
      (we additionally require divisor chains so coverage is exact).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping as TMapping, Optional, Sequence, Tuple

from repro_torch.core.architecture import Architecture
from repro_torch.core.problem import Problem


def _prod(xs) -> int:
    return math.prod(xs) if xs else 1


def mapping_signature(mapping: "Mapping", dims: Sequence[str]):
    """Canonical hashable identity of a mapping's cost-relevant content.

    Per level: (effective temporal order, TT per dim, ST per dim), with the
    order normalized the way the reuse analysis normalizes it (declared
    order first, then missing dims in problem order). Mappings that differ
    only in how they *store* an equivalent order hash identically; equal
    signatures imply byte-identical analytical costs.
    """
    sig = []
    for lm in mapping.levels:
        declared = tuple(lm.temporal_order)
        order = declared + tuple(d for d in dims if d not in declared)
        tts = lm.temporal_tile_sizes
        sts = lm.spatial_tile_sizes
        sig.append(
            (
                order,
                tuple(int(tts.get(d, 1)) for d in dims),
                tuple(int(sts.get(d, 1)) for d in dims),
            )
        )
    return tuple(sig)


@dataclass
class LevelMapping:
    """Tiling directives targeting one cluster level (paper Fig. 5(d))."""

    cluster: str
    temporal_order: Tuple[str, ...]
    temporal_tile_sizes: Dict[str, int]
    spatial_tile_sizes: Dict[str, int]

    def tt(self, d: str) -> int:
        return int(self.temporal_tile_sizes.get(d, 1))

    def st(self, d: str) -> int:
        return int(self.spatial_tile_sizes.get(d, 1))

    def to_dict(self) -> dict:
        return {
            "target_cluster": self.cluster,
            "temporal_order": list(self.temporal_order),
            "temporal_tile_sizes": dict(self.temporal_tile_sizes),
            "spatial_tile_sizes": dict(self.spatial_tile_sizes),
        }


@dataclass
class Mapping:
    """A full mapping: one LevelMapping per cluster level, outermost first."""

    levels: List[LevelMapping]
    problem_name: str = ""

    # ------------------------------------------------------------------ #
    # Tile-chain accessors.  Index i: 0 == outermost level.
    # ------------------------------------------------------------------ #
    def outer_spatial_tile(self, i: int, problem: Problem) -> Dict[str, int]:
        """ST^{i+1} in paper terms: the tile handed to level i from outside."""
        if i == 0:
            return dict(problem.dims)
        return {d: self.levels[i - 1].st(d) for d in problem.dims}

    def temporal_trips(self, i: int, problem: Problem) -> Dict[str, int]:
        """Temporal loop trip count per dim at level i."""
        outer = self.outer_spatial_tile(i, problem)
        lm = self.levels[i]
        return {d: max(1, outer[d] // max(1, lm.tt(d))) for d in problem.dims}

    def spatial_fanout(self, i: int, problem: Problem) -> Dict[str, int]:
        """Spatial parallelism per dim at level i."""
        lm = self.levels[i]
        return {d: max(1, lm.tt(d) // max(1, lm.st(d))) for d in problem.dims}

    def parallelism(self, i: int, problem: Problem) -> int:
        return _prod(self.spatial_fanout(i, problem).values())

    def steps(self, i: int, problem: Problem) -> int:
        return _prod(self.temporal_trips(i, problem).values())

    def total_parallelism(self, problem: Problem) -> int:
        return _prod(self.parallelism(i, problem) for i in range(len(self.levels)))

    def utilization(self, problem: Problem, arch: Architecture) -> float:
        """Fraction of physical PEs (leaf clusters) used by this mapping."""
        return self.total_parallelism(problem) / max(1, arch.num_pes)

    # ------------------------------------------------------------------ #
    # Legality (paper's four rules + divisibility + constraint hooks)
    # ------------------------------------------------------------------ #
    def violations(self, problem: Problem, arch: Architecture) -> List[str]:
        errs: List[str] = []
        n = len(self.levels)
        if n != arch.n_levels:
            errs.append(f"mapping has {n} levels but architecture has {arch.n_levels}")
            return errs
        dims = problem.dims
        for i, lm in enumerate(self.levels):
            outer = self.outer_spatial_tile(i, problem)
            for d in dims:
                tt, st = lm.tt(d), lm.st(d)
                if tt < 1 or st < 1:
                    errs.append(f"L{i}:{d}: non-positive tile")
                    continue
                if outer[d] % tt != 0:
                    errs.append(f"R4 L{i}:{d}: TT={tt} does not divide outer tile {outer[d]}")
                if tt % st != 0:
                    errs.append(f"R4 L{i}:{d}: ST={st} does not divide TT={tt}")
                # R1: ST_d^i >= TT_d^{i-1} (inner level is i+1 in list order)
                if i + 1 < n:
                    inner_tt = self.levels[i + 1].tt(d)
                    if st < inner_tt:
                        errs.append(
                            f"R1 L{i}:{d}: spatial tile {st} < inner temporal tile {inner_tt}"
                        )
                    if st % max(1, inner_tt) != 0:
                        errs.append(
                            f"R4 L{i}:{d}: inner TT={inner_tt} does not divide ST={st}"
                        )
            # R2: parallelism bounded by sub-cluster fanout
            child_fanout = arch.clusters[i + 1].fanout if i + 1 < n else 1
            par = self.parallelism(i, problem)
            if par > child_fanout:
                errs.append(f"R2 L{i}: parallelism {par} > child fanout {child_fanout}")
            # R3: memory capacity at non-virtual levels
            cl = arch.clusters[i]
            if not cl.virtual and cl.memory_bytes is not None and i > 0:
                tile = {d: lm.tt(d) for d in dims}
                need = sum(ds.footprint_bytes(tile) for ds in problem.data_spaces)
                if need > cl.memory_bytes:
                    errs.append(
                        f"R3 L{i}({cl.name}): tile footprint {need}B > capacity {cl.memory_bytes}B"
                    )
            bad = set(lm.temporal_order) - set(dims)
            if bad:
                errs.append(f"L{i}: unknown dims in temporal_order: {sorted(bad)}")
        # innermost level: no sub-clusters -> TT == ST
        last = self.levels[-1]
        for d in dims:
            if last.tt(d) != last.st(d):
                errs.append(f"R2 L{n-1}:{d}: innermost level cannot parallelize (TT!=ST)")
        return errs

    def is_legal(self, problem: Problem, arch: Architecture) -> bool:
        """Early-exit legality predicate.

        Checks exactly the conditions ``violations`` reports, but returns on
        the first failure without building diagnostic strings -- this is on
        the hot path of every map-space sampler and neighborhood operator.
        Use ``violations`` when you need to know WHY a mapping is illegal.
        """
        n = len(self.levels)
        if n != arch.n_levels:
            return False
        dims = tuple(problem.dims.keys())
        dimset = set(dims)
        outer: TMapping[str, int] = problem.dims
        for i, lm in enumerate(self.levels):
            tts = lm.temporal_tile_sizes
            sts = lm.spatial_tile_sizes
            inner = self.levels[i + 1].temporal_tile_sizes if i + 1 < n else None
            par = 1
            for d in dims:
                tt = int(tts.get(d, 1))
                st = int(sts.get(d, 1))
                if tt < 1 or st < 1:
                    return False
                if outer[d] % tt or tt % st:
                    return False
                par *= tt // st
                if inner is not None:
                    itt = int(inner.get(d, 1))
                    if st < itt or st % max(1, itt):
                        return False
            child_fanout = arch.clusters[i + 1].fanout if i + 1 < n else 1
            if par > child_fanout:
                return False
            cl = arch.clusters[i]
            if not cl.virtual and cl.memory_bytes is not None and i > 0:
                tile = {d: int(tts.get(d, 1)) for d in dims}
                need = sum(ds.footprint_bytes(tile) for ds in problem.data_spaces)
                if need > cl.memory_bytes:
                    return False
            if not set(lm.temporal_order) <= dimset:
                return False
            outer = {d: int(sts.get(d, 1)) for d in dims}
        last = self.levels[-1]
        for d in dims:
            if last.tt(d) != last.st(d):
                return False
        return True

    def clone(self) -> "Mapping":
        """Fast deep copy (cheaper than a to_dict/from_dict round trip)."""
        return Mapping(
            [
                LevelMapping(
                    lm.cluster,
                    lm.temporal_order,
                    dict(lm.temporal_tile_sizes),
                    dict(lm.spatial_tile_sizes),
                )
                for lm in self.levels
            ],
            self.problem_name,
        )

    # ------------------------------------------------------------------ #
    # Rendering (paper Fig. 5(e)/Fig. 7 loop-nest form) + serialization
    # ------------------------------------------------------------------ #
    def loop_nest_str(self, problem: Problem) -> str:
        lines: List[str] = []
        indent = 0
        for i, lm in enumerate(self.levels):
            trips = self.temporal_trips(i, problem)
            spat = self.spatial_fanout(i, problem)
            lines.append("  " * indent + f"// {lm.cluster}")
            order = list(lm.temporal_order) + [d for d in problem.dims if d not in lm.temporal_order]
            for d in order:
                if trips[d] > 1:
                    lines.append("  " * indent + f"for {d}1 in [0:{trips[d]})")
                    indent += 1
            concurrent = [d for d in problem.dims if spat[d] > 1]
            if concurrent:
                decl = ", ".join(f"{d}0 in [0:{spat[d]})" for d in concurrent)
                lines.append("  " * indent + f"spatial_for ({decl})  // concurrent")
                indent += 1
        lines.append("  " * indent + f"compute({problem.name})")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"problem": self.problem_name, "levels": [lm.to_dict() for lm in self.levels]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "Mapping":
        levels = [
            LevelMapping(
                cluster=l["target_cluster"],
                temporal_order=tuple(l["temporal_order"]),
                temporal_tile_sizes={k: int(v) for k, v in l["temporal_tile_sizes"].items()},
                spatial_tile_sizes={k: int(v) for k, v in l["spatial_tile_sizes"].items()},
            )
            for l in d["levels"]
        ]
        return Mapping(levels, d.get("problem", ""))

    @staticmethod
    def from_json(s: str) -> "Mapping":
        return Mapping.from_dict(json.loads(s))

    # ------------------------------------------------------------------ #
    # Builders
    # ------------------------------------------------------------------ #
    @staticmethod
    def trivial(problem: Problem, arch: Architecture) -> "Mapping":
        """All-temporal-at-top mapping: always legal iff tiles fit memory.

        Everything executes sequentially on one PE -- the worst legal
        mapping; useful as a search seed and in tests.
        """
        dims = problem.dim_names
        levels: List[LevelMapping] = []
        for i, cl in enumerate(arch.clusters):
            if i == 0:
                tt = {d: 1 for d in dims}
                st = {d: 1 for d in dims}
            else:
                tt = {d: 1 for d in dims}
                st = {d: 1 for d in dims}
            levels.append(LevelMapping(cl.name, tuple(dims), tt, st))
        # outermost level: temporal tile 1 per dim => trips = full dims
        return Mapping(levels, problem.name)

    @staticmethod
    def from_tiles(
        problem: Problem,
        arch: Architecture,
        tile_chain: Sequence[TMapping[str, int]],
        orders: Optional[Sequence[Sequence[str]]] = None,
    ) -> "Mapping":
        """Build from an explicit chain [(TT^n, ST^n), (TT^{n-1}, ST^{n-1}), ...]
        given as a flat list [TT0, ST0, TT1, ST1, ...] of dicts, outermost first.
        Missing dims default to 1.
        """
        assert len(tile_chain) == 2 * arch.n_levels
        dims = problem.dim_names
        levels = []
        for i, cl in enumerate(arch.clusters):
            tt = {d: int(tile_chain[2 * i].get(d, 1)) for d in dims}
            st = {d: int(tile_chain[2 * i + 1].get(d, 1)) for d in dims}
            order = tuple(orders[i]) if orders else tuple(dims)
            levels.append(LevelMapping(cl.name, order, tt, st))
        return Mapping(levels, problem.name)
