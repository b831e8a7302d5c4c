"""Constraint files (paper Sec. IV-E).

Constraints encode accelerator-specific mapping restrictions so the
map-space can be pruned: allowed/required parallel dims per level
(e.g. NVDLA forces C and K parallel), fixed loop orders (dataflow styles:
weight/output/input/row stationary), feasible tile sizes, aspect ratios,
and min/max PE utilization.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.architecture import Architecture
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Problem


@dataclass
class Constraints:
    """A constraint set. All fields optional; empty == fully flexible
    accelerator (paper: 'to describe a fully flexible accelerator like
    MAERI, the user will not provide constraint file')."""

    name: str = "flexible"
    # level name (or "*") -> set of dims allowed to be spatially distributed
    allowed_spatial_dims: Dict[str, Set[str]] = field(default_factory=dict)
    # level name -> dims that MUST be spatially distributed (NVDLA: {c, k})
    required_spatial_dims: Dict[str, Set[str]] = field(default_factory=dict)
    # level name -> required temporal order (outer->inner); prefix match
    loop_orders: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # (level name, dim) -> allowed temporal tile sizes
    allowed_tile_sizes: Dict[Tuple[str, str], Set[int]] = field(default_factory=dict)
    # dim -> required multiple for the innermost (compute) tile, e.g. MXU=128
    tile_multiples: Dict[str, int] = field(default_factory=dict)
    # cap on CONCURRENTLY parallelized dims per cluster level. 1 emulates
    # memory-target loop-centric abstractions (Timeloop/Interstellar),
    # where one spatial_for binds one dim to one physical axis -- used by
    # the fig8 benchmark to reproduce the paper's native-TC results
    # faithfully before showing Union's richer space beats them.
    max_concurrent_spatial: Optional[int] = None
    min_utilization: float = 0.0
    max_utilization: float = 1.0

    def _spatial_ok(self, level: str, dim: str) -> bool:
        for key in (level, "*"):
            if key in self.allowed_spatial_dims:
                return dim in self.allowed_spatial_dims[key]
        return True

    def check(self, mapping: Mapping, problem: Problem, arch: Architecture) -> List[str]:
        errs: List[str] = []
        for i, lm in enumerate(mapping.levels):
            fan = mapping.spatial_fanout(i, problem)
            for d, f in fan.items():
                if f > 1 and not self._spatial_ok(lm.cluster, d):
                    errs.append(f"C:{lm.cluster}: dim {d} may not be spatial")
            if self.max_concurrent_spatial is not None:
                n_sp = sum(1 for f in fan.values() if f > 1)
                if n_sp > self.max_concurrent_spatial:
                    errs.append(
                        f"C:{lm.cluster}: {n_sp} concurrent spatial dims > "
                        f"cap {self.max_concurrent_spatial}"
                    )
            req = self.required_spatial_dims.get(lm.cluster, set())
            for d in req:
                if fan.get(d, 1) <= 1:
                    errs.append(f"C:{lm.cluster}: dim {d} must be spatial")
            order = self.loop_orders.get(lm.cluster)
            if order:
                trips = mapping.temporal_trips(i, problem)
                active = [d for d in lm.temporal_order if trips.get(d, 1) > 1]
                want = [d for d in order if d in active]
                got = [d for d in active if d in order]
                if want != got:
                    errs.append(f"C:{lm.cluster}: temporal order {got} violates required {want}")
            for d in problem.dims:
                allowed = self.allowed_tile_sizes.get((lm.cluster, d))
                if allowed is not None and lm.tt(d) not in allowed:
                    errs.append(f"C:{lm.cluster}:{d}: tile {lm.tt(d)} not in allowed set")
        innermost = mapping.levels[-1]
        for d, m in self.tile_multiples.items():
            if d in problem.dims:
                tt = innermost.tt(d)
                if tt % m != 0 and tt != problem.dims[d]:
                    errs.append(f"C:innermost:{d}: tile {tt} not a multiple of {m}")
        util = mapping.utilization(problem, arch)
        if util < self.min_utilization - 1e-9:
            errs.append(f"C:util {util:.3f} < min {self.min_utilization}")
        if util > self.max_utilization + 1e-9:
            errs.append(f"C:util {util:.3f} > max {self.max_utilization}")
        return errs

    def ok(self, mapping: Mapping, problem: Problem, arch: Architecture) -> bool:
        return not self.check(mapping, problem, arch)


def nvdla_style(conv_dims: Tuple[str, str] = ("c", "k")) -> Constraints:
    """Paper Sec. IV-E: NVDLA-style accelerator forces parallel C and K."""
    return Constraints(
        name="nvdla_style",
        allowed_spatial_dims={"*": set(conv_dims)},
        required_spatial_dims={},
        min_utilization=0.0,
    )


def weight_stationary(reduction_dims: Sequence[str], level: str) -> Constraints:
    """Keep weights resident: reduction loops innermost at the given level."""
    return Constraints(name="weight_stationary", loop_orders={level: tuple(reduction_dims)})


def mxu_aligned(dims: Sequence[str], multiple: int = 128) -> Constraints:
    """TPU MXU alignment: innermost compute tiles multiples of 128."""
    return Constraints(name="mxu_aligned", tile_multiples={d: multiple for d in dims})


def tc_aligned(
    multiples: Dict[str, int], spatial_dims: Optional[Sequence[str]] = None
) -> Constraints:
    """Hopper tensor-core alignment: each listed dim's innermost (CTA) tile
    is a multiple of its value -- 64 for a ``wgmma`` row group, 16 for the
    bf16 MMA depth -- unless it is the whole dim. ``spatial_dims``, when
    given, are the only dims the CTA grid may spread over the SMs (a
    kernel that loops over a reduction inside the CTA never splits it
    across CTAs)."""
    return Constraints(
        name="tc_aligned",
        tile_multiples=dict(multiples),
        allowed_spatial_dims={"*": set(spatial_dims)} if spatial_dims is not None else {},
    )
