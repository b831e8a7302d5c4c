"""TTGT rewriting: Tensor Contraction -> Transpose-Transpose-GEMM-Transpose.

Paper Sec. II-A / V-A (COMET reformulation): a TC is flattened into a GEMM
by grouping indices into M (A-and-C), N (B-and-C), K (A-and-B) groups, with
explicit transposes when the groups are not contiguous in the given
layouts. The Union frontend enumerates candidate groupings, costs the GEMM
with any cost model (optionally + transpose DRAM traffic), and picks the
best algorithm per accelerator (native vs TTGT) -- the Fig. 8 case study.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.problem import Problem


@dataclass
class TTGTPlan:
    tc_name: str
    m_group: Tuple[str, ...]
    n_group: Tuple[str, ...]
    k_group: Tuple[str, ...]
    M: int
    N: int
    K: int
    needs_transpose_a: bool
    needs_transpose_b: bool
    needs_transpose_c: bool
    transpose_elems: int  # elements moved by the explicit transposes

    def gemm_problem(self, word_bytes: int = 1) -> Problem:
        return Problem.gemm(self.M, self.N, self.K,
                            name=f"{self.tc_name}_ttgt", word_bytes=word_bytes)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TTGT(M={self.M}[{','.join(self.m_group)}] "
                f"N={self.N}[{','.join(self.n_group)}] "
                f"K={self.K}[{','.join(self.k_group)}])")


def _parse_tc(problem: Problem) -> Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]:
    spec = problem.attrs.get("einsum")
    if not spec:
        raise ValueError("TTGT requires an einsum-annotated TC problem")
    lhs, rhs = spec.replace(" ", "").split("->")
    a, b = lhs.split(",")
    return tuple(a), tuple(b), tuple(rhs)


def _is_contiguous_suffix_prefix(order: Tuple[str, ...], group: Tuple[str, ...],
                                 where: str) -> bool:
    """True if `group` (as a set) appears contiguously at the given end of
    `order` in exactly the group's order (no transpose needed)."""
    k = len(group)
    if k == 0:
        return True
    seg = order[-k:] if where == "suffix" else order[:k]
    return tuple(seg) == tuple(group)


def enumerate_ttgt_plans(problem: Problem) -> List[TTGTPlan]:
    """Enumerate (M,N,K) groupings. Group membership is fixed by the einsum
    (an index is M, N, K, or batch); the enumeration is over the ORDER of
    indices inside each group (which changes transpose requirements).
    Batch indices (in A, B, and C) are folded into M.
    """
    a_idx, b_idx, c_idx = _parse_tc(problem)
    a_set, b_set, c_set = set(a_idx), set(b_idx), set(c_idx)
    k_set = (a_set & b_set) - c_set
    batch = a_set & b_set & c_set
    m_set = ((a_set & c_set) - b_set) | batch
    n_set = (b_set & c_set) - a_set
    dangling = (a_set | b_set | c_set) - (k_set | m_set | n_set)
    if dangling:
        raise ValueError(f"non-contractable indices {dangling} in {problem.name}")

    sizes = problem.dims
    M = math.prod(sizes[d] for d in m_set) if m_set else 1
    N = math.prod(sizes[d] for d in n_set) if n_set else 1
    K = math.prod(sizes[d] for d in k_set) if k_set else 1

    import itertools

    plans: List[TTGTPlan] = []
    m_orders = list(itertools.permutations(sorted(m_set)))[:24]
    n_orders = list(itertools.permutations(sorted(n_set)))[:24]
    k_orders = list(itertools.permutations(sorted(k_set)))[:24]
    a_elems = math.prod(sizes[d] for d in a_idx)
    b_elems = math.prod(sizes[d] for d in b_idx)
    c_elems = math.prod(sizes[d] for d in c_idx)
    for mo in m_orders:
        for no in n_orders:
            for ko in k_orders:
                # A must be laid out as [M-group..., K-group...] (row-major GEMM A)
                ta = not (
                    _is_contiguous_suffix_prefix(a_idx, tuple(ko), "suffix")
                    and _is_contiguous_suffix_prefix(a_idx, tuple(mo), "prefix")
                )
                tb = not (
                    _is_contiguous_suffix_prefix(b_idx, tuple(no), "suffix")
                    and _is_contiguous_suffix_prefix(b_idx, tuple(ko), "prefix")
                )
                tc_ = not (
                    _is_contiguous_suffix_prefix(c_idx, tuple(no), "suffix")
                    and _is_contiguous_suffix_prefix(c_idx, tuple(mo), "prefix")
                )
                elems = (a_elems * 2 if ta else 0) + (b_elems * 2 if tb else 0) + (
                    c_elems * 2 if tc_ else 0
                )
                plans.append(
                    TTGTPlan(
                        problem.name, tuple(mo), tuple(no), tuple(ko),
                        M, N, K, ta, tb, tc_, elems,
                    )
                )
    # dedupe by (ta,tb,tc) keeping min transpose volume; all share (M,N,K)
    best: Dict[Tuple[bool, bool, bool], TTGTPlan] = {}
    for p in plans:
        key = (p.needs_transpose_a, p.needs_transpose_b, p.needs_transpose_c)
        if key not in best or p.transpose_elems < best[key].transpose_elems:
            best[key] = p
    return sorted(best.values(), key=lambda p: p.transpose_elems)


def best_ttgt_plan(problem: Problem) -> TTGTPlan:
    return enumerate_ttgt_plans(problem)[0]


def transpose_cost(plan: TTGTPlan, arch, word_bytes: int = 1) -> Tuple[float, float]:
    """``(cycles, energy_pj)`` of the plan's explicit transposes at the
    outermost memory.

    ``plan.transpose_elems`` already counts one read plus one write per
    relaid-out element (the ``2x`` factor in :func:`enumerate_ttgt_plans`),
    so the element count IS the number of outermost-level accesses:

      * energy -- each access moves ``word_bytes`` at the outermost
        (non-virtual) level; half are reads, half writes;
      * cycles -- the relaid bytes stream through the boundary INTO the
        first real level below the outermost memory, limited by that
        level's fill bandwidth (0 when unbounded).

    The Fig. 8 benchmark adds these to the TTGT GEMM's cost before
    comparing EDP against the native contraction, as this module's header
    documents (`--no-transpose-cost` reproduces the uncosted numbers).
    """
    if plan.transpose_elems <= 0:
        return 0.0, 0.0
    real = [i for i, cl in enumerate(arch.clusters) if not cl.virtual]
    if not real:
        return 0.0, 0.0
    bytes_moved = plan.transpose_elems * word_bytes
    top = arch.clusters[real[0]]
    energy_pj = bytes_moved * (top.read_energy + top.write_energy) / 2.0
    cycles = 0.0
    for i in real[1:]:
        bw = arch.clusters[i].fill_bandwidth
        if not math.isinf(bw):
            cycles = bytes_moved * arch.frequency_hz / bw
            break
    return cycles, energy_pj
