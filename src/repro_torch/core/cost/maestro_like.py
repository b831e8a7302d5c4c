"""MAESTRO-like cluster data-centric cost model (paper Sec. III-B2, [10]).

Operation-level model: only accepts high-level operations it natively
understands (CONV2D / GEMM / DWCONV / TC-as-GEMM tags) -- the
conformability pass enforces this, mirroring the paper's discussion that
MAESTRO consumes operations while Timeloop consumes loop nests.

Differences from the Timeloop-like model (deliberate -- the two models
bracket reality, which is exactly why Union makes them swappable):

  * NoC multicast is an explicit energy term (data-centric reuse): every
    delivered copy pays a hop cost, but multicast reads the source once.
  * Latency is computed per cluster level as (steps x per-step max of
    compute and fill) with a pipeline-startup term -- MAESTRO's
    double-buffered cluster schedule -- instead of a global roofline max.
  * Edge/utilization effects: partial spatial occupancy directly scales
    the per-step compute time.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core.architecture import Architecture
from repro_torch.core.cost.analysis import (
    BATCH_EXACT_LIMIT,
    analyze,
    batch_hierarchical_energy,
    boundary_bytes_per_instance,
    exact_divisor,
    get_context,
    hierarchical_lower_bound,
)
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.cost.energy import ACCEL_45NM_UINT8, EnergyTable
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Problem

_SUPPORTED_OPS = {"CONV2D", "GEMM", "DWCONV", "TC", "ATTN_QK", "ATTN_PV", "SSD"}


class MaestroLikeModel(CostModel):
    name = "maestro_like"

    def __init__(self, energy_table: EnergyTable = ACCEL_45NM_UINT8) -> None:
        self.etab = energy_table

    def conformable(self, problem: Problem) -> bool:
        return problem.operation in _SUPPORTED_OPS and problem.unit_op == "mac2"

    def lower_bound(self, problem: Problem, mapping, arch: Architecture, sig=None):
        return self._calibrate_bound(
            hierarchical_lower_bound(problem, mapping, arch, sig=sig)
        )

    def lower_bound_fn(self, problem: Problem, arch: Architecture):
        fn = get_context(problem, arch).signature_lower_bound
        if self.calibration is None:
            return fn
        return lambda sig: self._calibrate_bound(fn(sig))

    def lower_bound_chains_fn(self, problem: Problem, arch: Architecture):
        fn = get_context(problem, arch).chains_lower_bound
        if self.calibration is None:
            return fn
        # drop the optional (incumbent, scalarize) early-exit hints: they
        # live in CALIBRATED metric space while fn computes raw bounds --
        # computing the full raw bound and scaling it keeps the bound exact
        return lambda chain_list, orders, *_hints: self._calibrate_bound(
            fn(chain_list, orders)
        )

    def lower_bound_batch_fn(self, problem: Problem, arch: Architecture):
        fn = get_context(problem, arch).lower_bound_batch
        if self.calibration is None:
            return fn
        # same final multiply as the scalar ``_calibrate_bound`` per
        # element, so calibrated batch admission stays bit-identical
        s = float(self.calibration.scale)

        def calibrated(*args, **kwargs):
            out = fn(*args, **kwargs)
            if out is None:
                return None
            cyc, en = out
            return cyc * s, en

        return calibrated

    def store_key_parts(self):
        return (self.name, self.etab) + self.calibration_key_parts()

    def batch_cost_terms_fn(self, problem: Problem, arch: Architecture):
        """Array-program twin of ``evaluate_signature``'s latency/energy
        accumulation (double-buffered schedule + startup + NoC delivery
        term): same float-op order per row, in numpy. A
        calibration scale is applied as the final latency multiply,
        exactly as ``apply_calibration`` does on the scalar path. See
        ``CostModel.batch_cost_terms_fn``."""
        if not self.conformable(problem):
            return None
        cal_s = (
            float(self.calibration.scale) if self.calibration is not None else None
        )
        ctx = get_context(problem, arch)
        freq = arch.frequency_hz
        clusters = arch.clusters
        real_levels = ctx.real_levels
        spaces = problem.data_spaces
        num_pes = ctx.num_pes
        hop = self.etab.noc_hop_pj_byte

        def terms(bt, xp):
            cc = bt.compute_cycles
            # par is guarded too: utilization must match the scalar path's
            # exact-int parallelism bit for bit
            mx = xp.maximum(
                xp.maximum(xp.max(cc), xp.max(bt.total_trips)), xp.max(bt.par)
            )
            latency = cc
            startup = xp.zeros_like(cc)
            extras = {"compute_cycles": cc}
            for pos, i in enumerate(real_levels):
                if i == 0:
                    continue
                cl = clusters[i]
                if math.isinf(cl.fill_bandwidth):
                    continue
                total_fill = xp.zeros_like(cc)
                tile_bytes = xp.zeros_like(cc)
                for k, ds in enumerate(spaces):
                    r = bt.rows[k]
                    t = (r.fills[:, pos] + r.drains[:, pos]) * ds.word_bytes
                    mx = xp.maximum(mx, xp.max(t))
                    total_fill = total_fill + t
                    tile_bytes = tile_bytes + r.foot[:, pos] * ds.word_bytes
                mx = xp.maximum(mx, xp.max(tile_bytes))
                valid = total_fill > 0
                bw = exact_divisor(xp, cl.fill_bandwidth)
                fill_cycles = total_fill * freq / bw
                startup = startup + xp.where(
                    valid, tile_bytes * freq / bw, 0.0
                )
                extras[f"fill_cycles::{i}"] = fill_cycles
                extras[f"fill_valid::{i}"] = valid
                latency = xp.where(valid, xp.maximum(latency, fill_cycles), latency)
            latency = latency + startup
            energy, noc_energy, _mac, e_mx = batch_hierarchical_energy(
                ctx, arch, problem, bt, hop_pj_byte=hop, xp=xp
            )
            mx = xp.maximum(mx, e_mx)
            energy = energy + noc_energy
            extras["startup_cycles"] = startup
            extras["noc_energy_pj"] = noc_energy
            util = bt.par / exact_divisor(xp, num_pes)
            if cal_s is not None:
                latency = latency * cal_s
            return latency, energy, util, mx, extras

        return terms

    def costs_from_batch(
        self, problem, arch, latency, energy, util, extras, indices=None
    ):
        ctx = get_context(problem, arch)
        clusters = arch.clusters
        freq = arch.frequency_hz
        cal_s = (
            float(self.calibration.scale) if self.calibration is not None else None
        )
        cc = extras["compute_cycles"]
        fills = [
            (clusters[i].name, extras[f"fill_cycles::{i}"], extras[f"fill_valid::{i}"])
            for i in ctx.real_levels
            if f"fill_cycles::{i}" in extras
        ]
        startup = extras["startup_cycles"]
        noc = extras["noc_energy_pj"]
        rows = range(latency.shape[0]) if indices is None else indices
        out = []
        for b in rows:
            breakdown = {"compute_cycles": float(cc[b])}
            for name, cyc, valid in fills:
                if valid[b]:
                    breakdown[f"fill_cycles_{name}"] = float(cyc[b])
            breakdown["startup_cycles"] = float(startup[b])
            breakdown["noc_energy_pj"] = float(noc[b])
            if cal_s is not None:
                # latency is already scaled inside the terms program; the
                # breakdown records the scale exactly like apply_calibration
                breakdown["calibration_scale"] = cal_s
            out.append(
                Cost(
                    latency_cycles=float(latency[b]),
                    energy_pj=float(energy[b]),
                    utilization=float(util[b]),
                    macs=problem.macs,
                    frequency_hz=freq,
                    breakdown=breakdown,
                )
            )
        return out

    def evaluate_signature(self, problem: Problem, arch: Architecture, sig):
        """Fused signature->Cost path: identical math (and float-operation
        order, so bit-identical results) to ``evaluate``, skipping the
        AccessProfile object assembly."""
        if not self.conformable(problem):
            raise ValueError(
                f"{self.name} only supports operations {_SUPPORTED_OPS}, "
                f"got {problem.operation!r} (unit op {problem.unit_op!r})"
            )
        ctx = get_context(problem, arch)
        compute_cycles, par, inst_at, _tl, _sl, rows = ctx.signature_traffic(sig)
        freq = arch.frequency_hz
        clusters = arch.clusters
        real_levels = ctx.real_levels
        real_parent = ctx.real_parent
        spaces = problem.data_spaces
        leaf = clusters[-1]

        latency = float(compute_cycles)
        breakdown = {"compute_cycles": float(compute_cycles)}
        startup = 0.0
        for pos, i in enumerate(real_levels):
            if i == 0:
                continue
            cl = clusters[i]
            if math.isinf(cl.fill_bandwidth):
                continue
            total_fill = 0.0
            tile_bytes = 0
            for ds_idx, ds in enumerate(spaces):
                r = rows[ds_idx][pos]
                total_fill += (r[0] + r[1]) * ds.word_bytes
                tile_bytes += r[5] * ds.word_bytes
            if total_fill <= 0:
                continue
            fill_cycles = total_fill * freq / cl.fill_bandwidth
            startup += tile_bytes * freq / cl.fill_bandwidth
            breakdown[f"fill_cycles_{cl.name}"] = fill_cycles
            latency = max(latency, fill_cycles)
        latency += startup
        breakdown["startup_cycles"] = startup

        energy = 0.0
        noc_energy = 0.0
        hop = self.etab.noc_hop_pj_byte
        for ds_idx, ds in enumerate(spaces):
            wb = ds.word_bytes
            dsr = rows[ds_idx]
            for pos, i in enumerate(real_levels):
                cl = clusters[i]
                fills, drains, preads, pwrites, inst, _foot = dsr[pos]
                energy += fills * inst * wb * cl.write_energy
                energy += drains * inst * wb * cl.read_energy
                parent_idx = real_parent[i]
                if parent_idx is not None:
                    parent = clusters[parent_idx]
                    n_parent = inst_at[parent_idx]
                    # source reads once per distinct datum (multicast-aware)
                    energy += preads * n_parent * wb * parent.read_energy
                    energy += pwrites * n_parent * wb * parent.write_energy
                    # but every DELIVERED copy pays a NoC hop
                    delivered = (fills + drains) * inst
                    noc_energy += delivered * wb * hop
            energy += ctx.l1_reads[ds.name] * wb * leaf.read_energy
        energy += problem.macs * leaf.mac_energy
        energy += noc_energy
        breakdown["noc_energy_pj"] = noc_energy

        return self.apply_calibration(Cost(
            latency_cycles=latency,
            energy_pj=energy,
            utilization=par / ctx.num_pes,
            macs=problem.macs,
            frequency_hz=freq,
            breakdown=breakdown,
        ))

    def evaluate_signature_batch(
        self,
        problem: Problem,
        arch: Architecture,
        sigs,
        stacked=None,
        select=None,
    ):
        """Vectorized ``evaluate_signature`` over a whole miss-batch (same
        float-operation order per candidate; bit-identical results, with a
        BATCH_EXACT_LIMIT guard that falls back to the scalar path). The
        latency/energy accumulation is ``batch_cost_terms_fn``, run with
        numpy over the admitted subset. ``stacked``/``select``
        reuse the engine's admission-stage StackedBatch (see
        ``CostModel.evaluate_signature_batch``)."""
        if not self.conformable(problem):
            raise ValueError(
                f"{self.name} only supports operations {_SUPPORTED_OPS}, "
                f"got {problem.operation!r} (unit op {problem.unit_op!r})"
            )
        ctx = get_context(problem, arch)
        bt = ctx.signature_traffic_batch(
            sigs, stacked=stacked, select=select
        )
        if bt is None:
            return None
        terms = self.batch_cost_terms_fn(problem, arch)
        latency, energy, util, mx, extras = terms(bt, np)
        if not (float(mx) < BATCH_EXACT_LIMIT):
            return None  # exactness not guaranteed: use the scalar path
        return self.costs_from_batch(problem, arch, latency, energy, util, extras)

    def evaluate(self, problem: Problem, mapping: Mapping, arch: Architecture) -> Cost:
        if not self.conformable(problem):
            raise ValueError(
                f"{self.name} only supports operations {_SUPPORTED_OPS}, "
                f"got {problem.operation!r} (unit op {problem.unit_op!r})"
            )
        prof = analyze(problem, mapping, arch)
        freq = arch.frequency_hz
        leaf = arch.clusters[-1]

        # ----- latency: per-level double-buffered schedule ---------------- #
        # steady-state per-outer-step time = max(compute chunk, fill chunk);
        # plus one pipeline-startup fill of the first tile at every level.
        compute_cycles = prof.compute_cycles
        latency = float(compute_cycles)
        breakdown = {"compute_cycles": float(compute_cycles)}
        startup = 0.0
        for i, cl in enumerate(arch.clusters):
            if cl.virtual or i == 0 or math.isinf(cl.fill_bandwidth):
                continue
            total_fill = boundary_bytes_per_instance(prof, problem, i)
            if total_fill <= 0:
                continue
            fill_cycles = total_fill * freq / cl.fill_bandwidth
            # first-tile startup: one tile's worth of fill is exposed
            tile_bytes = sum(
                prof.traffic[(ds.name, i)].tile_elems * ds.word_bytes
                for ds in problem.data_spaces
                if (ds.name, i) in prof.traffic
            )
            startup += tile_bytes * freq / cl.fill_bandwidth
            breakdown[f"fill_cycles_{cl.name}"] = fill_cycles
            latency = max(latency, fill_cycles)
        latency += startup
        breakdown["startup_cycles"] = startup

        # ----- energy: buffer accesses + NoC delivery hops ---------------- #
        energy = 0.0
        noc_energy = 0.0
        for ds in problem.data_spaces:
            wb = ds.word_bytes
            for i, cl in enumerate(arch.clusters):
                lt = prof.traffic.get((ds.name, i))
                if lt is None:
                    continue
                parent_idx = prof.real_parent[i]
                energy += lt.fills_per_instance * lt.instances * wb * cl.write_energy
                energy += lt.drains_per_instance * lt.instances * wb * cl.read_energy
                if parent_idx is not None:
                    parent = arch.clusters[parent_idx]
                    n_parent = prof.instances_at[parent_idx]
                    # source reads once per distinct datum (multicast-aware)
                    energy += lt.parent_reads * n_parent * wb * parent.read_energy
                    energy += lt.parent_writes * n_parent * wb * parent.write_energy
                    # but every DELIVERED copy pays a NoC hop
                    delivered = (lt.fills_per_instance + lt.drains_per_instance) * lt.instances
                    noc_energy += delivered * wb * self.etab.noc_hop_pj_byte
            energy += prof.l1_reads[ds.name] * wb * arch.clusters[-1].read_energy
        energy += problem.macs * leaf.mac_energy
        energy += noc_energy
        breakdown["noc_energy_pj"] = noc_energy

        return self.apply_calibration(Cost(
            latency_cycles=latency,
            energy_pj=energy,
            utilization=prof.utilization,
            macs=problem.macs,
            frequency_hz=freq,
            breakdown=breakdown,
        ))
