"""Timeloop-like hierarchical cost model (paper Sec. III-B2, [11]).

Loop-level model: accepts any Problem whose data spaces are affine
projections of a perfectly-nested loop iteration space (which is every
``Problem`` built by this repo's IR -- the conformability pass rejects
anything else, e.g. a unit-op mismatch).

Latency: perfect double buffering -- max(compute, per-level fill time).
Energy:  per-level access counts x per-byte access energies + MAC energy.
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
    generic_hierarchical_energy,
    get_context,
    hierarchical_lower_bound,
)
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Problem


class TimeloopLikeModel(CostModel):
    name = "timeloop_like"

    def __init__(self, unit_op: str = "mac2") -> None:
        self.unit_op = unit_op

    def conformable(self, problem: Problem) -> bool:
        # loop-level: needs an affine perfectly-nested loop body whose unit
        # operation matches the energy model configuration (paper: MTTKRP is
        # rejected under a mac2-configured model but fine under mac3).
        return problem.unit_op == self.unit_op

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

    def batch_admit_core_builder(self, problem: Problem, arch: Architecture):
        builder = get_context(problem, arch)._make_lb_core
        if self.calibration is None:
            return builder
        s = float(self.calibration.scale)

        def calibrated_builder(xp):
            core = builder(xp)

            def calibrated_core(tt, st, perm):
                cyc, en, mx = core(tt, st, perm)
                return cyc * s, en, mx

            return calibrated_core

        return calibrated_builder

    def store_key_parts(self):
        return (self.name, self.unit_op) + self.calibration_key_parts()

    def batch_cost_terms_fn(self, problem: Problem, arch: Architecture):
        """Array-program twin of ``evaluate_signature``'s latency/energy
        accumulation: same float-operation order per row, runnable with
        numpy (host scoring) or the torch namespace (inside the fused device
        core). A calibration scale is applied as the final latency
        multiply, exactly as ``apply_calibration`` does on the scalar
        path. See ``CostModel.batch_cost_terms_fn``."""
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

        def terms(bt, xp):
            cc = bt.compute_cycles
            # par is guarded too: utilization must match the scalar path's
            # exact-int parallelism bit for bit
            mx = xp.maximum(
                xp.maximum(xp.max(cc), xp.max(bt.total_trips)), xp.max(bt.par)
            )
            worst = xp.zeros_like(cc)
            extras = {"compute_cycles": cc}
            for pos, i in enumerate(real_levels):
                cl = clusters[i]
                # the scalar path computes bts before skipping these levels
                # but never uses it; skipping first is value-identical (the
                # fills/drains factors are exactness-guarded in the energy
                # walk below)
                if i == 0 or math.isinf(cl.fill_bandwidth):
                    continue
                bts = xp.zeros_like(cc)
                for k, ds in enumerate(spaces):
                    t = (
                        bt.rows[k].fills[:, pos] + bt.rows[k].drains[:, pos]
                    ) * ds.word_bytes
                    mx = xp.maximum(mx, xp.max(t))
                    bts = bts + t
                cyc = bts * freq / exact_divisor(xp, cl.fill_bandwidth)
                extras[f"bw_cycles::{i}"] = cyc
                extras[f"bw_bytes::{i}"] = bts
                worst = xp.maximum(worst, xp.where(bts > 0, cyc, 0.0))
            latency = xp.maximum(cc, worst)
            energy, _noc, _mac, e_mx = batch_hierarchical_energy(
                ctx, arch, problem, bt, xp=xp
            )
            mx = xp.maximum(mx, e_mx)
            util = bt.par / exact_divisor(xp, num_pes)
            if cal_s is not None:
                latency = latency * cal_s
            return latency, energy, util, mx, extras

        return terms

    def batch_cost_terms_generic(self, problem: Problem, arch: Architecture):
        """Shape-generic twin of :meth:`batch_cost_terms_fn` (see
        ``CostModel.batch_cost_terms_generic``): structure = which real
        levels carry a finite-bandwidth fill term; every value (bandwidths,
        energies, word widths, calibration) rides in the parameter pack."""
        if not self.conformable(problem):
            return None
        ctx = get_context(problem, arch)
        clusters = arch.clusters
        real_levels = list(ctx.real_levels)
        real_parent = [-1 if p is None else p for p in ctx.real_parent]
        K = len(problem.data_spaces)
        bw_levels = tuple(
            (pos, i)
            for pos, i in enumerate(real_levels)
            if not (i == 0 or math.isinf(clusters[i].fill_bandwidth))
        )
        leaf = clusters[-1]
        cal = self.calibration
        model_key = (self.name, self.unit_op, bw_levels)
        model_params = {
            "tl_bw": np.asarray(
                [clusters[i].fill_bandwidth for _pos, i in bw_levels],
                dtype=np.float64,
            ),
            "num_pes": np.float64(ctx.num_pes),
            "lvl_read_e": np.asarray(
                [c.read_energy for c in clusters], dtype=np.float64
            ),
            "lvl_write_e": np.asarray(
                [c.write_energy for c in clusters], dtype=np.float64
            ),
            # innermost-operand terms precomputed host-side with Python
            # semantics (int products are exact; one final float multiply)
            "l1_terms": np.asarray(
                [
                    ctx.l1_reads[ds.name] * ds.word_bytes * leaf.read_energy
                    for ds in problem.data_spaces
                ],
                dtype=np.float64,
            ),
            "mac_term": np.float64(problem.macs * leaf.mac_energy),
            "calib_scale": np.float64(cal.scale) if cal is not None else np.float64(1.0),
        }

        def terms(bt, xp, p):
            cc = bt.compute_cycles
            mx = xp.maximum(
                xp.maximum(xp.max(cc), xp.max(bt.total_trips)), xp.max(bt.par)
            )
            worst = xp.zeros_like(cc)
            extras = {"compute_cycles": cc}
            for t, (pos, i) in enumerate(bw_levels):
                bts = xp.zeros_like(cc)
                for k in range(K):
                    tk = (
                        bt.rows[k].fills[:, pos] + bt.rows[k].drains[:, pos]
                    ) * p["wb"][k]
                    mx = xp.maximum(mx, xp.max(tk))
                    bts = bts + tk
                cyc = bts * p["freq"] / exact_divisor(xp, p["tl_bw"][t])
                extras[f"bw_cycles::{i}"] = cyc
                extras[f"bw_bytes::{i}"] = bts
                worst = xp.maximum(worst, xp.where(bts > 0, cyc, 0.0))
            latency = xp.maximum(cc, worst)
            energy, _noc, e_mx = generic_hierarchical_energy(
                real_levels, real_parent, K, bt, xp, p
            )
            mx = xp.maximum(mx, e_mx)
            util = bt.par / exact_divisor(xp, p["num_pes"])
            return latency, energy, util, mx, extras

        return model_key, model_params, terms

    def costs_from_batch(
        self, problem, arch, latency, energy, util, extras, indices=None
    ):
        ctx = get_context(problem, arch)
        clusters = arch.clusters
        freq = arch.frequency_hz
        cal_s = (
            float(self.calibration.scale) if self.calibration is not None else None
        )
        mac_term = problem.macs * clusters[-1].mac_energy
        cc = extras["compute_cycles"]
        bw = [
            (clusters[i].name, extras[f"bw_cycles::{i}"], extras[f"bw_bytes::{i}"])
            for i in ctx.real_levels
            if f"bw_cycles::{i}" in extras
        ]
        rows = range(latency.shape[0]) if indices is None else indices
        out = []
        for b in rows:
            breakdown = {"compute_cycles": float(cc[b])}
            for name, cyc, bts in bw:
                if bts[b] > 0:
                    breakdown[f"bw_cycles_{name}"] = float(cyc[b])
            breakdown["energy_mac_pj"] = mac_term
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
                f"{self.name} configured with unit op {self.unit_op!r} cannot "
                f"evaluate problem with unit op {problem.unit_op!r}"
            )
        ctx = get_context(problem, arch)
        compute_cycles, par, inst_at, _tl, _sl, rows = ctx.signature_traffic(sig)
        freq = arch.frequency_hz
        clusters = arch.clusters
        real_levels = ctx.real_levels
        real_parent = ctx.real_parent
        spaces = problem.data_spaces

        worst_bw_cycles = 0.0
        breakdown = {"compute_cycles": compute_cycles}
        for pos, i in enumerate(real_levels):
            if i == 0:
                continue
            cl = clusters[i]
            bts = 0.0
            for ds_idx, ds in enumerate(spaces):
                r = rows[ds_idx][pos]
                bts += (r[0] + r[1]) * ds.word_bytes
            if bts <= 0 or math.isinf(cl.fill_bandwidth):
                continue
            cyc = bts * freq / cl.fill_bandwidth
            breakdown[f"bw_cycles_{cl.name}"] = cyc
            worst_bw_cycles = max(worst_bw_cycles, cyc)
        latency = max(compute_cycles, worst_bw_cycles)

        energy = 0.0
        leaf = clusters[-1]
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
                    energy += preads * n_parent * wb * parent.read_energy
                    energy += pwrites * n_parent * wb * parent.write_energy
            energy += ctx.l1_reads[ds.name] * wb * leaf.read_energy
        energy += problem.macs * leaf.mac_energy
        breakdown["energy_mac_pj"] = problem.macs * leaf.mac_energy

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
        backend: str = "numpy",
        stacked=None,
        select=None,
        device=None,
    ):
        """Vectorized ``evaluate_signature`` over a whole miss-batch: same
        float-operation order per candidate, so results are bit-identical
        whenever every integer-valued product stays float64-exact (checked
        against BATCH_EXACT_LIMIT; returns None otherwise). The latency/
        energy accumulation is the SAME array program the fused
        single-dispatch device path runs (``batch_cost_terms_fn``), run here
        with numpy over the admitted subset. ``stacked``/``select`` reuse
        the engine's admission-stage StackedBatch (see
        ``CostModel.evaluate_signature_batch``)."""
        if not self.conformable(problem):
            raise ValueError(
                f"{self.name} configured with unit op {self.unit_op!r} cannot "
                f"evaluate problem with unit op {problem.unit_op!r}"
            )
        ctx = get_context(problem, arch)
        bt = ctx.signature_traffic_batch(
            sigs, backend=backend, stacked=stacked, select=select, device=device
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
                f"{self.name} configured with unit op {self.unit_op!r} cannot "
                f"evaluate problem with unit op {problem.unit_op!r}"
            )
        prof = analyze(problem, mapping, arch)
        freq = arch.frequency_hz

        # ---------------- latency: compute vs per-level bandwidth ------- #
        compute_cycles = prof.compute_cycles
        worst_bw_cycles = 0.0
        breakdown = {"compute_cycles": compute_cycles}
        for i, cl in enumerate(arch.clusters):
            if cl.virtual or i == 0:
                continue
            bts = boundary_bytes_per_instance(prof, problem, i)
            if bts <= 0 or math.isinf(cl.fill_bandwidth):
                continue
            cyc = bts * freq / cl.fill_bandwidth
            breakdown[f"bw_cycles_{cl.name}"] = cyc
            worst_bw_cycles = max(worst_bw_cycles, cyc)
        latency = max(compute_cycles, worst_bw_cycles)

        # ---------------- energy ---------------------------------------- #
        energy = 0.0
        for ds in problem.data_spaces:
            for i, cl in enumerate(arch.clusters):
                lt = prof.traffic.get((ds.name, i))
                if lt is None:
                    continue
                parent_idx = prof.real_parent[i]
                wb = ds.word_bytes
                # writes into this buffer + reads back out of it on drain
                energy += lt.fills_per_instance * lt.instances * wb * cl.write_energy
                energy += lt.drains_per_instance * lt.instances * wb * cl.read_energy
                if parent_idx is not None:
                    parent = arch.clusters[parent_idx]
                    n_parent = prof.instances_at[parent_idx]
                    # parent_reads/writes are per-parent-instance counts with
                    # ideal multicast (irrelevant spatial splits read once)
                    energy += lt.parent_reads * n_parent * wb * parent.read_energy
                    energy += lt.parent_writes * n_parent * wb * parent.write_energy
            # innermost operand movement (L1 -> MAC datapath)
            leaf = arch.clusters[-1]
            energy += prof.l1_reads[ds.name] * ds.word_bytes * leaf.read_energy
        energy += problem.macs * arch.clusters[-1].mac_energy
        breakdown["energy_mac_pj"] = problem.macs * arch.clusters[-1].mac_energy

        return self.apply_calibration(Cost(
            latency_cycles=latency,
            energy_pj=energy,
            utilization=prof.utilization,
            macs=problem.macs,
            frequency_hz=freq,
            breakdown=breakdown,
        ))
