"""TPU v5e three-term roofline cost model (the port's copy of the
reference package's ``tpu_roofline``).

Terms (in seconds, per chip), on the TPU v5e constants of
``architecture.TPU_V5E`` (or the arch's own ``attrs``):

  compute    = FLOPs_per_chip / peak_bf16_flops
  memory     = HBM_bytes_per_chip / hbm_bw
  collective = ici_bytes_per_chip / ici_link_bw  (ring-discounted per collective)

This is a cost model of a TPU-like accelerator in Union's library of
models, which the mappers can search against like any other. It is not a
model of the H100 and no number it gives is a measurement of any card.

``TPURooflineModel.evaluate`` scores a (Problem, Mapping) pair: HBM
traffic from the shared reuse analysis, collective traffic inferred from
which mesh-level spatial splits are relevant/irrelevant/reduction for each
data space; ``RooflineReport`` holds the three terms of one cell.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.core.architecture import Architecture, TPU_V5E
from repro_torch.core.cost.analysis import (
    BATCH_EXACT_LIMIT,
    analyze,
    astype,
    batch_projection_footprint,
    boundary_bytes_per_instance,
    device_index,
    device_scalar,
    exact_divisor,
    get_context,
)
from repro_torch.core.cost.base import Cost, CostModel
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Problem

MESH_AXES = ("pod", "data", "model")


@dataclass
class RooflineReport:
    """The §Roofline record for one (arch x shape x mesh) cell."""

    name: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_total: float = 0.0
    peak_flops: float = TPU_V5E["peak_bf16_flops"]
    hbm_bw: float = TPU_V5E["hbm_bw"]
    link_bw: float = TPU_V5E["ici_link_bw"]
    extras: Dict[str, float] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / self.link_bw

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic fully-overlapped step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs: how much compiled compute is 'useful'."""
        total_hlo = self.flops_per_chip * self.chips
        return self.model_flops_total / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization at the optimistic step time (MFU bound)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops_total / (t * self.chips * self.peak_flops)

    def row(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_time_s,
            "useful_flops_frac": self.useful_flops_fraction,
            "roofline_frac": self.roofline_fraction,
        }

    @staticmethod
    def from_artifact(name: str, art: Dict) -> "RooflineReport":
        """Build from a dry-run artifact dict, read as JSON: the port's
        ``launch/dryrun.py`` output (``experiments/torch/dryrun``) or the
        reference's.

        Prefers the ``corrected`` costs (the reference's scan bodies x trip
        count; the port traces every unit and stores its counts there);
        raw cost_analysis numbers are the fallback for artifacts produced
        without the correction pass.
        """
        src = art.get("corrected", art)
        return RooflineReport(
            name=name,
            chips=int(art["chips"]),
            flops_per_chip=float(src["flops_per_device"]),
            hbm_bytes_per_chip=float(src["bytes_per_device"]),
            collective_bytes_per_chip=float(src["collective_bytes_per_device"]),
            model_flops_total=float(art.get("model_flops", 0.0)),
            extras={k: float(v) for k, v in art.get("extras", {}).items()},
        )


class TPURooflineModel(CostModel):
    """Analytic three-term roofline over (Problem, Mapping) on a TPU arch."""

    name = "tpu_roofline"

    def lower_bound(self, problem: Problem, mapping, arch: Architecture, sig=None):
        """(cycles, energy_pj) floor: perfect chip scaling + compulsory VMEM
        traffic; energy floor is the MAC term alone."""
        from repro_torch.core.mapping import mapping_signature

        ctx = get_context(problem, arch)
        if sig is None:
            sig = mapping_signature(mapping, ctx.dims)
        peak = float(arch.attrs.get("peak_bf16_flops", TPU_V5E["peak_bf16_flops"]))
        hbm_bw = float(arch.attrs.get("hbm_bw", TPU_V5E["hbm_bw"]))
        chips = 1
        for cl in arch.clusters:
            if cl.dimension in MESH_AXES and cl.fanout > 1:
                chips *= cl.fanout
        compute_s = 2.0 * problem.macs / max(1, chips) / peak
        vmem_level = arch.n_levels - 1
        memory_s = 0.0
        if vmem_level in ctx.real_levels:
            memory_s = ctx.signature_min_boundary_bytes(sig, vmem_level) / hbm_bw
        cycles = max(compute_s, memory_s) * arch.frequency_hz
        energy = problem.macs * arch.clusters[-1].mac_energy
        return self._calibrate_bound((cycles, energy))

    def batch_admit_core_builder(self, problem: Problem, arch: Architecture):
        """Array-generic form of the roofline admission bound (perfect chip
        scaling + compulsory VMEM traffic): an ``xp -> core`` builder whose
        ``core(tt, st, perm)`` reproduces ``lower_bound`` per row
        bit-for-bit with numpy or inside the fused device program. A
        calibration scale is applied to the cycles as the same final
        multiply the scalar ``_calibrate_bound`` performs."""
        cal_s = (
            float(self.calibration.scale) if self.calibration is not None else None
        )
        ctx = get_context(problem, arch)
        peak = float(arch.attrs.get("peak_bf16_flops", TPU_V5E["peak_bf16_flops"]))
        hbm_bw = float(arch.attrs.get("hbm_bw", TPU_V5E["hbm_bw"]))
        chips = 1
        for cl in arch.clusters:
            if cl.dimension in MESH_AXES and cl.fanout > 1:
                chips *= cl.fanout
        compute_s = 2.0 * problem.macs / max(1, chips) / peak
        vmem_level = arch.n_levels - 1
        vmem_real = vmem_level in ctx.real_levels
        freq = arch.frequency_hz
        energy_const = problem.macs * arch.clusters[-1].mac_energy
        axes_info = ctx.ds_projection_axes

        def build(xp):
            def core(tt, st, perm):
                B = tt.shape[0]
                mx = xp.zeros(())
                memory_s = xp.zeros(B, dtype=xp.float64)
                if vmem_real:
                    ttf = astype(xp, xp.maximum(tt[:, vmem_level, :], 1), xp.float64)
                    total = xp.zeros(B, dtype=xp.float64)
                    for wb, axes, _rel in axes_info:
                        t = batch_projection_footprint(axes, ttf, xp) * wb
                        mx = xp.maximum(mx, xp.max(t))
                        total = total + t
                    memory_s = total / exact_divisor(xp, hbm_bw)
                cycles = xp.maximum(compute_s, memory_s) * freq
                if cal_s is not None:
                    cycles = cycles * cal_s
                return cycles, xp.full(B, energy_const, dtype=xp.float64), mx

            return core

        return build

    def lower_bound_batch_fn(self, problem: Problem, arch: Architecture):
        """Vectorized ``lower_bound``: one array program reproduces the
        scalar bound (perfect chip scaling + compulsory VMEM traffic) for
        a whole stacked batch, bit-identically -- or returns None beyond
        the float64-exact range so the engine falls back per candidate.
        Runs the same core the fused device path runs, with numpy (the
        admit core already carries the calibration multiply), on either
        engine backend, as the reference does."""
        ctx = get_context(problem, arch)
        core = self.batch_admit_core_builder(problem, arch)(np)

        def lb_batch(sigs=None, backend: str = "numpy", stacked=None, device=None):
            sb = stacked
            if sb is None:
                if not sigs:
                    return None
                sb = ctx.stacked_batch(sigs)
            if sb.size == 0:
                return None
            cycles, energy, mx = core(sb.tt, sb.st, sb.perm)
            if not (float(mx) < BATCH_EXACT_LIMIT):
                return None
            return cycles, energy

        return lb_batch

    def batch_cost_terms_fn(self, problem: Problem, arch: Architecture):
        """Array-program twin of ``evaluate``'s three-term roofline: VMEM
        boundary traffic from the shared batch analysis, chip utilization
        and collective terms from the stacked fan/tile matrices. Same
        float-operation order per row as ``evaluate``; a
        calibration scale is applied as the final latency multiply, exactly
        as ``apply_calibration`` does on the scalar path. See
        ``CostModel.batch_cost_terms_fn``."""
        cal_s = (
            float(self.calibration.scale) if self.calibration is not None else None
        )
        ctx = get_context(problem, arch)
        peak = float(arch.attrs.get("peak_bf16_flops", TPU_V5E["peak_bf16_flops"]))
        hbm_bw = float(arch.attrs.get("hbm_bw", TPU_V5E["hbm_bw"]))
        link_bw = float(arch.attrs.get("ici_link_bw", TPU_V5E["ici_link_bw"]))
        freq = arch.frequency_hz
        mac_term = problem.macs * arch.clusters[-1].mac_energy
        num_pes = max(1, arch.num_pes)
        chips = 1
        mesh_levels = []
        for i, cl in enumerate(arch.clusters):
            if cl.dimension in MESH_AXES and cl.fanout > 1:
                chips *= cl.fanout
                mesh_levels.append(i)
        vmem_level = arch.n_levels - 1
        vmem_real = vmem_level in ctx.real_levels
        pos_v = ctx.real_levels.index(vmem_level) if vmem_real else -1
        red = set(problem.reduction_dims())
        red_idx = np.asarray(
            [j for j, d in enumerate(ctx.dims) if d in red], dtype=np.int64
        )
        axes_info = ctx.ds_projection_axes
        ds_out = [ds.is_output for ds in problem.data_spaces]
        word_bytes = [ds.word_bytes for ds in problem.data_spaces]

        def terms(bt, xp):
            B = bt.compute_cycles.shape[0]
            # par is guarded too: utilization must match the scalar path's
            # exact-int parallelism bit for bit
            mx = xp.maximum(xp.max(bt.total_trips), xp.max(bt.par))

            fansf = astype(xp, bt.fans, xp.float64)
            lvl_par = xp.prod(fansf, axis=2)  # [B, n_levels]
            used_chips = xp.ones(B)
            for i in mesh_levels:
                if i > 0:
                    used_chips = used_chips * lvl_par[:, i - 1]
            used_chips = xp.maximum(1.0, xp.minimum(float(chips), used_chips))
            # a device scalar over a tensor: torch's ``float / tensor`` is
            # ``reciprocal(tensor) * float``, not IEEE division
            flops_per_chip = device_scalar(xp, 2.0 * problem.macs) / used_chips
            compute_s = flops_per_chip / exact_divisor(xp, peak)

            hbm_bytes = xp.zeros(B)
            if vmem_real:
                for k in range(len(axes_info)):
                    r = bt.rows[k]
                    t = (r.fills[:, pos_v] + r.drains[:, pos_v]) * word_bytes[k]
                    mx = xp.maximum(mx, xp.max(t))
                    hbm_bytes = hbm_bytes + t
            memory_s = hbm_bytes / exact_divisor(xp, hbm_bw)

            coll_bytes = xp.zeros(B)
            for i in mesh_levels:
                lvl = i - 1  # mapping level distributing over this mesh axis
                if lvl < 0:
                    continue
                f = bt.fans[:, lvl, :]
                n_arr = lvl_par[:, lvl]
                has_split = n_arr > 1
                split_red = (
                    xp.any(f[:, device_index(xp, red_idx)] > 1, axis=1)
                    if red_idx.size
                    else xp.zeros(B, dtype=bool)
                )
                stf = astype(xp, bt.st[:, lvl, :], xp.float64)
                for k, (wb, axes, rel_idx) in enumerate(axes_info):
                    shard = xp.ones(B)
                    for ax in axes:
                        span = xp.ones(B)
                        for coeff, j in ax:
                            span = span + coeff * (stf[:, j] - 1.0)
                        shard = shard * span
                    mx = xp.maximum(mx, xp.max(shard))
                    if ds_out[k]:
                        cond = has_split & split_red
                        term = 2.0 * (n_arr - 1.0) / n_arr * shard * wb
                    else:
                        split_rel = (
                            xp.any(f[:, device_index(xp, rel_idx)] > 1, axis=1)
                            if rel_idx
                            else xp.zeros(B, dtype=bool)
                        )
                        cond = has_split & ~split_rel
                        term = (n_arr - 1.0) / n_arr * shard * wb
                    coll_bytes = coll_bytes + xp.where(cond, term, 0.0)
            collective_s = coll_bytes / exact_divisor(xp, link_bw)

            latency_s = xp.maximum(compute_s, xp.maximum(memory_s, collective_s))
            energy_pj = (
                hbm_bytes * used_chips * 7.0 + coll_bytes * used_chips * 2.0 + mac_term
            )
            util = bt.par / exact_divisor(xp, num_pes)
            bound_idx = xp.argmax(
                xp.stack([compute_s, memory_s, collective_s]), axis=0
            )
            extras = {
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": collective_s,
                "bound": bound_idx,
            }
            latency = latency_s * freq
            if cal_s is not None:
                latency = latency * cal_s
            return latency, energy_pj, util, mx, extras

        return terms

    def costs_from_batch(
        self, problem, arch, latency, energy, util, extras, indices=None
    ):
        freq = arch.frequency_hz
        cal_s = (
            float(self.calibration.scale) if self.calibration is not None else None
        )
        rows = range(latency.shape[0]) if indices is None else indices
        out = []
        for b in rows:
            breakdown = {
                "compute_s": float(extras["compute_s"][b]),
                "memory_s": float(extras["memory_s"][b]),
                "collective_s": float(extras["collective_s"][b]),
                "bound": float(extras["bound"][b]),
            }
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
        """Vectorized ``evaluate`` over a miss-batch of signatures:
        ``batch_cost_terms_fn``, run with numpy over the admitted
        subset. Same float-operation order per candidate as ``evaluate``
        (bit-identical; BATCH_EXACT_LIMIT guard falls back to the scalar
        path). ``stacked``/``select`` reuse the engine's admission-stage
        StackedBatch (see ``CostModel.evaluate_signature_batch``)."""
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
        prof = analyze(problem, mapping, arch)
        peak = float(arch.attrs.get("peak_bf16_flops", TPU_V5E["peak_bf16_flops"]))
        hbm_bw = float(arch.attrs.get("hbm_bw", TPU_V5E["hbm_bw"]))
        link_bw = float(arch.attrs.get("ici_link_bw", TPU_V5E["ici_link_bw"]))

        # chips = product of fanouts at mesh-axis levels
        chips = 1
        mesh_levels = []
        for i, cl in enumerate(arch.clusters):
            if cl.dimension in MESH_AXES and cl.fanout > 1:
                chips *= cl.fanout
                mesh_levels.append(i)

        # compute term: FLOPs divide evenly over the chips actually used
        used_chips = 1
        for i in mesh_levels:
            # parallelism expressed at the mapping level whose children are
            # the mesh level's instances (= level i-1 in list order)
            used_chips *= mapping.parallelism(i - 1, problem) if i > 0 else 1
        used_chips = max(1, min(chips, used_chips))
        flops_per_chip = 2.0 * problem.macs / used_chips
        compute_s = flops_per_chip / peak

        # memory term: traffic into the innermost real buffer (VMEM) per chip
        vmem_level = arch.n_levels - 1
        hbm_bytes = boundary_bytes_per_instance(prof, problem, vmem_level)
        memory_s = hbm_bytes / hbm_bw

        # collective term from mesh-level spatial splits
        coll_bytes = 0.0
        for i in mesh_levels:
            lvl = i - 1  # mapping level that distributes over this mesh axis
            if lvl < 0:
                continue
            fan = mapping.spatial_fanout(lvl, problem)
            split = {d: f for d, f in fan.items() if f > 1}
            if not split:
                continue
            n = math.prod(split.values())
            red = set(problem.reduction_dims())
            tile = mapping.outer_spatial_tile(lvl + 1, problem)
            for ds in problem.data_spaces:
                rel = set(ds.dims)
                shard = ds.footprint(tile)
                if ds.is_output:
                    if any(d in red for d in split):
                        # partial sums all-reduced: ring = 2*(n-1)/n * bytes
                        coll_bytes += 2.0 * (n - 1) / n * shard * ds.word_bytes
                else:
                    if not any(d in rel for d in split):
                        # replicated input must be broadcast: all-gather
                        coll_bytes += (n - 1) / n * shard * ds.word_bytes
        collective_s = coll_bytes / link_bw

        latency_s = max(compute_s, memory_s, collective_s)
        freq = arch.frequency_hz
        rep = RooflineReport(
            name=problem.name, chips=chips,
            flops_per_chip=flops_per_chip, hbm_bytes_per_chip=hbm_bytes,
            collective_bytes_per_chip=coll_bytes,
            model_flops_total=2.0 * problem.macs,
            peak_flops=peak, hbm_bw=hbm_bw, link_bw=link_bw,
        )
        # energy: rough HBM+ICI+MAC (used only for EDP-style ranking on TPU)
        energy_pj = (
            hbm_bytes * used_chips * 7.0
            + coll_bytes * used_chips * 2.0
            + problem.macs * arch.clusters[-1].mac_energy
        )
        return self.apply_calibration(Cost(
            latency_cycles=latency_s * freq,
            energy_pj=energy_pj,
            utilization=mapping.utilization(problem, arch),
            macs=problem.macs,
            frequency_hz=freq,
            breakdown={
                "compute_s": compute_s,
                "memory_s": memory_s,
                "collective_s": collective_s,
                "bound": {"compute": 0.0, "memory": 1.0, "collective": 2.0}[rep.bound],
            },
        ))
