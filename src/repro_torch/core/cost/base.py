"""Cost model interface + result record."""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.architecture import Architecture
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Problem


@dataclass
class Cost:
    """Result of evaluating one mapping on one architecture."""

    latency_cycles: float
    energy_pj: float
    utilization: float
    macs: int
    frequency_hz: float
    breakdown: Dict[str, float] = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        return self.latency_cycles / self.frequency_hz

    @property
    def energy_j(self) -> float:
        return self.energy_pj * 1e-12

    @property
    def edp(self) -> float:
        """Energy-Delay Product in J*s (paper's headline metric)."""
        return self.energy_j * self.latency_s

    def metric(self, name: str) -> float:
        if name == "latency":
            return self.latency_cycles
        if name == "energy":
            return self.energy_pj
        if name == "edp":
            return self.edp
        raise ValueError(f"unknown metric {name!r}")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Cost(cycles={self.latency_cycles:.3g}, E={self.energy_pj:.3g}pJ, "
            f"EDP={self.edp:.3g}Js, util={self.utilization:.2%})"
        )


class CostModel(abc.ABC):
    """Every cost model: conformability check + evaluate (+ lower bound).

    **Calibration hook.** A model may carry an optional calibration (a
    measured-vs-modeled latency scale produced by
    ``repro_torch.codesign.calibrate``; any object with a positive-float
    ``scale`` and a ``key_parts()`` tuple works). A calibrated model
    multiplies every latency prediction by that scale as the FINAL
    operation of EVERY path -- scalar (``evaluate``,
    ``evaluate_signature``, the ``lower_bound*`` family) and vectorized
    (``lower_bound_batch_fn``, ``batch_admit_core_builder``,
    ``batch_cost_terms_fn``, ``evaluate_signature_batch``,
    ``batch_cost_terms_generic``) alike. A uniform positive final
    multiply keeps the admission invariant (bound <= evaluate, since
    IEEE multiply by the same positive factor is monotone) and never
    changes which mapping is argmin; and because the batch paths apply
    the IDENTICAL final ``latency * scale`` per element, the calibrated
    batch results stay bit-identical to the calibrated scalar path
    (same two float64 operands, same single rounding). The shape-generic
    path takes the scale as a parameter (1.0 when uncalibrated --
    ``x * 1.0`` is IEEE-exact), so one program serves every
    calibration value. ``store_key_parts()`` includes
    ``calibration_key_parts()``, so calibrated and raw results never
    alias in a ResultStore.
    """

    name: str = "base"
    #: optional calibration scale (None = raw model, byte-identical to
    #: the pre-calibration behavior); set via :meth:`set_calibration`
    calibration = None

    @abc.abstractmethod
    def evaluate(self, problem: Problem, mapping: Mapping, arch: Architecture) -> Cost:
        ...

    # ------------------------------------------------------------------ #
    # calibration
    # ------------------------------------------------------------------ #
    def set_calibration(self, calibration) -> "CostModel":
        """Attach (or with None, remove) a calibration; returns self for
        chaining: ``TimeloopLikeModel().set_calibration(scale)``."""
        if calibration is not None:
            s = float(calibration.scale)
            if not (s > 0.0 and math.isfinite(s)):
                raise ValueError(
                    f"calibration scale must be finite and positive, got {s!r}"
                )
            calibration.key_parts()  # fail fast on a malformed object
        self.calibration = calibration
        return self

    @property
    def calibration_scale(self) -> float:
        """The latency multiplier in effect (1.0 when uncalibrated)."""
        return float(self.calibration.scale) if self.calibration is not None else 1.0

    def calibration_key_parts(self) -> "tuple":
        """Store-key suffix identifying the active calibration (empty when
        uncalibrated, so raw-model keys are unchanged by this feature)."""
        if self.calibration is None:
            return ()
        return tuple(self.calibration.key_parts())

    def apply_calibration(self, cost: Cost) -> Cost:
        """Rescale a raw Cost's latency by the calibration scale (identity
        when uncalibrated -- the raw object passes through untouched). The
        scale is recorded in the breakdown for provenance."""
        if self.calibration is None:
            return cost
        s = float(self.calibration.scale)
        breakdown = dict(cost.breakdown)
        breakdown["calibration_scale"] = s
        return Cost(
            latency_cycles=cost.latency_cycles * s,
            energy_pj=cost.energy_pj,
            utilization=cost.utilization,
            macs=cost.macs,
            frequency_hz=cost.frequency_hz,
            breakdown=breakdown,
        )

    def _calibrate_bound(self, bound: "tuple[float, float]") -> "tuple[float, float]":
        """Apply the calibration scale to a ``(cycles, energy_pj)`` lower
        bound -- same final multiply as :meth:`apply_calibration`, so the
        admission invariant (bound <= evaluate) survives calibration."""
        if self.calibration is None:
            return bound
        cycles, energy = bound
        return cycles * float(self.calibration.scale), energy

    def lower_bound(
        self,
        problem: Problem,
        mapping: Optional[Mapping],
        arch: Architecture,
        sig=None,
    ) -> "tuple[float, float]":
        """Cheap ``(latency_cycles, energy_pj)`` lower bounds for a mapping.

        Must be computable from the tile chain alone (no reuse analysis)
        and must never exceed the corresponding ``evaluate`` results -- the
        evaluation engine uses it as an incumbent-aware admission filter.
        ``sig`` is the engine's canonical signature when already available
        (implementations may consume it instead of ``mapping``). The
        default declines to bound (never prunes).
        """
        return 0.0, 0.0

    def lower_bound_fn(self, problem: Problem, arch: Architecture):
        """Bound ``lower_bound`` to (problem, arch) once; the evaluation
        engine calls the returned ``sig -> (cycles, energy_pj)`` closure per
        candidate. Models with precomputed per-problem state override this
        to skip the per-call dispatch."""
        return lambda sig: self.lower_bound(problem, None, arch, sig=sig)

    def lower_bound_chains_fn(self, problem: Problem, arch: Architecture):
        """Optional chain-level variant: a ``(chain_list, orders) ->
        (cycles, energy_pj)`` closure matching ``lower_bound_fn`` on the
        equivalent signature, letting the engine bound genome candidates
        without building their signature. None when unsupported."""
        return None

    def lower_bound_batch_fn(self, problem: Problem, arch: Architecture):
        """Optional vectorized admission bound: a closure
        ``(sigs, backend=..., stacked=..., device=...) -> Optional[(cycles[B],
        energy_pj[B]))`` producing, for every signature of a stacked batch,
        exactly the values ``lower_bound_fn`` produces per candidate (the
        engine admits a whole miss-batch with one masked array program).
        Implementations MUST return None whenever bit-identity with the
        scalar bound cannot be guaranteed (the engine then falls back to
        the per-candidate bound). None when unsupported."""
        return None

    def evaluate_signature(
        self, problem: Problem, arch: Architecture, sig
    ) -> Optional[Cost]:
        """Fused fast path: produce the same Cost ``evaluate`` would for a
        mapping with canonical signature ``sig``, without materializing the
        Mapping object. Return None when unsupported (the engine falls back
        to ``evaluate``). Implementations MUST be bit-identical to
        ``evaluate``."""
        return None

    def evaluate_signature_batch(
        self,
        problem: Problem,
        arch: Architecture,
        sigs,
        backend: str = "numpy",
        stacked=None,
        select=None,
        device=None,
    ) -> Optional[List[Cost]]:
        """Vectorized fast path: the Costs ``evaluate_signature`` (or
        ``evaluate``) would produce for every signature in ``sigs``,
        computed as one array program over the stacked batch.

        ``backend`` selects the array stack (``"numpy"`` or ``"torch"``,
        the latter on ``device``).
        ``stacked``/``select`` let the evaluation engine share the
        admission stage's already-stacked (device-resident, on torch)
        ``StackedBatch`` and score only the admitted row indices; ``sigs``
        must then be the corresponding subset, in ``select`` order.
        Return None when unsupported OR when exactness cannot be
        guaranteed for this batch (values beyond the float64-exact integer
        range) -- the engine then falls back to per-candidate evaluation.
        Implementations MUST be bit-identical to the scalar path whenever
        they return a result."""
        return None

    def batch_admit_core_builder(self, problem: Problem, arch: Architecture):
        """Optional array-generic admission-bound core builder for the fused
        single-dispatch pipeline: an ``xp -> core`` callable
        where ``core(tt, st, perm) -> (cycles[B], energy_pj[B], guard)``
        reproduces ``lower_bound_fn`` per row bit-identically (``guard``
        is the running max of every guarded integer-valued quantity; the
        host rejects the dispatch at BATCH_EXACT_LIMIT). The hierarchical
        models return ``AnalysisContext._make_lb_core``; None disables the
        fused path for this model."""
        return None

    def batch_cost_terms_fn(self, problem: Problem, arch: Architecture):
        """Optional array-program cost terms: an array-generic closure
        ``terms(bt: BatchTraffic, xp) -> (latency[B], energy_pj[B],
        util[B], guard, extras)`` accumulating this model's latency/energy
        over the stacked traffic with ``xp`` ops only (numpy host-side,
        the torch namespace inside the fused device core -- the per-row
        float-op order must equal ``evaluate_signature``'s; see
        ``analysis.exact_divisor`` for host constants divided by). ``guard`` is an xp
        scalar (max of guarded integer-valued products, checked host-side
        against BATCH_EXACT_LIMIT); ``extras`` is a str->array[B] dict
        carrying whatever :meth:`costs_from_batch` needs to rebuild
        breakdown dicts. None when unsupported (disables both the shared
        numpy scoring program and the fused device path)."""
        return None

    def batch_cost_terms_generic(self, problem: Problem, arch: Architecture):
        """Optional SHAPE-GENERIC cost terms for the process-wide program
        cache: ``(model_struct_key, model_params, terms)`` or None.

        ``model_struct_key`` is a hashable tuple of every STRUCTURAL
        property the terms program branches on (it joins the
        ``AnalysisContext.shape_class_key()`` in the program key);
        ``model_params`` is a dict of numpy arrays/scalars merged into the
        context's ``shape_params()`` pack and passed, as device tensors,
        as an argument; ``terms(bt, xp, p)`` mirrors
        :meth:`batch_cost_terms_fn`'s closure but reads every VALUE from
        ``p`` instead of Python closure constants, so one program serves
        every (problem, arch) pair with equal keys (the closure of the
        FIRST such pair is the one kept; it must not capture values that
        can differ within the key class). ``model_params`` must include
        ``calib_scale`` (1.0 when uncalibrated) -- the generic fused core
        applies it as the final latency multiply. None when unsupported;
        the engine then falls back to the per-context
        :meth:`batch_cost_terms_fn` pipeline."""
        return None

    def costs_from_batch(
        self,
        problem: Problem,
        arch: Architecture,
        latency,
        energy,
        util,
        extras,
        indices=None,
    ) -> List[Cost]:
        """Materialize Cost objects (scalar-path breakdown layout
        included) from :meth:`batch_cost_terms_fn` output arrays --
        ``indices`` restricts materialization to the given rows (the
        engine's fused path builds Costs only for ADMITTED candidates)."""
        raise NotImplementedError

    def store_key_parts(self) -> "tuple":
        """Model-configuration part of the persistent ResultStore key (see
        ``repro_torch.core.cost.store``). Two model instances with equal parts
        MUST produce bit-identical Costs for every (problem, arch,
        signature); models with scoring-relevant configuration override
        this to include it (and must append ``calibration_key_parts()``
        like this default does, so calibrated results never alias raw
        ones)."""
        return (self.name,) + self.calibration_key_parts()

    def conformable(self, problem: Problem) -> bool:
        """Whether this model can evaluate the problem at all.

        Overridden per model; see also repro_torch.core.ir.conformability which
        runs these checks as compiler passes.
        """
        return True

    def evaluate_metric(
        self, problem: Problem, mapping: Mapping, arch: Architecture, metric: str = "edp"
    ) -> float:
        return self.evaluate(problem, mapping, arch).metric(metric)
