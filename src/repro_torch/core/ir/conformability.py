"""Cost-model-dependent conformability passes (paper Sec. III-A3).

Each pass embodies one cost model's input constraints; the router returns
the set of models that can evaluate a problem, so Union-opt never feeds a
model something it cannot understand (the paper's example: MTTKRP needs a
three-operand unit op and must be rejected by a mac2-configured Timeloop).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.cost.base import CostModel
from repro_torch.core.problem import Problem

MAESTRO_NATIVE_OPS = {"CONV2D", "GEMM", "DWCONV", "TC", "ATTN_QK", "ATTN_PV", "SSD"}


@dataclass
class ConformabilityReport:
    problem: str
    results: Dict[str, Tuple[bool, str]] = field(default_factory=dict)

    def ok(self, model_name: str) -> bool:
        return self.results.get(model_name, (False, "not checked"))[0]

    def render(self) -> str:
        lines = [f"conformability[{self.problem}]:"]
        for k, (ok, why) in self.results.items():
            lines.append(f"  {k}: {'OK' if ok else 'REJECT'} ({why})")
        return "\n".join(lines)


def check_operation_level(problem: Problem) -> Tuple[bool, str]:
    """MAESTRO-style: the op tag must be natively understood."""
    if problem.operation in MAESTRO_NATIVE_OPS and problem.unit_op == "mac2":
        return True, f"operation {problem.operation} natively supported"
    if problem.unit_op != "mac2":
        return False, f"unit op {problem.unit_op} != mac2 energy model"
    return False, f"operation {problem.operation!r} not in native set"


def check_loop_level(problem: Problem, unit_op: str = "mac2") -> Tuple[bool, str]:
    """Timeloop-style: perfectly-nested affine loops, no conditionals,
    loop reordering must not change the result, unit op must match the
    energy model configuration."""
    if problem.attrs.get("data_dependent"):
        return False, "data-dependent control flow (not perfectly nested)"
    if problem.attrs.get("gather"):
        return False, "gather access is not an affine projection"
    for ds in problem.data_spaces:
        for expr in ds.projection:
            if not expr.terms:
                return False, f"empty projection axis in {ds.name}"
    if problem.unit_op != unit_op:
        return False, f"unit op {problem.unit_op} != configured {unit_op}"
    return True, "perfectly-nested affine loop nest"


def conformable_models(
    problem: Problem, models: Sequence[CostModel]
) -> ConformabilityReport:
    rep = ConformabilityReport(problem.name)
    for m in models:
        if m.name == "maestro_like":
            rep.results[m.name] = check_operation_level(problem)
        elif m.name == "timeloop_like":
            rep.results[m.name] = check_loop_level(problem, getattr(m, "unit_op", "mac2"))
        else:
            rep.results[m.name] = (m.conformable(problem), "model-specific check")
    return rep
