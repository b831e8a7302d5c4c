"""IR dialects: LayerOp -> EinsumGeneric -> AffineLoopNest.

These are deliberately small dataclasses, not a full SSA IR -- the point
(as in the paper) is the *abstraction boundaries*: the domain dialect knows
operator semantics, the generic dialect knows only contraction structure,
the affine dialect knows only loops + affine accesses. Each lowering step
discards exactly the information the next consumer does not need, while the
``operation`` annotation is carried through so operation-level cost models
(MAESTRO) still work after lowering (paper Sec. IV-B).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.problem import AffineExpr


@dataclass(frozen=True)
class TensorType:
    shape: Tuple[int, ...]
    dtype: str = "bf16"

    @property
    def elems(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def word_bytes(self) -> int:
        return {"bf16": 2, "f32": 4, "f16": 2, "i8": 1, "u8": 1, "i32": 4}[self.dtype]


@dataclass
class LayerOp:
    """Domain-level op (TOSA/COMET-TA analog)."""

    name: str
    kind: str  # linear | conv2d | dwconv | attention_qk | attention_pv |
    #            moe_gemm | embedding | ssd_chunk | lstm_cell | norm | ...
    inputs: Dict[str, TensorType]
    outputs: Dict[str, TensorType]
    params: Dict[str, object] = field(default_factory=dict)

    def __repr__(self) -> str:  # pragma: no cover
        ins = ", ".join(f"{k}:{list(v.shape)}" for k, v in self.inputs.items())
        return f"LayerOp({self.kind} {self.name} [{ins}])"


@dataclass
class EinsumGeneric:
    """Linalg-generic analog: iteration dims + per-operand affine maps."""

    name: str
    dims: Dict[str, int]  # iteration space
    operands: List[Tuple[str, Tuple[AffineExpr, ...], int]]  # (name, proj, word_bytes)
    result: Tuple[str, Tuple[AffineExpr, ...], int]
    operation: Optional[str] = None  # carried annotation for op-level models
    unit_op: str = "mac2"
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class AffineLoopNest:
    """Affine-dialect analog: perfectly nested loops + one MAC statement."""

    name: str
    loops: List[Tuple[str, int]]  # (iv, extent), outermost first
    reads: List[Tuple[str, Tuple[AffineExpr, ...], int]]
    write: Tuple[str, Tuple[AffineExpr, ...], int]
    operation: Optional[str] = None
    unit_op: str = "mac2"
    attrs: Dict[str, object] = field(default_factory=dict)

    def render(self) -> str:
        lines = []
        for i, (iv, ext) in enumerate(self.loops):
            lines.append("  " * i + f"affine.for %{iv} = 0 to {ext} {{")
        ind = "  " * len(self.loops)
        rhs = " * ".join(
            f"{n}[{', '.join(map(repr, proj))}]" for n, proj, _ in self.reads
        )
        wname, wproj, _ = self.write
        lines.append(ind + f"{wname}[{', '.join(map(repr, wproj))}] += {rhs}")
        for i in range(len(self.loops) - 1, -1, -1):
            lines.append("  " * i + "}")
        return "\n".join(lines)
