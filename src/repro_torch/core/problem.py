"""Union problem abstraction (paper Sec. IV-B).

A tensor operation is described by:
  * a set of named problem *dimensions* with integer sizes (the iteration
    space is their Cartesian product),
  * a set of *data spaces* (tensors), each with an affine *projection*
    from the iteration space onto the tensor's coordinate space,
  * an optional high-level ``operation`` tag (GEMM / CONV2D / TC / ...)
    so operation-level cost models (MAESTRO) and loop-level cost models
    (Timeloop) can both consume the same instance.

The abstraction is intentionally richer than plain einsum: a projection
axis is a list of (coefficient, dim) terms so strided convolution windows
(``x*stride + r``) are first-class, as in Timeloop's problem spec.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping as TMapping, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Term:
    """One affine term ``coeff * dim``."""

    coeff: int
    dim: str

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.dim if self.coeff == 1 else f"{self.coeff}*{self.dim}"


@dataclass(frozen=True)
class AffineExpr:
    """An affine combination of problem dimensions: ``sum_i coeff_i * dim_i``.

    One AffineExpr describes ONE coordinate axis of a data space.
    """

    terms: Tuple[Term, ...]

    @staticmethod
    def of(*terms: Tuple[int, str] | str) -> "AffineExpr":
        out = []
        for t in terms:
            if isinstance(t, str):
                out.append(Term(1, t))
            else:
                out.append(Term(int(t[0]), str(t[1])))
        return AffineExpr(tuple(out))

    @property
    def dims(self) -> Tuple[str, ...]:
        return tuple(t.dim for t in self.terms)

    def extent(self, tile: TMapping[str, int]) -> int:
        """Number of distinct coordinate values touched when each dim ``d``
        ranges over ``tile[d]`` contiguous values.

        For a single term ``c*d`` with tile t: extent = (t-1)*|c| + 1 when the
        axis is sampled at stride |c| -- but data footprint counts *addresses
        spanned*, so for compound expressions (conv sliding window
        ``stride*x + r``) the footprint is ``sum_i |c_i|*(t_i - 1) + 1``.
        This matches Timeloop's working-set computation for strided CONV.
        """
        span = 1
        for t in self.terms:
            span += abs(t.coeff) * (max(1, int(tile.get(t.dim, 1))) - 1)
        return span

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return " + ".join(repr(t) for t in self.terms)


@dataclass(frozen=True)
class DataSpace:
    """A tensor operand/result of the problem.

    ``projection`` has one AffineExpr per tensor axis. ``is_output`` marks
    read-modify-write data spaces (partial-sum traffic is modeled for them).
    """

    name: str
    projection: Tuple[AffineExpr, ...]
    is_output: bool = False
    word_bytes: int = 2  # bf16 default on TPU; paper case studies use 1 (uint8)

    @property
    def dims(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for expr in self.projection:
            for d in expr.dims:
                if d not in seen:
                    seen.append(d)
        return tuple(seen)

    def footprint(self, tile: TMapping[str, int]) -> int:
        """Number of elements touched for the given per-dim tile sizes."""
        n = 1
        for expr in self.projection:
            n *= expr.extent(tile)
        return n

    def footprint_bytes(self, tile: TMapping[str, int]) -> int:
        return self.footprint(tile) * self.word_bytes


@dataclass
class Problem:
    """A Union problem instance.

    ``dims`` maps dimension name -> size (ordered; the order is the default
    loop order). ``operation`` is the optional high-level tag used by
    operation-level cost models and conformability passes.
    """

    name: str
    dims: Dict[str, int]
    data_spaces: Tuple[DataSpace, ...]
    operation: Optional[str] = None  # e.g. "GEMM", "CONV2D", "TC", "MTTKRP"
    unit_op: str = "mac2"  # two-operand multiply-accumulate (paper Sec. III-B2)
    attrs: Dict[str, object] = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    # Derived quantities
    # ------------------------------------------------------------------ #
    @property
    def dim_names(self) -> Tuple[str, ...]:
        return tuple(self.dims.keys())

    @property
    def iteration_space(self) -> int:
        return math.prod(self.dims.values())

    @property
    def macs(self) -> int:
        """One unit-op per iteration-space point."""
        return self.iteration_space

    @property
    def flops(self) -> int:
        return 2 * self.macs  # one multiply + one add

    def outputs(self) -> Tuple[DataSpace, ...]:
        return tuple(ds for ds in self.data_spaces if ds.is_output)

    def inputs(self) -> Tuple[DataSpace, ...]:
        return tuple(ds for ds in self.data_spaces if not ds.is_output)

    def data_space(self, name: str) -> DataSpace:
        for ds in self.data_spaces:
            if ds.name == name:
                return ds
        raise KeyError(name)

    def reduction_dims(self) -> Tuple[str, ...]:
        """Dims that do not project into any output data space."""
        out_dims = set()
        for ds in self.outputs():
            out_dims.update(ds.dims)
        return tuple(d for d in self.dims if d not in out_dims)

    def total_tensor_bytes(self) -> int:
        return sum(ds.footprint_bytes(self.dims) for ds in self.data_spaces)

    def validate(self) -> None:
        for ds in self.data_spaces:
            for expr in ds.projection:
                for t in expr.terms:
                    if t.dim not in self.dims:
                        raise ValueError(
                            f"data space {ds.name!r} references unknown dim {t.dim!r}"
                        )
        if not self.outputs():
            raise ValueError(f"problem {self.name!r} has no output data space")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        d = ", ".join(f"{k}={v}" for k, v in self.dims.items())
        return f"Problem({self.name}: {d}; op={self.operation})"

    # ------------------------------------------------------------------ #
    # Constructors for the tensor operations in the paper (Sec. II-A)
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_einsum(
        name: str,
        spec: str,
        sizes: TMapping[str, int],
        operation: Optional[str] = None,
        word_bytes: int = 2,
    ) -> "Problem":
        """Build a Problem from an einsum spec, e.g. ``"dfgb,geac->abcdef"``.

        Every index letter is a problem dimension; inputs/outputs get
        identity projections. This covers GEMM, TC, MTTKRP, batched matmul,
        attention score/context products, SSD chunk contractions, ...
        """
        lhs, rhs = spec.replace(" ", "").split("->")
        operands = lhs.split(",")
        letters: List[str] = []
        for token in operands + [rhs]:
            for ch in token:
                if ch not in letters:
                    letters.append(ch)
        dims = {ch: int(sizes[ch]) for ch in letters}
        spaces: List[DataSpace] = []
        for i, token in enumerate(operands):
            proj = tuple(AffineExpr.of(ch) for ch in token)
            spaces.append(DataSpace(f"In{i}", proj, False, word_bytes))
        out_proj = tuple(AffineExpr.of(ch) for ch in rhs)
        spaces.append(DataSpace("Out", out_proj, True, word_bytes))
        p = Problem(name, dims, tuple(spaces), operation=operation)
        p.attrs["einsum"] = spec
        p.validate()
        return p

    @staticmethod
    def gemm(M: int, N: int, K: int, name: str = "gemm", word_bytes: int = 2) -> "Problem":
        p = Problem.from_einsum(name, "mk,kn->mn", {"m": M, "k": K, "n": N}, "GEMM", word_bytes)
        return p

    @staticmethod
    def conv2d(
        N: int,
        K: int,
        C: int,
        X: int,
        Y: int,
        R: int,
        S: int,
        stride: int = 1,
        name: str = "conv2d",
        word_bytes: int = 2,
    ) -> "Problem":
        """CONV2D loop nest of paper Algorithm 1. X, Y are OUTPUT sizes."""
        dims = {"n": N, "k": K, "x": X, "y": Y, "c": C, "r": R, "s": S}
        ia = DataSpace(
            "Inputs",
            (
                AffineExpr.of("n"),
                AffineExpr.of("c"),
                AffineExpr.of((stride, "x"), (1, "r")),
                AffineExpr.of((stride, "y"), (1, "s")),
            ),
            False,
            word_bytes,
        )
        w = DataSpace(
            "Weights",
            (AffineExpr.of("k"), AffineExpr.of("c"), AffineExpr.of("r"), AffineExpr.of("s")),
            False,
            word_bytes,
        )
        oa = DataSpace(
            "Outputs",
            (AffineExpr.of("n"), AffineExpr.of("k"), AffineExpr.of("x"), AffineExpr.of("y")),
            True,
            word_bytes,
        )
        p = Problem(name, dims, (ia, w, oa), operation="CONV2D")
        p.attrs["stride"] = stride
        p.validate()
        return p

    @staticmethod
    def depthwise_conv2d(
        N: int, C: int, X: int, Y: int, R: int, S: int, stride: int = 1,
        name: str = "dwconv", word_bytes: int = 2,
    ) -> "Problem":
        dims = {"n": N, "c": C, "x": X, "y": Y, "r": R, "s": S}
        ia = DataSpace(
            "Inputs",
            (
                AffineExpr.of("n"),
                AffineExpr.of("c"),
                AffineExpr.of((stride, "x"), (1, "r")),
                AffineExpr.of((stride, "y"), (1, "s")),
            ),
            False,
            word_bytes,
        )
        w = DataSpace(
            "Weights",
            (AffineExpr.of("c"), AffineExpr.of("r"), AffineExpr.of("s")),
            False,
            word_bytes,
        )
        oa = DataSpace(
            "Outputs",
            (AffineExpr.of("n"), AffineExpr.of("c"), AffineExpr.of("x"), AffineExpr.of("y")),
            True,
            word_bytes,
        )
        p = Problem(name, dims, (ia, w, oa), operation="DWCONV")
        p.attrs["stride"] = stride
        p.validate()
        return p

    @staticmethod
    def mttkrp(I: int, J: int, K: int, L: int, name: str = "mttkrp", word_bytes: int = 2) -> "Problem":
        """A(i,j) += X(i,k,l) * B(k,j) * C(l,j): three-operand unit op.

        Used by the paper (Sec. III-B2) as the example of a problem whose
        unit operation is NOT a two-operand MAC -- conformability passes
        must reject it for cost models configured with mac2.
        """
        dims = {"i": I, "j": J, "k": K, "l": L}
        x = DataSpace("X", (AffineExpr.of("i"), AffineExpr.of("k"), AffineExpr.of("l")), False, word_bytes)
        b = DataSpace("B", (AffineExpr.of("k"), AffineExpr.of("j")), False, word_bytes)
        c = DataSpace("C", (AffineExpr.of("l"), AffineExpr.of("j")), False, word_bytes)
        a = DataSpace("A", (AffineExpr.of("i"), AffineExpr.of("j")), True, word_bytes)
        p = Problem(name, dims, (x, b, c, a), operation="MTTKRP", unit_op="mac3")
        p.validate()
        return p

    # Paper Table III tensor contractions (TCCG suite) ------------------- #
    @staticmethod
    def tc_intensli2(tds: int, word_bytes: int = 2) -> "Problem":
        # C[a,b,c,d] = A[d,b,e,a] * B[e,c]
        return Problem.from_einsum(
            f"intensli2_tds{tds}", "dbea,ec->abcd",
            {k: tds for k in "abcde"}, "TC", word_bytes,
        )

    @staticmethod
    def tc_ccsd7(tds: int, word_bytes: int = 2) -> "Problem":
        # C[a,b,c] = A[a,d,e,c] * B[e,b,d]
        return Problem.from_einsum(
            f"ccsd7_tds{tds}", "adec,ebd->abc",
            {k: tds for k in "abcde"}, "TC", word_bytes,
        )

    @staticmethod
    def tc_ccsd_t4(tds: int, word_bytes: int = 2) -> "Problem":
        # C[a,b,c,d,e,f] = A[d,f,g,b] * B[g,e,a,c]  (paper Algorithm 2)
        return Problem.from_einsum(
            f"ccsd-t4_tds{tds}", "dfgb,geac->abcdef",
            {k: tds for k in "abcdefg"}, "TC", word_bytes,
        )
