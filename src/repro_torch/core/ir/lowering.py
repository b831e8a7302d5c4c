"""Progressive lowering: LayerOp -> EinsumGeneric -> AffineLoopNest -> Problem.

Mirrors the paper's pipeline (Fig. 2): domain dialect -> Linalg -> Affine ->
Union problem, with the operation annotation preserved end-to-end so both
operation-level and loop-level cost models can consume the result.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.ir.dialects import AffineLoopNest, EinsumGeneric, LayerOp, TensorType
from repro_torch.core.problem import AffineExpr, DataSpace, Problem


# --------------------------------------------------------------------- #
# LayerOp -> EinsumGeneric
# --------------------------------------------------------------------- #
def _einsum_generic(
    name: str, spec: str, sizes: Dict[str, int], operation: str, wb: int = 2
) -> EinsumGeneric:
    lhs, rhs = spec.replace(" ", "").split("->")
    tokens = lhs.split(",")
    dims = {}
    for tok in tokens + [rhs]:
        for ch in tok:
            dims.setdefault(ch, int(sizes[ch]))
    operands = [
        (f"In{i}", tuple(AffineExpr.of(ch) for ch in tok), wb)
        for i, tok in enumerate(tokens)
    ]
    result = ("Out", tuple(AffineExpr.of(ch) for ch in rhs), wb)
    return EinsumGeneric(name, dims, operands, result, operation, attrs={"einsum": spec})


def layer_to_generic(op: LayerOp) -> EinsumGeneric:
    k = op.kind
    if k == "linear":
        x = op.inputs["x"].shape  # (B, In)  [B may be batch*seq, flattened]
        w = op.inputs["w"].shape  # (In, Out)
        wb = op.inputs["x"].word_bytes
        return _einsum_generic(op.name, "bi,io->bo", {"b": x[0], "i": x[1], "o": w[1]}, "GEMM", wb)
    if k == "embedding_gather":
        # gather is not a contraction; model as onehot-matmul for costing
        tok = op.inputs["ids"].shape
        emb = op.inputs["table"].shape
        g = _einsum_generic(
            op.name, "bv,vd->bd", {"b": tok[0], "v": emb[0], "d": emb[1]}, "GEMM",
            op.inputs["table"].word_bytes,
        )
        g.attrs["gather"] = True
        return g
    if k == "conv2d":
        p = op.params
        wb = p.get("word_bytes") or 2
        g = EinsumGeneric(
            op.name,
            {"n": p["N"], "k": p["K"], "x": p["X"], "y": p["Y"], "c": p["C"],
             "r": p["R"], "s": p["S"]},
            [
                ("Inputs", (
                    AffineExpr.of("n"), AffineExpr.of("c"),
                    AffineExpr.of((p.get("stride", 1), "x"), (1, "r")),
                    AffineExpr.of((p.get("stride", 1), "y"), (1, "s")),
                ), wb),
                ("Weights", (
                    AffineExpr.of("k"), AffineExpr.of("c"),
                    AffineExpr.of("r"), AffineExpr.of("s"),
                ), wb),
            ],
            ("Outputs", (
                AffineExpr.of("n"), AffineExpr.of("k"),
                AffineExpr.of("x"), AffineExpr.of("y"),
            ), wb),
            "CONV2D",
            attrs={"stride": p.get("stride", 1)},
        )
        return g
    if k == "attention_qk":
        p = op.params  # b=batch, h=heads, q/kv seq, d=head_dim
        return _einsum_generic(
            op.name, "bhqd,bhkd->bhqk",
            {"b": p["B"], "h": p["H"], "q": p["Q"], "k": p["KV"], "d": p["D"]},
            "ATTN_QK",
        )
    if k == "attention_pv":
        p = op.params
        return _einsum_generic(
            op.name, "bhqk,bhkd->bhqd",
            {"b": p["B"], "h": p["H"], "q": p["Q"], "k": p["KV"], "d": p["D"]},
            "ATTN_PV",
        )
    if k == "moe_gemm":
        p = op.params  # e experts, t tokens-per-expert, i/o dims
        return _einsum_generic(
            op.name, "eti,eio->eto",
            {"e": p["E"], "t": p["T"], "i": p["I"], "o": p["O"]},
            "GEMM",
        )
    if k == "ssd_chunk":
        p = op.params  # Mamba-2 chunked state update: (b,c,l,h,p)x(b,c,l,n)
        return _einsum_generic(
            op.name, "clhp,cln->chpn",
            {"c": p["C"], "l": p["L"], "h": p["H"], "p": p["P"], "n": p["N"]},
            "SSD",
        )
    if k == "tc":
        # generic einsum contraction; `operation`/`word_bytes` overrides let
        # shared builders (core.opstream) emit GEMM/SSD/... problems
        # bit-identical to the historical Problem.* constructors
        return _einsum_generic(
            op.name, op.params["einsum"], op.params["sizes"],
            op.params.get("operation") or "TC",
            op.params.get("word_bytes") or 2,
        )
    raise NotImplementedError(f"no lowering for LayerOp kind {k!r}")


# --------------------------------------------------------------------- #
# EinsumGeneric -> AffineLoopNest
# --------------------------------------------------------------------- #
def generic_to_affine(g: EinsumGeneric) -> AffineLoopNest:
    loops = [(d, s) for d, s in g.dims.items()]
    return AffineLoopNest(
        name=g.name,
        loops=loops,
        reads=[(n, proj, wb) for n, proj, wb in g.operands],
        write=g.result,
        operation=g.operation,
        unit_op=g.unit_op,
        attrs=dict(g.attrs),
    )


# --------------------------------------------------------------------- #
# AffineLoopNest -> Problem
# --------------------------------------------------------------------- #
def affine_to_problem(nest: AffineLoopNest) -> Problem:
    dims = {iv: ext for iv, ext in nest.loops}
    spaces: List[DataSpace] = []
    for n, proj, wb in nest.reads:
        spaces.append(DataSpace(n, tuple(proj), False, wb))
    wn, wproj, wwb = nest.write
    spaces.append(DataSpace(wn, tuple(wproj), True, wwb))
    p = Problem(nest.name, dims, tuple(spaces), operation=nest.operation,
                unit_op=nest.unit_op)
    p.attrs.update(nest.attrs)
    p.validate()
    return p


def lower_layer_to_problem(op: LayerOp) -> Problem:
    """Full pipeline for one op."""
    return affine_to_problem(generic_to_affine(layer_to_generic(op)))
