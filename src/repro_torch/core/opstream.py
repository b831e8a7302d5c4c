"""Whole-model operator streams: (ModelConfig, ShapeConfig) -> OpStream
(the port's copy of ``repro/core/opstream.py``).

This is the layer that connects configs, the IR and the mappers into one
pipeline:

  configs (ModelConfig/ShapeConfig)  ->  IR (LayerOp lowering)  ->
  OpStream [(Problem, multiplicity, role)]  ->  ONE union_opt_sweep
  (shared engines / memo / ResultStore / shape-class warmup)  ->
  multiplicity-weighted end-to-end latency / energy / EDP per model,
  cross-checked against the reference's dry-run ``cost_analysis()``
  artifacts where they exist (plain JSON readers below).

Design contract (the reference's ``docs/whole_model.md``):

* **Every contraction-shaped op goes through the IR path.** The shared
  builders below (`build_gemm`, `build_conv2d`, `build_einsum`, the TCCG
  constructors) construct a ``LayerOp`` and run the full
  ``LayerOp -> EinsumGeneric -> AffineLoopNest -> Problem`` lowering --
  and are asserted BIT-IDENTICAL to the ad-hoc
  ``Problem.gemm``/``Problem.conv2d``/``Problem.from_einsum``
  constructors and to the reference's builders
  (tests/test_torch_opstream.py).

* **Dedup by content, weight by multiplicity.** Content-equal problems
  (name excluded -- e.g. wk and wv, or the 26 identical MoE layers of
  deepseek-v2-lite) collapse into ONE entry whose ``multiplicity``
  counts how many times the op runs per model step. The sweep then
  searches each unique op once (the engine/store would dedup the cost
  anyway -- the stream dedups the *search*), and the aggregation
  multiplies costs back out.

* **Roles.** Each entry is tagged with the model component it came from
  (``embed / attention / attention_score / mlp / moe / router / ssm /
  ssm_scan / head``) so end-to-end EDP decomposes into a stacked
  per-role breakdown. ``PARAM_ROLES``
  mark the entries whose FLOPs correspond to parameter MACs -- the
  subset reconciled against the ``2 * active_params * tokens``
  MODEL_FLOPS convention that the reference's ``launch/dryrun.py`` embeds
  in every artifact (``formula_model_flops`` here is that same formula).

* **Gather is costed, not mapped.** ``embedding_gather`` lowers to the
  onehot-matmul Problem the conformability pass rightly REJECTS for
  loop-level cost models (a gather is not an affine contraction), so
  its entry carries ``mappable=False``: it is excluded from the sweep
  and costed analytically (bandwidth term only) in the aggregation,
  while its onehot MACs still reconcile the embedding's share of
  MODEL_FLOPS.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union as TUnion

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.core.architecture import Architecture
from repro_torch.core.ir.dialects import LayerOp, TensorType
from repro_torch.core.ir.lowering import lower_layer_to_problem
from repro_torch.core.problem import Problem

# --------------------------------------------------------------------- #
# Shared IR-routed builders (workloads.py + figure tables + streams)
# --------------------------------------------------------------------- #


def build_einsum(
    name: str,
    spec: str,
    sizes: Dict[str, int],
    operation: Optional[str] = None,
    word_bytes: int = 2,
) -> Problem:
    """Lower an einsum through the FULL IR pipeline (LayerOp -> generic ->
    affine -> Problem). Bit-identical to ``Problem.from_einsum`` -- the
    point is that every constructor routes through one lowering path."""
    op = LayerOp(
        name, "tc", {}, {},
        params={"einsum": spec, "sizes": dict(sizes),
                "operation": operation, "word_bytes": word_bytes},
    )
    return lower_layer_to_problem(op)


def build_gemm(M: int, N: int, K: int, name: str = "gemm", word_bytes: int = 2) -> Problem:
    """IR-routed equivalent of ``Problem.gemm`` (asserted bit-identical)."""
    return build_einsum(name, "mk,kn->mn", {"m": M, "k": K, "n": N}, "GEMM", word_bytes)


def build_conv2d(
    N: int, K: int, C: int, X: int, Y: int, R: int, S: int,
    stride: int = 1, name: str = "conv2d", word_bytes: int = 2,
) -> Problem:
    """IR-routed equivalent of ``Problem.conv2d`` (asserted bit-identical)."""
    op = LayerOp(
        name, "conv2d", {}, {},
        params=dict(N=N, K=K, C=C, X=X, Y=Y, R=R, S=S, stride=stride,
                    word_bytes=word_bytes),
    )
    return lower_layer_to_problem(op)


def build_tc_intensli2(tds: int, word_bytes: int = 2) -> Problem:
    return build_einsum(f"intensli2_tds{tds}", "dbea,ec->abcd",
                        {k: tds for k in "abcde"}, "TC", word_bytes)


def build_tc_ccsd7(tds: int, word_bytes: int = 2) -> Problem:
    return build_einsum(f"ccsd7_tds{tds}", "adec,ebd->abc",
                        {k: tds for k in "abcde"}, "TC", word_bytes)


def build_tc_ccsd_t4(tds: int, word_bytes: int = 2) -> Problem:
    return build_einsum(f"ccsd-t4_tds{tds}", "dfgb,geac->abcdef",
                        {k: tds for k in "abcdefg"}, "TC", word_bytes)


# --------------------------------------------------------------------- #
# OpStream
# --------------------------------------------------------------------- #

#: roles whose FLOPs are parameter MACs (reconciled against MODEL_FLOPS);
#: the complement (attention_score / ssm_scan) is activation-activation
#: compute the 2*N*T convention deliberately excludes.
PARAM_ROLES = ("embed", "attention", "mlp", "moe", "router", "ssm", "head")
SCORE_ROLES = ("attention_score", "ssm_scan")

#: documented tolerance band for stream-vs-formula FLOPs reconciliation
#: (the reference's docs/whole_model.md): the stream may exceed the formula by the
#: MoE capacity factor (cf=1.25 on the routed-expert share) and the tied
#: lm-head term (added to the expectation explicitly), and may fall short
#: by the norm/bias/conv parameters the stream does not model (<~7%).
RECONCILE_BAND = (0.90, 1.40)


@dataclass
class OpEntry:
    """One deduplicated operator of a model step."""

    problem: Problem
    multiplicity: float  # executions per model step (fwd only; see backward_factor)
    role: str
    mappable: bool = True  # False => excluded from the sweep, costed analytically

    @property
    def flops(self) -> float:
        return self.multiplicity * self.problem.flops

    @property
    def bytes(self) -> float:
        return self.multiplicity * self.problem.total_tensor_bytes()


@dataclass
class OpStream:
    """Deduplicated operator stream of one (model, shape) cell."""

    model: str
    shape: str
    kind: str  # train | prefill | decode
    entries: List[OpEntry]
    backward_factor: float  # 3.0 for train (fwd+bwd), 1.0 otherwise
    meta: Dict[str, object] = field(default_factory=dict)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def mappable_entries(self) -> List[OpEntry]:
        return [e for e in self.entries if e.mappable]

    def total_flops(self) -> float:
        """Multiplicity-weighted FLOPs per model step (incl. backward)."""
        return self.backward_factor * sum(e.flops for e in self.entries)

    def total_bytes(self) -> float:
        return self.backward_factor * sum(e.bytes for e in self.entries)

    def flops_by_role(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            out[e.role] = out.get(e.role, 0.0) + self.backward_factor * e.flops
        return out

    def param_flops(self) -> float:
        """FLOPs of the parameter-MAC roles only (MODEL_FLOPS subset)."""
        return self.backward_factor * sum(
            e.flops for e in self.entries if e.role in PARAM_ROLES
        )


class _StreamBuilder:
    """Accumulates lowered ops with content-keyed dedup."""

    def __init__(self) -> None:
        self._order: List[OpEntry] = []
        self._index: Dict[tuple, OpEntry] = {}
        self.n_ops = 0.0  # pre-dedup op executions (multiplicity-weighted)

    @staticmethod
    def _content_key(p: Problem, role: str) -> tuple:
        return (
            role,
            tuple(p.dims.items()),
            tuple((ds.name, ds.projection, ds.is_output, ds.word_bytes)
                  for ds in p.data_spaces),
            p.operation,
            p.unit_op,
            tuple(sorted((k, repr(v)) for k, v in p.attrs.items())),
        )

    def add(self, problem: Problem, mult: float, role: str, mappable: bool = True) -> None:
        if mult <= 0:
            return
        self.n_ops += mult
        key = self._content_key(problem, role)
        e = self._index.get(key)
        if e is None:
            e = OpEntry(problem, float(mult), role, mappable)
            self._index[key] = e
            self._order.append(e)
        else:
            e.multiplicity += float(mult)

    def entries(self) -> List[OpEntry]:
        return list(self._order)


def _linear(name: str, tokens: int, d_in: int, d_out: int) -> Problem:
    return build_einsum(name, "bi,io->bo",
                        {"b": tokens, "i": d_in, "o": d_out}, "GEMM")


def _attention_ops(add, cfg: ModelConfig, prefix: str, B: int, T: int,
                   Q: int, KV: int) -> None:
    """Attention block: projection GEMMs + score/context einsums.

    GQA shapes come straight from the config (n_kv_heads < n_heads share
    KV); decode cells carry Q=1 at the serving batch size B."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.use_mla:
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        dn, dv = cfg.nope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            add(_linear(f"{prefix}.q_down", T, d, cfg.q_lora_rank), 1, "attention")
            add(_linear(f"{prefix}.q_up", T, cfg.q_lora_rank, h * (dn + dr)), 1, "attention")
        else:
            add(_linear(f"{prefix}.wq", T, d, h * (dn + dr)), 1, "attention")
        add(_linear(f"{prefix}.kv_down", T, d, r), 1, "attention")
        add(_linear(f"{prefix}.k_rope", T, d, dr), 1, "attention")
        add(_linear(f"{prefix}.kv_up", T, r, h * (dn + dv)), 1, "attention")
        add(lower_layer_to_problem(LayerOp(
            f"{prefix}.qk", "attention_qk", {}, {},
            params=dict(B=B, H=h, Q=Q, KV=KV, D=dn + dr))), 1, "attention_score")
        add(lower_layer_to_problem(LayerOp(
            f"{prefix}.pv", "attention_pv", {}, {},
            params=dict(B=B, H=h, Q=Q, KV=KV, D=dv))), 1, "attention_score")
        add(_linear(f"{prefix}.wo", T, h * dv, d), 1, "attention")
    else:
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        add(_linear(f"{prefix}.wq", T, d, h * hd), 1, "attention")
        add(_linear(f"{prefix}.wk", T, d, kv * hd), 1, "attention")
        add(_linear(f"{prefix}.wv", T, d, kv * hd), 1, "attention")
        add(lower_layer_to_problem(LayerOp(
            f"{prefix}.qk", "attention_qk", {}, {},
            params=dict(B=B, H=h, Q=Q, KV=KV, D=hd))), 1, "attention_score")
        add(lower_layer_to_problem(LayerOp(
            f"{prefix}.pv", "attention_pv", {}, {},
            params=dict(B=B, H=h, Q=Q, KV=KV, D=hd))), 1, "attention_score")
        add(_linear(f"{prefix}.wo", T, h * hd, d), 1, "attention")


def _dense_ffn_ops(add, cfg: ModelConfig, prefix: str, T: int, d_ff: int) -> None:
    d = cfg.d_model
    if cfg.act in ("silu", "swiglu"):
        add(_linear(f"{prefix}.gate", T, d, d_ff), 1, "mlp")
        add(_linear(f"{prefix}.up", T, d, d_ff), 1, "mlp")
    else:
        add(_linear(f"{prefix}.up", T, d, d_ff), 1, "mlp")
    add(_linear(f"{prefix}.down", T, d_ff, d), 1, "mlp")


def moe_expert_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Per-expert token capacity -- the SAME rule ``models/moe.py`` uses
    for dispatch: C = max(1, ceil(T * k * cf / e))."""
    e, k = cfg.n_routed_experts, cfg.top_k
    return max(1, int(math.ceil(tokens * k * cfg.capacity_factor / e)))


def _moe_ops(add, cfg: ModelConfig, prefix: str, T: int) -> None:
    """MoE layer: router GEMM + capacity-dispatched expert GEMMs (the
    ``moe_gemm`` LayerOp kind: E experts x C token slots) + shared-expert
    dense GEMMs. Active-expert multiplicity follows models/moe.py's
    capacity rule, so the stream FLOPs carry the same cf=1.25 padding
    the runtime dispatch pays."""
    d, de, e = cfg.d_model, cfg.d_expert, cfg.n_routed_experts
    add(_linear(f"{prefix}.router", T, d, e), 1, "router")
    C = moe_expert_capacity(cfg, T)
    up = lower_layer_to_problem(LayerOp(
        f"{prefix}.experts_up", "moe_gemm", {}, {},
        params=dict(E=e, T=C, I=d, O=de)))
    down = lower_layer_to_problem(LayerOp(
        f"{prefix}.experts_down", "moe_gemm", {}, {},
        params=dict(E=e, T=C, I=de, O=d)))
    add(up, 2, "moe")  # gate + up projections
    add(down, 1, "moe")
    for _ in range(cfg.n_shared_experts):
        add(_linear(f"{prefix}.shared_gate", T, d, de), 1, "moe")
        add(_linear(f"{prefix}.shared_up", T, d, de), 1, "moe")
        add(_linear(f"{prefix}.shared_down", T, de, d), 1, "moe")


def _ffn_ops(add, cfg: ModelConfig, prefix: str, T: int, layer_idx: int) -> None:
    """FFN for an attn layer, mirroring ModelConfig.num_params exactly:
    MoE past first_k_dense, dense (d_ff) before it / without experts."""
    if cfg.n_routed_experts and layer_idx >= cfg.first_k_dense:
        _moe_ops(add, cfg, prefix, T)
    elif cfg.n_routed_experts:
        if cfg.d_ff:
            _dense_ffn_ops(add, cfg, prefix, T, cfg.d_ff)
    elif cfg.d_ff:
        _dense_ffn_ops(add, cfg, prefix, T, cfg.d_ff)


_SSD_CHUNK = 256  # models/ssm.py mamba2_apply default


def _mamba2_ops(add, cfg: ModelConfig, prefix: str, B: int, T: int,
                S: int, decode: bool) -> None:
    """Mamba-2 block: projection GEMMs + the chunked-SSD scan contractions
    (models/ssm.py ``_ssd_chunked``) for train/prefill, or the O(1)
    recurrent state update for decode."""
    d, di = cfg.d_model, cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    nh, p = cfg.n_ssm_heads, cfg.ssm_head_dim
    add(_linear(f"{prefix}.in_z", T, d, di), 1, "ssm")
    add(_linear(f"{prefix}.in_x", T, d, di), 1, "ssm")
    add(_linear(f"{prefix}.in_B", T, d, g * n), 1, "ssm")
    add(_linear(f"{prefix}.in_C", T, d, g * n), 1, "ssm")
    add(_linear(f"{prefix}.in_dt", T, d, nh), 1, "ssm")
    # depthwise causal conv over x/B/C (macs == conv params * tokens)
    add(build_einsum(f"{prefix}.conv1d", "twc,wc->tc",
                     {"t": T, "w": cfg.conv_width, "c": di + 2 * g * n},
                     "DWCONV"), 1, "ssm")
    add(_linear(f"{prefix}.out", T, di, d), 1, "ssm")
    if decode:
        # recurrent step: state outer-product update + state read per token
        add(build_einsum(f"{prefix}.ssd_update", "bhp,bhn->bhpn",
                         {"b": B, "h": nh, "p": p, "n": n}, "SSD"), 1, "ssm_scan")
        add(build_einsum(f"{prefix}.ssd_read", "bhpn,bhn->bhp",
                         {"b": B, "h": nh, "p": p, "n": n}, "SSD"), 1, "ssm_scan")
        return
    chunk = min(_SSD_CHUNK, S)
    nc = B * max(1, S // chunk)  # batch folded into the chunk axis
    # intra-chunk scores C_i . B_j  (bclhn,bcshn->bchls)
    add(build_einsum(f"{prefix}.ssd_scores", "clhn,cshn->chls",
                     {"c": nc, "l": chunk, "s": chunk, "h": nh, "n": n},
                     "SSD"), 1, "ssm_scan")
    # diagonal-block output (bchls,bcshp->bclhp)
    add(build_einsum(f"{prefix}.ssd_diag", "chls,cshp->clhp",
                     {"c": nc, "l": chunk, "s": chunk, "h": nh, "p": p},
                     "SSD"), 1, "ssm_scan")
    # chunk-final states via the ssd_chunk LayerOp kind (clhp,cln->chpn)
    add(lower_layer_to_problem(LayerOp(
        f"{prefix}.ssd_state", "ssd_chunk", {}, {},
        params=dict(C=nc, L=chunk, H=nh, P=p, N=n))), 1, "ssm_scan")
    # inter-chunk contribution C_i . S_in  (bclhn,bchpn->bclhp)
    add(build_einsum(f"{prefix}.ssd_off", "clhn,chpn->clhp",
                     {"c": nc, "l": chunk, "h": nh, "p": p, "n": n},
                     "SSD"), 1, "ssm_scan")


def _mlstm_ops(add, cfg: ModelConfig, prefix: str, B: int, T: int,
               S: int, decode: bool) -> None:
    """mLSTM block: 5 d->d projections (q,k,v,gates,out -- matching the
    4d^2+d^2 parameter count) + matrix-memory recurrence, chunkwise for
    train/prefill (attention-like within a chunk + per-chunk d_head^2
    state update), O(1) recurrent for decode."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // max(1, h)
    add(_linear(f"{prefix}.qkv_gates", T, d, d), 5, "ssm")
    if decode:
        add(build_einsum(f"{prefix}.mem_update", "bhp,bhn->bhpn",
                         {"b": B, "h": h, "p": hd, "n": hd}, "SSD"), 1, "ssm_scan")
        add(build_einsum(f"{prefix}.mem_read", "bhpn,bhn->bhp",
                         {"b": B, "h": h, "p": hd, "n": hd}, "SSD"), 1, "ssm_scan")
        return
    chunk = min(_SSD_CHUNK, S)
    nc = B * max(1, S // chunk)
    add(build_einsum(f"{prefix}.scores", "chqd,chkd->chqk",
                     {"c": nc, "h": h, "q": chunk, "k": chunk, "d": hd},
                     "SSD"), 1, "ssm_scan")
    add(build_einsum(f"{prefix}.diag", "chqk,chkd->chqd",
                     {"c": nc, "h": h, "q": chunk, "k": chunk, "d": hd},
                     "SSD"), 1, "ssm_scan")
    add(build_einsum(f"{prefix}.mem_state", "chkd,chke->chde",
                     {"c": nc, "h": h, "k": chunk, "d": hd, "e": hd},
                     "SSD"), 1, "ssm_scan")
    add(build_einsum(f"{prefix}.mem_off", "chqd,chde->chqe",
                     {"c": nc, "h": h, "q": chunk, "d": hd, "e": hd},
                     "SSD"), 1, "ssm_scan")


def _slstm_ops(add, cfg: ModelConfig, prefix: str, T: int) -> None:
    """sLSTM block: 4 gate input projections (d->d) + 4 per-head recurrent
    GEMMs (hd x hd each, applied per token)."""
    d, h = cfg.d_model, cfg.n_heads
    hd = d // max(1, h)
    add(_linear(f"{prefix}.gates_in", T, d, d), 4, "ssm")
    add(build_einsum(f"{prefix}.gates_rec", "tghp,ghpn->tghn",
                     {"t": T, "g": 4, "h": h, "p": hd, "n": hd}, "GEMM"),
        1, "ssm")


def build_opstream(
    model: TUnion[str, ModelConfig],
    shape: TUnion[str, ShapeConfig],
    serving_batch: Optional[int] = None,
) -> OpStream:
    """Lower a (ModelConfig, ShapeConfig) cell into its deduplicated
    operator stream. ``serving_batch`` overrides the shape's global batch
    (decode cells at serving batch sizes)."""
    cfg = get_config(model) if isinstance(model, str) else model
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    B = int(serving_batch or sh.global_batch)
    S = sh.seq_len
    decode = sh.kind == "decode"
    Q = 1 if decode else S
    T = B * Q  # tokens processed per step
    if decode and not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode stream")

    b = _StreamBuilder()
    add = b.add

    # frontend projector (vlm/audio stubs): matches num_params' projector MLP
    if cfg.frontend != "none" and cfg.d_frontend:
        add(_linear("frontend.proj_in", T, cfg.d_frontend, cfg.d_model), 1, "embed")
        add(_linear("frontend.proj_mid", T, cfg.d_model, cfg.d_model), 1, "embed")

    # token embedding: gather, lowered to the onehot matmul the
    # conformability pass rejects for loop-level models -> mappable=False
    emb = lower_layer_to_problem(LayerOp(
        "embed", "embedding_gather",
        {"ids": TensorType((T,), "i32"),
         "table": TensorType((cfg.vocab, cfg.d_model))},
        {"y": TensorType((T, cfg.d_model))},
    ))
    add(emb, 1, "embed", mappable=False)

    for i, blk in enumerate(cfg.block_pattern * cfg.n_units):
        prefix = {"attn": "attn", "mamba2": "mamba2",
                  "mlstm": "mlstm", "slstm": "slstm"}[blk]
        if blk == "attn":
            _attention_ops(add, cfg, prefix, B, T, Q, S)
            if cfg.family not in ("hybrid",):
                _ffn_ops(add, cfg, prefix, T, i)
        elif blk == "mamba2":
            _mamba2_ops(add, cfg, prefix, B, T, S, decode)
        elif blk == "mlstm":
            _mlstm_ops(add, cfg, prefix, B, T, S, decode)
        elif blk == "slstm":
            _slstm_ops(add, cfg, prefix, T)

    # lm head (runs whether or not embeddings are tied)
    add(_linear("head", T, cfg.d_model, cfg.vocab), 1, "head")

    return OpStream(
        model=cfg.name,
        shape=sh.name,
        kind=sh.kind,
        entries=b.entries(),
        backward_factor=3.0 if sh.kind == "train" else 1.0,
        meta={
            "tokens_per_step": T,
            "global_batch": B,
            "seq_len": S,
            "n_ops_pre_dedup": b.n_ops,
            "n_unique": len(b.entries()),
        },
    )


# --------------------------------------------------------------------- #
# FLOPs reconciliation (MODEL_FLOPS convention + dryrun artifacts)
# --------------------------------------------------------------------- #


def formula_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The MODEL_FLOPS convention: 6*N_active*tokens (train) /
    2*N_active*tokens (prefill) / 2*N_active*batch (decode).
    The reference's ``launch/dryrun.py`` embeds this number in every
    artifact."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def reconcile_model_flops(stream: OpStream,
                          cfg: Optional[ModelConfig] = None) -> Dict[str, float]:
    """Reconcile the stream's parameter-role FLOPs against the
    MODEL_FLOPS formula. Returns the ratio + the documented correction
    terms; callers assert ``RECONCILE_BAND[0] <= ratio <= RECONCILE_BAND[1]``.

    Corrections applied to the expectation:
      * tied embeddings: the lm head still runs a full T x d x vocab GEMM
        but num_params counts vocab*d once -- add it back;
      * everything else (MoE capacity padding above, norm/bias/conv
        deficit below) is what the band absorbs.
    """
    cfg = cfg or get_config(stream.model)
    bf = stream.backward_factor
    T = float(stream.meta["tokens_per_step"])
    expected = 2.0 * T * cfg.active_params() * bf
    corrections = {}
    if cfg.tie_embeddings:
        tied = 2.0 * T * cfg.vocab * cfg.d_model * bf
        expected += tied
        corrections["tied_head_flops"] = tied
    got = stream.param_flops()
    return {
        "stream_param_flops": got,
        "expected_flops": expected,
        "formula_model_flops": formula_model_flops(
            cfg, ShapeConfig(stream.shape, int(stream.meta["seq_len"]),
                             int(stream.meta["global_batch"]), stream.kind)),
        "ratio": got / expected if expected else float("inf"),
        "corrections": corrections,
        "band": RECONCILE_BAND,
    }


def artifact_path(model: str, shape: str, mesh: str = "16x16",
                  art_dir: TUnion[str, Path] = "experiments/dryrun") -> Path:
    return Path(art_dir) / f"{model}__{shape}__{mesh}.json"


def reconcile_with_artifact(stream: OpStream, art: TUnion[dict, str, Path]) -> Dict[str, float]:
    """Cross-check the stream against a dryrun ``cost_analysis()``
    artifact: stream FLOPs vs the structure-corrected per-device FLOPs
    summed over chips, and the artifact's embedded MODEL_FLOPS (which
    must match ``formula_model_flops`` exactly -- same formula).

    The stream/HLO ratio shares dryrun's own useful-FLOPs band
    ((0.05, 1.1]): compiled HLO includes remat recompute, masking and
    vector work the stream does not model, so the stream is a lower
    bound up to small einsum-accounting slack."""
    if not isinstance(art, dict):
        art = json.loads(Path(art).read_text())
    corrected = art.get("corrected", art)
    hlo_total = float(corrected["flops_per_device"]) * float(art["chips"])
    bytes_total = float(corrected["bytes_per_device"]) * float(art["chips"])
    return {
        "stream_flops": stream.total_flops(),
        "hlo_flops": hlo_total,
        "flops_ratio": stream.total_flops() / hlo_total if hlo_total else float("inf"),
        "stream_bytes": stream.total_bytes(),
        "hlo_bytes": bytes_total,
        "bytes_ratio": stream.total_bytes() / bytes_total if bytes_total else float("inf"),
        "model_flops_artifact": float(art["model_flops"]),
        "collective_bytes_per_device": float(
            corrected.get("collective_bytes_per_device", 0.0)),
    }


def measured_collective_s(art: TUnion[dict, str, Path]) -> float:
    """The roofline collective term fed from MEASURED hloparse bytes: the
    artifact's per-device collective link bytes over the ICI link
    bandwidth (``RooflineReport.from_artifact`` semantics)."""
    from repro_torch.core.cost.roofline import RooflineReport

    if not isinstance(art, dict):
        art = json.loads(Path(art).read_text())
    return RooflineReport.from_artifact(art.get("cell", "cell"), art).collective_s


# --------------------------------------------------------------------- #
# One-sweep driver + end-to-end aggregation
# --------------------------------------------------------------------- #


def stream_sweep_tasks(
    streams: Sequence[OpStream],
    arch: Architecture,
    mapper: str = "heuristic",
    cost_model: str = "timeloop",
    metric: str = "edp",
    constraints=None,
    mapper_kw: Optional[dict] = None,
):
    """Flatten model streams into ONE task list for ``union_opt_sweep``.
    Returns (tasks, index) where index[i] = (stream_idx, entry_idx) maps
    solutions back to entries (solutions come back in task order)."""
    from repro_torch.core.optimizer import SweepTask

    tasks, index = [], []
    for si, stream in enumerate(streams):
        for ei, e in enumerate(stream.entries):
            if not e.mappable:
                continue
            tasks.append(SweepTask(
                e.problem, arch, mapper=mapper, cost_model=cost_model,
                metric=metric, constraints=constraints,
                mapper_kw=dict(mapper_kw or {}),
                tag=(stream.model, stream.shape, e.role, e.problem.name),
            ))
            index.append((si, ei))
    return tasks, index


def _gather_cost(problem: Problem, arch: Architecture) -> Tuple[float, float]:
    """Analytic (latency_s, energy_j) for a non-mappable gather entry:
    a pure bandwidth term (read one embedding row + write it per token)
    at DRAM energy -- NOT the onehot-matmul FLOPs, which exist only to
    reconcile MODEL_FLOPS."""
    out = problem.outputs()[0]
    move_bytes = 2.0 * out.footprint_bytes(problem.dims)  # row read + out write
    bw = next((c.fill_bandwidth for c in arch.clusters
               if math.isfinite(c.fill_bandwidth)), 1e9)
    dram = arch.clusters[0]
    energy_pj = move_bytes * (dram.read_energy + dram.write_energy) / 2.0
    return move_bytes / bw, energy_pj * 1e-12


@dataclass
class ModelCost:
    """Multiplicity-weighted end-to-end cost of one model stream."""

    model: str
    shape: str
    latency_s: float
    energy_j: float
    collective_s: float
    roles: Dict[str, Dict[str, float]]
    n_unique_ops: int
    n_ops: float

    @property
    def edp(self) -> float:
        return self.energy_j * (self.latency_s + self.collective_s)

    def row(self) -> Dict[str, object]:
        return {
            "model": self.model, "shape": self.shape,
            "latency_s": self.latency_s, "energy_j": self.energy_j,
            "collective_s": self.collective_s, "edp": self.edp,
            "roles": self.roles, "n_unique_ops": self.n_unique_ops,
            "n_ops": self.n_ops,
        }


def aggregate_stream_costs(
    streams: Sequence[OpStream],
    index: Sequence[Tuple[int, int]],
    solutions: Sequence,
    arch: Architecture,
    collective_s: Optional[Dict[str, float]] = None,
) -> List[ModelCost]:
    """Fold per-op sweep solutions back into per-model end-to-end costs.

    Latency is the serialized multiplicity-weighted sum of per-op
    latencies (ops of one step run back-to-back on the modeled
    accelerator), energy the weighted sum; EDP = total energy x total
    latency. Non-mappable entries (gathers) contribute their analytic
    bandwidth term. ``collective_s`` (per model name) adds the measured
    hloparse collective term as a serial component."""
    per_entry: Dict[Tuple[int, int], object] = {}
    for (si, ei), sol in zip(index, solutions):
        per_entry[(si, ei)] = sol
    out: List[ModelCost] = []
    for si, stream in enumerate(streams):
        bf = stream.backward_factor
        lat = en = 0.0
        roles: Dict[str, Dict[str, float]] = {}
        for ei, e in enumerate(stream.entries):
            sol = per_entry.get((si, ei))
            if sol is not None:
                l = bf * e.multiplicity * sol.cost.latency_s
                j = bf * e.multiplicity * sol.cost.energy_j
            elif not e.mappable:
                l0, j0 = _gather_cost(e.problem, arch)
                l = bf * e.multiplicity * l0
                j = bf * e.multiplicity * j0
            else:  # mappable entry whose task was skipped upstream
                continue
            lat += l
            en += j
            r = roles.setdefault(e.role, {"latency_s": 0.0, "energy_j": 0.0, "flops": 0.0})
            r["latency_s"] += l
            r["energy_j"] += j
            r["flops"] += bf * e.flops
        out.append(ModelCost(
            model=stream.model, shape=stream.shape,
            latency_s=lat, energy_j=en,
            collective_s=float((collective_s or {}).get(stream.model, 0.0)),
            roles=roles,
            n_unique_ops=len(stream.entries),
            n_ops=float(stream.meta.get("n_ops_pre_dedup", len(stream.entries))),
        ))
    return out
