"""Model/shape configuration schema + registry (a copy of the jax-free
``repro/configs/base.py``).

Every assigned architecture is a ``ModelConfig``; the four input-shape
regimes are ``ShapeConfig``s. A (ModelConfig, ShapeConfig) pair defines one
cell of the whole-model operator streams (``core/opstream.py``).
``reduced()`` gives the CPU-smoke-test version of a config.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 => d_model // n_heads

    # attention flags
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    encoder_only: bool = False

    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_k_dense: int = 0  # leading dense layers (DeepSeek style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM / hybrid: repeating block pattern; n_layers % len(pattern) == 0
    block_pattern: Tuple[str, ...] = ("attn",)  # attn | mamba2 | mlstm | slstm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4

    # modality stub frontends
    frontend: str = "none"  # none | vision_stub | audio_stub
    d_frontend: int = 0
    n_frontend_tokens: int = 0  # tokens contributed by the frontend

    # norm / act
    rms_eps: float = 1e-6
    act: str = "silu"

    notes: str = ""

    # ------------------------------------------------------------------ #
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_units(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern len {len(self.block_pattern)}"
        )
        return self.n_layers // len(self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k (sub-quadratic sequence handling)?"""
        return any(b in ("mamba2", "mlstm", "slstm") for b in self.block_pattern)

    # ------------------------------------------------------------------ #
    def num_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and sanity)."""
        d, h, kv, hd, ff, v = (
            self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
            self.d_ff, self.vocab,
        )
        per_block: Dict[str, int] = {}
        if self.use_mla:
            attn = (
                d * self.kv_lora_rank  # kv down
                + d * self.rope_head_dim  # shared rope key
                + self.kv_lora_rank * h * (self.nope_head_dim + self.v_head_dim)
                + (d * self.q_lora_rank + self.q_lora_rank * h *
                   (self.nope_head_dim + self.rope_head_dim)
                   if self.q_lora_rank else d * h * (self.nope_head_dim + self.rope_head_dim))
                + h * self.v_head_dim * d  # out proj
            )
        else:
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qkv_bias:
                attn += (h + 2 * kv) * hd
        per_block["attn"] = attn + 2 * d  # + norms
        if self.n_routed_experts:
            expert = 3 * d * self.d_expert
            moe = (
                self.n_routed_experts * expert
                + self.n_shared_experts * expert
                + d * self.n_routed_experts  # router
            )
            per_block["ffn"] = moe + d
            per_block["ffn_dense"] = 3 * d * ff + d if ff else 0
        else:
            if self.act in ("silu", "swiglu"):
                per_block["ffn"] = 3 * d * ff + d
            else:
                per_block["ffn"] = 2 * d * ff + d
        # ssm blocks
        di, n, g, p = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_head_dim
        nh = self.n_ssm_heads if self.ssm_state else 0
        per_block["mamba2"] = (
            d * (2 * di + 2 * g * n + nh) + self.conv_width * (di + 2 * g * n)
            + nh * 2 + di + di * d + 2 * d
        ) if self.ssm_state else 0
        per_block["mlstm"] = (4 * d * d + d * d + 3 * d + 2 * d) if "mlstm" in self.block_pattern else 0
        # slstm: 4 gates x (input + per-head recurrent)
        hd_s = d // max(1, self.n_heads)
        per_block["slstm"] = (
            4 * d * d + 4 * self.n_heads * hd_s * hd_s + 4 * d + 2 * d
        ) if "slstm" in self.block_pattern else 0

        total = 0
        for i, b in enumerate(self.block_pattern * self.n_units):
            if b == "attn":
                total += per_block["attn"]
                if self.family not in ("hybrid",):
                    layer_idx = i
                    if self.n_routed_experts and layer_idx >= self.first_k_dense:
                        total += per_block["ffn"]
                    elif self.n_routed_experts:
                        total += per_block["ffn_dense"]
                    elif self.d_ff:
                        total += per_block["ffn"]
            elif b == "mamba2":
                total += per_block["mamba2"]
            elif b == "mlstm":
                total += per_block["mlstm"]
            elif b == "slstm":
                total += per_block["slstm"]
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        if self.frontend != "none":
            total += self.d_frontend * d + d * d  # projector MLP
        return int(total)

    def active_params(self) -> int:
        """Per-token active parameters (MoE: only top_k + shared experts)."""
        if not self.n_routed_experts:
            return self.num_params()
        expert = 3 * self.d_model * self.d_expert
        inactive = (self.n_routed_experts - self.top_k) * expert
        n_moe_layers = self.n_layers - self.first_k_dense
        return self.num_params() - n_moe_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        pat = self.block_pattern
        return replace(
            self,
            name=self.name + "_smoke",
            n_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_routed_experts=min(self.n_routed_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2),
            d_expert=32 if self.d_expert else 0,
            first_k_dense=min(self.first_k_dense, 1),
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            q_lora_rank=0,
            rope_head_dim=8 if self.use_mla else self.rope_head_dim,
            nope_head_dim=16 if self.use_mla else self.nope_head_dim,
            v_head_dim=16 if self.use_mla else self.v_head_dim,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            d_frontend=32 if self.d_frontend else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name.endswith("_smoke"):
        return _REGISTRY[name[: -len("_smoke")]].reduced()
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def runnable_cells() -> Tuple[Tuple[str, str], ...]:
    """All (arch, shape) dry-run cells after the mandated skip rules."""
    cells = []
    for name in list_configs():
        cfg = _REGISTRY[name]
        for shape in SHAPES.values():
            if shape.kind == "decode" and not cfg.supports_decode:
                continue  # encoder-only: no autoregressive step
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue  # needs sub-quadratic attention
            cells.append((name, shape.name))
    return tuple(cells)
