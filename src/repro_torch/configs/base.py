"""Model configuration schema + registry (a copy of the jax-free
``repro/configs/base.py``: the fields, the properties the ported modules
read, ``reduced()`` and the registry).

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


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name.endswith("_smoke"):
        return _REGISTRY[name[: -len("_smoke")]].reduced()
    return _REGISTRY[name]
