"""qwen2-moe-a2.7b [moe] -- 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,  # every layer is MoE
        vocab=151936,
        n_routed_experts=60,
        n_shared_experts=4,
        top_k=4,
        d_expert=1408,
        qkv_bias=True,
        act="silu",
        notes="all-MoE layers; shared experts always active; long_500k skipped",
    )
)
