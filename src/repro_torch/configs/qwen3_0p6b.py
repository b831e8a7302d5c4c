"""qwen3-0.6b [dense] -- qk_norm + GQA [hf:Qwen/Qwen3-8B family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; head_dim=128
(qwen3 uses wide heads: 16H x 128 = 2048 > d_model), qk-norm, no bias.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1e6,
        act="silu",
        notes="qk-norm GQA; tied embeddings; long_500k skipped",
    )
)
