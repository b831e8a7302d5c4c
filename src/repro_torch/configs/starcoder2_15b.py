"""starcoder2-15b [dense] -- GQA, RoPE [arXiv:2402.19173].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. StarCoder2 uses
bias on projections and gelu MLP (non-gated).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab=49152,
        qkv_bias=True,
        rope_theta=1e5,
        act="gelu",
        notes="GQA kv=4; gelu (non-gated) FFN; long_500k skipped",
    )
)
