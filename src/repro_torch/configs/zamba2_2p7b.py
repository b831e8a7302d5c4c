"""zamba2-2.7b [hybrid] -- Mamba2 + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Zamba2 interleaves Mamba-2 blocks with a (shared-weight) full attention
block; the repeating unit is 5x mamba2 + 1x attn (9 units = 54L). The
attention block is instantiated per unit (same FLOPs; weight sharing only
changes parameter bytes).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab=32000,
        block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "attn"),
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        conv_width=4,
        act="silu",
        notes="hybrid SSM+attn; runs long_500k (constant-size SSM state, "
        "attention KV only at 9 shared blocks)",
    )
)
