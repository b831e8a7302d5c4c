"""codeqwen1.5-7b [dense] -- qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440 vocab=92416, QKV bias
(qwen1.5 family uses attention QKV bias), SwiGLU, RoPE.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab=92416,
        qkv_bias=True,
        rope_theta=1e6,
        act="silu",
        notes="full-attention dense LM; long_500k skipped (quadratic attn)",
    )
)
