"""llava-next-34b [vlm] -- anyres tiling [hf:llava-hf/llava-v1.6 family].

Backbone: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision tower is a STUB: input_specs() provides precomputed anyres
patch embeddings (n_frontend_tokens x d_frontend) which a 2-layer MLP
projector maps into the LM embedding space (the llava recipe).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        rope_theta=5e6,
        frontend="vision_stub",
        d_frontend=1024,  # CLIP-L/14 penultimate features
        n_frontend_tokens=2880,  # anyres: base 576 + 4 tiles x 576
        act="silu",
        notes="vision frontend stubbed as precomputed patch embeddings; "
        "long_500k skipped (quadratic attn)",
    )
)
