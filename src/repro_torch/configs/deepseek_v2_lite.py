"""deepseek-v2-lite-16b [moe] -- MLA kv_lora=512 [arXiv:2405.04434].

27L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=102400.
MoE: 64 routed experts top-6 + 2 shared, first layer dense (d_ff=10944).
NOTE: the assignment line mentions both "64e top-6" and "160 routed"; 160
routed belongs to full DeepSeek-V2 -- V2-Lite (hf config) is 64 routed +
2 shared, top-6, which we follow (recorded in DESIGN.md).
MLA: kv_lora_rank=512, rope_head_dim=64, nope=128, v_head=128, no q-lora.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # dense first layer FFN width
        vocab=102400,
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_expert=1408,
        first_k_dense=1,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        act="silu",
        notes="MLA latent KV cache; EP over model axis; long_500k skipped",
    )
)
