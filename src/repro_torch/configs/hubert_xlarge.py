"""hubert-xlarge [audio] -- encoder-only [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means target codebook).
The 7-layer strided conv feature extractor is a STUB: input_specs()
provides precomputed 20ms frame embeddings (d_frontend=512) projected into
d_model. Encoder-only: bidirectional attention, no decode shapes.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        encoder_only=True,
        frontend="audio_stub",
        d_frontend=512,
        act="gelu",
        notes="encoder-only w2v2-style stack; decode_32k/long_500k skipped",
    )
)
