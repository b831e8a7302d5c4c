"""xlstm-1.3b [ssm] -- sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304. xLSTM blocks carry their
own up/down projections (d_ff=0: no separate FFN). We use the paper's
mostly-mLSTM ratio: repeating unit = 5x mLSTM + 1x sLSTM (8 units = 48L).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
        ssm_expand=2,
        ssm_head_dim=512,
        act="gelu",
        notes="pure recurrent; runs long_500k; d_ff=0 (projections inside blocks)",
    )
)
