"""Architecture configs: the 10 assigned architectures (copies of
``repro/configs``). The model code ports some block kinds only
(``models/model.py`` raises for the others); the operator streams of
``core/opstream.py`` need only the config."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_configs,
    register,
    runnable_cells,
)

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    deepseek_v2_lite,
    hubert_xlarge,
    llava_next_34b,
    qwen2_moe_a2p7b,
    qwen3_0p6b,
    qwen15_110b,
    starcoder2_15b,
    xlstm_1p3b,
    zamba2_2p7b,
)
