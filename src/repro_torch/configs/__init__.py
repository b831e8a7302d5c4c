"""Architecture configs ported so far: qwen3-0.6b (attention only) and
zamba2-2.7b (Mamba-2 + attention)."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    register,
)

# import for registration side effects
from repro_torch.configs import qwen3_0p6b, zamba2_2p7b  # noqa: F401
