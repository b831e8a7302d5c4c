"""Architecture configs ported so far (only the attention-only qwen3-0.6b)."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    register,
)

# import for registration side effects
from repro_torch.configs import qwen3_0p6b  # noqa: F401
