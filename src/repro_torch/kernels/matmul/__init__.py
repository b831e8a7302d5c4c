from repro_torch.kernels.matmul.matmul import instance_for  # noqa: F401
from repro_torch.kernels.matmul.ops import (  # noqa: F401
    MATMUL_BF16_H100,
    MATMUL_H100,
    matmul,
    plan_for,
    plan_tiles,
    tiles_from_mapping,
)
