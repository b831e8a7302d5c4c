from repro_torch.kernels.matmul.ops import MATMUL_H100, matmul, plan_tiles  # noqa: F401
