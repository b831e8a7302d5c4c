"""Mini-MLIR dialect stack (paper Sec. III-A).

Three levels, mirroring the paper's TOSA/Linalg/Affine pipeline:

  LayerOp       -- domain op ("TOSA/TA-level"): linear, conv2d, attention...
  EinsumGeneric -- language-independent contraction ("Linalg-generic-level")
  AffineLoopNest-- perfectly-nested affine loops ("Affine-level")

plus the final lowering into a Union ``Problem`` and:

  ttgt          -- TC -> transpose-transpose-GEMM-transpose rewriting
                   (algorithm exploration, paper Sec. V-A)
  conformability-- cost-model-dependent conformability passes
"""

from repro_torch.core.ir.dialects import AffineLoopNest, EinsumGeneric, LayerOp, TensorType  # noqa: F401
from repro_torch.core.ir.lowering import (  # noqa: F401
    affine_to_problem,
    layer_to_generic,
    generic_to_affine,
    lower_layer_to_problem,
)
from repro_torch.core.ir.ttgt import TTGTPlan, enumerate_ttgt_plans, best_ttgt_plan  # noqa: F401
from repro_torch.core.ir.conformability import conformable_models, ConformabilityReport  # noqa: F401
