"""The port's co-design layer: one planner and one calibration loop for
the three kernels, on an H100 cluster hierarchy (a copy of
``repro/codesign`` on the port's own core).

  * :class:`KernelSpace` (``space.py``) is what a kernel registers: its
    mapping ``Problem``, ``Constraints``, a ``decode`` that reads the C1
    temporal tile out of a Union mapping, a binding ``legalize`` that
    turns any candidate into a CTA tile the compiled CUDA kernel takes,
    and safe defaults. Spaces plan on :func:`~repro_torch.core.
    architecture.h100_sm` under the shared-memory budget
    (:data:`~repro_torch.core.architecture.H100_SMEM_BUDGET`).
  * :func:`plan` (``planner.py``) is the one search path every kernel
    tile comes from (``ops.plan_tiles``, ``plan_blocks``, ``plan_chunk``):
    ``union_opt`` over the space, cached in a ResultStore.
  * ``calibrate.py`` closes the loop: it times the kernel per (kernel,
    shape, BlockConfig) -- CUDA events on the card -- and records it next
    to the model's prediction in a :class:`CalibrationTable`.
"""

from repro_torch.core.architecture import H100_SMEM_BUDGET  # noqa: F401
from repro_torch.codesign.space import (  # noqa: F401
    KernelSpace,
    all_spaces,
    get_space,
    register_space,
    round_up,
)
from repro_torch.codesign.planner import (  # noqa: F401
    PLAN_SEARCH_ERRORS,
    PLANNER_VERSION,
    Plan,
    get_plan_store,
    plan,
    plan_space_key,
    planner_stats,
    predict_cost,
    reset_planner_stats,
)
from repro_torch.codesign.calibrate import (  # noqa: F401
    CALIBRATION_VERSION,
    CalibrationScale,
    CalibrationTable,
    calibrate_kernel,
    measure_kernel,
)
