"""Plug-and-play accelerator cost models (paper Sec. III-B2).

All cost models implement the same interface (``base.CostModel``) and
consume the same (Problem, Mapping, Architecture) triple -- that is the
paper's interoperability contribution: any mapper can drive any model.

  timeloop_like -- hierarchical memory-target analytical model
                   (per-level access counts + bandwidth roofline)
  maestro_like  -- cluster data-centric model (NoC multicast energy,
                   per-cluster scheduling)
  roofline      -- TPU v5e three-term roofline (compute/memory/collective);
                   a model of a TPU-like accelerator, not of the H100
"""

from repro_torch.core.cost.base import Cost, CostModel  # noqa: F401
from repro_torch.core.cost.engine import EngineStats, EvaluationEngine, mapping_signature  # noqa: F401
from repro_torch.core.cost.store import ResultStore  # noqa: F401
from repro_torch.core.cost.timeloop_like import TimeloopLikeModel  # noqa: F401
from repro_torch.core.cost.maestro_like import MaestroLikeModel  # noqa: F401
from repro_torch.core.cost.roofline import TPURooflineModel  # noqa: F401
