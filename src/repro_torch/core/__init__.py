"""Union core: the paper's primary contribution.

Unified abstractions (paper Sec. IV):
  problem       -- tensor operation as dims + data-spaces + affine projections
  architecture  -- logical cluster-target hardware description
  mapping       -- cluster-target loop-centric mapping + legality rules
  mapspace      -- map-space enumeration with pruning
  constraints   -- user constraint files (paper Sec. IV-E)
  cost          -- plug-and-play cost models (Timeloop-like, MAESTRO-like)
  mappers       -- plug-and-play mappers (heuristic; the others are queued)
  ir            -- mini-MLIR dialect stack + lowering + conformability
"""

from repro_torch.core.problem import Problem, DataSpace, AffineExpr, Term  # noqa: F401
from repro_torch.core.architecture import Architecture, Cluster  # noqa: F401
from repro_torch.core.mapping import Mapping, LevelMapping  # noqa: F401
