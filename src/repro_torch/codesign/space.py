"""KernelSpace: the per-kernel half of the co-design contract (the port's
copy of ``repro/codesign/space.py``, planned on an H100).

A kernel package defines ONE :class:`KernelSpace` subclass and registers a
singleton instance. The space owns everything the planner
(:func:`repro_torch.codesign.planner.plan`) needs to turn a shape into a
legal BlockConfig:

  * ``problem(shape)``      -- the Union :class:`Problem` whose C1 temporal
                               tile IS the kernel's CTA tile,
  * ``constraints(shape)``  -- mapper constraints (tensor-core alignment),
  * ``arch(smem_budget)``   -- the cluster hierarchy mapped onto
                               (``h100_sm`` by default); legality rule R3
                               at C1 keeps every legal tile within the
                               shared-memory budget,
  * ``decode(mapping, shape)``   -- read the BlockConfig out of the C1
                               (innermost-level) temporal tile,
  * ``legalize(config, shape, smem_budget)`` -- repair ANY candidate into
                               a tile the compiled CUDA kernel takes,
  * ``default_config(shape)``    -- the no-search fallback seed (always
                               run through ``legalize``),
  * ``example_inputs``/``run``   -- the calibration hooks ``calibrate.py``
                               uses to time the kernel,
  * ``reference(inputs, config)`` -- the plain version ``run`` is held
                               against at a calibration shape and tile.

The **shared-memory budget convention**: every space defaults to
:data:`~repro_torch.core.architecture.H100_SMEM_BUDGET`, half of the 227 KB
a CTA may opt into, so two stages of operand tiles (or two CTAs) fit on an
SM -- the rule the TPU spaces applied to VMEM (8 MiB of 16 MiB).

Space names differ from the reference package's (``matmul_h100``, not
``matmul``): the plan store keys plans by space name, not by
architecture, so a shared store never hands a TPU plan to the H100.

``BlockConfig`` is a plain ``Tuple[int, ...]`` in ``decode_dims`` order --
it is stored in plan caches and calibration tables, so it stays a
JSON-friendly value type.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.architecture import H100_SMEM_BUDGET, Architecture, h100_sm
from repro_torch.core.constraints import Constraints
from repro_torch.core.mapping import Mapping
from repro_torch.core.mapspace import MapSpace, _divisors_cached
from repro_torch.core.problem import Problem

BlockConfig = Tuple[int, ...]


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return (x + m - 1) // m * m


def spread(tiles: Dict[str, int], fanout: int) -> Dict[str, int]:
    """How many CTAs of each grid dim run side by side: per dim a divisor
    of its tile count, with the largest product that is at most
    ``fanout`` (ties go to the first dims). ``tiles`` maps each grid dim
    to its number of tiles."""
    dims = list(tiles)
    best, best_prod = {d: 1 for d in dims}, 1
    for combo in itertools.product(*(_divisors_cached(int(tiles[d])) for d in dims)):
        prod = math.prod(combo)
        if best_prod < prod <= fanout:
            best, best_prod = dict(zip(dims, combo)), prod
    return best


class KernelSpace:
    """Base class of the per-kernel co-design contract (see module doc).

    Subclasses set the class attributes and implement the abstract
    methods; instances are stateless singletons registered via
    :func:`register_space`."""

    #: registry key; also the kernel label in plan caches + calibration
    name: str = "kernel"
    #: problem dims whose C1 temporal tile forms the BlockConfig, in order
    decode_dims: Tuple[str, ...] = ()
    #: problem dims the kernel's CTA grid runs over; the others are looped
    #: inside one CTA (a reduction is never split across CTAs)
    grid_dims: Tuple[str, ...] = ()
    #: shared-memory budget (see module doc)
    smem_budget: int = H100_SMEM_BUDGET
    #: default planner knobs (overridable per plan() call)
    mapper: str = "heuristic"
    cost_model: str = "timeloop"
    metric: str = "latency"
    search_budget: int = 400  # heuristic climb steps

    # ------------------------------------------------------------------ #
    # mapping space
    # ------------------------------------------------------------------ #
    def problem(self, shape: Sequence[int]) -> Problem:
        raise NotImplementedError

    def constraints(self, shape: Sequence[int]) -> Constraints:
        return Constraints()

    def arch(self, smem_budget: Optional[int] = None) -> Architecture:
        return h100_sm(smem_tile_budget=int(smem_budget or self.smem_budget))

    # ------------------------------------------------------------------ #
    # mapping -> BlockConfig
    # ------------------------------------------------------------------ #
    def decode(self, mapping: Mapping, shape: Sequence[int]) -> BlockConfig:
        """Read the BlockConfig from the C1 (innermost) temporal tile."""
        leaf = mapping.levels[-1]
        return tuple(int(leaf.tt(d)) for d in self.decode_dims)

    def legalize(
        self,
        config: BlockConfig,
        shape: Sequence[int],
        smem_budget: Optional[int] = None,
    ) -> BlockConfig:
        raise NotImplementedError

    def default_config(self, shape: Sequence[int]) -> BlockConfig:
        """No-search seed; the planner always legalizes it before use."""
        return tuple(0 for _ in self.decode_dims)

    # ------------------------------------------------------------------ #
    # BlockConfig -> canonical mapping (for cost prediction)
    # ------------------------------------------------------------------ #
    def block_tiles(
        self, shape: Sequence[int], config: BlockConfig
    ) -> Dict[str, int]:
        """Problem-dim -> C1 temporal tile for a given BlockConfig (dims
        omitted here stay fully resident, tile == full extent)."""
        return dict(zip(self.decode_dims, config))

    def launched_shape(
        self, shape: Sequence[int], config: BlockConfig
    ) -> Tuple[int, ...]:
        """The shape the launched grid covers. A kernel that masks its
        ragged edges computes whole tiles, so its spaces round the tiled
        dims up to the tile here; the default is ``shape`` itself."""
        return tuple(int(s) for s in shape)

    def canonical_mapping(
        self,
        shape: Sequence[int],
        config: BlockConfig,
        arch: Optional[Architecture] = None,
    ) -> Tuple[Problem, Mapping, Architecture]:
        """The mapping a BlockConfig denotes on this space's hierarchy.

        The C1 tile is the CTA tile at every level below the outermost.
        At the outermost level the CTA grid spreads over the next level's
        fanout (the SMs): each grid dim is split over as many SMs as
        :func:`spread` gives, and the CTA level's temporal loop walks the
        tiles one SM works through. On a hierarchy whose grid level has
        fanout 1 (the TPU's, where grid steps run in order on one core)
        nothing spreads and this is the reference package's mapping: full
        problem outermost, the block tile at every level below. This is
        what the calibration layer evaluates to get the model's predicted
        cycles for the exact launched config."""
        problem = self.problem(self.launched_shape(shape, config))
        arch = arch or self.arch()
        tiles = self.block_tiles(shape, config)
        full_of = dict(problem.dims)
        for d, full in full_of.items():
            t = int(tiles.get(d, full))
            if t <= 0 or full % t != 0:
                raise ValueError(
                    f"{self.name}: block tile {t} does not divide dim "
                    f"{d}={full} (legalize first)"
                )
        fanout = arch.clusters[1].fanout if arch.n_levels > 1 else 1
        par = spread(
            {d: full_of[d] // int(tiles.get(d, full_of[d])) for d in self.grid_dims
             if d in full_of},
            fanout,
        )
        chains: Dict[str, Tuple[int, ...]] = {}
        for d, full in full_of.items():
            t = int(tiles.get(d, full))
            chain = [int(full), int(full) // par.get(d, 1)]
            for _ in range(arch.n_levels - 1):
                chain += [t, t]
            chains[d] = tuple(chain)
        space = MapSpace(problem, arch, None)
        return problem, space._chain_to_mapping(chains), arch

    # ------------------------------------------------------------------ #
    # calibration hooks (optional; NotImplementedError disables
    # measurement for this space)
    # ------------------------------------------------------------------ #
    def example_inputs(self, shape: Sequence[int], device, generator):
        """Representative tensors at ``shape`` on ``device``, drawn from
        the seeded ``torch.Generator``."""
        raise NotImplementedError

    def run(self, inputs, config: BlockConfig):
        """Run the kernel on ``inputs`` with the given BlockConfig (the
        plain version on a CPU tensor); return its output(s)."""
        raise NotImplementedError

    def reference(self, inputs, config: BlockConfig):
        """The kernel's plain version on the same ``inputs``: what
        ``run(inputs, config)`` must equal, to the kernel's tolerance."""
        raise NotImplementedError


# ---------------------------------------------------------------------- #
# registry
# ---------------------------------------------------------------------- #
_REGISTRY: Dict[str, KernelSpace] = {}


def register_space(space: KernelSpace) -> KernelSpace:
    """Register a kernel's space singleton (idempotent by name)."""
    _REGISTRY[space.name] = space
    return space


def get_space(name: str) -> KernelSpace:
    if name not in _REGISTRY:
        all_spaces()  # trigger kernel-package registration
    return _REGISTRY[name]


def all_spaces() -> Dict[str, KernelSpace]:
    """All registered spaces, importing the port's kernel packages first
    (they register their spaces at import time)."""
    import importlib

    for mod in (
        "repro_torch.kernels.matmul.ops",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.kernels.ssd_scan.ops",
    ):
        importlib.import_module(mod)
    return dict(_REGISTRY)
