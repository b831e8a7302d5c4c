"""Plug-and-play mappers (paper Sec. III-B1).

Every mapper searches the SAME MapSpace and scores candidates with ANY
CostModel -- the unified mapping abstraction is what makes e.g. a
GAMMA-style genetic mapper usable with a Timeloop-like cost model, which
the paper highlights as impossible in the tightly-coupled status quo.
"""

from repro_torch.core.mappers.base import Mapper, SearchResult  # noqa: F401
from repro_torch.core.mappers.exhaustive import ExhaustiveMapper  # noqa: F401
from repro_torch.core.mappers.random_search import RandomMapper  # noqa: F401
from repro_torch.core.mappers.decoupled import DecoupledMapper  # noqa: F401
from repro_torch.core.mappers.genetic import GeneticMapper  # noqa: F401
from repro_torch.core.mappers.heuristic import HeuristicMapper  # noqa: F401

MAPPER_REGISTRY = {
    "exhaustive": ExhaustiveMapper,
    "random": RandomMapper,
    "decoupled": DecoupledMapper,
    "genetic": GeneticMapper,
    "heuristic": HeuristicMapper,
}


def get_mapper(name: str, **kw) -> Mapper:
    return MAPPER_REGISTRY[name](**kw)
