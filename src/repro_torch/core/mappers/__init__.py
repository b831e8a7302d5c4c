"""Plug-and-play mappers (paper Sec. III-B1).

Every mapper searches the SAME MapSpace and scores candidates with ANY
CostModel. The port has the heuristic mapper, which the co-design planner
uses; the others wait their turn in :data:`QUEUED_MAPPERS`.
"""

from repro_torch.core.mappers.base import Mapper, SearchResult  # noqa: F401
from repro_torch.core.mappers.heuristic import HeuristicMapper  # noqa: F401


class _Registry(dict):
    def __missing__(self, name):
        queued = f" (queued to be ported: {name!r})" if name in QUEUED_MAPPERS else ""
        raise KeyError(
            f"mapper {name!r} is not in the port{queued}; it has {sorted(self)}, "
            f"and {sorted(QUEUED_MAPPERS)} are still to be ported"
        )


#: mappers of the reference package that the port does not have yet
QUEUED_MAPPERS = ("decoupled", "exhaustive", "genetic", "random")

MAPPER_REGISTRY = _Registry(heuristic=HeuristicMapper)


def get_mapper(name: str, **kw) -> Mapper:
    return MAPPER_REGISTRY[name](**kw)
