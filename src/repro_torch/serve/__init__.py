"""Serving-tier daemons built on the search stack.

``mapping_service`` is the mapping-as-a-service daemon: mapping queries
(problem, arch, metric, mapper, budget) answered from the persistent
:class:`~repro_torch.core.cost.store.ResultStore` + answer journal in O(ms)
when warm, bounded deadline-enforced search on miss -- on the numpy engine
or on the torch backend's device programs.
"""

from repro_torch.serve.mapping_service import (  # noqa: F401
    MappingService,
    QueryError,
    query_fingerprint,
)
