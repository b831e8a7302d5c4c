"""Sharding rules, their DTensor placements, and activation hints."""

from repro_torch.sharding.specs import (  # noqa: F401
    P,
    ShardingRules,
    batch_specs,
    cache_specs,
    named,
    param_specs,
    placements,
    state_specs,
)
