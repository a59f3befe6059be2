"""Logical-axis sharding rules of the port (:mod:`.rules`)."""
from repro_torch.sharding.rules import (  # noqa: F401
    Placements, ShardingRules, batch_axes, current_rules, default_rules,
    logical_spec, mesh_context, mesh_shape, placements, shard_act,
)
