"""Meshes, sharding rules, annotations and collectives over
``torch.distributed`` (DTensor on a ``DeviceMesh``), plus ``fault``
(heartbeats, straggler detection, restarts)."""
from repro_torch.distributed.annotate import ann, logical_sharding, use_rules
from repro_torch.distributed.sharding import ShardingRules, rules_for_mesh

__all__ = ["ann", "logical_sharding", "use_rules", "ShardingRules", "rules_for_mesh"]
