"""Distribution layer: the sharding rules, overlapped collectives, int8
gradient compression, GPipe, and the sharded train step's collectives,
on ``torch.distributed`` (NCCL on the card, gloo on the CPU)."""
from repro_torch.distributed.sharding import (
    batch_axes, batch_pspec, cache_pspecs, param_placements, param_pspecs,
    placements, rules_for, ShardingRules,
)

__all__ = [
    "batch_axes", "batch_pspec", "cache_pspecs", "param_placements", "param_pspecs", "placements", "rules_for",
    "ShardingRules",
]
