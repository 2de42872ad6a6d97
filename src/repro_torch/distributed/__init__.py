"""repro_torch.distributed — sharding for the PyTorch port.

* :mod:`~repro_torch.distributed.plan` — the pure-data
  :class:`ShardingPlan` (mesh shape, per-buffer placements, the typed
  collective schedule), digest for digest the reference's;
* :mod:`~repro_torch.distributed.partition` — the partitioning pass
  (``replicate`` / ``dp`` / ``tp`` / ``dp_tp`` / ``auto``);
* :mod:`~repro_torch.distributed.collectives` — sizing the collectives,
  and running them over the local shards of a group of mesh positions;
* :mod:`~repro_torch.distributed.sharding` — the parameter, batch and
  cache partition-spec rules of the LM stack.
"""

from .collectives import (attach, build_steps, env_partition_specs,
                          make_collective)
from .partition import STRATEGIES, PartitionError, partition, propagate
from .plan import (COLLECTIVE_KINDS, CollectiveStep, MeshSpec, ShardingPlan,
                   ShardSpec)
from .sharding import (BATCH, P, ShardingSpecError, batch_specs, cache_specs,
                       param_specs, sanitize_spec, shard_hint)

__all__ = ["BATCH", "COLLECTIVE_KINDS", "CollectiveStep", "MeshSpec", "P",
           "PartitionError", "STRATEGIES", "ShardSpec", "ShardingPlan",
           "ShardingSpecError", "attach", "batch_specs", "build_steps",
           "cache_specs", "env_partition_specs", "make_collective",
           "param_specs", "partition", "propagate", "sanitize_spec",
           "shard_hint"]
