"""repro_torch.distributed — sharding for the PyTorch port.

* :mod:`~repro_torch.distributed.plan` — the pure-data
  :class:`ShardingPlan` (mesh shape, per-buffer placements, the typed
  collective schedule), digest for digest the reference's;
* :mod:`~repro_torch.distributed.partition` — the partitioning pass
  (``replicate`` / ``dp`` / ``tp`` / ``dp_tp`` / ``auto``);
* :mod:`~repro_torch.distributed.collectives` — sizing the collectives,
  running them over the local shards of a group of mesh positions, and
  the in-step ``psum`` / ``pmax`` / ``all_gather`` of ``shard_map``;
* :mod:`~repro_torch.distributed.sharding` — the parameter, batch and
  cache partition-spec rules of the LM stack, and the placement helpers
  (``use_mesh``, ``NamedSharding``, ``place``, ``shard_map``);
* :mod:`~repro_torch.distributed.spmd` — the lockstep executor of the LM
  stack's sharded train, serve and prefill steps;
* :mod:`~repro_torch.distributed.compression` — int8 gradient
  compression and ``compressed_allreduce``.
"""

from .collectives import (all_gather, attach, build_steps,
                          env_partition_specs, make_collective, pmax, psum)
from .partition import STRATEGIES, PartitionError, partition, propagate
from .plan import (COLLECTIVE_KINDS, CollectiveStep, MeshSpec, ShardingPlan,
                   ShardSpec)
from .sharding import (BATCH, NamedSharding, P, PlacedArray,
                       ShardingSpecError, as_shardings, batch_specs,
                       cache_specs, current_mesh, gather, param_shardings,
                       param_specs, place, replicated, sanitize_spec,
                       shard_hint, shard_map, use_mesh)

__all__ = ["BATCH", "COLLECTIVE_KINDS", "CollectiveStep", "MeshSpec",
           "NamedSharding", "P", "PartitionError", "PlacedArray",
           "STRATEGIES", "ShardSpec", "ShardingPlan", "ShardingSpecError",
           "all_gather", "as_shardings", "attach", "batch_specs",
           "build_steps", "cache_specs", "current_mesh",
           "env_partition_specs", "gather", "make_collective",
           "param_shardings", "param_specs", "partition", "place", "pmax",
           "propagate", "psum", "replicated", "sanitize_spec", "shard_hint",
           "shard_map", "use_mesh"]
