"""Device mesh of the port: the reference's five named axes over
``torch.device``s, the sharding rules and shards of the ``expert`` and
``model`` axes, and the collectives of the one-process mesh (``data`` and
``pipe`` replicate; ``seq`` shards the KV pool by page range,
``ops/cp_paged_attention.py``)."""

from .mesh import (
    ALL_AXES,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    DeviceMesh,
    MeshConfig,
    axis_size,
    build_mesh,
)
from .sharding import (
    KV_PAGES_SPEC,
    ModelShardedPages,
    ShardedBlock,
    ShardedParams,
    ShardingRules,
    all_gather,
    all_reduce,
    broadcast,
    replicated_tree,
    shard_params,
)

__all__ = ["ALL_AXES", "AXIS_DATA", "AXIS_EXPERT", "AXIS_MODEL",
           "AXIS_PIPE", "AXIS_SEQ", "DeviceMesh", "KV_PAGES_SPEC",
           "MeshConfig", "ModelShardedPages", "ShardedBlock",
           "ShardedParams", "ShardingRules", "all_gather", "all_reduce",
           "axis_size", "broadcast", "build_mesh", "replicated_tree",
           "shard_params"]
