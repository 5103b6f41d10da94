"""Device mesh of the port: the reference's five named axes over
``torch.device``s, the sharding rules and shards of the ``expert`` and
``model`` axes, and their collectives (``data`` and ``pipe`` replicate;
``seq`` shards the KV pool by page range, ``ops/cp_paged_attention.py``).
A mesh may span processes (``process_mesh``, after
``multihost.initialize``): each rank holds its coordinates' shards and the
collectives cross the ranks over the axes' process groups."""

from .mesh import (
    ALL_AXES,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    GROUP_AXES,
    DeviceMesh,
    MeshConfig,
    ProcessLayout,
    axis_size,
    build_mesh,
    process_mesh,
)
from .sharding import (
    KV_PAGES_SPEC,
    ModelShardedPages,
    ShardedBlock,
    ShardedParams,
    ShardingRules,
    all_gather,
    all_parts,
    all_reduce,
    broadcast,
    replicated_tree,
    shard_params,
)

__all__ = ["ALL_AXES", "AXIS_DATA", "AXIS_EXPERT", "AXIS_MODEL",
           "AXIS_PIPE", "AXIS_SEQ", "DeviceMesh", "GROUP_AXES",
           "KV_PAGES_SPEC", "MeshConfig", "ModelShardedPages",
           "ProcessLayout", "ShardedBlock", "ShardedParams",
           "ShardingRules", "all_gather", "all_parts", "all_reduce",
           "axis_size", "broadcast", "build_mesh", "process_mesh",
           "replicated_tree", "shard_params"]
