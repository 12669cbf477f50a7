"""Multi-device sharding of the block step (torch twin of
brutefir_tpu.parallel): one process drives an ('f', 'sp') grid of shards."""

from .mesh import (Mesh, ShardedGraph, Sharded, auto_mesh, make_mesh,
                   shardable)

__all__ = ["Mesh", "ShardedGraph", "Sharded", "auto_mesh", "make_mesh",
           "shardable"]
