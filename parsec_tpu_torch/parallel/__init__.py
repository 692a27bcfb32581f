"""Mesh-level parallelism for the transformer: the five canonical axes
(dp/pp/tp/sp/ep), ring and Ulysses attention, the GPipe schedule and the
expert-parallel MoE feed-forward, over a mesh of chips by
``shard_map_compat`` (parallel/shard_map.py: one thread a shard, every
collective one autograd node over its group).  Outside a shard every
axis has size 1.  The reduced-precision collectives of the distributed
wave live in ``mesh``."""
from .mesh import (AXES, Chip, Mesh, PartitionSpec, axis_index, axis_size,
                   make_mesh, shard_map_compat, shard_map_fwd, spec,
                   sync_axes)
from .ring_attention import local_attention, ring_attention
from .sequence import heads_to_sequence, sequence_to_heads, ulysses_attention
from .pipeline import gpipe, last_stage_value
from .moe import load_balance_loss, moe_ffn
from .shard_map import all_to_all, pmean, ppermute, psum

__all__ = ["AXES", "Chip", "Mesh", "PartitionSpec", "make_mesh", "spec",
           "sync_axes", "shard_map_compat", "shard_map_fwd", "axis_size",
           "axis_index", "psum", "pmean", "ppermute", "all_to_all",
           "ring_attention", "local_attention", "ulysses_attention",
           "heads_to_sequence", "sequence_to_heads", "gpipe",
           "last_stage_value", "moe_ffn", "load_balance_loss"]
