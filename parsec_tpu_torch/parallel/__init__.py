"""Mesh-level parallelism for the transformer: the five canonical axes
(dp/pp/tp/sp/ep), ring and Ulysses attention, the GPipe schedule and the
expert-parallel MoE feed-forward.

This package runs on one device, where every axis has size 1: the ring
is one step over the diagonal block, the all-to-alls, the pipeline's
sends and the experts' psum are the identity.  Collectives over several
devices are SPMD (ROADMAP Queue 1, part D2b).  The
reduced-precision collectives of the distributed wave live in ``mesh``."""
from .mesh import AXES, Chip, Mesh, axis_size, make_mesh
from .ring_attention import local_attention, ring_attention
from .sequence import ulysses_attention
from .pipeline import gpipe, last_stage_value
from .moe import load_balance_loss, moe_ffn

__all__ = ["AXES", "Chip", "Mesh", "make_mesh", "axis_size", "ring_attention",
           "local_attention", "ulysses_attention", "gpipe",
           "last_stage_value", "moe_ffn", "load_balance_loss"]
