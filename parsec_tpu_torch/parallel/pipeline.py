"""Pipeline parallelism: the GPipe microbatch schedule over the pp axis.

With S stages and M microbatches GPipe runs M + S - 1 ticks, stage s
working on microbatch t - s at tick t and sending its output on to stage
s + 1.  At pp = 1 the one stage runs the M microbatches in order and
sends nothing.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .mesh import axis_size


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params: Any, x_micro: torch.Tensor,
          axis_name: str = "pp") -> torch.Tensor:
    """Run the pipeline.  ``stage_fn(stage_params, x)`` applies this
    shard's stage to one microbatch; ``x_micro`` is [M, mb, ...].
    Returns the last stage's outputs, [M, mb, ...]."""
    axis_size(axis_name)
    return torch.stack([stage_fn(stage_params, x_micro[t])
                        for t in range(x_micro.shape[0])])


def last_stage_value(x: torch.Tensor, axis_name: str = "pp") -> torch.Tensor:
    """The last pp stage's value, on every stage; at pp = 1 it is ``x``."""
    axis_size(axis_name)
    return x
