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


def gpipe(stage_fn: Callable[[Any, torch.Tensor], Any], stage_params: Any,
          x_micro: torch.Tensor, axis_name: str = "pp",
          with_aux: bool = False) -> Any:
    """Run the pipeline.  ``stage_fn(stage_params, x)`` applies this
    shard's stage to one microbatch; ``x_micro`` is [M, mb, ...].
    Returns the last stage's outputs, [M, mb, ...].

    with_aux: ``stage_fn`` returns ``(y, aux_scalar)`` and gpipe returns
    ``(outs, aux_sum)``, the stage's aux summed over the microbatches
    (every tick does real work at pp = 1)."""
    axis_size(axis_name)
    results = [stage_fn(stage_params, x_micro[t])
               for t in range(x_micro.shape[0])]
    if not with_aux:
        return torch.stack(results)
    ys, auxes = zip(*results)
    aux_sum = auxes[0]
    for aux in auxes[1:]:
        aux_sum = aux_sum + aux
    return torch.stack(ys), aux_sum


def last_stage_value(x: torch.Tensor, axis_name: str = "pp") -> torch.Tensor:
    """The last pp stage's value, on every stage; at pp = 1 it is ``x``."""
    axis_size(axis_name)
    return x
