"""Pipeline parallelism: the GPipe microbatch schedule over the pp axis.

With S stages and M microbatches GPipe runs M + S - 1 ticks, stage s
working on microbatch t - s at tick t and sending its output on to stage
s + 1 by ``ppermute``.  The JAX package's stages also compute on their
buffers in the bubble ticks (garbage it masks out); here a stage skips a
bubble tick and sends zeros, so the results are unchanged and a stage
computes exactly its M microbatches.  At pp = 1 the one stage runs the
M microbatches in order and sends nothing.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .shard_map import axis_index, axis_size, ppermute, psum


def gpipe(stage_fn: Callable[[Any, torch.Tensor], Any], stage_params: Any,
          x_micro: torch.Tensor, axis_name: str = "pp",
          with_aux: bool = False) -> Any:
    """Run the pipeline.  ``stage_fn(stage_params, x)`` applies this
    shard's stage to one microbatch (its output has the input's shape);
    ``x_micro`` is [M, mb, ...], of which stage 0 consumes its own.
    Returns [M, mb, ...] outputs, valid ON THE LAST STAGE ONLY (zeros on
    the others; reduce with :func:`last_stage_value`).

    with_aux: ``stage_fn`` returns ``(y, aux_scalar)`` and gpipe returns
    ``(outs, aux_sum)``, this stage's aux summed over the microbatches it
    worked on."""
    S = axis_size(axis_name)
    M = x_micro.shape[0]
    if S == 1:
        results = [stage_fn(stage_params, x_micro[t]) for t in range(M)]
        if not with_aux:
            return torch.stack(results)
        ys, auxes = zip(*results)
        aux_sum = auxes[0]
        for aux in auxes[1:]:
            aux_sum = aux_sum + aux
        return torch.stack(ys), aux_sum
    idx = axis_index(axis_name)
    fwd = [(i, i + 1) for i in range(S - 1)]
    buf = None
    outs = [None] * M
    aux_sum = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    for t in range(M + S - 1):
        mb = t - idx              # the microbatch this stage works on
        if 0 <= mb < M:
            y = stage_fn(stage_params, x_micro[mb] if idx == 0 else buf)
            if with_aux:
                y, aux = y
                aux_sum = aux_sum + aux
            if idx == S - 1:
                outs[mb] = y
        else:                     # a bubble tick: nothing to compute
            y = torch.zeros_like(x_micro[0])
        if t < M + S - 2:         # the last tick's send reaches no one
            buf = ppermute(y, axis_name, fwd)
    zero = torch.zeros_like(x_micro[0])
    out = torch.stack([zero if o is None else o for o in outs])
    return (out, aux_sum) if with_aux else out


def last_stage_value(x: torch.Tensor, axis_name: str = "pp") -> torch.Tensor:
    """The last pp stage's value on every stage (a masked psum); at
    pp = 1 it is ``x``."""
    S = axis_size(axis_name)
    if S == 1:
        return x
    mine = x if axis_index(axis_name) == S - 1 else torch.zeros_like(x)
    return psum(mine, axis_name)
