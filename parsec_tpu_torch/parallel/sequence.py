"""Ulysses-style sequence parallelism: all-to-all head<->sequence reshard.

Attention wants the full sequence per head, the rest of the model the
full heads per sequence chunk; an all-to-all over the sp axis converts
[B, H, T/sp, D] <-> [B, H/sp, T, D], attention runs locally on full
sequences (the flash kernel on the card), and the inverse all-to-all
restores the layout.  At sp = 1 both all-to-alls are the identity.
"""
from __future__ import annotations

import torch

from .ring_attention import local_attention
from .shard_map import all_to_all, axis_size


def heads_to_sequence(x: torch.Tensor, axis_name: str = "sp") -> torch.Tensor:
    """[B, H, T_local, Dh] -> [B, H_local, T, Dh]: scatter heads, gather
    the sequence."""
    return all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)


def sequence_to_heads(x: torch.Tensor, axis_name: str = "sp") -> torch.Tensor:
    """[B, H_local, T, Dh] -> [B, H, T_local, Dh]: the inverse reshard."""
    return all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp",
                      causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention via all-to-all resharding.
    q/k/v: [B, H, T_local, Dh] (H divisible by the sp axis size)."""
    sp = axis_size(axis_name)
    if q.shape[1] % sp:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by "
                         f"sp ({sp})")
    if sp == 1:
        return local_attention(q, k, v, causal=causal)
    qg, kg, vg = (heads_to_sequence(x, axis_name).contiguous()
                  for x in (q, k, v))
    out = local_attention(qg, kg, vg, causal=causal)
    return sequence_to_heads(out, axis_name)
