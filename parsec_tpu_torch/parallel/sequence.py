"""Ulysses-style sequence parallelism: all-to-all head<->sequence reshard.

Attention wants the full sequence per head, the rest of the model the
full heads per sequence chunk; an all-to-all over the sp axis converts
[B, H, T/sp, D] <-> [B, H/sp, T, D], attention runs locally on full
sequences, and the inverse all-to-all restores the layout.  At sp = 1
both all-to-alls are the identity, so the attention is local_attention
(the flash kernel on the card).
"""
from __future__ import annotations

import torch

from .mesh import axis_size
from .ring_attention import local_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp",
                      causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention via all-to-all resharding.
    q/k/v: [B, H, T_local, Dh] (H divisible by the sp axis size)."""
    sp = axis_size(axis_name)
    if q.shape[1] % sp:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by "
                         f"sp ({sp})")
    return local_attention(q, k, v, causal=causal)
