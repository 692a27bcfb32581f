"""Expert parallelism: the MoE feed-forward with experts over the ep axis.

The dense-dispatch formulation of the JAX package's ``parallel/moe.py``:
each ep shard owns E/ep experts, every token is evaluated against every
local expert with the gate probabilities of those experts (this shard's
slice, by ``axis_index("ep")``), and the gate-weighted contributions are
summed over ep by a psum (the identity at ep = 1); no capacity
dropping.  Top-k gating keeps the probabilities at or above the k-th
largest and renormalises them.  Differentiable end to end: the
top-k mask carries no gradient, the kept probabilities do.

The gate follows the JAX package's arithmetic, since at bf16 one ulp of
a probability can add or drop an expert at the top-k threshold: its
logits are the product summed in fp32 and rounded once to the operands'
type, as XLA's dot computes it (:func:`gate_product`), and its
probabilities follow ``jax.nn.softmax`` step by step in that type
(:func:`softmax`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .shard_map import axis_index, axis_size, psum


def gate_product(x: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,de->...e", x, gate_w)`` as XLA's dot computes it:
    the operands widened to fp32 (a bf16 product is exact there), the
    sum in fp32, the result rounded once to their promoted type.  A bf16
    ``torch.einsum`` on the card is a cuBLAS bf16 GEMM, which PyTorch's
    default lets reduce in bf16."""
    dt = torch.promote_types(x.dtype, gate_w.dtype)
    return torch.matmul(x.to(torch.promote_types(dt, torch.float32)),
                        gate_w.to(torch.promote_types(dt, torch.float32))
                        ).to(dt)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, with its roundings: ``exp``
    of the logits less their (non-differentiated) max in the logits'
    type, the sum of those in fp32 rounded back to that type, and the
    quotient in it.  ``torch.softmax`` computes a bf16 softmax in fp32
    and rounds once, so a quarter of its bf16 probabilities differ from
    JAX's by an ulp."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    return e / e.float().sum(dim=-1, keepdim=True).to(e.dtype)


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, axis_name: str = "ep", top_k: int = 2,
            gate_logits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., D]; gate_w: [D, E_total]; w1: [E_local, D, F]; w2:
    [E_local, F, D].  Returns [..., D].  Pass precomputed ``gate_logits``
    to share the gating product with the load-balance loss."""
    E_local = w1.shape[0]
    ep = axis_size(axis_name)
    E_total = E_local * ep
    if top_k < 1:
        raise ValueError(f"moe_ffn: top_k must be at least 1, got {top_k}")
    logits = (gate_logits if gate_logits is not None
              else gate_product(x, gate_w))
    probs = softmax(logits)
    if top_k < E_total:
        thresh = torch.topk(probs, top_k, dim=-1).values[..., -1:]
        probs = probs * (probs >= thresh)
        probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-9)
    if ep > 1:          # this shard's experts' probabilities
        i = axis_index(axis_name)
        probs = probs[..., i * E_local:(i + 1) * E_local]
    h = torch.einsum("...d,edf->...ef", x.float(), w1.float())
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("...ef,efd->...ed", h, w2.float())
    out = torch.einsum("...ed,...e->...d", y, probs.to(y.dtype))
    return psum(out, axis_name).to(x.dtype)


def load_balance_loss(gate_logits: torch.Tensor,
                      axis_name: str = "ep") -> torch.Tensor:
    """The Switch auxiliary load-balancing loss: E times the sum over
    experts of the mean gate probability and the fraction of tokens whose
    argmax is that expert (the first index on a tie)."""
    probs = softmax(gate_logits)
    E = probs.shape[-1]
    mean_prob = probs.reshape(-1, E).mean(dim=0)
    hard = F.one_hot(probs.argmax(dim=-1), E).to(probs.dtype)
    frac = hard.reshape(-1, E).mean(dim=0)
    return E * (mean_prob * frac).sum()
