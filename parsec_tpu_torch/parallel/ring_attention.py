"""Ring attention: sequence-parallel exact attention, and the plain
single-shard attention it is checked against.

Each sp shard holds a local Q/K/V sequence chunk; K/V blocks go round
the ring while a flash-style online softmax merges each block's partial
result by its running max and denominator.  On one device sp = 1: the
ring is one step, over the shard's own (diagonal) block, masked
causally.  The block's local attention is the flash stats kernel
(ops/kernels.py) on the card, or the plain online softmax.  The kernel
path is differentiable through its own VJP, as the JAX package's is: the
backward recomputes through the plain ring.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import kernels
from ..ops.kernels import NEG_INF
from .mesh import axis_size


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q, k, v: [B, H, T_local, Dh] per-shard chunks of the ``axis_name``
    ring.  Returns [B, H, T_local, Dh].

    ``use_kernel`` selects each step's local compute: the flash stats
    kernel, with the block's softmax statistics merged into the running
    state, or the plain online softmax.  None = the kernel on a CUDA
    tensor.  True on a CPU tensor runs the same merge over the kernel's
    plain version."""
    axis_size(axis_name)   # the ring's length: 1, so one step
    if use_kernel is None:
        use_kernel = q.is_cuda
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_kernel:
        return _RingFlash.apply(q, k, v, causal, float(scale))
    return _ring_plain(q, k, v, causal, scale)


def _ring_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float) -> torch.Tensor:
    """The plain online-softmax ring.  At sp = 1 the one step holds this
    shard's own block, so query and key positions are both 0..T_local-1."""
    B, H, Tl, Dh = q.shape
    m = torch.full((B, H, Tl), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, Dh), dtype=torch.float32, device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(Tl, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v.float())
    return (acc / l[..., None]).to(q.dtype)


def _ring_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float) -> torch.Tensor:
    """The ring over the flash stats kernel: each step's block result is
    merged into the running (m, l, acc) by its statistics.  At sp = 1
    there is one step, over the diagonal block."""
    B, H, Tl, Dh = q.shape
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, Dh), dtype=torch.float32, device=q.device)
    o_b, m_b, l_b = kernels.flash_attention_stats(q, k, v, causal=causal,
                                                  scale=scale)
    # merge this block's normalised partial into the running state
    m_new = torch.maximum(m, m_b)
    c_run = torch.exp(m - m_new) * l
    c_blk = torch.exp(m_b - m_new) * l_b
    acc = (acc * torch.exp(m - m_new)[..., None]
           + o_b.float() * c_blk[..., None])
    l = c_run + c_blk
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The stats-kernel ring with the JAX package's recompute VJP
    (``_ring_flash_vjp_bwd``): the backward differentiates the plain
    ring, the same arithmetic, on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _ring_flash(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
            out = _ring_plain(*leaves, ctx.causal, ctx.scale)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Plain single-shard attention (the Ulysses path's attention after
    its all-to-all, and the sp = 1 reference).

    ``use_kernel`` None = the flash kernel on a CUDA tensor (it masks its
    own ragged edges, so no shape gate is needed); False = the plain
    materialised softmax (the tests' oracle)."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        return kernels.flash_attention(q, k, v, causal=causal, scale=scale)
    return kernels.flash_attention_plain(q, k, v, causal=causal, scale=scale)
