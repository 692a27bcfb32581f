"""Ring attention: sequence-parallel exact attention, and the plain
single-shard attention it is checked against.

Each sp shard holds a local Q/K/V sequence chunk; K/V blocks go round
the ring while a flash-style online softmax merges each block's partial
result by its running max and denominator.  Causal masking uses global
positions: at step t shard i holds the block that started on shard
(i - t) mod sp.

Two forms, as in the JAX package:
- the plain ring (``_ring_plain``), whose blocks travel by ``ppermute``
  and whose gradient is autograd's through it;
- the kernel ring (``_RingFlashGroup``): each block's local attention is
  the flash stats kernel (ops/kernels.py), and the backward recomputes
  through the plain ring (the JAX package's recompute VJP).  That VJP
  holds the ring's exchanges, so the kernel ring is ONE autograd node
  over the sp group (``shard_map.group_call``): its forward runs every
  shard's steps, each on its own chip's stream, and launches nothing for
  a block in a shard's future (the JAX ``lax.switch``); its backward
  recomputes each shard's plain ring on that shard's chip, from its own
  query and the blocks it attended to, with no exchange to wait for.

At sp = 1 (one device, or a mesh without sp) the ring is one step, over
the shard's own (diagonal) block, and the kernel ring a group of one.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops import kernels
from ..ops.kernels import NEG_INF
from . import shard_map as sm
from .mesh import Chip


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
    sp = sm.axis_size(axis_name)
    if use_kernel is None:
        use_kernel = q.is_cuda
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_kernel and sp == 1:
        return _RingFlashGroup.apply([Chip(0, q.device)], causal,
                                     float(scale), q, k, v)[0]
    if sp == 1:
        return _ring_plain(q, k, v, causal, scale)
    if use_kernel:
        return sm.group_call(
            "ring_flash", axis_name, (q, k, v),
            lambda qkvs, chips: _RingFlashGroup.apply(
                chips, causal, float(scale),
                *[t for qkv in qkvs for t in qkv]))
    idx = sm.axis_index(axis_name)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    blocks = [(k, v)]

    def block(t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        # the block held at step t came from shard (idx - t) mod sp
        while len(blocks) <= t:
            kb, vb = blocks[-1]
            blocks.append((sm.ppermute(kb, axis_name, perm),
                           sm.ppermute(vb, axis_name, perm)))
        return blocks[t]

    return _ring_steps(q, block, idx, sp, causal, scale)


def _ring_steps(q: torch.Tensor,
                block: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                idx: int, sp: int, causal: bool, scale: float,
                skip_future: bool = False) -> torch.Tensor:
    """The plain online-softmax ring of shard ``idx`` of ``sp``:
    ``block(t)`` is the (k, v) block it holds at step t, which started on
    shard (idx - t) mod sp.  ``skip_future`` leaves out a causal block
    from the shard's future, whose step changes nothing (every score is
    masked after step 0's diagonal block); the ring over ``ppermute``
    cannot, since every member must join each exchange."""
    B, H, Tl, Dh = q.shape
    m = torch.full((B, H, Tl), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, Dh), dtype=torch.float32, device=q.device)
    pos = torch.arange(Tl, device=q.device)
    for t in range(sp):
        src = (idx - t) % sp
        if skip_future and causal and src > idx:
            continue
        k_blk, v_blk = block(t)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_blk.float()) * scale
        if causal:
            keep = (idx * Tl + pos)[:, None] >= (src * Tl + pos)[None, :]
            s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   v_blk.float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype)


def _ring_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float) -> torch.Tensor:
    """The plain ring at sp = 1: one step over the shard's own block."""
    return _ring_steps(q, lambda t: (k, v), 0, 1, causal, scale)


def _merge(m, l, acc, o_b, m_b, l_b):
    """Merge a block's normalised partial (o_b, m_b, l_b) into the
    running state (m, l, acc)."""
    m_new = torch.maximum(m, m_b)
    c_run = torch.exp(m - m_new) * l
    c_blk = torch.exp(m_b - m_new) * l_b
    acc = (acc * torch.exp(m - m_new)[..., None]
           + o_b.float() * c_blk[..., None])
    return m_new, c_run + c_blk, acc


def _ring_flash(q: torch.Tensor,
                block: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                idx: int, sp: int, causal: bool,
                scale: float) -> torch.Tensor:
    """The ring of shard ``idx`` over the flash stats kernel: each step's
    block result merged into the running (m, l, acc) by its statistics.
    A past block attends fully, the diagonal block causally, and a block
    from the shard's future (causal only) launches nothing: its merge
    would add exactly nothing."""
    B, H, Tl, Dh = q.shape
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, Dh), dtype=torch.float32, device=q.device)
    for t in range(sp):
        src = (idx - t) % sp
        if causal and src > idx:
            continue
        k_blk, v_blk = block(t)
        o_b, m_b, l_b = kernels.flash_attention_stats(
            q, k_blk, v_blk, causal=causal and src == idx, scale=scale)
        m, l, acc = _merge(m, l, acc, o_b, m_b, l_b)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(q.dtype)


class _RingFlashGroup(torch.autograd.Function):
    """The stats-kernel ring over a whole sp group as one node: inputs
    q_0, k_0, v_0, q_1, ... in ring order; output i is shard i's
    attention.  The forward runs shard i's steps on chip i's stream (the
    blocks it needs moved there); the backward recomputes shard i's plain
    ring there too, from q_i and the blocks it attended to, and sums each
    block's gradient on its own chip in ring order.  At sp = 1 this is
    the JAX package's recompute VJP (``_ring_flash_vjp_bwd``) as is."""

    @staticmethod
    def forward(ctx, chips, causal, scale, *qkv):
        sp = len(chips)
        ctx.chips, ctx.causal, ctx.scale = chips, causal, scale
        ctx.save_for_backward(*qkv)
        outs = []
        for i, chip in enumerate(chips):
            with sm._on_chip(chip):
                sm._wait(chip, chips[0])   # every deposit is ready there

                def block(t, i=i, chip=chip):
                    j = (i - t) % sp
                    kv = tuple(sm._move(x, chips[j], chip)
                               for x in qkv[3 * j + 1:3 * j + 3])
                    for x in kv:
                        sm._read_on(x, chip)
                    return kv

                outs.append(_ring_flash(qkv[3 * i], block, i, sp, causal,
                                        scale))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        chips, sp, causal = ctx.chips, len(ctx.chips), ctx.causal
        qkv = ctx.saved_tensors
        entry = sm._autograd_streams(chips)
        dq, parts = [], {}           # parts[i, j]: shard i's (dk_j, dv_j)
        for i, chip in enumerate(chips):
            seen = [j for j in range(sp) if not (causal and j > i)]
            with sm._on_chip(chip):
                for e in entry:
                    sm._wait(chip, e)
                sm._read_on(gs[i], chip)
                q = qkv[3 * i].detach().requires_grad_(True)
                kv = {}
                for j in seen:
                    pair = [sm._move(x, chips[j], chip)
                            for x in qkv[3 * j + 1:3 * j + 3]]
                    for x in pair:
                        sm._read_on(x, chip)
                    kv[j] = [x.detach().requires_grad_(True) for x in pair]
                with torch.enable_grad():
                    out = _ring_steps(q, lambda t, i=i: kv[(i - t) % sp], i,
                                      sp, causal, ctx.scale,
                                      skip_future=True)
                    grads = torch.autograd.grad(
                        out, [q] + [x for j in seen for x in kv[j]], gs[i])
            dq.append(grads[0])
            for n, j in enumerate(seen):
                parts[i, j] = grads[1 + 2 * n:3 + 2 * n]
        out = []
        for j, chip in enumerate(chips):
            mine = [i for i in range(sp) if (i, j) in parts]
            with sm._on_chip(chip):
                for i in mine:
                    sm._wait(chip, chips[i])
                    for x in parts[i, j]:
                        sm._read_on(x, chip)
                dkv = [sm._sum_in_order([parts[i, j][w] for i in mine],
                                        [chips[i] for i in mine], chip)
                       for w in (0, 1)]
            for e in entry:
                sm._wait(e, chip)
                for x in [dq[j]] + dkv:
                    sm._read_on(x, e)
            out += [dq[j]] + dkv
        return (None, None, None) + tuple(out)


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
