"""Flagship model: the decoder-only transformer, its forward and loss.

The port of the JAX package's ``models/transformer.py``.  The forward
and the loss of ONE shard run inside ``shard_map_compat`` over the
(dp, pp, tp, sp, ep) mesh (models/train.py) with its collectives
(parallel/shard_map.py): dp splits the batch; pp stacks the layers per
stage under the GPipe schedule; tp splits the heads and the FFN hidden,
with a psum after each output projection; sp splits the sequence, with
ring or Ulysses attention and positions offset by the shard's place; ep
splits the experts, with a psum in the MoE combine.  On one device, or
outside a shard, every axis has size 1: each psum is the identity and
the GPipe schedule runs the microbatches in order.  The parameters are
the same tree as the JAX package's (``init_params`` makes the same
draws; ``params_from_numpy`` carries a JAX tree, or a JAX Adam state,
across), passed to each call like JAX's functional forward.  The plain
products (QKV, output projection, FFN, experts, tied logits) are
``torch.matmul``, as the JAX package leaves them to XLA; the attention is
the hand-written flash kernel on the card, forward and backward.

The dtypes follow the JAX package's, promotions included.  The
activations between layers are in the config dtype (``x.astype(dtype)``
after the embedding), so q, k and v are too.  The dense layer's products
take their operands promoted to one type and at least fp32, as the JAX
einsums with ``preferred_element_type=float32`` compute them (a bf16
product is exact in fp32, so the only rounding is the fp32 sum's), and
are rounded once to the activations' type; GELU runs on the fp32
product.  So a tree of fp32 weights (Adam promotes bf16 weights to fp32
at the first step, as JAX's does) with bf16 activations works as in
JAX.  The head is fp32.  On the card the products are fp32 GEMMs on the
widened operands (cuBLAS, no TF32 unless the caller allows it), so
``allow_bf16_reduced_precision_reduction`` does not apply to them.

Pre-norm RMSNorm, no biases, tanh-GELU, learned positions and a tied
embedding, as in the JAX model; ``n_experts > 0`` swaps the FFN for the
top-k MoE (parallel/moe.py) and adds its load-balance loss to
``loss_shard``; ``remat`` recomputes each layer in the backward, the
counterpart of ``jax.checkpoint``: ``torch.utils.checkpoint`` where the
layer holds no collective, else one node over the layer's tp, sp and ep
group (``parallel.shard_map.remat``) that recomputes each member in its
shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from ..parallel.mesh import AXES
from ..parallel.moe import gate_product, load_balance_loss, moe_ffn
from ..parallel.pipeline import gpipe, last_stage_value
from ..parallel.ring_attention import local_attention, ring_attention
from ..parallel.sequence import ulysses_attention
from ..parallel.shard_map import axis_index, axis_size, pmean, psum
from ..parallel.shard_map import remat as shard_remat

ATTENTIONS = ("ring", "ulysses", "flash", "local")
#: the axes whose collectives run inside a layer (the tp psums, the sp
#: ring or all-to-all, the ep combine)
LAYER_AXES = ("tp", "sp", "ep")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4          # divisible by tp (and by sp for ulysses)
    d_head: int = 16
    n_stages: int = 1         # == pp axis size
    layers_per_stage: int = 1
    d_ff: int = 128           # divisible by tp
    n_experts: int = 0        # 0 = dense FFN; else divisible by ep
    moe_top_k: int = 2
    seq_len: int = 32         # divisible by sp
    batch: int = 8            # divisible by dp; batch/dp divisible by n_micro
    n_micro: int = 1          # pipeline microbatches per shard
    attention: str = "ring"   # "ring" | "ulysses" | "flash" | "local"
    remat: bool = False       # recompute each layer in the backward
    dtype: torch.dtype = torch.float32
    aux_loss_weight: float = 0.01

    @property
    def n_layers(self) -> int:
        return self.n_stages * self.layers_per_stage


def init_params(cfg: TransformerConfig, seed: int = 0) -> Dict[str, Any]:
    """The global parameter tree, on the CPU: the JAX package's
    ``init_params`` draws, in the same order from the same
    ``np.random.RandomState(seed)``, so the two trees are equal."""
    rng = np.random.RandomState(seed)
    dt = cfg.dtype

    def w(*shape, scale=None):
        # 1/sqrt(shape[-2]) is 1/sqrt(H) for wqkv, as in the JAX package
        scale = scale or (1.0 / np.sqrt(shape[-2] if len(shape) >= 2
                                        else shape[-1]))
        return torch.from_numpy(rng.normal(0, scale, size=shape)).to(dt)

    S, L = cfg.n_stages, cfg.layers_per_stage
    D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    params: Dict[str, Any] = {
        "embed": w(cfg.vocab, D, scale=0.02),
        "pos": w(cfg.seq_len, D, scale=0.02),
        "ln_f": torch.ones((D,), dtype=dt),
        "stages": {
            "ln1": torch.ones((S, L, D), dtype=dt),
            "ln2": torch.ones((S, L, D), dtype=dt),
            "wqkv": w(S, L, D, 3, H, Dh),
            "wo": w(S, L, H, Dh, D),
        },
    }
    if cfg.n_experts:
        E = cfg.n_experts
        params["stages"]["gate"] = w(S, L, D, E, scale=0.02)
        params["stages"]["w1e"] = w(S, L, E, D, Fd)
        params["stages"]["w2e"] = w(S, L, E, Fd, D)
    else:
        params["stages"]["w1"] = w(S, L, D, Fd)
        params["stages"]["w2"] = w(S, L, Fd, D)
    return params


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Each leaf's partitioning as a tuple of mesh axis names (None =
    not split), the JAX package's ``PartitionSpec``s as tuples: stages
    stack over pp, heads and the FFN hidden over tp, experts over ep,
    everything else replicated (``()``)."""
    specs: Dict[str, Any] = {
        "embed": (),
        "pos": (),
        "ln_f": (),
        "stages": {
            "ln1": ("pp",),
            "ln2": ("pp",),
            "wqkv": ("pp", None, None, None, "tp", None),
            "wo": ("pp", None, "tp", None, None),
        },
    }
    if cfg.n_experts:
        specs["stages"]["gate"] = ("pp",)
        specs["stages"]["w1e"] = ("pp", None, "ep", None, "tp")
        specs["stages"]["w2e"] = ("pp", None, "ep", "tp", None)
    else:
        specs["stages"]["w1"] = ("pp", None, None, "tp")
        specs["stages"]["w2"] = ("pp", None, "tp", None)
    return specs


def params_from_numpy(tree: Any) -> Any:
    """A tree of numpy arrays as CPU tensors of the same dtypes and
    values: the JAX package's parameters (dense or with experts, fp32 or
    bf16) or its Adam state ``{"mu", "nu", "count"}``, through
    ``np.asarray``, so a JAX step and a port step start from the same
    state.  A bf16 array (numpy's ``bfloat16`` extension type, which
    ``torch.from_numpy`` refuses) crosses bit for bit as its 16-bit
    patterns."""
    if isinstance(tree, dict):
        return {name: params_from_numpy(a) for name, a in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_to(tree: Any, device) -> Any:
    """The tree on ``device``; a tensor already there is not copied."""
    if isinstance(tree, dict):
        return {name: params_to(a, device) for name, a in tree.items()}
    return tree.to(device)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the JAX package's einsums with
    ``preferred_element_type=float32`` compute it: both operands in their
    promoted type, at least fp32, and the sums in it."""
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                             torch.float32)
    return torch.matmul(a.to(dt), b.to(dt))


class Transformer(nn.Module):
    """The forward of one shard.  Holds the config; the parameters are
    passed to each call as a tree (``init_params``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.n_experts and cfg.moe_top_k < 1:
            raise ValueError(f"moe_top_k must be at least 1, got "
                             f"{cfg.moe_top_k}")
        if cfg.attention not in ATTENTIONS:
            raise ValueError(f"attention {cfg.attention!r} is not one of "
                             f"{ATTENTIONS}")
        self.cfg = cfg

    def forward(self, params: Dict[str, Any],
                tokens: torch.Tensor) -> torch.Tensor:
        """The logits of ``forward_shard``."""
        return self.forward_shard(params, tokens)[0]

    @staticmethod
    def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + 1e-6)).to(x.dtype) * g

    def _attention(self, q, k, v) -> torch.Tensor:
        attention = self.cfg.attention
        if attention == "ring":
            return ring_attention(q, k, v, "sp", causal=True)
        if attention == "ulysses":
            return ulysses_attention(q, k, v, "sp", causal=True)
        if attention == "flash":
            # the kernel: no materialised [T, T] scores (single-shard
            # sequence; combine with sp through the ring)
            return kernels.flash_attention(q, k, v, causal=True)
        return local_attention(q, k, v, causal=True)

    def _layer(self, lp: Dict[str, torch.Tensor], x: torch.Tensor,
               aux) -> Tuple[torch.Tensor, Any]:
        """One transformer block on a local shard. x: [mb, T, D]; the
        shard's heads and FFN hidden are its tp slice.  Returns the new
        residual stream and ``aux`` plus this layer's load-balance loss
        (``aux`` unchanged for a dense FFN)."""
        mb, T, D = x.shape
        H, Dh = lp["wqkv"].shape[2], self.cfg.d_head
        h = self._rmsnorm(x, lp["ln1"])
        qkv = _dot(h, lp["wqkv"].reshape(D, 3 * H * Dh)).to(x.dtype)
        # [mb, T, 3, H, Dh] -> three contiguous [mb, H, T, Dh]
        q, k, v = (qkv.view(mb, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
                   .contiguous())
        a = self._attention(q, k, v)
        o = _dot(a.transpose(1, 2).reshape(mb, T, H * Dh),
                 lp["wo"].reshape(H * Dh, D)).to(x.dtype)
        x = x + psum(o, "tp")      # heads are tp-sharded
        h2 = self._rmsnorm(x, lp["ln2"])
        if "w1e" in lp:
            gate_logits = gate_product(h2, lp["gate"])
            # in the stream's type, as the dense FFN's (h2 is fp32 once
            # Adam has made ln2 fp32; the JAX package's scan then raises)
            f = moe_ffn(h2, lp["gate"], lp["w1e"], lp["w2e"], "ep",
                        top_k=self.cfg.moe_top_k,
                        gate_logits=gate_logits).to(x.dtype)
            aux = aux + load_balance_loss(gate_logits)
        else:
            # GELU on the fp32 product, rounded once after it
            u = F.gelu(_dot(h2, lp["w1"]), approximate="tanh").to(x.dtype)
            f = _dot(u, lp["w2"]).to(x.dtype)
        return x + psum(f, "tp"), aux     # the FFN hidden is tp-sharded

    def _embed(self, params: Dict[str, Any],
               tokens: torch.Tensor) -> torch.Tensor:
        """Token and position embeddings, [B, T_local, D] in the config
        dtype; shard i of sp holds positions from i * T_local."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        if axis_index("sp"):
            pos = pos + axis_index("sp") * tokens.shape[1]
        return (params["embed"][tokens]
                + params["pos"][pos][None]).to(self.cfg.dtype)

    def _head(self, params: Dict[str, Any], y: torch.Tensor) -> torch.Tensor:
        """Final norm and the tied logits, in fp32."""
        y = self._rmsnorm(y, params["ln_f"])
        return torch.matmul(y.float(), params["embed"].float().mT)

    def forward_shard(self, params: Dict[str, Any],
                      tokens: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """tokens: [B_local, T_local] int64, on the parameters' device.
        Returns (logits [B_local, T_local, V] in fp32, valid on the LAST
        pp stage, zeros on the others; aux): ``aux`` is this stage's
        load-balance loss summed over its layers and microbatches (0 for
        a dense FFN)."""
        x = self._embed(params, tokens)
        B, Tl, _ = x.shape
        M = self.cfg.n_micro
        if B % M:
            raise ValueError(f"local batch {B} not divisible by {M} "
                             f"microbatches")
        # [S, L, ...] -> this shard's layer stack [S*L, ...]
        stage = {name: a.reshape(-1, *a.shape[2:])
                 for name, a in params["stages"].items()}
        # a recomputed layer keeps nothing for the backward but its inputs
        remat = self.cfg.remat and torch.is_grad_enabled()
        # a layer with collectives recomputes over its group (tp, sp, ep)
        grouped = remat and axis_size(LAYER_AXES) > 1

        def stage_fn(sparams, xm):
            aux = torch.zeros((), dtype=torch.float32, device=xm.device)
            for i in range(sparams["wqkv"].shape[0]):
                lp = {name: a[i] for name, a in sparams.items()}
                if grouped:
                    xm, aux = shard_remat(self._layer, LAYER_AXES, lp, xm,
                                          aux)
                elif remat:
                    xm, aux = checkpoint(self._layer, lp, xm, aux,
                                         use_reentrant=False)
                else:
                    xm, aux = self._layer(lp, xm, aux)
            return xm, aux

        y, aux = gpipe(stage_fn, stage, x.reshape(M, B // M, Tl, -1), "pp",
                       with_aux=True)
        if axis_index("pp") != axis_size("pp") - 1:
            # a stage before the last holds no output (gpipe's zeros); the
            # JAX package's head runs on its garbage, then masks it out
            return torch.zeros((B, Tl, params["embed"].shape[0]),
                               dtype=torch.float32, device=x.device), aux
        return self._head(params, y.reshape(B, Tl, -1)), aux


def forward_shard(cfg: TransformerConfig, params: Dict[str, Any],
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of one shard (inside ``shard_map_compat`` over the five
    axes, or on one device): ``Transformer(cfg).forward_shard``."""
    return Transformer(cfg).forward_shard(params, tokens)


def loss_shard(cfg: TransformerConfig, params: Dict[str, Any],
               tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of the fp32 logits over every token of the
    global batch, plus ``aux_loss_weight`` times the load-balance loss's
    mean over layers and microbatches (then over the dp and sp token
    blocks) when MoE is on: a scalar replicated on every shard.
    ``tokens`` and ``labels``: this shard's [B_local, T_local] int64 on
    the parameters' device."""
    logits, aux = forward_shard(cfg, params, tokens)
    if axis_size(AXES) == 1:       # one shard: the one-device arithmetic
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        if cfg.n_experts:
            loss = loss + cfg.aux_loss_weight * (aux / (cfg.n_layers
                                                         * cfg.n_micro))
        return loss
    if axis_index("pp") == axis_size("pp") - 1:
        local_sum = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    labels.reshape(-1), reduction="sum")
    else:                          # only the last pp stage holds logits
        local_sum = torch.zeros((), dtype=torch.float32,
                                device=logits.device)
    total = psum(last_stage_value(local_sum, "pp"), ("dp", "sp"))
    loss = total / (labels.numel() * axis_size(("dp", "sp")))
    if cfg.n_experts:
        # each pp stage summed its own layers' aux; the mean over layers
        # and microbatches, averaged over the (dp, sp) token blocks
        aux_mean = psum(aux, "pp") / (cfg.n_layers * cfg.n_micro)
        loss = loss + cfg.aux_loss_weight * pmean(aux_mean, ("dp", "sp"))
    return loss