"""The transformer's entry points: the training step (forward, backward,
Adam) and the forward for inference.

The port of the JAX package's ``models/train.py``.  Over a mesh of
several chips the loss runs in ``shard_map_compat`` (one thread a shard,
parallel/shard_map.py) on each shard's slices of the GLOBAL parameter
tree; the gradient is one ``torch.autograd.grad`` of the replicated loss
over the global leaves, taken after every shard has returned, so a leaf
replicated over some axes gets its shards' contributions summed (the
JAX package's ``sync_axes``) by the graph itself; Adam then updates the
global tree.  A mesh of one device runs the same entry on the calling
thread, where every axis has size 1 and ``loss_shard`` keeps its
one-device arithmetic.  The step is functional like the JAX one: it returns new parameters and a new
optimizer state and leaves its arguments as they were.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..parallel.mesh import Mesh, make_mesh, shard_map_compat, spec
from ..parallel.pipeline import last_stage_value
from .transformer import (Transformer, TransformerConfig, forward_shard,
                          loss_shard, param_specs, params_to)

#: the token ids' and labels' split: batch over dp, sequence over sp
DATA_SPEC = spec("dp", "sp")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {name: tree_map(fn, a, *(r[name] for r in rest))
                for name, a in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for a in tree.values() for leaf in tree_leaves(a)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """The leaves, in ``tree_leaves`` order, in the shape of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def adam_init(params: Any) -> Dict[str, Any]:
    """Adam's state for ``params``: zero moments and an int32 step count."""
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adam_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step, the JAX package's arithmetic: the count in int32,
    the bias corrections ``1 - b ** count`` in fp32 on the device.
    Returns ``(new_params, new_state)``; nothing is updated in place."""
    with torch.no_grad():
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                      grads)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        new_params = tree_map(
            lambda p, m, v: p - lr * (m / c1) / (torch.sqrt(v / c2) + eps),
            params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}


def opt_state_specs(pspecs: Any) -> Dict[str, Any]:
    """The optimizer state's specs: the moments mirror the parameters',
    the count is replicated."""
    return {"mu": pspecs, "nu": pspecs, "count": ()}


def shard_params(params: Any, mesh: Mesh, pspecs: Any) -> Any:
    """The tree placed on the mesh: each leaf whole on the mesh's device
    (its first chip's), where each call's executor hands every shard its
    slice by ``pspecs`` (a view on the same card, a copy on another)."""
    return params_to(params, mesh.device)


def _check_attention_mesh(cfg: TransformerConfig, mesh: Mesh) -> None:
    """flash attention is shard-local: over sp > 1 it would silently
    compute block-diagonal attention instead of global causal — reject
    loudly (use attention='ring' for sequence parallelism)."""
    sp = mesh.shape.get("sp", 1)
    if cfg.attention == "flash" and sp > 1:
        raise ValueError(
            "attention='flash' is single-shard in the sequence dimension; "
            f"mesh has sp={sp} — use attention='ring' (or 'ulysses') for "
            "sequence-parallel meshes")


def _resolve_mesh(cfg: TransformerConfig, mesh: Optional[Mesh],
                  device) -> Mesh:
    if mesh is None:
        mesh = make_mesh(1) if device is None else \
            make_mesh(devices=[device])
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    _check_attention_mesh(cfg, mesh)
    Transformer(cfg)           # the config's own checks
    return mesh


def _token_ids(cfg: TransformerConfig, ids: Any, what: str,
               device: torch.device) -> torch.Tensor:
    """Token ids of any integer type, as a tensor or an array, checked
    against the vocabulary and moved to ``device`` as int64."""
    ids = torch.as_tensor(ids)
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab):
        raise ValueError(f"{what} outside [0, {cfg.vocab})")
    return ids.to(device, torch.int64)


def value_and_grad(cfg: TransformerConfig, params: Any, tokens: torch.Tensor,
                   labels: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Any]:
    """``loss_shard`` and its gradient with respect to every leaf of
    ``params`` (the global tree on one device; tokens and labels int64
    there).  The loss is the shards' joint loss over ``mesh``
    (``shard_map_compat``, split by ``param_specs`` and ``DATA_SPEC``; by
    default a mesh of the parameters' one device) and the gradient one
    backward of it, after every shard has returned.  The leaves are
    detached copies of the tree's tensors, so the caller's tree takes no
    gradient."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("a training step cannot run under "
                           "torch.inference_mode()")
    leaves = tree_map(lambda t: (t.clone() if t.is_inference()
                                 else t.detach()).requires_grad_(True),
                      params)
    if mesh is None:
        mesh = make_mesh(devices=[tree_leaves(params)[0].device])
    with torch.enable_grad():
        loss = shard_map_compat(
            lambda p, t, y: loss_shard(cfg, p, t, y), mesh,
            in_specs=(param_specs(cfg), DATA_SPEC, DATA_SPEC),
            out_specs=spec())(leaves, tokens, labels)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                    lr: float = 1e-3, device=None):
    """The step ``(params, opt_state, tokens, labels) -> (params,
    opt_state, loss)``: the loss of ``loss_shard``, its gradients by
    autograd (the flash kernel's backward on the card), one Adam update.
    It runs on ``cuda:0`` (raising without a card) unless the caller
    passes ``device="cpu"`` or a mesh; over a mesh of several chips
    ``value_and_grad`` takes the shards' joint loss and Adam updates the
    global tree on the mesh's device.  It moves the parameters and the
    optimizer state to the device unless they are there, and takes token
    ids and labels of any integer type."""
    mesh = _resolve_mesh(cfg, mesh, device)
    dev = mesh.device

    def step(params: Any, opt_state: Dict[str, Any], tokens: Any,
             labels: Any):
        tokens = _token_ids(cfg, tokens, "token ids", dev)
        labels = _token_ids(cfg, labels, "labels", dev)
        params = params_to(params, dev)
        loss, grads = value_and_grad(cfg, params, tokens, labels, mesh)
        new_params, new_state = adam_update(
            params, grads, params_to(opt_state, dev), lr=lr)
        return new_params, new_state, loss

    return step


def make_forward(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                 device=None) -> Callable[[Dict[str, Any], Any],
                                          torch.Tensor]:
    """The forward ``(params, tokens) -> logits [B, T, vocab]`` (fp32),
    for inference.  It runs on ``cuda:0`` (raising without a card) unless
    the caller passes ``device="cpu"`` or a mesh; over a mesh of several
    chips each shard runs ``forward_shard`` on its slices and the logits
    are assembled over dp and sp from the last pp stage's.  Each call
    runs under ``torch.inference_mode()``, moves the parameters to the
    device unless they are there, and takes token ids of any integer
    type, as a tensor or an array."""
    mesh = _resolve_mesh(cfg, mesh, device)
    dev = mesh.device
    run = shard_map_compat(
        lambda p, t: last_stage_value(forward_shard(cfg, p, t)[0], "pp"),
        mesh, in_specs=(param_specs(cfg), DATA_SPEC), out_specs=DATA_SPEC)

    def forward(params: Dict[str, Any], tokens: Any) -> torch.Tensor:
        tokens = _token_ids(cfg, tokens, "token ids", dev)
        with torch.inference_mode():
            return run(params_to(params, dev), tokens)

    return forward
