"""The transformer's entry point: the forward for inference.

Training (the train step, Adam, remat) is a later slice of the port
(ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..parallel.mesh import Mesh, make_mesh
from ..parallel.pipeline import last_stage_value
from .transformer import Transformer, TransformerConfig, params_to


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


def make_forward(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                 device=None) -> Callable[[Dict[str, Any], Any],
                                          torch.Tensor]:
    """The forward ``(params, tokens) -> logits [B, T, vocab]`` (fp32),
    for inference.  It runs on ``cuda:0`` (raising without a card) unless
    the caller passes ``device="cpu"`` or a mesh over the CPU.  Each call
    runs under ``torch.inference_mode()``, moves the parameters to the
    device unless they are there, and takes token ids of any integer
    type, as a tensor or an array."""
    if mesh is None:
        mesh = make_mesh(devices=None if device is None else [device])
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    _check_attention_mesh(cfg, mesh)
    model = Transformer(cfg)
    dev = mesh.device

    def forward(params: Dict[str, Any], tokens: Any) -> torch.Tensor:
        tokens = torch.as_tensor(tokens)
        if tokens.numel() and (int(tokens.min()) < 0
                               or int(tokens.max()) >= cfg.vocab):
            raise ValueError(f"token ids outside [0, {cfg.vocab})")
        with torch.inference_mode():
            logits = model(params_to(params, dev),
                           tokens.to(dev, torch.int64))
            return last_stage_value(logits, "pp")

    return forward
