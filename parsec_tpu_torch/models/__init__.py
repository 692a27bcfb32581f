"""The flagship transformer: its forward, on one device."""
from .transformer import (ATTENTIONS, Transformer, TransformerConfig,
                          init_params, params_from_numpy, params_to)
from .train import make_forward

__all__ = ["ATTENTIONS", "Transformer", "TransformerConfig", "init_params",
           "params_from_numpy", "params_to", "make_forward"]
