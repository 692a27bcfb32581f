"""The flagship transformer and its training step, on one device or over
a mesh of chips (dp, pp, tp, sp, ep)."""
from .transformer import (ATTENTIONS, Transformer, TransformerConfig,
                          forward_shard, init_params, loss_shard,
                          param_specs, params_from_numpy, params_to)
from .train import (adam_init, adam_update, make_forward, make_train_step,
                    opt_state_specs, shard_params)

__all__ = ["ATTENTIONS", "Transformer", "TransformerConfig", "init_params",
           "param_specs", "forward_shard", "loss_shard", "params_from_numpy",
           "params_to", "make_train_step", "make_forward", "adam_init",
           "adam_update", "opt_state_specs", "shard_params"]
