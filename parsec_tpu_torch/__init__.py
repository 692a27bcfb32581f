"""parsec_tpu_torch — the PyTorch/CUDA port of parsec_tpu: the same
task-based runtime (DAG scheduling, the PTG DSL, tiled collections,
per-device task incarnations, tracing) with its accelerator device module
and hot kernels written for an NVIDIA Hopper card.

This package ports the single-rank PTG and DTD front ends of the JAX
package, beside it in the same repository:

    ctx = parsec_tpu_torch.init(nb_cores=4)         # device module on cuda:0
    A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    parsec_tpu_torch.ops.dpotrf(ctx, A)
    ctx.fini()

DTD pools (``dtd.taskpool_new``, ``insert_task``, ``add_chore(body,
"cuda", fn)``), their composition (``compose``, ``recursive_call``), and
whole-graph capture of either front end as one CUDA graph
(``ptg.capture``, ``dtd.capture.dtd_capture``); and the flagship transformer's forward (``models``, over ``parallel``):

    cfg = models.TransformerConfig(...)
    forward = models.make_forward(cfg)              # on cuda:0
    logits = forward(models.init_params(cfg, seed), tokens)

``init(device="cpu")`` and ``make_forward(cfg, device="cpu")`` run the
same code over host tensors with each kernel's plain PyTorch version;
without them, a missing card raises.
"""
from .runtime.context import Context, init
from .runtime.taskpool import (Chore, Dep, Flow, HookReturn, Task, TaskClass,
                               Taskpool, TaskStatus)
from .data.data import Coherency, Data, DataCopy, FlowAccess, data_new_with_payload
from .data.datatype import Datatype, dtt_of_array
from .data.arena import Arena
from .utils.params import params
from .runtime.compound import CompoundTaskpool, compose
from .runtime.recursive import recursive_call
from . import dsl
from .dsl import dtd, ptg
from . import ops
from . import parallel
from . import models

__version__ = "0.1.0"

__all__ = [
    "Context", "init", "Taskpool", "TaskClass", "Task", "Chore", "Flow",
    "Dep", "HookReturn", "TaskStatus", "Data", "DataCopy", "Coherency",
    "FlowAccess", "Datatype", "Arena", "params", "dsl", "dtd", "ptg", "ops",
    "CompoundTaskpool", "compose", "recursive_call",
    "parallel", "models", "data_new_with_payload", "dtt_of_array", "__version__",
]
