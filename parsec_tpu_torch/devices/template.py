"""Template device module — the skeleton to clone for a new device type.

Reference behavior: ``parsec/mca/device/template/`` ships a fully-commented
no-op component (device_template_module.c:1-194) whose purpose is to be
copied when bringing up a new accelerator; it documents every hook a
device module must provide. This is the same artifact for this runtime:
a minimal but *working* device that executes chores through a
user-supplied executor callable, so a new backend can start from
something that already passes the test suite.

The template computes host-side: a task's inputs are the host copies,
each synced to its newest version first (an accelerator — the CUDA
module — may own it: the D2H queues on that module's stream behind the
kernel that wrote the tile), and its outputs become the new host
versions, which a later CUDA task stages back in.

To bring up a new device type:

1. Copy this file; pick a ``device_type`` string (task classes select it
   via their chore/incarnation list, e.g. ``Chore("mydev", hook)``, or
   ``BODY [type=mydev]`` in a JDF).
2. Implement ``kernel_scheduler`` — run one task's functional chore
   (``fn(task, input_arrays) -> output_arrays``) wherever your device
   lives, returning the outputs (synchronously here; return ASYNC and
   complete them in :meth:`progress` for async devices — see
   devices/cuda.py for the stream/window pattern).
3. Optionally implement staging (`data_advise`, host<->device copies
   with version bumps — see CudaDevice._stage_in/_epilog) and memory
   accounting/LRU if the device has its own memory.
4. Register it: append an instance to a context's ``devices`` (or to
   ``devices.build_devices``) and gate it behind an MCA param like
   ``device_<type>_enabled``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from .device import Device


class TemplateDevice(Device):
    """A working no-op accelerator: chores execute via ``executor``
    (default: call inline on the worker thread)."""

    def __init__(self, device_index: int,
                 executor: Optional[Callable[..., Any]] = None,
                 device_type: str = "template") -> None:
        super().__init__(device_type, device_index)
        # accelerators advertise a lower cost weight than the CPU so the
        # load balancer prefers them for tasks that have a chore here
        self.time_estimate_default = 1.0
        self._executor = executor or (lambda fn, *args: fn(*args))
        self.stats = {"tasks": 0}

    def kernel_scheduler(self, es, task) -> Any:
        """Entry point called by the chore hook (the
        parsec_cuda_kernel_scheduler slot). Synchronous minimal version:
        stage in = read the newest host payloads, execute, stage out =
        write the host copies back with a version bump."""
        from ..data.data import Data, FlowAccess
        from ..runtime.taskpool import HookReturn

        chore = task.task_class.incarnations[task.selected_chore]
        arrays: List[Any] = []
        for flow in task.task_class.flows:
            ref = task.data[flow.flow_index] if not flow.ctl else None
            if ref is None or ref.data_in is None:
                arrays.append(None)
                continue
            copy = ref.data_in
            if copy.data is not None:
                # this device computes host-side: the host copy must
                # hold the newest version (the CUDA module may own it,
                # and its predecessor handed this task the device copy)
                copy = copy.data.sync_to_host(es.context.devices)
                ref.data_in = copy
            arrays.append(Data.materialize_host(copy))
        outs = self._executor(chore.dyld_fn, task, arrays)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        written = [f for f in task.task_class.flows
                   if not f.ctl and (task.access_of(f) & FlowAccess.WRITE)
                   and task.data[f.flow_index].data_in is not None]
        if len(outs) != len(written):
            raise ValueError(
                f"{task.snprintf()}: chore returned {len(outs)} outputs "
                f"for {len(written)} written flows")
        for flow, out in zip(written, outs):
            ref = task.data[flow.flow_index]
            ref.data_in.payload = out
            if ref.data_in.data is not None:
                ref.data_in.data.version_bump(ref.data_in.device_id)
        self.executed_tasks += 1
        self.stats["tasks"] += 1
        return HookReturn.DONE


def template_chore_hook(device_type: str = "template",
                        device_selector: Optional[Callable] = None):
    """The hook to put in a task class's incarnation list for a device
    type (the generated-CUDA-hook slot, jdf2c.c:6557): find an attached
    device of that type, else fall through to the next incarnation.
    Every accelerator type but CUDA dispatches here (the CUDA module
    keeps its own hook, devices/cuda.cuda_chore_hook)."""
    from ..runtime.taskpool import HookReturn

    def hook(es, task):
        devs = [d for d in es.context.devices
                if d.device_type == device_type]
        if not devs:
            return HookReturn.NEXT
        if device_selector is not None:
            dev = device_selector(task, devs)
        else:
            from .device import get_best_device
            dev = get_best_device(task, devs, eligible_types={device_type})
        return dev.kernel_scheduler(es, task)
    return hook
