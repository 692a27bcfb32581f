"""Device MCA framework: registry + construction.

ref: parsec_mca_device_init/attach (parsec/parsec.c:832-837), component
selection via the MCA params ``device_cuda_enabled`` / ``device_cuda_max``
/ ``device_cuda_platform`` (the reference's own ``device_cuda_*`` names).

The accelerator module drives the torch device the caller names: None
means ``cuda:0``, and a missing card then raises — the CPU is used only
when the caller asks for it (``device="cpu"``), never as a fallback.
"""
from __future__ import annotations

from typing import Any, List

from ..utils import logging as plog
from ..utils.params import params
from .cpu import CPUDevice
from .device import Device, get_best_device


def resolve_device(device: Any = None):
    """The torch device the accelerator module drives: ``device`` when
    given, else the ``device_cuda_platform`` knob, else ``cuda:0``.
    Raises when it names CUDA and no card is present."""
    import torch
    if device is None:
        device = params.get("device_cuda_platform") or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the accelerator module was asked to run on {dev}, but "
                f"PyTorch sees no CUDA device; pass device=\"cpu\" (or set "
                f"PARSEC_MCA_device_cuda_platform=cpu) to run it over host "
                f"tensors, or PARSEC_MCA_device_cuda_enabled=0 for a "
                f"host-only context")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported accelerator device {dev}")
    return dev


def as_tensor(x: Any, device: Any = None):
    """``x`` (an array or a tensor) on ``resolve_device(device)``: the
    whole-matrix routines' inputs (ops/dgetrf.py, ops/inverse.py)."""
    import torch
    return torch.as_tensor(x).to(resolve_device(device))


def build_devices(context, device: Any = None) -> List[Device]:
    devices: List[Device] = [CPUDevice(0)]
    if not params.get("device_cuda_enabled") \
            or params.get("device_cuda_max") == 0:
        if device is not None:
            raise ValueError(f"device={device!r} given but the CUDA device "
                             f"module is disabled")
        return devices
    from .cuda import CudaDevice
    dev = CudaDevice(1, resolve_device(device))
    devices.append(dev)
    plog.device_stream.verbose(3, "attached accelerator module on %s",
                               dev.name)
    return devices


__all__ = ["Device", "CPUDevice", "build_devices", "get_best_device",
           "resolve_device"]
