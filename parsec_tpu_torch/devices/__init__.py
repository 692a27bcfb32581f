"""Device MCA framework: registry + construction.

ref: parsec_mca_device_init/attach (parsec/parsec.c:832-837), component
selection via the MCA params ``device_cuda_enabled`` / ``device_cuda_max``
/ ``device_cuda_platform`` (the reference's own ``device_cuda_*`` names).

The accelerator module drives the torch device the caller names: None
means ``cuda:0``, and a missing card then raises — the CPU is used only
when the caller asks for it (``device="cpu"``), never as a fallback.

With ``device_mesh_shape`` the module is a chip mesh
(``CudaMeshDevice``) over a slice of the chip pool (:func:`chip_pool`):
the physical cards, or ``device_cuda_virtual_chips`` logical chips on
the one device, each with a stream of its own.
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
    mesh_dev = _maybe_mesh_device(context, device)
    if mesh_dev is not None:
        devices.append(mesh_dev)
        plog.device_stream.verbose(
            3, "attached mesh device %s over %d chip(s)", mesh_dev.name,
            len(mesh_dev.chips))
        return devices
    from .cuda import CudaDevice
    dev = CudaDevice(1, resolve_device(device))
    devices.append(dev)
    plog.device_stream.verbose(3, "attached accelerator module on %s",
                               dev.name)
    return devices


def chip_pool(device: Any = None) -> List[Any]:
    """The chips a mesh carves its slices from, as
    :class:`~parsec_tpu_torch.parallel.mesh.Chip` descriptors (ids 0..,
    no streams): ``device_cuda_virtual_chips`` logical chips on
    ``resolve_device(device)`` when that knob is above 0, else the
    physical cards ``cuda:0 .. device_count()-1`` (one host chip under
    ``device="cpu"``), of which ``device_cuda_max`` >= 0 caps the
    count."""
    import torch

    from ..parallel.mesh import Chip
    dev = resolve_device(device)
    k = int(params.get("device_cuda_virtual_chips"))
    if k > 0:
        return [Chip(i, dev) for i in range(k)]
    if dev.type != "cuda":
        return [Chip(0, dev)]
    pool = [Chip(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]
    cap = int(params.get("device_cuda_max"))
    return pool[:cap] if cap >= 0 else pool


def _maybe_mesh_device(context, device: Any = None):
    """The rank's chip-mesh device when ``device_mesh_shape`` asks for
    one: this rank takes a contiguous slice of the chip pool at offset
    ``rank * k`` (in-process SPMD ranks own disjoint chips when the pool
    holds them all; the slice wraps otherwise).  Too few chips raises,
    naming both knobs; nothing falls back to one device."""
    shape = params.get("device_mesh_shape")
    if not shape:
        return None
    from .cuda import CudaMeshDevice, parse_mesh_shape
    gp, gq = parse_mesh_shape(shape)
    need = gp * gq
    if need <= 1:
        return None
    pool = chip_pool(device)
    if len(pool) < need:
        raise RuntimeError(
            f"device_mesh_shape={shape} needs {need} chips and the chip "
            f"pool holds {len(pool)}; set device_cuda_virtual_chips={need} "
            f"(or more) to declare logical chips on "
            f"{resolve_device(device)}")
    rank = int(getattr(context, "rank", 0) or 0)
    off = (rank * need) % len(pool)
    chips = (pool * 2)[off:off + need]
    return CudaMeshDevice(1, chips, (gp, gq))


from .template import TemplateDevice, template_chore_hook  # noqa: E402

__all__ = ["Device", "CPUDevice", "build_devices", "chip_pool",
           "get_best_device", "resolve_device", "TemplateDevice",
           "template_chore_hook"]
