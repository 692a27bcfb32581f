"""Device mesh over the five canonical parallel axes: dp (data), pp
(pipeline stages), tp (tensor/heads), sp (sequence), ep (experts).

A mesh here spans one device, so every axis has size 1; a mesh over
more devices raises until the collectives are ported onto
``torch.distributed`` (ROADMAP Queue 1 item 5)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

AXES = ("dp", "pp", "tp", "sp", "ep")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a mesh, laid out over ``axis_names``."""
    devices: np.ndarray           # of torch.device, one dimension per axis
    axis_names: tuple = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The mesh's one device."""
        return self.devices.flat[0]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over one device: ``devices[0]`` when given, else ``cuda:0``
    (which raises without a card).  More than one device raises."""
    n = n_devices if n_devices is not None else (
        len(devices) if devices is not None else 1)
    if n != 1 or (devices is not None and len(devices) != 1):
        raise NotImplementedError(
            f"a mesh over {n} devices needs the collectives over "
            f"torch.distributed (ROADMAP Queue 1 item 5); this package "
            f"runs on one device")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh defaults to cuda:0; pass "
                "devices=[torch.device('cpu')] to run on the CPU")
        devices = [torch.device("cuda", 0)]
    arr = np.empty((1,) * len(AXES), dtype=object)
    arr.flat[0] = torch.device(devices[0])
    return Mesh(arr)


def axis_size(axis_name: str) -> int:
    """The size of a mesh axis: 1 for every axis, on one device.  The
    sp = 1 and pp = 1 forms of ring_attention, sequence and pipeline
    rest on it."""
    if axis_name not in AXES:
        raise ValueError(f"unknown mesh axis {axis_name!r}; axes are {AXES}")
    return 1
