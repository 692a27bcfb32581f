"""MeshFabric: in-process ranks pinned to devices — payloads move device
to device, control messages stay in the process.

Reference behaviour being replaced: the funnelled-MPI comm engine moves
tile payloads host to host with Isend/Irecv on negotiated tags
(parsec/parsec_mpi_funnelled.c:245-365).  Here each SPMD rank thread of
one process is pinned to a torch device; the small control plane
(activations, GET requests) travels through the in-process queues of
``LocalFabric``, and a tile payload that lives on a device is copied
onto the consumer's device (a device-to-device copy, queued on the
producer's stream) and handed over by reference: it never becomes host
bytes.  A numpy payload is uploaded to the consumer's device.

On one card every rank is ``cuda:0`` (``devices=[cuda:0] * n``).  The
copies are then on-card copies, and each rank's reads of a handed-over
tensor wait for the producer's stream event (``data.mark_ready`` /
``wait_ready``).  ``MeshFabric(nb_ranks=n)`` without ``devices`` needs
n devices.  ``d2d_transfers`` / ``d2d_bytes`` count the device tensors
that crossed between ranks (messages and GET/PUT data); each engine's
``d2d_sent`` / ``d2d_sent_bytes`` its own sends.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..data.data import is_device_array, mark_ready, to_host_array
from .engine import TAG_PUT_DATA
from .local import LocalCommEngine, LocalFabric


def _devices(n: Optional[int]) -> List[Any]:
    import torch
    have = torch.cuda.device_count()
    n = have if n is None else n
    if n < 1 or have < n:
        raise RuntimeError(
            f"mesh fabric needs {n} devices, torch sees {have} CUDA "
            f"devices (pass devices=[...] to pin several ranks to one)")
    return [torch.device("cuda", i) for i in range(n)]


def _tensors_in(payload: Any) -> Tuple[int, int]:
    """(count, bytes) of the device tensors a message carries."""
    if is_device_array(payload):
        return 1, payload.numel() * payload.element_size()
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (list, tuple)):
        n = b = 0
        for v in payload:
            dn, db = _tensors_in(v)
            n += dn
            b += db
        return n, b
    return 0, 0


def _mesh_copy(payload: Any) -> Any:
    """The in-process 'wire': numpy arrays are copied (nothing host-side
    is shared between ranks), device tensors pass by reference — the
    sender hands over a private copy or a fresh tensor no one mutates."""
    if isinstance(payload, np.ndarray):
        return payload.copy()
    if isinstance(payload, dict):
        return {k: _mesh_copy(v) for k, v in payload.items()}
    if isinstance(payload, tuple):
        return tuple(_mesh_copy(v) for v in payload)
    if isinstance(payload, list):
        return [_mesh_copy(v) for v in payload]
    return payload


class MeshFabric(LocalFabric):
    """One rank per entry of ``devices``; control messages in-process,
    payloads moved device to device."""

    def __init__(self, nb_ranks: Optional[int] = None,
                 devices: Optional[List[Any]] = None) -> None:
        import torch
        if devices is None:
            devices = _devices(nb_ranks)
        devices = [torch.device(d) for d in devices]
        if nb_ranks is not None and nb_ranks != len(devices):
            raise ValueError(f"nb_ranks={nb_ranks} but {len(devices)} "
                             f"devices given")
        super().__init__(len(devices))
        self.devices = devices
        self.d2d_transfers = 0
        self.d2d_bytes = 0

    def engine(self, rank: int) -> "MeshCommEngine":
        eng = MeshCommEngine(self, rank)
        self.engines[rank] = eng
        return eng

    def _count_d2d(self, n: int, nbytes: int) -> None:
        with self._stat_lock:
            self.d2d_transfers += n
            self.d2d_bytes += nbytes


class MeshCommEngine(LocalCommEngine):
    """GET/PUT data and device-tensor payloads move device to device;
    AMs stay in the process."""

    fabric: MeshFabric

    def __init__(self, fabric: MeshFabric, rank: int) -> None:
        super().__init__(fabric, rank)
        #: this rank's share of the fabric's d2d counters (what it sent)
        self.d2d_sent = 0
        self.d2d_sent_bytes = 0

    @property
    def device(self) -> Any:
        return self.fabric.devices[self.rank]

    def _to_device_of(self, rank: int, array: Any) -> Any:
        """A private copy of a payload on ``rank``'s device (a device
        copy on the current stream, or an upload of a numpy array),
        marked ready for a consumer on another stream."""
        import torch
        dev = self.fabric.devices[rank]
        out = (array.to(dev, copy=True) if is_device_array(array)
               else torch.tensor(np.asarray(array), device=dev))
        return mark_ready(out)

    def send_am(self, dst: int, tag: int, payload: Any) -> None:
        n, nbytes = _tensors_in(payload)
        if n:
            self.fabric._count_d2d(n, nbytes)
            self.d2d_sent += n
            self.d2d_sent_bytes += nbytes
        super().send_am(dst, tag, payload)

    def _copy_for_wire(self, payload: Any) -> Any:
        return _mesh_copy(payload)

    # -- GET: serve with a copy on the requester's device ---------------
    def _serve_get(self, requester: int, h: Any) -> Any:
        return self._to_device_of(requester, h.array)

    # -- PUT: transfer first, land in the registered region on arrival --
    def put(self, dst_rank: int, remote_handle_id: int, array: Any,
            on_complete: Optional[Callable] = None) -> None:
        data = self._to_device_of(dst_rank, array)
        self.send_am(dst_rank, TAG_PUT_DATA,
                     {"handle": remote_handle_id, "data": data})
        if on_complete is not None:
            on_complete(array)

    def _on_put_data(self, src: int, payload: Any) -> None:
        h = self._mem.get(payload["handle"])
        if h is None:
            raise RuntimeError(f"PUT for unknown mem handle "
                               f"{payload['handle']}")
        if isinstance(h.array, np.ndarray):
            np.copyto(h.array, to_host_array(payload["data"]))
        else:
            # a device-resident region: rebind the handle to the arrived
            # private copy (the handle is the indirection layer)
            h.array = payload["data"]
