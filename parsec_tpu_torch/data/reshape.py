"""Reshape engine: lazy type/shape conversion across dataflow edges.

Reference behavior: when a producer's datatype differs from what a
consumer declares (e.g. full tile -> lower triangle), a *reshape promise*
(``parsec_datacopy_future_t``) is attached to the edge; the FIRST consumer
to need the data triggers the conversion, concurrent consumers of the same
(copy, type) dedup onto one promise, and the converted copy is released
with the promise (ref: parsec/parsec_reshape.c:1-771, promise structs
parsec/remote_dep.h:86-117; 18 dedicated tests under
tests/collections/reshape/).

Here a "datatype" is a (dtype, shape, region) descriptor
(data/datatype.py); conversion is a masked cast instead of an MPI
pack/unpack. Local and remote variants share the promise machinery:
the local trigger converts an existing host/device copy; the remote
variant is armed before the payload exists and converts on arrival.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..core.future import DataCopyFuture
from .data import Coherency, Data, DataCopy
from .datatype import Datatype, dtt_of_array


def reshape_array(arr: Any, dst: Datatype, src: Optional[Datatype] = None) -> Any:
    """Convert ``arr`` to datatype ``dst``: cast + region mask (+ reshape
    when element counts match). The conversion body is numpy for host
    arrays and torch for device tensors (the relayout-kernel analog of
    ce.reshape)."""
    if src is None:
        src = dtt_of_array(arr)
    if arr.shape != tuple(dst.shape):
        if src.nb_elts != dst.nb_elts:
            raise ValueError(
                f"reshape {src.shape}->{dst.shape}: element counts differ")
        arr = arr.reshape(dst.shape)
    if np.dtype(src.dtype) != np.dtype(dst.dtype):
        if isinstance(arr, np.ndarray):
            arr = arr.astype(dst.dtype)
        else:
            import torch
            arr = arr.to(getattr(torch, np.dtype(dst.dtype).name))
    if dst.region != "full" and dst.region != src.region:
        mask = dst.mask()
        if mask is not None:
            if isinstance(arr, np.ndarray):
                arr = np.where(mask, arr, np.zeros((), dtype=arr.dtype))
            else:
                import torch
                m = torch.as_tensor(mask, device=arr.device)
                arr = torch.where(m, arr, torch.zeros((), dtype=arr.dtype,
                                                      device=arr.device))
    return arr


def reshape_batch(arr: Any, dst: Datatype) -> Any:
    """``reshape_array`` over a leading batch dimension: each
    ``arr[i]`` (a tile of ``dst.shape``) is cast and region-masked as
    ``reshape_array(arr[i], dst)`` would, in one call (the wave and
    turbo engines convert a stack of same-class tiles at once)."""
    import torch
    if tuple(arr.shape[1:]) != tuple(dst.shape):
        raise ValueError(f"reshape_batch: tiles {tuple(arr.shape[1:])} "
                         f"are not {tuple(dst.shape)}")
    dt = getattr(torch, np.dtype(dst.dtype).name)
    if arr.dtype != dt:
        arr = arr.to(dt)
    mask = dst.mask()
    if mask is not None:
        m = torch.as_tensor(mask, device=arr.device)
        arr = torch.where(m, arr, torch.zeros((), dtype=arr.dtype,
                                              device=arr.device))
    return arr


def _needs_reshape(copy: DataCopy, dst: Datatype) -> bool:
    src = copy.dtt
    if src is None:
        payload = copy.payload
        if payload is None:
            return True  # cannot prove compatibility; promise will decide
        src = dtt_of_array(payload)
    return not src.compatible_wire(dst)


class ReshapeRepo:
    """Per-taskpool table of reshape promises with dedup.

    Keyed by (source copy identity, destination datatype): N consumers of
    one produced copy that declare the same [type=...] share ONE converted
    copy, converted once (ref: reshape dedup of concurrent promises,
    parsec_reshape.c setup_matching_reshape paths).
    """

    def __init__(self) -> None:
        self._promises: Dict[Tuple, DataCopyFuture] = {}
        self._lock = threading.Lock()
        self.stats = {"local_promises": 0, "remote_promises": 0,
                      "conversions": 0, "hits": 0}

    # -- local reshape ------------------------------------------------------
    def reshaped_copy(self, copy: Optional[DataCopy], dst: Datatype,
                      es: Any = None) -> Optional[DataCopy]:
        """Return a copy matching ``dst``, converting lazily via a shared
        promise. Non-matching copies are never mutated — the original
        stays valid for consumers that want the producer's type."""
        if copy is None or copy.payload is None:
            return copy
        if not _needs_reshape(copy, dst):
            return copy
        fut = self.promise(copy, dst)
        return fut.get_or_trigger()

    def promise(self, copy: DataCopy, dst: Datatype) -> DataCopyFuture:
        """The shared promise converting ``copy`` to ``dst`` (local
        variant: the source payload already exists)."""
        key = (id(copy), dst)
        with self._lock:
            fut = self._promises.get(key)
            if fut is not None:
                self.stats["hits"] += 1
                return fut

            def trigger(_spec, _copy=copy, _dst=dst):
                self.stats["conversions"] += 1
                src_dtt = _copy.dtt or dtt_of_array(_copy.payload)
                arr = reshape_array(_copy.payload, _dst, src_dtt)
                return _detached_copy(arr, _dst, version=_copy.version)

            fut = DataCopyFuture(spec=dst, trigger_cb=trigger)
            self._promises[key] = fut
            self.stats["local_promises"] += 1
            return fut

    # -- remote reshape -----------------------------------------------------
    def incoming_promise(self, edge_key: Tuple, dst: Datatype
                         ) -> Tuple[DataCopyFuture, Callable[[Any], None]]:
        """Remote variant: the promise is armed BEFORE the payload exists
        (the receiver knows the consumer's type from its own dep lookup,
        ref: remote_dep_mpi_retrieve_datatype both-ends lookup). Returns
        (future, deliver); call ``deliver(ndarray)`` when the wire data
        arrives — consumers already waiting convert exactly once."""
        key = ("remote", edge_key, dst)
        with self._lock:
            ent = self._promises.get(key)
            if ent is not None:
                self.stats["hits"] += 1
                return ent, getattr(ent, "_deliver", lambda a: None)

            arrival = DataCopyFuture(spec=None)

            def trigger(_spec, _dst=dst):
                arr = arrival.get()  # blocks until wire data delivered
                self.stats["conversions"] += 1
                return _detached_copy(reshape_array(arr, _dst), _dst,
                                      version=1)

            fut = DataCopyFuture(spec=dst, trigger_cb=trigger)

            def deliver(arr: Any) -> None:
                if not arrival.is_ready():
                    arrival.set(arr)
                fut.trigger()

            fut._deliver = deliver  # type: ignore[attr-defined]
            self._promises[key] = fut
            self.stats["remote_promises"] += 1
            return fut, deliver

    def clear(self) -> None:
        with self._lock:
            self._promises.clear()


def _detached_copy(arr: Any, dtt: Datatype, version: int = 1) -> DataCopy:
    d = Data(nb_elts=dtt.nb_elts)
    c = DataCopy(d, 0, payload=arr, dtt=dtt)
    c.version = version
    c.coherency = Coherency.OWNED
    d.attach_copy(c)
    return c
