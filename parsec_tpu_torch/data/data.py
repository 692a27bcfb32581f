"""Data substrate: versioned per-device data copies with coherency.

Reference behavior: ``parsec_data_t`` holds one ``parsec_data_copy_t`` per
device, each with a version, a reader count, and a coherency state in
{INVALID, OWNED, EXCLUSIVE, SHARED}; ownership moves to a copy on write
access and readers attach to valid copies
(ref: parsec/data_internal.h:57-81, parsec/data.h:27-31,
parsec_data_transfer_ownership_to_copy parsec/data.c:286-370).

In this package a copy's payload is a numpy array on the host device or a
``torch.Tensor`` on the accelerator device. The device module
(devices/cuda.py) moves payloads and orders kernels on its CUDA stream,
or, on a chip mesh, on the stream of each chip; every host read of a
device payload goes through ``to_host_array``, which copies on the
stream that wrote it (:func:`stream_of`).
"""
from __future__ import annotations

import itertools
import threading
from enum import IntEnum
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.object import Obj

#: declared lock discipline, enforced by the concurrency lint
#: (the JAX package's analysis/lock_check.py reads the same map there):
#: the copy map is read by worker, comm, and device threads while
#: stage-in/eviction/writeback mutate it — every touch goes through
#: Data._lock (construction and refcount-zero teardown are exempt)
_GUARDED_BY = {
    "Data._copies": "_lock",
}


def is_device_array(x: Any) -> bool:
    """A torch tensor (device-resident payload): stays on the device
    through stage-in; numpy arrays and scalars take host paths."""
    import torch
    return isinstance(x, torch.Tensor)


#: torch device -> the stream its device module launches every kernel
#: and copy on (registered by devices/cuda.py).  A host read of a tensor
#: must queue behind the stream that wrote it, not the reading thread's
#: own.  Several modules may share one card (rank threads of one
#: process, each with its own context), and the one registered last
#: holds the device's entry: so a tensor a module wrote carries that
#: module's stream, or its chip's on a chip mesh (:func:`stream_of`),
#: and a host read goes through the pull of the module whose stream it
#: names (``_stream_pulls``).
_device_streams: Dict[Any, Any] = {}
_device_pulls: Dict[Any, Any] = {}
_stream_pulls: Dict[Any, Any] = {}


def register_device_stream(device: Any, stream: Any,
                           pull: Optional[Callable] = None) -> None:
    """The device module's stream, and its D2H copy (``pull``: the
    module's own bound method, which telemetry instruments; held weakly,
    so a finalized module's tiles are not kept alive) for
    ``to_host_array``."""
    _device_streams[device] = stream
    if pull is not None:
        _device_pulls[device] = weakref.WeakMethod(pull)
        _stream_pulls[stream] = weakref.WeakMethod(pull)


def tag_stream(t: Any, stream: Any) -> Any:
    """Record that ``stream`` wrote the tensor ``t`` (a chip mesh's
    streams; ``None`` leaves it untagged).  Returns ``t``."""
    if stream is not None and is_device_array(t):
        t._ptt_stream = stream
    return t


def stream_of(t: Any, default: Any = None) -> Any:
    """The stream that wrote ``t`` (:func:`tag_stream`), else
    ``default``.  A read of ``t`` queued on it waits for the writer."""
    s = getattr(t, "_ptt_stream", None)
    return default if s is None else s


def order_after_writer(t: Any, stream: Any) -> Any:
    """Make ``stream`` wait for whatever wrote ``t``: the producer's
    event of a hand-over (:func:`mark_ready`), and the stream tagged on
    ``t`` when it is another one; the caching allocator learns that
    ``stream`` uses ``t``'s memory.  Returns ``t``."""
    wait_ready(t, stream)
    s = getattr(t, "_ptt_stream", None)
    if s is not None and stream is not None and s != stream:
        stream.wait_stream(s)
        t.record_stream(stream)
    return t


def mark_ready(t: Any, stream: Any = None) -> Any:
    """Hand-over of a CUDA tensor to a consumer on another stream (a rank
    thread of the same process): record, on ``stream`` (default: the
    current one), the event the consumer's stream must wait for before
    it reads ``t``.  A host tensor needs nothing.  Returns ``t``."""
    if is_device_array(t) and t.is_cuda:
        import torch
        s = stream if stream is not None else torch.cuda.current_stream(
            t.device)
        ev = torch.cuda.Event()
        ev.record(s)
        t._ptt_ready = ev
    return t


def wait_ready(t: Any, stream: Any = None) -> Any:
    """The consumer's half of :func:`mark_ready`: ``stream`` (default:
    the current one) waits for the producer's event, and the caching
    allocator learns that ``stream`` uses ``t``'s memory.  Returns
    ``t``."""
    ev = getattr(t, "_ptt_ready", None)
    if ev is not None:
        import torch
        s = stream if stream is not None else torch.cuda.current_stream(
            t.device)
        s.wait_event(ev)
        t.record_stream(s)
    return t


def to_host_array(x: Any) -> Any:
    """A writable numpy array holding ``x``'s values, never sharing
    memory with a device payload (host bodies mutate in place).  A CUDA
    tensor is copied on the stream that wrote it (:func:`stream_of`: a
    chip's, else its device module's), so the copy waits for the kernel
    that produced it (and for the producer's event of a tensor handed
    over from another stream, :func:`mark_ready`)."""
    if not is_device_array(x):
        return np.array(x)
    ev = getattr(x, "_ptt_ready", None)
    if ev is not None:
        ev.synchronize()
    s = getattr(x, "_ptt_stream", None)
    ref = _stream_pulls.get(s) if s is not None else None
    pull = ref() if ref is not None else None
    if pull is None:
        ref = _device_pulls.get(x.device)
        pull = ref() if ref is not None else None
    if pull is not None:
        return pull(x)
    stream = stream_of(x, _device_streams.get(x.device))
    if stream is None:
        return x.detach().to("cpu", copy=True).numpy()
    import torch
    with torch.cuda.stream(stream):
        return x.detach().to("cpu", copy=True).numpy()


class Coherency(IntEnum):
    INVALID = 0
    OWNED = 1       # only valid version; other copies may be stale
    EXCLUSIVE = 2   # owned and no other copies exist
    SHARED = 3      # multiple valid copies


class FlowAccess(IntEnum):
    NONE = 0
    READ = 1
    WRITE = 2
    RW = 3


class DataCopy(Obj):
    """One incarnation of a Data on one device."""

    __slots__ = ("data", "device_id", "version", "readers", "coherency",
                 "payload", "flags", "dtt", "arena_chunk")

    def __init__(self, data: "Data", device_id: int, payload: Any = None,
                 dtt: Any = None) -> None:
        super().__init__()
        self.data = data
        self.device_id = device_id
        self.version = 0
        self.readers = 0
        self.coherency = Coherency.INVALID
        self.payload = payload
        self.dtt = dtt          # datatype/shape descriptor (see data/datatype.py)
        self.arena_chunk = None  # owning arena, for recycling on destruct

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<DataCopy dev={self.device_id} v={self.version} "
                f"{Coherency(self.coherency).name} readers={self.readers}>")

    def _destruct(self) -> None:
        if self.arena_chunk is not None:
            self.arena_chunk.release_copy(self)
            self.arena_chunk = None
        if self.data is not None:
            self.data._detach_copy(self)
        self.payload = None
        super()._destruct()


class Data(Obj):
    """A logical datum with per-device copies (ref: parsec_data_t)."""

    _key_iter = itertools.count()

    def __init__(self, key: Any = None, collection: Any = None,
                 nb_elts: int = 0) -> None:
        super().__init__()
        self.key = key if key is not None else next(Data._key_iter)
        self.collection = collection  # owning data collection, if any
        self.nb_elts = nb_elts        # logical payload size in elements/bytes
        self.owner_device: int = -1
        self.preferred_device: int = -1
        self._copies: Dict[int, DataCopy] = {}
        self._lock = threading.RLock()

    # -- copy management ----------------------------------------------------
    def attach_copy(self, copy: DataCopy) -> None:
        with self._lock:
            assert copy.device_id not in self._copies, \
                f"data {self.key} already has a copy on device {copy.device_id}"
            self._copies[copy.device_id] = copy
            copy.data = self

    def _detach_copy(self, copy: DataCopy) -> None:
        with self._lock:
            cur = self._copies.get(copy.device_id)
            if cur is copy:
                del self._copies[copy.device_id]

    def get_copy(self, device_id: int) -> Optional[DataCopy]:
        with self._lock:
            return self._copies.get(device_id)

    def copies(self) -> List[DataCopy]:
        with self._lock:
            return list(self._copies.values())

    def newest_version(self) -> int:
        with self._lock:
            return max((c.version for c in self._copies.values()
                        if c.coherency != Coherency.INVALID), default=-1)

    def newest_copy(self, exclude_device: int = -1) -> Optional[DataCopy]:
        """A valid copy holding the newest version (transfer source)."""
        with self._lock:
            best = None
            for c in self._copies.values():
                if c.coherency == Coherency.INVALID or c.device_id == exclude_device:
                    continue
                if best is None or c.version > best.version:
                    best = c
            return best

    # -- coherency protocol -------------------------------------------------
    def start_transfer_ownership(self, device_id: int, access: FlowAccess) -> Optional[DataCopy]:
        """Phase 1 (ref parsec_data_start_transfer_ownership_to_copy,
        parsec/data.c:318): decide whether device_id's copy needs a transfer
        and from where. Returns the source copy to pull from, or None if the
        local copy is already valid.
        """
        with self._lock:
            dst = self._copies.get(device_id)
            assert dst is not None, "transfer ownership to a non-attached copy"
            newest = self.newest_version()
            if dst.coherency != Coherency.INVALID and dst.version == newest:
                return None
            src = self.newest_copy(exclude_device=device_id)
            return src

    def complete_transfer_ownership(self, device_id: int, access: FlowAccess) -> DataCopy:
        """Phase 2: dst copy now holds the newest payload; fix states.

        Write access: dst becomes OWNED, all other copies SHARED (stale-able);
        read access: dst joins the SHARED set (or OWNED copy stays owner).
        """
        with self._lock:
            dst = self._copies[device_id]
            newest = self.newest_version()
            if dst.version < newest:
                dst.version = newest
            if access & FlowAccess.WRITE:
                for c in self._copies.values():
                    if c is not dst and c.coherency != Coherency.INVALID:
                        c.coherency = Coherency.SHARED
                dst.coherency = Coherency.OWNED
                self.owner_device = device_id
            else:
                if dst.coherency == Coherency.INVALID:
                    dst.coherency = Coherency.SHARED
                dst.readers += 1
            return dst

    def version_bump(self, device_id: int) -> int:
        """After a write completes: the writer's copy advances the version
        (ref: CUDA epilog OWNED handback, device_cuda_module.c:2365-2430)."""
        with self._lock:
            dst = self._copies[device_id]
            dst.version = self.newest_version() + 1
            dst.coherency = Coherency.OWNED
            self.owner_device = device_id
            for c in self._copies.values():
                if c is not dst and c.coherency != Coherency.INVALID:
                    c.coherency = Coherency.SHARED
            return dst.version

    def release_reader(self, device_id: int) -> None:
        with self._lock:
            c = self._copies.get(device_id)
            if c is not None and c.readers > 0:
                c.readers -= 1

    def invalidate_others(self, device_id: int) -> None:
        with self._lock:
            for c in self._copies.values():
                if c.device_id != device_id:
                    c.coherency = Coherency.INVALID

    # -- host-side helpers shared by the DSLs -------------------------------
    @staticmethod
    def materialize_host(copy: "DataCopy") -> Any:
        """Ensure ``copy.payload`` is a writable host ndarray and return it.

        A host (device-0) copy can transiently hold a device tensor or a
        read-only array. Host task bodies
        mutate payloads in place, so the first host consumer materializes
        a writable numpy buffer here; device consumers keep the zero-copy
        device array."""
        p = copy.payload
        if p is not None and not (isinstance(p, np.ndarray)
                                  and p.flags.writeable):
            copy.payload = to_host_array(p)
        return copy.payload

    def host_copy(self) -> DataCopy:
        """The device-0 copy, attached on demand."""
        with self._lock:
            host = self._copies.get(0)
            if host is None:
                host = DataCopy(self, 0, payload=None)
                self._copies[0] = host
            return host

    def sync_to_host(self, devices=None) -> DataCopy:
        """Make the host copy hold the newest version, pulling from the
        owning accelerator if needed. ``devices`` is the context device list
        indexed by device_id (None: direct conversion, no device-module
        stats/LRU bookkeeping)."""
        host = self.host_copy()
        newest = self.newest_copy()
        if newest is not None and newest.device_id != 0 and \
                newest.version > host.version:
            if devices is not None:
                devices[newest.device_id].pull_to_host(self)
                host = self.get_copy(0)
            else:
                host.payload = to_host_array(newest.payload)
                host.version = newest.version
                host.coherency = Coherency.SHARED
        return host

    def _destruct(self) -> None:
        for c in list(self._copies.values()):
            c.data = None
        self._copies.clear()
        super()._destruct()


def data_new_with_payload(payload: Any, device_id: int = 0, key: Any = None) -> Data:
    """Convenience: wrap an existing host array as a Data with one OWNED copy."""
    d = Data(key=key, nb_elts=getattr(payload, "size", 0))
    c = DataCopy(d, device_id, payload=payload)
    c.coherency = Coherency.OWNED
    c.version = 1
    d.attach_copy(c)
    d.owner_device = device_id
    return d
