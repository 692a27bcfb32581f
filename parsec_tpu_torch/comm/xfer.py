"""Device data plane: tile transfers between rank processes, device to device.

Reference behavior being replaced: on multi-node runs the reference
moves tile payloads over MPI alongside the control traffic
(parsec/parsec_mpi_funnelled.c:245-365 — GET emulation over two-sided
sends through HOST buffers).  Here the CommEngine (TCP between
processes) stays the CONTROL plane — activations, GET requests, termdet
— and a cross-rank dataflow edge whose payload lives in device memory
is handed over by this plane instead of staging through the host.

Backends (MCA ``xfer_backend``):

- ``ipc`` — rank processes sharing one CUDA card.  The producer parks a
  private device copy of the tile (taken on its device module's stream)
  and ships its CUDA IPC handle in the activation; the consumer opens the
  handle, copies the tile into its own memory on its device module's
  stream, waits for the copy and ACKs; the ACK releases the park.
  PyTorch's caching allocator suballocates, so the handle names the
  base allocation and the byte offset travels with it
  (``UntypedStorage._share_cuda_``); the producer's stream event
  travels too, so the consumer's copy queues behind the producer's
  writes.  PyTorch caches an opened handle per process.  A failure to
  open or copy raises: nothing falls back to host staging.
- ``loopback`` — host sockets (xfer/loopback.py), for a context on the
  CPU (the tests).
- ``auto`` (default) — ``ipc`` when the plane's device is a CUDA
  device, ``loopback`` otherwise.

Without a plane attached, payloads stage through the host over the
comm engine (the default), as in the JAX package.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..utils import logging as plog
from .engine import TAG_USER_BASE

TAG_XFER_ADDR = TAG_USER_BASE - 2  # reserved (transport sync uses -1)
TAG_XFER_ACK = TAG_USER_BASE - 3   # consumer pulled: release the park


def _resolve_backend(backend: Optional[str], device: Any) -> str:
    if backend is None:
        from ..utils.params import params
        backend = str(params.get("xfer_backend") or "auto")
    if backend not in ("auto", "ipc", "loopback"):
        raise ValueError(f"xfer_backend={backend!r}: expected "
                         f"auto/ipc/loopback")
    if backend == "auto":
        backend = "ipc" if getattr(device, "type", None) == "cuda" \
            else "loopback"
    if backend == "ipc":
        if getattr(device, "type", None) != "cuda":
            raise ValueError(f"xfer_backend=ipc needs a CUDA device, "
                             f"got {device}")
        if "expandable_segments:true" in os.environ.get(
                "PYTORCH_CUDA_ALLOC_CONF", "").replace(" ", "").lower():
            raise RuntimeError(
                "the CUDA IPC device plane cannot share memory from "
                "expandable segments: unset expandable_segments in "
                "PYTORCH_CUDA_ALLOC_CONF")
    return backend


class _IPCBackend:
    """CUDA IPC between processes on one card (see the module docstring)."""

    name = "ipc"

    def __init__(self, device: Any, stream: Any) -> None:
        self.device = device
        self.stream = stream

    def address(self) -> str:
        return f"ipc:{os.getpid()}"

    def park(self, arr: Any) -> Tuple[Any, Dict[str, Any]]:
        """A private copy of ``arr`` and its IPC descriptor.  The copy
        and the interprocess event the descriptor carries are both on
        the device module's stream, so the event fires after the kernel
        that wrote ``arr``; the copy is a fresh allocation, so no later
        write to ``arr`` reaches the consumer."""
        import torch
        from ..data.data import order_after_writer
        # a tile written on another stream of this process (a rank
        # thread's, or a chip's of a mesh) is copied only after its
        # producer's event or stream
        order_after_writer(arr, self.stream)
        with torch.cuda.stream(self.stream):
            t = arr.detach().to(self.device).contiguous().clone()
            (dev, handle, size, off, rc, rco, ev,
             ev_sync) = t.untyped_storage()._share_cuda_()
        desc = {"dev": dev, "handle": handle, "size": size, "off": off,
                "rc": rc, "rco": rco, "ev": ev, "ev_sync": ev_sync,
                "toff": t.storage_offset(), "shape": tuple(t.shape),
                "stride": tuple(t.stride()), "dtype": str(t.dtype)}
        return t, desc

    def pull(self, desc: Dict[str, Any]) -> Any:
        """Open the producer's parked tile and copy it into this
        process's memory on the device module's stream; returns when the
        copy has landed (the ACK may then release the park)."""
        import torch
        dtype = getattr(torch, desc["dtype"].split(".")[-1])
        with torch.cuda.stream(self.stream):
            # waits on the producer's event in this stream
            storage = torch.UntypedStorage._new_shared_cuda(
                desc["dev"], desc["handle"], desc["size"], desc["off"],
                desc["rc"], desc["rco"], desc["ev"], desc["ev_sync"])
            remote = torch._utils._rebuild_tensor(
                torch.storage.TypedStorage(wrap_storage=storage,
                                           dtype=dtype, _internal=True),
                desc["toff"], desc["shape"], desc["stride"])
            out = remote.clone()
        self.stream.synchronize()
        del remote, storage
        return out


class _LoopbackBackend:
    """Host sockets (xfer/loopback.py)."""

    name = "loopback"

    def __init__(self, device: Any, host: str) -> None:
        from ..xfer import loopback
        self.device = device
        self.server = loopback.start_transfer_server(f"{host}:0")
        self._conns: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def address(self) -> str:
        return self.server.address()

    def park_uuid(self, uuid: int, arr: Any) -> None:
        self.server.await_pull(uuid, [arr])

    def pull_uuid(self, addr: str, uuid: int, shape: Tuple,
                  dtype: str) -> Any:
        import torch
        # connect() blocks on the network: never under the lock
        conn = self._conns.get(addr)
        if conn is None:
            new_conn = self.server.connect(addr)
            with self._lock:
                conn = self._conns.setdefault(addr, new_conn)
            if conn is not new_conn:
                new_conn.close()
        arr = conn.pull(uuid, [(tuple(shape), dtype)])[0]
        return torch.from_numpy(arr.copy()).to(self.device)

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()
        self.server.close()


class DeviceDataPlane:
    """One per rank: parks device tiles for remote pulls and pulls
    peers' parked tiles into local device memory.

    uuids are partitioned by rank (rank in the high bits) so producers
    never collide.  ``register`` parks a tile for one remote pull and
    returns ``(uuid, shape, dtype)``; ``descriptor(uuid)`` is what the
    consumer needs besides (the IPC handle; None on loopback);
    ``pull`` fetches a peer's parked tile; ``release`` drops a park
    once its consumer ACKed.

    ``device`` is the context's CUDA device module (its torch device
    and stream are used) or a torch device.
    """

    def __init__(self, ce, device: Any = None, host: str = "127.0.0.1",
                 backend: Optional[str] = None) -> None:
        import torch
        stream = getattr(device, "stream", None)
        tdev = getattr(device, "torch_device", device)
        if tdev is None:
            tdev = torch.device("cuda", 0)
        self.device = torch.device(tdev)
        self.backend_name = _resolve_backend(backend, self.device)
        if self.backend_name == "ipc":
            if stream is None:
                stream = torch.cuda.current_stream(self.device)
            self._be: Any = _IPCBackend(self.device, stream)
        else:
            self._be = _LoopbackBackend(self.device, host)
        self.ce = ce
        self.addresses: Dict[int, str] = {ce.rank: self._be.address()}
        self._uuid_next = 1
        self._parked: Dict[int, Any] = {}   # uuid -> tensor (keep-alive)
        self._descs: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self.stats = {"pulls": 0, "serves": 0, "bytes_pulled": 0,
                      "releases": 0}
        ce.tag_register(TAG_XFER_ADDR, self._on_addr)
        for r in range(ce.nb_ranks):
            if r != ce.rank:
                ce.send_am(r, TAG_XFER_ADDR,
                           {"rank": ce.rank, "addr": self._be.address(),
                            "backend": self.backend_name})
        ce.device_plane = self

    def _on_addr(self, src: int, payload: Dict) -> None:
        if payload.get("backend") != self.backend_name:
            raise RuntimeError(
                f"rank {self.ce.rank}: device plane backend "
                f"{self.backend_name!r}, rank {src} runs "
                f"{payload.get('backend')!r}")
        self.addresses[payload["rank"]] = payload["addr"]

    def exchange(self, timeout: float = 30.0) -> None:
        """Progress the CE until every peer's address arrived."""
        t0 = time.monotonic()
        while len(self.addresses) < self.ce.nb_ranks:
            self.ce.progress()
            if time.monotonic() - t0 > timeout:
                missing = [r for r in range(self.ce.nb_ranks)
                           if r not in self.addresses]
                raise TimeoutError(
                    f"no transfer address from ranks {missing}")
            time.sleep(0.001)

    @property
    def leaked_parks(self) -> int:
        """Parks not yet released (0 once every consumer ACKed)."""
        with self._lock:
            return len(self._parked)

    # ------------------------------------------------------------------ #
    def register(self, arr: Any) -> Tuple[int, Tuple, str]:
        """Park a device tile for one remote pull; returns the wire
        descriptor (uuid, shape, dtype_name)."""
        with self._lock:
            uuid = (self.ce.rank << 40) | self._uuid_next
            self._uuid_next += 1
        if self.backend_name == "ipc":
            kept, desc = self._be.park(arr)
        else:
            self._be.park_uuid(uuid, arr)
            kept, desc = arr, None
        with self._lock:
            self._parked[uuid] = kept
            self._descs[uuid] = desc
            self.stats["serves"] += 1
        return uuid, tuple(arr.shape), str(arr.dtype).split(".")[-1]

    def is_parked(self, uuid: int) -> bool:
        """True until the consumer's ACK released ``uuid``'s park."""
        with self._lock:
            return uuid in self._parked

    def descriptor(self, uuid: int) -> Any:
        with self._lock:
            return self._descs.get(uuid)

    def release(self, uuid: int) -> None:
        """Drop the keep-alive once the consumer confirmed the pull."""
        with self._lock:
            if self._parked.pop(uuid, None) is not None:
                self.stats["releases"] += 1
            self._descs.pop(uuid, None)

    def pull(self, src_rank: int, uuid: int, shape: Tuple, dtype: str,
             desc: Any = None) -> Any:
        """Fetch a tile parked by ``src_rank`` into a tensor on this
        plane's device; raises on any failure."""
        if self.backend_name == "ipc":
            if desc is None:
                raise RuntimeError(f"device plane pull of uuid {uuid:#x} "
                                   f"from rank {src_rank} without its IPC "
                                   f"descriptor")
            out = self._be.pull(desc)
        else:
            with self._lock:
                addr = self.addresses.get(src_rank)
            if addr is None:
                raise RuntimeError(
                    f"no transfer address for rank {src_rank} "
                    f"(exchange() not run?)")
            out = self._be.pull_uuid(addr, uuid, shape, dtype)
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"device plane pull of uuid {uuid:#x}: "
                               f"shape {tuple(out.shape)} != {tuple(shape)}")
        nbytes = out.numel() * out.element_size()
        with self._lock:
            self.stats["pulls"] += 1
            self.stats["bytes_pulled"] += nbytes
        ds = getattr(self.ce, "dplane_stats", None)
        if ds is not None:
            # the engine-owned gauges (obs COMM::DPLANE_*)
            ds["dplane_xfers"] += 1
            ds["dplane_bytes"] += nbytes
        return out

    def fini(self) -> None:
        with self._lock:
            self._parked.clear()
            self._descs.clear()
        close = getattr(self._be, "close", None)
        if close is not None:
            close()
        plog.debug.verbose(3, "device plane rank %d: %s", self.ce.rank,
                           self.stats)
