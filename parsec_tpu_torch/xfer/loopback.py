"""Loopback transfer backend: the device-plane contract
(``start_transfer_server`` → server with ``address``/``await_pull``/
``connect``, connection with ``pull``) over plain TCP sockets.

The device data plane (comm/xfer.py) moves tiles between rank processes
on one card through CUDA IPC.  A context on the CPU has no card, so its
plane parks host copies here and serves them over a socket: the same
uuid-keyed one-shot pulls of parked arrays, so the tests run the real
:class:`~parsec_tpu_torch.comm.xfer.DeviceDataPlane` logic on the CPU.

Wire protocol (one request/response per pull, persistent connection):
request = ``<Q`` uuid; response = ``<I`` buffer count (``0xFFFFFFFF``
= unknown uuid) then per buffer ``<Q`` length + raw bytes.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ..data.data import is_device_array, to_host_array
from ..utils import logging as plog

_MISSING = 0xFFFFFFFF

_GUARDED_BY = {
    "LoopbackTransferServer._parked": "_lock",
}


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("loopback transfer peer closed")
        buf += chunk
    return bytes(buf)


class LoopbackConnection:
    """Client half: one persistent socket to a peer's server; pulls are
    serialized request/response round-trips (the lock covers the full
    round-trip so interleaved pulls from racing threads can't tear)."""

    def __init__(self, address: str) -> None:
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def pull(self, uuid: int,
             specs: Sequence[Tuple[Tuple[int, ...], str]]) -> List[np.ndarray]:
        """Fetch the arrays parked under ``uuid``; each lands as a host
        numpy array of its ``(shape, dtype)`` spec."""
        with self._lock:
            self._sock.sendall(struct.pack("<Q", uuid))  # lock: the lock IS the pull serializer
            (count,) = struct.unpack("<I", _read_exact(self._sock, 4))
            if count == _MISSING:
                raise KeyError(f"no parked arrays under uuid {uuid:#x}")
            bufs = []
            for _ in range(count):
                (ln,) = struct.unpack("<Q", _read_exact(self._sock, 8))
                bufs.append(_read_exact(self._sock, ln))
        if len(bufs) != len(specs):
            raise ValueError(
                f"uuid {uuid:#x}: {len(bufs)} parked buffers != "
                f"{len(specs)} requested specs")
        return [np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape)
                for raw, (shape, dt) in zip(bufs, specs)]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class LoopbackTransferServer:
    """Server half: parks host copies of arrays under their uuid and
    serves each to exactly one pull (pop-on-serve), over an accept loop
    of daemon threads."""

    def __init__(self, address: str) -> None:
        host, port = address.rsplit(":", 1)
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, int(port)))
        self._listen.listen(64)
        self._addr = f"{host}:{self._listen.getsockname()[1]}"
        self._parked: Dict[int, List[bytes]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"loopback-xfer-{self._addr}")
        self._accept_thread.start()

    def address(self) -> str:
        return self._addr

    def await_pull(self, uuid: int, arrays: Sequence[Any]) -> None:
        """Park host copies of ``arrays`` for one pull of ``uuid``.  The
        copy happens here (a tensor comes down on its device module's
        stream) so later producer-side mutation can't tear a serve."""
        bufs = [np.ascontiguousarray(
            to_host_array(a) if is_device_array(a) else np.asarray(a)
        ).tobytes() for a in arrays]
        with self._lock:
            self._parked[uuid] = bufs

    def connect(self, address: str) -> LoopbackConnection:
        return LoopbackConnection(address)

    def close(self) -> None:
        self._closed = True
        try:
            self._listen.close()
        except OSError:
            pass
        with self._lock:
            self._parked.clear()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listen.accept()
            except OSError:
                return  # closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_loop, args=(conn,),
                             daemon=True).start()

    def _serve_loop(self, conn: socket.socket) -> None:
        try:
            while not self._closed:
                (uuid,) = struct.unpack("<Q", _read_exact(conn, 8))
                with self._lock:
                    bufs = self._parked.pop(uuid, None)
                if bufs is None:
                    conn.sendall(struct.pack("<I", _MISSING))
                    continue
                parts = [struct.pack("<I", len(bufs))]
                for b in bufs:
                    parts.append(struct.pack("<Q", len(b)))
                    parts.append(b)
                conn.sendall(b"".join(parts))
        except (ConnectionError, OSError):
            pass  # peer closed (or server shutdown): thread exits
        finally:
            try:
                conn.close()
            except OSError:
                pass
        plog.debug.verbose(4, "loopback xfer %s: serve loop exit",
                           self._addr)


def start_transfer_server(address: str) -> LoopbackTransferServer:
    """A loopback transfer server listening on ``address``
    (``host:port``, port 0 = any)."""
    return LoopbackTransferServer(address)
