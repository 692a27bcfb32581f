"""Readers-writer lock + value array.

Reference behavior: ``parsec_rwlock`` — a compact atomic readers-writer
lock used around shared runtime tables (ref: parsec/class/parsec_rwlock.c)
— and ``parsec_value_array_t`` — a growable array of fixed-size elements
(ref: parsec/class/value_array.h).

Here both are implemented in C++ in this package's native core
(``native/_native.cpp`` RWLock/ValueArray — write-preferring atomic lock
that releases the GIL while spinning, spinlocked byte array) and rebound
over the pure-Python versions below; the Python classes stay importable
(``PyRWLock``, ``PyValueArray``) as the plain versions the parity tests
drive beside the native ones.
"""
from __future__ import annotations

import threading


class RWLock:
    """Write-preferring readers-writer lock (fallback: condition-based)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def read_lock(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def read_unlock(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def write_lock(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def write_unlock(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    def nreaders(self) -> int:
        with self._cond:
            return self._readers


class ValueArray:
    """Growable array of fixed-size byte elements (zero-filled growth)."""

    def __init__(self, item_size: int) -> None:
        if item_size <= 0:
            raise ValueError("item_size must be positive")
        self._item = item_size
        self._buf = bytearray()
        self._n = 0
        self._lock = threading.Lock()

    def set_size(self, n: int) -> None:
        if n < 0:
            raise ValueError("negative size")
        with self._lock:
            need = n * self._item
            if need > len(self._buf):
                self._buf.extend(b"\0" * (need - len(self._buf)))
            else:
                del self._buf[need:]
            self._n = n

    def get(self, i: int) -> bytes:
        with self._lock:
            if not 0 <= i < self._n:
                raise IndexError("ValueArray index out of range")
            return bytes(self._buf[i * self._item:(i + 1) * self._item])

    def set(self, i: int, data) -> None:
        data = bytes(data)
        if len(data) != self._item:
            raise ValueError(f"expected {self._item} bytes per item")
        with self._lock:
            if not 0 <= i < self._n:
                raise IndexError("ValueArray index out of range")
            self._buf[i * self._item:(i + 1) * self._item] = data

    def push_back(self, data) -> int:
        data = bytes(data)
        if len(data) != self._item:
            raise ValueError(f"expected {self._item} bytes per item")
        with self._lock:
            idx = self._n
            self._buf.extend(data)
            self._n += 1
            return idx

    def item_size(self) -> int:
        return self._item

    def __len__(self) -> int:
        with self._lock:
            return self._n


# keep the pure-Python implementations importable under stable names
PyRWLock, PyValueArray = RWLock, ValueArray

# rebind to the native C++ core (native/__init__.py raises if it fails)
from ..native import native as _native  # noqa: E402

RWLock = _native.RWLock          # type: ignore[misc,assignment]
ValueArray = _native.ValueArray  # type: ignore[misc,assignment]
