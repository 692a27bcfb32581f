"""Resizable, striped-lock hash table.

Reference behavior: bucket-locked resizable hash table used for dependency
tracking, DTD task/tile registries, and data repos
(ref: parsec/class/parsec_hash_table.h:93-145, parsec_hash_table.c:1-745).

Semantics preserved: insert-if-absent (``find_or_insert``), lock/unlock of a
key's bucket for atomic read-modify-write, removal returning the item.
Striped locks bound contention the way per-bucket locks do in the reference.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

_NSTRIPES = 64


class HashTable:
    def __init__(self, nb_stripes: int = _NSTRIPES) -> None:
        self._stripes = [dict() for _ in range(nb_stripes)]
        self._locks = [threading.RLock() for _ in range(nb_stripes)]
        self._n = nb_stripes

    def _idx(self, key: Any) -> int:
        return hash(key) % self._n

    # -- bucket locking (parsec_hash_table_lock_bucket) --------------------
    def lock_bucket(self, key: Any) -> None:
        self._locks[self._idx(key)].acquire()

    def unlock_bucket(self, key: Any) -> None:
        self._locks[self._idx(key)].release()

    # -- nolock variants: caller holds the bucket lock ---------------------
    def nolock_find(self, key: Any) -> Optional[Any]:
        return self._stripes[self._idx(key)].get(key)

    def nolock_insert(self, key: Any, value: Any) -> None:
        self._stripes[self._idx(key)][key] = value

    def nolock_remove(self, key: Any) -> Optional[Any]:
        return self._stripes[self._idx(key)].pop(key, None)

    # -- locked operations --------------------------------------------------
    def find(self, key: Any) -> Optional[Any]:
        i = self._idx(key)
        with self._locks[i]:
            return self._stripes[i].get(key)

    def insert(self, key: Any, value: Any) -> None:
        i = self._idx(key)
        with self._locks[i]:
            self._stripes[i][key] = value

    def find_or_insert(self, key: Any, factory: Callable[[], Any]) -> Tuple[Any, bool]:
        """Return (value, inserted). factory() runs under the bucket lock."""
        i = self._idx(key)
        with self._locks[i]:
            if key in self._stripes[i]:
                return self._stripes[i][key], False
            v = factory()
            self._stripes[i][key] = v
            return v, True

    def remove(self, key: Any) -> Optional[Any]:
        i = self._idx(key)
        with self._locks[i]:
            return self._stripes[i].pop(key, None)

    def update(self, key: Any, fn: Callable[[Optional[Any]], Any]) -> Any:
        """Atomic read-modify-write of one entry."""
        i = self._idx(key)
        with self._locks[i]:
            v = fn(self._stripes[i].get(key))
            self._stripes[i][key] = v
            return v

    def __len__(self) -> int:
        return sum(len(s) for s in self._stripes)

    def items(self) -> Iterator[Tuple[Any, Any]]:
        """Snapshot iteration (not linearizable across stripes)."""
        for i in range(self._n):
            with self._locks[i]:
                snap = list(self._stripes[i].items())
            yield from snap

    def clear(self) -> None:
        for i in range(self._n):
            with self._locks[i]:
                self._stripes[i].clear()


class HashTable64(HashTable):
    """Hash table restricted to 64-bit integer keys (the reference's
    ``parsec_key_t`` is a 64-bit word, parsec_hash_table.h:93). Rebound to
    the native C++ bucket-locked resizable table below."""

    def keys(self):
        return [k for k, _ in self.items()]


PyHashTable64 = HashTable64
from ..native import native as _native  # noqa: E402

HashTable64 = _native.HashTable64    # type: ignore[misc,assignment]
