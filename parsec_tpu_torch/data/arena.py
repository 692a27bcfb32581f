"""Arenas: sized freelist allocators for task/communication buffers.

Reference behavior: per-(type, shape) freelists of buffers used for
communication and NEW-tile allocation, with MCA caps ``arena_max_used`` /
``arena_max_cached`` (ref: parsec/arena.c, parsec/parsec.c:681-686).

An arena vends numpy host buffers (or, via a device module hook,
device-backed buffers) for a fixed Datatype. Freed buffers are
cached for reuse up to max_cached; max_used caps total live allocations.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional

import numpy as np

from ..utils.params import params
from .data import Data, DataCopy, Coherency
from .datatype import Datatype


class Arena:
    def __init__(self, dtt: Datatype, max_used: Optional[int] = None,
                 max_cached: Optional[int] = None, allocator=None) -> None:
        self.dtt = dtt
        mu = params.get("arena_max_used") if max_used is None else max_used
        mc = params.get("arena_max_cached") if max_cached is None else max_cached
        self.max_used = None if mu in (-1, None) else mu
        self.max_cached = None if mc in (-1, None) else mc
        self._free: List[Any] = []
        self._used = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # allocator(dtt) -> backing buffer; default host numpy
        self._alloc = allocator or (lambda d: np.empty(d.shape, dtype=d.dtype))

    def allocate(self, block: bool = True) -> Any:
        with self._cond:
            while True:
                if self._free:
                    self._used += 1
                    return self._free.pop()
                if self.max_used is None or self._used < self.max_used:
                    self._used += 1
                    break
                if not block:
                    return None
                self._cond.wait()
        return self._alloc(self.dtt)

    def free(self, buf: Any) -> None:
        with self._cond:
            self._used -= 1
            if self.max_cached is None or len(self._free) < self.max_cached:
                self._free.append(buf)
            self._cond.notify()

    @property
    def used(self) -> int:
        return self._used

    @property
    def cached(self) -> int:
        return len(self._free)

    # -- data-copy integration ---------------------------------------------
    def new_copy(self, data: Data, device_id: int = 0) -> DataCopy:
        """Allocate an arena-backed DataCopy (recycled on copy destruct)."""
        buf = self.allocate()
        copy = DataCopy(data, device_id, payload=buf, dtt=self.dtt)
        copy.arena_chunk = _ArenaChunk(self, buf)
        data.attach_copy(copy)
        return copy


class _ArenaChunk:
    __slots__ = ("arena", "buf")

    def __init__(self, arena: Arena, buf: Any) -> None:
        self.arena = arena
        self.buf = buf

    def release_copy(self, copy: DataCopy) -> None:
        self.arena.free(self.buf)
        self.buf = None


class ZoneMalloc:
    """Segment-based arena allocator for device-heap offset bookkeeping
    (ref: parsec/utils/zone_malloc.c — the GPU heap sub-allocator).

    ``malloc(nbytes) -> offset`` (-1 when full, caller evicts), ``free``,
    with first-fit + coalescing. Rebound to the native C++ implementation
    below; this Python version keeps identical semantics.
    """

    def __init__(self, total: int, align: int = 512) -> None:
        if total <= 0 or align <= 0 or (align & (align - 1)):
            raise ValueError("total must be > 0, align a positive power of two")
        self.total = total
        self.align = align
        self._used = 0
        self._lock = threading.Lock()
        self._segs: List[List[int]] = [[0, total, 1]]  # [off, size, free]

    def malloc(self, nbytes: int) -> int:
        if nbytes <= 0:
            raise ValueError("nbytes must be > 0")
        want = (nbytes + self.align - 1) & ~(self.align - 1)
        with self._lock:
            for i, seg in enumerate(self._segs):
                off, size, free = seg
                if not free or size < want:
                    continue
                if size > want:
                    self._segs.insert(i + 1, [off + want, size - want, 1])
                    seg[1] = want
                seg[2] = 0
                self._used += want
                return off
        return -1

    def free(self, offset: int) -> None:
        with self._lock:
            for i, seg in enumerate(self._segs):
                if seg[0] == offset and not seg[2]:
                    seg[2] = 1
                    self._used -= seg[1]
                    if i + 1 < len(self._segs) and self._segs[i + 1][2]:
                        seg[1] += self._segs[i + 1][1]
                        del self._segs[i + 1]
                    if i > 0 and self._segs[i - 1][2]:
                        self._segs[i - 1][1] += seg[1]
                        del self._segs[i]
                    return
        raise ValueError("invalid or double free")

    def used(self) -> int:
        return self._used

    def available(self) -> int:
        return self.total - self._used

    def largest_free(self) -> int:
        with self._lock:
            return max((s[1] for s in self._segs if s[2]), default=0)


PyZoneMalloc = ZoneMalloc
from ..native import native as _native  # noqa: E402

ZoneMalloc = _native.ZoneMalloc      # type: ignore[misc,assignment]
