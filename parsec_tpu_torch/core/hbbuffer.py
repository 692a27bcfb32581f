"""Hierarchical bounded buffers (hbbuffer) and the max-heap.

Reference behavior: ``parsec_hbbuffer_t`` — a bounded per-thread buffer whose
overflow spills to a parent push function (ultimately the global system
dequeue); used by all local-queue schedulers (ref: parsec/hbbuffer.c:1-277).
``parsec_maxheap`` orders tasks by priority for heap-based stealing
(ref: parsec/maxheap.c:1-384).

Like the list containers (core/lists.py), both are implemented in C++
(native/_native.cpp) and rebound here; the Python classes below stay
importable (``PyHBBuffer``, ``PyMaxHeap``) as the plain versions for the
native parity tests. The native HBBuffer reads ``item.priority``
directly when ``prio_fn`` is omitted — the schedulers' fast path.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional


class HBBuffer:
    """Bounded buffer; pushes that do not fit go to ``parent_push``.

    ``ranking`` mirrors the reference's priority-aware insertion: the buffer
    keeps the best tasks locally and spills the rest.
    """

    def __init__(self, size: int, parent_push: Callable[[Iterable[Any], int], None],
                 prio_fn: Callable[[Any], int] = lambda t: getattr(t, "priority", 0)) -> None:
        assert size > 0
        self.size = size
        self.parent_push = parent_push
        self.prio_fn = prio_fn
        self._items: List = []
        self._ctr = itertools.count()
        self._lock = threading.Lock()

    def push_all(self, items: Iterable[Any], distance: int = 0) -> None:
        spill: List[Any] = []
        with self._lock:
            for it in items:
                if len(self._items) < self.size:
                    heapq.heappush(self._items, (-self.prio_fn(it), next(self._ctr), it))
                else:
                    # keep the highest-priority tasks local, spill the lowest
                    lowest = max(self._items)
                    if (-self.prio_fn(it)) < lowest[0]:
                        idx = self._items.index(lowest)
                        spill.append(self._items[idx][2])
                        self._items[idx] = (-self.prio_fn(it), next(self._ctr), it)
                        heapq.heapify(self._items)
                    else:
                        spill.append(it)
        if spill:
            self.parent_push(spill, distance + 1)

    def pop_best(self) -> Optional[Any]:
        with self._lock:
            if not self._items:
                return None
            return heapq.heappop(self._items)[2]

    def is_empty(self) -> bool:
        return not self._items

    def __len__(self) -> int:
        return len(self._items)


class MaxHeap:
    """Priority max-heap of tasks (ref: parsec/maxheap.c)."""

    def __init__(self) -> None:
        self._h: List = []
        self._ctr = itertools.count()
        self._lock = threading.Lock()

    def insert(self, item: Any, priority: int = 0) -> None:
        with self._lock:
            heapq.heappush(self._h, (-priority, next(self._ctr), item))

    def pop_max(self) -> Optional[Any]:
        with self._lock:
            if not self._h:
                return None
            return heapq.heappop(self._h)[2]

    def split(self) -> "MaxHeap":
        """Steal roughly half the heap (heap-split stealing)."""
        out = type(self)()
        # share the tie-break counter: stolen entries keep their seq, so a
        # fresh counter would collide with them (TypeError on heapq tuple
        # comparison) and break FIFO-within-priority; the native split
        # does the same by continuing from self->seq
        out._ctr = self._ctr
        with self._lock:
            half = len(self._h) // 2
            if half:
                stolen = self._h[-half:]
                del self._h[-half:]
                heapq.heapify(self._h)
                out._h = stolen
                heapq.heapify(out._h)
        return out

    def __len__(self) -> int:
        return len(self._h)


PyHBBuffer, PyMaxHeap = HBBuffer, MaxHeap
# rebind to the native C++ core (native/__init__.py raises if it fails)
from ..native import native as _native  # noqa: E402

HBBuffer = _native.HBBuffer          # type: ignore[misc,assignment]
MaxHeap = _native.MaxHeap            # type: ignore[misc,assignment]
