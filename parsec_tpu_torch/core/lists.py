"""Thread-safe LIFO / FIFO / dequeue / ordered list containers.

Reference behavior: lock-free LIFO (128-bit CAS), FIFO, dequeue, and
priority-ordered list used by every scheduler (ref: parsec/class/lifo.h,
parsec/class/parsec_list.h; SURVEY.md §2.1 "Class system").

The hot containers are implemented in C++ (``native/_native.cpp`` —
Treiber-stack LIFO, spinlocked deque/FIFO, priority-ordered map) and
rebound over the pure-Python versions below at import; the native core
is built at first use and a failed build raises.  The Python classes stay
importable (``PyLifo`` ...) as the plain versions the native parity
tests drive beside the native ones.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from collections import deque
from typing import Any, Iterable, List, Optional


class Lifo:
    """LIFO stack. push/pop single items or chains (iterables)."""

    def __init__(self) -> None:
        self._d: deque = deque()
        self._lock = threading.Lock()

    def push(self, item: Any) -> None:
        with self._lock:
            self._d.append(item)

    def push_chain(self, items: Iterable[Any]) -> None:
        with self._lock:
            self._d.extend(items)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._d.pop() if self._d else None

    def try_pop(self) -> Optional[Any]:
        return self.pop()

    def is_empty(self) -> bool:
        return not self._d

    def __len__(self) -> int:
        return len(self._d)


class Fifo:
    """FIFO queue."""

    def __init__(self) -> None:
        self._d: deque = deque()
        self._lock = threading.Lock()

    def push(self, item: Any) -> None:
        with self._lock:
            self._d.append(item)

    def push_chain(self, items: Iterable[Any]) -> None:
        with self._lock:
            self._d.extend(items)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._d.popleft() if self._d else None

    def is_empty(self) -> bool:
        return not self._d

    def __len__(self) -> int:
        return len(self._d)


class Dequeue:
    """Double-ended queue: push/pop at both ends (ref: parsec/class/dequeue.h).

    Schedulers push locally at the front and steal from the back.
    """

    def __init__(self) -> None:
        self._d: deque = deque()
        self._lock = threading.Lock()

    def push_front(self, item: Any) -> None:
        with self._lock:
            self._d.appendleft(item)

    def push_back(self, item: Any) -> None:
        with self._lock:
            self._d.append(item)

    def push_front_chain(self, items: Iterable[Any]) -> None:
        with self._lock:
            self._d.extendleft(reversed(list(items)))

    def push_back_chain(self, items: Iterable[Any]) -> None:
        with self._lock:
            self._d.extend(items)

    def pop_front(self) -> Optional[Any]:
        with self._lock:
            return self._d.popleft() if self._d else None

    def pop_back(self) -> Optional[Any]:
        with self._lock:
            return self._d.pop() if self._d else None

    def is_empty(self) -> bool:
        return not self._d

    def __len__(self) -> int:
        return len(self._d)


class OrderedList:
    """Priority-sorted list; higher priority pops first, FIFO within equal
    priority (ref: parsec_list with priority sorting, used by ap/ip/spq
    schedulers — parsec/mca/sched/ap/sched_ap_module.c:93-112).
    """

    def __init__(self) -> None:
        self._heap: List = []
        self._ctr = itertools.count()
        self._lock = threading.Lock()

    def push_sorted(self, item: Any, priority: int = 0) -> None:
        with self._lock:
            heapq.heappush(self._heap, (-priority, next(self._ctr), item))

    def push_sorted_chain(self, items: Iterable[Any], prio_fn) -> None:
        with self._lock:
            for it in items:
                heapq.heappush(self._heap, (-prio_fn(it), next(self._ctr), it))

    def pop_front(self) -> Optional[Any]:
        """Highest priority first."""
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def pop_back(self) -> Optional[Any]:
        """Lowest priority (inverse-priority pop, ip scheduler)."""
        with self._lock:
            if not self._heap:
                return None
            idx = max(range(len(self._heap)), key=lambda i: (self._heap[i][0], self._heap[i][1]))
            item = self._heap[idx][2]
            self._heap[idx] = self._heap[-1]
            self._heap.pop()
            if idx < len(self._heap):
                heapq.heapify(self._heap)
            return item

    def is_empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)


# keep the pure-Python implementations importable under stable names
PyLifo, PyFifo, PyDequeue, PyOrderedList = Lifo, Fifo, Dequeue, OrderedList

# rebind to the native C++ core (native/__init__.py raises if it fails)
from ..native import native as _native  # noqa: E402

Lifo = _native.Lifo                  # type: ignore[misc,assignment]
Fifo = _native.Fifo                  # type: ignore[misc,assignment]
Dequeue = _native.Dequeue            # type: ignore[misc,assignment]
OrderedList = _native.OrderedList    # type: ignore[misc,assignment]
