"""Debug history: a bounded ring of recent runtime events.

Reference behavior: the PARSEC_DEBUG_HISTORY build keeps a ring buffer of
timestamped runtime marks (task transitions, messages) that is dumped when
something goes wrong, so a crash report carries the recent scheduling
history (ref: parsec/debug_marks.c + PARSEC_DEBUG_HISTORY,
CMakeLists.txt:183-193; SURVEY.md §5.2).

The ring is fed two ways: explicit ``mark()`` calls from runtime error
paths, and (when enabled) a PINS module that records task transitions —
the same hook sites the profiler uses, so nothing new is compiled into
the hot path. Enable with the MCA param ``debug_history_size`` (entries;
0 = off, the default) or programmatically via ``enable()``; enables are
refcounted so overlapping Contexts (in-process SPMD ranks) can share the
ring and the last ``disable()`` unhooks it. ``dump()`` renders the
newest-last history; Context.record_task_error dumps automatically on a
task failure.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional, Tuple

from ..profiling.pins import PinsEvent, PinsModule


class DebugHistory:
    """Bounded ring (deque(maxlen): O(1) append, auto-drop-oldest)."""

    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._t0 = time.monotonic_ns()
        self._ring: deque = deque(maxlen=max(capacity, 0))
        self._off = capacity <= 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(maxlen=max(capacity, 0))
            self._off = capacity <= 0

    def mark(self, what: str, detail: Any = None, th: Optional[int] = None) -> None:
        if self._off:
            return
        if th is None:
            th = threading.get_ident() & 0xFFFF
        ent = (time.monotonic_ns() - self._t0, th, what, detail)
        with self._lock:
            self._ring.append(ent)

    def entries(self) -> List[Tuple]:
        """Oldest-first surviving entries."""
        with self._lock:
            return list(self._ring)

    def dump(self, limit: Optional[int] = None) -> str:
        ents = self.entries()
        if limit is not None:
            ents = ents[-limit:]
        lines = [f"debug history ({len(ents)} entries, newest last):"]
        for ts, th, what, detail in ents:
            d = f" {detail}" if detail is not None else ""
            lines.append(f"  [{ts / 1e6:10.3f}ms th{th:05d}] {what}{d}")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class DebugHistoryModule(PinsModule):
    """Feed scheduling transitions into the ring via the PINS sites.

    SELECT events are excluded on purpose: idle workers fire SELECT_END
    with a None payload on every poll, which would flood the ring with
    noise and evict the task transitions the history exists to keep."""

    name = "debug_history"
    events = [PinsEvent.EXEC_BEGIN, PinsEvent.EXEC_END,
              PinsEvent.COMPLETE_EXEC_END, PinsEvent.SCHEDULE_BEGIN]

    def __init__(self, history: "DebugHistory") -> None:
        self.history = history

    def callback(self, es: Any, event: PinsEvent, payload: Any) -> None:
        if payload is None:
            return
        if event == PinsEvent.SCHEDULE_BEGIN:
            detail = f"{len(payload)} tasks"
        else:
            detail = payload.snprintf() if hasattr(payload, "snprintf") \
                else None
        self.history.mark(event.name, detail,
                          th=getattr(es, "th_id", None))


#: process-wide ring used by runtime error paths; empty until enabled
history = DebugHistory(capacity=0)
_module: Optional[DebugHistoryModule] = None
_enables = 0
_state_lock = threading.Lock()


def enabled() -> bool:
    return history.capacity > 0


def enable(capacity: int = 4096, pins: bool = True) -> DebugHistory:
    """Size the ring and hook the PINS feed. Refcounted: each Context
    that enables must disable; the ring empties at the last disable."""
    global _module, _enables
    with _state_lock:
        _enables += 1
        if history.capacity < capacity:
            history.resize(capacity)
        if pins and _module is None:
            _module = DebugHistoryModule(history)
            _module.enable()
    return history


def disable() -> None:
    global _module, _enables
    with _state_lock:
        _enables = max(0, _enables - 1)
        if _enables > 0:
            return
        if _module is not None:
            _module.disable()
            _module = None
        history.resize(0)
