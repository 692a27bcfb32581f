"""Mempool — per-thread freelists for frequently recycled objects.

Reference behavior: ``parsec_mempool_t`` / ``parsec_thread_mempool_t``
give each execution stream a private freelist of fixed-size elements
(task structs, remote-dep structs); allocation pops locally without
contention and elements return to the thread that owns them
(ref: parsec/mempool.c/.h, parsec/private_mempool.c — SURVEY.md §2.1).

Here Python task objects are interpreter-managed, so
the pool's job here is recycling *expensive payloads* — host scratch
buffers (DTD SCRATCH params), pinned staging arrays, reusable tile
temporaries. Same structure as the reference: a ``Mempool`` owns one
``ThreadMempool`` per thread (created on first touch, like
parsec_mempool_construct's per-ES array); ``allocate`` pops the calling
thread's freelist or constructs; ``free`` pushes back to the *owning*
thread's list (elements remember their owner, the
``parsec_thread_mempool_t *owner`` back-pointer)."""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

from ..utils import logging as plog

__all__ = ["Mempool", "ThreadMempool"]

# intrusive owner back-pointer (the reference's parsec_thread_mempool_t
# *owner field); set on the element itself so dropped elements carry no
# pool-side state
_OWNER_ATTR = "_parsec_mempool_owner"


def _drop_gauges(gauges: List[tuple]) -> None:
    """Unregister a named pool's SDE gauges (finalizer-safe: must not
    reference the pool). Passes each registered poll fn so a LIVE
    same-named pool's re-registration is left untouched (the identity
    guard SDERegistry.unregister exists for)."""
    from ..profiling.sde import sde
    for name, fn in gauges:
        sde.unregister(name, fn)


def _purge_owner(pool_ref: "weakref.ref", key: int) -> None:
    """weakref.finalize callback: drop a dead element's id entry without
    retaining the pool (a bound-method callback would keep the whole pool
    and its cached buffers alive for as long as any escaped element is)."""
    pool = pool_ref()
    if pool is not None:
        pool.owner_of.pop(key, None)


class ThreadMempool:
    """One thread's freelist (ref: parsec_thread_mempool_t)."""

    def __init__(self, pool: "Mempool", thread_id: int) -> None:
        self.pool = pool
        self.thread_id = thread_id
        self._free: List[Any] = []
        self._lock = threading.Lock()  # frees may come from other threads
        self.nb_elt = 0                # total constructed by this thread

    def allocate(self) -> Any:
        pool = self.pool
        with self._lock:
            if self._free:
                pool._note_alloc(hit=True)
                return self._free.pop()
            self.nb_elt += 1  # under the lock: free() races from other threads
        pool._note_alloc(hit=False)
        elt = pool.constructor()
        pool._set_owner(elt, self)
        return elt

    def push(self, elt: Any) -> None:
        with self._lock:
            if self.pool.max_cached < 0 or len(self._free) < self.pool.max_cached:
                self._free.append(elt)
            else:
                self.pool._disown(elt)  # dropped to GC: a stray later
                # free() must not re-insert it

    def __len__(self) -> int:
        with self._lock:
            return len(self._free)


class Mempool:
    """ref: parsec_mempool_t — a set of per-thread freelists sharing one
    constructor. ``max_cached`` bounds each thread's retained elements
    (-1 = unbounded, the reference default)."""

    def __init__(self, constructor: Callable[[], Any],
                 max_cached: int = -1, name: Optional[str] = None) -> None:
        self.constructor = constructor
        self.max_cached = max_cached
        self.owner_of: Dict[int, ThreadMempool] = {}
        self._threads: Dict[int, ThreadMempool] = {}
        self._lock = threading.Lock()
        # telemetry: allocation counters + outstanding high-water (plain
        # GIL int adds on the hot path, like sde.inc); a *named* pool
        # additionally exports pull gauges under PARSEC::MEMPOOL::<NAME>
        self.name = name
        self.nb_allocs = 0       # total allocate() calls
        self.nb_hits = 0         # served from a freelist (no construction)
        self.nb_outstanding = 0  # allocated minus freed
        self.outstanding_hwm = 0
        # fired (no args) after each free() returns an element, i.e.
        # whenever nb_outstanding drops — quota consumers (an admission queue,
        # for one) re-evaluate queued work on it; must be cheap and
        # must not raise (failures are logged and swallowed)
        self.on_free: Optional[Callable[[], None]] = None
        self._gauges: List[tuple] = []  # (name, poll fn) for unregister
        if name:
            self._register_gauges(name)

    def _note_alloc(self, hit: bool) -> None:
        self.nb_allocs += 1
        if hit:
            self.nb_hits += 1
        n = self.nb_outstanding = self.nb_outstanding + 1
        if n > self.outstanding_hwm:
            self.outstanding_hwm = n

    def _register_gauges(self, name: str) -> None:
        """Export this pool's accounting on the process-wide SDE registry
        (contextless, like the reference's process-global counters).

        The poll closures hold only a WEAK reference to the pool — a
        strong one would pin every cached buffer for the process
        lifetime (the exact leak the _purge_owner docstring warns
        about) — and a finalizer drops the gauge names once the pool is
        collected, so abandoned pools clean up after themselves.
        ``unregister_gauges()`` does it eagerly."""
        from ..profiling.sde import sde
        prefix = f"PARSEC::MEMPOOL::{name.upper()}"
        ref = weakref.ref(self)

        def poll(attr: str):
            def fn():
                pool = ref()
                if pool is None:
                    return None
                v = getattr(pool, attr)
                return v() if callable(v) else v
            return fn

        self._gauges = []
        for suffix, attr in (("ALLOCS", "nb_allocs"), ("HITS", "nb_hits"),
                             ("OUTSTANDING", "nb_outstanding"),
                             ("OUTSTANDING_HWM", "outstanding_hwm"),
                             ("CACHED", "nb_cached"),
                             ("CONSTRUCTED", "nb_constructed")):
            gname = f"{prefix}::{suffix}"
            fn = poll(attr)
            sde.register_poll(gname, fn)
            self._gauges.append((gname, fn))
        weakref.finalize(self, _drop_gauges, list(self._gauges))

    def unregister_gauges(self) -> None:
        """Eagerly drop this pool's gauges from the global registry
        (also happens automatically when the pool is collected)."""
        _drop_gauges(self._gauges)
        self._gauges = []

    def thread_mempool(self, thread_id: Optional[int] = None) -> ThreadMempool:
        tid = thread_id if thread_id is not None else threading.get_ident()
        tm = self._threads.get(tid)
        if tm is None:
            with self._lock:
                tm = self._threads.setdefault(tid, ThreadMempool(self, tid))
        return tm

    def allocate(self) -> Any:
        return self.thread_mempool().allocate()

    def _set_owner(self, elt: Any, tm: ThreadMempool) -> None:
        """Record which thread-pool constructed ``elt``.

        Preferred: an attribute on the element itself (the reference's
        intrusive owner back-pointer). Objects that reject attributes
        (numpy arrays, slotted classes) fall back to an id-keyed map whose
        entry a weakref finalizer purges when the element dies — so ids
        reused after GC can't alias a foreign object into the pool.
        """
        try:
            setattr(elt, _OWNER_ATTR, tm)
            return
        except (AttributeError, TypeError):
            pass
        key = id(elt)
        self.owner_of[key] = tm
        try:
            weakref.finalize(elt, _purge_owner, weakref.ref(self), key)
        except TypeError:
            # supports neither attributes nor weakrefs (object(), tuples):
            # the entry is purged when push() drops the element, but an
            # element the USER drops without free() leaves a stale id that
            # a later id-reuse could alias — use an attr- or
            # weakref-capable element type if elements may leak
            pass

    def _disown(self, elt: Any) -> None:
        """Sever ownership of a dropped element (both carrier forms)."""
        try:
            delattr(elt, _OWNER_ATTR)
            return
        except AttributeError:
            pass
        self.owner_of.pop(id(elt), None)

    def free(self, elt: Any) -> None:
        """Return ``elt`` to its owning thread's freelist (the reference's
        elements carry an owner back-pointer; cross-thread frees land in
        the owner's list, not the caller's)."""
        owner = getattr(elt, _OWNER_ATTR, None)
        if owner is None:
            owner = self.owner_of.get(id(elt))
        if owner is not None:
            self.nb_outstanding = max(0, self.nb_outstanding - 1)
            owner.push(elt)
            cb = self.on_free
            if cb is not None:
                try:
                    cb()
                except Exception as exc:  # noqa: BLE001 - never kill free
                    plog.warning("mempool %s: on_free hook failed: %r",
                                 self.name or "<anon>", exc)
        # unknown element: not pool-constructed; drop it (GC)

    def nb_cached(self) -> int:
        with self._lock:
            return sum(len(tm) for tm in self._threads.values())

    def nb_constructed(self) -> int:
        with self._lock:
            return sum(tm.nb_elt for tm in self._threads.values())
