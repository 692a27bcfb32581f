"""DTD — Dynamic Task Discovery front end, on one rank.

Reference behavior: a sequential task-insertion API that discovers the DAG at
runtime from data access modes (IN/OUT/INOUT + AFFINITY/DONT_TRACK), with
per-tile last-user tracking (WAR/WAW chaining, read-after-read fan-out),
sliding-window backpressure (window 8000 / threshold 4000), per-taskpool
registries of task classes and tiles, NEW-tile support, accelerator chores
via ``add_chore``, and explicit data flush back home
(ref: parsec/interfaces/dtd/insert_function.c, insert_function.h:284-425,
overlap_strategies.c:1-356, parsec_dtd_data_flush.c:1-397; call stack
SURVEY.md §3.5).

Public surface mirrors the reference:
``DTDTaskpool.insert_task(fn, args...)``, ``tile_of(collection, key)``,
``tile_new(...)``, ``data_flush/data_flush_all``, ``add_chore``, ``wait``.

This package runs one rank: the cross-rank half of the JAX package's DTD
(remote writers, send/recv tasks) is not carried, and a DTD pool added to
a context of several ranks raises.

Host bodies take ``(es, task)`` and read their arguments with
``unpack_args``: numpy arrays for tiles, mutated in place.  A CUDA chore
(``add_chore(body, "cuda", fn)``) is functional: ``fn`` gets one tensor
per tile on the device module's torch device and the raw value of every
VALUE param, and returns new tensors for the written tiles.  The device
module may stack a burst of same-class tasks and call ``fn`` ONCE on
tensors with a leading batch dimension, so ``fn`` must treat that
dimension as a batch: ``.mT`` (not ``.T``) for a transpose, ``dim=-2``
for a row concatenation; the tile operations of ``ops/linalg.py`` do.
"""
from __future__ import annotations

import threading
from enum import IntFlag
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ...core.hashtable import HashTable
from ...profiling.grapher import grapher
from ...data.data import Data, FlowAccess, data_new_with_payload
from ...runtime.scheduling import _Backoff, schedule, task_progress
from ...runtime.taskpool import Chore, Flow, HookReturn, Task, TaskClass, Taskpool
from ...runtime.termdet import termdet_new
from ...utils.params import params

__all__ = ["AccessMode", "INPUT", "OUTPUT", "INOUT", "VALUE", "SCRATCH",
           "REF", "AFFINITY", "DONT_TRACK", "DTDTile", "DTDTaskClass",
           "DTDTaskpool", "taskpool_new", "unpack_args"]


class AccessMode(IntFlag):
    """ref: parsec_dtd_op_t / flags in insert_function.h"""
    INPUT = 0x1
    OUTPUT = 0x2
    INOUT = 0x3
    VALUE = 0x10         # pass-by-value scalar argument
    SCRATCH = 0x20       # per-task scratch buffer
    REF = 0x40           # opaque reference, no tracking
    AFFINITY = 0x100     # place the task where this tile lives
    DONT_TRACK = 0x200   # do not build dependencies on this argument


INPUT = AccessMode.INPUT
OUTPUT = AccessMode.OUTPUT
INOUT = AccessMode.INOUT
VALUE = AccessMode.VALUE
SCRATCH = AccessMode.SCRATCH
REF = AccessMode.REF
AFFINITY = AccessMode.AFFINITY
DONT_TRACK = AccessMode.DONT_TRACK


class DTDTile:
    """ref: parsec_dtd_tile_t — tracked unit of data with last-user state.

    ``writers_seq`` counts the writes inserted on the tile and
    ``flushed_at_seq`` the write a flush was last inserted after; both
    change at insertion time, so ``data_flush_all`` flushes exactly the
    tiles written since their last flush.
    """

    __slots__ = ("key", "data", "last_writer", "readers", "lock",
                 "writers_seq", "flushed_at_seq")

    def __init__(self, key: Any, data: Data) -> None:
        self.key = key
        self.data = data
        self.last_writer: Optional["_DTDRecord"] = None
        self.readers: List["_DTDRecord"] = []
        self.lock = threading.Lock()
        self.writers_seq = 0
        self.flushed_at_seq = -1


class _DTDRecord:
    """Per-task DTD bookkeeping: dependency counter + successor list."""

    __slots__ = ("task", "deps_remaining", "successors", "completed", "lock")

    def __init__(self, task: Task) -> None:
        self.task = task
        self.deps_remaining = 1   # +1 insertion guard, dropped when fully parsed
        self.successors: List["_DTDRecord"] = []
        self.completed = False
        self.lock = threading.Lock()

    def add_successor(self, succ: "_DTDRecord") -> bool:
        """Register succ; returns False if we already completed (no dep)."""
        with self.lock:
            if self.completed:
                return False
            self.successors.append(succ)
            return True

    def dep_satisfied(self) -> bool:
        with self.lock:
            self.deps_remaining -= 1
            if self.deps_remaining < 0:
                raise RuntimeError(f"{self.task.snprintf()}: more dependency "
                                   f"releases than dependencies")
            return self.deps_remaining == 0


class _Param:
    __slots__ = ("value", "mode", "tile", "flow_index")

    def __init__(self, value: Any, mode: AccessMode, tile: Optional[DTDTile],
                 flow_index: int = -1) -> None:
        self.value = value
        self.mode = mode
        self.tile = tile
        self.flow_index = flow_index


def _dtd_cpu_hook(es, task: Task) -> HookReturn:
    """Run the user body on writable host arrays holding the newest
    version of every tile."""
    for p in task.user or ():
        if p.tile is not None:
            Data.materialize_host(p.tile.data.sync_to_host(es.context.devices))
    rc = task.task_class.user_body(es, task)
    return HookReturn.DONE if rc is None else rc


class DTDTaskClass(TaskClass):
    def __init__(self, name: str, tc_id: int, nb_flows: int,
                 body: Callable, flows: List[Flow]) -> None:
        super().__init__(name, tc_id, nb_flows, flows=flows,
                         incarnations=[Chore("cpu", _dtd_cpu_hook)])
        self.user_body = body
        self.prepare_input = _dtd_prepare_input
        self.release_deps = _dtd_release_deps


def _dtd_prepare_input(es, task: Task) -> HookReturn:
    """Resolve data_in copies (ref: data_lookup_of_dtd_task,
    insert_function.c:2014). Accelerator chores stage in themselves; the host
    path must pull the newest version back to the host copy."""
    will_run_on_device = any(
        ch.device_type != "cpu" and (task.chore_mask & (1 << i))
        for i, ch in enumerate(task.task_class.incarnations))
    for flow in task.task_class.flows:
        data = task.body_args[flow.flow_index].tile.data
        if will_run_on_device:
            task.data[flow.flow_index].data_in = \
                data.newest_copy() or data.host_copy()
        else:
            task.data[flow.flow_index].data_in = \
                data.sync_to_host(es.context.devices)
        task.data[flow.flow_index].fulfilled = True
    return HookReturn.DONE


def _dtd_release_deps(es, task: Task, action_mask: int) -> List[Task]:
    """ref: dtd_release_dep_fct (insert_function.c:1603) — mark written
    copies, wake satisfied successors."""
    rec: _DTDRecord = task.dtd
    # version bump for host-written flows (device epilog bumps its own)
    if task.selected_device is None or task.selected_device.device_type == "cpu":
        for flow in task.task_class.flows:
            if task.access_of(flow) & FlowAccess.WRITE:
                task.body_args[flow.flow_index].tile.data.version_bump(0)
    ready: List[Task] = []
    with rec.lock:
        rec.completed = True
        succs, rec.successors = rec.successors, []
    for s in succs:
        if grapher.enabled:
            grapher.dep(task, s.task.snprintf())
        if s.dep_satisfied():
            ready.append(s.task)
    task.taskpool._on_task_done()
    return ready


class DTDTaskpool(Taskpool):
    """ref: parsec_dtd_taskpool_new (insert_function.c)"""

    MAX_TASK_CLASSES = 25  # ref: insert_function_internal.h:30

    def __init__(self, name: str = "dtd") -> None:
        super().__init__(name=name)
        self.window_size = params.get("dtd_window_size")
        self.threshold_size = params.get("dtd_threshold_size")
        self._task_classes: Dict[Any, DTDTaskClass] = {}
        self._tiles = HashTable()
        self._outstanding = 0
        self._out_lock = threading.Lock()
        self._inserted = 0
        # keep-alive action until wait() (so an empty pool doesn't terminate)
        self.tdm = termdet_new("local", self)
        self.tdm.taskpool_addto_runtime_actions(1)
        self._alive = True
        # inserts before context.add_taskpool are buffered and replayed at
        # enqueue time, so DTD pools compose (parsec_compose chains enqueue
        # parts later) and nest (recursive_call) naturally
        self._pending_inserts: List[tuple] = []
        self.on_enqueue = self._on_enqueue

    def _on_enqueue(self, tp) -> None:
        if self.context.nb_ranks != 1:
            raise NotImplementedError(
                f"{self.name}: nb_ranks={self.context.nb_ranks}, but this "
                f"package runs DTD on one rank")
        pending, self._pending_inserts = self._pending_inserts, []
        for body, args, kw in pending:
            self.insert_task(body, *args, **kw)

    # ------------------------------------------------------------------ #
    # tiles                                                              #
    # ------------------------------------------------------------------ #
    def tile_of(self, collection, key: Any) -> DTDTile:
        """ref: parsec_dtd_tile_of (insert_function.h:219) — one DTDTile per
        (collection, key), memoized."""
        tile, _ = self._tiles.find_or_insert(
            (id(collection), key),
            lambda: DTDTile(key, collection.data_of_key(key)))
        return tile

    def tile_of_data(self, data: Data) -> DTDTile:
        tile, _ = self._tiles.find_or_insert(
            ("data", data.key), lambda: DTDTile(data.key, data))
        return tile

    def tile_of_array(self, arr: Any, key: Any = None) -> DTDTile:
        """Wrap a host array as a tracked tile."""
        return self.tile_of_data(data_new_with_payload(arr, device_id=0,
                                                       key=key))

    def tile_new(self, shape: Tuple[int, ...], dtype=np.float32,
                 key: Any = None) -> DTDTile:
        """ref: NEW-tile support (dtd_test_new_tile) — runtime-allocated."""
        return self.tile_of_array(np.zeros(shape, dtype=dtype), key=key)

    # ------------------------------------------------------------------ #
    # task classes + chores                                              #
    # ------------------------------------------------------------------ #
    def _task_class_of(self, body: Callable, nb_flows: int,
                       name: Optional[str]) -> DTDTaskClass:
        tc = self._task_classes.get(body)
        if tc is None:
            if len(self._task_classes) >= self.MAX_TASK_CLASSES:
                raise RuntimeError(
                    f"too many DTD task classes (ref limit "
                    f"{self.MAX_TASK_CLASSES})")
            flows = [Flow(f"flow{i}", FlowAccess.NONE, i)
                     for i in range(nb_flows)]
            tc = DTDTaskClass(name or getattr(body, "__name__", "dtd_task"),
                              len(self._task_classes), nb_flows, body, flows)
            self._task_classes[body] = tc
            self.task_classes.append(tc)
        if tc.nb_flows != nb_flows:
            raise ValueError(f"task class {tc.name} re-inserted with "
                             f"{nb_flows} tracked tiles, first with "
                             f"{tc.nb_flows}")
        return tc

    def add_chore(self, body: Callable, device_type: str, fn: Any) -> None:
        """ref: parsec_dtd_task_class_add_chore (insert_function.c:2432).

        ``device_type`` is ``"cuda"``.  ``fn`` takes one argument per
        inserted parameter in insertion order — a tensor on the device
        module's torch device for each tile, the raw value of each VALUE
        param (the order of unpack_args) — and returns new tensors for the
        written tiles, in order.  It runs per task on single tiles, or
        ONCE on a burst of same-class tasks with every tile argument
        stacked on a leading batch dimension (VALUE params must then be
        equal and hashable; tasks passing different values never stack).
        A chore that fails on a stack is not retried per task: the error
        aborts the DAG and re-raises from ``wait()``.  The chore applies
        to the class's tasks inserted after this call; the class exists
        from its first insert."""
        if device_type != "cuda":
            raise ValueError(f"add_chore: device type {device_type!r}; this "
                             f"package has one accelerator chore type, "
                             f"\"cuda\"")
        tc = self._task_classes.get(body)
        if tc is None:
            raise ValueError("add_chore before the first insert_task of "
                             "this body")

        def wrapped(task: Task, arrays: List[Any]) -> Any:
            return fn(*[arrays[p.flow_index] if p.tile is not None
                        else p.value for p in task.user
                        if p.tile is not None or (p.mode & VALUE)])

        # batched dispatch (devices/batching.py): tiles are the batch
        # arguments, VALUE params the static key
        from ...devices.batching import DeviceBatchSpec

        def extract(task: Task, arrays: List[Any]):
            bargs: List[Any] = []
            fidx: List[int] = []
            tmpl: List[Any] = []
            for p in task.user:
                if p.tile is not None:
                    tmpl.append(None)
                    bargs.append(arrays[p.flow_index])
                    fidx.append(p.flow_index)
                elif p.mode & VALUE:
                    try:
                        hash(p.value)
                    except TypeError:
                        return None
                    tmpl.append(("v", p.value))
            return tuple(bargs), tuple(fidx), tuple(tmpl)

        def call(bargs, static):
            it = iter(bargs)
            out = fn(*[next(it) if s is None else s[1] for s in static])
            if out is None:
                return ()
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)

        from ...devices.cuda import cuda_chore_hook
        tc.incarnations.append(Chore(
            "cuda", cuda_chore_hook(), dyld_fn=wrapped,
            batch_spec=DeviceBatchSpec(tc.name, extract, call)))

    # ------------------------------------------------------------------ #
    # insertion                                                          #
    # ------------------------------------------------------------------ #
    def insert_task(self, body: Callable, *args, name: Optional[str] = None,
                    priority: int = 0, _internal: bool = False) -> Optional[Task]:
        """ref: parsec_dtd_insert_task (insert_function.h:284, impl :3506).

        ``args`` are (value, VALUE) / (tile, INPUT|INOUT|OUTPUT [|AFFINITY...])
        pairs, or bare Python values (implicitly VALUE).  Before the pool
        is added to a context the insert is buffered (returns None) and
        replayed at enqueue time.
        """
        if not self._alive:
            raise RuntimeError(f"{self.name}: insert_task after wait() or "
                               f"seal()")
        if self.context is None:
            self._pending_inserts.append(
                (body, args, dict(name=name, priority=priority)))
            return None
        if not _internal:
            self._backpressure()
        # parse the vararg list (ref: __parsec_dtd_taskpool_create_task :3219)
        parsed: List[_Param] = []
        tracked: List[_Param] = []
        for a in args:
            if isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], AccessMode):
                val, mode = a
            else:
                val, mode = a, AccessMode.VALUE
            if mode & (VALUE | REF | SCRATCH | DONT_TRACK):
                parsed.append(_Param(val, mode, None))
                continue
            if not isinstance(val, DTDTile):
                raise TypeError(f"tracked argument must be a DTDTile, got "
                                f"{type(val)}")
            p = _Param(val, mode, val, flow_index=len(tracked))
            tracked.append(p)
            parsed.append(p)
        return self._insert_local(body, parsed, tracked, name, priority)

    def _insert_local(self, body: Callable, parsed: List[_Param],
                      tracked: List[_Param], name: Optional[str],
                      priority: int) -> Task:
        tc = self._task_class_of(body, len(tracked), name)
        task = Task(self, tc, locals_=(self._inserted,), priority=priority)
        self._inserted += 1
        rec = _DTDRecord(task)
        task.dtd = rec
        # per-INSTANCE access modes (the same body may be inserted with
        # different modes; the shared class Flow objects stay untouched)
        task.body_args = tracked
        task.user = parsed
        task.flow_access = [FlowAccess(int(p.mode) & 0x3) for p in tracked]
        self.add_tasks(1)
        with self._out_lock:
            self._outstanding += 1

        # dependency discovery from tile last-user state
        # (ref: overlap_strategies.c WAR/fan-out resolution)
        def _chain_after(pred: _DTDRecord) -> None:
            # take the dep BEFORE publishing rec to the predecessor: if the
            # increment came after add_successor, a concurrently-completing
            # predecessor could consume the insertion guard and schedule a
            # half-built task (then the guard drop would schedule it twice)
            with rec.lock:
                rec.deps_remaining += 1
            if not pred.add_successor(rec):
                rec.dep_satisfied()  # already completed; cannot hit zero here

        for p in tracked:
            tile = p.tile
            with tile.lock:
                writer = tile.last_writer
                if int(p.mode) & 0x3 == int(AccessMode.INPUT):
                    if writer is not None and writer is not rec:
                        _chain_after(writer)
                    # prune completed readers so read-mostly tiles don't
                    # retain every historical reader record
                    tile.readers = [r for r in tile.readers if not r.completed]
                    tile.readers.append(rec)
                else:  # OUTPUT or INOUT: chain after writer and all readers
                    preds = [writer] if writer is not None and writer is not rec \
                        else []
                    preds.extend(r for r in tile.readers if r is not rec)
                    for pr in preds:
                        _chain_after(pr)
                    tile.writers_seq += 1
                    tile.last_writer = rec
                    tile.readers = []

        # drop the insertion guard; schedule if ready
        if rec.dep_satisfied():
            schedule(self.context.execution_streams[0], [task])
        return task

    def _on_task_done(self) -> None:
        with self._out_lock:
            self._outstanding -= 1

    def _backpressure(self) -> None:
        """ref: parsec_dtd_block_if_threshold_reached (insert_function.c:3215)
        — over the window, the inserting thread helps execute."""
        if self._outstanding <= self.window_size:
            return
        ctx = self.context
        es = ctx.execution_streams[0]
        while self._outstanding > self.threshold_size:
            task = es.next_task
            es.next_task = None
            if task is None:
                task = ctx.scheduler.select(es)
            if task is not None:
                task_progress(es, task)
            elif ctx.progress_engines(es) == 0:
                break  # nothing runnable; don't deadlock the inserter

    # ------------------------------------------------------------------ #
    # flush + wait                                                       #
    # ------------------------------------------------------------------ #
    def data_flush(self, tile: DTDTile) -> None:
        """ref: parsec_dtd_data_flush — order a writeback of the tile to its
        home (host copy / collection storage) after its last user. One shared
        task class serves every flush (a per-call closure would exhaust the
        25-class limit)."""
        self.insert_task(_dtd_flush_body, (tile, INOUT | AFFINITY),
                         (tile, VALUE | REF), name="dtd_flush",
                         _internal=True)
        tile.flushed_at_seq = tile.writers_seq

    def data_flush_all(self) -> None:
        for _, tile in self._tiles.items():
            if tile.flushed_at_seq != tile.writers_seq:
                self.data_flush(tile)

    def seal(self) -> None:
        """No further inserts will come: flush dirty tiles and drop the
        keep-alive so the pool terminates once its tasks finish. Used when
        the pool runs without a blocking ``wait()`` — compound parts and
        recursive sub-pools (compose/recursive_call call this on enqueue)."""
        if not self._alive:
            return
        # flush while still alive: data_flush inserts flush tasks
        self.data_flush_all()
        self._alive = False
        self.tdm.taskpool_addto_runtime_actions(-1)

    def wait(self) -> None:
        """ref: parsec_dtd_taskpool_wait — drop the keep-alive and help
        execute until this taskpool terminates.  A task error (a host
        body, a CUDA chore, a launch) aborts the DAG and re-raises here."""
        if self.context is None:
            raise RuntimeError(f"{self.name}: wait() before "
                               f"context.add_taskpool")
        if self._alive:
            self._alive = False
            self.tdm.taskpool_addto_runtime_actions(-1)
        ctx = self.context
        ctx.start()
        es = ctx.execution_streams[0]
        backoff = _Backoff()
        while not self.completed and not ctx._task_errors:
            task = es.next_task
            es.next_task = None
            if task is None:
                task = ctx.scheduler.select(es)
            try:
                if task is not None:
                    task_progress(es, task)
                    backoff.hit()
                elif ctx.progress_engines(es):
                    backoff.hit()
                else:
                    backoff.miss(ctx)
            except BaseException as exc:
                ctx.record_task_error(exc, task)
        ctx.raise_pending_error()


def _dtd_flush_body(es, task: Task) -> None:
    """Shared flush task body: pull the newest copy back to the host."""
    tile: DTDTile = next(p.value for p in task.user if p.tile is None)
    tile.data.sync_to_host(es.context.devices)


def taskpool_new(name: str = "dtd") -> DTDTaskpool:
    return DTDTaskpool(name=name)


def unpack_args(task: Task) -> List[Any]:
    """ref: parsec_dtd_unpack_args — values for VALUE params, writable host
    ndarrays for tracked tiles (in the original insertion order)."""
    out: List[Any] = []
    for p in task.user:
        if p.tile is not None:
            host = p.tile.data.get_copy(0)
            out.append(None if host is None else Data.materialize_host(host))
        else:
            out.append(p.value)
    return out
