"""DTD — Dynamic Task Discovery front end.

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

On several ranks, every rank inserts every task (SPMD insertion) and
only the placement rank executes it: the others update tile tracking
state and synthesize send tasks for data leaving their rank and recv
tasks for data arriving (tile-sequence matching over the comm engine,
comm/remote_dep.py).

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
from ...data.data import (Data, FlowAccess, data_new_with_payload,
                         is_device_array)
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


class RemoteWriter:
    """SPMD-consistent marker: the tile's last write happened on ``rank``
    and is the ``seq``-th write of the tile."""

    __slots__ = ("rank", "seq")

    def __init__(self, rank: int, seq: int) -> None:
        self.rank = rank
        self.seq = seq


class DTDTile:
    """ref: parsec_dtd_tile_t — tracked unit of data with last-user state.

    ``writers_seq`` counts every write by any rank (the insertion stream
    is SPMD-identical, so the count agrees everywhere) and
    ``flushed_at_seq`` the write a flush was last inserted after; both
    change at insertion time, so ``data_flush_all`` flushes exactly the
    tiles written since their last flush.  ``last_writer`` is a local
    record or a RemoteWriter; ``recv_proxy`` is the local recv-task
    record materializing a remote write; ``sent_to`` dedups sends of one
    version.
    """

    __slots__ = ("key", "comm_key", "rank", "data", "last_writer",
                 "readers", "lock", "writers_seq", "flushed_at_seq",
                 "sent_to", "recv_proxy", "recv_proxy_seq")

    def __init__(self, key: Any, data: Data, rank: int = 0,
                 comm_key: Any = None) -> None:
        self.key = key
        self.comm_key = comm_key if comm_key is not None else key
        self.rank = rank
        self.data = data
        self.last_writer: Any = None   # _DTDRecord | RemoteWriter | None
        self.readers: List["_DTDRecord"] = []
        self.lock = threading.Lock()
        self.writers_seq = 0
        self.flushed_at_seq = -1
        self.sent_to: set = set()
        self.recv_proxy: Optional["_DTDRecord"] = None
        self.recv_proxy_seq = -1


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
        self._coll_names: Dict[str, int] = {}
        self._tiles = HashTable()
        self._outstanding = 0
        self._out_lock = threading.Lock()
        self._inserted = 0
        # keep-alive action until wait() (so an empty pool doesn't terminate)
        self.tdm = termdet_new("local", self)
        self.tdm.taskpool_addto_runtime_actions(1)
        self._alive = True
        self.comm = None  # remote-dep driver, attached on register
        # inserts before context.add_taskpool are buffered and replayed at
        # enqueue time, so DTD pools compose (parsec_compose chains enqueue
        # parts later) and nest (recursive_call) naturally
        self._pending_inserts: List[tuple] = []
        self._mesh_hint_iter = 0   # insertion-order chip placement hint
        self.on_enqueue = self._on_enqueue

    def _on_enqueue(self, tp) -> None:
        pending, self._pending_inserts = self._pending_inserts, []
        for body, args, kw in pending:
            self.insert_task(body, *args, **kw)

    # ------------------------------------------------------------------ #
    # tiles                                                              #
    # ------------------------------------------------------------------ #
    def tile_of(self, collection, key: Any,
                wire_name: Optional[str] = None) -> DTDTile:
        """ref: parsec_dtd_tile_of (insert_function.h:219) — one DTDTile per
        (collection, key), memoized. The wire key uses the collection *name*
        (or the explicit ``wire_name`` override) so SPMD ranks agree on it
        (per-rank instances of one logical collection must share a name in
        multi-rank runs)."""
        name = wire_name if wire_name is not None else collection.name
        # wire keys are (name, key): on several ranks, catch two distinct
        # collections sharing a name before they cross-deliver tile data
        owner = self._coll_names.setdefault(name, id(collection))
        if owner != id(collection) and self.nb_ranks > 1:
            raise ValueError(
                f"two collections share the name {name!r}; set distinct "
                f".name values (the name keys tile messages between ranks)")

        def factory() -> DTDTile:
            rank = collection.rank_of_key(key)
            data = collection.data_of_key(key) if rank == self.my_rank \
                else Data(key=("remote", name, key))
            return DTDTile(key, data, rank=rank, comm_key=(name, key))
        tile, _ = self._tiles.find_or_insert((id(collection), key), factory)
        return tile

    def tile_of_data(self, data: Data) -> DTDTile:
        tile, _ = self._tiles.find_or_insert(
            ("data", data.key), lambda: DTDTile(data.key, data))
        return tile

    def tile_of_array(self, arr: Any, key: Any = None) -> DTDTile:
        """Wrap a host array as a tracked tile.  Keyless tiles get a
        deterministic insertion-order ``mesh_hint`` so a chip-mesh
        device (``device_mesh_shape``) round-robins them across its
        chips in the same order on every run."""
        data = data_new_with_payload(arr, device_id=0, key=key)
        data.mesh_hint = self._mesh_hint_iter
        self._mesh_hint_iter += 1
        return self.tile_of_data(data)

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

    def add_chore(self, body: Callable, device_type: str, fn: Any,
                  stacked: bool = False) -> None:
        """ref: parsec_dtd_task_class_add_chore (insert_function.c:2432).

        ``device_type`` is ``"cuda"``.  ``fn`` takes one argument per
        inserted parameter in insertion order — a tensor on the device
        module's torch device for each tile, the raw value of each VALUE
        param (the order of unpack_args) — and returns new tensors for the
        written tiles, in order.  A burst of same-class tasks (equal,
        hashable VALUE params; tasks passing different values never
        group) dispatches as one group.  By default ``fn`` keeps
        single-tile semantics: the group calls it once per task, on that
        task's tiles.  ``stacked=True`` declares that ``fn`` takes a
        leading batch dimension (write ``.mT``, never ``.T``; concatenate
        on ``dim=-2``): the group then calls it ONCE with every tile
        argument stacked.  A stacked chore that fails is not retried per
        task: the error aborts the DAG and re-raises from ``wait()``.
        The chore applies to the class's tasks inserted after this call;
        the class exists from its first insert."""
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
            batch_spec=DeviceBatchSpec(tc.name, extract, call,
                                       stacked=stacked)))

    @property
    def my_rank(self) -> int:
        return self.context.rank if self.context is not None else 0

    @property
    def nb_ranks(self) -> int:
        return self.context.nb_ranks if self.context is not None else 1

    def _task_rank(self, tracked: List[_Param]) -> int:
        """Placement: AFFINITY param's tile rank, else first written tile,
        else first tracked tile (ref: PARSEC_AFFINITY placement)."""
        for p in tracked:
            if p.mode & AFFINITY:
                return p.tile.rank
        for p in tracked:
            if int(p.mode) & 0x2:
                return p.tile.rank
        if tracked:
            return tracked[0].tile.rank
        return 0

    # ------------------------------------------------------------------ #
    # insertion                                                          #
    # ------------------------------------------------------------------ #
    def insert_task(self, body: Callable, *args, name: Optional[str] = None,
                    priority: int = 0, _internal: bool = False) -> Optional[Task]:
        """ref: parsec_dtd_insert_task (insert_function.h:284, impl :3506).

        ``args`` are (value, VALUE) / (tile, INPUT|INOUT|OUTPUT [|AFFINITY...])
        pairs, or bare Python values (implicitly VALUE).  Before the pool
        is added to a context the insert is buffered (returns None) and
        replayed at enqueue time.  On several ranks every rank inserts
        every task; only the placement rank executes it (and gets the
        Task back) — the others update tile tracking state and
        synthesize send tasks for edges leaving their rank (returns
        None; ref: remote deps inferred from rank_of, SURVEY.md §2.2).
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
        t_rank = self._task_rank(tracked)
        if t_rank != self.my_rank:
            self._process_remote_insertion(tracked, t_rank)
            return None
        return self._insert_local(body, parsed, tracked, name, priority)

    def _insert_local(self, body: Callable, parsed: List[_Param],
                      tracked: List[_Param], name: Optional[str],
                      priority: int, hold_deps: int = 0) -> Task:
        tc = self._task_class_of(body, len(tracked), name)
        task = Task(self, tc, locals_=(self._inserted,), priority=priority)
        self._inserted += 1
        rec = _DTDRecord(task)
        rec.deps_remaining += hold_deps  # comm-gated tasks (recv) hold extra
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
            acc = int(p.mode) & 0x3
            with tile.lock:
                # only consumers need the remote data materialized; a pure
                # OUTPUT has no RAW dep (and cross-rank WAR/WAW is vacuous)
                local_pred = self._materialize_reader_pred(tile) \
                    if (acc & 0x1) else (tile.last_writer
                                         if isinstance(tile.last_writer,
                                                       _DTDRecord)
                                         else None)
                if acc == int(AccessMode.INPUT):
                    if local_pred is not None and local_pred is not rec:
                        _chain_after(local_pred)
                    # prune completed readers so read-mostly tiles don't
                    # retain every historical reader record
                    tile.readers = [r for r in tile.readers if not r.completed]
                    tile.readers.append(rec)
                else:  # OUTPUT or INOUT: chain after writer and all readers
                    preds = []
                    if local_pred is not None and local_pred is not rec:
                        preds.append(local_pred)
                    preds.extend(r for r in tile.readers if r is not rec)
                    for pr in preds:
                        _chain_after(pr)
                    tile.writers_seq += 1
                    tile.last_writer = rec
                    tile.recv_proxy = None
                    tile.readers = []
                    tile.sent_to = set()

        # drop the insertion guard; schedule if ready
        if rec.dep_satisfied():
            self._schedule_new(task)
        return task

    def _materialize_reader_pred(self, tile: DTDTile) -> Optional[_DTDRecord]:
        """The record a local consumer must chain after. A RemoteWriter (or
        remotely-homed pristine tile) is materialized by inserting a
        recv-task whose record becomes the tile's local proxy. Caller holds
        tile.lock."""
        lw = tile.last_writer
        if isinstance(lw, _DTDRecord):
            return lw
        if isinstance(lw, RemoteWriter):
            seq = lw.seq
        elif lw is None and tile.rank != self.my_rank:
            seq = tile.writers_seq  # home data, possibly never written
        else:
            return None  # pristine local tile: no predecessor
        if tile.recv_proxy is not None and tile.recv_proxy_seq == seq:
            return tile.recv_proxy
        proxy = self._insert_recv(tile, seq)
        tile.recv_proxy = proxy
        tile.recv_proxy_seq = seq
        return proxy

    def _insert_recv(self, tile: DTDTile, seq: int) -> _DTDRecord:
        """Insert the comm-gated recv-task materializing (tile, seq).
        Caller holds tile.lock — the recv chains after current local readers
        manually to avoid re-entering the tracking logic."""
        box: Dict[str, Any] = {}
        task = self._insert_local(
            _dtd_recv_body,
            [_Param(box, VALUE | REF, None), _Param(tile, VALUE | REF, None)],
            [], name="dtd_recv", priority=0, hold_deps=1)
        rec = task.dtd
        # the recv overwrites the tile: order it after live local readers
        for r in tile.readers:
            if not r.completed:
                with rec.lock:
                    rec.deps_remaining += 1
                if not r.add_successor(rec):
                    rec.dep_satisfied()
        tile.readers = []
        if self.comm is None:
            raise RuntimeError(f"{self.name}: tile {tile.comm_key} lives on "
                               f"rank {tile.rank}, but no comm engine is "
                               f"attached")

        def on_data(arr):
            box["data"] = arr
            if rec.dep_satisfied():
                self._schedule_new(task)
        self.comm.dtd_expect(self, tile.comm_key, seq, on_data)
        return rec

    def _process_remote_insertion(self, tracked: List[_Param],
                                  t_rank: int) -> None:
        """A task placed on another rank: emit sends for data leaving my
        rank, update SPMD tile tracking."""
        for p in tracked:
            tile = p.tile
            acc = int(p.mode) & 0x3
            with tile.lock:
                if acc & 0x1:
                    lw = tile.last_writer
                    i_hold = isinstance(lw, _DTDRecord) or \
                        (lw is None and tile.rank == self.my_rank)
                    if i_hold and (t_rank, tile.writers_seq) not in tile.sent_to:
                        tile.sent_to.add((t_rank, tile.writers_seq))
                        self._insert_send(tile, tile.writers_seq, t_rank)
                if acc & 0x2:  # the remote task writes a new version
                    tile.writers_seq += 1
                    tile.last_writer = RemoteWriter(t_rank, tile.writers_seq)
                    tile.recv_proxy = None
                    # KEEP live local readers (incl. the send just inserted):
                    # a future recv of the new version chains after them, so
                    # the in-place overwrite of the host payload stays
                    # ordered behind every consumer of the old version
                    tile.readers = [r for r in tile.readers if not r.completed]
                    tile.sent_to = set()

    def _insert_send(self, tile: DTDTile, seq: int, dst: int) -> None:
        """Insert the send-task shipping (tile, seq) to ``dst``. Caller
        holds tile.lock; the send chains after the local writer manually."""
        task = self._insert_local(
            _dtd_send_body,
            [_Param((tile, seq, dst), VALUE | REF, None)],
            [], name="dtd_send", priority=0, hold_deps=1)
        rec = task.dtd
        lw = tile.last_writer
        if isinstance(lw, _DTDRecord) and lw is not rec:
            with rec.lock:
                rec.deps_remaining += 1
            if not lw.add_successor(rec):
                rec.dep_satisfied()
        tile.readers.append(rec)
        # chaining complete: drop the hold (may schedule right away)
        if rec.dep_satisfied():
            self._schedule_new(task)

    def _schedule_new(self, task: Task) -> None:
        schedule(self.context.execution_streams[0], [task])

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


def _dtd_recv_body(es, task: Task) -> None:
    """Comm-gated recv: materialize the received version into the tile's
    host copy (the task was scheduled only after the data arrived)."""
    box = task.user[0].value
    tile: DTDTile = task.user[1].value
    arr = box["data"]
    host = tile.data.host_copy()
    if is_device_array(arr):
        # the mesh-local path (comm/mesh.py): the producer's private
        # device copy becomes this version as it is; the next device
        # task stages it in device to device, a host read pulls it
        host.payload = arr
    elif host.payload is None:
        host.payload = np.array(arr)
    else:
        # the host copy may transiently hold a tensor: write into a
        # writable numpy buffer, never through a device payload
        np.copyto(Data.materialize_host(host), arr)
    tile.data.version_bump(0)


def _dtd_send_body(es, task: Task) -> None:
    """Ship the tile's current version to the destination rank (the D2H
    copy, if any, queues on the device module's stream)."""
    tile, seq, dst = task.user[0].value
    tp: DTDTaskpool = task.taskpool
    newest = tile.data.newest_copy()
    if newest is not None and is_device_array(newest.payload) \
            and tp.comm.mesh_local_to(dst):
        # a peer in this process: the device version travels device to
        # device (the comm engine takes the private copy on our stream)
        tp.comm.dtd_send(tp, tile.comm_key, seq, dst, newest.payload)
        return
    host = tile.data.sync_to_host(es.context.devices)
    if host.payload is None:
        raise RuntimeError(f"dtd_send of tile {tile.comm_key} with no local "
                           f"payload")
    tp.comm.dtd_send(tp, tile.comm_key, seq, dst, host.payload)


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
