"""Turbo per-task dispatch: the static runtime's native fast path.

The reference's hot loop is µs-class generated C — select a ready task,
bind its copies, invoke the body hook, release successors
(parsec/scheduling.c:586-625 + the jdf2c-generated release_deps).  The
classic Python per-task path costs about 0.7 ms a task on the card
(PERF.md) in interpreter glue spread across dozens of small calls
(scheduler queues, Task objects, per-flow copy resolution, device-module
bookkeeping).  Turbo removes it structurally:

- data binding is PRECOMPILED: WaveRunner's slot assignment resolves
  every (task, flow) to a (pool, row) pair at build time; before the
  loop each task's entry is bound to views of its pool rows, so per-task
  binding is a list lookup, not a guard-evaluating walk;
- select -> release runs in C: ``NativeDAG.run_loop`` owns a priority
  max-heap over the lowered CSR counters and calls back into Python
  exactly ONCE per task — the body, called once on its rows' views
  (each a ``[1, mb, nb]`` stack, as the bodies take a batch dimension),
  with its outputs ``copy_``'d into its slot rows;
- completion accounting is batched after the loop.

Semantics are the per-task runtime's, not wave's: tasks execute ONE AT
A TIME in any dependence-respecting priority order, and a task's
writes land in its slot in place — exactly the runtime's shared-copy
mutation model (a flow's body mutates the copy bound to it).  There is
no antichain batching and no gather-before-scatter wave semantics.
Every GEMM and SYRK update is one GEMM-kernel launch over a batch of one.

Writebacks are LAZY and device-resident: after the run, each written
tile's newest copy is a lazy row of the device pool, materialized on
first read — a single-tile host read pulls exactly one tile back.
"""
from __future__ import annotations

import heapq
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...data.data import Coherency, DataCopy
from ...utils import logging as plog
from .wave import (WaveError, WaveRunner, _check_out, _make_call_f,
                   _merge_masked_f)

__all__ = ["TurboRunner", "LazyPoolCopy"]


class _PoolHolder:
    """The one strong owner of the result pools. Lazy copies reference
    THIS, never the runner: whatever outlives the run (the collection
    and its copies) keeps only the pools alive, not the runner's
    entries/plans/taskpool graph."""

    __slots__ = ("pools", "ready")

    def __init__(self) -> None:
        self.pools: Tuple = ()
        # the CUDA event after the run that wrote the pools, when a read
        # may queue on another stream (the distributed wave's rank
        # threads); None: reads are ordered already
        self.ready = None


class LazyPoolCopy(DataCopy):
    """A device copy whose payload is a row of a stacked tile pool,
    taken on first access: registering N tiles costs nothing on the
    device, and a host read of one tile moves one tile."""

    __slots__ = ("_holder", "_pid", "_row", "_mat", "_val", "_armed")

    def __init__(self, data, device_id: int, holder, pid: int, row: int,
                 dtt=None) -> None:
        self._holder = holder
        self._pid = pid
        self._row = row
        self._mat = False
        self._val = None
        self._armed = False
        super().__init__(data, device_id, payload=None, dtt=dtt)
        self._armed = True

    @property
    def payload(self):
        if not self._mat:
            self._val = self._holder.pools[self._pid][self._row]
            if self._holder.ready is not None:
                self._val._ptt_ready = self._holder.ready
            self._mat = True
        return self._val

    @payload.setter
    def payload(self, v) -> None:
        if not self._armed:
            return      # DataCopy.__init__'s placeholder assignment
        self._mat = True
        self._val = v


def _task_fn_f(genv, kplans, spec):
    """One task's body over its slot views: ``fn(ins, outs, wbxs)``
    calls the class body once on the input views, then copies each
    written output (region-merged where a masked memory writeback
    applies) into its out view, and the dual-output merge into its wbx
    view. Module-level, so the closure cached on the DAG captures kplans
    and a pruned env only — never a runner or its pools."""
    ci, _k, statics, _incols, _outcols, wbflags, _wbxcols, _cnv = spec
    p = kplans[ci]
    call = _make_call_f(genv, p, statics)
    masked = [bool(wbflags and wbflags[j] and p.written[j]
                   and p.wb_name[j] is not None) for j in range(p.nf)]

    def fn(ins, outs, wbxs):
        vals = call(*ins)
        writes = []
        oi = 0
        for j, w in enumerate(p.written):
            if not w:
                continue
            dst = outs[j]
            full = _check_out(p, j, vals[oi], dst, 1)
            writes.append((dst, _merge_masked_f(genv, p, j, full, dst)
                           if masked[j] else full))
            if wbxs[j] is not None:
                writes.append((wbxs[j], _merge_masked_f(
                    genv, p, j, full, wbxs[j])))
            oi += 1
        if len(writes) > 1:
            # an output may be a view of a slot another write of this
            # task lands in first (a body handing back its input): copy
            # such outputs out of the pools before any write
            ptrs = {d.untyped_storage().data_ptr() for d, _ in writes}
            writes = [(d, v.clone() if v.untyped_storage().data_ptr()
                       in ptrs else v) for d, v in writes]
        for dst, val in writes:
            dst.copy_(val)
    return fn


class TurboRunner(WaveRunner):
    """Per-task executor over precompiled slot tables.

    Eligibility is WaveRunner's (slot assignment must resolve every
    flow) plus an acyclic WAR ordering; ineligible taskpools raise
    WaveError at construction and the caller takes the classic path.
    """

    def __init__(self, tp) -> None:
        super().__init__(tp, max_chunk=1)
        self._entries: Optional[List] = None
        self._holder = _PoolHolder()
        self._aug = self._augment_war_edges()

    @property
    def pools(self) -> Tuple:
        return self._holder.pools

    # ------------------------------------------------------------------ #
    def _augment_war_edges(self):
        """Anti-dependence (WAR) ordering, statically.

        Per-task in-place scatters mean a slot's next writer must wait
        for every reader of the CURRENT value — wave mode layers these
        inside each antichain (_split_war); turbo has no antichains, so
        the ordering becomes real edges: for each (slot, reader) pair,
        an edge reader -> next writer of that slot (by dependence
        level). Two same-level writers of one slot race and are
        rejected statically, like wave's two-writer check. Returns
        (indptr, succ, indegree) — the augmented CSR the run loop
        walks; cached on the DAG."""
        dag = self.dag
        cached = dag.kernel_cache.get("turbo_war")
        if cached is not None:
            return cached
        # dependence levels (longest path), Kahn order
        indeg = dag.indegree.copy()
        level = np.zeros(dag.n_tasks, np.int32)
        frontier = [int(t) for t in np.nonzero(indeg == 0)[0]]
        while frontier:
            nxt = []
            for t in frontier:
                for e in range(int(dag.indptr[t]), int(dag.indptr[t + 1])):
                    s = int(dag.succ[e])
                    level[s] = max(level[s], level[t] + 1)
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        nxt.append(s)
            frontier = nxt
        writers: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        readers: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for t in range(dag.n_tasks):
            p = self.plans[int(dag.class_of[t])]
            lv = int(level[t])
            for k in range(len(p.flow_idx)):
                if p.written[k]:
                    for key in self._write_keys(t, p, k):
                        writers.setdefault(key, []).append((lv, t))
                if p.reads[k] or not p.written[k]:
                    key = (int(self._slot_coll[t, k]),
                           int(self._slot[t, k]))
                    readers.setdefault(key, []).append((lv, t))
        extra: List[Tuple[int, int]] = []
        for key, wl in writers.items():
            ws = sorted(set(wl))
            for a, b in zip(ws, ws[1:]):
                if a[0] == b[0] and a[1] != b[1]:
                    raise WaveError(
                        f"two unordered writers of one tile (tasks "
                        f"{a[1]} and {b[1]}): the DAG races — in-place "
                        f"per-task scatters would keep an arbitrary one")
                # write-after-write: successive writers execute in level
                # order even when no dataflow path orders them (wave
                # order; a redundant edge over an existing path is
                # harmless — it is walked like any other)
                extra.append((a[1], b[1]))
            for (lr, r) in readers.get(key, ()):
                for (lw, w) in ws:
                    if lw >= lr and w != r:
                        extra.append((r, w))   # reader before next writer
                        break
        if not extra:
            out = (dag.indptr, dag.succ, dag.indegree)
            dag.kernel_cache["turbo_war"] = out
            return out
        extra_by_src: Dict[int, List[int]] = {}
        indeg2 = dag.indegree.copy()
        for (r, w) in set(extra):
            extra_by_src.setdefault(r, []).append(w)
            indeg2[w] += 1
        indptr2 = np.zeros(dag.n_tasks + 1, np.int32)
        succ2: List[int] = []
        for t in range(dag.n_tasks):
            succ2.extend(int(dag.succ[e]) for e in
                         range(int(dag.indptr[t]), int(dag.indptr[t + 1])))
            succ2.extend(sorted(extra_by_src.get(t, ())))
            indptr2[t + 1] = len(succ2)
        succ2a = np.asarray(succ2, np.int32)
        # cyclic WAR (two tasks each reading the slot the other writes)
        # turns into a CYCLE here — per-task in-place scatters cannot
        # serve it; fail at build so the caller falls back to an engine
        # that can (fused wave gathers-before-scatter; the classic
        # runtime's copies)
        ind = np.array(indeg2, copy=True)
        frontier = [int(t) for t in np.nonzero(ind == 0)[0]]
        seen = 0
        while frontier:
            seen += len(frontier)
            nxt = []
            for t in frontier:
                for e in range(int(indptr2[t]), int(indptr2[t + 1])):
                    s = int(succ2a[e])
                    ind[s] -= 1
                    if ind[s] == 0:
                        nxt.append(s)
            frontier = nxt
        if seen != dag.n_tasks:
            raise WaveError(
                "cyclic write-after-read conflicts: per-task in-place "
                "scatters cannot serve this DAG — the classic runtime "
                "(copies) or fused wave (gather-before-scatter) can")
        out = (indptr2, succ2a, indeg2)
        dag.kernel_cache["turbo_war"] = out
        plog.debug.verbose(3, "turbo %s: %d WAR ordering edges added",
                           self.tp.name, len(set(extra)))
        return out

    # ------------------------------------------------------------------ #
    def _build_entries(self, pools) -> None:
        """Per-task entries ``(fn, rows)``: ``fn`` the task's pre-bound
        body closure (one per distinct spec: class, static locals, pool
        signature), ``rows`` its (pool, row) pairs per flow — input,
        output and dual-output writeback. Cached on the DAG: repeated
        taskpool instantiations with the same signature reuse them (the
        reference's analog is the jdf2c-generated direct hook call,
        scheduling.c:586-625)."""
        dag = self.dag
        cached = dag.kernel_cache.get("turbo_entries")
        if cached is not None:
            self._entries = cached
            return
        entries = []
        fns: Dict[Tuple, Any] = {}
        for t in range(dag.n_tasks):
            ids = np.asarray([t], np.int64)
            ent, _ = self._frontier_entries(ids, dag.class_of[ids], pools)
            spec, a = ent[0]
            _ci, _k, _st, incols, outcols, _wbf, wbxcols, _cnv = spec
            nf = len(incols)
            rows = (tuple((incols[j], int(a["idx_in"][j, 0]))
                          for j in range(nf)),
                    tuple((outcols[j], int(a["idx_out"][j, 0]))
                          if outcols[j] >= 0 else None for j in range(nf)),
                    tuple((wbxcols[j], int(a["idx_wbx"][j, 0]))
                          if wbxcols and wbxcols[j] >= 0 else None
                          for j in range(nf)))
            fn = fns.get(spec)
            if fn is None:
                fn = fns[spec] = _task_fn_f(self._trace_env, self._kplans,
                                            spec)
            entries.append((fn, rows))
        if self._kernels_shareable:
            dag.kernel_cache["turbo_entries"] = entries
        self._entries = entries

    @staticmethod
    def _bind(entries, pools) -> List:
        """Each entry bound to views of its pool rows (``[1, mb, nb]``):
        the loop then indexes nothing."""
        def view(r):
            return None if r is None else pools[r[0]][r[1]:r[1] + 1]
        return [(fn, [view(r) for r in ins], [view(r) for r in outs],
                 [view(r) for r in wbxs])
                for fn, (ins, outs, wbxs) in entries]

    def execute_per_task(self, pools) -> Tuple:
        """Run every task as ONE body call in C-driven priority order;
        ``stats["dispatch_secs"]`` is the host time of the loop."""
        if self._entries is None:
            self._build_entries(pools)
        holder = self._holder
        holder.pools = tuple(pools)
        bound = self._bind(self._entries, holder.pools)

        def tramp(tid: int) -> None:
            fn, ins, outs, wbxs = bound[tid]
            try:
                fn(ins, outs, wbxs)
            except WaveError:
                raise
            except Exception as exc:
                name = self.plans[int(self.dag.class_of[tid])].ast.name
                werr = self._trace_error(exc, name)
                if werr is not None:
                    raise werr from exc
                raise

        dag = self.dag
        indptr, succ, indeg = self._aug    # WAR/WAW-augmented CSR
        engine = self._make_aug_engine(indptr, succ, indeg)
        prio = np.ascontiguousarray(dag.priority, np.int32)
        t0 = time.perf_counter()
        done = int(engine.run_loop(tramp, prio))
        secs = time.perf_counter() - t0
        if done != dag.n_tasks:
            raise WaveError(
                f"turbo execution stalled: {done}/{dag.n_tasks} tasks ran")
        self.stats = {
            "tasks": dag.n_tasks,
            "kernel_calls": dag.n_tasks,
            "dispatch_secs": round(secs, 6),
            "compiled_kernels": len({id(fn) for fn, _ in self._entries}),
            "native_loop": True,
        }
        plog.debug.verbose(3, "turbo %s: %s", self.tp.name, self.stats)
        return self.pools

    @staticmethod
    def _make_aug_engine(indptr, succ, indeg):
        """A fresh NativeDAG over the augmented CSR. Flow arrays are
        zeros: the run loop routes no bindings (pools carry the data)."""
        from ...native import native as _native
        return _native.NativeDAG(
            np.ascontiguousarray(indptr, np.int32),
            np.ascontiguousarray(succ, np.int32),
            np.zeros(len(succ), np.int8),
            np.zeros(len(succ), np.int8),
            np.ascontiguousarray(indeg, np.int32), 0)

    def _py_run_loop(self, tramp, prio, indptr, succ, indeg0) -> int:
        """Python mirror of NativeDAG.run_loop: the plain version a
        parity test drives beside it; the runner never calls it."""
        indeg = np.array(indeg0, copy=True)
        heap = [(-int(prio[t]), int(t))
                for t in np.nonzero(indeg == 0)[0]]
        heapq.heapify(heap)
        done = 0
        while heap:
            _, t = heapq.heappop(heap)
            tramp(t)
            for e in range(int(indptr[t]), int(indptr[t + 1])):
                s = int(succ[e])
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(heap, (-int(prio[s]), s))
            done += 1
        return done

    # ------------------------------------------------------------------ #
    def attach_lazy_results(self, device_index: int) -> None:
        """Register the result of every tile some task wrote as its
        newest DEVICE copy — a LazyPoolCopy taking its pool row on first access. Host
        copies stay attached (stale); the coherency protocol pulls a
        tile to the host only when someone reads it."""
        holder = self._holder
        for pid, rows in self._written_rows.items():
            if pid >= self._n_real_colls:
                continue  # scratch: no home tile
            coll = self.collections[self.pool_names[pid]]
            for row in rows:
                row = int(row)
                data = coll.data_of(*self._pool_coords[pid][row])
                old = data.get_copy(device_index)
                if old is not None:
                    data._detach_copy(old)
                h0 = data.get_copy(0)
                lazy = LazyPoolCopy(data, device_index, holder, pid, row,
                                    dtt=None if h0 is None else h0.dtt)
                data.attach_copy(lazy)
                lazy.coherency = Coherency.OWNED
                data.version_bump(device_index)

    def run(self, device=None, device_index: Optional[int] = None) -> None:
        """Stage in, execute, then write back to the host copies (or,
        with ``device_index``, attach lazy device copies); ``device``
        None is cuda:0 (raising without a card), "cpu" the host."""
        pools = self.execute_per_task(self.build_pools(device))
        if device_index is None:
            self.scatter_pools(pools)       # eager host writeback
        else:
            self.attach_lazy_results(device_index)
