"""Static lowering: PTG taskpool → flat dependence arrays.

The reference's PTG offers two dependency-tracking modes
(``--dep-management``, ref: parsec/interfaces/ptg/ptg-compiler/main.c:37):
the default *dynamic* hash table keyed by task locals, and a *static*
("index-array") mode where per-class dense counter arrays are sized from
the iteration space at taskpool instantiation and dependence completion
is an O(1) counter decrement (ref: parsec/parsec_internal.h:173-196
bitmask encoding). This module is the static mode's form here: the
whole (single-rank) task space is enumerated ONCE into flat arrays —
task ids, a CSR successor list with producer/consumer flow indices,
dense indegree counters, priorities — that the native engine
(``NativeDAG``, native/_native.cpp) walks in C.

Two consumers:
- the classic per-task runtime: ``release_deps`` becomes one C call that
  decrements successor counters, routes the produced DataCopy bindings,
  and returns the freshly-ready ids (dsl/ptg/runtime.py wires it in when
  ``dep_management=static``);
- the wave runner (dsl/ptg/wave.py): pops whole ready antichains and
  executes each class's members as one batched body call.

Enumeration costs O(tasks) time and memory — the same trade the
reference's static mode makes; results are cached per (JDF, bound
globals, distribution) so repeated instantiations (benchmark reps,
iterative solvers) pay it once.

The engine is always the native one: ``make_engine`` returns a
``NativeDAG`` (the native core raises at import when it does not
build); the Python mirror ``PyDAG`` is built only where a caller names
it, as the parity tests do.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...utils import logging as plog

__all__ = ["LoweredDAG", "lower", "make_engine", "PyDAG"]


class LoweredDAG:
    """Flat static dependence structure of one single-rank PTG taskpool.

    Arrays (task ids are dense ints in enumeration order):
      class_of[t]  — task-class index (position in tp.task_classes)
      locals_of[t] — the instance's locals tuple
      priority[t]  — evaluated priority expression
      indptr/succ  — CSR successor ids per task
      succ_flow[e] — consumer-side flow index of edge e
      out_flow[e]  — producer-side flow index of edge e
      indegree[t]  — number of producer activations task t waits for
                     (counted from the producer side, so the counter
                     reaches zero exactly when every activation fired)
    """

    __slots__ = ("n_tasks", "class_names", "class_of", "locals_of", "id_of",
                 "indptr", "succ", "succ_flow", "out_flow", "indegree",
                 "priority", "max_flows", "kernel_cache")

    def __init__(self, n_tasks: int, class_names: List[str],
                 class_of: np.ndarray, locals_of: List[Tuple],
                 id_of: Dict[Tuple[str, Tuple], int], indptr: np.ndarray,
                 succ: np.ndarray, succ_flow: np.ndarray,
                 out_flow: np.ndarray, indegree: np.ndarray,
                 priority: np.ndarray, max_flows: int) -> None:
        self.n_tasks = n_tasks
        self.class_names = class_names
        self.class_of = class_of
        self.locals_of = locals_of
        self.id_of = id_of
        self.indptr = indptr
        self.succ = succ
        self.succ_flow = succ_flow
        self.out_flow = out_flow
        self.indegree = indegree
        self.priority = priority
        self.max_flows = max_flows
        # chunk/fused closures and turbo entries shared by every runner
        # built over this DAG: the DAG itself is cached per (JDF, bound
        # globals), and the closures are a pure function of that same
        # signature, so repeated taskpool instantiations (benchmark
        # reps, iterative solvers) reuse them instead of rebuilding
        self.kernel_cache: Dict[Tuple, Any] = {}

    @property
    def n_edges(self) -> int:
        return int(self.succ.shape[0])

    def startup_ids(self) -> np.ndarray:
        return np.nonzero(self.indegree == 0)[0].astype(np.int32)


def _signature(tp) -> Optional[Tuple]:
    """Cache key for a taskpool's lowering: JDF identity + every bound
    global reduced to a structural signature. Returns None (uncacheable)
    when a global's identity can't be summarized structurally."""
    from ...collections.collection import DataCollection
    # rank is deliberately NOT part of the key: lowering enumerates the
    # full rank-independent DAG, so SPMD ranks sharing a process share
    # the cache entry
    parts: List[Any] = [tp.nb_ranks]
    for g in tp.jdf.globals:
        v = tp.global_env.get(g.name)
        if isinstance(v, (int, float, str, bool, np.integer, np.floating)):
            parts.append((g.name, v))
        elif isinstance(v, DataCollection):
            # tile shape/extent/dtype must be part of the key: guard and
            # priority expressions may read collection attributes beyond
            # the coordinate set, so two structurally different
            # collections with the same tile coords must not alias
            shape_sig = tuple(
                getattr(v, a, None) for a in ("mb", "nb", "lm", "ln"))
            dt = getattr(v, "dtype", None)
            parts.append((g.name, type(v).__name__, shape_sig,
                          None if dt is None else np.dtype(dt).str,
                          tuple(sorted(v.tiles())) if hasattr(v, "tiles")
                          else id(v)))
        elif v is None:
            parts.append((g.name, None))
        else:
            return None
    return tuple(parts)


# cache scoped per live JDFFile: keyed (id(jdf), signature) with a
# weakref finalizer purging a dead JDF's entries — a reused id can never
# alias a stale DAG, and dropped JDFs free their O(tasks) arrays
_cache: Dict[Tuple, LoweredDAG] = {}
# RLock: the purge finalizer can fire from gc INSIDE a locked section of
# the same thread (e.g. while inserting into the cache)
_cache_lock = threading.RLock()
_cache_tracked: Dict[int, Any] = {}


def _purge_jdf(jid: int) -> None:
    with _cache_lock:
        _cache_tracked.pop(jid, None)
        for k in [k for k in _cache if k[0] == jid]:
            del _cache[k]


def lower(tp, use_cache: bool = True,
          allow_multirank: bool = False) -> LoweredDAG:
    """Enumerate ``tp``'s task space and dependence edges into a
    LoweredDAG.

    The enumeration is rank-independent (the FULL task space and edge
    set — SPMD ranks lowering the same JDF get identical DAGs), but the
    static engines keep no foreign-edge bookkeeping, so only single-rank
    pools lower for them (a multi-rank pool runs the hash mode).  The
    distributed wave (wave_dist.py) partitions the full DAG by rank
    itself and passes ``allow_multirank=True``."""
    import weakref

    if tp.nb_ranks != 1 and not allow_multirank:
        raise ValueError("static lowering is single-rank; use dynamic "
                         "dep management for multi-rank taskpools")
    key = None
    if use_cache:
        sig = _signature(tp)
        if sig is not None:
            jid = id(tp.jdf)
            try:
                with _cache_lock:
                    if jid not in _cache_tracked:
                        _cache_tracked[jid] = weakref.finalize(
                            tp.jdf, _purge_jdf, jid)
                key = (jid, sig)
            except TypeError:
                key = None  # JDF type without weakref support: no cache
    if key is not None:
        with _cache_lock:
            hit = _cache.get(key)
        if hit is not None:
            return hit

    classes = list(tp.task_classes)
    class_names = [tc.ast.name for tc in classes]
    class_index = {n: i for i, n in enumerate(class_names)}
    max_flows = max((len(tc.ast.flows) for tc in classes), default=0)

    locals_of: List[Tuple] = []
    class_of_l: List[int] = []
    prio_l: List[int] = []
    id_of: Dict[Tuple[str, Tuple], int] = {}
    for ci, tc in enumerate(classes):
        for locals_ in tc.iter_space():
            tid = len(locals_of)
            id_of[(class_names[ci], locals_)] = tid
            locals_of.append(locals_)
            class_of_l.append(ci)
            if tc.ast.priority is not None:
                prio_l.append(int(tc.ast.priority(tc.env_of(locals_))))
            else:
                prio_l.append(0)
    n = len(locals_of)

    # producer-side edge enumeration (the iterate_successors walk, done
    # once symbolically with no data copies)
    edges_per: List[List[Tuple[int, int, int]]] = [[] for _ in range(n)]
    nb_edges = 0
    for tid in range(n):
        tc = classes[class_of_l[tid]]
        acc = edges_per[tid]

        def cb(succ_name: str, succ_locals: Tuple, flow_name: str,
               _copy, out_idx: int) -> None:
            nonlocal nb_edges
            skey = (succ_name, succ_locals)
            sid = id_of.get(skey)
            if sid is None:
                raise ValueError(
                    f"{class_names[class_of_l[tid]]}{locals_of[tid]} edge "
                    f"targets {succ_name}{succ_locals}, outside the "
                    f"iteration space")
            s_ast = classes[class_index[succ_name]].ast
            sflow = next(i for i, f in enumerate(s_ast.flows)
                         if f.name == flow_name)
            acc.append((sid, sflow, out_idx))
            nb_edges += 1

        _iterate_successors_symbolic(tc, locals_of[tid], cb)

    indptr = np.zeros(n + 1, np.int32)
    succ = np.empty(nb_edges, np.int32)
    succ_flow = np.empty(nb_edges, np.int8)
    out_flow = np.empty(nb_edges, np.int8)
    indegree = np.zeros(n, np.int32)
    e = 0
    for tid in range(n):
        for (sid, sflow, oflow) in edges_per[tid]:
            succ[e] = sid
            succ_flow[e] = sflow
            out_flow[e] = oflow
            indegree[sid] += 1
            e += 1
        indptr[tid + 1] = e

    dag = LoweredDAG(n, class_names, np.asarray(class_of_l, np.int32),
                     locals_of, id_of, indptr, succ, succ_flow, out_flow,
                     indegree, np.asarray(prio_l, np.int32), max_flows)
    plog.debug.verbose(3, "lowered %s: %d tasks, %d edges, %d startup",
                       tp.name, n, nb_edges, len(dag.startup_ids()))
    if key is not None:
        with _cache_lock:
            _cache[key] = dag
    return dag


def _iterate_successors_symbolic(tc, locals_: Tuple, cb) -> None:
    """Producer-side successor walk with no task instance: generated
    specialization when available, interpreted AST fallback (mirrors
    PTGTaskClass._iterate_successors minus data copies)."""
    by_name = tc.tp.jdf.task_class_by_name
    if tc._gen_succ is not None:
        copies = [None] * len(tc.ast.flows)
        # generated cbs pass dep-target args in the consumer's PARAM
        # order; lowered ids are keyed by ranged-locals order — translate
        tc._gen_succ(locals_, copies,
                     lambda name, loc, fl, cp, idx, tys=None: cb(
                         name, by_name(name).locals_from_param_args(loc),
                         fl, cp, idx))
        return
    from .runtime import _expand_args
    env = tc.env_of(locals_)
    for i, f in enumerate(tc.ast.flows):
        for d in f.deps_out():
            t = d.resolve(env)
            if t is None or t.kind in ("null", "new", "memory"):
                continue
            for succ_locals in _expand_args(t.args, env):
                past = by_name(t.task_class)
                cb(t.task_class, past.locals_from_param_args(succ_locals),
                   t.flow, None, i)


class PyDAG:
    """Pure-Python mirror of the native ``NativeDAG``: the plain version
    the parity tests drive beside it, never chosen by the runtime. Same
    API: start/complete/take_bindings/complete_batch."""

    def __init__(self, dag: LoweredDAG) -> None:
        self._indptr = dag.indptr
        self._succ = dag.succ
        self._succ_flow = dag.succ_flow
        self._out_flow = dag.out_flow
        self._indeg = dag.indegree.copy()
        self._max_flows = dag.max_flows
        self._bindings: Dict[int, List[Any]] = {}
        self._lock = threading.Lock()
        self._started = False
        self._completed = 0

    def start(self) -> List[int]:
        assert not self._started, "start() called twice"
        self._started = True
        return [int(t) for t in np.nonzero(self._indeg == 0)[0]]

    def complete(self, tid: int, copies=None) -> List[int]:
        ready: List[int] = []
        lo, hi = int(self._indptr[tid]), int(self._indptr[tid + 1])
        with self._lock:
            for e in range(lo, hi):
                sid = int(self._succ[e])
                if copies is not None:
                    cp = copies[int(self._out_flow[e])]
                    if cp is not None:
                        b = self._bindings.get(sid)
                        if b is None:
                            b = self._bindings[sid] = [None] * self._max_flows
                        b[int(self._succ_flow[e])] = cp
                self._indeg[sid] -= 1
                if self._indeg[sid] == 0:
                    ready.append(sid)
                elif self._indeg[sid] < 0:
                    raise RuntimeError(
                        f"task {sid} released more times than its "
                        f"indegree")
            self._completed += 1
        return ready

    def complete_batch(self, tids) -> List[int]:
        ready: List[int] = []
        for t in tids:
            ready.extend(self.complete(int(t), None))
        return ready

    def take_bindings(self, tid: int) -> Tuple:
        with self._lock:
            b = self._bindings.pop(int(tid), None)
        return tuple(b) if b is not None else (None,) * self._max_flows

    def indegree_of(self, tid: int) -> int:
        return int(self._indeg[tid])

    def completed(self) -> int:
        return self._completed


def make_engine(dag: LoweredDAG):
    """The native C++ ready-tracking engine over ``dag``."""
    from ...native import native as _native
    return _native.NativeDAG(
        np.ascontiguousarray(dag.indptr),
        np.ascontiguousarray(dag.succ),
        np.ascontiguousarray(dag.succ_flow),
        np.ascontiguousarray(dag.out_flow),
        np.ascontiguousarray(dag.indegree),
        int(dag.max_flows))
