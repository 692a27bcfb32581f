"""Batched device dispatch: stack same-class ready tasks into ONE launch.

The reference GPU module amortizes submission by pipelining stage-in /
exec / stage-out across streams (device_cuda_module.c, SURVEY §3.4); the
lever here is amortizing the *launch* itself — one kernel launch for a
whole antichain of same-class tasks instead of one per task.

A task class opts in by attaching a :class:`DeviceBatchSpec` to its
device chore (``Chore.batch_spec``).  The spec separates the *per-task*
part (``extract``: which staged tensors are batchable and what static
context the body needs) from the body itself (``call``: a function of
those tensors).  The device module groups ready tasks whose (spec, static
context, shapes, dtypes) agree and dispatches each group through
:func:`stacked_call`.

A dispatch keeps each body's single-tile semantics unless the body says
otherwise.  A spec marked ``stacked`` (a JDF ``BODY [... batch=stacked]``,
a DTD ``add_chore(..., stacked=True)``) declares that its body takes a
leading batch dimension: each batch argument is stacked into one
``[n, ...]`` tensor and the body runs ONCE over it.  The tile operations
of ops/linalg.py take that dimension natively: the GEMM and SYRK updates
launch one kernel over ``gridDim.z = n``, each z-slice doing exactly the
per-task arithmetic in the same order, and POTRF/TRSM loop over the
slices.  Results are therefore bit-exact vs per-task dispatch
(``device_batch_mode=unroll``, the only mode of this package).  The stack
is one extra device copy of every input tile; a pointer-array grouped
launch would avoid it.  Every other body runs once per member of the
group, inside the same dispatch and on the same stream, exactly as
per-task dispatch would run it (the JAX package's ``unroll`` mode emits
one subgraph per member likewise).

Batch sizes are bucketed to powers of two, as in the JAX package, so a
burst dispatches as a few large launches.

On a chip mesh (devices/cuda.py ``CudaMeshDevice``) a group whose size
the chip count divides runs through :func:`cached_sharded_callable`: k
slot-blocks of n/k tasks, each one :func:`stacked_call` on its chip's
stream.  Each block does the same per-task arithmetic as the single-chip
stacked path, so the results are bit-identical to it.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["DeviceBatchSpec", "ShardedCallable", "STAGE_FAILED",
           "bucket_size", "cached_sharded_callable", "cached_stage_callable",
           "clear_stage_cache", "live_stage_entries",
           "release_stage_entries", "segment_plan", "stacked_call"]


class DeviceBatchSpec:
    """Recipe for stacking same-class tasks into one launch.

    ``extract(task, arrays) -> None | (bargs, flow_idx, static)``
        Per-task.  ``arrays`` is the device module's staged per-flow
        tensor list.  Returns the batchable tensor args, the flow index
        behind each, and a hashable static key covering EVERYTHING the
        body reads that is not a batched tensor (referenced locals,
        absent-flow mask, ...).  ``None`` means this task cannot batch
        (it goes through per-task ``dyld_fn`` dispatch).

    ``call(bargs, static) -> tuple`` — the body: the written flows'
        outputs, in flow order.  With ``stacked`` it takes tensors with a
        leading batch dimension and returns outputs with the same leading
        dimension; without, it takes one task's tensors.

    ``stacked`` — the body declared that it takes a leading batch
        dimension; otherwise :func:`stacked_call` runs it per member.
    """

    __slots__ = ("name", "extract", "call", "stacked")

    def __init__(self, name: str,
                 extract: Callable[[Any, Any], Optional[Tuple]],
                 call: Callable[[Tuple, Any], Tuple],
                 stacked: bool = False) -> None:
        self.name = name
        self.extract = extract
        self.call = call
        self.stacked = bool(stacked)


def bucket_size(navail: int, batch_max: int) -> int:
    """Largest power-of-two <= min(navail, batch_max)."""
    n = min(navail, max(2, batch_max))
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def segment_plan(n: int, requested: int) -> int:
    """Segments a flush group of ``n`` tasks splits into (segmented
    flush): the largest power of two <= min(requested, n // 2), so every
    segment keeps >= 2 tasks and the per-segment sizes are themselves
    powers of two.  1 = whole-batch flush.  Each segment is its own
    launch, and its outputs retire (releasing their successors) without
    waiting for the later segments; the arithmetic per task is the same
    either way."""
    if requested <= 1 or n < 4:
        return 1
    s, limit = 1, min(requested, n // 2)
    while s * 2 <= limit:
        s *= 2
    return s


def stacked_call(spec: DeviceBatchSpec, static: Any,
                 rows: Sequence[Sequence[Any]]) -> List[List[Any]]:
    """Run ``spec``'s body over ``len(rows)`` tasks: ``rows[i][j]`` is
    batch argument ``j`` of task ``i``; returns, per task, its list of
    outputs.  A ``stacked`` spec runs once over the stacked arguments
    (the outputs are views into the stacked results); any other runs once
    per task, in order."""
    if not spec.stacked:
        return [list(spec.call(tuple(r), static)) for r in rows]
    import torch
    n = len(rows)
    cols = tuple(torch.stack([r[j] for r in rows])
                 for j in range(len(rows[0])))
    outs = spec.call(cols, static)
    for o in outs:
        if o.shape[0] != n:
            raise ValueError(f"{spec.name}: batched body returned a "
                             f"leading dimension {o.shape[0]} for {n} "
                             f"tasks")
    return [[o[i] for o in outs] for i in range(n)]


class ShardedCallable:
    """One flush group of ``n`` same-signature tasks spread over the
    chips of ``mesh``: chip ``c`` (the mesh's flat order) runs slot-block
    ``c``, rows ``[c*n/k, (c+1)*n/k)``, as one :func:`stacked_call` on its
    own stream, and records one event there."""

    __slots__ = ("spec", "static", "chips", "per")

    def __init__(self, spec: DeviceBatchSpec, static: Any, n: int,
                 mesh: Any) -> None:
        self.chips = list(mesh.devices.flat)
        k = len(self.chips)
        if n < k or n % k:
            raise ValueError(f"a group of {n} does not split into {k} "
                             f"slot-blocks")
        self.spec = spec
        self.static = static
        self.per = n // k

    def __call__(self, blocks: Sequence[Sequence[Sequence[Any]]],
                 launching: Callable, record: Callable
                 ) -> Tuple[List[List[List[Any]]], List[Any]]:
        """``blocks[c][r][j]``: batch argument ``j`` of row ``r`` of chip
        ``c``'s block, already on that chip.  ``launching(chip)`` is the
        context of a dispatch on ``chip`` (its stream entered) and
        ``record(chip)`` records the event that completes the block.
        Returns each chip's per-task outputs and its event."""
        outs, events = [], []
        for chip, rows in zip(self.chips, blocks):
            if len(rows) != self.per:
                raise ValueError(f"slot-block of {len(rows)} rows for "
                                 f"{self.per}")
            with launching(chip):
                outs.append(stacked_call(self.spec, self.static, rows))
                events.append(record(chip))
        return outs, events


#: mesh -> {(spec, n, nargs, static, shapes): ShardedCallable}.  Keyed by
#: the mesh OBJECT (meshes hash by identity): another rank's mesh in the
#: same process gets its own entries, and a finalized device's mesh
#: drops its entries with it.
_sharded_cache: "weakref.WeakKeyDictionary[Any, Dict]" = \
    weakref.WeakKeyDictionary()


def cached_sharded_callable(spec: DeviceBatchSpec, n: int, nargs: int,
                            static: Any, shapes: Tuple,
                            mesh: Any) -> ShardedCallable:
    """The sharded callable of this group signature on ``mesh``."""
    cache = _sharded_cache.setdefault(mesh, {})
    key = (spec, n, nargs, static, shapes)
    fn = cache.get(key)
    if fn is None:
        fn = ShardedCallable(spec, static, n, mesh)
        cache[key] = fn
    return fn


#: the stage compiler's failure sentinel: a stage signature whose record
#: already failed — the next taskpool over the same spec downgrades that
#: stage at once instead of recording the known failure again
STAGE_FAILED = object()


class _SpecStageCache:
    """The stage cache of ONE parsed spec: token -> key -> entry (a
    stage's recorded program, its plan, or :data:`STAGE_FAILED`).  It
    lives ON the spec object (``jdf._ptt_stage_cache``), so it goes
    when the spec goes: the plan it caches references the spec back, a
    cycle the collector frees once nothing else holds the spec.  An
    entry fetched with an ``owner`` (a recorded program: a CUDA graph,
    its static buffers and its private memory pool; a plan, which keeps
    its first pool's classes and collections) also goes when the last
    context that fetched it finishes (``release_stage_entries``): the
    specs of the ops live as long as the process, and the memory their
    entries hold must not."""

    __slots__ = ("entries", "owners", "building", "__weakref__")

    def __init__(self) -> None:
        self.entries: Dict[Any, Dict[Any, Any]] = {}
        #: (token, key) -> ids of the live contexts holding the entry
        self.owners: Dict[Tuple, set] = {}
        #: (token, key) -> the event its builder sets when done
        self.building: Dict[Tuple, threading.Event] = {}


_stage_cache_lock = threading.Lock()

#: every live per-spec stage cache (introspection: live_stage_entries)
_live_stage_caches: "weakref.WeakSet[_SpecStageCache]" = weakref.WeakSet()

#: id(context) -> the (cache, token, key) entries that context holds
_owned_entries: Dict[int, List[Tuple[Any, Any, Any]]] = {}

_MISSING = object()


def _own(cache: _SpecStageCache, tok: Any, key: Any, owner: Any) -> None:
    """Note ``owner``'s hold on an entry (under ``_stage_cache_lock``)."""
    ids = cache.owners.setdefault((tok, key), set())
    if id(owner) not in ids:
        ids.add(id(owner))
        _owned_entries.setdefault(id(owner), []).append(
            (weakref.ref(cache), tok, key))


def cached_stage_callable(token: Any, key: Any, build: Callable,
                          owner: Any = None) -> Any:
    """Fetch-or-build one stage's program (or plan) under ``token``, the
    spec token of stagec/lower.spec_token: its first element wraps the
    parsed spec (``.obj``), on which the cache lives.  ``build`` runs
    once per (token, key), also when several threads ask at once (the
    others wait for it); whatever it returns (the failure sentinel
    included) is returned to every later caller.  With ``owner`` (a
    context) the entry is held for that context until
    :func:`release_stage_entries` is called with it."""
    spec = token[0].obj
    tok = token[1:]
    while True:
        with _stage_cache_lock:   # rank threads may share one spec
            cache = getattr(spec, "_ptt_stage_cache", None)
            if cache is None:
                cache = _SpecStageCache()
                spec._ptt_stage_cache = cache
                _live_stage_caches.add(cache)
            fn = cache.entries.setdefault(tok, {}).get(key, _MISSING)
            if fn is not _MISSING:
                if owner is not None:
                    _own(cache, tok, key, owner)
                return fn
            done = cache.building.get((tok, key))
            if done is None:
                done = cache.building[(tok, key)] = threading.Event()
                break
        done.wait()   # another thread builds it; then fetch again
    try:
        fn = build()
    finally:
        with _stage_cache_lock:
            del cache.building[(tok, key)]
        done.set()
    with _stage_cache_lock:
        cache.entries.setdefault(tok, {})[key] = fn
        if owner is not None:
            _own(cache, tok, key, owner)
    return fn


def release_stage_entries(owner: Any) -> None:
    """Drop ``owner``'s hold on the stage entries it fetched (a context
    calls this at ``fini``): an entry no live context holds goes, and
    with it its graph's memory pool and static buffers (once no
    taskpool still references the program)."""
    with _stage_cache_lock:
        for ref, tok, key in _owned_entries.pop(id(owner), ()):
            cache = ref()
            if cache is None:
                continue
            ids = cache.owners.get((tok, key))
            if ids is None:
                continue
            ids.discard(id(owner))
            if not ids:
                del cache.owners[(tok, key)]
                cache.entries.get(tok, {}).pop(key, None)


def live_stage_entries() -> int:
    """Entries held by the stage caches of every live spec."""
    with _stage_cache_lock:
        return sum(len(per) for c in list(_live_stage_caches)
                   for per in c.entries.values())


def clear_stage_cache() -> None:
    """Drop every live spec's stage entries: their recorded programs'
    device memory returns to the allocator once no taskpool references
    them.  Entries a context holds go at its ``fini`` anyway; this is
    for a long-lived context that ran many sizes, dtypes or knob
    settings."""
    with _stage_cache_lock:
        for c in list(_live_stage_caches):
            c.entries.clear()
            c.owners.clear()
        _owned_entries.clear()
