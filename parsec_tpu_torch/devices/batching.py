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

import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["DeviceBatchSpec", "ShardedCallable", "bucket_size",
           "cached_sharded_callable", "segment_plan", "stacked_call"]


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
