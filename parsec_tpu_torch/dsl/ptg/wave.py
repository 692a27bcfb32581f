"""Wave execution: run a lowered PTG taskpool as batched body calls.

The per-task runtime pays one Python dispatch per task (about 0.7 ms on
the card, PERF.md), which bounds throughput no matter how fast the card
is; whole-DAG capture (capture.py) removes the host loop but replays one
launch per task.  Wave execution keeps batching and drops the per-task
host work:

- the lowered DAG (lower.py) tracks readiness in dense native counters;
- every collection lives on the device as stacked tile pools
  ``[n_tiles, mb, nb]``, one pool per distinct tile shape (ragged
  tilings — the reference's lm%mb edge tiles — split into interior +
  edge + corner pools, each uniform, each batched exactly), staged in
  once per run;
- each ready antichain ("wave") runs as ONE Python call (fused mode,
  default): every class/group gathers its input tiles from the pre-wave
  pools (``index_select``), runs its body over the gathered stack, and
  written tiles scatter back in place (``index_copy_``). Waves whose
  gathers exceed ``wave_fuse_bytes`` run per-(class, chunk) calls;
- host dispatch cost is per *wave* (fused) or per *chunk* (~classes x
  log2(wave size)), plus, for a body that keeps single-tile semantics,
  one body call per member.

Every body keeps single-tile semantics, as the JAX package's ``vmap`` of
a single-instance body does: a body is called once per member of the
gathered stack, and its outputs are stacked for the scatter.  A body
marked ``BODY [type=cuda batch=stacked]`` declares that it takes a
leading batch dimension and is called ONCE on the whole stack: the
DPLASMA bodies (ops/) do, so their GEMM and SYRK updates are one
GEMM-kernel launch over ``gridDim.z`` = the chunk.  Either way the
static body locals are bound to concrete values: the range locals the
body reads (directly or through a derived local) split a class's members
into groups of equal values, as the device module's batching does
(devices/batching.py).

Semantics notes:
- priorities are ignored: execution is breadth-first by dependence
  level;
- a wave may contain a reader of a tile and the (dataflow-independent)
  writer of the same tile (WAR); fused waves gather every input before
  any scatter, so same-wave readers see pre-wave values (the per-task
  runtime's copy semantics) even for cyclic WAR; unfused waves split
  readers into an earlier sub-wave instead (cyclic WAR raises there);
- supported flows are those whose values live in collection tiles
  (memory-sourced or forwarded from task to task) or in NEW scratch
  pools (zeroed on the device each run); a flow that resolves to
  neither, or a writeback to a different tile than the flow's slot,
  raises WaveError — those run through the per-task runtime instead.

``run(device=None)`` runs where ``init()`` puts the device module
(``cuda:0`` unless ``device_cuda_platform`` names another) and raises
without a card; ``run(device="cpu")`` runs the same code over host
tensors with each kernel's plain version (what the tests do).  The pools of ``build_pools``
may not be split across several chips in this package (that is SPMD,
ROADMAP Queue 1, part D2b).

A multi-rank taskpool (or any call with an explicit ``comm``) runs
through ``DistWaveRunner`` (wave_dist.py): every rank walks the same
waves over its slice of the pools, and tiles move between ranks on a
static schedule.  The seams it uses here: ``_multirank``, the
global-to-local pool-row maps ``_g2l`` and the per-instance wire
conversions ``_wconv`` ([type_remote] on a cross-rank edge).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...data.datatype import Datatype, np_dtype
from ...data.reshape import reshape_batch
from ...devices import resolve_device
from ...utils import logging as plog
from .lower import LoweredDAG, lower, make_engine
from .runtime import PTGTaskpool, _expand_args, f_prop, scratch_shape

__all__ = ["WaveError", "WaveRunner", "wave"]


class WaveError(RuntimeError):
    pass


def _torch_dtype(dtype):
    return getattr(torch, np_dtype(dtype).name)


def _pick_body(tc_ast):
    for b in tc_ast.bodies:
        if b.device_type not in ("cpu", "recursive"):
            return b
    return tc_ast.bodies[0]


class _ClassPlan:
    """Per-task-class metadata: which flows carry data, where their
    slots live, and the cached chunk closures."""

    __slots__ = ("tc", "ast", "flow_idx", "flow_names",
                 "written", "reads", "range_locals", "body_locals",
                 "derived", "code", "stacked", "kernels", "in_tnames",
                 "wb_names", "in_tname", "wb_name", "_kplan")

    def __init__(self, tc) -> None:
        self.tc = tc
        self.ast = tc.ast
        self.flow_idx = [i for i, f in enumerate(tc.ast.flows)
                         if not f.is_ctl]
        self.flow_names = [tc.ast.flows[i].name for i in self.flow_idx]
        from ...data.data import FlowAccess
        self.written = [bool(tc.flows[i].access & FlowAccess.WRITE)
                        for i in self.flow_idx]
        # a flow with in-deps reads its slot's current value (RW reads
        # then writes; WRITE-only flows have no in-deps and may clobber)
        self.reads = [bool(tc.ast.flows[i].deps_in()) for i in self.flow_idx]
        nf = len(self.flow_idx)
        # reshape-property support: per-flow [type]/[type_data] names
        # collected across instances (must be uniform — closures are
        # per-class), resolved to concrete conversions at first call
        # when pool tile shapes exist
        self.in_tnames: List[set] = [set() for _ in range(nf)]
        self.wb_names: List[set] = [set() for _ in range(nf)]
        self.in_tname: List[Optional[str]] = [None] * nf
        self.wb_name: List[Optional[str]] = [None] * nf
        self.range_locals = [ld.name for ld in tc.ast.locals
                             if ld.range is not None]
        body = _pick_body(tc.ast)
        self.code = compile(body.code, f"<jdf:{tc.ast.name}:BODY[wave]>",
                            "exec")
        self.stacked = body.stacked
        # locals the body reads (co_names: exec reads them as globals),
        # closed over the derived locals it reads: bodies branch on them
        # in Python (`BETA if k == 0 else 1.0`) and see one value per
        # call, so the range locals among them are STATIC — a wave's
        # members are grouped on their values
        needed = set(self.code.co_names)
        derived = {ld.name: ld for ld in tc.ast.locals if ld.range is None}
        todo = [nm for nm in needed if nm in derived]
        while todo:
            for nm in derived[todo.pop()].expr._code.co_names:
                if nm not in needed:
                    needed.add(nm)
                    if nm in derived:
                        todo.append(nm)
        self.body_locals = [i for i, nm in enumerate(self.range_locals)
                            if nm in needed]
        self.derived = [(ld.name, ld.expr) for ld in tc.ast.locals
                        if ld.range is None and ld.name in needed]
        self.kernels: Dict[Tuple, Any] = {}
        self._kplan = None

    def kplan(self) -> "_KPlan":
        """The light view the cached closures capture: per-class
        metadata WITHOUT the task-class/taskpool back-references, so
        closures cached on the (process-cached) LoweredDAG cannot pin
        runners, collections or device pools for process lifetime."""
        if self._kplan is None:
            self._kplan = _KPlan(self)
        return self._kplan


class _KPlan:
    __slots__ = ("name", "nf", "flow_names", "written", "wb_name",
                 "in_tname", "range_locals", "body_locals", "derived",
                 "code", "stacked")

    def __init__(self, p: _ClassPlan) -> None:
        self.name = p.ast.name
        self.nf = len(p.flow_idx)
        self.flow_names = p.flow_names
        self.written = p.written
        # in_tname/wb_name lists are assigned ELEMENT-wise by
        # _validate_tnames — sharing the list objects keeps the view
        # current regardless of construction order
        self.wb_name = p.wb_name
        self.in_tname = p.in_tname
        self.range_locals = p.range_locals
        self.body_locals = p.body_locals
        self.derived = p.derived
        self.code = p.code
        self.stacked = p.stacked


# --------------------------------------------------------------------- #
# chunk logic: module-level so cached closures capture only the light   #
# _KPlan views + a collection-pruned env — never a runner (closures     #
# cached on the process-cached LoweredDAG must not pin pools)           #
# --------------------------------------------------------------------- #
def _resolve_dst_f(genv, p: _KPlan, k, nm, tile_shape, pool_dtype):
    """Concrete Datatype for a validated [type*] name (resolved at the
    first call, when pool tile shapes are in hand)."""
    val = genv.get(nm)
    if isinstance(val, Datatype):
        dst = val
    else:   # validated shorthand
        dst = Datatype(np_dtype(pool_dtype), tuple(tile_shape), nm)
    if tuple(dst.shape) != tuple(tile_shape):
        raise WaveError(
            f"{p.name}.{p.flow_names[k]}: [type={nm}] shape "
            f"{dst.shape} differs from the pool tile {tile_shape}; "
            f"wave pools are fixed-shape — use the per-task runtime")
    return dst


def _make_call_f(genv, p: _KPlan, statics: Tuple, wires: Tuple = ()):
    """The class body over stacked tensors, with the given static
    body-local values: ``call(*flow_vals) -> written outputs``, each
    input ``[k, ...]`` and each output ``[k, ...]``.  A ``batch=stacked``
    body runs once on the stacks; any other runs once per member and its
    outputs are stacked.  [type]/[type_data] input conversions (masked
    casts) apply to the gathered stack first (ref: parsec_reshape.c
    consumer-side promise trigger).  ``wires`` carries this group's
    per-flow [type_remote] names (distributed wave: instances whose
    bound producer lives on another rank convert the received raw tile
    consumer-side, the remote_dep_mpi.c:766 lookup)."""
    flow_names = p.flow_names
    written = p.written
    in_tname = p.in_tname
    derived = p.derived
    code = p.code
    stacked = p.stacked
    static_pairs = [(p.range_locals[i], v)
                    for i, v in zip(p.body_locals, statics)]

    def conv_in(j, v):
        nm = (wires[j] if wires and wires[j] is not None
              else in_tname[j])
        if nm is None:
            return v
        dst = _resolve_dst_f(genv, p, j, nm, tuple(v.shape[1:]), v.dtype)
        if dst.compatible_wire(Datatype(np_dtype(v.dtype),
                                        tuple(v.shape[1:]))):
            return v
        return reshape_batch(v, dst)

    def run(vals):
        env = dict(genv)
        for nm, v in static_pairs:  # concrete: bodies may branch
            env[nm] = v
        for nm, ex in derived:
            env[nm] = ex(env)
        for nm, v in zip(flow_names, vals):
            env[nm] = v
        env["np"] = np
        env["torch"] = torch
        env["es_rank"] = 0
        env["this_task"] = None
        exec(code, env)
        return tuple(env[nm] for nm, w in zip(flow_names, written) if w)

    def call(*flow_vals):
        vals = [conv_in(j, v) for j, v in enumerate(flow_vals)]
        if stacked or not vals:
            return run(vals)
        outs = [run([v[i] for v in vals]) for i in range(vals[0].shape[0])]
        return tuple(torch.stack([torch.as_tensor(o[j]) for o in outs])
                     for j in range(len(outs[0])))

    return call


def _merge_masked_f(genv, p: _KPlan, j, val, dest_old):
    """Region-masked memory writeback: only in-region elements land;
    the rest keep the DESTINATION's pre-wave values (the detached-clone
    semantics of the per-task runtime). ``val`` is batched [k, ...]; the
    declared dtype round-trip mirrors reshape_to + np.copyto."""
    dst = _resolve_dst_f(genv, p, j, p.wb_name[j],
                         tuple(dest_old.shape[1:]), dest_old.dtype)
    conv = reshape_batch(val, dst).to(dest_old.dtype)
    mask = dst.mask()
    if mask is None:
        return conv
    return torch.where(torch.as_tensor(mask, device=conv.device), conv,
                       dest_old)


def _check_out(p: _KPlan, j, val, pool, k):
    """A body output must be a stack of k tiles of the pool's shape."""
    if not isinstance(val, torch.Tensor) or \
            tuple(val.shape) != (k,) + tuple(pool.shape[1:]):
        shape = tuple(val.shape) if hasattr(val, "shape") else type(val)
        raise WaveError(
            f"{p.name}.{p.flow_names[j]}: the body returned {shape} for "
            f"{k} tiles of {tuple(pool.shape[1:])}; a wave body must "
            f"return one pool tile a task (a stack with a leading batch "
            f"dimension when it is marked batch=stacked)")
    return val if val.dtype == pool.dtype else val.to(pool.dtype)


def _gather_group_f(kplans, pools, spec, idx):
    """Gather one group's inputs + masked-merge destinations from the
    (pre-scatter) pools: ``idx`` holds the chunk's device index
    tensors."""
    _ci, _k, _st, incols, outcols, wbflags, wbxcols, _cnv = spec
    p = kplans[_ci]
    nf = p.nf
    gathered = [pools[incols[j]].index_select(0, idx.inp[j])
                for j in range(nf)]
    dest_old = {j: pools[outcols[j]].index_select(0, idx.out[j])
                for j in range(nf)
                if p.written[j] and p.wb_name[j] is not None
                and wbflags and wbflags[j]}
    wbx_old = {j: pools[wbxcols[j]].index_select(0, idx.wbx[j])
               for j in range(nf) if wbxcols and wbxcols[j] >= 0}
    return gathered, dest_old, wbx_old


def _compute_scatter_f(genv, kplans, call, pools, spec, staged, idx) -> None:
    """Run one group's body on its gathered stacks and scatter the
    written outputs into ``pools`` in place (``index_copy_``, the
    counterpart of donated buffers).

    The masked merge applies only at declared MEMORY-target scatters
    (wbflags, per-instance): an instance whose guarded out-dep resolved
    to no target writes in place or renames, and its successors must
    see the FULL body output. A dual-output flow additionally scatters
    the region-merge into its memory target (wbx) while the rename slot
    carries the full value."""
    ci, k, _statics, _incols, outcols, _wbflags, wbxcols, _cnv = spec
    p = kplans[ci]
    gathered, dest_old, wbx_old = staged
    outs = call(*gathered)
    oi = 0
    for j, w in enumerate(p.written):
        if not w:
            continue
        cid = outcols[j]
        full = _check_out(p, j, outs[oi], pools[cid], k)
        val = full
        if j in dest_old:
            val = _merge_masked_f(genv, p, j, full, dest_old[j])
        pools[cid].index_copy_(0, idx.out[j], val)
        if j in wbx_old:
            xcid = wbxcols[j]
            pools[xcid].index_copy_(0, idx.wbx[j], _merge_masked_f(
                genv, p, j, full, wbx_old[j]))
        oi += 1


class _Idx:
    """A chunk's index tensors on the pools' device: one row per flow
    (``inp``, ``out``, ``wbx``), int64 as index_select/index_copy_
    take."""

    __slots__ = ("inp", "out", "wbx")

    def __init__(self, inp, out, wbx) -> None:
        self.inp, self.out, self.wbx = inp, out, wbx


def _stage_indices(entries, device) -> List[_Idx]:
    """Every chunk's index arrays of a wave in ONE host-to-device copy
    (a copy per chunk and flow would cost a transfer each)."""
    arrs = []
    for _spec, a in entries:
        arrs += [a["idx_in"], a["idx_out"], a["idx_wbx"]]
    flat = np.concatenate([x.ravel() for x in arrs]).astype(np.int64)
    dev = torch.from_numpy(flat).to(device)
    out, off = [], 0
    views = []
    for x in arrs:
        n = x.size
        views.append(dev[off:off + n].view(x.shape))
        off += n
    for i in range(len(entries)):
        out.append(_Idx(*views[3 * i:3 * i + 3]))
    return out


class WaveRunner:
    """Executor for one single-rank PTG taskpool in wave mode."""

    _multirank = False   # DistWaveRunner (wave_dist.py) overrides

    def __init__(self, tp: PTGTaskpool, max_chunk: int = 256) -> None:
        if tp.nb_ranks != 1 and not self._multirank:
            raise WaveError(
                f"single-rank wave on a taskpool with nb_ranks="
                f"{tp.nb_ranks}; use wave(tp, comm=...) / DistWaveRunner")
        self.tp = tp
        self.max_chunk = max(1, int(max_chunk))
        self.dag: LoweredDAG = lower(tp, allow_multirank=self._multirank)
        from ...collections.collection import DataCollection
        self.collections: Dict[str, Any] = {
            name: c for name, c in tp.global_env.items()
            if isinstance(c, DataCollection)}
        if not self.collections:
            raise WaveError("taskpool binds no data collections")
        self.coll_names = sorted(self.collections)
        # Pools are SHAPE-SPLIT: each collection's tiles are partitioned
        # by their true tile shape and every shape class becomes its own
        # stacked pool. A ragged tiling (the reference's first-class
        # lm%mb edge tiles, parsec/data_dist/matrix/matrix.c:106,116)
        # yields at most 4 pools per matrix (interior + bottom/right
        # edge + corner); bodies see exact shapes, so edge tiles need no
        # padding or masking and the math is the per-task runtime's.
        # Chunks already group by the per-instance pool signature, so
        # mixed-shape classes batch per shape. Pool order is
        # deterministic (largest tile first within each collection).
        self.pool_names: List[str] = []       # pool id -> collection name
        self._pool_coords: List[List[Tuple]] = []
        self._pool_shapes: List[Tuple] = []
        self._pool_of: Dict[str, Dict[Tuple, Tuple[int, int]]] = {}
        for n in self.coll_names:
            coll = self.collections[n]
            coords = sorted(coll.tiles())
            ts = getattr(coll, "tile_shape", None)
            if callable(ts):
                by_shape: Dict[Tuple, List[Tuple]] = {}
                for c in coords:
                    by_shape.setdefault(
                        tuple(int(v) for v in ts(*c)), []).append(c)
                shapes = sorted(by_shape,
                                key=lambda s: (-int(np.prod(s)), s))
            else:
                # no descriptor contract: one pool, shapes resolved at
                # staging (a ragged tiling needs tile_shape)
                by_shape = {None: coords}
                shapes = [None]
            loc = self._pool_of.setdefault(n, {})
            for sh in shapes:
                pid = len(self.pool_names)
                self.pool_names.append(n)
                self._pool_coords.append(by_shape[sh])
                self._pool_shapes.append(sh)
                for i, c in enumerate(by_shape[sh]):
                    loc[c] = (pid, i)
        self.plans = [_ClassPlan(tc) for tc in tp.task_classes]
        # reshape properties ([type]/[type_data]) are served in the
        # chunk call: input conversions apply after the gather, region-
        # masked memory writebacks merge with the pre-body tile value at
        # scatter. The names must be uniform per (class, flow).
        # NEW scratch flows get per-class scratch pools (ids after the
        # real collections), zeroed on the device each run like the
        # per-task runtime's runtime-allocated NEW tiles.
        self._n_real_colls = len(self.pool_names)
        # wave-level call fusion (one call per wave): MCA-tunable, with
        # a gather-bytes budget above which big waves keep per-chunk
        # calls
        from ...utils.params import params
        self._fuse = bool(params.get("wave_fuse"))
        self._fuse_bytes = int(params.get("wave_fuse_bytes"))
        self._fuse_programs = int(params.get("wave_fuse_programs"))
        self._fused_kerns: Dict[Tuple, Any] = {}
        self._scratch: Dict[Tuple, Dict[str, Any]] = {}
        self.stats: Dict[str, Any] = {}
        self.stage_in_bytes = 0     # host bytes the last build_pools moved
        self.device = None          # the last build_pools' device
        self._g2l = None   # DistWaveRunner: global->local pool row maps
        # slot tables: per task, per (non-ctl) flow position in the
        # class's flow_idx list -> flat tile index (collection fixed per
        # class/flow, validated during assignment)
        self._assign_slots()
        self._validate_tnames()
        self._kplans = [p.kplan() for p in self.plans]
        self._trace_env = self._build_trace_env()

    # ------------------------------------------------------------------ #
    # slot assignment                                                    #
    # ------------------------------------------------------------------ #
    def _wire_tname_of(self, tc, f, env) -> Optional[str]:
        """[type_remote] hook: wire conversions exist only on cross-rank
        edges — the distributed runner overrides this; a single-rank
        wave has no remote edges."""
        return None

    def _assign_slots(self) -> None:
        dag = self.dag
        n = dag.n_tasks
        # per-INSTANCE wire conversions ([type_remote] on a bound remote
        # edge, distributed only): sparse (task, flow) -> name; chunks
        # group by the per-flow name tuple so per-class closures stay
        # uniform while local and remote instances convert differently
        self._wconv: Dict[Tuple[int, int], str] = {}
        max_df = max((len(p.flow_idx) for p in self.plans), default=0)
        slot = np.full((n, max_df), -1, np.int32)
        # topo order via Kahn over the lowered CSR
        indeg = dag.indegree.copy()
        head = 0
        order = [int(t) for t in np.nonzero(indeg == 0)[0]]
        while head < len(order):
            t = order[head]
            head += 1
            for e in range(int(dag.indptr[t]), int(dag.indptr[t + 1])):
                s = int(dag.succ[e])
                indeg[s] -= 1
                if indeg[s] == 0:
                    order.append(s)
        if len(order) != n:
            raise WaveError("cycle in lowered DAG")

        flow_pos = []  # per class: ast flow index -> dense position
        for p in self.plans:
            pos = {fi: k for k, fi in enumerate(p.flow_idx)}
            flow_pos.append(pos)

        # class-local ordinal of each task (scratch-pool slot index for
        # NEW flows: one scratch tile per instance)
        ordinal = np.zeros(n, np.int32)
        counts: Dict[int, int] = {}
        for t in range(n):
            ci = int(dag.class_of[t])
            ordinal[t] = counts.get(ci, 0)
            counts[ci] = counts.get(ci, 0) + 1
        self._class_ordinal = ordinal
        self._class_count = counts

        # IN and OUT slots are SEPARATE: a written flow without a memory
        # out-dep renames into a per-instance scratch slot, so its body
        # output reaches successors without mutating the home tile —
        # the per-task runtime's copy-rename semantics (this also lets
        # instances write back to a DIFFERENT tile than they read, and
        # lets guarded deps bind different collections per instance:
        # chunks group by the per-task collection signature)
        slot_out = np.full((n, max_df), -1, np.int32)
        scoll = np.full((n, max_df), -1, np.int16)
        socoll = np.full((n, max_df), -1, np.int16)
        # per-INSTANCE: does this flow write a declared memory target
        # (the only scatters where a [type*] writeback mask applies)?
        wb_apply = np.zeros((n, max_df), bool)
        # per-INSTANCE extra masked scatter: a flow with BOTH a masked
        # memory writeback AND task successors produces TWO values —
        # successors get the full body output (rename slot), memory
        # gets the region-merge; these arrays carry the memory target
        wbx_cid = np.full((n, max_df), -1, np.int16)
        wbx_idx = np.full((n, max_df), -1, np.int32)
        self._wbx_cid, self._wbx_idx = wbx_cid, wbx_idx

        for t in order:
            ci = int(dag.class_of[t])
            p = self.plans[ci]
            tc = p.tc
            env = tc.env_of(dag.locals_of[t])
            for k, fi in enumerate(p.flow_idx):
                f = tc.ast.flows[fi]
                s = self._slot_of_flow(t, f, env, flow_pos, slot, scoll,
                                       slot_out, socoll)
                if s is None:
                    raise WaveError(
                        f"{p.ast.name}{dag.locals_of[t]}.{f.name}: flow "
                        f"does not resolve to a collection tile or scratch "
                        f"pool (NULL flows need the per-task runtime)")
                coll_id, idx = s
                scoll[t, k] = coll_id
                slot[t, k] = idx
                tname = self._inst_in_tname(f, env)
                p.in_tnames[k].add(tname)
                wnm = self._wire_tname_of(tc, f, env)
                if wnm is not None:
                    self._wconv[(t, k)] = wnm
                if p.written[k]:
                    out_cid, out_idx, has_target = self._out_slot_of_flow(
                        t, p, k, f, env, coll_id, idx, tname,
                        wbx_cid, wbx_idx)
                    socoll[t, k] = out_cid
                    slot_out[t, k] = out_idx
                    wb_apply[t, k] = has_target
        self._slot = slot
        self._slot_out = slot_out
        self._slot_coll = scoll
        self._slot_out_coll = socoll
        self._wb_apply = wb_apply
        # only collections the DAG actually touches are staged; only the
        # rows some task writes are scattered back (pool id -> rows)
        self._used_colls = ({int(c) for c in np.unique(scoll) if c >= 0}
                            | {int(c) for c in np.unique(socoll) if c >= 0}
                            | {int(c) for c in np.unique(wbx_cid) if c >= 0})
        written = (np.concatenate([socoll.ravel(), wbx_cid.ravel()]),
                   np.concatenate([slot_out.ravel(), wbx_idx.ravel()]))
        self._written_rows: Dict[int, np.ndarray] = {
            int(c): np.unique(written[1][written[0] == c])
            for c in np.unique(written[0]) if c >= 0}

    def _inst_in_tname(self, f, env) -> Optional[str]:
        """The [type*] name this instance's input edge declares (same
        first-applicable-dep rule as the runtime's _input_dtt;
        type_remote is wire-only and never applies on one rank)."""
        for d in f.deps_in():
            t = d.resolve(env)
            if t is None:
                continue
            props = d.properties
            if t.kind == "memory":
                nm = props.get("type_data") or props.get("type")
            else:
                nm = props.get("type")
            return None if nm == "full" else nm
        return None

    def _scratch_slot(self, tid, f, env, shape=None) -> Tuple[int, int]:
        """NEW flow: one scratch tile per instance in a per-(class,
        flow) zeroed pool (the runtime-allocated NEW tile analog; shape
        from [shape=]/[dtype=] props, uniform across instances — pools
        are stacked tensors)."""
        ci = int(self.dag.class_of[tid])
        if shape is None:
            shape = scratch_shape(f, env)
        if shape is None:
            raise WaveError(
                f"{self.plans[ci].ast.name}.{f.name}: NEW flow needs a "
                f"[shape=...] property")
        key = (ci, f.name, "new")
        sp = self._scratch.get(key)
        if sp is None:
            sp = self._scratch[key] = {
                "cid": self._n_real_colls + len(self._scratch),
                "shape": shape,
                "dtype": np.dtype(f_prop(f, "dtype", "float32")),
                "like": None,
                "n": self._class_count[ci],
                "label": f"{self.plans[ci].ast.name}.{f.name}",
            }
        elif sp["shape"] != shape:
            raise WaveError(
                f"{sp['label']}: NEW shapes differ across instances "
                f"({sp['shape']} vs {shape}); scratch pools are stacked")
        return sp["cid"], int(self._class_ordinal[tid])

    def _rename_slot(self, tid, f, like_cid: int) -> Tuple[int, int]:
        """Written flow with NO memory out-target: its output must reach
        successors without touching the home tile — rename into a
        per-instance scratch slot (the copy-rename the per-task runtime
        gets from fresh DataCopies). Tile shape/dtype copied from the
        input slot's pool at staging."""
        ci = int(self.dag.class_of[tid])
        # keyed by the like-pool: instances binding different input
        # pools (guarded collections, or shape-split edge tiles) rename
        # into separate pools so tile shapes stay exact per pool. Rows
        # are per-key ordinals in the deterministic topo walk, sized to
        # the instances that actually rename through this pool.
        key = (ci, f.name, "ren", like_cid)
        sp = self._scratch.get(key)
        if sp is None:
            sp = self._scratch[key] = {
                "cid": self._n_real_colls + len(self._scratch),
                "shape": None,
                "dtype": None,
                "like": like_cid,
                "rows": {},
                "n": 0,
                "label": f"{self.plans[ci].ast.name}.{f.name}",
            }
        row = sp["rows"].setdefault(int(tid), len(sp["rows"]))
        sp["n"] = len(sp["rows"])
        return sp["cid"], row

    def _out_slot_of_flow(self, tid, p, k, f, env, in_cid, in_idx, tname,
                          wbx_cid, wbx_idx) -> Tuple[int, int, bool]:
        """Where this written flow's output lands.

        Mirrors the runtime's copy binding: a flow's body mutates the
        copy BOUND to it, so by default the output lands in the input
        slot (home tiles and shared producer copies are mutated in
        place, like the reference's parsec_data_copy_t sharing). The
        exceptions:
        - a memory out-dep names the tile — must be the input slot
          (or the input is private scratch: NEW tiles write back home);
        - a [type*] INPUT conversion applies — the runtime binds a
          DETACHED converted copy there, so the output renames into a
          private scratch slot and the home/producer value stays put.
        """
        targets = set()
        inst_masked = False
        has_task_succ = False
        for d in f.deps_out():
            t = d.resolve(env)
            if t is None:
                continue
            if t.kind == "task":
                has_task_succ = True
                continue
            if t.kind != "memory":
                continue
            coords = tuple(int(a(env)) for a in t.args)
            hit = self._locate_tile(t.collection, coords)
            if hit is None:
                raise WaveError(
                    f"{p.ast.name}.{f.name}: writes back to unbound "
                    f"collection {t.collection!r}")
            targets.add(hit)
            nm = d.properties.get("type_data") or d.properties.get("type")
            nm = None if nm == "full" else nm
            inst_masked = inst_masked or nm is not None
            p.wb_names[k].add(nm)
        if len(targets) > 1:
            raise WaveError(
                f"{p.ast.name}.{f.name}: one instance writes back to "
                f"multiple tiles {sorted(targets)}; unsupported in wave "
                f"mode")
        if targets:
            cid, idx = next(iter(targets))
            if inst_masked and has_task_succ:
                # TWO distinct values leave this flow: successors get
                # the FULL body output (runtime: the detached clone),
                # memory gets the region-masked merge. Main scatter
                # renames; the memory target rides the extra-scatter
                # arrays (masked merge against its own old value).
                wbx_cid[tid, k] = cid
                wbx_idx[tid, k] = idx
                return self._rename_slot(tid, f, in_cid) + (False,)
            if (cid, idx) != (in_cid, in_idx) and \
                    in_cid < self._n_real_colls:
                raise WaveError(
                    f"{p.ast.name}.{f.name}: writes back to a different "
                    f"tile than its slot; unsupported in wave mode (the "
                    f"body would also mutate the source in the runtime)")
            return cid, idx, True
        if tname is not None:
            return self._rename_slot(tid, f, in_cid) + (False,)
        return in_cid, in_idx, False

    def _slot_of_flow(self, tid, f, env, flow_pos, slot, scoll,
                      slot_out, socoll):
        deps_in = f.deps_in()
        for d in deps_in:
            t = d.resolve(env)
            if t is None:
                continue
            if t.kind == "memory":
                coords = tuple(int(a(env)) for a in t.args)
                return self._locate_tile(t.collection, coords)
            if t.kind == "new":
                return self._scratch_slot(tid, f, env)
            if t.kind == "task":
                for args in _expand_args(t.args, env):
                    past = self.tp.jdf.task_class_by_name(t.task_class)
                    pkey = (t.task_class, past.locals_from_param_args(args))
                    pid = self.dag.id_of.get(pkey)
                    if pid is None:
                        continue  # out-of-space producer: inapplicable
                    pci = int(self.dag.class_of[pid])
                    pplan = self.plans[pci]
                    pfi = next(i for i, pf in enumerate(pplan.ast.flows)
                               if pf.name == t.flow)
                    k = flow_pos[pci].get(pfi)
                    if k is None:
                        return None
                    # a WRITTEN producer flow hands successors its OUT
                    # slot (post-rename); a READ flow forwards its input
                    if pplan.written[k]:
                        idx = int(slot_out[pid, k])
                        cid = int(socoll[pid, k])
                    else:
                        idx = int(slot[pid, k])
                        cid = int(scoll[pid, k])
                    if idx < 0:
                        return None
                    return cid, idx
                continue
            return None  # null
        if not deps_in:
            # WRITE-only flow: bind to its memory out-target, or a
            # scratch pool when it only feeds successors ([shape=] set)
            for d in f.deps_out():
                t = d.resolve(env)
                if t is not None and t.kind == "memory":
                    coords = tuple(int(a(env)) for a in t.args)
                    return self._locate_tile(t.collection, coords)
            ssh = scratch_shape(f, env)
            if ssh is not None:
                return self._scratch_slot(tid, f, env, shape=ssh)
        return None

    def _locate_tile(self, coll_name: str,
                     coords: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
        """Map a dep target to its (pool id, pool row); None when the
        collection is unbound. Vector-style 1-arg targets pad a trailing
        0 (data_of(m) == data_of(m, 0))."""
        loc = self._pool_of.get(coll_name)
        if loc is None:
            return None
        hit = loc.get(coords)
        while hit is None and len(coords) < 2:
            coords = coords + (0,)
            hit = loc.get(coords)
        if hit is None:
            raise WaveError(f"no tile {coords} in collection "
                            f"{coll_name}")
        return hit

    # ------------------------------------------------------------------ #
    # reshape-property conversions                                       #
    # ------------------------------------------------------------------ #
    def _validate_tnames(self) -> None:
        """Uniformity + resolvability of collected [type*] names (the
        closures are per-class, so per-instance variation is
        unservable; the general runtime handles those JDFs)."""
        for p in self.plans:
            for k in range(len(p.flow_idx)):
                for which, names in (("in", p.in_tnames[k]),
                                     ("writeback", p.wb_names[k])):
                    real = {n for n in names if n is not None}
                    if len(real) > 1 or (real and None in names):
                        raise WaveError(
                            f"{p.ast.name}.{p.flow_names[k]}: [type*] "
                            f"names vary across instances "
                            f"({sorted(names, key=str)}); per-class wave "
                            f"calls need one — use the per-task runtime")
                    for nm in real:
                        val = self.tp.global_env.get(nm)
                        if not isinstance(val, Datatype) and \
                                nm not in ("lower", "upper", "full"):
                            raise WaveError(
                                f"{p.ast.name}.{p.flow_names[k]} "
                                f"({which}): [type={nm}] is neither a "
                                f"Datatype global nor a region shorthand")
                p.in_tname[k] = next(iter(
                    {n for n in p.in_tnames[k] if n is not None}), None)
                p.wb_name[k] = next(iter(
                    {n for n in p.wb_names[k] if n is not None}), None)

    def _build_trace_env(self) -> Dict[str, Any]:
        """global_env for the cached closures, with DataCollection values
        dropped unless a body or derived-local expression names them:
        closures cached on the process-cached DAG must not pin
        collections — and through their attached lazy device copies,
        result pools — for process lifetime."""
        from ...collections.collection import DataCollection
        needed = set()
        for p in self.plans:
            needed |= set(p.code.co_names)
            for ld in p.ast.locals:
                if ld.range is None:
                    needed |= set(ld.expr._code.co_names)
            if p.ast.priority is not None:
                needed |= set(p.ast.priority._code.co_names)
        env = {k: v for k, v in self.tp.global_env.items()
               if not isinstance(v, DataCollection) or k in needed}
        # a body that NAMES a collection bakes that instance into the
        # closure: such closures stay per-runner (a later taskpool with
        # the same structural signature but different data would reuse
        # the stale collection)
        self._kernels_shareable = not any(
            isinstance(env.get(nm), DataCollection) for nm in needed)
        return env

    # ------------------------------------------------------------------ #
    # chunk and fused-wave closures (their logic lives in the            #
    # module-level _*_f functions so cached closures capture kplans +    #
    # a pruned env, never the runner)                                    #
    # ------------------------------------------------------------------ #
    def _kernel(self, ci: int, k: int, statics: Tuple, incols: Tuple,
                outcols: Tuple, wbflags: Tuple = (), wbxcols: Tuple = (),
                cnv: Tuple = ()):
        """The chunk closure for class ``ci``, chunk size ``k``, static
        body-local values ``statics``, per-flow pool ids
        ``incols``/``outcols``, per-flow writeback-mask applicability
        ``wbflags``, and per-flow extra masked-scatter pool ids
        ``wbxcols`` (guarded deps may bind different pools / have or
        lack a memory target per instance — chunks group by the full
        signature), and per-flow [type_remote] conversions ``cnv``:
        fn(pools, idx) gathers, runs the body once on the stacks and
        scatters the written slots in place."""
        p = self.plans[ci]
        key = (k, statics, incols, outcols, wbflags, wbxcols, cnv)
        kern = p.kernels.get(key)
        if kern is not None:
            return kern
        spec = (ci, k, statics, incols, outcols, wbflags, wbxcols, cnv)
        if self._kernels_shareable:
            kern = self.dag.kernel_cache.get(spec)
            if kern is not None:
                p.kernels[key] = kern
                return kern
        kplans = self._kplans
        genv = self._trace_env
        call = _make_call_f(genv, kplans[ci], statics, cnv)

        def chunk_fn(pools, idx):
            staged = _gather_group_f(kplans, pools, spec, idx)
            _compute_scatter_f(genv, kplans, call, pools, spec, staged,
                               idx)
            return pools

        p.kernels[key] = chunk_fn
        if self._kernels_shareable:
            self.dag.kernel_cache[spec] = chunk_fn
        return chunk_fn

    def _fused_kernel(self, specs: Tuple):
        """ONE call for a whole wave (all classes, all groups): every
        group gathers from the PRE-WAVE pools first, then all bodies run
        and all scatters land. Because a wave is an antichain, no
        group's input depends on another's output, and gather-before-
        any-scatter gives every same-wave reader the pre-wave value —
        WAR semantics without sub-wave layering (and without its extra
        calls). Cached per wave signature."""
        kern = self._fused_kerns.get(specs)
        if kern is not None:
            return kern
        if self._kernels_shareable:
            kern = self.dag.kernel_cache.get(("fused", specs))
            if kern is not None:
                self._fused_kerns[specs] = kern
                return kern
        kplans = self._kplans
        genv = self._trace_env
        calls = [_make_call_f(genv, kplans[sp[0]], sp[2], sp[7])
                 for sp in specs]

        def wave_fn(pools, idxs):
            staged = [_gather_group_f(kplans, pools, sp, ix)
                      for sp, ix in zip(specs, idxs)]
            for sp, call, ix, st in zip(specs, calls, idxs, staged):
                _compute_scatter_f(genv, kplans, call, pools, sp, st, ix)
            return pools

        self._fused_kerns[specs] = wave_fn
        if self._kernels_shareable:
            self.dag.kernel_cache[("fused", specs)] = wave_fn
        return wave_fn

    @staticmethod
    def _chunks(k: int, max_chunk: int) -> List[int]:
        """Binary decomposition of k bounded by max_chunk: exact sizes
        from a fixed set, so cached closures are reused."""
        out = []
        while k >= max_chunk:
            out.append(max_chunk)
            k -= max_chunk
        b = 1
        while k:
            if k & 1:
                out.append(b)
            k >>= 1
            b <<= 1
        return out

    # ------------------------------------------------------------------ #
    # execution                                                          #
    # ------------------------------------------------------------------ #
    def _frontier_entries(self, ids: np.ndarray, classes: np.ndarray,
                          pools):
        """Break a frontier (or sub-wave) into chunk-call entries
        [(spec, arrays)] and estimate their total gather bytes.

        (No priority ordering: a wave is an antichain and every member
        executes before the next readiness update.) Body-referenced
        locals become static values, and guarded deps may bind
        different pools per instance: members group by (statics, pool
        signature)."""
        dag = self.dag
        entries = []
        total = 0
        for ci in np.unique(classes):
            members = ids[classes == ci]
            p = self.plans[int(ci)]
            nf = len(p.flow_idx)
            groups: Dict[Tuple, List[int]] = {}
            none_cnv = (None,) * nf
            for t in members:
                sv = tuple(int(dag.locals_of[t][i])
                           for i in p.body_locals)
                icl = tuple(int(c) for c in self._slot_coll[t, :nf])
                ocl = tuple(int(c) for c in self._slot_out_coll[t, :nf])
                wfl = tuple(bool(b) for b in self._wb_apply[t, :nf])
                xcl = tuple(int(c) for c in self._wbx_cid[t, :nf])
                cnv = (tuple(self._wconv.get((int(t), j))
                             for j in range(nf))
                       if self._wconv else none_cnv)
                groups.setdefault((sv, icl, ocl, wfl, xcl, cnv),
                                  []).append(int(t))
            for (statics, icl, ocl, wfl, xcl, cnv), g in groups.items():
                garr = np.asarray(g, np.int64)
                off = 0
                for k in self._chunks(len(garr), self.max_chunk):
                    chunk = garr[off:off + k]
                    off += k
                    idx_in = self._slot[chunk, :nf].T.copy()
                    idx_out = self._slot_out[chunk, :nf].T.copy()
                    idx_wbx = self._wbx_idx[chunk, :nf].T.copy()
                    if self._g2l is not None:
                        self._to_local_rows(nf, icl, ocl, xcl, idx_in,
                                            idx_out, idx_wbx)
                    spec = (int(ci), k, statics, icl, ocl, wfl, xcl, cnv)
                    entries.append((spec, {"idx_in": idx_in,
                                           "idx_out": idx_out,
                                           "idx_wbx": idx_wbx}))
                    for j in range(nf):
                        pl = pools[icl[j]]
                        total += k * int(np.prod(pl.shape[1:])) * \
                            pl.element_size()
        return entries, total

    def _to_local_rows(self, nf, icl, ocl, xcl, idx_in, idx_out,
                       idx_wbx) -> None:
        """Sliced pools (distributed): translate a chunk's global tile
        indices into this rank's pool rows, in place."""
        bad = False
        for j in range(nf):
            idx_in[j] = self._g2l[icl[j]][idx_in[j]]
            bad |= bool((idx_in[j] < 0).any())
            if ocl[j] >= 0:
                idx_out[j] = self._g2l[ocl[j]][idx_out[j]]
                bad |= bool((idx_out[j] < 0).any())
            if xcl[j] >= 0:
                idx_wbx[j] = self._g2l[xcl[j]][idx_wbx[j]]
                bad |= bool((idx_wbx[j] < 0).any())
        if bad:
            raise WaveError("sliced-pool translation hit a tile this rank "
                            "never staged (local-map construction bug)")

    @staticmethod
    def _trace_error(exc: Exception, label: str):
        """A body that branches in Python on a stacked tensor's value
        cannot run batched: name it instead of a bare torch error."""
        if isinstance(exc, RuntimeError) and "ambiguous" in str(exc):
            return WaveError(
                f"{label}: body cannot run on a batch (it branches on "
                f"a data value in Python); run this taskpool through the "
                f"per-task runtime")
        return None

    def _write_keys(self, t: int, p, k: int) -> List[Tuple[int, int]]:
        """The (pool, row) slots a task's written flow scatters into
        (out slot, plus the dual-output masked memory target)."""
        wkeys = [(int(self._slot_out_coll[t, k]),
                  int(self._slot_out[t, k]))]
        if int(self._wbx_cid[t, k]) >= 0:
            wkeys.append((int(self._wbx_cid[t, k]),
                          int(self._wbx_idx[t, k])))
        return wkeys

    def _check_two_writers(self, ids: np.ndarray,
                           classes: np.ndarray) -> None:
        """Two same-wave writers of one tile race regardless of call
        structure (the last scatter would win arbitrarily)."""
        writes: Dict[Tuple[int, int], int] = {}
        for pos, t in enumerate(ids):
            p = self.plans[int(classes[pos])]
            for k in range(len(p.flow_idx)):
                if not p.written[k]:
                    continue
                for key in self._write_keys(int(t), p, k):
                    prev = writes.get(key)
                    if prev is not None and prev != int(t):
                        raise WaveError(
                            f"frontier holds two writers of the same "
                            f"tile (tasks {prev} and {int(t)}): the "
                            f"DAG races — in-place scatters would "
                            f"keep an arbitrary one")
                    writes[key] = int(t)

    def _call_chunk(self, spec: Tuple, idx: _Idx, pools):
        try:
            return self._kernel(*spec)(pools, idx)
        except Exception as exc:
            werr = self._trace_error(exc, self.plans[spec[0]].ast.name)
            if werr is not None:
                raise werr from exc
            raise

    def _run_entries(self, entries, pools) -> Tuple[Any, int]:
        """Each entry as its own chunk call, in order."""
        idxs = _stage_indices(entries, pools[0].device)
        for (spec, _a), idx in zip(entries, idxs):
            pools = self._call_chunk(spec, idx, pools)
        return pools, len(entries)

    def _execute_frontier(self, ids: np.ndarray, classes: np.ndarray,
                          pools) -> Tuple[Any, int]:
        """Execute one ready antichain.

        Fused mode (default): the whole wave is ONE call — every group
        gathers from the pre-wave pools before any scatter lands, which
        amortizes per-call dispatch and gives WAR/cyclic-WAR frontiers
        their copy semantics for free (a single-entry wave gets the same
        semantics from its chunk closure directly — it, too, gathers
        before scattering). Fallbacks keep per-chunk calls with WAR
        sub-wave layering: waves whose gathers exceed
        ``wave_fuse_bytes`` (the gathered copies all live at once in a
        fused call) and waves beyond the ``wave_fuse_programs`` budget
        of cached fused closures."""
        entries = None
        if self._fuse:
            entries, gather_bytes = self._frontier_entries(
                ids, classes, pools)
            if gather_bytes <= self._fuse_bytes:
                if len(entries) == 1:
                    self._check_two_writers(ids, classes)
                    return self._run_entries(entries, pools)
                specs = tuple(e[0] for e in entries)
                if specs in self._fused_kerns or \
                        len(self._fused_kerns) < self._fuse_programs:
                    self._check_two_writers(ids, classes)
                    return self._call_fused(specs, entries, pools), 1
        n_calls = 0
        try:
            layers = self._split_war(ids, classes)
        except WaveError:
            if entries is None:
                raise       # fusion off: the layered contract stands
            # _split_war re-raises two-writer races via
            # _check_two_writers; if that passes, the failure was a
            # CYCLIC WAR frontier — only the fused gather-before-
            # scatter form can serve it, so correctness overrides the
            # fusion byte/program budgets
            self._check_two_writers(ids, classes)
            return self._call_fused(tuple(e[0] for e in entries),
                                    entries, pools), 1
        for sids, cls in layers:
            if len(layers) == 1 and entries is not None:
                sub_entries = entries
            else:
                sub_entries, _ = self._frontier_entries(sids, cls, pools)
            pools, nc = self._run_entries(sub_entries, pools)
            n_calls += nc
        return pools, n_calls

    def _call_fused(self, specs: Tuple, entries, pools):
        idxs = _stage_indices(entries, pools[0].device)
        try:
            return self._fused_kernel(specs)(pools, idxs)
        except Exception as exc:
            werr = self._trace_error(exc, "fused wave")
            if werr is not None:
                raise werr from exc
            raise

    def execute(self, pools):
        """Run the DAG over device tile pools (stacked tensors ordered
        by self.pool_names, shape-split per collection), updating them
        in place; returns the pools."""
        import time as _time

        pools = list(pools)
        dag = self.dag
        eng = make_engine(dag)
        ready = np.asarray(eng.start(), np.int32)
        n_waves = n_calls = 0
        t0 = _time.perf_counter()
        while ready.size:
            n_waves += 1
            pools, nc = self._execute_frontier(ready, dag.class_of[ready],
                                               pools)
            n_calls += nc
            ready = np.asarray(eng.complete_batch(ready), np.int32)
        done = eng.completed()
        if int(done) != dag.n_tasks:
            raise WaveError(
                f"wave execution stalled: {done}/{dag.n_tasks} tasks ran")
        # observability: the counters a profiler of the per-task path
        # would have shown (wave bypasses PINS sites by design —
        # dispatch is what it amortizes away); dispatch_secs is the host
        # time of the loop, which returns before the device finishes
        self.stats = {"tasks": dag.n_tasks, "waves": n_waves,
                      "kernel_calls": n_calls,
                      "dispatch_secs": round(_time.perf_counter() - t0, 6),
                      "compiled_kernels": sum(len(p.kernels)
                                              for p in self.plans)
                      + len(self._fused_kerns)}
        plog.debug.verbose(3, "wave %s: %s", self.tp.name, self.stats)
        return tuple(pools)

    def _split_war(self, ids: np.ndarray, classes: np.ndarray):
        """Split a frontier so no in-place scatter clobbers a same-wave
        read. Anti-dependence edges (reader R of a tile that a different
        frontier task W writes: R must run before W) are layered with
        Kahn's algorithm; each layer is anti-dep-free and executes as one
        batched sub-wave. A cyclic frontier (two tasks each reading the
        tile the other writes — legal dataflow, but unservable by
        in-place scatters) raises WaveError: run it through the per-task
        runtime, whose copies rename WAR hazards away."""
        self._check_two_writers(ids, classes)
        reads: Dict[Tuple[int, int], List[int]] = {}
        writes: Dict[Tuple[int, int], int] = {}
        for pos, t in enumerate(ids):
            p = self.plans[int(classes[pos])]
            for k in range(len(p.flow_idx)):
                # IN and OUT slots differ for renamed/cross-tile writes:
                # the read is against the in slot, the write against the
                # out slot (an RW flow is both)
                if p.reads[k] or not p.written[k]:
                    key = (int(self._slot_coll[t, k]), int(self._slot[t, k]))
                    reads.setdefault(key, []).append(int(t))
                if p.written[k]:
                    for key in self._write_keys(int(t), p, k):
                        writes[key] = int(t)
        out_edges: Dict[int, List[int]] = {}
        indeg: Dict[int, int] = {int(t): 0 for t in ids}
        n_conf = 0
        for key, ts in reads.items():
            w = writes.get(key)
            if w is None:
                continue
            for r in ts:
                if r == w:
                    continue
                out_edges.setdefault(r, []).append(w)
                indeg[w] += 1
                n_conf += 1
        if n_conf == 0:
            return [(ids, classes)]
        cls_of = {int(t): int(c) for t, c in zip(ids, classes)}
        layer = [t for t in indeg if indeg[t] == 0]
        done = 0
        layers = []
        while layer:
            layers.append(layer)
            done += len(layer)
            nxt: List[int] = []
            for t in layer:
                for w in out_edges.get(t, ()):
                    indeg[w] -= 1
                    if indeg[w] == 0:
                        nxt.append(w)
            layer = nxt
        if done != len(ids):
            raise WaveError(
                "frontier has cyclic write-after-read conflicts; this DAG "
                "needs the per-task runtime (copies rename WAR hazards)")
        return [(np.asarray(ls, np.int64),
                 np.asarray([cls_of[t] for t in ls], np.int32))
                for ls in layers]

    # ------------------------------------------------------------------ #
    # convenience: run against the bound collections                     #
    # ------------------------------------------------------------------ #
    def build_pools(self, device=None, sharding=None) -> Tuple:
        """Stage each collection as stacked ``[n_tiles, mb, nb]``
        tensors on ``device`` (None: the device module's device, cuda:0
        unless ``device_cuda_platform`` names another; raising without a
        card),
        one per shape-split pool (self.pool_names order), each tile
        copied from its host copy straight into its pool row; scratch
        pools are zeroed on the device, never staged.
        ``self.stage_in_bytes`` holds the host bytes moved."""
        if sharding is not None:
            raise NotImplementedError(
                "build_pools(sharding=...): wave pools split across chips "
                "are SPMD (ROADMAP Queue 1, part D2b)")
        device = resolve_device(device)
        pools = []
        staged = 0
        for pid, name in enumerate(self.pool_names):
            if pid not in self._used_colls:
                pools.append(torch.zeros((0,), device=device))  # placeholder
                continue
            coll = self.collections[name]
            tiles = [np.asarray(coll.data_of(*c).sync_to_host().payload)
                     for c in self._pool_coords[pid]]
            pool = torch.empty((len(tiles),) + tiles[0].shape,
                               dtype=_torch_dtype(tiles[0].dtype),
                               device=device)
            for i, t in enumerate(tiles):
                if t.shape != tiles[0].shape:
                    raise WaveError(
                        f"{name}: tiles {tiles[0].shape} and {t.shape} in "
                        f"one pool; a ragged tiling needs tile_shape")
                pool[i].copy_(torch.from_numpy(np.ascontiguousarray(t)))
                staged += t.nbytes
            pools.append(pool)
        # scratch pools (NEW flows + write renames): zeroed each run, ids
        # after real collections; rename pools copy tile shape/dtype
        # from the pool they rename ("like" — already built: its cid is
        # always smaller)
        for cnt, shape, dt in self._scratch_specs(pools):
            pools.append(torch.zeros((cnt,) + shape, dtype=dt,
                                     device=device))
        self.stage_in_bytes = staged
        self.device = device
        return tuple(pools)

    def _scratch_specs(self, pools) -> List[Tuple[int, Tuple, Any]]:
        """(count, tile_shape, torch dtype) per scratch pool in cid order
        — the single authority for scratch layout (build_pools and
        synth_pools both consume it)."""
        specs = []
        for sp in sorted(self._scratch.values(), key=lambda s: s["cid"]):
            if sp["shape"] is not None:
                specs.append((sp["n"], tuple(sp["shape"]),
                              _torch_dtype(sp["dtype"])))
            else:
                like = pools[sp["like"]]
                specs.append((sp["n"], tuple(like.shape[1:]), like.dtype))
        return specs

    def synth_pools(self, tile_fn=None, device=None, pool_fn=None) -> Tuple:
        """Build pools ON the device with no host staging (benchmarks
        generate their inputs from a seed), in build_pools' layout. Two
        granularities:

        - ``tile_fn(coll_name, coord) -> tensor``, one tile at a time;
        - ``pool_fn(coll_name, coords) -> stacked [len(coords), ...]``,
          a whole pool in one expression.

        Pool/scratch layout is identical to :meth:`build_pools` by
        construction (same pool walk, same :meth:`_scratch_specs`)."""
        if (tile_fn is None) == (pool_fn is None):
            raise ValueError("pass exactly one of tile_fn / pool_fn")
        device = resolve_device(device)
        pools = []
        for pid, name in enumerate(self.pool_names):
            if pid not in self._used_colls:
                pools.append(torch.zeros((0,), device=device))
                continue
            coords = self._pool_coords[pid]
            if pool_fn is not None:
                pool = pool_fn(name, coords)
            else:
                pool = torch.stack([tile_fn(name, c) for c in coords])
            pools.append(pool.to(device).contiguous())
        for cnt, shape, dt in self._scratch_specs(pools):
            pools.append(torch.zeros((cnt,) + shape, dtype=dt,
                                     device=device))
        return tuple(pools)

    def scatter_pools(self, pools: Tuple) -> None:
        """Write the rows some task wrote back into their tiles' host
        copies: one device-to-host copy per pool of those rows (the
        others' home copies stand)."""
        for pid, rows in self._written_rows.items():
            if pid >= self._n_real_colls:
                continue  # scratch: no home tile
            coll = self.collections[self.pool_names[pid]]
            idx = torch.from_numpy(rows.astype(np.int64)).to(
                pools[pid].device)
            host = pools[pid].index_select(0, idx).cpu().numpy()
            for i, r in enumerate(rows):
                data = coll.data_of(*self._pool_coords[pid][r])
                hc = data.host_copy()
                if hc.payload is None:
                    hc.payload = host[i].copy()
                else:
                    np.copyto(hc.payload, host[i])
                data.version_bump(0)

    def run(self, device=None) -> None:
        """Stage in, execute, write back; ``device`` None is cuda:0
        (raising without a card), "cpu" the host."""
        pools = self.execute(self.build_pools(device))
        self.scatter_pools(pools)

    @property
    def nb_tasks(self) -> int:
        return self.dag.n_tasks


def wave(tp: PTGTaskpool, max_chunk: int = 256, comm=None) -> WaveRunner:
    """Build a wave-mode executor.  Single-rank taskpools get the local
    WaveRunner; multi-rank taskpools (or an explicit ``comm``) get the
    distributed runner (wave_dist.py), which partitions the DAG by the
    data distribution and exchanges tiles between waves."""
    if tp.nb_ranks != 1 or comm is not None:
        from .wave_dist import DistWaveRunner
        return DistWaveRunner(tp, max_chunk=max_chunk, comm=comm)
    return WaveRunner(tp, max_chunk=max_chunk)
