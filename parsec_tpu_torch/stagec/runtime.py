"""Runtime integration: execute compiled stages as single chores
interleaved with the interpreted residue.

A :class:`StageCompiler` attaches to a ``PTGTaskpool`` at startup when
the ``stage_compile`` MCA knob is on.  Each compilable stage becomes
ONE synthetic task on the ordinary runtime: its flows are the stage's
packed slots, its chore is the stage's recorded program (one CUDA
graph, :class:`StageProgram`; or the wave-front variant that spreads
the stage's rows over the rank's chip mesh, stagec/sharded.py), and it
rides the untouched scheduler / CUDA device module / eager-completion
machinery — stage-in, memory accounting, priorities and the eager
release window apply to a stage exactly as they do to a single task.

Dynamic dependency tracking for stages piggybacks on the existing
activation protocol: ``PTGTaskClass.activate`` consults the compiler
first (``on_activate``), so activations from local residue tasks,
other stages, AND remote ranks all count toward a stage's external
goal without any wire-format change; when the counter hits zero the
stage task spawns (its graph recorded right there, once per stage
signature) and is scheduled like any ready task.  On completion the
stage's release walk reuses each member's untouched ``_release_deps``
— remote activations batch per rank, memory writebacks ride the device
epilog — with intra-stage edges swallowed by the same ``on_activate``
seam.

Recording is the "forced trace" of this package: at spawn the stage
function (stagec/lower.build_stage_fn) warms up on a side stream and
records into a ``torch.cuda.CUDAGraph`` over zero-filled static slot
buffers of the stage's shapes (``dsl/graph.GraphRunner``); every replay
copies the real slots in, replays the graph with one host call, and
hands the written tiles back.  Every GEMM and SYRK body of a stage is
the hand-written GEMM kernel (``csrc/matmul.cu``).  A record's warm-up
launches it through its wrapper (counted); the launches captured into
the graph are counted too but run only in replays, and a replay re-runs
them without counting.  Both are counted on the recording thread alone,
so residue tasks launching meanwhile from other workers stay out of
them: each program keeps its ``warmup_gemm_launches``, its
``captured_gemm_launches`` and its ``replays``.  Recording calls
``torch.cuda.synchronize`` on the device twice: it waits for the
card, not for any host lock, so it cannot deadlock against a worker
that holds one, but it does stall every stream of the device while
residue tasks launch (once per stage signature).  On the CPU
(``device="cpu"``) a stage runs its function eagerly over host tensors
with each kernel's plain version.

**Donation** (``stage_compile_donate``, default on): a replay writes
the results of the WRITE slots into the slot's own device tensor
(``copy_``) instead of a fresh clone, saving one allocation per
written tile.  It applies only to stages whose member classes the
BDY204 analysis proves free of intra-stage tile aliasing, and only to
a dispatch whose slots are distinct tensors.  The epilog bumps the
tile's version, so no reader sees a stale payload.

Also behind the same knob:

- **Cross-pool chaining** (stagec/chain.py): when the context carries
  a declared chain, the host pool's final stage records the CHAINED
  program (host stage + rider stages of later pools) and the rider
  pools CONSUME their pre-computed stage outputs at startup
  (``consume_chain``) — zero dispatch, tiles stay device-resident.
- **Compiled residue schedule**: residue tasks in a pre-planned
  per-(level, class) group (``plan.residue_groups``) are BUFFERED as
  they become ready and handed to the device batching pipeline as one
  contiguous burst when the group completes.
- **Prestage/execute overlap**: buffered activation payloads stage to
  the card at ARRIVAL, a spawning stage's own host-resident tiles
  stage before its record, and completed stages prestage the next
  pending stages' final-valued tiles — through the device module's
  prefetch seam (``CudaDevice.prestage_data``), bounded by
  ``device_prefetch_depth``, counted in ``prestage_issued`` /
  ``prestage_hits``.

Fallback ladder (semantics are never at risk):

1. a class the lowerability pass rejects stays interpreted (residue);
2. a stage whose body cannot be recorded (:class:`~..dsl.graph.
   CaptureError`: a host sync, a data-dependent branch) DOWNGRADES —
   its buffered activations replay through the normal dynamic path and
   its members execute through the batched dispatch (on the card, with
   the same GEMM kernel), permanently but only for that stage (the
   failure is cached; ``stage_fallbacks`` counts it).  Any other error
   raises: a kernel that fails to build or to launch, or an error
   inside a body;
3. a chained program that fails to record falls back to the host-only
   program (riders spawn normally from their own pools;
   ``chain_fallbacks``);
4. (the JAX package's sharded-to-single-chip fallback) is not carried:
   a sharded build or dispatch that fails RAISES, as the device
   module's sharded batched dispatch does.  Only a wave front the
   planner deems ineligible (a member count the chips do not divide, a
   shared slot, a NEW or NULL binding) takes the single-chip graph;
5. ``stage_compile`` unset: ``tp._stagec`` is None and behavior is
   bit-for-bit the pre-stagec runtime.

**Cross-rank SPMD stages** (``stage_compile_xrank``, stagec/xrank.py):
with several ranks in one process, a planned wave front whose members
span ranks runs as ONE program over the ranks' lane chips — each rank's
rows one CUDA graph recorded on its lane chip at spawn, the boundary
tiles gathered device to device — and the activations of those edges
carry control only.  A rank whose stage downgrades declines the wave
(its peers run their rows rank-local, ``xstage_fallbacks``); any other
failure of the wave raises on every participant.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.data import Coherency, Data, DataCopy, FlowAccess
from ..devices.batching import STAGE_FAILED as _FAILED
from ..dsl.graph import CaptureError, GraphRunner
from ..obs.spans import inbound_flow_ctx
from ..runtime.taskpool import (ACTION_RELEASE_ALL, Chore, Flow, Task,
                                TaskClass)
from ..utils import logging as plog
from ..utils.params import params
from .lower import (StageLayout, build_layout, build_stage_fn,
                    spec_token, stage_signature)
from .plan import StagePlan, plan_stages

#: declared lock discipline (analysis/lock_check.py): a stage record's
#: dependency counter, buffered activation events, and lifecycle status
#: are mutated from worker threads AND the comm delivery path — every
#: access goes through the record's own lock.  ``edge_copies`` is
#: single-owner by lifecycle (written by the dispatching manager, read
#: by the completing worker's release walk, ordered by the task
#: lifecycle) and deliberately unregistered.  A program's replay
#: ordering event belongs to the program's lock.
_GUARDED_BY = {
    "_StageRec.remaining": "_lock",
    "_StageRec.events": "_lock",
    "_StageRec.status": "_lock",
    "_StageRec.flow_ctxs": "_lock",
    "StageCompiler._rg_left": "_rg_lock",
    "StageCompiler._rg_buf": "_rg_lock",
    "StageProgram._done": "_lock",
    "StageCompiler._xorder": "_xlock",
    "StageCompiler._xheld": "_xlock",
}

# _StageRec lifecycle
_PENDING, _SPAWNED, _DONE, _DOWNGRADED = range(4)

#: consume_chain sentinel: no stash entry AT ALL (the host program
#: never ran) — distinct from a None marker (the host fell back and
#: already counted the fallback)
_NO_STASH = object()


class StageProgram:
    """The recorded program of one stage signature: ``run`` (the stage
    function of stagec/lower.py, or a chained one) recorded once per
    torch device as one CUDA graph (``dsl/graph.GraphRunner``) and
    replayed per dispatch; on the CPU, ``run`` eagerly.

    ``out_slots`` are the slot indices of the written tiles (the first
    ``len(out_slots)`` outputs of ``run``); the remaining ``n_edges``
    outputs are edge live-outs.  Facts for the caller: ``graphs``
    (device -> GraphRunner: ``captured_gemm_launches``, ``replays``,
    ``capture_seconds``, ``replay_ms``) and ``record_seconds``."""

    def __init__(self, run, name: str, n_slots: int,
                 out_slots: List[int], n_edges: int,
                 replay_stream: Any = None) -> None:
        self.run_fn = run
        #: the stream replays run on (the device module's): records
        #: capture on its own stream (dsl/graph.own_stream)
        self.replay_stream = replay_stream
        self.name = name
        self.n_slots = n_slots
        self.out_slots = list(out_slots)
        self.n_edges = n_edges
        self.graphs: Dict[str, GraphRunner] = {}
        self.record_seconds = 0.0
        self._lock = threading.Lock()
        self._done = None   # event after the last replay's copy-out

    # the GraphRunner's view: a state dict of slots -> outputs
    def _execute(self, state, device, note):
        outs = self.run_fn(*[state[i] for i in range(self.n_slots)],
                           device=device, note=note)
        res = dict(state)
        nt = len(self.out_slots)
        for j, si in enumerate(self.out_slots):
            res[si] = outs[j]
        for j in range(self.n_edges):
            res[("e", j)] = outs[nt + j]
        return res

    def _written(self) -> List[Any]:
        return self.out_slots + [("e", j) for j in range(self.n_edges)]

    def graph_on(self, device) -> GraphRunner:
        key = str(device)
        gr = self.graphs.get(key)
        if gr is None:
            gr = GraphRunner(self._execute, self.name, self._written)
            self.graphs[key] = gr
        return gr

    def record(self, shapes: Tuple, device) -> None:
        """Warm up and record on ``device`` over zero-filled slots of
        ``shapes`` (a CUDA device; nothing to record on the CPU), for
        replays on the program's ``replay_stream``.  A body that cannot
        be recorded raises :class:`CaptureError`."""
        import torch
        device = torch.device(device)
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        zeros = {i: torch.zeros(s, dtype=getattr(torch, d), device=device)
                 for i, (s, d) in enumerate(shapes)}
        self.graph_on(device).record(zeros, device, self.replay_stream)
        self.record_seconds += time.perf_counter() - t0

    def replay(self, arrays: List[Any], device,
               donate: bool) -> Tuple[List[Any], List[Any]]:
        """Run the program on the slot tensors ``arrays`` (on
        ``device``); returns ``(tile_outs, edge_outs)``.  With
        ``donate`` the tile results are written into their slots' own
        tensors."""
        import torch
        device = torch.device(device)
        nt = len(self.out_slots)
        if device.type != "cuda":
            outs = list(self.run_fn(*arrays, device=device))
            tiles, edges = outs[:nt], outs[nt:]
            if donate:
                tiles, edges = _donate_eager(arrays, self.out_slots,
                                             tiles, edges)
            return tiles, edges
        gr = self.graph_on(device)
        with self._lock:
            cur = torch.cuda.current_stream(device)
            if self._done is not None:
                # a replay from another stream: its copy-out first
                cur.wait_event(self._done)
            out = gr.run({i: a for i, a in enumerate(arrays)}, device,
                         donate=donate)
            ev = torch.cuda.Event()
            ev.record(cur)
            self._done = ev
        return ([out.get(si) for si in self.out_slots],
                [out.get(("e", j)) for j in range(self.n_edges)])

    @property
    def captured_gemm_launches(self) -> int:
        return sum(g.captured_gemm_launches or 0
                   for g in self.graphs.values())

    @property
    def warmup_gemm_launches(self) -> int:
        return sum(g.warmup_gemm_launches or 0
                   for g in self.graphs.values())

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())

    def facts(self) -> Dict[str, Any]:
        """Recording facts: the GEMM kernel's launches of the records'
        warm-ups (real launches, counted) and those captured in the
        graphs (run by each replay, uncounted), replays, record seconds
        and the last replay's device time."""
        last = None
        for g in self.graphs.values():
            if g.replays:
                last = g.replay_ms
        return {"warmup_gemm_launches": self.warmup_gemm_launches,
                "captured_gemm_launches": self.captured_gemm_launches,
                "replays": self.replays,
                "record_seconds": self.record_seconds,
                "replay_ms": last, "sharded": False}


def _shares(a: Any, b: Any) -> bool:
    import torch
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


def _donate_eager(arrays, out_slots, tiles, edges):
    """CPU donation: copy each tile result into its slot's tensor.  A
    result or edge that shares memory with a donated slot is cloned
    first, so no copy overwrites a value still to be handed out."""
    dsts = [arrays[si] for si in out_slots]
    tiles = [t.clone() if any(_shares(t, d) and t is not d for d in dsts)
             else t for t in tiles]
    edges = [e.clone() if any(_shares(e, d) for d in dsts) else e
             for e in edges]
    out = []
    for t, d in zip(tiles, dsts):
        if t is d or t is None or getattr(d, "shape", None) != t.shape \
                or d.dtype != t.dtype:
            out.append(t)
        else:
            out.append(d.copy_(t))
    return out, edges


class _StageRec:
    """One stage's dynamic state on one taskpool."""

    def __init__(self, stage, layout: StageLayout, priority: int) -> None:
        self.stage = stage
        self.layout = layout
        self.priority = priority
        self._lock = threading.Lock()
        self.remaining = layout.goal
        self.events: List[Tuple] = []   # (member_key, flow, copy) buffered
        # wire trace contexts of the remote activations that fed this
        # stage (only collected while a profile is live) — stamped onto
        # the stage task's exec span so the merged timeline can
        # attribute the stage's span to its cross-rank inputs
        self.flow_ctxs: List[Tuple] = []
        self.status = _PENDING
        self.fn: Optional[StageProgram] = None
        self.sharded = None             # WavefrontProgram or None
        self.task: Optional[Task] = None
        self.edge_copies: Dict[Tuple, Any] = {}
        self.shapes: Tuple = ()
        self.donate = False
        self.chain = None               # HostChain when this rec hosts
        self.xwave = None               # XWave when this rec joins one
        self.xblock = None              # its recorded block (xrank.XBlock)
        self.xfail = None               # why its block failed to build
        #: Data objects prestaged for this stage and not yet counted
        #: (single-owner by lifecycle: the buffering/spawn path)
        self.prestaged: List[Any] = []


class StageTaskClass(TaskClass):
    """The synthetic task class of ONE compiled stage: flows are the
    stage's packed slots.  Never registered on the taskpool's
    ``task_classes`` (remote activation ids index that list), so the
    wire protocol is untouched.  ``mesh_wide`` marks a stage that spreads
    over the chip mesh: the device module then stages each slot on its
    own chip and launches nothing on a home chip of its own."""

    def __init__(self, compiler: "StageCompiler", rec: _StageRec) -> None:
        lay = rec.layout
        flows: List[Flow] = []
        for i, ((coll, coords), access) in enumerate(lay.mem_slots):
            flows.append(Flow(f"{coll}{coords}", access, i))
        base = len(lay.mem_slots)
        for j, (mkey, fname) in enumerate(lay.act_slots):
            flows.append(Flow(f"{mkey[0]}{mkey[1]}.{fname}",
                              FlowAccess.READ, base + j))
        if rec.chain is not None:
            # chained host stage: the riders' extra tiles join the
            # packed slots as READ flows after the act slots
            base = len(flows)
            for j, (coll, coords) in enumerate(rec.chain.extra):
                flows.append(Flow(
                    f"chain:{getattr(coll, 'name', 'tile')}{coords}",
                    FlowAccess.READ, base + j))
        super().__init__(f"STAGE{rec.stage.index}[{compiler.tp.name}]",
                         -1 - rec.stage.index, len(flows), flows=flows)
        from ..devices.cuda import cuda_chore_hook
        self.incarnations = [Chore("cuda", cuda_chore_hook(),
                                   dyld_fn=compiler._make_dyld(rec))]
        self.mesh_wide = rec.sharded is not None
        self.release_deps = \
            lambda es, task, mask, c=compiler, r=rec: c._release(es, r)
        # one stage completion retires every member task's count (the
        # final unit comes from complete_execution's own decrement)
        n = rec.stage.n_tasks
        if n > 1:
            self.complete_execution = \
                lambda es, task, tp=compiler.tp: tp.task_completed(n - 1)


class StageCompiler:
    """Per-taskpool stage-compile engine (``tp._stagec``)."""

    def __init__(self, tp, context, plan: StagePlan) -> None:
        self.tp = tp
        self.context = context
        self.plan = plan
        self.stats = context.stage_stats
        # span-context collection only while a profile is live: the
        # activate redirect is a hot path
        self._trace_on = context.profile is not None
        from .lower import spec_codes
        self._codes = spec_codes(tp)
        self._token = spec_token(tp)
        # donation inside compiled stages, EXCEPT for stages whose
        # member classes carry a BDY204 verdict (two flows read the
        # same tile)
        self._donate_default = bool(params.get("stage_compile_donate"))
        self._bdy_aliased: set = set()
        if self._donate_default:
            from ..analysis.body_check import check_jdf_bodies
            from .plan import _finding_class
            self._bdy_aliased = {
                _finding_class(f) for f in check_jdf_bodies(tp.jdf)
                if f.code == "BDY204"}
        self._dev = next(d for d in context.devices
                         if d.device_type == "cuda")
        # the chip mesh, when this rank's device module is one:
        # wave-front stages then run their rows over its chips
        self._mesh_dev = (self._dev if getattr(self._dev, "mesh", None)
                          is not None and len(getattr(self._dev, "chips",
                                                      ())) > 1 else None)
        self._recs: List[_StageRec] = []
        self._member_rec: Dict[Tuple, _StageRec] = {}
        self._rec_by_index: Dict[int, _StageRec] = {}
        for stage, layout, prio in plan.prepared:
            rec = _StageRec(stage, layout, prio)
            self._recs.append(rec)
            self._rec_by_index[stage.index] = rec
            for m in stage.members:
                self._member_rec[m.key] = rec

        # cross-pool chaining (stagec/chain.py): does this pool HOST a
        # chained program, or CONSUME a stash?  A rider may contribute a
        # multi-stage prefix: one rec per fused link, in stage order,
        # all-or-nothing
        self._consume_recs: List[_StageRec] = []
        chain_state = getattr(context, "_stage_chain", None)
        if chain_state is not None:
            # pop: the HostChain moves onto the rec, so the registry
            # entry (and eventually the pool's strong ref) can retire
            hc = chain_state.hosts.pop(id(tp), None)
            if hc is not None:
                host_rec = self._rec_by_index.get(hc.host_stage_index)
                if host_rec is not None:
                    host_rec.chain = hc
            links = chain_state.consumes.get(id(tp))
            if links:
                recs = []
                for link in links:
                    rec0 = self._rec_by_index.get(link.stage.index)
                    if rec0 is None or rec0.stage is not link.stage:
                        recs = []
                        break
                    recs.append(rec0)
                self._consume_recs = recs

        # compiled residue schedule: per-(level, class) groups
        # pre-planned by the lowerability pass — ready members buffer
        # here and dispatch as ONE device burst when complete
        self._rg_lock = threading.Lock()
        self._rg_of: Dict[Tuple, int] = {}
        self._rg_left: List[int] = []
        self._rg_buf: List[List[Task]] = []
        self._rg_host: List[bool] = []
        if params.get("stage_residue_batch") and \
                (plan.residue_groups or plan.residue_groups_host):
            eligible = {
                tc.ast.name for tc in tp.task_classes
                if any(c.device_type == "cuda" and c.dyld_fn is not None
                       for c in tc.incarnations)}
            host_ok = {
                tc.ast.name for tc in tp.task_classes
                if any(c.device_type == "cpu" for c in tc.incarnations)}
            for host, groups in ((False, plan.residue_groups),
                                 (True, plan.residue_groups_host)):
                for keys in groups:
                    if keys[0][0] not in (host_ok if host else eligible):
                        continue
                    gi = len(self._rg_left)
                    self._rg_left.append(len(keys))
                    self._rg_buf.append([])
                    self._rg_host.append(host)
                    for k in keys:
                        self._rg_of[k] = gi

        # prestage/execute overlap: early stage-in of stage inputs
        # through the device module's prefetch seam, bounded by
        # device_prefetch_depth stages with outstanding prestages
        self._prestage_depth = int(getattr(self._dev, "prefetch_depth",
                                           0))
        self._prestage_recs: set = set()

        # cross-rank SPMD stages (stagec/xrank.py): negotiate "xs" with
        # every spanning peer, check the lane chips, exchange and assert
        # the plan digest, wire the planned waves onto their stage recs.
        # A peer without "xs", a missing digest or an epoch skew keeps
        # every stage rank-local; a diverging digest or lane chips that
        # are not distinct raise
        self._xrank = None
        self._lanes = None
        if plan.xwaves:
            from .xrank import install_xrank
            install_xrank(self)
        # the rank's cross-rank waves dispatch in wave-id order, every
        # rank alike: a wave's rendezvous holds the device manager, so
        # two ranks that entered different waves first would each wait
        # for the other.  A stage task whose turn has not come is held
        # here until the waves before it have dispatched (a later wave
        # never feeds an earlier one: ids follow levels)
        self._xlock = threading.Lock()
        self._xorder: List[_StageRec] = sorted(
            (r for r in self._recs if r.xwave is not None),
            key=lambda r: r.xwave.wave_id)
        self._xheld: Dict[int, Task] = {}

    def _count(self, **inc: int) -> None:
        """Add to the context's stage counters: worker threads, rank
        threads and the comm path count concurrently."""
        with self.context.stage_stats_lock:
            for k, v in inc.items():
                self.stats[k] += v

    def _tc(self, inst):
        """The LIVE taskpool's class for a (possibly cached-plan)
        instance: plans are cached per spec token across taskpools, so
        ``inst.tc`` may belong to an earlier pool — every runtime
        action rebinds by name."""
        return self.tp.class_by_name(inst.tc.ast.name)

    # ------------------------------------------------------------------ #
    # dependency tracking: the activate redirect                         #
    # ------------------------------------------------------------------ #
    def on_activate(self, tc, locals_: Tuple, flow_name: str,
                    copy) -> Tuple[bool, Optional[Task]]:
        """Called by ``PTGTaskClass.activate`` before its own dynamic
        dep table.  Returns ``(handled, ready_task)``; handled=False
        passes through to the interpreted path (non-members and
        downgraded stages)."""
        rec = self._member_rec.get((tc.ast.name, locals_))
        if rec is None:
            return False, None
        spawn = False
        with rec._lock:
            if rec.status == _DOWNGRADED:
                return False, None
            if rec.status != _PENDING:
                # an intra-stage edge emitted by the release walk of
                # this very stage: already computed inside the stage's
                # program — swallow
                return True, None
            rec.events.append(((tc.ast.name, locals_), flow_name, copy))
            if self._trace_on:
                # which wire flow (if any) delivered this activation:
                # remote_dep publishes the inbound context thread-
                # locally around the activation walk (obs/spans.py)
                fctx = inbound_flow_ctx()
                if fctx is not None:
                    rec.flow_ctxs.append(fctx)
            rec.remaining -= 1
            assert rec.remaining >= 0, \
                f"{tc.ast.name}{locals_}: stage overshoot"
            if rec.remaining == 0:
                rec.status = _SPAWNED   # claim; build outside the lock
                spawn = True
        if not spawn:
            # prestage the buffered payload NOW: the stage still awaits
            # other inputs, so its copy overlaps whatever is producing
            # them (the executing stage / the wire)
            self._prestage_activation(rec, copy)
            return True, None
        tasks = self._xgate(self._spawn(rec))
        if not tasks:
            return True, None
        if len(tasks) > 1:
            from ..runtime.scheduling import schedule
            schedule(self.context.execution_streams[0], tasks[1:])
        return True, tasks[0]

    def startup_tasks(self) -> List[Task]:
        """Stages with no external task inputs are startup tasks.  A
        stage another pool's chained program pre-computes stays PENDING
        here — ``consume_chain`` finalizes (or falls back) after the
        taskpool's counts are credited."""
        out: List[Task] = []
        for rec in self._recs:
            if rec in self._consume_recs:
                continue
            with rec._lock:
                if rec.status != _PENDING or rec.remaining > 0:
                    continue
                rec.status = _SPAWNED
            out.extend(self._spawn(rec))
        return self._xgate(out)

    # ------------------------------------------------------------------ #
    # cross-rank waves: one dispatch order on every rank                 #
    # ------------------------------------------------------------------ #
    def _xgate(self, tasks: List[Task]) -> List[Task]:
        """``tasks`` less the cross-rank stage tasks whose turn has not
        come: those wait in ``_xheld`` for :meth:`_xdone`."""
        out = []
        with self._xlock:
            for t in tasks:
                rec = getattr(t, "user", None)
                if not isinstance(rec, _StageRec) or rec.xwave is None \
                        or not self._xorder or self._xorder[0] is rec:
                    out.append(t)
                else:
                    self._xheld[id(rec)] = t
        return out

    def _xdone(self, rec: _StageRec) -> None:
        """``rec`` dispatched, or left its wave: the next wave's stage
        task, if it is already waiting, goes to the scheduler."""
        ready = []
        with self._xlock:
            if rec in self._xorder:
                self._xorder.remove(rec)
            # a wave the rank left (its stage downgraded) has no turn
            while self._xorder and self._xorder[0].xwave is None:
                self._xorder.pop(0)
            if self._xorder:
                t = self._xheld.pop(id(self._xorder[0]), None)
                if t is not None:
                    ready.append(t)
        if ready:
            from ..runtime.scheduling import schedule
            schedule(self.context.execution_streams[0], ready)
            self.context.wake_workers(len(ready))

    # ------------------------------------------------------------------ #
    # cross-pool chaining: consume a stashed rider stage                 #
    # ------------------------------------------------------------------ #
    def consume_chain(self, es) -> List[Task]:
        """Finalize this pool's chained-in stages: adopt the stashed
        device outputs as the newest tile copies, run each stage's
        release walk, retire its members' counts.  Called by
        ``PTGTaskpool._startup`` AFTER the task counts are credited (a
        completion before ``set_nb_tasks`` would go negative).  A
        missing stash (the host program downgraded, or never ran)
        falls back to spawning the stages normally."""
        recs = self._consume_recs
        if not recs:
            return []
        self._consume_recs = []
        st = getattr(self.context, "_stage_chain", None)
        stash = st.stash.pop(id(self.tp), _NO_STASH) if st is not None \
            else _NO_STASH
        if st is not None:
            st.consumes.pop(id(self.tp), None)
        if isinstance(stash, list) and len(stash) != len(recs):
            # the host recorded a different prefix than this pool fused
            # (stale registry entry): dispatch everything normally
            stash = _NO_STASH
        if stash is None or stash is _NO_STASH:
            if stash is _NO_STASH:
                # the host program never ran at all (downgrade, knob
                # change); a None marker means the host already fell
                # back — and already counted the fallback
                self._count(chain_fallbacks=1)
            plog.debug.verbose(
                2, "stagec chain: %s found no stash for stage %d; "
                "dispatching it normally", self.tp.name,
                recs[0].stage.index)
            out: List[Task] = []
            for rec in recs:
                # later prefix recs with remaining > 0 stay PENDING and
                # spawn through the ordinary activation path
                with rec._lock:
                    if rec.status != _PENDING or rec.remaining > 0:
                        continue
                    rec.status = _SPAWNED
                out.extend(self._spawn(rec))
            return out
        # mark EVERY fused rec spawned up front: an earlier rec's
        # release walk must not re-dispatch a later fused rec through
        # the activation path (its activations are in-program)
        for rec in recs:
            with rec._lock:
                rec.status = _SPAWNED
        ready: List[Task] = []
        total = 0
        for rec, part in zip(recs, stash):
            lay = rec.layout
            for arr, si in zip(part["tiles"], lay.out_mem):
                (coll_name, coords), _a = lay.mem_slots[si]
                data = self.tp.global_env[coll_name].data_of(*coords)
                self._dev.adopt_output(data, arr)
            for ek, arr in zip(lay.edge_outs, part["edges"]):
                if arr is not None:
                    rec.edge_copies[ek] = _edge_copy(arr)
            n = rec.stage.n_tasks
            self._count(chain_links=1, stage_tasks=n)
            self._dev.stats["tasks"] += n
            ready.extend(self._release(es, rec))
            self.tp.task_completed(n)
            total += n
        plog.debug.verbose(
            3, "stagec chain: %s consumed %d stage(s) (%d task(s)) "
            "from the chained program", self.tp.name, len(recs), total)
        return ready

    # ------------------------------------------------------------------ #
    # compiled residue schedule                                          #
    # ------------------------------------------------------------------ #
    def on_residue_ready(self, task: Task) -> Optional[Task]:
        """A residue task just became ready (``PTGTaskClass.activate``
        routes every non-member spawn here).  Members of a pre-planned
        residue group BUFFER; the completed group is handed to the
        device batching pipeline as one contiguous burst — no per-task
        scheduler round-trip, and the burst flushes as stacked calls.
        Non-grouped tasks pass through untouched."""
        gi = self._rg_of.get((task.task_class.ast.name, task.locals))
        if gi is None:
            return task
        with self._rg_lock:
            self._rg_buf[gi].append(task)
            self._rg_left[gi] -= 1
            if self._rg_left[gi] > 0:
                return None
            group, self._rg_buf[gi] = self._rg_buf[gi], []
        if self._rg_host[gi]:
            self._dispatch_host_group(group)
        else:
            self._dispatch_residue_group(group)
        return None

    def _dispatch_residue_group(self, tasks: List[Task]) -> None:
        """Hand one complete residue group straight to the device:
        inputs bound (prepare_input), the CUDA chore selected, every
        task pushed onto the device queue back to back — the next
        manager flush drains them as ONE burst through the stacked
        dispatch.  No scheduler enqueue/select per task."""
        es0 = self.context.execution_streams[0]
        dev = self._dev
        self._count(residue_batches=1, residue_batch_tasks=len(tasks))
        for task in tasks:
            tc = task.task_class
            if tc.prepare_input is not None:
                tc.prepare_input(es0, task)
            task.selected_chore = next(
                i for i, c in enumerate(tc.incarnations)
                if c.device_type == "cuda")
            task.selected_device = dev
            est = (tc.time_estimate(task, dev) if tc.time_estimate
                   else dev.time_estimate_default)
            dev.load_add(est)
            task.es_hint = es0.th_id
            dev.pending.push_back((task, est))
        # no inline progress: the next idle worker's manager cycle
        # drains the whole burst with ITS execution stream
        self.context.wake_workers(len(tasks))

    def _dispatch_host_group(self, tasks: List[Task]) -> None:
        """Host-bodied counterpart: a complete pre-planned group of HOST
        residue tasks enters the scheduler as ONE contiguous burst —
        same-(level, class) members are an antichain, so nothing in
        the group depends on anything else in it and the whole batch is
        ready at once."""
        es0 = self.context.execution_streams[0]
        self._count(residue_batches=1, residue_batch_tasks=len(tasks))
        from ..runtime.scheduling import schedule
        schedule(es0, tasks)
        self.context.wake_workers(len(tasks))

    # ------------------------------------------------------------------ #
    # prestage/execute overlap                                           #
    # ------------------------------------------------------------------ #
    def _prestage_activation(self, rec: _StageRec, copy) -> None:
        """Early stage-in of a buffered activation payload: the stage
        still awaits other inputs, so this transfer hides under whatever
        is producing them.  Budgeted: at most ``device_prefetch_depth``
        pending stages hold outstanding prestages at once."""
        if self._prestage_depth <= 0 or copy is None \
                or copy.data is None:
            return
        if id(rec) not in self._prestage_recs \
                and len(self._prestage_recs) >= self._prestage_depth:
            return
        if self._dev.prestage_data(copy.data, dtt=copy.dtt):
            self._prestage_recs.add(id(rec))
            rec.prestaged.append(copy.data)
            self._count(prestage_issued=1)

    def _prestage_own_tiles(self, rec: _StageRec) -> None:
        """Stage the spawning stage's host-resident tiles NOW, so the
        copies run before its record instead of serializing ahead of
        its dispatch.  Safe: the stage's activation goal is met, so
        every tile it reads holds its final value (memory ordering
        between tasks is dataflow-carried)."""
        if self._prestage_depth <= 0:
            return
        tiles = [self.tp.global_env[name].data_of(*coords)
                 for (name, coords), _a in rec.layout.mem_slots]
        if rec.chain is not None:
            tiles.extend(coll.data_of(*coords)
                         for coll, coords in rec.chain.extra)
        committed = [d for d in tiles if self._dev.prestage_data(d)]
        if committed:
            rec.prestaged.extend(committed)
            self._count(prestage_issued=len(committed))

    def _prestage_lookahead(self) -> None:
        """A stage just completed: prestage the next PENDING stages'
        tiles whose writers are all retired (their host values are
        final), up to the device_prefetch_depth stage budget — stage
        N+1's slot stage-in overlaps what still executes."""
        if self._prestage_depth <= 0:
            return
        budget = self._prestage_depth
        writers = self.plan.mem_writers
        member_stage = self.plan.member_stage
        for rec in self._recs:
            if budget <= 0:
                break
            with rec._lock:
                if rec.status != _PENDING:
                    continue
            budget -= 1
            for (coll_name, coords), _access in rec.layout.mem_slots:
                final = True
                for wk in writers.get((coll_name, coords), ()):
                    wsi = member_stage.get(wk)
                    wrec = (self._rec_by_index.get(wsi)
                            if wsi is not None else None)
                    if wrec is None:
                        final = False   # residue or foreign writer
                        break
                    with wrec._lock:
                        if wrec.status != _DONE:
                            final = False   # value not yet final
                    if not final:
                        break
                if not final:
                    continue
                data = self.tp.global_env[coll_name].data_of(*coords)
                if self._dev.prestage_data(data):
                    self._prestage_recs.add(id(rec))
                    rec.prestaged.append(data)
                    self._count(prestage_issued=1)

    def _count_prestage_hits(self, rec: _StageRec) -> None:
        """At spawn: every prestaged Data whose device copy is still
        current is a HIT — the stage's stage-in finds the tile resident
        instead of paying a serial host-to-device copy."""
        for data in rec.prestaged:
            if self._dev.prestaged_current(data):
                self._count(prestage_hits=1)
        rec.prestaged = []
        self._prestage_recs.discard(id(rec))

    # ------------------------------------------------------------------ #
    # spawn: record the stage's program, bind slots, emit the task       #
    # ------------------------------------------------------------------ #
    def _spawn(self, rec: _StageRec) -> List[Task]:
        try:
            return [self._make_stage_task(rec)]
        except CaptureError as exc:
            plog.warning(
                "stagec: stage %d of %s cannot be recorded (%s); its %d "
                "member task(s) run interpreted",
                rec.stage.index, self.tp.name, str(exc)[:200],
                rec.stage.n_tasks)
            return self._downgrade(rec)

    def _slot_shapes(self, rec: _StageRec, bindings: Dict) -> Tuple:
        shapes = []
        for (coll_name, coords), _access in rec.layout.mem_slots:
            coll = self.tp.global_env[coll_name]
            shapes.append(_tile_shape(coll, coords))
        for ak in rec.layout.act_slots:
            cp = bindings.get(ak)
            if cp is None or cp.payload is None:
                raise RuntimeError(
                    f"activation slot {ak} bound no payload")
            shapes.append(_payload_shape(cp.payload))
        return tuple(shapes)

    def _device(self):
        """The torch device stages run on: the device module's."""
        return self._dev.torch_device

    def _build_program(self, key, rec: _StageRec, make_run,
                       what: str) -> StageProgram:
        """Fetch-or-build-and-record one program under ``key``.  A body
        that cannot be recorded caches the failure sentinel and raises
        :class:`CaptureError`; a cached failure re-raises at once."""
        from ..devices.batching import cached_stage_callable

        n_edges = (len(rec.layout.edge_outs) if rec.chain is None
                   else _chain_outputs(rec) - len(rec.layout.out_mem))

        def build():
            t0 = time.perf_counter_ns()
            prog = StageProgram(
                make_run(), f"stage {rec.stage.index} of {self.tp.name} "
                f"({what})", len(rec.shapes), rec.layout.out_mem, n_edges,
                self._dev.stream)
            try:
                prog.record(rec.shapes, self._device())
            except CaptureError:
                return _FAILED
            self._count(stage_compiles=1,
                        stage_compile_ns=time.perf_counter_ns() - t0)
            return prog

        prog = cached_stage_callable(self._token, key, build,
                                     owner=self.context)
        if prog is _FAILED:
            raise CaptureError(f"stage {rec.stage.index} of "
                               f"{self.tp.name}: {what} program cannot be "
                               f"recorded (cached verdict)")
        return prog

    def _lowered(self, rec: _StageRec, donate: bool) -> StageProgram:
        """The cached recorded program for this stage signature — in the
        per-spec stage cache (devices/batching.py); a repeat taskpool
        over the same spec/NB/dtype replays it without recording.  A
        cached failure re-raises instantly."""
        key = stage_signature(rec.stage, rec.shapes) + (
            donate, "fused", str(self._device()))
        return self._build_program(
            key, rec, lambda: build_stage_fn(self.tp, rec.stage, rec.layout,
                                             self._codes), "fused")

    def _extra_shapes(self, rec: _StageRec) -> Tuple:
        return tuple(_tile_shape(coll, coords)
                     for coll, coords in rec.chain.extra)

    def _lowered_chain(self, rec: _StageRec, donate: bool) -> StageProgram:
        """The cached CHAINED program of a host stage (stagec/chain.py):
        host stage + rider stages of later pools, cached under the host
        pool's spec token.  A cached failure re-raises instantly (the
        caller falls back to the host-only program)."""
        from . import chain as chain_mod

        key = chain_mod.chain_signature(rec.shapes, rec.stage, rec.chain,
                                        donate) + (str(self._device()),)
        return self._build_program(
            key, rec, lambda: chain_mod.build_chain_run(
                self.tp, rec.stage, rec.layout, self._codes, rec.chain),
            "chained")

    def _make_stage_task(self, rec: _StageRec) -> Task:
        with rec._lock:
            events = list(rec.events)
        bindings: Dict[Tuple, Any] = {}
        for (mkey, fname, copy) in events:
            if copy is not None:
                bindings[(mkey, fname)] = copy
        # prestage the stage's host-resident tiles: their copies run
        # before the record below
        self._prestage_own_tiles(rec)
        rec.shapes = self._slot_shapes(rec, bindings)
        if rec.chain is not None:
            rec.shapes = rec.shapes + self._extra_shapes(rec)
        rec.donate = self._donate_default and not any(
            m.tc.ast.name in self._bdy_aliased for m in rec.stage.members)
        if rec.chain is not None:
            try:
                rec.fn = self._lowered_chain(rec, rec.donate)
            except CaptureError as exc:   # the host-only program stands by
                self._count(chain_fallbacks=1)
                plog.warning(
                    "stagec chain: chained program of %s stage %d "
                    "failed to record (%s: %s); host-only program "
                    "(riders dispatch from their own pools)",
                    self.tp.name, rec.stage.index,
                    type(exc).__name__, str(exc)[:200])
                st = getattr(self.context, "_stage_chain", None)
                if st is not None:
                    # a None stash tells each rider "the host fell
                    # back, spawn normally" — counted HERE once, not
                    # once more per rider
                    for link in rec.chain.riders:
                        st.stash[id(link.tp)] = None
                rec.chain = None
                rec.shapes = self._slot_shapes(rec, bindings)
        if rec.chain is None:
            if rec.xwave is not None:
                self._xblock(rec)
            else:
                self._rank_local(rec)
        self._count_prestage_hits(rec)
        tc = StageTaskClass(self, rec)
        if self._trace_on:
            # stage-task spans carry member contexts: the stage's exec
            # span lists its member tasks and the wire flow ids that fed
            # it, so the merged timeline can tie one stage slice to its
            # cross-rank inputs
            with rec._lock:
                ctxs = list(rec.flow_ctxs)
            tc.trace_info = {
                "stage_members": rec.stage.n_tasks,
                "member_tasks": [f"{m.key[0]}{tuple(m.key[1])}"
                                 for m in rec.stage.members[:16]],
                "wire_flows": [f"R{o}:{s}" for (o, s) in ctxs[:32]],
            }
        task = Task(self.tp, tc, (rec.stage.index,),
                    priority=rec.priority)
        task.user = rec
        for i, ((coll_name, coords), _a) in enumerate(rec.layout.mem_slots):
            coll = self.tp.global_env[coll_name]
            task.data[i].data_in = coll.data_of(*coords).host_copy()
            task.data[i].fulfilled = True
        base = len(rec.layout.mem_slots)
        for j, ak in enumerate(rec.layout.act_slots):
            task.data[base + j].data_in = bindings[ak]
            task.data[base + j].fulfilled = True
        if rec.chain is not None:
            base += len(rec.layout.act_slots)
            for j, (coll, coords) in enumerate(rec.chain.extra):
                task.data[base + j].data_in = \
                    coll.data_of(*coords).host_copy()
                task.data[base + j].fulfilled = True
        rec.task = task
        return task

    def _rank_local(self, rec: _StageRec) -> None:
        """The stage's rank-local program: the wave front over the chip
        mesh, else the single-chip graph."""
        if self._mesh_dev is not None \
                and params.get("stage_compile_shard"):
            rec.sharded = self._sharded(rec)
        if rec.sharded is None:
            rec.fn = self._lowered(rec, rec.donate)

    def _xblock(self, rec: _StageRec) -> None:
        """This rank's recorded block of the stage's cross-rank wave.  A
        block that cannot be recorded raises CaptureError (the stage
        downgrades and declines the wave).  Any other failure errors the
        wave's rendezvous at once and is raised when the stage task
        dispatches (``dispatch_xrank``): raised here, in the middle of
        a release walk, it would keep activations from the peers, who
        would then never reach the rendezvous to see the error."""
        from .xrank import build_xblock, error_rec
        try:
            rec.xblock = build_xblock(self, rec)
        except CaptureError:
            raise
        except Exception as exc:
            error_rec(self, rec, exc)
            rec.xfail = exc

    def _sharded(self, rec: _StageRec):
        """A wave-front stage on a mesh rank runs its rows over the
        rank's chips (stagec/sharded.py).  An ineligible wave front
        (planning) returns None: the single-chip graph.  A block whose
        body cannot be recorded is the stage's record failure (cached;
        the caller downgrades the stage); any other failure RAISES — no
        fallback to the single-chip graph."""
        from .sharded import build_wavefront_callable, wavefront_info
        from ..devices.batching import cached_stage_callable
        dev = self._mesh_dev
        k = len(dev.chips)
        n = rec.stage.n_tasks
        if n < k or n % k:
            return None
        info = wavefront_info(self.tp, rec.stage, rec.layout, self._codes)
        if info is None:
            return None
        key = stage_signature(rec.stage, rec.shapes) + ("sharded", dev.mesh)

        def build():
            t0 = time.perf_counter_ns()
            try:
                prog = build_wavefront_callable(dev, info, self.tp.rank,
                                                rec.shapes)
            except CaptureError:
                return _FAILED
            self._count(stage_compiles=1,
                        stage_compile_ns=time.perf_counter_ns() - t0)
            return prog

        prog = cached_stage_callable(self._token, key, build,
                                     owner=self.context)
        if prog is _FAILED:
            raise CaptureError(f"stage {rec.stage.index} of {self.tp.name}: "
                               f"a wave-front block cannot be recorded "
                               f"(cached verdict)")
        return prog

    # ------------------------------------------------------------------ #
    # downgrade: replay into the interpreted dynamic path                #
    # ------------------------------------------------------------------ #
    def _downgrade(self, rec: _StageRec) -> List[Task]:
        """Transparent per-stage fallback: buffered external
        activations replay through the normal per-class dep tables and
        the members execute via the interpreted (batched) dispatch.
        Permanent only for this stage — other stages keep their
        recorded programs."""
        with rec._lock:
            rec.status = _DOWNGRADED
            events, rec.events = rec.events, []
        if rec.xwave is not None:
            # peers are (or will be) waiting at this wave's rendezvous:
            # decline NOW so they run their rows rank-local
            from .xrank import decline_rec
            decline_rec(self, rec)
            rec.xwave = None
            self._count(xstage_fallbacks=1)
            self._xdone(rec)
        rec.prestaged = []
        self._prestage_recs.discard(id(rec))
        self._count(stage_fallbacks=1)
        ready: List[Task] = []
        for inst in rec.stage.members:
            tc = self._tc(inst)
            if tc.goal_of(inst.locals) == 0:
                ready.append(tc.make_task(inst.locals, None))
        for (mkey, fname, copy) in events:
            tc = self.tp.class_by_name(mkey[0])
            t = tc.activate(mkey[1], fname, copy)
            if t is not None:
                ready.append(t)
        return ready

    # ------------------------------------------------------------------ #
    # execution: the stage chore                                         #
    # ------------------------------------------------------------------ #
    def _make_dyld(self, rec: _StageRec):
        def dyld(task: Task, arrays: List[Any]):
            return self._execute_stage(task, rec, arrays)
        return dyld

    def _execute_stage(self, task: Task, rec: _StageRec,
                       arrays: List[Any]):
        lay = rec.layout
        dev = task.selected_device
        tile_outs = None
        if rec.xwave is not None:
            from .xrank import XDeclined, dispatch_xrank
            try:
                tile_outs, edge_outs = dispatch_xrank(self, rec, arrays)
                self._count(xstage_tasks=rec.stage.n_tasks)
            except XDeclined as exc:
                plog.debug.verbose(
                    2, "stagec xrank: stage %d of %s runs rank-local (%s)",
                    rec.stage.index, self.tp.name, exc)
                rec.xwave = None
                self._count(xstage_fallbacks=1)
                self._record_in_dispatch(rec)
            self._xdone(rec)
        if tile_outs is None and rec.sharded is not None:
            from .sharded import dispatch_sharded
            tile_outs, edge_outs = dispatch_sharded(self._mesh_dev,
                                                    rec.sharded, arrays)
            self._count(stage_sharded=1)
        elif tile_outs is None:
            donate = rec.donate and \
                len({id(a) for a in arrays}) == len(arrays)
            # the slots' device: the module's, or a mesh chip's card (a
            # program records once on each card it replays on)
            device = next((a.device for a in arrays
                           if hasattr(a, "device")), self._device())
            tile_outs, edge_outs = rec.fn.replay(arrays, device, donate)
            if rec.chain is not None:
                # stash each rider stage's outputs for its pool's
                # consume_chain (stagec/chain.py): tiles + edge
                # live-outs, device tensors on the device stream.  A
                # rider pool may own SEVERAL links (multi-stage
                # prefix): its stash is the per-link list in stage
                # order
                nhost = len(lay.edge_outs)
                rest = list(edge_outs[nhost:])
                edge_outs = edge_outs[:nhost]
                st = getattr(self.context, "_stage_chain", None)
                stash_by_tp: Dict[int, List[Dict[str, Any]]] = {}
                for link in rec.chain.riders:
                    nt = len(link.layout.out_mem)
                    part, rest = rest[:link.n_out], rest[link.n_out:]
                    stash_by_tp.setdefault(id(link.tp), []).append(
                        {"tiles": [_tag(dev, task, a) for a in part[:nt]],
                         "edges": [_tag(dev, task, a)
                                   for a in part[nt:]]})
                if st is not None:
                    for tpid, parts in stash_by_tp.items():
                        st.stash[tpid] = parts
        for ek, arr in zip(lay.edge_outs, edge_outs):
            if arr is None:
                continue   # a NULL-forwarded flow: successors bind None
            rec.edge_copies[ek] = _edge_copy(_tag(dev, task, arr))
        self._count(stage_dispatches=1, stage_tasks=rec.stage.n_tasks)
        if dev is not None:
            dev.stats["tasks"] += rec.stage.n_tasks - 1  # +1 from epilog
        return tuple(tile_outs)

    def _record_in_dispatch(self, rec: _StageRec) -> None:
        """Record the rank-local program of a stage that left its wave at
        dispatch.  The record's GEMM launches are the program's (as a
        spawn-time record's are), so they come back out of the device
        module's dispatch count."""
        from ..ops.kernels import thread_matmul_launches
        k0 = thread_matmul_launches()
        try:
            self._rank_local(rec)
        finally:
            self._dev.gemm_launches -= thread_matmul_launches() - k0

    # ------------------------------------------------------------------ #
    # release: each member's untouched _release_deps over the stash      #
    # ------------------------------------------------------------------ #
    def _release(self, es, rec: _StageRec) -> List[Task]:
        with rec._lock:
            rec.status = _DONE
        # this stage's written tiles are final: prestage the next
        # pending stages' inputs
        self._prestage_lookahead()
        ready: List[Task] = []
        for inst in rec.stage.members:
            if inst.key not in rec.layout.release_members:
                continue   # every successor is inside this stage
            tc = self._tc(inst)
            shim = Task(self.tp, tc, inst.locals)
            for i, f in enumerate(tc.ast.flows):
                cp = rec.edge_copies.get((inst.key, f.name))
                if cp is not None:
                    shim.data[i].data_out = cp
            ready.extend(tc._release_deps(
                es, shim, ACTION_RELEASE_ALL) or [])
        rec.edge_copies.clear()
        return ready

    # ------------------------------------------------------------------ #
    # facts for the caller                                               #
    # ------------------------------------------------------------------ #
    def program_report(self) -> List[Dict[str, Any]]:
        """Per stage of this pool: its tasks, whether it ran, and its
        program's recording facts — the GEMM kernel's captured launches
        (a replay re-runs them uncounted), replays, record seconds and
        the last replay's device time (``None`` on the CPU or before a
        replay); per chip for a wave front over the mesh."""
        out = []
        for rec in self._recs:
            with rec._lock:
                status = rec.status
            row: Dict[str, Any] = {
                "stage": rec.stage.index, "tasks": rec.stage.n_tasks,
                "status": ("pending", "spawned", "done",
                           "downgraded")[status],
                "chained": rec.chain is not None}
            # the program that ran: a stage that left its cross-rank
            # wave reports its rank-local program
            prog = next((p for p in (rec.sharded, rec.fn, rec.xblock)
                         if p is not None), None)
            if prog is not None:
                row.update(prog.facts())
            out.append(row)
        return out


def _chain_outputs(rec: _StageRec) -> int:
    """Outputs of a chained program: the host stage's tiles and edges,
    then every rider's."""
    return (len(rec.layout.out_mem) + len(rec.layout.edge_outs)
            + sum(link.n_out for link in rec.chain.riders))


def _tag(dev, task: Task, arr: Any) -> Any:
    """Tag a stage output as written where the stage ran (a mesh chip;
    the identity on one stream)."""
    if dev is None or arr is None or not hasattr(dev, "_tag"):
        return arr
    return dev._tag(arr, dev._stage_target(task))


def _tile_shape(coll, coords) -> Tuple:
    """(shape, dtype name) of one collection tile."""
    data = coll.data_of(*coords)
    newest = data.newest_copy()
    if newest is not None and newest.payload is not None:
        return _payload_shape(newest.payload)
    return (tuple(coll.tile_shape(*coords)), np.dtype(coll.dtype).name)


def _payload_shape(payload: Any) -> Tuple:
    """(shape, dtype name) of an array or a tensor (``torch.<name>``
    spells the same dtype)."""
    dt = payload.dtype
    name = np.dtype(dt).name if isinstance(dt, np.dtype) \
        else str(dt).replace("torch.", "")
    return (tuple(payload.shape), name)


def _edge_copy(arr) -> DataCopy:
    """Wrap a stage live-out tensor as a deliverable DataCopy (the shape
    remote_dep builds for arrivals): a detached Data whose newest copy
    holds the tensor — consumers stage it in like any task output."""
    numel = int(arr.numel()) if hasattr(arr, "numel") \
        else int(getattr(arr, "size", 0))
    d = Data(nb_elts=numel)
    cp = DataCopy(d, 0, payload=arr)
    cp.version = 1
    cp.coherency = Coherency.OWNED
    d.attach_copy(cp)
    return cp


def prepared_plan(tp, context) -> StagePlan:
    """The cached, layout-prepared StagePlan of one taskpool under the
    current knobs.  The plan + layouts are a pure function of (spec,
    globals, geometry, distribution, rank) AND the partition knobs —
    max_tasks, wavefront mode, and the exclusion set all join the
    cache key, so a knob change can never hit a stale plan.  Shared by
    ``try_install`` and the chain planner (stagec/chain.declare_chain),
    which therefore always agree on stage identity."""
    from ..devices.batching import cached_stage_callable
    from .plan import _excluded_classes
    # cross-rank SPMD stages need the wave-front partition even without
    # a chip mesh: every rank must cut the SAME (level, class) waves for
    # the one program to line up
    xrank = bool(params.get("stage_compile_xrank")) \
        and tp.nb_ranks > 1 and bool(params.get("stage_compile_shard"))
    wavefront = xrank or any(
        d.device_type == "cuda" and getattr(d, "mesh", None) is not None
        and len(getattr(d, "chips", ())) > 1 for d in context.devices)
    max_tasks = int(params.get("stage_compile_max_tasks"))

    def build_plan():
        plan = plan_stages(tp, rank=tp.rank, max_tasks=max_tasks,
                           wavefront=wavefront)
        for stage in plan.stages:
            layout = build_layout(tp, plan, stage)
            # the max over the members' TRUE priorities (negative
            # included — a spec that deprioritizes a class must not
            # see its compiled stage boosted to 0)
            prios = [int(m.tc.ast.priority(m.env))
                     for m in stage.members
                     if m.tc.ast.priority is not None]
            plan.prepared.append((stage, layout,
                                  max(prios) if prios else 0))
        # plan-cached startup enumeration: goal-0 local residue + the
        # foreign mem-put expectation are pure functions of the plan
        # identity — a stagec _startup skips the whole per-instance
        # iteration-space walk on repeat pools
        for inst in plan.order:
            k = inst.key
            if k in plan.local_keys:
                if k not in plan.member_stage \
                        and inst.tc.goal_of(inst.locals, inst.env) == 0:
                    plan.startup_goal0.append(k)
            else:
                plan.startup_mem_puts += tp._count_mem_puts_to_me(
                    tp.class_by_name(k[0]), inst.env)
        if xrank:
            from .xrank import plan_xwaves
            plan_xwaves(tp, plan, max_tasks)
        return plan

    # held for the context: the plan's instances keep the first pool's
    # classes and environment (its collections) alive
    return cached_stage_callable(
        spec_token(tp),
        ("stageplan", wavefront, xrank, max_tasks, _excluded_classes()),
        build_plan, owner=context)


def try_install(tp, context) -> Optional[StageCompiler]:
    """Build a StageCompiler for ``tp`` when the stage_compile knob is
    on and the pool is eligible; None keeps the interpreted runtime
    bit-for-bit (the knob's off-contract).  The plan + layouts are a
    pure function of (spec, globals, geometry, distribution, rank), so
    they cache under the spec token — a repeat taskpool skips the whole
    enumeration/partition walk, not just the record."""
    if not any(d.device_type == "cuda" for d in context.devices):
        return None
    try:
        plan = prepared_plan(tp, context)
    except CaptureError as exc:
        # unenumerable spec (a dependency cycle, a dangling dep): the
        # interpreted runtime reports it its own way
        plog.debug.verbose(
            2, "stagec: %s not plannable (%s); interpreted path",
            tp.name, exc)
        return None
    if not plan.stages:
        return None
    plog.debug.verbose(
        3, "stagec: %s rank %d -> %d stage(s) covering %d/%d local "
        "task(s), %d residue", tp.name, tp.rank, len(plan.stages),
        plan.n_staged, plan.n_local, plan.n_residue)
    return StageCompiler(tp, context, plan)
