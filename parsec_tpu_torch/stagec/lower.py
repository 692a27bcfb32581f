"""Lowering pass: one stage function per stage, recorded as a CUDA graph.

A stage's tiles become a packed slot list (memory-sourced tiles first,
externally-activated task-edge values second); intra-stage dependencies
become plain data flow between the members' bodies.  The member walk
mirrors ``dsl/ptg/capture.CapturedTaskpool._execute`` exactly
(first-applicable in-dep binds, post-body flow values feed successors,
WRITE flows scatter to memory targets), so every member runs the same
launches, on the same tiles, as the per-task interpreted path; the order
between members is the one their dependences fix.  The stage function is
eager torch over the slots: the stage compiler (stagec/runtime.py)
records it once per stage signature into ONE ``torch.cuda.CUDAGraph``
(``dsl/graph.GraphRunner``) and replays that graph as a single chore.
On the CPU it runs eagerly.  Either way the result is bit-identical to
the interpreted runtime.

Recorded programs are cached per (spec token, stage signature) in the
per-spec stage cache of :mod:`..devices.batching`
(``cached_stage_callable``), so a fresh taskpool over the same spec and
problem parameters replays an existing graph without recording again.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.data import FlowAccess
from ..dsl.ptg.capture import _producer_locals
from ..dsl.ptg.runtime import _expand_args, f_prop, scratch_shape

__all__ = ["StageLayout", "build_layout", "build_stage_fn",
           "stage_signature", "spec_token", "spec_codes"]


def spec_codes(tp) -> Dict[str, Any]:
    """The compiled accelerator-BODY code objects of a taskpool's
    classes, memoized ON the parsed spec (``jdf._ptt_stagec_codes``):
    stage compilers and chain links come and go per taskpool — the
    bodies must not recompile every time, and the memo goes with the
    spec."""
    from ..dsl.ptg.capture import _pick_body
    codes = getattr(tp.jdf, "_ptt_stagec_codes", None)
    if codes is None:
        codes = {
            tc.ast.name: compile(_pick_body(tc.ast).code,
                                 f"<jdf:{tc.ast.name}:BODY[stagec]>",
                                 "exec")
            for tc in tp.task_classes}
        tp.jdf._ptt_stagec_codes = codes
    return codes


class StageLayout:
    """The packed calling convention of one lowered stage.

    - ``mem_slots``: [((coll_name, coords), FlowAccess)] — one per
      distinct tile the stage reads from / writes to memory;
    - ``act_slots``: [(member_key, flow_name)] — one per externally-
      activated task-edge input (the redirect buffers the copies);
    - ``out_mem``: indices into ``mem_slots`` of written tiles, in slot
      order — the device module's written-flow outputs;
    - ``edge_outs``: [(member_key, flow_name)] post-body values some
      non-member successor consumes (stashed by the dispatch, released
      by the stage task's release walk);
    - ``goal``: external task-sourced activations to await before the
      stage is ready (the stage task's dynamic dependency counter).
    """

    __slots__ = ("mem_slots", "act_slots", "out_mem", "edge_outs", "goal",
                 "mem_index", "act_index", "release_members")

    def __init__(self) -> None:
        self.mem_slots: List[Tuple[Tuple, FlowAccess]] = []
        self.act_slots: List[Tuple[Tuple, str]] = []
        self.out_mem: List[int] = []
        self.edge_outs: List[Tuple[Tuple, str]] = []
        self.goal = 0
        self.mem_index: Dict[Tuple, int] = {}
        self.act_index: Dict[Tuple, int] = {}
        #: member keys with at least one out-edge leaving the stage
        #: (data or CTL): the ONLY members the stage task's release
        #: walk visits — interior members' successors are all in the
        #: same program, so walking them would emit only swallowed
        #: activations (pure overhead, O(stage size))
        self.release_members: set = set()

    @property
    def n_flows(self) -> int:
        return len(self.mem_slots) + len(self.act_slots)

    def slot_of_act(self, member_key: Tuple, flow_name: str) -> Optional[int]:
        j = self.act_index.get((member_key, flow_name))
        return None if j is None else len(self.mem_slots) + j


def build_layout(tp, plan, stage) -> StageLayout:
    """Walk the stage members' dependency edges once and derive the
    packed argument/output layout plus the external activation goal."""
    lay = StageLayout()
    class_ast = {tc.ast.name: tc.ast for tc in tp.task_classes}
    insts = plan.inst_by_key
    mkeys = stage.member_keys
    mem_access: Dict[Tuple, int] = {}
    mem_order: List[Tuple] = []
    edge_set = set()

    def note_mem(key: Tuple, access: FlowAccess) -> None:
        if key not in mem_access:
            mem_access[key] = FlowAccess.NONE
            mem_order.append(key)
        mem_access[key] |= access

    for inst in stage.members:
        env = inst.env
        for f in inst.tc.ast.flows:
            # inputs: every task-sourced in-dep expansion from outside
            # the stage is one awaited activation (the same counting
            # the interpreted input_goal applies, filtered to edges
            # that cross the stage boundary and producers that exist)
            for d in f.deps_in():
                t = d.resolve(env)
                if t is None:
                    continue
                if t.kind == "task":
                    for args in _expand_args(t.args, env):
                        pk = (t.task_class, _producer_locals(
                            class_ast, t.task_class, args))
                        if pk in insts and pk not in mkeys:
                            lay.goal += 1
                            if not f.is_ctl:
                                ak = (inst.key, f.name)
                                if ak not in lay.act_index:
                                    lay.act_index[ak] = len(lay.act_slots)
                                    lay.act_slots.append(ak)
                elif t.kind == "memory" and not f.is_ctl:
                    coords = tuple(int(a(env)) for a in t.args)
                    note_mem((t.collection, coords), FlowAccess.READ)
            if f.is_ctl:
                # a CTL out-edge leaving the stage still must fire its
                # (payload-less) activation at release
                for d in f.deps_out():
                    t = d.resolve(env)
                    if t is None or t.kind != "task":
                        continue
                    for args in _expand_args(t.args, env):
                        pk = (t.task_class, _producer_locals(
                            class_ast, t.task_class, args))
                        if pk not in mkeys:
                            lay.release_members.add(inst.key)
                            break
                continue
            writes = f.access in ("RW", "WRITE")
            if writes:
                for d in f.deps_out():
                    t = d.resolve(env)
                    if t is not None and t.kind == "memory":
                        coords = tuple(int(a(env)) for a in t.args)
                        note_mem((t.collection, coords), FlowAccess.WRITE)
            if not f.deps_in():
                # pure-output flow bound to its memory target's current
                # value (the interpreted _output_binding semantics)
                for d in f.deps_out():
                    t = d.resolve(env)
                    if t is not None and t.kind == "memory":
                        coords = tuple(int(a(env)) for a in t.args)
                        note_mem((t.collection, coords), FlowAccess.READ)
                        break
            # any flow value a non-member successor consumes is live-out
            for d in f.deps_out():
                t = d.resolve(env)
                if t is None or t.kind != "task":
                    continue
                for args in _expand_args(t.args, env):
                    pk = (t.task_class, _producer_locals(
                        class_ast, t.task_class, args))
                    if pk not in mkeys:
                        lay.release_members.add(inst.key)
                        ek = (inst.key, f.name)
                        if ek not in edge_set:
                            edge_set.add(ek)
                            lay.edge_outs.append(ek)
                        break

    for i, key in enumerate(mem_order):
        lay.mem_slots.append((key, mem_access[key]))
        lay.mem_index[key] = i
        if mem_access[key] & FlowAccess.WRITE:
            lay.out_mem.append(i)
    return lay


def build_stage_fn(tp, stage, layout: StageLayout,
                   codes: Dict[str, Any]):
    """The stage function: ``run(*slots, device=, note=)`` takes the
    packed slot tensors (``layout`` order) and returns the written
    tiles followed by the edge live-outs.  Functional: the bodies assign
    new tensors to the written flow names, so nothing is written in
    place — safe to record into a CUDA graph.  A NEW flow is
    ``torch.zeros`` on ``device``; a body's namespace is the interpreted
    device bodies' (``np``, ``torch``, ``es_rank``; ``this_task`` is
    None).  ``note(label)`` runs before each member's body, so a failed
    recording can name the task."""
    import torch

    class_ast = {tc.ast.name: tc.ast for tc in tp.task_classes}
    members = list(stage.members)
    mkeys = stage.member_keys
    n_mem = len(layout.mem_slots)
    mem_keys = [k for k, _a in layout.mem_slots]
    rank = tp.rank

    def zeros(f, env, device):
        return torch.zeros(scratch_shape(f, env),
                           dtype=getattr(torch, f_prop(f, "dtype",
                                                       "float32")),
                           device=device)

    def run(*bufs, device=None, note=None):
        if device is None:
            device = next((b.device for b in bufs
                           if isinstance(b, torch.Tensor)), "cpu")
        tile_store: Dict[Tuple, Any] = {
            mem_keys[i]: bufs[i] for i in range(n_mem)}
        ext: Dict[Tuple, Any] = {
            ak: bufs[n_mem + j] for j, ak in enumerate(layout.act_slots)}
        out_store: Dict[Tuple, Any] = {}
        for inst in members:
            tc_ast = inst.tc.ast
            env = dict(inst.env)
            payloads: Dict[str, Any] = {}
            for f in tc_ast.flows:
                if f.is_ctl:
                    continue
                val = None
                bound = False
                for d in f.deps_in():
                    t = d.resolve(inst.env)
                    if t is None:
                        continue
                    if t.kind == "task":
                        pk = (t.task_class, _producer_locals(
                            class_ast, t.task_class,
                            tuple(a(inst.env) for a in t.args)))
                        if pk in mkeys:
                            val = out_store[(pk[0], pk[1], t.flow)]
                        else:
                            val = ext.get((inst.key, f.name))
                    elif t.kind == "memory":
                        coords = tuple(int(a(inst.env)) for a in t.args)
                        val = tile_store[(t.collection, coords)]
                    elif t.kind == "new":
                        val = zeros(f, inst.env, device)
                    elif t.kind == "null":
                        val = None
                    bound = True
                    break
                if not bound and not f.deps_in():
                    # pure-output flow: its memory target's current
                    # value, else a zeroed scratch (interpreted
                    # _output_binding / new_scratch_copy semantics)
                    for d in f.deps_out():
                        t = d.resolve(inst.env)
                        if t is not None and t.kind == "memory":
                            coords = tuple(int(a(inst.env))
                                           for a in t.args)
                            val = tile_store[(t.collection, coords)]
                            break
                    else:
                        if scratch_shape(f, inst.env) is not None:
                            val = zeros(f, inst.env, device)
                payloads[f.name] = val
            env.update(payloads)
            env["np"] = np
            env["torch"] = torch
            env["es_rank"] = rank
            env["this_task"] = None
            if note is not None:
                note(f"{tc_ast.name}{inst.locals}")
            exec(codes[tc_ast.name], env)
            for f in tc_ast.flows:
                if f.is_ctl:
                    continue
                out_store[(tc_ast.name, inst.locals, f.name)] = \
                    env.get(f.name)
                if f.access in ("RW", "WRITE"):
                    for d in f.deps_out():
                        t = d.resolve(inst.env)
                        if t is None or t.kind != "memory":
                            continue
                        coords = tuple(int(a(inst.env)) for a in t.args)
                        tile_store[(t.collection, coords)] = \
                            env.get(f.name)
        tiles = tuple(tile_store[mem_keys[i]] for i in layout.out_mem)
        edges = tuple(out_store[(mk[0], mk[1], fn)]
                      for (mk, fn) in layout.edge_outs)
        return tiles + edges

    return run


def stage_signature(stage, shapes: Tuple) -> Tuple:
    """The cache key of one recorded stage: its member set (class +
    locals — NB and the tile grid are implied by the locals space) plus
    the concrete slot shapes/dtypes."""
    return (stage.index,
            tuple((m.tc.ast.name, m.locals) for m in stage.members),
            shapes)


def spec_token(tp) -> Tuple:
    """The cache token of a taskpool's stage programs: a fresh taskpool
    over the same parsed spec, scalar globals, and collection geometry
    hits already-recorded stages.  It leads with the JDFFile object
    itself, through the identity wrapper (plan.IdKey): the cache lives on
    that object (devices/batching.cached_stage_callable), so a dead
    spec's entries — CUDA graphs and their memory pools — go with it."""
    from ..collections.collection import DataCollection
    from .plan import IdKey
    scalars = []
    colls = []
    for name, val in sorted(tp.global_env.items()):
        if isinstance(val, (int, float, str, np.integer, np.floating)):
            scalars.append((name, val))
        elif isinstance(val, DataCollection):
            # geometry AND distribution: rank_of decides stage
            # membership, so P/Q/nodes are part of the plan identity
            colls.append((name, type(val).__name__,
                          getattr(val, "mt", None), getattr(val, "nt", None),
                          getattr(val, "mb", None), getattr(val, "nb", None),
                          getattr(val, "P", None), getattr(val, "Q", None),
                          getattr(val, "nodes", None),
                          str(getattr(val, "dtype", None))))
    return (IdKey(tp.jdf), tuple(scalars), tuple(colls),
            tp.rank, tp.nb_ranks)
