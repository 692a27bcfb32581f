"""Replay a PTG taskpool through the DTD engine.

Reference behavior: the ``ptg_to_dtd`` PINS module intercepts a PTG
taskpool and re-executes it with the dynamic-task-discovery front end —
a cross-DSL consistency check and a migration aid (ref:
parsec/mca/pins/ptg_to_dtd/).

As in the JAX package, the PTG's instance graph is *compiled* into a DTD
insertion stream:

1. order every task instance of every class topologically, as capture
   plans it (``capture.plan``: DTD discovers deps from the *sequential*
   insertion order, and any topological order is a valid sequential
   schedule);
2. map each data flow to its *memory anchor* — the collection tile the
   flow chain ultimately originates from / writes back to — by walking
   input-dep chains backwards; that tile becomes the DTD tracked datum
   with IN/INOUT access derived from the flow access.

Flows with no memory anchor (NEW scratch, CTL) carry no data dependency —
same restriction as the reference module.  A class with an accelerator
BODY runs it as the DTD class's CUDA chore (``add_chore(body, "cuda",
…)``, registered before its first insert): on the context's device
module, on the card, or over host tensors under ``init(device="cpu")``,
as the PTG runtime runs it.  A class with only a host BODY runs it on
the DTD tiles' host payloads: each flow name is bound to a CPU tensor
sharing the payload's memory (``torch.from_numpy``), and a rebound
written flow is copied back into the payload.  One DTD task class serves
each (PTG class, number of anchored flows).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .capture import _pick_body, _producer_locals, plan
from .runtime import PTGTaskpool, PTGTaskClass

__all__ = ["ptg_to_dtd"]


def _memory_anchor(tp: PTGTaskpool, class_ast: Dict, tc: PTGTaskClass,
                   locals_: Tuple, flow_name: str,
                   memo: Dict) -> Optional[Tuple[str, Tuple]]:
    """The (collection, indices) a flow's data chain originates from,
    following task-sourced inputs backwards (the same datatype-lookup walk
    the reference does on the receiver side, remote_dep_mpi.c:766)."""
    key = (tc.task_class_id, locals_, flow_name)
    if key in memo:
        return memo[key]
    memo[key] = None  # cycle guard; RW chains terminate at memory
    env = tc.env_of(locals_)
    fl = tc.ast.flow_by_name(flow_name)
    anchor = None
    for d in fl.deps_in():
        t = d.resolve(env)
        if t is None:
            continue
        if t.kind == "memory":
            anchor = (t.collection, tuple(a(env) for a in t.args))
        elif t.kind == "task":
            args = _producer_locals(class_ast, t.task_class,
                                    tuple(a(env) for a in t.args))
            anchor = _memory_anchor(tp, class_ast,
                                    tp.class_by_name(t.task_class), args,
                                    t.flow, memo)
        break  # first resolving dep defines the chain, as in prepare_input
    if anchor is None:
        for d in fl.deps_out():
            t = d.resolve(env)
            if t is not None and t.kind == "memory":
                anchor = (t.collection, tuple(a(env) for a in t.args))
                break
    memo[key] = anchor
    return anchor


def _host_body(tc: PTGTaskClass):
    """The DTD host body running ``tc``'s JDF body for one instance; the
    last inserted parameter carries (locals, [(flow, tracked?, access)])."""
    from ..dtd import unpack_args
    host = [b for b in tc.ast.bodies if b.device_type in ("cpu", "recursive")]
    code = compile((host[0] if host else tc.ast.bodies[0]).code,
                   f"<ptg_to_dtd:{tc.name}>", "exec")

    def body(es, task):
        *arrays, (locals_, binds) = unpack_args(task)
        env = tc.env_of(locals_)
        it = iter(arrays)
        bound = []
        for fname, tracked, access in binds:
            val = torch.from_numpy(next(it)) if tracked else None
            env[fname] = val
            bound.append((fname, val, access))
        env["np"] = np
        env["torch"] = torch
        env["es_rank"] = 0
        exec(code, env)
        for fname, old, access in bound:
            new_val = env.get(fname)
            if old is not None and access != "READ" \
                    and new_val is not None and new_val is not old:
                old.copy_(torch.as_tensor(new_val))
    body.__name__ = tc.name
    return body


def _device_chore(tc: PTGTaskClass):
    """The CUDA chore running ``tc``'s accelerator body (the one capture
    picks): flow names bound to the device module's tensors, the last
    argument (locals, binds) as in :func:`_host_body`; returns the written
    flows' values in order."""
    code = compile(_pick_body(tc.ast).code, f"<ptg_to_dtd:{tc.name}[cuda]>",
                   "exec")

    def chore(*args):
        *arrays, (locals_, binds) = args
        env = tc.env_of(locals_)
        it = iter(arrays)
        for fname, tracked, _access in binds:
            env[fname] = next(it) if tracked else None
        env["np"] = np
        env["torch"] = torch
        env["es_rank"] = 0
        env["this_task"] = None
        exec(code, env)
        return tuple(env[fname] for fname, tracked, access in binds
                     if tracked and access != "READ")
    chore.__name__ = tc.name
    return chore


def ptg_to_dtd(ptg_tp: PTGTaskpool, context) -> Any:
    """Execute ``ptg_tp``'s DAG through a fresh DTD taskpool on ``context``
    (blocking). The PTG pool itself is never enqueued. Returns the DTD pool
    (already waited)."""
    from ..dtd import AccessMode, VALUE, REF, taskpool_new

    if ptg_tp.context is not None:
        raise ValueError("ptg_to_dtd wants a PTG pool not yet enqueued")

    dtd_tp = taskpool_new(name=f"{ptg_tp.name}_as_dtd")
    context.add_taskpool(dtd_tp)
    class_ast = {tc.ast.name: tc.ast for tc in ptg_tp.task_classes}
    memo: Dict = {}
    bodies: Dict[Tuple[str, int], Any] = {}
    for inst in plan(ptg_tp):
        tc, locals_ = inst.tc, inst.locals
        binds: List[Tuple[str, bool, str]] = []
        args = []
        for f in tc.ast.flows:
            if f.is_ctl:
                continue
            anchor = _memory_anchor(ptg_tp, class_ast, tc, locals_, f.name,
                                    memo)
            binds.append((f.name, anchor is not None, f.access))
            if anchor is None:
                continue
            coll = ptg_tp.global_env[anchor[0]]
            tile = dtd_tp.tile_of(coll, coll.data_key(*anchor[1]))
            mode = AccessMode.INPUT if f.access == "READ" else AccessMode.INOUT
            args.append((tile, mode))
        key = (tc.name, len(args))
        if key not in bodies:
            bodies[key] = _host_body(tc)
            # the class exists before its first insert, so every one of its
            # tasks takes the chore
            dtd_tp._task_class_of(bodies[key], len(args), tc.name)
            if _pick_body(tc.ast).device_type not in ("cpu", "recursive"):
                dtd_tp.add_chore(bodies[key], "cuda", _device_chore(tc))
        dtd_tp.insert_task(bodies[key], *args, ((locals_, binds), VALUE | REF),
                           name=tc.name)
    dtd_tp.data_flush_all()
    dtd_tp.wait()
    return dtd_tp
