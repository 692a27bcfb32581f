"""Graph capture: run a whole single-rank PTG taskpool as ONE CUDA graph.

The port's counterpart of the JAX package's capture (which compiles the
DAG into one jitted XLA executable).  PTG control flow is affine and
problem-size-static, so the full DAG is known at capture time: we walk
the taskpool's task classes (ast.py), resolve every dependency edge
symbolically, order the instances topologically (Kahn, LIFO), and run
each body ONCE with tensors as flow payloads.  On the card that sequence
of launches is recorded once into a CUDA graph (dsl/graph.py) and every
``run()`` replays it with one host call, where the interpreted runtime
pays its Python dispatch per task.

Scope: single rank (nb_ranks == 1); data/memory flows only (a NEW flow
needs a ``shape`` dep property); bodies must be functional — the
``[type=cuda]`` form, assigning new tensors to the written flow names.
Priorities are ignored: the replay runs the recorded order on one
stream.  Each tile's chain of updates is fixed by the dependences, so
the results are bit-identical to the interpreted runtime's.

    cg = ptg.capture(dpotrf_taskpool(A))
    cg.run()                         # cuda:0; results back in A's tiles
    cg.run(device=dev)               # dev: the context's CUDA device
                                     # module; results stay on the card
    cg.run(device="cpu")             # eager, over host tensors
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...collections.collection import DataCollection
from ...data.data import DataCopy
from ..graph import CaptureError, GraphRunner
from .runtime import PTGTaskpool, _expand_args, f_prop, scratch_shape

__all__ = ["CaptureError", "CapturedSequence", "CapturedTaskpool",
           "capture", "capture_sequence", "plan"]


def _pick_body(tc_ast):
    """Prefer the accelerator body (functional form); else first body."""
    for b in tc_ast.bodies:
        if b.device_type not in ("cpu", "recursive"):
            return b
    return tc_ast.bodies[0]


class _Instance:
    __slots__ = ("tc", "locals", "env", "preds", "key")

    def __init__(self, tc, locals_, env):
        self.tc = tc
        self.locals = locals_
        self.env = env
        self.preds: List[Tuple[str, Tuple]] = []
        self.key = (tc.ast.name, locals_)


class _Step:
    """One task of the captured order, with its dependences resolved:
    ``inputs`` lists (flow, kind, source) with kind "task" (a key of the
    value store), "memory" (a state key), "new" ((shape, dtype)) or
    "null"; ``stores`` the flows whose post-body value some later task
    reads; ``writes`` (flow, state key) memory writebacks; ``drops`` the
    value-store keys this step reads last."""

    __slots__ = ("label", "code", "env", "inputs", "stores", "writes", "drops")


class CapturedTaskpool:
    """The capture plan of one PTG taskpool and its graph.

    ``donate=True`` lets a run on the card write the results into the
    input tiles it was handed (the device copies, with ``run(device=…)``)
    instead of new tensors, which saves one tile allocation per written
    tile."""

    def __init__(self, tp: PTGTaskpool, donate: bool = False) -> None:
        if tp.nb_ranks != 1:
            raise CaptureError(
                "graph capture is single-rank; multi-rank taskpools "
                "execute through the runtime + comm engine")
        self.tp = tp
        self.donate = donate
        self.collections: Dict[str, Any] = {
            name: c for name, c in tp.global_env.items()
            if isinstance(c, DataCollection)}
        if not self.collections:
            raise CaptureError("taskpool binds no data collections")
        self._order, class_ast, valid_keys = _plan_taskpool(tp)
        codes = {tc.ast.name: compile(_pick_body(tc.ast).code,
                                      f"<jdf:{tc.ast.name}:BODY[captured]>",
                                      "exec")
                 for tc in tp.task_classes}
        self._steps = self._resolve(codes, class_ast, valid_keys)
        self.graph = GraphRunner(self._execute, f"capture({tp.name})",
                                 self.written)

    @property
    def nb_tasks(self) -> int:
        return len(self._order)

    # ------------------------------------------------------------------ #
    # planning: resolve every task's inputs and outputs once             #
    # ------------------------------------------------------------------ #
    def _resolve(self, codes, class_ast, valid_keys) -> List[_Step]:
        steps: List[_Step] = []
        readers: Dict[Tuple, int] = {}    # value key -> index of last reader
        for inst in self._order:
            tc_ast = inst.tc.ast
            st = _Step()
            st.label = f"{tc_ast.name}{inst.locals}"
            st.code = codes[tc_ast.name]
            st.env = dict(inst.env)
            st.inputs, st.writes, st.stores, st.drops = [], [], [], []
            for f in tc_ast.flows:
                if f.is_ctl:
                    continue
                src = ("null", None)
                dangling = None
                for d in f.deps_in():
                    t = d.resolve(inst.env)
                    if t is None:
                        continue
                    if t.kind == "task":
                        args = _producer_locals(
                            class_ast, t.task_class,
                            tuple(a(inst.env) for a in t.args))
                        if (t.task_class, args) not in valid_keys:
                            # inapplicable: producer out of space — legal
                            # only if another dep supplies the input
                            dangling = f"{t.task_class}{args}"
                            continue
                        key = (t.task_class, args, t.flow)
                        readers[key] = len(steps)
                        src = ("task", key)
                    elif t.kind == "memory":
                        coords = tuple(int(a(inst.env)) for a in t.args)
                        src = ("memory", (t.collection, coords))
                    elif t.kind == "new":
                        # the runtime's NEW allocation rules (runtime.py)
                        shape = scratch_shape(f, inst.env)
                        if shape is None:
                            raise CaptureError(
                                f"{tc_ast.name}.{f.name}: NEW without a "
                                f"shape property cannot be captured")
                        dt = getattr(torch, f_prop(f, "dtype", "float32"))
                        src = ("new", (shape, dt))
                    break  # first applicable dep wins (runtime semantics)
                if src[0] == "null" and dangling is not None:
                    # no dep bound a value AND one pointed out-of-space:
                    # that's a mis-written dep target, not a NULL flow
                    raise CaptureError(
                        f"{tc_ast.name}{inst.locals}.{f.name}: input dep "
                        f"resolves to {dangling}, outside its iteration "
                        f"space, and no other dep supplies the flow")
                st.inputs.append((f.name, src[0], src[1]))
                if f.access in ("RW", "WRITE"):
                    for d in f.deps_out():
                        t = d.resolve(inst.env)
                        if t is not None and t.kind == "memory":
                            coords = tuple(int(a(inst.env)) for a in t.args)
                            st.writes.append((f.name, (t.collection, coords)))
            steps.append(st)
        # keep a body's post-value only while a later task reads it
        for key, last in readers.items():
            steps[last].drops.append(key)
        for inst, st in zip(self._order, steps):
            keys = [(inst.tc.ast.name, inst.locals, f.name)
                    for f in inst.tc.ast.flows if not f.is_ctl]
            st.stores = [(key[2], key) for key in keys if key in readers]
        return steps

    def written(self) -> List[Tuple]:
        """The tiles ((collection name, coords)) some task writes back."""
        return list(dict.fromkeys(key for st in self._steps
                                  for _name, key in st.writes))

    # ------------------------------------------------------------------ #
    # execution                                                          #
    # ------------------------------------------------------------------ #
    def _execute(self, tiles: Dict[Tuple, Any], device: torch.device,
                 note=lambda label: None) -> Dict[Tuple, Any]:
        """Run the plan on ``tiles`` ({(collection name, coords): tensor})
        and return the tile state after the last task."""
        state = dict(tiles)
        values: Dict[Tuple, Any] = {}   # (class, locals, flow) -> value
        for st in self._steps:
            env = dict(st.env)
            for name, kind, src in st.inputs:
                if kind == "task":
                    env[name] = values[src]
                elif kind == "memory":
                    env[name] = state[src]
                elif kind == "new":
                    env[name] = torch.zeros(src[0], dtype=src[1],
                                            device=device)
                else:
                    env[name] = None
            # the namespace of the runtime's device bodies (runtime.py)
            env["np"] = np
            env["torch"] = torch
            env["es_rank"] = 0
            env["this_task"] = None
            note(st.label)
            exec(st.code, env)
            for key in st.drops:
                del values[key]
            for name, key in st.stores:
                values[key] = env.get(name)
            for name, key in st.writes:
                state[key] = env.get(name)
        return state

    def record(self, device=None) -> None:
        """Warm up and record the CUDA graph on the collections' current
        tiles without running it (``run`` records on first use); a body
        that cannot be recorded raises :class:`CaptureError`."""
        _record_on_collections(self.collections, self.graph, device)

    def run(self, device=None) -> None:
        """Execute the captured graph on the taskpool's collections.

        ``device`` is the context's CUDA device module (reads its fresh
        device copies and leaves the results as device copies), or a
        torch device: None means cuda:0, and raises without a card;
        ``"cpu"`` runs the bodies eagerly over host tensors.  Without a
        device module the results are stored back as host copies."""
        _run_on_collections(self.collections, self.graph, device,
                            self.donate)


def _plan_taskpool(tp: PTGTaskpool):
    """Planning as a pure function of the taskpool: enumerate instances,
    resolve dependence edges, topo-sort. Returns
    ``(order, class_ast_by_name, valid_instance_keys)``."""
    class_ast = {tc.ast.name: tc.ast for tc in tp.task_classes}
    insts: Dict[Tuple, _Instance] = {}
    for tc in tp.task_classes:
        for locals_ in tc.iter_space():
            inst = _Instance(tc, locals_, tc.env_of(locals_))
            insts[inst.key] = inst
    for inst in insts.values():
        for f in inst.tc.ast.flows:
            for d in f.deps_in():
                t = d.resolve(inst.env)
                if t is None or t.kind != "task":
                    continue
                for args in _expand_args(t.args, inst.env):
                    pkey = (t.task_class,
                            _producer_locals(class_ast, t.task_class, args))
                    if pkey not in insts:
                        # a dep line resolving to an out-of-space
                        # instance is inapplicable, not an error:
                        # activations are producer-driven, so a
                        # nonexistent producer simply never fires
                        # (another dep supplies this input)
                        continue
                    inst.preds.append(pkey)
    # Kahn
    indeg = {k: len(i.preds) for k, i in insts.items()}
    succs: Dict[Tuple, List[Tuple]] = {k: [] for k in insts}
    for k, i in insts.items():
        for p in i.preds:
            succs[p].append(k)
    ready = [k for k, n in indeg.items() if n == 0]
    order: List[_Instance] = []
    while ready:
        k = ready.pop()
        order.append(insts[k])
        for s in succs[k]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(order) != len(insts):
        stuck = [k for k, n in indeg.items() if n > 0][:5]
        raise CaptureError(f"dependency cycle in task graph near {stuck}")
    return order, class_ast, set(insts)


def _producer_locals(class_ast, class_name: str, arg_values: Tuple) -> Tuple:
    """Consumer-side instance lookup: translate dep-target args from the
    producer's param order to its locals order (ast.py)."""
    past = class_ast.get(class_name)
    if past is None:
        return tuple(arg_values)
    return past.locals_from_param_args(arg_values)


def plan(tp: PTGTaskpool) -> List[_Instance]:
    """Symbolically enumerate ``tp``'s task instances in topological
    order with resolved predecessor lists — the planning half of capture,
    usable standalone without compiling bodies."""
    order, _class_ast, _keys = _plan_taskpool(tp)
    return order


def _device_of(device):
    """(device module or None, torch device) for a ``run(device=…)``."""
    from ...devices import resolve_device
    if hasattr(device, "torch_device"):
        return device, device.torch_device
    return None, resolve_device(device)


def _on_stream(module):
    """Run on the device module's stream, which orders every launch and
    copy of the module: the graph's input copies then read its tiles
    after their producers, and its later launches read the results after
    the replay.  Without a module: the current stream."""
    return module.on_stream() if module is not None \
        else contextlib.nullcontext()


def _gather(collections, module) -> Dict[Tuple, Any]:
    """Every tile's payload: the device module's copy when it holds the
    newest version, else the host copy (synchronised home)."""
    tiles: Dict[Tuple, Any] = {}
    for name, coll in collections.items():
        for coords in coll.tiles():
            data = coll.data_of(*coords)
            if module is not None:
                dc = data.get_copy(module.device_index)
                if dc is not None and dc.payload is not None \
                        and dc.version >= data.newest_copy().version:
                    tiles[(name, coords)] = dc.payload
                    continue
            tiles[(name, coords)] = data.sync_to_host().payload
    return tiles


def _record_on_collections(collections, graph: GraphRunner,
                           device=None) -> None:
    module, tdev = _device_of(device)
    if tdev.type != "cuda":
        raise ValueError(f"record: a CUDA graph needs a CUDA device, got "
                         f"{tdev}")
    with _on_stream(module):
        graph.record(_gather(collections, module), tdev)


def _run_on_collections(collections, graph: GraphRunner, device=None,
                        donate: bool = False) -> None:
    """Gather tile payloads, run the graph, store every written tile back
    as the newest copy: on the device module when one is given, else on
    the host."""
    module, tdev = _device_of(device)
    with _on_stream(module):
        out = graph.run(_gather(collections, module), tdev, donate)
    for (name, coords), arr in out.items():
        data = collections[name].data_of(*coords)
        if module is not None:
            dc = data.get_copy(module.device_index)
            if dc is None:
                dc = DataCopy(data, module.device_index, payload=arr)
                data.attach_copy(dc)
            else:
                dc.payload = arr
            data.version_bump(module.device_index)
        else:
            data.host_copy().payload = arr.detach().to("cpu").numpy()
            data.version_bump(0)


def capture(tp: PTGTaskpool, donate: bool = False) -> CapturedTaskpool:
    """Capture a PTG taskpool's full DAG into one graph."""
    return CapturedTaskpool(tp, donate=donate)


class CapturedSequence:
    """Several taskpools executed in order as ONE graph — the captured
    analog of sequential add_taskpool/wait composition (parsec_compose,
    compound.c): later pools see earlier pools' tile writes through the
    shared collections. e.g. dposv = dpotrf ; trsm_lower ;
    trsm_lower_trans as a single replay."""

    def __init__(self, tps: List[PTGTaskpool], donate: bool = False) -> None:
        if not tps:
            raise CaptureError("empty taskpool sequence")
        self.stages = [CapturedTaskpool(tp) for tp in tps]
        self.donate = donate
        # shared state is keyed by collection OBJECT: stages may bind the
        # same collection under different global names (dpotrf's descA is
        # dtrsm's descL) and must still see each other's writes. A name
        # reused for a DIFFERENT object would silently fork state — error.
        self._canon_name: Dict[int, str] = {}   # id(coll) -> external name
        self.collections: Dict[str, Any] = {}   # external name -> coll
        seen_names: Dict[str, int] = {}
        for cg in self.stages:
            for name, coll in cg.collections.items():
                cid = id(coll)
                if name in seen_names and seen_names[name] != cid:
                    raise CaptureError(
                        f"collection name {name!r} bound to different "
                        f"objects across the sequence")
                seen_names[name] = cid
                if cid not in self._canon_name:
                    self._canon_name[cid] = name
                    self.collections[name] = coll
        self.graph = GraphRunner(self._execute, "capture_sequence(" + ", ".join(
            cg.tp.name for cg in self.stages) + ")", self.written)

    @property
    def nb_tasks(self) -> int:
        return sum(cg.nb_tasks for cg in self.stages)

    def written(self) -> List[Tuple]:
        """As :meth:`CapturedTaskpool.written`, under the sequence's
        collection names."""
        return list(dict.fromkeys(
            (self._canon_name[id(cg.collections[name])], coords)
            for cg in self.stages for name, coords in cg.written()))

    def _execute(self, tiles: Dict[Tuple, Any], device: torch.device,
                 note=lambda label: None) -> Dict[Tuple, Any]:
        # object-keyed store; stages view it under their own local names
        store = {(id(self.collections[name]), coords): v
                 for (name, coords), v in tiles.items()}
        for cg in self.stages:
            names = {id(coll): name for name, coll in cg.collections.items()}
            sub = {(names[cid], coords): v for (cid, coords), v in store.items()
                   if cid in names}
            out = cg._execute(sub, device, note)
            for (name, coords), v in out.items():
                store[(id(cg.collections[name]), coords)] = v
        return {(self._canon_name[cid], coords): v
                for (cid, coords), v in store.items()}

    def record(self, device=None) -> None:
        """As :meth:`CapturedTaskpool.record`, for the whole sequence."""
        _record_on_collections(self.collections, self.graph, device)

    def run(self, device=None) -> None:
        """As :meth:`CapturedTaskpool.run`, for the whole sequence."""
        _run_on_collections(self.collections, self.graph, device,
                            self.donate)


def capture_sequence(tps: List[PTGTaskpool],
                     donate: bool = False) -> CapturedSequence:
    """Capture a sequential taskpool composition into one graph."""
    return CapturedSequence(tps, donate=donate)
