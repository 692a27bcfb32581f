"""Lowerability pass: partition an instantiated PTG DAG into compilable
stages vs interpreted residue.

Reuses the verdicts the static verifier already computes — the
PTG1xx dataflow checks (:mod:`..analysis.ptg_check`) and the BDY2xx
host-sync predicates (:mod:`..analysis.body_check`) — plus the
capture planner's symbolic DAG enumeration (``dsl/ptg/capture.plan``,
the core behind :mod:`..analysis.dagenum`).  A task CLASS is
lowerable when its accelerator body provably records into a CUDA graph
(no host synchronisation) and is deterministic, and its dependency
edges carry no release-time datatype
conversions; a task INSTANCE additionally needs straight-line per-tile
dataflow (no ranged data inputs) and memory writebacks that land on
tiles this rank owns.  Everything else is residue and keeps the
interpreted per-task/batched dispatch — semantics are never
at risk, only the dispatch amortization.

Stage grouping: local compilable instances are merged across
consecutive dependence levels into one stage as long as no path from a
stage member leaves the stage and re-enters it (the condensed
stage/residue graph must stay acyclic — a residue or remote task both
consuming from and feeding a stage would deadlock it).  The ``taint``
walk below tracks exactly that: non-member instances transitively
downstream of the current stage; a candidate with a tainted
predecessor closes the stage.  ``wavefront=True`` instead emits one
stage per (dependence level, task class) — the grouping the
mesh-sharded variant (stagec/sharded.py) can spread across chips.

Reason codes: BDY2xx / PTG1xx findings are surfaced verbatim; stagec
adds STG3xx for conditions that only matter to the stage compiler:

- ``STG300`` no-accelerator-body: every BODY is cpu/recursive — the
  host interpreter owns the class.
- ``STG302`` edge-reshape: a dependency carries a ``[type*=...]``
  property — the interpreted release path converts datatypes per edge,
  which a recorded stage does not reproduce.
- ``STG303`` masked-writeback: a memory out-dep declares a region-
  masked writeback type; the fused scatter writes whole tiles.
- ``STG304`` ranged-data-input: a data flow's in-dep expands a range
  (multi-producer binding is arrival-order-defined — not recordable).
- ``STG305`` new-without-shape: a NEW input has no evaluable
  ``[shape=...]`` property, so the stage cannot allocate it.
- ``STG306`` operator-excluded: the class is named in the
  ``stage_compile_exclude`` MCA param — a debugging / measurement knob
  (the residue-heavy bench leg rides it).

A host-only class whose body is a NO-OP (``pass`` — the
reader/broadcast classes dtrsm places on tile owners) is lowerable
after all: inside a recorded stage the class contributes
nothing but dataflow (its flow values forward untouched), which is
exactly what the interpreted cpu hook does for a ``pass`` body.  Only
pure forwarders qualify (every non-CTL flow READ): a no-op body behind
a WRITE flow still version-bumps through the interpreted path and is
left alone.

The pass also pre-plans the **residue schedule**: residue
instances with an accelerator body are grouped per (dependence level,
class) at plan time, so the runtime can hand each group to the device
batching pipeline as one burst with zero per-task scheduler
round-trips (see stagec/runtime.StageCompiler.on_residue_ready).
Level-1 (startup) residue keeps the chunked startup hand-off — it is
already scheduled as one burst.
"""
from __future__ import annotations

import ast as pyast
import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

from ..analysis import body_check, ptg_check
from ..dsl.ptg.ast import JDFFile, RangeExpr

#: BDY findings that disqualify a class from stage lowering (202: a host
#: sync cannot be recorded into a CUDA graph; 203 is included:
#: nondeterminism breaks the bit-exact compiled-vs-interpreted contract
#: the runtime integration gates on)
_BDY_DISQUALIFYING = ("BDY200", "BDY201", "BDY202", "BDY203")


@dataclasses.dataclass
class ClassVerdict:
    """Per-task-class lowerability: ``ok`` or the finding that blocks.
    ``note`` annotates an ok verdict (e.g. the no-op forwarder
    relaxation) without changing it."""
    name: str
    ok: bool
    code: Optional[str] = None
    reason: Optional[str] = None
    note: Optional[str] = None

    def __str__(self) -> str:
        if self.ok:
            return (f"{self.name}: compilable"
                    + (f" ({self.note})" if self.note else ""))
        return f"{self.name}: fallback [{self.code}] {self.reason}"


class Stage:
    """One compilable stage: an ordered set of local task instances
    lowered into a single recorded program (one CUDA graph)."""

    __slots__ = ("index", "members", "member_keys", "level_lo", "level_hi")

    def __init__(self, index: int) -> None:
        self.index = index
        self.members: List[Any] = []       # capture._Instance, topo order
        self.member_keys: Set[Tuple] = set()
        self.level_lo = self.level_hi = 0

    def add(self, inst, level: int) -> None:
        if not self.members:
            self.level_lo = level
        self.members.append(inst)
        self.member_keys.add(inst.key)
        self.level_hi = level

    @property
    def n_tasks(self) -> int:
        return len(self.members)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<Stage#{self.index} {self.n_tasks} tasks "
                f"levels {self.level_lo}..{self.level_hi}>")


class StagePlan:
    """The lowerability pass's output for one instantiated taskpool."""

    __slots__ = ("order", "stages", "member_stage", "verdicts",
                 "inst_by_key", "n_local", "n_residue", "prepared",
                 "levels", "residue_groups", "residue_groups_host",
                 "mem_writers", "local_keys", "startup_goal0",
                 "startup_mem_puts", "xwaves", "xwave_report")

    def __init__(self, order, stages, member_stage, verdicts,
                 n_local: int, n_residue: int) -> None:
        #: [(stage, StageLayout, priority)] — filled by the runtime's
        #: cached prepare step (stagec/runtime.try_install)
        self.prepared: List[Tuple] = []
        self.order = order                  # global topo instance order
        self.stages: List[Stage] = stages
        #: (class_name, locals) -> stage index
        self.member_stage: Dict[Tuple, int] = member_stage
        self.verdicts: Dict[str, ClassVerdict] = verdicts
        self.inst_by_key = {i.key: i for i in order}
        self.n_local = n_local
        self.n_residue = n_residue
        #: instance key -> dependence level (1 = no task preds)
        self.levels: Dict[Tuple, int] = {}
        #: compiled residue schedule: pre-planned
        #: per-(level, class) groups of LOCAL residue instance keys at
        #: levels >= 2 — the runtime buffers each group's ready tasks
        #: and hands the complete group to the device batching pipeline
        #: as one burst (zero per-task scheduler round-trips)
        self.residue_groups: List[List[Tuple]] = []
        #: host-bodied residue groups: same per-(level,
        #: class) pre-planning for classes the HOST interpreter owns —
        #: the runtime schedules each complete group as one pre-planned
        #: burst instead of a per-task activate/schedule round-trip
        self.residue_groups_host: List[List[Tuple]] = []
        #: cross-rank SPMD waves (stagec/xrank.py): filled by
        #: plan_xwaves when stage_compile_xrank is on and nb_ranks > 1
        self.xwaves: List[Any] = []
        #: [(level, class, text)] — per-(level, class) cross-rank
        #: eligibility verdicts (the --lower-report column)
        self.xwave_report: List[Tuple] = []
        #: (collection name, coords) -> ordered instance keys with a
        #: memory out-dep landing on that tile, over the FULL (all-rank)
        #: instance order — the chain planner's dataflow proof and the
        #: prestager's final-value check both read it
        self.mem_writers: Dict[Tuple, List[Tuple]] = {}
        #: instance keys local to this rank (plan_stages' rank_of walk)
        self.local_keys: Set[Tuple] = set()
        #: plan-cached startup enumeration: the goal-0 LOCAL
        #: residue instances and the foreign mem-put expectation, so a
        #: stagec _startup skips the per-instance iteration-space walk
        #: (a pure function of the plan identity — filled by
        #: stagec/runtime.prepared_plan)
        self.startup_goal0: List[Tuple] = []
        self.startup_mem_puts = 0

    @property
    def n_staged(self) -> int:
        return sum(s.n_tasks for s in self.stages)


def _finding_class(f) -> str:
    """The task class a body_check finding names (its messages lead
    with the class name: '<cls> BODY[dev]: ...' / '<cls>: ...')."""
    head = f.message.split(None, 1)[0] if f.message else ""
    return head.rstrip(":")


def _class_edge_reshape(tc) -> bool:
    for f in tc.flows:
        for d in f.deps:
            for k in ("type", "type_remote"):
                if k in d.properties:
                    return True
    return False


def _class_masked_writeback(tc) -> bool:
    for f in tc.flows:
        for d in f.deps_out():
            targets = [x for x in (d.target, d.alt_target) if x is not None]
            if not any(x.kind == "memory" for x in targets):
                continue
            nm = d.properties.get("type_data") or d.properties.get("type")
            if nm is not None and nm != "full":
                return True
    return False


def _class_ranged_data_input(tc) -> bool:
    for f in tc.flows:
        if f.is_ctl:
            continue
        for d in f.deps_in():
            for t in (d.target, d.alt_target):
                if t is None or t.kind != "task":
                    continue
                if any(isinstance(a, RangeExpr) for a in t.args):
                    return True
    return False


def _noop_forwarder(tc) -> bool:
    """The STG300 relaxation: a host-only class whose body is a no-op
    (``pass`` / docstring only) and whose non-CTL flows are all READ
    forwards its inputs untouched — inside a recorded stage it is pure
    dataflow, identical to what the interpreted cpu hook does."""
    if any(f.access != "READ" for f in tc.flows if not f.is_ctl):
        return False
    body = tc.bodies[0]
    try:
        tree = pyast.parse(body.code)
    except SyntaxError:
        return False
    return all(isinstance(node, pyast.Pass)
               or (isinstance(node, pyast.Expr)
                   and isinstance(node.value, pyast.Constant))
               for node in tree.body)


def _excluded_classes() -> Tuple[str, ...]:
    """Operator-excluded classes (``stage_compile_exclude``)."""
    from ..utils.params import params
    raw = str(params.get_or("stage_compile_exclude", "string", "") or "")
    return tuple(sorted(s.strip() for s in raw.split(",") if s.strip()))


class IdKey:
    """Hashable identity wrapper: keys a cache by object IDENTITY while
    holding a strong reference, so a recycled id can never alias a dead
    object's entries (JDFFile is an eq-dataclass — unhashable itself).
    The spec token of lower.py leads with one; the stage cache
    (devices/batching.cached_stage_callable) hangs off its ``obj``."""

    __slots__ = ("obj",)

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, IdKey) and other.obj is self.obj


#: verdicts are a pure function of the AST plus the
#: ``stage_compile_exclude`` knob (a knob change must never hit a stale
#: verdict); re-deriving them per taskpool would tax every repeat run's
#: startup.  The memo lives ON the parsed spec
#: (``jdf._ptt_stagec_verdicts``: exclusion set -> verdicts), so it goes
#: when the spec goes.
_VERDICT_MEMO_MAX = 64


def class_verdicts(jdf: JDFFile) -> Dict[str, ClassVerdict]:
    """Per-task-class lowerability over a parsed JDF, reusing the
    analysis/ verdicts: PTG1xx dataflow errors poison the whole
    spec (an unsound graph is not worth fusing), BDY2xx record-safety
    findings disqualify their class, and the STG3xx structural checks
    cover what only the stage compiler cares about."""
    excluded = _excluded_classes()
    memos = getattr(jdf, "_ptt_stagec_verdicts", None)
    if memos is None:
        memos = jdf._ptt_stagec_verdicts = {}
    memo = memos.get(excluded)
    if memo is not None:
        return memo
    out: Dict[str, ClassVerdict] = {}
    ptg_findings = [f for f in ptg_check.verify_jdf(jdf)
                    if f.severity == "error"]
    body_findings = body_check.check_jdf_bodies(jdf)
    by_class: Dict[str, Any] = {}
    for f in body_findings:
        if f.code in _BDY_DISQUALIFYING:
            by_class.setdefault(_finding_class(f), f)
    for tc in jdf.task_classes:
        if ptg_findings:
            f = ptg_findings[0]
            out[tc.name] = ClassVerdict(tc.name, False, f.code, f.message)
            continue
        if tc.name in excluded:
            out[tc.name] = ClassVerdict(
                tc.name, False, "STG306",
                f"{tc.name}: excluded by the stage_compile_exclude knob")
            continue
        bf = by_class.get(tc.name)
        if bf is not None:
            out[tc.name] = ClassVerdict(tc.name, False, bf.code, bf.message)
            continue
        forwarder = False
        if not any(b.device_type not in ("cpu", "recursive")
                   for b in tc.bodies):
            if not _noop_forwarder(tc):
                out[tc.name] = ClassVerdict(
                    tc.name, False, "STG300",
                    f"{tc.name}: no accelerator BODY — the host "
                    f"interpreter owns this class")
                continue
            # no-op forwarder (reader/broadcast class): pure dataflow
            # inside a recorded stage — lowerable despite the cpu BODY
            forwarder = True
        if _class_edge_reshape(tc):
            out[tc.name] = ClassVerdict(
                tc.name, False, "STG302",
                f"{tc.name}: a dependency declares a [type*=...] "
                f"datatype conversion — release-time reshapes are not "
                f"reproduced by a recorded stage")
            continue
        if _class_masked_writeback(tc):
            out[tc.name] = ClassVerdict(
                tc.name, False, "STG303",
                f"{tc.name}: a memory out-dep declares a region-masked "
                f"writeback type — the stage's scatter writes whole tiles")
            continue
        if _class_ranged_data_input(tc):
            out[tc.name] = ClassVerdict(
                tc.name, False, "STG304",
                f"{tc.name}: a data flow's in-dep expands a range — "
                f"multi-producer bindings are arrival-order-defined")
            continue
        out[tc.name] = ClassVerdict(
            tc.name, True,
            note="no-op forwarder body" if forwarder else None)
    while len(memos) >= _VERDICT_MEMO_MAX:
        memos.pop(next(iter(memos)))
    memos[excluded] = out
    return out


def _instance_compilable(tp, inst, verdict: ClassVerdict,
                         rank: int) -> bool:
    """Instance-level residue checks on top of the class verdict:
    memory writebacks must land on tiles this rank owns (a foreign
    writeback rides the comm engine's mem_writeback protocol, which
    the stage's scatter does not speak) and NEW inputs need an evaluable
    shape (STG305)."""
    if not verdict.ok:
        return False
    from ..dsl.ptg.runtime import scratch_shape
    tc_ast = inst.tc.ast
    for i, f in enumerate(tc_ast.flows):
        if f.is_ctl:
            continue
        for d in f.deps_out():
            t = d.resolve(inst.env)
            if t is None or t.kind != "memory":
                continue
            coll = tp.global_env[t.collection]
            if coll.rank_of(*[a(inst.env) for a in t.args]) != rank:
                return False
        for d in f.deps_in():
            t = d.resolve(inst.env)
            if t is not None and t.kind == "new" \
                    and scratch_shape(f, inst.env) is None:
                return False
    return True


def plan_stages(tp, rank: int = 0, max_tasks: int = 256,
                wavefront: bool = False) -> StagePlan:
    """Partition ``tp``'s instantiated DAG into compilable stages plus
    interpreted residue for this rank.  Raises whatever the capture
    planner raises on an unenumerable spec (callers treat that as
    "no stages")."""
    from ..dsl.ptg.capture import plan as _capture_plan
    order = _capture_plan(tp)
    verdicts = class_verdicts(tp.jdf)

    level: Dict[Tuple, int] = {}
    for inst in order:  # topo: preds resolved first
        level[inst.key] = 1 + max((level[p] for p in inst.preds), default=0)

    local = {inst.key for inst in order
             if inst.tc.rank_of_instance(inst.env) == rank}
    ok = {inst.key for inst in order
          if inst.key in local and _instance_compilable(
              tp, inst, verdicts[inst.tc.ast.name], rank)}

    by_level: Dict[int, List[Any]] = {}
    for inst in order:
        by_level.setdefault(level[inst.key], []).append(inst)

    stages: List[Stage] = []
    member_stage: Dict[Tuple, int] = {}

    def close(stage: Optional[Stage]) -> None:
        if stage is not None and stage.members:
            stages.append(stage)

    if wavefront:
        # one stage per (level, class): the grouping the mesh-sharded
        # variant can spread over chips (same-class uniform rows);
        # always condensation-safe — a level is an antichain, so no
        # residue at the same level can sit between two stages
        for lv in sorted(by_level):
            per_class: Dict[str, Stage] = {}
            for inst in by_level[lv]:
                if inst.key not in ok:
                    continue
                st = per_class.get(inst.tc.ast.name)
                if st is None or st.n_tasks >= max_tasks:
                    st = Stage(len(stages))
                    stages.append(st)
                    per_class[inst.tc.ast.name] = st
                st.add(inst, lv)
                member_stage[inst.key] = st.index
    else:
        cur: Optional[Stage] = None
        tainted: Set[Tuple] = set()   # non-members downstream of cur
        for lv in sorted(by_level):
            cands = [i for i in by_level[lv] if i.key in ok]
            others = [i for i in by_level[lv] if i.key not in ok]
            cur_keys = cur.member_keys if cur is not None else set()
            for o in others:
                if any(p in cur_keys or p in tainted for p in o.preds):
                    tainted.add(o.key)
            blocked = any(p in tainted for c in cands for p in c.preds)
            if cur is not None and cands and (
                    blocked or cur.n_tasks + len(cands) > max_tasks):
                close(cur)
                cur, tainted = None, set()
            while len(cands) > max_tasks:   # an antichain splits freely
                st = Stage(len(stages))
                for i in cands[:max_tasks]:
                    st.add(i, lv)
                    member_stage[i.key] = st.index
                close(st)
                cands = cands[max_tasks:]
            if cands:
                if cur is None:
                    cur = Stage(len(stages))
                for i in cands:
                    cur.add(i, lv)
                    member_stage[i.key] = cur.index
        close(cur)

    n_residue = len(local) - len(member_stage)
    plan = StagePlan(order, stages, member_stage, verdicts,
                     n_local=len(local), n_residue=n_residue)
    plan.levels = level
    plan.local_keys = local

    # memory-writeback map over the FULL order (chain proof + prestage
    # final-value checks): tile -> ordered writer instance keys
    for inst in order:
        env = inst.env
        for f in inst.tc.ast.flows:
            if f.is_ctl:
                continue
            for d in f.deps_out():
                t = d.resolve(env)
                if t is not None and t.kind == "memory":
                    coords = tuple(int(a(env)) for a in t.args)
                    plan.mem_writers.setdefault(
                        (t.collection, coords), []).append(inst.key)

    # compiled residue schedule: pre-plan per-(level, class)
    # groups of device-bodied local residue at levels >= 2 (level-1
    # residue is startup — already handed off as one chunked burst).
    # Groups of one save nothing; they keep the per-task path.
    device_cls = {tc.ast.name for tc in tp.task_classes
                  if any(b.device_type not in ("cpu", "recursive")
                         for b in tc.ast.bodies)}
    # host-bodied residue joins the same pre-planning: a
    # complete (level, class) group of HOST tasks schedules as one
    # pre-planned burst instead of per-task scheduler round-trips
    per_group: Dict[Tuple, List[Tuple]] = {}
    per_group_host: Dict[Tuple, List[Tuple]] = {}
    for inst in order:
        k = inst.key
        if k not in local or k in member_stage or level[k] < 2:
            continue
        tgt = per_group if k[0] in device_cls else per_group_host
        tgt.setdefault((level[k], k[0]), []).append(k)
    for gk in sorted(per_group):
        keys = per_group[gk]
        if len(keys) >= 2:
            plan.residue_groups.append(keys)
    for gk in sorted(per_group_host):
        keys = per_group_host[gk]
        if len(keys) >= 2:
            plan.residue_groups_host.append(keys)
    return plan


def lower_report(jdf: JDFFile) -> List[str]:
    """Human-readable per-task-class lowerability report (the
    ``--lower-report`` payload of ``python -m parsec_tpu_torch.analysis``):
    compilable / fallback plus
    the BDY2xx/PTG1xx/STG3xx reason, so a spec author sees why a class
    won't fuse before the first run."""
    verdicts = class_verdicts(jdf)
    lines = [f"{jdf.name}: stage-compile lowerability"]
    for tc in jdf.task_classes:
        lines.append(f"  {verdicts[tc.name]}")
    n_ok = sum(1 for v in verdicts.values() if v.ok)
    lines.append(f"  -- {n_ok}/{len(verdicts)} class(es) compilable")
    return lines


def stage_report(tp, rank: int = 0, max_tasks: int = 256,
                 wavefront: bool = False,
                 plan: Optional[StagePlan] = None) -> List[str]:
    """Per-STAGE verdicts over an instantiated taskpool (the
    ``--lower-report`` per-stage payload of the analysis CLI): how
    the partition actually falls — each stage's size, level span, and
    class mix, plus the residue split and the pre-planned residue
    groups the compiled residue schedule will ride.  ``plan`` reuses
    an already-computed partition (the lint plans each spec once for
    both this report and the chain verdicts)."""
    if plan is None:
        plan = plan_stages(tp, rank=rank, max_tasks=max_tasks,
                           wavefront=wavefront)
    lines: List[str] = []
    for st in plan.stages:
        per_cls: Dict[str, int] = {}
        for m in st.members:
            per_cls[m.tc.ast.name] = per_cls.get(m.tc.ast.name, 0) + 1
        mix = ", ".join(f"{c} x{n}" for c, n in sorted(per_cls.items()))
        lines.append(f"  stage#{st.index}: {st.n_tasks} task(s), "
                     f"levels {st.level_lo}..{st.level_hi} [{mix}]")
    n_grouped = sum(len(g) for g in plan.residue_groups)
    lines.append(
        f"  -- {len(plan.stages)} stage(s) covering {plan.n_staged}/"
        f"{plan.n_local} local task(s), {plan.n_residue} residue"
        + (f" ({len(plan.residue_groups)} residue group(s) pre-planned "
           f"over {n_grouped} task(s))" if plan.residue_groups else ""))
    if plan.residue_groups_host:
        n_host = sum(len(g) for g in plan.residue_groups_host)
        lines.append(
            f"  -- {len(plan.residue_groups_host)} host residue "
            f"group(s) pre-planned over {n_host} task(s)")
    # cross-rank eligibility column (stagec/xrank.py): one line per
    # (level, class) wave group — spanning ranks + boundary edges + collective
    # kind, or the reason it stays rank-local
    for (lv, cls, text) in plan.xwave_report:
        lines.append(f"  xrank level {lv} {cls}: {text}")
    return lines
