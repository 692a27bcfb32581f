"""Cross-pool stage chaining.

Sequentially composed taskpools (dposv = dpotrf ; trsm_fwd ; trsm_bwd)
hand their tiles over at every pool boundary: pool K's final stage
completes, ``wait()`` quiesces, and pool K+1's first stage pays a fresh
stage-in plus a full dispatch for tiles that never needed to leave the
card.  This module is the CapturedSequence trick at STAGE granularity:
when a declared pool sequence's inter-pool dataflow is provable, the
final stage of pool K and the first stage(s) of pool K+1 record into
ONE chained program (one CUDA graph) executed as pool K's stage task,
and pool K+1 CONSUMES its stages' pre-computed outputs at startup (zero
dispatch, tiles stay device-resident).  Chains cascade: a pool that
rides a chain whole is itself fused onward, so a fully-lowerable dposv
runs as one program.

The dataflow proof (``boundary_verdict``): pool K+1's first stage S
must await NO task-sourced activations (``layout.goal == 0`` — all its
inputs are memory tiles), every tile S touches must be rank-local, and
every pool-of-the-segment writer of any tile S reads must be FUSED
into the segment's in-program stages (a residue or foreign writer
could still mutate the tile between the chained dispatch and pool
K+1's startup, so it rejects the boundary).  Later stages of pool K+1
may await activations whose producers are all in-program.  Rejections
are recorded with a reason string — surfaced by ``python -m
parsec_tpu_torch.analysis --lower-report`` — and are distinct from
chain FALLBACKS (a planned chain whose host program failed to record
at runtime; counted in ``chain_fallbacks``).

Everything rides the existing knobs and caches: ``stage_compile`` must
be on, ``stage_compile_chain`` gates the feature (default on), and the
chained program is cached under the host pool's spec token beside the
per-stage programs — a repeat dposv over the same geometry replays it
without recording again.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..utils import logging as plog
from ..utils.params import params
from .lower import build_stage_fn, spec_token, stage_signature
from .plan import StagePlan

__all__ = ["ChainLink", "HostChain", "ChainState", "declare_chain",
           "boundary_verdict", "build_chain_run"]


def _canon(coll: Any, coords: Tuple) -> Tuple:
    """Canonical tile identity ACROSS pools: collection OBJECT + coords
    (pools bind the same collection under different global names —
    dpotrf's descA is dtrsm's descL)."""
    return (id(coll), coords)


class ChainLink:
    """One rider: a later pool's stage fused into the chained program
    of an earlier pool's final stage.  A rider may contribute a
    multi-stage PREFIX: stage 0 must be memory-fed (the
    original proof), stages 1..k may await ACTIVATIONS as long as every
    producer is itself fused — ``act_binds`` names, per act slot, the
    in-program (producer_key, producer_flow) whose post-body value
    feeds it through the chained program's edge store."""

    __slots__ = ("tp", "stage", "layout", "codes", "mem_canon",
                 "colls", "n_out", "act_binds")

    def __init__(self, tp, stage, layout, act_binds=()) -> None:
        from .lower import spec_codes
        self.tp = tp
        self.stage = stage
        self.layout = layout
        self.codes = spec_codes(tp)
        #: slot order -> canonical tile key; colls holds the strong
        #: refs that keep the canonical ids valid
        self.colls = {name: c for name, c in tp.global_env.items()
                      if hasattr(c, "data_of")}
        self.mem_canon = [
            _canon(self.colls[name], coords)
            for (name, coords), _a in layout.mem_slots]
        self.n_out = len(layout.out_mem) + len(layout.edge_outs)
        #: layout.act_slots order -> (producer member key, flow name)
        self.act_binds = list(act_binds)


class HostChain:
    """The chain segment seen from its HOST pool: the riders fused
    after the host's final stage, plus the extra packed-buffer inputs
    (tiles riders read that neither the host stage binds nor an
    earlier in-program stage produces)."""

    __slots__ = ("host_stage_index", "riders", "extra")

    def __init__(self, host_stage_index: int, riders: List[ChainLink],
                 extra: List[Tuple[Any, Tuple]]) -> None:
        self.host_stage_index = host_stage_index
        self.riders = riders
        self.extra = extra       # [(collection object, coords)]


class ChainState:
    """Per-context chain registry (``context._stage_chain``): which
    pools host a chained program, which consume a stash, the stashed
    rider outputs, and the plan-time boundary rejections.  Entries are
    consumed as pools install/execute; ``sweep`` (run at every
    declaration) drops the strong refs of fully-consumed pools so a
    long-lived context declaring many compositions stays bounded."""

    def __init__(self) -> None:
        self.hosts: Dict[int, HostChain] = {}       # id(host_tp) ->
        #: id(rider_tp) -> fused ChainLinks in stage order (a rider may
        #: contribute a multi-stage prefix)
        self.consumes: Dict[int, List[ChainLink]] = {}
        self.stash: Dict[int, Any] = {}             # id(rider_tp) ->
        self.rejects: List[Tuple[str, str, str]] = []
        self._keep: List[Any] = []   # strong refs: ids stay valid

    def sweep(self) -> None:
        live = set(self.hosts) | set(self.consumes) | set(self.stash)
        self._keep = [tp for tp in self._keep if id(tp) in live]
        if len(self.rejects) > 64:
            del self.rejects[:-64]


def _pool_writers_canon(tp, plan: StagePlan) -> Dict[Tuple, List[Tuple]]:
    """plan.mem_writers rekeyed by canonical tile identity."""
    out: Dict[Tuple, List[Tuple]] = {}
    for (name, coords), writers in plan.mem_writers.items():
        coll = tp.global_env.get(name)
        if coll is None:
            continue
        out.setdefault(_canon(coll, coords), []).extend(writers)
    return out


def _tiles_verdict(seg: List[Tuple[Any, StagePlan, Any]],
                   tp_b, layout_b) -> Optional[str]:
    """The tile half of the dataflow proof: every tile the candidate
    stage touches must be rank-local, and every segment-pool writer of
    a tile it reads must be FUSED in-program (``seg`` carries each
    pool's fused member-key set).  None = fusable; else the reason."""
    seg_writers = [(tp_a, _pool_writers_canon(tp_a, plan_a), fused_a)
                   for tp_a, plan_a, fused_a in seg]
    for (name, coords), _access in layout_b.mem_slots:
        coll = tp_b.global_env.get(name)
        if coll is None or not hasattr(coll, "rank_of"):
            return f"unresolvable collection {name!r}"
        if coll.rank_of(*coords) != tp_b.rank:
            return (f"tile {name}{coords} lives on rank "
                    f"{coll.rank_of(*coords)} — cross-rank dataflow "
                    f"is not fusable")
        ck = _canon(coll, coords)
        for tp_a, writers_a, fused_a in seg_writers:
            for wk in writers_a.get(ck, ()):
                if wk not in fused_a:
                    return (f"tile {name}{coords} is written by "
                            f"{wk[0]}{wk[1]} of {tp_a.name}, outside "
                            f"its fused stage(s)")
    return None


def boundary_verdict(seg: List[Tuple[Any, StagePlan, Any]],
                     tp_b, plan_b: StagePlan) -> Optional[str]:
    """Is pool B's first stage fusable onto the segment ``seg``
    (``[(tp, plan, fused_member_keys)]``, host first)?  None = fusable;
    else the chain-rejection reason (``--lower-report`` prints it
    verbatim)."""
    if plan_b is None or not plan_b.stages or not plan_b.prepared:
        return "no compilable first stage in the next pool"
    stage_b, layout_b, _prio = plan_b.prepared[0]
    if layout_b.goal or layout_b.act_slots:
        return (f"first stage awaits {layout_b.goal} task-sourced "
                f"activation(s) — only memory-fed stages chain")
    return _tiles_verdict(seg, tp_b, layout_b)


def _act_binds(tp_b, plan_b: StagePlan, stage_b, layout_b,
               fused_b: set, eavail: set):
    """The activation half of the proof: a NON-FIRST stage
    of pool B may await task-sourced activations as long as EVERY
    producer is an already-fused stage of the same pool — its value
    then flows through the chained program's edge store instead of a
    runtime activation.  Returns the per-act-slot (producer_key,
    producer_flow) bind list, or a reason string.

    Conservatism mirrors ``lower.build_stage_fn``'s first-applicable
    binding walk: each act slot must be bound by its flow's FIRST
    resolvable dep, and that dep must name exactly the in-program
    producer (an act slot the fused walk would never read has no
    provable in-program value — reject)."""
    from ..dsl.ptg.runtime import _expand_args
    from ..dsl.ptg.capture import _producer_locals
    class_ast = {tc.ast.name: tc.ast for tc in tp_b.task_classes}
    insts = plan_b.inst_by_key
    mkeys = stage_b.member_keys
    binds: Dict[Tuple, Tuple] = {}
    for inst in stage_b.members:
        env = inst.env
        for f in inst.tc.ast.flows:
            first = None
            try:
                for d in f.deps_in():
                    t = d.resolve(env)
                    if t is None:
                        continue
                    if first is None:
                        first = t
                    if t.kind == "task":
                        for args in _expand_args(t.args, env):
                            pk = (t.task_class, _producer_locals(
                                class_ast, t.task_class, args))
                            if pk in insts and pk not in mkeys \
                                    and pk not in fused_b:
                                return (
                                    f"{inst.key[0]}{inst.key[1]}."
                                    f"{f.name} awaits {pk[0]}{pk[1]}, "
                                    f"which is not fused in-program")
            except Exception as exc:  # noqa: BLE001 - proof, not error
                return (f"unresolvable binding on "
                        f"{inst.key[0]}{inst.key[1]}.{f.name} ({exc})")
            if f.is_ctl:
                continue
            ak = (inst.key, f.name)
            if ak not in layout_b.act_index:
                continue
            if first is None or first.kind != "task":
                return (f"act slot {inst.key[0]}{inst.key[1]}."
                        f"{f.name} is not bound by its first dep — "
                        f"no provable in-program value")
            try:
                pk = (first.task_class, _producer_locals(
                    class_ast, first.task_class,
                    tuple(a(env) for a in first.args)))
            except Exception as exc:  # noqa: BLE001 - proof, not error
                return (f"unresolvable producer of "
                        f"{inst.key[0]}{inst.key[1]}.{f.name} ({exc})")
            if pk in mkeys:
                # intra-stage edge: build_stage_fn resolves it through
                # its own out_store, not an act slot
                continue
            if pk not in fused_b:
                return (f"act slot {inst.key[0]}{inst.key[1]}."
                        f"{f.name} binds {pk[0]}{pk[1]}, which is not "
                        f"fused in-program")
            if (pk, first.flow) not in eavail:
                return (f"act slot {inst.key[0]}{inst.key[1]}."
                        f"{f.name} binds {pk[0]}{pk[1]}.{first.flow}, "
                        f"which is not an in-program edge output")
            binds[ak] = (pk, first.flow)
    out = []
    for ak in layout_b.act_slots:
        b = binds.get(ak)
        if b is None:
            return (f"act slot {ak[0][0]}{ak[0][1]}.{ak[1]} has no "
                    f"in-program bind")
        out.append(b)
    return out


def _stage_verdict(seg: List[Tuple[Any, StagePlan, Any]], tp_b,
                   plan_b: StagePlan, stage_b, layout_b, fused_b: set,
                   eavail: set):
    """Full verdict for fusing a NON-FIRST stage of pool B: its tiles
    must stay in-program — counting pool B's OWN earlier writers, which
    must be fused or stage members — and every task input must bind to
    an already-fused stage.  Returns the act bind list or a reason."""
    reason = _tiles_verdict(
        seg + [(tp_b, plan_b, fused_b | stage_b.member_keys)],
        tp_b, layout_b)
    if reason is not None:
        return reason
    return _act_binds(tp_b, plan_b, stage_b, layout_b, fused_b, eavail)


def declare_chain(context, tps: List[Any]) -> Optional[ChainState]:
    """Declare a sequential taskpool composition for cross-pool stage
    chaining.  Call BEFORE the usual ``add_taskpool``/``wait`` loop;
    pools then execute exactly as they always did, except that fusable
    boundary stages run inside one chained program.  Ineligible
    boundaries are recorded (``ChainState.rejects``) and execute
    unchained — never an error.  Returns the context's ChainState, or
    None when chaining is off/ineligible."""
    if len(tps) < 2 or not params.get("stage_compile") \
            or not params.get("stage_compile_chain"):
        return None
    if not any(d.device_type == "cuda" for d in context.devices):
        return None
    from .runtime import prepared_plan
    state = getattr(context, "_stage_chain", None)
    if state is None:
        state = ChainState()
        context._stage_chain = state
    state.sweep()   # previous compositions' consumed entries retire
    state._keep.extend(tps)

    plans: List[Optional[StagePlan]] = []
    for tp in tps:
        try:
            plans.append(prepared_plan(tp, context))
        except Exception as exc:  # noqa: BLE001 - unplannable: no chain
            plog.debug.verbose(2, "stagec chain: %s not plannable (%s)",
                               tp.name, exc)
            plans.append(None)

    # segment walk: host = a pool whose final stage DISPATCHES; each
    # rider contributes its longest provable stage PREFIX (stage 0
    # memory-fed, later stages bound to already-fused producers), and
    # the segment cascades through a pool only when
    # ALL of its stages fused (its final stage is then in-program)
    seg: List[Tuple[Any, StagePlan, Any]] = []
    seg_links: List[ChainLink] = []
    host_idx: Optional[int] = None

    def close_segment() -> None:
        nonlocal seg, seg_links, host_idx
        if host_idx is not None and seg_links:
            host_tp, host_plan = tps[host_idx], plans[host_idx]
            host_stage = host_plan.stages[-1]
            extra = _extra_slots(host_tp, host_plan, host_stage,
                                 seg_links)
            state.hosts[id(host_tp)] = HostChain(
                host_stage.index, list(seg_links), extra)
            for link in seg_links:
                state.consumes.setdefault(id(link.tp), []).append(link)
            plog.debug.verbose(
                2, "stagec chain: %s hosts %d rider stage(s) [%s]",
                host_tp.name, len(seg_links),
                ", ".join(l.tp.name for l in seg_links))
        seg, seg_links, host_idx = [], [], None

    for k in range(len(tps) - 1):
        tp_a, plan_a = tps[k], plans[k]
        tp_b, plan_b = tps[k + 1], plans[k + 1]
        if host_idx is None:
            if plan_a is None or not plan_a.stages:
                state.rejects.append(
                    (tp_a.name, tp_b.name,
                     "no compilable final stage in the earlier pool"))
                continue
            seg = [(tp_a, plan_a, set(plan_a.stages[-1].member_keys))]
            host_idx = k
        reason = boundary_verdict(seg, tp_b, plan_b)
        if reason is not None:
            state.rejects.append((tp_a.name, tp_b.name, reason))
            close_segment()
            continue
        fused_b: set = set()
        eavail_b: set = set()
        b_links: List[ChainLink] = []
        for (stage_k, layout_k, _prio) in plan_b.prepared:
            if not b_links:
                binds: Any = []   # first stage: memory-fed, proved above
            else:
                binds = _stage_verdict(seg, tp_b, plan_b, stage_k,
                                       layout_k, fused_b, eavail_b)
                if isinstance(binds, str):
                    state.rejects.append(
                        (tp_a.name, tp_b.name,
                         f"stage#{stage_k.index}: {binds}"))
                    break
            b_links.append(ChainLink(tp_b, stage_k, layout_k, binds))
            fused_b |= stage_k.member_keys
            eavail_b.update(layout_k.edge_outs)
        seg_links.extend(b_links)
        if len(b_links) == len(plan_b.stages):
            # whole pool in-program: the segment cascades through it
            seg.append((tp_b, plan_b, fused_b))
        else:
            close_segment()
    close_segment()
    return state


def _extra_slots(host_tp, host_plan: StagePlan, host_stage,
                 riders: List[ChainLink]) -> List[Tuple[Any, Tuple]]:
    """Tiles the riders read that the host stage neither binds nor an
    earlier in-program stage produces: they join the chained program's
    packed buffer as extra READ inputs."""
    host_colls = {name: c for name, c in host_tp.global_env.items()
                  if hasattr(c, "data_of")}
    # host layout binds every tile its members touch; find them through
    # the prepared layout (same object the runtime dispatches with)
    host_layout = next(lay for st, lay, _p in host_plan.prepared
                       if st.index == host_stage.index)
    bound = {_canon(host_colls[name], coords)
             for (name, coords), _a in host_layout.mem_slots}
    produced = set(bound)
    extra: List[Tuple[Any, Tuple]] = []
    seen = set()
    for link in riders:
        for ck, ((name, coords), _a) in zip(link.mem_canon,
                                            link.layout.mem_slots):
            if ck not in produced and ck not in seen:
                seen.add(ck)
                extra.append((link.colls[name], coords))
        produced.update(
            link.mem_canon[si] for si in link.layout.out_mem)
    return extra


def build_chain_run(host_tp, host_stage, host_layout, host_codes,
                    chain: HostChain):
    """The CHAINED stage function: host slots (+ the chain's extra
    tiles) in, host outputs followed by every rider's outputs back.
    Later links read earlier links' written tiles through a canonically-
    keyed in-program tile store — the CapturedSequence composition, at
    stage granularity.  Same calling convention as
    ``lower.build_stage_fn`` (``run(*slots, device=, note=)``)."""
    host_run = build_stage_fn(host_tp, host_stage, host_layout,
                              host_codes)
    rider_runs = [(link, build_stage_fn(link.tp, link.stage,
                                        link.layout, link.codes))
                  for link in chain.riders]
    n_host = host_layout.n_flows
    host_colls = {name: c for name, c in host_tp.global_env.items()
                  if hasattr(c, "data_of")}
    host_canon = [_canon(host_colls[name], coords)
                  for (name, coords), _a in host_layout.mem_slots]
    extra_canon = [_canon(coll, coords) for coll, coords in chain.extra]

    def run(*bufs, device=None, note=None):
        store = {ck: bufs[i] for i, ck in enumerate(host_canon)}
        for j, ck in enumerate(extra_canon):
            store[ck] = bufs[n_host + j]
        # in-program edge store: (pool id, producer key, flow) -> value,
        # feeding later links' activation slots (multi-stage prefixes)
        estore: Dict[Tuple, Any] = {}
        host_outs = host_run(*bufs[:n_host], device=device, note=note)
        for oi, si in enumerate(host_layout.out_mem):
            store[host_canon[si]] = host_outs[oi]
        outs = list(host_outs)
        for link, rfn in rider_runs:
            tpid = id(link.tp)
            acts = tuple(estore[(tpid,) + bind] for bind in link.act_binds)
            routs = rfn(*(tuple(store[ck] for ck in link.mem_canon)
                          + acts), device=device, note=note)
            for oi, si in enumerate(link.layout.out_mem):
                store[link.mem_canon[si]] = routs[oi]
            n_t = len(link.layout.out_mem)
            for ek, val in zip(link.layout.edge_outs, routs[n_t:]):
                estore[(tpid, ek[0], ek[1])] = val
            outs.extend(routs)
        return tuple(outs)

    return run


def chain_signature(rec_shapes: Tuple, host_stage, chain: HostChain,
                    donate: Tuple) -> Tuple:
    """Cache key of one chained program (under the HOST pool's spec
    token): host stage signature over the FULL slot shapes, each
    rider's (spec token, stage signature), the donate flag."""
    riders = tuple(
        (spec_token(link.tp), stage_signature(link.stage, ()),
         tuple(link.act_binds))
        for link in chain.riders)
    return (stage_signature(host_stage, rec_shapes), riders, donate,
            "chain")
