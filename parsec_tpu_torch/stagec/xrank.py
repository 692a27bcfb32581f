"""Cross-rank SPMD stages: one program across the ranks of a process.

The stage compiler runs each (level, class) wave front of a rank as one
recorded program; the distributed wave engine already puts every
in-process rank on a lane chip of its own.  This module composes the
two: when ``stage_compile_xrank`` is on and a planned wave-front stage
spans RANKS, the participating ranks run the whole (level, class) wave
as ONE program over their lane chips (``parallel.mesh.xrank_mesh`` over
``dsl.ptg.wave_dist.lane_device_pool``).  Position p of that mesh is the
p-th participating rank; its member rows are ONE CUDA graph recorded on
its lane chip when its stage spawns, replayed on the chip's stream.
Inter-rank dependency edges — activations that would serialize a tile
over the wire — become an in-program gather: each producer position's
boundary tile is copied device to device into every other position's
boundary stack (ordered by CUDA events), and an index tensor, an input
of each position's graph, selects every boundary-fed flow from that
stack (``index_select`` and a ``where`` on the index's sign).  The
gather is pure data movement (a sum of one-hot stacks would turn
``-0.0 + 0.0`` into ``+0.0``), so the wave stays bit-identical to the
interpreted runtime.

The wire then carries CONTROL ONLY for those edges: a producer whose
every consumer edge lands in a cross-rank wave parks a private copy of
the payload in the process-global :data:`XSTORE` and sends the
activation without ``data``/``handle``/``xfer`` (the ``"xs"`` key names
the parked entry); each consumer rank takes it at delivery.  So every
rank holds real payloads before its stage dispatches, and a wave a rank
declines still runs rank-local on its peers with nothing lost.

Negotiation mirrors the other HELLO capabilities: the TCP HELLO
advertises ``"xs"`` with a per-process random token, and a link
negotiates it only when the tokens are EQUAL (both ranks share this
process, its chips and streams).  Mixed-version peers, separate
processes and knob-unset peers keep the activation path bit-for-bit.
An in-process fabric (no ``xstage_to``) is gated by the knob alone.
Before any wave dispatches, the participants exchange a digest of the
whole cross-rank plan and RAISE on divergence.

Dispatch is a process-global rendezvous keyed (digest, install epoch,
wave id): each participating rank deposits its member rows (and private
copies of the boundary payloads it consumes), the LAST depositor runs
every position's block, and every rank takes its own rows back.  The
ladder, one wave at a time:

- a rank whose stage downgrades (its block cannot be recorded) DECLINES
  the rendezvous: its peers run the wave's rows rank-local
  (``xstage_fallbacks`` counts each rank that left the wave);
- an assembly, record or launch error, a rendezvous that times out
  (``stage_xrank_timeout``) or a peer that dies ERRORS the rendezvous
  and raises on every participant — no path quietly moves the wave to
  the CPU or to the rank-local program;
- lane chips that are not distinct (one card and no
  ``device_cuda_virtual_chips``) raise at install, on every rank.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..comm.engine import TAG_USER_BASE
from ..utils import logging as plog
from ..utils.params import params

__all__ = ["XWave", "plan_xwaves", "xwaves_digest", "XSTORE",
           "xs_negotiated", "install_xrank", "build_xblock",
           "dispatch_xrank", "decline_rec", "error_rec", "XDeclined",
           "TAG_XSTAGE"]

#: cross-rank stage-plan digest exchange (the xfer/plan.py idiom);
#: +117 sits clear of TAG_REDIST (+111) and the below-base tags
TAG_XSTAGE = TAG_USER_BASE + 117

#: declared lock discipline (analysis/lock_check.py)
_GUARDED_BY = {
    "_Inbox.msgs": "lock",
    "_XStore.entries": "lock",
    "_Rendezvous.deposits": "_rdv_cond",
    "_Rendezvous.declined": "_rdv_cond",
    "_Rendezvous.taken": "_rdv_cond",
    "_Rendezvous.result": "_rdv_cond",
    "_Rendezvous.error": "_rdv_cond",
    # a block's graph runner: recorded by its rank, replayed by whichever
    # rank deposits last
    "XBlock.runner": "_lock",
}


class XDeclined(Exception):
    """A participant left the wave (its stage downgraded): the caller
    runs its rows rank-local."""


class XWave:
    """One planned cross-rank wave: a (level, class) wave front whose
    members span several ranks, aligned across every participant."""

    __slots__ = ("wave_id", "level", "class_name", "ranks",
                 "members_by_rank", "n_max", "boundary", "feeds",
                 "my_stage_index", "my_info")

    def __init__(self, wave_id: int, level: int, class_name: str,
                 ranks: Tuple[int, ...],
                 members_by_rank: Dict[int, Tuple],
                 boundary: Tuple, feeds: Dict[int, Tuple]) -> None:
        self.wave_id = wave_id
        self.level = level
        self.class_name = class_name
        self.ranks = ranks                      # sorted participants
        #: rank -> member keys in stage order
        self.members_by_rank = members_by_rank
        self.n_max = max(len(m) for m in members_by_rank.values())
        #: dedup'd cross-rank edges: ((prod_rank, prod_key, flow), ...)
        self.boundary = boundary
        #: rank -> per-member tuple of (flow_pos, boundary_index) pairs
        self.feeds = feeds
        #: this rank's matching plan stage (runtime wiring; NOT part of
        #: the digest — per-rank by construction)
        self.my_stage_index: Optional[int] = None
        self.my_info: Optional[Any] = None      # WavefrontInfo


def xwaves_digest(waves: List[XWave]) -> str:
    """sha1 over the SPMD-consistent wave content: every rank derives
    the same plan from the same spec/knobs, so the digests must agree
    — asserted before any wave dispatches (the xfer/plan.py loud-
    failure contract)."""
    canon = [(w.wave_id, w.level, w.class_name, w.ranks, w.n_max,
              tuple(sorted((r, w.members_by_rank[r]) for r in w.ranks)),
              w.boundary,
              tuple(sorted((r, w.feeds[r]) for r in w.ranks)))
             for w in waves]
    return hashlib.sha1(repr(canon).encode()).hexdigest()


# ---------------------------------------------------------------------- #
# planner pass: replay the wavefront partition per rank and align        #
# ---------------------------------------------------------------------- #
def plan_xwaves(tp, plan, max_tasks: int) -> None:
    """Fill ``plan.xwaves`` (the cross-rank waves this plan dispatches
    through :func:`dispatch_xrank`) and ``plan.xwave_report`` (one
    entry per (level, class) wave group: spanning ranks, boundary-edge
    count and collective kind, or the reason it stays rank-local — the
    ``--lower-report`` cross-rank column).

    Eligibility failures recorded here are PLAN verdicts, not
    fallbacks: only a planned wave a rank later leaves counts in
    ``xstage_fallbacks``."""
    from .lower import _producer_locals, build_layout, spec_codes
    from .plan import _instance_compilable
    from .sharded import wavefront_info

    nb = tp.nb_ranks
    verdicts = plan.verdicts
    codes = spec_codes(tp)
    class_ast = {tc.ast.name: tc.ast for tc in tp.task_classes}
    my_rank = tp.rank

    rank_of: Dict[Tuple, int] = {}
    ok_by_rank: List[set] = [set() for _ in range(nb)]
    for inst in plan.order:
        r = inst.tc.rank_of_instance(inst.env)
        rank_of[inst.key] = r
        if 0 <= r < nb and _instance_compilable(
                tp, inst, verdicts[inst.tc.ast.name], r):
            ok_by_rank[r].add(inst.key)

    by_level: Dict[int, List[Any]] = {}
    for inst in plan.order:
        by_level.setdefault(plan.levels[inst.key], []).append(inst)

    my_stage_of = {}
    for st in plan.stages:
        my_stage_of[tuple(m.key for m in st.members)] = st.index

    waves: List[XWave] = []
    report: List[Tuple[int, str, str]] = []

    def note(lv: int, cls: str, text: str) -> None:
        report.append((lv, cls, text))

    for lv in sorted(by_level):
        # per-class member lists per rank, in plan (stage) order — the
        # exact grouping plan_stages' wavefront branch produces
        per_class: Dict[str, Dict[int, List[Any]]] = {}
        for inst in by_level[lv]:
            r = rank_of[inst.key]
            if not (0 <= r < nb) or inst.key not in ok_by_rank[r]:
                continue
            per_class.setdefault(inst.tc.ast.name, {}) \
                .setdefault(r, []).append(inst)
        for cls in sorted(per_class):
            groups = per_class[cls]
            ranks = tuple(sorted(groups))
            if len(ranks) < 2:
                note(lv, cls, f"rank-local (spans {len(ranks)} rank)")
                continue
            if any(len(g) > max_tasks for g in groups.values()):
                note(lv, cls, "a rank's wave exceeds "
                     "stage_compile_max_tasks (chunk split: waves "
                     "would misalign across ranks)")
                continue
            wave = _plan_one_wave(
                tp, plan, lv, cls, ranks, groups, rank_of, class_ast,
                codes, my_rank, my_stage_of, len(waves),
                build_layout, wavefront_info, _producer_locals, note)
            if wave is not None:
                waves.append(wave)

    plan.xwaves = waves
    plan.xwave_report = report


def _plan_one_wave(tp, plan, lv, cls, ranks, groups, rank_of, class_ast,
                   codes, my_rank, my_stage_of, wave_id,
                   build_layout, wavefront_info, _producer_locals,
                   note) -> Optional[XWave]:
    from .plan import Stage
    members_by_rank: Dict[int, Tuple] = {}
    infos: Dict[int, Any] = {}
    boundary_index: Dict[Tuple, int] = {}
    boundary: List[Tuple] = []
    feeds: Dict[int, Tuple] = {}
    for r in ranks:
        insts = groups[r]
        st = Stage(-1)
        for inst in insts:
            st.add(inst, lv)
        try:
            layout_r = build_layout(tp, plan, st)
            info_r = wavefront_info(tp, st, layout_r, codes)
        except Exception as exc:  # noqa: BLE001 - plan verdict, not error
            note(lv, cls, f"rank {r}: layout failed ({exc})")
            return None
        if info_r is None:
            note(lv, cls, f"rank {r}: not wavefront-lowerable "
                 "(shared slot / NEW binding / intra-wave edge)")
            return None
        if "es_rank" in info_r.code.co_names:
            # the verdict texts are every rank's (and the JAX
            # package's): a body reading es_rank stays rank-local
            note(lv, cls, "body reads es_rank — per-rank values can't "
                 "ride one traced program")
            return None
        if not _uniform_mem_shapes(tp, info_r, layout_r):
            note(lv, cls, f"rank {r}: ragged member tile shapes")
            return None
        members_by_rank[r] = tuple(i.key for i in insts)
        infos[r] = info_r
        rfeeds = []
        for i, inst in enumerate(insts):
            pairs = []
            for (j, pk, pfl) in _member_boundary(
                    inst, rank_of, r, class_ast, _producer_locals):
                bk = (rank_of[pk], pk, pfl)
                b = boundary_index.get(bk)
                if b is None:
                    b = boundary_index[bk] = len(boundary)
                    boundary.append(bk)
                pairs.append((j, b))
            rfeeds.append(tuple(pairs))
        feeds[r] = tuple(rfeeds)
    if any(pr not in ranks for (pr, _pk, _fl) in boundary):
        # a boundary producer on a NON-participating rank has no mesh
        # position to source the gather from
        note(lv, cls, "boundary producer outside the wave's rank set")
        return None
    wave = XWave(wave_id, lv, cls, ranks, members_by_rank,
                 tuple(boundary), feeds)
    if my_rank in ranks:
        wave.my_stage_index = my_stage_of.get(members_by_rank[my_rank])
        wave.my_info = infos[my_rank]
        if wave.my_stage_index is None:
            note(lv, cls, "wave does not match a planned stage on this "
                 "rank")
            return None
    note(lv, cls, f"cross-rank: {len(ranks)} rank(s), "
         f"{len(boundary)} boundary edge(s), all-gather")
    return wave


def _member_boundary(inst, rank_of, r, class_ast, _producer_locals):
    """Cross-rank act-fed flows of one member: [(flow_pos, prod_key,
    prod_flow)] — the exact first-applicable binding walk the stage
    function (lower.build_stage_fn) and wavefront_info perform."""
    out = []
    nonctl = [f for f in inst.tc.ast.flows if not f.is_ctl]
    for j, f in enumerate(nonctl):
        for d in f.deps_in():
            t = d.resolve(inst.env)
            if t is None:
                continue
            if t.kind == "task":
                pk = (t.task_class, _producer_locals(
                    class_ast, t.task_class,
                    tuple(a(inst.env) for a in t.args)))
                pr = rank_of.get(pk)
                if pr is not None and pr != r:
                    out.append((j, pk, t.flow))
            break
    return out


def _uniform_mem_shapes(tp, info, layout) -> bool:
    """Plan-time ragged check over MEMORY-bound slots: one tile shape
    per flow across the wave.  Activation payload shapes are only known
    at dispatch; the assembler re-checks them."""
    n_mem = len(layout.mem_slots)
    for j in range(info.nargs):
        shapes = set()
        for i in range(info.n):
            slot = info.arg_slots[i][j]
            if slot < n_mem:
                (coll_name, coords), _a = layout.mem_slots[slot]
                coll = tp.global_env[coll_name]
                shapes.add(tuple(coll.tile_shape(*coords)))
        if len(shapes) > 1:
            return False
    return True


# ---------------------------------------------------------------------- #
# XStore: in-process payload parking for control-only activations        #
# ---------------------------------------------------------------------- #
class _XStore:
    """Process-global parked payloads for cross-rank waves.  The
    producer deposits once with a refcount of the receiving-rank
    count; each consumer rank takes exactly once at delivery (the
    transport's K_SEQ dedup makes replays invisible here)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.entries: Dict[Tuple, List] = {}   # key -> [payload, refs]

    def put(self, key: Tuple, payload: Any, refs: int) -> None:
        with self.lock:
            self.entries[key] = [payload, refs]

    def take(self, key: Tuple) -> Any:
        with self.lock:
            ent = self.entries.get(key)
            if ent is None:
                return None
            ent[1] -= 1
            payload = ent[0]
            if ent[1] <= 0:
                del self.entries[key]
            return payload

    def __len__(self) -> int:
        with self.lock:
            return len(self.entries)


XSTORE = _XStore()

_xs_seq_lock = threading.Lock()  # lock: guards module-global _xs_seq counter, not a class field
_xs_seq = 0


def xstore_key(rank: int, tp_id: int) -> Tuple:
    """A fresh park key: unique per process, prefixed with the sender
    identity so a key printed in an error names its origin."""
    global _xs_seq
    with _xs_seq_lock:
        _xs_seq += 1
        return ("xs", rank, tp_id, _xs_seq)


def xs_negotiated(ce, peer: int) -> bool:
    """Did ``peer`` negotiate the ``"xs"`` capability?  TCP engines
    answer from the HELLO token exchange (``xstage_to``); an engine
    without the accessor is an in-process fabric whose ranks are
    co-resident by construction — the knob alone gates it there."""
    fn = getattr(ce, "xstage_to", None)
    if fn is not None:
        return bool(fn(peer))
    return bool(params.get_or("stage_compile_xrank", "bool", False))


# ---------------------------------------------------------------------- #
# digest exchange (the xfer/plan.py inbox idiom)                         #
# ---------------------------------------------------------------------- #
class _Inbox:
    """Per-engine TAG_XSTAGE inbox: FIFO per (src, kind) — pool
    installs are SPMD-ordered, so the k-th take on one rank pairs with
    the k-th send from the peer."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.msgs: Dict[Tuple, List[Dict]] = {}

    def on_msg(self, src: int, payload: Dict) -> None:
        key = (src, payload.get("kind"))
        with self.lock:
            self.msgs.setdefault(key, []).append(payload)

    def take(self, key: Tuple) -> Optional[Dict]:
        with self.lock:
            q = self.msgs.get(key)
            if not q:
                return None
            return q.pop(0)


def _inbox_of(ce) -> _Inbox:
    box = getattr(ce, "_xstage_inbox", None)
    if box is None:
        box = _Inbox()
        ce._xstage_inbox = box
        ce.tag_register(TAG_XSTAGE, box.on_msg)
    return box


def _wait_take(ce, box: _Inbox, key: Tuple, timeout: float) -> Dict:
    deadline = time.monotonic() + timeout
    while True:
        msg = box.take(key)
        if msg is not None:
            return msg
        if time.monotonic() > deadline:
            raise TimeoutError(f"xstage digest from rank {key[0]} "
                               f"not received within {timeout}s")
        ce.progress()
        time.sleep(0.0005)


def _exchange_digest(ce, peers: List[int], digest: str, epoch: int,
                     timeout: float) -> bool:
    """Send my (digest, epoch) to every spanning peer and await
    theirs.  A DIGEST mismatch is a diverged plan — raise (the
    run_redistribution contract).  A missing or epoch-skewed peer
    negotiates the pool DOWN to rank-local stages instead."""
    box = _inbox_of(ce)
    for p in peers:
        ce.send_am(p, TAG_XSTAGE,
                   {"kind": "cfg", "digest": digest, "epoch": epoch})
    for p in peers:
        try:
            msg = _wait_take(ce, box, (p, "cfg"), timeout)
        except TimeoutError:
            plog.warning(
                "stagec xrank: rank %d sent no plan digest within %gs; "
                "cross-rank stages disabled for this pool", p, timeout)
            return False
        if msg.get("digest") != digest:
            raise RuntimeError(
                f"stagec xrank: cross-rank stage plan diverges from "
                f"rank {p} (digest {msg.get('digest')!r} != {digest!r})"
                " — ranks disagree on the wave partition")
        if msg.get("epoch") != epoch:
            plog.warning(
                "stagec xrank: install epoch skew vs rank %d (%s != "
                "%d); cross-rank stages disabled for this pool",
                p, msg.get("epoch"), epoch)
            return False
    return True


#: (digest, rank) -> install count; every rank installs the SPMD-same
#: pool sequence, so the k-th install of a digest agrees process-wide
_epoch_lock = threading.Lock()  # lock: guards module-global _install_counts, not a class field
_install_counts: Dict[Tuple[str, int], int] = {}


def _install_epoch(digest: str, rank: int) -> int:
    with _epoch_lock:
        c = _install_counts.get((digest, rank), 0) + 1
        _install_counts[(digest, rank)] = c
        return c


# ---------------------------------------------------------------------- #
# lane chips                                                             #
# ---------------------------------------------------------------------- #
def lane_chips(tp, device) -> List[Any]:
    """rank -> lane chip of ``tp``'s ranks (``lane_device_pool`` over the
    chip pool of ``device``).  Chips that are not distinct cannot hold
    one position each: that RAISES, naming the knob that declares
    logical chips."""
    from ..dsl.ptg.wave_dist import lane_device_pool
    pool = lane_device_pool(tp.nb_ranks, device)
    ids = {(str(c.device), c.id) for c in pool}
    if len(ids) != len(pool):
        raise RuntimeError(
            f"stagec xrank: the {tp.nb_ranks} ranks' lane chips are not "
            f"distinct ({pool}); a cross-rank stage runs one position "
            f"per rank on a chip of its own — set "
            f"device_cuda_virtual_chips={tp.nb_ranks} (or more) to "
            f"declare logical chips on one card")
    return pool


def _lane_stream(chip) -> Any:
    """The stream a lane chip's blocks replay on: one of the process's
    own for each chip, so two chips' blocks run side by side (None on
    the CPU)."""
    if chip.device.type != "cuda":
        return None
    from ..dsl.graph import own_stream
    return own_stream(chip.device, ("xrank lane", chip.id))


# ---------------------------------------------------------------------- #
# install: wire waves onto stage recs, exchange the digest               #
# ---------------------------------------------------------------------- #
def install_xrank(compiler) -> bool:
    """Attach the plan's cross-rank waves to this compiler: negotiate
    ``"xs"`` with every spanning peer, check the lane chips, exchange and
    assert the plan digest, wire each wave onto its stage rec, and
    publish the producer-side elision target set (``tp._xs_targets``).
    False leaves every stage rank-local."""
    tp = compiler.tp
    waves: List[XWave] = list(getattr(compiler.plan, "xwaves", ()) or ())
    if not waves:
        return False
    ce = getattr(getattr(tp, "comm", None), "ce", None)
    if ce is None:
        return False
    me = tp.rank
    peers = sorted({r for w in waves for r in w.ranks} - {me})
    if not peers:
        return False
    for p in peers:
        if not xs_negotiated(ce, p):
            plog.debug.verbose(
                2, "stagec xrank: peer %d did not negotiate 'xs' "
                "(mixed version or separate process); rank-local "
                "stages", p)
            return False
    compiler._lanes = lane_chips(tp, compiler._device())
    timeout = _timeout()
    digest = xwaves_digest(waves)
    epoch = _install_epoch(digest, me)
    _purge_stale(digest, epoch)
    if not _exchange_digest(ce, peers, digest, epoch, timeout):
        return False
    compiler._xrank = (digest, epoch)
    targets = set()
    wired = 0
    for w in waves:
        for mks in w.members_by_rank.values():
            targets.update(mks)
        if me not in w.ranks:
            continue
        rec = compiler._rec_by_index.get(w.my_stage_index)
        if rec is not None and w.my_info is not None \
                and rec.chain is None \
                and tuple(m.key for m in rec.stage.members) \
                == w.members_by_rank[me]:
            rec.xwave = w
            wired += 1
        else:
            # peers will rendezvous this wave: decline NOW so they
            # fall back instead of running out the clock
            _decline(digest, epoch, w, me)
            compiler._count(xstage_fallbacks=1)
    tp._xs_targets = targets
    plog.debug.verbose(
        2, "stagec xrank: %s rank %d joined %d cross-rank wave(s) "
        "(%d wired) with rank(s) %s", tp.name, me, len(waves), wired,
        peers)
    return True


def _timeout() -> float:
    try:
        return float(params.get_or("stage_xrank_timeout", "string",
                                   "60") or 60)
    except (TypeError, ValueError):
        return 60.0


# ---------------------------------------------------------------------- #
# one position's block: the rank's rows, recorded on its lane chip       #
# ---------------------------------------------------------------------- #
class XBlock:
    """One rank's rows of a cross-rank wave on its lane chip.  Each row
    runs the class body exactly as a rank-local stage does; a
    boundary-fed flow takes its value from the position's boundary stack
    (``bstack``, B tiles) at the row's index (``bidx[row, flow]``, -1 =
    the row's own slot), both graph INPUTS, so the routing is data.  On
    a card the block records once as one CUDA graph on its chip and
    replays on the chip's stream; on the CPU it runs eagerly."""

    def __init__(self, info, rank: int, chip, shapes: Tuple,
                 bnd_flows: Tuple[int, ...], B: int, tshape: Tuple,
                 bidx: np.ndarray) -> None:
        """``shapes``: ((shape, dtype name) per flow) of every row;
        ``tshape``: the boundary tiles' (shape, dtype name)."""
        from ..dsl.graph import GraphRunner
        self.info = info
        self.rank = rank
        self.chip = chip
        self.stream = _lane_stream(chip)
        self.shapes = shapes
        self.bnd_flows = bnd_flows
        self.B = B
        self.tshape = tshape
        self.bidx_host = bidx
        self.record_seconds = 0.0
        self._lock = threading.Lock()
        self.runner = GraphRunner(
            self._execute, f"cross-rank wave of {info.class_name}, "
            f"rank {rank}", self._written)

    @property
    def device(self):
        return self.chip.device

    def _written(self) -> List[Tuple[int, int]]:
        return [(r, o) for r in range(self.info.n)
                for o in range(self.info.nargs)]

    def _execute(self, state, device, note):
        import torch
        info, bnd = self.info, frozenset(self.bnd_flows)
        bstack = state.get("bstack")
        bidx = state.get("bidx")
        out = {}
        for r in range(info.n):
            env = dict(info.envs[r])
            for j, fname in enumerate(info.flow_names):
                v = state[(r, j)]
                if self.B and j in bnd:
                    # sel < 0: a row fed by its own rank — keep its slot
                    sel = bidx[r, j]
                    g = bstack.index_select(
                        0, sel.clamp(min=0).reshape(1))[0]
                    v = torch.where(sel >= 0, g, v)
                env[fname] = v
            env["np"] = np
            env["torch"] = torch
            env["es_rank"] = self.rank   # plan_xwaves rejects readers
            env["this_task"] = None
            note(f"{info.class_name} row {r} of rank {self.rank}")
            exec(info.code, env)
            for j, fname in enumerate(info.flow_names):
                out[(r, j)] = env.get(fname)
        return out

    def _state(self, rows, bstack, bidx) -> Dict[Any, Any]:
        state: Dict[Any, Any] = {(r, j): rows[r][j]
                                 for r in range(self.info.n)
                                 for j in range(self.info.nargs)}
        if self.B:
            state["bstack"] = bstack
            state["bidx"] = bidx
        return state

    def record(self) -> None:
        """Warm up and record the block over zero-filled rows on its
        chip (a card only; the CPU runs it eagerly).  A body that cannot
        be recorded raises :class:`~..dsl.graph.CaptureError`."""
        import torch
        device = torch.device(self.device)
        if device.type != "cuda":
            return
        t0 = time.perf_counter()

        def zeros(sd):
            s, d = sd
            return torch.zeros(s, dtype=getattr(torch, d), device=device)

        rows = [[zeros(self.shapes[j]) for j in range(self.info.nargs)]
                for _ in range(self.info.n)]
        bstack = (torch.zeros((self.B,) + tuple(self.tshape[0]),
                              dtype=getattr(torch, self.tshape[1]),
                              device=device) if self.B else None)
        bidx = (torch.as_tensor(self.bidx_host, device=device)
                if self.B else None)
        with self._lock, torch.cuda.stream(self.stream):
            self.runner.record(self._state(rows, bstack, bidx), device,
                               self.stream)
        self.record_seconds += time.perf_counter() - t0

    def run(self, rows, bstack) -> Dict[Tuple[int, int], Any]:
        """Run the block on ``rows`` ([row][flow] tensors) and the
        position's boundary stack, on the chip's stream (the caller
        entered it and ordered it after every writer of the inputs)."""
        import torch
        device = torch.device(self.device)
        bidx = (torch.as_tensor(self.bidx_host, device=device)
                if self.B else None)
        state = self._state(rows, bstack, bidx)
        with self._lock:
            if device.type == "cuda":
                return self.runner.run(state, device)
            return self.runner._execute(state, device, lambda label: None)

    def facts(self) -> Dict[str, Any]:
        with self._lock:
            gr = self.runner
        return {"warmup_gemm_launches": gr.warmup_gemm_launches or 0,
                "captured_gemm_launches": gr.captured_gemm_launches or 0,
                "replays": gr.replays,
                "record_seconds": self.record_seconds,
                "replay_ms": gr.replay_ms if gr.replays else None,
                "sharded": False, "xrank": True}


def build_xblock(compiler, rec) -> XBlock:
    """This rank's block of ``rec``'s cross-rank wave, fetched from (or
    recorded into) the per-spec stage cache at spawn — a record made
    here is counted as the stage's, never as a dispatch's.  A block that
    cannot be recorded raises :class:`~..dsl.graph.CaptureError` (the
    caller downgrades the stage and declines the wave)."""
    from ..devices.batching import cached_stage_callable
    from ..dsl.graph import CaptureError
    from .lower import stage_signature
    from .sharded import wavefront_info
    wave: XWave = rec.xwave
    tp = compiler.tp
    me = tp.rank
    info = wavefront_info(tp, rec.stage, rec.layout, compiler._codes)
    if info is None or info.n != len(wave.members_by_rank[me]):
        raise RuntimeError(f"stagec xrank: stage {rec.stage.index} of "
                           f"{tp.name} is not wave {wave.wave_id}'s rows")
    shapes = tuple(rec.shapes[info.arg_slots[0][j]]
                   for j in range(info.nargs))
    for i in range(info.n):
        for j in range(info.nargs):
            if rec.shapes[info.arg_slots[i][j]] != shapes[j]:
                raise RuntimeError(
                    f"stagec xrank: ragged flow {info.flow_names[j]!r} "
                    f"in wave {wave.wave_id}: "
                    f"{rec.shapes[info.arg_slots[i][j]]} vs {shapes[j]}")
    bnd_flows = tuple(sorted({j for r in wave.ranks
                              for pairs in wave.feeds[r]
                              for (j, _b) in pairs}))
    B = len(wave.boundary)
    tshape = shapes[bnd_flows[0]] if bnd_flows else None
    if any(shapes[j] != tshape for j in bnd_flows):
        raise RuntimeError(f"stagec xrank: the boundary-fed flows of wave "
                           f"{wave.wave_id} differ in shape")
    bidx = np.full((info.n, info.nargs), -1, np.int64)
    for i, pairs in enumerate(wave.feeds[me]):
        for (j, b) in pairs:
            bidx[i, j] = b
    chip = compiler._lanes[me]
    key = stage_signature(rec.stage, rec.shapes) + (
        "xrank", wave.ranks, wave.n_max, B, bnd_flows, tshape,
        tuple(map(tuple, bidx)), str(chip.device), chip.id)

    def build():
        t0 = time.perf_counter_ns()
        blk = XBlock(info, me, chip, shapes, bnd_flows, B, tshape, bidx)
        try:
            blk.record()
        except CaptureError as exc:
            # the verdict is cached with what broke the capture
            return CaptureError(f"stage {rec.stage.index} of {tp.name}, "
                                f"wave {wave.wave_id}: {exc}")
        compiler._count(xstage_compiles=1,
                        stage_compile_ns=time.perf_counter_ns() - t0)
        return blk

    blk = cached_stage_callable(compiler._token, key, build,
                                owner=compiler.context)
    if isinstance(blk, CaptureError):
        raise CaptureError(f"its cross-rank block cannot be recorded "
                           f"(cached verdict): {blk}")
    return blk


# ---------------------------------------------------------------------- #
# rendezvous: deposit / assemble / extract                               #
# ---------------------------------------------------------------------- #
class _Rendezvous:
    """One wave's meeting point, keyed (digest, epoch, wave_id)."""

    def __init__(self, ranks: Tuple[int, ...]) -> None:
        self.ranks = frozenset(ranks)
        # every entry shares the MODULE condition (entries are created
        # and reaped under it); the instance alias is the declared
        # guard handle for the fields below (_GUARDED_BY)
        self._rdv_cond = _rdv_cond
        self.deposits: Dict[int, Dict] = {}
        self.declined: set = set()
        self.taken: set = set()
        self.result: Optional[Dict] = None
        self.error: Optional[str] = None


_rdv_cond = threading.Condition()
_rdv: Dict[Tuple, _Rendezvous] = {}


def _purge_stale(digest: str, epoch: int) -> None:
    with _rdv_cond:
        for k in [k for k in _rdv
                  if k[0] == digest and k[1] < epoch]:
            _rdv.pop(k)
        _rdv_cond.notify_all()


def _ent(key: Tuple, ranks: Tuple[int, ...]) -> _Rendezvous:
    with _rdv_cond:
        ent = _rdv.get(key)
        if ent is None:
            ent = _rdv[key] = _Rendezvous(ranks)
        return ent


def _gc_locked(key: Tuple, ent: _Rendezvous) -> None:  # holds: ent._rdv_cond
    if ent.taken | ent.declined >= ent.ranks:
        _rdv.pop(key, None)


def _decline(digest: str, epoch: int, wave: XWave, rank: int) -> None:
    key = (digest, epoch, wave.wave_id)
    ent = _ent(key, wave.ranks)
    with ent._rdv_cond:
        ent.declined.add(rank)
        _gc_locked(key, ent)
        ent._rdv_cond.notify_all()


def _set_error(ent: _Rendezvous, text: str) -> None:
    with ent._rdv_cond:
        if ent.error is None:
            ent.error = text
        ent._rdv_cond.notify_all()


def decline_rec(compiler, rec) -> None:
    """This rank leaves ``rec``'s wave (its stage downgraded): tell the
    rendezvous so waiting peers run the wave rank-local NOW."""
    wave = getattr(rec, "xwave", None)
    xr = getattr(compiler, "_xrank", None)
    if wave is None or xr is None:
        return
    _decline(xr[0], xr[1], wave, compiler.tp.rank)


def error_rec(compiler, rec, exc: BaseException) -> None:
    """``rec``'s wave failed on this rank: error the rendezvous so every
    participant raises instead of waiting for a deposit that never
    comes."""
    wave = getattr(rec, "xwave", None)
    xr = getattr(compiler, "_xrank", None)
    if wave is None or xr is None:
        return
    _set_error(_ent((xr[0], xr[1], wave.wave_id), wave.ranks),
               f"rank {compiler.tp.rank} failed: "
               f"{type(exc).__name__}: {exc}")


def dispatch_xrank(compiler, rec, arrays: List[Any]):
    """Run ``rec``'s stage as its position of the cross-rank wave's ONE
    program.  Returns ``(tile_outs, edge_outs)`` in layout order.
    Raises :class:`XDeclined` when a participant left the wave (the
    caller runs the rows rank-local) and RuntimeError when the wave
    failed anywhere (the rendezvous is errored first, so no peer
    hangs)."""
    wave: XWave = rec.xwave
    blk: XBlock = rec.xblock
    me = compiler.tp.rank
    xr = compiler._xrank
    key = (xr[0], xr[1], wave.wave_id)
    ent = _ent(key, wave.ranks)
    if rec.xfail is not None:
        # the block failed to build at spawn; the rendezvous was
        # errored then
        _take_and_gc(key, ent, me)
        raise RuntimeError(f"cross-rank wave {wave.wave_id} "
                           f"({wave.class_name} level {wave.level}): "
                           f"rank {me}'s block failed to build: "
                           f"{type(rec.xfail).__name__}: {rec.xfail}"
                           ) from rec.xfail
    try:
        deposit = _make_deposit(blk, wave, arrays, me)
    except Exception as exc:
        _set_error(ent, f"deposit failed on rank {me}: "
                        f"{type(exc).__name__}: {exc}")
        _take_and_gc(key, ent, me)
        raise
    ce = getattr(getattr(compiler.tp, "comm", None), "ce", None)
    run_build = False
    with ent._rdv_cond:
        ent.deposits[me] = deposit
        if ent.error is None and not ent.declined \
                and len(ent.deposits) == len(wave.ranks):
            run_build = True
            deposits = dict(ent.deposits)
    if run_build:
        try:
            result = _assemble_and_run(wave, deposits)
        except Exception as exc:
            _set_error(ent, f"assembly failed on rank {me}: "
                            f"{type(exc).__name__}: {exc}")
            _take_and_gc(key, ent, me)
            raise
        with ent._rdv_cond:
            ent.result = result
            ent._rdv_cond.notify_all()
    else:
        _await_result(ent, ce, wave, me)
    with ent._rdv_cond:
        err, result, declined = ent.error, ent.result, set(ent.declined)
    _take_and_gc(key, ent, me)
    if err is not None:
        raise RuntimeError(f"cross-rank wave {wave.wave_id} "
                           f"({wave.class_name} level {wave.level}): "
                           f"{err}")
    if result is None:
        raise XDeclined(f"rank(s) {sorted(declined)} declined cross-rank "
                        f"wave {wave.wave_id}")
    return _extract(compiler, blk, wave, result, me)


def _take_and_gc(key: Tuple, ent: _Rendezvous, me: int) -> None:
    with ent._rdv_cond:
        ent.taken.add(me)
        _gc_locked(key, ent)
        ent._rdv_cond.notify_all()


def _await_result(ent: _Rendezvous, ce, wave: XWave, me: int) -> None:
    """Wait for the assembler, a decline or an error.  A peer the comm
    engine reports dead, or the ``stage_xrank_timeout`` clock, errors
    the rendezvous.  The comm engine is not progressed here: a deposit
    never travels through it, and the rank's other workers keep
    progressing it."""
    timeout = _timeout()
    deadline = time.monotonic() + timeout
    while True:
        with ent._rdv_cond:
            if ent.result is not None or ent.error is not None \
                    or ent.declined:
                return
            ent._rdv_cond.wait(0.01)
            if ent.result is not None or ent.error is not None \
                    or ent.declined:
                return
        dead = getattr(ce, "dead_peers", None) or ()
        gone = [r for r in wave.ranks if r != me and r in dead]
        if gone:
            _set_error(ent, f"peer rank(s) {gone} died before the "
                            f"rendezvous completed")
            return
        if time.monotonic() > deadline:
            with ent._rdv_cond:
                if ent.result is None and ent.error is None \
                        and not ent.declined:
                    ent.error = (f"rendezvous timed out after "
                                 f"{timeout}s (stage_xrank_timeout)")
                    ent._rdv_cond.notify_all()
            return


def _cuda(t: Any) -> bool:
    return getattr(t, "is_cuda", False)


def _make_deposit(blk: XBlock, wave: XWave, arrays: List[Any],
                  me: int) -> Dict:
    """My position's contribution: my rows (the stage's slot tensors,
    per member and flow) and a PRIVATE copy of each boundary payload I
    consume (a torch tile can be written in place later), with the event
    after them on the stream this dispatch runs on."""
    info = blk.info
    rows = [[arrays[info.arg_slots[i][j]] for j in range(info.nargs)]
            for i in range(info.n)]
    bnd: Dict[int, Any] = {}
    for i, pairs in enumerate(wave.feeds[me]):
        for (j, b) in pairs:
            if b not in bnd:
                bnd[b] = arrays[info.arg_slots[i][j]].detach().clone()
    ready = None
    first = next((a for row in rows for a in row if _cuda(a)), None)
    if first is not None:
        import torch
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(first.device))
    return {"rank": me, "block": blk, "rows": rows, "bnd": bnd,
            "ready": ready}


def _after(stream, ready, tensors) -> None:
    """Order ``stream`` after a deposit's event and tell the caching
    allocator that ``stream`` reads ``tensors`` (no-op on the CPU)."""
    if stream is None:
        return
    if ready is not None:
        stream.wait_event(ready)
    for t in tensors:
        if _cuda(t) and t.device == stream.device:
            t.record_stream(stream)


def _on(blk: XBlock):
    import contextlib
    if blk.stream is None:
        return contextlib.nullcontext()
    import torch
    return torch.cuda.stream(blk.stream)


def _assemble_and_run(wave: XWave, deposits: Dict[int, Dict]) -> Dict:
    """LAST depositor's job: check the deposits, gather the boundary
    tiles over the positions' chips and run every position's block on
    its chip's stream.  Publishes per position the block's outputs and
    the event after them."""
    import torch

    from ..parallel.mesh import xrank_mesh
    R = len(wave.ranks)
    B = len(wave.boundary)
    blocks = [deposits[r]["block"] for r in wave.ranks]
    mesh = xrank_mesh([b.chip for b in blocks])
    if len({(str(c.device), c.id) for c in mesh.devices}) != R:
        raise RuntimeError("lane chips are not distinct per rank")
    # flow shapes: uniform across the wave (activation payload shapes
    # are only known now)
    first = blocks[0]
    for blk in blocks:
        if blk.shapes != first.shapes or blk.bnd_flows != first.bnd_flows \
                or blk.B != B:
            raise RuntimeError(
                f"ragged wave {wave.wave_id}: rank {blk.rank}'s rows "
                f"{blk.shapes} vs rank {first.rank}'s {first.shapes}")
        for row in deposits[blk.rank]["rows"]:
            for j, a in enumerate(row):
                got = (tuple(a.shape), str(a.dtype).replace("torch.", ""))
                if got != tuple(blk.shapes[j]):
                    raise RuntimeError(
                        f"ragged flow {blk.info.flow_names[j]!r} across "
                        f"the wave: {got} vs {blk.shapes[j]}")
    ready = {r: deposits[r]["ready"] for r in wave.ranks}
    stacks: List[Any] = [None] * R
    nbytes = 0
    if B:
        payloads: Dict[int, Tuple[Any, Any]] = {}
        for r in wave.ranks:
            for b, p in deposits[r]["bnd"].items():
                payloads.setdefault(b, (p, ready[r]))
        missing = [b for b in range(B) if b not in payloads]
        if missing:
            raise RuntimeError(f"boundary entries {missing} have no "
                               f"consumer payload")
        tshape = first.tshape
        for b, (p, _ev) in payloads.items():
            got = (tuple(p.shape), str(p.dtype).replace("torch.", ""))
            if got != tuple(tshape):
                raise RuntimeError(f"boundary tile {b} is {got}, not "
                                   f"{tshape}")
        shape = (B,) + tuple(tshape[0])
        dtype = getattr(torch, tshape[1])
        tile_nbytes = int(np.prod(tshape[0], dtype=np.int64)) \
            * torch.empty((), dtype=dtype).element_size()
        # each producer position holds its own boundary tiles ...
        placed = [None] * R
        for p, r in enumerate(wave.ranks):
            blk = blocks[p]
            with _on(blk):
                st = torch.empty(shape, dtype=dtype, device=blk.device)
                for b, (pr, _pk, _fl) in enumerate(wave.boundary):
                    if pr == r:
                        src, ev = payloads[b]
                        _after(blk.stream, ev, (src,))
                        st[b].copy_(src)
                stacks[p] = st
                if blk.stream is not None:
                    placed[p] = torch.cuda.Event()
                    placed[p].record(blk.stream)
        # ... and every other position copies them in: the all-gather
        pos_of = {r: p for p, r in enumerate(wave.ranks)}
        for p, blk in enumerate(blocks):
            with _on(blk):
                for b, (pr, _pk, _fl) in enumerate(wave.boundary):
                    q = pos_of[pr]
                    if q == p:
                        continue
                    _after(blk.stream, placed[q], (stacks[q],))
                    stacks[p][b].copy_(stacks[q][b])
                    nbytes += tile_nbytes
    outs: List[Dict] = [None] * R
    done: List[Any] = [None] * R
    for p, r in enumerate(wave.ranks):
        blk = blocks[p]
        rows = deposits[r]["rows"]
        with _on(blk):
            _after(blk.stream, ready[r], [a for row in rows for a in row])
            outs[p] = blk.run(rows, stacks[p])
            if blk.stream is not None:
                done[p] = torch.cuda.Event()
                done[p].record(blk.stream)
    return {"outs": outs, "done": done, "collective_bytes": nbytes}


def _extract(compiler, blk: XBlock, wave: XWave, result: Dict, me: int):
    """My position's rows, mapped through my layout's out_mem/edge maps,
    on this dispatch's stream (which waits for my block)."""
    import torch
    p = wave.ranks.index(me)
    outs, ev = result["outs"][p], result["done"][p]
    if ev is not None:
        dev_t = torch.device(compiler._device())
        cur = torch.cuda.current_stream(dev_t)
        cur.wait_event(ev)
        moved = {}
        for k, t in outs.items():
            if t is None:
                moved[k] = t
            elif t.device == dev_t:
                t.record_stream(cur)
                moved[k] = t
            else:
                ev.synchronize()   # another card: copy once it is done
                moved[k] = t.to(dev_t)
        outs = moved
    info = blk.info
    tile_outs = [outs.get((i, o)) for (i, o) in info.out_mem_map]
    edge_outs = [outs.get((i, o)) for (i, o) in info.edge_map]
    compiler._count(xstage_collective_bytes=result["collective_bytes"])
    return tile_outs, edge_outs
