"""Elastic grid recovery: cross-grid checkpoint reshard + rank shrink/join.

Detection, injection and checkpoint-restart alone need the *identical*
rank count and process grid to recover (``utils/checkpoint`` fails fast
on any mismatch), so losing one rank ends the job until a fresh
incarnation of the same world starts. This module turns that into an
in-world recovery path ("Memory-efficient array redistribution",
arXiv:2112.01075 — the reshard machinery is ``collections/redistribute``),
as the JAX package's ``ft/elastic.py`` does:

- :func:`reshard_restore` — **cross-grid restore**: a snapshot written
  on any ``nodes/P×Q`` grid lands on the *current* grid. Each current
  participant loads the writer shards folded onto it, materializes a
  source-distribution :class:`_SnapshotView`, and drives
  ``collections.redistribute`` (whole-tile reshuffle fast path when
  the tile grids match — always true here, geometry is immutable — and
  fragment assembly otherwise) so every tile reaches its new owner
  over the ordinary DTD data plane (or the collective planner,
  ``xfer_collective_redist``). Reached through
  ``restore_collection(..., reshard=True)``; the strict default is
  untouched. Restored tiles land in host copies with their versions
  bumped, so device tasks after the resize stage them in afresh.
- :class:`ElasticCoordinator` — **membership agreement** over a new
  ``TAG_ELASTIC`` active message (wire-level ``K_ELASTIC`` on TCP,
  delivered by the receiver thread like ``K_PING``; peers without the
  HELLO ``"el"`` capability are excluded exactly like heartbeats'
  ``"hb"``). Delivery only records the frame and notifies: it never
  blocks the receiver thread, whose heartbeats keep the survivors from
  evicting each other. A leader-decided vote/commit round: every
  voter sends its proposed member set + resume stage to all voters,
  the lowest-ranked voter commits when all votes match (or aborts a
  grow round whose window expired), and joiners receive a ``welcome``
  naming the member set and the snapshot stage to reshard from.
- **Shrink** (``--mca ft_elastic shrink``): when the heartbeat
  detector evicts a rank mid-run, ``ft.run_with_restart`` no longer
  only aborts — the survivors agree on a reduced grid (deterministic
  from the surviving rank set, :func:`plan_grid`), rebuild their
  collections on it (:class:`ElasticPolicy.rebuild`), reshard-restore
  the last snapshot, and replay from ``last_snap``. No human in the
  loop; the dead rank's *data* survives on disk in its shard files.
- **Join** (``ft_elastic grow`` / ``both``): a late rank announces
  itself; the incumbents fold it in at the next quiescent point
  (a stage boundary with a fresh snapshot), gated by
  ``ft_elastic_grow_min``; the same reshard machinery spreads tiles
  onto the grown grid.

Trust model: crash faults only. A membership view's ``dead`` list is
gossip from a peer's own detector and is believed (it accelerates
convergence when detectors fire at different times); a byzantine rank
could abuse it, which is outside this module's scope.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import logging as plog
from ..utils.params import params

__all__ = ["GridSpec", "plan_grid", "ElasticBlockCyclic", "ElasticPolicy",
           "ElasticCoordinator", "ElasticError", "reshard_restore",
           "maybe_install_elastic"]

#: cross-thread coordinator state (detector callback / transport
#: receiver threads deliver; the restart loop waits) — all of
#: it behind the one condition, whose notify doubles as the wakeup
_GUARDED_BY = {
    "ElasticCoordinator._views":   "_cond",
    "ElasticCoordinator._joins":   "_cond",
    "ElasticCoordinator._welcome": "_cond",
    "ElasticCoordinator._commit":  "_cond",
    "ElasticCoordinator._aborts":  "_cond",
    "ElasticCoordinator._epoch":   "_cond",
}

#: how often a waiting voter/joiner re-sends its current vote or join
#: announcement — membership frames ride the chaos-injected transports,
#: so the protocol must survive dropped frames
_RESEND_S = 0.25
#: default overall agreement deadline (``ft_elastic_timeout``)
_TIMEOUT_S = 30.0
#: a grow round is OPTIONAL (incumbents may proceed without resizing),
#: so the leader only holds the stage boundary this long for votes
_GROW_WINDOW_S = 5.0


class ElasticError(RuntimeError):
    """Membership agreement failed (timeout, eviction mid-agreement,
    or this rank was shrunk out) — the caller falls back to the strict
    abort path with the on-disk snapshot set still consistent."""


# --------------------------------------------------------------------- #
# grids                                                                 #
# --------------------------------------------------------------------- #
class GridSpec:
    """A deterministic process grid over an explicit member set.

    ``members[logical] = world rank``: collections built on the spec
    keep WORLD ranks in ``rank_of`` (comm addressing is untouched);
    only the block-cyclic math runs on logical coordinates. Every rank
    derives the same spec from the same member set — that determinism
    IS the agreement shortcut (peers exchange member sets, never
    layouts)."""

    def __init__(self, members: Sequence[int], world: int, rank: int) -> None:
        self.members = tuple(sorted(members))
        assert len(set(self.members)) == len(self.members), "duplicate members"
        self.world = int(world)
        self.rank = int(rank)
        n = len(self.members)
        # most-square factorization, rows >= cols (the JAX package's
        # convention): n=4 -> 2x2, n=2 -> 2x1, n=3 -> 3x1
        q = max(p for p in range(1, int(n ** 0.5) + 1) if n % p == 0)
        self.P, self.Q = n // q, q

    @property
    def nodes(self) -> int:
        return len(self.members)

    def collection(self, lm: int, ln: int, mb: int, nb: int,
                   **kw: Any) -> "ElasticBlockCyclic":
        """A block-cyclic collection on this grid (manifest records
        ``members`` so a snapshot written here reshards back)."""
        return ElasticBlockCyclic(lm, ln, mb, nb, P=self.P, Q=self.Q,
                                  members=self.members, nodes=self.world,
                                  rank=self.rank, **kw)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, GridSpec)
                and self.members == other.members and self.world == other.world)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"GridSpec({self.P}x{self.Q} over members={self.members} "
                f"world={self.world})")


def plan_grid(members: Sequence[int], world: int, rank: int) -> GridSpec:
    """The one deterministic member-set -> grid function (shrink and
    grow both go through here, so every participant lands on the same
    layout without exchanging it)."""
    return GridSpec(members, world, rank)


from ..collections.matrix import TiledMatrix, TwoDimBlockCyclic  # noqa: E402
from ..collections.redistribute import _engine_of  # noqa: E402


class ElasticBlockCyclic(TwoDimBlockCyclic):
    """2D block-cyclic over an explicit ``members`` world-rank map.

    ``nodes`` stays the WORLD size and ``rank`` the world rank, so the
    comm layer addresses real peers; ``rank_of`` routes the logical
    block-cyclic owner through ``members``. With the identity map this
    is exactly ``TwoDimBlockCyclic``."""

    def __init__(self, lm: int, ln: int, mb: int, nb: int,
                 members: Sequence[int], P: int = 1, Q: int = 1,
                 nodes: Optional[int] = None, rank: int = 0, **kw: Any) -> None:
        members = tuple(members)
        assert len(members) == P * Q, \
            f"grid {P}x{Q} needs {P * Q} members, got {len(members)}"
        world = nodes if nodes is not None else (max(members) + 1)
        super().__init__(lm, ln, mb, nb, P=P, Q=Q, nodes=world, rank=rank,
                         **kw)
        self.members = members

    def rank_of(self, m: int, n: int) -> int:
        return self.members[super().rank_of(m, n)]


# --------------------------------------------------------------------- #
# cross-grid restore                                                    #
# --------------------------------------------------------------------- #
def _participants(man_or_coll: Any) -> List[int]:
    """World ranks that own at least one logical grid slot — from a
    manifest dict or a live collection. ``members`` when recorded
    (elastic grids), else the identity map over the logical grid."""
    if isinstance(man_or_coll, dict):
        man = man_or_coll
        if man.get("members") is not None:
            return list(man["members"])
        p, q = man.get("P"), man.get("Q")
        if p and q:
            return list(range(int(p) * int(q)))
        return list(range(int(man.get("nodes", 1))))
    coll = man_or_coll
    if getattr(coll, "members", None) is not None:
        return list(coll.members)
    p, q = getattr(coll, "P", None), getattr(coll, "Q", None)
    if p and q:
        return list(range(p * q))
    return list(range(getattr(coll, "nodes", 1)))


def _src_rank_fn(man: Dict[str, Any]) -> Callable[[int, int], int]:
    """Reconstruct the snapshot grid's tile -> world-rank function from
    its manifest (the ``rank_of`` of a collection we no longer have)."""
    part = _participants(man)
    p, q = man.get("P"), man.get("Q")
    if p and q:
        P, Q = int(p), int(q)
        kr = int(man.get("krows", 1) or 1)
        kc = int(man.get("kcols", 1) or 1)

        def rank_of(m: int, n: int) -> int:
            return part[((m // kr) % P) * Q + (n // kc) % Q]
        return rank_of
    if len(part) == 1:
        return lambda m, n: part[0]
    raise ValueError(
        f"cannot reshard a {man.get('kind')!r} snapshot: its manifest "
        f"records no P/Q grid to reconstruct tile ownership from")


def _shard_identity(man: Dict[str, Any]) -> Tuple:
    """Everything that must agree across one snapshot's shard files —
    a mixed set (stale shards of an older grid left beside a newer
    save) must be rejected, not silently blended."""
    return tuple((k, repr(man.get(k)))
                 for k in ("lm", "ln", "mb", "nb", "dtype", "uplo", "kind",
                           "nodes", "P", "Q", "krows", "kcols", "members"))


def _load_folded_shards(prefix: str, man: Dict[str, Any],
                        writers: List[int], mine: List[int]):
    """Load tile arrays from the writer shards folded onto this rank.
    Returns {(m, n): array}. A torn shard or an identity mismatch
    raises CheckpointCorruptError (the restart loop then falls back
    to the previous complete snapshot)."""
    import json
    from ..utils import checkpoint as ckpt
    ident = _shard_identity(man)
    loaded: Dict[Tuple[int, int], Any] = {}
    for w in writers:
        if w not in mine:
            continue
        path = ckpt.checkpoint_path(prefix, w)
        with ckpt._open_snapshot(path) as z:
            shard_man = json.loads(str(z["__manifest__"]))
            if _shard_identity(shard_man) != ident:
                raise ckpt.CheckpointCorruptError(
                    f"checkpoint shard {path} disagrees with the other "
                    f"shards' manifest — a stale shard from a different "
                    f"grid is mixed into this snapshot")
            for name in z.files:
                if not name.startswith("t"):
                    continue
                m, n = map(int, name[1:].split("_"))
                loaded[(m, n)] = z[name]
    return loaded


def _make_view(coll: Any, man: Dict[str, Any], loaded: Dict, fold, src_rank):
    """Source-distribution view over the loaded shard arrays: tiles
    live where the fold landed them; redistribute moves them to the
    target's owners."""

    class _SnapshotView(TiledMatrix):
        def rank_of(self, m: int, n: int) -> int:
            return fold(src_rank(m, n))

    view = _SnapshotView(coll.lm, coll.ln, coll.mb, coll.nb,
                         dtype=coll.dtype, nodes=coll.nodes, rank=coll.rank,
                         uplo=man.get("uplo", "full"))
    view.name = f"{coll.name}::snapshot"
    missing = []
    for (m, n) in view.tiles():
        if view.rank_of(m, n) != view.rank:
            continue
        arr = loaded.get((m, n))
        if arr is None:
            missing.append((m, n))
            continue
        view.set_tile(m, n, arr)
    if missing:
        from ..utils import checkpoint as ckpt
        raise ckpt.CheckpointCorruptError(
            f"snapshot {view.name} is missing tiles {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''} after loading every "
            f"reachable shard — shard files were lost or torn")
    return view


def reshard_restore(coll: Any, prefix: str,
                    context: Optional[Any] = None) -> int:
    """Restore ``coll`` from a snapshot written on a DIFFERENT grid.

    Geometry (tiling, dtype, extent, uplo) must match — resharding
    redistributes tiles, it cannot reinterpret bytes — so a tile-size
    mismatch still hard-fails with :class:`CheckpointMismatchError`.
    The distribution is free: any writer ``nodes``/P×Q/``members``
    lands on ``coll``'s grid.

    SPMD: call on every CURRENT participant with its own ``context``
    (required whenever the current grid spans more than one rank — the
    move is a collective DTD redistribution). A single-participant
    target restores directly, no context needed, provided every writer
    shard is reachable from this process. Returns the number of local
    tiles restored."""
    from ..collections.redistribute import redistribute
    from ..data.data import Data
    from ..utils import checkpoint as ckpt

    t0 = time.perf_counter()
    man = ckpt.find_manifest(prefix)
    ours = ckpt._manifest_of(coll)
    geom_bad = [k for k in ckpt.GEOMETRY_KEYS
                if man.get(k, ours.get(k)) != ours.get(k)]
    if geom_bad:
        detail = "; ".join(f"{k}: snapshot {man.get(k)!r} != ours "
                           f"{ours.get(k)!r}" for k in geom_bad)
        raise ckpt.CheckpointMismatchError(
            f"cannot reshard {prefix}: tile GEOMETRY diverges ({detail}) "
            f"— resharding redistributes tiles between grids, it cannot "
            f"reinterpret tile shapes or dtypes")

    # the writer set and the fold come from the MANIFEST, never the
    # filesystem: ranks whose storage shows a different file set would
    # otherwise build divergent folds and the collective redistribution
    # below would be inserted inconsistently across ranks
    writers = sorted(set(_participants(man)))
    cur = _participants(coll)
    fold_map = {w: cur[i % len(cur)] for i, w in enumerate(writers)}
    src_rank = _src_rank_fn(man)
    mine = [w for w, r in fold_map.items() if r == coll.rank]

    def fold(w: int) -> int:
        return fold_map[w]

    t_load = time.perf_counter()
    loaded = _load_folded_shards(prefix, man, writers, mine)
    ce = _engine_of(context)
    if ce is not None:
        ce.elastic_stats["reshard_load_us"] += int(
            (time.perf_counter() - t_load) * 1e6)

    if len(cur) == 1:
        # single current participant: every writer folds here — plain
        # host copies, no taskpool/comm machinery required
        n = 0
        for (m, n_) in coll.tiles():
            if coll.rank_of(m, n_) != coll.rank:
                continue  # pragma: no cover - single participant owns all
            arr = loaded.get((m, n_))
            if arr is None:
                raise ckpt.CheckpointCorruptError(
                    f"snapshot {prefix} has no tile ({m},{n_}) in any "
                    f"reachable shard")
            # a host copy holding a device tensor or a read-only array
            # takes a writable buffer first (set_tile writes in place)
            Data.materialize_host(coll.data_of(m, n_).host_copy())
            coll.set_tile(m, n_, arr)
            n += 1
        _note_reshard(context, coll, n, t0)
        return n

    if context is None:
        raise ValueError(
            "reshard_restore onto a multi-rank grid is a collective "
            "redistribution: pass the rank's context (and call on every "
            "participant)")
    if getattr(coll, "name", None) in (None, type(coll).__name__):
        # the DTD registry keys tile messages by collection name: pin a
        # deterministic one before the SPMD-consistent insertion below
        coll.name = "resharded"
    view = _make_view(coll, man, loaded, fold, src_rank)
    tp = redistribute(view, coll, coll.lm, coll.ln, context=context,
                      tiles=list(coll.tiles()))
    n = sum(1 for _ in coll.local_tiles())
    plog.debug.verbose(2, "ft.elastic: reshard plan moved %d bytes "
                       "globally", getattr(tp, "redist_bytes", 0))
    _note_reshard(context, coll, n, t0)
    return n


def _note_reshard(context: Any, coll: Any, ntiles: int, t0: float) -> None:
    """Feed the FT::RESHARD_* gauges (engine-owned counters polled by
    obs.register_engine_gauges) — bytes = local tiles LANDED here;
    ``reshard_us`` covers the whole restore, shard loading included
    (``reshard_load_us`` is that part alone)."""
    ce = _engine_of(context)
    if ce is None:
        return
    nbytes = sum(
        coll.tile_shape(m, n)[0] * coll.tile_shape(m, n)[1]
        * coll.dtype.itemsize
        for (m, n) in coll.local_tiles())
    ce.elastic_stats["reshard_bytes"] += int(nbytes)
    ce.elastic_stats["reshard_us"] += int((time.perf_counter() - t0) * 1e6)
    plog.debug.verbose(2, "ft.elastic: resharded %d tile(s) / %d bytes "
                       "onto rank %d", ntiles, nbytes, coll.rank)


# --------------------------------------------------------------------- #
# membership agreement                                                  #
# --------------------------------------------------------------------- #
class ElasticCoordinator:
    """Per-rank membership agreement over TAG_ELASTIC / K_ELASTIC.

    Attaches to the engine (draining any frames buffered before a
    coordinator existed — a joiner may announce while the incumbents
    are mid-stage) and runs leader-decided vote/commit rounds:

    - every VOTER sends ``{"kind": "view", op, members, stage, epoch}``
      to all voters and records its own;
    - the LEADER (lowest-ranked voter) commits when every voter's view
      matches its proposal — broadcast ``commit`` + ``welcome`` the
      joiners — or, for an optional grow round, broadcasts ``abort``
      when the decision window expires;
    - NON-LEADERS wait for the matching decision; a leader death
      re-enters the round with the next-lowest leader.

    Shrink rounds are mandatory (survivors have nothing else to do, so
    they hold until the deadline then fall back to the strict abort);
    grow rounds are optional (the boundary is held only ``window``
    seconds — missing joiners stay pending for the next boundary).
    """

    def __init__(self, ce: Any) -> None:
        self.ce = ce
        self.rank = ce.rank
        self.world = ce.nb_ranks
        self._cond = threading.Condition()
        self._views: Dict[int, Dict[str, Any]] = {}
        self._joins: set = set()
        self._welcome: Optional[Dict[str, Any]] = None
        self._commit: Optional[Dict[str, Any]] = None
        self._aborts: set = set()          # (op, stage, epoch) tuples
        self._epoch = 0
        # attach under the engine's deferred lock: _on_elastic holds it
        # for its attach-check-or-buffer step, so no frame can slip
        # between this drain and the attach
        with ce._deferred_lock:
            buf = list(ce._elastic_buf)
            ce._elastic_buf.clear()
            ce.ft_elastic = self
        for src, payload in buf:
            self.deliver(src, payload)

    def detach(self) -> None:
        with self.ce._deferred_lock:
            if self.ce.ft_elastic is self:
                self.ce.ft_elastic = None

    # -- transport hooks (any thread) -----------------------------------
    def membership_changed(self) -> None:
        """A peer died or finished: wake any agreement wait so it
        re-proposes from the reduced set instead of waiting out its
        resend tick."""
        with self._cond:
            self._cond.notify_all()

    def deliver(self, src: int, payload: Dict[str, Any]) -> None:
        """One TAG_ELASTIC/K_ELASTIC frame (progress drain, or the TCP
        receiver thread)."""
        kind = payload.get("kind")
        gossip: List[int] = []
        with self._cond:
            if kind == "view":
                self._views[src] = payload
                for j in payload.get("joins", ()):
                    if j != self.rank:
                        self._joins.add(int(j))
                gossip = [int(d) for d in payload.get("dead", ())
                          if d != self.rank and d not in self.ce.dead_peers]
            elif kind == "join":
                self._joins.add(src)
            elif kind == "welcome":
                self._welcome = payload
            elif kind == "commit":
                self._commit = payload
            elif kind == "abort":
                self._aborts.add((payload.get("op"), payload.get("stage"),
                                  payload.get("epoch")))
            self._cond.notify_all()
        det = self.ce.ft_detector
        if det is not None:
            det.note_alive(src)   # an elastic frame is proof of life
        for d in gossip:
            # believe a peer's detector (crash-fault trust model): it
            # saw the death first; converging on the dead set NOW beats
            # waiting out our own heartbeat deadline
            self.ce.report_peer_failure(
                d, f"elastic membership view from rank {src}")

    # -- joiner side -----------------------------------------------------
    def announce_join(self, deadline_s: float = _TIMEOUT_S) -> Dict[str, Any]:
        """Broadcast this rank's arrival and wait for a welcome naming
        the member set and the snapshot stage to reshard from."""
        t_end = time.monotonic() + deadline_s
        last_tx = 0.0
        while time.monotonic() < t_end:
            now = time.monotonic()
            if now - last_tx >= _RESEND_S:
                last_tx = now
                for p in range(self.world):
                    if p != self.rank and p not in self.ce.dead_peers:
                        self.ce.ft_elastic_send(p, {"kind": "join"})
            with self._cond:
                w = self._welcome
                if w is not None:
                    self._welcome = None
                    self._epoch = int(w.get("epoch", self._epoch))
                    return w
                self._cond.wait(timeout=0.02)
            self.ce.progress()
        raise ElasticError(
            f"rank {self.rank}: join announcement went unanswered for "
            f"{deadline_s:.0f}s (no incumbent reached a quiescent point, "
            f"or grow is disabled on the incumbents)")

    def pending_joins(self, members: Sequence[int]) -> List[int]:
        with self._cond:
            return sorted(j for j in self._joins
                          if j not in members and j not in self.ce.dead_peers)

    # -- member side -----------------------------------------------------
    def _alive(self, members: Sequence[int]) -> List[int]:
        return [r for r in members
                if r == self.rank or (r not in self.ce.dead_peers
                                      and not self.ce.peer_finished(r))]

    def agree(self, op: str, members: Sequence[int], stage: int,
              deadline_s: float = _TIMEOUT_S,
              window_s: Optional[float] = None,
              tp_next: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """One agreement round as voter (and leader when lowest).

        Returns the decision ``{"members": tuple, "tp_base": int|None}``,
        or None when an optional (grow) round was aborted; raises
        :class:`ElasticError` on deadline or when this rank is excluded
        from the commit.

        ``tp_next`` is this rank's next taskpool WIRE id
        (``RemoteDepEngine.next_tp_id``): DTD traffic is keyed by
        registration-order wire ids, and participants of a resize can
        disagree on them (survivors diverge by one registration at a
        mid-stage failure; a joiner registered nothing at all), so every
        vote carries the counter and the commit/welcome carries
        ``tp_base`` — the max — which every participant syncs to before
        registering the reshard pool."""
        assert op in ("shrink", "grow")
        with self._cond:
            # an ABORTED round leaves same-epoch views behind (only a
            # commit concludes/bumps): drop them so this round's leader
            # cannot instantly "commit" on the previous boundary's
            # votes — live voters re-send within one resend tick
            self._views.clear()
        t_end = time.monotonic() + deadline_s
        while time.monotonic() < t_end:
            voters = self._alive(members)
            if not voters or (voters == [self.rank] and op == "shrink"):
                # last one standing: nothing to agree with
                self._conclude((self.rank,))
                return {"members": (self.rank,), "tp_base": tp_next,
                        "stage": stage}
            if op == "grow":
                joins = self.pending_joins(members)
                if not joins:
                    return None   # everyone already folded in elsewhere
                prop = tuple(sorted(set(voters) | set(joins)))
            else:
                joins = []
                prop = tuple(voters)
            leader = min(voters)
            with self._cond:
                epoch = self._epoch
                self._views[self.rank] = {"members": list(prop),
                                          "stage": stage, "op": op,
                                          "epoch": epoch,
                                          "tp_next": tp_next}
            vote = {"kind": "view", "op": op, "members": list(prop),
                    "stage": stage, "epoch": epoch, "joins": list(joins),
                    "tp_next": tp_next,
                    "dead": sorted(self.ce.dead_peers)}
            got = (self._lead(op, prop, voters, joins, stage, epoch, vote,
                              t_end, window_s)
                   if self.rank == leader else
                   self._follow(op, voters, leader, stage, epoch, vote,
                                t_end))
            if got == "retry":
                continue
            if got == "aborted":
                return None
            assert isinstance(got, dict)
            committed = tuple(got["members"])
            if self.rank not in committed:
                raise ElasticError(
                    f"rank {self.rank} was excluded from the committed "
                    f"member set {committed} (a peer's detector declared "
                    f"us dead) — aborting this incarnation")
            self._conclude(committed)
            return {"members": committed, "tp_base": got.get("tp_base"),
                    "stage": got.get("stage", stage)}
        raise ElasticError(
            f"rank {self.rank}: {op} agreement on stage {stage} did not "
            f"converge within {deadline_s:.0f}s")

    def _conclude(self, committed: Tuple[int, ...]) -> None:
        with self._cond:
            self._epoch += 1
            self._views.clear()
            self._commit = None
            self._joins.difference_update(committed)

    def _matching_votes(self, op: str, prop: Tuple[int, ...],
                        voters: Sequence[int],
                        epoch: int) -> bool:  # holds: self._cond
        """Votes match on (op, members, epoch) — NOT on stage: a rank
        leaves a pool's wait as soon as its local part terminates, so
        survivors of a mid-stage failure can sit one snapshot apart.
        The leader reconciles by committing the MINIMUM voted stage
        (every voter provably wrote that snapshot's own shards; ranks
        ahead of it simply replay)."""
        for v in voters:
            view = self._views.get(v)
            if (view is None or view.get("op") != op
                    or tuple(view.get("members", ())) != prop
                    or view.get("epoch") != epoch):
                return False
        return True

    def _lead(self, op, prop, voters, joins, stage, epoch, vote, t_end,
              window_s):
        """Leader half of one round: gather matching votes, then
        broadcast commit (+ welcomes) or — optional rounds only —
        abort."""
        w_end = (time.monotonic() + window_s) if window_s is not None \
            else t_end
        last_tx = 0.0
        while time.monotonic() < min(w_end, t_end):
            now = time.monotonic()
            if now - last_tx >= _RESEND_S:
                last_tx = now
                for p in voters:
                    if p != self.rank:
                        self.ce.ft_elastic_send(p, vote)
            with self._cond:
                ok = self._matching_votes(op, prop, voters, epoch)
                tp_base = c_stage = None
                if ok:
                    views = [self._views[v] for v in voters
                             if self._views.get(v) is not None]
                    vals = [v.get("tp_next") for v in views
                            if v.get("tp_next") is not None]
                    tp_base = max(vals) if vals else None
                    # the committed resume point: the lowest voted
                    # snapshot — every voter provably wrote its own
                    # shards for it; ranks ahead of it replay
                    c_stage = min(v.get("stage", stage) for v in views)
            if ok:
                decision = {"kind": "commit", "op": op,
                            "members": list(prop), "stage": c_stage,
                            "epoch": epoch, "tp_base": tp_base}
                for p in prop:
                    if p == self.rank:
                        continue
                    msg = decision if p in voters else {
                        "kind": "welcome", "members": list(prop),
                        "stage": c_stage, "epoch": epoch + 1,
                        "tp_base": tp_base}
                    self.ce.ft_elastic_send(p, msg)
                return decision
            if self._alive(voters) != list(voters):
                return "retry"   # a voter died: re-propose without it
            with self._cond:
                self._cond.wait(timeout=0.01)
            self.ce.progress()
        if time.monotonic() >= t_end:
            return "retry"       # outer loop raises on the deadline
        # optional round, window expired: release the boundary
        for p in voters:
            if p != self.rank:
                self.ce.ft_elastic_send(
                    p, {"kind": "abort", "op": op, "stage": stage,
                        "epoch": epoch})
        return "aborted"

    def _follow(self, op, voters, leader, stage, epoch, vote, t_end):
        """Non-leader half: vote, then wait for the leader's decision."""
        last_tx = 0.0
        while time.monotonic() < t_end:
            now = time.monotonic()
            if now - last_tx >= _RESEND_S:
                last_tx = now
                for p in voters:
                    if p != self.rank:
                        self.ce.ft_elastic_send(p, vote)
            with self._cond:
                # the commit's stage may differ from OUR vote (the
                # leader reconciles divergent snapshots to the min) —
                # only op + epoch identify the round
                c = self._commit
                if (c is not None and c.get("op") == op
                        and c.get("epoch") == epoch):
                    return c
                if (op, stage, epoch) in self._aborts:
                    self._aborts.discard((op, stage, epoch))
                    return "aborted"
                self._cond.wait(timeout=0.01)
            if leader in self.ce.dead_peers \
                    or self.ce.peer_finished(leader):
                return "retry"   # next-lowest voter takes over
            self.ce.progress()
        return "retry"


# --------------------------------------------------------------------- #
# policy + context wiring                                               #
# --------------------------------------------------------------------- #
class ElasticPolicy:
    """What the restart loop needs from the application to resize.

    ``rebuild(grid: GridSpec) -> (stages, collections)`` constructs the
    run on an arbitrary member grid — called for the initial grid too
    (pass ``stages=None`` to ``run_with_restart``), so there is ONE
    source of truth for how the job lays itself out. Fresh collections
    may hold initial data; a resize reshard-restores over every tile,
    so stale initial values never leak into a recovered run.

    ``mode``: "shrink" | "grow" | "both" (default: the ``ft_elastic``
    MCA param; empty disables, keeping today's fail-fast contract).
    ``members``: the initial member world-rank set (default: all
    ranks). ``join=True`` marks this rank a late joiner: it announces,
    waits for a welcome, reshards, and picks the run up mid-flight.
    """

    def __init__(self, rebuild: Callable[[GridSpec], Tuple[Sequence, Sequence]],
                 mode: Optional[str] = None,
                 members: Optional[Sequence[int]] = None,
                 grow_min: Optional[int] = None,
                 timeout: Optional[float] = None,
                 grow_window: float = _GROW_WINDOW_S,
                 join: bool = False) -> None:
        if mode is None:
            mode = str(params.get("ft_elastic") or "").strip()
        if mode not in ("", "shrink", "grow", "both"):
            raise ValueError(f"unknown ft_elastic mode {mode!r} "
                             f"(want shrink | grow | both)")
        self.rebuild = rebuild
        self.mode = mode
        self.members = tuple(members) if members is not None else None
        if grow_min is None:
            raw = params.get("ft_elastic_grow_min")
            grow_min = int(raw) if raw else 1
        self.grow_min = max(1, int(grow_min))
        if timeout is None:
            raw = str(params.get("ft_elastic_timeout") or "").strip()
            timeout = float(raw) if raw else _TIMEOUT_S
        self.timeout = float(timeout)
        self.grow_window = float(grow_window)
        self.join = bool(join)

    @property
    def allows_shrink(self) -> bool:
        return self.mode in ("shrink", "both")

    @property
    def allows_grow(self) -> bool:
        return self.mode in ("grow", "both")


def maybe_install_elastic(ctx: Any) -> Optional[ElasticCoordinator]:
    """Attach a coordinator to the context's engine when ``ft_elastic``
    is configured — Context calls this at init (after the detector, so
    eviction callbacks find it; before obs, so the gauges see the
    engine's elastic_stats) — join announcements arriving mid-stage
    then reach a live coordinator instead of the engine buffer."""
    if ctx.comm is None or ctx.nb_ranks < 2:
        return None
    if not str(params.get("ft_elastic") or "").strip():
        return None
    ce = getattr(ctx.comm, "ce", ctx.comm)
    if ce.ft_elastic is not None:
        return ce.ft_elastic
    return ElasticCoordinator(ce)
