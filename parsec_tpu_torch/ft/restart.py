"""Checkpoint-integrated restart: the recovery pillar of ft/.

``utils/checkpoint`` gives quiescent-point snapshots (a consistent
per-rank tile dump between taskpools); this module adds the POLICY that
turns snapshots into recovery: run a sequence of taskpool stages,
snapshot every K completed stages, and on failure either abort cleanly
(the pre-ft behavior, now guaranteed rather than best-effort) or roll
the collections back to the last snapshot and re-run from there, with
bounded, exponentially backed-off retries.

Scope: rollback-and-retry recovers IN PROCESS from transient faults
(an injected task fault, a failed send that aborted one stage) on
SINGLE-RANK contexts. A hard rank loss (``RankFailedError``, or this
rank's own ``InjectedKill``) cannot be re-run inside the same comm
world — the dead rank is gone (or IS us) — and on a multi-rank run
even a transient fault aborts: rollback is a local act the surviving
peers cannot observe, so a lone retry would leave them waiting on the
original taskpool forever. In both cases the driver aborts after
restoring a consistent snapshot set; a fresh incarnation of the job
(relaunched processes, or a fresh fabric in tests) then calls
:func:`run_with_restart` with ``resume_from`` pointing at the same
prefix and continues from the last completed stage. Either way the
guarantee is the same: the ON-DISK snapshot set is always a consistent
stage boundary, never a half-written DAG (the abort path also rolls
the in-memory collections back best-effort).

Device-resident tiles: a snapshot pulls each tile's newest copy from
the card (``checkpoint.save_collection``); a rollback writes the host
copies and bumps their versions, so the re-run stages the restored
values back in instead of reading the failed attempt's device copies.

With an ``elastic`` policy (``ft/elastic.py``) a peer's hard loss is
recovered in-world instead: the survivors agree on a reduced grid,
rebuild their collections on it, reshard-restore the last snapshot and
replay; joiners are folded in at stage boundaries. No process is
started for it.

Policy grammar (``--mca ft_restart_policy``)::

    abort                              # snapshot, but never retry
    restart:retries=2:backoff=0.25:every=1

`every=K` snapshots after every K completed stages (the last stage is
always snapshotted).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Sequence

from ..utils import checkpoint as ckpt
from ..utils import logging as plog
from ..utils.params import params

__all__ = ["RestartPolicy", "run_with_restart"]


class RestartPolicy:
    """mode="abort" | "restart"; retries/backoff/every as in the
    module docstring."""

    def __init__(self, mode: str = "restart", retries: int = 2,
                 backoff: float = 0.25, every: int = 1) -> None:
        if mode not in ("abort", "restart"):
            raise ValueError(f"unknown restart mode {mode!r}")
        if every < 1:
            raise ValueError("snapshot cadence `every` must be >= 1")
        self.mode = mode
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.every = int(every)

    @classmethod
    def parse(cls, spec: str) -> "RestartPolicy":
        parts = [p for p in spec.strip().split(":") if p]
        if not parts:
            return cls()
        kw: Dict[str, Any] = {"mode": parts[0]}
        for kv in parts[1:]:
            k, v = kv.split("=", 1)
            if k == "retries":
                kw["retries"] = int(v)
            elif k == "backoff":
                kw["backoff"] = float(v)
            elif k == "every":
                kw["every"] = int(v)
            else:
                raise ValueError(
                    f"ft_restart_policy: unknown key {k!r}")
        return cls(**kw)

    @classmethod
    def from_params(cls) -> "RestartPolicy":
        spec = str(params.get("ft_restart_policy") or "").strip()
        return cls.parse(spec) if spec else cls()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"RestartPolicy({self.mode}, retries={self.retries}, "
                f"backoff={self.backoff}, every={self.every})")


def _stage_prefix(prefix: str, stage: int) -> str:
    return f"{prefix}.stage{stage}"


def _save(collections: Sequence[Any], prefix: str, stage: int,
          context: Any) -> None:
    for i, coll in enumerate(collections):
        ckpt.save_collection(coll, f"{_stage_prefix(prefix, stage)}.c{i}",
                             context=context)


def _restore(collections: Sequence[Any], prefix: str, stage: int,
             context: Any = None, reshard: bool = False) -> None:
    for i, coll in enumerate(collections):
        ckpt.restore_collection(coll, f"{_stage_prefix(prefix, stage)}.c{i}",
                                reshard=reshard, context=context)


def _restore_fallback(collections: Sequence[Any], prefix: str, stage: int,
                      context: Any = None, reshard: bool = False) -> int:
    """Restore the stage-``stage`` snapshot set, falling back to the
    previous COMPLETE snapshot when a shard is torn/corrupt (a rank
    that crashed mid-write before atomic saves, or truncating storage,
    must not dead-end the whole recovery). Walks one stage at a time
    so skipped cadence stages (``every > 1``) are stepped over; the
    requested stage itself must at least exist. Returns the stage
    actually restored."""
    s = stage
    while True:
        try:
            _restore(collections, prefix, s, context=context,
                     reshard=reshard)
            return s
        except ckpt.CheckpointCorruptError as exc:
            if s <= 0:
                raise
            plog.warning(
                "ft.restart: snapshot at stage %d is torn/corrupt (%s); "
                "falling back toward the previous complete snapshot", s, exc)
            s -= 1
        except FileNotFoundError:
            if s <= 0 or s == stage:
                raise
            s -= 1   # not a snapshot boundary (every > 1): keep walking


def _complete_stage(ncolls: int, prefix: str, stage: int) -> int:
    """Latest stage <= ``stage`` whose FULL writer shard set is on disk
    for every collection — the stage this rank can safely VOTE in a
    shrink round. A rank killed after its stage completed but before
    its atomic save PUBLISHED leaves the newest snapshot one shard
    short; a reshard restore of it would dead-end mid-collective. Disk
    state is shared, so every survivor probing the same snapshot set
    computes the same answer (the SPMD consistency the vote needs)."""
    from .elastic import _participants

    def complete(s: int) -> bool:
        for i in range(ncolls):
            p = f"{_stage_prefix(prefix, s)}.c{i}"
            try:
                man = ckpt.find_manifest(p)
            except (FileNotFoundError, ckpt.CheckpointCorruptError):
                return False
            if not all(os.path.exists(ckpt.checkpoint_path(p, w))
                       for w in _participants(man)):
                return False
        return True

    s = stage
    while s > 0 and not complete(s):
        s -= 1   # skipped cadence stages (every > 1) also walk through
    return s


def run_with_restart(ctx: Any, stages: Optional[Sequence[Callable[[], Any]]],
                     collections: Optional[Sequence[Any]], prefix: str,
                     policy: Optional[RestartPolicy] = None,
                     resume_from: Optional[int] = None,
                     elastic: Optional[Any] = None) -> Dict[str, Any]:
    """Run ``stages`` (zero-arg factories, each returning a FRESH
    taskpool — a taskpool object cannot be re-enqueued) under the
    snapshot/rollback policy. ``collections`` is the application state
    the stages mutate; ``prefix`` names the snapshot files
    (``<prefix>.stage<k>.c<i>.rank<r>.npz``).

    Returns ``{"stages", "retries", "snapshots", "last_snapshot",
    "resizes", "grid"}``. ``resume_from=k`` skips the initial
    snapshot, restores the stage-k snapshot set, and continues with
    stage k — the fresh-incarnation entry point after a hard rank
    loss.

    ``elastic`` (an :class:`ft.elastic.ElasticPolicy`) turns hard rank
    loss from a dead end into a resize: on a ``RankFailedError`` with
    shrink enabled the survivors agree on a reduced grid, rebuild the
    run via ``elastic.rebuild(grid)``, reshard-restore the last
    snapshot onto it, and replay from ``last_snap``; with grow
    enabled, announced joiners are folded in at stage boundaries
    (fresh-snapshot quiescent points), gated by
    ``elastic.grow_min``. With ``elastic`` the ``stages``/
    ``collections`` arguments may be ``None`` — ``rebuild`` is then
    the single source of truth for the initial grid too. Strict runs
    (no ``elastic``, or ``ft_elastic`` unset) keep today's fail-fast
    behavior exactly.
    """
    # a coordinator this call creates is detached on exit: leaving it
    # attached would carry pending joins/views into a LATER run on the
    # same context (phantom grow rounds holding every boundary). One
    # installed by Context (maybe_install_elastic) outlives the call.
    co_made = None
    if (elastic is not None and elastic.mode and ctx.comm is not None
            and ctx.nb_ranks >= 2):
        ce = getattr(ctx.comm, "ce", ctx.comm)
        if ce.ft_elastic is None:
            from .elastic import ElasticCoordinator
            co_made = ElasticCoordinator(ce)
    try:
        return _run_with_restart(ctx, stages, collections, prefix,
                                 policy, resume_from, elastic)
    finally:
        if co_made is not None:
            co_made.detach()


def _run_with_restart(ctx, stages, collections, prefix, policy,
                      resume_from, elastic) -> Dict[str, Any]:
    policy = policy or RestartPolicy.from_params()
    co = grid = ce = None
    joined_at: Optional[int] = None
    if elastic is not None and not elastic.mode:
        elastic = None   # knob off: strict contract, bit for bit
    if elastic is not None:
        if ctx.comm is None or ctx.nb_ranks < 2:
            raise ValueError(
                "elastic recovery needs a multi-rank comm world")
        from .elastic import ElasticCoordinator, plan_grid
        ce = getattr(ctx.comm, "ce", ctx.comm)
        co = ce.ft_elastic or ElasticCoordinator(ce)
        members = elastic.members or tuple(range(ctx.nb_ranks))
        grid = plan_grid(members, ctx.nb_ranks, ctx.rank)
        if elastic.join:
            # late joiner: announce, learn the member set + resume
            # stage from the welcome, reshard into the grown grid
            welcome = co.announce_join(deadline_s=elastic.timeout)
            if welcome.get("tp_base") is not None:
                # align taskpool WIRE ids with the incumbents (DTD
                # traffic is keyed by registration order, and they
                # registered pools for every stage we never ran)
                ctx.comm.sync_tp_ids(int(welcome["tp_base"]))
            grid = plan_grid(tuple(welcome["members"]), ctx.nb_ranks,
                             ctx.rank)
            stages, collections = elastic.rebuild(grid)
            joined_at = int(welcome["stage"])
            _restore(collections, prefix, joined_at, context=ctx,
                     reshard=True)
            ce.elastic_stats["elastic_resizes"] += 1
            ce.elastic_stats["elastic_joins"] += 1
            plog.inform("ft.restart: rank %d joined grid %dx%d (members "
                        "%s) at stage %d", ctx.rank, grid.P, grid.Q,
                        grid.members, joined_at)
        elif stages is None:
            stages, collections = elastic.rebuild(grid)
    assert stages is not None and collections is not None, \
        "stages/collections may only be omitted with an elastic policy"
    n = len(stages)
    retries_total = snapshots = resizes = 0
    if joined_at is not None:
        i = last_snap = joined_at
        resizes = 1   # the join itself resized this rank's grid
    elif resume_from is None:
        _save(collections, prefix, 0, ctx)
        snapshots += 1
        i = last_snap = 0
    else:
        i = last_snap = _restore_fallback(
            collections, prefix, resume_from, context=ctx,
            reshard=elastic is not None)
    # per-STAGE attempt counters: with every>1 a rollback replays
    # earlier (succeeding) stages, and a single shared counter reset on
    # their completion would let a persistently failing stage retry
    # forever with the backoff stuck at its first step
    attempts: Dict[int, int] = {}
    while i < n:
        try:
            tp = stages[i]()
            ctx.add_taskpool(tp)
            ctx.wait()
        except Exception as exc:  # noqa: BLE001 - the policy decides
            root = exc.__cause__ or exc
            from ..comm.engine import RankFailedError
            from .inject import InjectedKill
            # hard = unrecoverable in this incarnation: a peer is gone
            # (RankFailedError) or THIS rank was killed (InjectedKill —
            # its engine is permanently dark; retrying a stage on it
            # would hang termdet, the exact failure ft/ exists to stop)
            hard = isinstance(root, (RankFailedError, InjectedKill))
            # elastic shrink: a PEER's loss is recoverable in-world —
            # the survivors agree on a reduced grid and reshard the
            # last snapshot onto it. Our OWN kill (InjectedKill) is
            # not: this engine is dark — and neither is a silenced
            # (kill-injected) engine whose own detector evicted every
            # peer it stopped hearing: a dead rank must never "win" a
            # phantom agreement with itself. Bounded by the world size
            # so a cascade of losses cannot loop forever.
            # split-brain guard: a LINK fault partitions the
            # grid without killing anyone — both sides of the partition
            # would otherwise shrink to themselves and double-complete.
            # Only the side still seeing a STRICT MAJORITY of the
            # current members may resize; a minority partition takes
            # the strict abort (its snapshots stay consistent, and a
            # fresh incarnation can resume). Kill-based losses on >= 3
            # ranks are unaffected: the survivors ARE the majority.
            majority = True
            if (co is not None and grid is not None
                    and isinstance(root, RankFailedError)):
                reachable = [m for m in grid.members
                             if m == ctx.rank or m not in ce.dead_peers]
                majority = 2 * len(reachable) > len(grid.members)
                if not majority and elastic.allows_shrink:
                    plog.warning(
                        "ft.restart: only %d of %d members reachable — "
                        "a minority partition must not shrink (split-"
                        "brain); falling back to the strict abort path",
                        len(reachable), len(grid.members))
            if (co is not None and elastic.allows_shrink and majority
                    and isinstance(root, RankFailedError)
                    and not isinstance(root, InjectedKill)
                    and not getattr(ce, "_ft_silenced", False)
                    and resizes < ctx.nb_ranks):
                from .elastic import ElasticError, plan_grid
                recovered = False
                tries = 0
                # another rank can die DURING the agreement or the
                # reshard itself — re-enter with the further-reduced
                # survivor set; bounded by the world size
                while resizes + tries < ctx.nb_ranks:
                    try:
                        ctx.clear_task_errors()
                        # vote a snapshot this rank can PROVE complete:
                        # the dead rank may have died between finishing
                        # the stage and publishing its shard
                        safe = _complete_stage(len(collections), prefix,
                                               last_snap)
                        decision = co.agree(
                            "shrink", grid.members, safe,
                            deadline_s=elastic.timeout,
                            tp_next=getattr(ctx.comm, "next_tp_id", None))
                        if 2 * len(decision["members"]) \
                                <= len(grid.members):
                            # deaths DURING the round can shrink the
                            # committed set below a majority (down to
                            # this rank alone on a full partition):
                            # re-validate the decision, not just the
                            # entry view — the minority side must abort
                            raise ElasticError(
                                f"committed members "
                                f"{tuple(decision['members'])} are a "
                                f"minority of {grid.members} — refusing "
                                f"a split-brain resize")
                        if decision["tp_base"] is not None:
                            # survivors can diverge by one registration
                            # at a mid-stage failure: align wire ids
                            # before the reshard pool registers
                            ctx.comm.sync_tp_ids(decision["tp_base"])
                        grid = plan_grid(decision["members"],
                                         ctx.nb_ranks, ctx.rank)
                        stages, collections = elastic.rebuild(grid)
                        assert len(stages) == n, \
                            "elastic rebuild changed the stage count"
                        # the COMMITTED stage (min over votes — peers a
                        # snapshot behind us reconcile the round there;
                        # every voter provably wrote that snapshot)
                        last_snap = int(decision["stage"])
                        _restore(collections, prefix, last_snap,
                                 context=ctx, reshard=True)
                        ce.elastic_stats["elastic_resizes"] += 1
                        resizes += 1
                        recovered = True
                        break
                    except Exception as eexc:  # noqa: BLE001 - triaged below
                        nested = eexc.__cause__ or eexc
                        if isinstance(nested, RankFailedError) \
                                and not isinstance(nested, InjectedKill):
                            tries += 1
                            plog.warning(
                                "ft.restart: rank failure during elastic "
                                "shrink (%s) — re-agreeing on the reduced "
                                "survivor set", nested)
                            continue
                        plog.warning(
                            "ft.restart: elastic shrink failed (%s: %s) — "
                            "falling back to the strict abort path",
                            type(eexc).__name__, eexc)
                        break
                if recovered:
                    plog.warning(
                        "ft.restart: elastic shrink -> %dx%d over members "
                        "%s after %s; resharded snapshot %d, replaying",
                        grid.P, grid.Q, grid.members,
                        type(root).__name__, last_snap)
                    i = last_snap
                    continue
            # in-world rollback is a LOCAL act: on a multi-rank run the
            # peers saw no error and keep waiting on the original
            # taskpool (whose wire id a lone re-registration would
            # shift), so an uncoordinated retry deadlocks them — on
            # multi-rank, every failure aborts to a consistent snapshot
            # and recovery is a fresh incarnation (resume_from)
            multi = int(getattr(ctx, "nb_ranks", 1) or 1) > 1
            attempt = attempts[i] = attempts.get(i, 0) + 1
            if policy.mode == "abort" or hard or multi \
                    or attempt > policy.retries:
                # guaranteed-clean abort: errors drained, scheduler
                # queues flushed, the last snapshot still consistent —
                # a fresh incarnation resumes with resume_from=last_snap
                ctx.clear_task_errors()
                # best-effort in-memory rollback too, so a caller that
                # catches the abort never sees half-mutated tiles; the
                # ON-DISK snapshot set is the hard guarantee (a failed
                # restore must not mask the original error)
                try:
                    _restore_fallback(collections, prefix, last_snap)
                except Exception:  # noqa: BLE001  pragma: no cover
                    plog.warning("ft.restart: in-memory rollback to "
                                 "snapshot %d failed; on-disk snapshots "
                                 "remain authoritative", last_snap)
                why = (" — hard rank loss" if hard else
                       " — in-world retry unsupported on multi-rank "
                       "runs (peers cannot observe this rank's "
                       "rollback)" if multi and policy.mode != "abort"
                       else "")
                plog.warning(
                    "ft.restart: aborting at stage %d after %d "
                    "attempt(s) (%s%s); resume_from=%d", i, attempt,
                    type(root).__name__, why, last_snap)
                raise
            delay = policy.backoff * (2 ** (attempt - 1))
            plog.warning(
                "ft.restart: stage %d failed (%s: %s) — rolling back "
                "to snapshot %d, retry %d/%d in %.2fs", i,
                type(root).__name__, root, last_snap, attempt,
                policy.retries, delay)
            retries_total += 1
            time.sleep(delay)
            ctx.clear_task_errors()
            i = last_snap = _restore_fallback(collections, prefix, last_snap)
            continue
        i += 1
        if (i - last_snap) >= policy.every or i == n:
            _save(collections, prefix, i, ctx)
            snapshots += 1
            last_snap = i
        # elastic grow: fold announced joiners in at a quiescent point
        # that has a FRESH snapshot (the joiner reshards from it). The
        # round is optional — the leader holds the boundary only
        # ``grow_window`` seconds, so a straggling incumbent defers
        # the resize to the next boundary instead of stalling the run.
        if (co is not None and elastic.allows_grow and i < n
                and last_snap == i):
            # a fast, purely-local stage can complete without one comm
            # progress cycle: drain the engine HERE or a join sitting in
            # the inbox is invisible at exactly the boundary it targets
            ce.progress()
            joins = co.pending_joins(grid.members)
            if len(joins) >= elastic.grow_min:
                from .elastic import ElasticError, plan_grid
                try:
                    decision = co.agree(
                        "grow", grid.members, last_snap,
                        deadline_s=elastic.timeout,
                        window_s=elastic.grow_window,
                        tp_next=getattr(ctx.comm, "next_tp_id", None))
                except ElasticError as eexc:
                    # the round is OPTIONAL: a non-converging agreement
                    # (e.g. a peer saw the join only after passing its
                    # own boundary check, so it never voted) must not
                    # abort a healthy run — release the boundary, the
                    # joiner stays pending for the next one
                    plog.warning(
                        "ft.restart: grow round at stage %d released "
                        "(%s); joiners stay pending", last_snap, eexc)
                    decision = None
                if decision is not None:
                    committed = decision["members"]
                    if decision["tp_base"] is not None:
                        ctx.comm.sync_tp_ids(decision["tp_base"])
                    new = [r for r in committed if r not in grid.members]
                    grid = plan_grid(committed, ctx.nb_ranks, ctx.rank)
                    stages, collections = elastic.rebuild(grid)
                    assert len(stages) == n, \
                        "elastic rebuild changed the stage count"
                    # adopt the COMMITTED stage: an incumbent a boundary
                    # ahead of the slowest voter replays from the common
                    # snapshot so every member (joiner included) runs
                    # the same remaining stage sequence in lockstep
                    i = last_snap = int(decision["stage"])
                    _restore(collections, prefix, last_snap, context=ctx,
                             reshard=True)
                    ce.elastic_stats["elastic_resizes"] += 1
                    ce.elastic_stats["elastic_joins"] += len(new)
                    resizes += 1
                    plog.inform(
                        "ft.restart: elastic grow -> %dx%d over members "
                        "%s (+%s); resharded snapshot %d",
                        grid.P, grid.Q, grid.members, new, last_snap)
    return {"stages": n, "retries": retries_total,
            "snapshots": snapshots, "last_snapshot": last_snap,
            "resizes": resizes,
            "grid": grid.members if grid is not None else None}
