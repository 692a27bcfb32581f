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

This package carries the strict contract only: the JAX package's
elastic grid recovery (``ft/elastic.py``: shrink/grow resizes and the
resharding restore) needs ``collections/redistribute.py`` (ROADMAP
Queue 1 item 5), and an ``elastic=`` argument raises
NotImplementedError.

Policy grammar (``--mca ft_restart_policy``)::

    abort                              # snapshot, but never retry
    restart:retries=2:backoff=0.25:every=1

`every=K` snapshots after every K completed stages (the last stage is
always snapshotted).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

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
             context: Any = None) -> None:
    for i, coll in enumerate(collections):
        ckpt.restore_collection(coll, f"{_stage_prefix(prefix, stage)}.c{i}",
                                context=context)


def _restore_fallback(collections: Sequence[Any], prefix: str, stage: int,
                      context: Any = None) -> int:
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
            _restore(collections, prefix, s, context=context)
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


def _participants(man: Dict[str, Any]) -> List[int]:
    """World ranks that own at least one logical grid slot of a
    snapshot's manifest: ``members`` when recorded (a remapped grid
    written by the JAX package's elastic recovery), else the identity
    map over the logical grid (this package's own copy of the JAX
    package's ``ft/elastic._participants``, manifest form)."""
    if man.get("members") is not None:
        return list(man["members"])
    p, q = man.get("P"), man.get("Q")
    if p and q:
        return list(range(int(p) * int(q)))
    return list(range(int(man.get("nodes", 1))))


def _complete_stage(ncolls: int, prefix: str, stage: int) -> int:
    """Latest stage <= ``stage`` whose FULL writer shard set is on disk
    for every collection. A rank killed after its stage completed but
    before its atomic save PUBLISHED leaves the newest snapshot one
    shard short. Disk state is shared, so every survivor probing the
    same snapshot set computes the same answer."""
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


def run_with_restart(ctx: Any, stages: Sequence[Callable[[], Any]],
                     collections: Sequence[Any], prefix: str,
                     policy: Optional[RestartPolicy] = None,
                     resume_from: Optional[int] = None,
                     elastic: Optional[Any] = None) -> Dict[str, Any]:
    """Run ``stages`` (zero-arg factories, each returning a FRESH
    taskpool — a taskpool object cannot be re-enqueued) under the
    snapshot/rollback policy. ``collections`` is the application state
    the stages mutate; ``prefix`` names the snapshot files
    (``<prefix>.stage<k>.c<i>.rank<r>.npz``).

    Returns ``{"stages", "retries", "snapshots", "last_snapshot",
    "resizes", "grid"}`` (``resizes`` 0 and ``grid`` None: no elastic
    recovery here). ``resume_from=k`` skips the initial snapshot,
    restores the stage-k snapshot set, and continues with stage k — the
    fresh-incarnation entry point after a hard rank loss.

    ``elastic`` (the JAX package's ElasticPolicy) raises
    NotImplementedError: grid resizes need the resharding restore
    (ROADMAP Queue 1 item 5).
    """
    if elastic is not None:
        raise NotImplementedError(
            "run_with_restart(elastic=...): elastic grid recovery needs "
            "ft/elastic.py and collections/redistribute.py, which this "
            "package does not carry yet (ROADMAP Queue 1 item 5)")
    policy = policy or RestartPolicy.from_params()
    n = len(stages)
    retries_total = snapshots = 0
    if resume_from is None:
        _save(collections, prefix, 0, ctx)
        snapshots += 1
        i = last_snap = 0
    else:
        i = last_snap = _restore_fallback(
            collections, prefix, resume_from, context=ctx)
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
    return {"stages": n, "retries": retries_total,
            "snapshots": snapshots, "last_snapshot": last_snap,
            "resizes": 0, "grid": None}
