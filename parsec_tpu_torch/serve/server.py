"""SessionServer: multi-tenant persistent serving over one Context.

One long-lived :class:`~parsec_tpu_torch.runtime.context.Context` is shared by
named **tenants**; each tenant submits taskpools (PTG specs or DTD
closures, built by a zero-argument callable) that run concurrently on
the context's workers.  The server is the policy layer in front of the
untouched runtime:

- **admission control** — per-tenant caps on in-flight taskpools and
  tasks plus a declared byte quota (optionally fed by live named-Mempool
  outstanding-byte accounting); over-quota submissions are rejected
  (``serve_admission=reject``) or queued FIFO per tenant
  (``serve_admission=queue``) and drained as earlier pools retire;
- **weighted fairness** — tenant weight/priority class feeds
  :class:`~parsec_tpu_torch.serve.fairness.TenantFairness`, whose deficit
  boosts ``stamp_dynamic_priority`` folds above the class-profile band
  (runtime/scheduling.py); the ap/spq/pbq schedulers are untouched;
- **attribution** — the submitting tenant is stamped into the pool's
  flow context (``FlowIds.tenants``) and charged into the live health
  monitor (:meth:`LiveHealth.note_tenant_latency`), so window digests,
  ``/health``, obs_report and merged timelines group per tenant; the
  ``PARSEC::SERVE::*`` gauges are registered on the context's SDE
  registry only when a server is constructed.

A remote front-end rides the existing active-message layer:
:meth:`attach_engine` installs a ``TAG_SERVE`` handler consuming the
versioned envelopes of :mod:`parsec_tpu_torch.comm.wire`
(``serve_request``/``serve_reply``); over TCP the endpoint is gated by
the HELLO ``"sv"`` capability, so a knob-unset peer's wire bytes are
bit-for-bit those of a pre-serve build.

Lock ordering: the server lock is a leaf — taskpool construction,
``ctx.add_taskpool`` and reply sends all happen OUTSIDE it (completion
callbacks fire on worker threads holding taskpool claim state, and the
AM handler runs on whichever thread drains comm progress).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.spans import (SERVE_ADMITTED, SERVE_INFLIGHT_PREFIX,
                         SERVE_P99_LATENCY_PREFIX, SERVE_QUEUED,
                         SERVE_QUOTA_BYTES_PREFIX, SERVE_REJECTED,
                         SERVE_TENANTS)
from ..utils import logging as plog
from ..utils.params import params
from .fairness import TenantFairness

__all__ = ["AdmissionError", "SessionServer", "Submission", "Tenant"]

# Tenant/Submission mutable fields (inflight_*, queued, lat_us,
# waiters, charged) are guarded by the owning SessionServer's _lock too
# — the lint's recv.lock matching can only express same-receiver
# guards, so those stay documentation (class docstrings) rather than
# declarations.  _nq (global queued count) is written under _lock and
# read lock-free as kick()'s fast-path early-out.
_GUARDED_BY = {
    "SessionServer._tenants": "_lock",
    "SessionServer._subs": "_lock",
}

#: default per-tenant latency ring length (server-side; the live
#: monitor keeps its own ring of the same default for fleet merging);
#: both resize from the serve_latency_window knob at construction
_LAT_RING = 512


class AdmissionError(RuntimeError):
    """Submission rejected by admission control (cap or quota)."""


class Tenant:
    """One named session: weight, caps, quota, accounting.

    All mutable fields are guarded by the owning server's ``_lock``
    (the server mediates every access; tenants have no lock of their
    own)."""

    __slots__ = ("name", "weight", "quota_bytes", "max_pools", "max_tasks",
                 "inflight_pools", "inflight_tasks", "inflight_bytes",
                 "queued", "lat_us", "mempools", "pools_done", "_gauges")

    def __init__(self, name: str, weight: int, quota_bytes: int,
                 max_pools: int, max_tasks: int,
                 lat_ring: int = _LAT_RING) -> None:
        self.name = name
        self.weight = max(1, int(weight))
        self.quota_bytes = int(quota_bytes)   # 0 = unlimited
        self.max_pools = int(max_pools)       # 0 = unlimited
        self.max_tasks = int(max_tasks)       # 0 = unlimited
        self.inflight_pools = 0
        self.inflight_tasks = 0
        self.inflight_bytes = 0
        self.queued: deque = deque()          # queued Submissions (FIFO)
        self.lat_us: deque = deque(maxlen=max(1, int(lat_ring)))
        self.pools_done = 0
        # named-Mempool quota feeds: (mempool, item_bytes)
        self.mempools: List[Tuple[Any, int]] = []
        self._gauges: List[Tuple[str, Callable]] = []

    def used_bytes_locked(self) -> int:  # holds: server._lock
        n = self.inflight_bytes
        for mp, item_bytes in self.mempools:
            n += int(mp.nb_outstanding) * int(item_bytes)
        return n


class Submission:
    """One admitted (or queued) taskpool submission."""

    __slots__ = ("ticket", "tenant", "build", "nbytes", "ntasks", "name",
                 "t_submit_ns", "taskpool", "done", "error", "waiters",
                 "lat_us", "charged")

    def __init__(self, ticket: int, tenant: str, build: Callable[[], Any],
                 nbytes: int, ntasks: int, name: Optional[str]) -> None:
        self.ticket = ticket
        self.tenant = tenant
        self.build = build
        self.nbytes = int(nbytes)
        self.ntasks = max(1, int(ntasks))
        self.name = name
        self.t_submit_ns = time.monotonic_ns()
        self.taskpool = None
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.lat_us = 0.0
        # admission currently charged against the tenant (server _lock);
        # makes the release path idempotent against done/abort races
        self.charged = False
        # deferred remote "wait" replies: (src_rank, req_id)
        self.waiters: List[Tuple[int, int]] = []

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class SessionServer:
    """The serving front-end bound to one persistent Context."""

    def __init__(self, ctx, admission: Optional[str] = None) -> None:
        self.ctx = ctx
        if admission is None:
            admission = params.get_or("serve_admission", "string", "reject")
        if admission not in ("reject", "queue"):
            raise ValueError(f"serve_admission must be reject|queue, "
                             f"got {admission!r}")
        self.admission = admission
        self.max_tenants = int(params.get_or("serve_max_tenants", "int", 64))
        self.default_weight = int(
            params.get_or("serve_default_weight", "int", 1))
        self.default_quota = int(
            params.get_or("serve_default_quota_bytes", "sizet", 0))
        self.lat_ring = max(1, int(
            params.get_or("serve_latency_window", "int", _LAT_RING)))
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}
        self._subs: Dict[int, Submission] = {}
        self._next_ticket = 0
        self._nq = 0              # queued submissions across all tenants
        self._hooked_mempools: List[Any] = []
        self._closed = False
        self._ce = None
        self.fairness = TenantFairness()
        # hook the restamping seam: stamp_dynamic_priority now folds our
        # deficit boosts above the class-profile band
        ctx.serve_fairness = self.fairness
        # hook the flow stamp: outgoing wire contexts for pools we own
        # carry the submitting tenant (5th tuple slot, capability-gated)
        ce = getattr(ctx.comm, "ce", ctx.comm) if ctx.comm is not None \
            else None
        fl = getattr(ce, "_flow", None)
        if fl is not None:
            fl.tenants = self.fairness._pools
        # global serve gauges; per-tenant gauges register in open_tenant
        ctx.sde.register_poll(SERVE_TENANTS, lambda: len(self._tenants))
        plog.inform("serve: session server up (admission=%s, rank %d)",
                    self.admission, ctx.rank)

    # ------------------------------------------------------------------ #
    # tenants                                                            #
    # ------------------------------------------------------------------ #
    def open_tenant(self, name: str, weight: Optional[int] = None,
                    quota_bytes: Optional[int] = None, max_pools: int = 0,
                    max_tasks: int = 0) -> Tenant:
        """Open (or re-open idempotently) a named tenant session."""
        if weight is None:
            weight = self.default_weight
        if quota_bytes is None:
            quota_bytes = self.default_quota
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                return t
            if len(self._tenants) >= self.max_tenants:
                raise AdmissionError(
                    f"tenant cap reached ({self.max_tenants})")
            t = Tenant(name, weight, quota_bytes, max_pools, max_tasks,
                       lat_ring=self.lat_ring)
            self._tenants[name] = t
        self.fairness.register(name, t.weight)
        self._register_tenant_gauges(t)
        return t

    def close_tenant(self, name: str) -> None:
        with self._lock:
            t = self._tenants.pop(name, None)
            if t is not None:
                self._nq -= len(t.queued)
        if t is None:
            return
        self.fairness.forget(name)
        for gname, fn in t._gauges:
            self.ctx.sde.unregister(gname, fn)
        t._gauges.clear()
        # queued submissions can never launch now: fail them so local
        # and remote waiters unblock instead of timing out
        for sub in t.queued:
            self._finish(sub, error=f"tenant {name!r} closed")
        t.queued.clear()

    def bind_mempool(self, tenant: str, mempool, item_bytes: int) -> None:
        """Feed a named Mempool's outstanding bytes into the tenant's
        quota: ``nb_outstanding * item_bytes`` counts against
        ``quota_bytes`` at admission time, so a tenant holding tiles
        hostage admits less new work.

        The pool's ``on_free`` hook is pointed at :meth:`kick` so that
        quota headroom appearing from a mempool free re-admits queued
        submissions — a tenant with zero in-flight pools has no
        ``_pool_done`` event to drain its queue otherwise."""
        with self._lock:
            t = self._tenants[tenant]
            t.mempools.append((mempool, int(item_bytes)))
        if getattr(mempool, "on_free", None) is None:
            mempool.on_free = self.kick
            self._hooked_mempools.append(mempool)

    def _register_tenant_gauges(self, t: Tenant) -> None:
        name = t.name
        sde = self.ctx.sde

        def _inflight() -> int:
            return t.inflight_pools  # lock: point-in-time gauge read

        def _quota() -> int:
            with self._lock:
                return t.used_bytes_locked()

        def _p99() -> float:
            with self._lock:
                lat = list(t.lat_us)
            return _pct(lat, 0.99) if lat else 0.0

        for gname, fn in ((f"{SERVE_INFLIGHT_PREFIX}::{name}", _inflight),
                          (f"{SERVE_QUOTA_BYTES_PREFIX}::{name}", _quota),
                          (f"{SERVE_P99_LATENCY_PREFIX}::{name}", _p99)):
            sde.register_poll(gname, fn)
            t._gauges.append((gname, fn))

    # ------------------------------------------------------------------ #
    # submission                                                         #
    # ------------------------------------------------------------------ #
    def submit(self, tenant: str, build: Callable[[], Any], *,
               nbytes: int = 0, ntasks: int = 1,
               name: Optional[str] = None) -> Submission:
        """Submit one taskpool for ``tenant``.

        ``build`` is a zero-argument callable returning a NOT-yet-added
        Taskpool (PTG spec instantiation or a DTD closure).  ``nbytes``
        and ``ntasks`` are the declared footprint admission charges
        against the tenant's quota/caps.  Returns a
        :class:`Submission`; raises :class:`AdmissionError` under the
        ``reject`` policy, queues under ``queue``."""
        with self._lock:
            if self._closed:
                raise AdmissionError("server closed")
            t = self._tenants.get(tenant)
            if t is None:
                raise AdmissionError(f"unknown tenant {tenant!r}")
            self._next_ticket += 1
            sub = Submission(self._next_ticket, tenant, build, nbytes,
                             ntasks, name)
            self._subs[sub.ticket] = sub
            verdict = self._admit_locked(t, sub)
            if verdict == "admit":
                self._charge_locked(t, sub)
            elif verdict == "queue":
                t.queued.append(sub)
                self._nq += 1
        if verdict == "admit":
            self.ctx.sde.inc(SERVE_ADMITTED)
            self._launch(sub)
        elif verdict == "queue":
            self.ctx.sde.inc(SERVE_QUEUED)
        else:
            self.ctx.sde.inc(SERVE_REJECTED)
            with self._lock:
                del self._subs[sub.ticket]
            raise AdmissionError(verdict)
        return sub

    def _admit_locked(self, t: Tenant,
                      sub: Submission) -> str:  # holds: self._lock
        """"admit", "queue", or a rejection reason string."""
        over = None
        if t.max_pools and t.inflight_pools >= t.max_pools:
            over = (f"tenant {t.name!r} at max in-flight taskpools "
                    f"({t.max_pools})")
        elif t.max_tasks and t.inflight_tasks + sub.ntasks > t.max_tasks:
            over = (f"tenant {t.name!r} at max in-flight tasks "
                    f"({t.max_tasks})")
        elif t.quota_bytes and \
                t.used_bytes_locked() + sub.nbytes > t.quota_bytes:
            over = (f"tenant {t.name!r} over byte quota "
                    f"({t.used_bytes_locked() + sub.nbytes} > "
                    f"{t.quota_bytes})")
        if over is None:
            return "admit"
        return "queue" if self.admission == "queue" else over

    def _charge_locked(self, t: Tenant,
                       sub: Submission) -> None:  # holds: self._lock
        sub.charged = True
        t.inflight_pools += 1
        t.inflight_tasks += sub.ntasks
        t.inflight_bytes += sub.nbytes

    def _drain_locked(self, t: Tenant
                      ) -> List[Submission]:  # holds: self._lock
        """Pop + charge the tenant's queue head(s) that now fit; the
        caller launches them OUTSIDE the lock."""
        promoted: List[Submission] = []
        while t.queued:
            nxt = t.queued[0]
            if self._admit_locked(t, nxt) != "admit":
                break
            t.queued.popleft()
            self._nq -= 1
            self._charge_locked(t, nxt)
            promoted.append(nxt)
        return promoted

    def _release(self, sub: Submission, *,
                 completed: bool) -> List[Submission]:
        """Un-charge ``sub``'s admission and drain the tenant's queue.

        Every path that charged a submission funnels here — normal
        completion, build/enqueue failure, and taskpool abort — so the
        tenant's capacity can never leak; the ``charged`` flag makes it
        idempotent.  Returns the promoted submissions for the caller to
        launch outside the lock."""
        with self._lock:
            if not sub.charged:
                return []
            sub.charged = False
            t = self._tenants.get(sub.tenant)
            if t is None:
                return []
            t.inflight_pools = max(0, t.inflight_pools - 1)
            t.inflight_tasks = max(0, t.inflight_tasks - sub.ntasks)
            t.inflight_bytes = max(0, t.inflight_bytes - sub.nbytes)
            if completed:
                t.pools_done += 1
                t.lat_us.append(sub.lat_us)
            return self._drain_locked(t)

    def _launch_promoted(self, promoted: List[Submission]) -> None:
        for nxt in promoted:
            self.ctx.sde.inc(SERVE_ADMITTED)
            self._launch(nxt)

    def kick(self) -> None:
        """Re-evaluate every tenant's queued submissions against the
        CURRENT capacity.  Headroom can appear without any same-tenant
        pool completing — a bound Mempool's outstanding bytes dropped —
        and ``_pool_done``'s drain never fires for a tenant with zero
        in-flight pools, so bound mempools invoke this from their free
        path (callers with external quota feeds may call it directly).
        Lock-free fast path: the plain global queued-count."""
        if not self._nq:
            return
        promoted: List[Submission] = []
        with self._lock:
            if self._closed:
                return
            for t in self._tenants.values():
                if t.queued:
                    promoted.extend(self._drain_locked(t))
        self._launch_promoted(promoted)

    def _launch(self, sub: Submission) -> None:
        """Build + enqueue OUTSIDE the server lock (add_taskpool takes
        runtime locks and may schedule inline)."""
        try:
            tp = sub.build()
        except Exception as exc:  # noqa: BLE001 - surface on the waiter
            promoted = self._release(sub, completed=False)
            self._finish(sub, error=f"build failed: {exc!r}")
            self._launch_promoted(promoted)
            return
        sub.taskpool = tp
        self.fairness.bind_pool(tp.taskpool_id, sub.tenant)
        tp._complete_cbs.append(lambda _tp: self._pool_done(sub))
        tp._abort_cbs.append(lambda _tp: self._pool_aborted(sub))
        try:
            self.ctx.add_taskpool(tp)
        except Exception as exc:  # noqa: BLE001
            self.fairness.release_pool(tp.taskpool_id)
            promoted = self._release(sub, completed=False)
            self._finish(sub, error=f"enqueue failed: {exc!r}")
            self._launch_promoted(promoted)
            return
        if getattr(tp, "_alive", False):
            # DTD pools hold a keep-alive runtime action for
            # post-enqueue inserts that normally only tp.wait() drops; a
            # served submission is sealed at build time (every insert
            # already happened inside build), so drop it here —
            # termination is then detected without any caller blocking
            # in tp.wait()
            tp._alive = False
            tp.tdm.taskpool_addto_runtime_actions(-1)
        # a persistent context parks its workers between waves; re-arm
        # them for the new pool (no-op while a wave is already running)
        self.ctx.start()

    def _pool_done(self, sub: Submission) -> None:
        """Completion hook — fires on a worker thread inside taskpool
        termination; charge fairness, release admission, drain queue."""
        self._settle(sub, error=None)

    def _pool_aborted(self, sub: Submission) -> None:
        """Abort hook (``Taskpool.abort``, the ft/ eviction path): the
        pool will never terminate, but its admission charges must not
        outlive it — release capacity, unbind fairness, and fail the
        submission so local and remote waiters unblock instead of
        riding their timeout."""
        self._settle(sub, error="taskpool aborted (rank eviction)")

    def _settle(self, sub: Submission, error: Optional[str]) -> None:
        lat_us = (time.monotonic_ns() - sub.t_submit_ns) / 1e3
        sub.lat_us = lat_us
        tp = sub.taskpool
        if tp is not None:
            self.fairness.release_pool(tp.taskpool_id)
        # aborted pools still charge virtual runtime: an always-failing
        # tenant must not accrue an unbounded deficit boost over
        # healthy ones
        self.fairness.note_done(sub.tenant, sub.ntasks)
        if error is None:
            live = getattr(self.ctx.obs, "live", None)
            if live is not None:
                live.note_tenant_latency(sub.tenant, lat_us)
        promoted = self._release(sub, completed=error is None)
        self._finish(sub, error)
        self._launch_promoted(promoted)

    def _finish(self, sub: Submission, error: Optional[str]) -> None:
        sub.error = error
        with self._lock:
            waiters = list(sub.waiters)
            sub.waiters.clear()
        sub.done.set()
        for src, req in waiters:
            self._reply(src, req, ok=error is None,
                        ticket=sub.ticket, lat_us=sub.lat_us,
                        **({"error": error} if error else {}))

    # ------------------------------------------------------------------ #
    # introspection                                                      #
    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"tenants": {}}
            for name, t in self._tenants.items():
                lat = list(t.lat_us)
                out["tenants"][name] = {
                    "weight": t.weight,
                    "inflight_pools": t.inflight_pools,
                    "inflight_tasks": t.inflight_tasks,
                    "queued": len(t.queued),
                    "used_bytes": t.used_bytes_locked(),
                    "quota_bytes": t.quota_bytes,
                    "pools_done": t.pools_done,
                    "p50_lat_us": round(_pct(lat, 0.50), 1) if lat else 0.0,
                    "p99_lat_us": round(_pct(lat, 0.99), 1) if lat else 0.0,
                    "boost": self.fairness.boost_of_tenant(name),
                }
        return out

    # ------------------------------------------------------------------ #
    # remote endpoint (TAG_SERVE over the AM layer)                      #
    # ------------------------------------------------------------------ #
    def attach_engine(self, ce) -> None:
        """Serve remote clients: install the ``TAG_SERVE`` handler on
        ``ce``.  Over TCP the peer must have negotiated the HELLO
        ``"sv"`` capability (``ce.serve_to``) for its submissions to be
        honored."""
        from ..comm.engine import TAG_SERVE
        self._ce = ce
        fl = getattr(ce, "_flow", None)
        if fl is not None:
            fl.tenants = self.fairness._pools
        ce.tag_register(TAG_SERVE, self._on_request)

    def _reply(self, src: int, req: int, ok: bool, **kw) -> None:
        ce = self._ce
        if ce is None or src == self.ctx.rank:
            return
        from ..comm import wire
        from ..comm.engine import TAG_SERVE_REPLY
        try:
            ce.send_am(src, TAG_SERVE_REPLY, wire.serve_reply(req, ok, **kw))
        except Exception as exc:  # noqa: BLE001 - a dead client is not fatal
            plog.warning("serve: reply to rank %d failed: %r", src, exc)

    def _on_request(self, src: int, payload: Any) -> None:
        from ..comm import wire
        try:
            msg = wire.parse_serve(payload)
        except ValueError as exc:
            plog.warning("serve: bad request from rank %d: %r", src, exc)
            return
        if not self._ce.serve_to(src):
            # a peer that never negotiated "sv" gets a versioned error,
            # not silence — it can only hit this via a buggy client
            self._reply(src, msg["req"], ok=False,
                        error="peer did not negotiate the sv capability")
            return
        req = msg["req"]
        op = msg.get("op")
        try:
            if op == "open":
                t = self.open_tenant(
                    msg["tenant"], weight=msg.get("weight"),
                    quota_bytes=msg.get("quota_bytes"),
                    max_pools=msg.get("max_pools", 0),
                    max_tasks=msg.get("max_tasks", 0))
                self._reply(src, req, ok=True, tenant=t.name,
                            weight=t.weight, quota_bytes=t.quota_bytes)
            elif op == "submit":
                sub = self.submit(msg["tenant"], msg["build"],
                                  nbytes=msg.get("nbytes", 0),
                                  ntasks=msg.get("ntasks", 1),
                                  name=msg.get("name"))
                self._reply(src, req, ok=True, ticket=sub.ticket,
                            queued=sub.taskpool is None
                            and not sub.done.is_set())
            elif op == "wait":
                ticket = msg["ticket"]
                with self._lock:
                    sub = self._subs.get(ticket)
                    defer = sub is not None and not sub.done.is_set()
                    if defer:
                        sub.waiters.append((src, req))
                if sub is None:
                    self._reply(src, req, ok=False,
                                error=f"unknown ticket {ticket}")
                elif not defer:
                    self._reply(src, req, ok=sub.error is None,
                                ticket=ticket, lat_us=sub.lat_us,
                                **({"error": sub.error}
                                   if sub.error else {}))
            elif op == "stats":
                self._reply(src, req, ok=True, stats=self.stats())
            else:
                self._reply(src, req, ok=False, error=f"unknown op {op!r}")
        except AdmissionError as exc:
            self._reply(src, req, ok=False, error=str(exc), rejected=True)
        except Exception as exc:  # noqa: BLE001 - handler must not kill comm
            plog.warning("serve: op %r from rank %d failed: %r",
                         op, src, exc)
            self._reply(src, req, ok=False, error=repr(exc))

    # ------------------------------------------------------------------ #
    # shutdown                                                           #
    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Detach from the context: unhook fairness/flow/gauges.  Does
        not wait for in-flight pools (use Submission.wait / ctx.wait)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            tenants = list(self._tenants.values())
            self._tenants.clear()
            self._nq = 0
        for mp in self._hooked_mempools:
            if getattr(mp, "on_free", None) == self.kick:
                mp.on_free = None
        self._hooked_mempools = []
        for t in tenants:
            self.fairness.forget(t.name)
            for gname, fn in t._gauges:
                self.ctx.sde.unregister(gname, fn)
            for sub in t.queued:
                self._finish(sub, error="server closed")
            t.queued.clear()
        self.ctx.sde.unregister(SERVE_TENANTS)
        self.ctx.serve_fairness = None
        ce = getattr(self.ctx.comm, "ce", self.ctx.comm) \
            if self.ctx.comm is not None else None
        fl = getattr(ce, "_flow", None)
        if fl is not None and fl.tenants is self.fairness._pools:
            fl.tenants = None

    def __enter__(self) -> "SessionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (mirrors obs/live.py's helper; duplicated
    so serve/ has no import-time dependency on the live monitor)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(q * len(s) + 0.5)) - 1))
    return float(s[k])
