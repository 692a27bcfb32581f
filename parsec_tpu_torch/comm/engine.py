"""Comm engine (CE) abstraction: transport-neutral messaging.

Reference behavior: ``parsec_comm_engine_t`` — tagged active messages
(callback per tag), ``mem_register/unregister``, one-sided put/get with
local+remote completion callbacks, pack/unpack, sync, capabilities
(ref: parsec/parsec_comm_engine.h:139-166). The only in-tree transport is
funnelled MPI emulating one-sided ops over two-sided sends
(parsec/parsec_mpi_funnelled.c).

Here the CE is the control plane and the host-memory data plane.
Transports: LocalFabric (in-process ranks, the test fabric standing in
for oversubscribed mpiexec, SURVEY.md §4) and TCPCommEngine (rank
processes over sockets).  Device-resident tiles may ride a separate
device data plane (comm/xfer.py).  The fault-tolerance hooks (ft/:
heartbeat probes, the injected-kill silence, the chaos verdict on every
outbound frame, elastic membership frames) and the telemetry seams
(obs/: the ``_obs`` span sink, the ``_flow`` trace-context allocator)
live here, uniform across transports.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class FlowIds:
    """Per-rank allocator of wire trace contexts: a context is the
    compact ``(origin_rank, span_id)`` pair stamped on data-plane
    messages under the ``obs_flow`` knob, shared by the sender's and the
    receiver's flow events so the fleet merge can stitch the edge.
    Installed as ``ce._flow`` by the obs wiring — None keeps every send
    on the one-attribute-check fast path.

    ``live`` (obs_live) widens the stamped context to ``(origin, span,
    pool_tp_id, t_send_ns)`` — the taskpool wire id for per-pool
    attribution and the sender's monotonic send instant for live
    flow-lag — but ONLY toward peers whose ``live_to`` capability
    negotiated it, so a plain obs_flow receiver keeps seeing the 2-tuple
    its ``origin, span = ctx`` unpacking expects.

    ``tenants`` (serve/) widens the live context once more to
    ``(origin, span, pool, t_send_ns, tenant)``: a SessionServer
    installs its taskpool-id -> tenant-name mapping here so data-plane
    traffic of a served pool carries the tenant that submitted it — but
    ONLY toward peers whose ``serve_to`` capability negotiated it, so a
    live-only receiver keeps the 4-tuple it expects.  None (no server)
    keeps the live behavior byte-identical."""

    __slots__ = ("rank", "_next", "_lock", "live", "tenants")

    def __init__(self, rank: int) -> None:
        self.rank = rank
        self._next = 0
        self._lock = threading.Lock()
        self.live = False
        self.tenants: Optional[Dict[Any, str]] = None

    def next_ctx(self) -> Tuple[int, int]:
        with self._lock:
            self._next += 1
            return (self.rank, self._next)


#: data-plane tags that carry a wire trace context when flow tracing is
#: negotiated: activations, GET request/reply, one-sided puts, DTD tile
#: traffic, and memory writebacks — every payload is a dict, so the
#: context rides a ``"_tr"`` key inside the pickled body (chunked
#: transfers inherit it for free).  Control traffic (termdet, barrier,
#: heartbeat) is never stamped.
_FLOW_TAGS = frozenset((1, 2, 3, 4, 6, 7))  # values asserted below


class RankFailedError(RuntimeError):
    """A peer rank failed mid-run (crash, kill, or a torn connection).

    Failure *detection* is the explicit extension beyond the reference
    (SURVEY.md §5.3: PaRSEC has none — a dead MPI rank hangs the job):
    the TCP transport reports a torn connection while the engine is live
    (comm/tcp.py), and the dead rank aborts this rank's DAG instead of
    hanging in termdet forever."""

    def __init__(self, rank: int, reason: str = "connection lost") -> None:
        super().__init__(f"rank {rank} failed: {reason}")
        self.rank = rank


class MemHandle:
    """Registered memory region handle (ref: parsec_ce_mem_reg_handle_t —
    wraps {ptr, count, datatype}); here it wraps a host array + metadata.

    ``quantize_ok`` is the registrant's per-flow eligibility mark for
    the lossy quantized wire codecs: True only for tile payloads; the
    GET reply propagates it so the transport may quantize the bulk
    buffer toward peers that negotiated a codec."""

    _iter = 0
    _lock = threading.Lock()

    def __init__(self, array: Any, meta: Any = None,
                 quantize_ok: bool = False) -> None:
        with MemHandle._lock:
            MemHandle._iter += 1
            self.handle_id = MemHandle._iter
        self.array = array
        self.meta = meta
        self.quantize_ok = bool(quantize_ok)


class CommEngine:
    """Transport interface (ref: parsec_comm_engine_t function table)."""

    #: May the heartbeat detector evict a peer that was PROBED but never
    #: answered? Only sound when a successful probe implies the peer was
    #: verifiably alive and able to reply at probe time — true for TCP
    #: (``hb_ok`` means its receiver thread processed our HELLO and
    #: answers pings without any progress pumping), FALSE for the
    #: in-process fabrics (a probe merely lands in an inbox; the peer
    #: may be healthy but still initializing, not yet pumping progress —
    #: evicting it would be a false positive).
    ft_probe_baseline = False

    def __init__(self, rank: int, nb_ranks: int) -> None:
        self.rank = rank
        self.nb_ranks = nb_ranks
        self._tag_cbs: Dict[int, Callable] = {}
        self._mem: Dict[int, MemHandle] = {}
        self.on_get_served: Optional[Callable[[int], None]] = None
        # transports invoke this when a message lands in the inbox so a
        # parked worker wakes instead of finishing its backoff sleep
        self.on_arrival: Optional[Callable[[], None]] = None
        # late-bound tags: a message can land before its handler exists
        # (MPI's posted-recv semantics give this for free); such
        # messages wait here and replay at registration
        self._deferred: List[Tuple[int, int, Any]] = []
        self._deferred_lock = threading.Lock()
        self._deferred_warned: set = set()
        # uniform failure surface across transports
        self.dead_peers: set = set()
        #: called (peer, reason) when a peer is declared failed;
        #: RemoteDepEngine.attach points this at the context's abort path
        self.on_peer_failure: Optional[Callable[[int, str], None]] = None
        #: the attached DeviceDataPlane, or None (host staging)
        self.device_plane: Optional[Any] = None
        # telemetry sink (obs.spans.CommObs) — None keeps every
        # instrumented site on the one-attribute-check fast path
        # (the PINS ``_active == 0`` pattern)
        self._obs: Optional[Any] = None
        # cross-rank flow tracing: a FlowIds allocator when the
        # ``obs_flow`` knob is on AND telemetry is wired — the same
        # None-is-off pattern as ``_obs``
        self._flow: Optional[FlowIds] = None
        # -- fault tolerance (ft/) -------------------------------------
        #: HeartbeatDetector when one is installed (ft/detector.py)
        self.ft_detector: Optional[Any] = None
        #: ElasticCoordinator when one is attached (ft/elastic.py);
        #: TAG_ELASTIC traffic arriving before the attach is buffered
        #: (a joiner may announce while the incumbents are mid-stage)
        self.ft_elastic: Optional[Any] = None
        self._elastic_buf: List[Tuple[int, Any]] = []
        #: elastic-recovery counters (ft/elastic.py + ft/restart.py);
        #: polled by obs.register_engine_gauges as the FT::ELASTIC_* /
        #: FT::RESHARD_* gauges — plain dict, nothing on any hot path
        self.elastic_stats: Dict[str, int] = {
            "elastic_resizes": 0, "reshard_bytes": 0, "reshard_us": 0,
            "elastic_joins": 0, "reshard_load_us": 0}
        #: device-plane / planned-redistribution counters (comm/xfer.py,
        #: xfer/plan.py); polled as the COMM::DPLANE_* and
        #: COMM::REDIST_ROUNDS gauges ("two_level_reduces" stays 0: the
        #: wave's collective lane is not carried yet)
        self.dplane_stats: Dict[str, int] = {
            "dplane_bytes": 0, "dplane_xfers": 0, "redist_rounds": 0,
            "two_level_reduces": 0}
        #: injected-kill flag: the engine has gone dark (drops all
        #: traffic, answers no heartbeats) — simulates a crashed process
        self._ft_silenced = False
        #: deterministic fault injector (ft/inject.py), or None (the
        #: default: one never-taken branch on the send path)
        self._ft: Optional[Any] = None
        from ..utils.params import params
        spec = params.get("ft_inject")
        if spec:
            from ..ft.inject import FaultInjector
            self._ft = FaultInjector.from_spec(spec, rank=rank)
        # every engine answers heartbeat pings from its progress loop,
        # detector installed or not — liveness proof must not depend on
        # the *local* configuration
        self.tag_register(TAG_HEARTBEAT, self._on_heartbeat)
        # elastic membership traffic (ft/elastic.py) is likewise always
        # receivable: a coordinator may attach later and drain the buffer
        self.tag_register(TAG_ELASTIC, self._on_elastic)

    def _notify_arrival(self) -> None:
        cb = self.on_arrival
        if cb is not None:
            cb()

    MAX_DEFERRED = 4096

    # -- active messages ----------------------------------------------------
    def tag_register(self, tag: int, cb: Callable[[int, Any], None]) -> None:
        """cb(src_rank, payload) runs during progress() on the receiver."""
        # handler install and deferred drain are one atomic step against
        # deliver_message's check-then-defer: without the shared lock a
        # message checked before the install but deferred after the
        # drain would strand forever
        with self._deferred_lock:
            self._tag_cbs[tag] = cb
            pending = [m for m in self._deferred if m[1] == tag]
            if pending:
                self._deferred = [m for m in self._deferred if m[1] != tag]
        for src, _tag, payload in pending:
            cb(src, payload)

    def deliver_message(self, src: int, tag: int, payload: Any) -> bool:
        """Route one drained message to its handler, or hold it if the
        tag is not bound yet (replayed by tag_register — MPI's
        posted-recv semantics). Returns True when handled now.

        A tag that never gets a handler is a bug: warn once, and fail
        loudly if the hold queue grows past MAX_DEFERRED instead of
        leaking quietly."""
        obs = self._obs
        if obs is not None:
            # counted at ARRIVAL (deferred or not) so sent/received
            # totals balance across ranks
            obs.am_arrived(src, tag, payload)
            if tag in _FLOW_TAGS and isinstance(payload, dict):
                # the sender's wire trace context: record the receive
                # half of the flow edge at arrival — exactly once per
                # message even when the tag defers, so every ``ph:"s"``
                # has its ``ph:"f"``.  Only data-plane tags: a USER
                # payload's "_tr" key is the application's business
                ctx = payload.get("_tr")
                if ctx is not None:
                    obs.flow_recv(src, tag, ctx)
        with self._deferred_lock:
            cb = self._tag_cbs.get(tag)
            if cb is None:
                if len(self._deferred) >= self.MAX_DEFERRED:
                    raise RuntimeError(
                        f"rank {self.rank}: {len(self._deferred)} messages "
                        f"deferred for unregistered tags (first tags: "
                        f"{sorted({m[1] for m in self._deferred[:50]})}) — "
                        f"a handler was never registered")
                self._deferred.append((src, tag, payload))
        if cb is None:
            if tag not in self._deferred_warned:
                self._deferred_warned.add(tag)
                from ..utils import logging as plog
                plog.debug.verbose(
                    1, "rank %d: deferring message(s) for unregistered "
                    "tag %d", self.rank, tag)
            return False
        if obs is not None:
            t0 = time.monotonic_ns()
            cb(src, payload)
            obs.delivered(src, self.rank, tag, t0)
            return True
        cb(src, payload)
        return True

    def tag_unregister(self, tag: int) -> None:
        self._tag_cbs.pop(tag, None)

    def tag_registered(self, tag: int) -> bool:
        """True if ``tag`` already has a handler installed — consumers
        that must own a tag exclusively (ServeClient on
        TAG_SERVE_REPLY) check before registering, since
        ``tag_register`` silently replaces."""
        with self._deferred_lock:
            return tag in self._tag_cbs

    def send_am(self, dst: int, tag: int, payload: Any) -> None:
        raise NotImplementedError

    # -- cross-rank flow tracing --------------------------------------------
    def flow_to(self, dst: int) -> bool:
        """May a wire trace context travel toward ``dst``?  In-process
        fabrics share this build (always True); the TCP engine gates on
        the peer's HELLO ``"tr"`` capability, so a mixed peer's wire
        bytes stay exactly what a knob-unset build would send."""
        return True

    def live_to(self, dst: int) -> bool:
        """May the EXTENDED obs_live context (pool id + send instant)
        travel toward ``dst``?  In-process fabrics: yes; the TCP engine
        gates on the peer's HELLO ``"lv"`` capability so an
        obs_flow-only receiver never sees a 4-tuple."""
        return True

    def serve_to(self, dst: int) -> bool:
        """May the serve-extended context (tenant name) and serve
        control AMs travel toward ``dst``?  In-process fabrics: yes; the
        TCP engine gates on the peer's HELLO ``"sv"`` capability so a
        live-only receiver never sees a 5-tuple."""
        return True

    def _flow_stamp(self, dst: int, tag: int,
                    payload: Any) -> Tuple[Any, Optional[Tuple[int, ...]]]:
        """Stamp one outbound data-plane message with a fresh trace
        context: returns ``(payload', ctx)`` where ``payload'`` is a
        SHALLOW copy carrying ``"_tr": (origin_rank, span_id)`` — the
        caller's dict is never mutated (one activation dict fans out to
        several bcast children; each hop is its own flow edge).  ctx is
        None for self-sends, control tags, non-dict payloads, and peers
        the capability negotiation excluded — and on THAT path any
        inbound ``"_tr"`` a re-forwarded message still carries is
        STRIPPED (again on a copy): a bcast hop re-sends the received
        dict, and the upstream context must neither leak to a peer
        whose wire bytes must stay knob-unset-identical nor fake a
        second receive half of the upstream edge."""
        if tag not in _FLOW_TAGS or not isinstance(payload, dict):
            # control/user tags pass through UNTOUCHED — an application
            # payload's "_tr" key is never ours to strip
            return payload, None
        fl = self._flow
        if fl is None or dst == self.rank or not self.flow_to(dst):
            if "_tr" in payload:
                payload = dict(payload)
                del payload["_tr"]
            return payload, None
        ctx = fl.next_ctx()
        if fl.live and self.live_to(dst):
            # obs_live extension: taskpool wire id (per-pool
            # attribution — the data-plane dicts already carry "tp_id";
            # GET traffic does not, and attributes to None) and the
            # sender's monotonic send instant (flow lag)
            ctx = (ctx[0], ctx[1], payload.get("tp_id"),
                   time.monotonic_ns())
            tn = fl.tenants
            if tn and self.serve_to(dst):
                # serve extension: the tenant that submitted the pool
                # this message belongs to — None for pools the server
                # does not own (and for pool-less GET traffic), so
                # foreign workloads stay unattributed, not mislabeled
                ctx = ctx + (tn.get(ctx[2]),)
        payload = dict(payload)
        payload["_tr"] = ctx
        return payload, ctx

    def dplane_to(self, dst: int) -> bool:
        """May bulk planner payloads toward ``dst`` ride the device plane
        (xfer/plan.py)?  Only when a plane is attached here and the
        peer's plane address arrived (``DeviceDataPlane.exchange``): the
        plane's address exchange checks both ends run the same backend,
        which is this package's negotiation (its TCP HELLO carries no
        ``"dp"`` capability).  Otherwise the payload stays on the
        session wire."""
        plane = self.device_plane
        return plane is not None and dst in plane.addresses

    # -- failures -----------------------------------------------------------
    def mesh_local_with(self, peer: int) -> bool:
        """True when ``peer`` shares this process, so a device-tensor
        payload can travel device to device instead of serialize ->
        wire -> deserialize (the mesh-local path of remote_dep).
        Cross-process transports stay False; in-process fabrics
        override."""
        return False

    def report_peer_failure(self, peer: int, reason: str) -> None:
        """Uniform failure funnel: mark ``peer`` dead and notify the
        runtime. Idempotent."""
        if peer in self.dead_peers or self.peer_finished(peer):
            return
        self.dead_peers.add(peer)
        from ..utils import logging as plog
        plog.warning("rank %d: peer %d presumed FAILED (%s)",
                     self.rank, peer, reason)
        cb = self.on_peer_failure
        if cb is not None:
            cb(peer, reason)
        # a membership change invalidates any in-flight resize
        # agreement: wake the elastic coordinator so it re-proposes
        # from the reduced survivor set instead of waiting out its tick
        co = self.ft_elastic
        if co is not None:
            co.membership_changed()

    def peer_finished(self, peer: int) -> bool:
        """True when ``peer`` shut down CLEANLY (it finished its work
        and fini'd) — such a peer stops heartbeating but must never be
        declared failed. Transports that can observe orderly shutdown
        override this."""
        return False

    def peer_suspect(self, peer: int) -> bool:
        """True while ``peer``'s link is torn but a reliable session is
        still reconnecting inside its budget (comm/tcp.py) — a
        TRANSIENT fault, not a death. Consumers park instead of
        escalating: the heartbeat detector defers its verdict (probes
        cannot cross a torn link, so the silence proves nothing).
        Transports without sessions never suspect."""
        return False

    # -- fault tolerance (ft/) ----------------------------------------------
    def ft_link_fault(self, peer: int) -> None:
        """Chaos hook (ft/inject.py ``flap:``/``disconnect:``): tear
        this rank's link(s) toward ``peer`` without killing anything.
        Only socket transports have a link to tear; the in-process
        fabric ignores it."""

    def ft_silence(self) -> None:
        """Injected kill (ft/inject.py): the engine goes dark — drops
        all inbound and outbound traffic and answers no heartbeats,
        simulating a crashed process whose sockets may still be open
        (so only PROACTIVE detection can find it)."""
        self._ft_silenced = True

    def ft_outbound(self, dst: int, tag: int) -> int:
        """Chaos consult for one outbound frame: how many copies to
        deliver — 0 (engine silenced, or injected drop), 1 (normal),
        or 2 (injected duplicate). Injected delays sleep inside
        ``on_send``; an injected failsend raises from here. The ONE
        copy of the verdict semantics every transport's
        ``_transport_post`` applies."""
        if self._ft_silenced:
            return 0
        ft = self._ft
        if ft is None or dst == self.rank:
            return 1
        verdict = ft.on_send(dst, tag)
        if verdict == "drop":
            return 0
        if verdict == "flap":
            # the injector marked the link down: hard-close the
            # socket(s) FIRST, so this frame is accepted-but-unsent —
            # under a session it parks and replays, without one the
            # loss is loud (lost_sends), exactly like a real link fault
            self.ft_link_fault(dst)
            return 1
        return 2 if verdict == "dup" else 1

    def ft_ping(self, peer: int, seq: int, t_ns: int) -> bool:
        """Send one heartbeat probe toward ``peer``; True when a probe
        actually left. The base path rides a TAG_HEARTBEAT active
        message (the in-process fabric); the TCP engine overrides with
        a wire-level K_PING frame answered by the peer's receiver
        thread, so TCP liveness is independent of the progress
        cadence."""
        if self._ft_silenced or peer in self.dead_peers \
                or self.peer_finished(peer):
            return False
        try:
            self.send_am(peer, TAG_HEARTBEAT,
                         {"op": "ping", "seq": seq, "t": t_ns})
        except Exception:  # noqa: BLE001 - a probe must never propagate
            return False
        return True

    MAX_ELASTIC_BUF = 256

    def ft_elastic_send(self, peer: int, payload: Any) -> bool:
        """Send one elastic membership frame toward ``peer``; True when
        it actually left. Gated like ``ft_ping``: the base path rides a
        TAG_ELASTIC active message (the in-process fabric introspects
        the peer's handler); the TCP engine overrides with a wire-level
        K_ELASTIC frame delivered by the peer's receiver thread, gated
        on the HELLO ``el`` capability — a peer without it is never
        part of a resize agreement."""
        if self._ft_silenced or peer in self.dead_peers \
                or self.peer_finished(peer):
            return False
        try:
            self.send_am(peer, TAG_ELASTIC, dict(payload))
        except Exception:  # noqa: BLE001 - a proposal must never propagate
            return False
        return True

    def _on_elastic(self, src: int, payload: Any) -> None:
        """TAG_ELASTIC / K_ELASTIC arrival (progress drain or, on TCP,
        the receiver thread): hand to the attached coordinator, or
        buffer until one attaches (ElasticCoordinator.__init__ drains
        under the same lock, so no message can slip between the
        attach-check and the buffer append)."""
        if self._ft_silenced:
            return
        with self._deferred_lock:
            co = self.ft_elastic
            if co is None:
                if len(self._elastic_buf) < self.MAX_ELASTIC_BUF:
                    self._elastic_buf.append((src, payload))
                return
        co.deliver(src, payload)

    def _on_heartbeat(self, src: int, payload: Any) -> None:
        if self._ft_silenced:
            return
        op = payload.get("op")
        if op == "ping":
            # any heartbeat traffic FROM the peer proves it speaks the
            # protocol and is alive right now
            det = self.ft_detector
            if det is not None:
                det.note_alive(src)
            try:
                self.send_am(src, TAG_HEARTBEAT,
                             {"op": "pong", "seq": payload["seq"],
                              "t": payload["t"]})
            except Exception:  # noqa: BLE001 - peer died racing the reply
                pass
        elif op == "pong":
            det = self.ft_detector
            if det is not None:
                det.note_alive(
                    src, rtt=(time.monotonic_ns() - payload["t"]) / 1e9)

    # -- registered memory + one-sided emulation ----------------------------
    def mem_register(self, array: Any, meta: Any = None,
                     quantize_ok: bool = False) -> MemHandle:
        h = MemHandle(array, meta, quantize_ok=quantize_ok)
        self._mem[h.handle_id] = h
        return h

    def mem_unregister(self, handle: MemHandle) -> None:
        self._mem.pop(handle.handle_id, None)

    def get(self, src_rank: int, remote_handle_id: int,
            on_complete: Callable[[Any], None]) -> None:
        """One-sided get: fetch the remote registered region
        (emulated with a GET-request AM + data reply, like the funnelled
        MPI engine, parsec_mpi_funnelled.c:245-365).

        Aggregation contract: gets issued from message handlers during
        one progress() drain MAY be batched per peer into a single
        request/reply frame — on_complete still fires once per get,
        but callers must not assume one wire message per call."""
        raise NotImplementedError

    def put(self, dst_rank: int, remote_handle_id: int, array: Any,
            on_complete: Optional[Callable] = None) -> None:
        raise NotImplementedError

    # -- progress -----------------------------------------------------------
    def progress(self) -> int:
        """Drain incoming messages; returns #messages handled."""
        raise NotImplementedError

    def sync(self) -> None:
        """Barrier across ranks."""
        raise NotImplementedError

    def fini(self) -> None:
        pass


# wire tags (ref: parsec/remote_dep.h:41-48); the JAX package's numbering
TAG_ACTIVATE = 1
TAG_GET_REQ = 2
TAG_GET_DATA = 3
TAG_PUT_DATA = 4
TAG_TERMDET = 5
TAG_DTD_DATA = 6
TAG_MEM_PUT = 7
TAG_HEARTBEAT = 8   # liveness probes (tcp rides wire-level K_PING frames)
TAG_ELASTIC = 9     # elastic membership (grid resize / join; K_ELASTIC)
TAG_SERVE = 10      # serve/ session control: open/submit/wait requests
TAG_SERVE_REPLY = 11  # serve/ replies (admission verdicts, completions)
TAG_USER_BASE = 16

# the flow-traced data-plane tag set is spelled with literals above
# (the tags are defined after the class body); keep the two in sync
assert _FLOW_TAGS == {TAG_ACTIVATE, TAG_GET_REQ, TAG_GET_DATA,
                      TAG_PUT_DATA, TAG_DTD_DATA, TAG_MEM_PUT}
