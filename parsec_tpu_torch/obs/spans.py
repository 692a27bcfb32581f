"""Span-tracing hooks for the comm engine and device layer.

The scheduler hot path already has PINS sites; the comm engine and
devices had none. ``CommObs`` / ``DeviceObs`` are the per-rank hook
objects those layers call through a single attribute check
(``self._obs is not None`` — the PINS ``_active == 0`` pattern), so
uninstrumented runs pay one attribute load per site and nothing else.

Spans land in the rank's ``profiling.trace.Profile`` on dedicated
streams (``comm``, ``dev:<name>``) so Perfetto shows communication and
transfers as their own rows next to the worker exec rows; byte counters
land in the context's SDE registry under ``PARSEC::COMM::*`` /
``PARSEC::DEVICE::*``; transfer latencies feed the metrics histogram.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import COMM_XFER_SECONDS, MetricsRegistry

__all__ = ["CommObs", "DeviceObs", "OverlapTracker",
           "register_device_gauges",
           "COMM_BYTES_SENT", "COMM_BYTES_RECEIVED",
           "COMM_MSGS_SENT", "COMM_MSGS_RECEIVED",
           "COMM_ACTIVE_TRANSFERS", "COMM_PENDING_MESSAGES",
           "COMM_COALESCED", "COMM_CHUNKS_INFLIGHT",
           "COMM_COMPRESS_RATIO", "COMM_LINK_BW_PREFIX",
           "COMM_RECONNECTS", "COMM_REPLAYED_FRAMES",
           "COMM_DUP_DROPPED", "COMM_SUSPECT_MS",
           "FT_PEER_ALIVE", "FT_HB_RTT_PREFIX",
           "OBS_OVERLAP_FRACTION", "OBS_EXPOSED_COMM_US",
           "OBS_FLOW_SENT", "OBS_FLOW_RECV", "OBS_CLOCK_OFFSET_PREFIX",
           "OBS_HEALTH_STATUS", "OBS_HEALTH_WINDOWS",
           "OBS_HEALTH_FIRINGS", "OBS_HEALTH_STRAGGLER",
           "OBS_HEALTH_DEGRADED", "OBS_HEALTH_STUCK",
           "OBS_HEALTH_WORST_LINK_US",
           "TUNE_DECISIONS", "TUNE_REVERTS",
           "TUNE_ACTIVE_CODEC_PREFIX", "TUNE_OBJECTIVE_US",
           "SERVE_TENANTS", "SERVE_ADMITTED", "SERVE_REJECTED",
           "SERVE_QUEUED", "SERVE_INFLIGHT_PREFIX",
           "SERVE_QUOTA_BYTES_PREFIX", "SERVE_P99_LATENCY_PREFIX",
           "XSTAGE_COMPILES", "XSTAGE_TASKS",
           "XSTAGE_COLLECTIVE_BYTES", "XSTAGE_FALLBACKS",
           "flow_event_id", "inbound_flow_ctx", "set_inbound_flow_ctx",
           "payload_nbytes"]

COMM_BYTES_SENT = "PARSEC::COMM::BYTES_SENT"
COMM_BYTES_RECEIVED = "PARSEC::COMM::BYTES_RECEIVED"
COMM_MSGS_SENT = "PARSEC::COMM::MSGS_SENT"
COMM_MSGS_RECEIVED = "PARSEC::COMM::MSGS_RECEIVED"
COMM_ACTIVE_TRANSFERS = "PARSEC::COMM::ACTIVE_TRANSFERS"
COMM_PENDING_MESSAGES = "PARSEC::COMM::PENDING_MESSAGES"
# wire fast-path telemetry (TCP transport): messages that rode a
# multi-message coalesced frame, chunked-transfer segments in flight,
# cumulative compressed/raw byte ratio, and per-peer send-bandwidth
# EWMA gauges (PARSEC::COMM::LINK_BW::R<peer>, MB/s)
COMM_COALESCED = "PARSEC::COMM::COALESCED"
COMM_CHUNKS_INFLIGHT = "PARSEC::COMM::CHUNKS_INFLIGHT"
COMM_COMPRESS_RATIO = "PARSEC::COMM::COMPRESS_RATIO"
COMM_LINK_BW_PREFIX = "PARSEC::COMM::LINK_BW"
# reliable-session telemetry (comm/tcp.py): completed link
# reconnects, frames replayed from the window after a resume,
# duplicate frames the receiver dropped by seq, and cumulative
# milliseconds peers spent in SUSPECT (live episode included)
COMM_RECONNECTS = "PARSEC::COMM::RECONNECTS"
COMM_REPLAYED_FRAMES = "PARSEC::COMM::REPLAYED_FRAMES"
COMM_DUP_DROPPED = "PARSEC::COMM::DUP_DROPPED"
COMM_SUSPECT_MS = "PARSEC::COMM::SUSPECT_MS"
# device-plane / planned-redistribution telemetry (xfer/):
# bulk bytes and pull count that left the session wire for the device
# plane, alltoall rounds the redistribution planner executed, and
# two-level hierarchical reductions the wave collective lane issued —
# engine-owned counters (ce.dplane_stats), polled like elastic_stats
COMM_DPLANE_BYTES = "PARSEC::COMM::DPLANE_BYTES"
COMM_DPLANE_XFERS = "PARSEC::COMM::DPLANE_XFERS"
COMM_REDIST_ROUNDS = "PARSEC::COMM::REDIST_ROUNDS"
COMM_TWO_LEVEL_REDUCES = "PARSEC::COMM::TWO_LEVEL_REDUCES"
# fault-tolerance telemetry (ft/detector.py): peers currently confirmed
# alive, and the per-peer heartbeat round-trip EWMA in milliseconds
# (PARSEC::FT::HB_RTT::R<peer>, 0 until measured)
FT_PEER_ALIVE = "PARSEC::FT::PEER_ALIVE"
FT_HB_RTT_PREFIX = "PARSEC::FT::HB_RTT"
# elastic recovery telemetry (ft/elastic.py): completed grid resizes
# (shrink + grow) on this rank, joiners folded in, and the cross-grid
# reshard volume/wall landed here — engine-owned counters
# (ce.elastic_stats), polled like every other engine gauge
FT_ELASTIC_RESIZES = "PARSEC::FT::ELASTIC_RESIZES"
FT_ELASTIC_JOINS = "PARSEC::FT::ELASTIC_JOINS"
FT_RESHARD_BYTES = "PARSEC::FT::RESHARD_BYTES"
FT_RESHARD_US = "PARSEC::FT::RESHARD_US"
# LIVE T3-style overlap telemetry: the fraction of this
# rank's communication time (comm spans + host<->device transfers)
# hidden under task execution, and the exposed remainder in us — the
# same metric obs/critpath.py computes offline, maintained online by
# OverlapTracker so perf gates can assert it DURING a run.  1.0 for a
# zero-comm rank (nothing to hide = nothing exposed).
OBS_OVERLAP_FRACTION = "PARSEC::OBS::OVERLAP_FRACTION"
OBS_EXPOSED_COMM_US = "PARSEC::OBS::EXPOSED_COMM_US"
# cross-rank flow tracing: wire trace contexts stamped on
# data-plane messages under the ``obs_flow`` knob — FLOW_SENT counts
# the sender halves ("s" flow events), FLOW_RECV the receiver halves
# ("f"); and the NTP-style per-peer clock-offset estimate in µs
# (PARSEC::OBS::CLOCK_OFFSET_US::R<peer>, peer_clock - my_clock, 0
# until measured; identically 0 on same-clock in-process fabrics)
OBS_FLOW_SENT = "PARSEC::OBS::FLOW_SENT"
OBS_FLOW_RECV = "PARSEC::OBS::FLOW_RECV"
OBS_CLOCK_OFFSET_PREFIX = "PARSEC::OBS::CLOCK_OFFSET_US"
# streaming health monitor (obs/live.py, ``obs_live`` knob):
# current detector verdict (0 healthy / 1 degraded / 2 stuck), rolling
# windows folded, total detector firings plus the per-kind breakdown,
# and the worst link's cumulative exposed-wait in µs.  Registered ONLY
# when the knob is set — an unset knob adds no gauges at all.
OBS_HEALTH_STATUS = "PARSEC::OBS::HEALTH::STATUS"
OBS_HEALTH_WINDOWS = "PARSEC::OBS::HEALTH::WINDOWS"
OBS_HEALTH_FIRINGS = "PARSEC::OBS::HEALTH::FIRINGS"
OBS_HEALTH_STRAGGLER = "PARSEC::OBS::HEALTH::STRAGGLER_FIRINGS"
OBS_HEALTH_DEGRADED = "PARSEC::OBS::HEALTH::DEGRADED_LINK_FIRINGS"
OBS_HEALTH_STUCK = "PARSEC::OBS::HEALTH::STUCK_FIRINGS"
OBS_HEALTH_WORST_LINK_US = "PARSEC::OBS::HEALTH::WORST_LINK_EXPOSED_US"
# closed-loop self-tuning (tune/controller.py, ``tune_auto``
# knob): knob moves the controller committed, moves it rolled back on
# objective regression, the codec-ladder rung actually active toward a
# peer (PARSEC::TUNE::ACTIVE_CODEC::R<peer>, 0 lossless / 1 qbf16 /
# 2 qint8), and the device us/task objective EWMA the pipeline
# hill-climber steers by.  Registered ONLY under the knob — an unset
# knob constructs no controller and adds no gauges.
TUNE_DECISIONS = "PARSEC::TUNE::DECISIONS"
TUNE_REVERTS = "PARSEC::TUNE::REVERTS"
TUNE_ACTIVE_CODEC_PREFIX = "PARSEC::TUNE::ACTIVE_CODEC"
TUNE_OBJECTIVE_US = "PARSEC::TUNE::OBJECTIVE_US"
# cross-rank SPMD stages (stagec/xrank.py): wave-front stages run as
# ONE program over the spanning ranks' lane chips — blocks recorded,
# member tasks they retired, boundary-tile bytes moved by the in-program
# gather (every participant adds the wave's (R - 1) * B tile bytes), and
# planned cross-rank waves a rank left for its rank-local stage
XSTAGE_COMPILES = "PARSEC::STAGEC::XSTAGE_COMPILES"
XSTAGE_TASKS = "PARSEC::STAGEC::XSTAGE_TASKS"
XSTAGE_COLLECTIVE_BYTES = "PARSEC::STAGEC::XSTAGE_COLLECTIVE_BYTES"
XSTAGE_FALLBACKS = "PARSEC::STAGEC::XSTAGE_FALLBACKS"
# multi-tenant persistent serving (serve/server.py, ``serve``
# knob family): open tenant sessions, admission outcomes (admitted /
# rejected / queued submissions across all tenants), and per-tenant
# gauges registered at open_tenant — in-flight taskpools
# (PARSEC::SERVE::INFLIGHT::<tenant>), bytes charged against the
# declared Mempool quota (PARSEC::SERVE::QUOTA_BYTES::<tenant>), and
# the rolling p99 taskpool latency
# (PARSEC::SERVE::P99_LATENCY_US::<tenant>).  Registered ONLY when a
# SessionServer is constructed — no server, no gauges.
SERVE_TENANTS = "PARSEC::SERVE::TENANTS"
SERVE_ADMITTED = "PARSEC::SERVE::ADMITTED"
SERVE_REJECTED = "PARSEC::SERVE::REJECTED"
SERVE_QUEUED = "PARSEC::SERVE::QUEUED"
SERVE_INFLIGHT_PREFIX = "PARSEC::SERVE::INFLIGHT"
SERVE_QUOTA_BYTES_PREFIX = "PARSEC::SERVE::QUOTA_BYTES"
SERVE_P99_LATENCY_PREFIX = "PARSEC::SERVE::P99_LATENCY_US"


def flow_event_id(ctx: Tuple[int, ...]) -> int:
    """The Chrome-trace flow id of one wire trace context: the span id
    with the origin rank in the high bits, so ids from every rank's
    allocator stay globally unique in a merged timeline.  Tolerates the
    obs_live EXTENDED context ``(origin, span, pool, t_send_ns)`` — the
    flow id depends only on the first two fields, so a live-extended
    edge stitches with a plain one."""
    origin, span = ctx[0], ctx[1]
    return (int(origin) << 40) | (int(span) & ((1 << 40) - 1))


#: inbound trace context of the message currently being delivered on
#: this thread (remote_dep sets it around the activation walk) — how a
#: compiled stage task learns which wire flows fed it without any
#: signature change through the activate chain (stagec/runtime.py)
_INBOUND_TLS = threading.local()


def inbound_flow_ctx() -> Optional[Tuple[int, int]]:
    return getattr(_INBOUND_TLS, "ctx", None)


def set_inbound_flow_ctx(ctx: Optional[Tuple[int, int]]) -> None:
    _INBOUND_TLS.ctx = ctx

#: trace stream ids (outside any plausible worker th_id range)
COMM_STREAM_TID = 1 << 20
DEVICE_STREAM_TID = (1 << 20) + 1
#: the obs_live monitor's annotation stream (detector firings land as
#: Chrome-trace instant events so merged timelines show verdicts at
#: the right instant); must stay above every DEVICE_STREAM_TID + index
HEALTH_STREAM_TID = (1 << 20) + (1 << 10)


_TAG_NAMES: Dict[int, str] = {}


def _tag_name(tag: int) -> str:
    """Human label for a wire tag (span names beat raw tag ints in
    Perfetto). Lazy so obs never imports the comm layer at module load."""
    if not _TAG_NAMES:
        from ..comm import engine as _e
        _TAG_NAMES.update({
            _e.TAG_ACTIVATE: "activate", _e.TAG_GET_REQ: "get_req",
            _e.TAG_GET_DATA: "get_data", _e.TAG_PUT_DATA: "put_data",
            _e.TAG_TERMDET: "termdet", _e.TAG_DTD_DATA: "dtd_data",
            _e.TAG_MEM_PUT: "mem_put"})
    return _TAG_NAMES.get(tag, str(tag))


def payload_nbytes(payload: Any) -> int:
    """Structural byte count of an AM payload. Sender and receiver apply
    the SAME function to the SAME structure (deep-copied or re-pickled by
    the wire), so BYTES_SENT and BYTES_RECEIVED balance across ranks."""
    nbytes = getattr(payload, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_nbytes(v) for v in payload)
    return 8


class OverlapTracker:
    """Online compute/comm interval accumulator behind the live
    ``PARSEC::OBS::OVERLAP_FRACTION`` gauge.

    The span sinks report completed intervals into two channels —
    ``compute`` (task execution, fed by the EXEC-site timer) and
    ``comm`` (comm-engine spans + host<->device transfers).  The gauge
    read merges each channel's union and intersects them — the exact
    T3 metric obs/critpath.py computes offline, on the live run.
    Appends are O(1) under a lock; past ``COALESCE_AT`` intervals per
    channel the lists merge, and if still too long the old prefix
    (everything before a shared time watermark) is SEALED into scalar
    totals — its union length and cross-channel intersection are exact
    at seal time, so the reported fractions never drift while memory
    stays bounded on long runs.  (The one approximation: a span that
    *completes* after a seal but *started* before the watermark can no
    longer intersect sealed intervals of the other channel, so overlap
    may be slightly under-reported — conservative for a gate.)
    Timestamps are monotonic-ns (the span sinks' clock); intervals are
    stored in microseconds."""

    __slots__ = ("_lock", "_iv", "_closed")

    COALESCE_AT = 4096
    #: intervals kept live per channel after a seal
    KEEP_AT = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._iv: Dict[str, List[Tuple[float, float]]] = {
            "compute": [], "comm": []}
        # sealed-prefix totals (us): exact union lengths + their exact
        # intersection, accumulated when old intervals are retired
        self._closed = {"compute_us": 0.0, "comm_us": 0.0,
                        "overlap_us": 0.0}

    def note(self, channel: str, t0_ns: int, t1_ns: int) -> None:
        if t1_ns <= t0_ns:
            return
        with self._lock:
            self._iv[channel].append((t0_ns / 1e3, t1_ns / 1e3))
            if len(self._iv[channel]) > self.COALESCE_AT:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Merge both channels; if a channel is still over the budget
        (disjoint intervals cannot merge away), seal everything before
        a shared watermark into the closed totals."""
        from .critpath import merge_intervals, overlap_us
        comp = merge_intervals(self._iv["compute"])
        comm = merge_intervals(self._iv["comm"])
        if max(len(comp), len(comm)) > self.COALESCE_AT:
            # watermark: the start of the KEEP_AT-th-from-last interval
            # of every over-budget channel — both channels seal at the
            # SAME cut so the sealed intersection is exact
            w = min(ch[-self.KEEP_AT][0] for ch in (comp, comm)
                    if len(ch) > self.KEEP_AT)

            def split(ivs):
                old, new = [], []
                for b, e in ivs:
                    if e <= w:
                        old.append((b, e))
                    elif b >= w:
                        new.append((b, e))
                    else:           # straddles the cut: clip, no loss
                        old.append((b, w))
                        new.append((w, e))
                return old, new

            old_comp, comp = split(comp)
            old_comm, comm = split(comm)
            self._closed["compute_us"] += sum(e - b for b, e in old_comp)
            self._closed["comm_us"] += sum(e - b for b, e in old_comm)
            self._closed["overlap_us"] += overlap_us(old_comp, old_comm)
        self._iv["compute"], self._iv["comm"] = comp, comm

    def snapshot(self) -> Dict[str, float]:
        from .critpath import merge_intervals, overlap_us
        with self._lock:
            comp = list(self._iv["compute"])
            comm = list(self._iv["comm"])
            closed = dict(self._closed)
        comp = merge_intervals(comp)
        comm = merge_intervals(comm)
        comm_us = closed["comm_us"] + sum(e - b for b, e in comm)
        hidden = closed["overlap_us"] + overlap_us(comp, comm)
        return {"compute_us": (closed["compute_us"]
                               + sum(e - b for b, e in comp)),
                "comm_us": comm_us, "overlap_us": hidden,
                # zero-comm: nothing to hide — report PERFECT overlap
                # (1.0) so gates don't trip on comm-free ranks
                "overlap_fraction": (hidden / comm_us if comm_us > 0
                                     else 1.0)}

    def fraction(self) -> float:
        return round(self.snapshot()["overlap_fraction"], 4)

    def exposed_us(self) -> float:
        s = self.snapshot()
        return round(s["comm_us"] - s["overlap_us"], 1)


class CommObs:
    """Per-rank comm telemetry sink. Construct with the rank's metrics
    registry and (optionally) its Profile; every hook is safe to call
    from any thread."""

    __slots__ = ("metrics", "stream", "_open_gets", "_hist", "tracker",
                 "live")

    def __init__(self, metrics: MetricsRegistry,
                 profile: Optional[Any] = None,
                 tracker: Optional[OverlapTracker] = None,
                 live: Optional[Any] = None) -> None:
        self.metrics = metrics
        self.stream = (profile.stream(COMM_STREAM_TID, "comm")
                       if profile is not None else None)
        self._open_gets: Dict[int, int] = {}  # token -> t0_ns
        self._hist = metrics.histogram(COMM_XFER_SECONDS)
        self.tracker = tracker
        # obs_live streaming monitor: every span the sink
        # records is ALSO folded into the rolling health channels with
        # the same src/dst attribution the span args carry, so the live
        # per-link exposure matches the offline per-link report
        self.live = live

    # -- active messages -----------------------------------------------------
    def am_sent(self, src: int, dst: int, tag: int, payload: Any,
                t0_ns: int) -> None:
        nbytes = payload_nbytes(payload)
        sde = self.metrics.sde
        sde.inc(COMM_MSGS_SENT)
        sde.inc(COMM_BYTES_SENT, nbytes)
        t1 = time.monotonic_ns()
        if self.tracker is not None:
            self.tracker.note("comm", t0_ns, t1)
        if self.live is not None:
            self.live.note_comm(t0_ns, t1, src=src, dst=dst)
        st = self.stream
        if st is not None:
            st.span("comm:send", t0_ns, t1,
                    {"src": src, "dst": dst, "tag": tag, "bytes": nbytes})

    def am_arrived(self, src: int, tag: int, payload: Any) -> None:
        """Counted at arrival (even if the tag's handler is not bound yet
        and the message is deferred) so sent/received totals balance."""
        sde = self.metrics.sde
        sde.inc(COMM_MSGS_RECEIVED)
        sde.inc(COMM_BYTES_RECEIVED, payload_nbytes(payload))

    def delivered(self, src: int, me: int, tag: int, t0_ns: int) -> None:
        t1 = time.monotonic_ns()
        if self.live is not None:
            # delivers are comm spans offline (critpath._is_comm) but
            # NOT OverlapTracker channels — the live monitor keeps its
            # own channels so its numbers parity-match the report
            self.live.note_comm(t0_ns, t1, src=src, dst=me)
        st = self.stream
        if st is not None:
            st.span(f"comm:deliver:{_tag_name(tag)}", t0_ns, t1,
                    {"src": src, "dst": me, "tag": tag})

    # -- cross-rank flow edges ------------------------------------
    def flow_sent(self, dst: int, tag: int, ctx: Any, t0_ns: int) -> None:
        """The sender half of one wire flow edge: the message left with
        trace context ``ctx`` stamped on it at enqueue time ``t0_ns``."""
        self.metrics.sde.inc(OBS_FLOW_SENT)
        # serve-extended context: field 4 is the tenant that
        # submitted the pool — None on live-only contexts and on serve
        # traffic of pools no server owns
        tenant = ctx[4] if len(ctx) >= 5 else None
        if self.live is not None and len(ctx) >= 4:
            # extended live context: field 2 is the taskpool wire id
            self.live.note_flow_sent(dst, ctx[2], tenant=tenant)
        st = self.stream
        if st is not None:
            args = {"dst": dst}
            if tenant is not None:
                args["tenant"] = tenant
            st.flow(f"flow:{_tag_name(tag)}", flow_event_id(ctx), "s",
                    t0_ns, args)

    def flow_recv(self, src: int, tag: int, ctx: Any) -> None:
        """The receiver half: a message carrying ``ctx`` arrived —
        recorded once per message at arrival (deferred or not), so the
        merged timeline stitches exactly one edge per wire hop."""
        self.metrics.sde.inc(OBS_FLOW_RECV)
        t1 = time.monotonic_ns()
        tenant = ctx[4] if len(ctx) >= 5 else None
        if self.live is not None and len(ctx) >= 4:
            # extended live context: (origin, span, pool, t_send_ns) —
            # the sender's monotonic send instant converts to lag via
            # the live clock-offset estimate inside the monitor
            self.live.note_flow_recv(src, ctx[2], ctx[3], t1,
                                     tenant=tenant)
        st = self.stream
        if st is not None:
            args = {"src": src}
            if tenant is not None:
                args["tenant"] = tenant
            st.flow(f"flow:{_tag_name(tag)}", flow_event_id(ctx), "f",
                    t1, args)

    # -- one-sided transfers -------------------------------------------------
    def get_begin(self, token: int, src_rank: int) -> None:
        self._open_gets[token] = time.monotonic_ns()

    def get_end(self, token: int, src_rank: int, payload: Any) -> None:
        t0 = self._open_gets.pop(token, None)
        if t0 is None:
            return
        t1 = time.monotonic_ns()
        self._hist.observe((t1 - t0) / 1e9)
        if self.tracker is not None:
            self.tracker.note("comm", t0, t1)
        if self.live is not None:
            self.live.note_comm(t0, t1, src=src_rank)
        st = self.stream
        if st is not None:
            st.span("comm:get", t0, t1,
                    {"src": src_rank, "token": token,
                     "bytes": payload_nbytes(payload)})

    def put(self, dst_rank: int, payload: Any, t0_ns: int) -> None:
        # the span covers the local post only (one-sided puts complete
        # on the receiver's progress with no ack) — so puts do NOT feed
        # the transfer-latency histogram; GETs, which have a matched
        # reply, do
        t1 = time.monotonic_ns()
        if self.tracker is not None:
            self.tracker.note("comm", t0_ns, t1)
        if self.live is not None:
            self.live.note_comm(t0_ns, t1, dst=dst_rank)
        st = self.stream
        if st is not None:
            st.span("comm:put", t0_ns, t1,
                    {"dst": dst_rank, "bytes": payload_nbytes(payload)})

    # -- generic protocol spans (remote_dep et al.) --------------------------
    def span(self, key: str, t0_ns: int, info: Any = None) -> None:
        t1 = time.monotonic_ns()
        if self.tracker is not None:
            self.tracker.note("comm", t0_ns, t1)
        if self.live is not None:
            src = dst = None
            if isinstance(info, dict):
                src, dst = info.get("src"), info.get("dst")
            self.live.note_comm(t0_ns, t1, src=src, dst=dst)
        st = self.stream
        if st is not None:
            st.span(key, t0_ns, t1, info)

    # -- progress ------------------------------------------------------------
    def progress(self, handled: int, t0_ns: int) -> None:
        """Called after a drain; only drains that handled at least one
        message become spans (idle polls would drown the trace)."""
        if handled <= 0:
            return
        t1 = time.monotonic_ns()
        if self.live is not None:
            # progress drains are comm:* offline too (unattributed —
            # they widen the comm union for the overlap fraction)
            self.live.note_comm(t0_ns, t1)
        st = self.stream
        if st is not None:
            st.span("comm:progress", t0_ns, t1, {"handled": handled})

    # -- engine gauge wiring -------------------------------------------------
    def register_engine_gauges(self, ce: Any) -> None:
        """Pull gauges over the engine's live queues: outstanding GET
        tokens (ACTIVE_TRANSFERS), not-yet-deliverable deferred
        messages (PENDING_MESSAGES), and — on transports with the wire
        fast path — coalescing/chunking/compression counters plus
        per-peer link-bandwidth EWMA gauges. Poll-only: nothing lands
        on the transport's hot path."""
        sde = self.metrics.sde
        get_cbs = getattr(ce, "_get_cbs", None)
        if get_cbs is not None:
            sde.register_poll(COMM_ACTIVE_TRANSFERS, lambda: len(get_cbs))
        sde.register_poll(COMM_PENDING_MESSAGES,
                          lambda: len(ce._deferred))
        ws = getattr(ce, "wire_stats", None)
        if ws is not None:
            sde.register_poll(COMM_COALESCED,
                              lambda w=ws: w["coalesced_msgs"])
        if ws is not None and "reconnects" in ws:
            sde.register_poll(COMM_RECONNECTS,
                              lambda w=ws: w["reconnects"])
            sde.register_poll(COMM_REPLAYED_FRAMES,
                              lambda w=ws: w["replayed_frames"])
            sde.register_poll(COMM_DUP_DROPPED,
                              lambda w=ws: w["dup_dropped"])
        if hasattr(ce, "suspect_ms"):
            sde.register_poll(COMM_SUSPECT_MS, ce.suspect_ms)
        if hasattr(ce, "chunks_inflight"):
            sde.register_poll(COMM_CHUNKS_INFLIGHT, ce.chunks_inflight)
        if hasattr(ce, "compress_ratio"):
            sde.register_poll(
                COMM_COMPRESS_RATIO,
                lambda c=ce: (lambda r: 1.0 if r is None else r)(
                    c.compress_ratio()))
        if hasattr(ce, "link_bw_mbps"):
            for peer in range(ce.nb_ranks):
                if peer == ce.rank:
                    continue
                sde.register_poll(
                    f"{COMM_LINK_BW_PREFIX}::R{peer}",
                    lambda c=ce, p=peer: (lambda b: 0.0 if b is None
                                          else round(b, 3))(
                        c.link_bw_mbps(p)))
        flow_on = getattr(ce, "_flow_enabled", None)
        if flow_on is None:
            from ..utils.params import params
            flow_on = bool(params.get_or("obs_flow", "bool", False))
        if flow_on and hasattr(ce, "clock_offset_us"):
            # per-peer clock-offset estimate: peer_clock -
            # my_clock in µs, 0 until a clock-extended pong landed (and
            # identically 0 on same-clock in-process fabrics).  Only
            # under the knob: a big fleet with metrics on must not pay
            # nb_ranks-1 lock-taking polls per sample for a feature
            # that is off
            for peer in range(ce.nb_ranks):
                if peer == ce.rank:
                    continue
                sde.register_poll(
                    f"{OBS_CLOCK_OFFSET_PREFIX}::R{peer}",
                    lambda c=ce, p=peer: (lambda o: 0.0 if o is None
                                          else o)(c.clock_offset_us(p)))
        ds = getattr(ce, "dplane_stats", None)
        if ds is not None:
            sde.register_poll(COMM_DPLANE_BYTES,
                              lambda s=ds: s["dplane_bytes"])
            sde.register_poll(COMM_DPLANE_XFERS,
                              lambda s=ds: s["dplane_xfers"])
            sde.register_poll(COMM_REDIST_ROUNDS,
                              lambda s=ds: s["redist_rounds"])
            sde.register_poll(COMM_TWO_LEVEL_REDUCES,
                              lambda s=ds: s["two_level_reduces"])
        es = getattr(ce, "elastic_stats", None)
        if es is not None:
            sde.register_poll(FT_ELASTIC_RESIZES,
                              lambda s=es: s["elastic_resizes"])
            sde.register_poll(FT_ELASTIC_JOINS,
                              lambda s=es: s["elastic_joins"])
            sde.register_poll(FT_RESHARD_BYTES,
                              lambda s=es: s["reshard_bytes"])
            sde.register_poll(FT_RESHARD_US,
                              lambda s=es: s["reshard_us"])
        det = getattr(ce, "ft_detector", None)
        if det is not None:
            sde.register_poll(FT_PEER_ALIVE, det.alive_count)
            for peer in range(ce.nb_ranks):
                if peer == ce.rank:
                    continue
                sde.register_poll(
                    f"{FT_HB_RTT_PREFIX}::R{peer}",
                    lambda d=det, p=peer: (lambda r: 0.0 if r is None
                                           else round(r * 1e3, 3))(
                        d.rtt_s(p)))


def register_device_gauges(sde: Any, device: Any) -> None:
    """Pull gauges over one device's accounting state — poll-only, so
    registering them costs nothing on any hot path (safe to do for
    uninstrumented runs too)."""
    prefix = f"PARSEC::DEVICE::{device.name}"
    sde.register_poll(f"{prefix}::TASKS",
                      lambda d=device: d.executed_tasks)
    sde.register_poll(f"{prefix}::LOAD", lambda d=device: d.device_load)
    if hasattr(device, "mem_used"):
        sde.register_poll(f"{prefix}::MEM_USED",
                          lambda d=device: d.mem_used)
    if hasattr(device, "mem_highwater"):
        sde.register_poll(f"{prefix}::MEM_HIGHWATER",
                          lambda d=device: d.mem_highwater)
    if hasattr(device, "mesh_shards"):
        # chips in the device's mesh (device_mesh_shape) —
        # COLLECTIVE_BYTES / MESH_DISPATCHES / MESH_MOVES ride the
        # stats loop below
        sde.register_poll(f"{prefix}::MESH_SHARDS",
                          lambda d=device: d.mesh_shards)
    stats = getattr(device, "stats", None)
    if isinstance(stats, dict):
        for key in stats:
            sde.register_poll(f"{prefix}::{key.upper()}",
                              lambda s=stats, k=key: s[k])
    # batched-dispatch pipeline health (guide §9.1): mean tasks per
    # stacked dispatch, fraction of prefetched stage-ins that the
    # consuming task found already resident, and the mean CPU-side
    # dispatch cost per task (batched + per-task submissions combined)
    if isinstance(stats, dict) and "batches" in stats:
        sde.register_poll(
            f"{prefix}::BATCH_OCCUPANCY",
            lambda s=stats: round(s["batched_tasks"] / s["batches"], 3)
            if s["batches"] else 0.0)
    if isinstance(stats, dict) and "prefetch_issued" in stats:
        sde.register_poll(
            f"{prefix}::PREFETCH_HIT_RATE",
            lambda s=stats: round(s["prefetch_hits"]
                                  / s["prefetch_issued"], 3)
            if s["prefetch_issued"] else 0.0)
    if isinstance(stats, dict) and "dispatch_ns" in stats:
        sde.register_poll(
            f"{prefix}::DISPATCH_US",
            lambda s=stats: round(s["dispatch_ns"] / 1e3
                                  / s["dispatch_tasks"], 3)
            if s["dispatch_tasks"] else 0.0)


class DeviceObs:
    """Per-device span/histogram sink — installed as ``device._obs``
    only when telemetry is enabled, so uninstrumented transfer sites
    keep the one-attribute-check fast path (gauges are registered
    separately via :func:`register_device_gauges`).

    On a CUDA device a launch returns before its kernels end and a
    copy's host span includes waiting for the work queued before it, so
    host clocks time neither.  The device module then brackets each
    dispatch and each copy with timed CUDA events on its stream (only
    while this sink is installed: the knob-unset path records no timed
    event), and the sink places them on the host monotonic clock through
    one anchor, an event taken at a synchronize.  Events resolve lazily
    (:meth:`flush`, at the device's drain and at :meth:`close`):

    - a dispatch becomes a ``dev:busy`` span, from its start event to
      its end event: the stream's busy interval for that dispatch (an
      upper bound: it includes any gap between the body's launches);
    - a copy becomes a ``dev:xfer_in``/``dev:xfer_out`` span from its
      start event (the stream reached the copy) to the host's return
      from it, and the host's wait before the copy started, if any,
      becomes a ``dev:wait_in``/``dev:wait_out`` span of its own — only
      the copy counts as communication.

    On host tensors (``device="cpu"``) every launch and copy is complete
    when it returns, and the host spans are the intervals."""

    __slots__ = ("metrics", "stream", "name", "_hist", "tracker", "live",
                 "_cuda", "_dstream", "_anchor", "_pending", "_lock")

    def __init__(self, metrics: MetricsRegistry, device: Any,
                 profile: Optional[Any] = None,
                 tracker: Optional[OverlapTracker] = None,
                 live: Optional[Any] = None) -> None:
        self.metrics = metrics
        self.name = device.name
        self.stream = (profile.stream(DEVICE_STREAM_TID + device.device_index,
                                      f"dev:{device.name}")
                       if profile is not None else None)
        self._hist = metrics.histogram(COMM_XFER_SECONDS)
        self.tracker = tracker
        self.live = live
        self._dstream = getattr(device, "stream", None)
        self._cuda = self._dstream is not None
        self._lock = threading.Lock()
        # unresolved event records: (kind, args, ev0, ev1 | None,
        # t0_host_ns, t1_host_ns)
        self._pending: List[Tuple] = []
        self._anchor: Optional[Tuple[Any, int]] = None
        if self._cuda:
            import torch
            torch.cuda.synchronize(device.torch_device)
            ev = torch.cuda.Event(enable_timing=True)
            ta = time.monotonic_ns()
            ev.record(self._dstream)
            ev.synchronize()
            tb = time.monotonic_ns()
            self._anchor = (ev, (ta + tb) // 2)

    # -- called by the device module (its stream entered) --------------------
    def mark(self, stream: Any = None) -> Any:
        """A timed event on ``stream`` (default: the device stream; a
        chip mesh passes a chip's), None on host tensors."""
        if not self._cuda:
            return None
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._dstream if stream is None else stream)
        return ev

    def dispatch(self, name: str, ntasks: int, ev0: Any, t0_ns: int,
                 stream: Any = None) -> None:
        """One dispatch (a body call, or a batch) was launched on
        ``stream`` (default: the device stream) between ``ev0`` (or
        ``t0_ns`` on host tensors) and now."""
        if not self._cuda:
            self._busy(t0_ns, time.monotonic_ns(), name, ntasks)
            return
        ev1 = self.mark(stream)
        with self._lock:
            self._pending.append(("busy", (name, ntasks), ev0, ev1, 0, 0))

    def xfer(self, direction: str, nbytes: int, t0_ns: int,
             ev0: Any = None) -> None:
        """A host<->device transfer completed (direction: "in"|"out");
        the host asked for it at ``t0_ns`` and ``ev0`` was recorded on
        the stream just before the copy."""
        t1 = time.monotonic_ns()
        if ev0 is None:
            self._xfer(direction, nbytes, t0_ns, t0_ns, t1)
            return
        with self._lock:
            self._pending.append(("xfer", (direction, nbytes), ev0, None,
                                  t0_ns, t1))

    # -- resolution ------------------------------------------------------------
    def _at(self, ev: Any) -> int:
        """An event's instant on the host monotonic clock (ns)."""
        aev, ans = self._anchor
        return ans + int(round(aev.elapsed_time(ev) * 1e6))

    def flush(self) -> None:
        """Resolve every recorded event into spans (synchronizes with
        each first)."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        # a chip mesh records on several streams: wait for each entry
        for entry in pending:
            (entry[3] if entry[3] is not None else entry[2]).synchronize()
        for kind, args, ev0, ev1, h0, h1 in pending:
            if kind == "busy":
                self._busy(self._at(ev0), self._at(ev1), *args)
            else:
                # the copy started when the stream reached ev0, and
                # ended when the synchronous copy returned to the host
                c0 = min(max(self._at(ev0), h0), h1)
                self._xfer(args[0], args[1], h0, c0, h1)

    def _busy(self, t0: int, t1: int, name: str, ntasks: int) -> None:
        st = self.stream
        if st is not None:
            st.span("dev:busy", t0, t1,
                    {"device": self.name, "class": name, "tasks": ntasks})

    def _xfer(self, direction: str, nbytes: int, h0: int, c0: int,
              t1: int) -> None:
        self._hist.observe((t1 - c0) / 1e9)
        if self.tracker is not None:
            # transfers count as COMM for the overlap gauge — the same
            # classification the offline analyzer applies (dev:xfer*)
            self.tracker.note("comm", c0, t1)
        if self.live is not None:
            self.live.note_comm(c0, t1)
        st = self.stream
        if st is not None:
            if c0 > h0:
                st.span(f"dev:wait_{direction}", h0, c0,
                        {"device": self.name})
            st.span(f"dev:xfer_{direction}", c0, t1,
                    {"device": self.name, "bytes": nbytes})

    def close(self) -> None:
        self.flush()
