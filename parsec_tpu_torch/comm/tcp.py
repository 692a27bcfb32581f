"""TCP transport: the cross-process/cross-host comm engine.

Reference behavior being replaced: the funnelled MPI engine is the only
in-tree transport and carries both the control plane (activations, GET
requests) and the data plane over two-sided MPI
(parsec/parsec_mpi_funnelled.c). Here the same activation/GET/PUT
emulation (inherited from LocalCommEngine) rides framed pickle messages
over TCP sockets — one duplex connection per rank pair, receiver
threads feeding a local inbox, callbacks dispatched from progress() on
the caller's thread (funnelled semantics preserved).

The wire fast path (framing in comm/wire.py):

- each peer has a SEND QUEUE drained by a dedicated writer thread;
  ``send_am`` serializes on the caller's thread (copy-at-enqueue for
  everything below the chunk threshold — the historical snapshot
  semantics) and returns as soon as the message fits the bounded
  per-peer send buffer (``comm_send_buffer_bytes`` — backpressure
  toward a slow link, so producers stall instead of queueing an
  epoch's traffic in RAM);
- queued small messages COALESCE into one multi-message frame per
  syscall (``comm_coalesce_max_bytes``), so on a slow DCN the control
  plane pays one syscall + one wakeup for a burst of activations;
- buffers >= ``comm_chunk_bytes`` stream as bounded CHUNK frames with
  pickle-5 zero-copy views; control messages interleave between chunks
  instead of head-of-line blocking behind a multi-MB tile (callers on
  the bulk path — GET rendezvous, wave tiles — snapshot their payloads
  already, so zero-copy is safe there);
- per-link COMPRESSION (zlib, lz4 when installed) is negotiated at the
  connection handshake and engages only when the measured link
  bandwidth EWMA drops below ``comm_compress_threshold_mbps`` (default
  0 = never) AND a sample probe shows the traffic compresses; a peer
  that never advertises codecs (HELLO missing or no common codec)
  stays uncompressed. The v2 framing itself is a breaking wire change:
  every rank of a job must run the same framing version;
- RELIABLE SESSIONS (``comm_reconnect_timeout`` > 0, HELLO ``"rs"``
  capability): each peer link is a session — data frames carry a
  per-direction ``seq`` (wire.K_SEQ envelope), the writer retains a
  bounded replay window of sent-but-unacked frames
  (``comm_replay_window_bytes``; the retained bytes also count against
  the ``comm_send_buffer_bytes`` backpressure budget), and the
  receiver acks cumulatively (K_ACK) and discards duplicates by seq.
  A socket error then marks the peer SUSPECT instead of dead: senders
  park on the bounded send buffer, in-flight GETs/rendezvous wait, and
  a reconnector re-dials with exponential backoff + jitter under the
  ``comm_reconnect_timeout`` budget. The reconnect handshake
  (K_RESUME) exchanges the session epoch and last-delivered seq both
  ways — the sender replays the gap (byte-level resume of a frame
  truncated mid-body, K_FRAG), the receiver dedups, and no active
  message is lost or delivered twice. Only budget exhaustion — or the
  escalates to the ``_peer_died`` fail-fast path. A mixed-version peer
  (no ``"rs"`` in its HELLO) or an unset knob keeps fail-fast behavior
  bit for bit.

Payloads are host data: a torch tensor reaching the wire raises
TypeError (comm/wire.py); tiles in device memory either stage to numpy
in the remote-dep layer or ride the device data plane (comm/xfer.py).
The wire is the JAX package's, frame for frame.

Fault tolerance (ft/): heartbeat probes are wire-level K_PING/K_PONG
frames answered by the receiver THREAD (liveness judges the transport,
not the progress cadence) and fed to the installed HeartbeatDetector;
every outbound frame consults the chaos layer (``ft_outbound``); an
injected kill (``ft_silence``) drops all traffic, stops the writers
without flushing and finis without a goodbye, as a SIGKILL would.

Telemetry (obs/): with ``obs_flow`` (or ``obs_live``) set, the HELLO
advertises ``"tr"`` (and ``"lv"``), data AMs toward peers that
advertised it carry a wire trace context, and pings toward them grow a
clock word whose pong feeds a per-peer clock-offset EWMA (a sampler
thread keeps it fresh).  Unset on either end, the bytes that end sends
are the knob-unset ones.  Spans and flow halves land in the engine's
``_obs`` sink.  ``tune_auto`` advertises ``"tn"``: between two such ends
the controller (tune/) renegotiates a link's quantized codec at run time
by K_TUNE frames.  ``serve`` advertises ``"sv"``: between two such ends
the live context carries the submitting tenant and serve control AMs
are accepted.  Both imply the ``obs_live`` wire behavior.
``stage_compile_xrank`` advertises ``"xs"`` with a per-process token:
two ends negotiate it only when the tokens are equal, i.e. both ranks
live in this process and can share one cross-rank stage program
(stagec/xrank.py).

Connection setup: rank r listens on ``endpoints[r]``; r dials every rank
s < r and accepts from every s > r (one connection per unordered pair),
with a rank-identifying handshake byte frame followed by a HELLO
capability frame.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..core.lists import Fifo
from .engine import RankFailedError, TAG_GET_DATA, TAG_USER_BASE
from ..utils import logging as plog
from .local import LocalCommEngine, _wire_copy
from . import wire
from .wire import GOODBYE

TAG_BARRIER = TAG_USER_BASE - 1  # reserved by the transport for sync()

#: per-PROCESS random token advertised under the HELLO "xs" capability:
#: equality on the receive side proves two ranks share this process —
#: and therefore its chips and streams, the precondition for running a
#: wave-front stage as ONE program across them (stagec/xrank.py).
#: Minted lazily, so an unset knob never generates it.
_XS_TOKEN: Optional[str] = None
_XS_TOKEN_LOCK = threading.Lock()  # lock: guards module-global _XS_TOKEN lazy init, not a class field


def _xs_proc_token() -> str:
    global _XS_TOKEN
    with _XS_TOKEN_LOCK:
        if _XS_TOKEN is None:
            import os
            import uuid
            _XS_TOKEN = f"xs-{os.getpid()}-{uuid.uuid4().hex}"
        return _XS_TOKEN

#: bandwidth EWMA smoothing and the minimum send size that counts as a
#: bandwidth sample (smaller sends measure syscall latency, not the link)
_BW_ALPHA = 0.2
_BW_SAMPLE_MIN = 1 << 15
#: compression: re-probe cadence (frames) and the engage ratio
_PROBE_EVERY = 256
_PROBE_RATIO = 0.9
#: smallest body worth compressing
_COMP_MIN_BYTES = 512
#: iovec safety cap for one sendmsg (IOV_MAX is 1024 on linux)
_MAX_BATCH_MSGS = 256
#: anti-starvation: after this many consecutive ctrl frames with bulk
#: chunks waiting, one chunk is interleaved regardless — a sustained
#: control stream must not stall an in-flight bulk transfer forever
_CTRL_STREAK_MAX = 8
#: reliable sessions: how long a writer holds DATA frames waiting for
#: the peer's HELLO before assuming a mixed-version (session-less) peer
#: — frames sent before capabilities are known cannot ride the replay
#: window, so with sessions enabled locally the first data frame waits
#: for the capability exchange (every current build HELLOs first-thing,
#: so this only delays traffic toward true pre-HELLO builds)
_HELLO_GRACE = 5.0
#: receiver ack cadence: a cumulative K_ACK at latest every this many
#: delivered data frames (the byte threshold adapts to the window cap)
_ACK_EVERY_FRAMES = 16
#: reconnect backoff ceiling (seconds; doubles from the configured
#: initial value, with multiplicative jitter against thundering herds)
_RECONNECT_BACKOFF_MAX = 2.0

#: declared lock discipline, enforced by the concurrency lint
#: (parsec_tpu/analysis/lock_check.py): per-peer send queues belong to
#: the peer's condition (writer thread vs. every sender), the peer map
#: to the connection condition (accept thread vs. everyone), wire
#: counters and barrier state to their dedicated locks.  The same lint
#: verifies no socket send/recv or sleep ever runs while one of these
#: is held — the writer drains OUTSIDE peer.cond by construction.
_GUARDED_BY = {
    "_Peer.ctrl": "cond",
    "_Peer.bulk": "cond",
    "_Peer.queued_bytes": "cond",
    # reliable-session state: suspect flag, send/receive seq
    # counters, the replay window + its byte accounting, the pending
    # replay list and the receiver's partial-frame resume buffer are
    # shared between the writer thread, the receiver thread, every
    # sender parked in backpressure, and the reconnector — all under
    # the peer's condition (resume swaps threads only after the old
    # generation has exited, but the STATE handoff itself is locked)
    # quantized wire codecs: the negotiated lossy codec and
    # the per-peer per-codec byte accounting feeding the labeled
    # COMPRESS_RATIO gauges — written by the enqueuing sender thread
    # (quantize) and the writer thread (compress), read by the obs
    # poll, all under the peer's condition
    "_Peer.qz_codec": "cond",
    # closed-loop tuning: received quantized-buffer accounting, written
    # by the receiver thread and read by the controller's window tick
    "_Peer.qrx_pre": "cond",
    "_Peer.qrx_post": "cond",
    "_Peer.q_pre": "cond",
    "_Peer.q_post": "cond",
    "_Peer.comp_pre": "cond",
    "_Peer.comp_post": "cond",
    "_Peer.suspect": "cond",
    "_Peer.rs_epoch": "cond",
    "_Peer.rs_tx_seq": "cond",
    "_Peer.rs_rx_seq": "cond",
    "_Peer.rs_window": "cond",
    "_Peer.rs_window_bytes": "cond",
    "_Peer.rs_replay": "cond",
    "_Peer.rs_rx_partial": "cond",
    "TCPCommEngine._peers": "_conn_cond",
    "TCPCommEngine.wire_stats": "_stat_lock",
    "TCPCommEngine._rx_pending": "_stat_lock",
    "TCPCommEngine.ping_rtt": "_stat_lock",
    # GOODBYE verdict evidence: GET tokens whose reply arrived but has
    # not been consumed — written by receiver threads, read by the
    # GOODBYE wait (shares the engine lock that guards _get_cbs/_get_srcs)
    "TCPCommEngine._rx_get_tokens": "_lock",
    "TCPCommEngine._xfer_iter": "_stat_lock",
    "TCPCommEngine._suspect_ms_total": "_stat_lock",
    "TCPCommEngine._barrier_arrived": "_barrier_lock",
    "TCPCommEngine._barrier_release": "_barrier_lock",
}


def free_ports(n: int) -> List[int]:
    """n distinct free localhost ports (test/launcher helper).  The
    probe sockets close before the engines bind, so another process may
    take a port in between: callers that race other binders retry on
    EADDRINUSE."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _sendall_vec(sock: socket.socket, pieces: List[Any]) -> None:
    """Scatter-gather sendall: one syscall per iteration over the whole
    piece list (the coalescing win — a batch of frames leaves in ONE
    sendmsg instead of one syscall per message)."""
    views = [memoryview(p) for p in pieces]
    while views:
        sent = sock.sendmsg(views)
        while sent:
            if len(views[0]) <= sent:
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


class _FabricShim:
    """Satisfies the tiny surface LocalCommEngine expects of a fabric."""

    def __init__(self, nb_ranks: int) -> None:
        self.nb_ranks = nb_ranks
        self.msg_count = 0
        self.bytes_count = 0


class _Peer:
    """Per-peer send state: the queues the writer thread drains.

    ``ctrl`` holds coalescible message segments and standalone frames
    (chunked-transfer headers, hello); ``bulk`` holds chunk items. The
    writer always prefers ctrl, so control traffic interleaves between
    the bounded chunks of an in-flight bulk payload."""

    __slots__ = ("rank", "sock", "ctrl", "bulk", "cond", "writer",
                 "goodbye", "bw_mbps", "codec", "engaged", "frames",
                 "probe_ratio", "done", "queued_bytes", "hb_ok",
                 "el_ok", "tr_ok", "lv_ok", "rs_ok", "hello_seen", "connected_at",
                 "conn_gen",
                 "suspect", "suspect_since", "rs_epoch", "rs_tx_seq",
                 "rs_rx_seq", "rs_window", "rs_window_bytes", "rs_replay",
                 "rs_rx_unacked_frames", "rs_rx_unacked_bytes",
                 "rs_rx_partial", "rx_xfers", "recv_thread",
                 "rs_resuming", "qz_codec", "q_pre", "q_post",
                 "comp_pre", "comp_post", "rs_dup_next", "tn_ok", "sv_ok",
                 "xs_ok", "qrx_pre", "qrx_post")

    def __init__(self, rank: int, sock: socket.socket) -> None:
        self.rank = rank
        self.sock = sock
        self.ctrl: deque = deque()
        self.bulk: deque = deque()
        self.queued_bytes = 0      # backpressure accounting
        self.cond = threading.Condition()
        self.writer: Optional[threading.Thread] = None
        self.goodbye = False       # enqueue-side: shutdown requested
        self.done = False          # writer exited
        self.bw_mbps: Optional[float] = None   # send-side link EWMA
        self.codec: Optional[str] = None       # negotiated at HELLO
        self.engaged = False                   # compression live now
        self.frames = 0                        # frames sent (probe clock)
        self.probe_ratio: Optional[float] = None
        # -- quantized wire codec ----------------------------
        self.qz_codec: Optional[str] = None    # negotiated at HELLO
        self.q_pre = 0             # raw bytes of quantized buffers
        self.q_post = 0            # encoded bytes actually queued
        self.comp_pre = 0          # per-peer lossless codec accounting
        self.comp_post = 0
        self.hb_ok = False         # HELLO advertised heartbeat support
        self.el_ok = False         # HELLO advertised elastic membership
        self.tr_ok = False         # HELLO advertised flow tracing ("tr")
        self.lv_ok = False         # HELLO advertised obs_live ("lv")
        self.tn_ok = False         # HELLO advertised runtime tuning ("tn")
        self.sv_ok = False         # HELLO advertised serving ("sv")
        self.xs_ok = False         # HELLO proved a co-resident xrank ("xs")
        # -- closed-loop tuning ----------------------------------
        self.qrx_pre = 0           # raw bytes of RECEIVED quantized bufs
        self.qrx_post = 0          # encoded bytes that landed for them
        # -- reliable session --------------------------------
        self.rs_ok = False         # both ends advertised "rs"
        self.hello_seen = False    # the peer's HELLO was processed
        self.connected_at = time.monotonic()
        self.conn_gen = 0          # bumped at each resume: stale-thread guard
        self.suspect = False       # link torn, reconnect in progress
        self.suspect_since = 0.0
        self.rs_epoch = 0          # bumped at each successful resume
        self.rs_tx_seq = 0         # last seq assigned to a sent data frame
        self.rs_rx_seq = 0         # last seq DELIVERED from the peer
        self.rs_window: deque = deque()   # (seq, frame pieces, nbytes)
        self.rs_window_bytes = 0
        self.rs_replay: list = []  # resume backlog the new writer sends first
        self.rs_rx_unacked_frames = 0      # receiver-side ack cadence
        self.rs_rx_unacked_bytes = 0
        # (total body size, bytes received so far) of a frame the link
        # tore mid-body — fed to K_RESUME as the byte-level resume claim
        self.rs_rx_partial: Optional[Tuple[int, bytearray]] = None
        # receive-side chunked-transfer reassembly lives on the PEER so
        # a transfer half-landed when the link flapped completes from
        # the replayed chunks after the resume
        self.rx_xfers: Dict[int, wire.RxXfer] = {}
        self.recv_thread: Optional[threading.Thread] = None
        # accept-side resume in flight (handshakes run on their own
        # threads now; a duplicate concurrent dial must not race one)
        self.rs_resuming = False
        # injected duplicate (ft/inject.py ``dup:``) on a session link:
        # the writer sends the next sequenced frame twice, same seq
        self.rs_dup_next = False


class TCPCommEngine(LocalCommEngine):
    #: a TCP probe only leaves when the peer's HELLO was processed
    #: (hb_ok) — its receiver thread was alive then and answers pings
    #: with no progress pumping, so probed-but-silent = genuinely dead
    ft_probe_baseline = True

    def __init__(self, rank: int, endpoints: List[Tuple[str, int]],
                 connect_timeout: float = 30.0,
                 coalesce_max_bytes: Optional[int] = None,
                 chunk_bytes: Optional[int] = None,
                 compress_threshold_mbps: Optional[float] = None,
                 reconnect_timeout: Optional[float] = None,
                 reconnect_backoff: Optional[float] = None,
                 replay_window_bytes: Optional[int] = None,
                 quantize: Optional[str] = None,
                 quantize_threshold_mbps: Optional[float] = None,
                 obs_flow: Optional[bool] = None,
                 obs_live: Optional[bool] = None,
                 tune_auto: Optional[bool] = None,
                 serve: Optional[bool] = None,
                 xstage: Optional[bool] = None) -> None:
        from ..utils.params import params
        self._inbox: Fifo = Fifo()
        # GET tokens whose reply has ARRIVED (pushed to the inbox by a
        # receiver thread) but not yet been consumed by a worker — the
        # GOODBYE verdict uses this to tell delivered-not-consumed
        # apart from never-sent (guarded by self._lock)
        self._rx_get_tokens: set = set()
        self._peers: Dict[int, _Peer] = {}
        self._recv_threads: List[threading.Thread] = []
        self._closing = False
        # dead_peers / on_peer_failure live on the CommEngine base now
        # (uniform across transports); finished_peers is TCP's record of
        # clean GOODBYEs received
        self.finished_peers: set = set()
        self._barrier_arrived: set = set()
        self._barrier_release = 0
        self._barrier_lock = threading.Lock()
        self._stat_lock = threading.Lock()
        self._conn_cond = threading.Condition()
        self._xfer_iter = 0
        self._rx_pending: Dict[int, int] = {}  # peer -> incomplete rx xfers
        # wire knobs (constructor overrides beat the MCA layer — bench
        # and tests compare configurations inside one process)
        self.coalesce_max_bytes = (
            coalesce_max_bytes if coalesce_max_bytes is not None
            else params.get_or("comm_coalesce_max_bytes", "sizet", 1 << 16))
        self.chunk_bytes = max(
            1, chunk_bytes if chunk_bytes is not None
            else params.get_or("comm_chunk_bytes", "sizet", 1 << 17))
        self.compress_threshold_mbps = (
            compress_threshold_mbps if compress_threshold_mbps is not None
            else params.get_or("comm_compress_threshold_mbps", "int", 0))
        self.send_buffer_bytes = max(
            1, params.get_or("comm_send_buffer_bytes", "sizet", 1 << 26))
        # reliable sessions: a torn link becomes a SUSPECT
        # peer with reconnect + seq-numbered replay while the knob's
        # budget lasts; 0/unset keeps today's fail-fast bit for bit
        if reconnect_timeout is None:
            raw = str(params.get("comm_reconnect_timeout") or "").strip()
            reconnect_timeout = float(raw) if raw else 0.0
        self.reconnect_timeout = max(0.0, float(reconnect_timeout))
        self._rs_enabled = self.reconnect_timeout > 0
        if reconnect_backoff is None:
            raw = str(params.get("comm_reconnect_backoff") or "").strip()
            reconnect_backoff = float(raw) if raw else 0.05
        self.reconnect_backoff = max(1e-3, float(reconnect_backoff))
        self.replay_window_bytes = max(
            1, replay_window_bytes if replay_window_bytes is not None
            else params.get_or("comm_replay_window_bytes", "sizet", 1 << 24))
        #: ack at latest every _ACK_EVERY_FRAMES delivered data frames
        #: or this many delivered bytes, whichever first — sized so the
        #: sender's replay window drains well before it fills
        self._ack_bytes = max(1, min(1 << 18, self.replay_window_bytes // 4))
        self._suspect_ms_total = 0.0
        # quantized wire codecs: lossy blockwise encodings
        # for bulk float tile payloads the sender layer marked eligible
        # (per-flow ``_qz_ok``) — engaged per link only toward peers
        # whose HELLO advertised the codec under "qz" (both ends must
        # set the knob; the advertisement itself is gated so an unset
        # knob leaves every wire byte, HELLO included, unchanged)
        if quantize is None:
            quantize = str(params.get("comm_quantize") or "")
        self._quantize = wire.normalize_quant_codec(quantize)
        if quantize_threshold_mbps is None:
            quantize_threshold_mbps = params.get_or(
                "comm_quantize_threshold_mbps", "int", 0)
        self.quantize_threshold_mbps = float(quantize_threshold_mbps or 0)
        self._codecs = wire.available_codecs()
        #: last heartbeat round trip per peer, seconds (K_PING/K_PONG)
        self.ping_rtt: Dict[int, float] = {}
        # cross-rank flow tracing + clock alignment: when the
        # ``obs_flow`` knob is set, the HELLO advertises a "tr"
        # capability (symmetric like "qz": an unset knob leaves every
        # wire byte, HELLO included, bit-for-bit unchanged), data AMs
        # toward tr-peers carry a (origin, span) trace context inside
        # their pickled payload, and heartbeat pings toward tr-peers
        # grow a trailing clock word — the pong echoes the responder's
        # monotonic clock, feeding an NTP-style midpoint offset estimate
        # per peer (an EWMA over the samples whose round trip is near
        # the shortest seen, exported to the trace metadata so the fleet
        # merge can fuse rank timelines)
        if obs_flow is None:
            obs_flow = bool(params.get_or("obs_flow", "bool", False))
        # obs_live rides the same machinery and adds its own symmetric
        # "lv" capability: toward lv-peers the stamped context widens to
        # (origin, span, pool, t_send_ns).  The knob implies the
        # obs_flow wire behavior (contexts + clock words)
        if obs_live is None:
            obs_live = bool(params.get_or("obs_live", "bool", False))
        # closed-loop tuning: the controller renegotiates a link's
        # quantized codec at RUNTIME via K_TUNE frames — only ever
        # toward peers whose HELLO advertised the symmetric "tn"
        # capability (a peer without it keeps the codec its HELLO
        # negotiated, forever).  The knob implies the obs_live wire
        # behavior: the controller's heartbeat is the live monitor's
        # window tick.
        if tune_auto is None:
            tune_auto = bool(params.get_or("tune_auto", "bool", False))
        # multi-tenant serving: SessionServer endpoints ride a symmetric
        # "sv" capability — toward sv-peers the live flow context widens
        # once more with the owning tenant's name, and serve control AMs
        # (TAG_SERVE/_REPLY) are accepted.  The knob implies the obs_live
        # wire behavior; unset on EITHER end keeps that end's wire bytes
        # exactly what the unset build would produce.
        if serve is None:
            serve = bool(params.get_or("serve", "bool", False))
        self._serve_enabled = bool(serve)
        # cross-rank SPMD stages: the "xs" capability rides a per-PROCESS
        # random token, so it only negotiates between ranks that share
        # this process (one program over their lane chips); a knob-unset
        # or mixed-version peer never matches and keeps the activation
        # path bit-for-bit.  Unset on EITHER end leaves that end's HELLO
        # bytes exactly what the unset build sends
        if xstage is None:
            xstage = bool(params.get_or("stage_compile_xrank", "bool",
                                        False))
        self._xs_enabled = bool(xstage)
        self._tune_enabled = bool(tune_auto)
        self._live_enabled = (bool(obs_live) or self._tune_enabled
                              or self._serve_enabled)
        self._flow_enabled = bool(obs_flow) or self._live_enabled
        self._clock: Dict[int, float] = {}      # peer -> offset EWMA us
        self._clock_n: Dict[int, int] = {}      # peer -> sample count
        self._clock_rtt: Dict[int, float] = {}  # peer -> best round trip us
        self._clock_stop = threading.Event()
        self._clock_thread: Optional[threading.Thread] = None
        #: wire fast-path counters (plain dict: obs polls it when
        #: telemetry is on, nothing on the hot path otherwise)
        self.wire_stats = {
            "frames_sent": 0, "msgs_sent": 0, "coalesced_msgs": 0,
            "batches": 0, "chunks_sent": 0, "chunk_bytes_sent": 0,
            "frames_compressed": 0, "bytes_precompress": 0,
            "bytes_postcompress": 0, "msgs_chunked": 0,
            # quantized-codec counters: raw vs encoded bytes
            # of lossy-encoded bulk buffers (the labeled COMPRESS_RATIO
            # gauges ride the per-peer twins of these)
            "bufs_quantized": 0, "bytes_prequant": 0, "bytes_postquant": 0,
            # reliable-session counters (RECONNECTS / REPLAYED_FRAMES /
            # DUP_DROPPED gauges ride these)
            "reconnects": 0, "replayed_frames": 0, "dup_dropped": 0,
        }
        super().__init__(_FabricShim(len(endpoints)), rank)
        self.endpoints = endpoints
        self.connect_timeout = connect_timeout
        self.tag_register(TAG_BARRIER, self._on_barrier)

        host, port = endpoints[rank]
        self._listener = socket.create_server((host, port), backlog=len(endpoints))
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"tcp-accept-r{rank}")
        self._accept_thread.start()
        # dial lower ranks (they accept); retry while peers boot
        deadline = time.time() + connect_timeout
        for peer in range(rank):
            self._dial(peer, deadline)
        if self._flow_enabled and self.nb_ranks > 1:
            # clock-alignment sampler: periodic extended pings toward
            # tr-peers so offsets exist even when the heartbeat detector
            # is not installed; the detector's own probes contribute
            # extra samples for free
            self._clock_thread = threading.Thread(
                target=self._clock_loop, daemon=True,
                name=f"tcp-clock-r{rank}")
            self._clock_thread.start()

    # -- connection management ------------------------------------------
    def _dial(self, peer: int, deadline: float) -> None:
        host, port = self.endpoints[peer]
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=2.0)
                break
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {self.rank}: cannot reach rank {peer} at "
                        f"{host}:{port}")
                time.sleep(0.05)
        sock.settimeout(None)  # create_connection left timeout mode on
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(struct.pack("<I", self.rank))
        self._register_conn(peer, sock)

    def _accept_loop(self) -> None:
        try:
            while not self._closing:
                sock, _addr = self._listener.accept()
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # bounded handshake: a stray connection that never sends
                # its rank must not starve accepts from real peers
                sock.settimeout(5.0)
                try:
                    hdr = self._recv_exact(sock, 4)
                except OSError:
                    hdr = None
                if hdr is None:
                    sock.close()
                    continue
                sock.settimeout(None)
                (peer,) = struct.unpack("<I", hdr)
                with self._conn_cond:
                    known = self._peers.get(peer)
                if peer >= self.nb_ranks or peer == self.rank:
                    sock.close()
                    continue
                if known is not None:
                    # a re-dial from a known peer: a session resume when
                    # both ends negotiated "rs" (the peer may have seen
                    # the link fault before we did), else a stray
                    # duplicate that must never displace a real socket.
                    # Handled OFF the accept thread: one peer's slow
                    # handshake (or the thread joins inside the resume)
                    # must not stall every other peer's reconnect past
                    # its budget.
                    threading.Thread(
                        target=self._accept_resume, args=(known, sock),
                        daemon=True,
                        name=f"tcp-resume-r{self.rank}p{peer}").start()
                    continue
                self._register_conn(peer, sock)
        except OSError:
            return  # listener closed during fini

    def _register_conn(self, peer: int, sock: socket.socket) -> None:
        p = _Peer(peer, sock)
        with self._conn_cond:
            self._peers[peer] = p
            self._conn_cond.notify_all()
        p.writer = threading.Thread(
            target=self._writer_loop, args=(p, 0), daemon=True,
            name=f"tcp-send-r{self.rank}p{peer}")
        p.writer.start()
        t = threading.Thread(target=self._recv_loop, args=(p, sock, 0),
                             daemon=True, name=f"tcp-recv-r{self.rank}p{peer}")
        p.recv_thread = t
        t.start()
        with self._conn_cond:
            self._recv_threads.append(t)
        # capability advertisement: the receiving end only ever
        # compresses toward us after seeing this (mixed-version peers
        # never send one and stay on the uncompressed path); "rs" is
        # advertised only when reconnect sessions are enabled locally,
        # so a peer with the knob unset keeps fail-fast on BOTH ends
        info = {"ver": wire.WIRE_VERSION,
                "rank": self.rank,
                "codecs": self._codecs,
                "hb": True,
                "el": True,
                "rs": self._rs_enabled}
        if self._flow_enabled:
            # flow tracing is advertised ONLY when the local knob is
            # set (symmetric like "qz"): a knob-unset build keeps every
            # wire byte — this HELLO included — bit-for-bit, and a peer
            # without it simply never negotiates, so neither trace
            # contexts nor extended pings travel toward it
            info["tr"] = True
        if self._live_enabled:
            # obs_live: extended (pool, send-instant) flow contexts —
            # gated like "tr", so an unset knob's HELLO is bit-identical
            # and obs_flow-only peers keep 2-tuples
            info["lv"] = True
        if self._tune_enabled:
            # runtime tuning: this end accepts K_TUNE codec renegotiation
            # frames — gated like "tr"/"lv" so an unset knob's HELLO stays
            # bit-identical and a peer without it is never renegotiated
            info["tn"] = True
        if self._serve_enabled:
            # multi-tenant serving: this end hosts/uses SessionServer
            # endpoints and accepts tenant-extended flow contexts — gated
            # like "tr"/"lv"/"tn" so an unset knob's HELLO stays
            # bit-identical and a peer without it never sees a 5-tuple or
            # a serve control frame
            info["sv"] = True
        if self._xs_enabled:
            # cross-rank SPMD stages: the advertised value is a
            # per-process random token, not a bare True — the receive
            # side negotiates "xs" only on token EQUALITY, which proves
            # both ranks live in THIS process.  Gated like "sv" so an
            # unset knob's HELLO stays bit-identical
            info["xs"] = _xs_proc_token()
        if self._quantize is not None:
            # quantized codecs are advertised ONLY when the local knob
            # is set — symmetric like "rs", so a knob-unset build keeps
            # every wire byte (this HELLO included) bit-for-bit, and a
            # mixed-version peer (no "qz") negotiates down to lossless
            info["qz"] = wire.available_quant_codecs()
        hello = wire.pack_hello(info)
        with p.cond:
            p.ctrl.append(("frame", hello))
            p.queued_bytes += len(hello)
            p.cond.notify()

    def _peer_to(self, peer: int) -> _Peer:
        with self._conn_cond:
            ok = self._conn_cond.wait_for(lambda: peer in self._peers,
                                          timeout=self.connect_timeout)
            if not ok:
                raise TimeoutError(
                    f"rank {self.rank}: no connection from rank {peer}")
            return self._peers[peer]

    # kept for tests/back-compat: peer -> socket view
    @property
    def _conns(self) -> Dict[int, socket.socket]:
        with self._conn_cond:
            return {r: p.sock for r, p in self._peers.items()}

    def link_bw_mbps(self, peer: int) -> Optional[float]:
        """Send-side bandwidth EWMA toward ``peer`` in MB/s (None until
        a large-enough send has been measured). Feeds the adaptive
        eager/rendezvous cutoff (remote_dep) and the LINK_BW gauges."""
        with self._conn_cond:
            p = self._peers.get(peer)
        return p.bw_mbps if p is not None else None

    # -- clock alignment + flow tracing --------------------------------
    #: EWMA smoothing of the per-peer offset estimate, and the sampler
    #: thread's cadence: a quick burst for fresh links (offsets exist
    #: within ~a second of the HELLO), then a slow steady trickle
    _CLOCK_ALPHA = 0.25
    _CLOCK_BURST = 4
    _CLOCK_BURST_INTERVAL = 0.05
    _CLOCK_INTERVAL = 0.25
    #: a sample folds into the estimate only while its round trip stays
    #: within this factor of the shortest one seen toward the peer: the
    #: midpoint's error is bounded by half the round trip, and a round
    #: trip a busy process stretched (a pong queued behind worker
    #: threads) is the asymmetric kind
    _CLOCK_RTT_FACTOR = 2.0

    def _note_clock(self, peer: int, offset_us: float,
                    rtt_us: Optional[float] = None) -> None:
        with self._stat_lock:
            if rtt_us is not None:
                best = self._clock_rtt.get(peer)
                if best is None or rtt_us < best:
                    self._clock_rtt[peer] = best = rtt_us
                if rtt_us > self._CLOCK_RTT_FACTOR * best:
                    return
            cur = self._clock.get(peer)
            self._clock[peer] = (offset_us if cur is None else
                                 (1 - self._CLOCK_ALPHA) * cur
                                 + self._CLOCK_ALPHA * offset_us)
            self._clock_n[peer] = self._clock_n.get(peer, 0) + 1

    def mesh_local_with(self, peer: int) -> bool:
        """Rank processes never share a CUDA context: the in-process
        fabric's device-to-device handover (inherited from
        LocalCommEngine) must not fire here, or device tensors would be
        pickled inside the message instead of riding the device plane
        or the GET rendezvous."""
        return False

    def clock_offset_us(self, peer: int) -> Optional[float]:
        """NTP-style estimate of ``peer_clock - my_clock`` in µs (the
        ``PARSEC::OBS::CLOCK_OFFSET_US::R<peer>`` gauge; None until a
        clock-extended pong has been measured)."""
        with self._stat_lock:
            off = self._clock.get(peer)
        return None if off is None else round(off, 3)

    def clock_offsets_us(self) -> Dict[int, float]:
        """Every measured per-peer offset — stamped into the trace
        metadata at export so ``obs.merge_trace_docs`` can fuse the
        rank timelines onto one reference clock."""
        with self._stat_lock:
            return {p: round(v, 3) for p, v in self._clock.items()}

    def _clock_loop(self) -> None:
        """Dedicated sampler: one extended ping per tr-peer per tick.
        Rides ``ft_ping`` (ctrl lane, receiver-thread pong), so the
        chaos layer's ``hb=1`` directives shape these probes exactly
        like detector probes."""
        seq = 1 << 24   # distinct range from the detector's seqs
        rounds = 0
        while not self._clock_stop.wait(
                self._CLOCK_BURST_INTERVAL if rounds < self._CLOCK_BURST
                else self._CLOCK_INTERVAL):
            if self._closing or self._ft_silenced:
                return
            rounds += 1
            with self._conn_cond:
                peers = list(self._peers.values())
            for p in peers:
                if not p.tr_ok or p.done or p.rank in self.dead_peers \
                        or p.rank in self.finished_peers:
                    continue
                seq += 1
                try:
                    self.ft_ping(p.rank, seq, time.monotonic_ns())
                except Exception:  # noqa: BLE001 - sampling must not die
                    pass

    def flow_to(self, dst: int) -> bool:
        """Trace contexts travel only toward peers whose HELLO
        advertised ``"tr"`` — a peer without it (or with the knob unset)
        receives byte-identical data-plane traffic."""
        with self._conn_cond:
            p = self._peers.get(dst)
        return p is not None and p.tr_ok

    def live_to(self, dst: int) -> bool:
        """Extended obs_live contexts travel only toward peers whose
        HELLO advertised ``"lv"`` — an obs_flow-only peer keeps
        receiving the plain 2-tuple its unpacking expects."""
        with self._conn_cond:
            p = self._peers.get(dst)
        return p is not None and p.lv_ok

    def serve_to(self, dst: int) -> bool:
        """Tenant-extended serve contexts (and serve control AMs) travel
        only toward peers whose HELLO advertised ``"sv"`` — a live-only
        peer keeps receiving the 4-tuple its unpacking expects."""
        with self._conn_cond:
            p = self._peers.get(dst)
        return p is not None and p.sv_ok

    def xstage_to(self, dst: int, wait_s: float = 5.0) -> bool:
        """Cross-rank SPMD stages may span ``dst`` only when the peer's
        HELLO carried THIS process's "xs" token — both ends run with
        ``stage_compile_xrank`` set AND share this process.  A
        mixed-version or knob-unset peer keeps the activation path.  The
        HELLO is the link's first frame but lands on the receiver
        thread, and the accepting end may not hold the link yet, so a
        caller racing the dial waits (at most ``wait_s`` in all) for
        both: answering from a link or a HELLO not yet seen would
        negotiate DOWN for no reason and leave the peers on different
        plans."""
        deadline = time.time() + wait_s
        with self._conn_cond:
            if self._xs_enabled:
                self._conn_cond.wait_for(lambda: dst in self._peers,
                                         timeout=wait_s)
            p = self._peers.get(dst)
        if p is None:
            return False
        if self._xs_enabled and not p.hello_seen:
            with p.cond:
                while not p.hello_seen:
                    left = deadline - time.time()
                    if left <= 0:
                        break
                    p.cond.wait(min(0.1, left))
        return p.xs_ok

    def compress_ratio(self) -> Optional[float]:
        """Cumulative post/pre compression byte ratio (None: nothing
        was ever compressed)."""
        with self._stat_lock:
            pre = self.wire_stats["bytes_precompress"]
            post = self.wire_stats["bytes_postcompress"]
        return (post / pre) if pre else None

    # -- quantized wire codecs -------------------------------
    def _quant_codec_for(self, peer: _Peer) -> Optional[str]:
        """The quantized codec to apply toward ``peer`` right now:
        None unless the HELLO negotiation succeeded (both knobs set,
        codec common) AND the link sits below the bandwidth-EWMA
        threshold (``comm_quantize_threshold_mbps``; 0 = engage
        whenever the knob is set — the same per-link EWMA policy the
        lossless compressor uses, with an always-on default because
        the knob itself is the lossy opt-in)."""
        with peer.cond:
            codec = peer.qz_codec
        if codec is None:
            return None
        thr = self.quantize_threshold_mbps
        if thr:
            bw = peer.bw_mbps
            if bw is None or bw >= thr:
                return None
        return codec

    def quantize_ratio(self) -> Optional[float]:
        """Cumulative raw/encoded byte RATIO of quantized buffers
        (> 1 = the wire moved fewer bytes; None: nothing quantized)."""
        with self._stat_lock:
            pre = self.wire_stats["bytes_prequant"]
            post = self.wire_stats["bytes_postquant"]
        return (pre / post) if post else None

    def codec_ratio(self, peer: int, codec: str) -> float:
        """Per-link per-codec byte-reduction factor raw/encoded (the
        labeled ``COMPRESS_RATIO::R<peer>::<codec>`` gauge): > 1 once
        that codec engaged on the link, 1.0 while it has not (not
        negotiated, threshold not crossed, or nothing sent yet)."""
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None:
            return 1.0
        ent = wire.CODECS.get(codec)
        with p.cond:
            if ent is not None and not ent.lossless:
                pre, post = ((p.q_pre, p.q_post)
                             if p.qz_codec == codec else (0, 0))
            else:
                pre, post = ((p.comp_pre, p.comp_post)
                             if p.codec == codec else (0, 0))
        return round(pre / post, 4) if post else 1.0

    # -- reliable sessions ----------------------------------------------
    def peer_suspect(self, peer: int) -> bool:
        """True while ``peer``'s link is torn but its session is still
        inside the reconnect budget — the transient-vs-permanent
        distinction consumers park on (prefetch throttling) instead of treating every socket error as death."""
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None:
            return False
        with p.cond:
            return p.suspect

    def suspect_ms(self) -> float:
        """Cumulative milliseconds peers of this rank have spent in
        SUSPECT (completed episodes plus any live one) — the
        COMM::SUSPECT_MS gauge."""
        with self._stat_lock:
            total = self._suspect_ms_total
        now = time.monotonic()
        with self._conn_cond:
            peers = list(self._peers.values())
        for p in peers:
            with p.cond:
                if p.suspect:
                    total += (now - p.suspect_since) * 1e3
        return round(total, 3)

    def _session_suspect(self, p: _Peer, gen: int, reason: str) -> bool:
        """A writer/receiver of connection generation ``gen`` hit a
        socket fault. Returns True when the fault is ABSORBED by the
        session layer (peer parked as SUSPECT, reconnector running —
        or the fault belongs to an already-replaced generation); False
        means no session covers this link and the caller must take the
        fail-fast ``_peer_died`` path."""
        if not self._rs_enabled:
            return False
        with p.cond:
            if p.conn_gen != gen:
                return True   # stale thread of a resumed connection
            if not p.rs_ok or p.done:
                return False
        if self._closing or self._ft_silenced \
                or p.rank in self.dead_peers \
                or p.rank in self.finished_peers:
            return False
        first = False
        with p.cond:
            if not p.suspect:
                p.suspect = True
                p.suspect_since = time.monotonic()
                first = True
            p.cond.notify_all()
        if first:
            # kick the other thread of this generation out of its
            # blocking socket call so both land here (idempotent)
            try:
                p.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                p.sock.close()
            except OSError:
                pass
            plog.warning(
                "tcp rank %d: peer %d SUSPECT (%s) — reconnecting for "
                "up to %.1fs", self.rank, p.rank, reason,
                self.reconnect_timeout)
            threading.Thread(
                target=self._reconnector, args=(p, gen), daemon=True,
                name=f"tcp-reconnect-r{self.rank}p{p.rank}").start()
        return True

    def _reconnector(self, p: _Peer, gen: int) -> None:
        """Drive one SUSPECT episode: the side that originally dialed
        (the higher rank) re-dials with exponential backoff + jitter;
        the accepting side waits passively (``_accept_resume`` does the
        work when the peer's dial lands). Either way the episode is
        bounded by ``comm_reconnect_timeout``: expiry escalates to the
        fail-fast path with ``lost_sends`` (the replay window holds
        accepted frames that will now never be delivered)."""
        import random
        with p.cond:
            deadline = p.suspect_since + self.reconnect_timeout
        delay = self.reconnect_backoff
        rng = random.Random((self.rank << 16) ^ p.rank ^ id(p))
        while True:
            if self._closing or self._ft_silenced \
                    or p.rank in self.dead_peers \
                    or p.rank in self.finished_peers:
                return
            with p.cond:
                if not p.suspect or p.conn_gen != gen or p.done:
                    return   # resumed (or escalated elsewhere)
            now = time.monotonic()
            if now >= deadline:
                with p.cond:
                    if not p.suspect or p.conn_gen != gen or p.done:
                        return
                    p.done = True   # tombstone: no late resume may land
                    p.suspect = False
                    dur_ms = (now - p.suspect_since) * 1e3
                with self._stat_lock:
                    self._suspect_ms_total += dur_ms
                self._peer_died(
                    p.rank,
                    f"reconnect budget exhausted "
                    f"({self.reconnect_timeout:.1f}s)", lost_sends=True)
                return
            ft = self._ft
            link_down = ft is not None and ft.link_down(p.rank)
            if self.rank > p.rank and not link_down:
                try:
                    self._dial_resume(p, gen)
                    return
                except (OSError, ValueError):
                    pass   # next attempt after backoff
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2.0, _RECONNECT_BACKOFF_MAX) \
                * (1.0 + 0.25 * rng.random())

    def _send_frame_direct(self, sock: socket.socket, body: bytes) -> None:
        sock.sendall(struct.pack("<Q", len(body)) + body)

    def _recv_frame_direct(self, sock: socket.socket) -> memoryview:
        hdr = self._recv_exact(sock, 8)
        if hdr is None:
            raise OSError("connection closed during session resume")
        (size,) = struct.unpack("<Q", hdr)
        if size > (1 << 20):
            raise ValueError(f"oversized resume frame ({size} bytes)")
        body = self._recv_exact(sock, size)
        if body is None:
            raise OSError("connection closed during session resume")
        return memoryview(body)

    def _partial_claim_locked(self, p: _Peer) -> Optional[Dict[str, int]]:
        # holds: p.cond
        """The byte-level resume claim for K_RESUME: only a partial
        body that provably is the NEXT expected data frame (a complete
        K_SEQ header with seq == last delivered + 1) can resume
        mid-frame; anything else (truncated header, a torn session-less
        frame) is discarded and the sender replays whole frames."""
        part = p.rs_rx_partial
        if part is None:
            return None
        size, buf = part
        pref = wire.parse_seq_prefix(buf)
        if pref is not None and pref[1] == p.rs_rx_seq + 1 \
                and 0 < len(buf) < size:
            return {"seq": pref[1], "off": len(buf)}
        p.rs_rx_partial = None
        return None

    def _dial_resume(self, p: _Peer, gen: int) -> None:
        """One reconnect attempt from the dialing side; raises
        OSError/ValueError on any failure (the reconnector retries)."""
        host, port = self.endpoints[p.rank]
        sock = socket.create_connection((host, port), timeout=2.0)
        ok = False
        try:
            sock.settimeout(5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(struct.pack("<I", self.rank))
            with p.cond:
                epoch = p.rs_epoch + 1
                info = {"rank": self.rank, "epoch": epoch,
                        "ack": p.rs_rx_seq,
                        "partial": self._partial_claim_locked(p)}
            self._send_frame_direct(sock, wire.pack_resume(info))
            body = self._recv_frame_direct(sock)
            if body[0] != wire.K_RESUME:
                raise ValueError("peer did not answer the session resume")
            reply = wire.parse_resume(body)
            if int(reply.get("epoch", -1)) != epoch:
                raise ValueError("session epoch mismatch at resume")
            sock.settimeout(None)
            self._session_resume(p, sock, epoch, int(reply["ack"]),
                                 reply.get("partial"))
            ok = True
        finally:
            if not ok:
                try:
                    sock.close()
                except OSError:
                    pass

    def _accept_resume(self, p: _Peer, sock: socket.socket) -> None:
        """The accepting half of a session resume (a known peer
        re-dialed us). Anything short of a valid K_RESUME from a
        session-capable peer is a stray duplicate connection and is
        closed, exactly as before."""
        ft = self._ft
        if not (self._rs_enabled and not self._closing) \
                or p.rank in self.dead_peers \
                or p.rank in self.finished_peers \
                or (ft is not None and ft.link_down(p.rank)):
            sock.close()
            return
        with p.cond:
            rs_ok = p.rs_ok and not p.done and not p.rs_resuming
            if rs_ok:
                p.rs_resuming = True
        if not rs_ok:
            sock.close()
            return
        try:
            sock.settimeout(5.0)
            body = self._recv_frame_direct(sock)
            if body[0] != wire.K_RESUME:
                raise ValueError("known peer re-dialed without K_RESUME")
            info = wire.parse_resume(body)
            epoch = int(info["epoch"])
            with p.cond:
                gen = p.conn_gen
                # equal epochs are RESUMABLE, not stale: if our side
                # committed epoch N but the dialer's half of that
                # handshake failed (link tore again around the reply),
                # its retries keep proposing N — rejecting them would
                # dead-end a healthy link until the budget expires.
                # Only a strictly OLDER epoch is a stray duplicate.
                if epoch < p.rs_epoch:
                    raise ValueError("stale session epoch at resume")
            # the peer noticed the fault first: tear our half down too
            # so the old generation's threads exit before the handoff
            if not self._session_suspect(p, gen,
                                         "peer initiated session resume"):
                raise ValueError("session no longer resumable")
            with p.cond:
                reply = {"rank": self.rank, "epoch": epoch,
                         "ack": p.rs_rx_seq,
                         "partial": self._partial_claim_locked(p)}
            self._send_frame_direct(sock, wire.pack_resume(reply))
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._session_resume(p, sock, epoch, int(info["ack"]),
                                 info.get("partial"))
        except (OSError, ValueError) as exc:
            plog.debug.verbose(
                1, "tcp rank %d: resume from peer %d rejected (%s)",
                self.rank, p.rank, exc)
            try:
                sock.close()
            except OSError:
                pass
        finally:
            with p.cond:
                p.rs_resuming = False

    def _session_resume(self, p: _Peer, sock: socket.socket, epoch: int,
                        their_ack: int,
                        their_partial: Optional[Dict[str, int]]) -> None:
        """Install a re-established connection: trim the replay window
        to the peer's cumulative ack, stage the unacked gap (byte-level
        frag of a mid-frame truncation first, then whole frames) for
        the new writer, bump the generation so stale threads stand
        down, and start fresh writer/receiver threads."""
        # the old generation's threads saw their socket die when the
        # suspect transition closed it; wait for them so no stale
        # writer can interleave on the NEW socket (thread joins are
        # blocking — strictly outside every lock)
        old_writer, old_recv = p.writer, p.recv_thread
        for t in (old_writer, old_recv):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=10.0)
                if t.is_alive():  # pragma: no cover - wedged handler
                    raise ValueError("previous connection generation "
                                     "did not exit; resume aborted")
        with p.cond:
            if p.done or p.rank in self.dead_peers:
                raise ValueError("session escalated before resume landed")
            while p.rs_window and p.rs_window[0][0] <= their_ack:
                _seq, _pieces, nb = p.rs_window.popleft()
                p.rs_window_bytes -= nb
            replay: list = []
            entries = list(p.rs_window)
            if entries and their_partial:
                seq0, pieces0, _nb0 = entries[0]
                off = int(their_partial.get("off", 0))
                if int(their_partial.get("seq", -1)) == seq0:
                    body0 = b"".join(bytes(x) for x in pieces0)
                    if 0 < off < len(body0):
                        replay.append([wire.pack_frag(epoch, seq0, off),
                                       body0[off:]])
                        entries = entries[1:]
            for _seq, pieces, _nb in entries:
                replay.append(list(pieces))
            p.rs_replay = replay
            p.rs_epoch = epoch
            p.conn_gen += 1
            gen = p.conn_gen
            p.sock = sock
            p.suspect = False
            dur_ms = (time.monotonic() - p.suspect_since) * 1e3
            nreplay = len(replay)
            p.cond.notify_all()
        with self._stat_lock:
            self.wire_stats["reconnects"] += 1
            self.wire_stats["replayed_frames"] += nreplay
            self._suspect_ms_total += dur_ms
        # a completed resume handshake is proof of life: reset the
        # heartbeat silence baseline so the detector does not evict the
        # peer in the race between the resume and its first fresh pong
        det = self.ft_detector
        if det is not None:
            det.note_alive(p.rank)
        plog.warning(
            "tcp rank %d: session to peer %d RESUMED after %.0f ms "
            "(epoch %d, replaying %d frame(s))", self.rank, p.rank,
            dur_ms, epoch, nreplay)
        p.writer = threading.Thread(
            target=self._writer_loop, args=(p, gen), daemon=True,
            name=f"tcp-send-r{self.rank}p{p.rank}g{gen}")
        p.writer.start()
        t = threading.Thread(
            target=self._recv_loop, args=(p, sock, gen), daemon=True,
            name=f"tcp-recv-r{self.rank}p{p.rank}g{gen}")
        p.recv_thread = t
        t.start()
        # prune dead generations while appending (under the connection
        # lock: concurrent resumes of DIFFERENT peers rebuild this list
        # too): a long soak of flaps must not grow it without bound
        with self._conn_cond:
            self._recv_threads = [x for x in self._recv_threads
                                  if x.is_alive()] + [t]

    # -- liveness / fault tolerance ---------------------------------------
    def ping(self, peer: int, seq: int = 0) -> bool:
        """One heartbeat probe stamped now (``ft_ping``); the pong lands
        the round trip in ``ping_rtt[peer]``. True when a probe left."""
        return self.ft_ping(peer, seq, time.monotonic_ns())

    def ft_ping(self, peer: int, seq: int, t_ns: int) -> bool:
        """Wire-level heartbeat probe (K_PING): enqueued straight onto
        the peer's ctrl lane and answered by the peer's receiver
        thread, so a rank whose workers are all inside long kernels
        still answers. Never sent toward a peer whose HELLO did not
        advertise heartbeat support — a mixed-version peer is never
        probed, so the detector can never (wrongly) declare it dead."""
        if self._ft_silenced or peer in self.dead_peers \
                or peer in self.finished_peers:
            return False
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None or not p.hb_ok or p.done:
            return False
        with p.cond:
            if p.suspect:
                # the link is torn and the session layer owns the
                # verdict: a probe could not leave anyway, and the
                # detector must not count this interval as silence
                return False
        # probe frames bypass _transport_post, so consult the chaos
        # layer here too — ft_inject directives with hb=1 must be able
        # to drop/duplicate heartbeats on this transport as well
        from .engine import TAG_HEARTBEAT
        copies = self.ft_outbound(peer, TAG_HEARTBEAT)
        if copies == 0:
            return False
        # clock-alignment extension: extended pings only toward peers
        # that negotiated "tr" — the responding pong carries the peer's
        # clock, the midpoint-method sample
        frame = wire.pack_ping(seq, t_ns, clock_ns=0 if p.tr_ok else None)
        with p.cond:
            for _ in range(copies):
                p.ctrl.append(("frame", frame))
                p.queued_bytes += len(frame)
            p.cond.notify()
        return True

    def ft_elastic_send(self, peer: int, payload) -> bool:
        """Wire-level elastic membership frame (K_ELASTIC): like
        ``ft_ping``, enqueued on the ctrl lane and delivered by the
        peer's receiver thread — a resize proposal or join announcement
        lands even while every worker is inside a long kernel. Gated on
        the HELLO ``el`` capability: a peer without it is never drawn
        into an agreement it cannot answer. Exempt from the chaos layer
        (control plane, like heartbeats without ``hb=1``); the
        coordinator's resend tick covers real frame loss."""
        if self._ft_silenced or peer in self.dead_peers \
                or peer in self.finished_peers:
            return False
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None or not p.el_ok or p.done:
            return False
        frame = wire.pack_elastic(dict(payload))
        with p.cond:
            p.ctrl.append(("frame", frame))
            p.queued_bytes += len(frame)
            p.cond.notify()
        return True

    # -- closed-loop tuning ----------------------------------------------
    def tune_to(self, dst: int) -> bool:
        """K_TUNE renegotiation frames travel only toward peers whose
        HELLO advertised ``"tn"`` — a peer without it (or with the knob
        unset) keeps the codec its HELLO negotiated, forever."""
        with self._conn_cond:
            p = self._peers.get(dst)
        return p is not None and p.tn_ok

    def tune_send(self, peer: int, payload) -> bool:
        """Wire-level runtime-tuning frame (K_TUNE): like
        ``ft_elastic_send``, enqueued on the ctrl lane and applied by
        the peer's receiver thread — a codec renegotiation lands even
        while the peer's workers are inside a long kernel.  Gated on
        the HELLO ``tn`` capability.  Exempt from the chaos layer
        (control plane); the controller re-decides every window, so a
        lost frame is re-issued by the next tick."""
        if self._ft_silenced or peer in self.dead_peers \
                or peer in self.finished_peers:
            return False
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None or not p.tn_ok or p.done:
            return False
        frame = wire.pack_tune(dict(payload))
        with p.cond:
            p.ctrl.append(("frame", frame))
            p.queued_bytes += len(frame)
            p.cond.notify()
        return True

    def set_quant_codec(self, peer: int, codec: Optional[str]) -> bool:
        """Local half of a codec renegotiation: install ``codec`` (a
        registered quantized codec name, or None for lossless) as THIS
        rank's active encoding toward ``peer``, exactly as if the HELLO
        had negotiated it.  Quantization applies at enqueue, so frames
        already queued (and the replay window) keep the bytes encoded
        under the codec active when they were accepted — a replay stays
        bit-identical across the switch.  Resets the per-codec byte
        accounting so the COMPRESS_RATIO gauge reflects the NEW codec.
        Returns False (no change) toward an unknown peer or a codec
        name that is not registered."""
        if codec is not None and codec not in wire.available_quant_codecs():
            return False
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None:
            return False
        with p.cond:
            if p.qz_codec != codec:
                p.qz_codec = codec
                p.q_pre = 0
                p.q_post = 0
        return True

    def active_quant_codec(self, peer: int) -> Optional[str]:
        """The quantized codec THIS rank currently encodes with toward
        ``peer`` (HELLO-negotiated or runtime-renegotiated)."""
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None:
            return None
        with p.cond:
            return p.qz_codec

    def rx_quant_ratio(self, peer: int) -> Tuple[int, int]:
        """Receive-side quantized-buffer accounting for the inbound
        link from ``peer``: (raw bytes, encoded bytes) of quantized
        buffers that LANDED here.  The controller on the receiving rank
        reads the deltas: an escalated link whose encoded count stops
        moving carries no eligible traffic — the codec shows no win and
        the ladder steps back down."""
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is None:
            return (0, 0)
        with p.cond:
            return (p.qrx_pre, p.qrx_post)

    def _on_tune(self, p: _Peer, msg: Dict[str, Any]) -> None:
        """Apply one runtime-tuning directive from the controller on the
        RECEIVING end of this link (it watches its inbound exposed-wait;
        we hold the actuator — the send-side codec).  Only honored
        between ends that both advertised "tn"; an unknown op or codec
        name is dropped, never fatal."""
        if not (self._tune_enabled and p.tn_ok):
            return
        if msg.get("op") != "codec":
            plog.debug.verbose(
                1, "tcp rank %d: ignoring unknown tune op %r from "
                "peer %d", self.rank, msg.get("op"), p.rank)
            return
        codec = msg.get("codec")
        if not self.set_quant_codec(p.rank, codec):
            plog.warning(
                "tcp rank %d: peer %d requested unknown quantized "
                "codec %r — keeping %r", self.rank, p.rank, codec,
                self.active_quant_codec(p.rank))

    def ft_link_fault(self, dst: int) -> None:
        """Chaos hook (ft/inject.py ``flap:``/``disconnect:``): tear
        this rank's socket(s) to every peer the injector marked
        link-down (always including ``dst``, the triggering send's
        target) WITHOUT killing the process — both ends see a torn
        connection, which is a SUSPECT transition under a session and
        instant death without one.

        The tear is a WRITE-half shutdown, not a close: the next local
        write fails at once (the triggering frame — enqueued right
        after this hook — is picked up by the writer, retained in the
        replay window, and its send fails, so a session flap provably
        exercises the replay path), the peer sees EOF and parks its own
        half, and the suspect/death transition closes the socket
        fully."""
        ft = self._ft
        with self._conn_cond:
            peers = list(self._peers.values())
        for p in peers:
            if p.rank != dst and not (ft is not None
                                      and ft.link_down(p.rank)):
                continue
            try:
                p.sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def ft_silence(self) -> None:
        """Injected kill: beyond the base flag, wake every writer so it
        exits WITHOUT flushing its queue — a real SIGKILL drops queued
        frames, and survivors must not observe a message sequence that
        is impossible under a real crash."""
        super().ft_silence()
        with self._conn_cond:
            peers = list(self._peers.values())
        for p in peers:
            with p.cond:
                p.cond.notify_all()

    def report_peer_failure(self, peer: int, reason: str) -> None:
        """Uniform failure funnel (base-class API): a proactive
        (heartbeat) eviction is unconditional — the peer is SILENT, so
        unlike a torn connection there is no may-have-finished
        ambiguity for the reporting policy to weigh."""
        self._peer_died(peer, reason, lost_sends=True)

    def peer_finished(self, peer: int) -> bool:
        return peer in self.finished_peers

    # -- send path ------------------------------------------------------
    def send_am(self, dst: int, tag: int, payload: Any) -> None:
        # remote sends serialize via pickle (its own copy); only loopback
        # needs the anti-aliasing wire copy the local fabric applies
        if dst == self.rank:
            payload = _wire_copy(payload)
        obs = self._obs
        ctx = None
        if self._flow is not None or self._flow_enabled:
            # _flow_enabled without an armed allocator (knob on,
            # telemetry off): the stamp declines but still STRIPS a
            # re-forwarded inbound "_tr" — this rank advertised "tr",
            # so upstream contexts reach it and must not leak onward
            payload, ctx = self._flow_stamp(dst, tag, payload)
        if obs is None:
            self._transport_post(dst, self.rank, tag, payload)
            return
        t0 = time.monotonic_ns()
        self._transport_post(dst, self.rank, tag, payload)
        obs.am_sent(self.rank, dst, tag, payload, t0)
        if ctx is not None:
            obs.flow_sent(dst, tag, ctx, t0)

    def _transport_post(self, dst: int, src: int, tag: int,
                        payload: Any) -> None:
        copies = self.ft_outbound(dst, tag)
        if copies <= 0:
            return
        self._transport_post_live(dst, src, tag, payload)
        if copies <= 1:
            return
        # injected duplicate: on a session link the duplicate happens
        # at the WIRE level (same frame, same seq — the receiver's
        # seq dedup must keep the AM exactly-once); without a session
        # it stays a double post, the historical deliver-twice chaos
        rs = False
        if dst != self.rank:
            with self._conn_cond:
                p = self._peers.get(dst)
            if p is not None:
                with p.cond:
                    rs = p.rs_ok
                    if rs:
                        p.rs_dup_next = True
        if not rs:
            for _ in range(copies - 1):
                self._transport_post_live(dst, src, tag, payload)

    def _transport_post_live(self, dst: int, src: int, tag: int,
                             payload: Any) -> None:
        self._check_live(dst)
        if dst == self.rank:
            with self._stat_lock:
                self.fabric.msg_count += 1
            self._inbox.push((src, tag, payload))
            self._notify_arrival()
            return
        # protocol-5 out-of-band pickling: ndarray payloads are NOT
        # serialized into the frame — their buffers are collected as
        # views. Buffers below the chunk threshold are COPIED into the
        # queued segment here, on the caller's thread (the historical
        # copy-at-send snapshot semantics: inline activation payloads
        # may be mutated by a local successor right after this call
        # returns). Buffers >= the threshold stream as chunks; they
        # stay zero-copy ONLY when provably immutable (a read-only
        # buffer export — the rendezvous producers mark their
        # snapshots so), else they too are copied at enqueue: the
        # writer drains asynchronously, and a live host tile mutated
        # after send_am returns must not tear on the wire. A torch
        # tensor anywhere in the payload raises TypeError here.
        raw_bufs: list = []
        frame = wire.dumps_message((src, tag, payload), protocol=5,
                                   buffer_callback=raw_bufs.append)
        try:
            views = [b.raw() for b in raw_bufs]
        except BufferError:
            # a custom buffer-exporting type emitted a discontiguous
            # PickleBuffer (numpy in-bands those itself): fall back to
            # fully in-band pickling for this message
            frame = wire.dumps_message((src, tag, payload), protocol=4)
            views = []
        nbytes = len(frame) + sum(v.nbytes for v in views)
        with self._stat_lock:
            self.fabric.msg_count += 1
            self.fabric.bytes_count += nbytes
        peer = self._peer_to(dst)
        chunk = self.chunk_bytes
        if all(v.nbytes < chunk for v in views):
            seg = wire.pack_segment(frame, views)  # copies the views
            with peer.cond:
                self._backpressure_wait(peer, dst, len(seg))
                peer.ctrl.append(("msg", seg))
                peer.queued_bytes += len(seg)
                peer.cond.notify()
            return
        # chunked path: the header (pickle + small buffers) leads the
        # BULK lane, followed by each large buffer as bounded chunk
        # frames — the hdr-before-first-chunk invariant is structural
        # (bulk is FIFO), never a property of lane priorities.
        with self._stat_lock:
            self._xfer_iter += 1
            xid = (self.rank << 40) | self._xfer_iter
            self.wire_stats["msgs_chunked"] += 1
        # quantized wire codec: a bulk FLOAT buffer of a
        # message the sender layer marked eligible (``_qz_ok`` on the
        # payload dict — tile payloads only; control AMs and lossless
        # flows never carry the mark) encodes lossily HERE, at enqueue
        # — before the K_SEQ envelope, so the replay window retains the
        # encoded bytes and a post-flap replay stays bit-identical.
        q_codec = self._quant_codec_for(peer) if (
            isinstance(payload, dict) and payload.get("_qz_ok")) else None
        qfmts = [None] * len(raw_bufs)
        if q_codec is not None:
            for i, b in enumerate(raw_bufs):
                try:
                    qfmts[i] = memoryview(b).format
                except (BufferError, TypeError):  # pragma: no cover
                    qfmts[i] = None
        specs: list = []
        chunked_views: Dict[int, Any] = {}
        q_pre = q_post = q_bufs = 0
        for bidx, v in enumerate(views):
            if v.nbytes < chunk:
                specs.append((0, v.nbytes, v))
                continue
            if q_codec is not None and qfmts[bidx] in ("d", "f"):
                # fresh encoded bytes: immutable by construction, no
                # snapshot needed whatever the source's writability
                enc = memoryview(wire.quantize_buffer(
                    v, qfmts[bidx], q_codec))
                q_pre += v.nbytes
                q_post += enc.nbytes
                q_bufs += 1
                specs.append((wire.BUF_CHUNKED | wire.BUF_QUANT,
                              enc.nbytes, None))
                chunked_views[bidx] = enc
                continue
            if not v.readonly:
                v = memoryview(bytes(v))   # snapshot mutable bulk now
            specs.append((wire.BUF_CHUNKED, v.nbytes, None))
            chunked_views[bidx] = v
        if q_pre:
            with self._stat_lock:
                self.wire_stats["bufs_quantized"] += q_bufs
                self.wire_stats["bytes_prequant"] += q_pre
                self.wire_stats["bytes_postquant"] += q_post
            with peer.cond:
                peer.q_pre += q_pre
                peer.q_post += q_post
        hdr = wire.pack_xfer_hdr(xid, frame, specs)
        items = [("frame", hdr)]
        qbytes = len(hdr)
        for bidx, v in sorted(chunked_views.items()):
            for off in range(0, v.nbytes, chunk):
                items.append(("chunk", xid, bidx, off,
                              v[off:off + chunk]))
                qbytes += min(chunk, v.nbytes - off)
        with peer.cond:
            self._backpressure_wait(peer, dst, qbytes)
            peer.bulk.extend(items)
            peer.queued_bytes += qbytes
            peer.cond.notify()

    def _check_live(self, dst: int) -> None:
        if dst in self.dead_peers:
            raise RankFailedError(dst, "send to failed rank")
        if dst in self.finished_peers:
            raise RankFailedError(dst, "send to peer after its clean shutdown")

    def _backpressure_wait(self, peer: _Peer, dst: int,
                           nbytes: int) -> None:  # holds: peer.cond
        """Bounded send buffer (call with ``peer.cond`` held): block
        while the peer's queued bytes would exceed
        ``comm_send_buffer_bytes`` — the v1 synchronous-sendall
        backpressure with a buffer instead of O(one message), so a
        producer outpacing a slow link stalls instead of queueing an
        epoch's traffic in RAM. A message larger than the whole buffer
        is admitted alone into an empty queue. Aborts with
        RankFailedError when the peer dies while we wait."""
        limit = self.send_buffer_bytes
        # the replay window's retained (sent-but-unacked) bytes count
        # against the same budget: a flapping link's unacked backlog
        # spills into backpressure instead of unbounded RAM. The escape
        # for an oversized message keys on UNSENT bytes only, so a
        # residue of lazily-acked frames cannot park a producer forever.
        while peer.queued_bytes > 0 \
                and peer.queued_bytes + peer.rs_window_bytes \
                + nbytes > limit:
            self._check_live(dst)
            if peer.done:
                raise RankFailedError(dst, "send to failed rank")
            peer.cond.wait(0.1)
        self._check_live(dst)

    # -- writer thread --------------------------------------------------
    def _writer_can_data_locked(self, peer: _Peer) -> bool:
        # holds: peer.cond
        """May a DATA frame (batch / transfer header / chunk) leave
        right now? Not before capabilities are known when sessions are
        enabled locally (an unwrapped frame could never be replayed),
        and not while the replay window is at its byte cap (the window
        drains as the peer's cumulative acks arrive)."""
        if self._rs_enabled and not peer.hello_seen \
                and time.monotonic() - peer.connected_at < _HELLO_GRACE:
            return False
        if peer.rs_ok and peer.rs_window_bytes > 0 \
                and peer.rs_window_bytes >= self.replay_window_bytes:
            return False
        return True

    def _writer_ready_locked(self, peer: _Peer, gen: int) -> bool:
        # holds: peer.cond
        if peer.conn_gen != gen or peer.suspect:
            return True
        if peer.rank in self.dead_peers or self._ft_silenced:
            return True
        if peer.rs_replay:
            return True
        # session-less control frames (hello, pong, ack) stay
        # sendable even while data is gated — an ack-starved window on
        # BOTH ends would otherwise deadlock waiting for each other's
        # acks to drain through the blocked data lane
        if any(it[0] == "frame" for it in peer.ctrl):
            return True
        if (peer.ctrl or peer.bulk) and self._writer_can_data_locked(peer):
            return True
        return bool(peer.goodbye and not peer.ctrl and not peer.bulk)

    def _writer_loop(self, peer: _Peer, gen: int) -> None:
        """Drain one peer's queues: coalesce ctrl messages into batch
        frames (one syscall each), interleave one bulk chunk whenever
        the ctrl lane is idle, send the GOODBYE sentinel last. With a
        negotiated session, data frames are wrapped in a K_SEQ envelope
        and retained in the replay window until the peer acks them; a
        resume stages the unacked gap in ``rs_replay``, which the next
        writer generation sends before anything new."""
        coalesce = self.coalesce_max_bytes
        ctrl_streak = 0
        handoff = False   # SUSPECT/stale exit: queues + window survive
        try:
            while True:
                pieces: Optional[List[Any]] = None
                nmsgs = 0
                deq_bytes = 0
                is_goodbye = False
                sequenced = False
                replaying = False
                with peer.cond:
                    while not self._writer_ready_locked(peer, gen):
                        # timed wait ONLY while a clock-based gate is
                        # live (the pre-HELLO grace); every other gate
                        # change (enqueue, ack, suspect, resume, death)
                        # notifies — the default config keeps the
                        # wake-on-notify idle behavior
                        peer.cond.wait(
                            0.1 if self._rs_enabled
                            and not peer.hello_seen else None)
                    if peer.conn_gen != gen or peer.suspect:
                        handoff = True
                        return   # a resume (or the receiver's fault)
                        #          replaced this generation: the state
                        #          lives on for the next writer
                    if peer.rank in self.dead_peers or self._ft_silenced:
                        return   # _peer_died/ft_silence notified us:
                        #          stop (finally drops whatever is
                        #          still queued — a crash sends nothing)
                    if peer.rs_replay:
                        pieces = peer.rs_replay.pop(0)
                        replaying = True
                    elif peer.goodbye and not peer.ctrl and not peer.bulk:
                        # handled BEFORE the data gate: the sentinel is
                        # not a data frame, and waiting out a closed
                        # gate here would spin the thread hot
                        is_goodbye = True
                    else:
                        can_data = self._writer_can_data_locked(peer)
                        if not can_data:
                            idx = next((i for i, it in enumerate(peer.ctrl)
                                        if it[0] == "frame"), None)
                            if idx is None:
                                continue   # raced the gate: re-wait
                            body = peer.ctrl[idx][1]
                            del peer.ctrl[idx]
                            pieces = [body]
                            deq_bytes = len(body)
                            ctrl_streak = (ctrl_streak + 1
                                           if peer.bulk else 0)
                        else:
                            take_ctrl = bool(peer.ctrl) and (
                                not peer.bulk
                                or ctrl_streak < _CTRL_STREAK_MAX)
                            if take_ctrl:
                                kind = peer.ctrl[0][0]
                                if kind == "msg":
                                    segs = [peer.ctrl.popleft()[1]]
                                    total = len(segs[0])
                                    while (peer.ctrl
                                           and peer.ctrl[0][0] == "msg"
                                           and len(segs) < _MAX_BATCH_MSGS
                                           and total + len(peer.ctrl[0][1])
                                           <= coalesce):
                                        seg = peer.ctrl.popleft()[1]
                                        segs.append(seg)
                                        total += len(seg)
                                    pieces = wire.pack_batch(segs)
                                    nmsgs = len(segs)
                                    deq_bytes = total
                                    sequenced = peer.rs_ok
                                else:  # standalone frame (hello, pong)
                                    body = peer.ctrl.popleft()[1]
                                    pieces = [body]
                                    deq_bytes = len(body)
                                # the streak only counts ctrl frames sent
                                # WHILE bulk was waiting (the starvation
                                # being bounded)
                                ctrl_streak = (ctrl_streak + 1
                                               if peer.bulk else 0)
                            elif peer.bulk:
                                item = peer.bulk.popleft()
                                ctrl_streak = 0
                                sequenced = peer.rs_ok
                                if item[0] == "frame":  # chunked-xfer hdr
                                    pieces = [item[1]]
                                    deq_bytes = len(item[1])
                                else:
                                    _k, xid, bidx, off, view = item
                                    pieces = [wire.pack_chunk_hdr(
                                        xid, bidx, off), view]
                                    deq_bytes = view.nbytes
                                    with self._stat_lock:
                                        self.wire_stats["chunks_sent"] += 1
                                        self.wire_stats[
                                            "chunk_bytes_sent"] += \
                                            view.nbytes
                            else:  # raced both queues away: re-wait
                                continue
                if is_goodbye:
                    try:
                        peer.sock.sendall(struct.pack("<Q", GOODBYE))
                    except OSError:
                        pass
                    return
                if not replaying:
                    pieces = self._maybe_compress(peer, pieces)
                    # release the backpressure budget BEFORE the send:
                    # a sequenced frame's bytes move to the replay-
                    # window accounting (still backpressure-counted via
                    # rs_window_bytes), and a send that FAILS into the
                    # SUSPECT path must not strand its bytes in
                    # queued_bytes forever (the replay re-sends with
                    # deq_bytes already released)
                    with peer.cond:
                        if sequenced:
                            # number the frame and retain it (post-
                            # compression, so a replay is byte-
                            # identical) until the peer's cumulative
                            # ack releases it
                            peer.rs_tx_seq += 1
                            pieces = [wire.pack_seq(peer.rs_epoch,
                                                    peer.rs_tx_seq)] \
                                + list(pieces)
                            peer.rs_window.append(
                                (peer.rs_tx_seq, pieces, deq_bytes))
                            peer.rs_window_bytes += deq_bytes
                        peer.queued_bytes -= deq_bytes
                        peer.cond.notify_all()
                body_len = sum(len(p) if isinstance(p, (bytes, bytearray))
                               else p.nbytes for p in pieces)
                t0 = time.monotonic()
                _sendall_vec(peer.sock,
                             [struct.pack("<Q", body_len)] + pieces)
                dt = time.monotonic() - t0
                if sequenced:
                    with peer.cond:
                        dup = peer.rs_dup_next
                        peer.rs_dup_next = False
                    if dup:  # injected wire-level duplicate (same seq)
                        _sendall_vec(peer.sock,
                                     [struct.pack("<Q", body_len)] + pieces)
                if body_len >= _BW_SAMPLE_MIN and dt > 0:
                    inst = body_len / dt / 1e6
                    peer.bw_mbps = (inst if peer.bw_mbps is None else
                                    (1 - _BW_ALPHA) * peer.bw_mbps
                                    + _BW_ALPHA * inst)
                with self._stat_lock:
                    peer.frames += 1
                    self.wire_stats["frames_sent"] += 1
                    if nmsgs:
                        self.wire_stats["msgs_sent"] += nmsgs
                        self.wire_stats["batches"] += 1
                        if nmsgs > 1:
                            self.wire_stats["coalesced_msgs"] += nmsgs
        except OSError as exc:
            # with a negotiated session the fault is TRANSIENT until
            # proven otherwise: park the peer as SUSPECT (queues and
            # replay window intact — the frame that just failed is
            # unacked and will be replayed) and let the reconnector
            # decide. Without one, the send side can see the crash
            # before the receiver thread does — later sends raise
            # RankFailedError via dead_peers. send_am already returned
            # for the frame that just failed (and anything still
            # queued): an ACCEPTED send was LOST, so the death is
            # reported to the runtime unconditionally (lost_sends) —
            # the v1 path raised RankFailedError to the caller here, and
            # a silent drop would trade that loud abort for a termdet
            # hang.
            if self._session_suspect(peer, gen, f"send failed: {exc}"):
                handoff = True
                return
            self._peer_died(peer.rank, f"send failed: {exc}",
                            lost_sends=True)
        finally:
            if not handoff:
                peer.done = True
                with peer.cond:
                    dropped = len(peer.ctrl) + len(peer.bulk)
                    peer.ctrl.clear()
                    peer.bulk.clear()
                    peer.queued_bytes = 0
                    peer.rs_window.clear()
                    peer.rs_window_bytes = 0
                    peer.rs_replay = []
                    peer.cond.notify_all()
                if dropped and not self._closing and not self._ft_silenced:
                    plog.warning(
                        "tcp rank %d: dropped %d queued frame(s)/chunk(s) "
                        "to dead peer %d", self.rank, dropped, peer.rank)

    def _maybe_compress(self, peer: _Peer, pieces: List[Any]) -> List[Any]:
        """Engage per-link compression when (a) the peer advertised a
        common codec, (b) the measured bandwidth EWMA sits below the
        MCA threshold (default 0 = never), and (c) a sample probe shows
        the traffic actually compresses. Re-probes periodically so a
        shift to incompressible payloads backs off."""
        threshold = self.compress_threshold_mbps
        codec = peer.codec
        if not threshold or codec is None:
            return pieces
        bw = peer.bw_mbps
        if bw is None or bw >= threshold:
            return pieces
        body_len = sum(len(p) if isinstance(p, (bytes, bytearray))
                       else p.nbytes for p in pieces)
        if body_len < _COMP_MIN_BYTES:
            return pieces
        probing = (peer.probe_ratio is None
                   or peer.frames % _PROBE_EVERY == 0)
        if not probing and not peer.engaged:
            return pieces   # before the join: no copy between probes
        body = b"".join(bytes(p) for p in pieces)
        out = wire.compress_body(body, codec)
        if probing:
            # the probe IS this frame's compression — measured once,
            # reused as the payload when it engages
            peer.probe_ratio = (sum(len(p) for p in out) / len(body)
                                if out is not None else 1.0)
            peer.engaged = peer.probe_ratio <= _PROBE_RATIO
            if not peer.engaged:
                return pieces
        if out is None:
            return pieces
        post = sum(len(p) for p in out)
        with self._stat_lock:
            self.wire_stats["frames_compressed"] += 1
            self.wire_stats["bytes_precompress"] += len(body)
            self.wire_stats["bytes_postcompress"] += post
        with peer.cond:   # per-peer twin: the labeled ratio gauge
            peer.comp_pre += len(body)
            peer.comp_post += post
        return out

    # -- receive path ---------------------------------------------------
    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    @staticmethod
    def _recv_body(sock: socket.socket, n: int) -> Tuple[bytearray, bool]:
        """Read one frame body, KEEPING whatever landed when the
        connection tears mid-frame: (bytes so far, complete?). The
        partial body seeds the session layer's byte-level resume claim
        instead of being discarded (a torn multi-MB chunk resumes at
        the truncation offset, not from byte 0)."""
        buf = bytearray()
        try:
            while len(buf) < n:
                chunk = sock.recv(n - len(buf))
                if not chunk:
                    return buf, False
                buf += chunk
        except OSError:
            return buf, False
        return buf, True

    def _note_get_reply(self, tag: int, payload: Any) -> None:
        """Receiver-thread bookkeeping for the GOODBYE verdict: record
        which outstanding GET tokens have their reply ARRIVED (parked
        in the inbox, waiting for a worker to pump progress()).  A
        token still owed at GOODBYE with no arrived reply provably
        never got one — frames are FIFO, the sentinel is the stream's
        last — so the verdict need not wait for it."""
        if tag != TAG_GET_DATA:
            return
        items = payload.get("items") if isinstance(payload, dict) else None
        if not items:
            return
        with self._lock:
            for item in items:
                self._rx_get_tokens.add(item["token"])
            # consumed tokens left _get_cbs — prune so the set tracks
            # only the in-flight window, not the engine's lifetime
            self._rx_get_tokens.intersection_update(self._get_cbs)

    def _await_owed_gets(self, peer: int, timeout: float = 30.0) -> None:
        """Park this receiver thread (it has nothing left to read —
        the GOODBYE sentinel is the stream's last frame) until the
        workers CONSUME every outstanding GET toward ``peer`` whose
        reply already arrived, or the budget expires.  Returns at once
        when some owed token has no arrived reply: that reply provably
        never left the peer (frames are FIFO), so the peer is a
        definite failure and the verdict must not stall on it.  The
        arrived replies were pushed with an arrival notification, so a
        parked worker is already waking to consume them."""
        deadline = time.monotonic() + timeout
        while not self._closing and peer not in self.dead_peers:
            with self._lock:
                owed = [t for t, s in self._get_srcs.items() if s == peer]
                arrived = all(t in self._rx_get_tokens for t in owed)
            if not owed:
                return
            if not arrived or time.monotonic() >= deadline:
                return
            time.sleep(0.001)

    def _recv_fault(self, p: _Peer, gen: int, reason: str) -> None:
        """A receiver-side connection fault: absorbed as SUSPECT when a
        session covers the link, fail-fast ``_peer_died`` otherwise."""
        if self._session_suspect(p, gen, reason):
            return   # rx state (seq, partial, half-landed transfers)
            #          survives for the resume
        self._peer_died(p.rank, reason)
        with self._stat_lock:
            self._rx_pending.pop(p.rank, None)

    def _recv_loop(self, p: _Peer, sock: socket.socket, gen: int) -> None:
        peer = p.rank
        try:
            while True:
                hdr = self._recv_exact(sock, 8)
                if hdr is None:
                    self._recv_fault(p, gen, "peer closed the connection")
                    return
                (size,) = struct.unpack("<Q", hdr)
                if size == GOODBYE:
                    # a clean shutdown is honored only after the
                    # rendezvous replies the peer already delivered are
                    # CONSUMED: frames are FIFO, so every reply to a
                    # served GET precedes this sentinel in this very
                    # stream and is parked in the inbox — but
                    # _get_srcs is only cleared when a worker pumps
                    # progress(), so the verdict below would race the
                    # delivery it is checking for.  (An incomplete
                    # chunked transfer is different: its missing bytes
                    # provably never left, no point waiting.)
                    with p.cond:
                        mid_xfer = bool(p.rx_xfers)
                    if not mid_xfer:
                        self._await_owed_gets(peer)
                    with self._lock:
                        owes_us = peer in self._get_srcs.values()
                    with p.cond:
                        owes_us = owes_us or bool(p.rx_xfers)
                    if owes_us:
                        # "clean" exit while owing rendezvous data or
                        # mid-chunked-transfer is a protocol violation —
                        # treat as a failure
                        self._peer_died(
                            peer, "shut down owing rendezvous data")
                        with self._stat_lock:
                            self._rx_pending.pop(peer, None)
                        return
                    # orderly shutdown: the peer fini'd after completing
                    # its work — not a failure, no scary warnings
                    self.finished_peers.add(peer)
                    return
                buf, complete = self._recv_body(sock, size)
                if not complete:
                    with p.cond:
                        # record WHERE the truncation happened — the
                        # resume claim lets the sender continue this
                        # frame from the landed offset (K_FRAG)
                        p.rs_rx_partial = (size, buf) if buf else None
                    self._recv_fault(
                        p, gen, f"connection truncated mid-frame "
                                f"({len(buf)}/{size} bytes)")
                    return
                # read-only view, zero copy: reconstructed arrays alias
                # the received body and must not be host-mutable
                self._dispatch_body(p, memoryview(buf).toreadonly())
        except OSError as exc:
            self._recv_fault(p, gen, f"socket error: {exc}")
            return
        except Exception as exc:  # frame desync / unpickle failure: a
            # silent receiver death would hang both ranks — make it loud
            # (never SUSPECT: a protocol violation is not transient)
            self._peer_died(peer, f"receiver died: {exc!r}")
            with self._stat_lock:
                self._rx_pending.pop(peer, None)
            return

    def _dispatch_body(self, p: _Peer, body: memoryview) -> None:
        if self._ft_silenced:
            return   # injected kill: inbound traffic is never delivered
        peer = p.rank
        xfers = p.rx_xfers
        kind = body[0]
        if kind == wire.K_BATCH:
            for frame, bufs in wire.parse_batch(body):
                # out-of-band buffers alias the received body (zero
                # extra copy); arrays reconstructed over them are
                # read-only — host mutators copy-on-write via
                # Data.materialize_host
                src, tag, payload = wire.load_message(frame, bufs)
                self._note_get_reply(tag, payload)
                self._inbox.push((src, tag, payload))
                self._notify_arrival()  # wake a parked worker now
        elif kind == wire.K_XFER_HDR:
            xid, frame, specs = wire.parse_xfer_hdr(body)
            rx = wire.RxXfer(frame, specs)
            if rx.remaining <= 0:
                src, tag, payload = rx.message()
                self._note_get_reply(tag, payload)
                self._inbox.push((src, tag, payload))
                self._notify_arrival()
                return
            xfers[xid] = rx
            with self._stat_lock:
                self._rx_pending[peer] = len(xfers)
        elif kind == wire.K_CHUNK:
            xid, bidx, off, data = wire.parse_chunk(body)
            rx = xfers.get(xid)
            if rx is None:
                raise ValueError(f"chunk for unknown transfer {xid}")
            if rx.feed(bidx, off, data):
                del xfers[xid]
                with self._stat_lock:
                    self._rx_pending[peer] = len(xfers)
                if any(rx.quant):
                    # controller evidence: how many raw bytes this
                    # link's quantized buffers stood for vs the encoded
                    # bytes that actually landed
                    pre = post = 0
                    for b, q in zip(rx.bufs, rx.quant):
                        if q:
                            pre += wire.quant_raw_len(b)
                            post += len(b)
                    with p.cond:
                        p.qrx_pre += pre
                        p.qrx_post += post
                src, tag, payload = rx.message()
                self._note_get_reply(tag, payload)
                self._inbox.push((src, tag, payload))
                self._notify_arrival()
        elif kind == wire.K_HELLO:
            info = wire.parse_hello(body)
            p.codec = wire.negotiate_codec(
                self._codecs, info.get("codecs", ()))
            p.hb_ok = bool(info.get("hb"))
            p.el_ok = bool(info.get("el"))
            # flow tracing negotiates SYMMETRICALLY like "rs": both
            # ends must run with obs_flow set or neither stamps
            p.tr_ok = bool(info.get("tr")) and self._flow_enabled
            # obs_live's extended contexts are symmetric the same way
            p.lv_ok = bool(info.get("lv")) and self._live_enabled
            # runtime tuning is symmetric too: only a link whose BOTH
            # ends run with tune_auto ever renegotiates its codec
            p.tn_ok = bool(info.get("tn")) and self._tune_enabled
            # serving is symmetric the same way: tenant-extended flow
            # contexts (and serve control AMs) travel only on links
            # whose BOTH ends run with the serve knob set
            p.sv_ok = bool(info.get("sv")) and self._serve_enabled
            # "xs" negotiates on token EQUALITY, not truthiness: equal
            # tokens prove the peer lives in THIS process; a separate-
            # process, mixed-version or knob-unset peer never matches
            p.xs_ok = (self._xs_enabled
                       and info.get("xs") == _xs_proc_token())
            with p.cond:
                # quantize capability is symmetric like "rs": only a
                # peer that advertised the requested codec under "qz"
                # ever receives quantized buffers
                p.qz_codec = wire.negotiate_quant_codec(
                    self._quantize, info.get("qz", ()))
                # session capability is SYMMETRIC: both ends must run
                # with the knob set, or neither retains/replays
                p.rs_ok = bool(info.get("rs")) and self._rs_enabled
                p.hello_seen = True
                p.cond.notify_all()   # the writer may be holding data
        elif kind == wire.K_SEQ:
            # session data frame: deliver IN ORDER exactly once — a
            # replayed frame the old connection already delivered is
            # dropped here by seq, so no active message ever runs twice
            _epoch, seq, inner = wire.parse_seq(body)
            deliver = False
            with p.cond:
                if seq <= p.rs_rx_seq:
                    pass   # duplicate from a replay overlap
                elif seq != p.rs_rx_seq + 1:
                    raise ValueError(
                        f"session desync: frame seq {seq} after "
                        f"{p.rs_rx_seq}")
                else:
                    p.rs_rx_seq = seq
                    p.rs_rx_partial = None
                    deliver = True
                    p.rs_rx_unacked_frames += 1
                    p.rs_rx_unacked_bytes += len(body)
                    if p.rs_rx_unacked_frames >= _ACK_EVERY_FRAMES \
                            or p.rs_rx_unacked_bytes >= self._ack_bytes:
                        ack = wire.pack_ack(p.rs_epoch, seq)
                        p.rs_rx_unacked_frames = 0
                        p.rs_rx_unacked_bytes = 0
                        p.ctrl.append(("frame", ack))
                        p.queued_bytes += len(ack)
                        p.cond.notify()
            if not deliver:
                with self._stat_lock:
                    self.wire_stats["dup_dropped"] += 1
                return
            self._dispatch_body(p, inner)
        elif kind == wire.K_ACK:
            # cumulative delivery ack: release the replay window (and
            # the backpressure budget the retained bytes counted
            # against) up to the acked seq
            _epoch, seq = wire.parse_ack(body)
            with p.cond:
                while p.rs_window and p.rs_window[0][0] <= seq:
                    _seq, _pieces, nb = p.rs_window.popleft()
                    p.rs_window_bytes -= nb
                p.cond.notify_all()
        elif kind == wire.K_FRAG:
            # byte-level resume of the frame the link tore mid-body:
            # stitch our kept partial + the sender's remainder, then
            # dispatch the whole as the K_SEQ frame it always was
            _epoch, seq, offset, data = wire.parse_frag(body)
            with p.cond:
                part = p.rs_rx_partial
                if seq <= p.rs_rx_seq:
                    part = None   # somehow already delivered: dup
                elif part is None or len(part[1]) != offset:
                    raise ValueError(
                        f"frag resume mismatch: offset {offset}, held "
                        f"{len(part[1]) if part else 'no'} partial bytes")
                else:
                    full = bytes(part[1]) + bytes(data)
                    if len(full) != part[0]:
                        raise ValueError(
                            f"frag resume size mismatch: {len(full)} != "
                            f"{part[0]}")
                    p.rs_rx_partial = None
            if part is None:
                with self._stat_lock:
                    self.wire_stats["dup_dropped"] += 1
                return
            self._dispatch_body(p, memoryview(full))
        elif kind == wire.K_PING:
            # answered HERE, on the receiver thread (like K_HELLO): a
            # rank whose workers are all stuck in a long kernel still
            # proves liveness — the detector judges the TRANSPORT, not
            # the progress cadence
            seq, t_ns = wire.parse_ping(body)
            det = self.ft_detector
            if det is not None:
                det.note_alive(peer)
            if not p.done:
                # an EXTENDED ping requests clock alignment: the pong
                # echoes (seq, t_ns) and stamps THIS rank's monotonic
                # clock in the trailing word — only in answer to an
                # extension only tr-enabled peers send, so pongs toward
                # other peers stay byte-identical
                ext = wire.ping_clock(body)
                pong = wire.pack_ping(
                    seq, t_ns, pong=True,
                    clock_ns=(time.monotonic_ns()
                              if ext is not None else None))
                with p.cond:
                    p.ctrl.append(("frame", pong))
                    p.queued_bytes += len(pong)
                    p.cond.notify()
        elif kind == wire.K_PONG:
            _seq, t_ns = wire.parse_ping(body)
            now_ns = time.monotonic_ns()
            rtt = (now_ns - t_ns) / 1e9
            t_peer = wire.ping_clock(body)
            if t_peer:
                # midpoint method: the responder stamped its clock
                # mid-round-trip — offset = peer_clock - my_clock
                # assuming symmetric legs (error bounded by half the
                # path asymmetry), folded into a per-peer EWMA
                self._note_clock(
                    peer, (t_peer - (t_ns + now_ns) / 2.0) / 1e3,
                    rtt_us=(now_ns - t_ns) / 1e3)
            with self._stat_lock:
                self.ping_rtt[peer] = rtt
            det = self.ft_detector
            if det is not None:
                det.note_alive(peer, rtt=rtt)
        elif kind == wire.K_COMP:
            self._dispatch_body(p, memoryview(
                wire.decompress_body(body)))
        elif kind == wire.K_ELASTIC:
            # delivered HERE, on the receiver thread (like K_PING): a
            # resize proposal or join announcement must reach the
            # coordinator even while every worker is inside a long
            # kernel; the coordinator's deliver only notifies
            self._on_elastic(peer, wire.parse_elastic(body))
        elif kind == wire.K_TUNE:
            # applied HERE, on the receiver thread (like K_ELASTIC): a
            # codec renegotiation takes effect at the next enqueue, not
            # at the next progress pump — the controller's window
            # cadence stays decoupled from the workers'
            self._on_tune(p, wire.parse_tune(body))
        else:
            raise ValueError(f"unknown frame kind {kind}")

    def _peer_died(self, peer: int, reason: str,
                   lost_sends: bool = False) -> None:
        """Failure detector: a torn connection while we're live marks the
        peer dead (SURVEY.md §5.3 — the reference has nothing; a dead MPI
        rank hangs the job). Reporting policy:

        - any later SEND to the peer raises RankFailedError (always);
        - the death is reported to the runtime immediately when the peer
          provably owes us data (a pending rendezvous GET), when
          accepted-but-unsent frames were LOST with it (``lost_sends``
          — the writer path; the caller already returned believing the
          send succeeded), or always under ``comm_failure_strict`` —
          strict is off by default because with local termination
          detection a peer may legitimately fini before our local tail
          work finishes."""
        if self._closing or peer in self.dead_peers \
                or peer in self.finished_peers:
            return  # clean teardown (ours or theirs), or already reported
        self.dead_peers.add(peer)
        with self._conn_cond:
            p = self._peers.get(peer)
        if p is not None:
            dur_ms = 0.0
            with p.cond:  # unblock anything parked on the writer
                if p.suspect:
                    # a SUSPECT episode ends in escalation: close its
                    # accounting and stand the reconnector down
                    p.suspect = False
                    p.done = True
                    dur_ms = (time.monotonic() - p.suspect_since) * 1e3
                p.cond.notify_all()
            if dur_ms:
                with self._stat_lock:
                    self._suspect_ms_total += dur_ms
        plog.warning("tcp rank %d: peer %d presumed FAILED (%s)",
                     self.rank, peer, reason)
        cb = self.on_peer_failure
        if cb is None:
            return
        from ..utils.params import params
        with self._lock:
            owes_us = peer in self._get_srcs.values()
        if owes_us or lost_sends or params.get("comm_failure_strict"):
            cb(peer, reason)

    def _transport_drain(self):
        while True:
            item = self._inbox.pop()
            if item is None:
                return
            yield item

    # -- barrier over AMs (ref: ce.sync) --------------------------------
    def _on_barrier(self, src: int, payload: Any) -> None:
        # progress() runs on every scheduler thread: updates must be
        # atomic or arrivals are lost and sync() deadlocks
        with self._barrier_lock:
            if payload == "arrive":
                self._barrier_arrived.add(src)
            else:
                self._barrier_release += 1

    def _barrier_wait(self, check_and_consume, required_fn) -> None:
        """Spin on progress() until ``check_and_consume`` succeeds; raise
        RankFailedError when a still-required participant is gone
        (crashed OR cleanly fini'd without arriving) — a barrier can
        never complete then, and spinning until an external timeout is
        the hang this detector exists to eliminate. A peer that already
        arrived may fini freely; its flag is set by the recv thread only
        AFTER every preceding frame was queued, so one extra drain before
        raising rules out a queued-but-unprocessed barrier message."""
        while True:
            if check_and_consume():
                return
            if self.progress():
                continue
            gone = [p for p in required_fn()
                    if p in self.dead_peers or p in self.finished_peers]
            if gone:
                self.progress()  # final drain (see docstring)
                if check_and_consume():
                    return
                peer = gone[0]
                reason = ("rank failed during barrier"
                          if peer in self.dead_peers else
                          "rank shut down without joining the barrier")
                raise RankFailedError(peer, reason)
            time.sleep(0.001)

    def sync(self) -> None:
        if self.nb_ranks == 1:
            return
        if self.rank == 0:
            everyone = set(range(1, self.nb_ranks))

            def got_all_arrivals() -> bool:
                with self._barrier_lock:
                    if self._barrier_arrived >= everyone:
                        self._barrier_arrived -= everyone
                        return True
                    return False

            def still_missing():
                with self._barrier_lock:
                    return everyone - self._barrier_arrived

            self._barrier_wait(got_all_arrivals, still_missing)
            for peer in range(1, self.nb_ranks):
                self.send_am(peer, TAG_BARRIER, "release")
        else:
            self.send_am(0, TAG_BARRIER, "arrive")

            def got_release() -> bool:
                with self._barrier_lock:
                    if self._barrier_release >= 1:
                        self._barrier_release -= 1
                        return True
                    return False

            self._barrier_wait(got_release, lambda: (0,))

    def fini(self) -> None:
        self._closing = True
        self._clock_stop.set()   # stand the clock sampler down first
        t = self._clock_thread
        if t is not None:
            t.join(timeout=2.0)
        if self._ft_silenced:
            # injected kill: die WITHOUT a goodbye and WITHOUT flushing
            # — peers must learn of the death proactively (heartbeat) or
            # reactively (torn socket), exactly like a real crash
            try:
                self._listener.close()
            except OSError:
                pass
            with self._conn_cond:
                peers = dict(self._peers)
            for p in peers.values():
                try:
                    p.sock.close()
                except OSError:
                    pass
            return
        # clean goodbye so live peers see an orderly shutdown, not a
        # crash. The writer sends it only after BOTH queues drain (the
        # final results / termdet messages must precede it), so fini
        # waits for the writers to flush before tearing sockets down.
        with self._conn_cond:
            peers = dict(self._peers)
        for rank_, p in peers.items():
            if rank_ in self.dead_peers or rank_ in self.finished_peers:
                continue
            with p.cond:
                p.goodbye = True
                p.cond.notify()
        # progress-aware flush: a slow link draining a large bulk
        # backlog gets as long as it keeps moving bytes (the links this
        # wire targets run at single-digit MB/s); only a STALLED writer
        # (15 s with zero queue progress) is abandoned
        live = [p for r, p in peers.items()
                if r not in self.dead_peers
                and r not in self.finished_peers and p.writer is not None]
        prev = None
        stall = time.time() + 15.0
        while True:
            live = [p for p in live if p.writer.is_alive()]
            if not live:
                break
            cur = 0
            for p in live:
                with p.cond:
                    cur += len(p.ctrl) + len(p.bulk)
            if prev is None or cur < prev:
                prev = cur
                stall = time.time() + 15.0
            if time.time() > stall:
                plog.warning(
                    "tcp rank %d: %d writer(s) stalled with %d queued "
                    "frame(s) at shutdown", self.rank, len(live), cur)
                break
            time.sleep(0.02)
        try:
            self._listener.close()
        except OSError:
            pass
        for p in peers.values():
            try:
                p.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                p.sock.close()
            except OSError:
                pass
