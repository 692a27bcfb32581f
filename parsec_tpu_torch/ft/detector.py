"""Proactive failure detection: heartbeat liveness over the comm engines.

Before this module, failure detection was purely REACTIVE: a peer was
declared dead only when a TCP send to it happened to fail
(comm/tcp.py ``_peer_died``). A rank that goes silent without tearing
its sockets — SIGKILL'd with the kernel keeping connections half-open,
wedged in a driver call, partitioned — hung every peer in termination
detection forever. The detector closes that gap: every
``ft_heartbeat_interval`` seconds it probes each peer and judges
liveness from the replies; a silent peer is declared dead within
``ft_heartbeat_timeout`` and funneled through the SAME
``CommEngine.report_peer_failure`` → ``on_peer_failure`` →
``RankFailedError`` path that reactive send failures reach, so every
consumer (context abort, barrier waits, device-plane park
reclamation) sees one failure surface.

Transport-specific probe/replay mechanics (the detector itself is
transport-neutral):

- **TCP**: ``K_PING``/``K_PONG`` wire frames (comm/wire.py, alongside
  ``K_HELLO``) sent on the ctrl lane and answered directly by the
  peer's RECEIVER thread — liveness judges the transport, not the
  progress cadence, so a rank stuck in a long kernel is not falsely
  evicted. Pings go only to peers whose HELLO advertised ``"hb"``.
- **LocalFabric** (in-process SPMD): ``TAG_HEARTBEAT``
  active messages; every engine answers pings from its progress loop
  whether or not a detector is installed locally. Liveness therefore
  depends on the peer pumping progress — size the timeout above the
  longest un-pumped stretch (e.g. a kernel build at first use).

Safety rules (the acceptance bar for never evicting a healthy peer):

- a **mixed-version peer is never probed, so never declared dead**:
  the support gate lives at the PROBE layer (``ft_ping`` returns False
  — TCP only probes peers whose HELLO advertised ``"hb"``; the
  in-process fabrics only probe engines with a live ``TAG_HEARTBEAT``
  handler), and the detector only ever judges peers it has
  successfully probed;
- an ESTABLISHED peer (it answered at least once) that stays silent is
  evicted once the silence since its last proof of life exceeds the
  deadline;
- a probed-but-never-answering peer is evicted (baseline: when probing
  began) only on transports where a successful probe implies a live
  responder (``CommEngine.ft_probe_baseline`` — TCP: ``hb_ok`` means
  the peer's receiver thread processed our HELLO and answers without
  progress pumping, so a rank killed right after startup is still
  detected). On the in-process fabrics an unanswered probe may just
  mean the peer is not pumping progress yet (startup, a kernel
  build), so only established peers are ever judged there. One
  inherent TCP blind spot follows from the mixed-version rule: a peer
  that dies in the short window AFTER the rank handshake but BEFORE
  its HELLO is processed looks exactly like a pre-heartbeat build
  (``hb_ok`` never set), is never probed, and is only caught
  reactively when the kernel finally tears the half-open socket — the
  conservative side of the never-evict-a-healthy-mixed-version-peer
  bar;
- a peer that shut down CLEANLY (TCP GOODBYE / local-fabric finish
  mark) is skipped: finishing early is not failing;
- a peer whose link is SUSPECT under a reliable session
  (``comm_reconnect_timeout``, comm/tcp.py) is not judged while the
  reconnect budget lasts: probes cannot cross a torn link, so the
  silence proves nothing about the process. A completed resume resets
  the silence baseline; a peer that reconnects but still never
  answers is evicted at the next tick — the detector keeps final say
  over live-but-silent peers, the session only over torn links;
- ``ft_detector_mode=phi`` scales the deadline by the observed
  inter-arrival EWMA (a phi-accrual-style accrual: slow-but-steady
  links earn longer deadlines), never below ``ft_heartbeat_timeout``.

Gauges (obs ``CommObs.register_engine_gauges``, on the context's SDE
registry): ``FT_PEER_ALIVE`` (peers confirmed alive) and
``FT_HB_RTT_PREFIX::R<peer>`` (each peer's probe round-trip EWMA, ms).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..obs.spans import FT_HB_RTT_PREFIX, FT_PEER_ALIVE
from ..utils import logging as plog
from ..utils.params import params

__all__ = ["HeartbeatDetector", "maybe_install_detector",
           "FT_PEER_ALIVE", "FT_HB_RTT_PREFIX"]

#: EWMA smoothing for the heartbeat round-trip and inter-arrival gap
_ALPHA = 0.2
#: phi mode: declared dead when the silence exceeds this many observed
#: inter-arrival gaps (and at least ft_heartbeat_timeout)
_PHI_FACTOR = 8.0


class _PeerHealth:
    __slots__ = ("established", "last_rx", "rtt_s", "gap_s", "probed_at")

    def __init__(self) -> None:
        self.established = False      # answered at least one probe
        self.last_rx = 0.0            # monotonic time of last proof
        self.rtt_s: Optional[float] = None   # probe round-trip EWMA
        self.gap_s: Optional[float] = None   # inter-arrival EWMA
        #: time of the first successful probe (None until ft_ping ever
        #: returned True) — the silence baseline for a peer that died
        #: before first contact; ft_ping's False for unsupported peers
        #: keeps this None, which is the mixed-version exemption
        self.probed_at: Optional[float] = None


class HeartbeatDetector:
    """Per-rank liveness monitor over one comm engine.

    A small daemon thread sends one probe per peer per interval and
    checks deadlines; it never calls ``progress()`` (delivering
    arbitrary AMs on a side thread would break the funnelled dispatch
    semantics). Replies land via the transport's own threads
    (:meth:`note_alive` is thread-safe).
    """

    def __init__(self, ce: Any, interval: float, timeout: float,
                 mode: str = "timeout",
                 phi_factor: float = _PHI_FACTOR) -> None:
        if interval <= 0:
            raise ValueError("heartbeat interval must be > 0")
        if timeout <= interval:
            raise ValueError(
                f"heartbeat timeout ({timeout}s) must exceed the "
                f"interval ({interval}s)")
        if mode not in ("timeout", "phi"):
            raise ValueError(f"unknown ft_detector_mode {mode!r}")
        self.ce = ce
        self.interval = interval
        self.timeout = timeout
        self.mode = mode
        self.phi_factor = phi_factor
        self._peers: Dict[int, _PeerHealth] = {
            r: _PeerHealth() for r in range(ce.nb_ranks) if r != ce.rank}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self.evictions = 0
        ce.ft_detector = self   # transports feed note_alive through this

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "HeartbeatDetector":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"ft-hb-r{self.ce.rank}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if getattr(self.ce, "ft_detector", None) is self:
            self.ce.ft_detector = None

    # -- transport hooks (any thread) -----------------------------------
    def note_alive(self, peer: int, rtt: Optional[float] = None) -> None:
        """A liveness proof arrived from ``peer`` (its pong — with the
        measured round trip — or its own ping)."""
        st = self._peers.get(peer)
        if st is None:
            return
        now = time.monotonic()
        with self._lock:
            if st.established:
                gap = now - st.last_rx
                st.gap_s = (gap if st.gap_s is None
                            else (1 - _ALPHA) * st.gap_s + _ALPHA * gap)
            st.established = True
            st.last_rx = now
            if rtt is not None:
                st.rtt_s = (rtt if st.rtt_s is None
                            else (1 - _ALPHA) * st.rtt_s + _ALPHA * rtt)

    # -- gauges (obs register_engine_gauges) ----------------------------
    def alive_count(self) -> int:
        """Peers currently confirmed alive (established, not evicted,
        not cleanly finished)."""
        n = 0
        with self._lock:
            for peer, st in self._peers.items():
                if st.established and peer not in self.ce.dead_peers \
                        and not self.ce.peer_finished(peer):
                    n += 1
        return n

    def rtt_s(self, peer: int) -> Optional[float]:
        st = self._peers.get(peer)
        with self._lock:
            return st.rtt_s if st is not None else None

    def is_established(self, peer: int) -> bool:
        st = self._peers.get(peer)
        with self._lock:
            return bool(st is not None and st.established)

    # -- the monitor loop ----------------------------------------------
    def _deadline_for(self, st: _PeerHealth) -> float:
        if self.mode == "phi" and st.gap_s is not None:
            return max(self.timeout, self.phi_factor * st.gap_s)
        return self.timeout

    def _loop(self) -> None:
        ce = self.ce
        while not self._stop.wait(self.interval):
            if ce._ft_silenced:
                return   # this rank was injected-killed: judge nobody
            self._seq += 1
            now = time.monotonic()
            for peer, st in self._peers.items():
                if peer in ce.dead_peers or ce.peer_finished(peer):
                    continue
                if getattr(ce, "peer_suspect", None) is not None \
                        and ce.peer_suspect(peer):
                    # the link is torn but its reliable session is
                    # still inside the reconnect budget (comm/tcp.py):
                    # probes cannot cross, so the silence proves
                    # nothing — the session layer owns the verdict
                    # until it either resumes (a completed resume
                    # resets the silence baseline, and a zombie that
                    # reconnects but never answers is evicted at the
                    # next tick: the detector keeps final say) or
                    # escalates on budget exhaustion
                    continue
                sent = False
                try:
                    sent = ce.ft_ping(peer, self._seq,
                                      time.monotonic_ns())
                except Exception:  # noqa: BLE001 - probing must not die
                    plog.debug.verbose(
                        1, "rank %d: heartbeat probe to %d failed",
                        ce.rank, peer)
                with self._lock:
                    if sent and st.probed_at is None:
                        st.probed_at = now
                    if st.probed_at is None:
                        continue   # never probed (no hb support): exempt
                    if not st.established and not ce.ft_probe_baseline:
                        # in-process fabrics: an unanswered probe may
                        # just mean the peer is not pumping progress
                        # yet (startup, a long compile) — judging it
                        # would false-evict a healthy rank. Only
                        # transports whose probes imply a live
                        # responder (TCP) evict before first contact.
                        continue
                    baseline = (st.last_rx if st.established
                                else st.probed_at)
                    silent_for = now - baseline
                    deadline = self._deadline_for(st)
                if silent_for > deadline:
                    self.evictions += 1
                    ce.report_peer_failure(
                        peer,
                        f"heartbeat timeout: silent {silent_for:.2f}s "
                        f"(> {deadline:.2f}s, interval {self.interval}s)")


def maybe_install_detector(ctx: Any) -> Optional[HeartbeatDetector]:
    """Build + start a detector for ``ctx``'s comm engine when the
    ``ft_heartbeat_interval`` knob is set (and there is anyone to
    watch). Called by ``Context.__init__`` right after comm binding —
    before the obs wiring, so ``register_engine_gauges`` sees it."""
    if ctx.comm is None or ctx.nb_ranks < 2:
        return None
    raw = str(params.get("ft_heartbeat_interval") or "").strip()
    if not raw:
        return None
    interval = float(raw)
    if interval <= 0:
        return None
    raw_to = str(params.get("ft_heartbeat_timeout") or "").strip()
    timeout = float(raw_to) if raw_to else 8.0 * interval
    mode = str(params.get("ft_detector_mode") or "timeout")
    ce = getattr(ctx.comm, "ce", ctx.comm)
    return HeartbeatDetector(ce, interval, timeout, mode=mode).start()

