"""obs/live — in-runtime streaming health monitor.

PR 15 made inter-rank time explainable OFFLINE: per-link exposed-wait,
clock-aligned flow lag, distributed critical path — all computed from
trace files after the run.  This module computes the same report
ONLINE: as comm/device/exec spans close and FLOW_SENT/FLOW_RECV pairs
stitch, :class:`LiveHealth` folds them into

- rolling per-link **exposed-wait** (the exact per-interval algebra
  :func:`obs.critpath.per_link_exposed_wait` applies offline — one
  code path, so the online/offline parity gate can hold a tight
  tolerance),
- a per-rank **overlap fraction** over the same channels the offline
  analyzer classifies (``comm:*`` spans including delivers/progress,
  ``dev:xfer*`` transfers, ``exec:*`` compute),
- per-link **flow lag** from the extended flow contexts (the sender's
  monotonic send instant rides the wire; the receiver converts it with
  the live CLOCK_OFFSET_US estimate), and
- **per-taskpool attribution**: the taskpool wire id stamped through
  the flow context (the seam ROADMAP names for tenant ids) becomes
  per-pool sent/recv/lag aggregates.

On top of the rolling state an anomaly layer fires detectors against
self-calibrated baselines (:class:`RollingStat`, EWMA mean/variance +
ring-buffer percentiles):

- **straggler** — an inbound link's window exposed-wait z-score blows
  past the baseline (the peer is starving us), or this rank's own
  exec-busy collapses;
- **degraded link** — a link's window flow-lag regresses vs its own
  EWMA (or the transport's LINK_BW estimate collapses);
- **stuck progress** — no span closes for several windows while tasks
  are still pending.

Each firing lands three ways: a Chrome-trace INSTANT annotation on the
``health`` stream (merged offline timelines show detector verdicts at
the right instant), the ``PARSEC::OBS::HEALTH::*`` gauges, and the
snapshot's recent-firings ring (served fleet-wide by the aggregator's
``GET /health``).  Everything rides the ``obs_live`` knob — unset
constructs nothing: no thread, no gauges, no wire change.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .spans import (OBS_HEALTH_DEGRADED, OBS_HEALTH_FIRINGS,
                    OBS_HEALTH_STATUS, OBS_HEALTH_STRAGGLER,
                    OBS_HEALTH_STUCK, OBS_HEALTH_WINDOWS,
                    OBS_HEALTH_WORST_LINK_US)

__all__ = ["RollingStat", "LiveHealth", "fleet_health", "format_health",
           "register_health_gauges"]

#: declared lock discipline (the JAX package's analysis/lock_check.py): every
#: rolling channel, baseline, counter, and the firing ring belong to
#: the monitor's single mutex — writers are the span/flow note hooks
#: (any thread), the reader is snapshot()/the window tick.
_GUARDED_BY = {
    "LiveHealth._compute": "_lock",
    "LiveHealth._comm": "_lock",
    "LiveHealth._links": "_lock",
    "LiveHealth._closed": "_lock",
    "LiveHealth._closed_links": "_lock",
    "LiveHealth._lag_win": "_lock",
    "LiveHealth._lag_base": "_lock",
    "LiveHealth._bw_base": "_lock",
    "LiveHealth._exposed_base": "_lock",
    "LiveHealth._busy_base": "_lock",
    "LiveHealth._last_exposed": "_lock",
    "LiveHealth._last_compute_us": "_lock",
    "LiveHealth._pools": "_lock",
    "LiveHealth._tenants": "_lock",
    "LiveHealth._activity": "_lock",
    "LiveHealth._last_activity": "_lock",
    "LiveHealth._idle_windows": "_lock",
    "LiveHealth._firings": "_lock",
    "LiveHealth.counts": "_lock",
    "LiveHealth.status": "_lock",
}


class RollingStat:
    """Self-calibrating baseline of one scalar signal: EWMA mean +
    EWMA variance (for z-scores) plus a small ring of recent window
    samples (for percentiles).  Not thread-safe on its own — every
    instance lives under its owner's lock."""

    __slots__ = ("alpha", "mean", "_var", "n", "_ring", "_cap", "_i")

    def __init__(self, alpha: float = 0.2, ring: int = 32) -> None:
        self.alpha = alpha
        self.mean = 0.0
        self._var = 0.0
        self.n = 0
        self._cap = ring
        self._ring: List[float] = []
        self._i = 0

    def push(self, v: float) -> None:
        v = float(v)
        if self.n == 0:
            self.mean = v
            self._var = 0.0
        else:
            d = v - self.mean
            self.mean += self.alpha * d
            # EWMA of the squared deviation (Welford's EW analog)
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        self.n += 1
        if len(self._ring) < self._cap:
            self._ring.append(v)
        else:
            self._ring[self._i] = v
            self._i = (self._i + 1) % self._cap
    def std(self) -> float:
        return self._var ** 0.5

    def z(self, v: float) -> float:
        """Z-score of ``v`` against the baseline; a degenerate (zero
        variance) baseline uses a floor of 10% of the mean so a
        perfectly-steady signal can still raise an alarm instead of
        dividing by zero; an all-zero baseline (idle link) treats any
        departure as infinitely surprising — a spike after silence
        must still fire."""
        v = float(v)
        s = self.std()
        if s <= 0:
            s = abs(self.mean) * 0.1
        if s <= 0:
            if v == self.mean:
                return 0.0
            return float("inf") if v > self.mean else float("-inf")
        return (v - self.mean) / s

    def percentile(self, q: float) -> float:
        if not self._ring:
            return 0.0
        xs = sorted(self._ring)
        k = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[k]


def _pct(xs: List[float], q: float) -> float:
    """Nearest-rank percentile of a small sample list (0 when empty) —
    the per-tenant latency rollup's one shared helper."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[k]


def _link_exposed(ivs: List[Tuple[float, float]],
                  compute: List[Tuple[float, float]]) -> float:
    """Sum of per-interval exposed time — interval by interval, the
    EXACT summation ``critpath.per_link_exposed_wait`` applies offline
    (overlapping same-link spans intentionally each contribute their
    own exposed part; a union here would diverge from the report)."""
    from .critpath import overlap_us
    total = 0.0
    for b, e in ivs:
        total += (e - b) - overlap_us([(b, e)], compute)
    return total


class LiveHealth:
    """Streaming per-rank health aggregator + anomaly detectors.

    The span sinks (``CommObs``/``DeviceObs``/``ExecTimer``) call the
    ``note_*`` hooks as spans close; the monitor thread (or a test
    calling :meth:`tick` directly) folds one rolling window at a time
    and runs the detectors.  ``snapshot()`` is the JSON document the
    aggregator serves per rank under ``GET /health``."""

    #: interval-list budget before compaction (per channel), and how
    #: many merged intervals stay live after a seal — the same
    #: bounded-memory scheme as ``OverlapTracker``, with the same
    #: conservative caveat (a span closing after the seal cannot
    #: overlap sealed history)
    COALESCE_AT = 4096
    KEEP_AT = 1024

    def __init__(self, rank: int, window_ms: int = 250,
                 stream: Optional[Any] = None,
                 clock_offset_fn: Optional[Callable[[int],
                                                    Optional[float]]] = None,
                 pending_fn: Optional[Callable[[], int]] = None,
                 link_bw_fn: Optional[Callable[[int],
                                               Optional[float]]] = None,
                 z_thresh: float = 3.0, warmup_windows: int = 5,
                 min_exposed_us: float = 1000.0,
                 lag_factor: float = 3.0, min_lag_us: float = 500.0,
                 stuck_windows: int = 4) -> None:
        self.rank = int(rank)
        self.window_ms = max(10, int(window_ms))
        self.stream = stream
        self.clock_offset_fn = clock_offset_fn
        self.pending_fn = pending_fn
        self.link_bw_fn = link_bw_fn
        self.z_thresh = float(z_thresh)
        self.warmup_windows = int(warmup_windows)
        self.min_exposed_us = float(min_exposed_us)
        self.lag_factor = float(lag_factor)
        self.min_lag_us = float(min_lag_us)
        self.stuck_windows = int(stuck_windows)
        # per-tenant latency ring length (instance attr shadows the
        # class default): sized by the same serve_latency_window knob
        # the SessionServer reads, so server stats and health
        # snapshots percentile over the same horizon
        from ..utils.params import params
        self.TENANT_LAT_RING = max(1, int(params.get_or(
            "serve_latency_window", "int", type(self).TENANT_LAT_RING)))
        self._lock = threading.Lock()
        # rolling interval channels (µs pairs, monotonic-ns / 1e3)
        self._compute: List[Tuple[float, float]] = []
        self._comm: List[Tuple[float, float]] = []
        # per-link INDIVIDUAL comm intervals (never merged: the offline
        # per-link exposure sums per interval)
        self._links: Dict[str, List[Tuple[float, float]]] = {}
        self._closed = {"compute_us": 0.0, "comm_us": 0.0,
                        "overlap_us": 0.0}
        self._closed_links: Dict[str, float] = {}
        # flow lag: per-link samples of the CURRENT window + baselines
        self._lag_win: Dict[str, List[float]] = {}
        self._lag_base: Dict[str, RollingStat] = {}
        self._bw_base: Dict[int, RollingStat] = {}
        # detector baselines over window deltas
        self._exposed_base: Dict[str, RollingStat] = {}
        self._busy_base = RollingStat()
        self._last_exposed: Dict[str, float] = {}
        self._last_compute_us = 0.0
        # per-taskpool attribution (pool = taskpool wire id, or None
        # for data-plane tags that carry no tp_id)
        self._pools: Dict[Any, Dict[str, float]] = {}
        # per-tenant attribution (serve/): flow traffic of
        # served pools (tenant rides the 5-tuple context) plus the
        # taskpool latency samples the SessionServer pushes at pool
        # completion; empty — and absent from snapshots — without a
        # server, so pre-serve consumers see the exact old document
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._activity = 0
        self._last_activity = 0
        self._idle_windows = 0
        self._firings: deque = deque(maxlen=128)
        self.counts = {"windows": 0, "firings": 0, "straggler": 0,
                       "degraded_link": 0, "stuck": 0}
        self.status = 0   # 0 healthy, 1 degraded, 2 stuck
        # window-tick subscribers: each gets the per-window
        # digest AFTER the detectors ran, outside the lock — the
        # closed-loop controller rides this seam (append-only list;
        # callers subscribe before or after start(), both safe)
        self._subscribers: List[Callable[[Dict[str, Any]], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- engine binding ------------------------------------------------
    def bind_engine(self, ce: Any) -> None:
        """Late-bind the transport's live estimators (clock offsets for
        lag conversion, link bandwidth for the degradation detector)."""
        fn = getattr(ce, "clock_offset_us", None)
        if callable(fn):
            self.clock_offset_fn = fn
        bw = getattr(ce, "link_bw_mbps", None)
        if callable(bw):
            self.link_bw_fn = bw

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """Register a per-window-tick subscriber.  ``fn`` receives the
        window digest (see :meth:`tick`) after each fold, OUTSIDE the
        monitor's lock and on the monitor thread — it may call back
        into the transport or the monitor freely; exceptions are
        swallowed (a sick subscriber must not kill the heartbeat)."""
        self._subscribers.append(fn)

    def annotate(self, name: str, args: Dict[str, Any]) -> None:
        """Emit one instant annotation on the health stream (the same
        lane the detector firings ride) — no-op without a profile
        stream, so annotating is always safe to call."""
        st = self.stream
        if st is not None:
            st.trace(name, args, phase="i")

    # -- span/flow feeds (any thread) ----------------------------------
    def note_compute(self, t0_ns: int, t1_ns: int) -> None:
        if t1_ns <= t0_ns:
            return
        with self._lock:
            self._compute.append((t0_ns / 1e3, t1_ns / 1e3))
            self._activity += 1
            if len(self._compute) > self.COALESCE_AT:
                self._compact_locked()

    def note_comm(self, t0_ns: int, t1_ns: int,
                  src: Optional[int] = None,
                  dst: Optional[int] = None) -> None:
        """One comm-side span closed.  ``src``/``dst`` carry the peer
        attribution exactly as the span args do offline: an inbound
        span names its source, an outbound span its destination; an
        unattributed span (progress drains, device transfers) still
        counts toward the overlap channels."""
        if t1_ns <= t0_ns:
            return
        iv = (t0_ns / 1e3, t1_ns / 1e3)
        link = None
        if src is not None and src != self.rank:
            link = f"R{src}->R{self.rank}"
        elif dst is not None and dst != self.rank:
            link = f"R{self.rank}->R{dst}"
        with self._lock:
            self._comm.append(iv)
            self._activity += 1
            if link is not None:
                self._links.setdefault(link, []).append(iv)
            if len(self._comm) > self.COALESCE_AT:
                self._compact_locked()

    #: per-tenant taskpool-latency samples kept for the p50/p99 rollup
    #: (default; __init__ resizes from the serve_latency_window knob)
    TENANT_LAT_RING = 512

    def _tenant_cell_locked(
            self, tenant: str) -> Dict[str, Any]:  # holds: self._lock
        return self._tenants.setdefault(
            tenant, {"sent": 0, "recv": 0, "lag_us_sum": 0.0, "lag_n": 0,
                     "pools_done": 0,
                     "lat": deque(maxlen=self.TENANT_LAT_RING)})

    def note_flow_sent(self, dst: int, pool: Any,
                       tenant: Optional[str] = None) -> None:
        with self._lock:
            cell = self._pools.setdefault(
                pool, {"sent": 0, "recv": 0, "lag_us_sum": 0.0, "lag_n": 0})
            cell["sent"] += 1
            if tenant is not None:
                self._tenant_cell_locked(tenant)["sent"] += 1

    def note_tenant_latency(self, tenant: str, lat_us: float) -> None:
        """One served taskpool completed for ``tenant`` after ``lat_us``
        microseconds submit-to-termination — pushed by the
        SessionServer so health snapshots (and the fleet merge) carry
        per-tenant SLO percentiles next to the flow attribution."""
        with self._lock:
            cell = self._tenant_cell_locked(tenant)
            cell["pools_done"] += 1
            cell["lat"].append(float(lat_us))
            self._activity += 1

    def note_flow_recv(self, src: int, pool: Any, t_send_ns: int,
                       t_recv_ns: int,
                       tenant: Optional[str] = None) -> None:
        """A stitched flow edge arrived: the sender's monotonic send
        instant rode the extended context; convert it onto this rank's
        clock with the live offset estimate (offset = peer_clock -
        my_clock, so the send instant HERE is ``t_send - offset`` and
        the lag gains ``+offset``) and fold the lag per link and per
        taskpool."""
        off_us = 0.0
        fn = self.clock_offset_fn
        if fn is not None:
            try:
                off = fn(src)
            except Exception:   # noqa: BLE001 - telemetry must not raise
                off = None
            if off is not None:
                off_us = float(off)
        lag_us = (t_recv_ns - t_send_ns) / 1e3 + off_us
        link = f"R{src}->R{self.rank}"
        with self._lock:
            self._lag_win.setdefault(link, []).append(lag_us)
            cell = self._pools.setdefault(
                pool, {"sent": 0, "recv": 0, "lag_us_sum": 0.0, "lag_n": 0})
            cell["recv"] += 1
            cell["lag_us_sum"] += lag_us
            cell["lag_n"] += 1
            if tenant is not None:
                tc = self._tenant_cell_locked(tenant)
                tc["recv"] += 1
                tc["lag_us_sum"] += lag_us
                tc["lag_n"] += 1
            self._activity += 1

    # -- bounded memory ------------------------------------------------
    def _compact_locked(self) -> None:   # holds: self._lock
        """Merge the union channels; when still over budget, seal
        history before a shared watermark into scalar totals (overlap
        algebra exact at seal time — the OverlapTracker scheme), and
        retire whole per-link intervals older than the watermark into
        per-link exposed scalars."""
        from .critpath import merge_intervals, overlap_us
        comp = merge_intervals(self._compute)
        comm = merge_intervals(self._comm)
        if max(len(comp), len(comm)) > self.COALESCE_AT:
            w = min(ch[-self.KEEP_AT][0] for ch in (comp, comm)
                    if len(ch) > self.KEEP_AT)

            def split(ivs):
                old, new = [], []
                for b, e in ivs:
                    if e <= w:
                        old.append((b, e))
                    elif b >= w:
                        new.append((b, e))
                    else:
                        old.append((b, w))
                        new.append((w, e))
                return old, new

            old_comp, comp = split(comp)
            old_comm, comm = split(comm)
            self._closed["compute_us"] += sum(e - b for b, e in old_comp)
            self._closed["comm_us"] += sum(e - b for b, e in old_comm)
            self._closed["overlap_us"] += overlap_us(old_comp, old_comm)
            # per-link: retire whole intervals that END before the cut
            # (no clipping — the offline summation is per interval);
            # their exposed part is final against compute seen so far
            full_comp = merge_intervals(old_comp + comp)
            for link, ivs in self._links.items():
                old = [iv for iv in ivs if iv[1] <= w]
                if not old:
                    continue
                self._links[link] = [iv for iv in ivs if iv[1] > w]
                self._closed_links[link] = (
                    self._closed_links.get(link, 0.0)
                    + _link_exposed(old, full_comp))
        self._compute, self._comm = comp, comm

    # -- reading -------------------------------------------------------
    def _overlap_locked(self) -> Dict[str, float]:   # holds: self._lock
        from .critpath import merge_intervals, overlap_us
        comp = merge_intervals(self._compute)
        comm = merge_intervals(self._comm)
        comm_us = self._closed["comm_us"] + sum(e - b for b, e in comm)
        comp_us = self._closed["compute_us"] + sum(e - b for b, e in comp)
        hidden = self._closed["overlap_us"] + overlap_us(comp, comm)
        return {"compute_us": round(comp_us, 1),
                "comm_us": round(comm_us, 1),
                "overlap_us": round(hidden, 1),
                # zero-comm = perfect overlap, matching the offline
                # analyzer and the OverlapTracker gauge
                "overlap_fraction": round(hidden / comm_us, 4)
                if comm_us > 0 else 1.0}

    def _exposed_locked(self) -> Dict[str, float]:   # holds: self._lock
        from .critpath import merge_intervals
        comp = merge_intervals(self._compute)
        out = dict(self._closed_links)
        for link, ivs in self._links.items():
            out[link] = out.get(link, 0.0) + _link_exposed(ivs, comp)
        return {k: round(v, 1) for k, v in
                sorted(out.items(), key=lambda kv: -kv[1]) if v > 0}

    def snapshot(self) -> Dict[str, Any]:
        """The per-rank health document (JSON-clean): rolling overlap,
        per-link exposed-wait/lag, per-pool attribution, detector
        counters, and the recent firings ring."""
        with self._lock:
            ov = self._overlap_locked()
            exposed = self._exposed_locked()
            lag = {link: {"ewma_us": round(st.mean, 1),
                          "p95_us": round(st.percentile(0.95), 1),
                          "n": st.n}
                   for link, st in self._lag_base.items() if st.n}
            # links whose first samples are still in the open window
            # (no tick folded them yet) must not read as lag-less — a
            # short run can end before the first window closes
            for link, samples in self._lag_win.items():
                if link not in lag and samples:
                    m = sum(samples) / len(samples)
                    lag[link] = {"ewma_us": round(m, 1),
                                 "p95_us": round(max(samples), 1),
                                 "n": 0}
            pools = {str(p): {"sent": int(c["sent"]),
                              "recv": int(c["recv"]),
                              "lag_us_mean": round(
                                  c["lag_us_sum"] / c["lag_n"], 1)
                              if c["lag_n"] else 0.0}
                     for p, c in self._pools.items()}
            doc = {"rank": self.rank,
                   "ts": time.time(),
                   "window_ms": self.window_ms,
                   "windows": self.counts["windows"],
                   "status": self.status,
                   "counts": dict(self.counts),
                   "overlap": ov,
                   "per_link_exposed_us": exposed,
                   "per_link_lag_us": lag,
                   "per_pool": pools,
                   "firings": list(self._firings)}
            if self._tenants:
                # serve attribution — the key appears ONLY
                # when a server fed tenant data, so pre-serve snapshot
                # consumers keep the exact old document shape
                doc["per_tenant"] = {
                    str(t): {"sent": int(c["sent"]),
                             "recv": int(c["recv"]),
                             "lag_us_mean": round(
                                 c["lag_us_sum"] / c["lag_n"], 1)
                             if c["lag_n"] else 0.0,
                             "pools_done": int(c["pools_done"]),
                             "p50_lat_us": round(
                                 _pct(list(c["lat"]), 0.50), 1),
                             "p99_lat_us": round(
                                 _pct(list(c["lat"]), 0.99), 1)}
                    for t, c in self._tenants.items()}
            return doc

    # -- gauges (registered by the obs wiring) -------------------------
    def _count(self, key: str) -> int:
        with self._lock:
            return self.counts[key]

    def gauge_status(self) -> int:
        with self._lock:
            return self.status

    def gauge_worst_link_us(self) -> float:
        with self._lock:
            exposed = self._exposed_locked()
        return max(exposed.values()) if exposed else 0.0

    # -- the window tick + detectors -----------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        """Fold one rolling window and run every detector; returns the
        list of NEW firings (the monitor thread calls this every
        ``window_ms``; tests drive it directly for determinism)."""
        from .critpath import merge_intervals
        fired: List[Dict[str, Any]] = []
        pending = 0
        if self.pending_fn is not None:
            try:
                pending = int(self.pending_fn() or 0)
            except Exception:   # noqa: BLE001 - telemetry must not raise
                pending = 0
        bw_now: Dict[int, float] = {}
        with self._lock:
            peers = {int(link.split("->")[0][1:])
                     for link in set(self._links) | set(self._lag_win)
                     if link.startswith("R")}
        if self.link_bw_fn is not None:
            for peer in peers:
                if peer == self.rank:
                    continue
                try:
                    bw = self.link_bw_fn(peer)
                except Exception:   # noqa: BLE001
                    bw = None
                if bw is not None:
                    bw_now[peer] = float(bw)
        with self._lock:
            self.counts["windows"] += 1
            win = self.counts["windows"]
            warm = self.warmup_windows
            # 1) straggler: inbound-link window exposed-wait z-score
            comp = merge_intervals(self._compute)
            cum = dict(self._closed_links)
            for link, ivs in self._links.items():
                cum[link] = cum.get(link, 0.0) + _link_exposed(ivs, comp)
            dg_links: Dict[str, Dict[str, Any]] = {}
            for link, total in cum.items():
                delta = total - self._last_exposed.get(link, 0.0)
                self._last_exposed[link] = total
                if not link.endswith(f"->R{self.rank}"):
                    continue   # only inbound waits accuse a peer
                base = self._exposed_base.setdefault(link, RollingStat())
                z = base.z(delta) if base.n else 0.0
                dg_links[link] = {"exposed_us": round(delta, 1),
                                  "z": round(z, 2),
                                  "warm": base.n >= warm}
                if (base.n >= warm and delta > self.min_exposed_us
                        and z > self.z_thresh):
                    src = int(link.split("->")[0][1:])
                    fired.append(self._fire_locked(
                        "straggler", link=link, suspect=src,
                        value=round(delta, 1), window=win,
                        detail=f"window exposed-wait {delta:.0f}us, "
                               f"z={z:.1f} vs "
                               f"baseline {base.mean:.0f}us"))
                base.push(delta)
            # 1b) straggler (self): exec-busy collapse on THIS rank
            comp_us = self._closed["compute_us"] \
                + sum(e - b for b, e in comp)
            busy = comp_us - self._last_compute_us
            self._last_compute_us = comp_us
            bb = self._busy_base
            if (bb.n >= warm and bb.mean > 0 and pending > 0
                    and bb.z(busy) < -self.z_thresh):
                fired.append(self._fire_locked(
                    "straggler", link=None, suspect=self.rank,
                    value=round(busy, 1), window=win,
                    detail=f"exec-busy collapsed to {busy:.0f}us/window "
                           f"(baseline {bb.mean:.0f}us) with "
                           f"{pending} task(s) pending"))
            bb.push(busy)
            # 2) degraded link: window flow-lag regression vs own EWMA
            dg_lag: Dict[str, float] = {}
            lag_win, self._lag_win = self._lag_win, {}
            for link, samples in lag_win.items():
                mean = sum(samples) / len(samples)
                dg_lag[link] = round(mean, 1)
                base = self._lag_base.setdefault(link, RollingStat())
                if (base.n >= warm and mean > self.min_lag_us
                        and base.mean > 0
                        and mean > self.lag_factor * base.mean):
                    fired.append(self._fire_locked(
                        "degraded_link", link=link, suspect=None,
                        value=round(mean, 1), window=win,
                        detail=f"flow lag {mean:.0f}us = "
                               f"{mean / base.mean:.1f}x its "
                               f"{base.mean:.0f}us EWMA"))
                base.push(mean)
            # 2b) degraded link: transport bandwidth EWMA collapse
            for peer, bw in bw_now.items():
                base = self._bw_base.setdefault(peer, RollingStat())
                if (base.n >= warm and base.mean > 0
                        and bw < base.mean / self.lag_factor):
                    fired.append(self._fire_locked(
                        "degraded_link",
                        link=f"R{self.rank}->R{peer}", suspect=None,
                        value=round(bw, 2), window=win,
                        detail=f"link bw {bw:.1f} MB/s = "
                               f"{bw / base.mean:.2f}x its "
                               f"{base.mean:.1f} MB/s EWMA"))
                base.push(bw)
            # 3) stuck progress: nothing closed for k windows while
            # tasks are pending (one firing per stuck episode)
            if self._activity == self._last_activity and pending > 0:
                self._idle_windows += 1
                if self._idle_windows == self.stuck_windows:
                    fired.append(self._fire_locked(
                        "stuck", link=None, suspect=self.rank,
                        value=pending, window=win,
                        detail=f"no span closures for "
                               f"{self._idle_windows} window(s) with "
                               f"{pending} task(s) pending"))
            else:
                self._idle_windows = 0
            self._last_activity = self._activity
            # status: 2 while a stuck episode is live, 1 for a few
            # windows after any firing, else healthy
            if self._idle_windows >= self.stuck_windows:
                self.status = 2
            elif any(win - f["window"] <= 4 for f in self._firings):
                self.status = 1
            else:
                self.status = 0
        # annotations OUTSIDE the lock: the stream is its own appender
        st = self.stream
        if st is not None:
            for f in fired:
                st.trace(f"health:{f['kind']}",
                         {k: v for k, v in f.items() if v is not None},
                         phase="i")
        # window digest to subscribers, also outside the lock: the
        # controller may turn knobs (transport calls, device attrs)
        # from its callback without deadlock risk
        if self._subscribers:
            digest = {"window": win, "rank": self.rank,
                      "pending": pending, "busy_us": round(busy, 1),
                      "links": dg_links, "bw": dict(bw_now),
                      "lag_us": dg_lag, "fired": fired}
            for fn in list(self._subscribers):
                try:
                    fn(digest)
                except Exception:   # noqa: BLE001 - keep the heartbeat
                    pass
        return fired

    def _fire_locked(self, kind: str, link: Optional[str],
                     suspect: Optional[int], value: Any, window: int,
                     detail: str) -> Dict[str, Any]:   # holds: self._lock
        f = {"kind": kind, "rank": self.rank, "suspect": suspect,
             "link": link, "value": value, "window": window,
             "ts": time.time(), "detail": detail}
        self._firings.append(f)
        self.counts["firings"] += 1
        self.counts["straggler" if kind == "straggler" else
                    "degraded_link" if kind == "degraded_link" else
                    "stuck"] += 1
        return f

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "LiveHealth":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"obs-live-r{self.rank}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.window_ms / 1e3):
            try:
                self.tick()
            except Exception:   # noqa: BLE001 - the monitor must not die
                pass


# ---------------------------------------------------------------------- #
# fleet merge + the one shared formatter (online AND offline reports)    #
# ---------------------------------------------------------------------- #
def fleet_health(per_rank: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Fold N per-rank snapshots into ONE fleet document — the same
    shape ``GET /health`` serves: worst status, merged firings (time
    ordered), per-link exposure across the fleet, the worst link, and
    summed per-pool attribution."""
    ranks = {int(r): s for r, s in per_rank.items()
             if isinstance(s, dict)}
    counts = {"windows": 0, "firings": 0, "straggler": 0,
              "degraded_link": 0, "stuck": 0}
    links: Dict[str, float] = {}
    pools: Dict[str, Dict[str, float]] = {}
    tenants: Dict[str, Dict[str, float]] = {}
    firings: List[Dict[str, Any]] = []
    status = 0
    for r, snap in sorted(ranks.items()):
        status = max(status, int(snap.get("status", 0)))
        for k in counts:
            counts[k] += int(snap.get("counts", {}).get(k, 0))
        for link, us in (snap.get("per_link_exposed_us") or {}).items():
            links[link] = links.get(link, 0.0) + float(us)
        for p, cell in (snap.get("per_pool") or {}).items():
            agg = pools.setdefault(p, {"sent": 0, "recv": 0})
            agg["sent"] += int(cell.get("sent", 0))
            agg["recv"] += int(cell.get("recv", 0))
        for t, cell in (snap.get("per_tenant") or {}).items():
            # serve attribution: counters sum; latency
            # percentiles take the fleet-worst rank (percentiles do
            # not compose — the conservative bound is what SLO gates
            # want)
            agg = tenants.setdefault(
                t, {"sent": 0, "recv": 0, "pools_done": 0,
                    "p50_lat_us": 0.0, "p99_lat_us": 0.0})
            agg["sent"] += int(cell.get("sent", 0))
            agg["recv"] += int(cell.get("recv", 0))
            agg["pools_done"] += int(cell.get("pools_done", 0))
            agg["p50_lat_us"] = max(agg["p50_lat_us"],
                                    float(cell.get("p50_lat_us", 0.0)))
            agg["p99_lat_us"] = max(agg["p99_lat_us"],
                                    float(cell.get("p99_lat_us", 0.0)))
        firings.extend(snap.get("firings") or ())
    firings.sort(key=lambda f: f.get("ts", 0.0))
    worst = max(links.items(), key=lambda kv: kv[1]) if links else None
    doc = {"nb_ranks": len(ranks),
           "status": status,
           "counts": counts,
           "per_link_exposed_us": {k: round(v, 1) for k, v in
                                   sorted(links.items(),
                                          key=lambda kv: -kv[1])},
           "worst_link": ({"link": worst[0],
                           "exposed_us": round(worst[1], 1)}
                          if worst else None),
           "per_pool": pools,
           "firings": firings,
           "ranks": {str(r): s for r, s in sorted(ranks.items())}}
    if tenants:
        doc["per_tenant"] = tenants
    return doc


_STATUS = {0: "healthy", 1: "degraded", 2: "stuck"}


def format_health(doc: Dict[str, Any]) -> str:
    """Text rendering of a health document — accepts BOTH a per-rank
    snapshot (``snapshot()``) and a fleet document (``fleet_health`` /
    ``GET /health``), so the online CLI (tools/obs_top.py), the
    offline renderer (tools/obs_report.py --live), and a saved
    snapshot file all share one code path."""
    fleet = "ranks" in doc and "rank" not in doc
    out: List[str] = []
    status = int(doc.get("status", 0))
    counts = doc.get("counts", {})
    head = (f"fleet of {doc.get('nb_ranks', 0)} rank(s)" if fleet
            else f"rank {doc.get('rank', '?')} "
                 f"({doc.get('windows', 0)} windows of "
                 f"{doc.get('window_ms', 0)} ms)")
    out.append(f"health: {_STATUS.get(status, status)} — {head}, "
               f"{counts.get('firings', 0)} firing(s) "
               f"[straggler={counts.get('straggler', 0)} "
               f"degraded_link={counts.get('degraded_link', 0)} "
               f"stuck={counts.get('stuck', 0)}]")
    if fleet:
        wl = doc.get("worst_link")
        if wl:
            out.append(f"worst link: {wl['link']} "
                       f"exposed={wl['exposed_us'] / 1e3:.3f} ms")
        for r, snap in sorted(doc.get("ranks", {}).items(),
                              key=lambda kv: int(kv[0])):
            ov = snap.get("overlap", {})
            out.append(f"  rank {r}: {_STATUS.get(snap.get('status', 0))} "
                       f"overlap={ov.get('overlap_fraction', 1.0):.3f} "
                       f"comm={ov.get('comm_us', 0.0) / 1e3:.3f} ms "
                       f"exposed={(ov.get('comm_us', 0.0) - ov.get('overlap_us', 0.0)) / 1e3:.3f} ms")
    else:
        ov = doc.get("overlap", {})
        out.append(f"overlap: fraction="
                   f"{ov.get('overlap_fraction', 1.0):.3f} "
                   f"compute={ov.get('compute_us', 0.0) / 1e3:.3f} ms "
                   f"comm={ov.get('comm_us', 0.0) / 1e3:.3f} ms")
    exposed = doc.get("per_link_exposed_us") or {}
    if exposed:
        out.append("per-link exposed wait:")
        for link, us in list(exposed.items())[:8]:
            out.append(f"  {link:<12} {float(us) / 1e3:.3f} ms")
    lag = doc.get("per_link_lag_us") or {}
    if lag:
        out.append("per-link flow lag:")
        for link, cell in sorted(lag.items()):
            out.append(f"  {link:<12} ewma={cell.get('ewma_us', 0.0):.1f} us "
                       f"p95={cell.get('p95_us', 0.0):.1f} us "
                       f"n={cell.get('n', 0)}")
    pools = doc.get("per_pool") or {}
    if pools:
        out.append("per-taskpool attribution:")
        for p, cell in sorted(pools.items()):
            line = (f"  pool {p:<6} sent={cell.get('sent', 0)} "
                    f"recv={cell.get('recv', 0)}")
            if "lag_us_mean" in cell:
                line += f" lag_mean={cell['lag_us_mean']:.1f} us"
            out.append(line)
    # serve attribution: rendered only when a SessionServer
    # fed tenant data — pre-serve snapshots have no per_tenant key and
    # keep the exact pre-serve rendering
    tenants = doc.get("per_tenant") or {}
    if tenants:
        out.append("per-tenant attribution:")
        for t, cell in sorted(tenants.items()):
            line = (f"  tenant {t:<10} pools_done="
                    f"{cell.get('pools_done', 0)} "
                    f"sent={cell.get('sent', 0)} "
                    f"recv={cell.get('recv', 0)}")
            p99 = cell.get("p99_lat_us")
            if p99:
                line += (f" p50={cell.get('p50_lat_us', 0.0) / 1e3:.3f} ms"
                         f" p99={float(p99) / 1e3:.3f} ms")
            out.append(line)
    firings = doc.get("firings") or []
    if firings:
        out.append(f"recent firings ({len(firings)}):")
        for f in firings[-8:]:
            who = (f" link={f['link']}" if f.get("link") else "") + \
                  (f" suspect=R{f['suspect']}"
                   if f.get("suspect") is not None else "")
            out.append(f"  [w{f.get('window', '?')}] rank {f.get('rank')} "
                       f"{f.get('kind')}:{who} — {f.get('detail', '')}")
    return "\n".join(out)


def register_health_gauges(sde: Any, live: LiveHealth) -> None:
    """Poll gauges over the live monitor's counters — registered by the
    obs wiring ONLY under the ``obs_live`` knob (an unset knob must
    add no gauges at all)."""
    sde.register_poll(OBS_HEALTH_STATUS, live.gauge_status)
    sde.register_poll(OBS_HEALTH_WINDOWS, lambda: live._count("windows"))
    sde.register_poll(OBS_HEALTH_FIRINGS, lambda: live._count("firings"))
    sde.register_poll(OBS_HEALTH_STRAGGLER,
                      lambda: live._count("straggler"))
    sde.register_poll(OBS_HEALTH_DEGRADED,
                      lambda: live._count("degraded_link"))
    sde.register_poll(OBS_HEALTH_STUCK, lambda: live._count("stuck"))
    sde.register_poll(OBS_HEALTH_WORST_LINK_US, live.gauge_worst_link_us)
