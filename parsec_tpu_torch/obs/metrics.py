"""Unified metrics registry: counters + gauges + histograms.

The runtime already has two counter islands — the per-context SDE
registry (``profiling.sde``, owned counters + poll gauges) and ad-hoc
``stats`` dicts on engines/devices. ``MetricsRegistry`` wraps an
SDERegistry (so every existing ``PARSEC::*`` counter shows up
unchanged) and adds the one kind neither island has: **histograms**
(task-execution and transfer latency distributions), plus Prometheus
text exposition through ``obs.prometheus``.

Naming follows the reference's ``PARSEC::``-style namespace; exposition
sanitizes it to ``parsec_*`` metric names.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence

from ..profiling.pins import PinsEvent, PinsModule
from ..profiling.sde import SDERegistry

__all__ = ["Histogram", "MetricsRegistry", "MetricsTaskModule", "ExecTimer",
           "TASK_EXEC_SECONDS", "COMM_XFER_SECONDS"]

TASK_EXEC_SECONDS = "PARSEC::TASK::EXEC_SECONDS"
COMM_XFER_SECONDS = "PARSEC::COMM::XFER_SECONDS"

#: default latency buckets (seconds): 1 us .. 10 s, decade steps with a
#: midpoint — wide enough for both Python task bodies and DCN transfers
DEFAULT_BUCKETS = (1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2,
                   1e-1, 5e-1, 1.0, 10.0)


class Histogram:
    """Fixed-bucket cumulative histogram (the Prometheus model: each
    bucket counts observations <= its upper bound)."""

    __slots__ = ("name", "bounds", "counts", "sum", "count", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if value <= b:
                idx = i
                break
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        cum, buckets = 0, []
        for b, c in zip(self.bounds, counts):
            cum += c
            buckets.append((b, cum))
        buckets.append((float("inf"), total))
        return {"buckets": buckets, "sum": s, "count": total}

    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """One façade over counters (SDE owned), gauges (SDE polls), and
    histograms. Always constructed per Context (cheap: two dicts); the
    hot-path *feeders* — the PINS latency module, comm span hooks — are
    only enabled when metrics/profiling are switched on, so disabled
    runs keep the near-free fast path."""

    def __init__(self, sde: Optional[SDERegistry] = None) -> None:
        self.sde = sde if sde is not None else SDERegistry()
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # -- counters / gauges (delegate to the SDE registry) -------------------
    def inc(self, name: str, v: int = 1) -> None:
        self.sde.inc(name, v)

    def gauge(self, name: str, fn: Callable[[], Any]) -> None:
        self.sde.register_poll(name, fn)

    def read(self, name: str) -> Any:
        return self.sde.read(name)

    # -- histograms ----------------------------------------------------------
    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name, buckets))
        return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._hists)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = self.sde.snapshot()
        for name, h in self.histograms().items():
            out[name] = h.snapshot()
        return out

    def render_prometheus(self, labels: Optional[Dict[str, str]] = None) -> str:
        from .prometheus import render
        return render(self, labels=labels)


class ExecTimer:
    """The single exec-latency feed: per-thread begin timestamps into a
    histogram. Shared by MetricsTaskModule (metrics without profiling)
    and TaskProfilerModule.exec_timer (metrics + profiling, one PINS
    callback instead of two) so the measurement exists exactly once.
    When an ``OverlapTracker`` is attached the same intervals also feed
    the live overlap gauge's COMPUTE channel (obs/spans.py)."""

    __slots__ = ("hist", "_open", "_time", "tracker", "live")

    def __init__(self, hist: Histogram, tracker: Any = None,
                 live: Any = None) -> None:
        import time
        self._time = time
        self.hist = hist
        self._open: Dict[int, int] = {}
        self.tracker = tracker
        # obs_live: the same closed exec intervals also feed
        # the streaming health monitor's compute channel
        self.live = live

    def begin(self, th_id: int) -> None:
        self._open[th_id] = self._time.monotonic_ns()

    def end(self, th_id: int) -> None:
        t0 = self._open.pop(th_id, None)
        if t0 is not None:
            t1 = self._time.monotonic_ns()
            self.hist.observe((t1 - t0) / 1e9)
            if self.tracker is not None:
                self.tracker.note("compute", t0, t1)
            if self.live is not None:
                self.live.note_compute(t0, t1)


class MetricsTaskModule(PinsModule):
    """PINS module feeding the per-task execution-latency histogram —
    rides the existing ``_active == 0`` fast-path guard, so with metrics
    off the EXEC sites stay near-free."""

    name = "metrics_task"
    events = [PinsEvent.EXEC_BEGIN, PinsEvent.EXEC_END]

    def __init__(self, metrics: MetricsRegistry, context: Any = None,
                 tracker: Any = None, live: Any = None) -> None:
        self.metrics = metrics
        # context filter: several in-process SPMD ranks share the global
        # PINS sites, but each rank's histogram must only see its own
        # tasks (same isolation as the per-context SDE registry)
        self.context = context
        self.timer = ExecTimer(metrics.histogram(TASK_EXEC_SECONDS),
                               tracker=tracker, live=live)

    def callback(self, es: Any, event: PinsEvent, payload: Any) -> None:
        if self.context is not None and es.context is not self.context:
            return
        if event == PinsEvent.EXEC_BEGIN:
            self.timer.begin(es.th_id)
        else:
            self.timer.end(es.th_id)
