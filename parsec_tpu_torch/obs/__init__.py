"""obs — runtime-wide telemetry: one façade over the profiling islands.

The JAX package's ``obs`` package, carried over: the span traces
(``profiling.trace``), the hot-path callback sites (``profiling.pins``)
and the software counters (``profiling.sde``), plus the ``stats`` dicts
of the comm engine and devices, behind one wiring object:

- :mod:`obs.metrics` — ``MetricsRegistry``: counters/gauges (wrapping the
  per-context SDE registry) + latency histograms, fed by a PINS module;
- :mod:`obs.spans` — ``CommObs``/``DeviceObs``: span tracing + byte
  counters for the comm engine and device transfers (a single
  ``_obs is None`` check on the hot path, the PINS ``_active == 0``
  pattern); on a CUDA device ``DeviceObs`` also records the stream's
  busy intervals from timed CUDA events;
- :mod:`obs.prometheus` — text exposition + strict line-format parser;
- :mod:`obs.critpath` — offline critical-path / per-class breakdown /
  compute-comm overlap analysis, the fleet trace merge and the
  cross-rank flow stitching;
- :mod:`obs.live` — the streaming health monitor (``obs_live``).

Enable per run with ``Context(profile=True)`` (spans + counters), the
``metrics`` MCA param (histograms + counters without trace collection),
``obs_flow`` (cross-rank flow contexts on the wire) and ``obs_live``
(the monitor thread).  ``ContextObs`` is the per-context wiring object;
the runtime creates one in ``Context.__init__``.  ``tune_auto`` and
``serve`` imply ``obs_live``: the self-tuning controller (tune/) rides
the monitor's window tick, and a SessionServer (serve/) charges each
tenant's latency into it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .critpath import (analyze, critical_path, distributed_critical_path,
                       format_report, load_flow_events, merge_trace_docs,
                       parse_dot, per_link_exposed_wait, rank_clock_shifts,
                       rank_wall_split, stitch_flows)
from .live import (LiveHealth, RollingStat, fleet_health, format_health,
                   register_health_gauges)
from .metrics import (COMM_XFER_SECONDS, TASK_EXEC_SECONDS, Histogram,
                      MetricsRegistry, MetricsTaskModule)
from .prometheus import (fleet_to_prometheus, parse_exposition, render,
                         sanitize_name)
from .spans import (COMM_ACTIVE_TRANSFERS, COMM_BYTES_RECEIVED,
                    COMM_BYTES_SENT, COMM_CHUNKS_INFLIGHT, COMM_COALESCED,
                    COMM_COMPRESS_RATIO, COMM_DUP_DROPPED,
                    COMM_LINK_BW_PREFIX,
                    COMM_MSGS_RECEIVED, COMM_MSGS_SENT,
                    COMM_PENDING_MESSAGES, COMM_RECONNECTS,
                    COMM_REPLAYED_FRAMES, COMM_SUSPECT_MS,
                    CommObs, DeviceObs, HEALTH_STREAM_TID,
                    FT_ELASTIC_JOINS, FT_ELASTIC_RESIZES, FT_HB_RTT_PREFIX,
                    FT_PEER_ALIVE, FT_RESHARD_BYTES, FT_RESHARD_US,
                    OBS_CLOCK_OFFSET_PREFIX, OBS_EXPOSED_COMM_US,
                    OBS_FLOW_RECV, OBS_FLOW_SENT,
                    OBS_HEALTH_DEGRADED, OBS_HEALTH_FIRINGS,
                    OBS_HEALTH_STATUS, OBS_HEALTH_STRAGGLER,
                    OBS_HEALTH_STUCK, OBS_HEALTH_WINDOWS,
                    OBS_HEALTH_WORST_LINK_US, OBS_OVERLAP_FRACTION,
                    OverlapTracker, SERVE_ADMITTED, SERVE_INFLIGHT_PREFIX,
                    SERVE_P99_LATENCY_PREFIX, SERVE_QUEUED,
                    SERVE_QUOTA_BYTES_PREFIX, SERVE_REJECTED, SERVE_TENANTS,
                    TUNE_ACTIVE_CODEC_PREFIX,
                    TUNE_DECISIONS, TUNE_OBJECTIVE_US, TUNE_REVERTS,
                    flow_event_id, inbound_flow_ctx,
                    payload_nbytes, register_device_gauges)

__all__ = [
    "MetricsRegistry", "Histogram", "MetricsTaskModule", "ContextObs",
    "CommObs", "DeviceObs", "OverlapTracker", "payload_nbytes",
    "COMM_BYTES_SENT", "COMM_BYTES_RECEIVED", "COMM_MSGS_SENT",
    "COMM_MSGS_RECEIVED", "COMM_ACTIVE_TRANSFERS", "COMM_PENDING_MESSAGES",
    "COMM_COALESCED", "COMM_CHUNKS_INFLIGHT", "COMM_COMPRESS_RATIO",
    "COMM_LINK_BW_PREFIX", "COMM_RECONNECTS", "COMM_REPLAYED_FRAMES",
    "COMM_DUP_DROPPED", "COMM_SUSPECT_MS",
    "FT_PEER_ALIVE", "FT_HB_RTT_PREFIX",
    "FT_ELASTIC_RESIZES", "FT_ELASTIC_JOINS", "FT_RESHARD_BYTES",
    "FT_RESHARD_US",
    "OBS_OVERLAP_FRACTION", "OBS_EXPOSED_COMM_US",
    "OBS_FLOW_SENT", "OBS_FLOW_RECV", "OBS_CLOCK_OFFSET_PREFIX",
    "OBS_HEALTH_STATUS", "OBS_HEALTH_WINDOWS", "OBS_HEALTH_FIRINGS",
    "OBS_HEALTH_STRAGGLER", "OBS_HEALTH_DEGRADED", "OBS_HEALTH_STUCK",
    "OBS_HEALTH_WORST_LINK_US",
    "TUNE_DECISIONS", "TUNE_REVERTS", "TUNE_ACTIVE_CODEC_PREFIX",
    "TUNE_OBJECTIVE_US",
    "SERVE_TENANTS", "SERVE_ADMITTED", "SERVE_REJECTED", "SERVE_QUEUED",
    "SERVE_INFLIGHT_PREFIX", "SERVE_QUOTA_BYTES_PREFIX",
    "SERVE_P99_LATENCY_PREFIX",
    "LiveHealth", "RollingStat", "fleet_health", "format_health",
    "register_health_gauges",
    "flow_event_id", "inbound_flow_ctx",
    "TASK_EXEC_SECONDS", "COMM_XFER_SECONDS",
    "render", "parse_exposition", "sanitize_name", "fleet_to_prometheus",
    "analyze", "critical_path", "format_report", "parse_dot",
    "merge_trace_docs", "rank_clock_shifts", "stitch_flows",
    "load_flow_events", "distributed_critical_path",
    "per_link_exposed_wait", "rank_wall_split",
    "validate_chrome_trace",
]


class ContextObs:
    """Per-context telemetry wiring. Constructed by ``Context.__init__``
    once the SDE registry, profile, comm engine, and devices exist.

    Pull gauges (device memory/load, pending comm queues) are registered
    unconditionally — they cost nothing until something reads them. The
    hot-path hooks (comm spans/byte counters, device transfer spans, the
    task-latency PINS module) are installed only when tracing or metrics
    collection is on, so a bare run keeps the near-free fast path."""

    def __init__(self, ctx: Any) -> None:
        self.metrics = MetricsRegistry(ctx.sde)
        tune_on = _tune_param()
        # tune_auto implies obs_live: the controller's only input is the
        # monitor's window digest, so the knob pulls the whole monitor up
        # with it; serve implies it the same way (per-tenant SLO
        # attribution lives in the monitor's window digests)
        live_on = _live_param() or tune_on or _serve_param()
        # obs_live implies the span sinks: the streaming monitor's feeds
        # ARE the comm/device/exec hooks, so the knob alone turns
        # telemetry on even without profile= or metrics
        self.enabled = bool(ctx.profile is not None or _metrics_param()
                            or live_on)
        self._engines: List[Any] = []
        self._devices: List[Any] = []
        self._task_module: Optional[MetricsTaskModule] = None
        self._profiler_with_hist: Optional[Any] = None
        # streaming health monitor (obs/live.py): rolling per-link
        # exposure / overlap / lag + anomaly detectors, constructed
        # ONLY under the knob — unset means no object, no thread, no
        # gauges (the inertness contract)
        self.live: Optional[LiveHealth] = None
        if live_on:
            from ..utils.params import params
            self.live = LiveHealth(
                ctx.rank,
                window_ms=params.get_or("obs_live_window_ms", "int", 250),
                stream=(ctx.profile.stream(HEALTH_STREAM_TID, "health")
                        if ctx.profile is not None else None),
                pending_fn=getattr(ctx, "_pending_gauge", None))
            register_health_gauges(ctx.sde, self.live)
        # live T3 overlap gauge: compute/comm interval
        # accumulator behind PARSEC::OBS::OVERLAP_FRACTION — only with
        # telemetry on (its feeds are the span sinks below)
        self.overlap: Optional[OverlapTracker] = None
        if self.enabled:
            self.overlap = OverlapTracker()
            ctx.sde.register_poll(OBS_OVERLAP_FRACTION, self.overlap.fraction)
            ctx.sde.register_poll(OBS_EXPOSED_COMM_US, self.overlap.exposed_us)
        # stage-compile gauges (stagec/): poll-only over the context's
        # stage counters, the XSTAGE_* series those of the cross-rank
        # SPMD stages (stagec/xrank.py)
        ss = getattr(ctx, "stage_stats", None)
        if isinstance(ss, dict):
            for key in ("stage_compiles", "stage_tasks", "stage_fallbacks",
                        "prestage_issued", "prestage_hits", "chain_links",
                        "chain_fallbacks", "residue_batches",
                        "residue_batch_tasks", "xstage_compiles",
                        "xstage_tasks", "xstage_collective_bytes",
                        "xstage_fallbacks"):
                ctx.sde.register_poll(f"PARSEC::STAGEC::{key.upper()}",
                                      lambda s=ss, k=key: s[k])
            ctx.sde.register_poll(
                "PARSEC::STAGEC::STAGE_COMPILE_US",
                lambda s=ss: round(s["stage_compile_ns"] / 1e3, 1))
        # device pull gauges always (poll-only, no hot-path cost); the
        # span/histogram sink only when telemetry is on
        for dev in ctx.devices:
            register_device_gauges(ctx.sde, dev)
            if self.enabled:
                dev._obs = DeviceObs(self.metrics, dev, profile=ctx.profile,
                                     tracker=self.overlap, live=self.live)
                self._devices.append(dev)
        ce = getattr(ctx.comm, "ce", ctx.comm) if ctx.comm is not None else None
        if ce is not None:
            comm_obs = CommObs(self.metrics,
                               profile=ctx.profile if self.enabled else None,
                               tracker=self.overlap if self.enabled else None,
                               live=self.live)
            comm_obs.register_engine_gauges(ce)
            if self.enabled:
                ce._obs = comm_obs
                self._engines.append(ce)
                # cross-rank flow tracing: arm the wire
                # trace-context allocator — sends toward negotiated
                # peers stamp a (origin, span) context and emit the
                # "s" half of the flow edge; deliver_message emits the
                # "f" half on the receiver.  A transport that resolved
                # the knob itself (TCPCommEngine's obs_flow ctor
                # override) is the source of truth — it already
                # advertised (or withheld) the "tr" capability
                flow_on = getattr(ce, "_flow_enabled", None)
                if flow_on is None:
                    # in-process fabrics: either knob arms the
                    # allocator (obs_live rides the flow machinery)
                    flow_on = _flow_param() or self.live is not None
                if flow_on:
                    from ..comm.engine import FlowIds
                    ce._flow = FlowIds(ce.rank)
                    if self.live is not None:
                        # obs_live: widen stamped contexts toward
                        # lv-negotiated peers with (pool, t_send_ns)
                        ce._flow.live = True
            if self.live is not None:
                # late-bind the transport's live estimators: clock
                # offsets (flow-lag conversion) + link-bandwidth EWMA
                # (the degraded-link detector's second signal)
                self.live.bind_engine(ce)
            # remote-dep protocol counters as pull gauges
            stats = getattr(ctx.comm, "stats", None)
            if isinstance(stats, dict):
                for key in stats:
                    self.metrics.gauge(
                        f"PARSEC::COMM::{key.upper()}",
                        lambda s=stats, k=key: s[k])
        if self.enabled:
            profiler = getattr(ctx, "_task_profiler", None)
            if profiler is not None:
                # profiling on: the task profiler already hooks EXEC
                # begin/end — feed the histogram from it instead of
                # registering a second PINS callback on the hot path
                from .metrics import ExecTimer
                profiler.exec_timer = ExecTimer(
                    self.metrics.histogram(TASK_EXEC_SECONDS),
                    tracker=self.overlap, live=self.live)
                self._profiler_with_hist = profiler
            else:
                self._task_module = MetricsTaskModule(self.metrics,
                                                      context=ctx,
                                                      tracker=self.overlap,
                                                      live=self.live)
                self._task_module.enable()
        # closed-loop self-tuning (tune/controller.py): the controller
        # rides the monitor's window-tick subscriber seam — constructed
        # ONLY under tune_auto, after every actuation target (transport,
        # devices, overlap tracker) exists, before the monitor thread
        # starts ticking
        self.tuner = None
        if tune_on and self.live is not None:
            from ..tune import Controller, register_tune_gauges
            from ..utils.params import params
            raw = str(params.get_or("tune_residual_budget", "string",
                                    "1e-2") or "").strip()
            self.tuner = Controller(
                ctx.rank, self.live,
                engine=ce,
                devices=tuple(ctx.devices),
                residual_budget=float(raw) if raw else 0.0,
                hysteresis=params.get_or("tune_hysteresis_windows",
                                         "int", 2),
                z_thresh=self.live.z_thresh,
                overlap_fn=(self.overlap.fraction
                            if self.overlap is not None else None),
                stage_classes_fn=lambda c=ctx: _compiled_stage_classes(c))
            register_tune_gauges(ctx.sde, self.tuner)
            self.live.subscribe(self.tuner.on_window)
        if self.live is not None:
            # the rolling-window monitor thread (detectors + window
            # folds) — the last thing started, so every feed is wired
            self.live.start()

    def fini(self) -> None:
        """Unhook from global PINS sites and the engine/device sinks (a
        later context must not feed this context's histograms)."""
        if self.live is not None:
            self.live.stop()
        if self._task_module is not None:
            self._task_module.disable()
            self._task_module = None
        if self._profiler_with_hist is not None:
            self._profiler_with_hist.exec_timer = None
            self._profiler_with_hist = None
        for ce in self._engines:
            ce._obs = None
            ce._flow = None
        self._engines.clear()
        for dev in self._devices:
            dev._obs.close()
            dev._obs = None
        self._devices.clear()

    def render_prometheus(self, labels: Optional[Dict[str, str]] = None) -> str:
        from ..profiling.sde import sde as global_sde
        # include the process-global registry (named mempools, user
        # counters) so every documented name appears in one exposition
        return render(self.metrics, labels=labels, extra_sde=global_sde)


def _metrics_param() -> bool:
    from ..utils.params import params
    try:
        return bool(params.get("metrics"))
    except KeyError:  # pragma: no cover - param registered at import
        return False


def _flow_param() -> bool:
    from ..utils.params import params
    return bool(params.get_or("obs_flow", "bool", False))


def _tune_param() -> bool:
    from ..utils.params import params
    return bool(params.get_or("tune_auto", "bool", False))


def _serve_param() -> bool:
    from ..utils.params import params
    return bool(params.get_or("serve", "bool", False))


def _compiled_stage_classes(ctx: Any) -> List[str]:
    """Class names with a live compiled stage on this context (the stage
    compilers of its taskpools, stagec/runtime.py), in plan order — the
    stage-compile family's attribution source; an interpreted-only
    context returns []."""
    names: List[str] = []
    for tp in list(getattr(ctx, "taskpools", {}).values()):
        sc = getattr(tp, "_stagec", None)
        if sc is None:
            continue
        for stage in getattr(sc.plan, "stages", ()):
            for m in stage.members:
                n = m.tc.name
                if n not in names:
                    names.append(n)
    return names


def _live_param() -> bool:
    from ..utils.params import params
    return bool(params.get_or("obs_live", "bool", False))


# ---------------------------------------------------------------------- #
# minimal Chrome-trace schema check (used by the CI smoke test)          #
# ---------------------------------------------------------------------- #
def validate_chrome_trace(doc: Any) -> Dict[str, int]:
    """Validate the exported trace against the minimal schema Perfetto
    needs: a ``traceEvents`` list of dicts, each with a string ``name``
    and ``ph``, numeric ``ts`` for non-metadata events, per
    (pid, tid, name) matched B/E counts, and — for flow events
    (``ph:"s"``/``"f"``) — a flow ``id`` per event with
    start/finish PAIRING accounted order-independently (the receiver
    half of an edge may precede the sender half in a merged list).
    Returns summary counts including matched ``flows`` and the
    ``unmatched_flows`` remainder (one-sided edges are a lost-message
    or truncated-trace signal, not a schema violation); raises
    ValueError on any violation."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    opens: Dict[tuple, int] = {}
    flow_s: Dict[Any, int] = {}
    flow_f: Dict[Any, int] = {}
    n_spans = n_meta = n_counter = 0
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        if not isinstance(ev.get("name"), str) or not isinstance(
                ev.get("ph"), str):
            raise ValueError(f"event {i} missing name/ph")
        ph = ev["ph"]
        if ph == "M":
            n_meta += 1
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event {i} ({ev['name']}) missing numeric ts")
        key = (ev.get("pid", 0), ev.get("tid", 0), ev["name"])
        if ph == "B":
            opens[key] = opens.get(key, 0) + 1
            n_spans += 1
        elif ph == "E":
            if opens.get(key, 0) <= 0:
                raise ValueError(f"event {i}: E without matching B for {key}")
            opens[key] -= 1
        elif ph == "X":
            if not isinstance(ev.get("dur"), (int, float)):
                raise ValueError(
                    f"event {i} ({ev['name']}): X event missing numeric dur")
            n_spans += 1
        elif ph == "C":
            n_counter += 1
        elif ph in ("s", "f"):
            if not isinstance(ev.get("id"), (int, str)):
                raise ValueError(
                    f"event {i} ({ev['name']}): flow event missing id")
            side = flow_s if ph == "s" else flow_f
            side[ev["id"]] = side.get(ev["id"], 0) + 1
    unclosed = {k: v for k, v in opens.items() if v}
    if unclosed:
        raise ValueError(f"unclosed spans: {sorted(unclosed)[:5]}")
    matched = sum(min(n, flow_f.get(fid, 0)) for fid, n in flow_s.items())
    total_flow_ev = sum(flow_s.values()) + sum(flow_f.values())
    return {"spans": n_spans, "metadata": n_meta, "counters": n_counter,
            "flows": matched, "unmatched_flows": total_flow_ev - 2 * matched,
            "events": len(doc["traceEvents"])}
