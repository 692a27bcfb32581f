"""Prometheus text exposition (version 0.0.4) for the metrics registry.

``render(metrics)`` turns a :class:`obs.metrics.MetricsRegistry` into the
plain-text format every Prometheus scraper understands: the SDE owned
counters become ``counter`` samples, poll gauges become ``gauge``
samples, histograms become the ``_bucket``/``_sum``/``_count`` triple.
``PARSEC::COMM::BYTES_SENT`` exposes as ``parsec_comm_bytes_sent``.

``parse_exposition`` is the line-format validator used by the test
suite and by tools that round-trip the output — intentionally strict on
the grammar (names, label blocks, float values) so a malformed render
fails loudly in CI rather than silently at scrape time.

``fleet_to_prometheus`` renders an aggregator-server fleet snapshot
(per-rank last values) so ``tools/aggregator_server.py`` can serve a
real ``GET /metrics`` endpoint for a running job.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Tuple

__all__ = ["sanitize_name", "render", "parse_exposition",
           "fleet_to_prometheus"]

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r"\s+(?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?:\s+[0-9]+)?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def sanitize_name(name: str) -> str:
    """``PARSEC::COMM::BYTES_SENT`` -> ``parsec_comm_bytes_sent``."""
    out = re.sub(r"[^a-zA-Z0-9_]", "_", name.replace("::", "_")).lower()
    out = re.sub(r"_+", "_", out).strip("_")
    if not out or out[0].isdigit():
        out = "m_" + out
    return out


def _fmt_value(v: Any) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_str(labels: Optional[Dict[str, str]],
                extra: Optional[Dict[str, str]] = None) -> str:
    merged: Dict[str, str] = {}
    if labels:
        merged.update(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(merged.items()))
    return "{" + body + "}"


def render(metrics: Any, labels: Optional[Dict[str, str]] = None,
           extra_sde: Any = None) -> str:
    """Text exposition of a MetricsRegistry (counters, gauges,
    histograms). ``labels`` are attached to every sample (e.g.
    ``{"rank": "3"}``). ``extra_sde`` merges a second SDE registry —
    e.g. the process-global one carrying PARSEC::MEMPOOL::* and
    contextless user counters — with the registry's own names winning
    on collision."""
    counters, gauges = metrics.sde.snapshot_typed()
    if extra_sde is not None:
        xc, xg = extra_sde.snapshot_typed()
        counters = {**xc, **counters}
        gauges = {**xg, **gauges}
    # a name must expose as exactly ONE kind: duplicate metric names
    # with conflicting # TYPE lines make Prometheus reject the whole
    # exposition. Cross-kind collisions (same name owned in one
    # registry, polled in another) resolve to the counter.
    gauges = {k: v for k, v in gauges.items() if k not in counters}
    lines = []
    for name in sorted(counters):
        m = sanitize_name(name)
        lines.append(f"# HELP {m} {name}")
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{_labels_str(labels)} {_fmt_value(counters[name])}")
    for name in sorted(gauges):
        m = sanitize_name(name)
        lines.append(f"# HELP {m} {name}")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{_labels_str(labels)} {_fmt_value(gauges[name])}")
    for name, hist in sorted(metrics.histograms().items()):
        m = sanitize_name(name)
        snap = hist.snapshot()
        lines.append(f"# HELP {m} {name}")
        lines.append(f"# TYPE {m} histogram")
        for le, cum in snap["buckets"]:
            le_s = "+Inf" if math.isinf(le) else _fmt_value(le)
            lines.append(
                f"{m}_bucket{_labels_str(labels, {'le': le_s})} {cum}")
        lines.append(f"{m}_sum{_labels_str(labels)} {_fmt_value(snap['sum'])}")
        lines.append(f"{m}_count{_labels_str(labels)} {snap['count']}")
    return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Strict line-format check. Returns {(metric, labels): value};
    raises ValueError on any malformed line."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: malformed comment {line!r}")
            if not _NAME_OK.match(parts[2]):
                raise ValueError(f"line {lineno}: bad metric name {parts[2]!r}")
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels: Tuple[Tuple[str, str], ...] = ()
        lbl = m.group("labels")
        if lbl:
            body = lbl[1:-1].rstrip(",")
            if body:
                found = _LABEL.findall(body)
                rebuilt = ",".join(f'{k}="{v}"' for k, v in found)
                if rebuilt != body:
                    raise ValueError(
                        f"line {lineno}: malformed labels {lbl!r}")
                labels = tuple(found)
        v = m.group("value")
        out[(m.group("name"), labels)] = float(
            v.replace("Inf", "inf").replace("NaN", "nan"))
    return out


def fleet_to_prometheus(fleet: Dict[str, Any]) -> str:
    """Render an AggregatorServer.fleet() snapshot: each counter's last
    value per rank as a gauge sample labeled ``rank="<r>"``."""
    lines = []
    for name, agg in sorted(fleet.get("counters", {}).items()):
        m = sanitize_name(name)
        lines.append(f"# HELP {m} {name}")
        lines.append(f"# TYPE {m} gauge")
        for rank, cell in sorted(agg.get("ranks", {}).items()):
            lines.append(
                f'{m}{{rank="{rank}"}} {_fmt_value(cell.get("last"))}')
    lines.append("# HELP parsec_aggregator_pushes_total pushes received")
    lines.append("# TYPE parsec_aggregator_pushes_total counter")
    lines.append(f"parsec_aggregator_pushes_total {fleet.get('nb_pushes', 0)}")
    return "\n".join(lines) + "\n"
