"""OTF2 trace export — the profiling_otf2.c analog.

Reference behavior: an alternative trace backend that writes OTF2
archives directly instead of the dbp binary format, mapping per-thread
event streams to OTF2 locations, event classes to OTF2 regions, and
counter samples to OTF2 metrics (ref: parsec/profiling_otf2.c:1-1247;
selected at build time by PARSEC_PROF_TRACE_SYSTEM=otf2).

Here export is offline (any in-memory or .ptt Profile
can be converted after the run — no build-time switch needed). When the
real ``otf2`` Python bindings are installed, they are used and the
archive is readable by otf2-print/Vampir. Without them (this
environment), the fallback writer below produces an archive with the
same *structure* — an anchor file plus a trace directory holding one
global-definitions file and one event file per location, ULEB128-
compressed records with delta-encoded timestamps, which is OTF2's
storage scheme — validated by the matching reader in this module.

Record vocabulary (subset):

  global defs:  STRING(id, utf8)  CLOCK(resolution, t0)
                LOCATION_GROUP(id, name_ref, rank)
                LOCATION(id, name_ref, group_ref, nb_events, tid)
                REGION(id, name_ref)  METRIC(id, name_ref)
  events:       ENTER(dt, region)  LEAVE(dt, region)
                METRIC_SAMPLE(dt, metric, f64)  MARKER(dt, region)

All integers are ULEB128 varints except the METRIC_SAMPLE value (f64 LE).
Timestamps are nanosecond deltas from the previous event in the same
location (first event: delta from the clock t0), OTF2's timestamp
compression model.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, BinaryIO, Dict, List, Tuple

ANCHOR_MAGIC = b"OTF2-LITE\n"
FORMAT_VERSION = 1

# record type tags
DEF_STRING = 0x01
DEF_CLOCK = 0x02
DEF_LOCATION_GROUP = 0x03
DEF_LOCATION = 0x04
DEF_REGION = 0x05
DEF_METRIC = 0x06
EVT_ENTER = 0x10
EVT_LEAVE = 0x11
EVT_METRIC = 0x12
EVT_MARKER = 0x13


def _w_uleb(fh: BinaryIO, v: int) -> None:
    if v < 0:
        raise ValueError("uleb128 encodes unsigned values only")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            fh.write(bytes((b | 0x80,)))
        else:
            fh.write(bytes((b,)))
            return


def _r_uleb(fh: BinaryIO) -> int:
    shift = 0
    out = 0
    while True:
        raw = fh.read(1)
        if not raw:
            raise EOFError("truncated varint")
        b = raw[0]
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out
        shift += 7


class _StringTable:
    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self.strings: List[str] = []

    def ref(self, s: str) -> int:
        sid = self._ids.get(s)
        if sid is None:
            sid = len(self.strings)
            self._ids[s] = sid
            self.strings.append(s)
        return sid


def _have_real_otf2() -> bool:
    try:
        import otf2  # noqa: F401
        return True
    except ImportError:
        return False


def _normalized_events(st):
    """Expand complete ("X") spans — comm/device telemetry — into B/E
    pairs and sort by timestamp: OTF2 event streams are strictly
    time-ordered, while X events are appended at completion carrying
    begin timestamps in the past."""
    out = []
    for ts, ph, key, info in st.events:
        if ph == "X":
            dur = (info or {}).get("dur_ns", 0)
            out.append((ts, "B", key, None))
            out.append((ts + dur, "E", key, None))
        else:
            out.append((ts, ph, key, info))
    out.sort(key=lambda e: e[0])
    return out


def write_otf2(profile, path: str) -> str:
    """Write ``profile`` as an OTF2 archive rooted at ``path`` (a
    directory name). Returns the anchor path — ``<path>/anchor.otf2``
    for the structural fallback format, ``<path>/traces.otf2`` when the
    real otf2 bindings are importable; either return value feeds
    straight back into :func:`read_otf2`."""
    if _have_real_otf2():  # pragma: no cover - bindings absent in CI image
        return _write_real_otf2(profile, path)
    os.makedirs(os.path.join(path, "traces"), exist_ok=True)
    strings = _StringTable()
    streams = sorted(profile._streams.items())

    # regions/metrics discovered from the event streams
    region_ids: Dict[str, int] = {}
    metric_ids: Dict[str, int] = {}
    for _tid, st in streams:
        for _ts, ph, key, _info in st.events:
            if ph == "C":
                metric_ids.setdefault(key, len(metric_ids))
            else:
                region_ids.setdefault(key, len(region_ids))

    # one event file per location (= per thread stream)
    for loc_id, (tid, st) in enumerate(streams):
        with open(os.path.join(path, "traces", f"{loc_id}.evt"), "wb") as fh:
            prev_ts = 0
            for ts, ph, key, info in _normalized_events(st):
                rel = ts - profile._t0
                dt = rel - prev_ts
                prev_ts = rel
                if ph == "C":
                    fh.write(bytes((EVT_METRIC,)))
                    _w_uleb(fh, dt)
                    _w_uleb(fh, metric_ids[key])
                    fh.write(struct.pack("<d", float(info)))
                elif ph == "B":
                    fh.write(bytes((EVT_ENTER,)))
                    _w_uleb(fh, dt)
                    _w_uleb(fh, region_ids[key])
                elif ph == "E":
                    fh.write(bytes((EVT_LEAVE,)))
                    _w_uleb(fh, dt)
                    _w_uleb(fh, region_ids[key])
                else:
                    fh.write(bytes((EVT_MARKER,)))
                    _w_uleb(fh, dt)
                    _w_uleb(fh, region_ids[key])

    # global definitions
    group_name = strings.ref(f"rank {profile.rank}")
    loc_names = [strings.ref(st.name) for _tid, st in streams]
    region_names = {rid: strings.ref(name) for name, rid in region_ids.items()}
    metric_names = {mid: strings.ref(name) for name, mid in metric_ids.items()}
    with open(os.path.join(path, "traces", "global.def"), "wb") as fh:
        for s in strings.strings:
            sb = s.encode()
            fh.write(bytes((DEF_STRING,)))
            _w_uleb(fh, len(sb))
            fh.write(sb)
        fh.write(bytes((DEF_CLOCK,)))
        _w_uleb(fh, 1_000_000_000)  # ns resolution
        _w_uleb(fh, 0)
        fh.write(bytes((DEF_LOCATION_GROUP,)))
        _w_uleb(fh, 0)
        _w_uleb(fh, group_name)
        _w_uleb(fh, profile.rank)
        for loc_id, (tid, st) in enumerate(streams):
            fh.write(bytes((DEF_LOCATION,)))
            _w_uleb(fh, loc_id)
            _w_uleb(fh, loc_names[loc_id])
            _w_uleb(fh, 0)
            _w_uleb(fh, len(st.events))
            _w_uleb(fh, tid)  # original stream id, for exact round-trip
        for rid in range(len(region_ids)):
            fh.write(bytes((DEF_REGION,)))
            _w_uleb(fh, rid)
            _w_uleb(fh, region_names[rid])
        for mid in range(len(metric_ids)):
            fh.write(bytes((DEF_METRIC,)))
            _w_uleb(fh, mid)
            _w_uleb(fh, metric_names[mid])

    anchor = os.path.join(path, "anchor.otf2")
    with open(anchor, "wb") as fh:
        fh.write(ANCHOR_MAGIC)
        meta = json.dumps({
            "version": FORMAT_VERSION,
            # the format's writer tag, shared with the JAX package so
            # that both write the same bytes for the same events
            "writer": "parsec_tpu (otf2-lite fallback)",
            "rank": profile.rank,
            "num_locations": len(streams),
            "info": profile.info,
        }).encode()
        fh.write(struct.pack("<I", len(meta)))
        fh.write(meta)
    return anchor


def _write_real_otf2(profile, path: str) -> str:  # pragma: no cover
    import otf2
    from otf2.enums import RegionRole, Paradigm

    timer_res = 1_000_000_000
    with otf2.writer.open(path, timer_resolution=timer_res) as trace:
        root = trace.definitions.system_tree_node("node")
        group = trace.definitions.location_group(
            f"rank {profile.rank}", system_tree_parent=root)
        regions: Dict[str, Any] = {}
        metrics: Dict[str, Any] = {}
        for _tid, st in sorted(profile._streams.items()):
            writer = trace.event_writer(st.name, group=group)
            for ts, ph, key, info in _normalized_events(st):
                rel = ts - profile._t0
                if ph == "C":
                    m = metrics.get(key)
                    if m is None:
                        m = trace.definitions.metric(key, unit="#")
                        metrics[key] = m
                    writer.metric(rel, m, float(info))
                    continue
                r = regions.get(key)
                if r is None:
                    r = trace.definitions.region(
                        key, source_file="parsec_tpu",
                        region_role=RegionRole.TASK,
                        paradigm=Paradigm.USER)
                    regions[key] = r
                if ph == "B":
                    writer.enter(rel, r)
                elif ph == "E":
                    writer.leave(rel, r)
                else:
                    # OTF2 has no punctual event; a zero-length
                    # enter/leave pair preserves markers
                    writer.enter(rel, r)
                    writer.leave(rel, r)
    return os.path.join(path, "traces.otf2")


def _read_real_otf2(root: str):  # pragma: no cover - bindings absent in CI
    import otf2
    from .trace import Profile

    prof = Profile(rank=0)
    prof._t0 = 0
    with otf2.reader.open(os.path.join(root, "traces.otf2")) as trace:
        loc_ids: Dict[Any, int] = {}
        for location, event in trace.events:
            tid = loc_ids.setdefault(location, len(loc_ids))
            st = prof.stream(tid, str(getattr(location, "name", tid)))
            cls = type(event).__name__
            if cls == "Enter":
                st.events.append((event.time, "B", event.region.name, None))
            elif cls == "Leave":
                st.events.append((event.time, "E", event.region.name, None))
            elif cls == "Metric":
                st.events.append((event.time, "C",
                                  event.metric.members[0].name,
                                  float(event.values[0])))
    return prof


def read_otf2(path: str):
    """Read a fallback-format archive back into a profiling Profile
    (round-trip validation; timestamps re-based at 0)."""
    from .trace import Profile

    anchor = path if path.endswith(".otf2") else os.path.join(path, "anchor.otf2")
    root = os.path.dirname(anchor)
    if (not os.path.exists(anchor) or not anchor.endswith("anchor.otf2")) \
            and os.path.exists(os.path.join(root, "traces.otf2")):
        # a real OTF2 archive (bindings were installed at write time,
        # anchor is traces.otf2): read it back through the bindings too
        return _read_real_otf2(root)  # pragma: no cover
    with open(anchor, "rb") as fh:
        if fh.read(len(ANCHOR_MAGIC)) != ANCHOR_MAGIC:
            raise ValueError(f"{anchor}: not an otf2-lite anchor")
        (mlen,) = struct.unpack("<I", fh.read(4))
        meta = json.loads(fh.read(mlen).decode())
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported otf2-lite version {meta.get('version')}")

    strings: List[str] = []
    locations: List[Tuple[int, int, int, int]] = []  # (loc_id, name_ref, nb_events, tid)
    regions: Dict[int, int] = {}
    metrics: Dict[int, int] = {}
    with open(os.path.join(root, "traces", "global.def"), "rb") as fh:
        while True:
            tag_raw = fh.read(1)
            if not tag_raw:
                break
            tag = tag_raw[0]
            if tag == DEF_STRING:
                n = _r_uleb(fh)
                strings.append(fh.read(n).decode())
            elif tag == DEF_CLOCK:
                _r_uleb(fh)
                _r_uleb(fh)
            elif tag == DEF_LOCATION_GROUP:
                _r_uleb(fh)
                _r_uleb(fh)
                _r_uleb(fh)
            elif tag == DEF_LOCATION:
                loc_id = _r_uleb(fh)
                name_ref = _r_uleb(fh)
                _r_uleb(fh)  # group ref
                nb = _r_uleb(fh)
                tid = _r_uleb(fh)
                locations.append((loc_id, name_ref, nb, tid))
            elif tag == DEF_REGION:
                rid = _r_uleb(fh)
                regions[rid] = _r_uleb(fh)
            elif tag == DEF_METRIC:
                mid = _r_uleb(fh)
                metrics[mid] = _r_uleb(fh)
            else:
                raise ValueError(f"unknown def record tag {tag:#x}")

    prof = Profile(rank=meta.get("rank", 0), info=meta.get("info"))
    prof._t0 = 0
    for loc_id, name_ref, nb, tid in locations:
        st = prof.stream(tid, strings[name_ref])
        with open(os.path.join(root, "traces", f"{loc_id}.evt"), "rb") as fh:
            ts = 0
            for _ in range(nb):
                tag = fh.read(1)[0]
                ts += _r_uleb(fh)
                if tag == EVT_METRIC:
                    mid = _r_uleb(fh)
                    (val,) = struct.unpack("<d", fh.read(8))
                    st.events.append((ts, "C", strings[metrics[mid]], val))
                elif tag in (EVT_ENTER, EVT_LEAVE, EVT_MARKER):
                    rid = _r_uleb(fh)
                    ph = {EVT_ENTER: "B", EVT_LEAVE: "E", EVT_MARKER: "i"}[tag]
                    st.events.append((ts, ph, strings[regions[rid]], None))
                else:
                    raise ValueError(f"unknown event record tag {tag:#x}")
    return prof
