"""Offline critical-path + overlap analysis over exported traces.

Input: a Chrome-trace JSON written by ``profiling.trace.Profile.dump``
plus (optionally) the executed-DAG DOT written by the grapher
(``profiling_dot=<prefix>``). Output (see :func:`analyze`):

- **critical path** — the longest duration-weighted path through the
  executed DAG, with its task chain: the lower bound on makespan no
  scheduler can beat without changing the DAG;
- **per-task-class breakdown** — count / total / mean exec time per
  class per rank (where the time went);
- **compute/comm overlap fraction per rank** — the T3-style metric
  (arXiv:2401.16677): the fraction of communication time hidden under
  task execution. 1.0 = perfectly overlapped, 0.0 = fully exposed;
- **cross-rank section** (when the traces carry ``obs_flow``
  flow events): stitched send→recv wire edges, a DISTRIBUTED critical
  path that follows the binding constraint backwards across rank
  boundaries, and a per-link exposed-wait attribution table — which
  peer/link each rank's un-hidden comm time was spent waiting on.

Rank traces from different processes sit on different monotonic clocks;
:func:`rank_clock_shifts` aligns them from the ``trace_t0_ns`` +
``clock_offsets_us`` metadata the context stamps at export (the
ping/pong midpoint estimates, comm/tcp.py), and
:func:`merge_trace_docs` fuses N per-rank documents into ONE
offset-corrected Perfetto timeline (CLI: ``tools/obs_trace_merge.py``).

This package's device module adds ``dev:busy`` spans (a dispatch's
interval on the CUDA stream, from timed events): :func:`analyze` then
reports each rank's device-busy time, and :func:`rank_wall_split` splits
one rank's wall into device compute, copies, comm sends and deliveries,
the exposed wait on each link and the rest.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load_trace_intervals", "load_flow_events", "parse_dot",
           "critical_path", "merge_intervals", "overlap_us",
           "subtract_intervals", "rank_clock_shifts", "merge_trace_docs",
           "stitch_flows", "distributed_critical_path",
           "per_link_exposed_wait", "analyze", "format_report",
           "rank_wall_split"]


class Interval:
    __slots__ = ("pid", "tid", "name", "begin", "end", "args")

    def __init__(self, pid, tid, name, begin, end, args) -> None:
        self.pid, self.tid, self.name = pid, tid, name
        self.begin, self.end, self.args = begin, end, args

    @property
    def duration(self) -> float:
        return self.end - self.begin


def load_trace_intervals(doc: Dict[str, Any],
                         shift_us: float = 0.0) -> List[Interval]:
    """Intervals from complete ("X", ts+dur) events and from B/E pairs
    (matched per (pid, tid, name), LIFO — the same matching
    ``Profile.to_dataframe`` applies). Timestamps are the export's
    microseconds, plus ``shift_us`` (the per-rank clock correction
    :func:`rank_clock_shifts` computes)."""
    events = _doc_events(doc)
    out: List[Interval] = []
    # complete events carry their own duration — no pairing needed
    for e in events:
        if e.get("ph") == "X":
            out.append(Interval(e.get("pid", 0), e.get("tid", 0),
                                e.get("name", ""), e["ts"] + shift_us,
                                e["ts"] + e.get("dur", 0.0) + shift_us,
                                e.get("args")))
    # B/E events may interleave streams out of order in the list
    be = sorted(
        (e for e in events if e.get("ph") in ("B", "E")),
        key=lambda e: (e.get("pid", 0), e.get("tid", 0), e.get("ts", 0.0)))
    open_ev: Dict[Tuple, List[Tuple[float, Any]]] = {}
    for e in be:
        key = (e.get("pid", 0), e.get("tid", 0), e.get("name", ""))
        if e["ph"] == "B":
            open_ev.setdefault(key, []).append((e["ts"], e.get("args")))
        else:
            stack = open_ev.get(key)
            if stack:
                ts0, args = stack.pop()
                out.append(Interval(key[0], key[1], key[2], ts0 + shift_us,
                                    e["ts"] + shift_us, args))
    return out


def load_flow_events(doc: Dict[str, Any],
                     shift_us: float = 0.0) -> List[Dict[str, Any]]:
    """Flow-pair halves (``ph:"s"``/``"f"``) as plain dicts:
    ``{"phase", "id", "pid", "tid", "name", "ts", "args"}`` with the
    per-rank clock correction applied."""
    events = _doc_events(doc)
    out: List[Dict[str, Any]] = []
    for e in events:
        if e.get("ph") in ("s", "f"):
            out.append({"phase": e["ph"], "id": e.get("id", 0),
                        "pid": e.get("pid", 0), "tid": e.get("tid", 0),
                        "name": e.get("name", ""),
                        "ts": e.get("ts", 0.0) + shift_us,
                        "args": e.get("args")})
    return out


# ---------------------------------------------------------------------- #
# fleet merge: N per-rank traces onto one reference clock                #
# ---------------------------------------------------------------------- #
def _doc_events(doc: Any) -> List[Any]:
    """The event list of a Chrome trace in either accepted form: an
    object with ``traceEvents`` or a bare JSON array (the same duality
    ``load_trace_intervals`` supports)."""
    if isinstance(doc, list):
        return doc
    return doc.get("traceEvents", []) if isinstance(doc, dict) else []


def _doc_meta(doc: Any) -> Dict[str, Any]:
    meta = doc.get("metadata") if isinstance(doc, dict) else None
    return meta if isinstance(meta, dict) else {}


def _doc_rank(doc: Any) -> Optional[int]:
    meta = _doc_meta(doc)
    try:
        return int(meta["rank"])
    except (KeyError, TypeError, ValueError):
        # fall back to the dominant pid of the events (pid == rank in
        # every Profile export)
        pids = [e.get("pid") for e in _doc_events(doc)
                if isinstance(e, dict) and e.get("pid") is not None]
        return pids[0] if pids else None


def _doc_offsets(doc: Dict[str, Any]) -> Dict[int, float]:
    """Per-peer clock offsets (peer_clock - this_rank_clock, µs) the
    context stamped into the trace metadata at export."""
    import json as _json
    raw = _doc_meta(doc).get("clock_offsets_us")
    if isinstance(raw, str):
        try:
            raw = _json.loads(raw)
        except ValueError:
            return {}
    if not isinstance(raw, dict):
        return {}
    out = {}
    for k, v in raw.items():
        try:
            out[int(k)] = float(v)
        except (TypeError, ValueError):
            continue
    return out


def rank_clock_shifts(docs: List[Dict[str, Any]]) -> Dict[int, float]:
    """Per-document timestamp shift (µs, keyed by list index) that puts
    every rank's events onto the REFERENCE rank's clock (the
    lowest-numbered rank present).

    A rank-r timestamp ``ts`` maps to monotonic ``t0_r + ts`` on rank
    r's clock; the reference clock reads that instant as
    ``t0_r + ts - off`` where ``off = clock_r - clock_ref`` — the
    ping/pong midpoint estimate. The reference's own measurement of r
    is preferred; r's measurement of the reference (negated) is the
    fallback; 0 (same clock, e.g. in-process fabrics or a pre-merge
    document without metadata) otherwise."""
    ranks = [_doc_rank(d) for d in docs]
    known = [r for r in ranks if r is not None]
    if not known:
        return {i: 0.0 for i in range(len(docs))}
    ref_rank = min(known)
    ref_i = ranks.index(ref_rank)
    ref_meta = _doc_meta(docs[ref_i])
    ref_t0 = float(ref_meta.get("trace_t0_ns", 0.0))
    ref_offs = _doc_offsets(docs[ref_i])
    shifts: Dict[int, float] = {}
    for i, doc in enumerate(docs):
        r = ranks[i]
        if i == ref_i or r is None:
            shifts[i] = 0.0
            continue
        meta = _doc_meta(doc)
        t0 = float(meta.get("trace_t0_ns", ref_t0))
        if r in ref_offs:
            off = ref_offs[r]
        else:
            back = _doc_offsets(doc).get(ref_rank)
            off = -back if back is not None else 0.0
        shifts[i] = (t0 - ref_t0) / 1e3 - off
    return shifts


def merge_trace_docs(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fuse N per-rank Chrome-trace documents into ONE offset-corrected
    timeline: every event keeps its pid (= rank row in Perfetto), its
    ``ts``/``dur`` shifted onto the reference rank's clock; flow pairs
    (same id on an "s" in one rank row and an "f" in another) become
    arrows CROSSING rank rows. The merged metadata records the applied
    shifts — and no ``trace_t0_ns``, so re-merging is a no-op shift."""
    shifts = rank_clock_shifts(docs)
    events: List[Dict[str, Any]] = []
    ranks: List[int] = []
    applied: Dict[str, float] = {}
    for i, doc in enumerate(docs):
        r = _doc_rank(doc)
        if r is not None:
            ranks.append(r)
            applied[str(r)] = round(shifts[i], 3)
        sh = shifts[i]
        for e in _doc_events(doc):
            if not isinstance(e, dict):
                continue
            e = dict(e)
            if isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] + sh
            events.append(e)
    return {"traceEvents": events,
            "metadata": {"merged_ranks": sorted(set(ranks)),
                         "clock_shifts_us": applied}}


# ---------------------------------------------------------------------- #
# cross-rank edge stitching + distributed critical path       #
# ---------------------------------------------------------------------- #
def _ev_tenant(ev: Dict[str, Any]) -> Optional[str]:
    """The tenant a flow half / interval was attributed to, or None."""
    args = ev.get("args") if isinstance(ev, dict) else None
    if isinstance(args, dict):
        t = args.get("tenant")
        return t if isinstance(t, str) else None
    return None


def stitch_flows(flow_events: List[Dict[str, Any]]
                 ) -> Tuple[List[Dict[str, Any]], int]:
    """Pair "s"/"f" halves by flow id into send→recv edges:
    ``{"id", "name", "src", "dst", "send_ts", "recv_ts", "lag_us"}``.
    Returns (edges, unmatched_count) — a one-sided id is a truncated
    trace or a lost message, counted but never fabricated into an
    edge."""
    sends: Dict[Any, Dict[str, Any]] = {}
    recvs: Dict[Any, Dict[str, Any]] = {}
    unmatched = 0
    for ev in flow_events:
        side = sends if ev["phase"] == "s" else recvs
        if ev["id"] in side:
            unmatched += 1   # duplicate half: keep the first
            continue
        side[ev["id"]] = ev
    edges = []
    for fid, s in sends.items():
        f = recvs.pop(fid, None)
        if f is None:
            unmatched += 1
            continue
        edge = {"id": fid, "name": s["name"],
                "src": s["pid"], "dst": f["pid"],
                "send_ts": s["ts"], "recv_ts": f["ts"],
                "lag_us": f["ts"] - s["ts"]}
        # serve attribution: either half may carry the
        # submitting tenant in its args — pre-serve traces have
        # neither, and the key is then simply absent
        tenant = _ev_tenant(s) or _ev_tenant(f)
        if tenant is not None:
            edge["tenant"] = tenant
        edges.append(edge)
    unmatched += len(recvs)
    edges.sort(key=lambda e: e["send_ts"])
    return edges, unmatched


#: slack for "happened at/just before" comparisons: clock-correction
#: residue must not hide a genuinely-binding edge (µs)
_CP_EPS = 1.0


def distributed_critical_path(intervals: List[Interval],
                              edges: List[Dict[str, Any]]
                              ) -> Dict[str, Any]:
    """The cross-rank critical path: a backward walk from the globally
    last-finishing exec interval, at each step following whichever
    constraint BOUND the current node's start — the latest preceding
    exec interval on the same rank, or the latest inbound wire edge
    (then the walk jumps to the sending rank at the send instant).
    The standard last-gap-wins heuristic over distributed traces: it
    needs no DAG capture, only the stitched flow edges."""
    from bisect import bisect_right

    by_end: Dict[int, List[Interval]] = {}
    for iv in intervals:
        if iv.name.startswith("exec:"):
            by_end.setdefault(iv.pid, []).append(iv)
    if not by_end:
        return {"chain": [], "length_us": 0.0, "cross_edges": 0,
                "ranks_visited": []}
    # per rank, two sorted views + their key arrays so every backward
    # step is a bisect, not a scan (merged fleet traces hold 10^5+
    # intervals and the chain can run thousands of steps)
    ends: Dict[int, List[float]] = {}
    by_begin: Dict[int, List[Interval]] = {}
    begins: Dict[int, List[float]] = {}
    for pid, ivs in by_end.items():
        ivs.sort(key=lambda iv: iv.end)
        ends[pid] = [iv.end for iv in ivs]
        bb = sorted(ivs, key=lambda iv: iv.begin)
        by_begin[pid] = bb
        begins[pid] = [iv.begin for iv in bb]
    in_edges: Dict[int, List[Dict[str, Any]]] = {}
    recv_keys: Dict[int, List[float]] = {}
    for e in edges:
        in_edges.setdefault(e["dst"], []).append(e)
    for pid, evs in in_edges.items():
        evs.sort(key=lambda e: e["recv_ts"])
        recv_keys[pid] = [e["recv_ts"] for e in evs]

    def _latest_before(pid: int, t: float,
                       exclude: Optional[Interval]) -> Optional[Interval]:
        ivs = by_end.get(pid, ())
        i = bisect_right(ends.get(pid, ()), t + _CP_EPS) - 1
        while i >= 0 and ivs[i] is exclude:
            i -= 1
        return ivs[i] if i >= 0 else None

    def _containing(pid: int, t: float) -> Optional[Interval]:
        """The interval covering (or most recently started before) t —
        where the sending rank WAS when the edge left."""
        i = bisect_right(begins.get(pid, ()), t + _CP_EPS) - 1
        return by_begin[pid][i] if i >= 0 else None

    cur = max((iv for ivs in by_end.values() for iv in ivs),
              key=lambda iv: iv.end)
    end_ts = cur.end
    chain: List[Dict[str, Any]] = []
    visited = set()
    cross = 0
    while cur is not None and id(cur) not in visited:
        visited.add(id(cur))
        node = {"rank": cur.pid, "name": cur.name,
                "begin_us": cur.begin, "end_us": cur.end,
                "dur_us": cur.duration}
        if isinstance(cur.args, dict) and "task" in cur.args:
            node["task"] = cur.args["task"]
        chain.append(node)
        t = cur.begin
        prev = _latest_before(cur.pid, t, cur)
        edge = None
        evs = in_edges.get(cur.pid, ())
        i = bisect_right(recv_keys.get(cur.pid, ()), t + _CP_EPS) - 1
        if i >= 0:
            edge = evs[i]
        if edge is not None and (prev is None
                                 or edge["recv_ts"] > prev.end):
            # the inbound message is the binding constraint: cross to
            # the sender's timeline at the send instant
            cross += 1
            chain.append({"edge": edge["name"],
                          "link": f"R{edge['src']}->R{edge['dst']}",
                          "send_ts_us": edge["send_ts"],
                          "recv_ts_us": edge["recv_ts"],
                          "lag_us": round(edge["lag_us"], 1)})
            cur = _containing(edge["src"], edge["send_ts"])
            if cur is not None and id(cur) in visited:
                cur = None   # revisit guard: the edge stays as the
                #              chain's (wire-arrival) head
        else:
            cur = prev
    chain.reverse()
    # the path may legitimately BEGIN with a wire edge (no producer
    # interval known at/before the send instant): the send instant is
    # then the path start, so the edge's lag counts toward the length
    start_ts = next((n.get("begin_us", n.get("send_ts_us"))
                     for n in chain), end_ts)
    return {"chain": chain,
            "length_us": end_ts - start_ts,
            "cross_edges": cross,
            "ranks_visited": sorted({n["rank"] for n in chain
                                     if "rank" in n})}


def subtract_intervals(a: List[Tuple[float, float]],
                       b: List[Tuple[float, float]]
                       ) -> List[Tuple[float, float]]:
    """``a \\ b`` for MERGED interval lists: the parts of ``a`` no
    interval of ``b`` covers (the exposed remainder)."""
    out: List[Tuple[float, float]] = []
    j = 0
    for lo, hi in a:
        cur = lo
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            if cur >= hi:
                break
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def per_link_exposed_wait(intervals: List[Interval]
                          ) -> Dict[int, Dict[str, float]]:
    """Per-rank attribution of EXPOSED comm time to named links: each
    comm span whose args carry a peer (``src`` = inbound wait,
    ``dst`` = outbound send) contributes the part of itself no compute
    hid, summed per ``R<src>->R<dst>`` — "rank 2's exposed comm is 78%
    waiting on R0->R2 activations" becomes a table lookup."""
    by_rank: Dict[int, List[Interval]] = {}
    for iv in intervals:
        by_rank.setdefault(iv.pid, []).append(iv)
    out: Dict[int, Dict[str, float]] = {}
    for rank, ivs in by_rank.items():
        compute = merge_intervals([(iv.begin, iv.end) for iv in ivs
                                   if _is_compute(iv)])
        links: Dict[str, float] = {}
        for iv in ivs:
            if not _is_comm(iv) or not isinstance(iv.args, dict):
                continue
            if "src" in iv.args and iv.args["src"] != rank:
                link = f"R{iv.args['src']}->R{rank}"
            elif "dst" in iv.args and iv.args["dst"] != rank:
                link = f"R{rank}->R{iv.args['dst']}"
            else:
                continue
            exposed = iv.duration - overlap_us([(iv.begin, iv.end)],
                                               compute)
            if exposed > 0:
                links[link] = links.get(link, 0.0) + exposed
        out[rank] = {k: round(v, 1) for k, v in
                     sorted(links.items(), key=lambda kv: -kv[1])}
    return out


# ---------------------------------------------------------------------- #
# DOT (grapher output) parsing                                           #
# ---------------------------------------------------------------------- #
_NODE_RE = re.compile(r'^\s*(\w+)\s*\[label="([^"]*)"')
_EDGE_RE = re.compile(r"^\s*(\w+)\s*->\s*(\w+)")


def parse_dot(text: str) -> Tuple[Dict[str, str], List[Tuple[str, str]]]:
    """Returns (node_id -> label, [(src_label, dst_label), ...])."""
    labels: Dict[str, str] = {}
    raw_edges: List[Tuple[str, str]] = []
    for line in text.splitlines():
        if "->" in line:
            m = _EDGE_RE.match(line)
            if m:
                raw_edges.append((m.group(1), m.group(2)))
            continue
        m = _NODE_RE.match(line)
        if m:
            labels[m.group(1)] = m.group(2)
    edges = [(labels.get(a, a), labels.get(b, b)) for a, b in raw_edges]
    return labels, edges


def critical_path(durations: Dict[str, float],
                  edges: List[Tuple[str, str]]) -> Tuple[float, List[str]]:
    """Longest node-weighted path through the DAG. Nodes appearing only
    in ``edges`` default to zero weight. Raises ValueError on a cycle."""
    nodes = set(durations)
    for a, b in edges:
        nodes.update((a, b))
    succs: Dict[str, List[str]] = {n: [] for n in nodes}
    indeg: Dict[str, int] = {n: 0 for n in nodes}
    for a, b in edges:
        succs[a].append(b)
        indeg[b] += 1
    # Kahn topological order
    order: List[str] = [n for n in nodes if indeg[n] == 0]
    i = 0
    while i < len(order):
        for s in succs[order[i]]:
            indeg[s] -= 1
            if indeg[s] == 0:
                order.append(s)
        i += 1
    if len(order) != len(nodes):
        raise ValueError("dependency graph has a cycle")
    dist: Dict[str, float] = {}
    prev: Dict[str, Optional[str]] = {}
    for n in order:
        if n not in dist:
            dist[n] = durations.get(n, 0.0)
            prev[n] = None
        for s in succs[n]:
            cand = dist[n] + durations.get(s, 0.0)
            if cand > dist.get(s, float("-inf")):
                dist[s] = cand
                prev[s] = n
    if not dist:
        return 0.0, []
    tail = max(dist, key=lambda n: dist[n])
    path: List[str] = []
    cur: Optional[str] = tail
    while cur is not None:
        path.append(cur)
        cur = prev[cur]
    return dist[tail], list(reversed(path))


# ---------------------------------------------------------------------- #
# interval algebra                                                       #
# ---------------------------------------------------------------------- #
def merge_intervals(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Union of possibly-overlapping (begin, end) pairs."""
    if not spans:
        return []
    spans = sorted(spans)
    out = [list(spans[0])]
    for b, e in spans[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def overlap_us(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---------------------------------------------------------------------- #
# the report                                                             #
# ---------------------------------------------------------------------- #
def _is_compute(iv: Interval) -> bool:
    return iv.name.startswith("exec:")


def _is_comm(iv: Interval) -> bool:
    return iv.name.startswith(("comm:", "dev:xfer"))


def _is_device_busy(iv: Interval) -> bool:
    return iv.name == "dev:busy"


def _union_us(ivs: List[Tuple[float, float]]) -> float:
    return sum(e - b for b, e in merge_intervals(ivs))


#: the parts of a rank's wall :func:`rank_wall_split` reports, each a
#: predicate over span names (the reference's names, plus ``dev:busy``)
_WALL_PARTS = (
    ("device_compute", lambda n: n == "dev:busy"),
    ("h2d", lambda n: n == "dev:xfer_in"),
    ("d2h", lambda n: n == "dev:xfer_out"),
    ("host_wait_for_copy", lambda n: n.startswith("dev:wait_")),
    ("comm_send", lambda n: n == "comm:send"),
    ("comm_deliver", lambda n: n.startswith("comm:deliver")),
)


def rank_wall_split(intervals: List[Interval], rank: int, t0_us: float,
                    t1_us: float) -> Dict[str, Any]:
    """Split ``rank``'s wall ``[t0_us, t1_us]`` (trace µs) into its
    parts: the union of each kind of span clipped to the wall (device
    compute from the ``dev:busy`` event intervals, H2D and D2H copies,
    the host's waits before copies, comm sends, deliveries); for each
    link, the union of the wall its comm spans held while no task ran
    (the attribution rule of :func:`per_link_exposed_wait`, whose sum
    counts concurrent waits once each — a union does not); and
    ``rest``: the wall none of these covers.  The parts overlap one
    another (the card computes while a worker sends), so only ``rest``
    is taken by difference."""
    def clip(iv):
        b, e = max(iv.begin, t0_us), min(iv.end, t1_us)
        return (b, e) if e > b else None

    mine = [(iv, c) for iv in intervals if iv.pid == rank
            for c in (clip(iv),) if c is not None]
    wall = t1_us - t0_us
    out: Dict[str, Any] = {"wall_us": wall}
    covered: List[Tuple[float, float]] = []
    for part, pred in _WALL_PARTS:
        ivs = [c for iv, c in mine if pred(iv.name)]
        out[f"{part}_us"] = _union_us(ivs)
        covered.extend(ivs)
    compute = merge_intervals([c for iv, c in mine if _is_compute(iv)])
    by_link: Dict[str, List[Tuple[float, float]]] = {}
    for iv, c in mine:
        if not _is_comm(iv) or not isinstance(iv.args, dict):
            continue
        if "src" in iv.args and iv.args["src"] != rank:
            link = f"R{iv.args['src']}->R{rank}"
        elif "dst" in iv.args and iv.args["dst"] != rank:
            link = f"R{rank}->R{iv.args['dst']}"
        else:
            continue
        by_link.setdefault(link, []).append(c)
    out["exposed_wait_us"] = {}
    for link, ivs in sorted(by_link.items()):
        exposed = subtract_intervals(merge_intervals(ivs), compute)
        out["exposed_wait_us"][link] = round(
            sum(e - b for b, e in exposed), 1)
        covered.extend(exposed)
    out["rest_us"] = wall - _union_us(covered)
    return out


def analyze(trace_docs: List[Dict[str, Any]],
            dot_text: Optional[str] = None,
            tenant: Optional[str] = None) -> Dict[str, Any]:
    """Build the full report from one or more rank trace documents
    (already-parsed Chrome JSON) and an optional grapher DOT. Multiple
    per-rank documents are clock-aligned first (``trace_t0_ns`` +
    ``clock_offsets_us`` metadata, 0-shift when absent) so cross-rank
    flow edges stitch on one timeline.

    ``tenant`` narrows the cross-rank section to the flow
    halves a SessionServer attributed to that tenant — the SLO view of
    one customer's traffic through a shared fleet."""
    shifts = rank_clock_shifts(trace_docs)
    intervals: List[Interval] = []
    flow_events: List[Dict[str, Any]] = []
    for i, doc in enumerate(trace_docs):
        intervals.extend(load_trace_intervals(doc, shifts[i]))
        flow_events.extend(load_flow_events(doc, shifts[i]))
    if tenant is not None:
        flow_events = [ev for ev in flow_events
                       if _ev_tenant(ev) == tenant]

    # per-task-class breakdown per rank
    by_class: Dict[int, Dict[str, Dict[str, float]]] = {}
    task_durations: Dict[str, float] = {}
    for iv in intervals:
        if not _is_compute(iv):
            continue
        cls = iv.name[len("exec:"):]
        cell = by_class.setdefault(iv.pid, {}).setdefault(
            cls, {"count": 0, "total_us": 0.0})
        cell["count"] += 1
        cell["total_us"] += iv.duration
        if isinstance(iv.args, dict) and "task" in iv.args:
            # individual executed-task durations keyed by the same
            # printed name the grapher uses as the DOT node label
            task_durations[iv.args["task"]] = (
                task_durations.get(iv.args["task"], 0.0) + iv.duration)
    for cells in by_class.values():
        for cell in cells.values():
            cell["mean_us"] = cell["total_us"] / max(1, cell["count"])

    # T3-style compute/comm overlap per rank
    overlap: Dict[int, Dict[str, float]] = {}
    pids = sorted({iv.pid for iv in intervals})
    for pid in pids:
        rank_ivs = [iv for iv in intervals if iv.pid == pid]
        compute = merge_intervals([(iv.begin, iv.end) for iv in rank_ivs
                                   if _is_compute(iv)])
        comm = merge_intervals([(iv.begin, iv.end) for iv in rank_ivs
                                if _is_comm(iv)])
        comm_us = sum(e - b for b, e in comm)
        comp_us = sum(e - b for b, e in compute)
        hidden = overlap_us(compute, comm)
        # the rank's makespan: the span of everything it did — the
        # denominator that tells whether the EXPOSED comm (the part no
        # compute hid) actually matters for wall time
        makespan = (max(iv.end for iv in rank_ivs)
                    - min(iv.begin for iv in rank_ivs)) if rank_ivs else 0.0
        exposed = comm_us - hidden
        overlap[pid] = {
            "compute_us": comp_us,
            "comm_us": comm_us,
            "overlap_us": hidden,
            # zero-comm ranks report PERFECT overlap (1.0): nothing to
            # hide means nothing exposed — a single-rank run must not
            # trip an overlap gate (tools/obs_report.py --gate-overlap)
            "overlap_fraction": hidden / comm_us if comm_us > 0 else 1.0,
            "exposed_comm_us": exposed,
            "makespan_us": makespan,
            "exposed_share_of_makespan": (exposed / makespan
                                          if makespan > 0 else 0.0),
        }

    report: Dict[str, Any] = {
        "ranks": pids,
        "nb_intervals": len(intervals),
        "by_class": by_class,
        "overlap": overlap,
    }
    busy = [iv for iv in intervals if _is_device_busy(iv)]
    if busy:
        # the device's busy time per rank, from the stream's timed
        # events (not the host's launch time)
        report["device"] = {}
        for pid in pids:
            ivs = [(iv.begin, iv.end) for iv in busy if iv.pid == pid]
            if not ivs:
                continue
            mk = overlap[pid]["makespan_us"]
            busy_us = _union_us(ivs)
            report["device"][pid] = {
                "busy_us": busy_us, "dispatches": len(ivs),
                "busy_share_of_makespan": busy_us / mk if mk > 0 else 0.0}

    if flow_events:
        # cross-rank causal section: stitched wire edges,
        # the distributed critical path over them, and the per-link
        # exposed-wait attribution
        edges, unmatched = stitch_flows(flow_events)
        cross = [e for e in edges if e["src"] != e["dst"]]
        by_dir: Dict[str, int] = {}
        neg = 0
        min_lag = None
        for e in cross:
            key = f"R{e['src']}->R{e['dst']}"
            by_dir[key] = by_dir.get(key, 0) + 1
            if e["lag_us"] < 0:
                neg += 1
            min_lag = e["lag_us"] if min_lag is None \
                else min(min_lag, e["lag_us"])
        report["cross_rank"] = {
            "flow_edges": len(cross),
            "edges_per_link": by_dir,
            "unmatched_flows": unmatched,
            "negative_lag_edges": neg,
            "min_lag_us": round(min_lag, 1) if min_lag is not None
            else None,
            "critical_path": distributed_critical_path(intervals, cross),
            "per_link_exposed_us": per_link_exposed_wait(intervals),
        }
        # per-tenant rollups: only when some edge carries an
        # attribution — pre-serve traces keep the pre-serve report shape
        tenants = sorted({e["tenant"] for e in edges if "tenant" in e})
        if tenants:
            report["cross_rank"]["per_tenant"] = {
                t: _tenant_rollup(t, intervals, edges) for t in tenants}

    if dot_text:
        _labels, edges = parse_dot(dot_text)
        length, path = critical_path(task_durations, edges)
        total_exec = sum(task_durations.values())
        report["critical_path"] = {
            "length_us": length,
            "tasks": path,
            "nb_tasks": len(path),
            "total_exec_us": total_exec,
            # >1 means the DAG has exploitable parallelism
            "parallelism": total_exec / length if length > 0 else 0.0,
        }
    return report


def _tenant_rollup(tenant: str, intervals: List[Interval],
                   edges: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One tenant's slice of the cross-rank view: its wire edges, the
    distributed critical path constrained to THOSE edges, and the
    exposed wait of its attributed comm spans."""
    own = [e for e in edges if e.get("tenant") == tenant]
    cross = [e for e in own if e["src"] != e["dst"]]
    lags = sorted(e["lag_us"] for e in cross)
    dcp = distributed_critical_path(intervals, cross) if cross else None
    # exposed wait of this tenant's attributed comm spans only
    own_comm = [iv for iv in intervals
                if _ev_tenant({"args": iv.args}) == tenant]
    exposed = per_link_exposed_wait(
        own_comm + [iv for iv in intervals if _is_compute(iv)])
    exposed_us = round(sum(us for links in exposed.values()
                           for us in links.values()), 1)
    out: Dict[str, Any] = {
        "flow_edges": len(cross),
        "lag_us_mean": round(sum(lags) / len(lags), 1) if lags else 0.0,
        "lag_us_max": round(lags[-1], 1) if lags else 0.0,
        "exposed_wait_us": exposed_us,
    }
    if dcp is not None:
        out["critical_path_us"] = round(dcp["length_us"], 1)
        out["critical_path_cross_edges"] = dcp["cross_edges"]
    return out


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering (what tools/obs_report.py prints)."""
    out: List[str] = []
    cp = report.get("critical_path")
    if cp is not None:
        out.append(f"critical path: {cp['length_us'] / 1e3:.3f} ms over "
                   f"{cp['nb_tasks']} tasks "
                   f"(total exec {cp['total_exec_us'] / 1e3:.3f} ms, "
                   f"parallelism {cp['parallelism']:.2f}x)")
        if cp["tasks"]:
            chain = " -> ".join(cp["tasks"][:8])
            if cp["nb_tasks"] > 8:
                chain += " -> ..."
            out.append(f"  chain: {chain}")
    out.append("per-task-class breakdown:")
    for pid in sorted(report.get("by_class", {})):
        for cls, cell in sorted(report["by_class"][pid].items()):
            out.append(f"  rank {pid} {cls:<20} n={int(cell['count']):<6} "
                       f"total={cell['total_us'] / 1e3:.3f} ms "
                       f"mean={cell['mean_us']:.1f} us")
    out.append("compute/comm overlap per rank:")
    for pid in sorted(report.get("overlap", {})):
        ov = report["overlap"][pid]
        out.append(f"  rank {pid}: compute={ov['compute_us'] / 1e3:.3f} ms "
                   f"comm={ov['comm_us'] / 1e3:.3f} ms "
                   f"overlap fraction={ov['overlap_fraction']:.3f} "
                   f"exposed={ov.get('exposed_comm_us', 0.0) / 1e3:.3f} ms "
                   f"({ov.get('exposed_share_of_makespan', 0.0):.1%} of "
                   f"makespan)")
    devs = report.get("device") or {}
    if devs:
        out.append("device busy per rank (timed events on the stream):")
        for pid in sorted(devs):
            d = devs[pid]
            out.append(f"  rank {pid}: busy={d['busy_us'] / 1e6:.6f} s over "
                       f"{d['dispatches']} dispatches "
                       f"({d['busy_share_of_makespan']:.1%} of makespan)")
    cr = report.get("cross_rank")
    if cr is not None:
        out.append(f"cross-rank flow edges: {cr['flow_edges']} "
                   f"({cr['unmatched_flows']} unmatched, "
                   f"{cr['negative_lag_edges']} negative-lag) per link: "
                   + (", ".join(f"{k}={v}" for k, v in
                                sorted(cr["edges_per_link"].items()))
                      or "none"))
        dcp = cr["critical_path"]
        out.append(f"distributed critical path: "
                   f"{dcp['length_us'] / 1e3:.3f} ms crossing "
                   f"{dcp['cross_edges']} wire edge(s) over ranks "
                   f"{dcp['ranks_visited']}")
        steps = []
        for n in dcp["chain"][:12]:
            if "link" in n:
                steps.append(f"={n['link']}=>")
            else:
                steps.append(n.get("task") or n["name"])
        if steps:
            out.append("  chain: " + " ".join(steps)
                       + (" ..." if len(dcp["chain"]) > 12 else ""))
        out.append("exposed wait per link (µs of un-hidden comm, "
                   "by rank):")
        for rank in sorted(cr["per_link_exposed_us"]):
            links = cr["per_link_exposed_us"][rank]
            total = sum(links.values())
            if not links:
                out.append(f"  rank {rank}: none")
                continue
            parts = ", ".join(
                f"{lk}={us:.0f} ({us / total:.0%})"
                for lk, us in links.items())
            out.append(f"  rank {rank}: {parts}")
        tenants = cr.get("per_tenant") or {}
        if tenants:
            out.append("per-tenant cross-rank rollup:")
            for t in sorted(tenants):
                cell = tenants[t]
                line = (f"  tenant {t:<10} edges={cell['flow_edges']} "
                        f"lag mean/max={cell['lag_us_mean']:.0f}/"
                        f"{cell['lag_us_max']:.0f} us "
                        f"exposed={cell['exposed_wait_us']:.0f} us")
                if "critical_path_us" in cell:
                    cp_ms = cell["critical_path_us"] / 1e3
                    line += (f" critpath={cp_ms:.3f} ms"
                             f" ({cell['critical_path_cross_edges']} wire"
                             f" edge(s))")
                out.append(line)
    return "\n".join(out)
