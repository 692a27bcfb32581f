"""Fleet trace merge + distributed critical path: clock
alignment math, send→recv edge stitching, the cross-rank critical-path
walk, per-link exposed-wait attribution, flow-pair validation, and the
report's cross-rank section.

The port's counterpart of the JAX package's ``tests/test_trace_merge.py``, run on
the port with ``device="cpu"``.
"""
import json

import pytest

from parsec_tpu_torch.obs import validate_chrome_trace
from parsec_tpu_torch.obs.critpath import (Interval, analyze,
                                     distributed_critical_path,
                                     format_report,
                                     load_flow_events, merge_intervals,
                                     merge_trace_docs,
                                     per_link_exposed_wait,
                                     rank_clock_shifts, stitch_flows,
                                     subtract_intervals)


def _doc(rank, t0_ns, events, offsets=None):
    meta = {"rank": rank, "trace_t0_ns": t0_ns}
    if offsets is not None:
        meta["clock_offsets_us"] = json.dumps(offsets)
    return {"traceEvents": events, "metadata": meta}


def _x(pid, name, ts, dur, args=None, tid=0):
    ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
          "ts": ts, "dur": dur}
    if args:
        ev["args"] = args
    return ev


def _flow(pid, phase, fid, ts, name="flow:activate"):
    ev = {"name": name, "ph": phase, "pid": pid, "tid": 0, "ts": ts,
          "id": fid, "cat": "flow"}
    if phase == "f":
        ev["bp"] = "e"
    return ev


# ---------------------------------------------------------------------- #
# clock alignment                                                        #
# ---------------------------------------------------------------------- #
def test_rank_clock_shifts_prefers_reference_measurement():
    """Rank 1's events shift by (t0_1 - t0_0)/1e3 - offset, with the
    REFERENCE rank's measurement of the peer preferred."""
    d0 = _doc(0, 1_000_000, [], offsets={"1": 250.0})
    d1 = _doc(1, 3_000_000, [], offsets={"0": -240.0})
    shifts = rank_clock_shifts([d0, d1])
    assert shifts[0] == 0.0
    # (3e6 - 1e6)/1e3 - 250 = 2000 - 250
    assert shifts[1] == pytest.approx(1750.0)


def test_rank_clock_shifts_falls_back_to_negated_peer_estimate():
    d0 = _doc(0, 0, [])                       # ref measured nothing
    d1 = _doc(1, 1_000_000, [], offsets={"0": -300.0})
    shifts = rank_clock_shifts([d0, d1])
    assert shifts[1] == pytest.approx(1000.0 - 300.0)


def test_rank_clock_shifts_without_metadata_is_zero():
    d0 = {"traceEvents": [_x(0, "exec:a", 0, 1)]}
    d1 = {"traceEvents": [_x(1, "exec:b", 0, 1)]}
    shifts = rank_clock_shifts([d0, d1])
    assert shifts == {0: 0.0, 1: 0.0}


def test_merge_applies_shifts_and_keeps_rank_rows():
    d0 = _doc(0, 0, [_x(0, "exec:a", 10.0, 5.0),
                     _flow(0, "s", 7, 12.0)], offsets={"1": 100.0})
    d1 = _doc(1, 1_000_000, [_x(1, "exec:b", 0.0, 5.0),
                             _flow(1, "f", 7, 1.0)])
    merged = merge_trace_docs([d0, d1])
    assert merged["metadata"]["merged_ranks"] == [0, 1]
    # rank 1 shifts by 1000 - 100 = 900 us
    assert merged["metadata"]["clock_shifts_us"]["1"] == \
        pytest.approx(900.0)
    by_name = {e["name"]: e for e in merged["traceEvents"]}
    assert by_name["exec:a"]["ts"] == 10.0
    assert by_name["exec:b"]["ts"] == pytest.approx(900.0)
    assert by_name["exec:b"]["pid"] == 1
    edges, unmatched = stitch_flows(load_flow_events(merged))
    assert unmatched == 0 and len(edges) == 1
    assert edges[0]["lag_us"] == pytest.approx(901.0 - 12.0)
    # a re-merge of the merged doc is a no-op shift (no trace_t0_ns)
    again = merge_trace_docs([merged])
    assert {e["name"]: e["ts"] for e in again["traceEvents"]} == \
        {e["name"]: e["ts"] for e in merged["traceEvents"]}


# ---------------------------------------------------------------------- #
# stitching + interval algebra                                           #
# ---------------------------------------------------------------------- #
def test_stitch_flows_counts_one_sided_halves():
    events = [
        {"phase": "s", "id": 1, "pid": 0, "tid": 0, "ts": 0.0,
         "name": "flow:activate", "args": None},
        {"phase": "f", "id": 1, "pid": 1, "tid": 0, "ts": 5.0,
         "name": "flow:activate", "args": None},
        {"phase": "s", "id": 2, "pid": 0, "tid": 0, "ts": 1.0,
         "name": "flow:get_req", "args": None},   # lost message
        {"phase": "f", "id": 3, "pid": 1, "tid": 0, "ts": 2.0,
         "name": "flow:get_data", "args": None},  # truncated sender
    ]
    edges, unmatched = stitch_flows(events)
    assert len(edges) == 1 and edges[0]["id"] == 1
    assert edges[0]["src"] == 0 and edges[0]["dst"] == 1
    assert edges[0]["lag_us"] == pytest.approx(5.0)
    assert unmatched == 2


def test_subtract_intervals():
    a = merge_intervals([(0.0, 10.0), (20.0, 30.0)])
    b = merge_intervals([(2.0, 4.0), (8.0, 22.0), (29.0, 40.0)])
    assert subtract_intervals(a, b) == [(0.0, 2.0), (4.0, 8.0),
                                        (22.0, 29.0)]
    assert subtract_intervals(a, []) == a
    assert subtract_intervals([], b) == []


# ---------------------------------------------------------------------- #
# distributed critical path                                              #
# ---------------------------------------------------------------------- #
def test_distributed_critpath_follows_the_binding_edge():
    """Rank 1's last task B started at 21 with its local predecessor C
    done at 2 but the inbound edge landing at 20 — the wire is the
    binding constraint; the walk crosses to rank 0's producer A."""
    intervals = [
        Interval(0, 0, "exec:A", 0.0, 10.0, {"task": "A(0)"}),
        Interval(1, 0, "exec:C", 0.0, 2.0, {"task": "C(0)"}),
        Interval(1, 0, "exec:B", 21.0, 30.0, {"task": "B(0)"}),
    ]
    edges = [{"id": 9, "name": "flow:activate", "src": 0, "dst": 1,
              "send_ts": 9.0, "recv_ts": 20.0, "lag_us": 11.0}]
    dcp = distributed_critical_path(intervals, edges)
    assert dcp["cross_edges"] == 1
    assert dcp["ranks_visited"] == [0, 1]
    kinds = [n.get("task", n.get("link")) for n in dcp["chain"]]
    assert kinds == ["A(0)", "R0->R1", "B(0)"]
    assert dcp["length_us"] == pytest.approx(30.0)


def test_distributed_critpath_prefers_later_local_predecessor():
    """When the local predecessor finished AFTER the inbound edge
    landed, the local chain is the binding constraint."""
    intervals = [
        Interval(0, 0, "exec:A", 0.0, 10.0, None),
        Interval(1, 0, "exec:C", 0.0, 19.0, None),
        Interval(1, 0, "exec:B", 21.0, 30.0, None),
    ]
    edges = [{"id": 9, "name": "flow:activate", "src": 0, "dst": 1,
              "send_ts": 5.0, "recv_ts": 12.0, "lag_us": 7.0}]
    dcp = distributed_critical_path(intervals, edges)
    assert dcp["cross_edges"] == 0
    assert [n["name"] for n in dcp["chain"]] == ["exec:C", "exec:B"]


def test_distributed_critpath_leading_edge_counts_its_lag():
    """A path may BEGIN with a wire edge (no producer interval known
    at/before the send instant): the send instant is the path start,
    so the edge's lag counts toward length_us and the chain's head is
    the wire arrival (code-review regression)."""
    intervals = [
        Interval(1, 0, "exec:gemm", 100.0, 200.0, None),
        Interval(0, 0, "exec:potrf", 150.0, 180.0, None),
    ]
    edges = [{"id": 1, "name": "flow:activate", "src": 0, "dst": 1,
              "send_ts": 50.0, "recv_ts": 99.5, "lag_us": 49.5}]
    dcp = distributed_critical_path(intervals, edges)
    assert dcp["cross_edges"] == 1
    assert "link" in dcp["chain"][0]          # head = the wire arrival
    assert dcp["length_us"] == pytest.approx(150.0)   # 200 - send(50)


def test_distributed_critpath_empty_and_cyclic_safe():
    assert distributed_critical_path([], [])["chain"] == []
    # an edge pointing FORWARD in time toward an earlier interval must
    # not loop the walk (visited guard)
    intervals = [Interval(0, 0, "exec:A", 0.0, 10.0, None),
                 Interval(1, 0, "exec:B", 11.0, 20.0, None)]
    edges = [{"id": 1, "name": "e", "src": 0, "dst": 1,
              "send_ts": 9.0, "recv_ts": 11.0, "lag_us": 2.0},
             {"id": 2, "name": "e2", "src": 1, "dst": 0,
              "send_ts": 19.0, "recv_ts": 21.0, "lag_us": 2.0}]
    dcp = distributed_critical_path(intervals, edges)
    assert len(dcp["chain"]) <= 4


# ---------------------------------------------------------------------- #
# per-link exposed wait                                                  #
# ---------------------------------------------------------------------- #
def test_per_link_exposed_wait_attribution():
    """A comm span half-hidden under compute attributes only its
    EXPOSED half to the link named by its args."""
    intervals = [
        Interval(1, 0, "exec:A", 0.0, 10.0, None),
        # 10 us of GET from rank 0: 4 hidden under exec:A, 6 exposed
        Interval(1, 5, "comm:get", 6.0, 16.0, {"src": 0, "token": 1}),
        # outbound send toward rank 2, fully exposed
        Interval(1, 5, "comm:send", 20.0, 23.0, {"src": 1, "dst": 2}),
        # a comm span with no peer args contributes to no link
        Interval(1, 5, "comm:progress", 30.0, 31.0, {"handled": 2}),
    ]
    table = per_link_exposed_wait(intervals)
    assert table[1]["R0->R1"] == pytest.approx(6.0)
    assert table[1]["R1->R2"] == pytest.approx(3.0)
    assert set(table[1]) == {"R0->R1", "R1->R2"}


def test_analyze_cross_rank_section():
    """analyze() over two synthetic rank docs produces the cross_rank
    report: stitched edges per direction, the distributed path, and
    exposed-wait per link."""
    d0 = _doc(0, 0, [
        _x(0, "exec:A", 0.0, 10.0, {"task": "A(0)"}),
        _x(0, "comm:send", 9.0, 2.0, {"src": 0, "dst": 1}),
        _flow(0, "s", 7, 9.0),
    ])
    d1 = _doc(1, 0, [
        _x(1, "comm:deliver:activate", 19.5, 1.0, {"src": 0, "dst": 1}),
        _flow(1, "f", 7, 20.0),
        _x(1, "exec:B", 21.0, 9.0, {"task": "B(0)"}),
    ])
    report = analyze([d0, d1])
    cr = report["cross_rank"]
    assert cr["flow_edges"] == 1
    assert cr["edges_per_link"] == {"R0->R1": 1}
    assert cr["unmatched_flows"] == 0
    assert cr["negative_lag_edges"] == 0
    assert cr["min_lag_us"] == pytest.approx(11.0)
    assert cr["critical_path"]["cross_edges"] == 1
    assert cr["per_link_exposed_us"][1]["R0->R1"] > 0
    # without flow events the section is absent (the shape without flows)
    assert "cross_rank" not in analyze([
        {"traceEvents": [_x(0, "exec:A", 0.0, 1.0)]}])


# ---------------------------------------------------------------------- #
# validate_chrome_trace flow pairing                #
# ---------------------------------------------------------------------- #
def test_analyze_accepts_bare_array_documents():
    """The Chrome trace's bare-JSON-array form (no metadata wrapper)
    still analyzes — the alignment helpers must not assume the object
    form (code-review regression: AttributeError on list docs)."""
    doc = [{"name": "exec:t", "ph": "X", "ts": 0.0, "dur": 5.0,
            "pid": 0, "tid": 1}]
    report = analyze([doc])
    assert report["nb_intervals"] == 1
    assert merge_trace_docs([doc])["traceEvents"]


def test_validate_counts_matched_and_unmatched_flows():
    doc = {"traceEvents": [
        _flow(0, "s", 1, 0.0), _flow(1, "f", 1, 5.0),
        _flow(0, "s", 2, 1.0),                     # lone start
        _flow(1, "f", 3, 2.0), _flow(1, "f", 4, 3.0),  # lone finishes
    ]}
    v = validate_chrome_trace(doc)
    assert v["flows"] == 1
    assert v["unmatched_flows"] == 3


def test_validate_flow_order_independent():
    """The receiver half may precede the sender half in a merged list
    (rank concatenation order) — pairing must not care."""
    doc = {"traceEvents": [_flow(1, "f", 1, 5.0), _flow(0, "s", 1, 0.0)]}
    v = validate_chrome_trace(doc)
    assert v["flows"] == 1 and v["unmatched_flows"] == 0


def test_validate_flow_requires_id_and_ts():
    with pytest.raises(ValueError, match="missing id"):
        validate_chrome_trace({"traceEvents": [
            {"name": "flow:x", "ph": "s", "ts": 0.0}]})
    with pytest.raises(ValueError, match="missing numeric ts"):
        validate_chrome_trace({"traceEvents": [
            {"name": "flow:x", "ph": "s", "id": 1}]})


# ---------------------------------------------------------------------- #
# the report                                                             #
# ---------------------------------------------------------------------- #
def test_obs_report_prints_cross_rank_section():
    """The report over two rank documents carries the cross-rank section
    (the JAX package prints it through tools/obs_report.py, whose
    rendering is ``format_report``)."""

    d0 = _doc(0, 0, [
        _x(0, "exec:A", 0.0, 10.0, {"task": "A(0)"}),
        _x(0, "comm:send", 9.0, 2.0, {"src": 0, "dst": 1}),
        _flow(0, "s", 7, 9.0),
    ])
    d1 = _doc(1, 0, [
        _x(1, "comm:deliver:activate", 19.5, 1.0, {"src": 0, "dst": 1}),
        _flow(1, "f", 7, 20.0),
        _x(1, "exec:B", 21.0, 9.0, {"task": "B(0)"}),
    ])
    rep = analyze([json.loads(json.dumps(d0)), json.loads(json.dumps(d1))])
    out = format_report(rep)
    assert "cross-rank flow edges: 1" in out
    assert "distributed critical path:" in out
    assert "R0->R1" in out
    assert "exposed wait per link" in out
    # the raw section
    assert rep["cross_rank"]["flow_edges"] == 1
