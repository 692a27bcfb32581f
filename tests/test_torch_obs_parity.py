"""obs/ held against the JAX package on the same inputs.

Both packages' ``obs`` are pure Python over the same data structures, so
the same input must give the same output:

- one synthetic two-rank trace (exec, comm and copy spans, flow pairs,
  clock metadata) through both packages' ``analyze``,
  ``distributed_critical_path``, ``per_link_exposed_wait``,
  ``merge_trace_docs`` and ``format_report`` gives equal reports;
- the same counters, gauges and histograms render to the same
  Prometheus text, which both strict parsers read back alike;
- ``LiveHealth`` fed the same interval stream, with the wall clock it
  stamps on firings injected, gives the same window digests and
  detector firings; ``fleet_health`` and ``format_health`` agree on
  the snapshots.
"""
from __future__ import annotations

import json

import pytest

import parsec_tpu.obs as jobs
import parsec_tpu.obs.live as jlive
import parsec_tpu_torch.obs as tobs
import parsec_tpu_torch.obs.live as tlive
from parsec_tpu.obs.metrics import MetricsRegistry as JRegistry
from parsec_tpu.profiling.sde import SDERegistry as JSDE
from parsec_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from parsec_tpu_torch.profiling.sde import SDERegistry as TSDE

US = 1_000
MS = 1_000_000


def _x(pid, name, ts, dur, args=None, tid=1):
    ev = {"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": ts,
          "dur": dur}
    if args is not None:
        ev["args"] = args
    return ev


def _flow(pid, ph, fid, ts):
    return {"name": "flow:activate", "ph": ph, "id": fid, "pid": pid,
            "tid": 1 << 20, "ts": ts}


def _docs():
    """Two rank documents on clocks 500 µs apart (the offsets each rank
    measured say so), a chain R0 -> R1 -> R0 over activations, GETs and
    copies, exec spans hiding part of the comm."""
    d0 = {"traceEvents": [
        _x(0, "exec:POTRF", 0.0, 40.0, {"task": "POTRF(0)"}),
        _x(0, "dev:xfer_in", 5.0, 20.0, {"bytes": 4096}, tid=(1 << 20) + 1),
        _x(0, "comm:send", 38.0, 6.0, {"src": 0, "dst": 1, "bytes": 64},
           tid=1 << 20),
        _flow(0, "s", (0 << 40) | 1, 39.0),
        _x(0, "comm:deliver:activate", 170.0, 8.0, {"src": 1, "dst": 0},
           tid=1 << 20),
        _flow(0, "f", (1 << 40) | 1, 171.0),
        _x(0, "exec:SYRK", 180.0, 30.0, {"task": "SYRK(1, 0)"}),
        _x(0, "dev:xfer_out", 205.0, 15.0, {"bytes": 4096},
           tid=(1 << 20) + 1),
        _x(0, "comm:get", 150.0, 25.0, {"src": 1, "token": 3}, tid=1 << 20),
    ], "metadata": {"rank": 0, "trace_t0_ns": 1_000_000,
                    "clock_offsets_us": json.dumps({"1": 500.0})}}
    d1 = {"traceEvents": [
        _x(1, "comm:deliver:activate", 560.0, 9.0, {"src": 0, "dst": 1},
           tid=1 << 20),
        _flow(1, "f", (0 << 40) | 1, 561.0),
        _x(1, "exec:TRSM", 570.0, 50.0, {"task": "TRSM(0, 1)"}),
        _x(1, "comm:send", 618.0, 7.0, {"src": 1, "dst": 0, "bytes": 64},
           tid=1 << 20),
        _flow(1, "s", (1 << 40) | 1, 619.0),
        _x(1, "comm:progress", 600.0, 3.0, {"handled": 1}, tid=1 << 20),
    ], "metadata": {"rank": 1, "trace_t0_ns": 1_000_000,
                    "clock_offsets_us": json.dumps({"0": -500.0})}}
    return [d0, d1]


def _copy(x):
    return json.loads(json.dumps(x))


def test_trace_reports_equal_across_packages():
    docs = _docs()
    jr = jobs.analyze(_copy(docs))
    tr = tobs.analyze(_copy(docs))
    assert "device" not in tr      # no dev:busy span: the JAX shape
    assert _copy(tr) == _copy(jr)
    assert tr["cross_rank"]["flow_edges"] == 2
    assert tr["cross_rank"]["unmatched_flows"] == 0
    assert tobs.format_report(tr) == jobs.format_report(jr)
    jm = jobs.merge_trace_docs(_copy(docs))
    tm = tobs.merge_trace_docs(_copy(docs))
    assert tm == jm
    assert tobs.validate_chrome_trace(tm) == jobs.validate_chrome_trace(jm)
    assert tobs.rank_clock_shifts(_copy(docs)) == \
        jobs.rank_clock_shifts(_copy(docs))


def test_critical_path_and_link_wait_equal_across_packages():
    from parsec_tpu.obs import critpath as jcp
    from parsec_tpu_torch.obs import critpath as tcp
    docs = _docs()

    def run(cp, obs):
        shifts = cp.rank_clock_shifts(docs)
        ivs, fl = [], []
        for i, d in enumerate(docs):
            ivs += cp.load_trace_intervals(d, shifts[i])
            fl += cp.load_flow_events(d, shifts[i])
        edges, unmatched = obs.stitch_flows(fl)
        return (obs.distributed_critical_path(ivs, edges),
                obs.per_link_exposed_wait(ivs), edges, unmatched)

    j, t = run(jcp, jobs), run(tcp, tobs)
    assert _copy(t) == _copy(j)
    dcp, links, edges, unmatched = t
    assert unmatched == 0 and dcp["cross_edges"] >= 1
    assert "R1->R0" in links[0] and "R0->R1" in links[1]


def _fill(reg):
    reg.sde.inc("PARSEC::COMM::MSGS_SENT", 7)
    reg.sde.inc("PARSEC::COMM::BYTES_SENT", 123456)
    reg.gauge("PARSEC::DEVICE::cuda:0::MEM_USED", lambda: 4096)
    reg.gauge("PARSEC::OBS::OVERLAP_FRACTION", lambda: 0.8125)
    h = reg.histogram("parsec_task_exec_seconds")
    for v in (1e-6, 3e-4, 2e-3, 0.25, 7.0):
        h.observe(v)
    reg.observe("parsec_comm_xfer_seconds", 1.5e-5)
    return reg


def test_same_metrics_render_the_same_exposition():
    jt = _fill(JRegistry(JSDE())).render_prometheus(labels={"rank": "1"})
    tt = _fill(TRegistry(TSDE())).render_prometheus(labels={"rank": "1"})
    assert tt == jt
    assert tobs.parse_exposition(tt) == jobs.parse_exposition(jt)
    assert tobs.parse_exposition(jt) == jobs.parse_exposition(tt)
    fleet = {"nb_ranks": 2, "counters": {
        "PARSEC::COMM::MSGS_SENT": {
            "per_rank": {"0": 3, "1": 4},
            "fleet": {"min": 3, "max": 4, "last": 4, "sum_of_last": 7}}}}
    assert tobs.fleet_to_prometheus(_copy(fleet)) == \
        jobs.fleet_to_prometheus(_copy(fleet))


class _Clock:
    """The wall clock ``LiveHealth`` stamps on firings and windows."""

    def __init__(self):
        self.now = 1_700_000_000.0

    def time(self):
        self.now += 0.25
        return self.now

    def __getattr__(self, name):
        import time
        return getattr(time, name)


def _drive(live_mod, monkeypatch):
    monkeypatch.setattr(live_mod, "time", _Clock())
    offsets = {1: 250.0, 2: 40.0}
    lh = live_mod.LiveHealth(0, warmup_windows=3, min_exposed_us=100.0,
                             min_lag_us=100.0, stuck_windows=3,
                             clock_offset_fn=offsets.get,
                             pending_fn=lambda: 2)
    digests = []
    lh.subscribe(digests.append)
    fired = []
    t = 0
    for w in range(14):
        lh.note_compute(t, t + 3 * MS)
        lh.note_comm(t + 2 * MS, t + 2 * MS + 900 * US, src=1)
        lh.note_comm(t + 5 * MS, t + 5 * MS + 300 * US, dst=2)
        lh.note_flow_sent(1, 4)
        lh.note_flow_recv(1, 4, t, t + 10 * US)
        lh.note_flow_recv(2, 5, t, t + 20 * US)
        if w == 9:      # a 40 ms inbound stall and a lag regression
            lh.note_comm(t + 6 * MS, t + 46 * MS, src=1)
            lh.note_flow_recv(2, 5, t, t + 4000 * US)
        fired += lh.tick()
        t += 100 * MS
    for _ in range(5):  # silence with work pending: stuck
        fired += lh.tick()
    return lh.snapshot(), fired, digests


def test_live_health_same_stream_same_digests_and_firings(monkeypatch):
    jsnap, jfired, jdig = _drive(jlive, monkeypatch)
    tsnap, tfired, tdig = _drive(tlive, monkeypatch)
    assert _copy(tfired) == _copy(jfired)
    assert {f["kind"] for f in tfired} >= {"straggler", "degraded_link",
                                           "stuck"}
    assert _copy(tdig) == _copy(jdig) and len(tdig) == 19
    assert _copy(tsnap) == _copy(jsnap)
    fleet = {0: tsnap, 1: dict(tsnap, rank=1)}
    assert _copy(tobs.fleet_health(_copy(fleet))) == \
        _copy(jobs.fleet_health(_copy(fleet)))
    assert tobs.format_health(tsnap) == jobs.format_health(jsnap)


@pytest.mark.parametrize("wname", ["RollingStat"])
def test_rolling_stat_same_numbers(wname):
    j, t = getattr(jlive, wname)(alpha=0.3, ring=8), \
        getattr(tlive, wname)(alpha=0.3, ring=8)
    for v in (1.0, 4.0, 2.5, 9.0, 0.0, 3.0, 3.0, 100.0, 7.0, 2.0):
        j.push(v)
        t.push(v)
        assert (t.mean, t.std(), t.z(5.0), t.percentile(0.9)) == \
            (j.mean, j.std(), j.z(5.0), j.percentile(0.9))
