"""Streaming health monitor (``obs_live``): rolling-window
per-link/per-pool attribution, self-calibrated detectors, the online/
offline parity gate, the fleet-merged ``GET /health`` endpoint, and
knob-unset inertness.

The port's counterpart of the JAX package's ``tests/test_obs_live.py``, run on
the port with ``device="cpu"``.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
from parsec_tpu_torch.comm.engine import TAG_ACTIVATE, FlowIds
from parsec_tpu_torch.obs import (CommObs, LiveHealth, MetricsRegistry,
                            OBS_HEALTH_STATUS, OBS_HEALTH_STRAGGLER,
                            RollingStat, analyze, fleet_health,
                            flow_event_id, format_health,
                            merge_trace_docs)
from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
from parsec_tpu_torch.profiling.aggregator import AggregatorServer
from parsec_tpu_torch.profiling.trace import Profile
from parsec_tpu_torch.utils.params import params



def spmd(nb_ranks, fn, timeout=120, fabric=None):
    from parsec_tpu_torch.utils.spmd import spmd_threads
    return spmd_threads(nb_ranks, fn, timeout=timeout, fabric=fabric)

US = 1000          # ns per µs
MS = 1_000_000     # ns per ms


# ---------------------------------------------------------------------- #
# RollingStat units                                                      #
# ---------------------------------------------------------------------- #
def test_rolling_stat_mean_z_percentile():
    st = RollingStat(alpha=0.5, ring=8)
    for v in (100.0, 100.0, 100.0, 100.0):
        st.push(v)
    assert st.mean == pytest.approx(100.0)
    # zero variance -> the 10%-of-mean floor, not a division by zero
    assert st.z(130.0) == pytest.approx(3.0)
    assert st.percentile(0.95) == 100.0
    for v in (90.0, 110.0):
        st.push(v)
    assert st.std() > 0
    assert st.z(st.mean) == pytest.approx(0.0)


def test_rolling_stat_all_zero_baseline_still_fires():
    """An idle link's baseline is all zeros (mean 0, var 0); the first
    real spike must read as infinitely surprising, not z=0."""
    st = RollingStat()
    for _ in range(6):
        st.push(0.0)
    assert st.z(0.0) == 0.0
    assert st.z(5000.0) == float("inf")
    assert st.z(-1.0) == float("-inf")


# ---------------------------------------------------------------------- #
# deterministic detectors (tick() driven directly, no monitor thread)    #
# ---------------------------------------------------------------------- #
def _steady_windows(lh, k, t0_ns=0, comm_us=1000):
    """k windows of a steady comm pattern on R1->R0, one tick each;
    returns the ns cursor after the last window."""
    t = t0_ns
    for _ in range(k):
        lh.note_comm(t, t + comm_us * US, src=1)
        lh.tick()
        t += 100 * MS
    return t


def test_straggler_fires_on_correct_link_and_suspect():
    lh = LiveHealth(0, warmup_windows=3, min_exposed_us=100.0)
    t = _steady_windows(lh, 6)
    # the spike: a 50 ms inbound wait in one window
    lh.note_comm(t, t + 50 * MS, src=1)
    fired = lh.tick()
    kinds = {f["kind"] for f in fired}
    assert "straggler" in kinds
    f = next(f for f in fired if f["kind"] == "straggler")
    assert f["link"] == "R1->R0" and f["suspect"] == 1
    assert f["rank"] == 0 and f["value"] > 10_000
    snap = lh.snapshot()
    assert snap["counts"]["straggler"] >= 1
    assert snap["status"] == 1
    assert snap["firings"][-1]["kind"] == "straggler"


def test_straggler_needs_warm_baseline_and_outbound_never_accuses():
    lh = LiveHealth(0, warmup_windows=3, min_exposed_us=100.0)
    # spike in window 1: baseline cold, nothing fires
    lh.note_comm(0, 50 * MS, src=1)
    assert lh.tick() == []
    # outbound exposure (dst=1) never accuses a peer
    lh2 = LiveHealth(0, warmup_windows=1, min_exposed_us=100.0)
    t = 0
    for _ in range(6):
        lh2.note_comm(t, t + 1 * MS, dst=1)
        lh2.tick()
        t += 100 * MS
    lh2.note_comm(t, t + 80 * MS, dst=1)
    assert all(f["kind"] != "straggler" for f in lh2.tick())
    # ...but the link still shows up in the exposure table
    assert "R0->R1" in lh2.snapshot()["per_link_exposed_us"]


def test_compute_hides_comm_from_the_exposure_table():
    """A comm span fully under compute is 100% overlapped — zero
    exposed, no straggler material (the offline per-interval algebra)."""
    lh = LiveHealth(0)
    lh.note_compute(0, 10 * MS)
    lh.note_comm(2 * MS, 6 * MS, src=1)
    snap = lh.snapshot()
    assert snap["per_link_exposed_us"] == {}
    assert snap["overlap"]["overlap_fraction"] == pytest.approx(1.0)
    # half-hidden: only the un-hidden tail is exposed
    lh.note_comm(8 * MS, 14 * MS, src=1)
    snap = lh.snapshot()
    assert snap["per_link_exposed_us"]["R1->R0"] == pytest.approx(
        4000.0, abs=1.0)


def test_degraded_link_lag_regression_and_offset_conversion():
    offsets = {1: 250.0}
    lh = LiveHealth(0, warmup_windows=3, min_lag_us=100.0,
                    clock_offset_fn=offsets.get)
    t = 0
    for _ in range(5):
        # 1 µs wire time + 250 µs offset = ~251 µs lag
        lh.note_flow_recv(1, 0, t, t + 1 * US)
        lh.tick()
        t += 100 * MS
    snap = lh.snapshot()
    assert snap["per_link_lag_us"]["R1->R0"]["ewma_us"] == pytest.approx(
        251.0, abs=1.0)
    # regression: 10x the EWMA in one window
    lh.note_flow_recv(1, 0, t, t + 2510 * US)
    fired = lh.tick()
    f = next(f for f in fired if f["kind"] == "degraded_link")
    assert f["link"] == "R1->R0"
    assert lh.snapshot()["counts"]["degraded_link"] == 1


def test_stuck_progress_fires_once_and_recovers():
    lh = LiveHealth(0, stuck_windows=3, pending_fn=lambda: 5)
    lh.note_compute(0, 1 * MS)          # some activity, then silence
    lh.tick()
    fired = []
    for _ in range(6):
        fired += lh.tick()
    stuck = [f for f in fired if f["kind"] == "stuck"]
    assert len(stuck) == 1, "one firing per stuck episode"
    assert lh.gauge_status() == 2
    # progress resumes -> status recovers (after the degraded tail)
    for i in range(8):
        lh.note_compute((10 + i) * MS, (11 + i) * MS)
        lh.tick()
    assert lh.gauge_status() in (0, 1)
    snap = lh.snapshot()
    assert snap["counts"]["stuck"] == 1


def test_exec_busy_collapse_accuses_self():
    lh = LiveHealth(3, warmup_windows=3, pending_fn=lambda: 2)
    t = 0
    for _ in range(6):
        lh.note_compute(t, t + 10 * MS)
        lh.tick()
        t += 100 * MS
    fired = []
    for _ in range(2):
        fired += lh.tick()          # busy collapses to 0 with pending
    f = next(f for f in fired if f["kind"] == "straggler")
    assert f["suspect"] == 3 and f["link"] is None


def test_degraded_link_bw_collapse():
    bw = {"v": 100.0}
    lh = LiveHealth(0, warmup_windows=3,
                    link_bw_fn=lambda peer: bw["v"])
    # the bw detector only polls links it has seen traffic on
    lh.note_comm(0, 1 * MS, src=1)
    for _ in range(5):
        lh.tick()
    bw["v"] = 10.0                  # collapses to 0.1x the EWMA
    fired = lh.tick()
    f = next(f for f in fired if f["kind"] == "degraded_link")
    assert f["link"] == "R0->R1" and f["value"] == pytest.approx(10.0)


# ---------------------------------------------------------------------- #
# trace annotations + memory bounds                                      #
# ---------------------------------------------------------------------- #
def test_firing_lands_as_instant_annotation_with_args():
    from parsec_tpu_torch.obs.spans import HEALTH_STREAM_TID

    p = Profile(rank=0)
    lh = LiveHealth(0, warmup_windows=3, min_exposed_us=100.0,
                    stream=p.stream(HEALTH_STREAM_TID, "health"))
    t = _steady_windows(lh, 6)
    lh.note_comm(t, t + 50 * MS, src=1)
    assert lh.tick()
    doc = p.to_chrome_trace()
    inst = [e for e in doc["traceEvents"] if e.get("ph") == "i"]
    assert inst, "no instant annotation in the trace"
    ev = next(e for e in inst if e["name"] == "health:straggler")
    assert ev["args"]["link"] == "R1->R0"
    assert ev["args"]["suspect"] == 1
    assert ev["tid"] == HEALTH_STREAM_TID


def test_rolling_channels_stay_bounded():
    lh = LiveHealth(0)
    for i in range(3 * lh.COALESCE_AT):
        t = i * 100 * US
        lh.note_comm(t, t + 50 * US, src=1)
        if i % 2:
            lh.note_compute(t, t + 25 * US)
    with lh._lock:
        assert len(lh._comm) <= lh.COALESCE_AT + 1
        assert len(lh._compute) <= lh.COALESCE_AT + 1
    # sealed totals keep the aggregates whole
    snap = lh.snapshot()
    assert snap["overlap"]["comm_us"] == pytest.approx(
        3 * lh.COALESCE_AT * 50.0, rel=0.01)
    assert snap["per_link_exposed_us"]["R1->R0"] > 0


# ---------------------------------------------------------------------- #
# per-pool attribution through the extended flow context                 #
# ---------------------------------------------------------------------- #
def _live_pair():
    """Two local-fabric engines with flow + live armed on both ends
    (what the obs wiring does under ``obs_live``)."""
    fabric = LocalFabric(2)
    engines, lives, profiles = [], [], []
    for r in range(2):
        eng = fabric.engine(r)
        lh = LiveHealth(r)
        p = Profile(rank=r)
        eng._obs = CommObs(MetricsRegistry(), profile=p, live=lh)
        eng._flow = FlowIds(r)
        eng._flow.live = True
        engines.append(eng)
        lives.append(lh)
        profiles.append(p)
    return engines, lives, profiles


def test_pool_id_rides_the_flow_context():
    (e0, e1), (l0, l1), (p0, p1) = _live_pair()
    seen = []
    e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
    e0.send_am(1, TAG_ACTIVATE, {"tp_id": 7, "root": 0, "edges": {},
                                 "data": np.ones(4)})
    e1.progress()
    assert seen
    ctx = seen[0]["_tr"]
    assert len(ctx) == 4, "extended (origin, span, pool, t_send) context"
    assert ctx[2] == 7 and ctx[3] > 0
    # both halves attribute pool 7; flow ids still pair up
    assert l0.snapshot()["per_pool"]["7"]["sent"] == 1
    recv = l1.snapshot()["per_pool"]["7"]
    assert recv["recv"] == 1
    assert recv["lag_us_mean"] >= 0.0
    s_ev = [e for e in p0.to_chrome_trace()["traceEvents"]
            if e.get("ph") == "s"]
    f_ev = [e for e in p1.to_chrome_trace()["traceEvents"]
            if e.get("ph") == "f"]
    assert s_ev and f_ev and s_ev[0]["id"] == f_ev[0]["id"]
    assert s_ev[0]["id"] == flow_event_id(ctx)
    # the receiving link gained a lag sample on the live side
    with l1._lock:
        assert l1._lag_win.get("R0->R1")


def test_plain_flow_context_stays_two_tuple():
    """obs_flow WITHOUT obs_live: the wire context keeps the PR 15
    2-tuple — no pool id, no send timestamp, no extra bytes."""
    fabric = LocalFabric(2)
    e0, e1 = fabric.engine(0), fabric.engine(1)
    e0._obs = CommObs(MetricsRegistry(), profile=Profile(rank=0))
    e0._flow = FlowIds(0)           # live NOT armed
    seen = []
    e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
    e0.send_am(1, TAG_ACTIVATE, {"tp_id": 7, "edges": {}})
    e1.progress()
    assert seen and len(seen[0]["_tr"]) == 2


def test_tcp_live_negotiation_and_mixed_version_down():
    """Over real TCP: two obs_live peers negotiate "lv" and exchange
    4-tuple contexts; a mixed-version peer (knob unset) negotiates the
    sender all the way down — no stamp at all."""
    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports

    def boot_pair(live0, live1):
        eps = [("127.0.0.1", p) for p in free_ports(2)]
        engines = [None, None]

        def boot(r, lv):
            engines[r] = TCPCommEngine(r, eps, obs_live=lv)
        ts = [threading.Thread(target=boot, args=(r, lv))
              for r, lv in ((0, live0), (1, live1))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        return engines

    # both live
    e0, e1 = boot_pair(True, True)
    try:
        lh = LiveHealth(0)
        e0._obs = CommObs(MetricsRegistry(), live=lh)
        e0._flow = FlowIds(0)
        e0._flow.live = True
        seen = []
        e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
        deadline = time.time() + 10
        while time.time() < deadline and not e0._peer_to(1).hello_seen:
            time.sleep(0.01)
        assert e0.live_to(1) and e0.flow_to(1)
        e0.send_am(1, TAG_ACTIVATE, {"tp_id": 3, "edges": {},
                                     "data": np.ones(4)})
        deadline = time.time() + 10
        while time.time() < deadline and not seen:
            e1.progress()
            time.sleep(0.005)
        assert seen and len(seen[0]["_tr"]) == 4
        assert seen[0]["_tr"][2] == 3
        assert lh.snapshot()["per_pool"]["3"]["sent"] == 1
    finally:
        e0.fini()
        e1.fini()

    # mixed version: the peer never advertised "lv" (nor "tr")
    e0, e1 = boot_pair(True, False)
    try:
        e0._obs = CommObs(MetricsRegistry(), live=LiveHealth(0))
        e0._flow = FlowIds(0)
        e0._flow.live = True
        seen = []
        e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
        deadline = time.time() + 10
        while time.time() < deadline and not e0._peer_to(1).hello_seen:
            time.sleep(0.01)
        assert not e0.live_to(1) and not e0.flow_to(1)
        e0.send_am(1, TAG_ACTIVATE, {"tp_id": 3, "edges": {},
                                     "data": np.ones(4)})
        deadline = time.time() + 10
        while time.time() < deadline and not seen:
            e1.progress()
            time.sleep(0.005)
        assert seen and "_tr" not in seen[0]
    finally:
        e0.fini()
        e1.fini()


# ---------------------------------------------------------------------- #
# context wiring: knob-unset inertness, gauges, lifecycle                #
# ---------------------------------------------------------------------- #
def _live_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("obs-live")]


def test_knob_unset_constructs_nothing():
    fab = LocalFabric(1)
    eng = RemoteDepEngine(fab.engine(0))
    ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng)
    try:
        assert ctx.obs.live is None
        assert not _live_threads()
        assert OBS_HEALTH_STATUS not in ctx.sde.snapshot()
    finally:
        ctx.fini()


def test_knob_set_monitor_gauges_and_teardown():
    with params.cmdline_override("obs_live", "1"), \
            params.cmdline_override("obs_live_window_ms", "20"):
        fab = LocalFabric(1)
        eng = RemoteDepEngine(fab.engine(0))
        ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng)
        try:
            assert ctx.obs.live is not None
            assert _live_threads() == ["obs-live-r0"]
            time.sleep(0.1)         # a few window ticks
            snap = ctx.sde.snapshot()
            assert snap[OBS_HEALTH_STATUS] == 0
            assert snap[OBS_HEALTH_STRAGGLER] == 0
            assert ctx.obs.live.counts["windows"] > 0
        finally:
            ctx.fini()
        assert not _live_threads(), "fini must stop the monitor"


# ---------------------------------------------------------------------- #
# online/offline parity gate (tier-1)                                    #
# ---------------------------------------------------------------------- #
def test_online_offline_parity_dpotrf():
    """The declared-tolerance gate: on a traced 2-rank dpotrf, the live
    aggregator's per-rank overlap fraction and per-link exposed-wait
    must match ``obs/critpath.analyze()`` over the SAME run's traces —
    one algebra, two evaluation times."""
    n, nb, ranks = 128, 32, 2
    M = make_spd(n, dtype=np.float32)
    with params.cmdline_override("obs_live", "1"), \
            params.cmdline_override("obs_flow", "1"), \
            params.cmdline_override("comm_mesh_local", "0"):
        def rank_fn(r, fab):
            eng = RemoteDepEngine(fab.engine(r))
            ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng, profile=True)
            try:
                coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32,
                                         P=ranks, Q=1, nodes=ranks, rank=r)
                coll.name = "descA"
                coll.from_numpy(M.copy())
                ctx.add_taskpool(dpotrf_taskpool(coll, rank=r,
                                                 nb_ranks=ranks))
                ctx.wait()
                ctx.stamp_profile_meta()
                return (ctx.obs.live.snapshot(),
                        ctx.profile.to_chrome_trace())
            finally:
                ctx.fini()
        results, _fab = spmd(ranks, rank_fn)
    snaps = {r: results[r][0] for r in range(ranks)}
    report = analyze([merge_trace_docs([d for _s, d in results])])
    # -- overlap fraction: |live - offline| <= 0.10 per rank
    for r in range(ranks):
        live_ov = snaps[r]["overlap"]
        off_ov = report["overlap"][r]
        assert live_ov["overlap_fraction"] == pytest.approx(
            off_ov["overlap_fraction"], abs=0.10), f"rank {r}"
        # the raw comm seconds agree within 15%
        assert live_ov["comm_us"] == pytest.approx(
            off_ov["comm_us"], rel=0.15), f"rank {r}"
    # -- per-link exposed-wait: same links, each within 15% rel
    # (or 2 ms abs for near-zero entries)
    offline_links = report["cross_rank"]["per_link_exposed_us"]
    for r in range(ranks):
        live_links = snaps[r]["per_link_exposed_us"]
        for link, us in offline_links.get(r, {}).items():
            if us < 500:
                continue            # sub-noise entries prove nothing
            assert link in live_links, f"rank {r} missing {link}"
            assert live_links[link] == pytest.approx(
                us, rel=0.15, abs=2000.0), f"rank {r} {link}"
    # flow lag stitched live on the same links the offline report saw
    assert any(s["per_link_lag_us"] for s in snaps.values())


# ---------------------------------------------------------------------- #
# fleet merge, formatter, endpoints, chaos soak record                   #
# ---------------------------------------------------------------------- #
def _synthetic_snaps():
    lh0 = LiveHealth(0, warmup_windows=3, min_exposed_us=100.0)
    t = _steady_windows(lh0, 6)
    lh0.note_comm(t, t + 50 * MS, src=1)
    assert lh0.tick()
    lh1 = LiveHealth(1)
    lh1.note_comm(0, 2 * MS, src=0)
    lh1.tick()
    return lh0.snapshot(), lh1.snapshot()


def test_fleet_health_merges_and_ranks_worst_link():
    s0, s1 = _synthetic_snaps()
    doc = fleet_health({0: s0, 1: s1})
    assert doc["nb_ranks"] == 2
    assert doc["status"] == 1
    assert doc["counts"]["straggler"] >= 1
    assert doc["worst_link"]["link"] == "R1->R0"
    assert doc["firings"] == sorted(doc["firings"],
                                    key=lambda f: f["ts"])
    assert set(doc["ranks"]) == {"0", "1"}
    json.dumps(doc)                 # JSON-clean end to end
    # one formatter for both shapes
    txt = format_health(doc)
    assert "fleet of 2 rank(s)" in txt and "R1->R0" in txt
    assert "rank 0" in format_health(s0)


def test_health_and_timeline_endpoints():
    """The dryrun-gate surface: per-rank snapshots pushed to the
    aggregator come back fleet-merged over ``GET /health`` and as one
    time axis over ``GET /timeline``."""
    s0, s1 = _synthetic_snaps()
    srv = AggregatorServer().start()
    try:
        srv._ingest({"rank": 0, "counters": {}, "health": s0})
        srv._ingest({"rank": 1, "counters": {}, "health": s1})
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/health", timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["nb_ranks"] == 2
        assert doc["worst_link"]["link"] == "R1->R0"
        f = next(f for f in doc["firings"] if f["kind"] == "straggler")
        assert f["suspect"] == 1 and f["rank"] == 0
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/timeline", timeout=5) as r:
            tl = json.loads(r.read().decode())
        assert tl["nb_ranks"] == 2
        assert any(e["kind"] == "straggler" for e in tl["events"])
        ts = [e["ts"] for e in tl["events"]]
        assert ts == sorted(ts)
        srv.clear_health()
        assert srv.health_fleet()["nb_ranks"] == 0
    finally:
        srv.stop()


def test_sde_push_carries_health(tmp_path):
    """End to end over the push path: a context with obs_live + sde_push
    lands its snapshot on the aggregator without any HTTP client."""
    srv = AggregatorServer().start()
    try:
        with params.cmdline_override("obs_live", "1"), \
                params.cmdline_override("sde_push", srv.address), \
                params.cmdline_override("sde_push_interval_ms", "50"):
            fab = LocalFabric(1)
            eng = RemoteDepEngine(fab.engine(0))
            ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng)
            ctx.fini()              # the stop-path push is guaranteed
        deadline = time.time() + 10
        while time.time() < deadline \
                and srv.health_fleet()["nb_ranks"] == 0:
            time.sleep(0.02)
        doc = srv.health_fleet()
        assert doc["nb_ranks"] == 1 and "0" in doc["ranks"]
    finally:
        srv.stop()


