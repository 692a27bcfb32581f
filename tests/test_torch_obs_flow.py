"""Cross-rank flow tracing: wire trace contexts stamped on
data-plane messages, Chrome-trace flow pairs shared between sender and
receiver, mixed-version/knob-unset negotiation, and the failure
forensics dump (the wire-capture bit identity is in
``test_torch_comm_wire.py``).

The port's counterpart of the JAX package's ``tests/test_obs_flow.py``, run on
the port with ``device="cpu"``.
"""
import json

import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
from parsec_tpu_torch.comm.engine import (FlowIds, RankFailedError, TAG_ACTIVATE,
                                    TAG_DTD_DATA, TAG_TERMDET)
from parsec_tpu_torch.obs import (CommObs, MetricsRegistry, OBS_FLOW_RECV,
                            OBS_FLOW_SENT, flow_event_id,
                            validate_chrome_trace)
from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
from parsec_tpu_torch.profiling.trace import Profile
from parsec_tpu_torch.utils.params import params



def spmd(nb_ranks, fn, timeout=120, fabric=None):
    from parsec_tpu_torch.utils.spmd import spmd_threads
    return spmd_threads(nb_ranks, fn, timeout=timeout, fabric=fabric)


def _flow_pair():
    """Two local-fabric engines with telemetry AND the flow allocator
    armed (what the obs wiring does under ``obs_flow``)."""
    fabric = LocalFabric(2)
    engines, metrics, profiles = [], [], []
    for r in range(2):
        eng = fabric.engine(r)
        m = MetricsRegistry()
        p = Profile(rank=r)
        obs = CommObs(m, profile=p)
        eng._obs = obs
        eng._flow = FlowIds(r)
        engines.append(eng)
        metrics.append(m)
        profiles.append(p)
    return engines, metrics, profiles


def _flow_events(profile, phase=None):
    doc = profile.to_chrome_trace()
    return [e for e in doc["traceEvents"]
            if e.get("ph") in (("s", "f") if phase is None else (phase,))]


def test_flow_stamp_shares_one_id_across_ranks():
    """One activation send produces a ``ph:"s"`` on the sender and a
    ``ph:"f"`` on the receiver with the SAME flow id, the receiver's
    payload carries the context, and the caller's dict is unmutated."""
    (e0, e1), (m0, m1), (p0, p1) = _flow_pair()
    seen = []
    e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
    msg = {"tp_id": 0, "root": 0, "ranks": [1], "edges": {1: []},
           "data": np.ones((4, 4))}
    e0.send_am(1, TAG_ACTIVATE, msg)
    assert "_tr" not in msg, "sender's dict must never be mutated"
    e1.progress()
    assert seen and seen[0].get("_tr") == (0, 1)
    s_ev = _flow_events(p0, "s")
    f_ev = _flow_events(p1, "f")
    assert len(s_ev) == 1 and len(f_ev) == 1
    assert s_ev[0]["id"] == f_ev[0]["id"] == flow_event_id((0, 1))
    assert s_ev[0]["name"] == f_ev[0]["name"] == "flow:activate"
    assert m0.read(OBS_FLOW_SENT) == 1
    assert m1.read(OBS_FLOW_RECV) == 1
    # each rank's own export validates with the halves unmatched; the
    # two docs concatenated pair up
    d0, d1 = p0.to_chrome_trace(), p1.to_chrome_trace()
    assert validate_chrome_trace(d0)["unmatched_flows"] == 1
    both = {"traceEvents": d0["traceEvents"] + d1["traceEvents"]}
    v = validate_chrome_trace(both)
    assert v["flows"] == 1 and v["unmatched_flows"] == 0


def test_every_hop_gets_a_fresh_context():
    """The SAME payload dict sent to several destinations (the bcast
    fan-out) is stamped per hop — distinct span ids, one edge each."""
    fabric = LocalFabric(3)
    engines = []
    for r in range(3):
        eng = fabric.engine(r)
        eng._obs = CommObs(MetricsRegistry(), profile=Profile(rank=r))
        eng._flow = FlowIds(r)
        engines.append(eng)
    got = {}
    for r in (1, 2):
        engines[r].tag_register(
            TAG_DTD_DATA, lambda src, pl, r=r: got.setdefault(r, pl))
    msg = {"tp_id": 0, "tile": (0, 0), "seq": 1, "data": np.zeros(4)}
    engines[0].send_am(1, TAG_DTD_DATA, msg)
    engines[0].send_am(2, TAG_DTD_DATA, msg)
    engines[1].progress()
    engines[2].progress()
    assert got[1]["_tr"] != got[2]["_tr"]
    assert {got[1]["_tr"], got[2]["_tr"]} == {(0, 1), (0, 2)}


def test_declined_stamp_strips_forwarded_context():
    """A bcast hop re-sends the RECEIVED dict; when the stamp declines
    (e.g. the child peer never negotiated "tr"), the upstream context
    must be STRIPPED, not forwarded — a mixed-version peer's wire
    bytes stay knob-unset-identical and the upstream edge never gains
    a second receive half (code-review regression)."""
    (e0, _e1), _m, _p = _flow_pair()
    e0.flow_to = lambda dst: False          # every peer declines
    fwd = {"tp_id": 0, "edges": {}, "_tr": (9, 123)}
    out, ctx = e0._flow_stamp(1, TAG_ACTIVATE, fwd)
    assert ctx is None
    assert "_tr" not in out
    assert fwd["_tr"] == (9, 123), "caller's dict must not be mutated"
    # a self-send decline strips too; a control/user tag passes through
    # UNTOUCHED — an application payload's "_tr" is not ours to strip
    out2, _ = e0._flow_stamp(0, TAG_ACTIVATE, fwd)
    assert "_tr" not in out2
    out3, _ = e0._flow_stamp(1, TAG_TERMDET, fwd)
    assert out3 is fwd and out3["_tr"] == (9, 123)


def test_control_tags_and_self_sends_never_stamped():
    (e0, e1), _m, (p0, _p1) = _flow_pair()
    seen = []
    e1.tag_register(TAG_TERMDET, lambda src, pl: seen.append(pl))
    e0.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
    e0.send_am(1, TAG_TERMDET, {"op": "wave"})          # control tag
    e0.send_am(0, TAG_ACTIVATE, {"tp_id": 0, "edges": {}})  # self-send
    e1.progress()
    e0.progress()
    assert len(seen) == 2
    assert all("_tr" not in pl for pl in seen)
    assert not _flow_events(p0)


def test_flow_off_is_inert():
    """Without the allocator armed (knob unset), payloads and traces
    carry nothing."""
    fabric = LocalFabric(2)
    e0, e1 = fabric.engine(0), fabric.engine(1)
    p0 = Profile(rank=0)
    e0._obs = CommObs(MetricsRegistry(), profile=p0)
    e1._obs = CommObs(MetricsRegistry(), profile=Profile(rank=1))
    seen = []
    e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
    e0.send_am(1, TAG_ACTIVATE, {"tp_id": 0, "edges": {}})
    e1.progress()
    assert seen and "_tr" not in seen[0]
    assert not _flow_events(p0)


def test_tcp_mixed_version_peer_negotiates_down():
    """Over real TCP, a peer whose HELLO never advertised "tr" (knob
    unset there) receives UNstamped payloads even though the sender has
    flow tracing armed — the byte-level twin rides the bench capture
    differential (bench_trace_capture_identity)."""
    import time
    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports

    eps = [("127.0.0.1", p) for p in free_ports(2)]
    import threading
    engines = [None, None]

    def boot(r):
        engines[r] = TCPCommEngine(r, eps, obs_flow=(r == 0))
    ts = [threading.Thread(target=boot, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    e0, e1 = engines
    try:
        e0._obs = CommObs(MetricsRegistry(), profile=Profile(rank=0))
        e0._flow = FlowIds(0)
        seen = []
        e1.tag_register(TAG_ACTIVATE, lambda src, pl: seen.append(pl))
        # wait for the HELLO exchange so negotiation is settled
        deadline = time.time() + 10
        while time.time() < deadline and not e0._peer_to(1).hello_seen:
            time.sleep(0.01)
        assert not e0.flow_to(1), "no-\"tr\" peer must negotiate down"
        e0.send_am(1, TAG_ACTIVATE, {"tp_id": 0, "edges": {},
                                     "data": np.ones(4)})
        deadline = time.time() + 10
        while time.time() < deadline and not seen:
            e1.progress()
            time.sleep(0.005)
        assert seen and "_tr" not in seen[0]
    finally:
        e0.fini()
        e1.fini()


def test_dpotrf_flow_edges_stitch_across_ranks():
    """End to end on the in-process fabric: a 2-rank dpotrf under
    ``obs_flow`` produces matched cross-rank edges in BOTH directions
    with non-negative lag (same clock)."""
    from parsec_tpu_torch.obs import load_flow_events, merge_trace_docs, \
        stitch_flows

    n, nb, ranks = 128, 32, 2
    M = make_spd(n, dtype=np.float32)
    with params.cmdline_override("obs_flow", "1"), \
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
                return ctx.profile.to_chrome_trace()
            finally:
                ctx.fini()
        docs, _fab = spmd(ranks, rank_fn)
    edges, unmatched = stitch_flows(
        load_flow_events(merge_trace_docs(docs)))
    cross = [e for e in edges if e["src"] != e["dst"]]
    dirs = {(e["src"], e["dst"]) for e in cross}
    assert unmatched == 0
    assert (0, 1) in dirs and (1, 0) in dirs
    assert all(e["lag_us"] >= 0 for e in cross)


def test_forensics_dump_on_rank_failure(tmp_path):
    """A RankFailedError abort under an active file-backed profile
    flight-records the trace immediately (once), with the merge
    metadata stamped — fini may never run on an aborting fleet."""
    prefix = str(tmp_path / "post")
    with params.cmdline_override("profile", prefix):
        fab = LocalFabric(2)
        eng = RemoteDepEngine(fab.engine(0))
        ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng)
        try:
            assert ctx.profile is not None
            ctx.record_task_error(RankFailedError(1, "chaos"))
            path = tmp_path / "post.forensics.rank0.trace.json"
            assert path.exists(), "no forensics trace written"
            with open(path) as fh:
                doc = json.load(fh)
            validate_chrome_trace(doc)
            assert doc["metadata"]["rank"] == 0
            assert "trace_t0_ns" in doc["metadata"]
            mtime = path.stat().st_mtime_ns
            # once per context: a second failure must not re-dump
            ctx.record_task_error(RankFailedError(1, "again"))
            assert path.stat().st_mtime_ns == mtime
        finally:
            ctx._task_errors.clear()
            ctx.fini()


def test_forensics_needs_active_profile(tmp_path):
    """Without a file-backed profile the abort dumps nothing (the
    flight recorder is opt-in via the profile knob)."""
    fab = LocalFabric(2)
    eng = RemoteDepEngine(fab.engine(0))
    ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng)
    try:
        assert ctx.dump_forensics() == ""
        ctx.record_task_error(RankFailedError(1, "chaos"))
        assert not list(tmp_path.iterdir())
    finally:
        ctx._task_errors.clear()
        ctx.fini()


