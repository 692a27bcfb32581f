"""The port's fault-tolerance subsystem (parsec_tpu_torch/ft/): heartbeat
detection, deterministic fault injection, checkpoint-integrated restart.

Mirrors the JAX package's ``tests/test_ft.py`` (its elastic tests are
mirrored in ``test_torch_elastic.py``), on ``device="cpu"`` contexts over the port's ``LocalFabric`` and TCP
engine.  The injector's verdict streams and the chaos-killed dpotrf's
factor are also held against the JAX package's on the same input.
Every wait on a heartbeat or a rank is bounded (30 s at most).
"""
import os
import time

import numpy as np
import pytest

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, RankFailedError, RemoteDepEngine
from parsec_tpu_torch.comm.engine import TAG_HEARTBEAT
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.ft import (FT_HB_RTT_PREFIX, FT_PEER_ALIVE,
                                 FaultInjector, HeartbeatDetector,
                                 InjectedKill, InjectedTaskFault,
                                 RestartPolicy, run_with_restart)
from parsec_tpu_torch.ft.inject import parse_inject_spec
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads

RANK_TIMEOUT = 30.0   # seconds any rank thread may take


@pytest.fixture(autouse=True)
def _clean_params():
    params.reset()
    yield
    params.reset()


def spmd(nb_ranks, fn, fabric=None):
    return spmd_threads(nb_ranks, fn, timeout=RANK_TIMEOUT, fabric=fabric)


def _ctx(nb_cores=1, comm=None):
    return ptt.Context(nb_cores=nb_cores, comm=comm, device="cpu")


def _establish_all(ctx, eng, nb_ranks, rank):
    """Pump until this rank's detector has heartbeat contact with every
    peer, then barrier: on the in-process fabric only ESTABLISHED peers
    are ever evicted, so kill tests establish contact BEFORE the
    workload, as a long-running job has."""
    det = ctx._ft_detector
    if det is None:
        return
    deadline = time.monotonic() + 15.0
    while any(not det.is_established(p)
              for p in range(nb_ranks) if p != rank):
        assert time.monotonic() < deadline, "heartbeat never established"
        eng.ce.progress()
        time.sleep(0.002)
    eng.ce.sync()


def _pump(engines, secs, until=None):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        for e in engines:
            e.progress()
        if until is not None and until():
            return True
        time.sleep(0.002)
    return until() if until is not None else True


# --------------------------------------------------------------------- #
# detector                                                              #
# --------------------------------------------------------------------- #
def test_detection_latency_within_timeout():
    """A silenced (kill-injected) peer is declared dead within the
    configured heartbeat timeout — the core detection-latency bound."""
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    det = HeartbeatDetector(e0, interval=0.02, timeout=0.3).start()
    try:
        assert _pump([e0, e1], 5.0, until=lambda: det.is_established(1))
        assert det.rtt_s(1) is not None and det.rtt_s(1) < 1.0
        assert det.alive_count() == 1
        e1.ft_silence()                      # goes dark, sockets "open"
        t0 = time.monotonic()
        assert _pump([e0], 5.0, until=lambda: 1 in e0.dead_peers)
        latency = time.monotonic() - t0
        # timeout + one probe interval + scheduling slack
        assert latency < 0.3 + 0.02 + 0.6, f"detected in {latency:.3f}s"
        assert det.alive_count() == 0
        assert det.evictions == 1
    finally:
        det.stop()


def test_kill_before_first_contact_still_detected_tcp():
    """On TCP a rank that dies right after startup — before the first
    heartbeat exchange — must still be evicted: a successful probe
    implies the peer's receiver thread was alive (it processed our
    HELLO), so probed-but-silent is genuinely dead."""
    import concurrent.futures as cf

    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports

    eps = [("127.0.0.1", p) for p in free_ports(2)]
    with cf.ThreadPoolExecutor(2) as ex:
        e0, e1 = list(ex.map(lambda r: TCPCommEngine(r, eps), range(2)))
    det = HeartbeatDetector(e0, interval=0.02, timeout=0.3)
    try:
        deadline = time.monotonic() + 5.0
        while not e0._peers.get(1) or not e0._peers[1].hb_ok:
            assert time.monotonic() < deadline, "HELLO never processed"
            time.sleep(0.005)
        e1.ft_silence()
        det.start()
        t0 = time.monotonic()
        assert _pump([], 5.0, until=lambda: 1 in e0.dead_peers)
        assert time.monotonic() - t0 < 0.3 + 0.02 + 0.6
        assert not det.is_established(1)
    finally:
        det.stop()
        e0.fini()
        e1.fini()


def test_tcp_heartbeat_establishes_and_feeds_rtt():
    """The TCP engine's receiver threads answer K_PING and feed the
    detector's round trip; neither peer is evicted while both live."""
    import concurrent.futures as cf

    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports

    eps = [("127.0.0.1", p) for p in free_ports(2)]
    with cf.ThreadPoolExecutor(2) as ex:
        e0, e1 = list(ex.map(lambda r: TCPCommEngine(r, eps), range(2)))
    d0 = HeartbeatDetector(e0, interval=0.02, timeout=0.5).start()
    try:
        assert _pump([], 5.0, until=lambda: d0.is_established(1))
        assert 0 < d0.rtt_s(1) < 1.0
        _pump([], 0.3)
        assert not e0.dead_peers and d0.alive_count() == 1
    finally:
        d0.stop()
        e1.fini()
        e0.fini()


def test_unresponsive_local_peer_not_evicted_before_contact():
    """On the in-process fabric an unanswered probe may just mean the
    peer is not pumping progress yet — only ESTABLISHED peers are ever
    judged there, so a slow-starting healthy rank is never evicted."""
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    det = HeartbeatDetector(e0, interval=0.02, timeout=0.1).start()
    try:
        _pump([e0], 0.5)        # e1 never progresses: "still starting"
        assert 1 not in e0.dead_peers
        assert _pump([e0, e1], 5.0, until=lambda: det.is_established(1))
        e1.ft_silence()
        assert _pump([e0], 5.0, until=lambda: 1 in e0.dead_peers)
    finally:
        det.stop()


def test_mixed_version_peer_never_declared_dead():
    """A peer without a TAG_HEARTBEAT handler is never ESTABLISHED and
    therefore never evicted, however long it stays silent."""
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    e1.tag_unregister(TAG_HEARTBEAT)       # simulate a pre-ft build
    det = HeartbeatDetector(e0, interval=0.02, timeout=0.1).start()
    try:
        _pump([e0, e1], 0.5)               # >> timeout, pings unanswered
        assert not det.is_established(1)
        assert 1 not in e0.dead_peers
    finally:
        det.stop()


def test_cleanly_finished_peer_never_declared_dead():
    """Finishing early is not failing: a rank that fini'd cleanly stops
    heartbeating but is not evicted."""
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    det = HeartbeatDetector(e0, interval=0.02, timeout=0.15).start()
    try:
        assert _pump([e0, e1], 5.0, until=lambda: det.is_established(1))
        e1.fini()                           # clean shutdown, not a crash
        _pump([e0], 0.5)                    # >> timeout
        assert 1 not in e0.dead_peers
        assert e0.peer_finished(1)
    finally:
        det.stop()


def test_detector_phi_mode_and_bad_config():
    fab = LocalFabric(2)
    e0 = fab.engine(0)
    with pytest.raises(ValueError, match="must exceed"):
        HeartbeatDetector(e0, interval=0.1, timeout=0.1)
    with pytest.raises(ValueError, match="ft_detector_mode"):
        HeartbeatDetector(e0, interval=0.1, timeout=1.0, mode="psychic")
    det = HeartbeatDetector(e0, interval=0.02, timeout=0.2, mode="phi")
    st = det._peers[1]
    assert det._deadline_for(st) == 0.2     # no gap history: the floor
    st.gap_s = 0.05
    assert det._deadline_for(st) == pytest.approx(0.4)  # 8x gap EWMA


def test_uniform_on_peer_failure_across_transports():
    """The local engine carries the report_peer_failure /
    on_peer_failure / dead_peers surface, and remote_dep wires the
    context abort unconditionally."""
    fab = LocalFabric(2)
    eng = RemoteDepEngine(fab.engine(0))
    ctx = _ctx(comm=eng)
    try:
        assert eng.ce.on_peer_failure is not None
        eng.ce.report_peer_failure(1, "unit test")
        assert 1 in eng.ce.dead_peers
        with pytest.raises(RankFailedError):
            eng.ce.send_am(1, 100, {"x": 1})
        n_errs = len(ctx._task_errors)
        eng.ce.report_peer_failure(1, "again")   # idempotent
        assert len(ctx._task_errors) == n_errs
        with pytest.raises(RuntimeError) as ei:
            ctx.wait()
        assert isinstance(ei.value.__cause__, RankFailedError)
        ctx.clear_task_errors()             # let fini see a clean context
    finally:
        ctx.fini()


# --------------------------------------------------------------------- #
# injector                                                              #
# --------------------------------------------------------------------- #
def test_inject_spec_parser():
    from parsec_tpu.ft.inject import parse_inject_spec as jax_parse
    spec = "kill:rank=1:after=3, drop:pct=2.5:seed=7:peer=2; failsend:nth=4"
    ds = parse_inject_spec(spec)
    assert ds == jax_parse(spec)
    assert [d["op"] for d in ds] == ["kill", "drop", "failsend"]
    assert ds[0]["rank"] == 1 and ds[0]["after"] == 3
    assert ds[1]["pct"] == 2.5 and ds[1]["peer"] == 2
    with pytest.raises(ValueError, match="unknown op"):
        parse_inject_spec("explode:rank=1")
    with pytest.raises(ValueError, match="unknown key"):
        parse_inject_spec("kill:when=later")
    with pytest.raises(ValueError, match="never fire"):
        parse_inject_spec("drop:rank=1")


def test_inject_wire_ops_deterministic():
    from parsec_tpu.ft.inject import FaultInjector as JaxFaultInjector
    inj_a = FaultInjector.from_spec("drop:pct=30:seed=42", rank=0)
    inj_b = FaultInjector.from_spec("drop:pct=30:seed=42", rank=0)
    va = [inj_a.on_send(1, 100) for _ in range(200)]
    vb = [inj_b.on_send(1, 100) for _ in range(200)]
    assert va == vb                          # seeded: reproducible
    assert 20 < va.count("drop") < 100       # ~30% of 200
    # the JAX package's injector draws the same verdict stream
    inj_j = JaxFaultInjector.from_spec("drop:pct=30:seed=42", rank=0)
    assert [inj_j.on_send(1, 100) for _ in range(200)] == va
    inj_c = FaultInjector.from_spec("drop:pct=30:seed=42", rank=1)
    assert [inj_c.on_send(1, 100) for _ in range(200)] != va
    inj_d = FaultInjector.from_spec("drop:pct=100:seed=1", rank=0)
    assert inj_d.on_send(1, TAG_HEARTBEAT) == "ok"   # hb exempt
    assert inj_d.on_send(1, 100) == "drop"
    inj_e = FaultInjector.from_spec("failsend:nth=3", rank=0)
    assert inj_e.on_send(1, 100) == "ok"
    assert inj_e.on_send(1, 100) == "ok"
    with pytest.raises(RankFailedError):
        inj_e.on_send(1, 100)
    assert inj_e.on_send(1, 100) == "ok"


def test_injected_drop_on_local_fabric():
    """drop:pct=100 makes the local fabric a black hole toward peers."""
    params.set_cmdline("ft_inject", "drop:pct=100:seed=1")
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    got = []
    e1.tag_register(100, lambda s, p: got.append(p))
    e0.send_am(1, 100, {"i": 1})
    e1.progress()
    assert got == []
    assert e0._ft.stats["dropped"] == 1


def test_injected_dup_on_local_fabric():
    """dup:pct=100 delivers every frame toward a peer twice."""
    params.set_cmdline("ft_inject", "dup:pct=100:seed=1")
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    got = []
    e1.tag_register(100, lambda s, p: got.append(p["i"]))
    e0.send_am(1, 100, {"i": 7})
    e1.progress()
    assert got == [7, 7]
    assert e0._ft.stats["duplicated"] == 1


# --------------------------------------------------------------------- #
# kill a rank: detection + survivor abort (the acceptance scenario)     #
# --------------------------------------------------------------------- #
CHAIN_JDF = """
descA [ type="collection" ]
NB [ type="int" ]

Step(k)

k = 0 .. NB

: descA( k, 0 )

RW A <- (k == 0) ? descA( k, 0 ) : A Step( k-1 )
     -> (k == NB) ? descA( k, 0 ) : A Step( k+1 )

BODY
{
    A[0, 0] += 1.0
}
END
"""


def test_killed_rank_detected_survivors_raise():
    """kill:rank=1:after=2 over a 3-rank PTG chain: rank 1 goes dark at
    its 2nd task boundary; the survivors' detectors evict it within the
    heartbeat timeout and their waits raise RankFailedError instead of
    hanging in termdet; the victim aborts with InjectedKill."""
    nb_ranks, NB, tile = 3, 12, 4
    params.set_cmdline("ft_heartbeat_interval", "0.05")
    params.set_cmdline("ft_heartbeat_timeout", "1.0")
    params.set_cmdline("ft_inject", "kill:rank=1:after=2")

    def rank_fn(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = _ctx(comm=eng)
        try:
            assert ctx._ft_detector is not None
            coll = TwoDimBlockCyclic((NB + 1) * tile, tile, tile, tile,
                                     P=nb_ranks, Q=1, nodes=nb_ranks,
                                     rank=rank)
            coll.name = "descA"
            tp = ptg.compile_jdf(CHAIN_JDF, name="chain").new(
                descA=coll, NB=NB, rank=rank, nb_ranks=nb_ranks)
            _establish_all(ctx, eng, nb_ranks, rank)
            t0 = time.monotonic()
            try:
                ctx.add_taskpool(tp)
                ctx.wait()
                return ("completed", time.monotonic() - t0)
            except RuntimeError as e:
                return (type(e.__cause__).__name__, time.monotonic() - t0)
        finally:
            ctx.clear_task_errors()
            ctx.fini()

    results, _ = spmd(nb_ranks, rank_fn)
    outcomes = {r: results[r][0] for r in range(nb_ranks)}
    assert outcomes[1] == "InjectedKill"
    for r in (0, 2):
        assert outcomes[r] == "RankFailedError", outcomes
        assert results[r][1] < 10.0, results[r]


def test_taskfail_injection_and_restart_driver(tmp_path):
    """A transient injected task fault aborts the stage; the restart
    driver rolls back to the last snapshot, retries with backoff, and
    the final result matches the failure-free run exactly."""
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd

    n, nb = 96, 32
    M = make_spd(n)
    ctx = _ctx(nb_cores=2)
    try:
        A_ref = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=np.float32).from_numpy(M)
        ctx.add_taskpool(dpotrf_taskpool(A_ref))
        ctx.wait()
        ref = A_ref.to_numpy()
    finally:
        ctx.fini()

    params.set_cmdline("ft_inject", "taskfail:nth=4")
    ctx = _ctx(nb_cores=2)
    try:
        assert ctx.ft_injector is not None and ctx._ft_pins is not None
        A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        stats = run_with_restart(
            ctx, [lambda: dpotrf_taskpool(A)], [A],
            str(tmp_path / "ck"),
            policy=RestartPolicy("restart", retries=2, backoff=0.01))
        assert stats["retries"] == 1
        assert stats["snapshots"] == 2      # initial + final
        assert ctx.ft_injector.stats["task_faults"] == 1
        np.testing.assert_array_equal(A.to_numpy(), ref)
    finally:
        ctx.fini()


def test_restart_policy_abort_and_exhaustion(tmp_path):
    """abort mode never retries; restart mode re-raises once retries
    are exhausted, leaving the context clean for fini."""
    from parsec_tpu.ft import RestartPolicy as JaxRestartPolicy
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd

    n, nb = 64, 32
    M = make_spd(n)
    with pytest.raises(ValueError, match="unknown restart mode"):
        RestartPolicy("panic")
    spec = "restart:retries=3:backoff=0.5:every=2"
    pol, jpol = RestartPolicy.parse(spec), JaxRestartPolicy.parse(spec)
    assert (pol.mode, pol.retries, pol.backoff, pol.every) == \
        ("restart", 3, 0.5, 2) == \
        (jpol.mode, jpol.retries, jpol.backoff, jpol.every)
    params.set_cmdline("ft_restart_policy", "abort")
    assert RestartPolicy.from_params().mode == "abort"
    params.unset_cmdline("ft_restart_policy")

    params.set_cmdline("ft_inject", "taskfail:nth=1")
    ctx = _ctx(nb_cores=2)
    try:
        A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        with pytest.raises(RuntimeError) as ei:
            run_with_restart(ctx, [lambda: dpotrf_taskpool(A)], [A],
                             str(tmp_path / "ab"),
                             policy=RestartPolicy("abort"))
        assert isinstance(ei.value.__cause__, InjectedTaskFault)
        assert not ctx._task_errors          # guaranteed-clean abort
        # the same context is reusable after the clean abort
        A2 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        ctx.add_taskpool(dpotrf_taskpool(A2))
        ctx.wait()
    finally:
        ctx.fini()


def test_retry_bound_holds_across_rollback_replays(tmp_path):
    """With every>1 a rollback replays earlier (succeeding) stages;
    their completion must NOT reset the failing stage's attempt count
    (attempts are per stage)."""
    from parsec_tpu_torch.runtime.taskpool import Taskpool

    ctx = _ctx()
    try:
        calls = {"ok": 0, "bad": 0}

        def ok_stage():
            calls["ok"] += 1
            return Taskpool("ok-stage")     # zero tasks: completes

        def bad_stage():
            calls["bad"] += 1
            raise RuntimeError("persistent fault")

        with pytest.raises(RuntimeError, match="persistent fault"):
            run_with_restart(
                ctx, [ok_stage, bad_stage], [], str(tmp_path / "rb"),
                policy=RestartPolicy("restart", retries=1,
                                     backoff=0.01, every=2))
        assert calls["bad"] == 2            # first run + ONE retry
        assert calls["ok"] == 2             # replayed once by rollback
    finally:
        ctx.fini()


def test_injected_kill_is_hard_never_retried(tmp_path):
    """A kill is a loss of THIS rank: even with retries budgeted, the
    restart driver aborts immediately."""
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd

    n, nb = 64, 32
    params.set_cmdline("ft_inject", "kill:rank=0:after=1")
    ctx = _ctx()
    try:
        A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(
            make_spd(n))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as ei:
            run_with_restart(
                ctx, [lambda: dpotrf_taskpool(A)], [A],
                str(tmp_path / "kill"),
                policy=RestartPolicy("restart", retries=5, backoff=0.5))
        assert isinstance(ei.value.__cause__, InjectedKill)
        assert time.monotonic() - t0 < 0.5 * 5   # no retry, no backoff
    finally:
        ctx.fini()


def test_dpotrf_kill_checkpoint_restart_identical(tmp_path):
    """The acceptance scenario end to end: distributed dpotrf, rank 1
    chaos-killed mid-factorization; every rank aborts (no termdet
    hang); a fresh incarnation restores the pre-stage snapshot and
    re-runs — bit-identical to a failure-free run, and within 5e-4 of
    the JAX package's factor of the same input."""
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd

    nb_ranks, n, nb = 2, 128, 32
    M = make_spd(n)
    prefix = str(tmp_path / "ck")

    def dist(rank):
        d = TwoDimBlockCyclic(n, n, nb, nb, P=nb_ranks, Q=1,
                              nodes=nb_ranks, rank=rank, dtype=np.float32)
        for (i, j) in d.local_tiles():
            np.copyto(d.tile(i, j),
                      M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        return d

    def run_rank(rank, fabric, inject):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = _ctx(comm=eng)
        try:
            A = dist(rank)
            A.name = "descA"
            _establish_all(ctx, eng, nb_ranks, rank)
            stages = [lambda: dpotrf_taskpool(A, rank=rank,
                                              nb_ranks=nb_ranks)]
            try:
                stats = run_with_restart(
                    ctx, stages, [A], prefix,
                    policy=RestartPolicy("restart", retries=0),
                    resume_from=0 if not inject else None)
                local = {t: np.array(A.tile(*t)) for t in A.local_tiles()}
                return ("ok", local, stats)
            except RuntimeError as e:
                return (type(e.__cause__).__name__, None, None)
        finally:
            ctx.clear_task_errors()
            ctx.fini()

    # incarnation 1: snapshot at stage 0, then rank 1 dies mid-DAG
    params.set_cmdline("ft_heartbeat_interval", "0.05")
    params.set_cmdline("ft_heartbeat_timeout", "1.0")
    params.set_cmdline("ft_inject", "kill:rank=1:after=2")
    results, _ = spmd(nb_ranks, lambda r, f: run_rank(r, f, inject=True))
    assert results[1][0] == "InjectedKill"
    assert results[0][0] == "RankFailedError"   # no termdet hang

    # incarnation 2: fresh fabric, restore stage-0 snapshot, run clean
    params.set_cmdline("ft_inject", "")
    results, _ = spmd(nb_ranks, lambda r, f: run_rank(r, f, inject=False))
    merged = {}
    for st, local, stats in results:
        assert st == "ok"
        merged.update(local)

    # failure-free reference on the same grid (no ft knobs at all)
    params.reset()
    ref_results, _ = spmd(nb_ranks,
                          lambda r, f: run_rank(r, f, inject=False))
    ref = {}
    for st, local, _ in ref_results:
        assert st == "ok"
        ref.update(local)
    assert set(merged) == set(ref)
    for t in ref:
        np.testing.assert_array_equal(merged[t], ref[t])

    # the JAX package's dpotrf of the same input
    import parsec_tpu
    from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBC
    from parsec_tpu.ops import dpotrf_taskpool as jax_dpotrf_taskpool
    jctx = parsec_tpu.init(nb_cores=2, enable_tpu=False)
    try:
        JA = JaxTwoDimBC(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        jctx.add_taskpool(jax_dpotrf_taskpool(JA))
        jctx.wait()
    finally:
        jctx.fini()
    for (i, j) in ref:
        if i >= j:
            np.testing.assert_allclose(merged[(i, j)],
                                       np.asarray(JA.tile(i, j)),
                                       atol=5e-4, rtol=0)


# --------------------------------------------------------------------- #
# termdet correction: taskpool-level waiters unblock on eviction        #
# --------------------------------------------------------------------- #
def test_taskpool_abort_unblocks_wait():
    fab = LocalFabric(2)
    eng = RemoteDepEngine(fab.engine(0))
    ctx = _ctx(comm=eng)
    try:
        from parsec_tpu_torch.runtime.taskpool import Taskpool
        from parsec_tpu_torch.runtime.termdet import termdet_new
        tp = Taskpool("ft-abort")
        tp.tdm = termdet_new("user_trigger", tp)  # held open until trigger
        ctx.add_taskpool(tp)
        assert not tp.wait_completed(timeout=0.05)
        eng.ce.report_peer_failure(1, "unit")
        assert tp.wait_completed(timeout=5.0)
        assert tp.aborted
        tp.tdm.user_trigger()   # the late settle is a no-op
        assert tp.aborted
        ctx.clear_task_errors()
    finally:
        ctx.fini()


def test_ft_gauges_registered():
    """PEER_ALIVE / HB_RTT::R<peer> appear in the context's SDE
    registry, under the JAX package's names, when a detector runs."""
    from parsec_tpu.obs import FT_HB_RTT_PREFIX as JAX_RTT
    from parsec_tpu.obs import FT_PEER_ALIVE as JAX_ALIVE
    assert (FT_PEER_ALIVE, FT_HB_RTT_PREFIX) == (JAX_ALIVE, JAX_RTT)

    params.set_cmdline("ft_heartbeat_interval", "0.05")
    params.set_cmdline("ft_heartbeat_timeout", "30")   # no evictions here

    def rank_fn(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = _ctx(comm=eng)
        try:
            snap = ctx.sde.snapshot()
            assert FT_PEER_ALIVE in snap
            peer = 1 - rank
            assert f"{FT_HB_RTT_PREFIX}::R{peer}" in snap
            deadline = time.monotonic() + 5.0
            alive = 0
            while time.monotonic() < deadline:
                eng.ce.progress()
                alive = ctx.sde.snapshot()[FT_PEER_ALIVE]
                if alive == 1:
                    break
                time.sleep(0.01)
            # hold the engine alive until BOTH ranks measured
            eng.ce.sync()
            return alive
        finally:
            ctx.fini()

    counts, _ = spmd(2, rank_fn)
    assert counts == [1, 1]


# --------------------------------------------------------------------- #
# snapshot fallback and the strict contract                             #
# --------------------------------------------------------------------- #
SCALE_JDF = """
descA [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]

Scale(m, n)

m = 0 .. MT
n = 0 .. NT

: descA( m, n )

RW A <- descA( m, n )
     -> descA( m, n )

BODY
{
    A *= 2.0
    A += 1.0
}
END
"""


def test_restart_falls_back_past_torn_snapshot(tmp_path):
    """A snapshot torn by a rank dying mid-write must not poison the
    next recovery — resume_from walks back to the previous COMPLETE
    snapshot and replays from there."""
    from parsec_tpu_torch.utils import checkpoint as ckpt

    n, nb = 64, 32
    M0 = np.arange(n * n, dtype=np.float32).reshape(n, n) / (n * n)
    factory = ptg.compile_jdf(SCALE_JDF, name="scale_fb")
    prefix = str(tmp_path / "fb")

    def run(resume_from=None):
        ctx = _ctx()
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=np.float32).from_numpy(M0)
            A.name = "descA"
            mk = lambda: factory.new(descA=A, MT=A.mt - 1, NT=A.nt - 1)
            return run_with_restart(
                ctx, [mk, mk, mk], [A], prefix,
                policy=RestartPolicy("restart", retries=0, every=1),
                resume_from=resume_from), A.to_numpy()
        finally:
            ctx.fini()

    stats, final = run()
    assert stats["last_snapshot"] == 3
    np.testing.assert_array_equal(final, ((M0 * 2 + 1) * 2 + 1) * 2 + 1)
    path = ckpt.checkpoint_path(f"{prefix}.stage2.c0", 0)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 3])
    stats2, final2 = run(resume_from=2)
    np.testing.assert_array_equal(final2, final)   # replayed 1->3
    assert stats2["last_snapshot"] == 3


def test_complete_stage_walks_back_to_full_shard_set(tmp_path):
    """_complete_stage (the port's own _participants) names the latest
    stage whose every writer shard is on disk, as the JAX package's."""
    from parsec_tpu.ft.restart import _complete_stage as jax_complete
    from parsec_tpu_torch.ft.restart import _complete_stage
    from parsec_tpu_torch.utils import checkpoint as ckpt

    prefix = str(tmp_path / "cs")
    for stage in (0, 1, 2):
        for r in (0, 1):
            A = TwoDimBlockCyclic(64, 64, 32, 32, P=2, Q=1, nodes=2, rank=r,
                                  dtype=np.float32)
            ckpt.save_collection(A, f"{prefix}.stage{stage}.c0")
    os.unlink(ckpt.checkpoint_path(f"{prefix}.stage2.c0", 1))
    assert _complete_stage(1, prefix, 2) == jax_complete(1, prefix, 2) == 1
    assert _complete_stage(1, prefix, 1) == 1


def test_elastic_knob_installs_coordinator_and_unset_stays_strict(tmp_path):
    """ft_elastic unset: an ElasticPolicy is inert (the strict run, no
    coordinator, ``resizes`` 0 and ``grid`` None). ft_elastic=shrink:
    every rank's context attaches a membership coordinator to its engine
    at init and detaches it at fini; on one rank there is none, and an
    elastic policy there refuses (recovery needs a multi-rank world)."""
    from parsec_tpu_torch.ft import ElasticPolicy
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(
        np.ones((64, 64), np.float32))
    factory = ptg.compile_jdf(SCALE_JDF, name="scale_el")
    ctx = _ctx()
    try:
        st = run_with_restart(
            ctx, [lambda: factory.new(descA=A, MT=1, NT=1)], [A],
            str(tmp_path / "el"),
            elastic=ElasticPolicy(lambda g: ([], [])))
        assert (st["resizes"], st["grid"]) == (0, None)
        np.testing.assert_array_equal(A.to_numpy(), 3.0)
    finally:
        ctx.fini()
    params.set_cmdline("ft_elastic", "shrink")
    ctx = _ctx()
    try:
        assert ctx._ft_elastic is None
        with pytest.raises(ValueError, match="multi-rank"):
            run_with_restart(ctx, None, None, str(tmp_path / "el1"),
                             elastic=ElasticPolicy(lambda g: ([], [])))
    finally:
        ctx.fini()

    def rank_fn(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = _ctx(comm=eng)
        try:
            co = ctx._ft_elastic
            attached = co is not None and eng.ce.ft_elastic is co
        finally:
            ctx.fini()
        return attached, eng.ce.ft_elastic is None

    got, _ = spmd(2, rank_fn)
    assert got == [(True, True), (True, True)]
