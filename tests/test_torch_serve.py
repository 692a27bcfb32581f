"""The port's multi-tenant persistent serving (serve/), against
tests/test_serve.py's fifteen tests and against the JAX package's
``TenantFairness`` and ``SessionServer``.

Covers the wire envelopes, local admission and the submission lifecycle
on a persistent context, the remote ServeClient <-> SessionServer path
over the in-process fabric and over TCP on localhost, tenant-stamped
flow contexts feeding the cross-rank tooling, per-tenant live-health
attribution, and the knob-unset inertness contract.  The parity tests
feed the same tenant registrations, completions and submissions, made
from a numpy seed, through both packages, which must agree on every
boost, admission verdict and accounting field (exact: integer and
float bookkeeping, no summation order to differ).
"""
import pickle
import threading
import time

import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch import dtd
from parsec_tpu_torch.comm import LocalFabric, wire
from parsec_tpu_torch.comm.engine import TAG_ACTIVATE, FlowIds
from parsec_tpu_torch.dsl.dtd import VALUE
from parsec_tpu_torch.obs import (CommObs, MetricsRegistry, analyze,
                                  load_flow_events, merge_trace_docs,
                                  stitch_flows)
from parsec_tpu_torch.obs.live import LiveHealth, fleet_health, format_health
from parsec_tpu_torch.obs.spans import (SERVE_INFLIGHT_PREFIX,
                                        SERVE_P99_LATENCY_PREFIX,
                                        SERVE_QUOTA_BYTES_PREFIX,
                                        SERVE_TENANTS)
from parsec_tpu_torch.profiling.trace import Profile
from parsec_tpu_torch.serve import (AdmissionError, ServeClient,
                                    SessionServer, TenantFairness)
from parsec_tpu_torch.utils.params import params


@pytest.fixture
def ctx():
    c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    yield c
    c.fini()


# ---------------------------------------------------------------------- #
# wire envelopes                                                         #
# ---------------------------------------------------------------------- #
def test_serve_envelope_roundtrip():
    req = wire.serve_request("submit", 7, tenant="acme", ntasks=3)
    assert wire.parse_serve(req) is req
    assert req["op"] == "submit" and req["req"] == 7
    assert req["tenant"] == "acme" and req["ntasks"] == 3
    rep = wire.serve_reply(7, True, ticket=12)
    assert wire.parse_serve(rep)["ok"] is True
    assert rep["ticket"] == 12 and rep["sv"] == wire.SERVE_PROTO_VERSION
    # the envelopes and the K_TUNE frame are the JAX package's
    from parsec_tpu.comm import wire as jax_wire
    assert req == jax_wire.serve_request("submit", 7, tenant="acme",
                                         ntasks=3)
    assert rep == jax_wire.serve_reply(7, True, ticket=12)
    tune = {"op": "codec", "codec": "qbf16"}
    assert wire.pack_tune(tune) == jax_wire.pack_tune(tune)
    assert wire.parse_tune(memoryview(jax_wire.pack_tune(tune))) == tune
    assert wire.K_TUNE == jax_wire.K_TUNE
    # and their frames on the AM wire: the same bytes from either package
    assert wire.dumps_message((0, 10, req), protocol=5) == \
        pickle.dumps((0, 10, req), protocol=5)


def test_serve_envelope_rejects_malformed():
    with pytest.raises(ValueError):
        wire.parse_serve(b"not a dict")
    with pytest.raises(ValueError):
        wire.parse_serve({"op": "open", "req": 1})        # no version
    with pytest.raises(ValueError):
        wire.parse_serve({"sv": wire.SERVE_PROTO_VERSION + 1, "req": 1})
    with pytest.raises(ValueError):
        wire.parse_serve({"sv": 1, "op": "open"})         # no req id


# ---------------------------------------------------------------------- #
# local lifecycle on one persistent context                              #
# ---------------------------------------------------------------------- #
def _count_build(ctx, counter, n_tasks=4):
    """A DTD closure submission: build returns a sealed, not-yet-added
    pool whose tasks bump ``counter`` (a list cell)."""
    def build():
        tp = dtd.taskpool_new()

        def body(es, task):
            counter[0] += 1

        for k in range(n_tasks):
            tp.insert_task(body, (k, VALUE))
        return tp
    return build


def test_local_submit_lifecycle_and_gauges(ctx):
    done = [0]
    with SessionServer(ctx) as srv:
        assert ctx.serve_fairness is srv.fairness
        assert SERVE_TENANTS in ctx.sde.names()
        srv.open_tenant("acme", weight=4)
        names = ctx.sde.names()
        for prefix in (SERVE_INFLIGHT_PREFIX, SERVE_QUOTA_BYTES_PREFIX,
                       SERVE_P99_LATENCY_PREFIX):
            assert f"{prefix}::acme" in names
        subs = [srv.submit("acme", _count_build(ctx, done), ntasks=4)
                for _ in range(3)]
        for sub in subs:
            assert sub.wait(30), "served pool never completed"
            assert sub.error is None
            assert sub.lat_us > 0
        assert done[0] == 12
        st = srv.stats()["tenants"]["acme"]
        assert st["weight"] == 4 and st["pools_done"] == 3
        assert st["inflight_pools"] == 0 and st["queued"] == 0
        assert st["p50_lat_us"] > 0 and st["p99_lat_us"] >= st["p50_lat_us"]
    # close() detaches everything it hooked
    assert ctx.serve_fairness is None
    names = ctx.sde.names()
    assert SERVE_TENANTS not in names
    assert f"{SERVE_INFLIGHT_PREFIX}::acme" not in names


def test_local_admission_errors(ctx):
    srv = SessionServer(ctx)
    try:
        with pytest.raises(AdmissionError, match="unknown tenant"):
            srv.submit("ghost", lambda: None)
        srv.open_tenant("t", max_tasks=2)
        with pytest.raises(AdmissionError, match="max in-flight tasks"):
            srv.submit("t", lambda: None, ntasks=3)
        # idempotent re-open keeps the original caps
        t2 = srv.open_tenant("t", max_tasks=99)
        assert t2.max_tasks == 2
    finally:
        srv.close()
    with pytest.raises(AdmissionError, match="closed"):
        srv.submit("t", lambda: None)


def test_failed_build_releases_admission(ctx):
    """A submission whose build raises must un-charge the tenant's
    in-flight counters (capacity would otherwise leak forever) and
    still drain the queue."""
    done = [0]
    with SessionServer(ctx, admission="queue") as srv:
        srv.open_tenant("t", max_pools=1)

        def boom():
            raise RuntimeError("nope")

        bad = srv.submit("t", boom)
        assert bad.wait(10), "failed build must finish the submission"
        assert bad.error and "build failed" in bad.error
        st = srv.stats()["tenants"]["t"]
        assert st["inflight_pools"] == 0 and st["queued"] == 0
        # capacity actually came back: the next submission admits + runs
        ok = srv.submit("t", _count_build(ctx, done, n_tasks=2), ntasks=2)
        assert ok.wait(30) and ok.error is None
    assert done[0] == 2


def test_abort_releases_admission_and_promotes_queue(ctx):
    """Taskpool.abort (the ft eviction path) must run the serve abort
    hook: charges release, the submission fails (waiters unblock), and
    the tenant's queued work is promoted."""
    gate = threading.Event()

    def gated_build():
        tp = dtd.taskpool_new()

        def body(es, task):
            gate.wait(10)

        tp.insert_task(body, (0, VALUE))
        return tp

    done2 = [0]
    with SessionServer(ctx, admission="queue") as srv:
        srv.open_tenant("t", max_pools=1)
        sub1 = srv.submit("t", gated_build)
        sub2 = srv.submit("t", _count_build(ctx, done2, n_tasks=2))
        assert srv.stats()["tenants"]["t"]["queued"] == 1
        sub1.taskpool.abort()
        assert sub1.wait(10), "abort must finish the submission"
        assert sub1.error and "abort" in sub1.error
        gate.set()                     # release the parked worker
        assert sub2.wait(30), "queued pool must promote on abort"
        assert sub2.error is None and done2[0] == 2
        st = srv.stats()["tenants"]["t"]
        assert st["inflight_pools"] == 0 and st["queued"] == 0
    gate.set()


class _Tile:
    """Attribute-capable mempool element (owner back-pointer rides it)."""


def test_mempool_free_kicks_queued_submission(ctx):
    """A submission queued on the Mempool-fed byte quota while the
    tenant has ZERO in-flight pools has no pool-done event to drain it —
    the bound pool's free path must kick re-admission."""
    from parsec_tpu_torch.core.mempool import Mempool
    mp = Mempool(_Tile)
    done = [0]
    with SessionServer(ctx, admission="queue") as srv:
        srv.open_tenant("t", quota_bytes=100)
        srv.bind_mempool("t", mp, item_bytes=60)
        elt = mp.allocate()            # 60 outstanding bytes
        sub = srv.submit("t", _count_build(ctx, done, n_tasks=2),
                         nbytes=50)    # 60 + 50 > 100 -> queued
        assert srv.stats()["tenants"]["t"]["queued"] == 1
        mp.free(elt)                   # headroom appears -> kick drains
        assert sub.wait(30), "mempool free must re-admit queued work"
        assert sub.error is None and done[0] == 2
    assert mp.on_free is None          # close() unhooks the pool


def test_latency_window_knob_sizes_rings(ctx):
    """serve_latency_window must actually size the per-tenant latency
    rings in both the server and the live monitor."""
    with params.cmdline_override("serve_latency_window", "3"):
        srv = SessionServer(ctx)
        try:
            t = srv.open_tenant("t")
            assert t.lat_us.maxlen == 3
        finally:
            srv.close()
        lh = LiveHealth(rank=0)
        assert lh.TENANT_LAT_RING == 3
        for us in (1.0, 2.0, 3.0, 4.0):
            lh.note_tenant_latency("t", us)
        assert lh._tenants["t"]["lat"].maxlen == 3
        assert list(lh._tenants["t"]["lat"]) == [2.0, 3.0, 4.0]


# ---------------------------------------------------------------------- #
# remote client over the AM layer                                        #
# ---------------------------------------------------------------------- #
_REMOTE = {"ctx": None, "hits": 0}


def _remote_build():
    """Module-level so it survives the pickled submit path."""
    tp = dtd.taskpool_new()

    def body(es, task):
        _REMOTE["hits"] += 1

    for k in range(5):
        tp.insert_task(body, (k, VALUE))
    return tp


def _pump(engines):
    """A thread draining the engines' progress — the role the comm
    thread plays in a deployment."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            for e in engines:
                e.progress()
            time.sleep(0.002)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return stop, th


def _serve_pair(ctx):
    """Server on engine 0 (bound to the real context), client on
    engine 1, with a pump thread draining both engines' progress."""
    fabric = LocalFabric(2)
    e0, e1 = fabric.engine(0), fabric.engine(1)
    srv = SessionServer(ctx)
    srv.attach_engine(e0)
    cli = ServeClient(e1, server_rank=0, timeout=30.0)
    stop, th = _pump((e0, e1))
    return srv, cli, e0, e1, stop, th


def _open_submit_wait_stats(cli):
    msg = cli.open_tenant("acme", weight=8)
    assert msg["tenant"] == "acme" and msg["weight"] == 8
    ticket = cli.submit("acme", _remote_build, ntasks=5)
    done = cli.wait(ticket)          # deferred server-side reply
    assert done["ticket"] == ticket and done["lat_us"] > 0
    assert _REMOTE["hits"] == 5
    st = cli.stats()["tenants"]["acme"]
    assert st["pools_done"] == 1 and st["weight"] == 8
    with pytest.raises(RuntimeError, match="unknown tenant"):
        cli.submit("ghost", _remote_build)


def test_remote_open_submit_wait_stats(ctx):
    _REMOTE["ctx"], _REMOTE["hits"] = ctx, 0
    srv, cli, _e0, _e1, stop, th = _serve_pair(ctx)
    try:
        _open_submit_wait_stats(cli)
    finally:
        stop.set()
        th.join(5)
        srv.close()


def test_remote_capability_gate(ctx):
    srv, cli, e0, e1, stop, th = _serve_pair(ctx)
    try:
        # client side: a peer that never negotiated "sv" is refused
        # locally, before any bytes move
        e1.serve_to = lambda dst: False
        with pytest.raises(RuntimeError, match="sv capability"):
            cli.open_tenant("acme")
        # server side: the gate answers with a versioned error reply
        del e1.serve_to
        e0.serve_to = lambda src: False
        with pytest.raises(RuntimeError, match="did not negotiate"):
            cli.open_tenant("acme")
    finally:
        stop.set()
        th.join(5)
        srv.close()


def test_serve_client_owns_reply_tag_exclusively():
    """The engine keeps one handler per tag: a second ServeClient
    would silently detach the first, so construction refuses until the
    first is closed; close() also fails parked callers promptly."""
    fabric = LocalFabric(2)
    e1 = fabric.engine(1)
    c1 = ServeClient(e1, server_rank=0, timeout=30.0)
    with pytest.raises(RuntimeError, match="one ServeClient per engine"):
        ServeClient(e1, server_rank=0)
    errs = []

    def _blocked():
        try:
            c1.stats()                 # no server attached: never replies
        except Exception as exc:       # noqa: BLE001
            errs.append(exc)

    th = threading.Thread(target=_blocked, daemon=True)
    th.start()
    time.sleep(0.05)
    c1.close()
    th.join(5)
    assert errs and "closed" in str(errs[0])
    with pytest.raises(RuntimeError, match="closed"):
        c1.stats()
    # the tag is free again: a successor attaches cleanly
    with ServeClient(e1, server_rank=0) as c2:
        assert c2 is not None


def test_remote_over_tcp_localhost(ctx):
    """The same remote path over two TCP engines on localhost, both with
    the serve knob (the "sv" capability negotiated); a client toward a
    peer whose knob is unset is refused before any bytes move."""
    from test_torch_comm_wire import _engines_with, _peer_obj, _wait
    _REMOTE["ctx"], _REMOTE["hits"] = ctx, 0
    e0, e1 = _engines_with([dict(serve=True), dict(serve=True)])
    srv = cli = None
    stop, th = _pump((e0, e1))
    try:
        assert _wait(lambda: _peer_obj(e0, 1) is not None
                     and _peer_obj(e0, 1).hello_seen
                     and _peer_obj(e1, 0) is not None
                     and _peer_obj(e1, 0).hello_seen)
        assert e0.serve_to(1) and e1.serve_to(0)
        srv = SessionServer(ctx)
        srv.attach_engine(e0)
        cli = ServeClient(e1, server_rank=0, timeout=30.0)
        _open_submit_wait_stats(cli)
    finally:
        stop.set()
        th.join(5)
        if cli is not None:
            cli.close()
        if srv is not None:
            srv.close()
        e0.fini()
        e1.fini()
    f0, f1 = _engines_with([dict(serve=True), dict()])
    try:
        assert _wait(lambda: _peer_obj(f1, 0) is not None
                     and _peer_obj(f1, 0).hello_seen)
        assert not f1.serve_to(0)
        with ServeClient(f1, server_rank=0) as c:
            with pytest.raises(RuntimeError, match="sv capability"):
                c.open_tenant("acme")
    finally:
        f0.fini()
        f1.fini()


# ---------------------------------------------------------------------- #
# tenant-stamped flow contexts -> cross-rank tooling                     #
# ---------------------------------------------------------------------- #
def _tenant_flow_pair():
    fabric = LocalFabric(2)
    engines, profiles = [], []
    for r in range(2):
        eng = fabric.engine(r)
        p = Profile(rank=r)
        eng._obs = CommObs(MetricsRegistry(), profile=p)
        fl = FlowIds(r)
        fl.live = True
        eng._flow = fl
        engines.append(eng)
        profiles.append(p)
    return engines, profiles


def test_tenant_rides_flow_context_and_stitches():
    (e0, e1), (p0, p1) = _tenant_flow_pair()
    e0._flow.tenants = {42: "acme"}       # what attach/ctor install
    got = []
    e1.tag_register(TAG_ACTIVATE, lambda src, pl: got.append(pl))
    e0.send_am(1, TAG_ACTIVATE,
               {"tp_id": 42, "root": 0, "ranks": [1], "edges": {1: []}})
    e0.send_am(1, TAG_ACTIVATE,
               {"tp_id": 99, "root": 0, "ranks": [1], "edges": {1: []}})
    e1.progress()
    assert got[0]["_tr"][4] == "acme"     # owned pool: attributed
    assert got[1]["_tr"][4] is None       # foreign pool: unattributed
    docs = [p0.to_chrome_trace(), p1.to_chrome_trace()]
    edges, unmatched = stitch_flows(load_flow_events(merge_trace_docs(docs)))
    assert unmatched == 0
    tagged = [e for e in edges if e.get("tenant") == "acme"]
    assert len(tagged) == 1
    assert sum(1 for e in edges if "tenant" in e) == 1
    # the offline report narrows to one tenant and rolls it up
    report = analyze(docs, tenant="acme")
    per = report["cross_rank"]["per_tenant"]
    assert set(per) == {"acme"}
    assert per["acme"]["flow_edges"] == 1


# ---------------------------------------------------------------------- #
# live-health attribution                                                #
# ---------------------------------------------------------------------- #
def test_live_health_per_tenant_merge_and_render():
    lh0, lh1 = LiveHealth(rank=0), LiveHealth(rank=1)
    assert "per_tenant" not in lh0.snapshot()   # no-tenant shape intact
    for us in (1000.0, 2000.0, 3000.0):
        lh0.note_tenant_latency("acme", us)
    lh1.note_tenant_latency("acme", 9000.0)
    lh1.note_tenant_latency("bulk", 500.0)
    s0, s1 = lh0.snapshot(), lh1.snapshot()
    assert s0["per_tenant"]["acme"]["pools_done"] == 3
    assert s0["per_tenant"]["acme"]["p99_lat_us"] == 3000.0
    fleet = fleet_health({0: s0, 1: s1})
    acme = fleet["per_tenant"]["acme"]
    assert acme["pools_done"] == 4
    assert acme["p99_lat_us"] == 9000.0         # fleet-worst, not a sum
    text = format_health(fleet)
    assert "acme" in text and "bulk" in text
    # a fleet document with no tenant renders with no tenant section
    pre = fleet_health({0: LiveHealth(rank=0).snapshot()})
    assert "per_tenant" not in pre
    format_health(pre)


# ---------------------------------------------------------------------- #
# knob contract: unset constructs nothing, set implies the monitor      #
# ---------------------------------------------------------------------- #
def test_serve_knob_unset_is_inert(ctx):
    assert ctx.serve_fairness is None
    assert not any(n.startswith("PARSEC::SERVE")
                   for n in ctx.sde.names())
    assert ctx.obs.live is None


def test_serve_knob_implies_live_monitor():
    with params.cmdline_override("serve", "1"):
        c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
        try:
            assert c.obs.live is not None, \
                "serve=1 must arm obs_live (tenant SLO attribution)"
            assert c.obs.tuner is None
        finally:
            c.fini()


# ---------------------------------------------------------------------- #
# parity with the JAX package                                            #
# ---------------------------------------------------------------------- #
class _Pool:
    def __init__(self, tp_id):
        self.taskpool_id = tp_id


class _T:
    def __init__(self, tp):
        self.taskpool = tp


@pytest.mark.parametrize("seed", range(3))
def test_fairness_boosts_match_jax_package(seed):
    """Seeded registrations, pool bindings, completions and forgets
    through both packages' TenantFairness: every tenant's boost and
    every task's boost agree after each step."""
    from parsec_tpu.serve import TenantFairness as JaxFairness
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(60):
        kind = rng.choice(["register", "done", "done", "done", "forget"])
        name = f"t{rng.randint(0, 5)}"
        ops.append((kind, name, int(rng.randint(1, 12)),
                    int(rng.randint(1, 300))))
    trails = []
    for cls in (TenantFairness, JaxFairness):
        fair, trail = cls(), []
        for i, (kind, name, w, n) in enumerate(ops):
            if kind == "register":
                fair.register(name, w)
                fair.bind_pool(i, name)
            elif kind == "done":
                fair.note_done(name, n)
            else:
                fair.forget(name)
            tasks = [_T(_Pool(j)) for j in range(i + 1)] + [_T(None)]
            trail.append((fair.tenants(),
                          {t: fair.boost_of_tenant(t)
                           for t in sorted(fair.tenants())},
                          [fair.boost_of_task(t) for t in tasks]))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert any(any(b for b in step[1].values()) for step in trails[0])


def _admission_script(seed):
    rng = np.random.RandomState(seed)
    tenants = [("a", 4, 2000, 2, 0), ("b", 1, 0, 0, 6), ("c", 2, 900, 1, 4)]
    subs = [(tenants[int(rng.randint(0, 3))][0],
             int(rng.choice([0, 200, 500, 800])),
             int(rng.randint(1, 4))) for _ in range(14)]
    return tenants, subs


def _run_admission(srv_cls, adm_err, dtd_mod, ctx, seed, admission):
    """The seeded script through one package's server: each tenant
    opened with weight, quota, max_pools, max_tasks; each submission's
    verdict (admitted / queued / the rejection text) and the stats after
    it; then the gated pools released and the stats at the end."""
    tenants, subs = _admission_script(seed)
    gate = threading.Event()
    srv = srv_cls(ctx, admission=admission)
    out = []

    def strip(st):
        return {n: {k: v for k, v in t.items() if "lat" not in k}
                for n, t in st["tenants"].items()}
    try:
        for name, w, quota, pools, tasks in tenants:
            srv.open_tenant(name, weight=w, quota_bytes=quota,
                            max_pools=pools, max_tasks=tasks)

        def build():
            tp = dtd_mod.taskpool_new()

            def body(es, task):
                gate.wait(30)
            tp.insert_task(body)
            return tp
        handles = []
        for name, nbytes, ntasks in subs:
            try:
                sub = srv.submit(name, build, nbytes=nbytes,
                                 ntasks=ntasks)
                handles.append(sub)
                verdict = ("queued" if sub.taskpool is None
                           and not sub.done.is_set() else "admitted",
                           sub.ticket)
            except adm_err as exc:
                verdict = ("rejected", str(exc))
            out.append((verdict, strip(srv.stats())))
        gate.set()
        for sub in handles:
            assert sub.wait(30) and sub.error is None
        out.append(strip(srv.stats()))
    finally:
        gate.set()
        srv.close()
    return out


@pytest.mark.parametrize("seed,admission", [(0, "reject"), (1, "reject"),
                                            (2, "queue"), (3, "queue")])
def test_admission_verdicts_match_jax_package(ctx, seed, admission):
    """The same seeded tenants and submissions through both packages'
    SessionServer: every admission verdict (admitted with its ticket,
    queued, or the same rejection reason) and every accounting field
    (in-flight pools, tasks and bytes, queue length, quota use, boost)
    agrees after each submission and after the pools retire."""
    import parsec_tpu
    from parsec_tpu import dtd as jax_dtd
    from parsec_tpu.serve import AdmissionError as JaxAdmissionError
    from parsec_tpu.serve import SessionServer as JaxServer
    got = _run_admission(SessionServer, AdmissionError, dtd, ctx, seed,
                         admission)
    jctx = parsec_tpu.init(nb_cores=2)
    try:
        ref = _run_admission(JaxServer, JaxAdmissionError, jax_dtd, jctx,
                             seed, admission)
    finally:
        jctx.fini()
    assert got == ref
    kinds = {v[0][0] for v in got[:-1]}
    assert "admitted" in kinds and len(kinds) == 2, kinds
