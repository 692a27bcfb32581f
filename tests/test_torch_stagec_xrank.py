"""Cross-rank SPMD stages in the port (parsec_tpu_torch.stagec.xrank)
against the JAX package's (parsec_tpu.stagec.xrank) and against the
port's own interpreted runtime.

On the CPU each rank thread runs with ``device="cpu"`` and
``device_cuda_virtual_chips=2``, so the two ranks' lane chips are
distinct host chips; a wave's blocks then run eagerly on the last
depositor's thread.  The factor of every leg is the port's interpreted
2-rank factor bit for bit, and within ``F64_ATOL_PER_N * n`` of the JAX
package's interpreted 2-rank factor (the port's tile products are fp32
by design).  The cross-rank PLAN is pure Python in both packages and is
held exactly: waves, their members and boundary edges, the per-member
feeds and the ``--lower-report`` verdict texts.  Then each mechanism
alone: the XStore refcount and its private copies, the digest and epoch
exchange, a decline, a dead peer and a timeout (each raising on every
participant), lane chips that are not distinct, and the in-process
fabric's knob gating.  The card's case is in
tests/test_torch_stagec_chain.py, which imports no JAX.
"""
import errno
import threading
import time
import types
import weakref
from contextlib import ExitStack

import jax
import numpy as np
import pytest
import torch

import parsec_tpu
import parsec_tpu_torch as ptt
from parsec_tpu import ops as jops
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.ops import dtrsm as jdtrsm
from parsec_tpu.stagec.plan import plan_stages as jplan_stages
from parsec_tpu.stagec.xrank import plan_xwaves as jplan_xwaves

from parsec_tpu_torch import ops
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.graph import CaptureError
from parsec_tpu_torch.ops import dpotrf_taskpool, dtrsm, make_spd
from parsec_tpu_torch.stagec import xrank
from parsec_tpu_torch.stagec.plan import plan_stages
from parsec_tpu_torch.utils.params import params

N, NB, NR = 128, 32, 2
#: fp64 tiles, per unit of n (tests/test_torch_stagec.py): the port's
#: tile products are fp32 by design, so fp64 factors of the two packages
#: differ at fp32 rounding, never at fp64's
F64_ATOL_PER_N = 1e-8
#: the CPU's lane chips: one per rank
CHIPS = {"device_cuda_virtual_chips": "2"}


def _knobs(**kv):
    st = ExitStack()
    for k, v in kv.items():
        st.enter_context(params.cmdline_override(k, str(v)))
    return st


def _legs(stagec: bool, xr: bool, **kv):
    kn = dict(CHIPS, **kv)
    if stagec:
        kn["stage_compile"] = "1"
    if xr:
        kn["stage_compile_xrank"] = "1"
    return kn


def _assemble(results, n=N, nb=NB):
    L = np.zeros((n, n))
    for owned in results:
        for (m, k), t in owned.items():
            L[m * nb:m * nb + t.shape[0], k * nb:k * nb + t.shape[1]] = t
    return np.tril(L)


def _threads(nr, fn, timeout=120.0):
    """``fn(rank)`` on one thread a rank; a thread still alive after
    ``timeout`` seconds raises TimeoutError instead of hanging the run."""
    from parsec_tpu_torch.utils.spmd import spmd_threads
    return spmd_threads(nr, lambda r, _f: fn(r), timeout=timeout)[0]


def _tcp_engines(make, nr):
    """``nr`` TCP engines on free localhost ports, built in parallel (each
    constructor dials); ports taken meanwhile by another process make it
    try again."""
    from parsec_tpu_torch.comm.tcp import free_ports
    for attempt in range(5):
        eps = [("127.0.0.1", p) for p in free_ports(nr)]
        try:
            return _threads(nr, lambda r: make(r, eps), timeout=60)
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE or attempt == 4:
                raise


def _run_tcp(M, knobs, xstage_ctor=None, device="cpu", dtype=np.float64,
             n=N, nb=NB, nr=NR, pools=None):
    """dpotrf over ``nr`` rank threads on loopback TCP, the knobs set
    around the engines' construction (``"xs"`` rides the HELLO).
    ``xstage_ctor`` overrides each engine's ``xstage`` keyword (None:
    follow the knob).  Returns (L, per-rank stage stats, per-rank
    remote_dep stats, the "xs" links, per-rank program reports); a weak
    reference to each rank's pool goes into ``pools`` when given."""
    from parsec_tpu_torch.comm import RemoteDepEngine
    from parsec_tpu_torch.comm.tcp import TCPCommEngine

    def make(r, eps):
        kw = {} if xstage_ctor is None or xstage_ctor[r] is None \
            else {"xstage": xstage_ctor[r]}
        return TCPCommEngine(r, eps, **kw)

    with _knobs(**knobs):
        engines = _tcp_engines(make, nr)
        links = [[engines[r].xstage_to(p) for p in range(nr) if p != r]
                 for r in range(nr)]

        def rank_fn(rank):
            eng = RemoteDepEngine(engines[rank])
            ctx = ptt.Context(nb_cores=2, device=device, comm=eng)
            try:
                A = TwoDimBlockCyclic(n, n, nb, nb, P=nr, Q=1, nodes=nr,
                                      rank=rank, dtype=dtype
                                      ).from_numpy(M.copy())
                A.name = "descA"
                tp = dpotrf_taskpool(A, rank=rank, nb_ranks=nr)
                if pools is not None:
                    pools.append(weakref.ref(tp))
                ctx.add_taskpool(tp)
                ctx.wait()
                owned = {c: np.asarray(A.data_of(*c).sync_to_host().payload)
                         for c in A.tiles() if A.rank_of(*c) == rank}
                rows = (tp._stagec.program_report()
                        if tp._stagec is not None else [])
                return (owned, dict(ctx.stage_stats), dict(eng.stats),
                        rows)
            finally:
                ctx.fini()

        results = _threads(nr, rank_fn)
    return (_assemble([r[0] for r in results], n, nb),
            [r[1] for r in results], [r[2] for r in results], links,
            [r[3] for r in results])


@pytest.fixture(scope="module")
def spd():
    return make_spd(N)


@pytest.fixture(scope="module")
def interpreted(spd):
    """The port's interpreted 2-rank factor (no stage compilation)."""
    return _run_tcp(spd, dict(CHIPS))[0]


@pytest.fixture(scope="module")
def jax_factor(spd):
    """The JAX package's interpreted 2-rank factor of the same input over
    its own loopback TCP engines, jax x64 on (fp64 tiles)."""
    from parsec_tpu.comm import RemoteDepEngine as JRemoteDepEngine
    from parsec_tpu.comm.tcp import TCPCommEngine as JTCPCommEngine
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        engines = _tcp_engines(lambda r, eps: JTCPCommEngine(r, eps), NR)

        def rank_fn(rank):
            ctx = parsec_tpu.Context(nb_cores=2,
                                     comm=JRemoteDepEngine(engines[rank]))
            try:
                A = JTwoDimBlockCyclic(N, N, NB, NB, P=NR, Q=1, nodes=NR,
                                       rank=rank, dtype=np.float64
                                       ).from_numpy(spd.copy())
                A.name = "descA"
                ctx.add_taskpool(jops.dpotrf_taskpool(A, rank=rank,
                                                      nb_ranks=NR))
                ctx.wait()
                return {c: np.asarray(A.data_of(*c).sync_to_host().payload)
                        for c in A.tiles() if A.rank_of(*c) == rank}
            finally:
                ctx.fini()

        return _assemble(_threads(NR, rank_fn))
    finally:
        jax.config.update("jax_enable_x64", was)


def _hold(L, interpreted, jax_factor):
    np.testing.assert_array_equal(L, interpreted)
    np.testing.assert_allclose(L, jax_factor, atol=F64_ATOL_PER_N * N,
                               rtol=0)


# --------------------------------------------------------------------- #
# the reference's three cases                                          #
# --------------------------------------------------------------------- #
def test_xrank_engages_and_is_bit_exact(spd, interpreted, jax_factor):
    """Both ranks knob-on over loopback TCP: every spanning wave runs as
    ONE program over the two lane chips (xstage_tasks > 0 on every rank,
    no fallback), "xs" negotiated both ways, elided activations carry no
    payload, and the factor is the interpreted one bit for bit."""
    L, st, cs, links, _rows = _run_tcp(spd, _legs(True, True))
    assert all(all(lk) for lk in links), links
    assert all(s["xstage_tasks"] > 0 and s["xstage_compiles"] > 0
               for s in st), st
    assert all(s["xstage_fallbacks"] == 0 for s in st), st
    assert all(s["xstage_collective_bytes"] > 0 for s in st), st
    assert all(c["xs_elisions"] > 0 for c in cs), cs
    _hold(L, interpreted, jax_factor)


def test_xrank_mixed_version_negotiates_down(spd, interpreted, jax_factor):
    """Rank 1's engine predates "xs" (``xstage=False``, what an old
    build's HELLO looks like) while both ranks run with the knob on:
    rank 0 negotiates DOWN and every wave keeps the activation path —
    rank-local stages, no cross-rank engagement, bit for bit."""
    L, st, cs, links, _rows = _run_tcp(spd, _legs(True, True),
                                       xstage_ctor=[None, False])
    assert not any(links[0]), links
    for s in st:
        assert s["xstage_tasks"] == 0 and s["xstage_compiles"] == 0, st
        assert s["stage_tasks"] > 0, st
    assert all(c["xs_elisions"] == 0 for c in cs), cs
    _hold(L, interpreted, jax_factor)


def test_xrank_knob_unset_keeps_activation_path(spd, interpreted,
                                                jax_factor):
    """With only ``stage_compile`` on, no engine advertises "xs", no
    cross-rank block builds (every XSTAGE counter stays 0) and the
    factor matches the interpreted run bit for bit."""
    L, st, cs, links, _rows = _run_tcp(spd, _legs(True, False))
    assert not any(any(lk) for lk in links), links
    for s in st:
        for k in ("xstage_tasks", "xstage_compiles",
                  "xstage_collective_bytes", "xstage_fallbacks"):
            assert s[k] == 0, st
        assert s["stage_tasks"] > 0, st
    assert all(c["xs_elisions"] == 0 for c in cs), cs
    _hold(L, interpreted, jax_factor)


def test_fini_releases_the_pools_of_in_process_tcp_ranks(spd):
    """Rank threads of one process on TCP: a transport thread outlives
    the engine's fini (the accept loop), and through the engine's
    callbacks it kept each rank's context, pool, stage programs and
    their tiles alive.  After fini and a collection no pool is left."""
    import gc
    pools = []
    _run_tcp(spd, _legs(True, True), pools=pools)
    gc.collect()
    assert len(pools) == NR and all(r() is None for r in pools), \
        [r() for r in pools]


# --------------------------------------------------------------------- #
# the plan, exactly                                                    #
# --------------------------------------------------------------------- #
def _plain(x):
    """Plain ints, strings and tuples (numpy scalars and lists become
    their plain forms)."""
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in x.items()))
    if isinstance(x, np.integer):
        return int(x)
    return x


def _waves(plan):
    return [_plain((w.wave_id, w.level, w.class_name, w.ranks,
                    w.members_by_rank, w.n_max, w.boundary, w.feeds,
                    w.my_stage_index))
            for w in plan.xwaves]


def _pool(spec, T, o, tr, n, nb, rank):
    def coll(name, shape, tile):
        c = T(*shape, *tile, P=NR, Q=1, nodes=NR, rank=rank,
              dtype=np.float32)
        c.name = name
        return c
    sq = lambda nm: coll(nm, (n, n), (nb, nb))  # noqa: E731
    if spec == "dpotrf":
        return o.dpotrf_taskpool(sq("descA"), rank=rank, nb_ranks=NR)
    if spec == "dtrsm_fwd":
        return tr.dtrsm_lower_taskpool(sq("descL"),
                                       coll("descB", (n, nb), (nb, nb)),
                                       rank=rank, nb_ranks=NR)
    if spec == "dgetrf_nopiv":
        return o.dgetrf_nopiv_taskpool(sq("descA"), rank=rank, nb_ranks=NR)
    if spec == "pdgemm":
        return o.pdgemm_taskpool(sq("descA"), sq("descB"), sq("descC"),
                                 alpha=1.5, beta=0.5, rank=rank,
                                 nb_ranks=NR)
    raise KeyError(spec)


@pytest.mark.parametrize("max_tasks", [1024, 3])
@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("spec,n,nb", [
    ("dpotrf", 128, 32), ("dpotrf", 160, 32), ("dpotrf", 100, 32),
    ("dtrsm_fwd", 128, 32), ("dgetrf_nopiv", 128, 32),
    ("pdgemm", 96, 32)])
def test_xrank_plan_matches_jax_package(spec, n, nb, rank, max_tasks):
    """The same spec, rank and knobs through both packages' planners:
    the cross-rank waves (ids, levels, classes, ranks, members by rank,
    boundary edges, feeds, this rank's stage) and the verdict texts of
    the ``--lower-report`` column agree exactly."""
    jtp = _pool(spec, JTwoDimBlockCyclic, jops, jdtrsm, n, nb, rank)
    ptp = _pool(spec, TwoDimBlockCyclic, ops, dtrsm, n, nb, rank)
    jp = jplan_stages(jtp, rank=rank, max_tasks=max_tasks, wavefront=True)
    pp = plan_stages(ptp, rank=rank, max_tasks=max_tasks, wavefront=True)
    jplan_xwaves(jtp, jp, max_tasks)
    xrank.plan_xwaves(ptp, pp, max_tasks)
    assert _waves(pp) == _waves(jp)
    assert list(pp.xwave_report) == list(jp.xwave_report)
    assert xrank.xwaves_digest(pp.xwaves) == xrank.xwaves_digest(
        _as_port_waves(jp.xwaves))
    assert pp.xwave_report, "no wave group: the case tests nothing"


def _as_port_waves(jwaves):
    return [xrank.XWave(w.wave_id, w.level, w.class_name, w.ranks,
                        w.members_by_rank, w.boundary, w.feeds)
            for w in jwaves]


def test_xrank_one_rank_pool_plans_no_waves():
    """A pool of one rank plans no cross-rank wave even with the knob
    set (the knob needs nb_ranks > 1)."""
    with _knobs(**_legs(True, True)):
        ctx = ptt.init(nb_cores=1, device="cpu")
        try:
            A = TwoDimBlockCyclic(N, N, NB, NB,
                                  dtype=np.float64).from_numpy(make_spd(N))
            tp = dpotrf_taskpool(A)
            ctx.add_taskpool(tp)
            ctx.wait()
            assert tp._stagec.plan.xwaves == []
            assert ctx.stage_stats["xstage_tasks"] == 0
        finally:
            ctx.fini()


# --------------------------------------------------------------------- #
# each mechanism alone                                                 #
# --------------------------------------------------------------------- #
def test_xstore_refcount():
    """A parked payload is taken once per receiving rank, then gone; a
    key never parked (or taken out) answers None."""
    key = xrank.xstore_key(0, 7)
    assert key[:3] == ("xs", 0, 7)
    assert xrank.xstore_key(0, 7) != key
    obj = object()
    n0 = len(xrank.XSTORE)
    xrank.XSTORE.put(key, obj, 2)
    assert len(xrank.XSTORE) == n0 + 1
    assert xrank.XSTORE.take(key) is obj
    assert len(xrank.XSTORE) == n0 + 1
    assert xrank.XSTORE.take(key) is obj
    assert len(xrank.XSTORE) == n0
    assert xrank.XSTORE.take(key) is None


def _elide_one(payload):
    """One activation from rank 0 to a cross-rank wave member on rank 1
    through the port's remote_dep: returns (the message sent, the
    engine)."""
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    fab = LocalFabric(2)
    eng = RemoteDepEngine(fab.engine(0))
    sent = []
    eng.ce.send_am = lambda dst, tag, msg: sent.append((dst, tag, msg))
    tp = types.SimpleNamespace(
        comm_tp_id=0, wire_lossless=False, _xs_targets={("T", (1,))},
        task_classes=[types.SimpleNamespace(
            ast=types.SimpleNamespace(name="T"))])
    with _knobs(stage_compile_xrank="1"):
        eng.activate_batch(tp, None, {0: payload},
                           {1: [(0, (1,), "A", 0)]})
    return sent, eng


@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_parked_payload_is_a_private_copy(kind):
    """The wire carries control only (no data, handle or xfer), and what
    parks is a private copy: a write to the source after parking leaves
    the parked payload as it was.  A host payload parks read-only."""
    src0 = np.arange(16, dtype=np.float32).reshape(4, 4)
    src = torch.from_numpy(src0.copy()) if kind == "tensor" \
        else src0.copy()
    sent, eng = _elide_one(src)
    (dst, _tag, msg), = sent
    assert dst == 1 and "xs" in msg
    assert not ({"data", "handle", "xfer"} & set(msg)), msg
    assert eng.stats["xs_elisions"] == 1
    src[0, 0] = -1.0
    got = xrank.XSTORE.take(tuple(msg["xs"]))
    np.testing.assert_array_equal(np.asarray(got), src0)
    if kind == "ndarray":
        assert not got.flags.writeable
    assert xrank.XSTORE.take(tuple(msg["xs"])) is None


def test_xs_elision_needs_every_edge_in_a_wave():
    """A flow with one consumer edge outside every cross-rank wave keeps
    its payload on the wire."""
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    fab = LocalFabric(2)
    eng = RemoteDepEngine(fab.engine(0))
    sent = []
    eng.ce.send_am = lambda dst, tag, msg: sent.append(msg)
    tp = types.SimpleNamespace(
        comm_tp_id=0, wire_lossless=False, _xs_targets={("T", (1,))},
        task_classes=[types.SimpleNamespace(
            ast=types.SimpleNamespace(name="T"))])
    with _knobs(stage_compile_xrank="1"):
        eng.activate_batch(tp, None, {0: torch.ones(2, 2)},
                           {1: [(0, (1,), "A", 0), (0, (2,), "A", 0)]})
    assert "xs" not in sent[0] and "data" in sent[0]
    assert eng.stats["xs_elisions"] == 0


def _exchange(digests, epochs, timeout=5.0):
    """Both ranks of a LocalFabric run the digest exchange at once;
    returns per rank its result or the exception it raised."""
    from parsec_tpu_torch.comm import LocalFabric
    fab = LocalFabric(2)
    engines = [fab.engine(r) for r in range(2)]
    out = [None, None]

    def go(r):
        try:
            out[r] = xrank._exchange_digest(engines[r], [1 - r], digests[r],
                                            epochs[r], timeout)
        except Exception as exc:  # noqa: BLE001 - the result under test
            out[r] = exc

    ts = [threading.Thread(target=go, args=(r,), daemon=True)
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive(), "the digest exchange hung"
    return out


def test_digest_mismatch_raises():
    """Ranks that disagree on the wave partition raise on both sides."""
    out = _exchange(["a" * 40, "b" * 40], [1, 1])
    assert all(isinstance(o, RuntimeError) and "diverges" in str(o)
               for o in out), out


def test_epoch_skew_and_missing_digest_negotiate_down():
    """An install-epoch skew negotiates the pool down to rank-local
    stages on both sides; so does a peer that sends no digest within the
    timeout."""
    assert _exchange(["a" * 40] * 2, [1, 2]) == [False, False]
    assert _exchange(["a" * 40] * 2, [3, 3]) == [True, True]
    from parsec_tpu_torch.comm import LocalFabric
    fab = LocalFabric(2)
    e0 = fab.engine(0)
    fab.engine(1)
    assert xrank._exchange_digest(e0, [1], "a" * 40, 1, 0.2) is False


def _ranks(M, knobs, fabric=None, nr=NR, n=N, nb=NB, catch=False,
           timeout=120.0):
    """dpotrf over ``nr`` in-process rank threads (utils.spmd) on a
    LocalFabric or ``fabric``; returns per rank (owned tiles, stage
    stats) — or, with ``catch``, the exception the rank raised.  A rank
    thread still alive after ``timeout`` seconds raises TimeoutError."""
    from parsec_tpu_torch.comm import RemoteDepEngine
    from parsec_tpu_torch.utils.spmd import spmd_threads

    def rank_fn(rank, fab):
        ctx = ptt.Context(nb_cores=2, device="cpu",
                          comm=RemoteDepEngine(fab.engine(rank)))
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb, P=nr, Q=1, nodes=nr,
                                  rank=rank, dtype=np.float64
                                  ).from_numpy(M.copy())
            A.name = "descA"
            ctx.add_taskpool(dpotrf_taskpool(A, rank=rank, nb_ranks=nr))
            ctx.wait()
            out = ({c: np.asarray(A.data_of(*c).sync_to_host().payload)
                    for c in A.tiles() if A.rank_of(*c) == rank},
                   dict(ctx.stage_stats))
        except Exception as exc:  # noqa: BLE001 - the result under test
            # a pool whose startup raised is still registered: the fini
            # that follows would only repeat that
            try:
                ctx.fini()
            except AssertionError:
                pass
            if not catch:
                raise
            return exc
        ctx.fini()
        return out

    with _knobs(**knobs):
        res, _f = spmd_threads(nr, rank_fn, timeout=timeout, fabric=fabric)
    return res


def test_inproc_fabric_gates_on_the_knob_alone(spd, interpreted):
    """An in-process fabric has no HELLO: the MeshFabric (through
    utils.spmd) engages on the knob alone, and without it every stage
    stays rank-local; both bit for bit."""
    from parsec_tpu_torch.comm import MeshFabric
    on = _ranks(spd, _legs(True, True), fabric=MeshFabric(
        devices=["cpu"] * NR))
    off = _ranks(spd, _legs(True, False), fabric=MeshFabric(
        devices=["cpu"] * NR))
    assert all(s["xstage_tasks"] > 0 for _o, s in on), on
    assert all(s["xstage_tasks"] == 0 and s["stage_tasks"] > 0
               for _o, s in off), off
    np.testing.assert_array_equal(_assemble([o for o, _s in on]),
                                  interpreted)
    np.testing.assert_array_equal(_assemble([o for o, _s in off]),
                                  interpreted)


def test_decline_sends_peers_rank_local(spd, interpreted, monkeypatch):
    """A rank whose block cannot be recorded downgrades that stage and
    DECLINES its wave: the peer runs its rows rank-local, both count the
    fallback, every other wave stays cross-rank, bit for bit."""
    orig = xrank.build_xblock
    failed = []

    def build(compiler, rec):
        if compiler.tp.rank == 1 and not failed:
            failed.append(rec.xwave.wave_id)
            raise CaptureError("injected record failure")
        return orig(compiler, rec)

    monkeypatch.setattr(xrank, "build_xblock", build)
    res = _ranks(spd, _legs(True, True))
    st = [s for _o, s in res]
    assert failed, "no block was built"
    assert all(s["xstage_fallbacks"] == 1 for s in st), st
    assert st[1]["stage_fallbacks"] == 1, st
    assert all(s["xstage_tasks"] > 0 for s in st), st
    np.testing.assert_array_equal(_assemble([o for o, _s in res]),
                                  interpreted)


def test_waves_dispatch_in_one_order_on_every_rank(spd, interpreted,
                                                  monkeypatch):
    """A wave's rendezvous holds the rank's device manager, so ranks must
    dispatch their cross-rank waves in ONE order: here rank 0's SYRK
    wave and rank 1's GEMM wave of the same level spawn late, so each
    rank would otherwise enter a different wave first and wait for the
    other.  Each rank dispatches its waves in wave-id order, every wave
    runs cross-rank, bit for bit."""
    from parsec_tpu_torch.stagec.runtime import StageCompiler
    orig_block, orig_dispatch = StageCompiler._xblock, xrank.dispatch_xrank
    order = {0: [], 1: []}

    def late_block(self, rec):
        if (self.tp.rank, rec.xwave.class_name) in ((0, "SYRK"),
                                                    (1, "GEMM")):
            time.sleep(0.3)
        return orig_block(self, rec)

    def dispatch(compiler, rec, arrays):
        order[compiler.tp.rank].append(rec.xwave.wave_id)
        return orig_dispatch(compiler, rec, arrays)

    monkeypatch.setattr(StageCompiler, "_xblock", late_block)
    monkeypatch.setattr(xrank, "dispatch_xrank", dispatch)
    res = _ranks(spd, _legs(True, True, stage_xrank_timeout="10"),
                 timeout=60)
    assert order[0] == order[1] == sorted(order[0]), order
    assert all(s["xstage_fallbacks"] == 0 for _o, s in res), res
    np.testing.assert_array_equal(_assemble([o for o, _s in res]),
                                  interpreted)


def _late_deposit(monkeypatch, before):
    """Rank 1's first deposit runs ``before()``, then waits until a
    rendezvous was errored (by rank 0), then deposits."""
    orig = xrank._make_deposit
    hit = []

    def deposit(blk, wave, arrays, me):
        if me == 1 and not hit:
            hit.append(wave.wave_id)
            before()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                with xrank._rdv_cond:
                    if any(e.error for e in xrank._rdv.values()):
                        break
                time.sleep(0.01)
        return orig(blk, wave, arrays, me)

    monkeypatch.setattr(xrank, "_make_deposit", deposit)
    return hit


def test_dead_peer_raises_on_every_participant(spd, monkeypatch):
    """A peer the comm engine reports dead while rank 0 waits at the
    rendezvous errors it: rank 0 raises, and rank 1, arriving after,
    raises too — nobody hangs or falls back."""
    from parsec_tpu_torch.comm import LocalFabric
    fab = LocalFabric(NR)
    hit = _late_deposit(monkeypatch,
                        lambda: fab.engines[0].dead_peers.add(1))
    res = _ranks(spd, _legs(True, True, stage_xrank_timeout="20"),
                 fabric=fab, catch=True, timeout=60)
    assert hit
    for r in res:
        assert isinstance(r, Exception), res
        assert "died before the rendezvous completed" in str(r) \
            or "died before the rendezvous completed" in repr(r.__cause__)


def test_timeout_raises_on_every_participant(spd, monkeypatch):
    """A peer that does not deposit within ``stage_xrank_timeout``: the
    waiting rank errors the rendezvous and raises, and the late rank
    raises when it arrives."""
    hit = _late_deposit(monkeypatch, lambda: None)
    res = _ranks(spd, _legs(True, True, stage_xrank_timeout="0.5"),
                 catch=True, timeout=60)
    assert hit
    for r in res:
        assert isinstance(r, Exception), res
        assert "timed out" in str(r) or "timed out" in repr(r.__cause__)


def test_assembly_error_raises_on_every_participant(spd, monkeypatch):
    """A failure of the last depositor's assembly errors the rendezvous
    first: every participant raises."""
    def broken(wave, deposits):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(xrank, "_assemble_and_run", broken)
    res = _ranks(spd, _legs(True, True, stage_xrank_timeout="20"),
                 catch=True, timeout=60)
    for r in res:
        assert isinstance(r, Exception), res
        assert "injected launch failure" in str(r) \
            or "injected launch failure" in repr(r.__cause__)


def test_record_error_raises_on_every_participant(spd, monkeypatch):
    """A block record that fails with anything but a CaptureError (the
    one downgrade rung) errors its wave's rendezvous before raising: both
    ranks raise, neither waits for the other."""
    orig = xrank.XBlock.record

    def record(self):
        if self.rank == 1 and self.info.class_name == "GEMM":
            raise RuntimeError("injected record failure")
        return orig(self)

    monkeypatch.setattr(xrank.XBlock, "record", record)
    res = _ranks(spd, _legs(True, True, stage_xrank_timeout="20"),
                 catch=True, timeout=60)
    for r in res:
        assert isinstance(r, Exception), res
        assert "injected record failure" in str(r) \
            or "injected record failure" in repr(r.__cause__)


def test_lane_chips_not_distinct_raise(spd):
    """One host chip and no device_cuda_virtual_chips: both ranks' lane
    chip is the same, so the install raises on every rank, naming the
    knob."""
    kn = _legs(True, True)
    del kn["device_cuda_virtual_chips"]
    res = _ranks(spd, kn, catch=True, timeout=60)
    for r in res:
        assert isinstance(r, RuntimeError), res
        assert "device_cuda_virtual_chips" in str(r)


def test_host_read_goes_through_the_writer_modules_pull(monkeypatch):
    """Rank threads of one process each own a device module on the same
    card, and the one registered last holds the card's registry entry.
    A host read of a tensor another rank's module wrote (the payload of
    an activation to a co-resident peer) must copy behind THAT module's
    stream: a tensor tagged with a module's stream goes through that
    module's pull, an untagged one through the card's entry."""
    from parsec_tpu_torch.data import data as pdata
    monkeypatch.setattr(pdata, "_device_streams", {})
    monkeypatch.setattr(pdata, "_device_pulls", {})
    monkeypatch.setattr(pdata, "_stream_pulls", {})
    calls = []

    class Module:
        def __init__(self, name):
            self.name = name
            self.stream = object()

        def pull(self, x):
            calls.append(self.name)
            return x.numpy().copy()

    m0, m1 = Module("rank0"), Module("rank1")
    dev = torch.device("cpu")
    pdata.register_device_stream(dev, m0.stream, m0.pull)
    pdata.register_device_stream(dev, m1.stream, m1.pull)
    t = pdata.tag_stream(torch.arange(4.0), m0.stream)
    assert pdata.to_host_array(t).tolist() == [0.0, 1.0, 2.0, 3.0]
    assert calls == ["rank0"]
    pdata.to_host_array(torch.ones(2))
    assert calls == ["rank0", "rank1"]


def test_single_stream_module_tags_its_outputs():
    """The single-stream device module marks what it writes with its own
    stream (the seam a chip mesh uses for its chips), so a host read or
    a hand-over from another rank's thread queues behind it."""
    from parsec_tpu_torch.data.data import stream_of
    from parsec_tpu_torch.devices.cuda import CudaDevice
    dev = CudaDevice(1, "cpu")
    assert dev._tag(torch.zeros(2), None) is not None
    assert stream_of(dev._tag(torch.zeros(2), None)) is None  # no stream
    dev.stream = object()
    t = dev._tag(torch.zeros(2), None)
    assert stream_of(t) is dev.stream
    assert dev._tag(np.zeros(2), None).shape == (2,)   # host: untouched
