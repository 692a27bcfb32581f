"""The port's redistribution planner (parsec_tpu_torch/xfer/plan.py).

Mirrors the JAX package's ``tests/test_xfer_plan.py`` planner tests
(its loopback tests are mirrored in ``test_torch_comm.py``) and
``tests/test_comm_reliable.py::test_redistribution_survives_flap_bit_identical``:
the schedule is a pure function of the two distributions, with golden
structure for 4->2, 1x4->2x2 and 4->1; the knob-gated redistribute()
path is bit-identical to the DTD walk; a diverging plan fails loudly.
Across packages the same distributions give equal rounds and an equal
``digest()``. The device-plane branch runs on the CPU over the loopback
backend, as it runs over CUDA IPC on the card.
"""
import errno
import threading

import numpy as np
import pytest
import torch

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic, redistribute
from parsec_tpu_torch.comm import DeviceDataPlane, LocalFabric, RemoteDepEngine
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads
from parsec_tpu_torch.xfer import build_plan, run_redistribution

RANK_TIMEOUT = 60.0


def spmd(nb_ranks, fn, fabric=None):
    return spmd_threads(nb_ranks, fn, timeout=RANK_TIMEOUT, fabric=fabric)


def _grid(lm, ln, mb, nb, P, Q, nodes, rank=0):
    return TwoDimBlockCyclic(lm, ln, mb, nb, P=P, Q=Q,
                             nodes=nodes, rank=rank, dtype=np.float64)


# --------------------------------------------------------------------- #
# plan construction                                                     #
# --------------------------------------------------------------------- #
def test_plan_golden_4_to_2():
    """P=4 -> P=2 row-cyclic reshard of a 4x4 tile grid: rows 0/1 stay
    local, rows 2/3 each coalesce into ONE transfer, and both pairs
    share the single (d - s) % 4 == 2 round."""
    plan = build_plan(_grid(8, 8, 2, 2, P=4, Q=1, nodes=4),
                      _grid(8, 8, 2, 2, P=2, Q=1, nodes=4))
    assert plan.nb_ranks == 4
    assert len(plan.local) == 8
    assert plan.n_rounds == 1
    assert plan.n_transfers == 2
    assert plan.tile_moves == 8
    (rnd,) = plan.rounds
    assert [(t.src, t.dst, len(t.tiles)) for t in rnd] == \
        [(2, 0, 4), (3, 1, 4)]


def test_plan_golden_1x4_to_2x2():
    """1x4 -> 2x2 grid flip: every coord whose owners differ moves,
    bucketed per (src, dst) pair — strictly fewer transfers than the
    per-tile storm would pay."""
    plan = build_plan(_grid(8, 8, 2, 2, P=1, Q=4, nodes=4),
                      _grid(8, 8, 2, 2, P=2, Q=2, nodes=4))
    moved = plan.tile_moves
    assert moved + len(plan.local) == 16
    assert moved > 0
    assert plan.n_transfers < moved
    for rnd in plan.rounds:
        assert len({t.src for t in rnd}) == len(rnd)
        assert len({t.dst for t in rnd}) == len(rnd)
        for t in rnd:
            assert t.tiles == tuple(sorted(t.tiles))


def test_plan_golden_4_to_1():
    """Gather: P=4 -> P=1 concentrates everything on rank 0 — three
    coalesced transfers, one per source, spread over three rounds."""
    plan = build_plan(_grid(8, 8, 2, 2, P=4, Q=1, nodes=4),
                      _grid(8, 8, 2, 2, P=1, Q=1, nodes=4))
    assert len(plan.local) == 4
    assert plan.n_transfers == 3
    assert plan.n_rounds == 3
    assert sorted((t.src, t.dst) for rnd in plan.rounds for t in rnd) \
        == [(1, 0), (2, 0), (3, 0)]


def test_plan_pure_function_of_distributions():
    """Two independently constructed geometry pairs produce identical
    plans (and digests) — across ANY viewing rank."""
    def mk(r):
        return (_grid(12, 12, 3, 3, P=4, Q=1, nodes=4, rank=r),
                _grid(12, 12, 3, 3, P=2, Q=2, nodes=4, rank=r))
    plans = [build_plan(*mk(r)) for r in range(4)] + [build_plan(*mk(0))]
    assert len({p.digest() for p in plans}) == 1
    assert all(p == plans[0] for p in plans)


@pytest.mark.parametrize("grids", [
    ((4, 1), (2, 1)), ((1, 4), (2, 2)), ((4, 1), (1, 1))],
    ids=["4to2", "1x4to2x2", "4to1"])
def test_plan_digest_equals_jax_package(grids):
    """The JAX package builds the same plan for the same distributions:
    equal rounds and an equal ``digest()`` (sha1 of the same repr)."""
    from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBC
    from parsec_tpu.xfer import build_plan as jax_build_plan
    (P0, Q0), (P1, Q1) = grids
    ours = build_plan(_grid(12, 12, 3, 3, P0, Q0, nodes=4),
                      _grid(12, 12, 3, 3, P1, Q1, nodes=4))
    theirs = jax_build_plan(
        JaxTwoDimBC(12, 12, 3, 3, P=P0, Q=Q0, nodes=4, dtype=np.float64),
        JaxTwoDimBC(12, 12, 3, 3, P=P1, Q=Q1, nodes=4, dtype=np.float64))
    assert tuple(ours) == tuple(theirs)
    assert ours.n_rounds == theirs.n_rounds
    assert ours.digest() == theirs.digest()


# --------------------------------------------------------------------- #
# execution                                                             #
# --------------------------------------------------------------------- #
def _run_planned_reshard(nb_ranks, src_np, runs=1):
    """Knob-gated redistribute() on a whole-matrix reshard; returns
    (per-rank [(pool, local tiles)] per run, assembled matrices).
    24x24 over 3x3 tiles = an 8x8 tile grid, so every cross-rank
    (src, dst) pair coalesces SEVERAL tiles."""
    lm = ln = 24

    def rank_fn(rank, fabric):
        ctx = ptt.Context(nb_cores=1, device="cpu",
                          comm=RemoteDepEngine(fabric.engine(rank)))
        try:
            outs = []
            for _ in range(runs):
                Y = _grid(lm, ln, 3, 3, P=nb_ranks, Q=1,
                          nodes=nb_ranks, rank=rank).from_numpy(src_np)
                T = _grid(lm, ln, 3, 3, P=1, Q=nb_ranks,
                          nodes=nb_ranks, rank=rank).from_numpy(
                              np.zeros((lm, ln)))
                tp = redistribute(Y, T, lm, ln, context=ctx)
                outs.append((tp, {c: np.array(T.tile(*c))
                                  for c in T.local_tiles()}))
            return outs
        finally:
            ctx.fini()

    results, _ = spmd(nb_ranks, rank_fn)
    assembled = []
    for run in range(runs):
        got = np.zeros((lm, ln))
        for r in range(nb_ranks):
            for (m, n), arr in results[r][run][1].items():
                got[m * 3:(m + 1) * 3, n * 3:(n + 1) * 3] = arr
        assembled.append(got)
    return results, assembled


def test_planned_redistribute_bit_identical_and_beats_storm():
    """xfer_collective_redist: the planner path delivers the
    bit-identical matrix, returns the planner surrogate whose round and
    transfer counts are strictly below the per-tile move count, agrees
    on the digest across every rank, and repeats byte for byte."""
    src_np = np.random.RandomState(7).rand(24, 24)
    with params.cmdline_override("xfer_collective_redist", "1"):
        results, assembled = _run_planned_reshard(4, src_np, runs=2)
    for got in assembled:
        np.testing.assert_array_equal(got, src_np)
    digests = set()
    for r in range(4):
        for tp, _tiles in results[r]:
            assert hasattr(tp, "plan_digest"), \
                "knob set: planner surrogate expected, got DTD pool"
            assert tp.wire_lossless is True
            assert tp.redist_rounds < tp.redist_tile_moves
            assert tp.redist_transfers < tp.redist_tile_moves
            assert tp.redist_bytes > 0
            digests.add(tp.plan_digest)
    assert len(digests) == 1, digests


def test_planned_redistribute_knob_unset_keeps_dtd_pool():
    """Inertness: without the knob the DTD taskpool runs (no planner
    surface on the returned pool) and the result is identical."""
    src_np = np.random.RandomState(8).rand(24, 24)
    results, assembled = _run_planned_reshard(2, src_np)
    np.testing.assert_array_equal(assembled[0], src_np)
    for r in range(2):
        tp, _tiles = results[r][0]
        assert not hasattr(tp, "plan_digest")


def test_plan_digest_divergence_fails_loudly():
    """A rank whose target distribution disagrees dies in the digest
    handshake — never deadlocks in a half-joined round."""
    nb = 2

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        src = _grid(8, 8, 2, 2, P=nb, Q=1, nodes=nb, rank=rank)
        src.from_numpy(np.zeros((8, 8)))
        tgt = _grid(8, 8, 2, 2, P=1, Q=nb, nodes=nb, rank=rank) \
            if rank == 0 else _grid(8, 8, 2, 2, P=nb, Q=1,
                                    nodes=nb, rank=rank)
        tgt.from_numpy(np.zeros((8, 8)))
        run_redistribution(src, tgt, ce, timeout=30.0)

    with pytest.raises(RuntimeError, match="diverges"):
        spmd(nb, rank_fn)


def test_run_redistribution_bumps_round_gauge():
    """REDIST_ROUNDS: every executed plan adds its round count to the
    engine-owned dplane_stats the obs gauges poll."""
    nb = 2
    src_np = np.random.RandomState(9).rand(8, 8)

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        src = _grid(8, 8, 2, 2, P=nb, Q=1, nodes=nb,
                    rank=rank).from_numpy(src_np)
        tgt = _grid(8, 8, 2, 2, P=1, Q=nb, nodes=nb,
                    rank=rank).from_numpy(np.zeros((8, 8)))
        tp = run_redistribution(src, tgt, ce, timeout=30.0)
        return tp.redist_rounds, dict(ce.dplane_stats)

    results, _ = spmd(nb, rank_fn)
    for rounds, stats in results:
        assert rounds >= 1
        assert stats["redist_rounds"] == rounds


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_planned_redistribute_over_device_plane(dtype):
    """With a device data plane attached on every rank the bulk payload
    leaves the session wire: the bytes travel as a uint8 tensor and the
    consumer views them back to the sent dtype — bit-identical for f64
    too — every park is released, and the plane gauges count the pulls."""
    nb_ranks, lm = 2, 24
    src_np = np.random.RandomState(10).rand(lm, lm).astype(dtype)

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        plane = DeviceDataPlane(ce, device=torch.device("cpu"))
        try:
            plane.exchange()
            assert ce.dplane_to(1 - rank)
            src = TwoDimBlockCyclic(lm, lm, 3, 3, P=nb_ranks, Q=1,
                                    nodes=nb_ranks, rank=rank,
                                    dtype=dtype).from_numpy(src_np)
            tgt = TwoDimBlockCyclic(lm, lm, 3, 3, P=1, Q=nb_ranks,
                                    nodes=nb_ranks, rank=rank,
                                    dtype=dtype).from_numpy(
                                        np.zeros_like(src_np))
            run_redistribution(src, tgt, ce, timeout=30.0)
            ce.sync()
            return ({c: np.array(tgt.tile(*c)) for c in tgt.local_tiles()},
                    dict(plane.stats), plane.leaked_parks,
                    dict(ce.dplane_stats))
        finally:
            plane.fini()

    results, _ = spmd(nb_ranks, rank_fn)
    got = np.zeros_like(src_np)
    for tiles, stats, leaked, ds in results:
        assert stats["pulls"] >= 1 and leaked == 0
        assert ds["dplane_xfers"] == stats["pulls"]
        assert ds["dplane_bytes"] == stats["bytes_pulled"]
        for (m, n), arr in tiles.items():
            got[m * 3:(m + 1) * 3, n * 3:(n + 1) * 3] = arr
    np.testing.assert_array_equal(got, src_np)


def test_dplane_to_needs_an_attached_plane():
    """Without a plane (or before the peer's address arrived) planner
    payloads stay on the session wire."""
    fab = LocalFabric(2)
    ce = fab.engine(0)
    assert ce.dplane_to(1) is False


# --------------------------------------------------------------------- #
# chaos: a link flap in the middle of a planned redistribution          #
# --------------------------------------------------------------------- #
def _tcp_engines(n, **kw):
    import concurrent.futures as cf
    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports
    for _attempt in range(5):
        eps = [("127.0.0.1", p) for p in free_ports(n)]
        with cf.ThreadPoolExecutor(n) as ex:
            futs = [ex.submit(TCPCommEngine, r, eps, **kw) for r in range(n)]
            out, err = [], None
            for f in futs:
                try:
                    out.append(f.result())
                except OSError as exc:
                    if exc.errno != errno.EADDRINUSE:
                        raise
                    err = exc
        if err is None:
            return out
        for e in out:
            e._closing = True
            e.fini()
    raise err


def _wait_session(e0, e1, timeout=10.0):
    import time

    def ok():
        with e0._conn_cond:
            p01 = e0._peers.get(e1.rank)
        with e1._conn_cond:
            p10 = e1._peers.get(e0.rank)
        return p01 is not None and p01.rs_ok and p10 is not None \
            and p10.rs_ok
    deadline = time.time() + timeout
    while not ok() and time.time() < deadline:
        time.sleep(0.005)
    assert ok(), "session capability never negotiated"


def test_redistribution_survives_flap_bit_identical():
    """A ``flap:rank=*`` landing in the MIDDLE of a planned collective
    redistribution (rounds over the session wire) is absorbed by
    reconnect + replay — the reshard completes bit-identical to the
    source, the plan digests agree, and nobody is declared dead."""
    from parsec_tpu_torch.ft.inject import FaultInjector
    nb = 2
    lm = ln = 32
    src_np = np.random.RandomState(11).rand(lm, ln)
    engines = _tcp_engines(nb, reconnect_timeout=10.0)
    e0, e1 = engines
    try:
        _wait_session(e0, e1)
        # rank 0's 2nd post-install send is its round-1 bulk transfer:
        # the link tears with the frame unflushed — replay must carry it
        e0._ft = FaultInjector.from_spec(
            "flap:rank=*:nth=2:duration=0.05", rank=0)
        outs = [None] * nb
        errs = []

        def run(r):
            try:
                src = TwoDimBlockCyclic(
                    lm, ln, 4, 4, P=nb, Q=1, nodes=nb, rank=r,
                    dtype=np.float64).from_numpy(src_np)
                tgt = TwoDimBlockCyclic(
                    lm, ln, 4, 4, P=1, Q=nb, nodes=nb, rank=r,
                    dtype=np.float64).from_numpy(np.zeros((lm, ln)))
                tp = run_redistribution(src, tgt, engines[r], timeout=30.0)
                outs[r] = (tp.plan_digest,
                           {c: np.array(tgt.tile(*c))
                            for c in tgt.local_tiles()})
            except BaseException as exc:  # noqa: BLE001 - reported below
                errs.append(exc)

        ts = [threading.Thread(target=run, args=(r,)) for r in range(nb)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts), "redistribution hung"
        assert not errs, errs
        got = np.zeros((lm, ln))
        for r in range(nb):
            for (m, n), arr in outs[r][1].items():
                got[m * 4:m * 4 + arr.shape[0],
                    n * 4:n * 4 + arr.shape[1]] = arr
        np.testing.assert_array_equal(got, src_np)
        assert outs[0][0] == outs[1][0]
        assert e0._ft.stats["flaps"] >= 1
        assert e0.wire_stats["reconnects"] >= 1
        assert not e0.dead_peers and not e1.dead_peers
    finally:
        for e in engines:
            e.fini()
