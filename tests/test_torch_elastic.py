"""The port's elastic grid recovery (parsec_tpu_torch/ft/elastic.py and
the ``elastic=`` path of ``ft.run_with_restart``).

Mirrors the elastic tests of the JAX package's ``tests/test_ft.py``
(policy validation, ``plan_grid``, an agreement round with divergent
votes, a 3-rank dpotrf shrunk to 2 after a chaos kill, a late joiner
folded in, the gauges) on ``device="cpu"`` contexts over the port's
``LocalFabric``; the shrink also kills a rank whose survivors then map
a world rank onto another logical rank, and holds the recovered factor
bit for bit to one rank's. Every wait is bounded.
"""
import threading
import time

import numpy as np
import pytest

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.ft import (ElasticPolicy, GridSpec, RestartPolicy,
                                 plan_grid, run_with_restart)
from parsec_tpu_torch.ft.elastic import ElasticCoordinator
from parsec_tpu_torch.utils import checkpoint as ckpt
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads

RANK_TIMEOUT = 120.0


@pytest.fixture(autouse=True)
def _clean_params():
    params.reset()
    yield
    params.reset()


def spmd(nb_ranks, fn, fabric=None):
    return spmd_threads(nb_ranks, fn, timeout=RANK_TIMEOUT, fabric=fabric)


def _establish_all(ctx, eng, nb_ranks, rank):
    """Pump until this rank's detector has heartbeat contact with every
    peer, then barrier (only ESTABLISHED peers are evicted on the
    in-process fabric)."""
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


def test_elastic_policy_validation():
    with pytest.raises(ValueError, match="ft_elastic"):
        ElasticPolicy(lambda g: ([], []), mode="sideways")
    pol = ElasticPolicy(lambda g: ([], []), mode="both", grow_min=2)
    assert pol.allows_shrink and pol.allows_grow and pol.grow_min == 2
    # knob unset -> mode "" -> strict (run_with_restart nulls it)
    assert ElasticPolicy(lambda g: ([], [])).mode == ""
    params.set_cmdline("ft_elastic", "shrink")
    params.set_cmdline("ft_elastic_timeout", "7.5")
    pol = ElasticPolicy(lambda g: ([], []))
    assert pol.mode == "shrink" and pol.timeout == 7.5
    assert pol.allows_shrink and not pol.allows_grow


def test_plan_grid_deterministic_most_square():
    g4 = plan_grid((0, 1, 2, 3), 4, 0)
    assert (g4.P, g4.Q) == (2, 2)
    g3 = plan_grid((2, 0, 5), 6, 5)
    assert (g3.P, g3.Q) == (3, 1)
    assert g3.members == (0, 2, 5)      # sorted, world ranks preserved
    assert plan_grid((2, 5, 0), 6, 0).members == g3.members
    # the JAX package derives the same layout from the same member set
    from parsec_tpu.ft import plan_grid as jax_plan_grid
    for members in ((0, 1, 2, 3), (2, 0, 5), (1, 2), (0, 1, 2, 3, 4, 5)):
        ours, theirs = plan_grid(members, 6, 0), jax_plan_grid(members, 6, 0)
        assert (ours.P, ours.Q, ours.members) == \
            (theirs.P, theirs.Q, theirs.members)
    # world ranks stay world ranks: logical slot 1 of members (0, 2) is
    # world rank 2, and the collection keeps the world size
    A = plan_grid((0, 2), 3, 2).collection(64, 64, 32, 32)
    assert (A.nodes, A.rank, A.rank_of(0, 0), A.rank_of(1, 0)) == \
        (3, 2, 0, 2)
    assert [A.rank_of(*t) for t in A.local_tiles()] == [2, 2]


def test_elastic_agreement_reconciles_divergent_votes():
    """Coordinator-level: two survivors enter a shrink round ONE
    SNAPSHOT APART with different taskpool wire-id counters; the commit
    carries the min stage (both provably wrote it) and the max tp_next
    (so the laggard skips the ids it never assigned)."""
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    c0, c1 = ElasticCoordinator(e0), ElasticCoordinator(e1)
    out = [None, None]

    def voter(co, stage, tp_next, slot):
        out[slot] = co.agree("shrink", (0, 1), stage, deadline_s=10.0,
                             tp_next=tp_next)

    ts = [threading.Thread(target=voter, args=(c0, 3, 7, 0)),
          threading.Thread(target=voter, args=(c1, 2, 9, 1))]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 10.0
    while any(t.is_alive() for t in ts) and time.monotonic() < deadline:
        e0.progress()
        e1.progress()
        time.sleep(0.001)
    for t in ts:
        t.join(1.0)
        assert not t.is_alive(), "agreement did not converge"
    for got in out:
        assert got["members"] == (0, 1)
        assert got["stage"] == 2        # min over the divergent votes
        assert got["tp_base"] == 9      # max over the wire-id counters
    e0.fini()
    e1.fini()


def test_elastic_frames_buffer_until_a_coordinator_attaches():
    """A membership frame that lands before any coordinator exists is
    buffered by the engine and drained at attach (a joiner may announce
    while the incumbents are mid-stage); a detached coordinator stops
    receiving."""
    fab = LocalFabric(2)
    e0, e1 = fab.engine(0), fab.engine(1)
    assert e1.ft_elastic_send(0, {"kind": "join"})
    deadline = time.monotonic() + 5.0
    while not e0._elastic_buf and time.monotonic() < deadline:
        e0.progress()
        time.sleep(0.001)
    assert e0._elastic_buf == [(1, {"kind": "join"})]
    co = ElasticCoordinator(e0)
    assert e0.ft_elastic is co and not e0._elastic_buf
    assert co.pending_joins((0,)) == [1]
    co.detach()
    assert e0.ft_elastic is None
    e0.fini()
    e1.fini()


def _one_rank_factor(M, n, nb):
    from parsec_tpu_torch.ops import dpotrf_taskpool
    ctx = ptt.init(nb_cores=2, device="cpu")
    try:
        L = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        ctx.add_taskpool(dpotrf_taskpool(L))
        ctx.wait()
        return L.to_numpy()
    finally:
        ctx.fini()


@pytest.mark.parametrize("killed", [2, 1])
def test_elastic_shrink_3rank_dpotrf_recovers(tmp_path, killed):
    """3-rank checkpointed dpotrf, one rank chaos-killed mid-
    factorization, ft_elastic=shrink: the survivors agree on the 2-rank
    grid, reshard the last snapshot, replay, and produce the factor of
    one rank bit for bit — no fresh incarnation. Exactly one resize,
    reshard bytes > 0. With rank 1 killed, world rank 2 is logical
    rank 1 of the shrunk grid."""
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd

    nb_ranks, n, nb = 3, 256, 32
    M = make_spd(n)
    prefix = str(tmp_path / "es")
    survivors = tuple(r for r in range(nb_ranks) if r != killed)

    def run_rank(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = ptt.Context(nb_cores=1, comm=eng, device="cpu")
        try:
            def rebuild(grid: GridSpec):
                A = grid.collection(n, n, nb, nb, dtype=np.float32)
                A.name = "descA"
                for (i, j) in A.local_tiles():
                    np.copyto(A.tile(i, j),
                              M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
                return [lambda: dpotrf_taskpool(
                    A, rank=rank, nb_ranks=nb_ranks)], [A]

            _establish_all(ctx, eng, nb_ranks, rank)
            pol = ElasticPolicy(rebuild, timeout=30.0)
            try:
                stats = run_with_restart(
                    ctx, None, None, prefix,
                    policy=RestartPolicy("restart", retries=1),
                    elastic=pol)
            except RuntimeError as e:
                return (type(e.__cause__ or e).__name__, None, None, None)
            grid = plan_grid(stats["grid"], nb_ranks, rank)
            A = rebuild(grid)[1][0]
            ckpt.restore_collection(A, f"{prefix}.stage1.c0",
                                    reshard=True, context=ctx)
            local = {t: np.array(A.tile(*t)) for t in A.local_tiles()}
            return ("ok", local, stats, dict(eng.ce.elastic_stats))
        finally:
            ctx.clear_task_errors()
            ctx.fini()

    params.set_cmdline("ft_heartbeat_interval", "0.05")
    params.set_cmdline("ft_heartbeat_timeout", "4.0")
    params.set_cmdline("ft_inject", f"kill:rank={killed}:after=4")
    params.set_cmdline("ft_elastic", "shrink")
    results, _ = spmd(nb_ranks, run_rank)

    assert results[killed][0] in ("InjectedKill", "RankFailedError")
    L = np.zeros_like(M)
    for r in survivors:
        st, local, stats, es = results[r]
        assert st == "ok", results[r]
        assert stats["grid"] == survivors
        assert stats["resizes"] == 1
        assert es["elastic_resizes"] == 1
        assert es["reshard_bytes"] > 0
        for (i, j), tile in local.items():
            L[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
    np.testing.assert_array_equal(L, _one_rank_factor(M, n, nb))
    Lt = np.tril(L).astype(np.float64)
    resid = np.abs(Lt @ Lt.T - M).max() / (np.abs(M).max() * n)
    assert resid < 1e-5, f"shrunk-grid factor residual {resid:.2e}"


def test_elastic_grow_folds_in_late_joiner(tmp_path):
    """Grow: two incumbents run staged scaling while rank 2 announces
    late; at a stage boundary the grid grows to 3, the joiner reshards
    the fresh snapshot, and the final state equals the sequential
    reference."""
    world, n, nb, nstages = 3, 96, 16, 6
    M = np.arange(n * n, dtype=np.float32).reshape(n, n) / (n * n)
    factory = ptg.compile_jdf(SCALE_JDF, name="scale_grow")
    prefix = str(tmp_path / "eg")

    def run_rank(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = ptt.Context(nb_cores=1, comm=eng, device="cpu")
        try:
            def rebuild(grid: GridSpec):
                A = grid.collection(n, n, nb, nb, dtype=np.float32)
                A.name = "descA"
                for (i, j) in A.local_tiles():
                    np.copyto(A.tile(i, j),
                              M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])

                def mk():
                    return factory.new(descA=A, MT=A.mt - 1, NT=A.nt - 1,
                                       rank=rank, nb_ranks=world)
                return [mk] * nstages, [A]

            _establish_all(ctx, eng, world, rank)
            pol = ElasticPolicy(rebuild, mode="grow", members=(0, 1),
                                timeout=30.0, join=(rank == 2))
            stats = run_with_restart(
                ctx, None, None, prefix,
                policy=RestartPolicy("restart", retries=0, every=1),
                elastic=pol)
            return ("ok", stats, dict(eng.ce.elastic_stats))
        finally:
            ctx.clear_task_errors()
            ctx.fini()

    params.set_cmdline("ft_heartbeat_interval", "0.05")
    params.set_cmdline("ft_heartbeat_timeout", "15")
    results, _ = spmd(world, run_rank)

    for r in range(world):
        st, stats, es = results[r]
        assert st == "ok", results[r]
        assert stats["grid"] == (0, 1, 2)
        assert stats["resizes"] >= 1
        assert es["elastic_joins"] >= 1
        assert es["reshard_bytes"] > 0
    # the joiner really joined (not a fresh full run)
    assert results[2][1]["snapshots"] < results[0][1]["snapshots"]

    ref = M.copy()
    for _ in range(nstages):
        ref = ref * 2.0 + 1.0
    d = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
    d.name = "descA"
    ckpt.restore_collection(d, f"{prefix}.stage{nstages}.c0", reshard=True)
    np.testing.assert_allclose(d.to_numpy(), ref, rtol=1e-6)


def test_elastic_gauges_registered():
    """FT::ELASTIC_RESIZES / ELASTIC_JOINS / RESHARD_BYTES / RESHARD_US
    and the COMM::DPLANE_* / REDIST_ROUNDS gauges ride the engine gauge
    registration, under the JAX package's names, live against the
    engine's counters."""
    from parsec_tpu.obs import spans as jax_obs
    from parsec_tpu_torch.obs.spans import (COMM_REDIST_ROUNDS,
                                            FT_ELASTIC_JOINS,
                                            FT_ELASTIC_RESIZES,
                                            FT_RESHARD_BYTES, FT_RESHARD_US)
    names = (FT_ELASTIC_RESIZES, FT_ELASTIC_JOINS, FT_RESHARD_BYTES,
             FT_RESHARD_US, COMM_REDIST_ROUNDS)
    assert names == (jax_obs.FT_ELASTIC_RESIZES, jax_obs.FT_ELASTIC_JOINS,
                     jax_obs.FT_RESHARD_BYTES, jax_obs.FT_RESHARD_US,
                     jax_obs.COMM_REDIST_ROUNDS)

    def rank_fn(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = ptt.Context(nb_cores=1, comm=eng, device="cpu")
        try:
            snap = ctx.sde.snapshot()
            for name in names:
                assert name in snap and snap[name] == 0
            eng.ce.elastic_stats["reshard_bytes"] += 4096
            eng.ce.dplane_stats["redist_rounds"] += 3
            snap = ctx.sde.snapshot()
            return snap[FT_RESHARD_BYTES], snap[COMM_REDIST_ROUNDS]
        finally:
            ctx.fini()

    got, _ = spmd(2, rank_fn)
    assert got == [(4096, 3), (4096, 3)]
