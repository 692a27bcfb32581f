"""The port's multi-rank runtime over the in-process fabric: ranks are
threads (``parsec_tpu_torch.utils.spmd.spmd_threads``), each with its own
Context on ``device="cpu"``, exchanging activations, rendezvous GETs and
DTD tile traffic through ``LocalFabric``.  Mirrors the JAX package's
``tests/test_comm_multirank.py`` and holds the port's 4-rank dposv
against the JAX package's on the same numpy input."""
import numpy as np
import pytest
import torch

import parsec_tpu
import parsec_tpu_torch as ptt
from parsec_tpu.comm import LocalFabric as JaxLocalFabric
from parsec_tpu.comm import RemoteDepEngine as JaxRemoteDepEngine
from parsec_tpu.comm import bcast_children as jax_bcast_children
from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBlockCyclic
from parsec_tpu_torch.collections import DictCollection, TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine, bcast_children
from parsec_tpu_torch.comm.engine import TAG_ACTIVATE, TAG_USER_BASE
from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, INPUT, VALUE, unpack_args
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads

N_SMALL, NB_SMALL, NRHS_SMALL = 96, 32, 16


def spmd(nb_ranks, fn, timeout=60):
    return spmd_threads(nb_ranks, fn, timeout=timeout)


def _ctx(rank, fabric, nb_cores=1):
    return ptt.Context(nb_cores=nb_cores, comm=RemoteDepEngine(
        fabric.engine(rank)), device="cpu")


@pytest.mark.parametrize("topology", ["star", "chain", "binomial"])
def test_bcast_children_equal_to_jax(topology):
    """Every position's children, for every participant count up to 16,
    are the JAX package's; the binomial tree reaches each position once."""
    for nb in range(1, 17):
        for pos in range(nb):
            assert bcast_children(pos, nb, topology) == \
                jax_bcast_children(pos, nb, topology), (nb, pos)
        reached, frontier = {0}, [0]
        while frontier:
            nxt = []
            for p in frontier:
                for c in bcast_children(p, nb, topology):
                    assert c not in reached, f"nb={nb}: {c} reached twice"
                    reached.add(c)
                    nxt.append(c)
            frontier = nxt
        assert reached == set(range(nb))
    with pytest.raises(ValueError):
        bcast_children(0, 4, "ring")


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


def _ptg_chain_rank(rank, fabric, nb_ranks, NB, tile=4):
    ctx = _ctx(rank, fabric)
    try:
        coll = TwoDimBlockCyclic((NB + 1) * tile, tile, tile, tile,
                                 P=nb_ranks, Q=1, nodes=nb_ranks, rank=rank)
        coll.name = "descA"
        tp = ptt.ptg.compile_jdf(CHAIN_JDF, name="chain").new(
            descA=coll, NB=NB, rank=rank, nb_ranks=nb_ranks)
        ctx.add_taskpool(tp)
        ctx.wait()
        return {k: float(coll.tile(k, 0)[0, 0]) for k in range(NB + 1)
                if coll.rank_of(k, 0) == rank}
    finally:
        ctx.fini()


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_ptg_chain_across_ranks(nb_ranks):
    """A chain whose consecutive tasks live on different ranks: every
    hop is a remote dep (activation + data)."""
    NB = 7
    results, fabric = spmd(nb_ranks,
                           lambda r, f: _ptg_chain_rank(r, f, nb_ranks, NB))
    merged = {}
    for r in results:
        merged.update(r)
    expect = {k: 0.0 for k in range(NB + 1)}
    expect[0] = 1.0
    expect[NB] = float(NB + 1)
    assert merged == expect
    assert fabric.msg_count > 0


BCAST_JDF = """
descA [ type="collection" ]
NR [ type="int" ]

Root(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A Leaf( 1 .. NR-1 )
BODY
{
    A[0, 0] = 77.0
}
END

Leaf(r)
r = 1 .. NR-1
: descA( r, 0 )
READ A <- A Root( 0 )
BODY
{
    got.append(float(A[0, 0]))
}
END
"""


@pytest.mark.parametrize("topology", ["star", "chain", "binomial"])
def test_ptg_broadcast_topologies(topology):
    """One root datum broadcast to every other rank under each topology
    (ref: runtime_comm_coll_bcast, remote_dep.c:272-295)."""
    nb_ranks = 4
    got_all = [[] for _ in range(nb_ranks)]

    def rank_fn(rank, fabric):
        ctx = _ctx(rank, fabric)
        try:
            coll = TwoDimBlockCyclic(nb_ranks * 4, 4, 4, 4, P=nb_ranks, Q=1,
                                     nodes=nb_ranks, rank=rank)
            coll.name = "descA"
            tp = ptt.ptg.compile_jdf(BCAST_JDF, name="bcast").new(
                descA=coll, NR=nb_ranks, rank=rank, nb_ranks=nb_ranks)
            tp.global_env["got"] = got_all[rank]
            ctx.add_taskpool(tp)
            ctx.wait()
            return ctx.comm.stats["forwards"]
        finally:
            ctx.fini()

    with params.cmdline_override("runtime_comm_coll_bcast", topology):
        forwards, _ = spmd(nb_ranks, rank_fn)
    assert got_all[0] == []
    for r in range(1, nb_ranks):
        assert got_all[r] == [77.0], f"rank {r}: {got_all[r]}"
    # star: the root sends to all; chain/binomial: ranks re-forward
    assert (sum(forwards) == 0) == (topology == "star")


def test_ptg_rendezvous_large_payload():
    """Payloads over the short limit travel via the GET rendezvous."""
    def rank_fn(rank, fabric):
        ctx = _ctx(rank, fabric)
        try:
            coll = TwoDimBlockCyclic(2 * 64, 64, 64, 64, P=2, Q=1,
                                     nodes=2, rank=rank)
            coll.name = "descA"
            tp = ptt.ptg.compile_jdf(CHAIN_JDF, name="chain").new(
                descA=coll, NB=1, rank=rank, nb_ranks=2)
            ctx.add_taskpool(tp)
            ctx.wait()
            handles = len(ctx.comm.ce._mem)
            if coll.rank_of(1, 0) == rank:
                return float(coll.tile(1, 0)[0, 0]), handles
            return None, handles
        finally:
            ctx.fini()

    with params.cmdline_override("runtime_comm_short_limit", "64"):
        results, fabric = spmd(2, rank_fn)
    assert 2.0 in [r[0] for r in results]
    assert all(r[1] == 0 for r in results)   # every snapshot released
    # activation + GET request + GET reply at least
    assert fabric.msg_count >= 3


def _dtd_chain_rank(rank, fabric, N, comm_thread=False):
    ctx = _ctx(rank, fabric)
    try:
        assert (ctx._comm_thread is not None) == comm_thread
        coll = DictCollection(nodes=2, rank=rank)
        coll.name = "C"
        coll.add("x", 0, np.zeros(2) if rank == 0 else None)
        anchors = {}
        for r in range(2):
            a = DictCollection(nodes=2, rank=rank)
            a.name = f"anchor{r}"
            a.add("a", r, np.zeros(1) if r == rank else None)
            anchors[r] = a
        tp = ptt.dtd.taskpool_new("xchain")
        ctx.add_taskpool(tp)
        tile = tp.tile_of(coll, "x")
        history = []

        def bump(es, task):
            x, anchor, k = unpack_args(task)
            if x[0] != k:
                raise AssertionError(f"task {k} saw {x[0]}")
            x[0] += 1.0
            history.append(k)

        for k in range(N):
            at = tp.tile_of(anchors[k % 2], "a")
            tp.insert_task(bump, (tile, INOUT), (at, INPUT | AFFINITY),
                           (k, VALUE))
        tp.data_flush_all()
        tp.wait()
        ctx.wait()
        thread = ctx._comm_thread
        final = None
        if rank == 0:
            final = float(coll.data_of("x").get_copy(0).payload[0])
        return history, final, thread
    finally:
        ctx.fini()


def test_dtd_cross_rank_chain():
    """DTD chain on one tile with tasks alternating between 2 ranks: every
    edge is a cross-rank RAW resolved by (tile, seq) matching, and the
    flush brings the last version home."""
    N = 6
    results, fabric = spmd(2, lambda r, f: _dtd_chain_rank(r, f, N))
    (hist0, final0, _), (hist1, _, _) = results
    assert hist0 == [0, 2, 4]
    assert hist1 == [1, 3, 5]
    assert final0 == float(N)
    assert fabric.msg_count > 0


def test_dedicated_comm_thread_drains_progress():
    """comm_thread=1: the funnelled progress thread drives the dataflow
    (workers never touch the engine) and is joined at fini."""
    with params.cmdline_override("comm_thread", "1"):
        results, _ = spmd(2, lambda r, f: _dtd_chain_rank(
            r, f, 6, comm_thread=True))
    assert results[0][1] == 6.0
    for _hist, _final, thread in results:
        assert thread is not None and not thread.is_alive()


def test_activation_gated_until_counts_ready():
    """An activation that lands after taskpool registration but before
    startup credits nb_tasks stays buffered; counts_ready delivers it."""
    fabric = LocalFabric(2)
    e0 = RemoteDepEngine(fabric.engine(0))
    e1 = RemoteDepEngine(fabric.engine(1))

    class StubTP:
        pass

    tp = StubTP()
    e1.taskpool_register(tp)           # registered, counts NOT credited
    msg = {"tp_id": tp.comm_tp_id, "root": 0, "ranks": [1],
           "edges": {1: []}, "src_task": None, "dtt": None, "data": None}
    e0.ce.send_am(1, TAG_ACTIVATE, msg)
    e1.progress(None)                  # handler must buffer, not deliver
    assert list(e1._early_activations) == [tp.comm_tp_id]
    delivered = []
    e1._on_activate = lambda src, m, replay=False: delivered.append(m)
    e1.counts_ready(tp)
    assert [m["tp_id"] for m in delivered] == [tp.comm_tp_id]
    assert not e1._early_activations


def test_local_fabric_snapshots_tensors_at_send():
    """A tensor (and an array) sent over LocalFabric and then changed in
    place by its sender leaves the receiver's copy unchanged."""
    fabric = LocalFabric(2)
    e0, e1 = fabric.engine(0), fabric.engine(1)
    got = []
    e1.tag_register(TAG_USER_BASE + 1, lambda src, p: got.append(p))
    t = torch.arange(8, dtype=torch.float32)
    a = np.arange(8, dtype=np.float32)
    e0.send_am(1, TAG_USER_BASE + 1, {"t": t, "a": [a]})
    t.add_(100.0)
    a += 100.0
    assert e1.progress() == 1
    np.testing.assert_array_equal(got[0]["t"].numpy(), np.arange(8))
    np.testing.assert_array_equal(got[0]["a"][0], np.arange(8))
    assert got[0]["t"].data_ptr() != t.data_ptr()
    assert fabric.bytes_count == 64


def test_dead_consumer_parks_reclaimed():
    """A consumer rank that dies owing device-plane ACKs must not hang
    the producer: its parks are reclaimed and the pending actions
    retire."""
    class FakeTp:
        pending = 0

        def add_pending_action(self, n):
            self.pending += n

        def pending_action_done(self, n):
            self.pending -= n

    class FakePlane:
        def __init__(self):
            self.released = []

        def release(self, u):
            self.released.append(u)

    eng = RemoteDepEngine(LocalFabric(2).engine(0))
    plane = FakePlane()
    eng.ce.device_plane = plane
    tp = FakeTp()
    tp.add_pending_action(3)
    with eng._lock:
        eng._pending_xfers[11] = (tp, 1)
        eng._pending_xfers[12] = (tp, 1)
        eng._pending_xfers[13] = (tp, 0)
    eng._release_parks_for(1)
    assert sorted(plane.released) == [11, 12]
    assert tp.pending == 1
    eng._release_parks_for(1)
    assert tp.pending == 1


def _inputs(n=N_SMALL, nrhs=NRHS_SMALL):
    M = ptt.ops.make_spd(n)
    rng = np.random.RandomState(1)
    return M, (rng.rand(n, nrhs) - 0.5).astype(np.float32)


def _dist(cls, rank, nb_ranks, src, P, Q, nb=NB_SMALL):
    d = cls(src.shape[0], src.shape[1], nb, nb, P=P, Q=Q, nodes=nb_ranks,
            rank=rank, dtype=np.float32)
    for (i, j) in d.local_tiles():
        np.copyto(d.tile(i, j), src[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
    return d


def _gather(d, rank, nb=NB_SMALL):
    return {(i, j): np.array(d.tile(i, j)) for (i, j) in d.local_tiles()}


def _assemble(parts, shape, nb=NB_SMALL):
    out = np.zeros(shape, np.float32)
    for (i, j), t in parts.items():
        out[i * nb:i * nb + t.shape[0], j * nb:j * nb + t.shape[1]] = t
    return out


def _port_dposv(nb_ranks, M, Bm):
    P, Q = (2, nb_ranks // 2) if nb_ranks > 1 else (1, 1)

    def rank_fn(rank, fabric):
        ctx = _ctx(rank, fabric, nb_cores=2)
        try:
            A = _dist(TwoDimBlockCyclic, rank, nb_ranks, M, P, Q)
            B = _dist(TwoDimBlockCyclic, rank, nb_ranks, Bm, nb_ranks, 1)
            A.name, B.name = "descA", "descB"
            ptt.ops.dposv(ctx, A, B, rank=rank, nb_ranks=nb_ranks)
            return _gather(A, rank), _gather(B, rank)
        finally:
            ctx.fini()

    results, _ = spmd(nb_ranks, rank_fn, timeout=120)
    fa, fb = {}, {}
    for a, b in results:
        fa.update(a)
        fb.update(b)
    return _assemble(fa, M.shape), _assemble(fb, Bm.shape)


def test_dposv_four_ranks_vs_jax_and_one_rank():
    """dposv on 4 in-process ranks (A on a 2x2 grid, B on 4x1): X agrees
    with the JAX package's 4-rank LocalFabric dposv within 5e-4 (two
    frameworks' fp32 tile kernels), and factor and X are bit-identical
    to the port's one-rank dposv (each tile's chain of updates is fixed
    by the dependences; the fabric copies losslessly)."""
    M, Bm = _inputs()
    L4, X4 = _port_dposv(4, M, Bm)
    ctx = ptt.init(nb_cores=2, device="cpu")
    try:
        A1 = TwoDimBlockCyclic(N_SMALL, N_SMALL, NB_SMALL, NB_SMALL) \
            .from_numpy(M)
        B1 = TwoDimBlockCyclic(N_SMALL, NRHS_SMALL, NB_SMALL, NB_SMALL) \
            .from_numpy(Bm)
        ptt.ops.dposv(ctx, A1, B1)
    finally:
        ctx.fini()
    L1, X1 = A1.to_numpy(), B1.to_numpy()
    low = np.tril(np.ones_like(M, dtype=bool))
    np.testing.assert_array_equal(L4[low], L1[low])
    np.testing.assert_array_equal(X4, X1)

    def jax_rank(rank, fabric):
        from parsec_tpu.ops import dposv
        ctx = parsec_tpu.Context(nb_cores=1, comm=JaxRemoteDepEngine(
            fabric.engine(rank)), enable_tpu=False)
        try:
            A = _dist(JaxTwoDimBlockCyclic, rank, 4, M, 2, 2)
            B = _dist(JaxTwoDimBlockCyclic, rank, 4, Bm, 4, 1)
            A.name, B.name = "descA", "descB"
            dposv(ctx, A, B, rank=rank, nb_ranks=4)
            return _gather(B, rank)
        finally:
            ctx.fini()

    from parsec_tpu.ops import dtrsm as jax_dtrsm
    from parsec_tpu.utils.spmd import spmd_threads as jax_spmd
    # the JAX package builds its two dtrsm factories lazily without a
    # lock, so ranks racing the first call can see one of them None
    # (ROADMAP Queue 3); build them before its ranks start
    jax_dtrsm._factories()
    results, _ = jax_spmd(4, jax_rank, timeout=120,
                          fabric=JaxLocalFabric(4))
    fb = {}
    for b in results:
        fb.update(b)
    Xj = _assemble(fb, Bm.shape)
    np.testing.assert_allclose(X4, Xj, rtol=0, atol=5e-4)
    ref = np.linalg.solve(M.astype(np.float64), Bm.astype(np.float64))
    assert np.abs(X4 - ref).max() < 1e-3


def test_fourcounter_termdet_on_several_ranks():
    """termdet=fourcounter gives a multi-rank pool the distributed
    detector over the comm engine; the chain still terminates right."""
    seen = []

    def rank_fn(rank, fabric):
        ctx = _ctx(rank, fabric)
        try:
            coll = TwoDimBlockCyclic(8 * 4, 4, 4, 4, P=2, Q=1, nodes=2,
                                     rank=rank)
            coll.name = "descA"
            tp = ptt.ptg.compile_jdf(CHAIN_JDF, name="chain").new(
                descA=coll, NB=7, rank=rank, nb_ranks=2)
            ctx.add_taskpool(tp)
            seen.append(tp.tdm.name)
            ctx.wait()
            return {k: float(coll.tile(k, 0)[0, 0]) for k in range(8)
                    if coll.rank_of(k, 0) == rank}
        finally:
            ctx.fini()

    with params.cmdline_override("termdet", "fourcounter"):
        results, _ = spmd(2, rank_fn)
    assert seen == ["fourcounter", "fourcounter"]
    assert results[0][0] == 1.0 and results[1][7] == 8.0
