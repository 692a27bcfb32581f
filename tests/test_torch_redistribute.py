"""The port's redistribution engine (parsec_tpu_torch/collections/
redistribute.py).

Mirrors the JAX package's ``tests/test_redistribute.py`` on
``device="cpu"`` contexts (``reshard_array`` raises here: the mesh is not
carried), holds the port's moves against the JAX package's on the same
seeded inputs, and checks the card-resident case the CPU can show: after
a device DAG the newest tile versions are the device module's copies, and
both the DTD walk and the collective planner must move those, not the
stale host copies, and leave the target so that the next device task
stages the moved values in.
"""
import numpy as np
import pytest
import torch

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import (TwoDimBlockCyclic, TwoDimTabular,
                                          redistribute, redistribute_ptg,
                                          reshard_array)
from parsec_tpu_torch.comm import RemoteDepEngine
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads

RANK_TIMEOUT = 60.0


@pytest.fixture
def ctx():
    c = ptt.init(nb_cores=2, device="cpu")
    yield c
    c.fini()


def spmd(nb_ranks, fn):
    return spmd_threads(nb_ranks, fn, timeout=RANK_TIMEOUT)


def _rank_ctx(rank, fabric, device="cpu"):
    return ptt.Context(nb_cores=1, device=device,
                       comm=RemoteDepEngine(fabric.engine(rank)))


def _check(source_np, target_np_before, target_after,
           size_row, size_col, diY, djY, diT, djT):
    expect = target_np_before.copy()
    expect[diT:diT + size_row, djT:djT + size_col] = \
        source_np[diY:diY + size_row, djY:djY + size_col]
    np.testing.assert_array_equal(target_after, expect)


GEOMETRIES = [
    # (lmY, lnY, mbY, nbY, lmT, lnT, mbT, nbT, M, N, diY, djY, diT, djT)
    (8, 8, 4, 4, 8, 8, 4, 4, 8, 8, 0, 0, 0, 0),        # aligned same-tile
    (12, 12, 4, 4, 12, 12, 3, 3, 12, 12, 0, 0, 0, 0),  # different tile sizes
    (16, 12, 5, 4, 12, 16, 3, 5, 7, 9, 2, 1, 3, 4),    # unaligned submatrix
]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_redistribute_single_process(ctx, geometry):
    (lmY, lnY, mbY, nbY, lmT, lnT, mbT, nbT,
     M, N, diY, djY, diT, djT) = geometry
    rng = np.random.RandomState(42)
    src_np = rng.rand(lmY, lnY)
    tgt_np = rng.rand(lmT, lnT)
    Y = TwoDimBlockCyclic(lmY, lnY, mbY, nbY,
                          dtype=np.float64).from_numpy(src_np)
    T = TwoDimBlockCyclic(lmT, lnT, mbT, nbT,
                          dtype=np.float64).from_numpy(tgt_np)
    redistribute(Y, T, M, N, diY, djY, diT, djT, context=ctx)
    _check(src_np, tgt_np, T.to_numpy(), M, N, diY, djY, diT, djT)


def test_redistribute_random_sizes(ctx):
    rng = np.random.RandomState(7)
    for _trial in range(4):
        lmY, lnY = rng.randint(6, 20, size=2)
        lmT, lnT = rng.randint(6, 20, size=2)
        mbY, nbY = rng.randint(2, 6, size=2)
        mbT, nbT = rng.randint(2, 6, size=2)
        M = rng.randint(1, min(lmY, lmT) + 1)
        N = rng.randint(1, min(lnY, lnT) + 1)
        diY = rng.randint(0, lmY - M + 1)
        djY = rng.randint(0, lnY - N + 1)
        diT = rng.randint(0, lmT - M + 1)
        djT = rng.randint(0, lnT - N + 1)
        src_np = rng.rand(lmY, lnY)
        tgt_np = rng.rand(lmT, lnT)
        Y = TwoDimBlockCyclic(int(lmY), int(lnY), int(mbY), int(nbY),
                              dtype=np.float64).from_numpy(src_np)
        T = TwoDimBlockCyclic(int(lmT), int(lnT), int(mbT), int(nbT),
                              dtype=np.float64).from_numpy(tgt_np)
        redistribute(Y, T, int(M), int(N), int(diY), int(djY),
                     int(diT), int(djT), context=ctx)
        _check(src_np, tgt_np, T.to_numpy(), M, N, diY, djY, diT, djT)


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_redistribute_multirank(nb_ranks):
    """Block-cyclic P×1 source -> 1×Q target with different tile sizes:
    most fragments cross ranks."""
    lm = ln = 12
    rng = np.random.RandomState(3)
    src_np = rng.rand(lm, ln)
    tgt_np = rng.rand(lm, ln)

    def rank_fn(rank, fabric):
        ctx = _rank_ctx(rank, fabric)
        try:
            Y = TwoDimBlockCyclic(lm, ln, 4, 4, P=nb_ranks, Q=1,
                                  nodes=nb_ranks, rank=rank,
                                  dtype=np.float64).from_numpy(src_np)
            T = TwoDimBlockCyclic(lm, ln, 3, 3, P=1, Q=nb_ranks,
                                  nodes=nb_ranks, rank=rank,
                                  dtype=np.float64).from_numpy(tgt_np)
            redistribute(Y, T, 10, 10, disi_Y=1, disj_Y=2,
                         disi_T=2, disj_T=1, context=ctx)
            return {(m, n): np.array(T.tile(m, n))
                    for (m, n) in T.local_tiles()}
        finally:
            ctx.fini()

    results, _ = spmd(nb_ranks, rank_fn)
    expect = tgt_np.copy()
    expect[2:12, 1:11] = src_np[1:11, 2:12]
    got = np.zeros_like(expect)
    T_geom = TwoDimBlockCyclic(lm, ln, 3, 3, P=1, Q=nb_ranks, nodes=nb_ranks)
    for tiles in results:
        for (m, n), arr in tiles.items():
            tm, tn = T_geom.tile_shape(m, n)
            got[m * 3:m * 3 + tm, n * 3:n * 3 + tn] = arr
    np.testing.assert_array_equal(got, expect)


def test_redistribute_tabular_target(ctx):
    """Irregular per-tile rank table target (single process)."""
    lm = ln = 10
    rng = np.random.RandomState(11)
    src_np = rng.rand(lm, ln)
    Y = TwoDimBlockCyclic(lm, ln, 3, 3, dtype=np.float64).from_numpy(src_np)
    T = TwoDimTabular.random(lm, ln, 4, 4, nodes=1, dtype=np.float64)
    T.from_numpy(np.zeros((lm, ln)))
    redistribute(Y, T, lm, ln, context=ctx)
    np.testing.assert_array_equal(T.to_numpy(), src_np)


def test_reshard_array_raises_naming_the_mesh_part():
    """Moving an array between mesh shardings belongs with the mesh,
    which this package does not carry yet: it raises and says where it
    is planned."""
    with pytest.raises(NotImplementedError, match="part D2"):
        reshard_array(np.zeros((8, 8), np.float32), None, None)


def test_reshuffle_fast_path_equivalence(ctx):
    """Aligned same-grid case: the reshuffle walk (1 whole-tile task per
    tile) produces exactly what the general fragment walk does, with
    the same task count (the fragment enumerator collapses to whole
    tiles on aligned inputs)."""
    rng = np.random.RandomState(3)
    lm, nb = 48, 8
    src_np = rng.rand(lm, lm)
    Y = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(src_np)
    Y.name = "rsY"
    T1 = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(
        np.zeros((lm, lm)))
    T1.name = "rsT1"
    T2 = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(
        np.zeros((lm, lm)))
    T2.name = "rsT2"
    M = N = 32
    tp1 = redistribute(Y, T1, M, N, disi_Y=8, disj_Y=0, disi_T=16,
                       disj_T=8, context=ctx)
    tp2 = redistribute(Y, T2, M, N, disi_Y=8, disj_Y=0, disi_T=16,
                       disj_T=8, context=ctx, allow_reshuffle=False)
    expect = np.zeros((lm, lm))
    expect[16:16 + M, 8:8 + N] = src_np[8:8 + M, 0:N]
    np.testing.assert_array_equal(T1.to_numpy(), expect)
    np.testing.assert_array_equal(T2.to_numpy(), expect)
    assert tp1._inserted == tp2._inserted
    assert tp1.redist_bytes == tp2.redist_bytes == M * N * 8


def test_reshuffle_not_applied_when_unaligned(ctx):
    rng = np.random.RandomState(4)
    lm, nb = 32, 8
    src_np = rng.rand(lm, lm)
    Y = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(src_np)
    Y.name = "ruY"
    T = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(
        np.zeros((lm, lm)))
    T.name = "ruT"
    redistribute(Y, T, 16, 16, disi_Y=3, disj_Y=5, disi_T=1, disj_T=2,
                 context=ctx)
    expect = np.zeros((lm, lm))
    expect[1:17, 2:18] = src_np[3:19, 5:21]
    np.testing.assert_array_equal(T.to_numpy(), expect)


def test_redistribute_ptg_single_rank(ctx):
    rng = np.random.RandomState(5)
    lm, nb = 40, 8
    src_np = rng.rand(lm, lm)
    Y = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(src_np)
    T = TwoDimBlockCyclic(lm, lm, nb, nb, dtype=np.float64).from_numpy(
        np.zeros((lm, lm)))
    tp = redistribute_ptg(Y, T, 24, 24, disi_Y=8, disj_Y=8,
                          disi_T=16, disj_T=0)
    ctx.add_taskpool(tp)
    ctx.wait()
    expect = np.zeros((lm, lm))
    expect[16:40, 0:24] = src_np[8:32, 8:32]
    np.testing.assert_array_equal(T.to_numpy(), expect)


@pytest.mark.parametrize("nb_ranks", [2])
def test_redistribute_ptg_multirank(nb_ranks):
    rng = np.random.RandomState(6)
    lm, nb = 32, 8
    src_np = rng.rand(lm, lm)

    def rank_fn(rank, fabric):
        ctx = _rank_ctx(rank, fabric)
        try:
            Y = TwoDimBlockCyclic(lm, lm, nb, nb, P=nb_ranks, Q=1,
                                  nodes=nb_ranks, rank=rank,
                                  dtype=np.float64).from_numpy(src_np)
            Y.name = "pY"
            T = TwoDimBlockCyclic(lm, lm, nb, nb, P=1, Q=nb_ranks,
                                  nodes=nb_ranks, rank=rank,
                                  dtype=np.float64).from_numpy(
                np.zeros((lm, lm)))
            T.name = "pT"
            tp = redistribute_ptg(Y, T, 16, 16, disi_Y=0, disj_Y=8,
                                  disi_T=8, disj_T=0,
                                  rank=rank, nb_ranks=nb_ranks)
            ctx.add_taskpool(tp)
            ctx.wait()
            return {c: np.array(T.tile(*c)) for c in T.local_tiles()}
        finally:
            ctx.fini()

    results, _ = spmd(nb_ranks, rank_fn)
    expect = np.zeros((lm, lm))
    expect[8:24, 0:16] = src_np[0:16, 8:24]
    nt = lm // nb
    for m in range(nt):
        for n in range(nt):
            got = results[n % nb_ranks][(m, n)]   # P=1, Q=nb_ranks target
            np.testing.assert_array_equal(
                got, expect[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb],
                err_msg=f"tile ({m},{n})")


# --------------------------------------------------------------------- #
# against the JAX package                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("allow_reshuffle", [True, False])
def test_redistribute_matches_jax_package(ctx, geometry, allow_reshuffle):
    """The same move of the same seeded f64 matrix lands the same bytes
    in both packages (pure data movement: exact), with the same
    ``redist_bytes`` stamp."""
    import parsec_tpu
    from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBC
    from parsec_tpu.collections import redistribute as jax_redistribute
    (lmY, lnY, mbY, nbY, lmT, lnT, mbT, nbT,
     M, N, diY, djY, diT, djT) = geometry
    rng = np.random.RandomState(12)
    src_np, tgt_np = rng.rand(lmY, lnY), rng.rand(lmT, lnT)
    Y = TwoDimBlockCyclic(lmY, lnY, mbY, nbY,
                          dtype=np.float64).from_numpy(src_np)
    T = TwoDimBlockCyclic(lmT, lnT, mbT, nbT,
                          dtype=np.float64).from_numpy(tgt_np)
    tp = redistribute(Y, T, M, N, diY, djY, diT, djT, context=ctx,
                      allow_reshuffle=allow_reshuffle)
    jctx = parsec_tpu.init(nb_cores=1, enable_tpu=False)
    try:
        JY = JaxTwoDimBC(lmY, lnY, mbY, nbY,
                         dtype=np.float64).from_numpy(src_np)
        JT = JaxTwoDimBC(lmT, lnT, mbT, nbT,
                         dtype=np.float64).from_numpy(tgt_np)
        jtp = jax_redistribute(JY, JT, M, N, diY, djY, diT, djT,
                               context=jctx, allow_reshuffle=allow_reshuffle)
        want = np.asarray(JT.to_numpy())
    finally:
        jctx.fini()
    np.testing.assert_array_equal(T.to_numpy(), want)
    assert tp.redist_bytes == jtp.redist_bytes
    assert tp.wire_lossless is True


# --------------------------------------------------------------------- #
# card-resident newest versions                                         #
# --------------------------------------------------------------------- #
DOUBLE_JDF = """
descA [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]

Double(m, n)

m = 0 .. MT
n = 0 .. NT

: descA( m, n )

RW A <- descA( m, n )
     -> descA( m, n )

BODY [type=cuda]
{
    A = A * 2.0
}
END
"""


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("planner", [True, False])
def test_device_resident_sources_move_and_targets_restage(planner, device):
    """Two ranks factor a matrix with dpotrf on the device module (on
    the CPU its copies are CPU tensors; either way the host copies are
    stale), then
    move the factor from 2 x 1 to 1 x 2 before any flush — through the
    collective planner or the DTD walk. The target must equal the factor
    bit for bit; the target's tiles held stale DEVICE copies of zeros
    before the move (a device pass ran on them), and a device task after
    the move must read the moved values, not those copies."""
    from parsec_tpu_torch.dsl import ptg
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device module runs on cuda:0")
    n, nb, nb_ranks = 128, 32, 2
    M = make_spd(n)
    double = ptg.compile_jdf(DOUBLE_JDF, name="double_t")

    def rank_fn(rank, fabric):
        ctx = _rank_ctx(rank, fabric, device)
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb, P=2, Q=1, nodes=nb_ranks,
                                  rank=rank, dtype=np.float32)
            for (i, j) in A.local_tiles():
                np.copyto(A.tile(i, j),
                          M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
            T = TwoDimBlockCyclic(n, n, nb, nb, P=1, Q=2, nodes=nb_ranks,
                                  rank=rank, dtype=np.float32)
            A.name, T.name = "descA", "descT"
            ctx.add_taskpool(dpotrf_taskpool(A, rank=rank,
                                             nb_ranks=nb_ranks))
            ctx.wait()
            ctx.add_taskpool(double.new(descA=T, MT=T.mt - 1, NT=T.nt - 1,
                                        rank=rank, nb_ranks=nb_ranks))
            ctx.wait()
            stale = [c for c in A.local_tiles()
                     if A.data_of(*c).newest_copy().device_id != 0
                     and A.data_of(*c).host_copy().version
                     < A.data_of(*c).newest_copy().version]
            t_dev = [c for c in T.local_tiles()
                     if T.data_of(*c).newest_copy().device_id != 0]
            tp = redistribute(A, T, n, n, context=ctx)
            moved = {c: np.array(T.data_of(*c).host_copy().payload)
                     for c in T.local_tiles()}
            ctx.add_taskpool(double.new(descA=T, MT=T.mt - 1, NT=T.nt - 1,
                                        rank=rank, nb_ranks=nb_ranks))
            ctx.wait()
            copies = {c: T.data_of(*c).sync_to_host(ctx.devices)
                      for c in T.local_tiles()}
            if device == "cuda":
                torch.cuda.synchronize()
            doubled = {c: np.array(cp.payload) for c, cp in copies.items()}
            dev = ctx.device_by_type("cuda")
            return (len(stale), len(t_dev), hasattr(tp, "plan_digest"),
                    moved, doubled, dev.stats["tasks"])
        finally:
            ctx.fini()

    with params.cmdline_override("xfer_collective_redist",
                                 "1" if planner else "0"):
        results, _ = spmd(nb_ranks, rank_fn)
    # the factor of the same input on one rank, interpreted
    ctx1 = ptt.init(nb_cores=2, device=device)
    try:
        L = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        ctx1.add_taskpool(dpotrf_taskpool(L))
        ctx1.wait()
        for c in L.tiles():
            L.data_of(*c).sync_to_host(ctx1.devices)
        if device == "cuda":
            torch.cuda.synchronize()
        F = L.to_numpy()
    finally:
        ctx1.fini()
    got = np.zeros((n, n), np.float32)
    twice = np.zeros((n, n), np.float32)
    # tiles that crossed ranks were pulled to the host by the comm layer;
    # the others (rank 1's last panels) are still newest on the device
    assert sum(r[0] for r in results) > 0, \
        "no source tile was device-resident: nothing shown"
    for stale, t_dev, planned, moved, doubled, tasks in results:
        assert t_dev > 0, "no target tile held a device copy before the move"
        assert planned is planner
        assert tasks > 0
        for (i, j), arr in moved.items():
            got[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = arr
        for (i, j), arr in doubled.items():
            twice[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = arr
    np.testing.assert_array_equal(got, F)
    np.testing.assert_array_equal(twice, got * np.float32(2.0))
