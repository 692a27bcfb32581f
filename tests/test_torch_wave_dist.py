"""Distributed wave execution in the port (dsl/ptg/wave_dist.py) over the
in-process fabric: SPMD rank threads, one comm engine each, the pools on
the host (``run(device="cpu")``).

The cases of the JAX package's ``tests/test_wave_dist.py`` (fp64, n = 512,
nb = 64 as there): the three transfer kinds of the static schedule
(wave-0 pre-exchange of home tiles, post-wave pushes, final returns
home), dpotrf on 2 and 4 ranks, LU, SUMMA GEMM, QR, ragged tilings,
broadcast trees, the collective lane (full and partial groups), the lazy
write-back and the [type_remote] wire conversion; the hybrid mesh case
becomes a test that ``build_pools(sharding=)`` raises naming part D2.
Also mirrored: ``test_wave_reshape::test_dist_wave_masked_writeback``
and ``test_comm_wire``'s lane-uniformity and pool-spec tests.

Parity with the JAX package on the same seeded fp64 input: its
``DistWaveRunner`` (CPU, x64 on for the run) and the port's, on 2 x 1 and
2 x 2 and with the in-process lane: factors within 1e-8 n (the port's
products are fp32, see ``PARITY_ATOL_PER_N``), the static schedules
equal transfer for transfer, ``stats`` equal in waves, body calls, tiles
and lane calls, the fabric's message counts equal, and the
lane-uniformity digests equal.  The ``gpu`` cases run on the card.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

import parsec_tpu
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.comm import LocalFabric as JLocalFabric
from parsec_tpu.dsl import ptg as jptg
from parsec_tpu.ops import dpotrf_taskpool as jdpotrf_taskpool
from parsec_tpu.utils.spmd import spmd_threads as jspmd_threads

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, MeshFabric
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.ptg.wave import WaveError, WaveRunner
from parsec_tpu_torch.dsl.ptg.wave_dist import (
    DistWaveRunner, _CollectiveLane, check_lane_schedule_uniformity,
    lane_digest)
from parsec_tpu_torch.ops import (dgeqrf_taskpool, dgetrf_nopiv_taskpool,
                                  dpotrf_taskpool, make_spd,
                                  pdgemm_taskpool)
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads

SPMD_TIMEOUT = 180      # seconds a rank thread may take before it hangs
#: port against the JAX package on fp64 tiles, per unit of n: the JAX
#: test's own bound against numpy.  The port's tile products go through
#: the GEMM kernel, fp32 by design (its plain version too), so the two
#: factors differ at fp32 rounding (1.1e-7 at n = 512), not at fp64's
PARITY_ATOL_PER_N = 1e-8


def _spmd(nb_ranks, fn, fabric=None, timeout=SPMD_TIMEOUT):
    return spmd_threads(nb_ranks, fn, timeout=timeout, fabric=fabric)


def _gather_owned(coll, rank):
    out = {}
    for c in coll.tiles():
        if coll.rank_of(*c) == rank:
            out[c] = np.asarray(
                coll.data_of(*c).sync_to_host().payload).copy()
    return out


def _assemble(results, n, nb):
    """Shape-aware assembly of the ranks' owned tiles (edge tiles may be
    short)."""
    out = np.zeros((n, n))
    for owned in results:
        for (m, k), t in owned.items():
            out[m * nb:m * nb + t.shape[0], k * nb:k * nb + t.shape[1]] = t
    return out


class _knobs:
    """Set port knobs for a block (restored after)."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        for k, v in self.kv.items():
            params.set_cmdline(k, str(v))

    def __exit__(self, *exc):
        for k in self.kv:
            params.unset_cmdline(k)


def _dpotrf_rank(rank, fabric, nb_ranks, M, n, nb, P, Q):
    ce = fabric.engine(rank)
    coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                             P=P, Q=Q, nodes=nb_ranks, rank=rank)
    coll.name = "descA"
    coll.from_numpy(M.copy())
    tp = dpotrf_taskpool(coll, rank=rank, nb_ranks=nb_ranks)
    w = ptg.wave(tp, comm=ce)
    w.run(device="cpu")
    return _gather_owned(coll, rank)


@pytest.mark.parametrize("nb_ranks,P,Q", [(2, 2, 1), (4, 2, 2)])
def test_dist_wave_dpotrf(nb_ranks, P, Q):
    n, nb = 512, 64
    M = make_spd(n, dtype=np.float64)
    results, _ = _spmd(
        nb_ranks, lambda r, f: _dpotrf_rank(r, f, nb_ranks, M, n, nb, P, Q))
    L = np.tril(_assemble(results, n, nb))
    np.testing.assert_allclose(L, np.linalg.cholesky(M), rtol=0,
                               atol=1e-8 * n)


def test_dist_wave_matches_single_rank_bit_for_bit():
    """A wave's per-tile update chain is fixed by the dependences, and a
    lane broadcast adds only zeros: the 2 x 2 factor, with trees and with
    the lane, equals the one-rank wave's bit for bit (the card's check)."""
    n, nb = 256, 64
    M = make_spd(n, dtype=np.float64)
    one = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64).from_numpy(M)
    WaveRunner(dpotrf_taskpool(one)).run(device="cpu")
    ref = np.tril(one.to_numpy())
    for lane in ("off", "on"):
        with _knobs(wave_dist_collective=lane):
            results, _ = _spmd(
                4, lambda r, f: _dpotrf_rank(r, f, 4, M, n, nb, 2, 2))
        assert np.array_equal(np.tril(_assemble(results, n, nb)), ref), lane


# --------------------------------------------------------------------- #
# wave-0 pre-exchange: every rank's task reads a tile whose HOME is the #
# other rank, before anyone writes it                                   #
# --------------------------------------------------------------------- #
PREX_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]
M [ type="int" ]

Sweep(m)
m = 0 .. M-1
: descB( m, 0 )
RW B <- descB( m, 0 )
     -> descB( m, 0 )
READ L <- descA( (m+1) % M, 0 )
BODY
{
    B = B + 2.0 * L
}
END
"""


def _prex_rank(rank, fabric, nb_ranks, A0, B0, M, nb):
    ce = fabric.engine(rank)
    mk = lambda: TwoDimBlockCyclic(M * nb, nb, nb, nb, dtype=np.float64,
                                   P=nb_ranks, Q=1, nodes=nb_ranks,
                                   rank=rank)
    dA, dB = mk(), mk()
    dA.name, dB.name = "descA", "descB"
    dA.from_numpy(A0.copy())
    dB.from_numpy(B0.copy())
    tp = ptg.compile_jdf(PREX_JDF, name="prex").new(
        descA=dA, descB=dB, M=M, rank=rank, nb_ranks=nb_ranks)
    w = ptg.wave(tp, comm=ce)
    w.run(device="cpu")
    return _gather_owned(dB, rank), w.schedule_summary()


def test_dist_wave_zero_exchange_of_home_tiles():
    M, nb = 4, 8
    rng = np.random.RandomState(1)
    A0 = rng.rand(M * nb, nb)
    B0 = rng.rand(M * nb, nb)
    results, _ = _spmd(2, lambda r, f: _prex_rank(r, f, 2, A0, B0, M, nb))
    got = {}
    for owned, _s in results:
        got.update(owned)
    for m in range(M):
        exp = (B0[m * nb:(m + 1) * nb]
               + 2.0 * A0[((m + 1) % M) * nb:(((m + 1) % M) + 1) * nb])
        np.testing.assert_allclose(got[(m, 0)], exp, rtol=1e-6)
    # every transfer is a wave-0 pre-exchange, of one 8 x 8 fp64 tile
    for _o, summ in results:
        assert summ["pre"]["sent"] == summ["pre"]["recv"] == 2
        assert summ["pre"]["sent_bytes"] == 2 * nb * nb * 8
        assert summ["push"]["sent"] == summ["return"]["sent"] == 0


# --------------------------------------------------------------------- #
# producer->reader edge transfer + final write->home return             #
# --------------------------------------------------------------------- #
EDGE_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]
M [ type="int" ]

Phase1(m)
m = 0 .. M-1
: descA( m, 0 )
RW A <- descA( m, 0 )
     -> L Phase2( (m+1) % M )
     -> descA( m, 0 )
BODY
{
    A = A * 10.0
}
END

Phase2(m)
m = 0 .. M-1
: descB( m, 0 )
RW B <- descB( m, 0 )
     -> descB( m, 0 )
READ L <- A Phase1( (m+M-1) % M )
BODY
{
    B = B + L
}
END
"""


def _edge_rank(rank, fabric, nb_ranks, A0, B0, M, nb):
    ce = fabric.engine(rank)
    dA = TwoDimBlockCyclic(M * nb, nb, nb, nb, dtype=np.float64,
                           P=nb_ranks, Q=1, nodes=nb_ranks, rank=rank)

    # descB's distribution is SHIFTED: tile m of B lives on the rank that
    # does NOT own tile m of A, so every edge crosses ranks
    class Shifted(TwoDimBlockCyclic):
        def rank_of(self, m, n=0):
            return (super().rank_of(m, n) + 1) % nb_ranks

    dB = Shifted(M * nb, nb, nb, nb, dtype=np.float64,
                 P=nb_ranks, Q=1, nodes=nb_ranks, rank=rank)
    dA.name, dB.name = "descA", "descB"
    dA.from_numpy(A0.copy())
    dB.from_numpy(B0.copy())
    tp = ptg.compile_jdf(EDGE_JDF, name="edge").new(
        descA=dA, descB=dB, M=M, rank=rank, nb_ranks=nb_ranks)
    w = ptg.wave(tp, comm=ce)
    w.run(device="cpu")
    return _gather_owned(dA, rank), _gather_owned(dB, rank)


def test_dist_wave_edge_transfer_and_home_return():
    M, nb = 4, 8
    rng = np.random.RandomState(2)
    A0 = rng.rand(M * nb, nb)
    B0 = rng.rand(M * nb, nb)
    results, _ = _spmd(2, lambda r, f: _edge_rank(r, f, 2, A0, B0, M, nb))
    gotA, gotB = {}, {}
    for a, b in results:
        gotA.update(a)
        gotB.update(b)
    for m in range(M):
        sl = slice(m * nb, (m + 1) * nb)
        np.testing.assert_allclose(gotA[(m, 0)], 10.0 * A0[sl], rtol=1e-6)
        prev = slice(((m - 1) % M) * nb, (((m - 1) % M) + 1) * nb)
        np.testing.assert_allclose(gotB[(m, 0)], B0[sl] + 10.0 * A0[prev],
                                   rtol=1e-6)


def test_dist_wave_requires_affinity():
    """A class without affinity has no owner — rejected, not executed
    everywhere (divergent schedules would hang)."""
    NOAFF = """
descA [ type="collection" ]
M [ type="int" ]

T(m)
m = 0 .. M-1
RW A <- descA( m, 0 )
     -> descA( m, 0 )
BODY
{
    A = A + 1.0
}
END
"""

    def run(rank, fabric):
        ce = fabric.engine(rank)
        dA = TwoDimBlockCyclic(16, 8, 8, 8, dtype=np.float64,
                               P=2, Q=1, nodes=2, rank=rank)
        dA.name = "descA"
        dA.from_numpy(np.zeros((16, 8)))
        tp = ptg.compile_jdf(NOAFF, name="noaff").new(
            descA=dA, M=2, rank=rank, nb_ranks=2)
        with pytest.raises(WaveError, match="affinity"):
            ptg.wave(tp, comm=ce)
        return True

    results, _ = _spmd(2, run)
    assert all(results)


def _getrf_rank(rank, fabric, nb_ranks, M0, n, nb):
    ce = fabric.engine(rank)
    coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                             P=nb_ranks, Q=1, nodes=nb_ranks, rank=rank)
    coll.name = "descA"
    coll.from_numpy(M0.copy())
    tp = dgetrf_nopiv_taskpool(coll, rank=rank, nb_ranks=nb_ranks)
    w = ptg.wave(tp, comm=ce)
    w.run(device="cpu")
    return _gather_owned(coll, rank)


def test_dist_wave_dgetrf(nb_ranks=2):
    """LU (no pivoting) distributed: another dataflow shape than Cholesky
    (row and column panels) through the same static schedule."""
    n, nb = 256, 64
    M = make_spd(n, dtype=np.float64)   # SPD: no-pivot LU is stable
    results, _ = _spmd(
        nb_ranks, lambda r, f: _getrf_rank(r, f, nb_ranks, M, n, nb))
    LU = _assemble(results, n, nb)
    L = np.tril(LU, -1) + np.eye(n)
    U = np.triu(LU)
    assert np.abs(L @ U - M).max() / np.abs(M).max() < 1e-5


def test_dist_wave_pdgemm(nb_ranks=2):
    """SUMMA-style GEMM distributed: three collections, broadcast-heavy
    cross-rank edges, k-loop accumulation."""
    n, nb = 256, 64
    rng = np.random.RandomState(5)
    Am = rng.rand(n, n)
    Bm = rng.rand(n, n)

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)

        def dist(src, name):
            d = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                  P=nb_ranks, Q=1, nodes=nb_ranks,
                                  rank=rank)
            d.name = name
            d.from_numpy(src.copy())
            return d

        A, B = dist(Am, "descA"), dist(Bm, "descB")
        C = dist(np.zeros((n, n)), "descC")
        tp = pdgemm_taskpool(A, B, C, rank=rank, nb_ranks=nb_ranks)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        return _gather_owned(C, rank)

    results, _ = _spmd(nb_ranks, rank_fn)
    C = _assemble(results, n, nb)
    ref = Am @ Bm
    assert np.abs(C - ref).max() / np.abs(ref).max() < 1e-5


def test_dist_wave_stats():
    """Distributed runs expose exchange counters; SPMD ranks agree on the
    schedule, so sent == recv across the job."""
    n, nb = 256, 64
    M = make_spd(n, dtype=np.float64)

    def run(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                 P=2, Q=1, nodes=2, rank=rank)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        tp = dpotrf_taskpool(coll, rank=rank, nb_ranks=2)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        return w.stats

    results, _ = _spmd(2, run)
    s0, s1 = results
    assert s0["tasks"] == s1["tasks"]
    assert s0["local_tasks"] + s1["local_tasks"] == s0["tasks"]
    assert s0["transfers_scheduled"] == s1["transfers_scheduled"] > 0
    assert s0["tiles_sent"] + s1["tiles_sent"] \
        == s0["tiles_recv"] + s1["tiles_recv"] > 0
    # a LocalFabric is in-process: every payload was a tensor hand-over
    assert all(s["mesh_local_sends"] == s["messages_sent"] > 0
               and s["host_sends"] == 0 for s in results)


def test_dist_wave_dgeqrf(nb_ranks=2):
    """QR distributed: scratch-flow (T factor) forwarding crosses ranks
    through the same static schedule; the one-rank wave is the
    reference, reproduced exactly."""
    n, nb = 256, 64
    rng = np.random.RandomState(4)
    Am = rng.rand(n, n).astype(np.float64)

    def run(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                 P=nb_ranks, Q=1, nodes=nb_ranks, rank=rank)
        coll.name = "descA"
        coll.from_numpy(Am.copy())
        tp = dgeqrf_taskpool(coll, rank=rank, nb_ranks=nb_ranks)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        return _gather_owned(coll, rank)

    results, _ = _spmd(nb_ranks, run)
    out = _assemble(results, n, nb)
    A1 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64).from_numpy(
        Am.copy())
    WaveRunner(dgeqrf_taskpool(A1)).run(device="cpu")
    np.testing.assert_allclose(out, A1.to_numpy(), rtol=1e-6, atol=1e-9)


def test_dist_wave_pools_are_sliced():
    """Each rank stages only its touched tiles + halo: summed over ranks
    that is less than 2x the matrix, and each rank holds less than the
    whole collection."""
    n, nb = 512, 64
    M = make_spd(n, dtype=np.float64)

    def run(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                 P=2, Q=1, nodes=2, rank=rank)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        tp = dpotrf_taskpool(coll, rank=rank, nb_ranks=2)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        return (w.stats["local_tiles"], len(list(coll.tiles())),
                w.stage_in_bytes)

    results, _ = _spmd(2, run)
    total_local = sum(r[0] for r in results)
    full = results[0][1]
    assert total_local < 2 * full, (total_local, full)
    assert all(r[0] < full for r in results), results
    # the stage-in moved exactly the sliced rows
    assert all(r[2] == r[0] * nb * nb * 8 for r in results), results


@pytest.mark.parametrize("n,nb", [(232, 64), (200, 64)])
def test_dist_wave_dpotrf_ragged(n, nb, nb_ranks=2):
    M = make_spd(n, dtype=np.float64)
    results, _ = _spmd(
        nb_ranks,
        lambda r, f: _dpotrf_rank(r, f, nb_ranks, M, n, nb, nb_ranks, 1))
    L = np.tril(_assemble(results, n, nb))
    np.testing.assert_allclose(L, np.linalg.cholesky(M), rtol=0,
                               atol=1e-8 * n)


def test_dist_wave_dgetrf_ragged(nb_ranks=2):
    n, nb = 200, 64
    M = make_spd(n, dtype=np.float64)
    results, _ = _spmd(
        nb_ranks, lambda r, f: _getrf_rank(r, f, nb_ranks, M, n, nb))
    LU = _assemble(results, n, nb)
    L = np.tril(LU, -1) + np.eye(n)
    U = np.triu(LU)
    assert np.abs(L @ U - M).max() / np.abs(M).max() < 1e-5


# --------------------------------------------------------------------- #
# broadcast trees and the collective lane                               #
# --------------------------------------------------------------------- #
BCAST_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]
R [ type="int" ]

Read(r)
r = 0 .. R-1
: descB( r, 0 )
RW B <- descB( r, 0 )
     -> descB( r, 0 )
READ L <- descA( 0, 0 )
BODY
{
    B = B + L
}
END
"""


def _run_bcast(nb_ranks, topo, lane="off"):
    nb = 8
    rng = np.random.RandomState(3)
    A0 = rng.rand(nb_ranks * nb, nb)
    B0 = rng.rand(nb_ranks * nb, nb)

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        mk = lambda: TwoDimBlockCyclic(nb_ranks * nb, nb, nb, nb,
                                       dtype=np.float64, P=nb_ranks, Q=1,
                                       nodes=nb_ranks, rank=rank)
        dA, dB = mk(), mk()
        dA.name, dB.name = "descA", "descB"
        dA.from_numpy(A0.copy())
        dB.from_numpy(B0.copy())
        tp = ptg.compile_jdf(BCAST_JDF, name="bcastw").new(
            descA=dA, descB=dB, R=nb_ranks, rank=rank, nb_ranks=nb_ranks)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        return w.stats, _gather_owned(dB, rank)

    with _knobs(wave_dist_bcast=topo, wave_dist_collective=lane):
        results, _ = _spmd(nb_ranks, rank_fn)
    for r, (_st, owned) in enumerate(results):
        np.testing.assert_allclose(
            owned[(r, 0)], B0[r * nb:(r + 1) * nb] + A0[:nb], rtol=1e-6)
    return [st for st, _o in results]


def test_dist_wave_bcast_tree_offloads_root(nb_ranks=4):
    """descA(0,0) is read by all 4 ranks: star ships 3 tiles from the
    root; the binomial tree ships 2 from the root and 1 re-forward."""
    star = _run_bcast(nb_ranks, "star")
    assert star[0]["tiles_sent"] == nb_ranks - 1
    assert sum(s["tiles_forwarded"] for s in star) == 0
    tree = _run_bcast(nb_ranks, "binomial")
    assert tree[0]["bcast_topology"] == "binomial"
    assert tree[0]["tiles_sent"] < nb_ranks - 1
    assert sum(s["tiles_forwarded"] for s in tree) >= 1
    assert sum(s["tiles_recv"] for s in tree) == \
        sum(s["tiles_recv"] for s in star) == nb_ranks - 1


def test_dist_wave_collective_lane_bcast(nb_ranks=4):
    """A full-broadcast tile rides ONE sum over the members' zero-padded
    contributions instead of P sends: the same numbers, no p2p tile."""
    tree = _run_bcast(nb_ranks, "binomial")
    assert sum(s["tiles_sent"] for s in tree) == nb_ranks - 1
    assert all(s["collective_calls"] == 0 for s in tree)
    assert all(s["collective_lane"] is None for s in tree)
    lane = _run_bcast(nb_ranks, "binomial", lane="on")
    assert all(s["collective_lane"] == "inproc" for s in lane), lane
    assert all(s["collective_calls"] == 1 for s in lane), lane
    assert all(s["collective_tiles"] == 1 for s in lane), lane
    assert sum(s["tiles_sent"] for s in lane) == 0, lane
    assert sum(s["tiles_recv"] for s in lane) == 0, lane


def test_dist_wave_bcast_chain_root_sends_once(nb_ranks=4):
    """Chain topology: the root ships each broadcast tile exactly ONCE
    whatever the reader count; the chain re-forwards."""
    chain = _run_bcast(nb_ranks, "chain")
    assert chain[0]["tiles_sent"] == 1
    assert sum(s["tiles_forwarded"] for s in chain) == nb_ranks - 2


def _lane_differential(nb_ranks, n, nb, P, check_runner=None):
    """dpotrf twice on the same SPD input — trees, then the in-process
    lane: the tree factor matches numpy, the lane factor is
    bit-identical to the trees', the lane fired, and it displaced p2p
    sends.  Returns (st_tree, st_lane)."""
    M = make_spd(n, dtype=np.float64)

    def run(lane):
        def rank_fn(r, f):
            ce = f.engine(r)
            coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                     P=P, Q=nb_ranks // P,
                                     nodes=nb_ranks, rank=r)
            coll.name = "descA"
            coll.from_numpy(M.copy())
            tp = dpotrf_taskpool(coll, rank=r, nb_ranks=nb_ranks)
            w = ptg.wave(tp, comm=ce)
            if check_runner is not None:
                check_runner(w, lane)
            w.run(device="cpu")
            return w.stats, _gather_owned(coll, r)

        with _knobs(wave_dist_collective=lane):
            results, _ = _spmd(nb_ranks, rank_fn)
        L = np.tril(_assemble([o for _s, o in results], n, nb))
        return L, [s for s, _o in results]

    L_tree, st_tree = run("off")
    L_lane, st_lane = run("on")
    np.testing.assert_allclose(L_tree, np.linalg.cholesky(M), rtol=0,
                               atol=1e-8 * n)
    assert np.array_equal(L_lane, L_tree)
    assert sum(s["collective_calls"] for s in st_lane) > 0, st_lane
    assert sum(s["tiles_sent"] for s in st_lane) < \
        sum(s["tiles_sent"] for s in st_tree), (st_lane, st_tree)
    return st_tree, st_lane


def test_dist_wave_collective_lane_dpotrf_matches(nb_ranks=4):
    """Row-cyclic 4 ranks: every panel tile is read by all other ranks,
    so the lane carries FULL groups; identical factor, fewer sends."""
    _st_tree, st_lane = _lane_differential(nb_ranks, 256, 32, P=nb_ranks)
    assert sum(s["collective_tiles"] for s in st_lane) > 0


def test_dist_wave_collective_lane_ragged_dpotrf(nb_ranks=4):
    """The lane over SHAPE-SPLIT pools (N % nb != 0): each (wave, pool,
    member set) group gets its own call with its own tile shape."""
    _lane_differential(nb_ranks, 232, 32, P=nb_ranks)


def test_dist_wave_collective_lane_partial_groups(nb_ranks=4):
    """PARTIAL groups on a 2 x 2 grid: a panel tile is read by a row or
    column subset, never by all three others; groups of 3 members reduce
    over just their members, 1-dst edges stay p2p."""
    def check(w, lane):
        if lane == "on":
            groups = {m for by_g in w._lane_sched.values()
                      for (_c, m) in by_g}
            assert groups, "no lane groups scheduled at P=2xQ=2"
            assert all(len(m) < nb_ranks for m in groups), groups

    _lane_differential(nb_ranks, 256, 32, P=2, check_runner=check)


def test_dist_wave_collective_lane_ragged_partial(nb_ranks=4):
    _lane_differential(nb_ranks, 232, 32, P=2)


def test_dist_wave_collective_on_without_in_process_ranks_raises():
    """wave_dist_collective=on where no lane can attach (no
    torch.distributed group spanning the ranks, and ranks that are not
    threads of this process) raises instead of falling back to trees;
    auto chooses trees and says so."""
    A = TwoDimBlockCyclic(128, 128, 64, 64, dtype=np.float64, P=2,
                          nodes=2, rank=0).from_numpy(make_spd(128))
    A.name = "descA"
    fabric = LocalFabric(2)
    ce = fabric.engine(0)
    ce.mesh_local_with = lambda peer: peer == ce.rank   # a remote peer
    with _knobs(wave_dist_collective="on"):
        with pytest.raises(WaveError, match="no lane can attach"):
            ptg.wave(dpotrf_taskpool(A, rank=0, nb_ranks=2), comm=ce)
    w = ptg.wave(dpotrf_taskpool(A, rank=0, nb_ranks=2), comm=ce)
    assert w._lane is None
    with _knobs(wave_reduce_dtype="fp16", wave_dist_collective="on"):
        with pytest.raises(ValueError):
            ptg.wave(dpotrf_taskpool(A, rank=0, nb_ranks=2), comm=ce)


def test_dist_wave_lazy_writeback_single_tile_pull(nb_ranks=2):
    """scatter_pools keeps results in the pools (lazy pool-slice
    copies); a single owned-tile host read materializes exactly ONE."""
    from parsec_tpu_torch.dsl.ptg.turbo import LazyPoolCopy

    n, nb = 256, 64
    M = make_spd(n, dtype=np.float64)

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                 P=nb_ranks, Q=1, nodes=nb_ranks,
                                 rank=rank)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        tp = dpotrf_taskpool(coll, rank=rank, nb_ranks=nb_ranks)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        lazies = []
        for c in coll.tiles():
            if coll.rank_of(*c) != rank:
                continue
            for cp in coll.data_of(*c).copies():
                if isinstance(cp, LazyPoolCopy):
                    lazies.append((c, cp))
        assert lazies, "no lazy write-back copies on owned tiles"
        assert not any(cp._mat for _c, cp in lazies), "write-back was eager"
        c0, _cp0 = lazies[0]
        coll.data_of(*c0).sync_to_host()
        assert sum(cp._mat for _c, cp in lazies) == 1
        return _gather_owned(coll, rank)

    results, _ = _spmd(nb_ranks, rank_fn)
    L = np.tril(_assemble(results, n, nb))
    np.testing.assert_allclose(L, np.linalg.cholesky(M), rtol=0,
                               atol=1e-8 * n)


def test_dist_wave_eager_writeback_equals_lazy():
    """``wave_lazy_writeback=0`` pulls the owned rows into the host
    copies at once; the factor is the lazy path's, bit for bit."""
    n, nb = 256, 64
    M = make_spd(n, dtype=np.float64)
    lazy, _ = _spmd(2, lambda r, f: _dpotrf_rank(r, f, 2, M, n, nb, 2, 1))
    with _knobs(wave_lazy_writeback=0):
        eager, _ = _spmd(
            2, lambda r, f: _dpotrf_rank(r, f, 2, M, n, nb, 2, 1))
    assert np.array_equal(_assemble(lazy, n, nb), _assemble(eager, n, nb))


# --------------------------------------------------------------------- #
# [type_remote] wire conversion: per instance on CROSS-RANK edges only  #
# --------------------------------------------------------------------- #
WIRE_JDF = """
descA [ type="collection" ]

Prod(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A ConsR( 0 )
     -> A ConsL( 0 )
     -> descA( 0, 0 )
BODY
{
    A = A + 1.0
}
END

ConsR(k)
k = 0 .. 0
: descA( 1, 0 )
READ A <- A Prod( 0 )      [type_remote=lower]
RW   B <- descA( 1, 0 )
       -> descA( 1, 0 )
BODY
{
    B = A
}
END

ConsL(k)
k = 0 .. 0
: descA( 2, 0 )
READ A <- A Prod( 0 )      [type_remote=lower]
RW   B <- descA( 2, 0 )
       -> descA( 2, 0 )
BODY
{
    B = A
}
END
"""


def test_dist_wave_type_remote_wire_conversion(nb_ranks=2):
    """ConsR lives on rank 1 (remote edge: sees tril of Prod's output);
    ConsL lives on rank 0 with Prod (local edge: [type_remote] ignored —
    the full tile)."""
    nb = 8
    rng = np.random.RandomState(11)
    A0 = rng.rand(3 * nb, nb)

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(3 * nb, nb, nb, nb, dtype=np.float64,
                                 P=nb_ranks, Q=1, nodes=nb_ranks,
                                 rank=rank)
        coll.name = "descA"
        coll.from_numpy(A0.copy())
        tp = ptg.compile_jdf(WIRE_JDF, name="wirejdf").new(
            descA=coll, rank=rank, nb_ranks=nb_ranks)
        w = ptg.wave(tp, comm=ce)
        assert w._wconv, "no wire conversion was planned"
        w.run(device="cpu")
        return _gather_owned(coll, rank)

    results, _ = _spmd(nb_ranks, rank_fn)
    got = {}
    for r in results:
        got.update(r)
    prod = A0[:nb] + 1.0
    np.testing.assert_allclose(got[(1, 0)], np.tril(prod), rtol=1e-6)
    np.testing.assert_allclose(got[(2, 0)], prod, rtol=1e-6)
    np.testing.assert_allclose(got[(0, 0)], prod, rtol=1e-6)


def test_dist_wave_build_pools_sharding_raises_naming_d2():
    """The JAX package's hybrid process x mesh layout (each rank's sliced
    pools over its own sub-mesh) comes with the chip mesh: sharding=
    raises NotImplementedError naming part D2."""
    n, nb = 128, 64

    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64, P=2, Q=1,
                                 nodes=2, rank=rank)
        coll.name = "descA"
        coll.from_numpy(make_spd(n, dtype=np.float64))
        w = ptg.wave(dpotrf_taskpool(coll, rank=rank, nb_ranks=2), comm=ce)
        with pytest.raises(NotImplementedError, match="part D2"):
            w.build_pools(device="cpu", sharding=object())
        return True

    results, _ = _spmd(2, rank_fn)
    assert all(results)


MASKED_RW = """
descA [ type="collection" ]
NT [ type="int" ]

T(m)
m = 0 .. NT-1
: descA( m, m )
RW A <- descA( m, m )    [type_data=lower]
     -> descA( m, m )    [type_data=lower]
BODY
{
    A = A * 3.0 + 1.0
}
END
"""


def test_dist_wave_masked_writeback():
    """Masked write-backs also work distributed: the exchanged tile is
    the post-merge pool value (test_wave_reshape's case)."""
    N, NB = 8, 4
    base = (np.arange(N * N, dtype=np.float32).reshape(N, N) + 1.0) / 7.0
    fac = ptg.compile_jdf(MASKED_RW, "masked_dist")

    def run(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(N, N, NB, NB, dtype=np.float32,
                                 P=2, Q=1, nodes=2, rank=rank)
        coll.name = "descA"
        coll.from_numpy(base.copy())
        tp = fac.new(descA=coll, NT=N // NB, rank=rank, nb_ranks=2)
        w = ptg.wave(tp, comm=ce)
        w.run(device="cpu")
        return _gather_owned(coll, rank)

    results, _ = _spmd(2, run)
    got = {}
    for r in results:
        got.update(r)
    tri = np.tril(np.ones((NB, NB), bool))
    for m in range(N // NB):
        sl = slice(m * NB, (m + 1) * NB)
        exp = np.where(tri, np.tril(base[sl, sl]) * 3.0 + 1.0, base[sl, sl])
        np.testing.assert_allclose(got[(m, m)], exp, rtol=1e-5)


# --------------------------------------------------------------------- #
# the lane's rendezvous (test_wave_dist's last two, on tensors)         #
# --------------------------------------------------------------------- #
def test_collective_lane_issuer_failure_wakes_peers():
    """When the issuing rank's sum raises, waiting peers get a WaveError
    promptly (not at the timeout), and no refcount leaks."""
    rdv = ({}, {}, threading.Condition())
    lanes = [_CollectiveLane("inproc", 2, r, rendezvous=rdv, timeout=15)
             for r in range(2)]

    class Boom(RuntimeError):
        pass

    def exploding_sum(_stacked):
        raise Boom("collective died")

    results = {}

    def waiter():
        try:
            lanes[0].reduce(("p", 1, 0, 0), torch.zeros(1, 4, 4))
            results[0] = "ok"
        except WaveError as e:
            results[0] = f"waveerror: {e}"

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    slots, res, cv = rdv
    while time.monotonic() < deadline:
        with cv:
            if ("p", 1, 0, 0, (0, 1)) in slots:
                break
        time.sleep(0.01)
    lanes[1]._sum = exploding_sum
    with pytest.raises(Boom):
        lanes[1].reduce(("p", 1, 0, 0), torch.zeros(1, 4, 4))
    t.join(10)
    assert not t.is_alive(), "peer hung after issuer failure"
    assert results[0].startswith("waveerror"), results
    assert not slots and not res, "rendezvous state leaked"


def test_collective_lane_waiter_timeout_withdraws_deposit():
    """A lone depositor whose peers never arrive times out with a
    WaveError and withdraws its deposit."""
    rdv = ({}, {}, threading.Condition())
    lane = _CollectiveLane("inproc", 2, 0, rendezvous=rdv, timeout=1.5)
    with pytest.raises(WaveError, match="timed out"):
        lane.reduce(("p", 1, 0, 0), torch.zeros(1, 4, 4))
    slots, res, _cv = rdv
    assert not slots and not res, "rendezvous state leaked after timeout"


def test_collective_lane_sum_is_the_broadcast():
    """Three members, each sourcing one row of a zero-padded stack: every
    member picks up the full stack, bit for bit the sources' rows."""
    rng = np.random.RandomState(9)
    rows = torch.from_numpy(rng.randn(3, 4, 4))
    rdv = ({}, {}, threading.Condition())
    lanes = [_CollectiveLane("inproc", 4, r, rendezvous=rdv, timeout=30)
             for r in range(4)]
    outs = {}

    def member(r):
        contrib = torch.zeros(4, 4, 4, dtype=torch.float64)
        contrib[r] = rows[r]
        outs[r] = lanes[r].reduce(("p", 1, 2, 0), contrib,
                                  members=(0, 1, 2))

    ts = [threading.Thread(target=member, args=(r,)) for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    for r in range(3):
        assert torch.equal(outs[r][:3], rows) and not outs[r][3].any()
    assert not rdv[0] and not rdv[1]


# --------------------------------------------------------------------- #
# lane-schedule uniformity and the pool-spec guard (test_comm_wire's)   #
# --------------------------------------------------------------------- #
def test_lane_schedule_uniformity_matching_digests_pass():
    def rank_fn(r, fab):
        check_lane_schedule_uniformity(fab.engine(r), "same", timeout=20)
        return "ok"

    results, _f = spmd_threads(2, rank_fn, timeout=60)
    assert results == ["ok", "ok"]


def test_lane_schedule_uniformity_mismatch_fails_fast():
    def rank_fn(r, fab):
        try:
            check_lane_schedule_uniformity(
                fab.engine(r), f"digest-{r}", timeout=20)
            return "no-error"
        except WaveError as exc:
            return f"raised: {exc}"

    results, _f = spmd_threads(2, rank_fn, timeout=60)
    assert all(r.startswith("raised") for r in results), results
    assert "diverge" in results[0]


def test_pool_tile_spec_requires_contract_or_owned_tile():
    """A rank owning no tile of a pool whose collection lacks the static
    tile_shape/dtype contract gets a clear error, not a remote fetch."""
    class NoContractColl:
        dtype = None

        def rank_of(self, m, n):
            return 1          # every tile owned elsewhere

        def data_of(self, m, n):  # pragma: no cover - must not be hit
            raise AssertionError("data_of reached for unowned tile")

    shim = types.SimpleNamespace(
        rank=0, _n_real_colls=1, pool_names=["descA"],
        collections={"descA": NoContractColl()},
        _pool_shapes=[None], _pool_coords=[[(0, 0), (1, 0)]],
        _scratch={})
    with pytest.raises(WaveError, match="static"):
        DistWaveRunner._pool_tile_spec(shim, 0)


def test_pool_tile_spec_uses_locally_owned_coord():
    probed = []

    class HalfOwnedColl:
        dtype = None

        def rank_of(self, m, n):
            return 0 if (m, n) == (1, 0) else 1

        def data_of(self, m, n):
            probed.append((m, n))
            payload = np.zeros((4, 4), np.float32)
            host = types.SimpleNamespace(payload=payload)
            return types.SimpleNamespace(sync_to_host=lambda: host)

    shim = types.SimpleNamespace(
        rank=0, _n_real_colls=1, pool_names=["descA"],
        collections={"descA": HalfOwnedColl()},
        _pool_shapes=[None], _pool_coords=[[(0, 0), (1, 0)]],
        _scratch={})
    sh, dt = DistWaveRunner._pool_tile_spec(shim, 0)
    assert sh == (4, 4) and dt == np.float32
    assert probed == [(1, 0)]


# --------------------------------------------------------------------- #
# routing, the mesh fabric                                              #
# --------------------------------------------------------------------- #
def test_wave_routes_multirank_and_explicit_comm_to_dist():
    """wave(tp) sends a multi-rank pool (or any call with comm=) to
    DistWaveRunner; without a comm engine it raises naming it; the
    single-rank WaveRunner refuses a multi-rank pool."""
    A = TwoDimBlockCyclic(128, 128, 64, 64, dtype=np.float64, P=2,
                          nodes=2).from_numpy(make_spd(128))
    A.name = "descA"
    with pytest.raises(WaveError, match="comm engine"):
        ptg.wave(dpotrf_taskpool(A, rank=0, nb_ranks=2))
    with pytest.raises(WaveError, match="single-rank wave"):
        WaveRunner(dpotrf_taskpool(A, rank=0, nb_ranks=2))
    one = TwoDimBlockCyclic(128, 128, 64, 64,
                            dtype=np.float64).from_numpy(make_spd(128))
    one.name = "descA"
    fabric = LocalFabric(1)
    w = ptg.wave(dpotrf_taskpool(one), comm=fabric.engine(0))
    assert isinstance(w, DistWaveRunner)
    w.run(device="cpu")
    np.testing.assert_allclose(np.tril(one.to_numpy()),
                               np.linalg.cholesky(make_spd(128)),
                               rtol=0, atol=1e-8 * 128)
    assert type(ptg.wave(dpotrf_taskpool(one))) is WaveRunner


def test_dist_wave_over_mesh_fabric_hands_tensors_device_to_device():
    """On a MeshFabric every exchanged stack travels as a tensor (counted
    in d2d_bytes), none as host bytes; the factor is the LocalFabric
    run's, and with comm_mesh_local=0 every stack is host bytes."""
    n, nb = 256, 64
    M = make_spd(n, dtype=np.float64)

    def rank_fn(r, f):
        ce = f.engine(r)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64, P=2, Q=1,
                                 nodes=2, rank=r)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        w = ptg.wave(dpotrf_taskpool(coll, rank=r, nb_ranks=2), comm=ce)
        w.run(device="cpu")
        return w.stats, _gather_owned(coll, r)

    fab = MeshFabric(devices=["cpu"] * 2)
    mesh, _ = _spmd(2, rank_fn, fabric=fab)
    assert all(s["host_sends"] == 0 and s["mesh_local_sends"] > 0
               for s, _o in mesh)
    sent = sum(s["tiles_sent"] for s, _o in mesh)
    assert fab.d2d_bytes == sent * nb * nb * 8
    with _knobs(comm_mesh_local=0):
        host, _ = _spmd(2, rank_fn)
    assert all(s["mesh_local_sends"] == 0 and s["host_sends"] > 0
               for s, _o in host)
    assert np.array_equal(_assemble([o for _s, o in mesh], n, nb),
                          _assemble([o for _s, o in host], n, nb))


# --------------------------------------------------------------------- #
# parity with the JAX package                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def jax_x64():
    """The JAX runner in fp64 for the duration of one test (the JAX
    package's pools follow jax's x64 switch)."""
    import jax
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _jax_dist(nb_ranks, P, Q, M, n, nb):
    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        coll = JTwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64, P=P, Q=Q,
                                  nodes=nb_ranks, rank=rank)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        w = jptg.wave(jdpotrf_taskpool(coll, rank=rank, nb_ranks=nb_ranks),
                      comm=ce)
        sched = _schedule_of(w)
        w.run()
        return w.stats, _gather_owned(coll, rank), sched

    return jspmd_threads(nb_ranks, rank_fn, timeout=SPMD_TIMEOUT,
                         fabric=JLocalFabric(nb_ranks))


def _port_dist(nb_ranks, P, Q, M, n, nb):
    def rank_fn(rank, fabric):
        ce = fabric.engine(rank)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64, P=P, Q=Q,
                                 nodes=nb_ranks, rank=rank)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        w = ptg.wave(dpotrf_taskpool(coll, rank=rank, nb_ranks=nb_ranks),
                     comm=ce)
        sched = _schedule_of(w)
        w.run(device="cpu")
        return w.stats, _gather_owned(coll, rank), sched

    return _spmd(nb_ranks, rank_fn, fabric=LocalFabric(nb_ranks))


def _schedule_of(w):
    """A runner's static schedule in package-neutral terms: the transfers
    (wave, src, dst, pool's collection, tile coord), this rank's sends
    and receives by wave and tree generation, and the lane's groups."""
    name = lambda c: w.pool_names[c]
    coord = lambda c, i: tuple(w._pool_coords[c][i])
    return {
        "transfers": sorted((w_, s, d, name(c), coord(c, i))
                            for (w_, s, d, c, i) in w._transfers),
        "sends": {(wv, g, dst, name(c)): [coord(c, i) for i in idxs]
                  for wv, by_g in w._sends.items()
                  for g, by_d in by_g.items()
                  for dst, by_c in by_d.items()
                  for c, idxs in by_c.items()},
        "recvs": {(wv, g): list(srcs) for wv, by_g in w._recvs.items()
                  for g, srcs in by_g.items()},
        "lane": {(wv, name(c), members): [(coord(c, i), s)
                                          for (i, s) in ents]
                 for wv, by_c in w._lane_sched.items()
                 for (c, members), ents in by_c.items()},
        "local_tiles": [len(x) for x in w._l2g],
    }


@pytest.mark.parametrize("nb_ranks,P,Q,lane", [
    (2, 2, 1, "off"), (4, 2, 2, "off"), (4, 2, 2, "on")])
def test_parity_with_jax_dist_wave(jax_x64, nb_ranks, P, Q, lane):
    n, nb = 512, 64
    M = make_spd(n, dtype=np.float64)
    parsec_tpu.params.set_cmdline("wave_dist_collective", lane)
    try:
        with _knobs(wave_dist_collective=lane):
            jres, jfab = _jax_dist(nb_ranks, P, Q, M, n, nb)
            pres, pfab = _port_dist(nb_ranks, P, Q, M, n, nb)
    finally:
        parsec_tpu.params.unset_cmdline("wave_dist_collective")
    Lj = np.tril(_assemble([o for _s, o, _c in jres], n, nb))
    Lp = np.tril(_assemble([o for _s, o, _c in pres], n, nb))
    np.testing.assert_allclose(Lp, Lj, rtol=0, atol=PARITY_ATOL_PER_N * n)
    np.testing.assert_allclose(Lp, np.linalg.cholesky(M), rtol=0,
                               atol=1e-8 * n)
    for (js, _jo, jsch), (ps, _po, psch) in zip(jres, pres):
        assert psch == jsch
        for key in ("tasks", "waves", "kernel_calls", "local_tasks",
                    "transfers_scheduled", "tiles_sent", "tiles_recv",
                    "tiles_forwarded", "collective_calls",
                    "collective_tiles", "local_tiles"):
            assert ps[key] == js[key], (key, ps[key], js[key])
        assert ps["collective_lane"] == js["collective_lane"]
    if lane == "on":
        assert sum(s["collective_calls"] for s, _o, _c in pres) > 0
    assert pfab.msg_count == jfab.msg_count


@pytest.mark.parametrize("knobs", [
    {}, {"wave_dist_collective": "on", "wave_reduce_dtype": "bf16"},
    {"wave_dist_collective_min_pct": "25", "wave_reduce_dtype": "int8",
     "xfer_collective_redist": "1", "xfer_group_size": "4"}])
def test_lane_digest_parity_with_jax(monkeypatch, knobs):
    """The digest a multi-process runner exchanges is the JAX package's
    for the same params (the JAX runner's check, captured with its
    process count faked to the rank count)."""
    import jax
    import parsec_tpu.dsl.ptg.wave_dist as jwd
    got = []
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jwd, "check_lane_schedule_uniformity",
                        lambda ce, digest, timeout: got.append(digest))
    shim = types.SimpleNamespace(nb_ranks=2, ce=None, comm_timeout=30.0)
    for k, v in knobs.items():
        parsec_tpu.params.set_cmdline(k, v)
    try:
        with _knobs(**knobs):
            jwd.DistWaveRunner._check_lane_uniformity(shim)
            mine = lane_digest()
    finally:
        for k in knobs:
            parsec_tpu.params.unset_cmdline(k)
    assert got == [mine]


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_lane_orders_deposits_on_their_streams_gpu():
    """Rank threads on their own streams: each writes its contribution
    after a long kernel on its stream; the lane's events order the sum
    after every write and every pick-up after the sum, with no host
    synchronisation — the result is exact."""
    _need_card()
    dev = torch.device("cuda", 0)
    rdv = ({}, {}, threading.Condition())
    lanes = [_CollectiveLane("inproc", 4, r, rendezvous=rdv, timeout=60)
             for r in range(4)]
    big = torch.randn(2048, 2048, device=dev)
    outs, errs = {}, []

    def member(r):
        try:
            s = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(s):
                x = big
                for _ in range(20):        # keep the stream busy
                    x = x @ big / 2048.0
                contrib = torch.zeros(4, 256, 256, device=dev)
                contrib[r] = float(r + 1) + 0.0 * x[:256, :256]
                out = lanes[r].reduce(("g", 1, 0, 0), contrib)
                outs[r] = out.cpu()
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=member, args=(r,)) for r in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs and not any(t.is_alive() for t in ts), errs
    for r in range(4):
        for k in range(4):
            assert torch.all(outs[r][k] == float(k + 1)), (r, k)


@pytest.mark.gpu
def test_dist_wave_dpotrf_on_card_matches_one_rank_gpu():
    """4 rank threads on MeshFabric([cuda:0] * 4), trees and the lane:
    the factor equals the one-rank wave's on the card, bit for bit."""
    _need_card()
    from parsec_tpu_torch.ops import kernels
    n, nb = 1024, 256
    M = make_spd(n).astype(np.float32)
    one = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    WaveRunner(dpotrf_taskpool(one)).run()
    ref = np.tril(one.to_numpy())
    for lane in ("off", "on"):
        def rank_fn(r, f):
            ce = f.engine(r)
            coll = TwoDimBlockCyclic(n, n, nb, nb, P=2, Q=2, nodes=4,
                                     rank=r)
            coll.name = "descA"
            coll.from_numpy(M)
            w = ptg.wave(dpotrf_taskpool(coll, rank=r, nb_ranks=4),
                         comm=ce)
            w.run()
            return w.stats, _gather_owned(coll, r)

        before = kernels.matmul_launches
        with _knobs(wave_dist_collective=lane):
            res, fab = _spmd(4, rank_fn,
                             fabric=MeshFabric(devices=["cuda:0"] * 4))
        assert kernels.matmul_launches > before
        L = np.tril(_assemble([o for _s, o in res], n, nb))
        assert np.array_equal(L, ref), lane
        assert fab.d2d_bytes > 0
