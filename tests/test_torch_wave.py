"""Wave execution in the port (parsec_tpu_torch/dsl/ptg/wave.py), held
against the JAX package's wave runner on the same seeded inputs.

The cases of tests/test_ptg_wave.py on the host (``run(device="cpu")``:
the same code over host tensors, each kernel's plain version), except
the two sharded ones, which become one test that ``sharding=`` raises.
Each factor is bit-identical to the port's interpreted path (the hash
mode on ``init(device="cpu")``) and within the reference tests' bounds
of numpy and of the JAX wave's; the wave count and each wave's ready set
equal the JAX runner's.  The ``gpu`` case runs on the card.
"""
import sys

import numpy as np
import pytest
import torch

from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.dsl import ptg as jptg
from parsec_tpu.dsl.ptg.wave import wave as jwave
from parsec_tpu.ops import (dgeqrf_taskpool as jdgeqrf_taskpool,
                            dgetrf_nopiv_taskpool as jdgetrf_nopiv_taskpool,
                            dpotrf_taskpool as jdpotrf_taskpool,
                            pdgemm_taskpool as jpdgemm_taskpool)

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.ptg.wave import WaveError, WaveRunner, wave
from parsec_tpu_torch.ops import (dgeqrf_taskpool, dgetrf_nopiv_taskpool,
                                  dpotrf_taskpool, make_spd, pdgemm_taskpool)
from parsec_tpu_torch.utils.params import params

JATOL = 5e-4    # port against the JAX package, fp32


def _coll(M, nb, cls=TwoDimBlockCyclic):
    return cls(M.shape[0], M.shape[1], nb, nb,
               dtype=np.float32).from_numpy(M)


def _port_wave(make, mats, nb, max_chunk=256):
    """wave(tp).run(device="cpu"); returns (last collection, runner)."""
    colls = [_coll(M, nb) for M in mats]
    w = wave(make(*colls), max_chunk=max_chunk)
    w.run(device="cpu")
    return colls[-1].to_numpy(), w


def _interp(make, mats, nb):
    """The port's interpreted path (hash mode) on its CPU context."""
    ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    try:
        colls = [_coll(M, nb) for M in mats]
        ctx.add_taskpool(make(*colls))
        ctx.wait()
        return colls[-1].to_numpy()
    finally:
        ctx.fini()


def _jax_wave(make, mats, nb, max_chunk=256):
    colls = [_coll(M, nb, JTwoDimBlockCyclic) for M in mats]
    w = jwave(make(*colls), max_chunk=max_chunk)
    w.run()
    return colls[-1].to_numpy(), w


def _frontiers(runner):
    """Record each wave's ready set (sorted task ids) on a runner of
    either package."""
    sets = []
    orig = runner._execute_frontier

    def rec(ids, classes, pools):
        sets.append(tuple(sorted(int(t) for t in ids)))
        return orig(ids, classes, pools)

    runner._execute_frontier = rec
    return sets


def _check(make, jmake, mats, nb, out, max_chunk=256):
    """Bit-identical to the port's interpreted path, within 5e-4 of the
    JAX wave on the same input."""
    np.testing.assert_array_equal(out, _interp(make, mats, nb))
    jout, _ = _jax_wave(jmake, mats, nb, max_chunk)
    np.testing.assert_allclose(out, jout, atol=JATOL, rtol=1e-6)


def test_wave_dpotrf_matches_numpy():
    M = make_spd(1024, dtype=np.float32)
    out, w = _port_wave(dpotrf_taskpool, [M], 128, max_chunk=64)
    L = np.tril(out).astype(np.float64)
    assert np.allclose(L, np.linalg.cholesky(M.astype(np.float64)),
                       atol=1e-3)
    _check(dpotrf_taskpool, jdpotrf_taskpool, [M], 128, out, 64)


def test_wave_dgetrf_matches_numpy():
    M = make_spd(768, dtype=np.float32)
    out, _ = _port_wave(dgetrf_nopiv_taskpool, [M], 128, max_chunk=32)
    LU = out.astype(np.float64)
    L = np.tril(LU, -1) + np.eye(768)
    U = np.triu(LU)
    assert np.abs(L @ U - M).max() / np.abs(M).max() < 1e-5
    _check(dgetrf_nopiv_taskpool, jdgetrf_nopiv_taskpool, [M], 128, out, 32)


def test_wave_pdgemm_static_body_locals():
    """pdgemm's GEMM body branches on local k in Python (`BETA if k == 0
    else 1.0`): the runner groups on it and the body sees one value."""
    n, nb = 512, 128
    rng = np.random.RandomState(2)
    mats = [rng.rand(n, n).astype(np.float32),
            rng.rand(n, n).astype(np.float32), np.zeros((n, n), np.float32)]
    colls = [_coll(M, nb) for M in mats]
    w = wave(pdgemm_taskpool(*colls), max_chunk=16)
    gemm_plan = next(p for p in w.plans if p.ast.name == "GEMM")
    assert gemm_plan.body_locals, "k should be detected as a body local"
    w.run(device="cpu")
    out = colls[-1].to_numpy()
    ref = mats[0].astype(np.float64) @ mats[1].astype(np.float64)
    assert np.abs(out.astype(np.float64) - ref).max() / n < 1e-6
    _check(pdgemm_taskpool, jpdgemm_taskpool, mats, nb, out, 16)


def test_wave_dgeqrf_scratch_pools():
    """QR's WRITE-only Q/Q2 flows live in scratch pools zeroed on the
    device, never staged from the host."""
    n, nb = 384, 128
    M = np.random.RandomState(3).rand(n, n).astype(np.float32)
    out, w = _port_wave(dgeqrf_taskpool, [M], nb)
    assert w._scratch and w.stage_in_bytes == n * n * 4
    R = np.triu(out)
    Rref = np.linalg.qr(M.astype(np.float64), mode="r")
    np.testing.assert_allclose(np.abs(np.diag(R)), np.abs(np.diag(Rref)),
                               rtol=1e-3)
    _check(dgeqrf_taskpool, jdgeqrf_taskpool, [M], nb, out)


def test_wave_dispatch_scales_with_waves_not_tasks():
    """The point of wave mode: body calls far below the task count
    (per-task dispatch is what it eliminates)."""
    M = make_spd(2048, dtype=np.float32)   # NT=16: 816 tasks
    A = _coll(M, 128)
    w = wave(dpotrf_taskpool(A), max_chunk=256)
    calls = 0
    orig = w._kernel

    def counting(*kargs):
        fn = orig(*kargs)

        def wrapped(*a):
            nonlocal calls
            calls += 1
            return fn(*a)
        return wrapped

    w._kernel = counting
    w.run(device="cpu")
    assert w.nb_tasks == 816
    assert calls < w.nb_tasks / 3, f"{calls} chunk calls for 816 tasks"
    assert w.stats["kernel_calls"] < w.nb_tasks / 3
    np.testing.assert_array_equal(A.to_numpy(),
                                  _interp(dpotrf_taskpool, [M], 128))


@pytest.mark.parametrize("kind", ["potrf", "getrf", "geqrf"])
def test_wave_sets_equal_jax(kind):
    """Same pool, same waves: the count and each wave's ready set equal
    the JAX runner's, and so do the stats' task and wave counts."""
    n, nb = 512, 128
    if kind == "geqrf":
        M = np.random.RandomState(3).rand(n, n).astype(np.float32)
    else:
        M = make_spd(n, dtype=np.float32)
    make, jmake = {"potrf": (dpotrf_taskpool, jdpotrf_taskpool),
                   "getrf": (dgetrf_nopiv_taskpool, jdgetrf_nopiv_taskpool),
                   "geqrf": (dgeqrf_taskpool, jdgeqrf_taskpool)}[kind]
    w = wave(make(_coll(M, nb)))
    jw = jwave(jmake(_coll(M, nb, JTwoDimBlockCyclic)))
    sets, jsets = _frontiers(w), _frontiers(jw)
    w.run(device="cpu")
    jw.run()
    assert sets == jsets and len(sets) == jw.stats["waves"]
    assert w.stats["waves"] == jw.stats["waves"]
    assert w.stats["tasks"] == jw.stats["tasks"]
    assert w.pool_names == jw.pool_names
    assert w._pool_coords == jw._pool_coords


WAR_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]
NT [ type="int" ]

READER(k)

k = 0 .. NT-1

: descB( k, 0 )

READ  X <- descA( 0, 0 )
RW    Y <- descB( k, 0 )
      -> descB( k, 0 )

BODY
{
    Y = X + Y
}
END

WRITER(j)

j = 0 .. 0

: descA( 0, 0 )

RW    Z <- descA( 0, 0 )
      -> descA( 0, 0 )

BODY
{
    Z = Z * 0.0
}
END
"""


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_wave_war_frontier_split(fuse):
    """A frontier holding a reader of a tile and an independent writer of
    the same tile: no in-place scatter clobbers the read, fused (gather
    before scatter) or not (WAR sub-waves)."""
    with params.cmdline_override("wave_fuse", fuse):
        fac = ptg.compile_jdf(WAR_JDF, name="war")
        nt = 4
        descA = TwoDimBlockCyclic(4, 4, 4, 4).from_numpy(
            np.full((4, 4), 7.0, np.float32))
        descB = TwoDimBlockCyclic(4 * nt, 4, 4, 4).from_numpy(
            np.zeros((4 * nt, 4), np.float32))
        w = wave(fac.new(NT=nt, descA=descA, descB=descB))
        w.run(device="cpu")
    assert np.allclose(descB.to_numpy(), 7.0), "reader saw the clobbered tile"
    assert np.allclose(descA.to_numpy(), 0.0)
    assert w.stats["waves"] == 1
    assert w.stats["kernel_calls"] == (1 if fuse == "1" else 2)


def test_wave_new_scratch_flows():
    """NEW scratch sources live in per-class zeroed scratch pools.  The
    body broadcasts the [4] scratch over the [4, 4] tile's rows in a way
    that also holds on a stack of tiles (the port's bodies take a batch
    dimension); the JAX body is the same sum per instance."""
    jdf = """
descA [ type="collection" ]
NT [ type="int" ]

T(k)

k = 0 .. NT-1

: descA( k, 0 )

RW   A <- descA( k, 0 )
     -> descA( k, 0 )
READ S <- NEW  [shape=4 dtype=float32]

BODY
{
    A = A + S + 1.0
}
END
"""
    fac = ptg.compile_jdf(jdf.replace("A + S + 1.0",
                                      "A + S.unsqueeze(-2) + 1.0"),
                          name="newflow")
    descA = TwoDimBlockCyclic(8, 4, 4, 4).from_numpy(
        np.zeros((8, 4), np.float32))
    w = WaveRunner(fac.new(NT=2, descA=descA))
    w.run(device="cpu")
    assert np.allclose(descA.to_numpy(), 1.0)
    assert w.stage_in_bytes == 8 * 4 * 4    # the scratch was not staged
    jdescA = JTwoDimBlockCyclic(8, 4, 4, 4).from_numpy(
        np.zeros((8, 4), np.float32))
    jwave(jptg.compile_jdf(jdf, name="newflow").new(NT=2, descA=jdescA)).run()
    np.testing.assert_array_equal(descA.to_numpy(), jdescA.to_numpy())


def test_chunk_decomposition():
    assert WaveRunner._chunks(0, 256) == []
    assert WaveRunner._chunks(1, 256) == [1]
    assert WaveRunner._chunks(7, 256) == [1, 2, 4]
    assert WaveRunner._chunks(300, 256) == [256, 4, 8, 32]
    assert sum(WaveRunner._chunks(300, 256)) == 300
    assert sum(WaveRunner._chunks(1023, 64)) == 1023


SWAP_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

SWAPA(j)

j = 0 .. 0

: descA( 0, 0 )

READ  X <- descA( 1, 0 )
RW    Z <- descA( 0, 0 )
      -> descA( 0, 0 )

BODY
{
    Z = X
}
END

SWAPB(j)

j = 0 .. 0

: descA( 1, 0 )

READ  X <- descA( 0, 0 )
RW    Z <- descA( 1, 0 )
      -> descA( 1, 0 )

BODY
{
    Z = X
}
END
"""


def test_wave_cyclic_war():
    """Two co-ready tasks each reading the tile the other writes (a
    swap): fused waves gather every input before any scatter, so the
    swap is exact; with fusion disabled the layered in-place scatters
    cannot serve it and it raises."""
    fac = ptg.compile_jdf(SWAP_JDF, name="swap")
    M0 = np.arange(32, dtype=np.float32).reshape(8, 4)
    descA = TwoDimBlockCyclic(8, 4, 4, 4).from_numpy(M0.copy())
    w = wave(fac.new(NT=1, descA=descA))
    assert w._fuse
    w.run(device="cpu")
    np.testing.assert_array_equal(descA.to_numpy(),
                                  np.vstack([M0[4:], M0[:4]]))
    with params.cmdline_override("wave_fuse", "0"):
        descB = TwoDimBlockCyclic(8, 4, 4, 4).from_numpy(M0.copy())
        w2 = wave(fac.new(NT=1, descA=descB))
        assert not w2._fuse
        with pytest.raises(WaveError, match="cyclic"):
            w2.run(device="cpu")


def test_wave_sharding_raises():
    """Sharded pools come with the chip mesh: build_pools(sharding=)
    raises NotImplementedError naming its part of the roadmap."""
    w = wave(dpotrf_taskpool(_coll(make_spd(256), 128)))
    with pytest.raises(NotImplementedError, match="part D2"):
        w.build_pools(device="cpu", sharding=object())


def test_wave_run_without_card_raises(monkeypatch):
    """run() means cuda:0: without a card it raises, and the host runs
    only when the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _coll(make_spd(256), 128)
    w = wave(dpotrf_taskpool(A))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.build_pools()
    w.run(device="cpu")
    assert w.device == torch.device("cpu")


def test_wave_multirank_raises():
    """A multi-rank pool goes to the distributed runner, which raises
    without a comm engine; the single-rank runner refuses it."""
    M = make_spd(256)
    A = TwoDimBlockCyclic(256, 256, 128, 128, P=2,
                          dtype=np.float32).from_numpy(M)
    with pytest.raises(WaveError, match="comm engine"):
        wave(dpotrf_taskpool(A, rank=0, nb_ranks=2))
    with pytest.raises(WaveError, match="single-rank wave"):
        WaveRunner(dpotrf_taskpool(A, rank=0, nb_ranks=2))


def test_wave_reshape_properties_masked_writeback():
    """[type_data=lower] in/out: the body sees the masked read, the
    writeback preserves the upper region (through data/reshape.py)."""
    jdf = """
descA [ type="collection" ]

T(k)

k = 0 .. 0

: descA( 0, 0 )

RW   A <- descA( 0, 0 )    [type_data=lower]
     -> descA( 0, 0 )      [type_data=lower]

BODY
{
    A = A * 2.0
}
END
"""
    base = np.arange(16, dtype=np.float32).reshape(4, 4) + 1.0
    descA = TwoDimBlockCyclic(4, 4, 4, 4).from_numpy(base.copy())
    WaveRunner(ptg.compile_jdf(jdf, name="reshapey").new(
        descA=descA)).run(device="cpu")
    expect = np.where(np.tril(np.ones((4, 4), bool)), 2.0 * base, base)
    np.testing.assert_array_equal(descA.to_numpy(), expect)
    jdescA = JTwoDimBlockCyclic(4, 4, 4, 4).from_numpy(base.copy())
    jptg.wave(jptg.compile_jdf(jdf, name="reshapey").new(descA=jdescA)).run()
    np.testing.assert_array_equal(descA.to_numpy(), jdescA.to_numpy())


def test_wave_rejects_waw_frontier():
    """Two co-ready writers of one tile (a racy DAG) raise."""
    jdf = """
descA [ type="collection" ]

W1(k)

k = 0 .. 0

: descA( 0, 0 )

RW   A <- descA( 0, 0 )
     -> descA( 0, 0 )

BODY
{
    A = A + 1.0
}
END

W2(k)

k = 0 .. 0

: descA( 0, 0 )

RW   A <- descA( 0, 0 )
     -> descA( 0, 0 )

BODY
{
    A = A + 2.0
}
END
"""
    descA = TwoDimBlockCyclic(4, 4, 4, 4).from_numpy(
        np.zeros((4, 4), np.float32))
    w = wave(ptg.compile_jdf(jdf, name="waw").new(descA=descA))
    with pytest.raises(WaveError, match="two writers"):
        w.run(device="cpu")


def test_wave_body_without_batch_dimension_raises():
    """A body that drops the leading batch dimension is named, not
    silently broadcast into the pool."""
    jdf = """
descA [ type="collection" ]
NT [ type="int" ]

T(k)
k = 0 .. NT-1
: descA( k, 0 )
RW A <- descA( k, 0 )
     -> descA( k, 0 )
BODY
{
    A = A[0]
}
END
"""
    descA = TwoDimBlockCyclic(8, 4, 4, 4).from_numpy(
        np.zeros((8, 4), np.float32))
    w = wave(ptg.compile_jdf(jdf, name="flat").new(NT=2, descA=descA))
    with pytest.raises(WaveError, match="leading batch dimension"):
        w.run(device="cpu")


def test_wave_body_branching_on_data_raises():
    """A body marked ``batch=stacked`` that branches in Python on a
    tile's values cannot run on a stack of tiles: named as a WaveError,
    not a bare torch error.  Unmarked, the same body keeps single-tile
    semantics and runs per task."""
    jdf = """
descA [ type="collection" ]
NT [ type="int" ]

T(k)
k = 0 .. NT-1
: descA( k, 0 )
RW A <- descA( k, 0 )
     -> descA( k, 0 )
BODY%s
{
    A = A * 2.0 if A[0, 0] > 0 else A
}
END
"""
    descA = TwoDimBlockCyclic(8, 4, 4, 4).from_numpy(
        np.ones((8, 4), np.float32))
    w = wave(ptg.compile_jdf(jdf % " [batch=stacked]", name="branchy")
             .new(NT=2, descA=descA))
    with pytest.raises(WaveError, match="cannot run on a batch"):
        w.run(device="cpu")
    w = wave(ptg.compile_jdf(jdf % "", name="branchy1")
             .new(NT=2, descA=descA))
    w.run(device="cpu")
    np.testing.assert_array_equal(descA.to_numpy(),
                                  np.full((8, 4), 2.0, np.float32))


def test_wave_stats():
    """execute() leaves the runner's counters, with the JAX names."""
    M = make_spd(512, dtype=np.float32)
    w = wave(dpotrf_taskpool(_coll(M, 128)))
    w.run(device="cpu")
    s = w.stats
    assert set(s) == {"tasks", "waves", "kernel_calls", "dispatch_secs",
                      "compiled_kernels"}
    assert s["tasks"] == 20 and s["waves"] > 1
    assert 0 < s["kernel_calls"] < s["tasks"]
    assert s["dispatch_secs"] > 0 and s["compiled_kernels"] > 0
    assert w.stage_in_bytes == 512 * 512 * 4


# --------------------------------------------------------------------- #
# ragged tilings: shape-split pools (interior/edge/corner stacks, exact  #
# tile shapes — the reference's lm%mb edge-tile contract)               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,nb", [(1000, 128), (520, 128), (136, 64)])
def test_wave_dpotrf_ragged(n, nb):
    M = make_spd(n, dtype=np.float32)
    A = _coll(M, nb)
    w = wave(dpotrf_taskpool(A), max_chunk=64)
    assert len(w.pool_names) > len(w.coll_names)
    assert all(tuple(np.asarray(A.tile_shape(*c))) ==
               tuple(w._pool_shapes[pid])
               for pid in range(len(w.pool_names))
               for c in w._pool_coords[pid])
    w.run(device="cpu")
    out = A.to_numpy()
    L = np.tril(out).astype(np.float64)
    assert np.allclose(L, np.linalg.cholesky(M.astype(np.float64)),
                       atol=1e-3)
    np.testing.assert_array_equal(out, _interp(dpotrf_taskpool, [M], nb))
    if n == 520:
        jout, _ = _jax_wave(jdpotrf_taskpool, [M], nb, 64)
        np.testing.assert_allclose(out, jout, atol=JATOL)


def test_wave_dgetrf_ragged():
    n, nb = 840, 128        # 840 = 6*128 + 72: bottom/right/corner pools
    M = make_spd(n, dtype=np.float32)
    out, _ = _port_wave(dgetrf_nopiv_taskpool, [M], nb, max_chunk=32)
    LU = out.astype(np.float64)
    L = np.tril(LU, -1) + np.eye(n)
    U = np.triu(LU)
    assert np.abs(L @ U - M).max() / np.abs(M).max() < 1e-5
    np.testing.assert_array_equal(out,
                                  _interp(dgetrf_nopiv_taskpool, [M], nb))


def test_wave_pdgemm_ragged():
    n, nb = 600, 128        # 600 = 4*128 + 88
    rng = np.random.RandomState(7)
    mats = [rng.rand(n, n).astype(np.float32),
            rng.rand(n, n).astype(np.float32), np.zeros((n, n), np.float32)]
    out, _ = _port_wave(pdgemm_taskpool, mats, nb, max_chunk=16)
    ref = mats[0].astype(np.float64) @ mats[1].astype(np.float64)
    assert np.abs(out.astype(np.float64) - ref).max() / n < 1e-6
    _check(pdgemm_taskpool, jpdgemm_taskpool, mats, nb, out, 16)


def test_synth_pools_parity_and_subset_coords():
    """On-device pool synthesis (no host staging): the whole-pool function
    and the per-tile one give build_pools' layout and values, and a
    SUBSET coordinate set is not scattered onto row 0."""
    n, nb = 128, 32
    nt = n // nb
    g = torch.Generator().manual_seed(23)
    low = {(m, k): torch.rand(nb, nb, generator=g)
           for m in range(nt) for k in range(m + 1)}

    def tile_fn(_name, c):
        return low[c] if c in low else torch.zeros(nb, nb)

    def pool_fn(_name, coords):
        return torch.stack([tile_fn(_name, c) for c in coords])

    M = np.zeros((n, n), np.float32)
    for (m, k), t in low.items():
        M[m * nb:(m + 1) * nb, k * nb:(k + 1) * nb] = t.numpy()
    w = wave(dpotrf_taskpool(_coll(M, nb)))
    by_pool = w.synth_pools(pool_fn=pool_fn, device="cpu")
    by_tile = w.synth_pools(tile_fn, device="cpu")
    staged = w.build_pools(device="cpu")
    assert len(by_pool) == len(by_tile) == len(staged)
    for a, b, c in zip(by_pool, by_tile, staged):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    coords = [(m, k) for m in range(nt) for k in range(m + 1)]
    sub = pool_fn("descA", coords)
    for i, c in enumerate(coords):
        torch.testing.assert_close(sub[i], low[c], rtol=0, atol=0)
    with pytest.raises(ValueError, match="exactly one"):
        w.synth_pools(device="cpu")


def test_ptg_exports():
    mod = sys.modules["parsec_tpu_torch.dsl.ptg"]
    for name in ("lower", "LoweredDAG", "wave", "WaveRunner", "WaveError"):
        assert name in mod.__all__ and hasattr(mod, name)


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["potrf", "geqrf"])
def test_wave_on_card(kind):
    """wave().run() on cuda:0 at nb = 128: pools on the card, the GEMM
    kernel launched, bit-identical to the interpreted path there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GEMM kernel has no CPU mode")
    from parsec_tpu_torch.ops import kernels
    n, nb = 512, 128
    if kind == "potrf":
        M, make = make_spd(n), dpotrf_taskpool
    else:
        M = np.random.RandomState(3).rand(n, n).astype(np.float32)
        make = dgeqrf_taskpool
    A = _coll(M, nb)
    w = wave(make(A))
    kernels.matmul_launches = 0
    w.run()
    assert w.device == torch.device("cuda", 0)
    assert kernels.matmul_launches > 0
    ctx = parsec_tpu_torch.init(nb_cores=2)
    try:
        R = _coll(M, nb)
        ctx.add_taskpool(make(R))
        ctx.wait()
        np.testing.assert_array_equal(A.to_numpy(), R.to_numpy())
    finally:
        ctx.fini()
