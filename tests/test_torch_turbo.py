"""Turbo per-task dispatch in the port (parsec_tpu_torch/dsl/ptg/turbo.py),
held against the JAX package's turbo on the same seeded inputs.

The cases of tests/test_turbo.py on ``init(device="cpu")`` (the port's
CUDA device module over host tensors, each kernel's plain version): the
native C priority-heap loop, precompiled slot binding, one body call per
task, lazy device-resident writebacks.  Each result is checked against
numpy (atol 1e-3, as there) and against the JAX package's turbo result
(5e-4); inside the port the turbo factor is bit-identical to the classic
static path and to the hash mode.  The ``gpu`` cases run on the card.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import parsec_tpu
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.dsl import ptg as jptg
from parsec_tpu.ops import (dgeqrf_taskpool as jdgeqrf_taskpool,
                            dgetrf_nopiv_taskpool as jdgetrf_nopiv_taskpool,
                            dpotrf_taskpool as jdpotrf_taskpool,
                            pdgemm_taskpool as jpdgemm_taskpool)
from parsec_tpu.utils.params import params as jparams

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.ptg.turbo import LazyPoolCopy
from parsec_tpu_torch.dsl.ptg.wave import WaveError
from parsec_tpu_torch.ops import (dgeqrf_taskpool, dgetrf_nopiv_taskpool,
                                  dpotrf_taskpool, make_spd, pdgemm_taskpool)
from parsec_tpu_torch.utils.params import params

JATOL = 5e-4    # port against the JAX package, fp32


@pytest.fixture
def static_ctx():
    with params.cmdline_override("ptg_dep_management", "static"):
        ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
        try:
            yield ctx
        finally:
            ctx.fini()


def _coll(M, nb, cls=TwoDimBlockCyclic):
    return cls(M.shape[0], M.shape[1], nb, nb,
               dtype=np.float32).from_numpy(M)


def _jax_turbo(make, mats, nb):
    """The JAX package's turbo on the same inputs; returns the last
    collection as an array."""
    with jparams.cmdline_override("ptg_dep_management", "static"):
        ctx = parsec_tpu.init(nb_cores=2)
        try:
            colls = [_coll(M, nb, JTwoDimBlockCyclic) for M in mats]
            tp = make(*colls)
            ctx.add_taskpool(tp)
            ctx.wait()
            assert tp._turbo is not None
            return colls[-1].to_numpy()
        finally:
            ctx.fini()


def _port_mode(make, mats, nb, mode, dispatch="auto"):
    """The port on its own CPU context in one mode; returns the last
    collection as an array and the taskpool."""
    with params.cmdline_override("ptg_dep_management", mode), \
            params.cmdline_override("ptg_dispatch", dispatch):
        ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
        try:
            colls = [_coll(M, nb) for M in mats]
            tp = make(*colls)
            ctx.add_taskpool(tp)
            ctx.wait()
            return colls[-1].to_numpy(), tp
        finally:
            ctx.fini()


def _same_in_port(make, mats, nb, out):
    """The turbo result is bit-identical to the classic static path and
    to the hash mode."""
    classic, tp = _port_mode(make, mats, nb, "static", "classic")
    assert tp._turbo is None and tp._engine is not None
    np.testing.assert_array_equal(out, classic)
    np.testing.assert_array_equal(out, _port_mode(make, mats, nb, "hash")[0])


def test_turbo_dpotrf_matches_numpy(static_ctx):
    n, nb = 512, 128
    M = make_spd(n, dtype=np.float32)
    A = _coll(M, nb)
    tp = dpotrf_taskpool(A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    assert tp._turbo is not None, "turbo did not engage on a static pool"
    assert tp._turbo.stats["tasks"] == 20
    assert tp._turbo.stats["kernel_calls"] == 20   # per-task dispatch
    assert tp._turbo.stats["native_loop"]
    dev = static_ctx.device_by_type("cuda")
    assert dev.stats["tasks"] == dev.executed_tasks == 20
    out = A.to_numpy()
    L = np.tril(out).astype(np.float64)
    assert np.allclose(L, np.linalg.cholesky(M.astype(np.float64)),
                       atol=1e-3)
    np.testing.assert_allclose(
        np.tril(out), np.tril(_jax_turbo(jdpotrf_taskpool, [M], nb)),
        atol=JATOL)
    _same_in_port(dpotrf_taskpool, [M], nb, out)


def test_turbo_dgetrf_ragged(static_ctx):
    """LU over a ragged tiling: turbo inherits shape-split pools."""
    n, nb = 200, 64
    M = make_spd(n, dtype=np.float32)
    A = _coll(M, nb)
    tp = dgetrf_nopiv_taskpool(A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    assert tp._turbo is not None
    assert len(tp._turbo.pool_names) > 1
    LU = A.to_numpy()
    L = np.tril(LU.astype(np.float64), -1) + np.eye(n)
    U = np.triu(LU.astype(np.float64))
    assert np.abs(L @ U - M).max() / np.abs(M).max() < 1e-5
    np.testing.assert_allclose(
        LU, _jax_turbo(jdgetrf_nopiv_taskpool, [M], nb), atol=JATOL)
    _same_in_port(dgetrf_nopiv_taskpool, [M], nb, LU)


def test_turbo_pdgemm_static_body_locals(static_ctx):
    """pdgemm's GEMM body branches on local k in Python: per-task specs
    carry it as a static."""
    n, nb = 256, 64
    rng = np.random.RandomState(5)
    Am = rng.rand(n, n).astype(np.float32)
    Bm = rng.rand(n, n).astype(np.float32)
    Cm = np.zeros((n, n), np.float32)
    A, B, C = _coll(Am, nb), _coll(Bm, nb), _coll(Cm, nb)
    tp = pdgemm_taskpool(A, B, C)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    assert tp._turbo is not None
    gemm = next(p for p in tp._turbo.plans if p.ast.name == "GEMM")
    assert gemm.body_locals, "k should be a static body local"
    out = C.to_numpy()
    ref = Am.astype(np.float64) @ Bm.astype(np.float64)
    assert np.abs(out.astype(np.float64) - ref).max() / n < 1e-6
    np.testing.assert_allclose(
        out, _jax_turbo(jpdgemm_taskpool, [Am, Bm, Cm], nb),
        atol=JATOL, rtol=1e-6)
    _same_in_port(pdgemm_taskpool, [Am, Bm, Cm], nb, out)


def test_turbo_lazy_writeback_single_tile_pull(static_ctx):
    """Results stay device-resident; reading ONE tile takes exactly one
    pool row."""
    n, nb = 512, 128
    M = make_spd(n, dtype=np.float32)
    A = _coll(M, nb)
    tp = dpotrf_taskpool(A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    didx = static_ctx.device_by_type("cuda").device_index
    lazies = [A.data_of(*c).get_copy(didx) for c in A.tiles()]
    lazies = [c for c in lazies if isinstance(c, LazyPoolCopy)]
    # one per tile some task writes: the lower triangle's 10 of 16
    assert len(lazies) == 10, "no lazy device copies attached"
    assert not any(c._mat for c in lazies), "writeback was eager"
    A.data_of(1, 0).sync_to_host()
    assert sum(c._mat for c in lazies) == 1, \
        "one host read materialized more than one tile"
    # the tile read is the pool's row: a view, not a copy
    row = A.data_of(1, 0).get_copy(didx).payload
    assert row._base is not None and tuple(row.shape) == (nb, nb)


def test_turbo_body_error_aborts(static_ctx):
    jdf = """
descA [ type="collection" ]
NT [ type="int" ]

Boom(k)
k = 0 .. NT-1
: descA( k, 0 )
RW X <- descA( k, 0 )
     -> descA( k, 0 )
BODY
{
    X = X / torch.zeros_like(X)[0, 0]
    raise_check = [][0]
}
END
"""
    fac = ptg.compile_jdf(jdf, name="boom")
    A = TwoDimBlockCyclic(8, 4, 4, 4, dtype=np.float32).from_numpy(
        np.ones((8, 4), np.float32))
    tp = fac.new(NT=2, descA=A)
    static_ctx.add_taskpool(tp)
    with pytest.raises(RuntimeError, match="task body failed") as ei:
        static_ctx.wait()
    assert isinstance(ei.value.__cause__, IndexError)
    assert tp._turbo is not None


def test_turbo_kernel_cache_survives_taskpool(static_ctx):
    """A second taskpool with the same signature reuses the lowered DAG
    AND its pre-bound entries."""
    n, nb = 512, 128
    M = make_spd(n, dtype=np.float32)
    tps = []
    for _ in range(2):
        A = _coll(M, nb)
        tp = dpotrf_taskpool(A)
        static_ctx.add_taskpool(tp)
        static_ctx.wait()
        tps.append(tp)
    assert tps[0]._turbo.dag is tps[1]._turbo.dag, "lowering cache miss"
    assert tps[1]._turbo._entries is tps[0]._turbo._entries, \
        "turbo entries rebuilt for an identical signature"


def test_turbo_off_by_param(static_ctx):
    with params.cmdline_override("ptg_dispatch", "classic"):
        n, nb = 256, 128
        M = make_spd(n, dtype=np.float32)
        A = _coll(M, nb)
        tp = dpotrf_taskpool(A)
        static_ctx.add_taskpool(tp)
        static_ctx.wait()
        assert tp._turbo is None        # classic static path served it
        assert tp._engine is not None
        L = np.tril(A.to_numpy()).astype(np.float64)
        assert np.allclose(L, np.linalg.cholesky(M.astype(np.float64)),
                           atol=1e-3)


WAR_JDF = """
descA [ type="collection" ]

P(j)
j = 0 .. 0
: descA( 0, 0 )
RW X <- descA( 0, 0 )
     -> A R( 0 )
     -> B W( 0 )
     -> descA( 0, 0 )
BODY
{
    X = X + 1.0
}
END

R(j)
j = 0 .. 0
: descA( 1, 0 )
READ A <- X P( 0 )
RW   O <- descA( 1, 0 )
     -> descA( 1, 0 )
BODY
{
    O = A * 10.0
}
END

W(j)
j = 0 .. 0
: descA( 0, 0 )
RW B <- X P( 0 )
     -> descA( 0, 0 )
; 1000
BODY
{
    B = B + 100.0
}
END
"""


def test_turbo_war_ordering(static_ctx):
    """Reader R and in-place writer W of the same slot, both ready after
    P, with W's priority HIGHER: the augmented CSR orders R before W."""
    fac = ptg.compile_jdf(WAR_JDF, name="warj")
    M0 = np.full((8, 4), 5.0, np.float32)
    A = TwoDimBlockCyclic(8, 4, 4, 4, dtype=np.float32).from_numpy(
        M0.copy())
    tp = fac.new(descA=A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    assert tp._turbo is not None
    out = A.to_numpy()
    np.testing.assert_allclose(out[:4], 5.0 + 1.0 + 100.0)  # P then W
    np.testing.assert_allclose(out[4:], (5.0 + 1.0) * 10.0)  # R saw P's X
    jfac = jptg.compile_jdf(WAR_JDF, name="warj")
    np.testing.assert_array_equal(out, _jax_turbo(
        lambda A: jfac.new(descA=A), [M0], 4))


def test_turbo_cached_kernels_do_not_pin_runner(static_ctx):
    """The DAG-level cache outlives taskpools: its closures must not keep
    the runner (and its device pools) alive after the taskpool and
    collection are gone."""
    n, nb = 256, 128
    M = make_spd(n, dtype=np.float32)
    A = _coll(M, nb)
    tp = dpotrf_taskpool(A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    ref = weakref.ref(tp._turbo)
    del tp, A
    gc.collect()
    assert ref() is None, ("turbo runner (and its pools) pinned after the "
                           "taskpool died — a cached closure captured it")


SWAP_JDF = """
descA [ type="collection" ]

SA(j)
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

SB(j)
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


def test_turbo_cyclic_war_falls_back_to_classic(static_ctx):
    """A co-ready swap (cyclic WAR) is unservable by per-task in-place
    writes: TurboRunner refuses at build and ``auto`` takes the classic
    static path; the run completes with one of the classic
    serializations."""
    fac = ptg.compile_jdf(SWAP_JDF, name="swapt")
    M0 = np.arange(32, dtype=np.float32).reshape(8, 4)
    A = TwoDimBlockCyclic(8, 4, 4, 4, dtype=np.float32).from_numpy(
        M0.copy())
    tp = fac.new(descA=A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    assert tp._turbo is None, "turbo must refuse a cyclic-WAR DAG"
    assert tp._engine is not None
    out = A.to_numpy()
    half = np.vstack([M0[4:], M0[:4]])
    assert np.array_equal(out, half) or \
        np.array_equal(out[:4], M0[4:]) or \
        np.array_equal(out[4:], M0[:4]), out


def test_turbo_demanded_on_ineligible_pool_raises(static_ctx):
    """ptg_dispatch=turbo on the cyclic-WAR pool raises instead of
    taking the classic path."""
    fac = ptg.compile_jdf(SWAP_JDF, name="swapt")
    A = TwoDimBlockCyclic(8, 4, 4, 4, dtype=np.float32).from_numpy(
        np.zeros((8, 4), np.float32))
    tp = fac.new(descA=A)
    with params.cmdline_override("ptg_dispatch", "turbo"):
        with pytest.raises(WaveError, match="cyclic"):
            tp.startup_hook(static_ctx, tp)


def test_turbo_demanded_without_device_module_raises():
    """ptg_dispatch=turbo on a host-only context (no CUDA device module)
    raises; auto takes the classic static path there."""
    fac = ptg.compile_jdf("""
descA [ type="collection" ]
NT [ type="int" ]

T(k)
k = 0 .. NT-1
: descA( k, 0 )
RW A <- descA( k, 0 )
     -> descA( k, 0 )
BODY
{
    A *= 2.0
}
END
""", name="double")
    with params.cmdline_override("device_cuda_enabled", "0"), \
            params.cmdline_override("ptg_dep_management", "static"):
        ctx = parsec_tpu_torch.init(nb_cores=1)
        try:
            assert not [d for d in ctx.devices if d.device_type == "cuda"]
            A = TwoDimBlockCyclic(8, 4, 4, 4, dtype=np.float32).from_numpy(
                np.ones((8, 4), np.float32))
            tp = fac.new(NT=2, descA=A)
            with params.cmdline_override("ptg_dispatch", "turbo"):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    tp.startup_hook(ctx, tp)
            tp = fac.new(NT=2, descA=A)
            ctx.add_taskpool(tp)
            ctx.wait()
            assert tp._turbo is None and tp._engine is not None
            np.testing.assert_array_equal(A.to_numpy(), 2.0)
        finally:
            ctx.fini()


def test_turbo_dgeqrf_scratch_and_rename(static_ctx):
    """QR exercises NEW scratch pools (Q factors) and rename slots under
    per-task priority order — the WAR/WAW edge machinery's hardest
    customer. R's diagonal matches numpy's up to sign."""
    n, nb = 256, 64
    rng = np.random.RandomState(3)
    M = rng.rand(n, n).astype(np.float32)
    A = _coll(M, nb)
    tp = dgeqrf_taskpool(A)
    static_ctx.add_taskpool(tp)
    static_ctx.wait()
    runner = tp._turbo
    assert runner is not None
    assert runner._scratch, "no scratch pools for the NEW flows"
    out = A.to_numpy()
    R = np.triu(out)
    Rref = np.linalg.qr(M.astype(np.float64), mode="r")
    np.testing.assert_allclose(np.abs(np.diag(R)), np.abs(np.diag(Rref)),
                               rtol=1e-3)
    np.testing.assert_allclose(
        R, np.triu(_jax_turbo(jdgeqrf_taskpool, [M], nb)), atol=JATOL)
    _same_in_port(dgeqrf_taskpool, [M], nb, out)


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["potrf", "geqrf"])
def test_turbo_on_card(kind):
    """Turbo on cuda:0 at nb = 128: every GEMM-kernel task one launch,
    lazy results on the card, bit-identical to the hash mode there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GEMM kernel has no CPU mode")
    from parsec_tpu_torch.ops import kernels
    n, nb = 512, 128
    if kind == "potrf":
        M, make = make_spd(n), dpotrf_taskpool
    else:
        M = np.random.RandomState(3).rand(n, n).astype(np.float32)
        make = dgeqrf_taskpool

    def run(mode):
        with params.cmdline_override("ptg_dep_management", mode):
            ctx = parsec_tpu_torch.init(nb_cores=2)
            try:
                A = _coll(M, nb)
                tp = make(A)
                ctx.add_taskpool(tp)
                ctx.wait()
                dev = ctx.device_by_type("cuda")
                assert dev.name == "cuda:0" and dev.stats["tasks"] > 0
                return A.to_numpy(), tp
            finally:
                ctx.fini()

    kernels.matmul_launches = 0
    out, tp = run("static")
    assert tp._turbo is not None
    assert tp._turbo.pools[0].device.type == "cuda"
    gemm_tasks = {"potrf": 10, "geqrf": 20}[kind]
    assert kernels.matmul_launches == gemm_tasks
    np.testing.assert_array_equal(out, run("hash")[0])
