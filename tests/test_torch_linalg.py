"""The port's DPLASMA family (parsec_tpu_torch.ops) against the JAX
package's: dposv and the triangular solves, dgetrf_nopiv, dgeqrf,
pdgemm, the pivoted dgetrf and the inverses.

Both packages take the same seeded numpy input, with the shapes and
tolerances of tests/test_linalg_factorizations.py.  The port runs its
CUDA device module over host tensors (``init(device="cpu")``), so the real
stage-in, batching and epilog code runs with each kernel's plain version;
the whole-matrix routines take ``device="cpu"``.  The ``gpu``-marked tests
run the same routines on a card against the CPU and skip where there is
none.
"""
import numpy as np
import pytest
import scipy.linalg
import torch

from parsec_tpu import ops as jops
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic

import parsec_tpu_torch
from parsec_tpu_torch import ops
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.utils.params import params


@pytest.fixture
def tctx():
    c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    yield c
    c.fini()


def _f64(x):
    return np.asarray(x, dtype=np.float64)


def _uniform(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) - 0.5).astype(np.float32)


def _jax_run(ctx, tp):
    ctx.add_taskpool(tp)
    ctx.wait()
    assert tp.completed


def _run(ctx, tp):
    """Run a port taskpool and check that every task of a class with a
    CUDA body ran on the device module."""
    dev = ctx.device_by_type("cuda")
    before = dev.stats["tasks"]
    ctx.add_taskpool(tp)
    ctx.wait()
    assert tp.completed
    assert dev.stats["tasks"] - before == _device_tasks(tp)


def _device_tasks(tp):
    return sum(sum(1 for _ in tc.iter_space()) for tc in tp.task_classes
               if any(c.device_type == "cuda" for c in tc.incarnations))


def _pair(shape_src, nb, M):
    """The same matrix in a JAX and a port collection."""
    m, n = shape_src
    return (JTwoDimBlockCyclic(m, n, nb, nb, dtype=np.float32).from_numpy(M),
            TwoDimBlockCyclic(m, n, nb, nb, dtype=np.float32).from_numpy(M))


# ---------------------------------------------------------------------- #
# triangular solves + dposv                                              #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n,nrhs,nb", [(96, 32, 32), (64, 64, 64),
                                       (128, 96, 32)])
def test_dposv_matches_jax(ctx, tctx, n, nrhs, nb):
    M = ops.make_spd(n)
    Bm = _uniform(1, n, nrhs)
    jA, A = _pair((n, n), nb, M)
    jB, B = _pair((n, nrhs), nb, Bm)
    jops.dposv(ctx, jA, jB)
    dev = tctx.device_by_type("cuda")
    ops.dposv(tctx, A, B)
    mt, nt = A.mt, B.nt
    solve = mt * nt + mt * (mt - 1) // 2 * nt
    dpotrf = mt * (mt + 1) * (mt + 2) // 6
    assert dev.stats["tasks"] == dev.executed_tasks == dpotrf + 2 * solve
    X = B.to_numpy()
    np.testing.assert_allclose(X, jB.to_numpy(), atol=5e-3)
    np.testing.assert_allclose(X, np.linalg.solve(_f64(M), _f64(Bm)),
                               atol=5e-3)


def _lower(seed, n):
    rng = np.random.RandomState(seed)
    return (np.tril(rng.rand(n, n).astype(np.float32))
            + 4 * np.eye(n, dtype=np.float32)), rng


@pytest.mark.parametrize("trans", [False, True])
def test_dtrsm_matches_jax_and_scipy(ctx, tctx, trans):
    """Forward (L Y = B) and backward (L^T X = B) substitution."""
    Lm, rng = _lower(3 if trans else 2, 96)
    Bm = (rng.rand(96, 32 if trans else 64) - 0.5).astype(np.float32)
    jL, L = _pair((96, 96), 32, Lm)
    jB, B = _pair(Bm.shape, 32, Bm)
    jfn = jops.dtrsm_lower_trans_taskpool if trans else jops.dtrsm_lower_taskpool
    fn = ops.dtrsm_lower_trans_taskpool if trans else ops.dtrsm_lower_taskpool
    _jax_run(ctx, jfn(jL, jB))
    _run(tctx, fn(L, B))
    ref = scipy.linalg.solve_triangular(_f64(Lm), _f64(Bm), lower=True,
                                        trans="T" if trans else "N")
    np.testing.assert_allclose(B.to_numpy(), ref, atol=2e-3)
    np.testing.assert_allclose(B.to_numpy(), jB.to_numpy(), atol=2e-3)


def test_dtrsm_shape_mismatch():
    with pytest.raises(ValueError):
        ops.dtrsm_lower_taskpool(TwoDimBlockCyclic(64, 96, 32, 32),
                                 TwoDimBlockCyclic(64, 32, 32, 32))


# ---------------------------------------------------------------------- #
# LU without pivoting                                                    #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("m,n,nb", [(96, 96, 32), (64, 64, 64),
                                    (100, 100, 32)])
def test_dgetrf_nopiv_matches_jax(ctx, tctx, m, n, nb):
    M = ops.make_diag_dominant(m, n)
    np.testing.assert_array_equal(M, jops.make_diag_dominant(m, n))
    jA, A = _pair((m, n), nb, M)
    _jax_run(ctx, jops.dgetrf_nopiv_taskpool(jA))
    _run(tctx, ops.dgetrf_nopiv_taskpool(A))
    out = A.to_numpy()
    np.testing.assert_allclose(out, jA.to_numpy(), atol=5e-3)
    L = np.tril(_f64(out), -1) + np.eye(m, n)
    np.testing.assert_allclose(L @ np.triu(_f64(out)), M, atol=5e-3)


def test_dgetrf_nopiv_single_tile_matches_scipy(tctx):
    M = ops.make_diag_dominant(40)
    A = TwoDimBlockCyclic(40, 40, 40, 40).from_numpy(M)
    _run(tctx, ops.dgetrf_nopiv_taskpool(A))
    out = _f64(A.to_numpy())
    # diagonally dominant => scipy's pivoted LU does not permute
    P, L, U = scipy.linalg.lu(_f64(M))
    np.testing.assert_allclose(P, np.eye(40))
    np.testing.assert_allclose(np.tril(out, -1), np.tril(L, -1), atol=1e-3)
    np.testing.assert_allclose(np.triu(out), U, atol=1e-3)


def test_dgetrf_nopiv_batched_dispatch_bit_exact():
    """Stacked batched dispatch is bit-exact against per-task dispatch."""
    M = ops.make_diag_dominant(128, 128)

    def run(batch_max):
        with params.cmdline_override("device_batch_max", str(batch_max)):
            c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
            try:
                A = TwoDimBlockCyclic(128, 128, 32, 32).from_numpy(M.copy())
                _run(c, ops.dgetrf_nopiv_taskpool(A))
                return A.to_numpy(), c.device_by_type("cuda").stats
            finally:
                c.fini()

    (single, s1), (batched, s16) = run(1), run(16)
    assert s1["batches"] == 0 and s16["batches"] > 0
    np.testing.assert_array_equal(batched, single)


def test_dgetrf_rejects_nonsquare_diag_tiles():
    with pytest.raises(ValueError):
        ops.dgetrf_nopiv_taskpool(TwoDimBlockCyclic(100, 90, 32, 32))
    with pytest.raises(ValueError):
        ops.dgetrf_nopiv_taskpool(TwoDimBlockCyclic(64, 64, 32, 16))


# ---------------------------------------------------------------------- #
# QR                                                                     #
# ---------------------------------------------------------------------- #
def _sign_normalised(R):
    """R with each row scaled by the sign of its diagonal entry (the
    factorization is unique up to those signs)."""
    k = min(R.shape)
    R = _f64(R).copy()
    R[:k] *= np.where(np.diag(R) < 0, -1.0, 1.0)[:, None]
    return R


@pytest.mark.parametrize("m,n,nb", [(96, 96, 32), (64, 64, 64),
                                    (128, 64, 32), (96, 128, 32),
                                    (100, 100, 32)])
def test_dgeqrf_matches_jax(ctx, tctx, m, n, nb):
    """R^T R == A^T A, R == the JAX package's R up to row signs, and the
    tiles below the diagonal zeroed (ragged edges in the (100, 32) case)."""
    M = _uniform(7, m, n)
    jA, A = _pair((m, n), nb, M)
    _jax_run(ctx, jops.dgeqrf_taskpool(jA))
    _run(tctx, ops.dgeqrf_taskpool(A))
    out = A.to_numpy()
    R = np.triu(out)
    np.testing.assert_allclose(R.T @ _f64(R), _f64(M).T @ _f64(M), atol=2e-3)
    np.testing.assert_allclose(_sign_normalised(R),
                               _sign_normalised(np.triu(jA.to_numpy())),
                               atol=2e-3)
    for (i, j) in A.tiles():
        if i > j:
            np.testing.assert_allclose(A.tile(i, j), 0.0, atol=1e-5)


def test_dgeqrf_residual_gate(tctx):
    """The JAX package's strict relative residual bound at 256 / 64."""
    n, nb = 256, 64
    M = np.random.RandomState(7).rand(n, n).astype(np.float32)
    A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    _run(tctx, ops.dgeqrf_taskpool(A))
    R = np.triu(_f64(A.to_numpy()))
    G = _f64(M).T @ _f64(M)
    assert np.abs(R.T @ R - G).max() / np.abs(G).max() < 1e-5


def test_dgeqrf_single_tile_matches_numpy(tctx):
    M = _uniform(11, 48, 48)
    A = TwoDimBlockCyclic(48, 48, 48, 48).from_numpy(M)
    _run(tctx, ops.dgeqrf_taskpool(A))
    np.testing.assert_allclose(np.abs(np.triu(A.to_numpy())),
                               np.abs(np.linalg.qr(_f64(M))[1]), atol=2e-3)


def test_dgeqrf_rejects_nonsquare_diag_tiles():
    with pytest.raises(ValueError):
        ops.dgeqrf_taskpool(TwoDimBlockCyclic(100, 90, 32, 32))
    with pytest.raises(ValueError):
        ops.dgeqrf_taskpool(TwoDimBlockCyclic(64, 64, 32, 16))


# ---------------------------------------------------------------------- #
# GEMM                                                                   #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("transa,transb,m,n,k,nb,alpha,beta", [
    ("n", "n", 96, 64, 128, 32, 2.0, -1.0),
    ("n", "n", 64, 64, 64, 64, 2.0, -1.0),
    ("n", "n", 100, 60, 84, 32, 2.0, -1.0),
    ("t", "n", 96, 64, 80, 16, 1.5, 0.5), ("n", "t", 96, 64, 80, 16, 1.5, 0.5),
    ("t", "t", 96, 64, 80, 16, 1.5, 0.5),
    # ragged edge tiles under transposition
    ("t", "n", 100, 60, 84, 32, 1.5, 0.5),
    ("n", "t", 100, 60, 84, 32, 1.5, 0.5),
    ("t", "t", 100, 60, 84, 32, 1.5, 0.5)])
def test_pdgemm_matches_jax(ctx, tctx, transa, transb, m, n, k, nb, alpha,
                            beta):
    rng = np.random.RandomState(6)
    Am = (rng.rand(*((k, m) if transa == "t" else (m, k))) - 0.5).astype(
        np.float32)
    Bm = (rng.rand(*((n, k) if transb == "t" else (k, n))) - 0.5).astype(
        np.float32)
    Cm = (rng.rand(m, n) - 0.5).astype(np.float32)
    (jA, A), (jB, B), (jC, C) = (_pair(X.shape, nb, X) for X in (Am, Bm, Cm))
    kw = dict(alpha=alpha, beta=beta, transa=transa, transb=transb)
    _jax_run(ctx, jops.pdgemm_taskpool(jA, jB, jC, **kw))
    _run(tctx, ops.pdgemm_taskpool(A, B, C, **kw))
    opA = Am.T if transa == "t" else Am
    opB = Bm.T if transb == "t" else Bm
    ref = alpha * (_f64(opA) @ _f64(opB)) + beta * _f64(Cm)
    np.testing.assert_allclose(C.to_numpy(), ref, atol=2e-3)
    np.testing.assert_allclose(C.to_numpy(), jC.to_numpy(), atol=2e-3)


def test_pdgemm_shape_mismatch_rejected():
    A = TwoDimBlockCyclic(64, 64, 32, 32)
    C = TwoDimBlockCyclic(64, 64, 32, 32)
    with pytest.raises(ValueError):
        ops.pdgemm_taskpool(A, TwoDimBlockCyclic(32, 64, 32, 32), C)
    # grids conform but element extents don't (last k-tile 20 vs 26)
    with pytest.raises(ValueError):
        ops.pdgemm_taskpool(TwoDimBlockCyclic(64, 84, 32, 32),
                            TwoDimBlockCyclic(90, 64, 32, 32), C)
    with pytest.raises(ValueError, match="transa"):
        ops.pdgemm_taskpool(A, A, C, transa="x")


# ---------------------------------------------------------------------- #
# pivoted LU, solves and inverses (whole-matrix programs)                #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("m,n,nb,seed", [(192, 192, 64, 11),
                                         (160, 96, 64, 12),
                                         (96, 160, 64, 13)])
def test_dgetrf_matches_jax(m, n, nb, seed):
    """Square, rectangular and wide: the same row permutation as the JAX
    package, the packed factors within 1e-4, and A[perm] = L U."""
    A = _uniform(seed, m, n)
    jLU, jperm = jops.dgetrf(A, nb=nb)
    LU, perm = ops.dgetrf(A, nb=nb, device="cpu")
    assert LU.device.type == "cpu" and perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert not np.array_equal(perm.numpy(), np.arange(m))
    LU = LU.numpy()
    np.testing.assert_allclose(LU, np.asarray(jLU), atol=1e-4)
    k = min(m, n)
    L = (np.tril(_f64(LU), -1) + np.eye(m, n))[:, :k]
    U = np.triu(_f64(LU))[:k]
    assert np.linalg.norm(A[perm.numpy()] - L @ U) / np.linalg.norm(A) < 1e-5


def test_dgetrs_and_dgesv_match_jax():
    n, nrhs = 160, 8
    rng = np.random.RandomState(23)
    A = (rng.rand(n, n) - 0.5).astype(np.float32)
    B = rng.rand(n, nrhs).astype(np.float32)
    LU, perm = ops.dgetrf(A, nb=64, device="cpu")
    X = ops.dgetrs(LU, perm, B, device="cpu").numpy()
    jX = np.asarray(jops.dgesv(A, B, nb=64))
    np.testing.assert_allclose(ops.dgesv(A, B, nb=64, device="cpu").numpy(),
                               X, rtol=0, atol=0)
    np.testing.assert_allclose(X, jX, atol=1e-3)
    assert np.abs(X - np.linalg.solve(_f64(A), _f64(B))).max() < 5e-2
    with pytest.raises(ValueError, match="square"):
        ops.dgetrs(torch.zeros(4, 3), torch.arange(4), torch.zeros(4, 1),
                   device="cpu")


@pytest.mark.parametrize("lower,unit", [(True, False), (False, False),
                                        (True, True)])
def test_dtrtri_matches_jax(lower, unit):
    n = 96
    L = (np.tril(np.random.RandomState(21).rand(n, n).astype(np.float32))
         + 2 * np.eye(n, dtype=np.float32))
    T = L if lower else L.T.copy()
    inv = ops.dtrtri(T, lower=lower, unit_diagonal=unit, device="cpu").numpy()
    np.testing.assert_allclose(
        inv, np.asarray(jops.dtrtri(T, lower=lower, unit_diagonal=unit)),
        atol=2e-4)
    if not unit:
        np.testing.assert_allclose(inv @ T, np.eye(n), atol=2e-4)


def test_dpotri_matches_jax(ctx, tctx):
    """dpotrf (PTG, on the device module) then potri: the full pipeline."""
    n, nb = 128, 64
    M = ops.make_spd(n, seed=22)
    A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    _run(tctx, ops.dpotrf_taskpool(A))
    L = np.tril(A.to_numpy())
    Ainv = ops.dpotri(L, device="cpu").numpy()
    np.testing.assert_allclose(Ainv, np.asarray(jops.dpotri(L)), atol=5e-4)
    np.testing.assert_allclose(Ainv @ M, np.eye(n), atol=5e-3)
    for lower in (True, False):
        T = L if lower else L.T.copy()
        np.testing.assert_allclose(
            ops.dlauum(T, lower=lower, device="cpu").numpy(),
            np.asarray(jops.dlauum(T, lower=lower)), atol=1e-4)


@pytest.mark.parametrize("call", [
    lambda: ops.dgetrf(np.eye(4, dtype=np.float32), nb=2),
    lambda: ops.dgesv(np.eye(4, dtype=np.float32), np.ones((4, 1))),
    lambda: ops.dgetrs(np.eye(4, dtype=np.float32), np.arange(4),
                       np.ones((4, 1))),
    lambda: ops.dtrtri(np.eye(4, dtype=np.float32)),
    lambda: ops.dlauum(np.eye(4, dtype=np.float32)),
    lambda: ops.dpotri(np.eye(4, dtype=np.float32))])
def test_whole_matrix_routines_need_a_card(monkeypatch, call):
    """Without a card and without device="cpu", they raise instead of
    running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PARSEC_MCA_device_cuda_platform", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_ops_surface_matches_jax():
    """The JAX package's ops surface, with ``kernels`` in place of
    ``pallas_kernels``."""
    want = set(jops.__all__) - {"pallas_kernels"} | {"kernels"}
    assert set(ops.__all__) == want
    assert all(hasattr(ops, name) for name in ops.__all__)


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _launches():
    return ops.kernels.matmul_launches


def _dag_result(device, routine, n=100, nb=32):
    """One DAG on a fresh context on ``device`` (ragged 100 / 32 tiles):
    the result as an array, and the GEMM kernel's launches in the run."""
    c = parsec_tpu_torch.init(nb_cores=2, device=device)
    try:
        if routine == "dposv":
            A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(ops.make_spd(n))
            out = TwoDimBlockCyclic(n, 40, nb, nb).from_numpy(
                _uniform(1, n, 40))
            before = _launches()
            ops.dposv(c, A, out)
        else:
            M = (ops.make_diag_dominant(n) if routine == "dgetrf_nopiv"
                 else _uniform(2, n, n))
            out = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
            if routine.startswith("pdgemm"):
                t = routine[-1]
                A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(
                    _uniform(3, n, n))
                tp = ops.pdgemm_taskpool(A, A, out, alpha=1.5, beta=0.5,
                                         transa=t, transb=t)
            else:
                tp = getattr(ops, f"{routine}_taskpool")(out)
            before = _launches()
            _run(c, tp)
        assert c.device_by_type("cuda").torch_device.type == device.type
        return out.to_numpy(), _launches() - before
    finally:
        c.fini()


@pytest.mark.gpu
@pytest.mark.parametrize("routine", ["dposv", "dgetrf_nopiv", "dgeqrf",
                                     "pdgemm_n", "pdgemm_t"])
def test_dag_on_card_matches_cpu(card, routine):
    """Each DAG on the card against the same DAG on the CPU: every
    device task on the card, the GEMM kernel launched."""
    got, launches = _dag_result(card, routine)
    ref, _ = _dag_result(torch.device("cpu"), routine)
    assert launches > 0
    if routine == "dgeqrf":
        got, ref = (_sign_normalised(np.triu(x)) for x in (got, ref))
    np.testing.assert_allclose(got, ref, atol=1e-3)


@pytest.mark.gpu
def test_getrf_nopiv_on_card_matches_masked_loop(card):
    M = torch.from_numpy(ops.make_diag_dominant(256)).to(card)
    out = ops.getrf_nopiv(M)
    ref = ops.linalg.getrf_nopiv_plain(M)
    assert out.is_contiguous()
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-4
    batched = ops.getrf_nopiv(torch.stack([M, 2 * M]))
    assert torch.equal(batched[1], ops.getrf_nopiv(2 * M))


@pytest.mark.gpu
def test_whole_matrix_routines_on_card(card):
    A = _uniform(11, 192, 192)
    LU, perm = ops.dgetrf(A, nb=64)
    assert LU.device.type == "cuda"
    cLU, cperm = ops.dgetrf(A, nb=64, device="cpu")
    assert torch.equal(perm.cpu(), cperm)
    np.testing.assert_allclose(LU.cpu().numpy(), cLU.numpy(), atol=1e-4)
    B = np.ones((192, 4), np.float32)
    np.testing.assert_allclose(ops.dgesv(A, B, nb=64).cpu().numpy(),
                               ops.dgesv(A, B, nb=64, device="cpu").numpy(),
                               atol=1e-3)
    L = np.linalg.cholesky(_f64(ops.make_spd(128))).astype(np.float32)
    np.testing.assert_allclose(ops.dpotri(L).cpu().numpy(),
                               ops.dpotri(L, device="cpu").numpy(), atol=1e-4)
