"""Tile LU factorization without pivoting (dgetrf_nopiv) as a PTG graph,
and the pivoted blocked LU (dgetrf) as one program on tensors.

The right-looking tile LU with the DPLASMA task classes GETRF / TRSM_L
(row panel, yields U(k,n)) / TRSM_U (column panel, yields L(m,k)) / GEMM
(trailing update), the dataflow of the JAX package's ``ops/dgetrf.py``.
No pivoting: intended for diagonally-dominant or otherwise LU-stable
matrices.  Every trailing update is one launch of the GEMM kernel
(``gemm_nn_sub``); the diagonal tile goes through ``getrf_nopiv`` and the
panels through triangular solves (ops/linalg.py).

On return descA holds unit-lower L strictly below the diagonal and U on
and above: A = L U.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..collections.matrix import TiledMatrix
from ..devices import as_tensor
from ..dsl import ptg

DGETRF_JDF = """
descA [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
KT [ type="int" ]

GETRF(k)

k = 0 .. KT-1

: descA( k, k )

RW A <- (k == 0) ? descA( k, k ) : C GEMM( k-1, k, k )
     -> descA( k, k )
     -> T TRSM_L( k, k+1 .. NT-1 )
     -> T TRSM_U( k, k+1 .. MT-1 )

; (KT - k) * 1000

BODY [type=cuda batch=stacked]
{
    A = ops.getrf_nopiv(A)
}
END

TRSM_L(k, n)

k = 0 .. KT-1
n = k+1 .. NT-1

: descA( k, n )

READ T <- A GETRF( k )
RW   C <- (k == 0) ? descA( k, n ) : C GEMM( k-1, k, n )
       -> descA( k, n )
       -> B GEMM( k, k+1 .. MT-1, n )

; (KT - k) * 100

BODY [type=cuda batch=stacked]
{
    C = ops.trsm_lower_unit(T, C)
}
END

TRSM_U(k, m)

k = 0 .. KT-1
m = k+1 .. MT-1

: descA( m, k )

READ T <- A GETRF( k )
RW   C <- (k == 0) ? descA( m, k ) : C GEMM( k-1, m, k )
       -> descA( m, k )
       -> A GEMM( k, m, k+1 .. NT-1 )

; (KT - k) * 100

BODY [type=cuda batch=stacked]
{
    C = ops.trsm_upper_right(T, C)
}
END

GEMM(k, m, n)

k = 0 .. KT-1
m = k+1 .. MT-1
n = k+1 .. NT-1

: descA( m, n )

READ A <- C TRSM_U( k, m )
READ B <- C TRSM_L( k, n )
RW   C <- (k == 0) ? descA( m, n ) : C GEMM( k-1, m, n )
       -> ((m == k+1) and (n == k+1)) ? A GETRF( k+1 )
       -> ((m == k+1) and (n > k+1)) ? C TRSM_L( k+1, n )
       -> ((m > k+1) and (n == k+1)) ? C TRSM_U( k+1, m )
       -> ((m > k+1) and (n > k+1)) ? C GEMM( k+1, m, n )

; (KT - k) * 10

BODY [type=cuda batch=stacked]
{
    C = ops.gemm_nn_sub(C, A, B)
}
END
"""

_factory = None


def dgetrf_factory() -> "ptg.JDFFactory":
    global _factory
    if _factory is None:
        _factory = ptg.compile_jdf(DGETRF_JDF, name="dgetrf_nopiv")
    return _factory


def dgetrf_nopiv_taskpool(A: TiledMatrix, rank: int = 0, nb_ranks: int = 1):
    from .. import ops as ops_module
    kt = min(A.mt, A.nt)
    # every diagonal tile must be square (triangular solves need a square
    # factor): square full tiles, and a square trailing tile if partial
    last_rows = A.lm - (kt - 1) * A.mb
    last_cols = A.ln - (kt - 1) * A.nb
    if A.mb != A.nb or min(last_rows, A.mb) != min(last_cols, A.nb):
        raise ValueError(
            f"dgetrf_nopiv needs square diagonal tiles; got mb={A.mb} "
            f"nb={A.nb}, trailing diagonal tile "
            f"{min(last_rows, A.mb)}x{min(last_cols, A.nb)}")
    tp = dgetrf_factory().new(descA=A, MT=A.mt, NT=A.nt, KT=kt,
                              rank=rank, nb_ranks=nb_ranks)
    tp.global_env["ops"] = ops_module
    return tp


def dgetrf_nopiv(context, A: TiledMatrix, rank: int = 0,
                 nb_ranks: int = 1) -> None:
    """Factor A = L U in place (no pivoting): unit-lower L strictly below
    the diagonal, U on and above. Blocking: enqueue + wait."""
    tp = dgetrf_nopiv_taskpool(A, rank=rank, nb_ranks=nb_ranks)
    context.add_taskpool(tp)
    context.wait()


def _pivots_to_perm(pivots: torch.Tensor, n: int) -> torch.Tensor:
    """LAPACK's 1-based row interchanges as the row permutation ``p`` of
    ``n`` rows with ``P^T A = A[p] = L U``.  The interchanges compose in
    order, so this reads the panel's pivots on the host: one device sync
    a panel."""
    perm = list(range(n))
    for i, j in enumerate(pivots.tolist()):
        perm[i], perm[j - 1] = perm[j - 1], perm[i]
    return torch.tensor(perm, device=pivots.device)


def dgetrf(A: Any, nb: int = 256,
           device: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked LU with partial pivoting: ``A[perm] = L U`` for general
    (also rectangular) matrices, the algorithm of the JAX package's
    ``dgetrf`` on tensors: each panel through ``lu_factor_ex`` with
    pivoting, its row permutation applied to the whole trailing rows, the
    block row through a unit-lower triangular solve, the trailing update
    through one ``torch.matmul``.  That product follows the caller's
    ``torch.backends.cuda.matmul.allow_tf32``, off by PyTorch's default:
    leave it off, since LU feeds each update into the next panel and
    TF32's rounding would compound.  Pivoting's data-dependent row swaps
    do not fit an affine PTG, so this is a program on whole tensors, not
    a DAG.

    Runs on ``device`` (default ``cuda:0``, raising without a card).
    Returns ``(LU, perm)``: packed factors (unit-lower L strictly below
    the diagonal, U on and above) and the row permutation, int64."""
    LU = as_tensor(A, device).clone()
    n_rows, n_cols = LU.shape
    perm = torch.arange(n_rows, device=LU.device)
    for k0 in range(0, min(n_rows, n_cols), nb):
        # panel columns stop at the diagonal extent: for wide matrices
        # the columns beyond the row count belong to the block row
        k1 = min(k0 + nb, n_rows, n_cols)
        p_lu, piv, _info = torch.linalg.lu_factor_ex(LU[k0:, k0:k1])
        p_perm = _pivots_to_perm(piv, n_rows - k0)
        LU[k0:, k0:k1] = p_lu
        LU[k0:, :k0] = LU[k0:, :k0][p_perm]
        LU[k0:, k1:] = LU[k0:, k1:][p_perm]
        perm[k0:] = perm[k0:][p_perm]
        if k1 < n_cols:
            LU[k0:k1, k1:] = torch.linalg.solve_triangular(
                LU[k0:k1, k0:k1], LU[k0:k1, k1:], upper=False,
                unitriangular=True)
            if k1 < n_rows:
                LU[k1:, k1:] -= torch.matmul(LU[k1:, k0:k1], LU[k0:k1, k1:])
    return LU, perm


def make_diag_dominant(m: int, n: int = None, dtype=np.float32,
                       seed: int = 0) -> np.ndarray:
    """A diagonally-dominant matrix — LU-stable without pivoting."""
    n = m if n is None else n
    rng = np.random.RandomState(seed)
    A = rng.rand(m, n).astype(np.float64) - 0.5
    for i in range(min(m, n)):
        A[i, i] = np.sum(np.abs(A[i])) + 1.0
    return A.astype(dtype)
