"""Tile Cholesky (dpotrf_L) as a PTG task graph — the DPLASMA-slice.

The right-looking lower-triangular tile Cholesky with the classic four task
classes POTRF / TRSM / SYRK / GEMM and the same dataflow as DPLASMA's
dpotrf_L JDF running on the reference runtime (the north-star workload,
BASELINE.md config 5). The bodies are ``[type=cuda]`` (PaRSEC's own
spelling) and call the tile operations of ops/linalg.py, which the CUDA
device module dispatches onto the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..collections.matrix import TiledMatrix
from ..dsl import ptg

DPOTRF_L_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

POTRF(k)

k = 0 .. NT-1

: descA( k, k )

RW T <- (k == 0) ? descA( k, k ) : T SYRK( k-1, k )
     -> T TRSM( k, k+1 .. NT-1 )
     -> descA( k, k )

; (NT - k) * 1000

BODY [type=cuda batch=stacked]
{
    T = ops.potrf(T)
}
END

TRSM(k, m)

k = 0 .. NT-2
m = k+1 .. NT-1

: descA( m, k )

READ T <- T POTRF( k )
RW   C <- (k == 0) ? descA( m, k ) : C GEMM( k-1, m, k )
       -> A SYRK( k, m )
       -> A GEMM( k, m, k+1 .. m-1 )
       -> B GEMM( k, m+1 .. NT-1, m )
       -> descA( m, k )

; (NT - m) * 100 + (NT - k) * 10

BODY [type=cuda batch=stacked]
{
    C = ops.trsm_panel(T, C)
}
END

SYRK(k, m)

k = 0 .. NT-2
m = k+1 .. NT-1

: descA( m, m )

READ A <- C TRSM( k, m )
RW   T <- (k == 0) ? descA( m, m ) : T SYRK( k-1, m )
       -> (m == k+1) ? T POTRF( m ) : T SYRK( k+1, m )

; (NT - m) * 1000

BODY [type=cuda batch=stacked]
{
    T = ops.syrk_ln(T, A)
}
END

GEMM(k, m, n)

k = 0 .. NT-3
m = k+2 .. NT-1
n = k+1 .. m-1

: descA( m, n )

READ A <- C TRSM( k, m )
READ B <- C TRSM( k, n )
RW   C <- (k == 0) ? descA( m, n ) : C GEMM( k-1, m, n )
       -> (n == k+1) ? C TRSM( n, m ) : C GEMM( k+1, m, n )

; (NT - m) * 10

BODY [type=cuda batch=stacked]
{
    C = ops.gemm_nt(C, A, B)
}
END
"""

_factory = None


def dpotrf_factory() -> "ptg.JDFFactory":
    global _factory
    if _factory is None:
        _factory = ptg.compile_jdf(DPOTRF_L_JDF, name="dpotrf_L")
    return _factory


def dpotrf(context, A: TiledMatrix, rank: int = 0, nb_ranks: int = 1) -> None:
    """Run the Cholesky factorization of the SPD tiled matrix A in place
    (lower triangle holds L on return). Blocking: enqueue + wait."""
    assert A.mt == A.nt, "dpotrf needs a square tile grid"
    tp = dpotrf_taskpool(A, rank=rank, nb_ranks=nb_ranks)
    context.add_taskpool(tp)
    context.wait()


def dpotrf_taskpool(A: TiledMatrix, rank: int = 0, nb_ranks: int = 1):
    from .. import ops as ops_module
    tp = dpotrf_factory().new(descA=A, NT=A.nt, rank=rank, nb_ranks=nb_ranks)
    tp.global_env["ops"] = ops_module
    return tp


def make_spd(n: int, dtype=np.float32, seed: int = 0) -> np.ndarray:
    """A well-conditioned SPD matrix for testing/benchmarks."""
    rng = np.random.RandomState(seed)
    B = rng.rand(n, n).astype(np.float64) - 0.5
    M = (B @ B.T) / n + np.eye(n)
    return M.astype(dtype)
