"""Tile QR factorization (dgeqrf) as a PTG task graph.

The flat-tree tile QR with the four DPLASMA task classes GEQRT / UNMQR /
TSQRT / TSMQR, the dataflow of the JAX package's ``ops/dgeqrf.py``.  The
panel tasks export the explicit orthogonal factors (Q for the diagonal,
Q2 for the stacked triangle-on-square) instead of the reference's
compact-WY pair (V, T), so every consumer update is one launch of the
GEMM kernel (ops/linalg.py ``unmqr``, ``tsmqr``).  The Q/Q2 edges are
WRITE-only scratch flows with a ``[shape=...]`` NEW target, the analog of
DPLASMA's side-band descT collection: the runtime allocates each on the
host and the device module stages it in before the body overwrites it.

On return descA holds R in its upper triangle (tiles (i,j), i <= j) and
zeros below: A = Q R with Q discarded (verify via R^T R == A^T A).
"""
from __future__ import annotations

from ..collections.matrix import TiledMatrix
from ..dsl import ptg

DGEQRF_JDF = """
descA [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
KT [ type="int" ]

GEQRT(k)

k = 0 .. KT-1

: descA( k, k )

RW A <- (k == 0) ? descA( k, k ) : A2 TSMQR( k-1, k, k )
     -> (k < MT-1) ? R TSQRT( k, k+1 )
     -> (k == MT-1) ? descA( k, k )
WRITE Q -> Q UNMQR( k, k+1 .. NT-1 )  [shape="(descA.tile_shape(k, k)[0],) * 2"]

; (KT - k) * 1000

BODY [type=cuda]
{
    A, Q = ops.geqrt(A) if k < NT - 1 else ops.geqrt_r(A)
}
END

UNMQR(k, n)

k = 0 .. KT-1
n = k+1 .. NT-1

: descA( k, n )

READ Q <- Q GEQRT( k )
RW   C <- (k == 0) ? descA( k, n ) : A2 TSMQR( k-1, k, n )
       -> (k < MT-1) ? A1 TSMQR( k, k+1, n )
       -> (k == MT-1) ? descA( k, n )

; (KT - k) * 100

BODY [type=cuda]
{
    C = ops.unmqr(Q, C)
}
END

TSQRT(k, m)

k = 0 .. KT-1
m = k+1 .. MT-1

: descA( m, k )

RW R  <- (m == k+1) ? A GEQRT( k ) : R TSQRT( k, m-1 )
      -> (m == MT-1) ? descA( k, k ) : R TSQRT( k, m+1 )
RW A2 <- (k == 0) ? descA( m, k ) : A2 TSMQR( k-1, m, k )
      -> descA( m, k )
WRITE Q2 -> Q2 TSMQR( k, m, k+1 .. NT-1 )  [shape="(descA.tile_shape(k, k)[0] + descA.tile_shape(m, k)[0],) * 2"]

; (KT - k) * 1000 + (MT - m)

BODY [type=cuda]
{
    R, A2, Q2 = ops.tsqrt(R, A2) if k < NT - 1 else ops.tsqrt_r(R, A2)
}
END

TSMQR(k, m, n)

k = 0 .. KT-1
m = k+1 .. MT-1
n = k+1 .. NT-1

: descA( m, n )

READ Q2 <- Q2 TSQRT( k, m )
RW A1 <- (m == k+1) ? C UNMQR( k, n ) : A1 TSMQR( k, m-1, n )
      -> (m == MT-1) ? descA( k, n ) : A1 TSMQR( k, m+1, n )
RW A2 <- (k == 0) ? descA( m, n ) : A2 TSMQR( k-1, m, n )
      -> ((n == k+1) and (m == k+1)) ? A GEQRT( k+1 )
      -> ((n == k+1) and (m > k+1)) ? A2 TSQRT( k+1, m )
      -> ((n > k+1) and (m == k+1)) ? C UNMQR( k+1, n )
      -> ((n > k+1) and (m > k+1)) ? A2 TSMQR( k+1, m, n )

; (KT - k) * 10 + (MT - m)

BODY [type=cuda]
{
    A1, A2 = ops.tsmqr(Q2, A1, A2)
}
END
"""

_factory = None


def dgeqrf_factory() -> "ptg.JDFFactory":
    global _factory
    if _factory is None:
        _factory = ptg.compile_jdf(DGEQRF_JDF, name="dgeqrf")
    return _factory


def dgeqrf_taskpool(A: TiledMatrix, rank: int = 0, nb_ranks: int = 1):
    from .. import ops as ops_module
    kt = min(A.mt, A.nt)
    # the panel factorizations need square diagonal tiles (ragged edges
    # are fine as long as the trailing diagonal tile stays square)
    last_rows, last_cols = A.tile_shape(kt - 1, kt - 1)
    if A.mb != A.nb or last_rows != last_cols:
        raise ValueError(
            f"dgeqrf needs square diagonal tiles; got mb={A.mb} nb={A.nb}, "
            f"trailing diagonal tile {last_rows}x{last_cols}")
    tp = dgeqrf_factory().new(descA=A, MT=A.mt, NT=A.nt, KT=kt,
                              rank=rank, nb_ranks=nb_ranks)
    tp.global_env["ops"] = ops_module
    return tp


def dgeqrf(context, A: TiledMatrix, rank: int = 0, nb_ranks: int = 1) -> None:
    """Factor A = Q R in place: on return the upper triangle of A holds R
    (tiles strictly below the diagonal are zeroed); Q is not retained.
    Blocking: enqueue + wait."""
    tp = dgeqrf_taskpool(A, rank=rank, nb_ranks=nb_ranks)
    context.add_taskpool(tp)
    context.wait()
