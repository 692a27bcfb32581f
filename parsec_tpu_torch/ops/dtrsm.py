"""Tiled triangular solves (dtrsm) and the Cholesky solver (dposv).

The DPLASMA-style triangular solve DAGs on the runtime: forward
substitution ``L Y = B`` and backward substitution ``L^T X = Y`` over a
tiled lower factor and a tiled right-hand-side panel, as in the JAX
package's ``ops/dtrsm.py``.  L tiles reach their consumers through
owner-placed reader tasks (RDIAG, RPANEL) whose host bodies do nothing:
the host hook brings the newest copy of each tile home (after dpotrf, a
device-to-host copy of every L tile, as in the JAX package), and the
device copies stay valid for TRSM and GEMM.  Every update is one launch
of the GEMM kernel (ops/linalg.py ``gemm_nn_sub``, ``gemm_tn_sub``);
diagonal solves are triangular solves on the nb x nb tile.

dposv = dpotrf (ops/dpotrf.py) + forward + backward, three pools in turn
over the same collections: solves A X = B for SPD A, in place in B.
"""
from __future__ import annotations

from ..collections.matrix import TiledMatrix
from ..dsl import ptg

# forward substitution: Y(k) = L(k,k)^{-1} (B(k) - sum_{j<k} L(k,j) Y(j))
FWD_JDF = """
descL [ type="collection" ]
descB [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]

RDIAG(k)

k = 0 .. MT-1

: descL( k, k )

READ T <- descL( k, k )
       -> T TRSM( k, 0 .. NT-1 )

BODY
{
    pass
}
END

RPANEL(m, k)

k = 0 .. MT-2
m = k+1 .. MT-1

: descL( m, k )

READ P <- descL( m, k )
       -> A GEMM( k, m, 0 .. NT-1 )

BODY
{
    pass
}
END

TRSM(k, n)

k = 0 .. MT-1
n = 0 .. NT-1

: descB( k, n )

READ T <- T RDIAG( k )
RW   X <- (k == 0) ? descB( k, n ) : C GEMM( k-1, k, n )
       -> descB( k, n )
       -> B GEMM( k, k+1 .. MT-1, n )

; (MT - k) * 10

BODY [type=cuda batch=stacked]
{
    X = ops.trsm_lower(T, X)
}
END

GEMM(k, m, n)

k = 0 .. MT-2
m = k+1 .. MT-1
n = 0 .. NT-1

: descB( m, n )

READ A <- P RPANEL( m, k )
READ B <- X TRSM( k, n )
RW   C <- (k == 0) ? descB( m, n ) : C GEMM( k-1, m, n )
       -> (m == k+1) ? X TRSM( m, n ) : C GEMM( k+1, m, n )

; MT - k

BODY [type=cuda batch=stacked]
{
    C = ops.gemm_nn_sub(C, A, B)
}
END
"""

# backward substitution: X(k) = L(k,k)^{-T} (Y(k) - sum_{m>k} L(m,k)^T X(m))
BWD_JDF = """
descL [ type="collection" ]
descB [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]

RDIAG(k)

k = 0 .. MT-1

: descL( k, k )

READ T <- descL( k, k )
       -> T TRSM( k, 0 .. NT-1 )

BODY
{
    pass
}
END

RPANEL(m, k)

k = 0 .. MT-2
m = k+1 .. MT-1

: descL( m, k )

READ P <- descL( m, k )
       -> A GEMM( k, m, 0 .. NT-1 )

BODY
{
    pass
}
END

TRSM(k, n)

k = 0 .. MT-1
n = 0 .. NT-1

: descB( k, n )

READ T <- T RDIAG( k )
RW   X <- (k == MT-1) ? descB( k, n ) : C GEMM( k, k+1, n )
       -> descB( k, n )
       -> B GEMM( 0 .. k-1, k, n )

; (k + 1) * 10

BODY [type=cuda batch=stacked]
{
    X = ops.trsm_lower_trans(T, X)
}
END

GEMM(k, m, n)

k = 0 .. MT-2
m = k+1 .. MT-1
n = 0 .. NT-1

: descB( k, n )

READ A <- P RPANEL( m, k )
READ B <- X TRSM( m, n )
RW   C <- (m == MT-1) ? descB( k, n ) : C GEMM( k, m+1, n )
       -> (m == k+1) ? X TRSM( k, n ) : C GEMM( k, m-1, n )

; k + 1

BODY [type=cuda batch=stacked]
{
    C = ops.gemm_tn_sub(C, A, B)
}
END
"""

_pair = None


def _factories():
    # both published at once: in-process ranks call this concurrently,
    # and one must never see the first factory without the second
    global _pair
    if _pair is None:
        _pair = (ptg.compile_jdf(FWD_JDF, name="dtrsm_fwd"),
                 ptg.compile_jdf(BWD_JDF, name="dtrsm_bwd"))
    return _pair


def _tp(factory, L: TiledMatrix, B: TiledMatrix, rank: int, nb_ranks: int):
    from .. import ops as ops_module
    if L.mt != L.nt or L.mt != B.mt:
        raise ValueError(f"dtrsm: L tile grid {L.mt}x{L.nt} does not "
                         f"conform with B {B.mt}x{B.nt}")
    tp = factory.new(descL=L, descB=B, MT=B.mt, NT=B.nt,
                     rank=rank, nb_ranks=nb_ranks)
    tp.global_env["ops"] = ops_module
    return tp


def dtrsm_lower_taskpool(L, B, rank=0, nb_ranks=1):
    """Forward substitution L Y = B, Y written into B."""
    return _tp(_factories()[0], L, B, rank, nb_ranks)


def dtrsm_lower_trans_taskpool(L, B, rank=0, nb_ranks=1):
    """Backward substitution L^T X = B, X written into B."""
    return _tp(_factories()[1], L, B, rank, nb_ranks)


def dposv(context, A: TiledMatrix, B: TiledMatrix,
          rank: int = 0, nb_ranks: int = 1) -> None:
    """Solve A X = B for SPD A: Cholesky factor in place in A, then
    forward + backward substitution in place in B, three pools in turn.
    Blocking: enqueue + wait for each.

    With ``stage_compile`` (+ ``stage_compile_chain``) on, the three
    pools are declared as a chained sequence first (stagec/chain.py):
    fusable pool boundaries — provably memory-fed first stages whose
    every input writer is fused — then run inside ONE chained program
    (one CUDA graph) instead of handing tiles over between pools.
    Ineligible boundaries (multirank dataflow, residue writers) simply
    run unchained; the add/wait composition below is unchanged either
    way."""
    from ..utils.params import params
    from .dpotrf import dpotrf_taskpool
    pools = [dpotrf_taskpool(A, rank=rank, nb_ranks=nb_ranks),
             dtrsm_lower_taskpool(A, B, rank=rank, nb_ranks=nb_ranks),
             dtrsm_lower_trans_taskpool(A, B, rank=rank,
                                        nb_ranks=nb_ranks)]
    if params.get("stage_compile") and params.get("stage_compile_chain"):
        from ..stagec.chain import declare_chain
        declare_chain(context, pools)
    for tp in pools:
        context.add_taskpool(tp)
        context.wait()
