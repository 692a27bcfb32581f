"""Tile GEMM (C = alpha op(A) op(B) + beta C) as a PTG task graph.

The SUMMA pattern as DPLASMA expresses it, the dataflow of the JAX
package's ``ops/pdgemm.py``: owner-placed READ_A/READ_B tasks load each
A/B tile at its home rank and broadcast it over task edges to the full
row/column of GEMM consumers (their host bodies do nothing); each
GEMM(m,n,k) accumulates C(m,n) in place, chained over k.  The tile body
is one launch of the GEMM kernel.

Transpose variants (transa/transb in {"n","t"}): the reader tasks index
the source collection as (m,k) or (k,m) — collection argument
expressions are Python, so the swap is a conditional on the TRANSA/
TRANSB globals.  The kernel reads B transposed in place (TRANSB = 't');
a transposed A tile becomes a contiguous copy before the launch.
"""
from __future__ import annotations

from ..collections.matrix import TiledMatrix
from ..dsl import ptg

PDGEMM_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]
descC [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
KT [ type="int" ]
ALPHA [ type="float" default="1.0" ]
BETA [ type="float" default="1.0" ]
TRANSA [ type="string" default="'n'" ]
TRANSB [ type="string" default="'n'" ]

READ_A(m, k)

m = 0 .. MT-1
k = 0 .. KT-1

: descA( m if TRANSA == 'n' else k, k if TRANSA == 'n' else m )

READ A <- descA( m if TRANSA == 'n' else k, k if TRANSA == 'n' else m )
       -> A GEMM( m, 0 .. NT-1, k )

; (KT - k) * 10

BODY
{
    pass
}
END

READ_B(k, n)

k = 0 .. KT-1
n = 0 .. NT-1

: descB( k if TRANSB == 'n' else n, n if TRANSB == 'n' else k )

READ B <- descB( k if TRANSB == 'n' else n, n if TRANSB == 'n' else k )
       -> B GEMM( 0 .. MT-1, n, k )

; (KT - k) * 10

BODY
{
    pass
}
END

GEMM(m, n, k)

m = 0 .. MT-1
n = 0 .. NT-1
k = 0 .. KT-1

: descC( m, n )

READ A <- A READ_A( m, k )
READ B <- B READ_B( k, n )
RW   C <- (k == 0) ? descC( m, n ) : C GEMM( m, n, k-1 )
       -> (k == KT-1) ? descC( m, n ) : C GEMM( m, n, k+1 )

; KT - k

BODY [type=cuda]
{
    Ae = A if TRANSA == 'n' else ops.transpose(A)
    C = ops.gemm(C, Ae, B, float(ALPHA), float(BETA) if k == 0 else 1.0,
                 trans_b=TRANSB == 't')
}
END
"""

_factory = None


def pdgemm_factory() -> "ptg.JDFFactory":
    global _factory
    if _factory is None:
        _factory = ptg.compile_jdf(PDGEMM_JDF, name="pdgemm")
    return _factory


def _eff(coll, trans):
    """(rows, cols) tile-grid / extents / tile dims after the transpose."""
    if trans == "n":
        return (coll.mt, coll.nt, coll.lm, coll.ln, coll.mb, coll.nb)
    return (coll.nt, coll.mt, coll.ln, coll.lm, coll.nb, coll.mb)


def pdgemm_taskpool(A: TiledMatrix, B: TiledMatrix, C: TiledMatrix,
                    alpha: float = 1.0, beta: float = 1.0,
                    transa: str = "n", transb: str = "n",
                    rank: int = 0, nb_ranks: int = 1):
    from .. import ops as ops_module
    if transa not in ("n", "t") or transb not in ("n", "t"):
        raise ValueError(f"pdgemm: transa/transb must be 'n' or 't', got "
                         f"{transa!r}/{transb!r}")
    amt, ant, alm, aln, amb, anb = _eff(A, transa)
    bmt, bnt, blm, bln, bmb, bnb = _eff(B, transb)
    if ant != bmt or amt != C.mt or bnt != C.nt:
        raise ValueError("pdgemm: inner/outer tile grids do not agree "
                         f"(opA {amt}x{ant}, opB {bmt}x{bnt}, "
                         f"C {C.mt}x{C.nt})")
    if aln != blm or alm != C.lm or bln != C.ln:
        raise ValueError("pdgemm: element extents do not agree "
                         f"(opA {alm}x{aln}, opB {blm}x{bln}, "
                         f"C {C.lm}x{C.ln})")
    if anb != bmb or amb != C.mb or bnb != C.nb:
        raise ValueError("pdgemm: tile sizes do not conform "
                         f"(opA {amb}x{anb}, opB {bmb}x{bnb}, "
                         f"C {C.mb}x{C.nb})")
    tp = pdgemm_factory().new(descA=A, descB=B, descC=C,
                              MT=C.mt, NT=C.nt, KT=ant,
                              ALPHA=float(alpha), BETA=float(beta),
                              TRANSA=transa, TRANSB=transb,
                              rank=rank, nb_ranks=nb_ranks)
    tp.global_env["ops"] = ops_module
    return tp


def pdgemm(context, A: TiledMatrix, B: TiledMatrix, C: TiledMatrix,
           alpha: float = 1.0, beta: float = 1.0,
           transa: str = "n", transb: str = "n",
           rank: int = 0, nb_ranks: int = 1) -> None:
    """C <- alpha op(A) op(B) + beta C over tiled collections. Blocking."""
    tp = pdgemm_taskpool(A, B, C, alpha=alpha, beta=beta,
                         transa=transa, transb=transb,
                         rank=rank, nb_ranks=nb_ranks)
    context.add_taskpool(tp)
    context.wait()
