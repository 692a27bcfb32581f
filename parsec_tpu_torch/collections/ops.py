"""Collection-wide operations as PTG task graphs.

Reference behavior: elementwise ``apply`` over the tiles of a (possibly
triangular) matrix (ref: parsec/data_dist/matrix/apply.jdf), binary-tree
reductions by column / row / whole matrix (ref:
parsec/data_dist/matrix/reduce_col.jdf:31-70, reduce_row.jdf, reduce.jdf),
one-datum broadcast to all consumers (ref:
parsec/data_dist/matrix/broadcast.jdf), and the generic two-collection tile
map (ref: parsec/data_dist/matrix/map_operator.c).

All are expressed as JDF task graphs executed by the PTG runtime, so
multi-rank runs inherit the remote-dep machinery (chain/binomial broadcast
topologies for fan-out edges) for free — exactly how the reference builds
its collective operations out of ordinary task graphs rather than runtime
primitives (SURVEY.md §2.8: "reductions are expressed as task graphs").

The reduction trees handle non-power-of-two tile counts: a node with no
right child passes its value through unchanged (the reference's reduce
JDFs assume power-of-two extents; the guard-based pass-through here lifts
that restriction).
"""
from __future__ import annotations

import math

import numpy as np
from typing import Any, Callable, Optional

from ..dsl import ptg
from .matrix import TiledMatrix, TwoDimBlockCyclic

__all__ = ["apply", "apply_taskpool", "map_operator", "map_operator_taskpool",
           "reduce_col", "reduce_row", "reduce_all",
           "reduce_col_taskpool", "reduce_row_taskpool", "reduce_all_taskpool",
           "broadcast", "broadcast_taskpool", "band_to_rect_taskpool",
           "allreduce", "allreduce_taskpool"]

# --------------------------------------------------------------------------
# apply: elementwise unary operation over (triangular) tile sets
# ref: apply.jdf APPLY_L / APPLY_U / APPLY_DIAG task classes
# --------------------------------------------------------------------------

_APPLY_JDF = """
descA [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
LOWER [ type="int" ]
UPPER [ type="int" ]

APPLY_L(m, n)

m = 1 .. (0 if UPPER else MT-1)
n = 0 .. (m-1 if m < NT else NT-1)

: descA( m, n )

RW A <- descA( m, n )
     -> descA( m, n )

BODY
{
    A = operation(A, "full", m, n, op_args)
}
END

APPLY_U(m, n)

m = 0 .. MT-1
n = m+1 .. (0 if LOWER else NT-1)

: descA( m, n )

RW A <- descA( m, n )
     -> descA( m, n )

BODY
{
    A = operation(A, "full", m, n, op_args)
}
END

APPLY_DIAG(k)

k = 0 .. (MT-1 if MT < NT else NT-1)

: descA( k, k )

RW A <- descA( k, k )
     -> descA( k, k )

BODY
{
    A = operation(A, uplo_region, k, k, op_args)
}
END
"""

_apply_factory: Optional[Any] = None


def apply_taskpool(A: TiledMatrix, operation: Callable, uplo: str = "full",
                   op_args: Any = None, rank: int = 0, nb_ranks: int = 1):
    """``operation(tile, region, m, n, op_args) -> new tile`` applied to
    every stored tile of ``A``; ``uplo`` restricts to a triangle (incl. the
    diagonal, which gets ``region=uplo`` so the op can mask)."""
    global _apply_factory
    assert uplo in ("full", "lower", "upper")
    if _apply_factory is None:
        _apply_factory = ptg.compile_jdf(_APPLY_JDF, name="apply")
    tp = _apply_factory.new(descA=A, MT=A.mt, NT=A.nt,
                            LOWER=int(uplo == "lower"),
                            UPPER=int(uplo == "upper"),
                            rank=rank, nb_ranks=nb_ranks)
    tp.global_env["operation"] = operation
    tp.global_env["op_args"] = op_args
    tp.global_env["uplo_region"] = uplo
    return tp


def apply(context, A: TiledMatrix, operation: Callable, uplo: str = "full",
          op_args: Any = None) -> None:
    context.add_taskpool(apply_taskpool(A, operation, uplo, op_args))
    context.wait()


# --------------------------------------------------------------------------
# map_operator: generic two-collection tile map  (ref: map_operator.c)
# --------------------------------------------------------------------------

_MAP_JDF = """
src [ type="collection" ]
dest [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]

MAP(m, n)

m = 0 .. MT-1
n = 0 .. NT-1

: dest( m, n )

READ S <- src( m, n )
RW   D <- dest( m, n )
       -> dest( m, n )

BODY
{
    D = operation(S, D, m, n, op_args)
}
END
"""

_map_factory: Optional[Any] = None


def map_operator_taskpool(src: TiledMatrix, dest: TiledMatrix,
                          operation: Callable, op_args: Any = None,
                          rank: int = 0, nb_ranks: int = 1):
    """``operation(src_tile, dest_tile, m, n, op_args) -> new dest tile``
    over the common tile grid of ``src`` and ``dest``."""
    global _map_factory
    if _map_factory is None:
        _map_factory = ptg.compile_jdf(_MAP_JDF, name="map_operator")
    mt, nt = min(src.mt, dest.mt), min(src.nt, dest.nt)
    tp = _map_factory.new(src=src, dest=dest, MT=mt, NT=nt,
                          rank=rank, nb_ranks=nb_ranks)
    tp.global_env["operation"] = operation
    tp.global_env["op_args"] = op_args
    return tp


def map_operator(context, src: TiledMatrix, dest: TiledMatrix,
                 operation: Callable, op_args: Any = None) -> None:
    context.add_taskpool(map_operator_taskpool(src, dest, operation, op_args))
    context.wait()


# --------------------------------------------------------------------------
# tree reductions  (ref: reduce_col.jdf / reduce_row.jdf / reduce.jdf)
#
# One task class; leaf loads fold into level 1. Node (level, index) combines
# children (2i, 2i+1) of level-1; a missing right child passes through.
# --------------------------------------------------------------------------

# Leaf tasks copy the source tile into a NEW scratch buffer before the
# fold (ref: the reduce_in_col input task class, reduce_col.jdf:36-43) so
# the reduction never mutates the source collection: an RW flow sourced
# straight from memory is in-place on that tile (dpotrf-style semantics).
# {dt} is the element dtype literal; factories are cached per dtype.

_REDUCE_COL_JDF = """
descA [ type="collection" ]
dest [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
MB [ type="int" ]
NB [ type="int" ]
DEPTH [ type="int" ]

LEAF(i, col)

i = 0 .. MT-1
col = 0 .. NT-1

: descA( i, col )

READ  S <- descA( i, col )
WRITE R <- NEW  [shape="MB x NB" dtype="{dt}"]
        -> (i % 2 == 0) ? Rtop LEAF_REDUCE( 1, i >> 1, col )
        -> (i % 2 == 1) ? Rbottom LEAF_REDUCE( 1, i >> 1, col )

BODY
{{
    R = S
}}
END

LEAF_REDUCE(level, index, col)

level = 1 .. DEPTH
index = 0 .. ((MT + (1 << level) - 1) >> level) - 1
col = 0 .. NT-1
nprev = (MT + (1 << (level-1)) - 1) >> (level-1)
hasr = 1 if 2*index+1 < nprev else 0

: descA( index << level, col )

RW Rtop <- (level == 1) ? R LEAF( 2*index, col ) : Rtop LEAF_REDUCE( level-1, 2*index, col )
        -> (level < DEPTH and index % 2 == 0) ? Rtop LEAF_REDUCE( level+1, index >> 1, col )
        -> (level < DEPTH and index % 2 == 1) ? Rbottom LEAF_REDUCE( level+1, index >> 1, col )
        -> (level == DEPTH) ? dest( 0, col )

READ Rbottom <- (hasr and level == 1) ? R LEAF( 2*index+1, col )
             <- (hasr and level > 1) ? Rtop LEAF_REDUCE( level-1, 2*index+1, col )

BODY
{{
    Rtop = operation(Rtop, Rbottom, op_args) if hasr else Rtop
}}
END
"""

_REDUCE_ROW_JDF = """
descA [ type="collection" ]
dest [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
MB [ type="int" ]
NB [ type="int" ]
DEPTH [ type="int" ]

LEAF(i, row)

i = 0 .. NT-1
row = 0 .. MT-1

: descA( row, i )

READ  S <- descA( row, i )
WRITE R <- NEW  [shape="MB x NB" dtype="{dt}"]
        -> (i % 2 == 0) ? Rtop LEAF_REDUCE( 1, i >> 1, row )
        -> (i % 2 == 1) ? Rbottom LEAF_REDUCE( 1, i >> 1, row )

BODY
{{
    R = S
}}
END

LEAF_REDUCE(level, index, row)

level = 1 .. DEPTH
index = 0 .. ((NT + (1 << level) - 1) >> level) - 1
row = 0 .. MT-1
nprev = (NT + (1 << (level-1)) - 1) >> (level-1)
hasr = 1 if 2*index+1 < nprev else 0

: descA( row, index << level )

RW Rtop <- (level == 1) ? R LEAF( 2*index, row ) : Rtop LEAF_REDUCE( level-1, 2*index, row )
        -> (level < DEPTH and index % 2 == 0) ? Rtop LEAF_REDUCE( level+1, index >> 1, row )
        -> (level < DEPTH and index % 2 == 1) ? Rbottom LEAF_REDUCE( level+1, index >> 1, row )
        -> (level == DEPTH) ? dest( row, 0 )

READ Rbottom <- (hasr and level == 1) ? R LEAF( 2*index+1, row )
             <- (hasr and level > 1) ? Rtop LEAF_REDUCE( level-1, 2*index+1, row )

BODY
{{
    Rtop = operation(Rtop, Rbottom, op_args) if hasr else Rtop
}}
END
"""

_REDUCE_ALL_JDF = """
descA [ type="collection" ]
dest [ type="collection" ]
NT [ type="int" ]
MB [ type="int" ]
NB [ type="int" ]
NLEAF [ type="int" ]
DEPTH [ type="int" ]

LEAF(t)

t = 0 .. NLEAF-1

: descA( int(t / NT), t % NT )

READ  S <- descA( int(t / NT), t % NT )
WRITE R <- NEW  [shape="MB x NB" dtype="{dt}"]
        -> (t % 2 == 0) ? Rtop LEAF_REDUCE( 1, t >> 1 )
        -> (t % 2 == 1) ? Rbottom LEAF_REDUCE( 1, t >> 1 )

BODY
{{
    R = S
}}
END

LEAF_REDUCE(level, index)

level = 1 .. DEPTH
index = 0 .. ((NLEAF + (1 << level) - 1) >> level) - 1
nprev = (NLEAF + (1 << (level-1)) - 1) >> (level-1)
hasr = 1 if 2*index+1 < nprev else 0

: descA( int((index << level) / NT), (index << level) % NT )

RW Rtop <- (level == 1) ? R LEAF( 2*index ) : Rtop LEAF_REDUCE( level-1, 2*index )
        -> (level < DEPTH and index % 2 == 0) ? Rtop LEAF_REDUCE( level+1, index >> 1 )
        -> (level < DEPTH and index % 2 == 1) ? Rbottom LEAF_REDUCE( level+1, index >> 1 )
        -> (level == DEPTH) ? dest( 0, 0 )

READ Rbottom <- (hasr and level == 1) ? R LEAF( 2*index+1 )
             <- (hasr and level > 1) ? Rtop LEAF_REDUCE( level-1, 2*index+1 )

BODY
{{
    Rtop = operation(Rtop, Rbottom, op_args) if hasr else Rtop
}}
END
"""

_reduce_factories: dict = {}


def _reduce_factory(kind: str, dtype: np.dtype):
    key = (kind, str(dtype))
    if key not in _reduce_factories:
        src = {"col": _REDUCE_COL_JDF, "row": _REDUCE_ROW_JDF,
               "all": _REDUCE_ALL_JDF}[kind].format(dt=str(dtype))
        _reduce_factories[key] = ptg.compile_jdf(src, name=f"reduce_{kind}")
    return _reduce_factories[key]


def _depth(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 1


def _default_dest(A: TiledMatrix, mt: int, nt: int) -> TiledMatrix:
    return TwoDimBlockCyclic(mt * A.mb, nt * A.nb, A.mb, A.nb, dtype=A.dtype,
                             nodes=A.nodes, rank=A.rank)


def reduce_col_taskpool(A: TiledMatrix, operation: Callable,
                        dest: Optional[TiledMatrix] = None,
                        op_args: Any = None, rank: int = 0, nb_ranks: int = 1):
    """Fold tiles down every column: ``dest(0, col) = op-fold of
    A(0..MT-1, col)``. Returns (taskpool, dest)."""
    dest = dest if dest is not None else _default_dest(A, 1, A.nt)
    tp = _reduce_factory("col", A.dtype).new(
        descA=A, dest=dest, MT=A.mt, NT=A.nt, MB=A.mb, NB=A.nb,
        DEPTH=_depth(A.mt), rank=rank, nb_ranks=nb_ranks)
    tp.global_env["operation"] = operation
    tp.global_env["op_args"] = op_args
    return tp, dest


def reduce_row_taskpool(A: TiledMatrix, operation: Callable,
                        dest: Optional[TiledMatrix] = None,
                        op_args: Any = None, rank: int = 0, nb_ranks: int = 1):
    """Fold tiles across every row: ``dest(row, 0) = op-fold of
    A(row, 0..NT-1)``. Returns (taskpool, dest)."""
    dest = dest if dest is not None else _default_dest(A, A.mt, 1)
    tp = _reduce_factory("row", A.dtype).new(
        descA=A, dest=dest, MT=A.mt, NT=A.nt, MB=A.mb, NB=A.nb,
        DEPTH=_depth(A.nt), rank=rank, nb_ranks=nb_ranks)
    tp.global_env["operation"] = operation
    tp.global_env["op_args"] = op_args
    return tp, dest


def reduce_all_taskpool(A: TiledMatrix, operation: Callable,
                        dest: Optional[TiledMatrix] = None,
                        op_args: Any = None, rank: int = 0, nb_ranks: int = 1):
    """Fold every tile of A into ``dest(0, 0)``. Returns (taskpool, dest)."""
    nleaf = A.mt * A.nt
    dest = dest if dest is not None else _default_dest(A, 1, 1)
    tp = _reduce_factory("all", A.dtype).new(
        descA=A, dest=dest, NT=A.nt, MB=A.mb, NB=A.nb,
        NLEAF=nleaf, DEPTH=_depth(nleaf), rank=rank, nb_ranks=nb_ranks)
    tp.global_env["operation"] = operation
    tp.global_env["op_args"] = op_args
    return tp, dest


def reduce_col(context, A, operation, dest=None, op_args=None):
    tp, dest = reduce_col_taskpool(A, operation, dest, op_args)
    context.add_taskpool(tp)
    context.wait()
    return dest


def reduce_row(context, A, operation, dest=None, op_args=None):
    tp, dest = reduce_row_taskpool(A, operation, dest, op_args)
    context.add_taskpool(tp)
    context.wait()
    return dest


def reduce_all(context, A, operation, dest=None, op_args=None):
    tp, dest = reduce_all_taskpool(A, operation, dest, op_args)
    context.add_taskpool(tp)
    context.wait()
    return dest


def allreduce_taskpool(A: TiledMatrix, operation: Callable,
                       op_args: Any = None, rank: int = 0,
                       nb_ranks: int = 1):
    """Every tile of A folds to one value which then lands back in every
    tile of A — the reduce+broadcast composition the reference's DTD
    allreduce test builds by hand (no allreduce primitive exists in the
    runtime; reductions and broadcasts are task graphs, SURVEY.md §2.4).
    Returns one compound taskpool (reduce ; broadcast)."""
    from ..runtime.compound import compose
    red, scratch = reduce_all_taskpool(A, operation, None, op_args,
                                       rank=rank, nb_ranks=nb_ranks)
    bc = broadcast_taskpool(scratch, A, root=(0, 0), rank=rank,
                            nb_ranks=nb_ranks)
    return compose(red, bc)


def allreduce(context, A, operation, op_args=None):
    """In-place allreduce over A's tiles. Blocking."""
    tp = allreduce_taskpool(A, operation, op_args)
    context.add_taskpool(tp)
    context.wait()


# --------------------------------------------------------------------------
# broadcast: one source tile to every tile of dest  (ref: broadcast.jdf —
# a root datum propagated to a rank set; the fan-out edge rides the
# remote-dep broadcast topology in multi-rank runs)
# --------------------------------------------------------------------------

_BCAST_JDF = """
src [ type="collection" ]
dest [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
RM [ type="int" ]
RN [ type="int" ]

ROOT(z)

z = 0 .. 0

: src( RM, RN )

READ S <- src( RM, RN )
       -> S BCAST( 0 .. MT-1, 0 .. NT-1 )

BODY
{
    pass
}
END

BCAST(m, n)

m = 0 .. MT-1
n = 0 .. NT-1

: dest( m, n )

READ S <- S ROOT( 0 )
RW   D <- dest( m, n )
       -> dest( m, n )

BODY
{
    D = S
}
END
"""

_bcast_factory: Optional[Any] = None


def broadcast_taskpool(src: TiledMatrix, dest: TiledMatrix,
                       root: tuple = (0, 0), rank: int = 0, nb_ranks: int = 1):
    """Copy tile ``src(root)`` into every tile of ``dest``."""
    global _bcast_factory
    if _bcast_factory is None:
        _bcast_factory = ptg.compile_jdf(_BCAST_JDF, name="broadcast")
    return _bcast_factory.new(src=src, dest=dest, MT=dest.mt, NT=dest.nt,
                              RM=root[0], RN=root[1],
                              rank=rank, nb_ranks=nb_ranks)


def broadcast(context, src: TiledMatrix, dest: TiledMatrix,
              root: tuple = (0, 0)) -> None:
    context.add_taskpool(broadcast_taskpool(src, dest, root))
    context.wait()


# --------------------------------------------------------------------------
# diag_band_to_rect: copy the tridiagonal tile band of a band-stored matrix
# into a rectangular (2 × NT) matrix  (ref: diag_band_to_rect.jdf)
# --------------------------------------------------------------------------

_BAND_JDF = """
band [ type="collection" ]
rect [ type="collection" ]
NT [ type="int" ]

DIAG(k)

k = 0 .. NT-1

: band( k, k )

READ D <- band( k, k )
RW   R <- rect( 0, k )
       -> rect( 0, k )

BODY
{
    R = D
}
END

SUPER(k)

k = 1 .. NT-1

: band( k-1, k )

READ D <- band( k-1, k )
RW   R <- rect( 1, k )
       -> rect( 1, k )

BODY
{
    R = D
}
END
"""

_band_factory: Optional[Any] = None


def band_to_rect_taskpool(band: TiledMatrix, rect: TiledMatrix,
                          rank: int = 0, nb_ranks: int = 1):
    """Diagonal tiles of ``band`` → row 0 of ``rect``; superdiagonal tiles
    → row 1 (columns 1..NT-1)."""
    global _band_factory
    if _band_factory is None:
        _band_factory = ptg.compile_jdf(_BAND_JDF, name="diag_band_to_rect")
    nt = min(band.mt, band.nt)
    return _band_factory.new(band=band, rect=rect, NT=nt,
                             rank=rank, nb_ranks=nb_ranks)
