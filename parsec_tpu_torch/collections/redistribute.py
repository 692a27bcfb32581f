"""Redistribution engine: move an M×N submatrix between two arbitrary
tiled distributions.

Reference behavior: ``parsec_redistribute(Y, T, size_row, size_col,
disi_Y, disj_Y, disi_T, disj_T)`` — PTG- and DTD-based full submatrix
redistribution between any two block-cyclic distributions with unaligned
offsets and different tile sizes; each target tile assembles up to nine
source-fragment classes (NW/N/NE/W/I/E/SW/S/SE)
(ref: parsec/data_dist/matrix/redistribute/redistribute.jdf,
redistribute_wrapper.c:185, SURVEY.md §2.6).

Expressed through the DTD front end, as in the JAX package: one assembly
task per (target tile, source tile) pair, with INPUT deps on the
intersecting source tile and INOUT on the target tile. Task placement
follows the target tile's owner (AFFINITY); cross-rank fragments ride
the DTD data plane, so the same code is the single-process and the
distributed path. The assembly bodies are host bodies: the DTD runtime
pulls a card-resident newest version of a source tile back to its host
copy before the body reads it, and the written target tile's host copy
becomes the newest version, so a later device task stages it in again.

``reshard_array`` (the JAX package's move between mesh shardings)
belongs with SPMD meshes (ROADMAP Queue 1, part D2b) and raises here.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..dsl import dtd
from ..dsl.dtd import AFFINITY, INOUT, INPUT, VALUE, unpack_args
from .matrix import TiledMatrix


def _tile_range(lo: int, hi: int, tb: int) -> range:
    """Tiles of size tb intersecting global element rows [lo, hi)."""
    return range(lo // tb, (hi - 1) // tb + 1)


def _copy_frag(es, task) -> None:
    """One fragment: DTD task classes have a fixed flow signature (ref
    limit, insert_function_internal.h:30), so assembly is one 2-flow task
    per (target tile, source tile) pair; the INOUT chain on the target
    tile orders the disjoint fragment writes."""
    tgt, frag, src = unpack_args(task)
    dr0, dr1, dc0, dc1, sr0, sr1, sc0, sc1 = frag
    tgt[dr0:dr1, dc0:dc1] = src[sr0:sr1, sc0:sc1]


def _reshuffle_applicable(source: TiledMatrix, target: TiledMatrix,
                          size_row: int, size_col: int,
                          disi_Y: int, disj_Y: int,
                          disi_T: int, disj_T: int) -> bool:
    """The optimized-reshuffle precondition (ref: the reference's
    dedicated reshuffle path, redistribute_reshuffle.jdf via
    redistribute_wrapper.c:185: same tile grid, tile-aligned offsets):
    every target tile then maps 1:1 to one source tile — a pure
    rank/tile permutation, no fragment assembly."""
    return (source.mb == target.mb and source.nb == target.nb
            and disi_Y % source.mb == 0 and disj_Y % source.nb == 0
            and disi_T % target.mb == 0 and disj_T % target.nb == 0
            and size_row % source.mb == 0 and size_col % source.nb == 0)


def _copy_tile(es, task) -> None:
    tgt, src = unpack_args(task)
    tgt[:, :] = src


def _whole_matrix_applicable(source: TiledMatrix, target: TiledMatrix,
                             size_row: int, size_col: int,
                             disi_Y: int, disj_Y: int,
                             disi_T: int, disj_T: int) -> bool:
    """Whole-matrix same-tile-grid case: zero offsets, full extent,
    identical tiling on both ends. Unlike the aligned-subregion
    precondition above, this holds even with ragged edge tiles
    (``lm % mb != 0``) — every target tile still maps 1:1 to one
    equal-shape source tile, so it rides the reshuffle path. This is
    the cross-grid checkpoint-reshard shape (ft/elastic.py): geometry
    is immutable across snapshots, only the distribution moves."""
    return (source.mb == target.mb and source.nb == target.nb
            and source.lm == target.lm and source.ln == target.ln
            and disi_Y == disj_Y == disi_T == disj_T == 0
            and size_row == source.lm and size_col == source.ln)


def _engine_of(context: Any) -> Optional[Any]:
    """The rank's comm engine, unwrapped from a Context's RemoteDep
    layer (None without a context or a comm engine)."""
    if context is None:
        return None
    comm = getattr(context, "comm", None)
    if comm is None:
        return None
    return getattr(comm, "ce", comm)


def redistribute(source: TiledMatrix, target: TiledMatrix,
                 size_row: int, size_col: int,
                 disi_Y: int = 0, disj_Y: int = 0,
                 disi_T: int = 0, disj_T: int = 0,
                 context: Any = None,
                 taskpool: Optional[Any] = None,
                 allow_reshuffle: bool = True,
                 tiles: Optional[Any] = None) -> Any:
    """Copy source[disi_Y:disi_Y+size_row, disj_Y:disj_Y+size_col] into
    target[disi_T:..., disj_T:...] across distributions.

    SPMD: call on every rank. With ``taskpool`` the tasks are inserted
    into an existing DTD pool (composing with other work); otherwise a
    fresh pool is created, and with ``context`` it is enqueued + waited.
    Returns the taskpool.

    When both ends share the tile grid and all offsets/sizes are
    tile-aligned, the reshuffle walk runs instead: one whole-tile copy
    task per target tile — the reference's dedicated reshuffle JDF
    (redistribute_reshuffle.jdf). ``allow_reshuffle=False`` forces the
    general fragment walk (the equivalence tests use it).

    ``tiles`` (an iterable of target (m, n) coords) restricts the walk
    to an explicit tile set — required for triangular-storage
    collections whose off-storage tiles must never be touched, and only
    supported on the whole-matrix same-grid reshuffle shape (the
    checkpoint-reshard path, ft/elastic.py). The returned pool is
    stamped with ``redist_bytes`` — the GLOBAL payload volume of the
    inserted walk (identical on every rank: insertion is SPMD) — an
    observable distinct from the per-rank landed bytes the
    ``FT::RESHARD_BYTES`` gauge reports.

    With the ``xfer_collective_redist`` knob on, a whole-matrix
    same-grid move on a fresh pool over several ranks runs the
    collective planner instead (xfer/plan.py) and returns its
    ``PlannedRedistribution``.
    """
    assert disi_Y + size_row <= source.lm and disj_Y + size_col <= source.ln, \
        "source region out of bounds"
    assert disi_T + size_row <= target.lm and disj_T + size_col <= target.ln, \
        "target region out of bounds"
    if taskpool is None and context is None:
        raise ValueError(
            "redistribute() needs a context (fresh pool, enqueued + waited) "
            "or an existing taskpool to compose into")
    whole = _whole_matrix_applicable(source, target, size_row, size_col,
                                     disi_Y, disj_Y, disi_T, disj_T)
    # collective-planner path (xfer/plan.py): only on a fresh pool
    # (``taskpool`` composition keeps DTD ordering) and only multi-rank —
    # a single participant has nothing to coalesce
    if taskpool is None and allow_reshuffle and whole:
        from ..utils.params import params
        if params.get_or("xfer_collective_redist", "bool", False):
            ce = _engine_of(context)
            if ce is not None and getattr(ce, "nb_ranks", 1) > 1:
                from ..xfer.plan import run_redistribution
                return run_redistribution(source, target, ce, tiles=tiles,
                                          context=context)
    tp = taskpool if taskpool is not None else dtd.taskpool_new(
        name=f"redistribute_{source.lm}x{source.ln}")
    # redistribution is pure data MOVEMENT — checkpoint-reshard restores
    # (ft/elastic.py) ride it and must land bit-identical, so its wire
    # traffic is never eligible for the lossy quantized codecs
    # (comm/remote_dep.py consults this mark per flow)
    tp.wire_lossless = True
    own = taskpool is None
    if own and context is not None:
        context.add_taskpool(tp)
    # the DTD tile registry keys messages by collection name: give the two
    # ends deterministic distinct names when the user didn't. A per-taskpool
    # counter keeps composed calls collision-free (insertion streams are
    # identical on every rank, so the counter is SPMD-consistent)
    seq = getattr(tp, "_redist_seq", 0)
    tp._redist_seq = seq + 1
    if getattr(source, "name", None) in (None, type(source).__name__):
        source.name = f"redist{seq}_Y"
    if getattr(target, "name", None) in (None, type(target).__name__):
        target.name = f"redist{seq}_T"
    assert source.name != target.name, \
        "source and target collections need distinct .name values"
    if not hasattr(tp, "redist_bytes"):
        tp.redist_bytes = 0
    itemsize = np.dtype(target.dtype).itemsize

    def finish() -> Any:
        if own:
            tp.data_flush_all()
            if context is not None:
                tp.wait()
        return tp

    if allow_reshuffle and whole:
        for (m, n) in (tiles if tiles is not None else target.tiles()):
            tm, tn = target.tile_shape(m, n)
            tp.insert_task(
                _copy_tile,
                (tp.tile_of(target, (m, n)), INOUT | AFFINITY),
                (tp.tile_of(source, (m, n)), INPUT),
                name=f"reshuffle({m},{n})<-({m},{n})")
            tp.redist_bytes += tm * tn * itemsize
        return finish()
    if tiles is not None:
        raise ValueError(
            "redistribute(tiles=...) restricts the whole-matrix "
            "same-grid reshuffle walk only; the sub-region and "
            "fragment paths derive their tile sets from the region")

    if allow_reshuffle and _reshuffle_applicable(
            source, target, size_row, size_col,
            disi_Y, disj_Y, disi_T, disj_T):
        mb, nb = source.mb, source.nb
        dm, dn = disi_T // mb - disi_Y // mb, disj_T // nb - disj_Y // nb
        for sm in _tile_range(disi_Y, disi_Y + size_row, mb):
            for sn in _tile_range(disj_Y, disj_Y + size_col, nb):
                tp.insert_task(
                    _copy_tile,
                    (tp.tile_of(target, (sm + dm, sn + dn)),
                     INOUT | AFFINITY),
                    (tp.tile_of(source, (sm, sn)), INPUT),
                    name=f"reshuffle({sm + dm},{sn + dn})<-({sm},{sn})")
                tp.redist_bytes += mb * nb * itemsize
        return finish()

    mbT, nbT = target.mb, target.nb
    mbY, nbY = source.mb, source.nb
    # walk target tiles intersecting the target region
    for tm in _tile_range(disi_T, disi_T + size_row, mbT):
        # this target tile's rows ∩ region, in global-region coordinates r
        tr_lo = max(tm * mbT, disi_T) - disi_T
        tr_hi = min((tm + 1) * mbT, disi_T + size_row) - disi_T
        for tn in _tile_range(disj_T, disj_T + size_col, nbT):
            tc_lo = max(tn * nbT, disj_T) - disj_T
            tc_hi = min((tn + 1) * nbT, disj_T + size_col) - disj_T
            ttile = tp.tile_of(target, (tm, tn))
            # source tiles covering region rows [tr_lo, tr_hi) / cols ...
            for sm in _tile_range(disi_Y + tr_lo, disi_Y + tr_hi, mbY):
                sr_lo = max(sm * mbY, disi_Y + tr_lo)
                sr_hi = min((sm + 1) * mbY, disi_Y + tr_hi)
                for sn in _tile_range(disj_Y + tc_lo, disj_Y + tc_hi, nbY):
                    sc_lo = max(sn * nbY, disj_Y + tc_lo)
                    sc_hi = min((sn + 1) * nbY, disj_Y + tc_hi)
                    # fragment in region coords → slices in each tile
                    r0, r1 = sr_lo - disi_Y, sr_hi - disi_Y
                    c0, c1 = sc_lo - disj_Y, sc_hi - disj_Y
                    frag = (
                        r0 + disi_T - tm * mbT, r1 + disi_T - tm * mbT,
                        c0 + disj_T - tn * nbT, c1 + disj_T - tn * nbT,
                        sr_lo - sm * mbY, sr_hi - sm * mbY,
                        sc_lo - sn * nbY, sc_hi - sn * nbY)
                    tp.insert_task(
                        _copy_frag, (ttile, INOUT | AFFINITY),
                        (frag, VALUE), (tp.tile_of(source, (sm, sn)), INPUT),
                        name=f"redist({tm},{tn})<-({sm},{sn})")
                    tp.redist_bytes += (r1 - r0) * (c1 - c0) * itemsize
    return finish()


REDISTRIBUTE_RESHUFFLE_JDF = """
descY [ type="collection" ]
descT [ type="collection" ]
SM0 [ type="int" ]
SN0 [ type="int" ]
TM0 [ type="int" ]
TN0 [ type="int" ]
MT [ type="int" ]
NT [ type="int" ]

SRC(m, n)

m = 0 .. MT-1
n = 0 .. NT-1

: descY( SM0+m, SN0+n )

READ Y <- descY( SM0+m, SN0+n )
       -> T DST( m, n )

BODY
{
    pass
}
END

DST(m, n)

m = 0 .. MT-1
n = 0 .. NT-1

: descT( TM0+m, TN0+n )

RW T <- Y SRC( m, n )
     -> descT( TM0+m, TN0+n )

BODY
{
    pass
}
END
"""

_reshuffle_factory = None


def redistribute_ptg(source: TiledMatrix, target: TiledMatrix,
                     size_row: int, size_col: int,
                     disi_Y: int = 0, disj_Y: int = 0,
                     disi_T: int = 0, disj_T: int = 0,
                     rank: int = 0, nb_ranks: int = 1) -> Any:
    """PTG-generated reshuffle (the reference's redistribute.jdf role,
    ref: redistribute_wrapper.c:185): a static two-class task graph —
    SRC(m,n) placed on the source tile's owner reads it and ships it
    along a task edge to DST(m,n) on the target tile's owner, whose
    memory writeback lands it. Requires the aligned same-tile-grid
    precondition (the general unaligned fragment case runs through the
    DTD path in :func:`redistribute`). Returns the taskpool — enqueue
    with context.add_taskpool() on every rank."""
    from ..dsl import ptg
    global _reshuffle_factory
    assert _reshuffle_applicable(source, target, size_row, size_col,
                                 disi_Y, disj_Y, disi_T, disj_T), \
        "redistribute_ptg needs same tile grid + tile-aligned offsets"
    if _reshuffle_factory is None:
        _reshuffle_factory = ptg.compile_jdf(REDISTRIBUTE_RESHUFFLE_JDF,
                                             name="redistribute_reshuffle")
    mb, nb = source.mb, source.nb
    tp = _reshuffle_factory.new(
        descY=source, descT=target,
        SM0=disi_Y // mb, SN0=disj_Y // nb,
        TM0=disi_T // mb, TN0=disj_T // nb,
        MT=size_row // mb, NT=size_col // nb,
        rank=rank, nb_ranks=nb_ranks)
    tp.wire_lossless = True
    return tp


def reshard_array(arr: Any, mesh: Any, spec: Any) -> Any:
    """The JAX package's move of a mesh-resident array between two
    shardings. It belongs with SPMD meshes, which this package does not
    carry yet (ROADMAP Queue 1, part D2b): it raises."""
    raise NotImplementedError(
        "reshard_array moves an array between mesh shardings; sharded "
        "arrays are not carried by this package yet (ROADMAP Queue 1, "
        "part D2b)")
