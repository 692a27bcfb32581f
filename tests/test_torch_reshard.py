"""The port's cross-grid checkpoint restore (``restore_collection(...,
reshard=True)`` over ``ft.reshard_restore`` and
``collections/redistribute``).

Mirrors the five reshard tests of the JAX package's
``tests/test_checkpoint.py`` on ``device="cpu"`` contexts, and restores
snapshots the JAX package wrote — on a 4-rank grid, and on an elastic
(remapped) grid — onto the port's 2-rank grid, bit for bit.
"""
import numpy as np
import pytest

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import RemoteDepEngine
from parsec_tpu_torch.utils import checkpoint as ckpt
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads


def spmd(nb_ranks, fn):
    return spmd_threads(nb_ranks, fn, timeout=60.0)


def _write_grid_snapshot(tmp_path, M, n, nb, nb_ranks, P, Q, name):
    """Every rank's shard of M on a P x Q grid, written as the ranks
    would (each its own local tiles)."""
    prefix = str(tmp_path / name)
    for rank in range(nb_ranks):
        d = TwoDimBlockCyclic(n, n, nb, nb, P=P, Q=Q, nodes=nb_ranks,
                              rank=rank, dtype=np.float32)
        d.name = "descA"
        for (i, j) in d.local_tiles():
            np.copyto(d.tile(i, j),
                      M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        ckpt.save_collection(d, prefix)
    return prefix


def _reshard_onto(prefix, M, n, nb, nb_ranks, P, Q):
    """Restore with reshard=True on a fresh grid; check every landed
    tile against the source matrix, bit for bit."""
    def restore_rank(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = ptt.Context(nb_cores=1, comm=eng, device="cpu")
        try:
            d = TwoDimBlockCyclic(n, n, nb, nb, P=P, Q=Q, nodes=nb_ranks,
                                  rank=rank, dtype=np.float32)
            d.name = "descA"
            got = ckpt.restore_collection(d, prefix, reshard=True,
                                          context=ctx)
            local = {t: np.array(d.tile(*t)) for t in d.local_tiles()}
            return got, local, dict(eng.ce.elastic_stats)
        finally:
            ctx.fini()

    results, _ = spmd(nb_ranks, restore_rank)
    merged = {}
    for got, local, stats in results:
        assert got == len(local)
        assert stats["reshard_bytes"] > 0   # the reshard path really ran
        merged.update(local)
    assert len(merged) == (n // nb) ** 2
    for (i, j), arr in merged.items():
        np.testing.assert_array_equal(
            arr, M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])


def test_reshard_restore_4rank_to_2rank(tmp_path):
    """The shrink shape: a 4-rank snapshot lands bit-identical on a
    2-rank grid (each survivor loads the writer shards folded onto it
    and the redistribution moves tiles to their new owners)."""
    n, nb = 128, 32
    M = np.random.RandomState(11).rand(n, n).astype(np.float32)
    prefix = _write_grid_snapshot(tmp_path, M, n, nb, 4, 4, 1, "s42")
    _reshard_onto(prefix, M, n, nb, 2, 2, 1)


def test_reshard_restore_1x4_to_2x2(tmp_path):
    """Grid-SHAPE change at the same rank count: 1x4 -> 2x2 is a pure
    ownership permutation and must also be bit-identical."""
    n, nb = 128, 32
    M = np.random.RandomState(12).rand(n, n).astype(np.float32)
    prefix = _write_grid_snapshot(tmp_path, M, n, nb, 4, 1, 4, "s14")
    _reshard_onto(prefix, M, n, nb, 4, 2, 2)


def test_reshard_restore_to_single_rank(tmp_path):
    """A 4-rank snapshot folds onto ONE process with no comm machinery
    (pull a dead job's state anywhere)."""
    n, nb = 128, 32
    M = np.random.RandomState(13).rand(n, n).astype(np.float32)
    prefix = _write_grid_snapshot(tmp_path, M, n, nb, 4, 2, 2, "s41")
    d = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
    d.name = "descA"
    assert ckpt.restore_collection(d, prefix, reshard=True) == 16
    np.testing.assert_array_equal(d.to_numpy(), M)


def test_reshard_rejects_geometry_mismatch(tmp_path):
    """reshard=True relaxes the DISTRIBUTION only: a tile-size change
    still hard-fails (resharding moves tiles, it cannot re-tile
    bytes)."""
    n = 128
    M = np.random.RandomState(14).rand(n, n).astype(np.float32)
    prefix = _write_grid_snapshot(tmp_path, M, n, 32, 4, 4, 1, "sgm")
    wrong = TwoDimBlockCyclic(n, n, 16, 16, dtype=np.float32)
    wrong.name = "descA"
    with pytest.raises(ckpt.CheckpointMismatchError, match="GEOMETRY"):
        ckpt.restore_collection(wrong, prefix, reshard=True)


def test_reshard_rejects_mixed_stale_shards(tmp_path):
    """A stale shard from a DIFFERENT grid sitting beside a newer save
    must be rejected, not silently blended into the restore."""
    n, nb = 128, 32
    M = np.random.RandomState(15).rand(n, n).astype(np.float32)
    prefix = _write_grid_snapshot(tmp_path, M, n, nb, 2, 2, 1, "mix")
    stale = TwoDimBlockCyclic(n, n, nb, nb, P=4, Q=1, nodes=4, rank=1,
                              dtype=np.float32)
    stale.name = "descA"
    ckpt.save_collection(stale, prefix)
    d = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
    d.name = "descA"
    with pytest.raises(ckpt.CheckpointCorruptError, match="stale"):
        ckpt.restore_collection(d, prefix, reshard=True)


# --------------------------------------------------------------------- #
# snapshots the JAX package wrote                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("planner", [False, True])
def test_jax_written_4rank_snapshot_reshards_onto_2_port_ranks(tmp_path,
                                                               planner):
    """A snapshot the JAX package wrote on a 4-rank 2 x 2 grid is
    reshard-restored by the port onto 2 ranks (2 x 1), bit for bit —
    through the DTD walk and through the collective planner."""
    from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBC
    from parsec_tpu.utils import checkpoint as jax_ckpt
    n, nb = 128, 32
    M = np.random.RandomState(16).rand(n, n).astype(np.float32)
    prefix = str(tmp_path / "jax42")
    for rank in range(4):
        d = JaxTwoDimBC(n, n, nb, nb, P=2, Q=2, nodes=4, rank=rank,
                        dtype=np.float32)
        d.name = "descA"
        for (i, j) in d.local_tiles():
            d.set_tile(i, j, M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        jax_ckpt.save_collection(d, prefix)
    with params.cmdline_override("xfer_collective_redist",
                                 "1" if planner else "0"):
        _reshard_onto(prefix, M, n, nb, 2, 2, 1)


def test_jax_written_elastic_snapshot_reshards_onto_port_grid(tmp_path):
    """A snapshot the JAX package wrote on an ELASTIC grid (members
    (0, 2) of a world of 3: world rank 2 holds logical rank 1's tiles)
    lands on the port's own elastic grid over members (1, 2), where
    world rank 1 is logical rank 0 — bit for bit."""
    from parsec_tpu.ft.elastic import ElasticBlockCyclic as JaxElasticBC
    from parsec_tpu.utils import checkpoint as jax_ckpt
    from parsec_tpu_torch.ft import plan_grid
    n, nb, world = 96, 32, 3
    M = np.random.RandomState(17).rand(n, n).astype(np.float32)
    prefix = str(tmp_path / "jaxel")
    for rank in (0, 2):
        d = JaxElasticBC(n, n, nb, nb, members=(0, 2), P=2, Q=1,
                         nodes=world, rank=rank, dtype=np.float32)
        d.name = "descA"
        for (i, j) in d.local_tiles():
            d.set_tile(i, j, M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        jax_ckpt.save_collection(d, prefix)

    def restore_rank(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = ptt.Context(nb_cores=1, comm=eng, device="cpu")
        try:
            if rank == 0:
                return {}
            d = plan_grid((1, 2), world, rank).collection(
                n, n, nb, nb, dtype=np.float32)
            d.name = "descA"
            ckpt.restore_collection(d, prefix, reshard=True, context=ctx)
            assert d.rank_of(0, 0) == 1 and d.rank_of(1, 0) == 2
            return {t: np.array(d.tile(*t)) for t in d.local_tiles()}
        finally:
            ctx.fini()

    results, _ = spmd(world, restore_rank)
    merged = {}
    for local in results:
        merged.update(local)
    assert len(merged) == (n // nb) ** 2
    for (i, j), arr in merged.items():
        np.testing.assert_array_equal(
            arr, M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
