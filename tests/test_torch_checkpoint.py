"""The port's collection checkpoint/resume (parsec_tpu_torch/utils/
checkpoint.py): quiescent-point tile snapshots per rank, in the JAX
package's file format.  Mirrors the JAX package's
``tests/test_checkpoint.py`` (its cross-grid reshard tests are mirrored
in ``test_torch_reshard.py``), plus restores across the two packages in
both directions, and the device path: a snapshot pulls the device
module's newest copies, and a restore into collections whose tiles
still have (stale) device copies makes the re-run read the restored
values.
"""
import glob
import json

import numpy as np
import pytest

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.utils import checkpoint as ckpt
from parsec_tpu_torch.utils.spmd import spmd_threads


def spmd(nb_ranks, fn):
    return spmd_threads(nb_ranks, fn, timeout=30.0)


@pytest.fixture
def ctx():
    c = ptt.init(nb_cores=2, device="cpu")
    yield c
    c.fini()


def test_roundtrip_single_rank(tmp_path):
    rng = np.random.RandomState(0)
    M = rng.rand(96, 96).astype(np.float32)
    A = TwoDimBlockCyclic(96, 96, 32, 32, dtype=np.float32).from_numpy(M)
    prefix = str(tmp_path / "ck")
    path = ckpt.save_collection(A, prefix)
    B = TwoDimBlockCyclic(96, 96, 32, 32, dtype=np.float32)
    n = ckpt.restore_collection(B, prefix)
    assert n == 9
    np.testing.assert_array_equal(B.to_numpy(), M)
    assert path.endswith(".rank0.npz")


def test_restore_rejects_incompatible_geometry(tmp_path):
    A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(
        np.ones((64, 64), np.float32))
    prefix = str(tmp_path / "ck")
    ckpt.save_collection(A, prefix)
    wrong = TwoDimBlockCyclic(64, 64, 16, 16)
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.restore_collection(wrong, prefix)


def _save_grid(prefix, nb_ranks, n, nb, P, Q):
    def save_rank(rank, fabric):
        d = TwoDimBlockCyclic(n, n, nb, nb, P=P, Q=Q, nodes=nb_ranks,
                              rank=rank, dtype=np.float32)
        return ckpt.save_collection(d, prefix)
    return spmd(nb_ranks, save_rank)[0]


def test_restore_rejects_wrong_rank_count_and_grid(tmp_path):
    """A snapshot written on a 4-rank 2x2 grid fails FAST when restored
    onto a 2-rank 2x1 grid, naming every mismatched field and both
    grids."""
    n, nb = 128, 32
    prefix = str(tmp_path / "grid")
    _save_grid(prefix, 4, n, nb, 2, 2)
    wrong = TwoDimBlockCyclic(n, n, nb, nb, P=2, Q=1, nodes=2, rank=0,
                              dtype=np.float32)
    with pytest.raises(ckpt.CheckpointMismatchError) as ei:
        ckpt.restore_collection(wrong, prefix)
    msg = str(ei.value)
    assert "nodes" in msg and "Q" in msg
    assert "4 rank(s), grid 2x2" in msg
    assert "2 rank(s), grid 2x1" in msg
    single = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
    with pytest.raises(ckpt.CheckpointMismatchError):
        ckpt.restore_collection(single, prefix)


def test_mismatch_error_aggregates_all_keys(tmp_path):
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(
        np.ones((64, 64), np.float32))
    prefix = str(tmp_path / "agg")
    ckpt.save_collection(A, prefix)
    wrong = TwoDimBlockCyclic(64, 64, 16, 16, dtype=np.float64)
    with pytest.raises(ckpt.CheckpointMismatchError) as ei:
        ckpt.restore_collection(wrong, prefix)
    msg = str(ei.value)
    assert "mb" in msg and "dtype" in msg


def test_restore_accepts_pre_ft_manifest(tmp_path):
    """Snapshots whose manifest lacks nodes/rank (the pre-ft format)
    still restore."""
    rng = np.random.RandomState(3)
    M = rng.rand(64, 64).astype(np.float32)
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(M)
    prefix = str(tmp_path / "oldfmt")
    path = ckpt.save_collection(A, prefix)
    with np.load(path, allow_pickle=False) as z:
        man = json.loads(str(z["__manifest__"]))
        tiles = {k: z[k] for k in z.files if k.startswith("t")}
    for k in ("nodes", "rank"):
        man.pop(k, None)
    np.savez(path, __manifest__=json.dumps(man), **tiles)
    B = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32)
    assert ckpt.restore_collection(B, prefix) == 4
    np.testing.assert_array_equal(B.to_numpy(), M)


def test_checkpoint_resume_mid_computation(ctx, tmp_path):
    """Factor, checkpoint at the quiescent point, restore into a fresh
    collection and continue with the solves."""
    from parsec_tpu_torch.ops import (dpotrf_taskpool, dtrsm_lower_taskpool,
                                      dtrsm_lower_trans_taskpool, make_spd)
    n, nb = 96, 32
    M = make_spd(n)
    rng = np.random.RandomState(1)
    Bm = (rng.rand(n, 16) - 0.5).astype(np.float32)
    A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    ctx.add_taskpool(dpotrf_taskpool(A))
    ctx.wait()
    prefix = str(tmp_path / "factored")
    ckpt.save_collection(A, prefix, context=ctx)
    A2 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
    assert ckpt.restore_collection(A2, prefix) == 9
    B = TwoDimBlockCyclic(n, 16, nb, nb, dtype=np.float32).from_numpy(Bm)
    ctx.add_taskpool(dtrsm_lower_taskpool(A2, B))
    ctx.wait()
    ctx.add_taskpool(dtrsm_lower_trans_taskpool(A2, B))
    ctx.wait()
    ref = np.linalg.solve(M.astype(np.float64), Bm.astype(np.float64))
    np.testing.assert_allclose(B.to_numpy(), ref, atol=5e-3)


def test_spmd_per_rank_shards(tmp_path):
    """Each rank writes only its own tiles; restore on the same grid
    reads them back rank-locally."""
    nb_ranks, n, nb = 4, 128, 32
    rng = np.random.RandomState(2)
    M = rng.rand(n, n).astype(np.float32)
    prefix = str(tmp_path / "shards")

    def save_rank(rank, fabric):
        d = TwoDimBlockCyclic(n, n, nb, nb, P=2, Q=2, nodes=nb_ranks,
                              rank=rank, dtype=np.float32)
        for (i, j) in d.local_tiles():
            np.copyto(d.tile(i, j),
                      M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        return ckpt.save_collection(d, prefix)

    paths, _ = spmd(nb_ranks, save_rank)
    assert len(set(paths)) == nb_ranks

    def restore_rank(rank, fabric):
        d = TwoDimBlockCyclic(n, n, nb, nb, P=2, Q=2, nodes=nb_ranks,
                              rank=rank, dtype=np.float32)
        count = ckpt.restore_collection(d, prefix)
        ok = all(np.array_equal(
            d.tile(i, j), M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
            for (i, j) in d.local_tiles())
        return count, ok

    results, _ = spmd(nb_ranks, restore_rank)
    assert sum(c for c, _ in results) == 16
    assert all(ok for _, ok in results)


def test_loose_array_roundtrip(tmp_path):
    prefix = str(tmp_path / "state")
    ckpt.save_arrays(prefix, step=np.int64(7),
                     w=np.arange(6.0).reshape(2, 3))
    back = ckpt.load_arrays(prefix)
    assert back["step"] == 7
    np.testing.assert_array_equal(back["w"], np.arange(6.0).reshape(2, 3))


def test_manifest_records_format_version(tmp_path):
    from parsec_tpu.utils import checkpoint as jax_ckpt
    assert ckpt.CHECKPOINT_VERSION == jax_ckpt.CHECKPOINT_VERSION
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(
        np.ones((64, 64), np.float32))
    path = ckpt.save_collection(A, str(tmp_path / "ver"))
    assert ckpt.read_manifest(path)["version"] == ckpt.CHECKPOINT_VERSION


def test_atomic_save_survives_midwrite_crash(tmp_path, monkeypatch):
    """A crash mid-``np.savez`` leaves the PUBLISHED path holding the
    previous complete snapshot, and no temp file behind."""
    M0 = np.full((64, 64), 7.0, np.float32)
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(M0)
    prefix = str(tmp_path / "atomic")
    ckpt.save_collection(A, prefix)
    real_savez = np.savez

    def dying_savez(f, **arrays):
        real_savez(f, **{k: arrays[k] for k in list(arrays)[:1]})
        raise KeyboardInterrupt("rank killed mid-snapshot")

    A2 = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(
        np.zeros((64, 64), np.float32))
    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_collection(A2, prefix)
    monkeypatch.undo()
    B = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32)
    assert ckpt.restore_collection(B, prefix) == 4
    np.testing.assert_array_equal(B.to_numpy(), M0)
    assert not glob.glob(str(tmp_path / "*.tmp.*"))


def test_torn_snapshot_raises_corrupt_not_mismatch(tmp_path):
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(
        np.ones((64, 64), np.float32))
    prefix = str(tmp_path / "torn")
    path = ckpt.save_collection(A, prefix)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 3])
    B = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32)
    with pytest.raises(ckpt.CheckpointCorruptError, match="torn"):
        ckpt.restore_collection(B, prefix)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_collection(B, str(tmp_path / "never_written"))


def test_mismatch_error_names_the_reshard_roadmap_item(tmp_path):
    """Distribution-only mismatches name the escape hatch — the
    resharding restore (``reshard=True``) and ``ft_elastic`` shrink — as
    the JAX package's message does; geometry mismatches do not (a tile
    size change is unrecoverable by resharding)."""
    n, nb = 128, 32
    prefix = str(tmp_path / "hatch")
    _save_grid(prefix, 4, n, nb, 2, 2)
    wrong_grid = TwoDimBlockCyclic(n, n, nb, nb, P=2, Q=1, nodes=2,
                                   rank=0, dtype=np.float32)
    with pytest.raises(ckpt.CheckpointMismatchError) as ei:
        ckpt.restore_collection(wrong_grid, prefix)
    assert "reshard=True" in str(ei.value)
    assert "ft_elastic" in str(ei.value)
    wrong_geom = TwoDimBlockCyclic(n, n, 16, 16, P=2, Q=2, nodes=4,
                                   rank=0, dtype=np.float32)
    with pytest.raises(ckpt.CheckpointMismatchError) as ei:
        ckpt.restore_collection(wrong_geom, prefix)
    assert "reshard=True" not in str(ei.value)


def test_reshard_true_on_the_matching_grid_restores_per_rank(tmp_path,
                                                             monkeypatch):
    """reshard=True on the grid the snapshot was written on takes the
    plain per-rank path (no redistribution), bit for bit."""
    import parsec_tpu_torch.ft.elastic as elastic

    def refuse(*a, **kw):
        raise AssertionError("the matching grid must not reshard")

    monkeypatch.setattr(elastic, "reshard_restore", refuse)
    M = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    A = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32).from_numpy(M)
    prefix = str(tmp_path / "rs")
    ckpt.save_collection(A, prefix)
    B = TwoDimBlockCyclic(64, 64, 32, 32, dtype=np.float32)
    assert ckpt.restore_collection(B, prefix, reshard=True) == 4
    np.testing.assert_array_equal(B.to_numpy(), M)


# --------------------------------------------------------------------- #
# the JAX package's format, both ways                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 1, 2), (2, 2, 4)])
def test_snapshot_restores_across_packages(tmp_path, direction, grid):
    """A snapshot written by either package restores into the other's
    collection bit-identical: same file names, tile keys, manifest."""
    from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBC
    from parsec_tpu.utils import checkpoint as jax_ckpt
    P, Q, nodes = grid
    n, nb = 96, 32
    rng = np.random.RandomState(11 + nodes)
    M = rng.standard_normal((n, n)).astype(np.float32)
    prefix = str(tmp_path / f"x.stage1.c0")
    writer, reader = ((JaxTwoDimBC, jax_ckpt), (TwoDimBlockCyclic, ckpt))
    if direction == "torch_to_jax":
        writer, reader = reader, writer
    paths = []
    for rank in range(nodes):
        d = writer[0](n, n, nb, nb, P=P, Q=Q, nodes=nodes, rank=rank,
                      dtype=np.float32)
        for (i, j) in d.local_tiles():
            d.set_tile(i, j, M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        paths.append(writer[1].save_collection(d, prefix))
    assert paths == [f"{prefix}.rank{r}.npz" for r in range(nodes)]
    for rank in range(nodes):
        d = reader[0](n, n, nb, nb, P=P, Q=Q, nodes=nodes, rank=rank,
                      dtype=np.float32)
        count = reader[1].restore_collection(d, prefix)
        assert count == len(list(d.local_tiles()))
        for (i, j) in d.local_tiles():
            np.testing.assert_array_equal(
                np.asarray(d.tile(i, j)),
                M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
    # the same manifest and tile keys as the other package writes
    d = writer[0](n, n, nb, nb, P=P, Q=Q, nodes=nodes, rank=0,
                  dtype=np.float32)
    with np.load(paths[0]) as z:
        assert json.loads(str(z["__manifest__"])) == \
            reader[1]._manifest_of(d)
        assert sorted(k for k in z.files if k != "__manifest__") == \
            sorted(f"t{i}_{j}" for (i, j) in d.local_tiles())


# --------------------------------------------------------------------- #
# device copies: the snapshot pulls them, the restore supersedes them   #
# --------------------------------------------------------------------- #
SCALE_CUDA_JDF = """
descA [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]

Scale(m, n)

m = 0 .. MT
n = 0 .. NT

: descA( m, n )

RW A <- descA( m, n )
     -> descA( m, n )

BODY [type=cuda]
{
    A = A * 2.0
}
END
"""


def test_restore_supersedes_stale_device_copies(ctx, tmp_path):
    """The full restore path on the device module (CPU tensors here):
    after a device stage, the snapshot holds the DEVICE values; a later
    device stage leaves newer device copies; a restore into the same
    collection writes the host copies; the re-run stages the restored
    values in and does not read the stale device copies."""
    n, nb = 64, 32
    rng = np.random.RandomState(5)
    M = rng.standard_normal((n, n)).astype(np.float32)
    A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    A.name = "descA"
    factory = ptg.compile_jdf(SCALE_CUDA_JDF, name="scale_cuda")
    dev = ctx.device_by_type("cuda")

    def stage():
        tasks = dev.stats["tasks"]
        ctx.add_taskpool(factory.new(descA=A, MT=A.mt - 1, NT=A.nt - 1))
        ctx.wait()
        assert dev.stats["tasks"] - tasks == A.mt * A.nt   # on the module

    stage()                                   # device copies = 2M
    prefix = str(tmp_path / "dev")
    ckpt.save_collection(A, prefix, context=ctx)
    with np.load(ckpt.checkpoint_path(prefix, 0)) as z:
        np.testing.assert_array_equal(z["t1_0"], 2 * M[nb:, :nb])
    stage()                                   # device copies = 4M
    assert ckpt.restore_collection(A, prefix, context=ctx) == 4
    for (i, j) in A.tiles():
        d = A.data_of(i, j)
        stale = d.get_copy(dev.device_index)
        assert stale is not None
        np.testing.assert_array_equal(          # the stale copy is there
            np.asarray(stale.payload),
            4 * M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        assert d.newest_copy().device_id == 0   # but the host is newest
    stage()                                   # from the restored 2M
    np.testing.assert_array_equal(A.to_numpy(), 4 * M)
