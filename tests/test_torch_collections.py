"""The port's collections (distribution math, storage variants,
k-cyclicity, bands, tabular and vector layouts) against the JAX
package's: the cases of tests/test_collections.py (the reference's
tests/collections/), each run through both packages, the observations
compared and held to the reference's values.
"""
import numpy as np
import pytest

import parsec_tpu.collections
import parsec_tpu_torch.collections

JAX = parsec_tpu
PORT = parsec_tpu_torch


def _both(fn):
    """``fn(collections module)`` through the JAX package and the port:
    the two observations, which must agree; returns the port's."""
    want = fn(JAX.collections)
    got = fn(PORT.collections)
    assert _eq(got, want), (got, want)
    return got


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


def _raises(fn, exc):
    try:
        fn()
    except exc:
        return exc.__name__
    return None


def test_tiled_matrix_geometry():
    def geo(c):
        A = c.TiledMatrix(100, 60, 32, 16)
        return ((A.mt, A.nt), tuple(A.tile_shape(0, 0)),
                tuple(A.tile_shape(3, 3)), sorted(A.tiles()))
    mtnt, first, edge, tiles = _both(geo)
    # partial edge tiles
    assert mtnt == (4, 4) and first == (32, 16) and edge == (4, 12)
    assert len(tiles) == 16


def test_tiled_roundtrip_numpy():
    M = np.arange(48 * 48, dtype=np.float64).reshape(48, 48)

    def roundtrip(c):
        A = c.TiledMatrix(48, 48, 16, 16, dtype=np.float64)
        A.from_numpy(M)
        return A.to_numpy(), np.array(A.tile(1, 2))
    back, tile = _both(roundtrip)
    np.testing.assert_array_equal(back, M)
    np.testing.assert_array_equal(tile, M[16:32, 32:48])


def test_block_cyclic_rank_math():
    """2x2 grid, no k-cyclicity: round-robin in both dimensions."""
    def ranks(c):
        A = c.TwoDimBlockCyclic(64, 64, 8, 8, P=2, Q=2)
        counts = {}
        for t in A.tiles():
            counts[A.rank_of(*t)] = counts.get(A.rank_of(*t), 0) + 1
        return (A.nodes, [A.rank_of(*t) for t in sorted(A.tiles())],
                sorted(counts.items()))
    nodes, table, counts = _both(ranks)
    assert nodes == 4 and table[:2] == [0, 1] and table[8:10] == [2, 3]
    # every rank owns exactly 1/4 of the 8x8 tiles
    assert counts == [(0, 16), (1, 16), (2, 16), (3, 16)]


def test_block_cyclic_kcyclic():
    """krows=2: pairs of consecutive tile rows land on one P row."""
    table = _both(lambda c: [c.TwoDimBlockCyclic(
        64, 64, 8, 8, P=2, Q=1, krows=2).rank_of(m, 0) for m in range(8)])
    assert table == [0, 0, 1, 1, 0, 0, 1, 1]


def test_sym_storage_rejects_wrong_triangle():
    def sym(c):
        A = c.SymTwoDimBlockCyclic(64, 64, 16, 16, uplo="lower")
        A.data_of(2, 1)
        return (sorted(A.tiles()),
                _raises(lambda: A.data_of(1, 2), AssertionError))
    tiles, refused = _both(sym)
    assert len(tiles) == 10 and refused == "AssertionError"


def test_sym_to_numpy_mirrors():
    t = np.random.RandomState(0).rand(16, 16).astype(np.float32)

    def mirror(c):
        A = c.SymTwoDimBlockCyclic(32, 32, 16, 16, uplo="lower")
        A.set_tile(1, 0, t)
        return A.to_numpy()
    M = _both(mirror)
    np.testing.assert_allclose(M[16:32, 0:16], t)
    np.testing.assert_allclose(M[0:16, 16:32], t.T)


def test_band_distribution():
    def band(c):
        A = c.TwoDimBlockCyclicBand(64, 64, 8, 8, band_size=2, P=2, Q=2)
        return ([A.in_band(3, 3), A.in_band(3, 4), A.in_band(3, 5)],
                _raises(lambda: A.data_of(0, 5), AssertionError),
                sorted(A.tiles()), [A.rank_of(*t) for t in sorted(A.tiles())])
    inb, refused, tiles, _ranks = _both(band)
    assert inb == [True, True, False] and refused == "AssertionError"
    assert all(abs(m - n) < 2 for m, n in tiles)


def test_tabular_distribution():
    def tab(c):
        A = c.TwoDimTabular.random(32, 32, 8, 8, nodes=3, seed=42)
        return ([A.rank_of(m, n) for (m, n) in sorted(A.tiles())],
                A.rank_of(1, 2) == A.rank_table[1, 2])
    table, agrees = _both(tab)
    assert all(0 <= r < 3 for r in table) and agrees


def test_vector_cyclic():
    def vec(c):
        v = c.VectorTwoDimCyclic(100, 10, P=4)
        return (v.mt, [v.rank_of(k) for k in range(8)],
                tuple(v.data_of(3).get_copy(0).payload.shape))
    assert _both(vec) == (10, [0, 1, 2, 3, 0, 1, 2, 3], (10, 1))


def test_dict_collection_remote_entries():
    def dct(c):
        d = c.DictCollection(nodes=2, rank=0)
        d.add("x", 0, np.zeros(3))
        d.add("y", 1)  # remote, no local payload
        return (d.rank_of("x"), d.rank_of("y"),
                _raises(lambda: d.data_of("y"), KeyError))
    assert _both(dct) == (0, 1, "KeyError")


def test_local_array_collection_views_alias():
    def views(c):
        base = np.zeros((8, 2))
        d = c.LocalArrayCollection(base, 4).data_of(1)
        d.get_copy(0).payload[:] = 7.0
        return base   # tiles are views, not copies
    base = _both(views)
    assert np.all(base[2:4] == 7.0) and np.all(base[:2] == 0)


def test_sym_band_collection():
    """Band + triangular storage (ref: sym_two_dim_rectangle_cyclic_band)."""
    def symband(c):
        A = c.SymTwoDimBlockCyclicBand(8 * 8, 8 * 8, 8, 8, band_size=2,
                                       uplo="lower", P=2, Q=1, nodes=2)
        return (sorted(A.tiles()), A.rank_of(2, 2), A.rank_of(3, 3),
                _raises(lambda: A.data_of(7, 0), AssertionError))
    ts, r22, r33, refused = _both(symband)
    # lower-triangular AND within the band
    assert all(n <= m and m - n < 2 for (m, n) in ts)
    assert (3, 2) in ts and (3, 3) in ts
    assert (3, 0) not in ts and (2, 3) not in ts
    assert r22 != r33 and refused == "AssertionError"


@pytest.mark.parametrize("P,Q", [(1, 1), (2, 1), (2, 3)])
def test_block_cyclic_owned_tiles_agree(P, Q):
    """Each rank of a P x Q grid owns the same tiles in both packages,
    ragged edges included."""
    def owned(c):
        out = []
        for r in range(P * Q):
            A = c.TwoDimBlockCyclic(100, 70, 16, 16, P=P, Q=Q, nodes=P * Q,
                                    rank=r)
            out.append(sorted(A.local_tiles()))
        return out
    tiles = _both(owned)
    assert sum(len(t) for t in tiles) == 7 * 5
