"""The port's collection-wide operations (parsec_tpu_torch/collections/
ops.py: apply, map_operator, the tree reductions, broadcast,
band_to_rect, allreduce) as PTG graphs: every case of the JAX package's
``tests/test_collection_ops.py``, each run by both packages on the same
seeded numpy input, the port's result held against the JAX package's
(exactly: the same folds in the same order) and against numpy."""
import numpy as np
import pytest

import parsec_tpu
import parsec_tpu_torch as ptt
from parsec_tpu.collections import TwoDimBlockCyclic as JaxTwoDimBC
from parsec_tpu.collections import ops as jax_cops
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.collections import ops as cops

TILE = 4
PACKAGES = {"torch": (lambda: ptt.init(nb_cores=2, device="cpu"),
                      TwoDimBlockCyclic, cops),
            "jax": (lambda: parsec_tpu.init(nb_cores=2, enable_tpu=False),
                    JaxTwoDimBC, jax_cops)}


def _mk(M, pkg):
    mt, nt = M.shape[0] // TILE, M.shape[1] // TILE
    return PACKAGES[pkg][1](mt * TILE, nt * TILE, TILE, TILE).from_numpy(M)


def _seeded(mt, nt, seed):
    return np.random.RandomState(seed).rand(mt * TILE, nt * TILE).astype(
        np.float32)


def _both(run):
    """``run(ctx, make, ops)`` in each package; returns {pkg: result}."""
    out = {}
    for pkg, (init, _cls, ops) in PACKAGES.items():
        ctx = init()
        try:
            out[pkg] = run(ctx, lambda M, p=pkg: _mk(M, p), ops)
        finally:
            ctx.fini()
    np.testing.assert_array_equal(out["torch"], out["jax"])
    return out["torch"]


def _add(a, b, _args):
    return a + b


def test_apply_full():
    M = _seeded(3, 3, 0)

    def run(ctx, mk, ops):
        A = mk(M)
        ops.apply(ctx, A, lambda t, region, m, n, args: t * 2.0)
        return A.to_numpy()

    np.testing.assert_allclose(_both(run), M * 2.0, rtol=1e-6)


def test_apply_lower():
    M = _seeded(3, 3, 1)

    def run(ctx, mk, ops):
        A = mk(M)
        ops.apply(ctx, A, lambda t, region, m, n, args: t + 1.0,
                  uplo="lower")
        return A.to_numpy()

    exp = M.copy()
    for m in range(3):
        for n in range(m + 1):
            exp[m * TILE:(m + 1) * TILE, n * TILE:(n + 1) * TILE] += 1.0
    np.testing.assert_allclose(_both(run), exp, rtol=1e-6)


def test_apply_upper_region_arg():
    """The diagonal task receives region=uplo so ops can mask."""
    M = _seeded(2, 2, 2)

    def run(ctx, mk, ops):
        seen = []

        def op(t, region, m, n, args):
            seen.append((region, m, n))
            return t

        ops.apply(ctx, mk(M), op, uplo="upper")
        return np.array(sorted(seen), dtype=object)

    seen = [tuple(s) for s in _both(run)]
    assert {s[0] for s in seen if s[1] == s[2]} == {"upper"}
    assert ("full", 0, 1) in seen
    assert all(not (m > n) for (_, m, n) in seen)


def test_map_operator():
    Ms, Md = _seeded(2, 3, 3), _seeded(2, 3, 4)

    def run(ctx, mk, ops):
        S, D = mk(Ms), mk(Md)
        ops.map_operator(ctx, S, D, lambda s, d, m, n, args: s * d + m + n)
        return D.to_numpy()

    exp = np.empty_like(Md)
    for m in range(2):
        for n in range(3):
            sl = np.s_[m * TILE:(m + 1) * TILE, n * TILE:(n + 1) * TILE]
            exp[sl] = Ms[sl] * Md[sl] + m + n
    np.testing.assert_allclose(_both(run), exp, rtol=1e-6)


@pytest.mark.parametrize("mt", [1, 2, 3, 5, 8])
def test_reduce_col(mt):
    M = _seeded(mt, 2, mt)

    def run(ctx, mk, ops):
        A = mk(M)
        dest = ops.reduce_col(ctx, A, _add)
        np.testing.assert_array_equal(A.to_numpy(), M)   # source untouched
        return dest.to_numpy()

    exp = sum(M[m * TILE:(m + 1) * TILE] for m in range(mt))
    np.testing.assert_allclose(_both(run), exp, rtol=1e-5)


@pytest.mark.parametrize("nt", [1, 3, 4, 7])
def test_reduce_row(nt):
    M = _seeded(2, nt, 10 + nt)

    def run(ctx, mk, ops):
        return ops.reduce_row(ctx, mk(M), _add).to_numpy()

    exp = sum(M[:, n * TILE:(n + 1) * TILE] for n in range(nt))
    np.testing.assert_allclose(_both(run), exp, rtol=1e-5)


@pytest.mark.parametrize("mt,nt", [(1, 1), (2, 2), (3, 5)])
def test_reduce_all(mt, nt):
    M = _seeded(mt, nt, 20 + mt + nt)

    def run(ctx, mk, ops):
        return ops.reduce_all(ctx, mk(M), _add).to_numpy()

    exp = np.zeros((TILE, TILE), dtype=np.float32)
    for m in range(mt):
        for n in range(nt):
            exp += M[m * TILE:(m + 1) * TILE, n * TILE:(n + 1) * TILE]
    np.testing.assert_allclose(_both(run), exp, rtol=1e-5)


def test_reduce_max_op():
    """Non-additive fold: elementwise max."""
    M = _seeded(5, 1, 42)

    def run(ctx, mk, ops):
        return ops.reduce_col(ctx, mk(M),
                              lambda a, b, _: np.maximum(a, b)).to_numpy()

    np.testing.assert_allclose(_both(run),
                               np.max(M.reshape(5, TILE, TILE), axis=0),
                               rtol=0)


def test_broadcast():
    Ms, Md = _seeded(2, 2, 7), _seeded(3, 3, 8)

    def run(ctx, mk, ops):
        D = mk(Md)
        ops.broadcast(ctx, mk(Ms), D, root=(1, 0))
        return D.to_numpy()

    got = _both(run)
    root = Ms[TILE:2 * TILE, 0:TILE]
    for m in range(3):
        for n in range(3):
            np.testing.assert_array_equal(
                got[m * TILE:(m + 1) * TILE, n * TILE:(n + 1) * TILE], root)


def test_band_to_rect():
    M = _seeded(4, 4, 9)

    def run(ctx, mk, ops):
        rect = mk(np.zeros((2 * TILE, 4 * TILE), np.float32))
        ctx.add_taskpool(ops.band_to_rect_taskpool(mk(M), rect))
        ctx.wait()
        return rect.to_numpy()

    got = _both(run)
    for k in range(4):
        sl = np.s_[k * TILE:(k + 1) * TILE]
        np.testing.assert_array_equal(got[0:TILE, sl],
                                      M[sl, k * TILE:(k + 1) * TILE])
        if k >= 1:
            np.testing.assert_array_equal(
                got[TILE:2 * TILE, sl],
                M[(k - 1) * TILE:k * TILE, k * TILE:(k + 1) * TILE])


def test_allreduce_in_place():
    """reduce+broadcast composition: every tile ends with the global
    fold."""
    M = np.random.RandomState(5).rand(6 * 4, 4 * 4).astype(np.float32)

    def run(ctx, mk, ops):
        A = mk(M)
        ops.allreduce(ctx, A, lambda a, b, args: np.maximum(a, b))
        return A.to_numpy()

    out = _both(run)
    tiles = M.reshape(6, 4, 4, 4).transpose(0, 2, 1, 3).reshape(24, 4, 4)
    expect = np.maximum.reduce(tiles)
    for i in range(6):
        for j in range(4):
            np.testing.assert_array_equal(
                out[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4], expect)


def test_ops_read_device_resident_tiles():
    """A collection whose newest tiles live in the device module (CPU
    tensors here; the card in chip_smoke.py's collection_ops phase):
    the host bodies of reduce_all and apply pull them first."""
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
    n, nb = 64, 16
    M = make_spd(n)
    ctx = ptt.init(nb_cores=2, device="cpu")
    try:
        A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        ctx.add_taskpool(dpotrf_taskpool(A))
        ctx.wait()
        dev = ctx.device_by_type("cuda")
        assert A.data_of(1, 0).newest_copy().device_id == dev.device_index
        ref = A.to_numpy()   # syncs the host copies
        A2 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        ctx.add_taskpool(dpotrf_taskpool(A2))
        ctx.wait()
        total = cops.reduce_all(ctx, A2, _add).to_numpy()
        cops.apply(ctx, A2, lambda t, region, m, n, args: t * 0.5,
                   uplo="lower")
        got = A2.to_numpy()
    finally:
        ctx.fini()
    nt = n // nb
    tiles = [ref[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
             for i in range(nt) for j in range(nt)]
    np.testing.assert_allclose(total, np.sum(tiles, axis=0), rtol=1e-5,
                               atol=1e-5)
    for i in range(nt):
        for j in range(nt):
            sl = np.s_[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            scale = np.float32(0.5) if j <= i else np.float32(1.0)
            np.testing.assert_array_equal(got[sl], ref[sl] * scale)
