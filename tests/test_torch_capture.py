"""Whole-graph capture in the port (parsec_tpu_torch.dsl.ptg.capture,
parsec_tpu_torch.dsl.dtd.capture, dsl/graph.py) against the JAX
package's capture.

On the CPU a captured graph runs its bodies eagerly over host tensors
(``run(device="cpu")``, ``dtd_capture(device="cpu")``); on a CUDA device
it records one CUDA graph and replays it.  Both packages run the same
numpy inputs.  The JAX package computes with XLA, the port with PyTorch,
so the two agree to the JAX tests' own tolerances; inside the port the
captured results are bit-identical to the interpreted runtime's (each
tile's chain of updates is fixed by the dependences, and every body is
the same).  The ``gpu``-marked tests run on the card only.
"""
import numpy as np
import pytest
import torch

import parsec_tpu  # noqa: F401  (both frameworks in one process)
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.dsl import ptg as jptg
import parsec_tpu.dsl.dtd as jdtd
from parsec_tpu.dsl.dtd import capture as jcap
from parsec_tpu.ops import (dgeqrf_taskpool as jdgeqrf_taskpool,
                            dgetrf_nopiv_taskpool as jdgetrf_nopiv_taskpool,
                            dpotrf_taskpool as jdpotrf_taskpool,
                            pdgemm_taskpool as jpdgemm_taskpool)
from parsec_tpu.ops.dtrsm import (dtrsm_lower_taskpool as jtrsm_lower,
                                  dtrsm_lower_trans_taskpool as jtrsm_lower_t)

import parsec_tpu_torch
import parsec_tpu_torch.dsl.dtd as tdtd
from parsec_tpu_torch import dtd, ops
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.dtd import INOUT, INPUT, VALUE, unpack_args
from parsec_tpu_torch.dsl.dtd import capture as tcap
from parsec_tpu_torch.dsl.ptg.capture import plan
from parsec_tpu_torch.ops import (dgeqrf_taskpool, dgetrf_nopiv_taskpool,
                                  dpotrf_taskpool, make_diag_dominant,
                                  make_spd, pdgemm_taskpool)
from parsec_tpu_torch.ops.dtrsm import (dtrsm_lower_taskpool,
                                        dtrsm_lower_trans_taskpool)

RTOL = 1e-5   # fp32 results of two libraries (dtd_capture's graphs)


def _run_tp(tp, device="cpu"):
    ctx = parsec_tpu_torch.init(nb_cores=2, device=device)
    try:
        ctx.add_taskpool(tp)
        ctx.wait()
    finally:
        ctx.fini()


# --------------------------------------------------------------------- #
# test_dtd_capture.py, through both packages                            #
# --------------------------------------------------------------------- #
def _graphs():
    """(graph, its package's DTD module) for the JAX package and the
    port; the port's graph runs eagerly on the CPU."""
    return [(jcap.dtd_capture(), jdtd), (tcap.dtd_capture(device="cpu"), tdtd)]


def _val(g, t):
    return np.asarray(g.value(t))


def test_chain_scales_once_dispatch():
    vals = []
    for g, m in _graphs():
        a = g.tile_of_array(np.ones((8, 8), np.float32))
        for _ in range(10):
            g.insert_task(lambda x, s: x * s, (a, m.INOUT), (2.0, m.VALUE))
        assert g.nb_tasks == 10
        g.run()
        vals.append(_val(g, a))
    np.testing.assert_array_equal(vals[1], np.full((8, 8), 1024.0))
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL)


def test_gemm_accumulate_graph():
    n = 16
    rng = np.random.RandomState(0)
    An = rng.rand(n, n).astype(np.float32)
    Bn = rng.rand(n, n).astype(np.float32)
    vals = []
    for g, m in _graphs():
        A, B = g.tile_of_array(An), g.tile_of_array(Bn)
        C = g.tile(("C",), shape=(n, n))
        for _ in range(3):
            g.insert_task(lambda a, b, c: c + a @ b,
                          (A, m.INPUT), (B, m.INPUT), (C, m.INOUT))
        g.run()
        vals.append(_val(g, C))
    np.testing.assert_allclose(vals[1], 3 * (An @ Bn), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL)


def test_gemm_chore_graph_runs_the_gemm_body():
    """The port's tile body (the GEMM kernel's plain version on the CPU)
    as a captured chore, against the JAX package's jnp graph."""
    n = 16
    rng = np.random.RandomState(1)
    An, Bn, Cn = (rng.rand(n, n).astype(np.float32) for _ in range(3))
    (jg, jm), (tg, tm) = _graphs()
    vals = []
    for g, m, fn in ((jg, jm, lambda c, a, b: c - a @ b.T),
                     (tg, tm, ops.gemm_nt)):
        A, B, C = g.tile_of_array(An), g.tile_of_array(Bn), g.tile_of_array(Cn)
        for _ in range(2):
            g.insert_task(fn, (C, m.INOUT), (A, m.INPUT), (B, m.INPUT))
        g.run()
        vals.append(_val(g, C))
    np.testing.assert_allclose(vals[1], Cn - 2 * (An @ Bn.T), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL, atol=RTOL)


def test_multiple_written_flows():
    vals = []
    for g, m in _graphs():
        x = g.tile_of_array(np.full((4,), 3.0, np.float32))
        y = g.tile_of_array(np.full((4,), 4.0, np.float32))
        g.insert_task(lambda a, b, s: (b * s, a * s),
                      (x, m.INOUT), (y, m.INOUT), (10.0, m.VALUE))
        g.run()
        vals.append((_val(g, x), _val(g, y)))
    np.testing.assert_array_equal(vals[1][0], np.full(4, 40.0))
    np.testing.assert_array_equal(vals[1][1], np.full(4, 30.0))
    for j, t in zip(*vals):
        np.testing.assert_allclose(t, j, rtol=RTOL)


def test_output_only_flow_and_war():
    """WAR over a tile: a read inserted before an overwrite sees the old
    value — insertion order is the serialization."""
    vals = []
    for g, m in _graphs():
        src = g.tile_of_array(np.full((4,), 7.0, np.float32))
        cpy = g.tile(("copy",), shape=(4,))
        g.insert_task(lambda s, _c: s + 0, (src, m.INPUT), (cpy, m.OUTPUT))
        g.insert_task(lambda s: s * 0, (src, m.INOUT))
        g.run()
        vals.append((_val(g, cpy), _val(g, src)))
    np.testing.assert_array_equal(vals[1][0], np.full(4, 7.0))
    np.testing.assert_array_equal(vals[1][1], np.zeros(4))
    for j, t in zip(*vals):
        np.testing.assert_allclose(t, j, rtol=RTOL)


def test_copy_chore_writes_the_other_tile():
    """A chore handing one tile's input to another tile writes that tile,
    as in the JAX package's graph (which returns the whole state)."""
    vals = []
    for g, m in _graphs():
        src = g.tile_of_array(np.full((4,), 7.0, np.float32))
        dst = g.tile_of_array(np.zeros((4,), np.float32))
        g.insert_task(lambda s, _d: s, (src, m.INPUT), (dst, m.OUTPUT))
        g.run()
        vals.append((_val(g, dst), _val(g, src)))
    np.testing.assert_array_equal(vals[1][0], np.full(4, 7.0))
    np.testing.assert_array_equal(vals[1][1], np.full(4, 7.0))
    for j, t in zip(*vals):
        np.testing.assert_allclose(t, j, rtol=RTOL)


def test_in_place_chore_writes_its_tile():
    """A chore that writes its tile in place and hands it back wrote it;
    the caller's initial array stays as it was."""
    vals = []
    init = np.full((4,), 3.0, np.float32)
    for (g, m), fn in zip(_graphs(), (lambda x: x * 2.0,
                                      lambda x: x.mul_(2.0))):
        a = g.tile_of_array(init)
        g.insert_task(fn, (a, m.INOUT))
        g.run()
        vals.append(_val(g, a))
    np.testing.assert_array_equal(vals[1], np.full(4, 6.0))
    np.testing.assert_array_equal(init, np.full(4, 3.0))
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL)


def test_matches_runtime_dtd_execution():
    """Captured replay == the live DTD runtime on the same program, in
    the port (bit-identical) and against the JAX package's capture."""
    steps = [1.5, 2.0, 0.5, 3.0]
    ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(np.full((4, 4), 2.0, np.float32))

        def scale(es, task):
            x, s = unpack_args(task)
            x *= s

        for s in steps:
            tp.insert_task(scale, (tile, INOUT), (s, VALUE))
        tp.data_flush_all()
        tp.wait()
        runtime_out = np.array(tile.data.get_copy(0).payload)
    finally:
        ctx.fini()
    vals = []
    for g, m in _graphs():
        t = g.tile_of_array(np.full((4, 4), 2.0, np.float32))
        for s in steps:
            g.insert_task(lambda x, s: x * s, (t, m.INOUT), (s, m.VALUE))
        g.run()
        vals.append(_val(g, t))
    np.testing.assert_array_equal(vals[1], runtime_out)
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL)


def test_mixed_anon_and_named_tile_keys():
    vals = []
    for g, m in _graphs():
        a = g.tile_of_array(np.full((4,), 2.0, np.float32))
        c = g.tile("named", shape=(4,))
        g.insert_task(lambda x, _c: x * 5, (a, m.INPUT), (c, m.OUTPUT))
        g.run()
        vals.append(_val(g, c))
    np.testing.assert_array_equal(vals[1], np.full(4, 10.0))
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL)


def test_output_first_tile_needs_no_initial():
    """A tile whose first access is pure OUTPUT needs no shape/initial;
    its placeholder is the conventionally-ignored positional arg."""
    vals = []
    for g, m in _graphs():
        src = g.tile_of_array(np.full((4,), 2.0, np.float32))
        dst = g.tile("dst")
        g.insert_task(lambda s, _d: s + 1, (src, m.INPUT), (dst, m.OUTPUT))
        g.insert_task(lambda d: d * 2, (dst, m.INOUT))
        g.run()
        vals.append(_val(g, dst))
    np.testing.assert_array_equal(vals[1], np.full(4, 6.0))
    np.testing.assert_allclose(vals[1], vals[0], rtol=RTOL)


def test_insert_after_run_retraces():
    vals = []
    for g, m in _graphs():
        a = g.tile_of_array(np.ones((4,), np.float32))
        g.insert_task(lambda x: x + 1, (a, m.INOUT))
        g.run()
        first = _val(g, a)
        g.insert_task(lambda x: x * 10, (a, m.INOUT))
        g.run()
        vals.append((first, _val(g, a)))
    np.testing.assert_array_equal(vals[1][0], np.full(4, 2.0))
    np.testing.assert_array_equal(vals[1][1], np.full(4, 20.0))


def _errors(cap, m, **kw):
    """The exception type of each error case of test_dtd_capture.py."""
    types = []
    g = cap.dtd_capture(**kw)
    g.insert_task(lambda x: x, (g.tile(("uninit",)), m.INOUT))
    with pytest.raises(ValueError, match="no initial array") as ei:
        g.run()
    types.append(ei.type)
    with pytest.raises(TypeError, match="CaptureTile") as ei:
        cap.dtd_capture(**kw).insert_task(lambda x: x, (np.ones(3), m.INOUT))
    types.append(ei.type)
    g3 = cap.dtd_capture(**kw)
    b = g3.tile_of_array(np.ones((2,), np.float32))
    c = g3.tile_of_array(np.ones((2,), np.float32))
    g3.insert_task(lambda x, y: x, (b, m.INOUT), (c, m.INOUT))
    with pytest.raises(ValueError, match="written") as ei:
        g3.run()
    types.append(ei.type)
    with pytest.raises(RuntimeError, match="run") as ei:
        g3.value(b)
    types.append(ei.type)
    return types


def test_errors():
    assert _errors(tcap, tdtd, device="cpu") == _errors(jcap, jdtd)


def test_rebinding_tile_key_raises():
    types = []
    for g, m in _graphs():
        a = np.ones((4,), np.float32)
        t = g.tile_of_array(a, key="x")
        assert g.tile_of_array(a, key="x") is t
        with pytest.raises(ValueError) as e1:
            g.tile_of_array(np.zeros((4,), np.float32), key="x")
        g.tile("z", shape=(2, 2))
        with pytest.raises(ValueError) as e2:
            g.tile("z", shape=(3, 3))
        types.append((e1.type, e2.type))
    assert types[0] == types[1]


def test_shapeless_tile_binds_shape_on_redeclare():
    for (g, _m), (g2, _m2) in zip(_graphs(), _graphs()):
        t = g.tile("w")
        t2 = g.tile("w", shape=(2, 3))
        assert t2 is t and t.initial.shape == (2, 3)
        g2.tile("k", shape=(4,), dtype=np.float64)
        assert g2.tile("k", shape=(4,)).initial.dtype == np.float64


def test_dtd_capture_without_card_raises(monkeypatch):
    """dtd_capture() runs on cuda:0 and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PARSEC_MCA_device_cuda_platform", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcap.dtd_capture()


def _dtd_cholesky_graph(g, M, nb):
    """The dtd phase's Cholesky, recorded through dtd_capture."""
    n = M.shape[0]
    nt = n // nb
    T = {(m, k): g.tile_of_array(M[m * nb:(m + 1) * nb, k * nb:(k + 1) * nb],
                                 key=(m, k))
         for m in range(nt) for k in range(m + 1)}
    for k in range(nt):
        g.insert_task(ops.potrf, (T[k, k], INOUT))
        for m in range(k + 1, nt):
            g.insert_task(ops.trsm_panel, (T[k, k], INPUT), (T[m, k], INOUT))
        for m in range(k + 1, nt):
            g.insert_task(ops.syrk_ln, (T[m, m], INOUT), (T[m, k], INPUT))
            for n_ in range(k + 1, m):
                g.insert_task(ops.gemm_nt, (T[m, n_], INOUT),
                              (T[m, k], INPUT), (T[n_, k], INPUT))
    return T


def test_dtd_captured_cholesky_bit_identical_to_ptg():
    n, nb = 128, 32
    M = make_spd(n)
    A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    _run_tp(dpotrf_taskpool(A))
    g = tcap.dtd_capture(device="cpu")
    T = _dtd_cholesky_graph(g, M, nb)
    assert g.nb_tasks == 4 + 6 + 6 + 4
    g.run()
    for (m, k), t in T.items():
        np.testing.assert_array_equal(_val(g, t), A.tile(m, k))


# --------------------------------------------------------------------- #
# test_ptg_capture.py                                                   #
# --------------------------------------------------------------------- #
def _spd(n, nb, seed=0, coll=TwoDimBlockCyclic):
    M = make_spd(n, seed=seed)
    return M, coll(n, n, nb, nb, dtype=np.float32).from_numpy(M)


def test_capture_plan_matches_runtime_task_count():
    _, A = _spd(256, 64)
    cg = ptg.capture(dpotrf_taskpool(A))
    nt = A.nt
    expect = nt + nt * (nt - 1) + nt * (nt - 1) * (nt - 2) // 6
    assert cg.nb_tasks == expect
    assert len(plan(dpotrf_taskpool(A))) == expect
    _, JA = _spd(256, 64, coll=JTwoDimBlockCyclic)
    assert jptg.capture(jdpotrf_taskpool(JA)).nb_tasks == expect


@pytest.mark.parametrize("n,nb,seed", [(256, 64, 0), (192, 64, 3),
                                       (100, 32, 1)])
def test_captured_dpotrf(n, nb, seed):
    """Against the Cholesky residual, the JAX package's captured factor,
    and (bit for bit) the port's interpreted runtime."""
    M, A1 = _spd(n, nb, seed)
    ptg.capture(dpotrf_taskpool(A1)).run(device="cpu")
    L = np.tril(A1.to_numpy())
    assert np.linalg.norm(L @ L.T - M) / np.linalg.norm(M) < 1e-5
    _, JA = _spd(n, nb, seed, coll=JTwoDimBlockCyclic)
    jptg.capture(jdpotrf_taskpool(JA)).run()
    np.testing.assert_allclose(L, np.tril(JA.to_numpy()), rtol=2e-4,
                               atol=2e-4)
    _, A2 = _spd(n, nb, seed)
    _run_tp(dpotrf_taskpool(A2))
    np.testing.assert_array_equal(A1.to_numpy(), A2.to_numpy())


def test_captured_dgetrf_nopiv():
    n, nb = 192, 64
    M = make_diag_dominant(n, dtype=np.float32)
    A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    ptg.capture(dgetrf_nopiv_taskpool(A)).run(device="cpu")
    LU = A.to_numpy()
    L = np.tril(LU, -1) + np.eye(n, dtype=np.float32)
    assert np.linalg.norm(L @ np.triu(LU) - M) / np.linalg.norm(M) < 1e-4
    JA = JTwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    jptg.capture(jdgetrf_nopiv_taskpool(JA)).run()
    np.testing.assert_allclose(LU, JA.to_numpy(), rtol=1e-4, atol=1e-4)
    A2 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    _run_tp(dgetrf_nopiv_taskpool(A2))
    np.testing.assert_array_equal(LU, A2.to_numpy())


def test_captured_dgeqrf():
    n, nb = 192, 64
    M = np.random.RandomState(5).rand(n, n).astype(np.float32)
    A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    ptg.capture(dgeqrf_taskpool(A)).run(device="cpu")
    R = np.triu(A.to_numpy())
    assert np.linalg.norm(R.T @ R - M.T @ M) / np.linalg.norm(M.T @ M) < 1e-3
    JA = JTwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    jptg.capture(jdgeqrf_taskpool(JA)).run()
    # R is unique up to the signs of its rows
    JR = np.triu(JA.to_numpy())
    np.testing.assert_allclose(np.abs(R), np.abs(JR), rtol=1e-3, atol=1e-3)
    A2 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    _run_tp(dgeqrf_taskpool(A2))
    np.testing.assert_array_equal(A.to_numpy(), A2.to_numpy())


def test_captured_pdgemm_two_collections():
    n, nb = 128, 64
    rng = np.random.RandomState(7)
    An, Bn = rng.rand(n, n).astype(np.float32), rng.rand(n, n).astype(np.float32)
    Z = np.zeros((n, n), np.float32)

    def colls(coll):
        return [coll(n, n, nb, nb, dtype=np.float32).from_numpy(x)
                for x in (An, Bn, Z)]

    A, B, C = colls(TwoDimBlockCyclic)
    cg = ptg.capture(pdgemm_taskpool(A, B, C, alpha=1.0, beta=0.0))
    cg.run(device="cpu")
    np.testing.assert_allclose(C.to_numpy(), An @ Bn, rtol=1e-3, atol=1e-3)
    JA, JB, JC = colls(JTwoDimBlockCyclic)
    jcg = jptg.capture(jpdgemm_taskpool(JA, JB, JC, alpha=1.0, beta=0.0))
    assert cg.nb_tasks == jcg.nb_tasks
    jcg.run()
    np.testing.assert_allclose(C.to_numpy(), JC.to_numpy(), rtol=1e-3,
                               atol=1e-3)
    A2, B2, C2 = colls(TwoDimBlockCyclic)
    _run_tp(pdgemm_taskpool(A2, B2, C2, alpha=1.0, beta=0.0))
    np.testing.assert_array_equal(C.to_numpy(), C2.to_numpy())


def _dposv_colls(coll, M, Bn, nb):
    n, nrhs = Bn.shape
    A = coll(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    B = coll(n, nrhs, nb, nb, dtype=np.float32).from_numpy(Bn)
    A.name, B.name = "descA", "descB"
    return A, B


def test_captured_sequence_dposv():
    """dposv = dpotrf ; trsm_lower ; trsm_lower^T as ONE graph; matches
    numpy's solve and the JAX package's captured sequence."""
    n, nb, nrhs = 192, 64, 64
    M = make_spd(n, seed=9)
    Bn = np.random.RandomState(9).rand(n, nrhs).astype(np.float32)
    A, B = _dposv_colls(TwoDimBlockCyclic, M, Bn, nb)
    seq = ptg.capture_sequence([dpotrf_taskpool(A), dtrsm_lower_taskpool(A, B),
                                dtrsm_lower_trans_taskpool(A, B)])
    assert seq.nb_tasks > 0
    seq.run(device="cpu")
    X = B.to_numpy()
    ref = np.linalg.solve(M.astype(np.float64), Bn.astype(np.float64))
    assert np.abs(X - ref).max() < 5e-2
    JA, JB = _dposv_colls(JTwoDimBlockCyclic, M, Bn, nb)
    jptg.capture_sequence([jdpotrf_taskpool(JA), jtrsm_lower(JA, JB),
                           jtrsm_lower_t(JA, JB)]).run()
    np.testing.assert_allclose(X, JB.to_numpy(), atol=5e-2)
    # the same three pools through the interpreted runtime, bit for bit
    A2, B2 = _dposv_colls(TwoDimBlockCyclic, M, Bn, nb)
    for tp in (dpotrf_taskpool(A2), dtrsm_lower_taskpool(A2, B2),
               dtrsm_lower_trans_taskpool(A2, B2)):
        _run_tp(tp)
    np.testing.assert_array_equal(X, B2.to_numpy())


def test_captured_sequence_rejects_conflicting_names():
    _, A1 = _spd(128, 64)
    _, A2 = _spd(128, 64)
    A1.name = A2.name = "descA"
    with pytest.raises(ptg.CaptureError, match="different"):
        ptg.capture_sequence([dpotrf_taskpool(A1), dpotrf_taskpool(A2)])


def test_capture_rejects_multirank():
    _, A = _spd(128, 64)
    with pytest.raises(ptg.CaptureError, match="single-rank"):
        ptg.capture(dpotrf_taskpool(A, rank=0, nb_ranks=4))


def test_capture_run_keeps_results_on_the_device_module():
    """run(device=<the CUDA device module>) stores the written tiles as
    the module's copies (here over host tensors), and the interpreted
    runtime reads them from there."""
    M, A = _spd(256, 64, seed=1)
    ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
    try:
        dev = ctx.device_by_type("cuda")
        ptg.capture(dpotrf_taskpool(A)).run(device=dev)
        for (m, k) in A.tiles():
            if m >= k:
                assert A.data_of(m, k).newest_copy().device_id == \
                    dev.device_index
        L = np.tril(A.to_numpy())
        assert np.linalg.norm(L @ L.T - M) / np.linalg.norm(M) < 1e-5
    finally:
        ctx.fini()


def test_capture_run_without_card_raises(monkeypatch):
    _, A = _spd(128, 64)
    cg = ptg.capture(dpotrf_taskpool(A))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PARSEC_MCA_device_cuda_platform", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cg.run()


def test_capture_new_flow_with_shape():
    """A NEW flow with a shape property becomes zeros on the run's
    device; its body result flows to the memory output."""
    jdf = """
    descA [ type="collection" ]

    FILL(m)
    m = 0 .. 1
    : descA( m, 0 )
    RW   T <- NEW [ shape="2x2" ]
           -> descA( m, 0 )
    BODY [type=cuda]
    {
        T = T + (m + 1)
    }
    END
    """
    A = TwoDimBlockCyclic(4, 2, 2, 2).from_numpy(np.full((4, 2), 9.0,
                                                          np.float32))
    ptg.capture(ptg.compile_jdf(jdf, name="fill").new(descA=A)).run(
        device="cpu")
    np.testing.assert_array_equal(A.to_numpy(), np.repeat(
        np.array([[1.0], [2.0]], np.float32), 2, axis=0).repeat(2, axis=1))


COPY_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]

COPY(m)
m = 0 .. 1
: descB( m, 0 )
READ  X <- descA( m, 0 )
WRITE Y -> descB( m, 0 )
BODY [type=%s]
{
    Y = X
}
END
"""


def test_capture_body_copying_its_input_to_another_tile():
    """A body writing its READ input to another memory tile stores that
    tile, as the JAX package's capture does."""
    An = np.arange(8, dtype=np.float32).reshape(4, 2)
    Bn = np.zeros((4, 2), np.float32)
    A = TwoDimBlockCyclic(4, 2, 2, 2).from_numpy(An)
    B = TwoDimBlockCyclic(4, 2, 2, 2).from_numpy(Bn)
    ptg.capture(ptg.compile_jdf(COPY_JDF % "cuda", name="copy").new(
        descA=A, descB=B)).run(device="cpu")
    JA = JTwoDimBlockCyclic(4, 2, 2, 2).from_numpy(An)
    JB = JTwoDimBlockCyclic(4, 2, 2, 2).from_numpy(Bn)
    jptg.capture(jptg.compile_jdf(COPY_JDF % "tpu", name="copy").new(
        descA=JA, descB=JB)).run()
    np.testing.assert_array_equal(B.to_numpy(), An)
    np.testing.assert_array_equal(B.to_numpy(), JB.to_numpy())


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    c = parsec_tpu_torch.init(nb_cores=2)
    yield c
    c.fini()


@pytest.mark.gpu
def test_captured_dpotrf_twice_on_card(cuda_ctx):
    """One graph run on two inputs: both factors right and bit-identical
    to the interpreted runtime's, so no result aliases graph memory."""
    n, nb = 512, 128
    M0, A = _spd(n, nb, seed=0)
    cg = ptg.capture(dpotrf_taskpool(A))
    cg.run()
    L0 = A.to_numpy()
    M1 = make_spd(n, seed=1)
    A.from_numpy(M1)
    cg.run()
    L1 = A.to_numpy()
    assert cg.graph.replays == 2 and cg.graph.captured_gemm_launches > 0
    for M, L in ((M0, L0), (M1, L1)):
        Lt = np.tril(L)
        assert np.linalg.norm(Lt @ Lt.T - M) / np.linalg.norm(M) < 1e-5
        _, R = _spd(n, nb)
        R.from_numpy(M)
        cuda_ctx.add_taskpool(dpotrf_taskpool(R))
        cuda_ctx.wait()
        np.testing.assert_array_equal(L, R.to_numpy())


@pytest.mark.gpu
def test_capture_run_keeps_results_on_device(cuda_ctx):
    """run(device=dev) stores the written tiles as device copies."""
    M, A = _spd(256, 64, seed=1)
    dev = cuda_ctx.device_by_type("cuda")
    ptg.capture(dpotrf_taskpool(A)).run(device=dev)
    for (m, k) in A.tiles():
        if m >= k:
            assert A.data_of(m, k).newest_copy().device_id == dev.device_index
    L = np.tril(A.to_numpy())
    assert np.linalg.norm(L @ L.T - M) / np.linalg.norm(M) < 1e-5


@pytest.mark.gpu
def test_host_sync_body_raises_capture_error(cuda_ctx):
    """A body that reads a value on the host cannot be recorded: the
    capture raises CaptureError naming the task; nothing falls back."""
    jdf = """
    descA [ type="collection" ]

    SYNC(m)
    m = 0 .. 0
    : descA( m, 0 )
    RW   T <- descA( m, 0 )
           -> descA( m, 0 )
    BODY [type=cuda]
    {
        T = T * float(T.sum().item())
    }
    END
    """
    A = TwoDimBlockCyclic(4, 4, 4, 4).from_numpy(np.ones((4, 4), np.float32))
    cg = ptg.capture(ptg.compile_jdf(jdf, name="sync").new(descA=A))
    with pytest.raises(ptg.CaptureError, match=r"SYNC\(0,\)"):
        cg.record()
    g = tcap.dtd_capture()
    t = g.tile_of_array(np.ones((4, 4), np.float32))
    g.insert_task(lambda x: x * x.sum().item(), (t, INOUT))
    with pytest.raises(ptg.CaptureError, match="<lambda>#0"):
        g.run()
    # a failed capture leaves the thread able to record the next graph
    M, A = _spd(256, 64, seed=4)
    cg = ptg.capture(dpotrf_taskpool(A))
    cg.run()
    L = np.tril(A.to_numpy())
    assert np.linalg.norm(L @ L.T - M) / np.linalg.norm(M) < 1e-5


def _pdgemm_twice(ctx, donate):
    """C <- 1.5 A B + 0.5 C, captured, run twice through the context's
    device module; returns (C, the written tiles' device tensors after
    each run)."""
    n, nb = 256, 64
    rng = np.random.RandomState(8)
    An, Bn, Cn = (rng.rand(n, n).astype(np.float32) for _ in range(3))
    A, B, C = (TwoDimBlockCyclic(n, n, nb, nb).from_numpy(x)
               for x in (An, Bn, Cn))
    dev = ctx.device_by_type("cuda")
    cg = ptg.capture(pdgemm_taskpool(A, B, C, alpha=1.5, beta=0.5),
                     donate=donate)
    payloads = []
    for _ in range(2):
        cg.run(device=dev)
        payloads.append([C.data_of(*c).get_copy(dev.device_index).payload
                         for c in C.tiles()])
    AB = An.astype(np.float64) @ Bn
    expect = 1.5 * AB + 0.5 * (1.5 * AB + 0.5 * Cn)
    np.testing.assert_allclose(C.to_numpy(), expect, rtol=1e-5)
    return C.to_numpy(), payloads


def test_donate_on_cpu_gives_the_same_results():
    """On the CPU the bodies run eagerly: donate changes nothing."""
    ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
    try:
        plain, _ = _pdgemm_twice(ctx, donate=False)
        donated, _ = _pdgemm_twice(ctx, donate=True)
    finally:
        ctx.fini()
    np.testing.assert_array_equal(plain, donated)


@pytest.mark.gpu
def test_donated_run_writes_into_the_device_copies(cuda_ctx):
    """With donate, the second run (whose inputs are the first run's
    device copies) writes its results into those tensors in place; its
    values equal a run without donation."""
    donated, (first, second) = _pdgemm_twice(cuda_ctx, donate=True)
    assert all(a is b for a, b in zip(first, second))
    plain, (first, second) = _pdgemm_twice(cuda_ctx, donate=False)
    assert not any(a is b for a, b in zip(first, second))
    np.testing.assert_array_equal(donated, plain)



@pytest.mark.gpu
def test_in_place_chore_recorded_by_run(cuda_ctx):
    """run() records on first use; the warm-up's in-place write does not
    reach the first replay's result, nor the second's."""
    g = tcap.dtd_capture()
    init = np.full((64,), 3.0, np.float32)
    a = g.tile_of_array(init)
    b = g.tile_of_array(np.zeros((64,), np.float32))
    g.insert_task(lambda x: x.mul_(2.0), (a, INOUT))
    g.insert_task(lambda x, _y: x, (a, INPUT), (b, tdtd.OUTPUT))
    for _ in range(2):
        g.run()
        np.testing.assert_array_equal(g.value(a).cpu().numpy(),
                                      np.full(64, 6.0))
        np.testing.assert_array_equal(g.value(b).cpu().numpy(),
                                      np.full(64, 6.0))
    assert g.graph.replays == 2
    np.testing.assert_array_equal(init, np.full(64, 3.0))
