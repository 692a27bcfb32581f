"""Quantized wire codecs and reduced-precision collectives in the port
(parallel/mesh.py, the wave collective lane's ``wave_reduce_dtype``),
the JAX package's ``tests/test_quantize.py`` cases on the port.

Three layers: the error-feedback machinery (an iterative all-reduce whose
contributions fall below the quantization quantum LOSES them without
feedback and converges with it); the lane under ``wave_reduce_dtype``
(contributions quantize at the boundary through the SAME codec the wire
uses, full precision when the knob is unset); per-flow eligibility of
the quantized wire.  The port's torch ``qdq`` is held bit for bit to the
wire codec and to the JAX package's ``qdq_jax``, and
``reduced_precision_sum`` / ``two_level_allreduce`` to the JAX package's
on the same inputs.
"""
import threading

import numpy as np
import pytest
import torch

from parsec_tpu.parallel import mesh as jmesh

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic, redistribute
from parsec_tpu_torch.comm import wire
from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.ptg.wave_dist import _CollectiveLane
from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
from parsec_tpu_torch.parallel.mesh import (ErrorFeedback, _qdq_native, qdq,
                                            reduced_precision_sum,
                                            two_level_allreduce)
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads


@pytest.fixture
def ctx():
    c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    yield c
    c.fini()


def _gather_owned(coll, rank):
    return {c: np.asarray(coll.data_of(*c).sync_to_host().payload).copy()
            for c in coll.tiles() if coll.rank_of(*c) == rank}


# --------------------------------------------------------------------- #
# error feedback                                                        #
# --------------------------------------------------------------------- #
def test_error_feedback_converges_iterative_allreduce():
    """One large element pins the int8 block scale; many sub-quantum small
    ones quantize to zero every round without feedback (100 % drift) and
    converge to within one quantum with it."""
    big = np.zeros(wire.QUANT_BLOCK, np.float32)
    big[0] = 100.0
    small = np.full(wire.QUANT_BLOCK, 0.01, np.float32)
    small[0] = 0.0
    contrib = big + small
    K = 500
    ef = ErrorFeedback()
    tot_no = np.zeros_like(contrib)
    tot_ef = np.zeros_like(contrib)
    for _ in range(K):
        tot_no += wire.qdq_array(contrib, "qint8")
        tot_ef += ef.compensate("grad", contrib, "qint8", wire.qdq_array)
    true = contrib * K
    rel_no = float(np.abs(tot_no[1:] - true[1:]).max() / true[1])
    rel_ef = float(np.abs(tot_ef[1:] - true[1:]).max() / true[1])
    assert rel_no > 0.99, rel_no
    assert rel_ef < 0.1, rel_ef
    assert ef.keys() == ["grad"]


def test_error_feedback_shape_change_starts_fresh():
    ef = ErrorFeedback()
    ef.compensate("k", np.full(8, 0.3, np.float32), "qbf16", wire.qdq_array)
    b = np.full(16, 0.3, np.float32)
    out = ef.compensate("k", b, "qbf16", wire.qdq_array)
    np.testing.assert_array_equal(out, wire.qdq_array(b, "qbf16"))
    ef.reset("k")
    assert ef.keys() == []


def test_error_feedback_on_tensors_matches_numpy():
    """The lane feeds tensors: the residual carry on tensors through the
    torch qdq is the numpy carry through the wire codec, bit for bit."""
    rng = np.random.RandomState(12)
    xs = [rng.randn(700).astype(np.float32) for _ in range(5)]
    ef_np, ef_t = ErrorFeedback(), ErrorFeedback()
    for x in xs:
        a = ef_np.compensate("k", x, "qint8", wire.qdq_array)
        b = ef_t.compensate("k", torch.from_numpy(x), "qint8", qdq)
        np.testing.assert_array_equal(a, b.numpy())


def test_reduced_precision_sum_unset_is_exact():
    rng = np.random.RandomState(0)
    xs = [rng.randn(257).astype(np.float64) for _ in range(5)]
    exact = np.zeros_like(xs[0])
    for x in xs:
        exact = exact + x
    np.testing.assert_array_equal(reduced_precision_sum(xs, None), exact)
    np.testing.assert_array_equal(reduced_precision_sum(xs, ""), exact)


def test_reduced_precision_sum_quantizes_each_contribution():
    rng = np.random.RandomState(1)
    xs = [rng.randn(1000).astype(np.float32) for _ in range(3)]
    out = reduced_precision_sum(xs, "bf16")
    manual = sum(wire.qdq_array(x, "qbf16") for x in xs)
    np.testing.assert_array_equal(out, manual)
    exact = sum(xs)
    rel = np.abs(out - exact).max() / np.abs(exact).max()
    assert 0 < rel < 0.02, rel


def test_two_level_allreduce_boundary_quantization():
    """Level 1 (intra-group) stays full precision; only each group's
    boundary partial quantizes."""
    rng = np.random.RandomState(2)
    xs = [rng.randn(512).astype(np.float32) for _ in range(4)]
    exact = (xs[0] + xs[1]) + (xs[2] + xs[3])
    np.testing.assert_array_equal(two_level_allreduce(xs, 2, None), exact)
    q = two_level_allreduce(xs, 2, "int8")
    manual = (wire.qdq_array(xs[0] + xs[1], "qint8")
              + wire.qdq_array(xs[2] + xs[3], "qint8"))
    np.testing.assert_array_equal(q, manual)
    ef = ErrorFeedback()
    t1 = two_level_allreduce(xs, 2, "int8", feedback=ef, key="g")
    np.testing.assert_array_equal(t1, q)
    assert sorted(ef.keys()) == [("g", 0), ("g", 1)]
    t2 = two_level_allreduce(xs, 2, "int8", feedback=ef, key="g")
    assert not np.array_equal(t2, t1)


# --------------------------------------------------------------------- #
# the collective lane under wave_reduce_dtype                           #
# --------------------------------------------------------------------- #
def _single_rank_lane(reduce_dtype):
    rdv = ({}, {}, threading.Condition())
    return _CollectiveLane("inproc", 1, 0, rendezvous=rdv,
                           reduce_dtype=reduce_dtype)


def test_lane_quantizes_contribution_at_boundary():
    lane = _single_rank_lane("int8")
    x = np.random.RandomState(3).randn(4, 8, 8).astype(np.float32)
    out = lane.reduce(("p", 1, 0, 0), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, wire.qdq_array(x, "qint8"))
    assert lane.quantized_reduces == 1


def test_lane_rejects_unknown_reduce_dtype():
    with pytest.raises(ValueError):
        _single_rank_lane("fp16")


def test_lane_unset_keeps_full_precision():
    lane = _single_rank_lane("")
    assert lane._qcodec is None
    x = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    out = lane.reduce(("p", 1, 0, 1), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, x)
    assert lane.quantized_reduces == 0


def test_lane_error_feedback_needs_stable_key():
    """Without ``fb_key`` the lane quantizes WITHOUT feedback; with a
    stable key the residual carries into the next contribution."""
    lane = _single_rank_lane("int8")
    c = torch.zeros(1, wire.QUANT_BLOCK)
    c[0, 0] = 100.0
    c[0, 1] = 0.01
    out1 = lane.reduce(("p", 1, 0, 0), c)
    out2 = lane.reduce(("p", 1, 1, 0), c)
    assert torch.equal(out1, out2)
    tot = torch.zeros_like(c)
    for w in range(60):
        tot += lane.reduce(("q", 1, w, 0), c, fb_key="buf")
    assert tot[0, 1] > 0, "feedback never emitted the accumulated signal"


def _lane_group(n, contribs, knobs, reduce_dtype="bf16"):
    for k, v in knobs.items():
        params.set_cmdline(k, v)
    try:
        rdv = ({}, {}, threading.Condition())
        efb = ErrorFeedback()
        stats = [{"two_level_reduces": 0} for _ in range(n)]
        lanes = [_CollectiveLane("inproc", n, r, rendezvous=rdv,
                                 reduce_dtype=reduce_dtype,
                                 shared_feedback=efb, stats=stats[r])
                 for r in range(n)]
        outs = [None] * n
        errs = []

        def run(r):
            try:
                outs[r] = lanes[r].reduce(("p", 1, 0, 0),
                                          torch.from_numpy(contribs[r]))
            except BaseException as e:  # noqa: BLE001 - reported below
                errs.append(e)

        ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs and not any(t.is_alive() for t in ts), errs
    finally:
        for k in knobs:
            params.unset_cmdline(k)
    return outs, lanes, stats


def test_lane_two_level_reduction_engages_and_differs_from_flat():
    """``xfer_collective_redist``: deposits stay full precision, the
    issuer reduces hierarchically (one qdq per group).  256 + 1 sums
    exactly inside a group, but 257 is not a bf16 value, so the two-level
    total is 512 where the flat path gives 514."""
    n = 4
    contribs = [np.full((2, 8), v, np.float32)
                for v in (256.0, 1.0, 256.0, 1.0)]
    outs, lanes, stats = _lane_group(
        n, contribs, {"xfer_collective_redist": "1", "xfer_group_size": "2"})
    exp = two_level_allreduce(contribs, 2, "bf16")
    flat = reduced_precision_sum(contribs, "bf16")
    assert not np.array_equal(exp, flat), "input must discriminate"
    for r in range(n):
        np.testing.assert_array_equal(outs[r].numpy(), exp)
    assert all(ln.two_level_reduces == 1 for ln in lanes)
    assert all(ln.quantized_reduces == 0 for ln in lanes)
    assert all(s["two_level_reduces"] == 1 for s in stats)


def test_lane_two_level_group_size_gates_engagement():
    """The member count must EXCEED the group size for the hierarchy to
    engage; at group_size >= members the lane keeps the flat quantize."""
    x = np.full((2, 4), 256.0, np.float32) + 1.0
    outs, lanes, _s = _lane_group(
        1, [x], {"xfer_collective_redist": "1", "xfer_group_size": "4"})
    np.testing.assert_array_equal(outs[0].numpy(),
                                  wire.qdq_array(x, "qbf16"))
    assert lanes[0].two_level_reduces == 0
    assert lanes[0].quantized_reduces == 1


def test_wave_reduce_dtype_dpotrf_within_bound(nb_ranks=4):
    """End to end: the 4-rank row-cyclic distributed dpotrf whose panel
    broadcasts ride the in-process lane at bf16 stays within the declared
    residual bound of numpy's Cholesky, with quantized reduces counted."""
    n, nb = 256, 32
    M = make_spd(n, dtype=np.float64)

    def rank_fn(r, f):
        ce = f.engine(r)
        coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float64,
                                 P=nb_ranks, Q=1, nodes=nb_ranks, rank=r)
        coll.name = "descA"
        coll.from_numpy(M.copy())
        w = ptg.wave(dpotrf_taskpool(coll, rank=r, nb_ranks=nb_ranks),
                     comm=ce)
        w.run(device="cpu")
        return w.stats, _gather_owned(coll, r)

    params.set_cmdline("wave_dist_collective", "on")
    params.set_cmdline("wave_reduce_dtype", "bf16")
    try:
        results, _ = spmd_threads(nb_ranks, rank_fn, timeout=180)
    finally:
        params.unset_cmdline("wave_dist_collective")
        params.unset_cmdline("wave_reduce_dtype")
    L = np.zeros((n, n))
    for (_st, owned) in results:
        for (m, k), t in owned.items():
            L[m * nb:(m + 1) * nb, k * nb:(k + 1) * nb] = t
    L = np.tril(L)
    stats = [st for (st, _o) in results]
    assert all(s["collective_reduce_dtype"] == "qbf16" for s in stats)
    assert sum(s["collective_quantized"] for s in stats) > 0, stats
    ref = np.linalg.cholesky(M)
    resid = np.abs(L - ref).max() / np.abs(ref).max()
    assert resid < 1e-2, resid


# --------------------------------------------------------------------- #
# per-flow eligibility                                                  #
# --------------------------------------------------------------------- #
class _FakeTp:
    pass


def test_quantize_eligibility_per_flow():
    el = RemoteDepEngine._quantize_eligible
    tp = _FakeTp()
    assert el(tp, np.zeros(4, np.float32))
    assert el(tp, np.zeros(4, np.float64))
    assert el(tp, torch.zeros(4))
    assert not el(tp, np.zeros(4, np.int32))
    assert not el(tp, None)
    lossless_tp = _FakeTp()
    lossless_tp.wire_lossless = True
    assert not el(lossless_tp, np.zeros(4, np.float64))


def test_redistribute_pool_is_wire_lossless(ctx):
    """Checkpoint-reshard restores ride redistribute(); its pool marks
    itself lossless so reshard traffic never quantizes."""
    rng = np.random.RandomState(5)
    src = rng.rand(8, 8)
    Y = TwoDimBlockCyclic(8, 8, 4, 4, dtype=np.float64).from_numpy(src)
    T = TwoDimBlockCyclic(8, 8, 2, 2,
                          dtype=np.float64).from_numpy(np.zeros((8, 8)))
    tp = redistribute(Y, T, 8, 8, context=ctx)
    assert getattr(tp, "wire_lossless", False) is True
    np.testing.assert_array_equal(T.to_numpy(), src)


def test_qdq_matches_wire_delivery_layout():
    """qdq_array is EXACTLY what a quantized wire transfer delivers."""
    rng = np.random.RandomState(6)
    for dt, fmt in ((np.float64, "d"), (np.float32, "f")):
        arr = (rng.randn(1030) * 3).astype(dt)
        for codec in wire.available_quant_codecs():
            enc = wire.quantize_buffer(
                memoryview(np.ascontiguousarray(arr)).cast("B"), fmt, codec)
            via_wire = np.frombuffer(wire.dequantize_buffer(enc), dtype=dt)
            np.testing.assert_array_equal(via_wire,
                                          wire.qdq_array(arr, codec))


def test_native_qdq_bit_parity_with_numpy():
    """The torch qdq hop delivers BIT-FOR-BIT the values of the numpy wire
    codec and of the JAX package's ``qdq_jax``: every dtype, shape class
    (block multiples, remainders, multi-dim), magnitude, and all-zero
    blocks (the 1/scale guard)."""
    rng = np.random.RandomState(7)
    for codec in wire.available_quant_codecs():
        for dt in (np.float32, np.float64):
            for shape in ((7,), (512,), (513,), (64, 33), (3, 5, 7)):
                for scale in (1e-6, 1.0, 1e4):
                    x = (rng.randn(*shape) * scale).astype(dt)
                    a = wire.qdq_array(x, codec)
                    b = _qdq_native(x, codec)
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(
                        qdq(torch.from_numpy(x), codec).numpy(), a)
                    np.testing.assert_array_equal(
                        jmesh._qdq_native(x, codec), b)
        z = np.zeros(600, np.float32)
        np.testing.assert_array_equal(wire.qdq_array(z, codec),
                                      _qdq_native(z, codec))


def test_native_two_level_allreduce_bit_parity():
    """two_level_allreduce's default quantize hop (the torch qdq) is
    bit-identical to the eager wire codec (``native=False``) and to the
    JAX package's native default, with and without error feedback across
    iterations; with no codec it is the exact sum."""
    rng = np.random.RandomState(8)
    shards = [rng.randn(300).astype(np.float32) for _ in range(8)]
    for rd in wire.available_quant_codecs():
        np.testing.assert_array_equal(
            two_level_allreduce(shards, 4, rd, native=False),
            two_level_allreduce(shards, 4, rd))
        np.testing.assert_array_equal(
            jmesh.two_level_allreduce(shards, 4, rd),
            two_level_allreduce(shards, 4, rd))
        fb_np, fb_t, fb_j = ErrorFeedback(), ErrorFeedback(), \
            jmesh.ErrorFeedback()
        for _ in range(3):
            r_np = two_level_allreduce(shards, 4, rd, feedback=fb_np,
                                       key="k", native=False)
            r_t = two_level_allreduce(shards, 4, rd, feedback=fb_t, key="k")
            r_j = jmesh.two_level_allreduce(shards, 4, rd, feedback=fb_j,
                                            key="k")
            np.testing.assert_array_equal(r_np, r_t)
            np.testing.assert_array_equal(r_j, r_t)
    np.testing.assert_array_equal(
        two_level_allreduce(shards, 4, None, native=False),
        two_level_allreduce(shards, 4, None))


@pytest.mark.parametrize("rd", [None, "bf16", "int8"])
def test_reduced_precision_sum_parity_with_jax(rd):
    """reduced_precision_sum equals the JAX package's on the same inputs,
    with and without per-contributor feedback, and on tensors."""
    rng = np.random.RandomState(13)
    xs = [rng.randn(777).astype(np.float32) for _ in range(4)]
    np.testing.assert_array_equal(reduced_precision_sum(xs, rd),
                                  jmesh.reduced_precision_sum(xs, rd))
    ts = reduced_precision_sum([torch.from_numpy(x) for x in xs], rd)
    np.testing.assert_array_equal(ts.numpy(),
                                  jmesh.reduced_precision_sum(xs, rd))
    keys = [f"c{i}" for i in range(4)]
    fb, jfb = ErrorFeedback(), jmesh.ErrorFeedback()
    for _ in range(2):
        np.testing.assert_array_equal(
            reduced_precision_sum(xs, rd, feedback=fb, keys=keys),
            jmesh.reduced_precision_sum(xs, rd, feedback=jfb, keys=keys))


@pytest.mark.gpu
def test_qdq_on_card_bit_parity_gpu():
    """The torch qdq on cuda:0 delivers the wire codec's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(14)
    for codec in wire.available_quant_codecs():
        for dt in (np.float32, np.float64):
            x = (rng.randn(3, 1024, 1024) * 10).astype(dt)
            got = qdq(torch.from_numpy(x).cuda(), codec).cpu().numpy()
            np.testing.assert_array_equal(got, wire.qdq_array(x, codec))
