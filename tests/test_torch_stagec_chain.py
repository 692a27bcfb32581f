"""Whole-stage compilation in the port, held to the port's own interpreted
runtime bit for bit (``np.testing.assert_array_equal``).

On the CPU (``init(device="cpu")``) a compiled stage runs its stage
function eagerly over host tensors with each kernel's plain version; on
a card it is ONE recorded CUDA graph replayed per dispatch (the
``gpu``-marked tests).  Either way every member runs the body it runs
interpreted, on the same tiles, in an order the dependences fix, so the
results are identical.  These cases mirror the JAX package's
tests/test_stagec.py (its three cross-rank SPMD cases are in
tests/test_torch_stagec_xrank.py); where a reference case tests a JAX-only mechanism
the docstring names the port's counterpart.  This file imports no JAX.
"""
import gc
import os
import subprocess
import sys
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.graph import CaptureError
from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
from parsec_tpu_torch.utils.params import params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clear_stage_cache():
    from parsec_tpu_torch.devices.batching import clear_stage_cache
    clear_stage_cache()


def _knobs(stagec=False, **kv):
    st = ExitStack()
    if stagec:
        st.enter_context(params.cmdline_override("stage_compile", "1"))
    for k, v in kv.items():
        st.enter_context(params.cmdline_override(k, str(v)))
    return st


def _mesh(kv):
    kv = dict(kv)
    kv.update(device_mesh_shape="2x2", device_cuda_virtual_chips="4")
    return kv


def _run_dpotrf(n, nb, stagec, dtype=np.float32, device="cpu", **kv):
    """One dpotrf; returns (L, stage stats, tp._stagec, M, device)."""
    M = make_spd(n).astype(dtype)
    with _knobs(stagec, **kv):
        ctx = ptt.init(nb_cores=2, device=device)
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=dtype).from_numpy(M.copy())
            tp = dpotrf_taskpool(A)
            ctx.add_taskpool(tp)
            ctx.wait()
            return (np.tril(A.to_numpy()), dict(ctx.stage_stats),
                    tp._stagec, M, ctx.device_by_type("cuda"))
        finally:
            ctx.fini()


def _run_dpotrf_pools(n, nb, pools, device="cpu", **kv):
    """``pools`` stage-compiled dpotrf taskpools one after another on ONE
    context (the recorded programs live while it does); returns per pool
    (L, the stage counters it moved, tp._stagec)."""
    M = make_spd(n)
    out = []
    with _knobs(True, **kv):
        ctx = ptt.init(nb_cores=2, device=device)
        try:
            for _ in range(pools):
                A = TwoDimBlockCyclic(n, n, nb, nb,
                                      dtype=np.float32).from_numpy(M.copy())
                tp = dpotrf_taskpool(A)
                before = dict(ctx.stage_stats)
                ctx.add_taskpool(tp)
                ctx.wait()
                out.append((np.tril(A.to_numpy()),
                            {k: v - before[k]
                             for k, v in ctx.stage_stats.items()},
                            tp._stagec))
        finally:
            ctx.fini()
    return out


def _nt_tasks(n, nb):
    nt = (n + nb - 1) // nb
    return nt + 2 * (nt * (nt - 1) // 2) + nt * (nt - 1) * (nt - 2) // 6


# --------------------------------------------------------------------- #
# bit for bit against the interpreted runtime                          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,nb,dtype", [
    (128, 32, np.float32),     # uniform
    (100, 32, np.float32),     # ragged edge tiles
    (96, 32, np.float64),      # second dtype
    (128, 64, np.float32),     # second NB
])
def test_stagec_dpotrf_bit_exact_vs_interpreted(n, nb, dtype):
    """The compiled stages give the interpreted runtime's factor bit for
    bit, across NB and dtype, and the compiled path really engages."""
    L0, s0, sc0, M, _d = _run_dpotrf(n, nb, False, dtype)
    L1, s1, sc1, _m, _d = _run_dpotrf(n, nb, True, dtype)
    assert sc0 is None and s0["stage_tasks"] == 0
    assert sc1 is not None
    assert s1["stage_tasks"] == _nt_tasks(n, nb), s1
    assert s1["stage_fallbacks"] == 0, s1
    np.testing.assert_array_equal(L1, L0)
    resid = np.abs(L1.astype(np.float64) @ L1.astype(np.float64).T
                   - M).max() / np.abs(M).max()
    assert resid < 1e-5, f"residual {resid:.2e}"


def test_stagec_off_is_inert():
    """stage_compile unset: no compiler attaches, no counter moves, the
    factor is the interpreted runtime's."""
    L, stats, sc, _m, _d = _run_dpotrf(96, 32, False)
    assert sc is None
    assert all(v == 0 for v in stats.values()), stats
    with _knobs(stage_compile="0"):
        L2, stats2, sc2, _m, _d = _run_dpotrf(96, 32, False)
    assert sc2 is None and all(v == 0 for v in stats2.values())
    np.testing.assert_array_equal(L, L2)


def _run_lu(stagec, n=128, nb=32):
    from parsec_tpu_torch.ops import dgetrf_nopiv_taskpool, \
        make_diag_dominant
    M = make_diag_dominant(n)
    with _knobs(stagec):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=np.float32).from_numpy(M.copy())
            ctx.add_taskpool(dgetrf_nopiv_taskpool(A))
            ctx.wait()
            return A.to_numpy(), dict(ctx.stage_stats)
        finally:
            ctx.fini()


def _run_pdgemm(stagec, n=128, nb=32, transb="n"):
    from parsec_tpu_torch.ops import pdgemm_taskpool
    rng = np.random.RandomState(3)
    mats = [rng.rand(n, n).astype(np.float32) for _ in range(3)]
    with _knobs(stagec):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            A, B, C = (TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
                       .from_numpy(m.copy()) for m in mats)
            ctx.add_taskpool(pdgemm_taskpool(A, B, C, alpha=1.5, beta=0.5,
                                             transb=transb))
            ctx.wait()
            return C.to_numpy(), dict(ctx.stage_stats)
        finally:
            ctx.fini()


def _run_qr(stagec, n=128, nb=32):
    from parsec_tpu_torch.ops import dgeqrf_taskpool
    M = np.random.RandomState(4).rand(n, n).astype(np.float32)
    with _knobs(stagec):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=np.float32).from_numpy(M.copy())
            ctx.add_taskpool(dgeqrf_taskpool(A))
            ctx.wait()
            return A.to_numpy(), dict(ctx.stage_stats)
        finally:
            ctx.fini()


@pytest.mark.parametrize("routine", ["dgetrf_nopiv", "pdgemm_nn",
                                     "pdgemm_nt", "dgeqrf"])
def test_stagec_family_bit_exact(routine):
    """dgetrf_nopiv, pdgemm (B as is and transposed) and dgeqrf compile
    whole and give the interpreted results bit for bit."""
    run = {"dgetrf_nopiv": _run_lu, "dgeqrf": _run_qr,
           "pdgemm_nn": lambda s: _run_pdgemm(s),
           "pdgemm_nt": lambda s: _run_pdgemm(s, transb="t")}[routine]
    R0, s0 = run(False)
    R1, s1 = run(True)
    assert s0["stage_tasks"] == 0 and s1["stage_tasks"] > 0, s1
    assert s1["stage_fallbacks"] == 0, s1
    np.testing.assert_array_equal(R1, R0)


def test_stagec_aot_cache_hits_across_taskpools():
    """A fresh taskpool over the same (spec, NB, dtype) replays the
    cached program: no second record (the JAX package's AOT compile
    cache; here the per-spec cache of recorded programs)."""
    _clear_stage_cache()
    with _knobs(True):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            M = make_spd(128)
            for rep in range(2):
                A = TwoDimBlockCyclic(128, 128, 32, 32,
                                      dtype=np.float32).from_numpy(M.copy())
                ctx.add_taskpool(dpotrf_taskpool(A))
                ctx.wait()
                if rep == 0:
                    compiles0 = ctx.stage_stats["stage_compiles"]
                    assert compiles0 > 0
            assert ctx.stage_stats["stage_compiles"] == compiles0
            assert ctx.stage_stats["stage_dispatches"] == 2 * compiles0
        finally:
            ctx.fini()


def test_stagec_cache_token_covers_donate_and_max_tasks():
    """The cache key covers the donation flag (``stage_compile_donate``;
    the JAX package flips ``device_donate``, which this package refuses)
    AND stage_compile_max_tasks: flipping either between otherwise
    identical runs records anew, at unchanged numerics."""
    _clear_stage_cache()
    L0, _s0, _x, M, _d = _run_dpotrf(128, 32, False)
    with _knobs(True):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            def one(donate="1", max_tasks=None):
                kv = {"stage_compile_donate": donate}
                if max_tasks is not None:
                    kv["stage_compile_max_tasks"] = max_tasks
                with _knobs(**kv):
                    A = TwoDimBlockCyclic(
                        128, 128, 32, 32,
                        dtype=np.float32).from_numpy(M.copy())
                    ctx.add_taskpool(dpotrf_taskpool(A))
                    ctx.wait()
                    return np.tril(A.to_numpy())

            base = one()
            c1 = ctx.stage_stats["stage_compiles"]
            assert c1 > 0
            again = one()
            assert ctx.stage_stats["stage_compiles"] == c1
            don = one(donate="0")
            c2 = ctx.stage_stats["stage_compiles"]
            assert c2 > c1, "a donation flip hit a stale program"
            split = one(max_tasks=6)
            c3 = ctx.stage_stats["stage_compiles"]
            assert c3 > c2, "a max_tasks flip hit a stale plan/program"
            for got in (base, again, don, split):
                np.testing.assert_array_equal(got, L0)
        finally:
            ctx.fini()


def test_stagec_dead_spec_drops_its_cache_entries():
    """The stage cache lives on its spec: when the parsed spec is
    collected, its entries go with it, also while the context that
    recorded them lives on."""
    from parsec_tpu_torch.devices.batching import live_stage_entries
    from parsec_tpu_torch.ops.dpotrf import DPOTRF_L_JDF
    _clear_stage_cache()
    gc.collect()
    base = live_stage_entries()
    factory = ptg.compile_jdf(DPOTRF_L_JDF, name="dpotrf_dead")
    M = make_spd(96)
    with _knobs(True):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(96, 96, 32, 32,
                                  dtype=np.float32).from_numpy(M.copy())
            tp = factory.new(descA=A, NT=A.mt)
            tp.global_env["ops"] = ptt.ops
            ctx.add_taskpool(tp)
            ctx.wait()
            assert tp._stagec is not None
            assert live_stage_entries() > base
            del tp, factory, A
            gc.collect()
            assert live_stage_entries() == base
        finally:
            ctx.fini()


def test_stagec_fini_releases_the_context_programs():
    """A recorded program (on a card: a CUDA graph, its static buffers
    and its private memory pool) and the plan (which keeps the first
    pool's classes and collections) are held for the contexts that
    fetched them: the last one's fini drops them, the program is
    collected, and a later context records anew."""
    import weakref
    from parsec_tpu_torch.devices.batching import live_stage_entries
    _clear_stage_cache()
    gc.collect()
    base = live_stage_entries()
    M = make_spd(128)
    seen = []
    for _ in range(2):
        with _knobs(True):
            ctx = ptt.init(nb_cores=2, device="cpu")
            try:
                A = TwoDimBlockCyclic(128, 128, 32, 32,
                                      dtype=np.float32).from_numpy(M.copy())
                tp = dpotrf_taskpool(A)
                ctx.add_taskpool(tp)
                ctx.wait()
                prog = weakref.ref(tp._stagec._recs[0].fn)
                held = live_stage_entries()
                compiles = ctx.stage_stats["stage_compiles"]
            finally:
                ctx.fini()
        del tp, A
        gc.collect()
        seen.append((held, compiles, live_stage_entries(), prog() is None))
    (held1, c1, left1, gone1), (held2, c2, left2, gone2) = seen
    assert c1 > 0 and c2 == c1, seen   # the second context records anew
    assert held1 == held2 == base + c1 + 1, seen   # the programs, the plan
    assert left1 == left2 == base and gone1 and gone2, seen


def test_stagec_cache_entry_held_until_its_last_owner_releases():
    """Two live owners share one entry; it goes when both have released
    it.  An entry fetched with no owner (a plan) stays."""
    from parsec_tpu_torch.devices.batching import (
        cached_stage_callable, live_stage_entries, release_stage_entries)

    class Spec:
        pass

    class Wrap:
        def __init__(self, obj):
            self.obj = obj

    _clear_stage_cache()
    base = live_stage_entries()
    token = (Wrap(Spec()), "geometry")
    one, two = object(), object()
    prog = cached_stage_callable(token, "prog", object, owner=one)
    assert cached_stage_callable(token, "prog", object, owner=two) is prog
    plan = cached_stage_callable(token, "plan", object)
    assert live_stage_entries() == base + 2
    release_stage_entries(one)
    assert cached_stage_callable(token, "prog", object) is prog
    release_stage_entries(two)
    assert live_stage_entries() == base + 1
    assert cached_stage_callable(token, "plan", object) is plan
    assert cached_stage_callable(token, "prog", object) is not prog


def test_stagec_cache_builds_each_entry_once_across_threads():
    """Threads asking for the same entry at once wait for ONE build (two
    records of one signature would waste a graph); a build that raises
    leaves nothing cached, and the next caller builds again."""
    import threading
    import time
    from parsec_tpu_torch.devices.batching import cached_stage_callable

    class Spec:
        pass

    class Wrap:
        def __init__(self, obj):
            self.obj = obj

    token = (Wrap(Spec()), "geometry")
    builds = []

    def build():
        builds.append(1)
        time.sleep(0.05)
        return object()

    got = []
    threads = [threading.Thread(
        target=lambda: got.append(cached_stage_callable(token, "k", build)))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)

    def broken():
        raise ValueError("injected build failure")

    with pytest.raises(ValueError):
        cached_stage_callable(token, "bad", broken)
    assert cached_stage_callable(token, "bad", build) is not None
    assert len(builds) == 2


def test_stagec_noop_readers_lower_as_forwarders():
    """dtrsm's FWD spec mixes device classes with no-op reader classes
    (RDIAG/RPANEL hand L tiles on through ``pass`` host bodies): they
    lower as pure dataflow, so the WHOLE pool compiles — the same answer
    as interpreted, with stage_tasks covering every task."""
    from parsec_tpu_torch.ops import dtrsm_lower_taskpool
    from parsec_tpu_torch.ops.dtrsm import _factories
    from parsec_tpu_torch.stagec import class_verdicts

    n, nb, nrhs = 128, 32, 8
    M = make_spd(n)
    B0 = np.random.RandomState(5).rand(n, nrhs).astype(np.float32)
    Lnp = np.tril(np.linalg.cholesky(M.astype(np.float64))
                  ).astype(np.float32)

    def run(stagec):
        with _knobs(stagec):
            ctx = ptt.init(nb_cores=2, device="cpu")
            try:
                L = TwoDimBlockCyclic(n, n, nb, nb,
                                      dtype=np.float32).from_numpy(Lnp.copy())
                B = TwoDimBlockCyclic(n, nrhs, nb, nrhs,
                                      dtype=np.float32).from_numpy(B0.copy())
                ctx.add_taskpool(dtrsm_lower_taskpool(L, B))
                ctx.wait()
                return B.to_numpy(), dict(ctx.stage_stats)
            finally:
                ctx.fini()

    Y0, _s0 = run(False)
    Y1, s1 = run(True)
    np.testing.assert_array_equal(Y1, Y0)
    nt = n // nb
    assert s1["stage_tasks"] == nt + nt * (nt - 1) // 2 + nt \
        + nt * (nt - 1) // 2, s1
    v = class_verdicts(_factories()[0].jdf)
    assert v["RDIAG"].ok and v["RDIAG"].note and v["RPANEL"].ok
    assert v["TRSM"].ok and v["GEMM"].ok


# a dtrsm-fwd variant whose reader class carries a REAL host body (a
# host-side checksum): it stays residue (STG300 is not relaxed for bodies
# that do work), interleaving with the compiled stages
MIXED_FWD_JDF = """
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
    _chk = float(np.sum(np.asarray(T)))
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

BODY [type=cuda]
{
    X = ops.trsm_lower(T, X)
}
END

GEMM(k, m, n)

k = 0 .. MT-2
m = k+1 .. MT-1
n = 0 .. NT-1

: descB( m, n )

READ A <- descL( m, k )
READ B <- X TRSM( k, n )
RW   C <- (k == 0) ? descB( m, n ) : C GEMM( k-1, m, n )
       -> (m == k+1) ? X TRSM( m, n ) : C GEMM( k+1, m, n )

BODY [type=cuda]
{
    C = ops.gemm_nn_sub(C, A, B)
}
END
"""


def _run_mixed_fwd(stagec, n=128, nb=32, nrhs=8, **kv):
    M = make_spd(n)
    B0 = np.random.RandomState(5).rand(n, nrhs).astype(np.float32)
    Lnp = np.tril(np.linalg.cholesky(M.astype(np.float64))
                  ).astype(np.float32)
    with _knobs(stagec, **kv):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            L = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=np.float32).from_numpy(Lnp.copy())
            B = TwoDimBlockCyclic(n, nrhs, nb, nrhs,
                                  dtype=np.float32).from_numpy(B0.copy())
            tp = ptg.compile_jdf(MIXED_FWD_JDF, name="mixed_fwd").new(
                descL=L, descB=B, MT=B.mt, NT=B.nt)
            tp.global_env["ops"] = ptt.ops
            ctx.add_taskpool(tp)
            ctx.wait()
            return B.to_numpy(), dict(ctx.stage_stats)
        finally:
            ctx.fini()


def test_stagec_residue_interleaves_with_compiled_stages():
    """A pool mixing compilable device classes with REAL host bodies runs
    the stages compiled and the residue interpreted — the interpreted
    answer, with stage_tasks covering only the compilable part."""
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
    from parsec_tpu_torch.stagec import class_verdicts

    Y0, _s0 = _run_mixed_fwd(False)
    Y1, s1 = _run_mixed_fwd(True)
    np.testing.assert_array_equal(Y1, Y0)
    assert 0 < s1["stage_tasks"] < 4 + 6 + 4, s1
    v = class_verdicts(parse_jdf(MIXED_FWD_JDF, name="mixed_fwd"))
    assert not v["RDIAG"].ok and v["RDIAG"].code == "STG300"
    assert v["TRSM"].ok and v["GEMM"].ok
    # host residue groups ride the compiled residue schedule too
    Y2, s2 = _run_mixed_fwd(True, nrhs=8, nb=16)
    Y3, _s3 = _run_mixed_fwd(False, nrhs=8, nb=16)
    np.testing.assert_array_equal(Y2, Y3)


def test_stagec_residue_schedule_batches_groups():
    """With GEMM operator-excluded (STG306) its instances run as device
    residue between compiled stages: pre-planned per-(level, class)
    groups dispatch as bursts with stage_residue_batch on and stay
    per-task with it off, bit-exact either way."""
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
    from parsec_tpu_torch.ops.dpotrf import DPOTRF_L_JDF
    from parsec_tpu_torch.stagec import class_verdicts

    L0, *_ = _run_dpotrf(160, 32, False)
    L_on, s_on, *_ = _run_dpotrf(160, 32, True,
                                 stage_compile_exclude="GEMM")
    L_off, s_off, *_ = _run_dpotrf(160, 32, True,
                                   stage_compile_exclude="GEMM",
                                   stage_residue_batch="0")
    assert s_on["residue_batches"] > 0, s_on
    assert s_on["residue_batch_tasks"] >= 2 * s_on["residue_batches"]
    assert s_off["residue_batches"] == 0, s_off
    np.testing.assert_array_equal(L_on, L0)
    np.testing.assert_array_equal(L_off, L0)
    with _knobs(stage_compile_exclude="GEMM"):
        v = class_verdicts(parse_jdf(DPOTRF_L_JDF, name="dpotrf"))
    assert not v["GEMM"].ok and v["GEMM"].code == "STG306", v["GEMM"]
    assert v["POTRF"].ok


def test_stagec_dtd_burst_rejects_into_fallback():
    """DTD taskpools have no static spec to lower: with stage_compile ON
    a DTD burst runs exactly as before (the batched dispatch) and no
    stage counter moves."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT

    rng = np.random.RandomState(11)
    mats = [[rng.rand(16, 16).astype(np.float32) for _ in range(3)]
            for _ in range(8)]

    def run(stagec):
        with _knobs(stagec):
            ctx = ptt.init(nb_cores=2, device="cpu")
            try:
                tp = dtd.taskpool_new()
                ctx.add_taskpool(tp)

                def body(es, task):
                    c, a, b = dtd.unpack_args(task)
                    c -= a @ b.T

                boot = tp.tile_of_array(np.zeros((16, 16), np.float32))
                tp.insert_task(body, (boot, INOUT), (boot, INPUT),
                               (boot, INPUT))
                tp.add_chore(body, "cuda", lambda c, a, b: c - a @ b.mT)
                tiles = [[tp.tile_of_array(m.copy()) for m in row]
                         for row in mats]
                for c, a, b in tiles:
                    tp.insert_task(body, (c, INOUT), (a, INPUT),
                                   (b, INPUT))
                tp.wait()
                outs = [np.asarray(row[0].data.sync_to_host().payload)
                        for row in tiles]
                return outs, dict(ctx.stage_stats)
            finally:
                ctx.fini()

    out0, _s0 = run(False)
    out1, s1 = run(True)
    assert s1["stage_tasks"] == 0 and s1["stage_compiles"] == 0, s1
    for a, b in zip(out0, out1):
        np.testing.assert_array_equal(a, b)


def test_stagec_record_failure_downgrades_one_stage(monkeypatch):
    """A stage whose body cannot be recorded (a CaptureError at record,
    injected into stage 0) (a) falls back to the interpreted path
    transparently, bit-exact, (b) leaves the OTHER stages compiled and
    (c) is permanent only for that stage: a repeat taskpool downgrades it
    from the cached verdict without recording again."""
    import parsec_tpu_torch.stagec.runtime as srt

    _clear_stage_cache()
    real = srt.StageProgram.record
    calls = {"fail": 0}

    def failing_record(self, shapes, device):
        if self.name.startswith("stage 0 "):
            calls["fail"] += 1
            raise CaptureError("injected: a host sync in the body")
        return real(self, shapes, device)

    monkeypatch.setattr(srt.StageProgram, "record", failing_record)
    (L1, s1, _sc), (L2, s2, _sc2) = _run_dpotrf_pools(
        160, 32, 2, stage_compile_max_tasks=6)
    assert s1["stage_fallbacks"] == 1, s1
    assert s1["stage_compiles"] >= 1 and s1["stage_tasks"] > 0, s1
    L0, *_ = _run_dpotrf(160, 32, False)
    np.testing.assert_array_equal(L1, L0)
    assert calls["fail"] == 1, calls
    assert s2["stage_fallbacks"] == 1 and s2["stage_compiles"] == 0, s2
    np.testing.assert_array_equal(L2, L0)
    _clear_stage_cache()


def test_stagec_other_errors_raise(monkeypatch):
    """Only a record failure downgrades: any other error building a
    stage (here injected into build_stage_fn) aborts the
    DAG and re-raises from wait()."""
    import parsec_tpu_torch.stagec.runtime as srt

    _clear_stage_cache()

    real = srt.build_stage_fn

    def broken(tp, stage, layout, codes):
        if stage.index == 2:   # spawned by an activation, on a worker
            raise ValueError("injected: not a record failure")
        return real(tp, stage, layout, codes)

    monkeypatch.setattr(srt, "build_stage_fn", broken)
    with pytest.raises(RuntimeError) as ei:
        _run_dpotrf(160, 32, True, stage_compile_max_tasks=6)
    assert "injected: not a record failure" in repr(ei.value.__cause__) \
        or "injected" in str(ei.value)
    _clear_stage_cache()


def test_stagec_donate_downgrade_replays_clean(monkeypatch):
    """Donation on (the default) with one stage downgraded MID-RUN: its
    buffered activations replay into the dynamic path and the donating
    OTHER stages retire clean — bit-exact factor, one fallback."""
    import parsec_tpu_torch.stagec.runtime as srt

    _clear_stage_cache()
    real = srt.StageProgram.record

    def failing_record(self, shapes, device):
        if self.name.startswith("stage 1 "):
            raise CaptureError("injected mid-run record failure")
        return real(self, shapes, device)

    monkeypatch.setattr(srt.StageProgram, "record", failing_record)
    L1, s1, *_ = _run_dpotrf(160, 32, True, stage_compile_max_tasks=6,
                             stage_compile_donate=1)
    assert s1["stage_fallbacks"] == 1 and s1["stage_compiles"] >= 1, s1
    _clear_stage_cache()
    monkeypatch.setattr(srt.StageProgram, "record", real)
    L0, *_ = _run_dpotrf(160, 32, False)
    np.testing.assert_array_equal(L1, L0)


def test_stagec_donation_writes_into_the_slot_tensor():
    """With donation a replay writes each WRITE slot's result into the
    slot's own tensor (copy_), without it a fresh tensor; the factor is
    the same either way."""
    import parsec_tpu_torch.stagec.runtime as srt

    seen = {}
    real = srt.StageProgram.replay

    def spy(self, arrays, device, donate):
        tiles, edges = real(self, arrays, device, donate)
        seen.setdefault(donate, []).append(
            all(t is arrays[si] for t, si in zip(tiles, self.out_slots)))
        return tiles, edges

    try:
        srt.StageProgram.replay = spy
        L1, *_ = _run_dpotrf(128, 32, True, stage_compile_donate=1)
        L2, *_ = _run_dpotrf(128, 32, True, stage_compile_donate=0)
    finally:
        srt.StageProgram.replay = real
    assert seen[True] and all(seen[True]), seen
    assert seen[False] and not any(seen[False]), seen
    np.testing.assert_array_equal(L1, L2)


def test_stagec_donate_by_default_under_eviction_pressure():
    """Under a 4 KiB device budget with small stages the device module
    evicts mid-run — donated-then-evicted slot tensors — and the factor
    stays bit-exact vs interpreted with donation on and off."""
    _clear_stage_cache()
    L0, _s0, _x, M, _d = _run_dpotrf(160, 32, False)

    def leg(donate):
        with _knobs(True, stage_compile_max_tasks=4,
                    stage_compile_donate=donate):
            ctx = ptt.init(nb_cores=2, device="cpu")
            try:
                dev = ctx.device_by_type("cuda")
                dev.mem_budget = 4 * 1024
                A = TwoDimBlockCyclic(160, 160, 32, 32,
                                      dtype=np.float32).from_numpy(M.copy())
                ctx.add_taskpool(dpotrf_taskpool(A))
                ctx.wait()
                return (np.tril(A.to_numpy()), dev.stats["evictions"],
                        dict(ctx.stage_stats))
            finally:
                ctx.fini()

    Lon, ev_on, s_on = leg(1)
    Loff, ev_off, _s = leg(0)
    assert ev_on > 0 and ev_off > 0, (ev_on, ev_off)
    assert s_on["stage_tasks"] > 0 and s_on["stage_fallbacks"] == 0, s_on
    np.testing.assert_array_equal(Lon, L0)
    np.testing.assert_array_equal(Loff, L0)


ALIASED_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

Add(m)
m = 0 .. NT-1
: descA( m, 0 )
READ U <- descA( m, 0 )
RW   X <- descA( m, 0 )
       -> descA( m, 0 )
BODY [type=cuda]
{
    X = X + U
}
END
"""


def test_stagec_bdy204_alias_keeps_donation_suppressed():
    """Two flows reading the same tile (BDY204) keep donation OFF: the
    donation flag is part of the program's cache key, so flipping
    ``stage_compile_donate`` around the aliased class is a pure cache
    HIT, while the clean dpotrf control records anew on the same flip."""
    from parsec_tpu_torch.analysis.body_check import check_jdf_bodies
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf

    assert any(f.code == "BDY204" for f in check_jdf_bodies(
        parse_jdf(ALIASED_JDF, name="aliased")))
    _clear_stage_cache()
    nb, nt = 8, 4
    A0 = np.random.RandomState(3).rand(nt * nb, nb).astype(np.float32)
    factory = ptg.compile_jdf(ALIASED_JDF, name="aliased")
    M = make_spd(128)
    with _knobs(True):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            def aliased(donate):
                with _knobs(stage_compile_donate=donate):
                    A = TwoDimBlockCyclic(nt * nb, nb, nb, nb,
                                          dtype=np.float32
                                          ).from_numpy(A0.copy())
                    ctx.add_taskpool(factory.new(descA=A, NT=nt))
                    ctx.wait()
                    return A.to_numpy()

            R1 = aliased(1)
            c1 = ctx.stage_stats["stage_compiles"]
            assert c1 > 0
            R2 = aliased(0)
            assert ctx.stage_stats["stage_compiles"] == c1, \
                "the BDY204 class recorded anew: donation was not off"
            np.testing.assert_array_equal(R1, A0 * 2)
            np.testing.assert_array_equal(R2, A0 * 2)

            def clean(donate):
                with _knobs(stage_compile_donate=donate):
                    A = TwoDimBlockCyclic(128, 128, 32, 32,
                                          dtype=np.float32
                                          ).from_numpy(M.copy())
                    ctx.add_taskpool(dpotrf_taskpool(A))
                    ctx.wait()

            clean(1)
            c2 = ctx.stage_stats["stage_compiles"]
            clean(0)
            assert ctx.stage_stats["stage_compiles"] > c2, \
                "the clean class did not record anew: the control is broken"
        finally:
            ctx.fini()


def test_stagec_prestage_issues_and_hits():
    """Prestage/execute overlap: a stage-compiled run prestages its slot
    tiles through the device module's prefetch seam and the spawn-time
    accounting sees them land."""
    _clear_stage_cache()
    _l, s1, *_ = _run_dpotrf(128, 32, True)
    assert s1["prestage_issued"] > 0, s1
    assert 0 < s1["prestage_hits"] <= s1["prestage_issued"], s1


# --------------------------------------------------------------------- #
# the chain                                                             #
# --------------------------------------------------------------------- #
def _run_dposv(stagec, chain=True, n=128, nb=32, nrhs=32, dtype=np.float32):
    from parsec_tpu_torch.ops import dposv
    M = make_spd(n).astype(dtype)
    B0 = np.random.RandomState(7).rand(n, nrhs).astype(dtype)
    with _knobs(stagec, stage_compile_chain=int(chain)):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb, dtype=dtype).from_numpy(
                M.copy())
            B = TwoDimBlockCyclic(n, nrhs, nb, nrhs,
                                  dtype=dtype).from_numpy(B0.copy())
            dposv(ctx, A, B)
            rejects = (list(ctx._stage_chain.rejects)
                       if ctx._stage_chain is not None else None)
            return B.to_numpy(), dict(ctx.stage_stats), rejects
        finally:
            ctx.fini()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stagec_chain_dposv_one_program(dtype):
    """Single-rank dposv's three pools run as ONE chained program: both
    boundaries link (chain_links == 2), one stage dispatch runs all three
    pools, no fallback or rejection, and X is bit-exact vs the
    interpreted composition; with the chain off, three programs, the
    same X."""
    X0, _s0, _r = _run_dposv(False, dtype=dtype)
    Xc, sc, rejects = _run_dposv(True, chain=True, dtype=dtype)
    assert sc["chain_links"] == 2 and sc["chain_fallbacks"] == 0, sc
    assert sc["stage_dispatches"] == 1, sc
    assert rejects == [], rejects
    np.testing.assert_array_equal(Xc, X0)
    Xp, sp, _r2 = _run_dposv(True, chain=False, dtype=dtype)
    assert sp["chain_links"] == 0 and sp["stage_dispatches"] == 3, sp
    np.testing.assert_array_equal(Xp, X0)


def test_stagec_chain_host_failure_falls_back(monkeypatch):
    """A chained program that cannot be recorded falls back to the
    host-only program, and the rider pools, finding no stash, dispatch
    their stages normally: bit-exact X, chain_fallbacks counted, no
    hang."""
    import parsec_tpu_torch.stagec.chain as chain_mod

    _clear_stage_cache()

    def failing_chain_run(*a, **k):
        raise CaptureError("injected: the chained program cannot be "
                           "recorded")

    monkeypatch.setattr(chain_mod, "build_chain_run", failing_chain_run)
    X0, _s0, _r = _run_dposv(False)
    Xc, sc, _rej = _run_dposv(True, chain=True)
    assert sc["chain_links"] == 0, sc
    assert sc["chain_fallbacks"] >= 1, sc
    assert sc["stage_dispatches"] == 3, sc
    np.testing.assert_array_equal(Xc, X0)
    _clear_stage_cache()


def _spmd(nr, fn, timeout=300):
    from parsec_tpu_torch.utils.spmd import spmd_threads
    return spmd_threads(nr, fn, timeout=timeout)


def _ranks_run(stagec, solve, n=128, nb=32, nr=2):
    """dpotrf (or dposv) over ``nr`` in-process ranks on a LocalFabric;
    returns (the assembled result, per-rank stage stats, rejects)."""
    from parsec_tpu_torch.comm import RemoteDepEngine
    from parsec_tpu_torch.ops import dposv
    M = make_spd(n)
    B0 = np.random.RandomState(9).rand(n, nb).astype(np.float32)

    def rank_fn(rank, fabric):
        with _knobs(stagec):
            ctx = ptt.Context(nb_cores=2, device="cpu",
                              comm=RemoteDepEngine(fabric.engine(rank)))
            try:
                A = TwoDimBlockCyclic(n, n, nb, nb, P=nr, Q=1, nodes=nr,
                                      rank=rank, dtype=np.float32
                                      ).from_numpy(M.copy())
                A.name = "descA"
                B = TwoDimBlockCyclic(n, nb, nb, nb, P=nr, Q=1, nodes=nr,
                                      rank=rank, dtype=np.float32
                                      ).from_numpy(B0.copy())
                B.name = "descB"
                if solve:
                    dposv(ctx, A, B, rank=rank, nb_ranks=nr)
                    C = B
                else:
                    ctx.add_taskpool(dpotrf_taskpool(A, rank=rank,
                                                     nb_ranks=nr))
                    ctx.wait()
                    C = A
                owned = {c: np.asarray(C.data_of(*c).sync_to_host().payload)
                         for c in C.tiles() if C.rank_of(*c) == rank}
                rej = (list(ctx._stage_chain.rejects)
                       if ctx._stage_chain is not None else None)
                return owned, dict(ctx.stage_stats), rej
            finally:
                ctx.fini()

    results, _f = _spmd(nr, rank_fn)
    X = np.zeros((n, n if not solve else nb), np.float32)
    stats, rejects = [], []
    for owned, st_, rej in results:
        stats.append(st_)
        rejects.append(rej)
        for (m, k), t in owned.items():
            X[m * nb:m * nb + t.shape[0], k * nb:k * nb + t.shape[1]] = t
    return X, stats, rejects


def test_stagec_chain_rejects_multirank_dataflow():
    """2-rank dposv: cross-rank dataflow is not fusable — the chain
    planner REJECTS the boundaries (a reason recorded, no fallback
    counted) and the distributed composition stays bit-exact vs
    interpreted."""
    X0, _s0, _r0 = _ranks_run(False, True)
    X1, s1, r1 = _ranks_run(True, True)
    for s, rej in zip(s1, r1):
        assert s["chain_links"] == 0 and s["chain_fallbacks"] == 0, s
        assert s["stage_tasks"] > 0, s
        assert rej, "no chain-rejection reason was recorded"
    np.testing.assert_array_equal(X1, X0)


def test_stagec_multirank_engages_per_rank():
    """2 in-process ranks over the port's local comm: each rank compiles
    its local stages (stage_tasks > 0 on every rank), the cross-rank
    activations ride the untouched protocol, and the distributed factor
    is bit-exact vs the interpreted run."""
    L0, _s0, _r = _ranks_run(False, False)
    L1, s1, _r1 = _ranks_run(True, False)
    assert all(s["stage_tasks"] > 0 for s in s1), s1
    np.testing.assert_array_equal(np.tril(L1), np.tril(L0))


# --------------------------------------------------------------------- #
# the chip mesh                                                         #
# --------------------------------------------------------------------- #
def test_stagec_mesh_sharded_bit_exact():
    """On a 2 x 2 mesh rank (device_mesh_shape, 4 host chips) eligible
    wave-front stages run their rows over the chips — still bit-exact vs
    the single-chip interpreted path (NT = 5: the k = 0 SYRK wave has 4
    members, the chip count)."""
    L0, *_ = _run_dpotrf(160, 32, False)
    L1, s1, sc, _m, dev = _run_dpotrf(160, 32, True,
                                      **_mesh({}))
    assert dev.name == "cpu:mesh2x2"
    assert s1["stage_tasks"] == _nt_tasks(160, 32), s1
    assert s1["stage_sharded"] >= 1 and s1["stage_fallbacks"] == 0, s1
    rows = sc.program_report()
    assert any(r.get("sharded") for r in rows)
    np.testing.assert_array_equal(L1, L0)


SCALEWAVE_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

Gen(m)
m = 0 .. NT-1
: descA( m, 0 )
RW A <- descA( m, 0 )
     -> A Scale( m )
BODY [type=cuda]
{
    A = A + 1.0
}
END

Scale(m)
m = 0 .. NT-1
: descA( m, 0 )
RW A <- A Gen( m )
     -> descA( m, 0 )
BODY [type=cuda]
{
    A = A * (m + 2)
}
END
"""


def test_stagec_sharded_locals_per_row():
    """A wave-front class whose body READS a declared local
    (``A = A * (m + 2)``) runs sharded over the mesh, each row with its
    own value of ``m`` (the JAX package ships locals as traced scalars;
    here each row's environment holds them) — bit-exact vs
    interpreted."""
    nb, nt = 8, 4
    A0 = np.random.RandomState(3).rand(nt * nb, nb).astype(np.float32)

    def run(stagec, mesh):
        with _knobs(stagec, **(_mesh({}) if mesh else {})):
            ctx = ptt.init(nb_cores=2, device="cpu")
            try:
                A = TwoDimBlockCyclic(nt * nb, nb, nb, nb,
                                      dtype=np.float32).from_numpy(A0.copy())
                tp = ptg.compile_jdf(SCALEWAVE_JDF, name="scalewave").new(
                    descA=A, NT=nt)
                ctx.add_taskpool(tp)
                ctx.wait()
                return A.to_numpy(), dict(ctx.stage_stats), tp._stagec
            finally:
                ctx.fini()

    R0, _s0, _x = run(False, False)
    R1, s1, sc = run(True, True)
    assert s1["stage_sharded"] >= 2 and s1["stage_fallbacks"] == 0, s1
    np.testing.assert_array_equal(R1, R0)
    np.testing.assert_array_equal(
        R1, np.concatenate([(A0[m * nb:(m + 1) * nb] + 1.0) * (m + 2)
                            for m in range(nt)]))
    sharded = [r for r in sc.program_report() if r.get("sharded")]
    assert sharded and all(r["tasks"] == nt for r in sharded), sharded


def test_stagec_sharded_dispatch_failure_raises(monkeypatch):
    """The JAX package's sharded-to-single-chip fallback (its rung 4) is
    not carried: a sharded dispatch that fails aborts the DAG and
    re-raises from wait()."""
    import parsec_tpu_torch.stagec.sharded as sh

    def broken(*a, **k):
        raise RuntimeError("injected sharded dispatch failure")

    monkeypatch.setattr(sh, "dispatch_sharded", broken)
    with pytest.raises(RuntimeError) as ei:
        _run_dpotrf(160, 32, True, **_mesh({}))
    assert "injected sharded dispatch failure" in str(ei.value) \
        or "injected sharded dispatch failure" in repr(ei.value.__cause__)


def test_stagec_mesh_ineligible_wave_takes_single_chip():
    """A wave front the chip count does not divide is a planning
    decision: its stage takes the single-chip program, nothing falls
    back, the factor is the interpreted one (NT = 4: no wave of 4)."""
    L0, *_ = _run_dpotrf(128, 32, False)
    L1, s1, sc, *_ = _run_dpotrf(128, 32, True, **_mesh({}))
    assert s1["stage_sharded"] == 0 and s1["stage_fallbacks"] == 0, s1
    assert s1["stage_tasks"] == _nt_tasks(128, 32)
    np.testing.assert_array_equal(L1, L0)


# --------------------------------------------------------------------- #
# verdicts, gauges, lint                                                #
# --------------------------------------------------------------------- #
def test_stagec_lowerability_verdicts():
    """class_verdicts reuses the analysis/ findings: a this_task body
    comes back BDY201, a host-syncing body BDY202, clean device specs
    fully compilable."""
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
    from parsec_tpu_torch.ops.dpotrf import DPOTRF_L_JDF
    from parsec_tpu_torch.stagec import class_verdicts, lower_report

    v = class_verdicts(parse_jdf(DPOTRF_L_JDF, name="dpotrf"))
    assert all(x.ok for x in v.values()), v
    mixed = """
descA [ type="collection" ]

Gen(k)
k = 0 .. 3
: descA( k, 0 )
RW A <- descA( k, 0 )
     -> A Peek( k )
     -> A Sync( k )
     -> descA( k, 0 )
BODY [type=cuda]
{
    A = A + 1.0
}
END

Peek(k)
k = 0 .. 3
: descA( k, 0 )
READ A <- A Gen( k )
BODY [type=cuda]
{
    A = A * (1 if this_task is None else 1)
}
END

Sync(k)
k = 0 .. 3
: descA( k, 0 )
READ A <- A Gen( k )
BODY [type=cuda]
{
    s = A.sum().item()
}
END
"""
    jdf = parse_jdf(mixed, name="mixed")
    v = class_verdicts(jdf)
    assert v["Gen"].ok
    assert not v["Peek"].ok and v["Peek"].code == "BDY201", v["Peek"]
    assert not v["Sync"].ok and v["Sync"].code == "BDY202", v["Sync"]
    report = "\n".join(lower_report(jdf))
    assert "Peek: fallback [BDY201]" in report
    assert "Gen: compilable" in report


def test_stagec_gauges_in_exposition():
    """The PARSEC::STAGEC::* gauges surface in the Prometheus exposition
    after a stage-compiled run, the cross-rank XSTAGE_* series at 0."""
    from parsec_tpu_torch.obs import parse_exposition

    _clear_stage_cache()
    with _knobs(True):
        ctx = ptt.Context(nb_cores=2, device="cpu")
        try:
            M = make_spd(128)
            A = TwoDimBlockCyclic(128, 128, 32, 32,
                                  dtype=np.float32).from_numpy(M)
            ctx.add_taskpool(dpotrf_taskpool(A))
            ctx.wait()
            text = ctx.obs.render_prometheus(labels={"rank": "0"})
        finally:
            ctx.fini()
    vals = {n: v for (n, _l), v in parse_exposition(text).items()
            if n.startswith("parsec_stagec_")}
    assert vals.get("parsec_stagec_stage_tasks", 0) > 0, sorted(vals)
    assert vals.get("parsec_stagec_stage_compiles", 0) > 0, vals
    assert vals.get("parsec_stagec_stage_fallbacks", -1) == 0, vals
    assert vals.get("parsec_stagec_stage_compile_us", 0) > 0, vals
    assert vals.get("parsec_stagec_prestage_hits", -1) >= 0, vals
    assert vals.get("parsec_stagec_chain_links", -1) == 0, vals
    assert vals.get("parsec_stagec_chain_fallbacks", -1) == 0, vals
    assert vals.get("parsec_stagec_residue_batches", -1) == 0, vals
    assert vals.get("parsec_stagec_xstage_tasks", -1) == 0, vals


def test_stagec_classes_feed_the_tune_family():
    """obs' attribution source names the classes of a context's live
    compiled stages (the tune controller's stage-compile family acts on
    them), in plan order; a pool running interpreted names none."""
    from types import SimpleNamespace

    from parsec_tpu_torch.obs import _compiled_stage_classes
    from parsec_tpu_torch.stagec import try_install

    M = make_spd(128)
    with _knobs(True):
        ctx = ptt.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(128, 128, 32, 32,
                                  dtype=np.float32).from_numpy(M.copy())
            tp = dpotrf_taskpool(A)
            live = SimpleNamespace(taskpools={0: tp})
            assert _compiled_stage_classes(live) == []
            tp._stagec = try_install(tp, ctx)
            assert _compiled_stage_classes(live) == \
                ["POTRF", "TRSM", "SYRK", "GEMM"]
        finally:
            ctx.fini()


def test_stagec_lock_discipline_enforced():
    """stagec/runtime.py opts into the concurrency lint with a populated
    _GUARDED_BY map: the shipped module is clean, and an injected
    unguarded access IS caught."""
    from parsec_tpu_torch.analysis import lock_check

    path = os.path.join(ROOT, "parsec_tpu_torch", "stagec", "runtime.py")
    clean = [f for f in lock_check.lint_file(path)
             if f.severity in ("error", "warn")]
    assert not clean, clean
    bad = open(path).read() + ("\n\ndef _unguarded_poke(rec):\n"
                               "    rec.remaining -= 1\n")
    findings = lock_check.lint_source(bad, filename="runtime.py")
    assert any(f.code == "LCK301" and "remaining" in f.message
               for f in findings), findings


def _lint(*argv):
    proc = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.analysis", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items()
             if not k.startswith("PARSEC_MCA_")})
    return proc.returncode, proc.stdout + proc.stderr


def test_stagec_lint_lower_report_cli():
    """``python -m parsec_tpu_torch.analysis --lower-report`` prints the
    per-class verdicts, the per-stage partition and, for dtrsm's two
    specs, the chain verdict, and exits 0."""
    rc, out = _lint("--lower-report",
                    os.path.join(ROOT, "parsec_tpu_torch", "ops",
                                 "dpotrf.py"),
                    os.path.join(ROOT, "parsec_tpu_torch", "ops",
                                 "dtrsm.py"))
    assert rc == 0, out
    assert "POTRF: compilable" in out and "GEMM: compilable" in out
    assert "stage#0:" in out and "stage(s) covering" in out, out
    assert "chain FWD_JDF -> BWD_JDF: fusable" in out, out
    assert "--lower-report: 3 spec(s)" in out, out


def test_stagec_lint_lower_report_chain_rejection_reason(tmp_path):
    """--lower-report prints the chain-rejection REASON when two pools do
    not fuse: a second spec whose first stage awaits task activations
    (its compilable class is fed by a host-bodied producer)."""
    path = tmp_path / "unfusable.py"
    path.write_text('''
A_JDF = """
descA [ type="collection" ]

Gen(k)
k = 0 .. 3
: descA( k, 0 )
RW A <- descA( k, 0 )
     -> descA( k, 0 )
BODY [type=cuda]
{
    A = A + 1.0
}
END
"""

B_JDF = """
descA [ type="collection" ]

Host(k)
k = 0 .. 3
: descA( k, 0 )
RW A <- descA( k, 0 )
     -> A Use( k )
     -> descA( k, 0 )
BODY
{
    A[...] = np.asarray(A) * 2.0
}
END

Use(k)
k = 0 .. 3
: descA( k, 0 )
READ A <- A Host( k )
BODY [type=cuda]
{
    A = A * 1.0
}
END
"""
''')
    rc, out = _lint("--lower-report", str(path))
    assert rc == 0, out
    assert "chain A_JDF -> B_JDF: rejected" in out, out
    assert "awaits" in out and "activation" in out, out


@pytest.mark.parametrize("knob,value", [("stage_compile_xrank", "1"),
                                       ("stage_xrank_timeout", "60"),
                                       ("stage_xrank_timeout", "5")])
def test_stagec_xrank_knob_raises_naming_f2(knob, value):
    """Named for the refusal it replaced: cross-rank SPMD stages are
    carried now, so stage_compile_xrank=1 and a rendezvous timeout are
    live knobs — init accepts each beside stage_compile, nothing names
    the old roadmap part, and a pool of one rank plans no cross-rank
    wave (the knob needs nb_ranks > 1)."""
    from parsec_tpu_torch.utils.params import params as p
    with _knobs(True, **{knob: value}):
        assert str(p.get(knob)) in (value, "True")
        ctx = ptt.init(nb_cores=1, device="cpu")
        try:
            A = TwoDimBlockCyclic(64, 64, 32, 32,
                                  dtype=np.float32).from_numpy(make_spd(64))
            tp = dpotrf_taskpool(A)
            ctx.add_taskpool(tp)
            ctx.wait()
            assert tp._stagec is not None and tp._stagec.plan.xwaves == []
            assert ctx.stage_stats["xstage_tasks"] == 0
        finally:
            ctx.fini()


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #
@pytest.fixture
def on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")


@pytest.mark.gpu
def test_stagec_graphs_on_card_bit_exact(on_card):
    """On the card each stage is one recorded CUDA graph: the factor is
    the interpreted runtime's bit for bit, the graphs recorded GEMM
    launches and replayed, and a second pool replays without recording."""
    _clear_stage_cache()
    L0, *_ = _run_dpotrf(512, 128, False, device=None)
    (L1, s1, sc), (L2, s2, sc2) = _run_dpotrf_pools(512, 128, 2,
                                                    device=None)
    np.testing.assert_array_equal(L1, L0)
    np.testing.assert_array_equal(L2, L0)
    rows = sc.program_report()
    assert sum(r["captured_gemm_launches"] for r in rows) > 0, rows
    assert all(r["replays"] >= 1 for r in rows), rows
    assert s1["stage_fallbacks"] == 0 and s2["stage_compiles"] == 0, s2
    assert all(r["replays"] >= 2 for r in sc2.program_report())


def _xrank_tcp(M, n, nb, kv, nr=2):
    """dpotrf over ``nr`` rank threads on loopback TCP, on the card, the
    knobs ``kv`` set around the engines' construction (the "xs"
    capability rides the HELLO); returns (L, per-rank stage stats,
    per-rank program reports, the "xs" links).  The ranks meet at a
    barrier after their pools: nothing synchronizes the whole device
    while another rank still records a stage."""
    import errno
    import threading
    from parsec_tpu_torch.comm import RemoteDepEngine
    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports
    barrier = threading.Barrier(nr, timeout=120)
    with _knobs(**kv):
        for attempt in range(5):
            eps = [("127.0.0.1", p) for p in free_ports(nr)]
            try:
                engines, _f = _spmd(nr, lambda r, _f: TCPCommEngine(r, eps),
                                    timeout=60)
                break
            except OSError as exc:
                if exc.errno != errno.EADDRINUSE or attempt == 4:
                    raise
        links = [engines[r].xstage_to(p) for r in range(nr)
                 for p in range(nr) if p != r]

        def rank_fn(rank, _f):
            ctx = ptt.Context(nb_cores=2,
                              comm=RemoteDepEngine(engines[rank]))
            try:
                A = TwoDimBlockCyclic(n, n, nb, nb, P=nr, Q=1, nodes=nr,
                                      rank=rank, dtype=np.float32
                                      ).from_numpy(M.copy())
                A.name = "descA"
                tp = dpotrf_taskpool(A, rank=rank, nb_ranks=nr)
                try:
                    ctx.add_taskpool(tp)
                    ctx.wait()
                except BaseException:
                    barrier.abort()
                    raise
                barrier.wait()
                return ({c: np.asarray(A.data_of(*c).sync_to_host().payload)
                         for c in A.tiles() if A.rank_of(*c) == rank},
                        dict(ctx.stage_stats),
                        tp._stagec.program_report() if tp._stagec else [])
            finally:
                ctx.fini()

        res, _f = _spmd(nr, rank_fn, timeout=180)
    L = np.zeros((n, n), np.float32)
    for owned, _s, _r in res:
        for (m, k), t in owned.items():
            L[m * nb:m * nb + t.shape[0], k * nb:k * nb + t.shape[1]] = t
    return np.tril(L), [r[1] for r in res], [r[2] for r in res], links


@pytest.mark.gpu
def test_stagec_xrank_on_card_bit_exact(on_card):
    """Cross-rank stages on the card: two rank threads on loopback TCP,
    one logical lane chip of cuda:0 each; each rank's rows of a spanning
    wave are one CUDA graph on its chip.  The factor is the interpreted
    2-rank factor bit for bit, and the blocks' graphs recorded GEMM
    launches that their replays ran."""
    n, nb = 512, 128
    M = make_spd(n)
    chips = {"device_cuda_virtual_chips": "2"}
    L0, _s, _r, _l = _xrank_tcp(M, n, nb, chips)
    L1, st, rows, links = _xrank_tcp(
        M, n, nb, dict(chips, stage_compile="1", stage_compile_xrank="1"))
    assert all(links), links
    assert all(s["xstage_tasks"] > 0 and s["xstage_fallbacks"] == 0
               for s in st), st
    blocks = [r for rr in rows for r in rr if r.get("xrank")]
    assert sum(r["captured_gemm_launches"] for r in blocks) > 0, blocks
    assert all(r["replays"] >= 1 for r in blocks), blocks
    np.testing.assert_array_equal(L1, L0)


@pytest.mark.gpu
def test_record_captures_on_an_own_stream(on_card):
    """PyTorch hands out its pooled streams in turn (32 a device), so two
    streams made apart may be one: a record that captured on a pooled
    stream could take in the launches another thread made on that stream.
    A record captures on a stream of the process's own, one for each
    stream its replays run on, which no pooled stream is."""
    from parsec_tpu_torch.dsl.graph import GraphRunner, own_stream
    dev = torch.device("cuda", 0)
    pooled = [torch.cuda.Stream(device=dev).cuda_stream for _ in range(64)]
    assert len(set(pooled)) < len(pooled), "the pool did not repeat"
    replay = torch.cuda.Stream(device=dev)
    seen = []

    def execute(state, device, note):
        seen.append(torch.cuda.current_stream(device).cuda_stream)
        return {"y": state["x"] * 2.0}

    gr = GraphRunner(execute, "own stream", lambda: ["y"])
    with torch.cuda.stream(replay):
        x = torch.ones(4, device=dev)
        gr.record({"x": x}, dev)
        out = gr.run({"x": x}, dev)
    capture = own_stream(dev, ("capture", replay.cuda_stream)).cuda_stream
    assert seen[-1] == capture and capture not in pooled
    assert torch.equal(out["y"], torch.full((4,), 2.0, device=dev))


HOSTSYNC_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

Sync(m)
m = 0 .. NT-1
: descA( m, 0 )
RW A <- descA( m, 0 )
     -> descA( m, 0 )
BODY [type=cuda]
{
    A = A * float(A.sum().item() > -1.0)
}
END
"""


@pytest.mark.gpu
def test_stagec_launch_accounting_on_card(on_card):
    """The wrapper's count of GEMM launches is the records' warm-ups and
    captures (each counted on its recording thread) plus the device
    module's dispatches (the residue bursts, launching from other
    workers while stages record); a replay counts nothing."""
    from parsec_tpu_torch.ops import kernels
    _clear_stage_cache()
    L0, *_ = _run_dpotrf(1024, 128, False, device=None)
    M = make_spd(1024)
    with _knobs(True, stage_compile_exclude="SYRK"):
        ctx = ptt.init(nb_cores=4)
        try:
            dev = ctx.device_by_type("cuda")
            A = TwoDimBlockCyclic(1024, 1024, 128, 128,
                                  dtype=np.float32).from_numpy(M.copy())
            tp = dpotrf_taskpool(A)
            k0, d0 = kernels.matmul_launches, dev.gemm_launches
            ctx.add_taskpool(tp)
            ctx.wait()
            counted = kernels.matmul_launches - k0
            dispatched = dev.gemm_launches - d0
            rows = tp._stagec.program_report()
            L = np.tril(A.to_numpy())
            st = dict(ctx.stage_stats)
        finally:
            ctx.fini()
    np.testing.assert_array_equal(L, L0)
    warm = sum(r["warmup_gemm_launches"] for r in rows)
    cap = sum(r["captured_gemm_launches"] for r in rows)
    assert st["residue_batches"] > 0 and dispatched > 0, (st, dispatched)
    assert warm > 0 and cap == warm, rows
    assert counted == warm + cap + dispatched, (counted, warm, cap,
                                                dispatched)


@pytest.mark.gpu
def test_stagec_host_sync_body_downgrades_on_card(on_card, monkeypatch):
    """A body that syncs with the host cannot be recorded: its stage
    downgrades (stage_fallbacks == 1) and runs interpreted on the card,
    the result right.  The verdict would refuse the class (BDY202); the
    test forces it through the planner to reach the record."""
    import parsec_tpu_torch.stagec.plan as plan_mod

    _clear_stage_cache()
    real = plan_mod.class_verdicts

    def lenient(jdf):
        return {k: plan_mod.ClassVerdict(k, True)
                for k in real(jdf)}

    monkeypatch.setattr(plan_mod, "class_verdicts", lenient)
    nb, nt = 64, 4
    A0 = np.random.RandomState(3).rand(nt * nb, nb).astype(np.float32)
    with _knobs(True):
        ctx = ptt.init(nb_cores=2)
        try:
            A = TwoDimBlockCyclic(nt * nb, nb, nb, nb,
                                  dtype=np.float32).from_numpy(A0.copy())
            ctx.add_taskpool(ptg.compile_jdf(HOSTSYNC_JDF,
                                             name="hostsync").new(
                descA=A, NT=nt))
            ctx.wait()
            st = dict(ctx.stage_stats)
            out = A.to_numpy()
        finally:
            ctx.fini()
    assert st["stage_fallbacks"] == 1, st
    np.testing.assert_array_equal(out, A0)


@pytest.mark.gpu
def test_stagec_chain_and_mesh_on_card(on_card):
    """dposv as one chained graph and a 2 x 2 mesh of logical chips on
    the card, each bit-exact vs the interpreted runtime there."""
    from parsec_tpu_torch.ops import dposv
    _clear_stage_cache()
    n, nb = 512, 128
    M = make_spd(n)
    B0 = np.random.RandomState(7).rand(n, nb).astype(np.float32)
    outs = []
    for stagec in (False, True):
        with _knobs(stagec):
            ctx = ptt.init(nb_cores=2)
            try:
                A = TwoDimBlockCyclic(n, n, nb, nb,
                                      dtype=np.float32).from_numpy(M.copy())
                B = TwoDimBlockCyclic(n, nb, nb, nb,
                                      dtype=np.float32).from_numpy(B0.copy())
                dposv(ctx, A, B)
                outs.append((B.to_numpy(), dict(ctx.stage_stats)))
            finally:
                ctx.fini()
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1]["chain_links"] == 2, outs[1][1]
    L0, *_ = _run_dpotrf(640, 128, False, device=None)
    L1, s1, *_ = _run_dpotrf(640, 128, True, device=None, **_mesh({}))
    assert s1["stage_sharded"] >= 1, s1
    np.testing.assert_array_equal(L1, L0)


@pytest.mark.gpu
def test_stagec_dead_spec_frees_its_graphs_on_card(on_card):
    """On the card a context's recorded graphs go at its fini: the
    programs are collected, their static slots and private memory pools
    return to the allocator, and nothing of the spec's cache outlives
    the context."""
    import weakref
    from parsec_tpu_torch.devices.batching import live_stage_entries
    from parsec_tpu_torch.ops.dpotrf import DPOTRF_L_JDF
    _clear_stage_cache()
    gc.collect()
    torch.cuda.empty_cache()
    entries = live_stage_entries()
    factory = ptg.compile_jdf(DPOTRF_L_JDF, name="dpotrf_dead_card")
    n, nb = 1024, 256
    M = make_spd(n)
    with _knobs(True):
        ctx = ptt.init(nb_cores=2)
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb,
                                  dtype=np.float32).from_numpy(M.copy())
            tp = factory.new(descA=A, NT=A.mt)
            tp.global_env["ops"] = ptt.ops
            ctx.add_taskpool(tp)
            ctx.wait()
            L = np.tril(A.to_numpy())
            assert live_stage_entries() > entries
            progs = [rec.fn for rec in tp._stagec._recs]
            slots = {t.untyped_storage().data_ptr(): t.nbytes
                     for p in progs for g in p.graphs.values()
                     for t in list(g._static_in.values())
                     + list(g._static_out.values())}
            static = sum(slots.values())
            refs = [weakref.ref(p) for p in progs]
            del progs
            gc.collect()
            held = torch.cuda.memory_allocated()
        finally:
            ctx.fini()
    del A, tp, ctx
    gc.collect()
    torch.cuda.empty_cache()
    assert static > 0 and all(r() is None for r in refs)
    assert held - torch.cuda.memory_allocated() >= static, \
        (held, torch.cuda.memory_allocated(), static)
    assert live_stage_entries() == entries
    del factory
    L0, *_ = _run_dpotrf(n, nb, False, device=None)
    np.testing.assert_array_equal(L, L0)
