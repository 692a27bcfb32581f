"""Static dependency management in the port (parsec_tpu_torch): PTG
lowering into flat arrays and the native counter engine (ref:
--dep-management=index-array), held against the JAX package's.

The port's lowering must give the JAX package's arrays exactly; its
native engine must agree with the Python mirror step by step; static
mode on the classic per-task dispatch must give a factor bit-identical
to the port's hash mode and within 5e-4 of the JAX package's static
mode on the same input.  The port runs its CUDA device module over host
tensors (``init(device="cpu")``); the ``gpu`` case runs on the card.
"""
import numpy as np
import pytest
import torch

import parsec_tpu
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.dsl.ptg.lower import lower as jlower
from parsec_tpu.ops import (dgeqrf_taskpool as jdgeqrf_taskpool,
                            dgetrf_nopiv_taskpool as jdgetrf_nopiv_taskpool,
                            dpotrf_taskpool as jdpotrf_taskpool)
from parsec_tpu.utils.params import params as jparams

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.ptg.capture import plan
from parsec_tpu_torch.dsl.ptg.lower import PyDAG, lower, make_engine
from parsec_tpu_torch.ops import (dgeqrf_taskpool, dgetrf_nopiv_taskpool,
                                  dpotrf_taskpool, make_spd)
from parsec_tpu_torch.utils.params import params

ATOL = 5e-4   # the reference tests' bound on fp32 factors
KINDS = ("potrf", "getrf", "geqrf")
PORT = {"potrf": dpotrf_taskpool, "getrf": dgetrf_nopiv_taskpool,
        "geqrf": dgeqrf_taskpool}
JAX = {"potrf": jdpotrf_taskpool, "getrf": jdgetrf_nopiv_taskpool,
       "geqrf": jdgeqrf_taskpool}


def _matrix(kind, n, seed=0):
    if kind == "geqrf":
        return np.random.RandomState(seed + 3).rand(n, n).astype(np.float32)
    return make_spd(n, dtype=np.float32, seed=seed)


def _port_pool(kind, M, nb):
    n = M.shape[0]
    A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    return PORT[kind](A), A


def _jax_pool(kind, M, nb):
    n = M.shape[0]
    A = JTwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
    return JAX[kind](A), A


@pytest.mark.parametrize("kind", KINDS)
def test_lowering_equals_jax(kind):
    """The same taskpool lowers to the JAX package's arrays exactly."""
    M = _matrix(kind, 512)
    tdag = lower(_port_pool(kind, M, 128)[0], use_cache=False)
    jdag = jlower(_jax_pool(kind, M, 128)[0], use_cache=False)
    assert tdag.n_tasks == jdag.n_tasks and tdag.n_edges == jdag.n_edges
    assert tdag.class_names == jdag.class_names
    assert tdag.max_flows == jdag.max_flows
    for name in ("indptr", "succ", "succ_flow", "out_flow", "indegree",
                 "priority", "class_of"):
        a, b = getattr(tdag, name), getattr(jdag, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tdag.locals_of == jdag.locals_of
    assert tdag.id_of == jdag.id_of
    np.testing.assert_array_equal(tdag.startup_ids(), jdag.startup_ids())


@pytest.mark.parametrize("kind", KINDS)
def test_lowering_matches_capture_plan(kind):
    """The lowered edges agree with the capture planner's independent
    consumer-side resolution: same task set, each task's indegree equals
    its resolved predecessor count."""
    tp, _ = _port_pool(kind, _matrix(kind, 512), 128)
    dag = lower(tp, use_cache=False)
    order = plan(tp)
    assert dag.n_tasks == len(order)
    pred_counts = {inst.key: len(inst.preds) for inst in order}
    for tid in range(dag.n_tasks):
        key = (dag.class_names[int(dag.class_of[tid])], dag.locals_of[tid])
        assert dag.indegree[tid] == pred_counts[key], f"indegree {key}"
    assert dag.n_edges == sum(pred_counts.values())
    startup = {(dag.class_names[int(dag.class_of[t])], dag.locals_of[t])
               for t in dag.startup_ids()}
    assert startup == {k for k, n in pred_counts.items() if n == 0}


@pytest.mark.parametrize("kind", KINDS)
def test_native_and_python_engines_agree(kind):
    """Drive a lowered DAG to completion through the native engine and
    the Python mirror in the same order; ready sets match step by
    step."""
    dag = lower(_port_pool(kind, _matrix(kind, 512), 128)[0],
                use_cache=False)
    eng_a = make_engine(dag)
    eng_b = PyDAG(dag)
    assert type(eng_a).__module__ == "_parsec_torch_native"
    ra, rb = eng_a.start(), eng_b.start()
    done = 0
    while ra or rb:
        assert sorted(ra) == sorted(rb)
        frontier = sorted(ra)
        ra, rb = [], []
        for t in frontier:
            ra.extend(eng_a.complete(t))
            rb.extend(eng_b.complete(t))
            done += 1
    assert done == dag.n_tasks
    assert eng_a.completed() == eng_b.completed() == dag.n_tasks


@pytest.mark.parametrize("engine", ["native", "python"])
def test_binding_routing_and_overrelease(engine):
    """complete() routes the produced copy to the successor's flow slot;
    releasing past indegree raises instead of corrupting counters."""
    tp, _ = _port_pool("potrf", _matrix("potrf", 512), 128)
    dag = lower(tp, use_cache=False)
    eng = make_engine(dag) if engine == "native" else PyDAG(dag)
    tid = eng.start()[0]
    tc = tp.task_classes[int(dag.class_of[tid])]
    sentinel = object()
    eng.complete(tid, tuple(sentinel for _ in tc.ast.flows))
    lo, hi = int(dag.indptr[tid]), int(dag.indptr[tid + 1])
    routed = {(int(dag.succ[e]), int(dag.succ_flow[e]))
              for e in range(lo, hi)}
    assert routed
    for sid in {s for s, _ in routed}:
        b = eng.take_bindings(sid)
        assert len(b) == dag.max_flows
        for (s, f) in routed:
            if s == sid:
                assert b[f] is sentinel
    with pytest.raises((RuntimeError, AssertionError)):
        for _ in range(dag.n_tasks + 1):
            eng.complete(tid)  # keep over-releasing until it must trip


def test_make_engine_is_native():
    """make_engine never returns the Python mirror."""
    dag = lower(_port_pool("potrf", _matrix("potrf", 256), 128)[0])
    assert not isinstance(make_engine(dag), PyDAG)


def _port_run(kind, M, nb, mode, dispatch="classic"):
    """Factor M on the port's CPU context; returns (result, taskpool)."""
    with params.cmdline_override("ptg_dep_management", mode), \
            params.cmdline_override("ptg_dispatch", dispatch):
        ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
        try:
            tp, A = _port_pool(kind, M, nb)
            ctx.add_taskpool(tp)
            ctx.wait()
            dev = ctx.device_by_type("cuda")
            assert dev.stats["tasks"] == dev.executed_tasks
            return A.to_numpy(), tp
        finally:
            ctx.fini()


def _jax_static(kind, M, nb):
    with jparams.cmdline_override("ptg_dep_management", "static"), \
            jparams.cmdline_override("ptg_dispatch", "classic"):
        ctx = parsec_tpu.init(nb_cores=2)
        try:
            tp, A = _jax_pool(kind, M, nb)
            ctx.add_taskpool(tp)
            ctx.wait()
            assert tp._engine is not None
            return A.to_numpy()
        finally:
            ctx.fini()


@pytest.mark.parametrize("kind,n,nb", [("potrf", 512, 128),
                                       ("potrf", 200, 64),
                                       ("getrf", 384, 128),
                                       ("geqrf", 384, 128)])
def test_static_mode_end_to_end(kind, n, nb):
    """The classic static path engages, its result is bit-identical to
    the port's hash mode and within 5e-4 of the JAX package's static
    mode (the ragged 200/64 tiling included)."""
    M = _matrix(kind, n)
    out, tp = _port_run(kind, M, nb, "static")
    assert tp._engine is not None and tp._turbo is None
    assert tp.nb_local_tasks == tp._dag.n_tasks
    ref, htp = _port_run(kind, M, nb, "hash")
    assert htp._engine is None
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, _jax_static(kind, M, nb), atol=ATOL)
    if kind == "potrf":
        L = np.tril(out).astype(np.float64)
        np.testing.assert_allclose(L @ L.T, M, atol=ATOL)


def test_static_mode_multirank_raises():
    """Static lowering is single-rank: a two-rank pool raises, at the
    lowering and at startup."""
    M = make_spd(256)
    A = TwoDimBlockCyclic(256, 256, 128, 128, P=2,
                          dtype=np.float32).from_numpy(M)
    tp = dpotrf_taskpool(A, rank=0, nb_ranks=2)
    with pytest.raises(ValueError, match="single-rank"):
        lower(tp, use_cache=False)
    with params.cmdline_override("ptg_dep_management", "static"):
        with pytest.raises(NotImplementedError):
            tp.startup_hook(None, tp)


@pytest.mark.parametrize("knob,value", [("ptg_dep_management", "index"),
                                        ("ptg_dispatch", "fast")])
def test_unknown_mode_raises(knob, value):
    tp, _ = _port_pool("potrf", make_spd(128), 64)
    with params.cmdline_override("ptg_dep_management", "static"), \
            params.cmdline_override(knob, value):
        with pytest.raises(ValueError, match=knob):
            tp.startup_hook(None, tp)


def test_lowering_cache_shared_and_evicted():
    """Two pools of one signature share one lowering; a dead JDF's
    entries are purged."""
    import gc
    import importlib
    from parsec_tpu_torch.dsl import ptg
    lower_mod = importlib.import_module("parsec_tpu_torch.dsl.ptg.lower")
    M = make_spd(256)
    a, _ = _port_pool("potrf", M, 128)
    b, _ = _port_pool("potrf", M, 128)
    assert lower(a) is lower(b)
    fac = ptg.compile_jdf("""
descA [ type="collection" ]
NT [ type="int" ]

T(k)

k = 0 .. NT-1

: descA( k, 0 )

RW   A <- descA( k, 0 )
     -> descA( k, 0 )

BODY
{
    A = A * 2.0
}
END
""", name="evict")
    descA = TwoDimBlockCyclic(8, 4, 4, 4).from_numpy(
        np.ones((8, 4), np.float32))
    tp2 = fac.new(NT=2, descA=descA)
    lower(tp2)
    jid = id(fac.jdf)
    assert any(k[0] == jid for k in lower_mod._cache)
    del tp2, fac
    gc.collect()
    assert not any(k[0] == jid for k in lower_mod._cache)


@pytest.mark.gpu
def test_static_mode_on_card():
    """Classic static dpotrf on cuda:0, nb = 128: every task on the card,
    the GEMM kernel launched, bit-identical to the hash mode there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GEMM kernel has no CPU mode")
    from parsec_tpu_torch.ops import kernels
    M = make_spd(512)

    def run(mode):
        with params.cmdline_override("ptg_dep_management", mode), \
                params.cmdline_override("ptg_dispatch", "classic"):
            ctx = parsec_tpu_torch.init(nb_cores=2)
            try:
                tp, A = _port_pool("potrf", M, 128)
                ctx.add_taskpool(tp)
                ctx.wait()
                dev = ctx.device_by_type("cuda")
                assert dev.name == "cuda:0"
                assert dev.stats["tasks"] == tp.nb_local_tasks == 20
                return np.tril(A.to_numpy()), tp
            finally:
                ctx.fini()

    kernels.matmul_launches = 0
    L, tp = run("static")
    assert tp._engine is not None and kernels.matmul_launches > 0
    np.testing.assert_array_equal(L, run("hash")[0])
    np.testing.assert_allclose(L.astype(np.float64) @ L.T, M, atol=ATOL)
