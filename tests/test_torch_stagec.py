"""Whole-stage compilation in the port (parsec_tpu_torch.stagec) against
the JAX package's (parsec_tpu.stagec).

The stage PLAN is pure Python in both packages, so it is held exactly:
the class verdicts' ok flags, the partition (member keys of each stage,
local and residue counts, the pre-planned residue groups), fused and
wave-front, at two values of ``stage_compile_max_tasks``, one rank and
each rank of two, and the ``lower_report`` lines.  A verdict that
differs because a port body differs from its JAX body would be listed in
``EXPECTED_DIFFERENCES`` with its class and finding code; the shipped
specs have none.

The NUMBERS are held by tolerance: the port's stage-compiled dpotrf and
dposv against the JAX package's INTERPRETED runs on the same inputs
(f32 5e-4 on L and X; f64 1e-8 per unit of n, since the port's products
are fp32 by design).  The JAX package's own stage-compiled output is
not a bit-exact oracle (XLA fuses the jitted stage); inside the port a
stage is held to the port's interpreted runtime bit for bit
(tests/test_torch_stagec_chain.py).
"""
from contextlib import ExitStack

import jax
import numpy as np
import pytest

import parsec_tpu
from parsec_tpu import ops as jops
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.ops import dtrsm as jdtrsm
from parsec_tpu.stagec import class_verdicts as jclass_verdicts
from parsec_tpu.stagec import lower_report as jlower_report
from parsec_tpu.stagec import plan_stages as jplan_stages
from parsec_tpu.utils.params import params as jparams

import parsec_tpu_torch
from parsec_tpu_torch import ops
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.ops import dtrsm
from parsec_tpu_torch.stagec import class_verdicts, lower_report, plan_stages
from parsec_tpu_torch.utils.params import params

N, NB, NRHS = 128, 32, 32
ATOL = {np.float32: 5e-4}
#: fp64 tiles, per unit of n: the JAX package's own bound against numpy
#: (tests/test_torch_wave_dist.py).  The port's tile products go through
#: the GEMM kernel, fp32 by design (its plain version too), so fp64
#: factors of the two packages differ at fp32 rounding (1.1e-7 at
#: n = 96), never at fp64's 1e-10
F64_ATOL_PER_N = 1e-8

#: (spec, class) -> (the JAX package's finding code, the port's): a
#: verdict that differs because the port's body differs.  Empty: every
#: shipped spec's verdicts agree.
EXPECTED_DIFFERENCES = {}


def _coll(T, shape, tile, nr, rank, name, dtype=np.float32):
    kw = dict(P=nr, Q=1, nodes=nr, rank=rank) if nr > 1 else {}
    c = T(*shape, *tile, dtype=dtype, **kw)
    c.name = name
    return c


def _pools(spec, T, o, tr, nr, rank):
    """The taskpool of ``spec`` in one package (``T`` its collection
    class, ``o`` its ops module, ``tr`` its dtrsm module)."""
    sq = lambda nm: _coll(T, (N, N), (NB, NB), nr, rank, nm)  # noqa: E731
    if spec == "dpotrf":
        return o.dpotrf_taskpool(sq("descA"), rank=rank, nb_ranks=nr)
    if spec in ("dtrsm_fwd", "dtrsm_bwd"):
        B = _coll(T, (N, NRHS), (NB, NRHS), nr, rank, "descB")
        f = tr.dtrsm_lower_taskpool if spec == "dtrsm_fwd" \
            else tr.dtrsm_lower_trans_taskpool
        return f(sq("descL"), B, rank=rank, nb_ranks=nr)
    if spec == "dgetrf_nopiv":
        return o.dgetrf_nopiv_taskpool(sq("descA"), rank=rank, nb_ranks=nr)
    if spec == "dgeqrf":
        return o.dgeqrf_taskpool(sq("descA"), rank=rank, nb_ranks=nr)
    if spec == "pdgemm":
        return o.pdgemm_taskpool(sq("descA"), sq("descB"), sq("descC"),
                                 alpha=1.5, beta=0.5, rank=rank,
                                 nb_ranks=nr)
    raise KeyError(spec)


def _partition(plan):
    return dict(
        stages=[sorted(st.member_keys) for st in plan.stages],
        levels=[(st.level_lo, st.level_hi) for st in plan.stages],
        n_local=plan.n_local, n_residue=plan.n_residue,
        residue_groups=plan.residue_groups,
        residue_groups_host=plan.residue_groups_host)


SPECS = ("dpotrf", "dtrsm_fwd", "dtrsm_bwd", "dgetrf_nopiv", "pdgemm",
         "dgeqrf")
RANKS = ((1, 0), (2, 0), (2, 1))


@pytest.mark.parametrize("max_tasks", [1024, 6])
@pytest.mark.parametrize("wavefront", [False, True],
                         ids=["fused", "wavefront"])
@pytest.mark.parametrize("nr,rank", RANKS,
                         ids=[f"{nr}ranks_r{r}" for nr, r in RANKS])
@pytest.mark.parametrize("spec", SPECS)
def test_plan_matches_jax_package(spec, nr, rank, wavefront, max_tasks):
    """The same shapes through both packages' lowerability passes: the
    class verdicts' ok flags and the partition agree exactly."""
    jtp = _pools(spec, JTwoDimBlockCyclic, jops, jdtrsm, nr, rank)
    ptp = _pools(spec, TwoDimBlockCyclic, ops, dtrsm, nr, rank)
    jv, pv = jclass_verdicts(jtp.jdf), class_verdicts(ptp.jdf)
    assert set(jv) == set(pv)
    for name in jv:
        want = EXPECTED_DIFFERENCES.get((spec, name))
        if want is None:
            assert jv[name].ok == pv[name].ok, (name, jv[name], pv[name])
            assert jv[name].code == pv[name].code, (name, jv[name],
                                                    pv[name])
        else:
            assert (jv[name].code, pv[name].code) == want
    jp = jplan_stages(jtp, rank=rank, max_tasks=max_tasks,
                      wavefront=wavefront)
    pp = plan_stages(ptp, rank=rank, max_tasks=max_tasks,
                     wavefront=wavefront)
    assert _partition(pp) == _partition(jp)
    assert pp.stages, "the spec planned no stage: the case tests nothing"


@pytest.mark.parametrize("spec", SPECS)
def test_lower_report_matches_jax_package(spec):
    """``lower_report`` prints the same lines (the spec's name, each
    class's verdict, the count) in both packages."""
    jtp = _pools(spec, JTwoDimBlockCyclic, jops, jdtrsm, 1, 0)
    ptp = _pools(spec, TwoDimBlockCyclic, ops, dtrsm, 1, 0)
    assert lower_report(ptp.jdf) == jlower_report(jtp.jdf)


def test_excluded_class_plans_alike():
    """``stage_compile_exclude`` (STG306) moves the same class to the
    residue in both packages, with the same residue groups."""
    with params.cmdline_override("stage_compile_exclude", "SYRK"), \
            jparams.cmdline_override("stage_compile_exclude", "SYRK"):
        jtp = _pools("dpotrf", JTwoDimBlockCyclic, jops, jdtrsm, 1, 0)
        ptp = _pools("dpotrf", TwoDimBlockCyclic, ops, dtrsm, 1, 0)
        jv, pv = jclass_verdicts(jtp.jdf), class_verdicts(ptp.jdf)
        assert pv["SYRK"].code == jv["SYRK"].code == "STG306"
        jp, pp = plan_stages(ptp), jplan_stages(jtp)
        assert _partition(jp) == _partition(pp)
        assert pp.residue_groups, "no residue group: the case tests nothing"


# --------------------------------------------------------------------- #
# the numbers: the port's stages against the JAX package's interpreted   #
# --------------------------------------------------------------------- #
def _port_dpotrf(M, dtype):
    with params.cmdline_override("stage_compile", "1"):
        ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(*M.shape, NB, NB,
                                  dtype=dtype).from_numpy(M.copy())
            tp = ops.dpotrf_taskpool(A)
            ctx.add_taskpool(tp)
            ctx.wait()
            assert ctx.stage_stats["stage_tasks"] > 0
            return np.tril(A.to_numpy())
        finally:
            ctx.fini()


def _jax_dpotrf(M, dtype):
    ctx = parsec_tpu.init(nb_cores=2)
    try:
        A = JTwoDimBlockCyclic(*M.shape, NB, NB,
                               dtype=dtype).from_numpy(M.copy())
        ctx.add_taskpool(jops.dpotrf_taskpool(A))
        ctx.wait()
        return np.tril(A.to_numpy())
    finally:
        ctx.fini()


@pytest.fixture
def jax_x64():
    """fp64 arrays in the JAX package for the test (its pools follow
    jax's x64 switch)."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


@pytest.mark.parametrize("n", [128, 100])
def test_stage_compiled_dpotrf_vs_jax_interpreted(n):
    """f32, uniform and ragged tilings: the port's stage-compiled factor
    within 5e-4 of the JAX package's interpreted one."""
    M = ops.make_spd(n)
    got = _port_dpotrf(M, np.float32)
    want = _jax_dpotrf(M, np.float32)
    np.testing.assert_allclose(got, want, atol=ATOL[np.float32], rtol=0)


@pytest.mark.parametrize("n", [96, 100])
def test_stage_compiled_dpotrf_f64_vs_jax_interpreted(jax_x64, n):
    """fp64 tiles: within F64_ATOL_PER_N * n of the JAX package's
    interpreted factor (fp32 products in the port)."""
    M = ops.make_spd(n).astype(np.float64)
    got = _port_dpotrf(M, np.float64)
    want = _jax_dpotrf(M, np.float64)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=F64_ATOL_PER_N * n, rtol=0)


def _port_dposv(M, B0):
    with params.cmdline_override("stage_compile", "1"):
        ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
        try:
            A = TwoDimBlockCyclic(*M.shape, NB, NB,
                                  dtype=M.dtype).from_numpy(M.copy())
            B = TwoDimBlockCyclic(*B0.shape, NB, B0.shape[1],
                                  dtype=B0.dtype).from_numpy(B0.copy())
            ops.dposv(ctx, A, B)
            assert ctx.stage_stats["chain_links"] == 2
            return np.tril(A.to_numpy()), B.to_numpy()
        finally:
            ctx.fini()


def _jax_dposv(M, B0):
    with ExitStack() as st:
        st.enter_context(jparams.cmdline_override("stage_compile", "0"))
        ctx = parsec_tpu.init(nb_cores=2)
        try:
            A = JTwoDimBlockCyclic(*M.shape, NB, NB,
                                   dtype=M.dtype).from_numpy(M.copy())
            B = JTwoDimBlockCyclic(*B0.shape, NB, B0.shape[1],
                                   dtype=B0.dtype).from_numpy(B0.copy())
            jops.dposv(ctx, A, B)
            return np.tril(A.to_numpy()), B.to_numpy()
        finally:
            ctx.fini()


def test_chained_dposv_vs_jax_interpreted():
    """The port's dposv, its three pools one chained program, against the
    JAX package's interpreted dposv: L and X within 5e-4."""
    M = ops.make_spd(N)
    B0 = np.random.RandomState(7).rand(N, NRHS).astype(np.float32)
    L, X = _port_dposv(M, B0)
    jL, jX = _jax_dposv(M, B0)
    np.testing.assert_allclose(L, jL, atol=5e-4, rtol=0)
    np.testing.assert_allclose(X, jX, atol=5e-4, rtol=0)


def test_chained_dposv_f64_vs_jax_interpreted(jax_x64):
    """fp64 dposv: L and X within F64_ATOL_PER_N * n of the JAX
    package's interpreted run."""
    M = ops.make_spd(N).astype(np.float64)
    B0 = np.random.RandomState(7).rand(N, NRHS)
    L, X = _port_dposv(M, B0)
    jL, jX = _jax_dposv(M, B0)
    assert X.dtype == jX.dtype == np.float64
    np.testing.assert_allclose(L, jL, atol=F64_ATOL_PER_N * N, rtol=0)
    np.testing.assert_allclose(X, jX, atol=F64_ATOL_PER_N * N, rtol=0)
