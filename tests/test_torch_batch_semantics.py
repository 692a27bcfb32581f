"""Batched device dispatch keeps each body's single-tile semantics.

The device module groups same-class ready tasks into one dispatch, and
the wave engine gathers a wave's members into stacks.  A body written
for one tile must give the answer it gives per task: the JAX package
runs one subgraph per member (``unroll``) or ``vmap``s a single-instance
body.  A body runs ONCE over stacked tiles only when it declares a
leading batch dimension (``BODY [... batch=stacked]``,
``add_chore(..., stacked=True)``).

The probes: 16 independent tasks, each ``A = A - A * A.sum()`` on its
own tile, at ``device_batch_max`` 16, through the interpreted PTG path,
DTD and the wave engine; the port is held against the JAX package and
against numpy in float64, task by task.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

import parsec_tpu
import parsec_tpu.dsl.dtd as jdtd
import parsec_tpu_torch
import parsec_tpu_torch.dsl.dtd as tdtd
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.dsl import ptg as jptg
from parsec_tpu.dsl.ptg.wave import WaveRunner as JWaveRunner
from parsec_tpu.utils.params import params as jparams
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.ptg.wave import wave
from parsec_tpu_torch.utils.params import params

NT = 16
NB = 8
RTOL = 1e-5

PROBE_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

T(k)

k = 0 .. NT-1

: descA( k, 0 )

RW A <- descA( k, 0 )
     -> descA( k, 0 )

BODY [type=%s]
{
    A = A - A * A.sum()
}
END
"""


def _tiles(seed=0):
    return np.random.RandomState(seed).rand(NT * NB, NB).astype(np.float32)


def _want(M):
    """numpy in float64, task by task."""
    out = M.astype(np.float64).copy()
    for k in range(NT):
        t = out[k * NB:(k + 1) * NB]
        out[k * NB:(k + 1) * NB] = t - t * t.sum()
    return out


def _close(got, want):
    err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= RTOL, f"relative error {err:.3g} > {RTOL}"


@contextlib.contextmanager
def _overrides(reg, **over):
    with contextlib.ExitStack() as stack:
        for k, v in over.items():
            stack.enter_context(reg.cmdline_override(k, str(v)))
        yield


@contextlib.contextmanager
def _tctx(batch_max=16):
    """One worker, so the submitting thread accumulates the burst."""
    with _overrides(params, device_batch_max=batch_max):
        c = parsec_tpu_torch.init(nb_cores=1, device="cpu")
        try:
            yield c
        finally:
            c.fini()


@contextlib.contextmanager
def _jctx(batch_max=16):
    with _overrides(jparams, device_batch_max=batch_max):
        c = parsec_tpu.init(nb_cores=1)
        try:
            yield c
        finally:
            c.fini()


def _port_ptg(M, batch_max=16, stacked=False):
    body = "cuda batch=stacked" if stacked else "cuda"
    with _tctx(batch_max) as c:
        A = TwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)
        c.add_taskpool(ptg.compile_jdf(PROBE_JDF % body, name="probe")
                       .new(NT=NT, descA=A))
        c.wait()
        return A.to_numpy(), dict(c.device_by_type("cuda").stats)


def _jax_ptg(M):
    with _jctx() as c:
        A = JTwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)
        c.add_taskpool(jptg.compile_jdf(PROBE_JDF % "tpu", name="probe")
                       .new(NT=NT, descA=A))
        c.wait()
        return A.to_numpy()


def test_ptg_probe_keeps_single_tile_semantics():
    M = _tiles(1)
    got, st = _port_ptg(M)
    assert st["batches"] > 0, "the burst never took the batched path"
    assert st["stack_bytes"] == 0, "an unmarked body ran on a stack"
    _close(got, _want(M))
    _close(got, _jax_ptg(M).astype(np.float64))


def _dtd_probe(dtd, ctx, chore_type, M, stacked=None):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)

    def body(es, task):
        (x,) = dtd.unpack_args(task)
        x -= x * x.sum()

    boot = tp.tile_of_array(np.zeros((NB, NB), np.float32))
    tp.insert_task(body, (boot, dtd.INOUT))
    fn = lambda x: x - x * x.sum()   # noqa: E731
    if stacked is None:
        tp.add_chore(body, chore_type, fn)
    else:
        tp.add_chore(body, chore_type, fn, stacked=stacked)
    tiles = [tp.tile_of_array(M[k * NB:(k + 1) * NB].copy())
             for k in range(NT)]
    for t in tiles:
        tp.insert_task(body, (t, dtd.INOUT))
    for t in tiles:
        tp.data_flush(t)
    tp.wait()
    return np.concatenate([np.asarray(t.data.get_copy(0).payload)
                           for t in tiles])


def test_dtd_probe_keeps_single_tile_semantics():
    M = _tiles(2)
    with _tctx() as c:
        got = _dtd_probe(tdtd, c, "cuda", M)
        st = c.device_by_type("cuda").stats
        assert st["batches"] > 0 and st["stack_bytes"] == 0
    with _jctx() as c:
        ref = _dtd_probe(jdtd, c, "tpu", M)
    _close(got, _want(M))
    _close(got, ref.astype(np.float64))


def test_wave_probe_keeps_single_tile_semantics():
    M = _tiles(3)
    A = TwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)
    w = wave(ptg.compile_jdf(PROBE_JDF % "cuda", name="probe")
             .new(NT=NT, descA=A))
    w.run(device="cpu")
    assert w.stats["tasks"] == NT
    got = A.to_numpy()
    JA = JTwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)
    JWaveRunner(jptg.compile_jdf(PROBE_JDF % "tpu", name="probe")
                .new(NT=NT, descA=JA)).run()
    _close(got, _want(M))
    _close(got, JA.to_numpy().astype(np.float64))


def test_wave_new_scratch_flows():
    """Mirror of the JAX package's test_ptg_wave test: a [4] NEW scratch
    added to a [4, 4] tile broadcasts as it does on one tile."""
    jdf = """
descA [ type="collection" ]
NT [ type="int" ]

T(k)

k = 0 .. NT-1

: descA( k, 0 )

RW   A <- descA( k, 0 )
     -> descA( k, 0 )
READ S <- NEW  [shape=4 dtype=float32]

BODY
{
    A = A + S + 1.0
}
END
"""
    fac = ptg.compile_jdf(jdf, name="newflow")
    descA = TwoDimBlockCyclic(8, 4, 4, 4, dtype=np.float32).from_numpy(
        np.zeros((8, 4), np.float32))
    wave(fac.new(NT=2, descA=descA)).run(device="cpu")
    # scratch arrives zeroed (the runtime's NEW tiles are zeroed too)
    assert np.allclose(descA.to_numpy(), 1.0)


STACKED_JDF = """
descA [ type="collection" ]
NT [ type="int" ]
descB [ type="collection" ]
calls [ type="object" ]
ucalls [ type="object" ]

T(k)

k = 0 .. NT-1

: descA( k, 0 )

RW A <- descA( k, 0 )
     -> descA( k, 0 )

BODY [type=cuda batch=stacked]
{
    calls.append(tuple(A.shape))
    A = A - A * A.sum(dim=(-2, -1), keepdim=True)
}
END

U(k)

k = 0 .. NT-1

: descB( k, 0 )

RW B <- descB( k, 0 )
     -> descB( k, 0 )

BODY [type=cuda]
{
    ucalls.append(tuple(B.shape))
    B = B - B * B.sum()
}
END
"""


@pytest.mark.parametrize("path", ["ptg", "dtd", "wave"])
def test_marked_body_one_stacked_call_per_group(path):
    """A body that declares a leading batch dimension still runs once
    per dispatch group over the stacked tiles, bit-exact against
    per-task execution of the same body; an unmarked class of the same
    pool, batched beside it, sees one tile a call."""
    M = _tiles(4)

    def run(batch_max):
        calls = []
        ucalls = []
        B = TwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)

        def new_pool(A):
            return ptg.compile_jdf(STACKED_JDF, name="stk").new(
                NT=NT, descA=A, descB=B, calls=calls, ucalls=ucalls)

        def check_unmarked():
            assert ucalls and all(s == (NB, NB) for s in ucalls), ucalls
            _close(B.to_numpy(), _want(M))
        if path == "wave":
            A = TwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)
            wave(new_pool(A)).run(device="cpu")
            check_unmarked()
            return A.to_numpy(), calls, None
        with _tctx(batch_max) as c:
            if path == "ptg":
                A = TwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(M)
                c.add_taskpool(new_pool(A))
                c.wait()
                check_unmarked()
                out = A.to_numpy()
            else:
                def fn(x):
                    calls.append(tuple(x.shape))
                    return x - x * x.sum(dim=(-2, -1), keepdim=True)
                tp = tdtd.taskpool_new()
                c.add_taskpool(tp)

                def body(es, task):   # the boot task's host body
                    pass

                boot = tp.tile_of_array(np.zeros((NB, NB), np.float32))
                tp.insert_task(body, (boot, tdtd.INOUT))
                tp.add_chore(body, "cuda", fn, stacked=True)
                chore = tp.task_classes[-1].incarnations[-1]
                assert chore.batch_spec.stacked
                del calls[:]
                tiles = [tp.tile_of_array(M[k * NB:(k + 1) * NB].copy())
                         for k in range(NT)]
                for t in tiles:
                    tp.insert_task(body, (t, tdtd.INOUT))
                tp.data_flush_all()
                tp.wait()
                out = np.concatenate([np.asarray(t.data.get_copy(0).payload)
                                      for t in tiles])
            return out, calls, dict(c.device_by_type("cuda").stats)

    got, calls, st = run(16)
    if path == "wave":
        per_task = _want(M)   # the wave has no per-task mode: numpy
        _close(got, per_task)
        assert calls == [(NT, NB, NB)], calls   # ONE call for the wave
        return
    ref, ref_calls, _ = run(1)
    np.testing.assert_array_equal(got, ref)
    assert all(len(s) == 2 for s in ref_calls)   # per task: one tile
    stacked = [s for s in calls if len(s) == 3]
    assert stacked and all(s[0] >= 2 for s in stacked), calls
    n_stacked = sum(s[0] for s in stacked)
    # + singletons; DTD's boot task may run after the chore was added
    assert n_stacked + (len(calls) - len(stacked)) in (NT, NT + 1)
    # only the marked body's groups were stacked
    assert st["stack_bytes"] == n_stacked * NB * NB * 4


def test_stacked_property_round_trips_and_maps_to_dtd():
    """``batch=stacked`` survives unparse and parse, every DPLASMA JDF
    body declares it, and ptg_to_dtd maps it onto ``stacked=True`` (an
    unmarked body onto a per-task chore)."""
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd
    from parsec_tpu_torch.dsl.ptg.unparse import unparse
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
    for body in ("cuda batch=stacked", "cuda"):
        jdf = parse_jdf(PROBE_JDF % body, name="probe")
        again = parse_jdf(unparse(jdf), name="probe")
        assert again.task_classes[0].bodies[0].stacked == \
            ("stacked" in body)
    A = TwoDimBlockCyclic(64, 64, 16, 16).from_numpy(make_spd(64))
    tp = dpotrf_taskpool(A)
    for tc in tp.task_classes:
        dev = [b for b in tc.ast.bodies if b.device_type == "cuda"]
        assert dev and all(b.stacked for b in dev), tc.name
    with _tctx() as c:
        dtd_tp = ptg_to_dtd(tp, c)
        specs = [ch.batch_spec for tc in dtd_tp.task_classes
                 for ch in tc.incarnations if ch.batch_spec is not None]
        assert specs and all(sp.stacked for sp in specs)
    L = np.tril(A.to_numpy())
    M = make_spd(64)
    assert np.abs(L @ L.T - M).max() < 5e-4
    with _tctx() as c:
        B = TwoDimBlockCyclic(NT * NB, NB, NB, NB).from_numpy(_tiles(5))
        dtd_tp = ptg_to_dtd(ptg.compile_jdf(PROBE_JDF % "cuda",
                                            name="probe").new(NT=NT,
                                                              descA=B), c)
        specs = [ch.batch_spec for tc in dtd_tp.task_classes
                 for ch in tc.incarnations if ch.batch_spec is not None]
        assert specs and not any(sp.stacked for sp in specs)
    _close(B.to_numpy(), _want(_tiles(5)))
