"""Observability: DOT grapher, SDE counters, PINS checker modules,
Chrome-trace export, and the ptg_to_dtd replay.

Reference analogs: parsec_prof_grapher.c (DOT capture), papi_sde.c
(software counters), pins/iterators_checker, pins/papi, pins/ptg_to_dtd,
profiling.c + tools/profiling (trace export / pandas tables),
tests/profiling/check-async.py.

The port's counterpart of the JAX package's ``tests/test_observability.py``, run on
the port with ``device="cpu"``.
"""
import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.collections import ops as cops
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.profiling import (IteratorsCheckerModule, TaskTimeModule,
                                  TASKS_RETIRED, grapher, sde)
from parsec_tpu_torch.profiling.trace import Profile
from parsec_tpu_torch.profiling.pins import TaskProfilerModule

TILE = 4


@pytest.fixture
def ctx():
    c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    yield c
    c.fini()

CHAIN_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

STEP(k)
k = 0 .. NT-1
: descA( 0, 0 )
RW A <- (k == 0) ? descA( 0, 0 ) : A STEP( k-1 )
     -> (k < NT-1) ? A STEP( k+1 )
     -> (k == NT-1) ? descA( 0, 0 )
BODY
{
    A = A + 1.0
}
END
"""


def _chain_tp(nt=4):
    A = TwoDimBlockCyclic(TILE, TILE, TILE, TILE).from_numpy(
        np.zeros((TILE, TILE), np.float32))
    tp = ptg.compile_jdf(CHAIN_JDF, name="chain").new(descA=A, NT=nt)
    return tp, A


def test_grapher_captures_nodes_and_edges(ctx):
    grapher.enable()
    try:
        tp, A = _chain_tp(5)
        ctx.add_taskpool(tp)
        ctx.wait()
        assert grapher.nb_nodes() == 5
        assert grapher.nb_edges() == 4
        dot = grapher.to_dot()
        assert "digraph" in dot and "STEP_0_" in dot
        assert dot.count("->") == 4
    finally:
        grapher.disable()


def test_grapher_dtd_edges(ctx):
    from parsec_tpu_torch.dsl import dtd
    from parsec_tpu_torch.dsl.dtd import INOUT, unpack_args
    grapher.enable()
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(np.zeros((2, 2), np.float32))

        def bump(es, task):
            (t,) = unpack_args(task)
            t += 1

        for _ in range(3):
            tp.insert_task(bump, (tile, INOUT), name="bump")
        tp.data_flush_all()
        tp.wait()
        assert grapher.nb_nodes() >= 3
        assert grapher.nb_edges() >= 2  # the INOUT chain
    finally:
        grapher.disable()


def test_sde_counters(ctx):
    """Counters are per-context: each in-process rank counts only its own
    tasks (the reference's registry is per-process == per-rank)."""
    before = ctx.sde.read(TASKS_RETIRED)
    tp, A = _chain_tp(6)
    ctx.add_taskpool(tp)
    ctx.wait()
    assert ctx.sde.read(TASKS_RETIRED) >= before + 6
    snap = ctx.sde.snapshot()
    assert TASKS_RETIRED in snap
    # the scheduler gauge answers (possibly -1 when unsupported)
    assert "PARSEC::SCHEDULER::PENDING_TASKS" in snap


def test_sde_counters_isolated_between_contexts():
    """A second context's work must not inflate the first's counters."""
    import parsec_tpu_torch
    c1 = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
    c2 = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
    try:
        tp, _ = _chain_tp(4)
        c2.add_taskpool(tp)
        c2.wait()
        assert c1.sde.read(TASKS_RETIRED) == 0
        assert c2.sde.read(TASKS_RETIRED) >= 4
    finally:
        c1.fini()
        c2.fini()


def test_iterators_checker_clean_dag(ctx):
    from parsec_tpu_torch.ops import dpotrf, make_spd
    mod = IteratorsCheckerModule()
    mod.enable()
    try:
        n = 4 * TILE
        M = make_spd(n)
        A = TwoDimBlockCyclic(n, n, TILE, TILE).from_numpy(M)
        dpotrf(ctx, A)
        assert mod.checked > 0
        assert mod.errors == [], mod.errors[:3]
    finally:
        mod.disable()


def test_task_time_module(ctx):
    mod = TaskTimeModule()
    mod.enable()
    try:
        tp, A = _chain_tp(4)
        ctx.add_taskpool(tp)
        ctx.wait()
        assert mod.count.get("STEP", 0) == 4
        assert mod.wall_ns.get("STEP", 0) > 0
    finally:
        mod.disable()


def test_chrome_trace_and_dataframe(ctx, tmp_path):
    prof = Profile(rank=0)
    mod = TaskProfilerModule(prof)
    mod.enable()
    try:
        tp, A = _chain_tp(3)
        ctx.add_taskpool(tp)
        ctx.wait()
    finally:
        mod.disable()
    doc = prof.to_chrome_trace()
    names = {e["name"] for e in doc["traceEvents"]}
    assert "exec:STEP" in names
    out = prof.dump(str(tmp_path / "t.json"))
    assert out.endswith(".json")
    df = prof.to_dataframe()
    assert (df["name"] == "exec:STEP").sum() == 3
    assert (df["duration_ns"] > 0).all()


def test_ptg_to_dtd_replay_dpotrf(ctx):
    """Cross-DSL consistency on a non-trivial DAG: dpotrf via DTD."""
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd
    from parsec_tpu_torch.ops import make_spd
    from parsec_tpu_torch.ops.dpotrf import dpotrf_taskpool

    n = 3 * TILE
    M = make_spd(n)
    A = TwoDimBlockCyclic(n, n, TILE, TILE).from_numpy(M)
    ptg_to_dtd(dpotrf_taskpool(A), ctx)
    L = np.tril(A.to_numpy())
    np.testing.assert_allclose(L @ L.T, M, atol=5e-4)


# --------------------------------------------------------------------- #
# debug history ring (ref: PARSEC_DEBUG_HISTORY, debug_marks.c, §5.2)   #
# --------------------------------------------------------------------- #
def test_debug_history_ring_wraps():
    from parsec_tpu_torch.utils import debug_history as dh
    ring = dh.DebugHistory(capacity=4)
    for i in range(7):
        ring.mark("M", i)
    ents = ring.entries()
    assert len(ents) == 4
    assert [e[3] for e in ents] == [3, 4, 5, 6]  # oldest dropped, order kept
    assert "newest last" in ring.dump()
    assert len(ring) == 4


def test_debug_history_records_transitions(ctx):
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.utils import debug_history as dh
    dh.enable(256)
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        for _ in range(3):
            tp.insert_task(lambda es, task: None)
        tp.wait()
        names = {e[2] for e in dh.history.entries()}
        assert "EXEC_BEGIN" in names and "COMPLETE_EXEC_END" in names
    finally:
        dh.disable()
    assert not dh.enabled()


def test_debug_history_dumped_on_task_error(capsys):
    import parsec_tpu_torch
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.utils import debug_history as dh
    parsec_tpu_torch.params.reset()
    parsec_tpu_torch.params.set_cmdline("debug_history_size", "128")
    try:
        c = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
        try:
            tp = dtd.taskpool_new()
            c.add_taskpool(tp)

            def boom(es, task):
                raise ValueError("intentional")

            tp.insert_task(boom)
            with pytest.raises(RuntimeError):
                tp.wait()
        finally:
            c.fini()
        err = capsys.readouterr().err
        assert "debug history" in err and "TASK_ERROR" in err
    finally:
        dh.disable()
        parsec_tpu_torch.params.reset()


def test_debug_history_unhooked_at_fini():
    """A fini'd context must not leave the global PINS feed enabled."""
    import parsec_tpu_torch
    from parsec_tpu_torch.utils import debug_history as dh
    from parsec_tpu_torch.profiling.pins import pins_is_active
    parsec_tpu_torch.params.reset()
    parsec_tpu_torch.params.set_cmdline("debug_history_size", "64")
    c = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
    parsec_tpu_torch.params.reset()
    assert dh.enabled()
    c.fini()
    assert not dh.enabled()
    assert not pins_is_active()


def test_es_rusage_report(ctx):
    """Per-ES rusage deltas (ref: getrusage reports, scheduling.c:45-90)."""
    from parsec_tpu_torch.runtime.scheduling import es_rusage_report
    es = ctx.execution_streams[0]
    first = es_rusage_report(es)  # absolute thread counters at baseline
    assert {"utime_s", "stime_s", "vcsw", "ivcsw", "maxrss_kb"} <= set(first)
    tp, _ = _chain_tp(4)
    ctx.add_taskpool(tp)
    ctx.wait()
    delta = es_rusage_report(es)
    # deltas must be non-negative and bounded by the wall time of the
    # chain run — absolute counters leaking through would exceed this
    # (the baseline call above already accrued test-session utime)
    assert 0.0 <= delta["utime_s"] <= 5.0
    assert delta["vcsw"] >= 0 and delta["ivcsw"] >= 0
    sum(i * i for i in range(2_000_000))  # measurable cpu burn
    delta2 = es_rusage_report(es)
    # the burn happened on THIS thread: its delta sees it, stays small,
    # and a wrong-direction subtraction would go negative
    assert 0.0 <= delta2["utime_s"] <= 5.0


def test_hw_counters_module_graceful():
    """perf_event_open PINS module (pins/papi analog): counts real
    hardware events when the kernel allows, silently no-ops when the
    sandbox refuses PMU access."""
    import numpy as np
    import parsec_tpu_torch
    from parsec_tpu_torch.profiling.pins import HWCountersModule, pins_is_active

    mod = HWCountersModule()
    ctx = parsec_tpu_torch.init(device="cpu", nb_cores=1)
    try:
        mod.enable()
        if not mod.available:
            assert not pins_is_active()   # refused: must be a no-op
            return
        from parsec_tpu_torch import dtd
        from parsec_tpu_torch.dsl.dtd import INOUT, unpack_args
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(np.ones((64, 64), np.float32))

        def square(es, task):
            (x,) = unpack_args(task)
            x @ x  # measurable instruction count

        for _ in range(4):
            tp.insert_task(square, (tile, INOUT))
        tp.data_flush_all()
        tp.wait()
        s = mod.summary()
        assert s and all(v["instructions"] > 0 for v in s.values())
    finally:
        mod.disable()
        ctx.fini()


def test_perfctr_wrapper_units():
    """The raw wrapper degrades with OSError (never crashes) and its
    attr layout parses."""
    import pytest
    from parsec_tpu_torch.profiling import perfctr

    assert set(perfctr.PERF_EVENTS) >= {"instructions", "cycles"}
    if not perfctr.perf_available():
        with pytest.raises(OSError):
            perfctr.PerfCounterSet.open(["instructions"])
    else:
        s = perfctr.PerfCounterSet.open(["instructions"])
        a = s.read()
        sum(i * i for i in range(50000))
        b = s.read()
        assert b[0] > a[0]
        s.close()
