"""The port's backend-neutral leftovers: ``core/mempool.py`` (mirrors the
JAX package's ``tests/test_mempool.py``), ``core/sync.py`` (the native
RWLock/ValueArray against the plain versions and the JAX package's),
``utils/debug_history.py`` (the ring, its refcounted enable, the
context's ``debug_history_size`` wiring) and ``dsl/ptg/unparse.py``
(the same JDF text parsed and unparsed by both packages gives the same
string)."""
import gc
import threading
import time
import weakref

import numpy as np
import pytest

import parsec_tpu_torch as ptt
from parsec_tpu_torch.core.mempool import Mempool
from parsec_tpu_torch.core.sync import (PyRWLock, PyValueArray, RWLock,
                                        ValueArray)
from parsec_tpu_torch.utils import debug_history
from parsec_tpu_torch.utils.params import params


# --------------------------------------------------------------------- #
# mempool                                                               #
# --------------------------------------------------------------------- #
def test_allocate_recycles():
    made = []

    def ctor():
        b = np.empty((64,), np.float32)
        made.append(b)
        return b

    pool = Mempool(ctor)
    a = pool.allocate()
    pool.free(a)
    b = pool.allocate()
    assert b is a
    assert pool.nb_constructed() == 1
    pool.free(b)
    assert pool.nb_cached() == 1


def test_cross_thread_free_returns_to_owner():
    pool = Mempool(lambda: np.empty((8,), np.float32))
    elt = pool.allocate()
    owner = pool.thread_mempool()
    t = threading.Thread(target=lambda: pool.free(elt))
    t.start()
    t.join()
    assert len(owner) == 1          # landed in the OWNER's list
    assert pool.allocate() is elt


def test_max_cached_bounds_retention():
    pool = Mempool(lambda: object(), max_cached=2)
    elts = [pool.allocate() for _ in range(4)]
    for e in elts:
        pool.free(e)
    assert pool.nb_cached() == 2


def test_foreign_element_free_is_noop():
    pool = Mempool(lambda: object())
    pool.free(object())
    assert pool.nb_cached() == 0


def test_per_thread_freelists_are_private():
    pool = Mempool(lambda: object())
    got = {}
    barrier = threading.Barrier(3)

    def worker(name):
        barrier.wait()
        e = pool.allocate()
        pool.free(e)
        got[name] = pool.thread_mempool()
        barrier.wait()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(set(id(tm) for tm in got.values())) == 3
    assert pool.nb_cached() == 3


def test_dropped_numpy_element_purges_id_tracking():
    pool = Mempool(lambda: np.empty((8,), np.float32))
    pool.allocate()
    gc.collect()
    assert len(pool.owner_of) == 0


def test_attr_capable_elements_carry_owner_intrusively():
    class Elt:
        pass

    pool = Mempool(Elt)
    e = pool.allocate()
    assert len(pool.owner_of) == 0
    pool.free(e)
    assert pool.allocate() is e


def test_overflow_dropped_element_is_disowned():
    class Elt:
        pass

    pool = Mempool(Elt, max_cached=1)
    e1, e2 = pool.allocate(), pool.allocate()
    pool.free(e1)
    pool.free(e2)
    pool.free(e2)                   # stray double-free of the dropped one
    assert pool.nb_cached() == 1
    assert pool.allocate() is e1


def test_finalizer_does_not_retain_pool():
    pool = Mempool(lambda: np.empty((8,), np.float32))
    escaped = pool.allocate()
    ref = weakref.ref(pool)
    del pool
    gc.collect()
    assert ref() is None
    del escaped


def test_named_pool_gauges_on_the_process_registry():
    """A named pool exports its accounting under PARSEC::MEMPOOL::<NAME>
    on the port's process-wide SDE registry, as the JAX package's; the
    gauges go with the pool."""
    from parsec_tpu_torch.profiling.sde import sde
    pool = Mempool(lambda: np.empty((8,), np.float32), name="scratch")
    a = pool.allocate()
    pool.allocate()
    pool.free(a)
    snap = sde.snapshot()
    pre = "PARSEC::MEMPOOL::SCRATCH"
    assert snap[f"{pre}::ALLOCS"] == 2 and snap[f"{pre}::HITS"] == 0
    assert snap[f"{pre}::OUTSTANDING"] == 1
    assert snap[f"{pre}::OUTSTANDING_HWM"] == 2
    assert snap[f"{pre}::CACHED"] == 1
    assert snap[f"{pre}::CONSTRUCTED"] == 2
    fired = []
    pool.on_free = lambda: fired.append(1)
    pool.free(pool.allocate())
    assert fired == [1]
    pool.unregister_gauges()
    assert f"{pre}::ALLOCS" not in sde.snapshot()


# --------------------------------------------------------------------- #
# core/sync                                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["native", "plain", "jax"])
def test_rwlock_excludes_writers_and_counts_readers(impl):
    if impl == "jax":
        from parsec_tpu.core.sync import RWLock as JaxRWLock
        cls = JaxRWLock
    else:
        cls = RWLock if impl == "native" else PyRWLock
    lock = cls()
    lock.read_lock()
    lock.read_lock()
    assert lock.nreaders() == 2
    got = []

    def writer():
        lock.write_lock()
        got.append(lock.nreaders())
        lock.write_unlock()

    t = threading.Thread(target=writer)
    t.start()
    time.sleep(0.05)
    assert got == []                # readers hold it out
    lock.read_unlock()
    lock.read_unlock()
    t.join(timeout=10)
    assert got == [0]
    # writers are exclusive: a counter stays exact under contention
    box = [0]

    def bump():
        for _ in range(200):
            lock.write_lock()
            v = box[0]
            box[0] = v + 1
            lock.write_unlock()

    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert box[0] == 800


@pytest.mark.parametrize("impl", ["native", "plain"])
def test_value_array_matches_jax_package(impl):
    from parsec_tpu.core.sync import PyValueArray as JaxValueArray
    cls = ValueArray if impl == "native" else PyValueArray
    assert RWLock is not PyRWLock and ValueArray is not PyValueArray
    ours, theirs = cls(4), JaxValueArray(4)
    for va in (ours, theirs):
        va.set_size(3)
        va.set(1, b"abcd")
        assert va.push_back(b"wxyz") == 3
        va.set_size(5)                  # zero-filled growth
    assert len(ours) == len(theirs) == 5
    assert [ours.get(i) for i in range(5)] == \
        [theirs.get(i) for i in range(5)]
    assert ours.get(4) == b"\0" * 4 and ours.item_size() == 4
    with pytest.raises(IndexError):
        ours.get(5)
    with pytest.raises(ValueError):
        ours.set(0, b"toolong")
    with pytest.raises(ValueError):
        cls(0)


# --------------------------------------------------------------------- #
# debug history                                                         #
# --------------------------------------------------------------------- #
def test_debug_history_ring_bounded_and_dumped():
    h = debug_history.DebugHistory(capacity=3)
    for i in range(5):
        h.mark("EV", i, th=1)
    assert [e[3] for e in h.entries()] == [2, 3, 4]   # oldest dropped
    text = h.dump(limit=2)
    assert "2 entries" in text and text.rstrip().endswith("EV 4")
    off = debug_history.DebugHistory(capacity=0)
    off.mark("EV")
    assert len(off) == 0


def test_debug_history_refcounted_enable():
    assert not debug_history.enabled()
    debug_history.enable(16)
    debug_history.enable(8)
    assert debug_history.history.capacity == 16
    debug_history.disable()
    assert debug_history.enabled()      # one enable still live
    debug_history.disable()
    assert not debug_history.enabled()


def test_context_records_transitions_and_dumps_on_error(caplog):
    """debug_history_size wires the ring and its PINS feed; a task error
    is marked and the ring dumped; fini unhooks it."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import INOUT, unpack_args
    params.set_cmdline("debug_history_size", "64")
    try:
        ctx = ptt.Context(nb_cores=1, device="cpu")
        try:
            assert debug_history.enabled()
            tp = dtd.taskpool_new()
            ctx.add_taskpool(tp)
            tile = tp.tile_of_array(np.zeros((2, 2), np.float32))

            def ok(es, task):
                (x,) = unpack_args(task)
                x += 1

            def bad(es, task):
                raise ValueError("boom")

            tp.insert_task(ok, (tile, INOUT))
            tp.insert_task(bad, (tile, INOUT))
            tp.data_flush_all()
            with pytest.raises(RuntimeError):
                tp.wait()
            whats = [e[2] for e in debug_history.history.entries()]
            assert "EXEC_BEGIN" in whats and "COMPLETE_EXEC_END" in whats
            assert whats[-1] == "TASK_ERROR"
            ctx.clear_task_errors()
        finally:
            ctx.fini()
        assert not debug_history.enabled()
    finally:
        params.reset()


# --------------------------------------------------------------------- #
# unparse                                                               #
# --------------------------------------------------------------------- #
def _jdf_texts():
    import importlib
    from parsec_tpu_torch.collections import ops as cops

    def mod(name):   # ops/__init__ shadows the modules with functions
        return importlib.import_module(f"parsec_tpu_torch.ops.{name}")

    return {
        "dpotrf": mod("dpotrf").DPOTRF_L_JDF,
        "dtrsm_fwd": mod("dtrsm").FWD_JDF, "dtrsm_bwd": mod("dtrsm").BWD_JDF,
        "dgetrf": mod("dgetrf").DGETRF_JDF, "dgeqrf": mod("dgeqrf").DGEQRF_JDF,
        "pdgemm": mod("pdgemm").PDGEMM_JDF,
        "apply": cops._APPLY_JDF, "map": cops._MAP_JDF,
        "reduce_col": cops._REDUCE_COL_JDF.format(dt="float32"),
        "reduce_row": cops._REDUCE_ROW_JDF.format(dt="float32"),
        "reduce_all": cops._REDUCE_ALL_JDF.format(dt="float32"),
        "broadcast": cops._BCAST_JDF, "band": cops._BAND_JDF,
    }


@pytest.mark.parametrize("name", sorted(_jdf_texts()))
def test_unparse_equal_to_jax_and_roundtrips(name):
    from parsec_tpu.dsl.ptg.parser import parse_jdf as jax_parse
    from parsec_tpu.dsl.ptg.unparse import unparse as jax_unparse
    from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
    from parsec_tpu_torch.dsl.ptg.unparse import unparse
    text = _jdf_texts()[name]
    ours = unparse(parse_jdf(text, name=name))
    assert ours == jax_unparse(jax_parse(text, name=name))
    # the canonical text re-parses to the same structure (guards gain a
    # pair of parentheses each round, in both packages alike)
    again = parse_jdf(ours, name=name)
    first = parse_jdf(text, name=name)
    assert [(tc.name, tc.params, [(f.access, f.name, len(f.deps))
                                  for f in tc.flows])
            for tc in again.task_classes] == \
        [(tc.name, tc.params, [(f.access, f.name, len(f.deps))
                               for f in tc.flows])
         for tc in first.task_classes]
    assert unparse(again) == jax_unparse(jax_parse(ours, name=name))
