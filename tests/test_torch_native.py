"""The port's native C++ core (parsec_tpu_torch/native) against its
pure-Python plain versions, and beside the JAX package's own extension.

The container battery of tests/test_native_core.py, each case run on the
native class and on the Python class it replaces, so both stay
behaviourally identical; then the build contract: the port's library is
compiled into build/native/ under its own module name, loads beside the
JAX package's extension in one process, and a failed build raises.
"""
import os
import threading
import time

import numpy as np
import pytest

import parsec_tpu.native as jnative
import parsec_tpu_torch.native as tnative
from parsec_tpu_torch.core import hashtable as ht_mod
from parsec_tpu_torch.core import hbbuffer as hb_mod
from parsec_tpu_torch.core import lists as lists_mod
from parsec_tpu_torch.data import arena as arena_mod
from parsec_tpu_torch.native import build as tbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cls", [lists_mod.Lifo, lists_mod.PyLifo])
def test_lifo_mt(cls):
    q = cls()
    N, T = 2000, 4
    results = []

    def producer(base):
        for i in range(N):
            q.push(base + i)

    def consumer():
        got = []
        while len(got) < N:
            v = q.pop()
            if v is not None:
                got.append(v)
        results.append(got)

    ps = [threading.Thread(target=producer, args=(t * N,)) for t in range(T)]
    cs = [threading.Thread(target=consumer) for _ in range(T)]
    for t in ps + cs:
        t.start()
    for t in ps + cs:
        t.join()
    allv = sorted(x for got in results for x in got)
    assert allv == list(range(N * T))
    assert q.pop() is None and q.is_empty()


@pytest.mark.parametrize("cls", [lists_mod.Dequeue, lists_mod.PyDequeue])
def test_dequeue_chains_and_steal(cls):
    d = cls()
    d.push_back_chain(range(5))
    d.push_front_chain([-2, -1])
    assert len(d) == 7
    assert d.pop_front() == -2 and d.pop_back() == 4
    seen = []
    lock = threading.Lock()

    def steal():
        while True:
            v = d.pop_back()
            if v is None:
                return
            with lock:
                seen.append(v)

    ts = [threading.Thread(target=steal) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(seen) == [-1, 0, 1, 2, 3]


@pytest.mark.parametrize("cls", [lists_mod.Fifo, lists_mod.PyFifo])
def test_fifo_order(cls):
    q = cls()
    for i in range(5):
        q.push(i)
    assert [q.pop() for _ in range(5)] == list(range(5))
    assert q.pop() is None and q.is_empty()


@pytest.mark.parametrize("cls", [lists_mod.OrderedList,
                                 lists_mod.PyOrderedList])
def test_ordered_list_priority_and_fifo_tiebreak(cls):
    ol = cls()
    ol.push_sorted("low", 1)
    ol.push_sorted("hi-first", 9)
    ol.push_sorted("hi-second", 9)
    ol.push_sorted_chain(["mid"], lambda t: 5)
    assert ol.pop_front() == "hi-first"      # highest priority, oldest first
    assert ol.pop_back() == "low"            # inverse-priority pop (ip sched)
    assert ol.pop_front() == "hi-second"
    assert ol.pop_front() == "mid"
    assert ol.pop_front() is None and ol.is_empty()


@pytest.mark.parametrize("cls", [ht_mod.HashTable64, ht_mod.PyHashTable64])
def test_hashtable64_mt_resize(cls):
    h = cls()
    T, N = 8, 1500

    def worker(tid):
        for i in range(N):
            k = tid * N + i
            h.insert(k, ("v", k))
        for i in range(N):
            k = tid * N + i
            assert h.find(k) == ("v", k)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(h) == T * N
    assert h.find(0) == ("v", 0)
    assert h.remove(0) == ("v", 0)
    assert h.find(0) is None and h.remove(0) is None
    assert len(h) == T * N - 1


@pytest.mark.parametrize("cls", [ht_mod.HashTable64, ht_mod.PyHashTable64])
def test_hashtable64_find_or_insert_once(cls):
    h = cls()
    calls = []

    def factory():
        calls.append(1)
        return "made"

    v1, ins1 = h.find_or_insert(7, factory)
    v2, ins2 = h.find_or_insert(7, factory)
    assert (v1, ins1) == ("made", True)
    assert (v2, ins2) == ("made", False)
    assert len(calls) == 1


@pytest.mark.parametrize("cls", [arena_mod.ZoneMalloc,
                                 arena_mod.PyZoneMalloc])
def test_zone_malloc_coalescing(cls):
    z = cls(1 << 20, 512)
    offs = [z.malloc(1000) for _ in range(100)]
    assert all(o >= 0 for o in offs)
    assert len(set(offs)) == 100
    assert z.used() == 100 * 1024  # rounded to alignment
    for o in offs[::2]:
        z.free(o)
    assert z.used() == 50 * 1024
    assert z.malloc(1 << 20) == -1  # fragmented: no contiguous MB
    for o in offs[1::2]:
        z.free(o)
    assert z.used() == 0
    assert z.largest_free() == 1 << 20
    assert z.malloc(1 << 20) == 0


@pytest.mark.parametrize("cls", [arena_mod.ZoneMalloc,
                                 arena_mod.PyZoneMalloc])
def test_zone_malloc_errors(cls):
    z = cls(4096, 256)
    with pytest.raises(Exception):
        z.free(128)  # never allocated
    o = z.malloc(100)
    z.free(o)
    with pytest.raises(Exception):
        z.free(o)  # double free


class _Prio:
    __slots__ = ("priority", "tag")

    def __init__(self, p, tag=0):
        self.priority = p
        self.tag = tag


@pytest.mark.parametrize("cls", [hb_mod.HBBuffer, hb_mod.PyHBBuffer])
def test_hbbuffer_parity_spill_and_order(cls):
    spilled = []
    hb = cls(4, lambda items, d: spilled.extend(items))
    hb.push_all([_Prio(p) for p in (3, 9, 1, 7, 5, 8, 2)])
    assert len(hb) == 4
    assert sorted(t.priority for t in spilled) == [1, 2, 3]
    assert [hb.pop_best().priority for _ in range(4)] == [9, 8, 7, 5]
    assert hb.pop_best() is None
    assert hb.is_empty()


@pytest.mark.parametrize("cls", [hb_mod.HBBuffer, hb_mod.PyHBBuffer])
def test_hbbuffer_fifo_within_priority(cls):
    hb = cls(8, lambda items, d: None)
    hb.push_all([_Prio(5, tag=i) for i in range(6)])
    assert [hb.pop_best().tag for _ in range(6)] == list(range(6))


@pytest.mark.parametrize("cls", [hb_mod.HBBuffer, hb_mod.PyHBBuffer])
def test_hbbuffer_mt_stress(cls):
    """Concurrent pushers + poppers: no loss, no duplication."""
    spilled = []
    slock = threading.Lock()

    def spill(items, d):
        with slock:
            spilled.extend(items)

    hb = cls(32, spill)
    N, NT = 500, 4
    popped = [[] for _ in range(NT)]

    def pusher(base):
        hb.push_all([_Prio(p % 17, tag=base + p) for p in range(N)])

    def popper(out):
        deadline = time.time() + 10
        while time.time() < deadline:
            t = hb.pop_best()
            if t is None:
                if all(not th.is_alive() for th in pushers) and hb.is_empty():
                    return
                continue
            out.append(t)

    pushers = [threading.Thread(target=pusher, args=(i * N,))
               for i in range(NT)]
    poppers = [threading.Thread(target=popper, args=(popped[i],))
               for i in range(NT)]
    for t in pushers + poppers:
        t.start()
    for t in pushers + poppers:
        t.join(30)
        assert not t.is_alive()
    tags = sorted([t.tag for t in spilled] +
                  [t.tag for out in popped for t in out])
    assert tags == list(range(NT * N))


@pytest.mark.parametrize("cls", [hb_mod.MaxHeap, hb_mod.PyMaxHeap])
def test_maxheap_parity(cls):
    h = cls()
    for i, p in enumerate((4, 9, 2, 9, 1)):
        h.insert(_Prio(p, tag=i), priority=p)
    assert h.pop_max().priority == 9
    assert h.pop_max().priority == 9
    stolen = h.split()
    assert len(stolen) + len(h) == 3
    remaining = []
    for heap in (h, stolen):
        while True:
            t = heap.pop_max()
            if t is None:
                break
            remaining.append(t.priority)
    assert sorted(remaining) == [1, 2, 4]


# --------------------------------------------------------------------- #
# the build contract                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["Lifo", "Fifo", "Dequeue", "OrderedList",
                                  "HashTable64", "ZoneMalloc", "HBBuffer",
                                  "MaxHeap", "NativeDAG", "RWLock",
                                  "ValueArray"])
def test_native_classes_are_the_ports_own(name):
    """Every class comes from the port's extension, not the JAX one; the
    core modules are rebound to them."""
    cls = getattr(tnative.native, name)
    assert cls.__module__ == "_parsec_torch_native"
    assert cls is not getattr(jnative.native, name)
    rebound = {"Lifo": lists_mod.Lifo, "Fifo": lists_mod.Fifo,
               "Dequeue": lists_mod.Dequeue,
               "OrderedList": lists_mod.OrderedList,
               "HashTable64": ht_mod.HashTable64,
               "ZoneMalloc": arena_mod.ZoneMalloc,
               "HBBuffer": hb_mod.HBBuffer, "MaxHeap": hb_mod.MaxHeap}
    if name in rebound:
        assert rebound[name] is cls


def test_library_lives_under_build_native():
    """The port's library is built from its own source into
    build/native/ (keyed on the source's hash), and is another module
    object than the JAX package's extension."""
    path = os.path.realpath(tnative.native.__file__)
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert path == str(tbuild.library_path())
    assert tbuild.SOURCE == __import__("pathlib").Path(
        ROOT, "parsec_tpu_torch", "native", "_native.cpp")
    assert tnative.native is not jnative.native
    assert tnative.native.__name__ == "_parsec_torch_native"
    assert jnative.native.__name__ == "parsec_tpu.native._parsec_native"
    assert not os.path.dirname(path).startswith(
        os.path.join(ROOT, "parsec_tpu_torch"))
    # both extensions work side by side in one process
    a, b = tnative.native.Lifo(), jnative.native.Lifo()
    a.push(1)
    b.push(2)
    assert (a.pop(), b.pop()) == (1, 2)


def test_broken_build_raises(tmp_path):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to the Python containers."""
    bad = tmp_path / "_native.cpp"
    bad.write_text("#include <Python.h>\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.load(source=bad, out_dir=tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))


def test_rebuild_is_keyed_on_the_source(tmp_path):
    """Another source builds another library; the same source reuses its
    build."""
    src = tmp_path / "_native.cpp"
    src.write_bytes(tbuild.SOURCE.read_bytes())
    first = tbuild.library_path(src, tmp_path)
    src.write_bytes(tbuild.SOURCE.read_bytes() + b"\n// edited\n")
    assert tbuild.library_path(src, tmp_path) != first
    assert tbuild.library_path(tbuild.SOURCE, tmp_path) == \
        tmp_path / tbuild.library_path().name


def test_native_dag_run_loop_matches_python_loop():
    """NativeDAG.run_loop pops the same priority order as its Python
    mirror (TurboRunner._py_run_loop) on a small hand-built DAG."""
    from parsec_tpu_torch.dsl.ptg.turbo import TurboRunner
    # 0 -> 1, 0 -> 2, 1 -> 3, 2 -> 3
    indptr = np.asarray([0, 2, 3, 4, 4], np.int32)
    succ = np.asarray([1, 2, 3, 3], np.int32)
    indeg = np.asarray([0, 1, 1, 2], np.int32)
    prio = np.asarray([0, 1, 5, 0], np.int32)
    eng = TurboRunner._make_aug_engine(indptr, succ, indeg)
    order_c, order_py = [], []
    assert eng.run_loop(order_c.append, prio) == 4
    assert TurboRunner._py_run_loop(None, order_py.append, prio, indptr,
                                    succ, indeg) == 4
    assert order_c == order_py == [0, 2, 1, 3]


def test_native_dag_run_loop_propagates_body_error():
    from parsec_tpu_torch.dsl.ptg.turbo import TurboRunner
    eng = TurboRunner._make_aug_engine(
        np.asarray([0, 1, 1], np.int32), np.asarray([1], np.int32),
        np.asarray([0, 1], np.int32))

    def tramp(t):
        raise KeyError(t)

    with pytest.raises(KeyError):
        eng.run_loop(tramp, np.zeros(2, np.int32))
