"""The port's core containers (core/: lists, hash table, futures, objects,
heap buffers, rwlock, value array; the native core's classes and their
pure-Python versions) against the JAX package's: the cases of
tests/test_class_containers.py (the reference's tests/class/).  A
deterministic case runs through both packages and the observations must
agree and match the reference's values; a multithreaded stress case
holds the port to the reference's invariants (conservation, no torn
write, shared readers), which no two runs order alike.
"""
import struct
import threading

import pytest

import parsec_tpu.core.future
import parsec_tpu.core.hashtable
import parsec_tpu.core.hbbuffer
import parsec_tpu.core.lists
import parsec_tpu.core.object
import parsec_tpu.core.sync
import parsec_tpu_torch.core.future
import parsec_tpu_torch.core.hashtable
import parsec_tpu_torch.core.hbbuffer
import parsec_tpu_torch.core.lists
import parsec_tpu_torch.core.object
import parsec_tpu_torch.core.sync

JAX = parsec_tpu
PORT = parsec_tpu_torch


def _both(fn):
    """``fn(package)`` through the JAX package and the port: the two
    observations, which must agree; returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want, (got, want)
    return got


def _lifo(m):
    q = m.core.lists.Lifo()
    for i in range(10):
        q.push(i)
    return [q.pop() for _ in range(10)], q.pop()


def test_lifo_order():
    assert _both(_lifo) == (list(range(9, -1, -1)), None)


def _fifo(m):
    q = m.core.lists.Fifo()
    q.push_chain(range(10))
    return [q.pop() for _ in range(10)]


def test_fifo_order():
    assert _both(_fifo) == list(range(10))


def _dequeue(m):
    q = m.core.lists.Dequeue()
    q.push_back(1)
    q.push_front(0)
    q.push_back(2)
    return [q.pop_front(), q.pop_back(), q.pop_front(), q.pop_front()]


def test_dequeue_both_ends():
    assert _both(_dequeue) == [0, 2, 1, None]


def _ordered(m):
    ol = m.core.lists.OrderedList()
    ol.push_sorted("lo", 1)
    ol.push_sorted("hi", 10)
    ol.push_sorted("hi2", 10)
    ol.push_sorted("mid", 5)
    return [ol.pop_front(), ol.pop_front(), ol.pop_back(), ol.pop_front(),
            ol.pop_front()]


def test_ordered_list_priority_and_fifo_tiebreak():
    # FIFO within equal priority; pop_back is the inverse-priority pop
    assert _both(_ordered) == ["hi", "hi2", "lo", "mid", None]


@pytest.mark.parametrize("impl", ["native", "python"])
def test_lifo_mt_stress(impl):
    """Multithreaded push/pop conservation (ref: tests/class/lifo.c) on
    the port's native Lifo and its pure-Python version."""
    lists = PORT.core.lists
    q = lists.Lifo() if impl == "native" else lists.PyLifo()
    N, T = 2000, 4
    popped = [[] for _ in range(T)]

    def worker(t):
        for i in range(N):
            q.push((t, i))
        while True:
            item = q.pop()
            if item is None:
                break
            popped[t].append(item)

    ths = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
        assert not t.is_alive(), "a worker hung"
    leftover = []
    while True:
        it = q.pop()
        if it is None:
            break
        leftover.append(it)
    assert sum(len(p) for p in popped) + len(leftover) == N * T
    allitems = set(leftover)
    for p in popped:
        allitems.update(p)
    assert len(allitems) == N * T  # no duplication, no loss


def _hash(m):
    h = m.core.hashtable.HashTable()
    h.insert("a", 1)
    seen = [h.find("a")]
    seen.append(h.find_or_insert("b", lambda: 2))
    seen.append(h.find_or_insert("b", lambda: 99))
    seen.append(h.remove("a"))
    seen.append(h.find("a"))
    h.update("c", lambda old: (old or 0) + 5)
    h.update("c", lambda old: (old or 0) + 5)
    seen.append(h.find("c"))
    return seen, len(h)


def test_hash_table_basic_and_locked_rmw():
    assert _both(_hash) == ([1, (2, True), (2, False), 1, None, 10], 2)


def test_hash_table_mt_find_or_insert():
    """Every key of a concurrent find_or_insert storm resolves to exactly
    one creator."""
    h = PORT.core.hashtable.HashTable()

    def worker():
        for i in range(500):
            h.find_or_insert(i % 50, lambda: threading.get_ident())

    ths = [threading.Thread(target=worker) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
        assert not t.is_alive(), "a worker hung"
    assert len(h) == 50
    assert all(h.find(i) is not None for i in range(50))


def _future(m):
    f = m.core.future.Future()
    ready0 = f.is_ready()
    seen = []
    f.on_ready(lambda fut: seen.append(fut.peek()))
    f.set(42)
    out = [ready0, f.is_ready(), f.get(), list(seen)]
    f.on_ready(lambda fut: seen.append("late"))
    return out + [seen]


def test_future_basic():
    assert _both(_future) == [False, True, 42, [42], [42, "late"]]


def _countable(m):
    f = m.core.future.CountableFuture(3)
    return [f.contribute(), f.contribute(), f.contribute("done"), f.get()]


def test_countable_future():
    assert _both(_countable) == [False, False, True, "done"]


def _datacopy_once(m):
    calls = []

    def conv(spec):
        calls.append(spec)
        return spec * 2

    f = m.core.future.DataCopyFuture(spec=21, trigger_cb=conv)
    results = []

    def worker():
        results.append(f.get_or_trigger(timeout=5))

    ths = [threading.Thread(target=worker) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
        assert not t.is_alive(), "a worker hung"
    return results, len(calls)


def test_datacopy_future_trigger_once():
    """ref: tests/class/future_datacopy.c — concurrent triggers dedup."""
    assert _both(_datacopy_once) == ([42] * 4, 1)


def _chained(m):
    fut = m.core.future.DataCopyFuture
    inner = fut(spec=5, trigger_cb=lambda s: s + 1)
    outer = fut(spec=None, trigger_cb=lambda s: inner)
    return outer.get_or_trigger(timeout=5)


def test_datacopy_future_chained():
    assert _both(_chained) == 6


def _obj(m):
    destroyed = []

    class MyObj(m.core.object.Obj):
        def _destruct(self):
            destroyed.append(True)
            super()._destruct()

    o = MyObj()
    o.retain()
    first = o.release()
    mid = list(destroyed)
    return first, mid, o.release(), destroyed


def test_obj_refcount_destructor():
    assert _both(_obj) == (False, [], True, [True])


def _hbbuffer(m):
    spilled = []
    hb = m.core.hbbuffer.HBBuffer(2, lambda items, d: spilled.extend(items),
                                  prio_fn=lambda t: t)
    hb.push_all([5, 1, 9, 3])
    return len(hb), sorted(spilled), hb.pop_best(), hb.pop_best()


def test_hbbuffer_spill_keeps_best():
    assert _both(_hbbuffer) == (2, [1, 3], 9, 5)


def _maxheap(m):
    h = m.core.hbbuffer.MaxHeap()
    for i in range(10):
        h.insert(i, priority=i)
    top = h.pop_max()
    stolen = h.split()
    return top, len(stolen), len(h)


def test_maxheap_split():
    top, stolen, left = _both(_maxheap)
    assert top == 9 and stolen + left == 9 and stolen >= 1


# --------------------------------------------------------------------- #
# rwlock and value array (parsec/class/parsec_rwlock.c, value_array.h) #
# --------------------------------------------------------------------- #
IMPLS = ["native", "python"]


def _rwlock(impl):
    sync = PORT.core.sync
    return sync.RWLock if impl == "native" else sync.PyRWLock


def _value_array(m, impl):
    sync = m.core.sync
    return sync.ValueArray if impl == "native" else sync.PyValueArray


def test_native_classes_are_the_native_core():
    """The port binds the same classes to its native core as the JAX
    package does to its own."""
    for name in ("RWLock", "ValueArray"):
        for m in (JAX, PORT):
            sync = m.core.sync
            assert getattr(sync, name) is not getattr(sync, "Py" + name)


@pytest.mark.parametrize("impl", IMPLS)
def test_rwlock_under_contention(impl):
    """Readers run concurrently, writers are exclusive: two fields
    updated together under write_lock never tear for a reader."""
    lk = _rwlock(impl)()
    state = {"a": 0, "b": 0}
    N_WRITES = 200
    errors = []

    def writer():
        for _ in range(N_WRITES):
            lk.write_lock()
            state["a"] += 1
            state["b"] += 1
            lk.write_unlock()

    def reader():
        for _ in range(400):
            lk.read_lock()
            a, b = state["a"], state["b"]
            if a != b:
                errors.append((a, b))
            lk.read_unlock()

    threads = ([threading.Thread(target=writer) for _ in range(2)]
               + [threading.Thread(target=reader) for _ in range(4)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "rwlock deadlock"
    assert errors == [], f"readers saw torn writes: {errors[:5]}"
    assert state["a"] == state["b"] == 2 * N_WRITES
    assert lk.nreaders() == 0


@pytest.mark.parametrize("impl", IMPLS)
def test_rwlock_readers_share(impl):
    """Two readers hold the lock at once (a mutex in disguise would
    serialize them and the barrier would time out)."""
    lk = _rwlock(impl)()
    both_in = threading.Barrier(2, timeout=20)

    def reader():
        lk.read_lock()
        both_in.wait()   # blocks until BOTH threads hold the read lock
        lk.read_unlock()

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive(), "readers failed to share the lock"


def _va_basics(m, impl):
    va = _value_array(m, impl)(8)
    seen = [len(va), va.item_size()]
    va.set_size(3)
    seen += [len(va), va.get(2)]            # growth zero-fills
    va.set(1, struct.pack("<q", -42))
    seen.append(struct.unpack("<q", va.get(1))[0])
    seen += [va.push_back(struct.pack("<q", 7)), len(va)]
    va.set_size(2)                          # shrink drops the tail
    seen.append(len(va))
    for call, exc in ((lambda: va.get(2), IndexError),
                      (lambda: va.set(0, b"short"), ValueError)):
        try:
            call()
            seen.append(None)
        except exc:
            seen.append(exc.__name__)
    return seen


@pytest.mark.parametrize("impl", IMPLS)
def test_value_array_basics(impl):
    assert _both(lambda m: _va_basics(m, impl)) == [
        0, 8, 3, b"\0" * 8, -42, 3, 4, 2, "IndexError", "ValueError"]


@pytest.mark.parametrize("impl", IMPLS)
def test_value_array_concurrent_push(impl):
    """Concurrent push_back: every index handed out exactly once and
    every element lands intact."""
    va = _value_array(PORT, impl)(8)
    got = [[] for _ in range(4)]

    def pusher(slot):
        for i in range(250):
            v = slot * 1000 + i
            got[slot].append((va.push_back(struct.pack("<q", v)), v))

    threads = [threading.Thread(target=pusher, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert len(va) == 1000
    assert sorted(i for slot in got for (i, _v) in slot) == list(range(1000))
    for slot in got:
        for idx, v in slot:
            assert struct.unpack("<q", va.get(idx))[0] == v
