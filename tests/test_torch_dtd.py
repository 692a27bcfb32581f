"""The port's DTD front end (parsec_tpu_torch.dsl.dtd), its composition
(compose, recursive_call, SubtileView) and ptg_to_dtd, against the JAX
package's.

Every scenario runs through both packages on the same numpy inputs: the
host bodies are the same numpy code, so their final tiles must be equal
(``assert_array_equal``).  CUDA chores run on the port's CUDA device
module over host tensors (``init(device="cpu")``) with each kernel's
plain version; the JAX package's ``"tpu"`` chores run on its virtual CPU
devices.  Those two compute in different libraries, so they agree to a
stated tolerance.
"""
import contextlib
import threading

import numpy as np
import pytest

import parsec_tpu
import parsec_tpu.dsl.dtd as jdtd
from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
from parsec_tpu.ops import dpotrf_taskpool as jdpotrf_taskpool

import parsec_tpu_torch
import parsec_tpu_torch.dsl.dtd as tdtd
from parsec_tpu_torch import compose, ops, recursive_call
from parsec_tpu_torch.collections import SubtileView, TwoDimBlockCyclic
from parsec_tpu_torch.devices.cuda import CudaDevice
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.dsl.dtd import INOUT, INPUT, VALUE, unpack_args
from parsec_tpu_torch.ops import dpotrf, dpotrf_taskpool, make_spd
from parsec_tpu_torch.utils.params import params

TILE = 4


@pytest.fixture
def tctx():
    c = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    yield c
    c.fini()


@pytest.fixture
def tctx4():
    c = parsec_tpu_torch.init(nb_cores=4, device="cpu")
    yield c
    c.fini()


def _both(scenario, jctx, tctx):
    """Run ``scenario(dtd_module, ctx)`` through the JAX package and the
    port; return both results."""
    return scenario(jdtd, jctx), scenario(tdtd, tctx)


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# --------------------------------------------------------------------- #
# test_dtd_basic.py, through both packages                              #
# --------------------------------------------------------------------- #
def _empty(dtd, ctx):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    tp.wait()
    return tp.completed


def _single(dtd, ctx):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    ran = []
    tp.insert_task(lambda es, task: ran.append(task.snprintf()))
    tp.wait()
    return len(ran)


def _values(dtd, ctx):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    got = []
    tp.insert_task(lambda es, task: got.append(dtd.unpack_args(task)),
                   (7, dtd.VALUE), "hello")
    tp.wait()
    return got


def _raw_chain(dtd, ctx):
    """A chain of INOUT tasks on one tile serializes in insert order."""
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    arr = np.zeros(1, dtype=np.int64)
    tile = tp.tile_of_array(arr)

    def body(es, task):
        (a, k) = dtd.unpack_args(task)
        assert a[0] == k, f"task {k} saw {a[0]}"
        a[0] += 1

    for k in range(50):
        tp.insert_task(body, (tile, dtd.INOUT), (k, dtd.VALUE))
    tp.wait()
    return arr


def _fanout_war(dtd, ctx):
    """Readers run after a write and see the old value; the next writer
    waits for all of them (ref: overlap_strategies.c WAR resolution)."""
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    arr = np.array([10.0])
    tile = tp.tile_of_array(arr)
    reads = []
    lock = threading.Lock()

    def writer(es, task):
        (a,) = dtd.unpack_args(task)
        a[0] = 99.0

    def reader(es, task):
        (a, i) = dtd.unpack_args(task)
        with lock:
            reads.append((i, a[0]))

    for i in range(8):
        tp.insert_task(reader, (tile, dtd.INPUT), (i, dtd.VALUE))
    tp.insert_task(writer, (tile, dtd.INOUT))
    tp.wait()
    return sorted(reads), arr


def _diamond(dtd, ctx):
    """t1 writes A; t2, t3 read A and write B, C; t4 reads B and C."""
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    A, B, C = (tp.tile_of_array(np.zeros(1)) for _ in range(3))
    out = []

    def t1(es, task):
        (a,) = dtd.unpack_args(task)
        a[0] = 1.0

    def t2(es, task):
        a, b = dtd.unpack_args(task)
        b[0] = a[0] + 10

    def t3(es, task):
        a, c = dtd.unpack_args(task)
        c[0] = a[0] + 20

    def t4(es, task):
        b, c = dtd.unpack_args(task)
        out.append(b[0] + c[0])

    tp.insert_task(t1, (A, dtd.INOUT))
    tp.insert_task(t2, (A, dtd.INPUT), (B, dtd.INOUT))
    tp.insert_task(t3, (A, dtd.INPUT), (C, dtd.INOUT))
    tp.insert_task(t4, (B, dtd.INPUT), (C, dtd.INPUT))
    tp.wait()
    return out


def _new_tile(dtd, ctx):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    t = tp.tile_new((4,), dtype=np.float64)
    seen = []

    def init(es, task):
        (a,) = dtd.unpack_args(task)
        a[:] = 3.0

    def check(es, task):
        (a,) = dtd.unpack_args(task)
        seen.append(a.copy())

    tp.insert_task(init, (t, dtd.INOUT))
    tp.insert_task(check, (t, dtd.INPUT))
    tp.wait()
    return seen


def _many_independent(dtd, ctx):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    counter = [0]
    lock = threading.Lock()

    def body(es, task):
        with lock:
            counter[0] += 1

    for _ in range(500):
        tp.insert_task(body)
    tp.wait()
    return counter[0]


def _flush_two_pools(dtd, ctx):
    tp1, tp2 = dtd.taskpool_new("one"), dtd.taskpool_new("two")
    ctx.add_taskpool(tp1)
    ctx.add_taskpool(tp2)
    a1, a2 = np.zeros(1), np.zeros(1)
    t1, t2 = tp1.tile_of_array(a1), tp2.tile_of_array(a2)

    def inc(es, task):
        (a,) = dtd.unpack_args(task)
        a[0] += 1

    tp1.insert_task(inc, (t1, dtd.INOUT))
    tp2.insert_task(inc, (t2, dtd.INOUT))
    tp1.data_flush_all()
    tp2.data_flush_all()
    tp1.wait()
    tp2.wait()
    return [a1, a2]


@pytest.mark.parametrize("scenario", [
    _empty, _single, _values, _raw_chain, _diamond, _new_tile,
    _flush_two_pools], ids=lambda f: f.__name__.strip("_"))
def test_dtd_basic_matches_jax(ctx, tctx, scenario):
    j, t = _both(scenario, ctx, tctx)
    _assert_same(j, t)


@pytest.mark.parametrize("scenario", [_fanout_war, _many_independent],
                         ids=lambda f: f.__name__.strip("_"))
def test_dtd_four_workers_match_jax(ctx4, tctx4, scenario):
    j, t = _both(scenario, ctx4, tctx4)
    _assert_same(j, t)


def test_expected_basic_values(tctx, tctx4):
    """The port's answers on their own, as test_dtd_basic.py states
    them."""
    assert _empty(tdtd, tctx) is True
    assert _single(tdtd, tctx) == 1
    assert _values(tdtd, tctx) == [[7, "hello"]]
    assert _raw_chain(tdtd, tctx)[0] == 50
    reads, arr = _fanout_war(tdtd, tctx4)
    assert len(reads) == 8 and all(v == 10.0 for _, v in reads)
    assert arr[0] == 99.0
    assert _diamond(tdtd, tctx) == [32.0]
    np.testing.assert_array_equal(_new_tile(tdtd, tctx)[0], np.full(4, 3.0))
    assert _many_independent(tdtd, tctx4) == 500


def _window(dtd, ctx):
    tp = dtd.taskpool_new()
    tp.window_size = 50
    tp.threshold_size = 25
    ctx.add_taskpool(tp)
    arr = np.zeros(1)
    tile = tp.tile_of_array(arr)
    most = 0

    def body(es, task):
        (a, _k) = dtd.unpack_args(task)
        a[0] += 1

    for k in range(300):
        tp.insert_task(body, (tile, dtd.INOUT), (k, dtd.VALUE))
        most = max(most, tp._outstanding)
    tp.wait()
    return arr, most


def test_window_backpressure():
    """Insertion does not grow past the window (ref:
    insert_function.c:69-70 window/threshold)."""
    parsec_tpu.params.reset()
    params.reset()
    jc = parsec_tpu.init(nb_cores=2)
    tc = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    try:
        (ja, _), (ta, most) = _both(_window, jc, tc)
    finally:
        jc.fini()
        tc.fini()
    np.testing.assert_array_equal(ja, ta)
    assert ta[0] == 300 and most <= 51


@pytest.mark.parametrize("sched", ["lfq", "gd", "ap", "ip", "ll", "rnd",
                                   "spq", "pbq", "ltq", "lhq"])
def test_all_schedulers_run_dag(sched):
    """The chain's answer under every scheduler module, equal to the JAX
    package's (ref: tests/runtime/sched semantics tests)."""
    def chain(dtd, ctx):
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        arr = np.zeros(1)
        tile = tp.tile_of_array(arr)

        def body(es, task):
            (a, k) = dtd.unpack_args(task)
            assert a[0] == k
            a[0] += 1

        for k in range(30):
            tp.insert_task(body, (tile, dtd.INOUT), (k, dtd.VALUE))
        tp.wait()
        return arr

    jc = parsec_tpu.Context(nb_cores=2, scheduler=sched)
    tc = parsec_tpu_torch.Context(nb_cores=2, scheduler=sched, device="cpu")
    try:
        j, t = _both(chain, jc, tc)
    finally:
        jc.fini()
        tc.fini()
    np.testing.assert_array_equal(j, t)
    assert t[0] == 30


def _dtd_cross_rank_chain(pkg, dtd_mod, rank, fabric, n_tasks):
    """One tile homed on rank 0, CUDA-chore-free host bodies alternating
    between 2 ranks (AFFINITY on per-rank anchors): every edge is a
    cross-rank RAW matched by (tile, write sequence)."""
    from_pkg = __import__(pkg.__name__ + ".collections",
                          fromlist=["DictCollection"])
    comm = __import__(pkg.__name__ + ".comm", fromlist=["RemoteDepEngine"])
    kw = {"device": "cpu"} if pkg is parsec_tpu_torch else \
        {"enable_tpu": False}
    ctx = pkg.Context(nb_cores=1, comm=comm.RemoteDepEngine(
        fabric.engine(rank)), **kw)
    try:
        coll = from_pkg.DictCollection(nodes=2, rank=rank)
        coll.name = "C"
        coll.add("x", 0, np.arange(4.0) if rank == 0 else None)
        anchors = []
        for r in range(2):
            a = from_pkg.DictCollection(nodes=2, rank=rank)
            a.name = f"anchor{r}"
            a.add("a", r, np.zeros(1) if r == rank else None)
            anchors.append(a)
        tp = dtd_mod.taskpool_new("xchain")
        ctx.add_taskpool(tp)
        tile = tp.tile_of(coll, "x")

        def body(es, task):
            x, _a, k = dtd_mod.unpack_args(task)
            x *= 1.5
            x += k

        for k in range(n_tasks):
            tp.insert_task(body, (tile, dtd_mod.INOUT),
                           (tp.tile_of(anchors[k % 2], "a"),
                            dtd_mod.INPUT | dtd_mod.AFFINITY),
                           (k, dtd_mod.VALUE))
        tp.data_flush_all()
        tp.wait()
        ctx.wait()
        if rank == 0:
            return np.array(coll.data_of("x").get_copy(0).payload)
        return None
    finally:
        ctx.fini()


def test_dtd_pool_on_several_ranks_raises(tctx):
    """A DTD pool on several ranks runs its cross-rank edges over the
    comm engine — the port's 2-rank LocalFabric chain gives the JAX
    package's values bit for bit — and a tile on another rank with no
    comm engine attached raises instead of being read stale."""
    from parsec_tpu.comm import LocalFabric as JLocalFabric
    from parsec_tpu.utils.spmd import spmd_threads as jspmd
    from parsec_tpu_torch.utils.spmd import spmd_threads as tspmd
    t_res, t_fab = tspmd(2, lambda r, f: _dtd_cross_rank_chain(
        parsec_tpu_torch, tdtd, r, f, 7), timeout=60)
    j_res, _ = jspmd(2, lambda r, f: _dtd_cross_rank_chain(
        parsec_tpu, jdtd, r, f, 7), timeout=60, fabric=JLocalFabric(2))
    np.testing.assert_array_equal(t_res[0], j_res[0])
    assert t_fab.msg_count > 0
    from parsec_tpu_torch.collections import DictCollection
    tctx.nb_ranks = 2
    try:
        coll = DictCollection(nodes=2, rank=0)
        coll.name = "C"
        coll.add("x", 1, None)
        mine = DictCollection(nodes=2, rank=0)
        mine.name = "mine"
        mine.add("a", 0, np.zeros(1))
        tp = tdtd.taskpool_new()
        tctx.add_taskpool(tp)
        with pytest.raises(RuntimeError, match="no comm engine"):
            tp.insert_task(lambda es, task: None,
                           (tp.tile_of(coll, "x"), INPUT),
                           (tp.tile_of(mine, "a"), INOUT | tdtd.AFFINITY))
    finally:
        tctx.nb_ranks = 1
        tctx.taskpools.clear()
        tctx._active_taskpools = 0


def test_insert_errors(tctx):
    tp = tdtd.taskpool_new()
    tctx.add_taskpool(tp)
    with pytest.raises(TypeError, match="DTDTile"):
        tp.insert_task(lambda es, t: None, (np.ones(2), INOUT))
    with pytest.raises(ValueError, match="first insert_task"):
        tp.add_chore(len, "cuda", len)
    body = lambda es, t: None    # noqa: E731
    tp.insert_task(body)
    with pytest.raises(ValueError, match='"cuda"'):
        tp.add_chore(body, "tpu", len)
    tp.wait()
    with pytest.raises(RuntimeError, match="after wait"):
        tp.insert_task(body)


# --------------------------------------------------------------------- #
# test_dtd_stress.py: random DAGs against a sequential oracle           #
# --------------------------------------------------------------------- #
def _apply(args):
    coef = args[-1]
    out = args[0]
    acc = float(coef)
    for a in args[1:-1]:
        acc += float(a[0, 0])
    out += acc  # INOUT accumulate: order-sensitive across tasks
    out *= 1.0 + 1e-3 * coef  # non-commutative with the add


def _make_bodies(dtd):
    # one DTD task class per flow signature (arity 1, 2, 3)
    def b0(es, task):
        _apply(dtd.unpack_args(task))

    def b1(es, task):
        _apply(dtd.unpack_args(task))

    def b2(es, task):
        _apply(dtd.unpack_args(task))
    return {0: b0, 1: b1, 2: b2}


def _random_program(seed):
    rng = np.random.RandomState(seed)
    n_tiles, n_tasks = 8, 120
    tiles = [rng.rand(4, 4).astype(np.float64) for _ in range(n_tiles)]
    program = []
    for t in range(n_tasks):
        out = int(rng.randint(n_tiles))
        nin = int(rng.randint(0, 3))
        ins = [int(x) for x in rng.choice(
            [i for i in range(n_tiles) if i != out],
            size=nin, replace=False)] if nin else []
        program.append((out, ins, float(t % 7)))
    return tiles, program


def _oracle(tiles, program):
    state = [t.copy() for t in tiles]
    for (out, ins, coef) in program:
        acc = float(coef)
        for i in ins:
            acc += float(state[i][0, 0])
        state[out] += acc
        state[out] *= 1.0 + 1e-3 * coef
    return state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_dag_matches_oracle_and_jax(ctx4, tctx4, seed):
    tiles, program = _random_program(seed)

    def run(dtd, ctx):
        bodies = _make_bodies(dtd)
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        handles = [tp.tile_of_array(t.copy()) for t in tiles]
        for (out, ins, coef) in program:
            args = [(handles[out], dtd.INOUT)]
            args += [(handles[i], dtd.INPUT) for i in ins]
            args.append((coef, dtd.VALUE))
            tp.insert_task(bodies[len(ins)], *args)
        tp.data_flush_all()
        tp.wait()
        return [np.asarray(h.data.get_copy(0).payload) for h in handles]

    j, t = _both(run, ctx4, tctx4)
    for i, expect in enumerate(_oracle(tiles, program)):
        np.testing.assert_allclose(t[i], expect, rtol=1e-12,
                                   err_msg=f"tile {i} diverged (seed {seed})")
        np.testing.assert_array_equal(t[i], j[i])


# --------------------------------------------------------------------- #
# CUDA chores (test_device_tpu.py's DTD tests), on the CPU device module #
# --------------------------------------------------------------------- #
def _cuda(ctx):
    return ctx.device_by_type("cuda")


def test_cuda_chore_runs_and_writes_back(ctx, tctx):
    def run(dtd, ctx, chore_type, fn):
        a = np.arange(16.0, dtype=np.float32).reshape(4, 4)
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(a.copy())

        def body(es, task):   # host body
            (x,) = dtd.unpack_args(task)
            x *= 2.0

        tp.insert_task(body, (tile, dtd.INOUT))
        tp.wait()
        tp2 = dtd.taskpool_new()
        ctx.add_taskpool(tp2)
        tile2 = tp2.tile_of_data(tile.data)

        def body2(es, task):
            (x,) = dtd.unpack_args(task)
            x *= 2.0

        tp2.insert_task(body2, (tile2, dtd.INOUT))
        tp2.add_chore(body2, chore_type, fn)
        tp2.insert_task(body2, (tile2, dtd.INOUT))
        tp2.data_flush(tile2)
        tp2.wait()
        return np.asarray(tile.data.get_copy(0).payload)

    j = run(jdtd, ctx, "tpu", lambda x: x * 2.0)
    t = run(tdtd, tctx, "cuda", lambda x: x * 2.0)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(
        t, np.arange(16.0, dtype=np.float32).reshape(4, 4) * 8.0)
    assert _cuda(tctx).stats["tasks"] >= 1


def test_device_write_then_host_read_pulls_back(ctx, tctx):
    """Coherency: a host body after a CUDA chore sees the new version."""
    def run(dtd, ctx, chore_type):
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(np.ones((8, 8), dtype=np.float32))
        seen = []

        def dev_body(es, task):
            (x,) = dtd.unpack_args(task)
            x += 1.0

        def host_body(es, task):
            (x,) = dtd.unpack_args(task)
            seen.append(np.asarray(x).copy())

        tp.insert_task(dev_body, (tile, dtd.INOUT))
        tp.add_chore(dev_body, chore_type, lambda x: x + 1.0)
        tp.insert_task(dev_body, (tile, dtd.INOUT))
        tp.insert_task(host_body, (tile, dtd.INPUT))
        tp.wait()
        return seen

    j, t = run(jdtd, ctx, "tpu"), run(tdtd, tctx, "cuda")
    assert len(t) == 1
    np.testing.assert_array_equal(t[0], np.full((8, 8), 3.0))
    np.testing.assert_array_equal(j[0], t[0])


def test_chain_on_device_stays_on_device(tctx):
    """A chain of CUDA chores does not bounce through the host: one
    stage-in of the 16-byte tile, the flush's one stage-out."""
    tp = tdtd.taskpool_new()
    tctx.add_taskpool(tp)
    tile = tp.tile_of_array(np.zeros((4,), dtype=np.float32))

    def body(es, task):
        (x,) = unpack_args(task)
        x += 1.0

    tp.insert_task(body, (tile, INOUT))
    tp.add_chore(body, "cuda", lambda x: x + 1.0)
    for _ in range(9):
        tp.insert_task(body, (tile, INOUT))
    tp.data_flush(tile)
    tp.wait()
    np.testing.assert_array_equal(tile.data.get_copy(0).payload,
                                  np.full((4,), 10.0, np.float32))
    st = _cuda(tctx).stats
    assert st["tasks"] >= 9
    assert st["stage_in_bytes"] <= 16 * 2
    assert st["stage_out_bytes"] <= 16 * 2


def test_load_balancing_spreads_independent_tiles():
    """With two CUDA device modules attached, independent tasks spread
    over both (get_best_device by load).  init() attaches one module; the
    test attaches the second itself."""
    ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    try:
        ctx.devices.append(CudaDevice(len(ctx.devices), "cpu"))
        devs = [d for d in ctx.devices if d.device_type == "cuda"]
        tp = tdtd.taskpool_new()
        ctx.add_taskpool(tp)
        tiles = [tp.tile_of_array(np.zeros((16, 16), dtype=np.float32))
                 for _ in range(16)]

        def body(es, task):
            (x,) = unpack_args(task)
            x += 1.0

        tp.insert_task(body, (tiles[0], INOUT))
        tp.add_chore(body, "cuda", lambda x: x + 1.0)
        for t in tiles[1:]:
            tp.insert_task(body, (t, INOUT))
        tp.data_flush_all()
        tp.wait()
        used = sum(1 for d in devs if d.executed_tasks > 0)
        assert used >= 2, [d.executed_tasks for d in devs]
        for t in tiles:
            np.testing.assert_array_equal(t.data.get_copy(0).payload,
                                          np.ones((16, 16), np.float32))
    finally:
        ctx.fini()


@contextlib.contextmanager
def _burst_ctx(**over):
    """One worker and one CUDA device module on host tensors: the
    submitting thread accumulates the whole burst before the flush."""
    with contextlib.ExitStack() as stack:
        for k, v in over.items():
            stack.enter_context(params.cmdline_override(k, str(v)))
        c = parsec_tpu_torch.init(nb_cores=1, device="cpu")
        try:
            yield c
        finally:
            c.fini()


def _gemm_burst(ctx, burst, nb, seed=0):
    """A same-class burst of independent c -= a @ b.T CUDA chores;
    returns the c tiles after wait."""
    tp = tdtd.taskpool_new()
    ctx.add_taskpool(tp)

    def body(es, task):
        c, a, b = unpack_args(task)
        c -= a @ b.T

    boot = tp.tile_of_array(np.zeros((nb, nb), np.float32))
    tp.insert_task(body, (boot, INOUT), (boot, INPUT), (boot, INPUT))
    tp.add_chore(body, "cuda", ops.gemm_nt, stacked=True)
    rng = np.random.RandomState(seed)
    tiles = [[tp.tile_of_array(rng.rand(nb, nb).astype(np.float32))
              for _ in range(3)] for _ in range(burst)]
    for c, a, b in tiles:
        tp.insert_task(body, (c, INOUT), (a, INPUT), (b, INPUT))
    for c, _a, _b in tiles:
        tp.data_flush(c)
    tp.wait()
    return [np.asarray(c.data.get_copy(0).payload).copy()
            for c, _a, _b in tiles]


def test_batched_dispatch_bit_exact_vs_per_task():
    """A same-class burst through the stacked path is byte-identical to
    per-task dispatch, and really batched (with prefetch hits)."""
    with _burst_ctx(device_batch_max=1) as c:
        ref = _gemm_burst(c, 24, 32)
        assert _cuda(c).stats["batches"] == 0
    with _burst_ctx(device_batch_max=8, device_prefetch_depth=4) as c:
        got = _gemm_burst(c, 24, 32)
        st = _cuda(c).stats
        assert st["batches"] > 0, "burst never took the batched path"
        assert st["batched_tasks"] / st["batches"] >= 2
        assert st["prefetch_issued"] > 0 and st["prefetch_hits"] > 0
    rng = np.random.RandomState(0)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    for r in ref:   # the values: c - a b^T, as the tiles were drawn
        c, a, b = (rng.rand(32, 32).astype(np.float32) for _ in range(3))
        np.testing.assert_allclose(r, c - a @ b.T, rtol=1e-5, atol=1e-5)


def test_batched_dispatch_value_params_group_by_value():
    """VALUE params are static: tasks passing different scalars never
    stack into one group."""
    with _burst_ctx(device_batch_max=8) as c:
        tp = tdtd.taskpool_new()
        c.add_taskpool(tp)

        def body(es, task):
            x, s = unpack_args(task)
            x *= s

        boot = tp.tile_of_array(np.ones((4,), np.float32))
        tp.insert_task(body, (boot, INOUT), (1.0, VALUE))
        tp.add_chore(body, "cuda", lambda x, s: x * s)
        tiles = [tp.tile_of_array(np.ones((4,), np.float32))
                 for _ in range(8)]
        for i, t in enumerate(tiles):
            tp.insert_task(body, (t, INOUT), (float(i % 2 + 2), VALUE))
        for t in tiles:
            tp.data_flush(t)
        tp.wait()
        assert _cuda(c).stats["batches"] > 0
        for i, t in enumerate(tiles):
            np.testing.assert_array_equal(
                t.data.get_copy(0).payload,
                np.full((4,), float(i % 2 + 2), np.float32))


def test_batched_dispatch_divergent_shapes():
    """Same class, divergent tile shapes: every shape group dispatches
    right (singletons take the per-task path)."""
    with _burst_ctx(device_batch_max=8) as c:
        tp = tdtd.taskpool_new()
        c.add_taskpool(tp)

        def body(es, task):
            (x,) = unpack_args(task)
            x += 1.0

        boot = tp.tile_of_array(np.zeros((2, 2), np.float32))
        tp.insert_task(body, (boot, INOUT))
        tp.add_chore(body, "cuda", lambda x: x + 1.0)
        shapes = [(3, 3), (5, 5), (3, 3), (5, 5), (7, 7), (3, 3)]
        tiles = [tp.tile_of_array(np.zeros(s, np.float32)) for s in shapes]
        for t in tiles:
            tp.insert_task(body, (t, INOUT))
        for t in tiles:
            tp.data_flush(t)
        tp.wait()
        for s, t in zip(shapes, tiles):
            np.testing.assert_array_equal(t.data.get_copy(0).payload,
                                          np.ones(s, np.float32))


def _transpose_burst(ctx, stacked=False):
    tp = tdtd.taskpool_new()
    ctx.add_taskpool(tp)

    def body(es, task):
        (x,) = unpack_args(task)
        x[...] = x.T + 1.0

    boot = tp.tile_of_array(np.zeros((3, 3), np.float32))
    tp.insert_task(body, (boot, INOUT))
    # .T reverses every dimension: right on one tile, wrong on a stack
    tp.add_chore(body, "cuda", lambda x: x.T + 1.0, stacked=stacked)
    rng = np.random.RandomState(4)
    tiles = [tp.tile_of_array(rng.rand(3, 3).astype(np.float32))
             for _ in range(8)]
    for t in tiles:
        tp.insert_task(body, (t, INOUT))
    for t in tiles:
        tp.data_flush(t)
    tp.wait()
    return tiles


def test_stacked_chore_failure_raises_from_wait():
    """A chore that is right per task but wrong on a stack (``.T``, not
    ``.mT``) keeps single-tile semantics by default, batched or not.
    Declared ``stacked=True``, it is not downgraded to per-task
    dispatch: the stacked call's error aborts the DAG and re-raises from
    wait()."""
    rng = np.random.RandomState(4)
    want = [rng.rand(3, 3).astype(np.float32).T + 1.0 for _ in range(8)]
    with _burst_ctx(device_batch_max=1) as c:
        ref = [t.data.get_copy(0).payload.copy()
               for t in _transpose_burst(c)]   # per task: right
    with _burst_ctx(device_batch_max=8) as c:
        got = [t.data.get_copy(0).payload.copy()
               for t in _transpose_burst(c)]
        assert _cuda(c).stats["batches"] > 0
    for r, g, w in zip(ref, got, want):
        np.testing.assert_array_equal(r, g)
        np.testing.assert_allclose(r, w, rtol=1e-6)
    with _burst_ctx(device_batch_max=8) as c:
        with pytest.raises(RuntimeError, match="task body failed") as ei:
            _transpose_burst(c, stacked=True)
        assert isinstance(ei.value.__cause__, ValueError)


# --------------------------------------------------------------------- #
# the DTD Cholesky: bit-identical to the PTG one on the same bodies      #
# --------------------------------------------------------------------- #
def dtd_cholesky(ctx, A):
    """The tile Cholesky of ``A`` through DTD with CUDA chores; returns
    the number of tasks inserted after the four boot tasks."""
    tp = tdtd.taskpool_new("dtd_potrf")
    ctx.add_taskpool(tp)

    def potrf(es, task):
        raise AssertionError("host body ran")

    def trsm(es, task):
        raise AssertionError("host body ran")

    def syrk(es, task):
        raise AssertionError("host body ran")

    def gemm(es, task):
        raise AssertionError("host body ran")

    boot = tp.tile_of_array(np.eye(A.nb, dtype=np.float32))
    for body, fn, modes in [(potrf, ops.potrf, (INOUT,)),
                            (trsm, ops.trsm_panel, (INPUT, INOUT)),
                            (syrk, ops.syrk_ln, (INOUT, INPUT)),
                            (gemm, ops.gemm_nt, (INOUT, INPUT, INPUT))]:
        tp.insert_task(body, *[(boot, m) for m in modes])
        tp.add_chore(body, "cuda", fn, stacked=True)
    T = lambda m, n: tp.tile_of(A, (m, n))   # noqa: E731
    n_tasks = 0
    for k in range(A.nt):
        tp.insert_task(potrf, (T(k, k), INOUT))
        for m in range(k + 1, A.nt):
            tp.insert_task(trsm, (T(k, k), INPUT), (T(m, k), INOUT))
        for m in range(k + 1, A.nt):
            tp.insert_task(syrk, (T(m, m), INOUT), (T(m, k), INPUT))
            for n in range(k + 1, m):
                tp.insert_task(gemm, (T(m, n), INOUT), (T(m, k), INPUT),
                               (T(n, k), INPUT))
                n_tasks += 1
            n_tasks += 1
        n_tasks += 1 + (A.nt - k - 1)
    tp.data_flush_all()
    tp.wait()
    return n_tasks


@pytest.mark.parametrize("n,nb", [(128, 32), (100, 32)])
def test_dtd_cholesky_bit_identical_to_ptg(tctx, n, nb):
    M = make_spd(n)
    A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    dpotrf(tctx, A)
    B = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    before = _cuda(tctx).stats["tasks"]
    n_tasks = dtd_cholesky(tctx, B)
    nt = B.nt
    assert n_tasks == nt + nt * (nt - 1) + nt * (nt - 1) * (nt - 2) // 6
    assert _cuda(tctx).stats["tasks"] - before >= n_tasks
    np.testing.assert_array_equal(np.tril(B.to_numpy()),
                                  np.tril(A.to_numpy()))


# --------------------------------------------------------------------- #
# test_compound_recursive.py                                            #
# --------------------------------------------------------------------- #
def _scale_pool(dtd, A, fn, name):
    """A DTD pool applying ``fn`` to every tile of A in place."""
    tp = dtd.taskpool_new(name=name)

    def body(es, task):
        (t,) = dtd.unpack_args(task)
        t[...] = fn(t)

    for (m, n) in A.tiles():
        tp.insert_task(body, (tp.tile_of(A, (m, n)), dtd.INOUT))
    return tp


def test_compose_orders_pools(ctx, tctx):
    """(M*2)+1 != (M+1)*2 — the compound runs parts in order."""
    M = np.arange(TILE * TILE * 4, dtype=np.float32).reshape(2 * TILE,
                                                            2 * TILE)

    def run(pkg, dtd, coll, ctx):
        A = coll(2 * TILE, 2 * TILE, TILE, TILE).from_numpy(M)
        a = _scale_pool(dtd, A, lambda t: t * 2.0, "x2")
        b = _scale_pool(dtd, A, lambda t: t + 1.0, "p1")
        ctx.add_taskpool(pkg.compose(a, b))
        ctx.wait()
        return A.to_numpy()

    j = run(parsec_tpu, jdtd, JTwoDimBlockCyclic, ctx)
    t = run(parsec_tpu_torch, tdtd, TwoDimBlockCyclic, tctx)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(t, M * 2.0 + 1.0)


def test_compose_appends_to_compound(tctx):
    """compose(compound, c) appends in place (three-stage chain)."""
    order = []

    def stage(tag):
        tp = tdtd.taskpool_new(name=f"stage_{tag}")
        tp.insert_task(lambda es, task: order.append(tag), name=f"t_{tag}")
        return tp

    c1 = compose(stage("a"), stage("b"))
    c2 = compose(c1, stage("c"))
    assert c2 is c1
    tctx.add_taskpool(c2)
    tctx.wait()
    assert order == ["a", "b", "c"]


def test_compose_rejects_enqueued(tctx):
    tp1 = tdtd.taskpool_new()
    tp1.insert_task(lambda es, task: None, name="t")
    tctx.add_taskpool(tp1)
    tp1.wait()
    with pytest.raises(ValueError, match="enqueued"):
        compose(tp1, tdtd.taskpool_new())


def test_recursive_call_completes_parent(tctx):
    """A DTD task spawns a nested DTD pool; the parent completes only
    after the nested pool terminates."""
    events = []

    def parent_body(es, task):
        sub = tdtd.taskpool_new(name="nested")
        sub.insert_task(lambda es2, t2: events.append("child"), name="child")
        return recursive_call(es, task, sub,
                              callback=lambda s, t: events.append("callback"))

    tp = tdtd.taskpool_new(name="parent")
    tctx.add_taskpool(tp)
    tp.insert_task(parent_body, name="parent")
    tp.wait()
    assert events == ["child", "callback"]


def test_recursive_dpotrf_on_subtiles(ctx, tctx):
    """A diagonal-tile POTRF re-expressed as a nested tile Cholesky over
    sub-tiles (CUDA bodies on the device module), updating the parent
    tile in place through SubtileView; the JAX package's run gives the
    reference factor."""
    from parsec_tpu.collections import SubtileView as JSubtileView
    n = 4 * TILE
    M = make_spd(n, dtype=np.float32, seed=3)

    def run(pkg, dtd, view, taskpool, ctx):
        tp = dtd.taskpool_new(name="recursive_potrf")
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(M.copy())

        def factor(es, task):
            (t,) = dtd.unpack_args(task)
            return pkg.recursive_call(es, task, taskpool(view(t, TILE, TILE)))

        tp.insert_task(factor, (tile, dtd.INOUT), name="factor")
        tp.data_flush_all()
        tp.wait()
        return np.tril(np.asarray(tile.data.get_copy(0).payload))

    j = run(parsec_tpu, jdtd, JSubtileView, jdpotrf_taskpool, ctx)
    L = run(parsec_tpu_torch, tdtd, SubtileView, dpotrf_taskpool, tctx)
    np.testing.assert_allclose(L @ L.T, M, atol=5e-4)
    np.testing.assert_allclose(L, j, atol=5e-4)
    assert _cuda(tctx).stats["tasks"] > 0


def test_recursive_inside_compound(tctx):
    """Recursion composes with compound chaining."""
    log = []

    def rec_stage(tag):
        tp = tdtd.taskpool_new(name=f"outer_{tag}")

        def outer(es, task):
            sub = tdtd.taskpool_new(name=f"inner_{tag}")
            sub.insert_task(lambda e, t: log.append(f"in_{tag}"), name="i")
            return recursive_call(es, task, sub,
                                  callback=lambda s, t: log.append(f"cb_{tag}"))

        tp.insert_task(outer, name="o")
        return tp

    tctx.add_taskpool(compose(rec_stage("x"), rec_stage("y")))
    tctx.wait()
    assert log == ["in_x", "cb_x", "in_y", "cb_y"]


def test_subtile_view_geometry():
    arr = np.arange(36, dtype=np.float32).reshape(6, 6)
    v = SubtileView(arr, 4, 4)
    assert (v.mt, v.nt) == (2, 2)
    assert v.tile_shape(1, 1) == (2, 2)
    # tiles are views: writes reach the parent array
    v.data_of(0, 0).get_copy(0).payload[0, 0] = 99.0
    assert arr[0, 0] == 99.0
    with pytest.raises(IndexError):
        v.data_of(2, 0)


def test_compose_dtd_with_tracked_tiles(tctx):
    """Composed DTD pools that write tracked tiles seal cleanly (the
    flush runs before the pool stops accepting inserts)."""
    arr1 = np.zeros((TILE, TILE), np.float32)
    arr2 = np.zeros((TILE, TILE), np.float32)

    def writer(value):
        tp = tdtd.taskpool_new(name=f"w{value}")
        tile = tp.tile_of_array(arr1 if value == 1 else arr2)

        def body(es, task):
            (t,) = unpack_args(task)
            t += value

        tp.insert_task(body, (tile, INOUT), name="w")
        return tp

    tctx.add_taskpool(compose(writer(1), writer(2)))
    tctx.wait()
    assert arr1[0, 0] == 1.0 and arr2[0, 0] == 2.0


# --------------------------------------------------------------------- #
# ptg_to_dtd (test_observability.py's two replays)                      #
# --------------------------------------------------------------------- #
GEMM_JDF = """
descA [ type="collection" ]
descB [ type="collection" ]
descC [ type="collection" ]
MT [ type="int" ]
NT [ type="int" ]
KT [ type="int" ]

GEMM(m, n, k)

m = 0 .. MT-1
n = 0 .. NT-1
k = 0 .. KT-1

: descC( m, n )

READ A <- descA( m, k )
READ B <- descB( k, n )
RW   C <- (k == 0) ? descC( m, n ) : C GEMM( m, n, k-1 )
       -> (k == KT-1) ? descC( m, n ) : C GEMM( m, n, k+1 )

BODY
{
    C += A @ B
}
END
"""


def test_ptg_to_dtd_replay(ctx, tctx):
    """The GEMM k-chain JDF replayed through DTD matches numpy and the
    JAX package's replay."""
    from parsec_tpu.dsl import ptg as jptg
    from parsec_tpu.dsl.ptg.to_dtd import ptg_to_dtd as jptg_to_dtd
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd

    mt = nt = kt = 2
    rng = np.random.RandomState(11)
    Am = rng.rand(mt * TILE, kt * TILE).astype(np.float32)
    Bm = rng.rand(kt * TILE, nt * TILE).astype(np.float32)
    Cm = rng.rand(mt * TILE, nt * TILE).astype(np.float32)

    def run(pkg_ptg, coll, to_dtd, ctx):
        A = coll(mt * TILE, kt * TILE, TILE, TILE).from_numpy(Am)
        B = coll(kt * TILE, nt * TILE, TILE, TILE).from_numpy(Bm)
        C = coll(mt * TILE, nt * TILE, TILE, TILE).from_numpy(Cm)
        tp = pkg_ptg.compile_jdf(GEMM_JDF, name="gemm").new(
            descA=A, descB=B, descC=C, MT=mt, NT=nt, KT=kt)
        to_dtd(tp, ctx)
        return C.to_numpy()

    j = run(jptg, JTwoDimBlockCyclic, jptg_to_dtd, ctx)
    t = run(ptg, TwoDimBlockCyclic, ptg_to_dtd, tctx)
    np.testing.assert_allclose(t, Cm + Am @ Bm, rtol=2e-5)
    np.testing.assert_allclose(t, j, rtol=2e-5)


def test_ptg_to_dtd_replay_dpotrf(ctx, tctx):
    """Cross-DSL consistency on a non-trivial DAG: dpotrf via DTD, its
    ``ops.*`` bodies on CPU tensors sharing the host tiles."""
    from parsec_tpu.dsl.ptg.to_dtd import ptg_to_dtd as jptg_to_dtd
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd

    n = 3 * TILE
    M = make_spd(n)
    A = TwoDimBlockCyclic(n, n, TILE, TILE).from_numpy(M)
    tp = ptg_to_dtd(dpotrf_taskpool(A), tctx)
    assert tp.completed
    JA = JTwoDimBlockCyclic(n, n, TILE, TILE).from_numpy(M)
    jptg_to_dtd(jdpotrf_taskpool(JA), ctx)
    L = np.tril(A.to_numpy())
    np.testing.assert_allclose(L @ L.T, M, atol=5e-4)
    np.testing.assert_allclose(L, np.tril(JA.to_numpy()), atol=5e-4)
    with pytest.raises(ValueError, match="not yet enqueued"):
        enq = dpotrf_taskpool(A)
        enq.context = tctx
        ptg_to_dtd(enq, tctx)


def test_ptg_to_dtd_runs_device_bodies_as_chores(tctx):
    """A class with a BODY [type=cuda] runs it as its DTD class's CUDA
    chore on the context's device module, every task of it: dpotrf's
    tasks all ran there, and the factor is the PTG runtime's."""
    from parsec_tpu_torch.dsl.ptg.capture import plan
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd

    n, nb = 4 * TILE, TILE
    M = make_spd(n)
    A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    tp = dpotrf_taskpool(A)
    nb_tasks = len(plan(tp))
    before = _cuda(tctx).stats["tasks"]
    ptg_to_dtd(tp, tctx)
    assert _cuda(tctx).stats["tasks"] - before == nb_tasks
    R = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
    dpotrf(tctx, R)
    np.testing.assert_array_equal(np.tril(A.to_numpy()),
                                  np.tril(R.to_numpy()))


STEP_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

SRC(m, k)

k = 0 .. 0
m = 0 .. NT-1

: descA( m, 0 )

RW X <- descA( m, 0 )
     -> X DST( m )

BODY [type=cuda]
{
    X = X + 1.0
}
END

DST(m)

m = 0 .. NT-1

: descA( m, 0 )

RW X <- X SRC( m, 0 )
     -> descA( m, 0 )

BODY [type=cuda]
{
    X = X * 2.0
}
END
"""


def test_ptg_to_dtd_param_order_differs_from_locals(tctx):
    """SRC(m, k) declares k before m, as dtrsm's RPANEL does: DST's dep
    target SRC( m, 0 ) is in PARAM order and is translated to the locals'
    order, so each DST(m) finds SRC(m, 0)'s tile and runs after it."""
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd

    nt = 3
    An = np.arange(nt * 2, dtype=np.float32).reshape(nt * 2, 1) \
        * np.ones((1, 2), np.float32)

    def run(to_dtd):
        A = TwoDimBlockCyclic(nt * 2, 2, 2, 2).from_numpy(An)
        tp = ptg.compile_jdf(STEP_JDF, name="step").new(descA=A, NT=nt)
        if to_dtd:
            ptg_to_dtd(tp, tctx)
        else:
            tctx.add_taskpool(tp)
            tctx.wait()
        return A.to_numpy()

    np.testing.assert_array_equal(run(False), (An + 1.0) * 2.0)
    np.testing.assert_array_equal(run(True), (An + 1.0) * 2.0)


@pytest.mark.gpu
def test_ptg_to_dtd_on_the_card():
    """On a context holding the card, every dpotrf task runs its CUDA
    chore on cuda:0, through the GEMM kernel."""
    import torch
    from parsec_tpu_torch.dsl.ptg.capture import plan
    from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd
    from parsec_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, nb = 512, 128
    M = make_spd(n)
    c = parsec_tpu_torch.init(nb_cores=2)
    try:
        A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(M)
        tp = dpotrf_taskpool(A)
        nb_tasks = len(plan(tp))
        launches = kernels.matmul_launches
        ptg_to_dtd(tp, c)
        dev = _cuda(c)
        assert dev.name == "cuda:0"
        assert dev.stats["tasks"] == nb_tasks
        assert kernels.matmul_launches > launches
        L = np.tril(A.to_numpy())
    finally:
        c.fini()
    assert np.linalg.norm(L @ L.T - M) / np.linalg.norm(M) < 1e-5
