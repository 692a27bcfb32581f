"""Multi-tenant fairness and admission in the port's schedulers (serve/),
against the eight tenant tests of tests/test_sched_priority.py, plus the
pop order of the same tasks under both packages' fairness folds.

A ``TenantFairness`` attached as ``ctx.serve_fairness`` folds each
tenant's deficit boost above the class-profile band in
``stamp_dynamic_priority``; the ap/spq schedulers consume the combined
priority unchanged.  With no server and no class profile the fold is
one early return (``test_no_hook_keeps_static_priorities``).
"""
import threading

import pytest

import parsec_tpu_torch
from parsec_tpu_torch.runtime.profile import TENANT_PRIO_SCALE
from parsec_tpu_torch.runtime.scheduling import (schedule,
                                                 stamp_dynamic_priority)
from parsec_tpu_torch.runtime.taskpool import Task, TaskClass


class _FakePool:
    """Just enough taskpool for a Task living in scheduler queues."""
    taskpool_id = 0
    name = "fake"


class _TenantPool:
    """A fake pool with a distinct id so TenantFairness can attribute
    its tasks to a tenant."""
    name = "tenant-pool"

    def __init__(self, tp_id):
        self.taskpool_id = tp_id


def _mk_tasks(prios, cls="T"):
    tc = TaskClass(cls, 0, 0)
    tp = _FakePool()
    return [Task(tp, tc, (i,), priority=p) for i, p in enumerate(prios)]


def _tenant_tasks(tp, n, cls="T"):
    tc = TaskClass(cls, 0, 0)
    return [Task(tp, tc, (i,), priority=0) for i in range(n)]


def _ctx(sched, cores=1):
    return parsec_tpu_torch.init(nb_cores=cores, scheduler=sched,
                                 device="cpu")


def _fairness_ctx(sched="spq"):
    from parsec_tpu_torch.serve import TenantFairness
    ctx = _ctx(sched)
    fair = TenantFairness()
    fair.register("latency", 8)
    fair.register("bulk", 1)
    fair.bind_pool(101, "latency")
    fair.bind_pool(102, "bulk")
    ctx.serve_fairness = fair
    return ctx, fair, _TenantPool(101), _TenantPool(102)


@pytest.mark.parametrize("sched", ["ap", "spq"])
def test_mixed_tenant_weighted_pop_order(sched):
    """At cold start the heavier tenant's weight bias wins every pop;
    FIFO within each tenant is preserved (one shared boost per
    tenant)."""
    ctx, fair, pool_lat, pool_blk = _fairness_ctx(sched)
    try:
        es = ctx.execution_streams[0]
        lat = _tenant_tasks(pool_lat, 2)
        blk = _tenant_tasks(pool_blk, 2)
        # interleaved arrival, saturated queue
        schedule(es, [blk[0], lat[0], blk[1], lat[1]])
        got = [ctx.scheduler.select(es) for _ in range(4)]
        assert got == [lat[0], lat[1], blk[0], blk[1]]
    finally:
        ctx.fini()


def test_weighted_share_follows_deficit_under_saturation():
    """Once the heavy tenant has consumed its weighted share, the
    light tenant's deficit boost overtakes the weight bias — weighted
    fair share, not absolute priority."""
    ctx, fair, pool_lat, pool_blk = _fairness_ctx()
    try:
        es = ctx.execution_streams[0]
        # latency has completed 80 weight-normalized units (v=10),
        # bulk none (v=0): bulk is now the starved tenant
        fair.note_done("latency", 80)
        assert fair.boost_of_tenant("bulk") > fair.boost_of_tenant("latency")
        lat = _tenant_tasks(pool_lat, 1)
        blk = _tenant_tasks(pool_blk, 1)
        schedule(es, [lat[0], blk[0]])
        assert ctx.scheduler.select(es) is blk[0]
        assert ctx.scheduler.select(es) is lat[0]
    finally:
        ctx.fini()


def test_no_starvation_of_low_weight_tenant():
    """A weight-1 tenant sharing with a saturating weight-8 tenant must
    still be served: every completion charged to the heavy tenant
    raises the light tenant's deficit boost monotonically until it
    wins."""
    ctx, fair, pool_lat, pool_blk = _fairness_ctx()
    try:
        es = ctx.execution_streams[0]
        popped_bulk = False
        for _round in range(64):
            lat = _tenant_tasks(pool_lat, 1)
            blk = _tenant_tasks(pool_blk, 1)
            schedule(es, [lat[0], blk[0]])
            first = ctx.scheduler.select(es)
            second = ctx.scheduler.select(es)
            assert {first, second} == {lat[0], blk[0]}
            if first is blk[0]:
                popped_bulk = True
                break
            # the heavy tenant keeps winning AND completing
            fair.note_done("latency", 1)
        assert popped_bulk, "low-weight tenant starved for 64 rounds"
    finally:
        ctx.fini()


def test_fifo_within_tenant_across_batches():
    """Tasks of one tenant stamped in separate batches (no completion
    in between: boost unchanged) keep FIFO order — the fairness fold
    must not perturb the scheduler's within-priority invariant."""
    ctx, fair, pool_lat, _pool_blk = _fairness_ctx()
    try:
        es = ctx.execution_streams[0]
        first = _tenant_tasks(pool_lat, 1)[0]
        schedule(es, [first])
        second = _tenant_tasks(pool_lat, 1)[0]
        schedule(es, [second])
        assert first.priority == second.priority
        assert ctx.scheduler.select(es) is first
        assert ctx.scheduler.select(es) is second
    finally:
        ctx.fini()


def test_foreign_pool_ranks_with_lowest_tenant():
    """Pools the server does not own get boost 0 — the same floor the
    least-entitled tenant sits on, so foreign workloads compete there
    instead of starving behind every serve pool."""
    ctx, fair, pool_lat, _pool_blk = _fairness_ctx()
    try:
        es = ctx.execution_streams[0]
        foreign = _mk_tasks([5])     # _FakePool id 0: unknown to fair
        lat = _tenant_tasks(pool_lat, 1)
        schedule(es, [foreign[0], lat[0]])
        # latency's weight bias outranks the foreign static-5 (packed
        # above the class band) but the foreign task still pops second,
        # not never
        assert ctx.scheduler.select(es) is lat[0]
        assert ctx.scheduler.select(es) is foreign[0]
        assert fair.boost_of_task(foreign[0]) == 0
        assert lat[0].priority == \
            fair.boost_of_tenant("latency") * TENANT_PRIO_SCALE
    finally:
        ctx.fini()


def test_mempool_quota_admission_rejection():
    """Declared-bytes quota + bound named-Mempool outstanding bytes
    both count at admission; reject policy raises, release re-admits."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.core.mempool import Mempool
    from parsec_tpu_torch.serve import AdmissionError, SessionServer

    ctx = _ctx("ap", cores=2)
    srv = SessionServer(ctx)
    try:
        srv.open_tenant("t", quota_bytes=1000)
        mp = Mempool(lambda: bytearray(100), name="SERVE_T_Q")
        srv.bind_mempool("t", mp, 100)
        held = [mp.allocate() for _ in range(8)]   # 800 bytes outstanding

        def build():
            return dtd.taskpool_new()

        # 800 (mempool) + 300 (declared) > 1000 -> rejected
        with pytest.raises(AdmissionError):
            srv.submit("t", build, nbytes=300)
        # a rejected submission must not leak accounting
        assert srv.stats()["tenants"]["t"]["used_bytes"] == 800
        # freeing mempool items re-admits the same declaration
        for elt in held[:4]:
            mp.free(elt)
        sub = srv.submit("t", build, nbytes=300)
        assert sub.wait(20) and sub.error is None
        assert srv.stats()["tenants"]["t"]["used_bytes"] == 400
        mp.unregister_gauges()
    finally:
        srv.close()
        ctx.fini()


def test_queue_policy_defers_over_quota_submission():
    """serve_admission=queue: the over-cap submission parks in the
    tenant's FIFO and launches when an in-flight pool retires."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.serve import SessionServer

    ctx = _ctx("ap", cores=2)
    srv = SessionServer(ctx, admission="queue")
    try:
        srv.open_tenant("t", max_pools=1)
        gate = threading.Event()

        def blocked_build():
            tp = dtd.taskpool_new()

            def body(es, task):
                gate.wait(20)
            tp.insert_task(body)
            return tp

        def quick_build():
            return dtd.taskpool_new()

        first = srv.submit("t", blocked_build)
        second = srv.submit("t", quick_build)   # over max_pools: queued
        assert srv.stats()["tenants"]["t"]["queued"] == 1
        assert not second.done.is_set()
        gate.set()
        assert first.wait(20) and second.wait(20)
        assert first.error is None and second.error is None
        assert srv.stats()["tenants"]["t"]["queued"] == 0
        assert srv.stats()["tenants"]["t"]["pools_done"] == 2
    finally:
        srv.close()
        ctx.fini()


def test_no_hook_keeps_static_priorities():
    """No server and no class profile (``sched_dynamic_priority`` off):
    stamping leaves every priority as it was (the fast path is one early
    return)."""
    from parsec_tpu_torch.utils.params import params
    with params.cmdline_override("sched_dynamic_priority", "0"):
        ctx = _ctx("spq")
    try:
        assert ctx.serve_fairness is None and ctx.class_profile is None
        tasks = _mk_tasks([3, 1, 7])
        stamp_dynamic_priority(ctx, tasks)
        assert [t.priority for t in tasks] == [3, 1, 7]
    finally:
        ctx.fini()


@pytest.mark.parametrize("sched", ["ap", "spq"])
def test_pop_order_matches_jax_package(sched):
    """The same tenants, completions and interleaved arrivals through
    both packages' fairness folds and schedulers pop in the same order
    with the same stamped priorities."""
    import parsec_tpu
    from parsec_tpu.runtime.scheduling import schedule as jax_schedule
    from parsec_tpu.runtime.taskpool import Task as JaxTask
    from parsec_tpu.runtime.taskpool import TaskClass as JaxTaskClass
    from parsec_tpu.serve import TenantFairness as JaxFairness
    from parsec_tpu_torch.serve import TenantFairness

    def run(init, fair_cls, task_cls, tc_cls, sched_fn, **kw):
        ctx = init(nb_cores=1, scheduler=sched, **kw)
        try:
            fair = fair_cls()
            for name, w, tp_id in (("a", 4, 1), ("b", 1, 2), ("c", 2, 3)):
                fair.register(name, w)
                fair.bind_pool(tp_id, name)
            ctx.serve_fairness = fair
            es = ctx.execution_streams[0]
            pools = [_TenantPool(i) for i in (1, 2, 3, 9)]
            order = []
            for rnd, done in enumerate((("a", 12), ("c", 5), ("b", 1),
                                        ("a", 30))):
                tc = tc_cls("T", 0, 0)
                tasks = [task_cls(pools[(rnd + i) % 4], tc, (rnd, i),
                                  priority=i % 3) for i in range(8)]
                sched_fn(es, tasks)
                order += [(t.key, t.priority) for t in
                          (ctx.scheduler.select(es) for _ in tasks)]
                fair.note_done(*done)
            return order
        finally:
            ctx.fini()

    got = run(parsec_tpu_torch.init, TenantFairness, Task, TaskClass,
              schedule, device="cpu")
    ref = run(parsec_tpu.init, JaxFairness, JaxTask, JaxTaskClass,
              jax_schedule, enable_tpu=False)
    assert got == ref
