"""The progress engine: select → prepare_input → execute → complete → release.

Reference behavior: the worker-thread main loop ``__parsec_context_wait``
(select with scheduler, exponential backoff when idle), task progress
``__parsec_task_progress`` (prepare_input may return ASYNC; execute walks the
incarnation list honoring ``evaluate`` vetoes; CPU hooks run inline while
accelerator hooks hand off and return ASYNC), completion runs the generated
``release_deps`` which feeds freshly-enabled tasks back to ``__parsec_schedule``
— keeping the single highest-priority one on the releasing thread
(ref: parsec/scheduling.c:124-203, 284-328, 439-533, 535-666, 610-615).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..utils import logging as plog
from ..utils.params import params
from ..profiling.grapher import grapher
from ..profiling.pins import PINS, PinsEvent
from ..profiling.sde import TASKS_ENABLED, TASKS_RETIRED
from .profile import TENANT_PRIO_SCALE
from .taskpool import HookReturn, Task, TaskStatus, ACTION_RELEASE_ALL

_sched_log = plog.sched_stream

#: declared lock discipline, enforced by the concurrency lint
#: (the JAX package's analysis/lock_check.py).  The audit result for this
#: module is deliberately EMPTY: the progress loop owns no locked
#: shared state — ``es.next_task`` and the backoff are worker-private,
#: taskpool counters delegate to the termination detector, and the
#: scheduler queues are declared in sched/modules.py (rnd) or ride the
#: internally-synchronized containers of core/lists.py.  Keeping the
#: (empty) map here keeps the module inside the lint's contract: any
#: future lock added to this file must register its fields or fail the
#: tier-1 self-lint gate's review convention.
_GUARDED_BY: Dict[str, str] = {}


class ExecutionStream:
    """Per-worker execution stream (ref: parsec_execution_stream_t)."""

    def __init__(self, context, th_id: int, vp_id: int = 0,
                 vp_local_id: int = 0) -> None:
        self.context = context
        self.th_id = th_id
        self.vp_id = vp_id
        self.vp_local_id = vp_local_id  # position within the VP's stream list
        self.next_task: Optional[Task] = None   # scheduler-bypass slot
        self.sched_obj: Any = None               # scheduler-private queues
        self.rnd_seed = (th_id * 2654435761) & 0xFFFFFFFF
        self.profiling_stream = None
        self.nb_tasks_executed = 0

    @property
    def virtual_process(self):
        return self.context.vps[self.vp_id]

    def rand(self) -> int:
        # xorshift for scheduler tie-breaks / steal targets
        x = self.rnd_seed or 0x9E3779B9
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self.rnd_seed = x
        return x


def stamp_dynamic_priority(ctx, tasks: List[Task]) -> None:
    """Critical-path-driven priorities: re-stamp each task's
    scheduling priority from the online class profile's upward-rank
    boost, with the DSL's static priority expression as the tiebreak
    (``runtime/profile.py``).  Idempotent — recomputed from the task's
    immutable ``base_priority`` — so a rescheduled (AGAIN) task is not
    boosted twice, and a no-op when ``sched_dynamic_priority`` is off
    or the class is unknown to the profile.

    Multi-tenant fairness (serve/) folds on TOP through the same seam:
    when a SessionServer attached a ``TenantFairness`` to the context,
    each task additionally gains its tenant's deficit boost packed above
    the class-profile band (TENANT_PRIO_SCALE), so starved tenants rise
    and saturating tenants yield while the critical-path boost stays the
    within-tenant order.  Both hooks None (no profile, no server) keeps
    the fast path: one early return."""
    prof = ctx.class_profile
    fair = ctx.serve_fairness
    if prof is None and fair is None:
        return
    for t in tasks:
        p = (prof.effective(t.task_class.name, t.base_priority)
             if prof is not None else t.base_priority)
        if fair is not None:
            b = fair.boost_of_task(t)
            if b:
                p += b * TENANT_PRIO_SCALE
        t.priority = p


def schedule(es: ExecutionStream, tasks: List[Task], distance: int = 0) -> None:
    """ref: __parsec_schedule (scheduling.c:284-328) — hand a ring of ready
    tasks to the scheduler module; paranoid checks that every task really is
    ready (all input refs fulfilled)."""
    if not tasks:
        return
    ctx = es.context
    stamp_dynamic_priority(ctx, tasks)
    if __debug__:
        for t in tasks:
            assert t.status in (TaskStatus.NONE, TaskStatus.PREPARE_INPUT), \
                f"scheduling task {t.snprintf()} in state {t.status}"
    PINS(es, PinsEvent.SCHEDULE_BEGIN, tasks)
    ctx.scheduler.schedule(es, tasks, distance)
    PINS(es, PinsEvent.SCHEDULE_END, tasks)
    ctx.sde.inc(TASKS_ENABLED, len(tasks))
    ctx.wake_workers(len(tasks))


def schedule_keep_best(es: ExecutionStream, tasks: List[Task], distance: int = 0) -> None:
    """Keep the highest-priority freshly-enabled task on the releasing thread
    (es.next_task) and hand the rest to the scheduler
    (ref: scheduling.c:610-615, parsec_internal.h:463-470)."""
    if not tasks:
        return
    # stamp BEFORE picking the bypass task so "highest priority" and the
    # scheduler's queue order agree on the same (dynamic) priority
    stamp_dynamic_priority(es.context, tasks)
    if es.context.keep_highest_priority_task and es.next_task is None:
        best = max(range(len(tasks)), key=lambda i: tasks[i].priority)
        es.next_task = tasks.pop(best)
        es.context.sde.inc(TASKS_ENABLED, 1)  # bypasses schedule()'s count
    schedule(es, tasks, distance)


def execute(es: ExecutionStream, task: Task) -> HookReturn:
    """ref: __parsec_execute (scheduling.c:124-203) — walk incarnations by
    chore mask; evaluate() may veto a chore; the first willing hook runs."""
    tc = task.task_class
    task.status = TaskStatus.HOOK
    PINS(es, PinsEvent.EXEC_BEGIN, task)
    try:
        for idx in tc.chore_order():
            chore = tc.incarnations[idx]
            if not (task.chore_mask & (1 << idx)):
                continue
            if chore.evaluate is not None and not chore.evaluate(task):
                continue
            task.selected_chore = idx
            rc = chore.hook(es, task)
            if rc == HookReturn.NEXT:
                task.chore_mask &= ~(1 << idx)
                continue
            if rc == HookReturn.DISABLE:
                task.chore_mask &= ~(1 << idx)
                continue
            return rc
        plog.warning("task %s has no eligible chore left", task.snprintf())
        return HookReturn.ERROR
    finally:
        PINS(es, PinsEvent.EXEC_END, task)


def complete_execution(es: ExecutionStream, task: Task) -> None:
    """ref: __parsec_complete_execution (scheduling.c:439-468)."""
    tc = task.task_class
    task.status = TaskStatus.COMPLETE
    PINS(es, PinsEvent.COMPLETE_EXEC_BEGIN, task)
    if tc.prepare_output is not None:
        tc.prepare_output(es, task)
    if tc.complete_execution is not None:
        tc.complete_execution(es, task)
    if tc.release_deps is not None:
        PINS(es, PinsEvent.RELEASE_DEPS_BEGIN, task)
        ready = tc.release_deps(es, task, ACTION_RELEASE_ALL)
        PINS(es, PinsEvent.RELEASE_DEPS_END, task)
    else:
        ready = []
    es.nb_tasks_executed += 1
    es.context.sde.inc(TASKS_RETIRED)
    grapher.task_executed(es, task)
    tp = task.taskpool
    if tc.release_task is not None:
        tc.release_task(es, task)
    tp.task_completed()
    if ready:
        schedule_keep_best(es, list(ready))
    PINS(es, PinsEvent.COMPLETE_EXEC_END, task)


def task_progress(es: ExecutionStream, task: Task, distance: int = 0) -> None:
    """ref: __parsec_task_progress (scheduling.c:470-533)."""
    tc = task.task_class
    if task.status < TaskStatus.PREPARE_INPUT:
        task.status = TaskStatus.PREPARE_INPUT
        if tc.prepare_input is not None:
            PINS(es, PinsEvent.PREPARE_INPUT_BEGIN, task)
            rc = tc.prepare_input(es, task)
            PINS(es, PinsEvent.PREPARE_INPUT_END, task)
            if rc == HookReturn.ASYNC:
                return  # a future/stage-in will reschedule the task
            if rc == HookReturn.AGAIN:
                schedule(es, [task], distance + 1)
                return
            assert rc == HookReturn.DONE, f"prepare_input returned {rc}"
    prof = es.context.class_profile
    t0 = time.perf_counter_ns() if prof is not None else 0
    rc = execute(es, task)
    if rc == HookReturn.DONE:
        if prof is not None:
            # synchronous (CPU-chore) execution: feed the class profile
            # with the measured body time — the host half of the
            # duration-weighted EWMA (the device half comes from the
            # device module's dispatch timings)
            prof.note(tc.name, (time.perf_counter_ns() - t0) / 1e3)
        complete_execution(es, task)
    elif rc == HookReturn.ASYNC:
        pass  # device module owns completion now (SURVEY.md §3.4)
    elif rc == HookReturn.AGAIN:
        task.status = TaskStatus.PREPARE_INPUT
        schedule(es, [task], distance + 1)
    else:
        plog.fatal("task %s execution failed (rc=%s)", task.snprintf(), rc)


class _Backoff:
    """Exponential idle backoff (ref: scheduling.c idle loop + utils/backoff)."""

    __slots__ = ("misses",)
    MAX_SLEEP = 2e-3

    def __init__(self) -> None:
        self.misses = 0

    def hit(self) -> None:
        self.misses = 0

    def miss(self, context) -> None:
        self.misses += 1
        if self.misses < 4:
            return  # spin
        sleep = min(1e-5 * (1 << min(self.misses - 4, 8)), self.MAX_SLEEP)
        context.park(sleep)


def es_rusage_report(es: ExecutionStream) -> dict:
    """Per-ES thread resource usage delta since the last call on the SAME
    OS thread (ref: the per-ES getrusage reports, scheduling.c:45-90);
    logged at verbosity >= 3 from each wait-loop exit. Baselines are kept
    per calling thread: ES 0 runs on whichever thread drives wait(), so a
    baseline from another thread must not pollute the delta. maxrss_kb is
    reported as the absolute process high-water mark (getrusage has no
    per-thread rss)."""
    import resource
    ru = resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                    resource.RUSAGE_SELF))
    tid = threading.get_ident()
    cur = {"utime_s": ru.ru_utime, "stime_s": ru.ru_stime,
           "vcsw": ru.ru_nvcsw, "ivcsw": ru.ru_nivcsw,
           "minflt": ru.ru_minflt, "maxrss_kb": ru.ru_maxrss}
    prevs = getattr(es, "_last_rusage", None)
    if prevs is None:
        prevs = es._last_rusage = {}
    prev = prevs.get(tid)
    prevs[tid] = cur
    if prev is None:
        return dict(cur)
    out = {k: cur[k] - prev[k] for k in cur if k != "maxrss_kb"}
    out["maxrss_kb"] = cur["maxrss_kb"]
    return out


def context_wait_loop(es: ExecutionStream) -> None:
    """The worker main loop (ref: __parsec_context_wait scheduling.c:535-666).

    Runs until the context signals completion of all active taskpools.
    Idle cycles progress device managers and the communication engine.
    """
    ctx = es.context
    backoff = _Backoff()
    busy_spins = 0
    while not ctx.all_tasks_done():
        task = es.next_task
        es.next_task = None
        if task is None:
            PINS(es, PinsEvent.SELECT_BEGIN, None)
            task = ctx.scheduler.select(es)
            PINS(es, PinsEvent.SELECT_END, task)
        try:
            if task is not None:
                backoff.hit()
                task_progress(es, task)
                # bounded device poll on the BUSY path: a sub-batch-max
                # accumulation on a device must not starve behind a
                # long run of CPU-bound tasks that never lets this
                # worker reach the idle-cycle engine progress (an empty
                # device queue makes this a try-lock + two list checks)
                busy_spins += 1
                if busy_spins & 63 == 0:
                    for dev in ctx.devices:
                        dev.progress(es)
                continue
            # idle cycle: the device managers flush their accumulated
            # ready batches and retire finished launches (SURVEY.md §3.4);
            # engines before native loops: a claimed native loop owns
            # this worker for a whole lowered DAG, and the device
            # managers' accumulated ready batches must flush first
            progressed = ctx.progress_engines(es)
            if ctx.run_native_loops(es):
                backoff.hit()
                continue
        except BaseException as exc:  # a task body blew up: abort the DAG,
            ctx.record_task_error(exc, task)  # don't silently kill the worker
            continue
        if progressed:
            backoff.hit()
        else:
            backoff.miss(ctx)
    if plog.debug.verbosity >= 3:
        plog.debug.verbose(3, "es %d rusage: %s", es.th_id,
                           es_rusage_report(es))
