"""Recursive task calls: a task body spawns a nested taskpool and completes
only when it terminates.

Reference behavior: ``parsec_recursivecall`` submits a nested taskpool on
behalf of the running task; the task's hook returns ASYNC, and the nested
pool's completion callback finishes the generator task (ref:
parsec/recursive.h:44-70, callback ``parsec_recursivecall_callback``).
The completion is deferred to a scheduler thread via ``Context.defer`` —
termination detection may fire on any thread, and ``complete_execution``
needs a live execution stream (ref: HOOK_RETURN_ASYNC re-entry,
scheduling.c:503-506).

Typical use (the reference's pattern: a too-large tile kernel re-expressed
over sub-tiles, ref: parsec/data_dist/matrix/subtile.c):

    def potrf_body(es, task):
        (tile,) = unpack_args(task)
        sub = SubtileView(tile, smaller_nb, smaller_nb)
        return recursive_call(es, task, dpotrf_taskpool(sub))
"""
from __future__ import annotations

from typing import Callable, Optional

from .taskpool import HookReturn, Task, Taskpool

__all__ = ["recursive_call"]


def recursive_call(es, task: Task, subpool: Taskpool,
                   callback: Optional[Callable] = None) -> HookReturn:
    """Enqueue ``subpool``; when it completes, run ``callback(subpool,
    task)`` (if given) and complete ``task``. Returns ``HookReturn.ASYNC``
    for the body to return, so the runtime does not complete the task now."""
    ctx = task.taskpool.context
    if ctx is None:
        raise RuntimeError("recursive_call before context.add_taskpool")
    prev_cb = subpool.on_complete

    def done(sub_tp):
        if prev_cb is not None:
            prev_cb(sub_tp)

        def finish(wes):
            from .scheduling import complete_execution
            # subtile views (or any collection with a pull_home protocol)
            # fold device results back into the parent tile before the
            # generator task is declared complete
            for v in getattr(sub_tp, "global_env", {}).values():
                if hasattr(v, "pull_home"):
                    v.pull_home(ctx.devices)
            if callback is not None:
                callback(sub_tp, task)
            complete_execution(wes, task)

        ctx.defer(finish)

    subpool.on_complete = done
    ctx.add_taskpool(subpool)
    # DTD sub-pools: all inserts were buffered before this call; seal so
    # the pool terminates without a blocking wait()
    seal = getattr(subpool, "seal", None)
    if seal is not None:
        seal()
    return HookReturn.ASYNC
