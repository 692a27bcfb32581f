"""Compound taskpools: run several taskpools sequentially as one.

Reference behavior: ``parsec_compose(start, next)`` chains two taskpools
into a compound whose parts execute one after the other; composing onto an
existing compound appends (ref: parsec/compound.c:13-30). The compound
itself holds no tasks — it enqueues part i+1 from part i's completion
callback and terminates after the last part.
"""
from __future__ import annotations

from typing import List

from .taskpool import Taskpool

__all__ = ["CompoundTaskpool", "compose"]


class CompoundTaskpool(Taskpool):
    def __init__(self, parts: List[Taskpool]) -> None:
        super().__init__(name="compound")
        self.parts: List[Taskpool] = list(parts)
        self._idx = 0
        self.startup_hook = self._startup

    def _startup(self, context, tp):
        # one pending action keeps the compound alive across the chain
        # (it owns no tasks of its own)
        self.add_pending_action()
        self._launch_next(context)
        return []

    def _launch_next(self, context) -> None:
        if self._idx >= len(self.parts):
            self.pending_action_done()
            return
        sub = self.parts[self._idx]
        self._idx += 1
        prev_cb = sub.on_complete

        def chained(done_tp):
            if prev_cb is not None:
                prev_cb(done_tp)
            self._launch_next(context)

        sub.on_complete = chained
        context.add_taskpool(sub)
        # pools with an explicit end-of-insertion protocol (DTD) must be
        # sealed: nobody calls their blocking wait() inside a chain
        seal = getattr(sub, "seal", None)
        if seal is not None:
            seal()


def compose(start: Taskpool, next_tp: Taskpool) -> CompoundTaskpool:
    """Chain ``next_tp`` after ``start``; both must not be enqueued yet.
    If ``start`` is already a compound, ``next_tp`` is appended in place
    (ref: parsec_compose appending to an existing compound)."""
    if start.context is not None or next_tp.context is not None:
        raise ValueError("compose() operands must not be enqueued yet")
    if isinstance(start, CompoundTaskpool):
        start.parts.append(next_tp)
        return start
    return CompoundTaskpool([start, next_tp])
