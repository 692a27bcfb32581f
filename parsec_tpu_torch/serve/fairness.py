"""Weighted deficit fair-share boosts for multi-tenant serving.

``TenantFairness`` turns per-tenant completion accounting into the
priority boosts that ``stamp_dynamic_priority`` (runtime/scheduling.py)
folds ABOVE the class-profile band: each tenant accrues virtual runtime
``v_t = completed_tasks / weight``, and a tenant whose ``v_t`` lags the
front-runner earns a boost proportional to the lag.  A saturating
tenant's ``v_t`` races ahead (its boost decays to the floor), a starved
tenant's lags (its boost rises without bound up to the clamp) — the
deficit-round-robin invariant, expressed as priorities the untouched
ap/spq/pbq schedulers consume unchanged.

Design constraints inherited from the restamping seam:

- charging happens at pool COMPLETION (``note_done``), never at stamp
  time, so restamping the same ready set twice is idempotent;
- every queued task of one tenant shares one boost, so FIFO order
  *within* a tenant is exactly what the scheduler's priority tie-break
  already provides;
- ``boost_of_task`` is called on the scheduler hot path under no lock:
  it reads two plain dicts (``_pools``, ``_boost``) that are only ever
  rebound/assigned whole — the GIL makes each read atomic, and a stale
  boost merely delays fairness by one restamp.

Boosts are normalized so the *lowest* tenant sits at 0: pools the
server does not own (``boost_of_task`` -> 0) compete exactly like the
least-entitled tenant instead of starving behind every serve pool.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

__all__ = ["TenantFairness"]

_GUARDED_BY = {
    "TenantFairness._weight": "_lock",
    "TenantFairness._done": "_lock",
}

#: boost steps per unit of weight-normalized completion lag — coarse
#: enough that single-task jitter does not thrash restamps, fine enough
#: that a starved tenant rises within a few foreign completions
DEFICIT_GRAIN = 4.0
#: lead-term clamp: bounds the packed boost so
#: ``boost * TENANT_PRIO_SCALE`` (scheduling.py) stays well inside an
#: int64 even with the weight bias below it
_LEAD_CLAMP = (1 << 20) - 1
#: weight bias occupies the low 8 bits under the lead term: at equal
#: deficit (e.g. cold start) the heavier tenant wins the tie, which is
#: what gives a weight-8 latency tenant its head start before any
#: completion history exists
_WEIGHT_BIAS_MAX = 255


class TenantFairness:
    """Per-tenant deficit accounting -> cached priority boosts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._weight: Dict[str, int] = {}
        self._done: Dict[str, float] = {}
        # read lock-free on the scheduler hot path; rebound whole under
        # _lock by _recompute_locked (never mutated in place)
        self._boost: Dict[str, int] = {}
        # taskpool_id -> tenant; plain-dict item set/del are GIL-atomic
        self._pools: Dict[Any, str] = {}

    # -- tenant registry ----------------------------------------------------
    def register(self, tenant: str, weight: int) -> None:
        with self._lock:
            self._weight[tenant] = max(1, int(weight))
            self._done.setdefault(tenant, 0.0)
            self._recompute_locked()

    def forget(self, tenant: str) -> None:
        with self._lock:
            self._weight.pop(tenant, None)
            self._done.pop(tenant, None)
            self._recompute_locked()

    def tenants(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._weight)

    # -- pool binding -------------------------------------------------------
    def bind_pool(self, taskpool_id: Any, tenant: str) -> None:
        self._pools[taskpool_id] = tenant

    def release_pool(self, taskpool_id: Any) -> None:
        self._pools.pop(taskpool_id, None)

    def tenant_of(self, taskpool_id: Any) -> Optional[str]:
        return self._pools.get(taskpool_id)

    # -- accounting ---------------------------------------------------------
    def note_done(self, tenant: str, n: int = 1) -> None:
        """Charge ``n`` completed work units (tasks) to ``tenant``.

        Called from the pool-completion hook — worker-thread context,
        so the recompute must stay cheap (it is O(#tenants))."""
        with self._lock:
            if tenant not in self._weight:
                return
            self._done[tenant] = self._done.get(tenant, 0.0) + float(n)
            self._recompute_locked()

    def _recompute_locked(self) -> None:  # holds: self._lock
        if not self._weight:
            self._boost = {}
            return
        v = {t: self._done.get(t, 0.0) / w
             for t, w in self._weight.items()}
        v_max = max(v.values())
        raw: Dict[str, int] = {}
        for t, w in self._weight.items():
            lead = min(_LEAD_CLAMP, int((v_max - v[t]) * DEFICIT_GRAIN))
            raw[t] = lead * (_WEIGHT_BIAS_MAX + 1) + min(w, _WEIGHT_BIAS_MAX)
        floor = min(raw.values())
        # rebind whole: hot-path readers see either the old or the new
        # dict, never a half-updated one
        self._boost = {t: b - floor for t, b in raw.items()}

    # -- scheduler hot path (lock-free) -------------------------------------
    def boost_of_task(self, task: Any) -> int:
        """The fairness boost for one task, 0 for pools the server does
        not own.  Called from ``stamp_dynamic_priority`` for every task
        of every restamp batch — no locks, two dict reads."""
        tp = task.taskpool
        if tp is None:
            return 0
        tenant = self._pools.get(tp.taskpool_id)
        if tenant is None:
            return 0
        return self._boost.get(tenant, 0)

    def boost_of_tenant(self, tenant: str) -> int:
        return self._boost.get(tenant, 0)
