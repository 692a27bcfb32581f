"""ft — the fault-tolerance subsystem (detection, injection, recovery).

The reference has NO runtime-level recovery (SURVEY.md §5.4:
checkpointing "absent"), and without this subsystem a dead peer is
noticed only when a TCP send to it happens to fail — a rank that went
silent mid-rendezvous hangs termination detection forever. At the job
lengths the source paper targets ("Large Scale Distributed Linear
Algebra With Tensor Processing Units", arXiv:2112.09017 — multi-hour
tile factorizations), mean-time-to-failure is shorter than job time,
so the runtime itself must detect, tolerate, and recover. Four
pillars, as in the JAX package:

- :mod:`ft.detector` — **proactive failure detection**: heartbeat
  probes riding the comm engines (wire-level ``K_PING``/``K_PONG``
  frames on TCP, answered by the receiver thread; ``TAG_HEARTBEAT``
  active messages on the in-process fabric), per-peer liveness by
  plain timeout or phi-accrual-style EWMA, eviction funneled through
  the transport-uniform ``CommEngine.report_peer_failure``.
- :mod:`ft.inject` — **deterministic fault injection**: a seeded chaos
  layer (``--mca ft_inject "kill:rank=1:after=3,drop:pct=2:seed=7"``)
  that kills a rank at a task boundary, drops/duplicates/delays/fails
  sends at the wire layer — robustness is testable in-process, no real
  process kills needed.
- :mod:`ft.restart` — **checkpoint-integrated restart**: a policy
  driver wrapping the taskpool-boundary snapshots of
  ``utils/checkpoint`` — snapshot every K taskpools; on failure either
  abort cleanly or roll back to the last snapshot and re-run with
  bounded, backed-off retries. Snapshots pull the newest tile copies
  from the card.
- :mod:`ft.elastic` — **elastic grid recovery**: cross-grid checkpoint
  reshard (``reshard_restore`` — a snapshot written on any rank count /
  process grid lands on the current one via
  ``collections/redistribute``), and in-world grid RESIZE — with
  ``ft_elastic=shrink`` the survivors of a rank loss agree on a
  reduced grid over ``TAG_ELASTIC``/``K_ELASTIC`` membership frames,
  rebuild, reshard, and replay from the last snapshot; with ``grow``
  late-arriving ranks are folded in at stage boundaries. Like the JAX
  package's, it acts on hard failures (a peer's ``RankFailedError``)
  only.

Knobs: ``ft_heartbeat_interval``, ``ft_heartbeat_timeout``,
``ft_detector_mode``, ``ft_inject``, ``ft_restart_policy``,
``ft_elastic``, ``ft_elastic_grow_min``, ``ft_elastic_timeout``.
"""
from __future__ import annotations

from .detector import (FT_HB_RTT_PREFIX, FT_PEER_ALIVE, HeartbeatDetector,
                       maybe_install_detector)
from .elastic import (ElasticBlockCyclic, ElasticCoordinator, ElasticError,
                      ElasticPolicy, GridSpec, maybe_install_elastic,
                      plan_grid, reshard_restore)
from .inject import (FaultInjector, FTInjectModule, InjectedKill,
                     InjectedTaskFault)
from .restart import RestartPolicy, run_with_restart

__all__ = [
    "HeartbeatDetector", "maybe_install_detector",
    "FT_PEER_ALIVE", "FT_HB_RTT_PREFIX",
    "FaultInjector", "FTInjectModule", "InjectedKill", "InjectedTaskFault",
    "RestartPolicy", "run_with_restart",
    "ElasticBlockCyclic", "ElasticCoordinator", "ElasticError",
    "ElasticPolicy", "GridSpec", "maybe_install_elastic", "plan_grid",
    "reshard_restore",
]
