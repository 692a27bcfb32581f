"""The runtime context: init/fini, worker threads, taskpool lifecycle.

Reference behavior: ``parsec_init`` builds the context (MCA params, topology,
vpmap, worker threads parked on a barrier, profiling, comm, devices, data,
scheduler selection); ``parsec_context_add_taskpool`` attaches a termination
detector and runs the startup hook; ``parsec_context_start`` releases the
workers; ``parsec_context_wait`` joins the progress loop until every active
taskpool has terminated (ref: parsec/parsec.c:391-905,
parsec/scheduling.c:535-790; call stacks SURVEY.md §3.1-3.2).

Several ranks run one DAG over a comm engine (comm/): in-process ranks
pass ``comm=RemoteDepEngine(fabric.engine(r))``; rank processes set the
``comm_transport=tcp``, ``comm_endpoints`` and ``comm_rank`` knobs and
``init()`` wires the TCP engine itself (the launcher contract).  Fault
tolerance (ft/) is wired here as in the JAX package: the heartbeat
detector when ``ft_heartbeat_interval`` is set, the elastic membership
coordinator when ``ft_elastic`` is set, the fault injector from
``ft_inject`` (its task-boundary half as a PINS module), and
``clear_task_errors`` for the restart driver's rollback; so are the
debug-history ring (``debug_history_size``) and the live SDE push
(``sde_push``), and telemetry (obs/: ``profile``, ``metrics``,
``obs_flow``, ``obs_live``).  The counterpart of the JAX package's
``jax.distributed`` bootstrap is ``torch.distributed`` over gloo, set up
from the ``dist_coordinator``, ``dist_num_processes`` and
``dist_process_id`` knobs (the distributed wave's multi-process lane
rides it).  Self-tuning and serving are not carried, and a knob asking
for one of them raises NotImplementedError.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import logging as plog
from ..utils.params import params
from ..profiling.grapher import grapher
from ..profiling.sde import PENDING_TASKS, SDERegistry
from ..profiling.trace import Profile
from ..profiling.pins import TaskProfilerModule
from .scheduling import ExecutionStream, context_wait_loop, schedule
from .taskpool import Taskpool
from .termdet import termdet_new
from .vpmap import VPMap, VirtualProcess, default_nb_cores


def _maybe_init_torch_distributed() -> None:
    """``torch.distributed.init_process_group("gloo")`` from the
    ``dist_*`` knobs, so every participating rank process joins ONE
    process group (the JAX package's ``jax.distributed.initialize``
    bootstrap).  Idempotent per process; off unless
    ``dist_coordinator`` is set.  gloo is the only backend: NCCL does
    not run two ranks on one card.  The coordinator's TCP store needs a
    port of its own, apart from the comm engine's listeners."""
    coord = params.get("dist_coordinator")
    if not coord:
        return
    import torch.distributed as dist
    if dist.is_initialized():
        return
    world = int(params.get("dist_num_processes"))
    rank = int(params.get("dist_process_id"))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(
            f"dist_coordinator={coord!r} needs dist_num_processes >= 1 "
            f"and 0 <= dist_process_id < it (got {world}, {rank})")
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=world, rank=rank)


def _comm_from_params():
    """Auto-wire the control-plane comm engine from launcher params
    (each rank process gets PARSEC_MCA_comm_* — the analog of mpiexec
    handing each process its communicator)."""
    transport = params.get("comm_transport")
    eps = params.get("comm_endpoints")
    if not transport or transport in ("none", "0"):
        return None
    if transport != "tcp":
        raise ValueError(f"unknown comm_transport {transport!r} "
                         f"(supported: tcp)")
    if not eps:
        raise ValueError("comm_transport=tcp needs comm_endpoints")
    rank = int(params.get("comm_rank"))
    if rank < 0:
        raise ValueError("comm_transport=tcp needs comm_rank >= 0")
    endpoints = []
    for e in eps.split(","):
        host, port = e.rsplit(":", 1)
        endpoints.append((host, int(port)))
    from ..comm import RemoteDepEngine
    from ..comm.tcp import TCPCommEngine
    return RemoteDepEngine(TCPCommEngine(rank, endpoints))


class Context:
    """ref: parsec_context_t"""

    def __init__(self, nb_cores: Optional[int] = None,
                 argv: Optional[List[str]] = None,
                 scheduler: Optional[str] = None,
                 vpmap: Optional[VPMap] = None,
                 rank: int = 0, nb_ranks: int = 1,
                 comm: Any = None,
                 device: Any = None,
                 profile: bool = False) -> None:
        if argv:
            params.parse_argv(argv)
        # multi-process bootstrap (launcher-provided params): one
        # torch.distributed process group, before the comm engine
        _maybe_init_torch_distributed()
        if comm is None:
            comm = _comm_from_params()
        if comm is None and (nb_ranks != 1 or rank != 0):
            raise ValueError(f"rank={rank}, nb_ranks={nb_ranks} without a "
                             f"comm engine")
        self.rank = rank
        self.nb_ranks = nb_ranks
        self.comm = comm                       # remote-dep driver
        # synchronization state BEFORE comm binding: attach() installs an
        # arrival callback that a peer's thread may fire immediately
        # (in-process fabrics deliver synchronously from the sender) —
        # wake_workers / record_task_error must find these initialized
        self._work_cond = threading.Condition()     # idle park/wake
        # taskpool bookkeeping
        self.taskpools: Dict[int, Taskpool] = {}
        self._task_errors: List[BaseException] = []
        self._active_taskpools = 0
        self._tp_lock = threading.Lock()
        # deferred work: callbacks that must run on a scheduler thread with
        # a live execution stream (e.g. completing a generator task when its
        # nested taskpool terminates — the detection fires on an arbitrary
        # thread; ref: HOOK_RETURN_ASYNC re-entry, scheduling.c:503-506)
        self._deferred: "deque" = deque()
        # native dispatch loops (turbo static PTG): queued by _startup,
        # claimed by ONE worker from the wait loop
        self._native_loops: List[Any] = []
        self._started = False
        self._finalized = False
        # comm binding first: it defines our rank, which profiling and
        # device setup label their output with
        # (ref: parsec_remote_dep_init parsec.c:796)
        if comm is not None:
            comm.attach(self)
            self.rank = comm.rank
            self.nb_ranks = comm.nb_ranks
        # fault tolerance (ft/): proactive heartbeat detection when
        # ft_heartbeat_interval is set, and the task-boundary half of
        # the fault injector when ft_inject has kill/taskfail directives
        self._ft_detector = None
        self._ft_pins = None
        self._ft_elastic = None
        ft_inj = None
        if self.comm is not None:
            from ..ft.detector import maybe_install_detector
            self._ft_detector = maybe_install_detector(self)
            # elastic membership coordinator (ft/elastic.py) when the
            # ft_elastic knob is set — attached AFTER the detector (its
            # evictions wake pending agreements) and before the obs
            # wiring, so a joiner announcing mid-stage reaches a live
            # coordinator; ft.run_with_restart reuses this instance
            from ..ft.elastic import maybe_install_elastic
            self._ft_elastic = maybe_install_elastic(self)
            ft_inj = getattr(getattr(self.comm, "ce", self.comm),
                             "_ft", None)
        if ft_inj is None and params.get("ft_inject"):
            from ..ft.inject import FaultInjector
            ft_inj = FaultInjector.from_spec(params.get("ft_inject"),
                                             rank=self.rank)
        self.ft_injector = ft_inj
        if ft_inj is not None and ft_inj.has_task_actions:
            from ..ft.inject import FTInjectModule
            self._ft_pins = FTInjectModule(ft_inj, self)
            self._ft_pins.enable()
        self.vpmap = vpmap or VPMap.from_flat(nb_cores or default_nb_cores())
        self.nb_cores = self.vpmap.nb_total_threads

        # profiling (ref: parsec.c:706-788)
        prof_prefix = params.get("profile")
        self.profile: Optional[Profile] = None
        self._prof_prefix = None
        self._task_profiler = None
        self._forensics_dumped = False
        if profile or prof_prefix:
            self.profile = Profile(rank=self.rank)
            # files written at fini only when a prefix was configured;
            # profile=True alone keeps the trace in memory for the caller
            self._prof_prefix = prof_prefix or None
            self._task_profiler = TaskProfilerModule(self.profile,
                                                     context=self)
            self._task_profiler.enable()
        # executed-DAG capture (ref: --parsec_dot, parsec.c:596-614)
        self._dot_prefix = params.get("profiling_dot") or None
        if self._dot_prefix:
            grapher.enable()
        # debug history ring (ref: PARSEC_DEBUG_HISTORY, debug_marks.c)
        hist_size = params.get("debug_history_size")
        self._debug_history_on = bool(hist_size)
        if self._debug_history_on:
            from ..utils import debug_history
            debug_history.enable(int(hist_size))

        # virtual processes + execution streams
        self.vps: List[VirtualProcess] = []
        self.execution_streams: List[ExecutionStream] = []
        th_id = 0
        for vp_id, n in enumerate(self.vpmap.nb_threads_per_vp):
            vp = VirtualProcess(vp_id, n)
            self.vps.append(vp)
            for local in range(n):
                es = ExecutionStream(self, th_id, vp_id, vp_local_id=local)
                if self.profile is not None:
                    es.profiling_stream = self.profile.stream(th_id)
                vp.execution_streams.append(es)
                self.execution_streams.append(es)
                th_id += 1

        # devices (ref: parsec_mca_device_init/attach parsec.c:832-837):
        # the host plus the accelerator module, on ``device`` (cuda:0 when
        # None; "cpu" runs the same module over host tensors)
        from ..devices import build_devices
        self.devices = build_devices(self, device=device)
        # mesh ownership: when this rank's accelerator is a chip MESH
        # (device_mesh_shape), expose it so mesh-aware layers reuse the
        # rank's mesh instead of building their own
        self.device_mesh = next(
            (d.mesh for d in self.devices
             if getattr(d, "mesh", None) is not None), None)

        # stage-compile telemetry (stagec/): per-rank counters every
        # StageCompiler on this context accumulates into; exposed as
        # PARSEC::STAGEC::* gauges by ContextObs.  The xstage_* keys
        # count the cross-rank SPMD stages (stagec/xrank.py)
        self.stage_stats = {"stage_compiles": 0, "stage_tasks": 0,
                            "stage_fallbacks": 0, "stage_compile_ns": 0,
                            "stage_dispatches": 0, "stage_sharded": 0,
                            "prestage_issued": 0, "prestage_hits": 0,
                            "chain_links": 0, "chain_fallbacks": 0,
                            "residue_batches": 0,
                            "residue_batch_tasks": 0,
                            "xstage_compiles": 0, "xstage_tasks": 0,
                            "xstage_collective_bytes": 0,
                            "xstage_fallbacks": 0}
        # worker threads, rank threads and the comm path all count
        self.stage_stats_lock = threading.Lock()
        # cross-pool stage chain registry (stagec/chain.declare_chain
        # attaches a ChainState when a pool sequence is declared)
        self._stage_chain = None

        # online critical-path class profile: duration-
        # weighted per-class EWMAs + upward-rank boosts the priority
        # schedulers consume (runtime/profile.py); None = static
        # priorities only (the pre-overlap behavior)
        self.class_profile = None
        if params.get("sched_dynamic_priority"):
            from .profile import ClassProfile
            self.class_profile = ClassProfile()
        # multi-tenant fair-share hook (serve/): a SessionServer attaches
        # its TenantFairness here so stamp_dynamic_priority folds
        # per-tenant deficit boosts above the class-profile band; None
        # (the default — no server) keeps the class-profile-only path
        # byte-identical
        self.serve_fairness = None

        # scheduler (ref: parsec_set_scheduler scheduling.c:246-272)
        from ..sched import sched_new
        name = scheduler or params.get("sched")
        self.scheduler = sched_new(name)
        self.scheduler.install(self)
        for es in self.execution_streams:
            self.scheduler.flow_init(es)
        # SDE gauge: ready-task backlog (ref: per-scheduler PAPI-SDE
        # registration, sched_lfq_module.c:141-151)
        self._pending_gauge = lambda: self.scheduler.pending_tasks(self)
        # per-context registry: each in-process rank keeps its own counts
        # (the reference's registry is per-process, which IS per-rank there)
        self.sde = SDERegistry()
        self.sde.register_poll(PENDING_TASKS, self._pending_gauge)
        # unified telemetry wiring (obs/): metrics registry over ctx.sde,
        # comm/device/ft gauges always, hot-path span hooks only when
        # profiling, ``metrics`` or ``obs_live`` is on
        from ..obs import ContextObs
        self.obs = ContextObs(self)
        self.metrics = self.obs.metrics
        # live telemetry: push SDE snapshots to an aggregator if configured
        # (ref: PAPI-SDE counters feeding tools/aggregator_visu)
        self._sde_pusher = None
        push_addr = params.get("sde_push")
        if push_addr:
            from ..profiling.aggregator import SDEPusher
            from ..profiling.sde import sde as _global_sde
            try:
                self._sde_pusher = SDEPusher(
                    self.sde, push_addr, rank=self.rank,
                    interval=max(0.05,
                                 params.get("sde_push_interval_ms") / 1000.0),
                    extra_sde=_global_sde,
                    # obs_live: ship the rank's health snapshot with each
                    # push so the aggregator can serve a fleet-merged
                    # GET /health
                    health_fn=(self.obs.live.snapshot
                               if self.obs.live is not None else None),
                ).start()
            except ValueError as e:
                # telemetry must never take down the run
                plog.warning("sde_push disabled: %s", e)
        plog.debug.verbose(3, "context: %d threads, %d vps, %d devices, sched=%s",
                           self.nb_cores, len(self.vps), len(self.devices), name)

        # worker threads (all but stream 0, which the caller's thread drives)
        self._start_gen = 0
        self._worker_gen: List[int] = [0] * (self.nb_cores - 1)
        # workers currently inside context_wait_loop (guarded by
        # _work_cond): clear_task_errors waits for this to hit zero so
        # a rollback cannot race a worker still finishing its last task
        self._workers_in_loop = 0
        self._threads: List[threading.Thread] = []
        for i, es in enumerate(self.execution_streams[1:]):
            t = threading.Thread(target=self._worker_main, args=(es, i),
                                 name=f"parsec-es{es.th_id}", daemon=True)
            t.start()
            self._threads.append(t)

        self.keep_highest_priority_task = params.get("runtime_keep_highest_priority_task")

        # optional dedicated funnelled comm-progress thread (ref: the
        # comm thread remote_dep_mpi.c:478, bound via -C): useful when
        # every worker is busy in long device kernels and nobody drains
        # the engine; default off — workers drain during idle cycles
        self._comm_thread = None
        self._comm_thread_stop = threading.Event()
        if self.comm is not None and params.get("comm_thread"):
            self._comm_thread = threading.Thread(
                target=self._comm_thread_main, name="parsec-comm",
                daemon=True)
            self._comm_thread.start()

    # ------------------------------------------------------------------ #
    # taskpool lifecycle                                                 #
    # ------------------------------------------------------------------ #
    def add_taskpool(self, tp: Taskpool) -> None:
        """ref: parsec_context_add_taskpool (scheduling.c:668-735)."""
        assert not self._finalized
        assert tp.context is None, "taskpool already enqueued"
        tp.context = self
        if tp.tdm is None:  # DSL may have attached its own monitor
            kind = params.get("termdet")
            if kind == "fourcounter" and self.comm is not None \
                    and self.nb_ranks > 1:
                tp.tdm = termdet_new("fourcounter", tp, comm=self.comm)
            else:
                tp.tdm = termdet_new("local", tp)
        with self._tp_lock:
            self.taskpools[tp.taskpool_id] = tp
            self._active_taskpools += 1
        for dev in self.devices:
            dev.taskpool_register(tp)
        if self.class_profile is not None:
            # class-level dataflow feeds the upward-rank boosts BEFORE
            # startup tasks are scheduled, so even the first wave is
            # stamped with graph-aware priorities
            self.class_profile.observe_taskpool(tp)
        if self.comm is not None:
            self.comm.taskpool_register(tp)
        # after device+comm registration: DTD's buffered-insert replay may
        # synthesize remote send/recv tasks, which need tp.comm attached
        if tp.on_enqueue is not None:
            tp.on_enqueue(tp)
        if tp.startup_hook is not None:
            startup = list(tp.startup_hook(self, tp) or ())
            if startup:
                # chunked hand-off (ref: task_startup_iter/chunk,
                # parsec.c:688-694): the first chunk lands in the local
                # queues, the rest overflow to the system queue so a huge
                # startup set cannot flood per-thread buffers
                es0 = self.execution_streams[0]
                chunk = max(1, int(params.get("task_startup_chunk") or 0)
                            or len(startup))
                for i in range(0, len(startup), chunk):
                    schedule(es0, startup[i:i + chunk],
                             distance=0 if i == 0 else 1)
        tp.tdm.taskpool_ready()

    def _taskpool_done(self, tp: Taskpool) -> None:
        with self._tp_lock:
            if tp.taskpool_id in self.taskpools:
                del self.taskpools[tp.taskpool_id]
                self._active_taskpools -= 1
        tp.info.clear()  # run per-taskpool info destructors
        self.sample_sde_counters()
        self.wake_workers(self.nb_cores)

    def sample_sde_counters(self) -> None:
        """Snapshot every SDE counter/gauge into the trace as counter
        events (ref: PAPI-SDE counters feeding the live aggregator,
        tools/aggregator_visu; sampled at taskpool boundaries and on
        demand)."""
        if self.profile is None:
            return
        st = self.profile.stream(0)
        for name, value in self.sde.snapshot().items():
            try:
                st.counter(name, float(value))
            except (TypeError, ValueError):
                continue

    def all_tasks_done(self) -> bool:
        """ref: all_tasks_done (scheduling.c:218-221)."""
        return self._active_taskpools == 0 or bool(self._task_errors)

    def record_task_error(self, exc: BaseException, task=None) -> None:
        """A task body raised: abort the DAG and surface on the waiter."""
        plog.warning("task %s raised: %r",
                     task.snprintf() if task is not None else "<progress>", exc)
        from ..utils import debug_history
        if debug_history.enabled():
            debug_history.history.mark(
                "TASK_ERROR", f"{task.snprintf() if task else '<progress>'}: "
                              f"{exc!r}")
            plog.warning("%s", debug_history.history.dump(limit=64))
        self._task_errors.append(exc)
        # a dead rank's tasks/actions can never settle, so waiting on
        # the detectors is a guaranteed hang — abort every active pool
        # NOW, which also unblocks taskpool-level waiters (DTD tp.wait)
        # that do not consult the context's error list
        from ..comm.engine import RankFailedError
        if isinstance(exc, RankFailedError):
            with self._tp_lock:
                pools = list(self.taskpools.values())
            for tp in pools:
                tp.abort()
            # failure forensics: under an active file-backed profile, a
            # rank-failure abort flight-records its trace NOW — fini may
            # never run cleanly on an aborting fleet, and a post-mortem
            # per rank can still be merged
            self.dump_forensics(reason=repr(exc))
        # no count argument: a transport thread may report a dead peer
        # during comm.attach() in __init__, before nb_cores is set
        self.wake_workers()

    def clear_task_errors(self) -> List[BaseException]:
        """FT restart support (ft/restart.py): drop recorded errors and
        every aborted taskpool's leftovers — scheduler queues, worker
        bypass slots, deferred callbacks, the device modules' ready
        queues and in-flight windows — so a rolled-back re-run can be
        enqueued on this same context. Returns the drained errors.

        QUIESCES the workers FIRST: ``wait()`` returns the moment the
        error is recorded, but a worker can still be mid-task — its
        in-place tile write, successor scheduling, or a late
        record_task_error must not land AFTER this drain (a stale
        error would instantly poison the retried stage). The recorded
        errors keep ``all_tasks_done`` true while we wait, so every
        worker drops out of its loop and parks; only then are the
        errors, pools, and queues drained."""
        with self._work_cond:
            ok = self._work_cond.wait_for(
                lambda: self._workers_in_loop == 0, timeout=10.0)
        if not ok:  # pragma: no cover - a wedged task body
            plog.warning("ft: %d worker(s) still busy after 10s; "
                         "rollback may race their last task",
                         self._workers_in_loop)
        # device pipelines BEFORE the error drain: retiring a window
        # entry of the aborted DAG can record one more (stale) error,
        # and the accumulated ready queues hold undispatched tasks of
        # the dead DAG that must never execute against the restored
        # collections
        self._drain_devices()
        with self._tp_lock:
            errors = list(self._task_errors)
            self.taskpools.clear()
            self._active_taskpools = 0
            self._task_errors.clear()
        drained = 0
        for es in self.execution_streams:
            es.next_task = None
            # drain through EVERY stream: per-thread schedulers (lhq,
            # ltq, ...) keep private buffers a select() through es0
            # alone would never reach — a stale ready task surviving
            # here would mutate the restored collections on the re-run
            while self.scheduler.select(es) is not None:
                drained += 1   # stale ready tasks of the aborted DAG
        self._deferred.clear()
        if drained:
            plog.debug.verbose(2, "ft: dropped %d stale ready task(s) "
                               "from the aborted DAG", drained)
        return errors

    def raise_pending_error(self) -> None:
        if self._task_errors:
            exc = self._task_errors[0]
            raise RuntimeError("a task body failed; DAG aborted") from exc

    # ------------------------------------------------------------------ #
    # start / test / wait                                                #
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        """Release the workers (ref: parsec_context_start scheduling.c:740)."""
        if self._started:
            return
        self._started = True
        with self._work_cond:
            self._start_gen += 1
            self._work_cond.notify_all()

    def test(self) -> bool:
        """Non-blocking completion probe (ref: parsec_context_test)."""
        return self.all_tasks_done()

    def wait(self) -> None:
        """Caller joins the progress loop on stream 0 until all taskpools
        terminate (ref: parsec_context_wait scheduling.c:766-790)."""
        self.start()
        es0 = self.execution_streams[0]
        # the reference binds EVERY ES including the master: pin the
        # caller's thread for the duration of the loop, then restore
        # (it is an application thread, not ours to keep pinned)
        from .vpmap import bind_current_thread, binding_for
        core = binding_for(0, self.nb_cores)
        prev_affinity = None
        if core is not None:
            try:
                import os as _os
                prev_affinity = _os.sched_getaffinity(0)
            except (AttributeError, OSError):
                prev_affinity = None
            bind_current_thread(core)
        try:
            context_wait_loop(es0)
        finally:
            if prev_affinity is not None:
                try:
                    import os as _os
                    _os.sched_setaffinity(0, prev_affinity)
                except (AttributeError, OSError):
                    pass
        self._started = False
        # retire the devices' trailing in-flight window records: the
        # DAGs are done, and leftover records would pin the final
        # tasks' object graphs (taskpool -> collections -> copies)
        # until some future taskpool's progress
        self._drain_devices()
        self.raise_pending_error()

    def _drain_devices(self) -> None:
        """Drain every device's pipeline: retire trailing in-flight
        window entries (recording any async kernel error on this
        context) and discard ready-queue entries a DAG abort left
        undispatched (batched dispatch accumulates ready tasks between
        manager flushes, so an abort can strand them there)."""
        for dev in self.devices:
            drain = getattr(dev, "drain", None)
            if drain is not None:
                drain(self)

    def _worker_main(self, es: ExecutionStream, widx: int) -> None:
        from .vpmap import bind_current_thread, binding_for
        core = binding_for(es.th_id, self.nb_cores)
        if core is not None:
            bind_current_thread(core)  # ref: parsec_bindthread at ES boot
        while True:
            with self._work_cond:
                self._work_cond.wait_for(
                    lambda: self._finalized
                    or (self._start_gen > self._worker_gen[widx]
                        and not self.all_tasks_done()),
                    timeout=0.05)
                if self._finalized:
                    return
                if self.all_tasks_done():
                    self._worker_gen[widx] = self._start_gen
                    continue
                self._workers_in_loop += 1
            try:
                context_wait_loop(es)
            finally:
                with self._work_cond:
                    self._workers_in_loop -= 1
                    self._work_cond.notify_all()

    # ------------------------------------------------------------------ #
    # idle-loop helpers                                                  #
    # ------------------------------------------------------------------ #
    def _comm_thread_main(self) -> None:
        from .vpmap import bind_current_thread
        core = params.get("comm_thread_bind")
        if core >= 0:
            bind_current_thread(core)
        es0 = self.execution_streams[0]
        idle = 0
        while not self._comm_thread_stop.is_set():
            try:
                n = self.comm.progress(es0)
            except BaseException as exc:  # noqa: BLE001 - surfaced on wait
                self.record_task_error(exc)
                n = 0
            if n:
                idle = 0
            else:
                idle = min(idle + 1, 10)
                self._comm_thread_stop.wait(1e-5 * (1 << idle))

    def wake_workers(self, n: int = 1) -> None:
        with self._work_cond:
            self._work_cond.notify_all()

    def park(self, max_sleep: float) -> None:
        with self._work_cond:
            self._work_cond.wait(timeout=max_sleep)

    def progress_engines(self, es: ExecutionStream) -> int:
        """Idle-cycle progress of the device managers and the comm engine
        (the CUDA manager/progress_stream polling and the funnelled comm
        thread; SURVEY.md §3.3-3.4)."""
        n = 0
        while True:
            try:
                cb = self._deferred.popleft()
            except IndexError:
                break
            try:
                cb(es)
            except BaseException as exc:  # surface on the waiter like a task
                self.record_task_error(exc)
            n += 1
        for dev in self.devices:
            n += dev.progress(es)
        if self.comm is not None and self._comm_thread is None:
            # funnelled mode: ONLY the dedicated thread touches the
            # engine (ref: remote_dep_dequeue_main owns all MPI calls)
            n += self.comm.progress(es)
        return n

    def defer(self, cb) -> None:
        """Run ``cb(es)`` on a scheduler thread during idle-cycle progress."""
        self._deferred.append(cb)
        self.wake_workers(1)

    def submit_native_loop(self, fn) -> None:
        """Queue a native dispatch loop (ref: the generated static-mode
        progress drive, scheduling.c:586-625): one worker claims it from
        the wait loop and runs the whole lowered DAG through
        NativeDAG.run_loop, Python re-entered only at chore bodies."""
        with self._tp_lock:
            self._native_loops.append(fn)
        self.wake_workers(1)

    def run_native_loops(self, es) -> bool:
        if not self._native_loops:
            return False
        with self._tp_lock:
            if not self._native_loops:
                return False
            fn = self._native_loops.pop(0)
        fn(es)
        return True

    # ------------------------------------------------------------------ #
    # shutdown                                                           #
    # ------------------------------------------------------------------ #
    def fini(self) -> None:
        """ref: parsec_fini (parsec.c:1259)."""
        if self._finalized:
            return
        assert self.all_tasks_done(), "fini with active taskpools"
        if self._task_errors:
            with self._tp_lock:
                self.taskpools.clear()
                self._active_taskpools = 0
        self._finalized = True
        if self._ft_detector is not None:
            self._ft_detector.stop()   # before the engine dies under it
        if self._ft_elastic is not None:
            self._ft_elastic.detach()
        if self._ft_pins is not None:
            self._ft_pins.disable()
        with self._work_cond:
            self._work_cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        # the stage programs this context recorded (stagec/): their CUDA
        # graphs' memory goes now, unless another live context holds them
        from ..devices.batching import release_stage_entries
        release_stage_entries(self)
        for dev in self.devices:
            dev.fini()
        if self._comm_thread is not None:
            # stop the funnelled progress thread BEFORE tearing the
            # engine down under it
            self._comm_thread_stop.set()
            self._comm_thread.join(timeout=5)
        if self.comm is not None:
            self.comm.fini()
        if self._sde_pusher is not None:
            self._sde_pusher.stop()  # sends one final snapshot
        if self._task_profiler is not None:
            # unhook from the global PINS sites: a later context's events
            # must not leak into this finalized profile
            self._task_profiler.disable()
        # unhook telemetry (PINS latency module, engine and device sinks;
        # the device sinks resolve their last timed events here)
        self.obs.fini()
        if self._debug_history_on:
            from ..utils import debug_history
            debug_history.disable()  # refcounted across live contexts
            self._debug_history_on = False
        if self.profile is not None and self._prof_prefix:
            self.stamp_profile_meta()
            self.sample_sde_counters()
            path = self.profile.dump(self._prof_prefix)
            bpath = self.profile.dump_binary(self._prof_prefix)
            plog.inform("trace written to %s + %s", path, bpath)
        if self._dot_prefix:
            path = grapher.dump(f"{self._dot_prefix}.rank{self.rank}.dot")
            grapher.disable()
            plog.inform("DAG written to %s", path)
        self.scheduler.remove(self)
        # drop the poll gauge registered in __init__: it closes over self
        # and would keep this finalized context (and its scheduler) alive
        self.sde.unregister(PENDING_TASKS, self._pending_gauge)

    def stamp_profile_meta(self) -> None:
        """Trace metadata for the fleet merge: the rank and the measured
        per-peer clock offsets (µs) land in the profile's info dict,
        which ``to_chrome_trace`` exports as metadata next to
        ``trace_t0_ns`` — what ``obs.merge_trace_docs`` needs to fuse N
        rank timelines onto one clock.  ``fini`` calls it before writing
        the trace; a caller reading an in-memory profile calls it
        first."""
        if self.profile is None:
            return
        import json as _json
        self.profile.add_information("rank", self.rank)
        ce = getattr(self.comm, "ce", self.comm) \
            if self.comm is not None else None
        fn = getattr(ce, "clock_offsets_us", None)
        if callable(fn):
            try:
                offs = fn()
            except Exception:  # noqa: BLE001 - metadata must not abort
                offs = {}
            if offs:
                self.profile.add_information(
                    "clock_offsets_us",
                    _json.dumps({str(k): v for k, v in offs.items()}))

    def dump_forensics(self, reason: str = "taskpool abort") -> str:
        """Flight-recorder export: write the live profile's trace to
        ``<profile prefix>.forensics.rank<r>.trace.json`` (once per
        context; no-op without a file-backed profile). Returns the
        path written, or ""."""
        if self.profile is None or not self._prof_prefix \
                or self._forensics_dumped:
            return ""
        self._forensics_dumped = True
        try:
            self.stamp_profile_meta()
            self.sample_sde_counters()
            path = self.profile.dump(f"{self._prof_prefix}.forensics")
        except Exception as exc:  # noqa: BLE001 - must not mask the abort
            plog.warning("forensics trace export failed: %r", exc)
            return ""
        plog.warning("forensics trace written to %s (%s)", path, reason)
        return path

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc) -> None:
        self.fini()

    # device helpers
    def device_by_type(self, device_type: str):
        for d in self.devices:
            if d.device_type == device_type:
                return d
        return None


def init(nb_cores: Optional[int] = None, argv: Optional[List[str]] = None,
         device: Any = None, **kw) -> Context:
    """Module-level convenience mirroring parsec_init.  The accelerator
    module runs on ``device``: None means ``cuda:0`` (raising when no
    card is present, unless the ``device_cuda_platform`` knob names
    another), ``"cpu"`` runs the same module over host tensors with
    each kernel's plain version."""
    return Context(nb_cores=nb_cores, argv=argv, device=device, **kw)
