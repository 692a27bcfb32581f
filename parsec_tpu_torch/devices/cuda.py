"""CUDA device module: asynchronous offload engine over PyTorch.

Reference behavior reproduced (from the CUDA module, SURVEY.md §2.5, §3.4):
- the accelerator chore hands the task to a per-device mini-scheduler and
  returns HOOK_RETURN_ASYNC; the first thread to submit becomes the device
  *manager* (atomic mutex CAS, ref: device_cuda_module.c:2574-2577), others
  just enqueue to ``pending``;
- stage-in reserves device space, pulls the newest copy, and respects the
  coherency protocol (parsec_gpu_data_reserve_device_space / push,
  ref: device_cuda_module.c:864-1040, 2099-2195);
- two LRU lists (clean / dirty-owned) drive eviction with writeback
  (ref: device_gpu.h:128-129);
- in-flight tracking with CUDA events polled by the manager
  (progress_stream, ref: device_cuda_module.c:1961-2012);
- the epilog hands ownership back OWNED→SHARED and bumps versions
  (ref: device_cuda_module.c:2365-2430).

Every launch, copy and event of the module goes to ONE stream the device
owns.  Worker threads each have their own current stream, so the module
enters its stream around every launch and copy; a host read from any
thread (``pull_to_host``, eviction writeback, ``data.to_host_array``)
queues on that stream too and therefore waits for the tile's producer.
Because one stream orders every kernel, dependency release can happen at
launch (``cuda_eager_complete``): a successor's launch is queued behind
its producer's.

The chip mesh (:class:`CudaMeshDevice`, ``device_mesh_shape``) spreads
one rank's tiles over several chips, each with a stream of its own; the
seam it overrides (``_stage_target``, ``_placement``, ``_localize``,
``_tag``) is the identity here, so the single-stream module runs
exactly as it did.

Telemetry (obs/): while the context's ``DeviceObs`` is installed as
``_obs``, every dispatch is bracketed by timed CUDA events on the stream
(the device-busy intervals), and every host copy (``_put``, ``_pull``,
which stage-in, prefetch, eviction write-back, ``pull_to_host`` and
``data.to_host_array`` go through) records its start event and the
host's wait before it.  With ``_obs`` unset the module records no timed
event and launches exactly what it launches without telemetry.

``device="cpu"`` drives the same module over host tensors: there is no
stream or event, every launch is complete when it returns, and the tile
operations take their plain PyTorch versions.  The tests use it to run
the real stage-in, batching and epilog code.

Failures raise: a kernel build or launch error aborts the DAG and
re-raises from ``wait()``.  There is no downgrade to per-task or host
execution — CUDA errors are sticky, and a fallback would hide a broken
kernel.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.lists import Dequeue
from ..data.data import (Coherency, Data, DataCopy, FlowAccess,
                         is_device_array, mark_ready, order_after_writer,
                         register_device_stream, stream_of, tag_stream,
                         wait_ready)
from ..runtime.taskpool import HookReturn, Task
from ..utils import logging as plog
from ..utils.params import params
from .device import Device

#: declared lock discipline (the JAX package's analysis/lock_check.py
#: reads the same map there): memory accounting + both LRU lists belong
#: to the memory lock; the in-flight/window records to the manager lock
_GUARDED_BY = {
    "CudaDevice.mem_used": "_mem_lock",
    "CudaDevice.mem_highwater": "_mem_lock",
    "CudaDevice._lru_clean": "_mem_lock",
    "CudaDevice._lru_owned": "_mem_lock",
    "CudaDevice._inflight": "_manager_lock",
    "CudaDevice._window": "_manager_lock",
    "CudaDevice._eager_done": "_manager_lock",
}


class _InFlight:
    __slots__ = ("task", "outputs", "out_flows", "est", "event")

    def __init__(self, task: Task, outputs: List[Any], out_flows: List[int],
                 est: float, event: Any) -> None:
        self.task = task
        self.outputs = outputs
        self.out_flows = out_flows
        self.est = est
        self.event = event      # recorded after the launch; None on cpu

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class CudaDevice(Device):
    """One torch device managed as a PaRSEC accelerator device."""

    def __init__(self, device_index: int, torch_device: Any) -> None:
        import torch
        torch_device = torch.device(torch_device)
        if torch_device.type == "cuda" and torch_device.index is None:
            torch_device = torch.device("cuda", 0)
        super().__init__("cuda", device_index, name=str(torch_device))
        self.torch_device = torch_device
        self.is_cuda = torch_device.type == "cuda"
        self.stream = (torch.cuda.Stream(device=torch_device)
                       if self.is_cuda else None)
        if self.is_cuda:
            register_device_stream(torch_device, self.stream, self._pull)
        self.time_estimate_default = 1.0
        # device manager state (ref: gpu_device->mutex + pending)
        self.pending = Dequeue()
        self._manager_lock = threading.Lock()
        self._inflight: List[_InFlight] = []
        # memory accounting + LRU (ref: zone_malloc + gpu_mem_lru/_owned_lru)
        self.mem_budget = self._probe_budget()
        self.mem_used = 0
        self.mem_highwater = 0
        self._lru_clean: "OrderedDict[int, DataCopy]" = OrderedDict()
        self._lru_owned: "OrderedDict[int, DataCopy]" = OrderedDict()
        self._mem_lock = threading.Lock()
        #: the GEMM kernel's launches made inside this module's
        #: dispatches (the tasks' bodies; a recorded graph's replay
        #: launches uncounted)
        self.gemm_launches = 0
        self.stats = {"stage_in_bytes": 0, "stage_out_bytes": 0,
                      "evictions": 0, "tasks": 0,
                      "batches": 0, "batched_tasks": 0,
                      # bytes copied by stacking batch inputs into one
                      # [n, ...] tensor per argument (the batched path's
                      # extra device traffic)
                      "stack_bytes": 0,
                      "dispatch_ns": 0, "dispatch_tasks": 0,
                      "prefetch_issued": 0, "prefetch_hits": 0,
                      "segmented_flushes": 0, "flush_segments": 0}
        # eager completion (one stream orders the dataflow; on a chip mesh
        # a read across chips is a hop its reader's stream waits for) with
        # a bounded in-flight window
        self.eager_complete = bool(params.get("cuda_eager_complete"))
        self.eager_window = int(params.get("cuda_eager_window"))
        self._window: List[_InFlight] = []
        self._eager_done: List[_InFlight] = []
        # batched dispatch + stage-in prefetch
        self.batch_max = int(params.get("device_batch_max"))
        mode = str(params.get("device_batch_mode"))
        if mode != "unroll":
            raise NotImplementedError(
                f"device_batch_mode={mode!r}: this package stacks only in "
                f"the bit-exact 'unroll' mode")
        if params.get("device_donate"):
            raise NotImplementedError(
                "device_donate: buffer donation is not supported by this "
                "package")
        self.prefetch_depth = int(params.get("device_prefetch_depth"))
        self.flush_segments = int(params.get("device_flush_segments"))
        # copies staged early by the prefetcher: id(copy) -> version;
        # a stage-in that finds its copy here already valid is a HIT
        self._prefetched: Dict[int, int] = {}

    def _probe_budget(self) -> int:
        if self.is_cuda:
            import torch
            _free, total = torch.cuda.mem_get_info(self.torch_device)
            return int(total * params.get("cuda_memory_fraction_pct") / 100)
        return 8 << 30  # host tensors: 8 GiB of accounting space

    def _stream_at(self, target: Any) -> Any:
        """The stream that launches on ``target`` (a chip of a mesh; None
        = the device's own stream)."""
        return self.stream

    def _device_at(self, target: Any) -> Any:
        """The torch device of ``target``."""
        return self.torch_device

    def on_stream(self, target: Any = None):
        """Context entering ``target``'s stream (no-op on cpu)."""
        stream = self._stream_at(target)
        if stream is None:
            return contextlib.nullcontext()
        import torch
        return torch.cuda.stream(stream)

    @contextlib.contextmanager
    def _launching(self, target: Any, name: str, ntasks: int):
        """Context around one dispatch on ``target``: its stream, the
        telemetry's busy interval when ``_obs`` is set, and the GEMM
        kernel's launches made inside it (``gemm_launches``)."""
        from ..ops.kernels import thread_matmul_launches
        obs = self._obs
        k0 = thread_matmul_launches()
        with (self.on_stream(target) if obs is None
              else self._obs_dispatch(obs, target, name, ntasks)):
            yield
        self.gemm_launches += thread_matmul_launches() - k0

    @contextlib.contextmanager
    def _obs_dispatch(self, obs, target: Any, name: str, ntasks: int):
        stream = self._stream_at(target)
        with self.on_stream(target):
            m0, ev0 = time.monotonic_ns(), obs.mark(stream)
            yield
            obs.dispatch(name, ntasks, ev0, m0, stream)

    def _record_event(self, target: Any = None) -> Any:
        stream = self._stream_at(target)
        if stream is None:
            return None
        import torch
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def _put(self, payload: Any, target: Any = None) -> Any:
        """H2D copy of a host payload (synchronous: pageable memory), or
        a private device copy of a tensor, on ``target``'s stream and
        device, tagged as written there."""
        import torch
        dev = self._device_at(target)
        with self.on_stream(target):
            if is_device_array(payload):
                # a tensor handed over from another stream (a rank
                # thread's, comm/mesh.py, or a chip's) is read only after
                # its writer
                if self.is_cuda:
                    order_after_writer(payload,
                                       torch.cuda.current_stream(dev))
                return self._tag(payload.to(dev, copy=True), target)
            arr = np.ascontiguousarray(payload)
            obs = self._obs
            if obs is None:
                out = torch.from_numpy(arr).to(dev, copy=True)
            else:
                t0 = time.monotonic_ns()
                ev0 = obs.mark(self._stream_at(target))
                out = torch.from_numpy(arr).to(dev, copy=True)
                obs.xfer("in", arr.nbytes, t0, ev0)
        return self._tag(out, target)

    def _pull(self, payload: Any) -> np.ndarray:
        """D2H copy on the stream that wrote ``payload`` (the device
        stream, or a chip's): it waits for the producer."""
        import torch
        obs = self._obs
        stream = stream_of(payload, self.stream)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if obs is None:
                return payload.detach().to("cpu", copy=True).numpy()
            t0 = time.monotonic_ns()
            ev0 = obs.mark(stream)
            out = payload.detach().to("cpu", copy=True).numpy()
            obs.xfer("out", out.nbytes, t0, ev0)
            return out

    # ------------------------------------------------------------------ #
    # submission: the accelerator chore calls this and returns ASYNC     #
    # ------------------------------------------------------------------ #
    def kernel_scheduler(self, es, task: Task) -> HookReturn:
        """ref: parsec_cuda_kernel_scheduler (device_cuda_module.c:2537)."""
        task.selected_device = self
        est = (task.task_class.time_estimate(task, self)
               if task.task_class.time_estimate else self.time_estimate_default)
        self.load_add(est)
        task.es_hint = es.th_id
        self.pending.push_back((task, est))
        chore = task.task_class.incarnations[task.selected_chore]
        spec = getattr(chore, "batch_spec", None)
        if spec is not None and self.batch_max > 1 \
                and len(self.pending) < self.batch_max:
            # accumulate: a same-class burst becomes ONE stacked launch
            # at the next manager flush (idle workers call progress()
            # every cycle).  Meanwhile stage the head of the queue in
            # early (ref: push/exec overlap, device_cuda_module.c).
            if 0 < len(self.pending) <= self.prefetch_depth:
                self._prefetch_task(task)
            return HookReturn.ASYNC
        self.progress(es)
        return HookReturn.ASYNC

    # ------------------------------------------------------------------ #
    # the manager loop, run opportunistically from idle workers          #
    # ------------------------------------------------------------------ #
    def progress(self, es) -> int:
        if not self._manager_lock.acquire(blocking=False):
            return 0  # someone else is the manager (CAS-owner pattern)
        try:
            n = 0
            drained: List[Tuple[Task, float]] = []
            while True:
                item = self.pending.pop_front()
                if item is None:
                    break
                drained.append(item)
            if drained:
                n += self._dispatch_ready(es, drained)
            if self._eager_done:
                done, self._eager_done = self._eager_done, []
                for rec in done:
                    self._epilog(es, rec)
                    n += 1
            if self._window:
                # retire finished window entries so device_load drains on
                # idle devices and async errors surface during the run
                still_w = []
                for rec in self._window:
                    if rec.ready():
                        self._retire(rec, es)
                    else:
                        still_w.append(rec)
                self._window = still_w
            still: List[_InFlight] = []
            done = []
            for rec in self._inflight:
                (done if rec.ready() else still).append(rec)
            self._inflight = still
            for rec in done:
                self._epilog(es, rec)
                n += 1
            return n
        finally:
            self._manager_lock.release()

    # ------------------------------------------------------------------ #
    # stage-in / execute                                                 #
    # ------------------------------------------------------------------ #
    def _stage_in(self, task: Task) -> List[Any]:
        """Resolve every input flow to a tensor on this device
        (ref: parsec_cuda_kernel_push, device_cuda_module.c:2099-2195).
        A tile's resident copy is staged on its placement; the task sees
        it localized to its own target."""
        target = self._stage_target(task)
        arrays: List[Any] = []
        for flow in task.task_class.flows:
            access = task.access_of(flow)
            ref = task.data[flow.flow_index]
            if flow.ctl or ref.data_in is None:
                arrays.append(None)
                continue
            data = ref.data_in.data
            if data is None:
                # detached copy (e.g. NEW tile scratch): move payload directly
                arrays.append(self._put(ref.data_in.payload, target))
                continue
            with data._lock:   # the prefetcher may attach it meanwhile
                copy = data.get_copy(self.device_index)
                if copy is None:
                    copy = DataCopy(data, self.device_index, payload=None,
                                    dtt=ref.data_in.dtt)
                    data.attach_copy(copy)
            src = data.start_transfer_ownership(self.device_index, access)
            if src is not None:
                nbytes = getattr(src.payload, "nbytes", 0)
                # credit the stale payload being replaced before reserving
                self._account(-getattr(copy.payload, "nbytes", 0))
                self._reserve(nbytes)
                copy.payload = self._put(src.payload,
                                         self._placement(data, target))
                self.stats["stage_in_bytes"] += nbytes
                self._prefetched.pop(id(copy), None)  # staged-over: stale
            elif self._prefetched.pop(id(copy), None) is not None:
                # the prefetcher staged this tile ahead of the dispatch
                # and the version held
                self.stats["prefetch_hits"] += 1
            data.complete_transfer_ownership(self.device_index, access)
            self._lru_touch(copy, owned=bool(access & FlowAccess.WRITE))
            arrays.append(self._localize(copy.payload, target))
        return arrays

    # mesh seam (CudaMeshDevice overrides; on the single-stream module
    # every target is the module's own stream)
    def _stage_target(self, task: Task) -> Any:
        """Where a task launches (None: the device's own stream)."""
        return None

    def _placement(self, data: Data, target: Any) -> Any:
        """Where a tile's resident device copy lives."""
        return target

    def _localize(self, payload: Any, target: Any) -> Any:
        """Make a staged payload usable on ``target`` (a chip-to-chip hop
        on a mesh; the identity on one stream)."""
        return payload

    def _tag(self, t: Any, target: Any) -> Any:
        """Mark ``t`` as written on ``target`` (a mesh tags the chip; one
        stream tags itself: another rank's module on the same card reads
        the tensor behind this stream, not behind its own)."""
        return tag_stream(t, self.stream)

    def _note_profile(self, es, cls_name: str, us_per_task: float,
                      n: int) -> None:
        """Feed the context's online class profile (critical-path-driven
        scheduler priorities) with this class's measured launch cost."""
        ctx = getattr(es, "context", None) if es is not None else None
        prof = getattr(ctx, "class_profile", None)
        if prof is not None:
            prof.note(cls_name, us_per_task, n)

    def _out_flows(self, task: Task) -> List[int]:
        return [f.flow_index for f in task.task_class.flows
                if (task.access_of(f) & FlowAccess.WRITE) and not f.ctl
                and task.data[f.flow_index].data_in is not None]

    def _submit(self, es, task: Task, est: float) -> None:
        self._submit_prepared(es, task, est, self._stage_in(task))

    def _submit_prepared(self, es, task: Task, est: float,  # holds: self._manager_lock
                         inputs: List[Any]) -> None:
        """Per-task dispatch of an already-staged task."""
        tc = task.task_class
        chore = tc.incarnations[task.selected_chore]
        fn = chore.dyld_fn
        assert fn is not None, f"cuda chore of {tc.name} has no executable"
        target = self._stage_target(task)
        t0 = time.perf_counter_ns()
        with self._launching(target, tc.name, 1):
            outputs = fn(task, inputs)
            event = self._record_event(target)
        dt = time.perf_counter_ns() - t0
        self.stats["dispatch_ns"] += dt
        self.stats["dispatch_tasks"] += 1
        self._note_profile(es, tc.name, dt / 1e3, 1)
        if outputs is None:
            outputs = ()
        elif not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        out_flows = self._out_flows(task)
        if len(outputs) != len(out_flows):
            raise ValueError(f"{tc.name} cuda body returned {len(outputs)} "
                             f"tensors for {len(out_flows)} written flows")
        self._finish_submit(es, task, est,
                            [self._tag(o, target) for o in outputs],
                            out_flows, event)

    def _finish_submit(self, es, task: Task, est: float,  # holds: self._manager_lock
                       outputs: List[Any], out_flows: List[int],
                       event: Any) -> None:
        rec = _InFlight(task, outputs, out_flows, est, event)
        self.stats["tasks"] += 1
        if self.eager_complete:
            # the stream orders every consumer launch after its producer,
            # so dependency release need not wait for the kernel; host
            # reads queue on the stream too.  A bounded window keeps the
            # queue from running unboundedly ahead.
            self._window.append(rec)
            if len(self._window) > self.eager_window:
                self._retire(self._window.pop(0), es)
            self._eager_done.append(rec)
        else:
            self._inflight.append(rec)

    # ------------------------------------------------------------------ #
    # batched dispatch: stack same-class ready tasks into ONE launch     #
    # ------------------------------------------------------------------ #
    def _dispatch_ready(self, es, items: List[Tuple[Task, float]]) -> int:  # holds: self._manager_lock
        """Dispatch a drained ready set: group by (class, static context,
        shapes, dtypes), stack each group into power-of-two buckets,
        per-task dispatch for singletons and unbatchable tasks.  Returns
        the number of tasks submitted.  On an error the undispatched
        tasks go back to ``pending`` (the abort path's drain credits
        their load) and the error propagates."""
        from .batching import bucket_size
        groups: Dict[Any, List[Tuple]] = {}
        order: List[Any] = []   # dispatch groups in arrival order
        n = 0
        done_ids = set()
        try:
            for task, est in items:
                chore = task.task_class.incarnations[task.selected_chore]
                spec = getattr(chore, "batch_spec", None)
                if spec is None or self.batch_max <= 1:
                    done_ids.add(id(task))
                    self._submit(es, task, est)
                    n += 1
                    continue
                inputs = self._stage_in(task)
                ext = spec.extract(task, inputs)
                if ext is None:
                    done_ids.add(id(task))
                    self._submit_prepared(es, task, est, inputs)
                    n += 1
                    continue
                bargs, _flow_idx, static = ext
                shapes = tuple((tuple(a.shape), str(a.dtype)) for a in bargs)
                key = (spec, static, shapes)
                if key not in groups:
                    groups[key] = []
                    order.append(key)
                groups[key].append((task, est, inputs, bargs))
            for key in order:
                spec, static, _shapes = key
                g = groups[key]
                while len(g) >= 2:
                    b = bucket_size(len(g), self.batch_max)
                    chunk, g = g[:b], g[b:]
                    done_ids.update(id(e[0]) for e in chunk)
                    self._dispatch_batch(es, spec, static, chunk)
                    n += b
                for task, est, inputs, _ in g:   # singleton remainder
                    done_ids.add(id(task))
                    self._submit_prepared(es, task, est, inputs)
                    n += 1
        except BaseException:
            for task, est in items:
                if id(task) not in done_ids:
                    self.pending.push_back((task, est))
            raise
        return n

    def _dispatch_batch(self, es, spec, static,  # holds: self._manager_lock
                        chunk: List[Tuple], target: Any = None) -> None:
        """Dispatch one flush group on ``target`` — as ONE stacked launch,
        or (segmented flush) as ``device_flush_segments`` launches whose
        outputs each retire on their own."""
        from .batching import segment_plan
        n = len(chunk)
        segs = segment_plan(n, self.flush_segments)
        if segs <= 1:
            return self._dispatch_stacked(es, spec, static, chunk, target)
        self.stats["segmented_flushes"] += 1
        size = n // segs
        for i in range(0, n, size):
            self.stats["flush_segments"] += 1
            self._dispatch_stacked(es, spec, static, chunk[i:i + size],
                                   target)

    def _dispatch_stacked(self, es, spec, static,  # holds: self._manager_lock
                          chunk: List[Tuple], target: Any = None) -> None:
        """ONE dispatch for ``chunk`` on ``target``: a stacked launch, or
        the body once per member (batching.stacked_call)."""
        from .batching import stacked_call
        n = len(chunk)
        t0 = time.perf_counter_ns()
        with self._launching(target, chunk[0][0].task_class.name, n):
            per_task = stacked_call(spec, static, [e[3] for e in chunk])
            event = self._record_event(target)
        dt = time.perf_counter_ns() - t0
        self.stats["dispatch_ns"] += dt
        self.stats["dispatch_tasks"] += n
        self.stats["batches"] += 1
        self.stats["batched_tasks"] += n
        if spec.stacked:
            self.stats["stack_bytes"] += sum(a.nbytes for e in chunk
                                             for a in e[3])
        self._note_profile(es, chunk[0][0].task_class.name, dt / 1e3 / n, n)
        for (task, est, _inputs, _), outputs in zip(chunk, per_task):
            out_flows = self._out_flows(task)
            if len(outputs) != len(out_flows):
                raise ValueError(
                    f"{task.task_class.name} batched body returned "
                    f"{len(outputs)} tensors for {len(out_flows)} written "
                    f"flows")
            self._finish_submit(es, task, est,
                                [self._tag(o, target) for o in outputs],
                                out_flows, event)

    # ------------------------------------------------------------------ #
    # stage-in prefetch: stage queued tasks' inputs ahead of dispatch    #
    # ------------------------------------------------------------------ #
    def _prefetch_task(self, task: Task) -> None:
        """Early H2D of a queued task's host-resident inputs, on the
        submitting worker.  Every check re-validates under the data lock
        before committing (a racing stage-in must win)."""
        target = self._stage_target(task)
        for flow in task.task_class.flows:
            if flow.ctl:
                continue
            ref = task.data[flow.flow_index]
            if ref.data_in is None or ref.data_in.data is None:
                continue
            self.prestage_data(ref.data_in.data, dtt=ref.data_in.dtt,
                               target=target)

    def prestage_data(self, data: Data, dtt=None, target: Any = None) -> bool:
        """Stage one Data's newest host payload onto this device early,
        on its placement for a task launching on ``target``.  Returns
        True when a payload was committed (the later stage-in will be a
        prefetch HIT)."""
        with data._lock:
            copy = data.get_copy(self.device_index)
            newest = data.newest_version()
            if copy is not None and copy.coherency != Coherency.INVALID \
                    and copy.version >= newest:
                return False   # already device-resident and current
            src = data.newest_copy(exclude_device=self.device_index)
            # snapshot the version WITH the payload decision: the commit
            # below must stamp the version these bytes had
            src_version = src.version if src is not None else -1
        if src is None or src.payload is None \
                or is_device_array(src.payload):
            return False   # nothing to pull, or source is device-side
        nbytes = getattr(src.payload, "nbytes", 0)
        self._reserve(nbytes)
        buf = self._put(src.payload, self._placement(data, target))
        committed = False
        old = 0
        with data._lock:
            if copy is None:
                copy = data.get_copy(self.device_index)
            if copy is None:
                copy = DataCopy(data, self.device_index, payload=None,
                                dtt=dtt)
                data.attach_copy(copy)
            # commit only if a concurrent stage-in did not get there
            # first (it owns the coherency transition)
            if copy.readers == 0 and copy.coherency != Coherency.OWNED \
                    and (copy.coherency == Coherency.INVALID
                         or copy.version < src_version):
                old = getattr(copy.payload, "nbytes", 0)
                copy.payload = buf
                copy.version = src_version
                copy.coherency = Coherency.SHARED
                self._prefetched[id(copy)] = src_version
                committed = True
        if committed:
            self._account(-old)
            self._lru_touch(copy, owned=False)
            self.stats["prefetch_issued"] += 1
            self.stats["stage_in_bytes"] += nbytes
        else:
            self._account(-nbytes)   # lost the race: undo the hold
        return committed

    def prestaged_current(self, data: Data) -> bool:
        """Is this Data's device copy one the prefetcher staged and still
        the newest version?  The stage compiler's ``prestage_hits``
        accounting (a hit = the stage's stage-in will find the tile
        already resident instead of paying a serial host-to-device
        copy)."""
        with data._lock:
            copy = data.get_copy(self.device_index)
            return (copy is not None
                    and id(copy) in self._prefetched
                    and copy.coherency != Coherency.INVALID
                    and copy.version >= data.newest_version())

    def adopt_output(self, data: Data, arr: Any) -> None:
        """Adopt a device tensor as ``data``'s newest DEVICE copy — the
        epilog's writeback half without a task (the chain-consume path,
        stagec/chain.py: a rider stage's outputs computed inside an
        earlier pool's chained program land here, staying on the card
        instead of going through the host).  The lookup-attach-commit
        runs under the data lock (a prestage of the same tile must not
        interleave), and the adopted copy leaves the prestage set — it
        was never a prefetch, so it must not read as one."""
        with data._lock:
            copy = data.get_copy(self.device_index)
            if copy is None:
                copy = DataCopy(data, self.device_index, payload=None)
                data.attach_copy(copy)
            old = getattr(copy.payload, "nbytes", 0)
            copy.payload = arr
            data.version_bump(self.device_index)
            self._prefetched.pop(id(copy), None)
        self._account(-old)
        self._reserve(getattr(arr, "nbytes", 0))
        self._lru_touch(copy, owned=True)

    def drain(self, context=None) -> None:
        """Retire every remaining window entry (called at wait()-exit),
        recording async kernel failures on the context; DISCARD
        undispatched ``pending`` entries (they exist only when the DAG
        aborted mid-accumulation)."""
        with self._manager_lock:
            discarded = 0
            while True:
                item = self.pending.pop_front()
                if item is None:
                    break
                self.load_sub(item[1])
                discarded += 1
            if discarded:
                plog.debug.verbose(2, "cuda drain: discarded %d "
                                   "undispatched task(s) of an aborted DAG",
                                   discarded)
            for rec in self._window:
                self._retire(rec, context=context)
            self._window = []
            self._prefetched.clear()
        obs = self._obs
        if obs is not None:
            obs.flush()   # the run's timed events become spans

    def _retire(self, rec: _InFlight, es=None, context=None) -> None:
        """Release a window entry: drop its load contribution and surface
        any async kernel error against the task that launched it."""
        self.load_sub(rec.est)
        try:
            if rec.event is not None:
                rec.event.synchronize()
        except Exception as exc:
            ctx = context if context is not None else \
                (es.context if es is not None else None)
            if ctx is not None:
                ctx.record_task_error(exc, rec.task)
            else:
                plog.warning("async kernel of %s failed at drain: %s",
                             rec.task.snprintf(), exc)

    def _epilog(self, es, rec: _InFlight) -> None:
        """ref: parsec_cuda_kernel_epilog (device_cuda_module.c:2365-2430)."""
        from ..runtime.scheduling import complete_execution
        task = rec.task
        for arr, fidx in zip(rec.outputs, rec.out_flows):
            ref = task.data[fidx]
            data = ref.data_in.data if ref.data_in is not None else None
            if data is not None:
                copy = data.get_copy(self.device_index)
                old = getattr(copy.payload, "nbytes", 0)
                copy.payload = arr
                self._account(getattr(arr, "nbytes", 0) - old)
                data.version_bump(self.device_index)
                ref.data_out = copy
            else:
                ref.data_in.payload = arr
                ref.data_in.version += 1
        for flow in task.task_class.flows:
            if task.access_of(flow) == FlowAccess.READ and not flow.ctl:
                ref = task.data[flow.flow_index]
                if ref.data_in is not None and ref.data_in.data is not None:
                    ref.data_in.data.release_reader(self.device_index)
        if not self.eager_complete:
            self.load_sub(rec.est)  # eager mode releases at window exit
        self.executed_tasks += 1
        complete_execution(es, task)

    # ------------------------------------------------------------------ #
    # memory management: accounting arena + LRU eviction                 #
    # ------------------------------------------------------------------ #
    def _account(self, delta: int) -> None:
        with self._mem_lock:
            self.mem_used = max(0, self.mem_used + delta)
            if self.mem_used > self.mem_highwater:
                self.mem_highwater = self.mem_used

    def _reserve(self, nbytes: int) -> None:
        """ref: parsec_gpu_data_reserve_device_space w/ LRU eviction and
        cycling guard (device_cuda_module.c:864-1040)."""
        with self._mem_lock:
            self.mem_used += nbytes
            if self.mem_used > self.mem_highwater:
                self.mem_highwater = self.mem_used
            if self.mem_used <= self.mem_budget:
                return
            for key in list(self._lru_clean):
                if self.mem_used <= self.mem_budget:
                    break
                copy = self._lru_clean.pop(key)
                if not self._evict(copy, writeback=False):
                    self._lru_clean[key] = copy  # in use: keep tracked
            for key in list(self._lru_owned):
                if self.mem_used <= self.mem_budget:
                    break
                copy = self._lru_owned.pop(key)
                if not self._evict(copy, writeback=True):
                    self._lru_owned[key] = copy

    def _evict(self, copy: DataCopy, writeback: bool) -> bool:  # holds: self._mem_lock
        """Returns True when the copy was evicted (False: keep it listed)."""
        if copy.payload is None or copy.data is None:
            return True
        if copy.readers > 0:
            return False  # in use; cycling guard keeps it resident
        data = copy.data
        if writeback and copy.coherency == Coherency.OWNED:
            host = data.get_copy(0)
            if host is not None:
                host.payload = self._pull(copy.payload)
                host.version = copy.version
                host.coherency = Coherency.OWNED
                data.owner_device = 0
                self.stats["stage_out_bytes"] += host.payload.nbytes
        self.mem_used = max(0, self.mem_used - getattr(copy.payload, "nbytes", 0))
        copy.payload = None
        copy.coherency = Coherency.INVALID
        self.stats["evictions"] += 1
        return True

    def _lru_touch(self, copy: DataCopy, owned: bool) -> None:
        key = id(copy)
        with self._mem_lock:
            self._lru_clean.pop(key, None)
            self._lru_owned.pop(key, None)
            (self._lru_owned if owned else self._lru_clean)[key] = copy

    # ------------------------------------------------------------------ #
    # explicit transfers (used by DSLs for flush / pushout)              #
    # ------------------------------------------------------------------ #
    def pull_to_host(self, data: Data) -> Any:
        """D2H writeback of this device's copy if it owns the newest version
        (ref: parsec_cuda_kernel_pop D2H for pushout flows)."""
        copy = data.get_copy(self.device_index)
        if copy is None or copy.payload is None:
            return None
        arr = self._pull(copy.payload)
        with data._lock:   # another thread may pull the same tile
            host = data.get_copy(0)
            if host is None:
                host = DataCopy(data, 0, payload=arr)
                data.attach_copy(host)
            else:
                host.payload = arr
            host.version = copy.version
            host.coherency = Coherency.SHARED
            copy.coherency = Coherency.SHARED
        self.stats["stage_out_bytes"] += arr.nbytes
        return arr

    def data_advise(self, data: Data, advice: str) -> None:
        if advice == "prefetch":
            self.prestage_data(data)
        elif advice == "preferred_device":
            data.preferred_device = self.device_index

    def fini(self) -> None:  # lock: exempt(teardown: workers joined, managers quiesced)
        assert not self._inflight, "device finalized with in-flight tasks"
        for rec in self._window:
            self._retire(rec)  # teardown: must finalize every device
        self._window.clear()
        self._prefetched.clear()


def parse_mesh_shape(shape: Any) -> Tuple[int, int]:
    """``device_mesh_shape`` grammar: "PxQ" grid or a bare chip count
    (a 1 x N row). Empty / "1" / "1x1" means no mesh."""
    s = str(shape or "").strip().lower()
    if not s:
        return (1, 1)
    if "x" in s:
        p, q = s.split("x", 1)
        return (max(1, int(p)), max(1, int(q)))
    return (1, max(1, int(s)))


class CudaMeshDevice(CudaDevice):
    """One rank owning a MESH of chips (``device_mesh_shape``) instead of
    one stream.  A chip is a :class:`~parsec_tpu_torch.parallel.mesh.Chip`:
    an index, a torch device and a CUDA stream of its own, so K logical
    chips on one card (``device_cuda_virtual_chips``) share its SMs and
    memory and differ only in the stream they launch on.

    - **Placement**: each collection tile lives on ONE chip, chosen
      block-cyclically from its coordinates (``mesh_position_of``);
      keyless data is first-touch (it stays where the first task that
      stages it runs), and a keyless tile's home is its DTD
      ``mesh_hint`` (insertion order), else its key's hash.
    - **Execution**: a task runs on its home chip, the placement of its
      first written tile; its launches and the events that complete it
      go to that chip's stream, and its outputs are tagged with the chip
      (``_ptt_chip``, and ``_ptt_stream`` for host reads and hand-overs:
      data.stream_of).
    - **Hops** (``_move``): an input resident on another chip is copied
      privately on the SOURCE chip's stream (behind its writer, ahead of
      any later write there), and the target's stream waits for the
      copy's event.  So a consumer never reads another chip's tile
      directly: read-after-write and write-after-read across streams are
      both ordered by the source stream, and the copy's memory is
      recorded on the target stream for the caching allocator.  Each hop
      is one event and one wait, counted in ``mesh_moves`` (also on host
      chips, where there is no event) with its bytes in
      ``collective_bytes``.  Memoised per drained set.
    - **Sharded batched dispatch**: a flush group of n tasks, n a multiple
      of the chip count k, is sorted by home chip and cut into k
      slot-blocks of n/k, each one ``stacked_call`` on its chip's stream
      with one event per chip (devices/batching.py
      ``cached_sharded_callable``).  The per-task arithmetic is the
      single-chip stacked path's, so results are bit-identical to it.  A
      group the chip count does not divide runs as one stacked launch on
      the first task's home chip (``batches`` against
      ``mesh_dispatches``).  A failing sharded dispatch raises; nothing
      falls back.
    - **Memory**: chips that share one card share its memory, so the
      budget is one card's for each distinct torch device.
    """

    def __init__(self, device_index: int, chips: List[Any],
                 grid: Tuple[int, int]) -> None:
        import torch

        from ..parallel.mesh import Chip, make_mesh
        gp, gq = grid
        if gp * gq != len(chips):
            raise ValueError(f"a {gp}x{gq} mesh needs {gp * gq} chips, "
                             f"got {len(chips)}")
        super().__init__(device_index, chips[0].device)
        self.grid = (gp, gq)
        own = []
        for i, c in enumerate(chips):
            dev = torch.device(c.device)
            stream = None
            if dev.type == "cuda":   # chip 0 keeps the module's stream
                stream = self.stream if i == 0 \
                    else torch.cuda.Stream(device=dev)
            own.append(Chip(c.id, dev, stream))
        self.mesh = make_mesh(sizes={"tp": gp, "sp": gq}, devices=own)
        # row-major over the (gp, gq) grid: the mesh's flat order, which
        # is also the sharded batch's slot-block order
        self.chips = list(self.mesh.devices.flat)
        self._chip_pos = {c: i for i, c in enumerate(self.chips)}
        plat = "cuda" if self.is_cuda else "cpu"
        self.name = f"{plat}:mesh{gp}x{gq}"
        # chips on one card share its memory: one budget a torch device
        self.mem_budget *= len({c.device for c in self.chips})
        self.stats.update({"mesh_dispatches": 0, "mesh_tasks": 0,
                           "mesh_moves": 0, "collective_bytes": 0})
        #: the GEMM kernel's launches made on each chip's stream
        self.chip_gemm_launches = [0] * len(self.chips)
        # per-progress-cycle memo of hops: (id(src), chip) -> (src, copy)
        self._move_cache: Dict[Tuple[int, Any], Tuple[Any, Any]] = {}

    @property
    def mesh_shards(self) -> int:
        """Chips in this device's mesh (obs gauge MESH_SHARDS)."""
        return len(self.chips)

    def _stream_at(self, target: Any) -> Any:
        return self.stream if target is None else target.stream

    def _device_at(self, target: Any) -> Any:
        return self.torch_device if target is None else target.device

    @contextlib.contextmanager
    def _launching(self, target: Any, name: str, ntasks: int):
        """The base's dispatch context, counting the GEMM kernel's
        launches made inside it against ``target``'s chip."""
        from ..ops.kernels import thread_matmul_launches
        chip = self.chips[0] if target is None else target
        k0 = thread_matmul_launches()
        with super()._launching(chip, name, ntasks):
            yield
        pos = self._chip_pos.get(chip)
        if pos is not None:
            self.chip_gemm_launches[pos] += thread_matmul_launches() - k0

    # ------------------------------------------------------------------ #
    # placement: tile coordinate -> chip                                 #
    # ------------------------------------------------------------------ #
    def _chip_of(self, data: Optional[Data]) -> Any:
        if data is None:
            return self.chips[0]
        coll = getattr(data, "collection", None)
        coords = getattr(data, "mesh_coords", None)
        gp, gq = self.grid
        if coll is not None and coords is not None \
                and hasattr(coll, "mesh_position_of"):
            pr, pc = coll.mesh_position_of(*coords, self.grid)
            return self.chips[(int(pr) % gp) * gq + (int(pc) % gq)]
        hint = getattr(data, "mesh_hint", None)
        if hint is None:
            try:
                hint = hash(data.key)
            except TypeError:
                hint = id(data)
        return self.chips[int(hint) % len(self.chips)]

    def _stage_target(self, task: Task) -> Any:
        """A task's home chip: where its first written tile is placed
        (owner-computes one level below the rank grid); a read-only task
        runs where its first input lives.  A task whose class spreads
        over the whole mesh (``mesh_wide``: a wave-front stage,
        stagec/sharded.py) has none: its tiles stage on their own chips
        and its completion event goes to the module's stream."""
        if getattr(task.task_class, "mesh_wide", False):
            return None
        first = None
        for flow in task.task_class.flows:
            if flow.ctl:
                continue
            ref = task.data[flow.flow_index]
            if ref.data_in is None or ref.data_in.data is None:
                continue
            data = ref.data_in.data
            if first is None:
                first = data
            if task.access_of(flow) & FlowAccess.WRITE:
                return self._chip_of(data)
        return self._chip_of(first)

    def _placement(self, data: Data, target: Any) -> Any:
        """Collection tiles pin to their block-cyclic mesh position;
        keyless data is FIRST-TOUCH (it stays on the chip of the first
        task that stages it, so a task's private tiles never hop)."""
        if getattr(data, "collection", None) is not None \
                and getattr(data, "mesh_coords", None) is not None \
                and hasattr(data.collection, "mesh_position_of"):
            return self._chip_of(data)
        return target if target is not None else self._chip_of(data)

    def _tag(self, t: Any, target: Any) -> Any:
        if is_device_array(t):
            # no target (a mesh-wide task's output): keep the chip that
            # wrote it
            chip = target if target is not None else \
                (getattr(t, "_ptt_chip", None) or self.chips[0])
            t._ptt_chip = chip
            tag_stream(t, chip.stream)
        return t

    def _localize(self, payload: Any, target: Any) -> Any:
        return self._move(payload, target)

    def _move(self, arr: Any, target: Any) -> Any:
        """The chip-to-chip hop of a device tensor: a private copy taken
        on the source chip's stream, which ``target``'s stream waits for
        (see the class docstring).  The resident copy stays where it is;
        consumers pull.  Memoised per progress cycle."""
        if not is_device_array(arr):
            return arr
        src = getattr(arr, "_ptt_chip", None)
        if src is None:
            src = self.chips[0]   # untagged: written on the device stream
        if target is None or src is target:
            return arr
        key = (id(arr), target)
        hit = self._move_cache.get(key)
        if hit is not None:
            return hit[1]
        if src.stream is not None:
            import torch
            with torch.cuda.stream(src.stream):
                # a hop of a hop: the first hop's event comes first
                wait_ready(arr, src.stream)
                moved = mark_ready(arr.detach().to(target.device, copy=True),
                                   src.stream)
            wait_ready(moved, target.stream)
        else:
            moved = arr.detach().to(target.device, copy=True)
        self._tag(moved, target)
        self._move_cache[key] = (arr, moved)
        self.stats["mesh_moves"] += 1
        self.stats["collective_bytes"] += arr.numel() * arr.element_size()
        return moved

    def _dispatch_ready(self, es, items: List[Tuple[Task, float]]) -> int:  # holds: self._manager_lock
        try:
            return super()._dispatch_ready(es, items)
        finally:
            # the memo lives for one drained set, whose tasks keep every
            # source tensor alive (so no id is reused meanwhile)
            self._move_cache.clear()

    def resident_bytes_per_chip(self) -> List[int]:
        """Bytes of the resident device copies on each chip."""
        out = [0] * len(self.chips)
        with self._mem_lock:
            copies = list(self._lru_clean.values()) \
                + list(self._lru_owned.values())
        for copy in copies:
            t = copy.payload
            if is_device_array(t):
                pos = self._chip_pos.get(getattr(t, "_ptt_chip", None), 0)
                out[pos] += t.numel() * t.element_size()
        return out

    # ------------------------------------------------------------------ #
    # sharded batched dispatch                                           #
    # ------------------------------------------------------------------ #
    def _dispatch_batch(self, es, spec, static,  # holds: self._manager_lock
                        chunk: List[Tuple], target: Any = None) -> None:
        n, k = len(chunk), len(self.chips)
        if k > 1 and n >= k and n % k == 0:
            return self._dispatch_sharded(es, spec, static, chunk)
        # the shape rule: the group runs on the first task's home chip
        target = self._stage_target(chunk[0][0])
        chunk = [(t, e, inp, tuple(self._move(a, target) for a in ba))
                 for (t, e, inp, ba) in chunk]
        super()._dispatch_batch(es, spec, static, chunk, target)

    def _dispatch_sharded(self, es, spec, static,  # holds: self._manager_lock
                          chunk: List[Tuple]) -> None:
        """``chunk`` spread over the mesh: slot-blocks of n/k tasks, one
        per chip in the mesh's order, the tasks sorted by home chip so
        most rows are already resident where their block runs (the rest
        hop)."""
        from . import batching
        n, k = len(chunk), len(self.chips)
        per = n // k
        shapes = tuple((tuple(a.shape), str(a.dtype)) for a in chunk[0][3])
        fn = batching.cached_sharded_callable(spec, n, len(shapes), static,
                                              shapes, self.mesh)
        order = sorted(range(n), key=lambda i: self._chip_pos[
            self._stage_target(chunk[i][0])])
        t0 = time.perf_counter_ns()
        blocks = [[tuple(self._move(a, chip)
                         for a in chunk[order[c * per + r]][3])
                   for r in range(per)]
                  for c, chip in enumerate(self.chips)]
        name = chunk[0][0].task_class.name
        outs, events = fn(blocks, lambda chip: self._launching(
            chip, name, per), self._record_event)
        dt = time.perf_counter_ns() - t0
        self.stats["dispatch_ns"] += dt
        self.stats["dispatch_tasks"] += n
        self.stats["batches"] += 1
        self.stats["batched_tasks"] += n
        self.stats["mesh_dispatches"] += 1
        self.stats["mesh_tasks"] += n
        if spec.stacked:
            self.stats["stack_bytes"] += sum(a.nbytes for e in chunk
                                             for a in e[3])
        self._note_profile(es, name, dt / 1e3 / n, n)
        for s in range(n):
            task, est, _inputs, _ba = chunk[order[s]]
            c, r = divmod(s, per)
            outputs = outs[c][r]
            out_flows = self._out_flows(task)
            if len(outputs) != len(out_flows):
                raise ValueError(
                    f"{task.task_class.name} mesh-batched body returned "
                    f"{len(outputs)} tensors for {len(out_flows)} written "
                    f"flows")
            self._finish_submit(es, task, est,
                                [self._tag(o, self.chips[c])
                                 for o in outputs],
                                out_flows, events[c])

    def drain(self, context=None) -> None:
        super().drain(context)
        with self._manager_lock:
            self._move_cache.clear()

    def fini(self) -> None:  # lock: exempt(teardown: workers joined, managers quiesced)
        super().fini()
        self._move_cache.clear()


def cuda_chore_hook(device_selector=None):
    """The CUDA chore hook (ref: the generated CUDA hook,
    jdf2c.c:6557-6904): pick an attached cuda device and hand off, else
    fall through to the next incarnation."""
    from .device import get_best_device

    def hook(es, task):
        devs = [d for d in es.context.devices if d.device_type == "cuda"]
        if not devs:
            return HookReturn.NEXT
        if device_selector is not None:
            dev = device_selector(task, devs)
        else:
            dev = get_best_device(task, devs, eligible_types={"cuda"})
        return dev.kernel_scheduler(es, task)
    return hook
