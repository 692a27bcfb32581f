"""Whole-graph execution of a captured task graph: one CUDA graph.

The counterpart, for both capture front ends (dsl/ptg/capture.py and
dsl/dtd/capture.py), of the JAX package's ``jax.jit`` over the whole DAG.
A captured graph is a function ``execute(state, device, note)`` that runs
every task body once, in a topological order, on a dict of tiles
(``state``: key -> tensor) and returns the state after the last task.  Per-task
Python dispatch is what bounds the interpreted runtime on the card; a
CUDA graph records the whole sequence of launches once and replays it
with one host call.

On a CUDA device the first run warms up on a side stream (the kernels'
builds, cuBLAS and cuSOLVER handles and workspaces) and then records
``execute`` into a ``torch.cuda.CUDAGraph`` over static input tiles.
Every run copies its inputs into those tiles and replays the graph.  The
graph's outputs live in its private memory pool and the next replay
overwrites them, so a run hands back copies (with ``donate``, it copies
them into the caller's input tensors on the card instead, saving one
allocation per written tile).  The replay runs on one stream: the graph
keeps the order the bodies were recorded in.

On the CPU, ``execute`` runs eagerly over copies of the inputs.

One record at a time in the process: a record synchronizes the whole
device, which CUDA refuses while another thread captures (rank threads
of one process record their stages concurrently), so records take one
process-wide lock.  Replays and eager launches of other threads go on
meanwhile.  A record captures on a stream of its own
(:func:`own_stream`), one for each stream the graph will replay on:
``torch.cuda.Stream()`` hands out one of a pool of 32 streams a device
in turn, so a pooled capture stream may be a stream another thread is
launching on (its work would land in the graph), and graphs that replay
on different streams must not share the cuBLAS workspace PyTorch keys
by the capture stream.

A body that cannot be recorded (it synchronises with the host, or calls
a library routine that does) raises :class:`CaptureError` naming the
task and the CUDA error.  There is no fallback to the interpreted
runtime.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterable, Optional

import numpy as np
import torch

__all__ = ["CaptureError", "GraphRunner"]


class CaptureError(RuntimeError):
    """A task graph that cannot be captured (or recorded as a CUDA graph)."""


_record_lock = threading.Lock()  # lock: one GraphRunner.record at a time in the process, not a class field

_own_lock = threading.Lock()  # lock: guards module-global _own_streams, not a class field
_own_streams: Dict[Any, Any] = {}


def own_stream(device: Any, key: Hashable) -> "torch.cuda.Stream":
    """A CUDA stream of this process's own for (``device``, ``key``),
    made once with ``cuStreamCreate`` (non-blocking) and kept: no other
    caller of ``torch.cuda.Stream()`` is ever handed it, as a pooled
    stream may be."""
    import ctypes
    device = torch.device(device)
    k = (device.index or 0, key)
    with _own_lock:
        s = _own_streams.get(k)
        if s is None:
            create = ctypes.CDLL("libcuda.so.1").cuStreamCreate
            create.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                               ctypes.c_uint]
            create.restype = ctypes.c_int
            with torch.cuda.device(device):
                torch.empty(0, device=device)   # the context is current
                handle = ctypes.c_void_p()
                rc = create(ctypes.byref(handle), 1)   # non-blocking
            if rc != 0:
                raise RuntimeError(f"cuStreamCreate failed with CUresult "
                                   f"{rc} on {device}")
            s = _own_streams[k] = torch.cuda.ExternalStream(
                handle.value, device=device)
        return s


def _host_or_tensor(x: Any) -> torch.Tensor:
    """``x`` as a tensor: itself, or a CPU tensor sharing an array's
    memory (a ``copy_`` from it is one host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _cpu_copy(x: Any) -> Optional[torch.Tensor]:
    """A private CPU tensor holding ``x``'s values (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.tensor(np.asarray(x))


class GraphRunner:
    """Runs one captured graph, recording it as a CUDA graph on first use.

    ``execute(state, device, note)`` runs the graph on ``state`` and
    returns the final state; it calls ``note(label)`` before each task
    body, so a failed recording can name the task.  ``written()`` gives
    the keys of the tiles some task writes: those are the results, also
    where a body handed back a tensor it was given or wrote one in
    place.  Recording facts for the caller: ``capture_seconds`` (warm-
    up plus record), ``warmup_gemm_launches`` (the GEMM kernel's launches
    the warm-up ran), ``captured_gemm_launches`` (those recorded in the
    graph; a replay re-runs them without counting), both counted on the
    recording thread alone, ``replays``, and
    ``replay_ms`` (the last replay's device time, between two CUDA
    events)."""

    def __init__(self, execute: Callable, name: str,
                 written: Callable[[], Iterable[Hashable]]) -> None:
        self._execute = execute
        self._written_keys = written
        self.name = name
        self.capture_seconds: Optional[float] = None
        self.warmup_gemm_launches: Optional[int] = None
        self.captured_gemm_launches: Optional[int] = None
        self.replays = 0
        self._events = None
        self._device: Optional[torch.device] = None
        self._signature = None
        self._graph = None
        self._static_in: Dict[Hashable, torch.Tensor] = {}
        self._static_out: Dict[Hashable, torch.Tensor] = {}

    @property
    def recorded(self) -> bool:
        return self._graph is not None

    @property
    def replay_ms(self) -> float:
        """Device time of the last replay (waits for it to finish)."""
        start, stop = self._events
        stop.synchronize()
        return start.elapsed_time(stop)

    def reset(self) -> None:
        """Drop the recorded graph and its static tiles (frees its memory
        pool once nothing else holds them)."""
        self._graph = None
        self._static_in = {}
        self._static_out = {}
        self._signature = None
        self._device = None

    def run(self, inputs: Dict[Hashable, Any], device: torch.device,
            donate: bool = False) -> Dict[Hashable, torch.Tensor]:
        """Run the graph on ``inputs`` (arrays or tensors) on ``device``;
        return ``{key: tensor}`` for the tiles it wrote, on ``device``."""
        device = torch.device(device)
        if device.type == "cpu":
            state = {k: _cpu_copy(v) for k, v in inputs.items()}
            return self._written(self._execute(state, device, _no_note))
        if not self.recorded or self._device != device \
                or self._signature != _signature(inputs):
            self.record(inputs, device)
        # copied in after a record too: the warm-up may have written the
        # static tiles in place
        for k, v in inputs.items():
            if v is not None:
                self._static_in[k].copy_(_host_or_tensor(v))
        start, stop = self._events
        start.record()
        self._graph.replay()
        stop.record()
        self.replays += 1
        out: Dict[Hashable, torch.Tensor] = {}
        for k, v in self._static_out.items():
            dst = inputs.get(k)
            if donate and isinstance(dst, torch.Tensor) \
                    and dst.device == device and dst.shape == v.shape \
                    and dst.dtype == v.dtype:
                out[k] = dst.copy_(v)
            else:
                out[k] = v.clone()
        return out

    def _written(self, state: Dict[Hashable, Any]) -> Dict[Hashable, Any]:
        """The written tiles of a final ``state``."""
        return {k: state[k] for k in self._written_keys()
                if state.get(k) is not None}

    def record(self, inputs: Dict[Hashable, Any], device: torch.device,
               replay_stream: Any = None) -> None:
        """Warm up and record the graph over static copies of ``inputs``
        (under the process-wide record lock), capturing on the own stream
        of ``replay_stream``, the stream its replays run on (default: the
        current one)."""
        with _record_lock:
            self._record(inputs, device, replay_stream)

    def _record(self, inputs: Dict[Hashable, Any], device: torch.device,
                replay_stream: Any) -> None:
        from ..ops import kernels
        self.reset()
        device = torch.device(device)
        t0 = time.perf_counter()
        static_in = {k: None if v is None
                     else _host_or_tensor(v).to(device, copy=True)
                     for k, v in inputs.items()}
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        # this thread's launches only: other threads may launch meanwhile
        launches = kernels.thread_matmul_launches()
        with torch.cuda.stream(side):
            self._execute(static_in, device, _no_note)
        torch.cuda.current_stream(device).wait_stream(side)
        warmup_launches = kernels.thread_matmul_launches() - launches
        label = ["(before the first task)"]

        def note(task: str) -> None:
            label[0] = task

        graph = torch.cuda.CUDAGraph()
        launches = kernels.thread_matmul_launches()
        failure: Optional[BaseException] = None
        # the capture stream reads static_in after every earlier writer;
        # torch.cuda.graph's context manager is not used: when ending an
        # invalidated capture raises, it leaves its capture stream current
        torch.cuda.synchronize(device)
        if replay_stream is None:
            replay_stream = torch.cuda.current_stream(device)
        capture = own_stream(device, ("capture", replay_stream.cuda_stream))
        with torch.cuda.stream(capture):
            # thread_local: the runtime's idle worker threads may poll
            # their events meanwhile without breaking this capture
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_out = self._execute(static_in, device, note)
            except Exception as exc:
                failure = exc
            try:
                graph.capture_end()
            except RuntimeError as exc:   # the capture was invalidated
                failure = failure if failure is not None else exc
        if failure is not None:
            raise CaptureError(f"{self.name}: task {label[0]} cannot be "
                               f"recorded into a CUDA graph: {failure}") \
                from failure
        self.warmup_gemm_launches = warmup_launches
        self.captured_gemm_launches = \
            kernels.thread_matmul_launches() - launches
        self._static_out = self._written(static_out)
        self._static_in = static_in
        self._graph = graph
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        self._device = device
        self._signature = _signature(inputs)
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0


def _signature(inputs: Dict[Hashable, Any]):
    return tuple((k, None if v is None else (tuple(v.shape), str(v.dtype)))
                 for k, v in inputs.items())


def _no_note(task: str) -> None:
    pass
