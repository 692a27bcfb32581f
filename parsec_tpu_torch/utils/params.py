"""MCA-style layered configuration parameters.

Reference behavior reproduced: PaRSEC registers typed, named parameters per
subsystem and resolves them from (in priority order) command line
``--mca name value``, environment ``PARSEC_MCA_<name>``, per-user/system config
files, and compiled defaults (ref: parsec/utils/mca_param.c, SURVEY.md §5.6).

A small registry with the same resolution order; the config file format
is ``name = value`` lines.  The PyTorch port keeps its own registry,
separate from the JAX package's, so the two packages can share one
process (the parity tests) without seeing each other's overrides.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_ENV_PREFIX = "PARSEC_MCA_"
_lock = threading.RLock()


@dataclass
class Param:
    name: str
    type: str  # "int" | "string" | "sizet" | "bool"
    default: Any
    help: str = ""
    # resolution cache
    _value: Any = None
    _source: str = "default"
    _resolved: bool = False

    def _coerce(self, raw: Any) -> Any:
        if self.type == "int":
            return int(raw)
        if self.type == "sizet":
            v = int(str(raw), 0)
            if v < 0:
                raise ValueError(f"sizet param {self.name} must be >= 0, got {v}")
            return v
        if self.type == "bool":
            if isinstance(raw, bool):
                return raw
            return str(raw).strip().lower() in ("1", "true", "yes", "on")
        return str(raw)


class ParamRegistry:
    """Registry of MCA parameters with layered resolution."""

    def __init__(self) -> None:
        self._params: Dict[str, Param] = {}
        self._cmdline: Dict[str, str] = {}
        self._file_values: Dict[str, str] = {}
        self._files_loaded = False
        # scoped-override bookkeeping (cmdline_override): per name, the
        # pre-override state plus a stack of live override tokens, so
        # CONCURRENT overrides of one name from several threads (spmd
        # rank threads all entering the same context manager) unwind to
        # the true original instead of each other's values
        self._overrides: Dict[str, Dict[str, Any]] = {}

    # -- registration ------------------------------------------------------
    def register(self, name: str, type: str, default: Any, help: str = "") -> Param:
        with _lock:
            p = self._params.get(name)
            if p is None:
                p = Param(name=name, type=type, default=default, help=help)
                self._params[name] = p
            return p

    def reg_int(self, name: str, default: int, help: str = "") -> Param:
        return self.register(name, "int", default, help)

    def reg_sizet(self, name: str, default: int, help: str = "") -> Param:
        return self.register(name, "sizet", default, help)

    def reg_string(self, name: str, default: Optional[str], help: str = "") -> Param:
        return self.register(name, "string", default, help)

    def reg_bool(self, name: str, default: bool, help: str = "") -> Param:
        return self.register(name, "bool", default, help)

    # -- external value sources -------------------------------------------
    def set_cmdline(self, name: str, value: str) -> None:
        with _lock:
            self._cmdline[name] = value
            p = self._params.get(name)
            if p is not None:
                p._resolved = False

    def unset_cmdline(self, name: str) -> None:
        """Remove a cmdline-layer override (lower layers shine through
        again); no-op when none is set."""
        with _lock:
            self._cmdline.pop(name, None)
            p = self._params.get(name)
            if p is not None:
                p._resolved = False

    def get_cmdline(self, name: str) -> Optional[str]:
        """Raw cmdline-layer override for ``name`` (None when unset).
        The public accessor for embedders that save/restore overrides —
        the supported alternative to reaching into the private dict."""
        with _lock:
            return self._cmdline.get(name)

    @contextmanager
    def cmdline_override(self, name: str, value: str):
        """Scoped cmdline-layer override: sets ``name`` for the body,
        then restores whatever cmdline value (or absence) was there
        before — safe to nest, exception-safe, and safe under
        CONCURRENT same-name overrides from several threads.

        The naive save/restore (capture ``get_cmdline`` on enter, put
        it back on exit) leaks under concurrency: thread B entering
        while thread A's override is live captures *A's value* as its
        "previous" state and restores it at exit — permanently, once A
        has also exited (the test_stagec-before-test_overlap_pipeline
        ordering flake: spmd rank threads overriding ``stage_compile``
        concurrently left it set for every later test).  Instead each
        enter pushes a token onto a per-name stack that remembers the
        TRUE pre-override state from the first push; each exit removes
        its own token and re-resolves to the top remaining override or
        the original, whichever the stack says."""
        tok = object()
        with _lock:
            ent = self._overrides.get(name)
            if ent is None:
                ent = {"had": name in self._cmdline,
                       "orig": self._cmdline.get(name),
                       "stack": []}
                self._overrides[name] = ent
            ent["stack"].append((tok, value))
            self._cmdline[name] = value
            p = self._params.get(name)
            if p is not None:
                p._resolved = False
        try:
            yield self
        finally:
            with _lock:
                ent = self._overrides.get(name)
                if ent is not None:
                    ent["stack"] = [tv for tv in ent["stack"]
                                    if tv[0] is not tok]
                    if ent["stack"]:
                        # LIFO by surviving pushes: the most recent
                        # still-live override wins (nesting semantics)
                        self._cmdline[name] = ent["stack"][-1][1]
                    else:
                        del self._overrides[name]
                        if ent["had"]:
                            self._cmdline[name] = ent["orig"]
                        else:
                            self._cmdline.pop(name, None)
                p = self._params.get(name)
                if p is not None:
                    p._resolved = False

    def parse_argv(self, argv: List[str]) -> List[str]:
        """Consume ``--mca name value`` / ``--parsec name=value`` pairs.

        Returns argv with consumed options removed (ref: parsec/parsec.c:418-454).
        """
        out: List[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--mca":
                if i + 2 > len(argv) - 1:
                    raise ValueError("--mca requires <name> <value>")
                self.set_cmdline(argv[i + 1], argv[i + 2])
                i += 3
                continue
            if a.startswith("--mca="):
                body = a[len("--mca="):]
                if "=" not in body:
                    raise ValueError("--mca=<name>=<value> expected")
                k, v = body.split("=", 1)
                self.set_cmdline(k, v)
                i += 1
                continue
            if a == "--parsec" and i + 1 < len(argv):
                body = argv[i + 1]
                if "=" in body:
                    k, v = body.split("=", 1)
                    self.set_cmdline(k, v)
                i += 2
                continue
            out.append(a)
            i += 1
        return out

    def _load_files(self) -> None:
        if self._files_loaded:
            return
        self._files_loaded = True
        paths = []
        sysconf = os.environ.get("PARSEC_SYSCONF_PARAMS")
        if sysconf:
            paths.append(sysconf)
        home = os.path.expanduser("~/.parsec/mca-params.conf")
        paths.append(home)
        for path in paths:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line or line.startswith("#"):
                            continue
                        if "=" in line:
                            k, v = line.split("=", 1)
                            self._file_values[k.strip()] = v.strip()
            except OSError:
                continue

    # -- resolution --------------------------------------------------------
    def get(self, name: str) -> Any:
        with _lock:
            p = self._params.get(name)
            if p is None:
                raise KeyError(f"unknown MCA parameter: {name}")
            if p._resolved:
                return p._value
            self._load_files()
            if name in self._cmdline:
                p._value, p._source = p._coerce(self._cmdline[name]), "cmdline"
            elif _ENV_PREFIX + name in os.environ:
                p._value, p._source = p._coerce(os.environ[_ENV_PREFIX + name]), "env"
            elif name in self._file_values:
                p._value, p._source = p._coerce(self._file_values[name]), "file"
            else:
                p._value, p._source = p.default, "default"
            p._resolved = True
            return p._value

    def source(self, name: str) -> str:
        self.get(name)
        return self._params[name]._source

    def get_or(self, name: str, type: str, default: Any) -> Any:
        with _lock:
            if name not in self._params:
                self.register(name, type, default)
            return self.get(name)

    def dump(self) -> Dict[str, Any]:
        return {n: self.get(n) for n in sorted(self._params)}

    def reset(self) -> None:
        """Test helper: clear caches so env changes are re-read."""
        with _lock:
            self._cmdline.clear()
            self._file_values.clear()
            self._files_loaded = False
            for p in self._params.values():
                p._resolved = False


#: process-wide registry (mirrors the global MCA repository)
params = ParamRegistry()


def register_core_params() -> None:
    """Default knobs carried over from the reference (SURVEY.md §5.6)."""
    params.reg_string("sched", "lfq", "scheduler module to use")
    params.reg_string("bind_threads", "",
                      "worker core binding: \"rr\" or a core list \"0,2,4\" (ref --parsec_bind)")
    params.reg_bool("ptg_codegen", True,
                    "generate per-task-class successor/goal code (jdf2c analog)")
    params.reg_string("ptg_dep_management", "hash",
                      "PTG dependency tracking: hash (dynamic table) or "
                      "static (lowered flat arrays + the native engine, "
                      "ref --dep-management=index-array)")
    params.reg_string("ptg_dispatch", "auto",
                      "static PTG dispatch: auto (the turbo native loop "
                      "when the pool is eligible, else classic), turbo "
                      "(demand it: raise when ineligible) or classic "
                      "(the per-task runtime)")
    params.reg_bool("wave_fuse", True,
                    "wave execution: one call per wave (all classes' "
                    "gathers before any scatter) instead of one per "
                    "(class, chunk)")
    params.reg_int("wave_fuse_bytes", 1 << 30,
                   "wave execution: a wave whose gathers exceed this many "
                   "bytes runs per (class, chunk) instead of fused")
    params.reg_int("wave_fuse_programs", 128,
                   "wave execution: at most this many cached fused wave "
                   "closures per runner; later wave shapes run per "
                   "(class, chunk)")
    # the distributed wave (dsl/ptg/wave_dist.py)
    params.reg_string("wave_dist_collective", "auto",
                      "distributed wave broadcast groups: auto (one "
                      "all_reduce per group over torch.distributed when "
                      "it spans exactly one process per rank, else "
                      "broadcast trees), on (also the in-process lane of "
                      "rank threads in one process; a lane that cannot "
                      "attach raises), off (trees)")
    params.reg_int("wave_dist_collective_min_pct", 50,
                   "multiproc lane: a partial broadcast group smaller "
                   "than this share of the ranks rides trees instead")
    params.reg_string("wave_dist_plane", "auto",
                      "distributed wave payload hop: auto (attach a "
                      "DeviceDataPlane on the TCP transport unless the "
                      "multiproc lane has groups scheduled), on (force), "
                      "off (host bytes over the comm engine)")
    params.reg_string("wave_dist_bcast", "binomial",
                      "distributed wave static broadcast trees: binomial, "
                      "chain or star")
    params.reg_string("wave_reduce_dtype", "",
                      "quantize each collective-lane contribution at the "
                      "reduction boundary (bf16 | int8, the wire codecs); "
                      "empty = full precision")
    params.reg_bool("wave_lazy_writeback", True,
                    "distributed wave: results stay card-resident as lazy "
                    "pool slices pulled one tile at a time on first read "
                    "(0 = one eager pull of the owned rows)")
    params.reg_int("xfer_group_size", 0,
                   "two-level collective group size (ranks per full-"
                   "precision partial sum before the quantized boundary "
                   "hop); 0 = 2")
    params.reg_int("arena_max_used", -1, "cap on arena allocated buffers (-1 off)")
    params.reg_int("arena_max_cached", -1, "cap on arena cached buffers (-1 off)")
    params.reg_int("task_startup_iter", 64, "startup enumerator chunk iterations")
    params.reg_int("task_startup_chunk", 256, "startup enumerator chunk size")
    params.reg_int("device_load_balance_skew", 20,
                   "percent skew favoring the device already holding the data")
    params.reg_bool("runtime_keep_highest_priority_task", True,
                    "keep best ready task on releasing thread, bypass scheduler")
    params.reg_int("verbose", 0, "global debug verbosity")
    params.reg_string("profile", "", "enable profiling; path prefix for traces")
    params.reg_string("profiling_dot", "",
                      "capture the executed DAG; path prefix for DOT files "
                      "(ref: --parsec_dot)")
    params.reg_string("termdet", "local",
                      "termination detection module: local | "
                      "fourcounter (multi-rank pools on a comm engine)")
    # comm engine, remote dependencies and the device data plane
    # (comm/, xfer/); the knobs and defaults of the JAX package
    params.reg_string("runtime_comm_coll_bcast", "binomial",
                      "broadcast topology: star|chain|binomial")
    params.reg_sizet("runtime_comm_short_limit", 4096,
                     "max payload inlined in an activate message")
    params.reg_bool("comm_adaptive_short_limit", False,
                    "tune the eager/rendezvous cutoff per peer from the "
                    "measured GET round-trip and link bandwidth (the "
                    "static runtime_comm_short_limit is the floor, "
                    "comm_short_limit_max the ceiling)")
    params.reg_sizet("comm_short_limit_max", 1 << 20,
                     "ceiling for the adaptive eager/rendezvous cutoff")
    params.reg_sizet("comm_coalesce_max_bytes", 1 << 16,
                     "max bytes of queued small AMs coalesced into one "
                     "wire frame/syscall on the TCP transport (0 = one "
                     "frame per message)")
    params.reg_sizet("comm_chunk_bytes", 1 << 17,
                     "buffers at least this large stream as bounded "
                     "chunk frames so control messages interleave with "
                     "bulk data (TCP transport)")
    params.reg_int("comm_compress_threshold_mbps", 0,
                   "engage negotiated per-link compression when the "
                   "measured send bandwidth EWMA drops below this many "
                   "MB/s and a sample probe shows the traffic "
                   "compresses (0 = never)")
    params.reg_string("comm_quantize", "",
                      "lossy quantized wire codec for bulk float tile "
                      "payloads (bf16 | int8): engaged per link toward "
                      "peers that advertised it at the HELLO (both ends "
                      "must set the knob); empty = off, lossless wire")
    params.reg_int("comm_quantize_threshold_mbps", 0,
                   "engage the quantized codec only when the send-"
                   "bandwidth EWMA toward the peer is below this many "
                   "MB/s (0 = whenever comm_quantize is set)")
    params.reg_sizet("comm_send_buffer_bytes", 1 << 26,
                     "per-peer bounded send buffer: send_am blocks "
                     "while this many bytes are queued ahead of it")
    params.reg_string("comm_reconnect_timeout", "",
                      "reliable TCP sessions: keep a torn peer link in "
                      "SUSPECT and retry reconnecting (with seq-"
                      "numbered frame replay) for up to this many "
                      "seconds before escalating to rank failure; "
                      "empty/0 = off (every socket error is fail-fast)")
    params.reg_string("comm_reconnect_backoff", "",
                      "initial reconnect backoff in seconds (default "
                      "0.05), doubling with jitter up to a 2 s ceiling")
    params.reg_sizet("comm_replay_window_bytes", 1 << 24,
                     "per-peer replay window: sent-but-unacked session "
                     "frames retained for replay after a reconnect")
    params.reg_int("comm_prefetch_inflight", 8,
                   "max rendezvous GETs prefetched for activations that "
                   "arrived ahead of their taskpool's startup counts "
                   "(0 = no GET prefetch)")
    params.reg_string("sde_push", "",
                      "host:port of a live counter aggregator to push SDE "
                      "snapshots to (ref: tools/aggregator_visu)")
    params.reg_int("sde_push_interval_ms", 1000,
                   "milliseconds between SDE pushes")
    # fault tolerance (ft/)
    params.reg_string("ft_heartbeat_interval", "",
                      "seconds between heartbeat probes per peer (e.g. "
                      "0.05); empty/0 = proactive failure detection off")
    params.reg_string("ft_heartbeat_timeout", "",
                      "declare an established peer dead after this many "
                      "seconds of heartbeat silence (default: 8x the "
                      "interval); must exceed the longest un-pumped "
                      "progress stretch on in-process fabrics")
    params.reg_string("ft_detector_mode", "timeout",
                      "liveness judgment: timeout (fixed deadline) | phi "
                      "(phi-accrual-style: deadline scales with the "
                      "observed inter-arrival EWMA, floored at the "
                      "timeout)")
    params.reg_string("ft_inject", "",
                      "deterministic fault-injection spec, e.g. "
                      "\"kill:rank=1:after=3,drop:pct=2:seed=7\" "
                      "(ops: kill, taskfail, drop, dup, delay, failsend, "
                      "flap, disconnect; see ft/inject.py)")
    params.reg_string("ft_restart_policy", "",
                      "restart policy for ft.restart.run_with_restart: "
                      "\"abort\" or "
                      "\"restart:retries=N:backoff=S:every=K\"")
    params.reg_string("ft_elastic", "",
                      "elastic grid recovery (ft/elastic.py): \"shrink\" "
                      "(survivors of a rank loss agree on a reduced grid, "
                      "reshard the last snapshot onto it, and replay), "
                      "\"grow\" (fold announced joiners in at stage "
                      "boundaries), \"both\", or empty (default) for "
                      "the fail-fast abort")
    params.reg_int("ft_elastic_grow_min", 1,
                   "minimum announced joiners worth a grid resize at a "
                   "stage boundary (grow mode)")
    params.reg_string("ft_elastic_timeout", "",
                      "membership-agreement deadline in seconds "
                      "(default 30); on expiry the run falls back to the "
                      "strict abort path with consistent snapshots")
    params.reg_bool("comm_thread", False,
                    "dedicated funnelled comm-progress thread (ref: the "
                    "remote_dep_dequeue_main thread); default: workers "
                    "drain comm during idle cycles")
    params.reg_int("comm_thread_bind", -1,
                   "core to pin the comm thread to (ref: -C; -1 = unbound)")
    params.reg_bool("comm_failure_strict", False,
                    "treat ANY torn peer connection as a rank failure "
                    "(default: only when the peer owes data or is sent to)")
    params.reg_string("comm_transport", "",
                      "auto-wire a comm engine at init: \"tcp\" (endpoints "
                      "from comm_endpoints) or empty for none")
    params.reg_string("comm_endpoints", "",
                      "comma list of host:port control-plane endpoints, "
                      "one per rank, identical on every rank")
    params.reg_int("comm_rank", -1, "this process's rank in comm_endpoints")
    params.reg_string("dist_coordinator", "",
                      "host:port of the torch.distributed TCP store "
                      "(gloo); set on every rank process to initialise "
                      "one process group at init() (a port other than the "
                      "comm engine's listeners)")
    params.reg_int("dist_num_processes", 0,
                   "world size for torch.distributed.init_process_group")
    params.reg_int("dist_process_id", -1,
                   "this process's rank for "
                   "torch.distributed.init_process_group")
    params.reg_string("xfer_backend", "auto",
                      "device data plane backend: \"auto\" (ipc on a "
                      "CUDA device, loopback on the CPU), \"ipc\" (CUDA "
                      "IPC between rank processes on one card), "
                      "\"loopback\" (host sockets)")
    params.reg_bool("xfer_collective_redist", False,
                    "plan collections/redistribute's whole-matrix "
                    "same-grid moves as coalesced alltoall-style "
                    "collective rounds (xfer/plan.py) instead of one DTD "
                    "task per tile; the payload rides the device plane "
                    "where one is attached on both ends; it also switches "
                    "the wave collective lane to the two-level reduction "
                    "(parallel/mesh.two_level_allreduce). Off (default) "
                    "keeps the DTD path and the flat lane")
    params.reg_bool("comm_mesh_local", True,
                    "hand device-tensor payloads to peers in this process "
                    "(comm/mesh.py) device to device, as a private copy "
                    "taken on the producer's stream, never through host "
                    "bytes; off stages every payload through the host")
    params.reg_sizet("debug_history_size", 0,
                     "debug history ring entries (0=off, ref PARSEC_DEBUG_HISTORY)")
    params.reg_int("dtd_window_size", 8000, "DTD sliding window size")
    params.reg_int("dtd_threshold_size", 4000, "DTD backpressure resume threshold")
    # the accelerator device module (devices/cuda.py)
    params.reg_bool("device_cuda_enabled", True,
                    "attach the CUDA device module as the accelerator")
    params.reg_int("device_cuda_max", -1,
                   "max number of CUDA devices to attach (-1 all; this "
                   "package drives one)")
    params.reg_string("device_cuda_platform", "",
                      "torch device the accelerator module drives "
                      "(\"cuda\" or \"cpu\"); empty = cuda:0")
    params.reg_int("device_cuda_virtual_chips", 0,
                   "declare this many logical chips on the accelerator "
                   "module's one device (each an index and a CUDA stream "
                   "of its own, sharing the card's SMs and memory) as the "
                   "chip pool device_mesh_shape carves; 0 = the pool is "
                   "the physical cards cuda:0 .. device_count()-1 (one "
                   "host chip under device=\"cpu\")")
    params.reg_string("device_mesh_shape", "",
                      "attach this rank's chips as ONE mesh device "
                      "(\"PxQ\" grid or a chip count, e.g. \"2x2\" or "
                      "\"4\"): tiles are placed block-cyclically across "
                      "the chips, each chip launches on its own stream, "
                      "and a batched flush group whose size the chip "
                      "count divides is spread over the chips in "
                      "slot-blocks; intra-mesh dependencies hop chip to "
                      "chip as private device copies instead of riding "
                      "the wire. Empty = one device (the pre-mesh "
                      "behavior); too few chips in the pool raises (see "
                      "device_cuda_virtual_chips)")
    params.reg_bool("cuda_eager_complete", True,
                    "release deps at kernel launch (one device stream "
                    "orders the dataflow; on a chip mesh a read across "
                    "chips waits for the hop's event); off = wait for the "
                    "launch's completion event")
    params.reg_int("cuda_eager_window", 32,
                   "max in-flight eager submissions before blocking")
    params.reg_sizet("cuda_memory_fraction_pct", 85,
                     "percent of device memory managed by the arena")
    params.reg_int("device_batch_max", 16,
                   "max same-class ready tasks stacked into one kernel "
                   "launch (<=1 disables batching: every task is its "
                   "own launch)")
    params.reg_string("device_batch_mode", "unroll",
                      "how batched tasks are stacked: unroll (inputs "
                      "stacked on a leading batch dimension; every batch "
                      "element runs exactly the per-task arithmetic, so "
                      "results are bit-exact vs per-task dispatch) — the "
                      "only mode of this package")
    params.reg_int("device_prefetch_depth", 4,
                   "stage-in the inputs of up to this many queued tasks "
                   "ahead of their dispatch (0 = no prefetch)")
    params.reg_int("device_flush_segments", 4,
                   "carve each batched flush group into up to this many "
                   "launches so a segment's written tiles retire while "
                   "the rest of the batch is still queued (<=1 = "
                   "whole-batch flush; segments never shrink below 2 "
                   "tasks)")
    params.reg_bool("device_donate", False,
                    "donate device input buffers of WRITE flows to the "
                    "batched call; not supported by this package")
    params.reg_bool("sched_dynamic_priority", True,
                    "critical-path-driven scheduling: an online per-"
                    "class profile (duration-weighted EWMA fed from "
                    "device dispatch + CPU exec timings) computes an "
                    "upward-rank boost per task class; priority "
                    "schedulers pop critical-path classes first, with "
                    "the PTG spec's static priority as the tiebreak")
    params.reg_bool("metrics", False,
                    "collect runtime metrics (latency histograms + comm/"
                    "device counters) without full trace capture; "
                    "exposition via obs.prometheus / the aggregator")
    params.reg_bool("obs_flow", False,
                    "cross-rank flow tracing: stamp data-plane messages "
                    "with a (origin, span) trace context negotiated via "
                    "the HELLO \"tr\" capability, estimate per-peer "
                    "clock offsets from extended ping/pong exchanges, "
                    "and emit Chrome-trace flow events so "
                    "obs.merge_trace_docs can fuse rank timelines; off "
                    "(default) keeps every wire byte bit-for-bit "
                    "unchanged")
    params.reg_bool("obs_live", False,
                    "in-runtime streaming health monitor: fold closing "
                    "comm/device/exec spans and stitched flow pairs into "
                    "rolling-window per-link exposed-wait, per-rank "
                    "overlap, per-link flow lag, and per-taskpool "
                    "attribution (the flow context grows a taskpool wire "
                    "id + send timestamp toward peers that negotiated "
                    "the HELLO \"lv\" capability); an anomaly layer "
                    "fires straggler / degraded-link / stuck-progress "
                    "detectors against self-calibrated baselines, each "
                    "firing a trace annotation plus PARSEC::OBS::HEALTH::* "
                    "gauges; snapshots ride sde_push so the aggregator "
                    "serves GET /health.  Implies the obs_flow machinery; "
                    "off (default) is bit-for-bit inert: no threads, no "
                    "gauges, no wire change")
    params.reg_int("obs_live_window_ms", 250,
                   "rolling-window tick of the obs_live monitor: "
                   "detector baselines fold one sample per window "
                   "(smaller = faster detection, noisier baselines)")
    params.reg_bool("tune_auto", False,
                    "closed-loop self-tuning (tune/): a controller rides "
                    "the obs_live window tick and adapts the per-link "
                    "quantized codec (runtime K_TUNE renegotiation "
                    "toward peers that advertised the HELLO \"tn\" "
                    "capability), the device pipeline shape "
                    "(device_batch_max / device_prefetch_depth / "
                    "device_flush_segments, hill-climbed with "
                    "revert-on-regress), and stage-compile exclusions "
                    "(inert until stage compilation is carried). Every "
                    "move emits a tune:* annotation on the health stream "
                    "plus PARSEC::TUNE::* gauges. Implies obs_live; off "
                    "(default) constructs nothing and is bit-for-bit "
                    "inert on the wire")
    params.reg_string("tune_residual_budget", "1e-2",
                      "max relative residual the codec ladder may "
                      "spend: qbf16 (~1e-2) needs budget >= 1e-2, "
                      "qint8 (~1e-1) needs budget >= 1e-1; 0 pins "
                      "every link lossless (the controller still "
                      "tunes the device pipeline)")
    params.reg_int("tune_hysteresis_windows", 2,
                   "consecutive agreeing health windows required "
                   "before the controller moves a knob (and the "
                   "cool-down after any move/revert) — larger = "
                   "steadier under oscillating signal, slower to "
                   "react")
    # multi-tenant persistent serving (serve/)
    params.reg_bool("serve", False,
                    "multi-tenant persistent serving (serve/): advertise "
                    "the \"sv\" HELLO capability so SessionServer "
                    "submission endpoints accept remote tenants, and pull "
                    "the obs_live monitor up for per-tenant SLO "
                    "attribution; off (default) constructs nothing and "
                    "keeps the wire bit-for-bit")
    params.reg_string("serve_admission", "reject",
                      "over-quota submission policy: \"reject\" (the "
                      "submission fails with AdmissionError / an error "
                      "reply) or \"queue\" (it parks on the tenant's "
                      "queue and launches when capacity frees)")
    params.reg_int("serve_max_tenants", 64,
                   "max named tenant sessions one SessionServer accepts")
    params.reg_int("serve_default_weight", 1,
                   "fair-share weight a tenant gets when open_tenant "
                   "declares none (>= 1; the deficit fairness boost "
                   "normalizes completed work by this weight)")
    params.reg_sizet("serve_default_quota_bytes", 0,
                     "Mempool byte quota a tenant gets when open_tenant "
                     "declares none (0 = unlimited)")
    params.reg_int("serve_latency_window", 512,
                   "per-tenant taskpool-latency samples kept for the "
                   "P99_LATENCY_US gauge and health snapshots")
    # whole-stage compilation (stagec/)
    params.reg_bool("stage_compile", False,
                    "whole-stage compilation (stagec/): record each "
                    "verified PTG stage as ONE CUDA graph, replayed as a "
                    "single chore on the CUDA device module, with the "
                    "interpreted batched dispatch as the residue/"
                    "fallback path (device=\"cpu\": the stage runs "
                    "eagerly over host tensors); off (default) keeps the "
                    "per-task runtime bit-for-bit")
    params.reg_int("stage_compile_max_tasks", 1024,
                   "max task instances fused into one compiled stage "
                   "(bounds the recorded graph and its private memory "
                   "pool: one output tile a task; larger stages amortize "
                   "dispatch further — cross-stage boundaries pay an "
                   "interpreted release walk per boundary task)")
    params.reg_bool("stage_compile_shard", True,
                    "run eligible wave-front stages over the rank's chip "
                    "mesh (device_mesh_shape): each chip runs its block "
                    "of the wave front's rows on its own stream; off "
                    "forces the single-chip CUDA graph")
    params.reg_bool("stage_compile_chain", True,
                    "cross-pool stage chaining (stagec/chain.py): when a "
                    "taskpool sequence is declared (stagec.chain."
                    "declare_chain / ops.dposv), record the final stage "
                    "of pool K with the first stages of pool K+1 as one "
                    "chained CUDA graph when the inter-pool dataflow is "
                    "provable; off runs each pool's stages separately")
    params.reg_bool("stage_residue_batch", True,
                    "compiled residue schedule: dispatch per-(level, "
                    "class) residue groups pre-planned at stage-plan time "
                    "straight onto the device batching pipeline as one "
                    "burst, skipping the per-task scheduler round-trip; "
                    "off keeps the per-task residue dispatch")
    params.reg_string("stage_compile_exclude", "",
                      "comma-separated task-class names excluded from "
                      "stage compilation (verdict STG306): their "
                      "instances run as interpreted residue — a "
                      "debugging / measurement knob (the residue-heavy "
                      "leg rides it)")
    params.reg_bool("stage_compile_xrank", False,
                    "cross-rank SPMD stages (stagec/xrank.py): run a "
                    "wave-front stage that spans ranks as ONE program "
                    "over the participating ranks' lane chips (each "
                    "rank's rows recorded as a CUDA graph on its lane "
                    "chip), turning inter-rank dependency edges into "
                    "in-program device-to-device gathers of the boundary "
                    "tiles with control-only activations on the wire; "
                    "negotiated per peer via the HELLO \"xs\" capability "
                    "— mixed-version or knob-unset peers keep the "
                    "activation path bit-for-bit; off (default) keeps "
                    "every stage rank-local")
    params.reg_string("stage_xrank_timeout", "60",
                      "seconds a rank waits at a cross-rank stage "
                      "rendezvous for its peers' deposits; past it the "
                      "rendezvous is errored and every participant "
                      "raises (termdet never hangs)")
    params.reg_bool("stage_compile_donate", True,
                    "donation inside compiled stages: a replay writes the "
                    "results of WRITE slots into the slot's own device "
                    "tensor (copy_) instead of a fresh clone, for classes "
                    "the BDY204 analysis proves free of intra-stage tile "
                    "aliasing; the copy's version is bumped, so no reader "
                    "sees a stale payload; off hands back clones")


register_core_params()
