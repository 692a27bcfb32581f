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
                      "PTG dependency tracking: hash (dynamic table) is "
                      "the only mode of this package")
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
    params.reg_string("termdet", "local", "termination detection module")
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
    params.reg_bool("cuda_eager_complete", True,
                    "release deps at kernel launch (one device stream "
                    "orders the dataflow); off = wait for the launch's "
                    "completion event")
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
    # knobs of subsystems this package does not carry yet: registered
    # so that a caller who sets one gets NotImplementedError at init
    # (runtime/context.py) instead of a silently ignored request
    for name in TRIMMED_KNOBS:
        params.reg_string(name, "", "not supported by this package; "
                          "setting it raises NotImplementedError")


#: knobs of the JAX package's subsystems that this package leaves out
#: (comm, fault tolerance, obs, tuning, serving, stage compilation,
#: chip meshes, the debug-history ring, live counter push)
TRIMMED_KNOBS = ("comm_transport", "comm_thread", "ft_heartbeat_interval",
                 "ft_inject", "ft_elastic", "ft_restart_policy",
                 "metrics", "obs_flow", "obs_live", "tune_auto", "serve",
                 "sde_push", "stage_compile", "device_mesh_shape",
                 "debug_history_size", "ptg_dispatch")


register_core_params()
