"""Deterministic fault injection: a seeded chaos layer for the runtime.

Robustness claims need tests, and tests need failures on demand — in
process, reproducibly, without real process kills. The injector is
installed from the ``ft_inject`` MCA param and hooks two layers:

- the **wire layer**: every transport's ``_transport_post`` consults
  :meth:`FaultInjector.on_send` (one never-taken branch when no
  injector is installed), which can DROP a frame, DUPLICATE it, DELAY
  it, or FAIL the Nth send outright (``RankFailedError``);
- the **task boundary**: an :class:`FTInjectModule` PINS module (the
  ``COMPLETE_EXEC_END`` site) kills this rank after its Nth task
  completes — the engine goes dark (``ft_silence``: no goodbye, no
  replies, sockets left dangling) and the worker raises
  :class:`InjectedKill`, exactly the observable footprint of a
  SIGKILL'd process — or raises a transient
  :class:`InjectedTaskFault` (the retry-able failure the restart
  driver exercises).

Spec grammar (``--mca ft_inject "..."``): comma-separated directives,
each ``op:key=val:key=val``::

    kill:rank=1:after=3        # rank 1 goes dark at its 3rd task boundary
    taskfail:rank=0:nth=5      # transient task error at the 5th boundary
    drop:rank=*:peer=2:pct=2:seed=7   # drop 2% of frames toward rank 2
    dup:pct=1:seed=7           # duplicate 1% of frames
    delay:pct=5:ms=2:seed=7    # delay 5% of frames by 2 ms
    failsend:rank=0:nth=10     # rank 0's 10th send raises RankFailedError
    flap:rank=2:nth=30:duration=0.3   # rank 2's 30th send hard-closes
                               # the socket(s); the link stays DOWN
                               # (reconnects rejected) for 0.3 s
    disconnect:rank=2:nth=30   # like flap, but the link never comes
                               # back — a permanent fault that must
                               # exhaust the reconnect budget

``rank`` selects which rank's engine acts (default ``*`` = every
rank); ``seed`` makes percentage draws reproducible (the stream is
also salted by rank, so SPMD ranks draw independently but
deterministically). Wire directives never touch heartbeat traffic
unless ``hb=1`` — chaos under test must not blind the detector that
the test is asserting on. ``kill``/``taskfail``/``failsend`` are
one-shot; percentage directives apply for the engine's lifetime.

``flap``/``disconnect`` tear the LINK, not the process (the
transient-vs-permanent distinction the reliable session layer exists
for, comm/tcp.py): the socket(s) toward the directive's ``peer``
filter (default every peer) hard-close with nothing flushed, and the
engine's reconnect attempts — dialing out or accepting the peer's
re-dial — are rejected while the link is down. With sessions enabled
a flap is absorbed by reconnect + replay; a disconnect (or a flap
longer than ``comm_reconnect_timeout``) escalates to the ordinary
rank-failure path. On transports without sockets both are no-ops.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..profiling.pins import PinsEvent, PinsModule

__all__ = ["FaultInjector", "FTInjectModule", "InjectedKill",
           "InjectedTaskFault", "parse_inject_spec"]


class InjectedKill(RuntimeError):
    """This rank was chaos-killed at a task boundary (its engine is
    already dark); the local DAG aborts like a crash would."""

    def __init__(self, rank: int, after: int) -> None:
        super().__init__(
            f"rank {rank}: injected kill after {after} task completions")
        self.rank = rank


class InjectedTaskFault(RuntimeError):
    """A transient injected task failure (survives a retry)."""


_WIRE_OPS = ("drop", "dup", "delay", "failsend", "flap", "disconnect")
_TASK_OPS = ("kill", "taskfail")


def parse_inject_spec(spec: str) -> List[Dict[str, Any]]:
    """Parse the ``ft_inject`` grammar into directive dicts; raises
    ValueError on unknown ops/keys so typos fail at install, not by
    silently injecting nothing."""
    out: List[Dict[str, Any]] = []
    for raw in spec.replace(";", ",").split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        op = parts[0].strip()
        if op not in _WIRE_OPS + _TASK_OPS:
            raise ValueError(
                f"ft_inject: unknown op {op!r} in {raw!r} "
                f"(have {', '.join(_WIRE_OPS + _TASK_OPS)})")
        d: Dict[str, Any] = {"op": op, "rank": "*", "peer": "*",
                             "pct": 0.0, "nth": 0, "seed": 0,
                             "after": 1, "ms": 1.0, "hb": False,
                             "duration": 0.0}
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"ft_inject: expected key=val, got {kv!r}")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k not in d:
                raise ValueError(
                    f"ft_inject: unknown key {k!r} for op {op!r}")
            if k in ("rank", "peer"):
                d[k] = "*" if v.strip() == "*" else int(v)
            elif k in ("pct", "ms", "duration"):
                d[k] = float(v)
            elif k == "hb":
                d[k] = v.strip().lower() in ("1", "true", "yes", "on")
            else:
                d[k] = int(v)
        if op in _WIRE_OPS and d["nth"] <= 0 and d["pct"] <= 0:
            raise ValueError(
                f"ft_inject: {raw!r} would never fire — wire ops need "
                f"nth=N or pct>0")
        out.append(d)
    return out


class FaultInjector:
    """Per-rank injector instance: directives from one spec, counters
    and RNG streams salted by rank (SPMD ranks built from the same
    spec draw deterministically but independently)."""

    def __init__(self, directives: List[Dict[str, Any]], rank: int) -> None:
        self.rank = rank
        self._lock = threading.Lock()
        self._sends = 0        # matching wire events seen
        self._completions = 0  # task boundaries seen
        self._dirs = []
        for d in directives:
            if d["rank"] != "*" and d["rank"] != rank:
                continue
            ent = dict(d)
            ent["fired"] = False
            ent["rng"] = np.random.RandomState(
                (int(d["seed"]) + 1000003 * rank) & 0x7FFFFFFF)
            self._dirs.append(ent)
        self.has_task_actions = any(
            d["op"] in _TASK_OPS for d in self._dirs)
        # link-down intervals from flap/disconnect directives:
        # peer (or "*") -> monotonic deadline (inf = disconnect).
        # Consulted by the transport's reconnect machinery — dial
        # attempts and accepted resumes both fail while down.
        self._link_down: Dict[Any, float] = {}
        self.stats = {"dropped": 0, "duplicated": 0, "delayed": 0,
                      "failed_sends": 0, "kills": 0, "task_faults": 0,
                      "flaps": 0}

    def link_down(self, peer: int) -> bool:
        """Is the (virtual) link toward ``peer`` currently torn by a
        flap/disconnect directive?"""
        with self._lock:
            until = max(self._link_down.get(peer, 0.0),
                        self._link_down.get("*", 0.0))
        return time.monotonic() < until

    @classmethod
    def from_spec(cls, spec: str, rank: int) -> "FaultInjector":
        return cls(parse_inject_spec(spec), rank)

    # -- wire layer (transports call this on every remote post) ---------
    def on_send(self, dst: int, tag: int) -> str:
        """Verdict for one outgoing frame: "ok" | "drop" | "dup"
        (delays sleep in place; failsend raises). ``nth`` counts per
        directive over the sends its filters MATCH, so e.g.
        ``failsend:nth=3`` fires on exactly the 3rd matching send even
        with unmatched (heartbeat, other-peer) traffic interleaved."""
        from ..comm.engine import RankFailedError, TAG_HEARTBEAT
        is_hb = tag == TAG_HEARTBEAT
        with self._lock:
            self._sends += 1
            for d in self._dirs:
                if d["op"] not in _WIRE_OPS or d["fired"] and d["nth"]:
                    continue
                if is_hb and not d["hb"]:
                    continue   # chaos must not blind the detector
                if d["peer"] != "*" and d["peer"] != dst:
                    continue
                d["seen"] = n = d.get("seen", 0) + 1
                hit = (n == d["nth"] if d["nth"]
                       else d["pct"] > 0
                       and d["rng"].rand() * 100.0 < d["pct"])
                if not hit:
                    continue
                if d["nth"]:
                    d["fired"] = True
                op = d["op"]
                if op == "drop":
                    self.stats["dropped"] += 1
                    return "drop"
                if op == "dup":
                    self.stats["duplicated"] += 1
                    return "dup"
                if op == "delay":
                    self.stats["delayed"] += 1
                    delay_s = d["ms"] / 1e3
                    break   # sleep outside the lock
                if op in ("flap", "disconnect"):
                    self.stats["flaps"] += 1
                    until = (float("inf") if op == "disconnect"
                             else time.monotonic() + max(0.0,
                                                         d["duration"]))
                    key = d["peer"] if d["peer"] != "*" else "*"
                    self._link_down[key] = max(
                        self._link_down.get(key, 0.0), until)
                    return "flap"
                # failsend
                self.stats["failed_sends"] += 1
                raise RankFailedError(
                    dst, f"injected failure of send #{n} from rank "
                         f"{self.rank}")
            else:
                return "ok"
        time.sleep(delay_s)
        return "ok"

    # -- task boundary (FTInjectModule calls this per completion) -------
    def on_task_complete(self, context: Any) -> None:
        with self._lock:
            self._completions += 1
            n = self._completions
            trigger = None
            for d in self._dirs:
                if d["op"] not in _TASK_OPS or d["fired"]:
                    continue
                at = d["after"] if d["op"] == "kill" else d["nth"]
                if n >= max(1, at):
                    d["fired"] = True
                    trigger = d
                    break
        if trigger is None:
            return
        if trigger["op"] == "kill":
            self.stats["kills"] += 1
            # go dark FIRST: the abort that follows must leak nothing
            # (no goodbye, no final messages) — peers may only learn of
            # this death proactively, via the heartbeat detector
            comm = getattr(context, "comm", None)
            ce = getattr(comm, "ce", comm)
            if ce is not None and hasattr(ce, "ft_silence"):
                ce.ft_silence()
            raise InjectedKill(self.rank, n)
        self.stats["task_faults"] += 1
        raise InjectedTaskFault(
            f"rank {self.rank}: injected task fault at completion #{n}")


class FTInjectModule(PinsModule):
    """PINS module binding one injector's task-boundary directives to
    one context (the ``COMPLETE_EXEC_END`` site — the reference's
    task-boundary hook). Context-filtered like TaskProfilerModule: with
    several in-process SPMD ranks, each rank's module must see only its
    own completions."""

    name = "ft_inject"
    events = [PinsEvent.COMPLETE_EXEC_END]

    def __init__(self, injector: FaultInjector, context: Any) -> None:
        self.injector = injector
        self.context = context

    def callback(self, es: Any, event: PinsEvent, payload: Any) -> None:
        if es.context is not self.context:
            return
        self.injector.on_task_complete(self.context)
