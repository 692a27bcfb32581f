"""ServeClient: remote front-end for a SessionServer on another rank.

Requests ride ``TAG_SERVE`` active messages (versioned envelopes from
:mod:`parsec_tpu_torch.comm.wire`); replies arrive on ``TAG_SERVE_REPLY`` and
are correlated by a per-client request id.  Over TCP both ends must
have negotiated the HELLO ``"sv"`` capability (``serve`` knob set on
both) — the client refuses to talk to a peer that did not, mirroring
the server-side gate, so a mixed-version fleet degrades to an explicit
error instead of silence.

The calling thread blocks on a condition variable until its reply is
delivered — which happens on whichever thread drains the engine's
progress (a comm thread, a scheduler idle cycle, or an explicit
``progress()`` pump in engine-only tests).

One client per engine: the engine keeps ONE handler per tag, so a
second ServeClient would silently detach the first's reply path —
construction raises instead, and :meth:`close` releases the tag (and
wakes any parked callers) so a successor can attach."""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..comm import wire
from ..comm.engine import TAG_SERVE, TAG_SERVE_REPLY

__all__ = ["ServeClient", "ServeTimeout"]

_GUARDED_BY = {
    "ServeClient._replies": "_cond",
    "ServeClient._next_req": "_cond",
    "ServeClient._closed": "_cond",
}


class ServeTimeout(TimeoutError):
    """No reply from the session server within the deadline."""


class ServeClient:
    def __init__(self, ce, server_rank: int,
                 timeout: float = 30.0) -> None:
        self._ce = ce
        self._dst = int(server_rank)
        self._timeout = float(timeout)
        self._cond = threading.Condition()
        self._replies: Dict[int, Dict[str, Any]] = {}
        self._next_req = 0
        self._closed = False
        registered = getattr(ce, "tag_registered", None)
        if registered is not None and registered(TAG_SERVE_REPLY):
            raise RuntimeError(
                "TAG_SERVE_REPLY already has a handler on this engine: "
                "one ServeClient per engine (close() the previous "
                "client before constructing another)")
        ce.tag_register(TAG_SERVE_REPLY, self._on_reply)

    def close(self) -> None:
        """Detach from the engine: release the reply tag for a
        successor client and fail any calls still parked in
        :meth:`_call` (they raise instead of riding their timeout)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._ce.tag_unregister(TAG_SERVE_REPLY)

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _on_reply(self, src: int, payload: Any) -> None:
        try:
            msg = wire.parse_serve(payload)
        except ValueError:
            return
        with self._cond:
            self._replies[msg["req"]] = msg
            self._cond.notify_all()

    def _call(self, op: str, timeout: Optional[float] = None,
              **kw) -> Dict[str, Any]:
        if not self._ce.serve_to(self._dst):
            raise RuntimeError(
                f"rank {self._dst} did not negotiate the sv capability "
                f"(serve knob unset on one end)")
        with self._cond:
            if self._closed:
                raise RuntimeError("ServeClient is closed")
            self._next_req += 1
            req = self._next_req
        self._ce.send_am(self._dst, TAG_SERVE,
                         wire.serve_request(op, req, **kw))
        budget = timeout if timeout is not None else self._timeout
        with self._cond:
            self._cond.wait_for(
                lambda: req in self._replies or self._closed,
                timeout=budget)
            if req in self._replies:
                return self._replies.pop(req)
            if self._closed:
                raise RuntimeError(
                    f"ServeClient closed while op {op!r} was in flight")
            raise ServeTimeout(
                f"serve op {op!r} to rank {self._dst}: no reply "
                f"within {budget:.1f}s")

    # -- API ----------------------------------------------------------------
    def open_tenant(self, tenant: str, weight: Optional[int] = None,
                    quota_bytes: Optional[int] = None, max_pools: int = 0,
                    max_tasks: int = 0) -> Dict[str, Any]:
        msg = self._call("open", tenant=tenant, weight=weight,
                         quota_bytes=quota_bytes, max_pools=max_pools,
                         max_tasks=max_tasks)
        if not msg.get("ok"):
            raise RuntimeError(msg.get("error", "open_tenant failed"))
        return msg

    def submit(self, tenant: str, build: Callable[[], Any], *,
               nbytes: int = 0, ntasks: int = 1,
               name: Optional[str] = None) -> int:
        """Submit a pool-building callable; returns the server ticket.

        ``build`` travels pickled through the AM layer — it must be a
        module-level callable (the same constraint DTD closures over
        the wire already have).  Raises on rejection."""
        msg = self._call("submit", tenant=tenant, build=build,
                         nbytes=nbytes, ntasks=ntasks, name=name)
        if not msg.get("ok"):
            raise RuntimeError(msg.get("error", "submit rejected"))
        return int(msg["ticket"])

    def wait(self, ticket: int,
             timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the submitted pool completes on the server."""
        msg = self._call("wait", timeout=timeout, ticket=ticket)
        if not msg.get("ok"):
            raise RuntimeError(msg.get("error", f"wait({ticket}) failed"))
        return msg

    def stats(self) -> Dict[str, Any]:
        msg = self._call("stats")
        if not msg.get("ok"):
            raise RuntimeError(msg.get("error", "stats failed"))
        return msg["stats"]
