"""Live cross-rank counter aggregation — the aggregator_visu analog.

Reference behavior: a demo TCP server (tools/aggregator_visu/demo_server.c)
receives PAPI-SDE counter pushes from every rank of a running job; a
Python GUI aggregates and plots them live (tools/aggregator_visu/, SURVEY
§5.1 "live telemetry").

Here: a threaded line-JSON TCP server
(``AggregatorServer``) plus a per-context daemon pusher (``SDEPusher``)
that samples ``ctx.sde`` every interval and ships
``{"rank", "ts", "counters": {...}}``. The server keeps the latest and
extremal samples per (counter, rank) and serves a fleet-wide aggregate —
the same min/max/last/sum_of_last table ``tools/counter_aggregate.py``
computes offline — to pull clients that send the single line ``QUERY``.
Enable from any run with ``--mca sde_push host:port`` (interval knob
``sde_push_interval_ms``).
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Dict, Optional

from ..obs.prometheus import fleet_to_prometheus

__all__ = ["AggregatorServer", "SDEPusher", "fleet_to_prometheus"]


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        server: "AggregatorServer" = self.server.owner  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b"GET "):
                # minimal HTTP so a Prometheus scraper (or curl) can hit
                # the same port: GET /metrics returns text exposition of
                # every rank's latest pushed counters
                self._serve_http(server, line)
                return
            if line == b"QUERY":
                payload = json.dumps(server.fleet()).encode() + b"\n"
                self.wfile.write(payload)
                self.wfile.flush()
                continue
            try:
                msg = json.loads(line.decode())
            except ValueError:
                continue
            if isinstance(msg, dict):  # well-formed non-object JSON: drop
                server._ingest(msg)

    def _serve_http(self, server: "AggregatorServer", request: bytes) -> None:
        # drain the request headers (blank line terminates)
        for raw in self.rfile:
            if not raw.strip():
                break
        path = request.split()[1].decode(errors="replace") \
            if len(request.split()) > 1 else "/"
        if path in ("/metrics", "/"):
            body = fleet_to_prometheus(server.fleet()).encode()
            head = (b"HTTP/1.0 200 OK\r\n"
                    b"Content-Type: text/plain; version=0.0.4\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\n\r\n")
        elif path in ("/health", "/timeline"):
            # obs_live: fleet-merged health snapshot /
            # merged detector-firing timeline, JSON
            doc = (server.health_fleet() if path == "/health"
                   else server.timeline())
            body = json.dumps(doc).encode() + b"\n"
            head = (b"HTTP/1.0 200 OK\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\n\r\n")
        else:
            body = b"not found\n"
            head = (b"HTTP/1.0 404 Not Found\r\n"
                    b"Content-Type: text/plain\r\n"
                    b"Content-Length: " + str(len(body)).encode() +
                    b"\r\n\r\n")
        self.wfile.write(head + body)
        self.wfile.flush()


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class AggregatorServer:
    """Collects counter pushes; query with :meth:`fleet` (in-process) or
    by sending ``QUERY`` over a TCP connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = _TCPServer((host, port), _Handler)
        self._srv.owner = self  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address[:2]
        self._lock = threading.Lock()
        # {counter: {rank: {"last", "min", "max", "n", "ts"}}}
        self._series: Dict[str, Dict[int, Dict[str, Any]]] = {}
        # obs_live: latest per-rank health snapshot (the
        # "health" key of a push, present only when the sender runs
        # with the knob set)
        self._health: Dict[int, Dict[str, Any]] = {}
        self.nb_pushes = 0
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "AggregatorServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="sde-aggregator", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _ingest(self, msg: Dict[str, Any]) -> None:
        rank = int(msg.get("rank", 0))
        ts = float(msg.get("ts", time.time()))
        counters = msg.get("counters") or {}
        health = msg.get("health")
        with self._lock:
            self.nb_pushes += 1
            if isinstance(health, dict):
                self._health[rank] = health
            for name, value in counters.items():
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                per_rank = self._series.setdefault(name, {})
                cell = per_rank.get(rank)
                if cell is None:
                    per_rank[rank] = {"last": v, "min": v, "max": v,
                                      "n": 1, "ts": ts}
                else:
                    cell["last"] = v
                    cell["min"] = min(cell["min"], v)
                    cell["max"] = max(cell["max"], v)
                    cell["n"] += 1
                    cell["ts"] = ts

    def fleet(self) -> Dict[str, Any]:
        """The live analog of counter_aggregate.aggregate(): per-rank
        stats plus fleet-wide min/max/sum_of_last per counter."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name, per_rank in sorted(self._series.items()):
                ranks = {str(r): dict(cell)
                         for r, cell in sorted(per_rank.items())}
                lasts = [cell["last"] for cell in per_rank.values()]
                out[name] = {
                    "ranks": ranks,
                    # min/max span every sample seen (matching the offline
                    # counter_aggregate table), not just the latest values
                    "fleet": {"nb_ranks": len(per_rank),
                              "min": min(c["min"] for c in per_rank.values()),
                              "max": max(c["max"] for c in per_rank.values()),
                              "sum_of_last": sum(lasts)},
                }
            return {"counters": out, "nb_pushes": self.nb_pushes}

    def health_fleet(self) -> Dict[str, Any]:
        """The fleet-merged health document ``GET /health`` serves:
        per-rank snapshots folded over the comm plane exactly like the
        counter aggregation (worst status, merged firings, fleet-wide
        per-link exposure and worst link)."""
        from ..obs.live import fleet_health
        with self._lock:
            per_rank = {r: dict(s) for r, s in self._health.items()}
        return fleet_health(per_rank)

    def timeline(self) -> Dict[str, Any]:
        """The merged detector-firing timeline ``GET /timeline``
        serves: every rank's recent firings on one time axis (wall
        clock — firings are stamped with time.time() at the source)."""
        with self._lock:
            per_rank = {r: list(s.get("firings") or ())
                        for r, s in self._health.items()}
        events = [dict(f) for firings in per_rank.values()
                  for f in firings if isinstance(f, dict)]
        events.sort(key=lambda f: f.get("ts", 0.0))
        return {"nb_ranks": len(per_rank), "events": events}

    def clear_health(self) -> None:
        """Forget every rank's health snapshot — a soak driver calls
        this between iterations so each record reflects one iteration's
        firings only."""
        with self._lock:
            self._health.clear()


class SDEPusher:
    """Daemon thread sampling an SDERegistry and pushing snapshots to an
    AggregatorServer address (host:port). One per Context (= per rank)."""

    def __init__(self, sde, addr: str, rank: int = 0,
                 interval: float = 1.0, extra_sde=None,
                 health_fn=None) -> None:
        host, sep, port = addr.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(
                f"sde_push address {addr!r} is not host:port")
        self._addr = (host or "127.0.0.1", int(port))
        self._sde = sde
        # optional second registry merged into every push (the process-
        # global one: named mempools, contextless user counters); the
        # primary registry wins on name collision
        self._extra_sde = extra_sde
        # obs_live: optional zero-arg callable returning the
        # rank's health snapshot dict, shipped under "health" with each
        # push (absent when the knob is unset)
        self._health_fn = health_fn
        self.rank = rank
        self.interval = interval
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread = threading.Thread(target=self._run, name="sde-push",
                                        daemon=True)

    def start(self) -> "SDEPusher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def push_once(self) -> bool:
        """One synchronous sample+send; False if the server is unreachable
        (pushes are best-effort: telemetry must never take down the run)."""
        merged = dict(self._extra_sde.snapshot()) \
            if self._extra_sde is not None else {}
        merged.update(self._sde.snapshot())
        snap = {k: v for k, v in merged.items()
                if isinstance(v, (int, float))}
        doc = {"rank": self.rank, "ts": time.time(), "counters": snap}
        if self._health_fn is not None:
            try:
                doc["health"] = self._health_fn()
            except Exception:  # noqa: BLE001 - best-effort telemetry
                pass
        msg = json.dumps(doc) + "\n"
        try:
            if self._sock is None:
                self._sock = socket.create_connection(self._addr, timeout=2)
            self._sock.sendall(msg.encode())
            return True
        except OSError:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            return False

    def _run(self) -> None:
        while not self._stop.is_set():
            self.push_once()
            self._stop.wait(self.interval)
        self.push_once()  # final sample so short runs are visible
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
