"""LocalFabric: N SPMD ranks inside one process.

The test transport: every rank is a thread with its own Context; messages
are queued between per-rank inboxes with payload deep-copies to model the
wire. This is the analog of the reference's CI strategy — distributed
behavior validated by oversubscribed mpiexec on one node with no fake
network backend (SURVEY.md §4) — except the "node" is one process.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.lists import Fifo
from ..data.data import is_device_array, mark_ready, wait_ready
from .engine import (CommEngine, RankFailedError, TAG_GET_DATA,
                     TAG_GET_REQ, TAG_PUT_DATA)


class LocalFabric:
    """The shared 'network': per-rank inboxes + a barrier."""

    def __init__(self, nb_ranks: int) -> None:
        self.nb_ranks = nb_ranks
        self.inboxes: List[Fifo] = [Fifo() for _ in range(nb_ranks)]
        self.barrier = threading.Barrier(nb_ranks)
        self.engines: List[Optional["LocalCommEngine"]] = [None] * nb_ranks
        self.msg_count = 0
        self.bytes_count = 0
        # ranks that fini'd CLEANLY (the in-process analog of the TCP
        # GOODBYE): the heartbeat detector must never declare these
        # failed when their pings stop
        self.finished: set = set()
        self._stat_lock = threading.Lock()

    def engine(self, rank: int) -> "LocalCommEngine":
        eng = LocalCommEngine(self, rank)
        self.engines[rank] = eng
        return eng

    def _post(self, dst: int, src: int, tag: int, payload: Any) -> None:
        with self._stat_lock:
            self.msg_count += 1
            self.bytes_count += _payload_bytes(payload)
        self.inboxes[dst].push((src, tag, payload))
        eng = self.engines[dst]
        if eng is not None:
            eng._notify_arrival()  # wake a parked worker on the dst rank


def _payload_bytes(payload: Any) -> int:
    if isinstance(payload, np.ndarray):
        return payload.nbytes
    if is_device_array(payload):
        return payload.numel() * payload.element_size()
    if isinstance(payload, dict):
        return sum(_payload_bytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(_payload_bytes(v) for v in payload)
    return 8


def _wire_copy(payload: Any) -> Any:
    """Deep-copy arrays and tensors to model serialization: nothing is
    shared by reference across ranks, so a sender's later in-place write
    cannot reach a receiver's copy."""
    if isinstance(payload, np.ndarray):
        return payload.copy()
    if is_device_array(payload):
        # a tensor from another stream (mark_ready) is copied after its
        # producer's event, and the copy is marked for its consumer
        return mark_ready(wait_ready(payload).detach().clone())
    if isinstance(payload, dict):
        return {k: _wire_copy(v) for k, v in payload.items()}
    if isinstance(payload, tuple):
        return tuple(_wire_copy(v) for v in payload)
    if isinstance(payload, list):
        return [_wire_copy(v) for v in payload]
    return payload


class LocalCommEngine(CommEngine):
    def __init__(self, fabric: LocalFabric, rank: int) -> None:
        super().__init__(rank, fabric.nb_ranks)
        self.fabric = fabric
        self._get_cbs: Dict[int, Callable] = {}
        self._get_srcs: Dict[int, int] = {}  # token -> peer rank owing data
        self._get_iter = 0
        self._lock = threading.Lock()
        # GET aggregation: gets issued from handlers DURING a progress
        # drain batch per peer and flush as ONE request frame at the end
        # of that progress call (several same-cycle rendezvous to one
        # peer cost one wire round-trip instead of N). Depth is
        # per-thread: progress() runs on every scheduler thread.
        self._get_queue: Dict[int, List[Tuple[int, int]]] = {}
        self._drain_depth = threading.local()
        self.tag_register(TAG_GET_REQ, self._on_get_req)
        self.tag_register(TAG_GET_DATA, self._on_get_data)
        self.tag_register(TAG_PUT_DATA, self._on_put_data)

    # -- AMs ----------------------------------------------------------------
    # transport extension points: subclasses replace these two to carry
    # the same AM/GET/PUT emulation over another wire (comm/tcp.py)
    def _transport_post(self, dst: int, src: int, tag: int, payload: Any) -> None:
        for _ in range(self.ft_outbound(dst, tag)):
            self.fabric._post(dst, src, tag, payload)

    def _transport_drain(self):
        """Yield pending (src, tag, payload) messages."""
        inbox = self.fabric.inboxes[self.rank]
        while True:
            item = inbox.pop()
            if item is None:
                return
            yield item

    def send_am(self, dst: int, tag: int, payload: Any) -> None:
        # self-sends also loop back through the inbox for ordering fidelity
        if dst != self.rank and dst in self.dead_peers:
            raise RankFailedError(dst, "send to failed rank")
        obs = self._obs
        if obs is None:
            self._transport_post(dst, self.rank, tag,
                                 self._copy_for_wire(payload))
            return
        ctx = None
        if self._flow is not None:
            payload, ctx = self._flow_stamp(dst, tag, payload)
        t0 = time.monotonic_ns()
        self._transport_post(dst, self.rank, tag,
                             self._copy_for_wire(payload))
        obs.am_sent(self.rank, dst, tag, payload, t0)
        if ctx is not None:
            obs.flow_sent(dst, tag, ctx, t0)

    def _copy_for_wire(self, payload: Any) -> Any:
        """What the receiver gets (transport hook: the mesh engine hands
        device tensors over by reference)."""
        return _wire_copy(payload)

    # -- one-sided emulation (GET-req AM + data reply) ----------------------
    def get(self, src_rank: int, remote_handle_id: int,
            on_complete: Callable[[Any], None]) -> None:
        with self._lock:
            self._get_iter += 1
            token = self._get_iter
            self._get_cbs[token] = on_complete
            self._get_srcs[token] = src_rank
        obs = self._obs
        if obs is not None:
            obs.get_begin(token, src_rank)
        if getattr(self._drain_depth, "n", 0) > 0:
            # inside a progress drain on this thread: batch — the flush
            # at the end of this progress call sends one request per
            # peer covering every GET the drained messages triggered
            with self._lock:
                self._get_queue.setdefault(src_rank, []).append(
                    (remote_handle_id, token))
            return
        self.send_am(src_rank, TAG_GET_REQ,
                     {"requester": self.rank,
                      "gets": [(remote_handle_id, token)]})

    def _flush_gets(self) -> None:
        with self._lock:
            if not self._get_queue:
                return
            pending, self._get_queue = self._get_queue, {}
        first_exc = None
        for peer, gets in pending.items():
            try:
                self.send_am(peer, TAG_GET_REQ,
                             {"requester": self.rank, "gets": gets})
            except Exception as exc:  # noqa: BLE001 - e.g. RankFailedError
                # one dead peer must not starve the OTHER peers' batched
                # requests (their callbacks would never fire); send to
                # everyone, then surface the first failure
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc

    def _serve_get(self, requester: int, h: Any) -> Any:
        """One GET reply's payload (transport hook: the mesh engine
        copies the buffer onto the requester's device here)."""
        return h.array

    def _on_get_req(self, src: int, payload: Any) -> None:
        req = payload["requester"]
        items = []
        quantize_ok = True
        for handle_id, token in payload["gets"]:
            h = self._mem.get(handle_id)
            if h is None:
                raise RuntimeError(f"GET for unknown mem handle {handle_id}")
            quantize_ok = quantize_ok and h.quantize_ok
            items.append({"token": token, "data": self._serve_get(req, h),
                          "meta": h.meta})
        # every same-cycle GET from one requester rides ONE reply frame;
        # the reply is quantize-eligible only when EVERY served handle
        # was registered as a tile payload
        msg = {"items": items}
        if items and quantize_ok:
            msg["_qz_ok"] = True
        self.send_am(req, TAG_GET_DATA, msg)
        if self.on_get_served is not None:
            for handle_id, _token in payload["gets"]:
                self.on_get_served(handle_id)

    def _on_get_data(self, src: int, payload: Any) -> None:
        first_exc = None
        obs = self._obs
        for item in payload["items"]:
            with self._lock:
                cb = self._get_cbs.pop(item["token"])
                self._get_srcs.pop(item["token"], None)
            if obs is not None:
                # one matched begin/end span per one-sided transfer
                obs.get_end(item["token"], src, item["data"])
            try:
                cb(item["data"])
            except Exception as exc:  # noqa: BLE001
                # the reply frame carries SEVERAL gets: one callback
                # failing must not strand the remaining tokens — deliver
                # everything, then surface the first failure
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc

    def put(self, dst_rank: int, remote_handle_id: int, array: Any,
            on_complete: Optional[Callable] = None) -> None:
        """One-sided put: copy into the remote registered region
        (PUT-data AM applied on the receiver's progress)."""
        obs = self._obs
        t0 = time.monotonic_ns() if obs is not None else 0
        self.send_am(dst_rank, TAG_PUT_DATA,
                     {"handle": remote_handle_id, "data": array})
        if obs is not None:
            obs.put(dst_rank, array, t0)
        if on_complete is not None:
            on_complete(array)

    def _on_put_data(self, src: int, payload: Any) -> None:
        h = self._mem.get(payload["handle"])
        if h is None:
            raise RuntimeError(f"PUT for unknown mem handle "
                               f"{payload['handle']}")
        np.copyto(h.array, payload["data"])

    # -- progress -----------------------------------------------------------
    def progress(self) -> int:
        if self._ft_silenced:
            return 0   # injected kill: the inbox is never drained again
        n = 0
        obs = self._obs
        t0 = time.monotonic_ns() if obs is not None else 0
        tl = self._drain_depth
        tl.n = getattr(tl, "n", 0) + 1
        ok = False
        try:
            for src, tag, payload in self._transport_drain():
                if self.deliver_message(src, tag, payload):
                    n += 1
            ok = True
        finally:
            tl.n -= 1
            if tl.n == 0:
                if ok:
                    self._flush_gets()
                else:
                    # a handler raised mid-drain: still try to flush so
                    # live peers' batched GETs are not stranded, but the
                    # in-flight error must win over any flush failure
                    try:
                        self._flush_gets()
                    except Exception:  # noqa: BLE001
                        pass
        if obs is not None:
            obs.progress(n, t0)  # span only when work was done
        return n

    def mesh_local_with(self, peer: int) -> bool:
        """In-process SPMD ranks share one address space and one CUDA
        context: a device tensor can be handed to ``peer`` device to
        device, with no host bytes (the test-fabric analog of two ranks
        whose devices sit on one mesh)."""
        return 0 <= peer < self.nb_ranks

    def clock_offset_us(self, peer: int) -> float:
        """In-process ranks share ONE monotonic clock: the cross-rank
        trace offset is identically zero — the estimator only exists on
        cross-process transports (comm/tcp.py)."""
        return 0.0

    def clock_offsets_us(self) -> Dict[int, float]:
        return {p: 0.0 for p in range(self.nb_ranks) if p != self.rank}

    def sync(self) -> None:
        self.fabric.barrier.wait()

    def peer_finished(self, peer: int) -> bool:
        with self.fabric._stat_lock:
            return peer in self.fabric.finished

    def ft_ping(self, peer: int, seq: int, t_ns: int) -> bool:
        """Probe-layer support gate (the in-process analog of TCP's
        HELLO ``hb`` capability): only probe engines with a live
        TAG_HEARTBEAT handler — the detector never judges a peer it
        could not probe, so a handler-less (mixed-version) peer is
        never declared dead."""
        from .engine import TAG_HEARTBEAT
        eng = (self.fabric.engines[peer]
               if 0 <= peer < len(self.fabric.engines) else None)
        if eng is None or TAG_HEARTBEAT not in eng._tag_cbs:
            return False
        return super().ft_ping(peer, seq, t_ns)

    def ft_elastic_send(self, peer: int, payload: Any) -> bool:
        """Same support gate as ``ft_ping``, for membership traffic
        (the in-process analog of TCP's HELLO ``el`` capability): a
        peer without a TAG_ELASTIC handler must never be drawn into a
        resize agreement."""
        from .engine import TAG_ELASTIC
        eng = (self.fabric.engines[peer]
               if 0 <= peer < len(self.fabric.engines) else None)
        if eng is None or TAG_ELASTIC not in eng._tag_cbs:
            return False
        return super().ft_elastic_send(peer, payload)

    def fini(self) -> None:
        # clean-shutdown advertisement (the in-process GOODBYE): a rank
        # under an injected kill died SILENTLY and must not mark itself
        # finished — proactive detection is the only way peers learn
        if not self._ft_silenced:
            with self.fabric._stat_lock:
                self.fabric.finished.add(self.rank)
