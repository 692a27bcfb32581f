"""Remote dependencies: the dataflow protocol between ranks.

Reference behavior (SURVEY.md §2.4, §3.3): on task completion the sender's
``iterate_successors`` accumulates per-rank output masks; an **activate**
control message (taskpool_id / task_class_id / locals + output mask) goes
out; small payloads ride inline ("short" protocol, MCA
``runtime_comm_short_limit``), larger ones rendezvous — the receiver issues
a **GET** against the sender's registered memory; incoming data releases
local successors; broadcasts propagate along a virtual topology
(star / chain / binomial, MCA ``runtime_comm_coll_bcast``) with re-forwarding
at each hop (ref: parsec/remote_dep.c:272-358,454;
parsec/remote_dep_mpi.c:997-1082,1800-1906).

The DTD data plane uses tile-sequence matching: SPMD insertion gives every
rank an identical view of each tile's write sequence, so a cross-rank RAW
edge is named by (tile key, write index) — the sender posts after the n-th
write completes, the receiver's recv-task waits for exactly that message
(ref: DTD remote deps inferred from rank_of, insert_function.c).

Payloads on the wire are host numpy arrays: a tile whose newest copy is
a tensor comes down through the device module (``sync_to_host`` /
``to_host_array``), so the copy queues behind the kernel that wrote it.
With a device data plane attached (comm/xfer.py), a device tile above
the short limit is handed over device to device instead.  With
telemetry on (obs/), each activation batch and each DTD send is a
``comm:*`` span, and an activation's wire trace context is published to
the delivering thread.  The JAX package's mesh-local by-reference path
and cross-rank stage elision are not carried.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..data.data import (Coherency, Data, DataCopy, is_device_array,
                         mark_ready, stream_of, to_host_array)
from ..runtime.scheduling import schedule
from ..utils import logging as plog
from ..utils.params import params
from .engine import (CommEngine, RankFailedError, TAG_ACTIVATE,
                     TAG_DTD_DATA, TAG_MEM_PUT, TAG_TERMDET)
from .xfer import TAG_XFER_ACK

_log = plog.comm_stream


def _host(arr: Any) -> Any:
    """A host numpy view of a payload: a tensor is copied down on its
    device module's stream (never aliased), an array passes through."""
    return to_host_array(arr) if is_device_array(arr) else np.asarray(arr)


def bcast_children(me_pos: int, nb: int, topology: str) -> List[int]:
    """Children positions of ``me_pos`` in a broadcast over ``nb``
    participants (position 0 == root)
    (ref: remote_dep_bcast_star/chain/binomial_child, remote_dep.c:334-358)."""
    if topology == "star":
        return list(range(1, nb)) if me_pos == 0 else []
    if topology == "chain":
        return [me_pos + 1] if me_pos + 1 < nb else []
    if topology == "binomial":
        out = []
        mask = 1
        # classic binomial: position p sends to p | mask for masks above p
        while mask < nb:
            child = me_pos | mask
            if child != me_pos and child < nb and (me_pos & mask) == 0:
                out.append(child)
            if me_pos & mask:
                break
            mask <<= 1
        return out
    raise ValueError(f"unknown bcast topology {topology!r}")


class _PrefetchedGet:
    """One rendezvous GET issued AHEAD of its activation's delivery
    (remote-GET prefetch).  ``done`` flips when the payload
    lands; ``cb`` is set when the real delivery arrives first and wants
    the data the moment it materializes."""

    __slots__ = ("arr", "cb", "done")

    def __init__(self) -> None:
        self.arr = None
        self.cb: Optional[Callable] = None
        self.done = False


class RemoteDepEngine:
    """Per-rank driver bound to one Context (the comm-thread analog; progress
    runs funnelled from the idle loop, ref: remote_dep_dequeue_main)."""

    def __init__(self, ce: CommEngine) -> None:
        self.ce = ce
        self.rank = ce.rank
        self.nb_ranks = ce.nb_ranks
        self.context = None
        self.topology = params.get("runtime_comm_coll_bcast")
        self.short_limit = params.get("runtime_comm_short_limit")
        # adaptive eager/rendezvous: per-peer cutoff from the measured
        # GET round-trip EWMA x link bandwidth EWMA (the bandwidth-delay
        # product — below it the inline copy beats a rendezvous's extra
        # round-trip), clamped to [static short_limit, short_limit_max].
        # Off by default: with the knob unset the static cutoff applies
        # unchanged on every peer.
        self._adaptive_short = bool(params.get("comm_adaptive_short_limit"))
        self._short_limit_max = max(
            int(params.get("comm_short_limit_max")), self.short_limit)
        self._get_rtt: Dict[int, float] = {}      # peer -> EWMA seconds
        self.adaptive_limits: Dict[int, int] = {}  # peer -> last cutoff
        self._taskpools: Dict[int, Any] = {}
        self._next_tp_id = 0
        self._lock = threading.Lock()
        # DTD data-plane state: (tile_key, seq) -> payload | expectation
        self._dtd_arrived: Dict[Tuple, Any] = {}
        self._dtd_expect: Dict[Tuple, Callable] = {}
        # rendezvous bookkeeping: handle_id -> (taskpool, remaining, handle)
        self._pending_handles: Dict[int, Tuple] = {}
        self._pending_xfers: Dict[int, Any] = {}  # uuid -> (tp, dst_rank)
        # inbound traffic buffered until the taskpool's startup has
        # credited its task/action counts (delivering sooner would drive
        # runtime_actions negative — or, for activations, let a fast
        # remote-released task COMPLETE and decrement nb_tasks before
        # set_nb_tasks runs, which either trips the >=0 assertion or is
        # silently overwritten into a hang):
        # wire_id -> [(src, msg), ...]; ready ids in _counts_ready
        self._early_mem_puts: Dict[int, List[Tuple[int, Dict]]] = {}
        self._counts_ready: set = set()
        # activations that raced ahead of our local taskpool registration
        # (a faster rank can start pool N+1 while we are still in pool
        # N's wait; the reference holds such activations until the
        # taskpool is attached): wire_id -> [(src, msg), ...]
        self._early_activations: Dict[int, List[Tuple[int, Dict]]] = {}
        ce.tag_register(TAG_ACTIVATE, self._on_activate)
        ce.tag_register(TAG_DTD_DATA, self._on_dtd_data)
        ce.tag_register(TAG_MEM_PUT, self._on_mem_put)
        ce.tag_register(TAG_TERMDET, self._on_termdet)
        ce.tag_register(TAG_XFER_ACK, self._on_xfer_ack)
        ce.on_get_served = self.note_get_served
        # mesh-local path: device-tensor payloads to peers that share
        # this process (comm/mesh.py) travel device to device, any size,
        # never as host bytes.  A torch tile is mutable, so what travels
        # is a private device copy taken on the producer's stream (one
        # on-card copy; the JAX package ships its immutable buffer by
        # reference and copies only under donation)
        self._mesh_local = bool(params.get("comm_mesh_local"))
        # remote-GET prefetch: an activation that races ahead
        # of its taskpool's registration/startup counts is BUFFERED
        # (see _early_activations) — but its rendezvous payload need
        # not wait.  Up to ``comm_prefetch_inflight`` GETs are issued
        # while the activation is still held, so the fetch overlaps the
        # tail of the previous pool; the replayed delivery finds the
        # bytes already local (a HIT).  Keyed (data_rank, handle_id);
        # the delivery re-checks under the lock, so a prefetch landing
        # mid-delivery and the replay racing it resolve cleanly.
        self._prefetch_budget = int(params.get("comm_prefetch_inflight"))
        self._prefetch_inflight = 0
        self._prefetched_gets: Dict[Tuple[int, int], _PrefetchedGet] = {}
        self.stats = {"activates_sent": 0, "activates_recv": 0,
                      "dtd_sends": 0, "dtd_recvs": 0, "forwards": 0,
                      "mem_puts_sent": 0, "mem_puts_recv": 0,
                      "plane_sends": 0, "host_staged_bytes": 0,
                      "rendezvous_host": 0, "mesh_local_sends": 0,
                      # flows whose payload parked in the in-process
                      # XStore for a cross-rank stage (stagec/xrank.py):
                      # the wire carried control only
                      "xs_elisions": 0,
                      # prefetched-GET outcomes, DISTINCT from plain
                      # GETs so the overlap gauges stay debuggable
                      "prefetch_gets": 0, "prefetch_hits": 0,
                      "prefetch_misses": 0, "prefetch_cancels": 0}

    # ------------------------------------------------------------------ #
    # context integration                                                #
    # ------------------------------------------------------------------ #
    def attach(self, context) -> None:
        self.context = context
        context.comm = self
        # message-arrival wakeup: an idle worker may be parked in its
        # exponential backoff (up to 2 ms) when an activation lands —
        # polling cadence, not the wire, dominated small-message latency
        # (rtt ~460 us before this hook). Transports call on_arrival
        # from the delivering thread; waking one worker drains the
        # inbox immediately.
        self.ce.on_arrival = lambda: context.wake_workers(1)
        # failure detection: every transport carries the uniform
        # dead_peers / on_peer_failure surface (comm/engine.py), so a
        # torn TCP connection aborts this rank's DAG cleanly instead of
        # hanging in termdet forever
        def _on_failure(peer: int, reason: str) -> None:
            self._release_parks_for(peer)
            self._cancel_prefetches(peer)  # its GET replies never come
            context.record_task_error(RankFailedError(peer, reason))
        self.ce.on_peer_failure = _on_failure

    def taskpool_register(self, tp) -> None:
        """Wire ids are assigned by registration order — SPMD ranks register
        the same pools in the same order, so the index agrees everywhere
        (the process-global taskpool_id does NOT when ranks share a
        process, as in the test fabric)."""
        with self._lock:
            wire_id = self._next_tp_id
            self._next_tp_id += 1
            self._taskpools[wire_id] = tp
            tp.comm_tp_id = wire_id
        if hasattr(tp, "comm"):
            tp.comm = self
        # early activations stay buffered: they deliver in counts_ready(),
        # once startup has credited nb_tasks (see _on_activate)

    @property
    def next_tp_id(self) -> int:
        """The wire id the NEXT registered taskpool will get."""
        with self._lock:
            return self._next_tp_id

    def sync_tp_ids(self, base: int) -> None:
        """Advance the wire-id counter to ``base`` so the next
        registration agrees with peers that registered more pools than
        this rank — the elastic-recovery alignment (ft/elastic.py): a
        late joiner registered nothing while the incumbents ran whole
        stages, and even survivors of a mid-stage failure can diverge
        by one registration (a rank leaves a pool's wait as soon as
        global termination is detected, so it may register the next
        stage's pool while a peer is still waiting). Ids only ever
        advance; traffic addressed to ids this rank never registers
        stays parked in the early buffers, which is where stale frames
        for foreign pools belong."""
        with self._lock:
            self._next_tp_id = max(self._next_tp_id, int(base))

    def progress(self, es) -> int:
        return self.ce.progress()

    def fini(self) -> None:
        self._cancel_prefetches()
        plane = self.ce.device_plane
        if plane is not None:
            plane.fini()
        self.ce.fini()
        # a transport thread may outlive fini (an in-process TCP engine's
        # accept loop): through the engine's callbacks it must not keep
        # this rank's context, pools and their device tiles alive
        self.ce.on_arrival = None
        self.ce.on_peer_failure = None
        self.context = None
        with self._lock:
            self._taskpools.clear()
            self._early_activations.clear()

    # ------------------------------------------------------------------ #
    # quantized-wire eligibility                              #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _quantize_eligible(tp, arr) -> bool:
        """Per-flow eligibility for the lossy quantized wire codecs:
        only FLOAT tile payloads of pools that did not declare
        themselves lossless (``tp.wire_lossless`` — set by the
        checkpoint-reshard redistribute pools, whose shards must land
        bit-identical). Control AMs never reach this; non-float data
        is excluded at the transport too (belt and braces)."""
        if arr is None or getattr(tp, "wire_lossless", False):
            return False
        if is_device_array(arr):
            return arr.is_floating_point()
        dt = getattr(arr, "dtype", None)
        try:
            return dt is not None and np.dtype(dt).kind == "f"
        except TypeError:  # pragma: no cover - exotic dtype object
            return False

    # ------------------------------------------------------------------ #
    # mesh-local path                                                    #
    # ------------------------------------------------------------------ #
    def mesh_local_to(self, dst: int) -> bool:
        """Whether a device-tensor payload for ``dst`` takes the
        mesh-local path (``comm_mesh_local`` on, ``dst`` in this
        process)."""
        return self._mesh_local and self.ce.mesh_local_with(dst)

    def _xs_elide(self, tp, ranks: List[int],
                  dsts: Dict[int, List[Tuple]]) -> bool:
        """Whether a flow's payload may skip the wire: every receiving
        rank negotiated ``"xs"`` and every consumer edge is a member of
        a cross-rank wave (``tp._xs_targets``, set by
        stagec/xrank.install_xrank)."""
        targets = getattr(tp, "_xs_targets", None)
        if not targets:
            return False
        from ..stagec.xrank import xs_negotiated
        return (all((tp.task_classes[e[0]].ast.name, tuple(e[1]))
                    in targets for r in ranks for e in dsts[r])
                and all(xs_negotiated(self.ce, r) for r in ranks))

    def _private_copy(self, t: Any) -> Any:
        """The mesh-local payload: a private device copy of ``t`` on the
        stream that wrote it (the chip's, on a chip mesh, else this
        rank's device module's stream), behind the kernel that wrote
        ``t`` and ahead of any later write to it, marked ready for the
        consumer's stream (``data.mark_ready``)."""
        dev = (self.context.device_by_type("cuda")
               if self.context is not None else None)
        stream = stream_of(t, getattr(dev, "stream", None))
        if stream is None:
            return t.detach().clone()
        import torch
        with torch.cuda.stream(stream):
            return mark_ready(t.detach().clone(), stream)

    # ------------------------------------------------------------------ #
    # adaptive eager/rendezvous cutoff                                   #
    # ------------------------------------------------------------------ #
    _RTT_ALPHA = 0.2

    def _note_get_rtt(self, peer: int, secs: float) -> None:
        with self._lock:
            cur = self._get_rtt.get(peer)
            self._get_rtt[peer] = (secs if cur is None else
                                   (1 - self._RTT_ALPHA) * cur
                                   + self._RTT_ALPHA * secs)

    def _timed_get(self, peer: int, handle_id: int,
                   cb: Callable[[Any], None]) -> None:
        """Rendezvous GET that feeds the per-peer round-trip EWMA (the
        measurement half of the adaptive cutoff)."""
        t0 = time.monotonic()

        def on_data(arr):
            self._note_get_rtt(peer, time.monotonic() - t0)
            cb(arr)

        self.ce.get(peer, handle_id, on_data)

    def short_limit_for(self, peer: int) -> int:
        """Effective eager/rendezvous cutoff toward ``peer``: static
        unless adaptive mode is on AND both the link bandwidth and the
        GET round-trip have been measured — then the bandwidth-delay
        product (bytes a rendezvous round-trip 'wastes') bounded by
        [runtime_comm_short_limit, comm_short_limit_max]."""
        static = self.short_limit
        if not self._adaptive_short or peer == self.rank:
            return static
        bw_fn = getattr(self.ce, "link_bw_mbps", None)
        bw = bw_fn(peer) if callable(bw_fn) else None
        with self._lock:
            rtt = self._get_rtt.get(peer)
        if bw is None or rtt is None:
            return static
        bdp = int(bw * 1e6 * rtt)
        limit = max(static, min(bdp, self._short_limit_max))
        self.adaptive_limits[peer] = limit
        return limit

    # ------------------------------------------------------------------ #
    # PTG activation protocol                                            #
    # ------------------------------------------------------------------ #
    def activate_batch(self, tp, task, flow_payloads: Dict[int, Any],
                       remote_edges: Dict[int, List[Tuple]],
                       flow_dtts: Optional[Dict[int, Any]] = None) -> None:
        """Send activations for one completed task.

        remote_edges: dst_rank -> [(succ_tc_id, succ_locals, flow_name,
        out_flow_idx), ...]; flow_payloads: out_flow_idx -> host ndarray
        (or a device tensor when a device data plane is attached);
        flow_dtts: out_flow_idx -> the copy's Datatype, carried on the
        wire so a consumer whose declared type already matches does NOT
        reconvert (ref: remote_no_re_reshape.jdf). One message per output
        flow per broadcast tree (the reference aggregates by remote_deps
        struct, remote_dep.h:143-160).
        """
        obs = self.ce._obs
        t0 = time.monotonic_ns() if obs is not None else 0
        by_flow: Dict[int, Dict[int, List[Tuple]]] = {}
        for dst, edges in remote_edges.items():
            for e in edges:
                by_flow.setdefault(e[3], {}).setdefault(dst, []).append(e)
        for out_idx, dsts in by_flow.items():
            ranks = sorted(dsts)
            payload_arr = flow_payloads.get(out_idx)
            msg = {
                "tp_id": tp.comm_tp_id,
                "root": self.rank,
                "ranks": ranks,                      # bcast participants
                "edges": {r: dsts[r] for r in ranks},
                "src_task": getattr(task, "locals", None),
                "dtt": (flow_dtts or {}).get(out_idx),
            }
            if self._quantize_eligible(tp, payload_arr):
                # tile payload: the transport MAY lossily quantize its
                # bulk buffers toward peers that negotiated a codec
                # (comm_quantize; the mark also rides bcast forwards)
                msg["_qz_ok"] = True
            plane = getattr(self.ce, "device_plane", None)
            # the message reaches every participant: the cutoff must be
            # agreeable to all of them — take the most conservative
            limit = min(self.short_limit_for(r) for r in ranks)
            inline = payload_arr is None or payload_arr.nbytes <= limit
            if payload_arr is not None and self._xs_elide(
                    tp, ranks, dsts):
                # cross-rank stage elision (stagec/xrank.py): every
                # consumer edge of this flow lands in a cross-rank wave,
                # so the payload parks in the process-global XStore and
                # the wire carries CONTROL ONLY — the wave's program
                # gathers the tile.  Each consumer rank takes the parked
                # copy at delivery, so a wave its stage leaves still
                # holds a real payload.  A torch tile is mutable: what
                # parks is a private device copy taken on the producer's
                # stream (a host payload: a read-only copy)
                from ..stagec.xrank import XSTORE, xstore_key
                if is_device_array(payload_arr):
                    arr = self._private_copy(payload_arr)
                else:
                    arr = np.array(payload_arr)
                    arr.setflags(write=False)
                key = xstore_key(self.rank, tp.comm_tp_id)
                XSTORE.put(key, arr, len(ranks))
                msg["xs"] = list(key)
                self.stats["xs_elisions"] += 1
            elif (is_device_array(payload_arr)
                    and all(self.mesh_local_to(r) for r in ranks)):
                # mesh-local: every participant shares this process —
                # the private device copy rides the activation, any size
                msg["data"] = self._private_copy(payload_arr)
                self.stats["mesh_local_sends"] += 1
            elif (plane is not None and not inline
                    and is_device_array(payload_arr)):
                # device data plane: park the DEVICE buffer, consumers
                # pull it device-to-device (no host pickling); one uuid
                # per receiving rank, ACK-released (comm/xfer.py)
                uuids = {}
                descs = {}
                shape = dtype = None
                for r in ranks:
                    u, shape, dtype = plane.register(payload_arr)
                    uuids[r] = u
                    descs[r] = plane.descriptor(u)
                    with self._lock:
                        self._pending_xfers[u] = (tp, r)
                tp.add_pending_action(len(ranks))
                msg["xfer"] = {"uuids": uuids, "descs": descs,
                               "shape": shape, "dtype": dtype,
                               "src": self.rank}
                self.stats["plane_sends"] += len(ranks)
            elif inline:
                if payload_arr is not None:
                    payload_arr = _host(payload_arr)
                    self.stats["host_staged_bytes"] += payload_arr.nbytes
                msg["data"] = payload_arr
            else:
                # SNAPSHOT the payload: a local successor released by the
                # same completion may mutate the live host copy in place
                # before the remote GET is served (the inline path copies
                # at send time via the wire). Read-only so the wire's
                # chunked path may send it zero-copy.
                snap = (to_host_array(payload_arr)
                        if is_device_array(payload_arr)
                        else np.array(payload_arr))
                snap.setflags(write=False)
                self.stats["host_staged_bytes"] += snap.nbytes
                self.stats["rendezvous_host"] += 1
                handle = self.ce.mem_register(
                    snap, quantize_ok=self._quantize_eligible(
                        tp, payload_arr))
                # every non-root participant eventually GETs from the root
                tp.add_pending_action(1)
                self._pending_handles[handle.handle_id] = (tp, len(ranks), handle)
                msg["handle"] = handle.handle_id
                msg["data_rank"] = self.rank
                msg["nbytes"] = snap.nbytes
            # root (position 0 implicitly = the sender) forwards to children
            positions = [self.rank] + ranks  # root first
            for child_pos in bcast_children(0, len(positions), self.topology):
                self.ce.send_am(positions[child_pos], TAG_ACTIVATE, msg)
                self.stats["activates_sent"] += 1
        if obs is not None:
            obs.span("comm:activate_batch", t0,
                     {"task": getattr(task, "locals", None),
                      "flows": len(by_flow),
                      "dsts": sorted(remote_edges)})

    def _on_activate(self, src: int, msg: Dict, replay: bool = False) -> None:
        held = prefetch = None
        with self._lock:
            tp = self._taskpools.get(msg["tp_id"])
            if tp is None or msg["tp_id"] not in self._counts_ready:
                # raced ahead of our registration OR of startup's
                # set_nb_tasks: hold until counts_ready(), else a fast
                # remote-released task could complete and decrement
                # nb_tasks before the total is credited
                self._early_activations.setdefault(
                    msg["tp_id"], []).append((src, msg))
                held = True
                prefetch = self._plan_get_prefetch_locked(msg)
        if held:
            # the activation waits for counts_ready, its PAYLOAD need
            # not: issue the rendezvous GET now (bounded by the
            # comm_prefetch_inflight budget) so the fetch overlaps the
            # tail of whatever this rank is still running
            if prefetch is not None:
                self._issue_get_prefetch(*prefetch)
            return
        # count AFTER the gate: counts_ready re-invokes this handler for
        # buffered messages, which would double-count receives
        self.stats["activates_recv"] += 1
        # re-forward to my children in the bcast tree
        positions = [msg["root"]] + list(msg["ranks"])
        me_pos = positions.index(self.rank)
        for child_pos in bcast_children(me_pos, len(positions), self.topology):
            self.ce.send_am(positions[child_pos], TAG_ACTIVATE, msg)
            self.stats["forwards"] += 1
        my_edges = msg["edges"].get(self.rank, [])
        if not my_edges:
            return
        xf = msg.get("xfer")
        if xf is not None:
            plane = getattr(self.ce, "device_plane", None)
            if plane is None:  # not assert: must survive python -O
                raise RuntimeError(
                    "producer used the device data plane but this rank "
                    "has none attached (attach a DeviceDataPlane on "
                    "every rank)")
            uuid = xf["uuids"][self.rank]
            try:
                # returns once the bytes landed: the ACK releases the
                # producer's parked buffer and lets its taskpool retire
                arr = plane.pull(xf["src"], uuid, tuple(xf["shape"]),
                                 xf["dtype"],
                                 desc=(xf.get("descs") or {}).get(self.rank))
            except Exception as exc:  # noqa: BLE001
                # a failed pull must still retire the producer's pending
                # action (else its wait() hangs with nothing surfaced);
                # the failure ACK releases the park, then this rank
                # aborts its own DAG cleanly
                try:
                    self.ce.send_am(
                        xf["src"], TAG_XFER_ACK,
                        {"uuid": uuid,
                         "failed": f"{type(exc).__name__}: {exc}"[:300]})
                except Exception:  # peer already gone: failure path anyway
                    pass
                if self.context is not None:
                    self.context.record_task_error(exc)
                    return
                raise
            self.ce.send_am(xf["src"], TAG_XFER_ACK, {"uuid": uuid})
            self._deliver_activation(tp, my_edges, arr, msg.get("dtt"),
                                     tr=msg.get("_tr"))
            return
        xs = msg.get("xs")
        if xs is not None:
            # cross-rank stage elision: the co-resident producer parked
            # the payload in the process-global XStore — take it at
            # delivery, so this rank holds a real payload whatever its
            # stage does.  A missing entry is this rank's task error
            from ..stagec.xrank import XSTORE
            arr = XSTORE.take(tuple(xs))
            if arr is None:
                exc = RuntimeError(
                    f"cross-rank stage payload {tuple(xs)} missing "
                    f"from the in-process XStore")
                if self.context is not None:
                    self.context.record_task_error(exc)
                    return
                raise exc
            self._deliver_activation(tp, my_edges, arr, msg.get("dtt"),
                                     tr=msg.get("_tr"))
            return
        if "data" in msg or msg.get("handle") is None:
            self._deliver_activation(tp, my_edges, msg.get("data"),
                                     msg.get("dtt"), tr=msg.get("_tr"))
        else:
            # rendezvous: GET the payload from the data holder — unless
            # a prefetched GET already fetched (or is fetching) it
            def on_data(arr):
                self._deliver_activation(tp, my_edges, arr, msg.get("dtt"),
                                         tr=msg.get("_tr"))
            key = (msg["data_rank"], msg["handle"])
            rec = None
            with self._lock:
                rec = self._prefetched_gets.get(key)
                if rec is not None:
                    if rec.done:
                        del self._prefetched_gets[key]
                    else:
                        rec.cb = on_data   # deliver the moment it lands
            if rec is not None:
                self.stats["prefetch_hits"] += 1
                if rec.done:
                    on_data(rec.arr)
                return
            if replay and self._prefetch_budget > 0:
                # a held activation whose GET was NOT prefetched
                # (budget exhausted): the fetch serializes behind
                # counts_ready after all — the debuggability signal
                # for raising comm_prefetch_inflight
                self.stats["prefetch_misses"] += 1
            self._timed_get(msg["data_rank"], msg["handle"], on_data)

    # ------------------------------------------------------------------ #
    # remote-GET prefetch                                      #
    # ------------------------------------------------------------------ #
    def _plan_get_prefetch_locked(self, msg: Dict) -> Optional[Tuple[int, int]]:
        """Under self._lock: decide whether a just-buffered activation's
        rendezvous payload should be prefetched.  Returns the (peer,
        handle) to fetch, or None (no handle / no edges for this rank /
        budget exhausted / already prefetched)."""
        if self._prefetch_budget <= 0 or msg.get("handle") is None:
            return None
        if not msg["edges"].get(self.rank):
            return None   # pure-forwarding hop: children fetch themselves
        if self.ce.peer_suspect(msg["data_rank"]):
            # the producer's link is flapping (reliable-session SUSPECT,
            # comm/tcp.py): a prefetched GET would just pin one of the
            # bounded in-flight slots on a parked reply — let the
            # ordinary delivery path fetch once the session resumes
            return None
        key = (msg["data_rank"], msg["handle"])
        if key in self._prefetched_gets \
                or self._prefetch_inflight >= self._prefetch_budget:
            return None
        self._prefetched_gets[key] = _PrefetchedGet()
        self._prefetch_inflight += 1
        return key

    def _issue_get_prefetch(self, peer: int, handle: int) -> None:
        self.stats["prefetch_gets"] += 1

        def on_data(arr):
            cb = None
            with self._lock:
                rec = self._prefetched_gets.get((peer, handle))
                if rec is None:
                    # canceled (peer death / fini): the cancel already
                    # released the budget slot — a late reply must not
                    # decrement it a second time
                    return
                self._prefetch_inflight -= 1
                rec.arr = arr
                rec.done = True
                cb = rec.cb
                if cb is not None:
                    del self._prefetched_gets[(peer, handle)]
            if cb is not None:
                cb(arr)   # the replayed delivery got here first

        try:
            self._timed_get(peer, handle, on_data)
        except Exception:
            # a dead peer must not leak the budget slot; a replayed
            # delivery that has NOT latched on yet will issue (and fail)
            # its own GET, surfacing the error on the normal path
            cb = None
            with self._lock:
                rec = self._prefetched_gets.pop((peer, handle), None)
                if rec is not None:
                    self._prefetch_inflight -= 1
                    self.stats["prefetch_cancels"] += 1
                    cb = rec.cb
            if cb is not None:
                # a replayed delivery already latched onto this record
                # (counted a hit, issued no GET of its own) — it must
                # not be stranded with no fetch at all: fall back to a
                # plain GET; if the transport is truly dead this raises
                # too and surfaces exactly like the normal path
                self._timed_get(peer, handle, cb)
                return
            raise

    def _cancel_prefetches(self, peer: Optional[int] = None) -> None:
        """Drop prefetched entries (all, or those owed by ``peer``) —
        a dead producer's GET reply will never come, and fini must not
        strand budget accounting."""
        with self._lock:
            keys = [k for k in self._prefetched_gets
                    if peer is None or k[0] == peer]
            dropped = 0
            for k in keys:
                rec = self._prefetched_gets.pop(k)
                if not rec.done:
                    self._prefetch_inflight -= 1
                dropped += 1
            self.stats["prefetch_cancels"] += dropped

    def _deliver_activation(self, tp, edges: List[Tuple], arr,
                            dtt=None, tr=None) -> None:
        """Incoming data releases local successors
        (ref: remote_dep_release_incoming, remote_dep_mpi.c:997).
        Device-plane arrivals stay tensors (the device module adopts
        them); wire arrivals are numpy arrays.

        ``tr`` is the activation's wire trace context (None when flow
        tracing is off): published thread-locally around the activation
        walk (``obs.inbound_flow_ctx``), covering the synchronous
        delivery, the counts_ready replay and the rendezvous-GET
        callback, none of which share a call signature."""
        copy = None
        if arr is not None:
            payload = arr if is_device_array(arr) else np.asarray(arr)
            d = Data(nb_elts=int(np.prod(payload.shape)))
            copy = DataCopy(d, 0, payload=payload, dtt=dtt)
            copy.version = 1
            copy.coherency = Coherency.OWNED
            d.attach_copy(copy)
        if tr is not None:
            from ..obs.spans import set_inbound_flow_ctx
            set_inbound_flow_ctx(tuple(tr))
        ready = []
        try:
            for (succ_tc_id, succ_locals, flow_name, _out) in edges:
                tc = tp.task_classes[succ_tc_id]
                t = tc.activate(tuple(succ_locals), flow_name, copy)
                if t is not None:
                    ready.append(t)
        finally:
            if tr is not None:
                from ..obs.spans import set_inbound_flow_ctx
                set_inbound_flow_ctx(None)
        if ready and self.context is not None:
            es0 = self.context.execution_streams[0]
            schedule(es0, ready)

    # GET service accounting: the local fabric serves GETs inside
    # ce.progress; pending handles release when everyone fetched
    def _on_xfer_ack(self, src: int, payload: Dict) -> None:
        """A consumer's device-to-device pull completed (or failed —
        either way the park is dropped and the pending action retires,
        so the producer's wait() cannot hang on a sick consumer)."""
        uuid = payload["uuid"]
        if "failed" in payload:
            plog.warning("rank %d: device-plane pull of uuid %d failed at "
                         "consumer rank %d: %s", self.rank, uuid, src,
                         payload["failed"])
        with self._lock:
            ent = self._pending_xfers.pop(uuid, None)
        plane = getattr(self.ce, "device_plane", None)
        if plane is not None:
            plane.release(uuid)
        if ent is not None:
            ent[0].pending_action_done(1)

    def _release_parks_for(self, peer: int) -> None:
        """A consumer rank died: its ACKs will never come. Reclaim every
        buffer parked for it and retire the pending actions, so the
        producer's wait() aborts cleanly (RankFailedError) instead of
        hanging on a park that cannot be released (round-2 review:
        park-lifetime management)."""
        with self._lock:
            dead = [(u, self._pending_xfers.pop(u))
                    for u in [u for u, (_t, dst) in
                              self._pending_xfers.items() if dst == peer]]
        if not dead:
            return
        plane = getattr(self.ce, "device_plane", None)
        for u, (tp, _dst) in dead:
            if plane is not None:
                plane.release(u)
            tp.pending_action_done(1)
        plog.warning("rank %d: reclaimed %d parked transfer(s) destined "
                     "to dead rank %d", self.rank, len(dead), peer)

    def note_get_served(self, handle_id: int) -> None:
        # progress() fans out to every idle worker: the decrement must be
        # atomic or concurrent GET-serves lose counts and wait() hangs
        with self._lock:
            ent = self._pending_handles.get(handle_id)
            if ent is None:
                return
            tp, remaining, handle = ent
            remaining -= 1
            if remaining == 0:
                del self._pending_handles[handle_id]
            else:
                self._pending_handles[handle_id] = (tp, remaining, handle)
        if remaining == 0:
            self.ce.mem_unregister(handle)  # release the snapshot buffer
            tp.pending_action_done(1)

    # ------------------------------------------------------------------ #
    # memory writeback plane: a task's out-dep targets a collection tile
    # owned by another rank (ref: the final write of a dataflow edge to
    # remote memory travels the same remote-dep machinery; the owner
    # counts statically-known incoming writes as runtime actions so its
    # termination waits for them)                                        #
    # ------------------------------------------------------------------ #
    def mem_writeback(self, tp, coll_name: str, args: Tuple, arr,
                      dst: int) -> None:
        """arr=None is a release-only notification: the owner counted
        this edge but the producing flow carried no data copy — retire
        the pending action without writing."""
        msg = {"tp_id": tp.comm_tp_id, "coll": coll_name,
               "args": tuple(args),
               "data": None if arr is None else _host(arr)}
        if self._quantize_eligible(tp, arr):
            msg["_qz_ok"] = True   # tile writeback: may quantize
        self.ce.send_am(dst, TAG_MEM_PUT, msg)
        self.stats["mem_puts_sent"] += 1

    def counts_ready(self, tp) -> None:
        """The taskpool's startup credited its counts (set_nb_tasks ran
        and expected writebacks are pending actions): deliver buffered
        activations and memory puts, stop buffering for this pool."""
        with self._lock:
            self._counts_ready.add(tp.comm_tp_id)
            held_act = self._early_activations.pop(tp.comm_tp_id, [])
            held_put = self._early_mem_puts.pop(tp.comm_tp_id, [])
        for src, msg in held_act:
            self._on_activate(src, msg, replay=True)
        for src, msg in held_put:
            self._on_mem_put(src, msg)

    def _on_mem_put(self, src: int, msg: Dict) -> None:
        with self._lock:
            tp = self._taskpools.get(msg["tp_id"])
            if tp is None or msg["tp_id"] not in self._counts_ready:
                self._early_mem_puts.setdefault(
                    msg["tp_id"], []).append((src, msg))
                return
        self.stats["mem_puts_recv"] += 1
        if msg["data"] is not None:
            # generic collection write (mirrors the local writeback path;
            # set_tile is matrix-only)
            dest = tp.global_env[msg["coll"]].data_of(*msg["args"])
            host = dest.host_copy()
            arr = np.asarray(msg["data"])
            if host.payload is None:
                host.payload = np.array(arr)
            else:
                np.copyto(Data.materialize_host(host), arr)
            dest.version_bump(0)
        tp.pending_action_done(1)

    # ------------------------------------------------------------------ #
    # DTD data plane                                                     #
    # ------------------------------------------------------------------ #
    def dtd_send(self, tp, tile_key: Any, seq: int, dst: int,
                 arr: np.ndarray) -> None:
        """Small payloads ride inline in the AM; larger ones go through
        the same GET rendezvous as PTG edges (short proto vs rendezvous,
        ref: remote_dep_mpi.c:244-252); both carry host arrays.  A device
        tensor for a peer in this process takes the mesh-local path."""
        obs = self.ce._obs
        t0 = time.monotonic_ns() if obs is not None else 0
        msg = {"tp_id": tp.comm_tp_id, "tile": tile_key, "seq": seq}
        if self._quantize_eligible(tp, arr):
            msg["_qz_ok"] = True   # DTD tile payload: may quantize
        if is_device_array(arr) and self.mesh_local_to(dst):
            # mesh-local: the private device copy travels, any size
            nbytes = arr.numel() * arr.element_size()
            msg["data"] = self._private_copy(arr)
            self.stats["mesh_local_sends"] += 1
            self.ce.send_am(dst, TAG_DTD_DATA, msg)
            self.stats["dtd_sends"] += 1
            if obs is not None:
                obs.span("comm:dtd_send", t0,
                         {"dst": dst, "bytes": nbytes, "rendezvous": False})
            return
        arr = _host(arr)
        nbytes = arr.nbytes
        self.stats["host_staged_bytes"] += nbytes
        if nbytes <= self.short_limit_for(dst):
            msg["data"] = arr
        else:
            # snapshot the host buffer (a later local task may write in
            # place before the GET is served); read-only marks the
            # snapshot wire-zero-copy-safe
            snap = np.array(arr)
            snap.setflags(write=False)
            handle = self.ce.mem_register(
                snap, quantize_ok=self._quantize_eligible(tp, arr))
            tp.add_pending_action(1)
            with self._lock:
                self._pending_handles[handle.handle_id] = (tp, 1, handle)
            msg["handle"] = handle.handle_id
            msg["data_rank"] = self.rank
        self.ce.send_am(dst, TAG_DTD_DATA, msg)
        self.stats["dtd_sends"] += 1
        if obs is not None:
            obs.span("comm:dtd_send", t0,
                     {"dst": dst, "bytes": nbytes,
                      "rendezvous": "handle" in msg})

    def dtd_expect(self, tp, tile_key: Any, seq: int,
                   cb: Callable[[np.ndarray], None]) -> None:
        """Register interest in (taskpool, tile, seq); fires immediately if
        already arrived (the sender may run ahead of the receiver's
        insertion). The taskpool wire id is part of the key: two pools can
        reuse the same tiles with per-pool write sequences."""
        key = (tp.comm_tp_id, tile_key, seq)
        with self._lock:
            if key in self._dtd_arrived:
                arr = self._dtd_arrived.pop(key)
            else:
                self._dtd_expect[key] = cb
                return
        cb(arr)

    def _on_dtd_data(self, src: int, msg: Dict) -> None:
        self.stats["dtd_recvs"] += 1
        key = (msg["tp_id"], msg["tile"], msg["seq"])
        if "handle" in msg:
            # rendezvous: fetch through the data plane, deliver on arrival
            self._timed_get(msg["data_rank"], msg["handle"],
                            lambda arr, k=key: self._dtd_deliver(k, arr))
            return
        self._dtd_deliver(key, msg["data"])

    def _dtd_deliver(self, key: Tuple, arr: Any) -> None:
        with self._lock:
            cb = self._dtd_expect.pop(key, None)
            if cb is None:
                self._dtd_arrived[key] = arr
                return
        cb(arr)

    # ------------------------------------------------------------------ #
    # distributed termination (fourcounter waves ride TAG_TERMDET)       #
    # ------------------------------------------------------------------ #
    def termdet_local_quiet(self, tdm) -> None:
        # Single-counter-per-rank credit scheme is not needed for the
        # static-count PTG pools or the recv-task-counted DTD pools; the
        # hook exists for dynamically-discovered distributed pools.
        tdm.distributed_terminate()

    def _on_termdet(self, src: int, msg: Dict) -> None:  # pragma: no cover
        pass
