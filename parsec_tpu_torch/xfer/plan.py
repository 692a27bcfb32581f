"""Redistribution planner: compile a source→target distribution pair
into a deterministic schedule of portable collective steps.

The DTD path in :func:`~parsec_tpu_torch.collections.redistribute.redistribute`
moves a whole-matrix same-grid reshard as one task per target tile —
at the wire that is a per-tile GET/activation storm: every cross-rank
tile pays its own control round-trip and pickle envelope. The
reference's own redistribution literature (arxiv 2112.01075) plans the
same movement as collectives: the (src, dst) pair set IS an all-to-all
over the member set, so this module compiles the tile walk into
alltoall-style ROUNDS (round r carries every pair with
``(dst - src) % P == r`` — each rank sends to at most one peer per
round and receives from at most one), coalescing all same-(src, dst)
tiles into ONE transfer each. The schedule is a pure function of the
two distributions and the tile set — byte-identical across runs, ranks
and the two packages (the JAX package builds the same tuples, so
:func:`RedistPlan.digest` agrees) — and the digest is exchanged and
asserted before any data moves, so a divergent plan fails loudly
instead of deadlocking.

Execution rides the session wire by default (lossless — planner
traffic is never quantized, so reshards stay bit-identical), or the
device data plane (comm/xfer.py: CUDA IPC on the card, the socket
loopback on the CPU) for the bulk payload when the engine's
``dplane_to`` allows it, with only the descriptor/ack control half on
the session wire. The bytes travel as a ``torch.uint8`` tensor and the
consumer views them back to the sent dtype, so an f64 reshard stays
bit-identical.

Card-resident tiles: after a device DAG the newest version of a source
tile can live on the card. The pack pulls each source tile through the
device module (``Data.sync_to_host(context.devices)``) and waits for
the device streams before it reads host copies; the unpack writes the
target's host copy and bumps its version, so the next device task
stages the moved values in instead of reading a stale device copy.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..comm.engine import TAG_USER_BASE
from ..data.data import Data, is_device_array, to_host_array

# Every reserved below-base slot (-1 barrier, -2/-3 device plane) is
# taken — the planner claims a high user tag instead, the JAX package's
# number, far above the small literals the in-tree harnesses use.
TAG_REDIST = TAG_USER_BASE + 111

# concurrency contract checked by the lock lint (LCK3xx)
_GUARDED_BY = {
    "_Inbox.msgs": "lock",
}


class Transfer(NamedTuple):
    """One coalesced move: every ``tiles`` coord rides a single wire
    transfer from ``src`` to ``dst`` (flattened, concatenated in the
    listed order — ragged edge tiles coalesce fine)."""
    src: int
    dst: int
    tiles: Tuple[Tuple[int, int], ...]


class RedistPlan(NamedTuple):
    nb_ranks: int
    local: Tuple[Tuple[int, int], ...]           # src == dst: host copy
    rounds: Tuple[Tuple[Transfer, ...], ...]     # alltoall-style rounds

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def n_transfers(self) -> int:
        return sum(len(r) for r in self.rounds)

    @property
    def tile_moves(self) -> int:
        """Cross-rank tile count — what the GET storm would pay one
        transfer each for."""
        return sum(len(t.tiles) for r in self.rounds for t in r)

    def digest(self) -> str:
        return hashlib.sha1(repr(self).encode()).hexdigest()


def build_plan(source: Any, target: Any,
               tiles: Optional[Sequence[Tuple[int, int]]] = None
               ) -> RedistPlan:
    """Deterministic schedule for a whole-matrix same-grid reshard:
    walk the (sorted) tile set once, bucket cross-rank tiles by their
    (source owner, target owner) pair, and lay the pairs out in
    alltoall rounds. Pure function of the distributions — no rank or
    runtime state — so every SPMD caller builds the identical plan."""
    coords = sorted(tiles) if tiles is not None else sorted(target.tiles())
    nb = max(int(getattr(source, "nodes", 1)),
             int(getattr(target, "nodes", 1)), 1)
    local: List[Tuple[int, int]] = []
    pairs: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (m, n) in coords:
        s = source.rank_of(m, n)
        d = target.rank_of(m, n)
        if s == d:
            local.append((m, n))
        else:
            pairs.setdefault((s, d), []).append((m, n))
    rounds: List[Tuple[Transfer, ...]] = []
    for r in range(1, nb):
        rnd = tuple(Transfer(s, d, tuple(ts))
                    for (s, d), ts in sorted(pairs.items())
                    if (d - s) % nb == r)
        if rnd:
            rounds.append(rnd)
    return RedistPlan(nb, tuple(local), tuple(rounds))


# --------------------------------------------------------------------- #
# execution
# --------------------------------------------------------------------- #
class _Inbox:
    """Per-engine landing zone for TAG_REDIST messages. Keyed by
    (src, seq, kind, pair) so successive redistributions on one engine
    never cross-talk (``seq`` is an SPMD-consistent per-call counter).
    Acks are handled inline (they release device-plane parks),
    everything else parks here until the executor collects it."""

    def __init__(self, ce: Any) -> None:
        self.ce = ce
        self.msgs: Dict[Tuple, Any] = {}
        self.lock = threading.Lock()

    def on_msg(self, src: int, payload: Dict) -> None:
        kind = payload.get("kind")
        if kind == "ack":
            plane = getattr(self.ce, "device_plane", None)
            if plane is not None:
                plane.release(payload["uuid"])
            return
        key = (src, payload["seq"], kind, payload.get("pair"))
        with self.lock:
            self.msgs[key] = payload

    def take(self, key: Tuple) -> Optional[Dict]:
        with self.lock:
            return self.msgs.pop(key, None)


def _inbox_of(ce: Any) -> _Inbox:
    box = getattr(ce, "_redist_inbox", None)
    if box is None:
        box = _Inbox(ce)
        ce._redist_inbox = box
        ce.tag_register(TAG_REDIST, box.on_msg)
    return box


def _wait_take(ce: Any, box: _Inbox, keys: Sequence[Tuple], timeout: float,
               what: str) -> Dict:
    t0 = time.monotonic()
    while True:
        for key in keys:
            msg = box.take(key)
            if msg is not None:
                return msg
        ce.progress()
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(
                f"rank {ce.rank}: no redistribution {what} within "
                f"{timeout}s")
        time.sleep(0.0005)


class PlannedRedistribution:
    """What :func:`run_redistribution` returns — duck-types the slice
    of the DTD taskpool surface redistribute() callers consume
    (``redist_bytes``; ``wait()`` is a no-op: execution completed
    synchronously), plus the planner observables."""

    def __init__(self, plan: RedistPlan, redist_bytes: int) -> None:
        self.plan = plan
        self.redist_bytes = redist_bytes        # cross-rank payload bytes
        self.redist_rounds = plan.n_rounds
        self.redist_transfers = plan.n_transfers
        self.redist_tile_moves = plan.tile_moves
        self.plan_digest = plan.digest()
        self.wire_lossless = True

    def wait(self) -> None:
        pass


def _host_tiles(source: Any, tiles: Sequence[Tuple[int, int]],
                devices: Any) -> List[np.ndarray]:
    """Each tile's newest version as a host array: a card-resident
    newest copy comes down through its device module (a D2H copy queued
    on the module's stream), then every stream is waited for."""
    from ..utils.checkpoint import _synchronize
    copies = [source.data_of(m, n).sync_to_host(devices) for (m, n) in tiles]
    _synchronize(devices)
    return [to_host_array(c.payload) if is_device_array(c.payload)
            else np.asarray(c.payload) for c in copies]


def _pack(source: Any, tiles: Sequence[Tuple[int, int]],
          devices: Any = None) -> np.ndarray:
    return np.concatenate([np.ascontiguousarray(t).ravel()
                           for t in _host_tiles(source, tiles, devices)])


def _set_tile(target: Any, m: int, n: int, values: np.ndarray) -> None:
    """Write a host copy and bump its version (``set_tile``); a host copy
    a remote writer left read-only, or a device tensor, takes a writable
    buffer first."""
    Data.materialize_host(target.data_of(m, n).host_copy())
    target.set_tile(m, n, values)


def _unpack(target: Any, tiles: Sequence[Tuple[int, int]],
            flat: np.ndarray) -> None:
    off = 0
    for (m, n) in tiles:
        tm, tn = target.tile_shape(m, n)
        _set_tile(target, m, n, flat[off:off + tm * tn].reshape(tm, tn))
        off += tm * tn


def run_redistribution(source: Any, target: Any, ce: Any,
                       tiles: Optional[Sequence[Tuple[int, int]]] = None,
                       timeout: float = 120.0,
                       context: Any = None) -> PlannedRedistribution:
    """SPMD-execute the planned reshard over ``ce`` (call on every
    rank). Each round: enqueue every owned outgoing transfer (sends
    never block), then collect the round's incoming transfers — so no
    rank ever waits on a peer that is itself waiting. The digest
    handshake up front turns any cross-rank plan divergence into an
    immediate error instead of a wedged collective. ``context`` (the
    rank's Context) lets the pack pull card-resident source tiles
    through its device modules; without it a device-resident newest
    copy is converted directly."""
    plan = build_plan(source, target, tiles)
    me, nb = ce.rank, ce.nb_ranks
    devices = getattr(context, "devices", None)
    seq = getattr(ce, "_redist_seq_no", 0)
    ce._redist_seq_no = seq + 1
    box = _inbox_of(ce)
    dig = plan.digest()
    for r in range(nb):
        if r != me:
            ce.send_am(r, TAG_REDIST,
                       {"seq": seq, "kind": "cfg", "digest": dig})
    for r in range(nb):
        if r == me:
            continue
        msg = _wait_take(ce, box, [(r, seq, "cfg", None)], timeout,
                         f"plan digest from rank {r}")
        if msg["digest"] != dig:
            raise RuntimeError(
                f"rank {me}: redistribution plan diverges from rank {r} "
                f"({dig[:12]} != {msg['digest'][:12]}) — source/target "
                f"distributions are not SPMD-consistent")

    itemsize = np.dtype(target.dtype).itemsize
    redist_bytes = 0
    for rnd in plan.rounds:
        for t in rnd:
            for (m, n) in t.tiles:
                tm, tn = target.tile_shape(m, n)
                redist_bytes += tm * tn * itemsize

    mine = [c for c in plan.local if target.rank_of(*c) == me]
    for (m, n), arr in zip(mine, _host_tiles(source, mine, devices)):
        _set_tile(target, m, n, arr)

    plane = getattr(ce, "device_plane", None)
    dp_to = getattr(ce, "dplane_to", None)
    my_parks: List[int] = []
    for rnd in plan.rounds:
        for t in rnd:
            if t.src != me:
                continue
            payload = _pack(source, t.tiles, devices)
            if plane is not None and dp_to is not None and dp_to(t.dst):
                import torch
                # ship the RAW BYTES (a uint8 view): the consumer views
                # them back to the sent dtype, bit for bit, whatever it is
                wire = torch.from_numpy(payload.view(np.uint8))
                uuid, shape, dt = plane.register(wire)
                my_parks.append(uuid)
                ce.send_am(t.dst, TAG_REDIST,
                           {"seq": seq, "kind": "dp", "pair": t[:2],
                            "desc": (uuid, shape, dt),
                            "ipc": plane.descriptor(uuid),
                            "dt": str(payload.dtype)})
            else:
                ce.send_am(t.dst, TAG_REDIST,
                           {"seq": seq, "kind": "data", "pair": t[:2],
                            "data": payload})
        for t in rnd:
            if t.dst != me:
                continue
            msg = _wait_take(
                ce, box, [(t.src, seq, "dp", t[:2]),
                          (t.src, seq, "data", t[:2])], timeout,
                f"transfer {t.src}->{t.dst}")
            if msg["kind"] == "dp":
                if plane is None:  # not assert: must survive python -O
                    raise RuntimeError(
                        f"rank {me}: rank {t.src} sent a redistribution "
                        f"over the device plane, but this rank has none "
                        f"attached")
                uuid, shape, dt = msg["desc"]
                got = plane.pull(t.src, uuid, tuple(shape), dt,
                                 desc=msg.get("ipc"))
                flat = got.cpu().numpy().view(np.dtype(msg["dt"]))
                ce.send_am(t.src, TAG_REDIST,
                           {"seq": seq, "kind": "ack", "uuid": uuid})
            else:
                flat = np.asarray(msg["data"])
            _unpack(target, t.tiles, flat.ravel())

    # drain our consumers' acks so no park outlives the call (the park
    # keep-alive pins producer memory until the pull is confirmed)
    if my_parks:
        t0 = time.monotonic()
        while any(plane.is_parked(u) for u in my_parks):
            ce.progress()
            if time.monotonic() - t0 > timeout:
                from ..utils import logging as plog
                plog.warning(
                    "rank %d: %d device-plane park(s) unreleased after "
                    "%.0fs", me, sum(plane.is_parked(u) for u in my_parks),
                    timeout)
                break
            time.sleep(0.0005)

    stats = getattr(ce, "dplane_stats", None)
    if stats is not None:
        stats["redist_rounds"] += plan.n_rounds
    return PlannedRedistribution(plan, redist_bytes)
