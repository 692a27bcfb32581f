"""Distributed wave execution: one lowered PTG DAG over many ranks.

The reference dispatches distributed tasks from a C progress loop of a
few microseconds a task, overlapping per-task sends with compute
(parsec/scheduling.c:586-625 + remote_dep_mpi.c).  A Python per-task
loop cannot reach that rate; here compute is batched per wave (wave.py)
and communication into a few bulk exchanges per wave:

- every rank lowers the same JDF to the same full DAG (SPMD, like the
  reference: each rank evaluates the PTG locally, README.rst:23-27) and
  walks the same wave schedule = dependence levels of the DAG;
- each rank executes only the tasks its data distribution maps to it
  (owner-computes over ``rank_of`` affinity), as batched body calls
  over its local device tile pools;
- the communication schedule is computed STATICALLY at build time: for
  every tile interval between two writes, any reader on another rank
  gets the tile pushed right after the wave that wrote it, deduplicated
  per (wave, src, dst); the pre-exchange (wave 0) ships home tiles to
  remote first readers, and final writes ship back to the tile's home
  rank.  Both ends derive the identical schedule from the identical
  DAG, so no control messages, tag negotiation or rendezvous are
  needed: the data messages themselves are the entire protocol;
- cross-rank write-after-read needs no handling: a remote write only
  reaches this rank's staged copy of the tile in the post-wave
  exchange, which runs after local execution — the reader batched in
  the same wave saw the old value.  (Local same-wave WAR is layered by
  WaveRunner._split_war as before; two same-wave writers of one tile
  are rejected statically — a racy DAG.)

Memory model: pools are SLICED — each rank stages only the tiles its
tasks touch plus its transfer endpoints (the halo), O(local tiles) of
device memory instead of O(matrix) per rank.  The exchange schedule
speaks global tile indices on the wire; gathers and scatters translate
them to local pool rows (``_g2l``).  Owned tiles no local task touches
are never staged and their home copies stand.

Payload hops, per message: a ``DeviceDataPlane`` (comm/xfer.py: CUDA IPC
between rank processes on one card) when one is attached and routing
allows it; the mesh-local hand-over (comm/mesh.py) to a rank thread of
this process — the gathered tensor travels device to device; host bytes
over the comm engine otherwise.  Broadcast groups (one tile, several
readers) ride static trees, or the collective lane (``_CollectiveLane``,
``wave_dist_collective``): one sum per group over the members'
contributions, zero except at the rows each member sources.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ...comm.engine import TAG_USER_BASE, RankFailedError
from ...comm.remote_dep import bcast_children
from ...data.data import (Coherency, is_device_array, mark_ready,
                          to_host_array, wait_ready)
from ...data.datatype import Datatype
from ...devices import resolve_device
from ...utils import logging as plog
from ...utils.params import params
from .wave import WaveError, WaveRunner, _torch_dtype

__all__ = ["TAG_WAVE", "DistWaveRunner", "lane_device_pool",
           "check_lane_schedule_uniformity"]

TAG_WAVE = TAG_USER_BASE - 4
TAG_WAVE_CFG = TAG_USER_BASE - 5
_LANE_RDV_LOCK = threading.Lock()


def _ensure_cfg_inbox(ce):
    """Per-CE store for lane-config digests ((src, seq) -> digest)."""
    with _LANE_RDV_LOCK:
        ent = getattr(ce, "_wave_cfg_inbox", None)
        if ent is None:
            cv = threading.Condition()
            vals: Dict[Tuple[int, int], str] = {}
            ent = ce._wave_cfg_inbox = (vals, cv)
            ce._wave_cfg_seq = 0

            def _on_cfg(src: int, msg: Dict) -> None:
                with cv:
                    vals[(src, msg["seq"])] = msg["digest"]
                    cv.notify_all()

            ce.tag_register(TAG_WAVE_CFG, _on_cfg)
    return ent


def check_lane_schedule_uniformity(ce, digest: str,
                                   timeout: float = 30.0) -> None:
    """All-exchange a hash of the lane-scheduling params and fail fast on
    divergence: multi-process lane schedules are a pure function of
    (``wave_dist_collective``, ``wave_dist_collective_min_pct``,
    ``wave_reduce_dtype``) — a process that resolves them differently
    skips a global all-reduce the others block in, a distributed hang
    until timeout.  A digest mismatch (or a peer that never answers
    because its params routed it elsewhere) raises WaveError at runner
    setup instead."""
    if ce.nb_ranks < 2:
        return
    vals, cv = _ensure_cfg_inbox(ce)
    with cv:   # seq per exchange: runners are constructed SPMD, so the
        seq = ce._wave_cfg_seq   # n-th exchange pairs up on every rank
        ce._wave_cfg_seq = seq + 1
    for r in range(ce.nb_ranks):
        if r != ce.rank:
            ce.send_am(r, TAG_WAVE_CFG, {"seq": seq, "digest": digest})
    deadline = time.monotonic() + timeout
    for r in range(ce.nb_ranks):
        if r == ce.rank:
            continue
        while True:
            with cv:
                got = vals.get((r, seq))
            if got is not None:
                break
            if time.monotonic() > deadline:
                raise WaveError(
                    f"rank {ce.rank}: no lane-schedule config from rank "
                    f"{r} within {timeout}s — wave_dist_collective / "
                    f"wave_dist_collective_min_pct likely diverge across "
                    f"processes (they must be identical everywhere)")
            ce.progress()
            with cv:
                cv.wait(0.0005)
        if got != digest:
            raise WaveError(
                f"rank {ce.rank}: lane-schedule params diverge from rank "
                f"{r} (hash {got!r} != {digest!r}): wave_dist_collective "
                f"and wave_dist_collective_min_pct must be identical on "
                f"every process")
    with cv:
        for r in range(ce.nb_ranks):
            vals.pop((r, seq), None)


def lane_digest() -> str:
    """The digest ``check_lane_schedule_uniformity`` exchanges: sha1 of
    the repr of the lane-scheduling params (plain Python values, so every
    rank hashes identical bytes)."""
    mode = str(params.get("wave_dist_collective"))
    min_pct = int(params.get("wave_dist_collective_min_pct"))
    rdt = str(params.get("wave_reduce_dtype"))
    sig: Tuple = (mode, min_pct, rdt)
    # the two-level knob changes what every depositor contributes (full
    # precision vs pre-quantized): it rides the digest, appended only
    # when set so an unset knob hashes exactly the bytes it did before
    if bool(params.get("xfer_collective_redist")):
        sig = sig + (True, int(params.get("xfer_group_size")))
    return hashlib.sha1(repr(sig).encode()).hexdigest()


def _ensure_wave_inbox(ce):
    """Per-CE shared inbox for wave-exchange messages.  One handler per
    CE however many runners or pools exist; keys carry the pool name and
    the run epoch, so concurrent or back-to-back runs cannot alias.
    Messages for an epoch older than the pool's current one are dropped
    on arrival (their run already finished or failed).  Park-release
    acks (device-plane payload hop) ride the same tag."""
    with _LANE_RDV_LOCK:
        cv = getattr(ce, "_wave_inbox_cv", None)
        if cv is not None:
            return ce._wave_inbox, cv
        ce._wave_inbox = {}
        ce._wave_epochs = getattr(ce, "_wave_epochs", {})
        ce._wave_parks = set()
        cv = threading.Condition()

        def _on_msg(src: int, msg: Dict) -> None:
            if "ack_uuids" in msg:
                plane = getattr(ce, "device_plane", None)
                for u in msg["ack_uuids"]:
                    if plane is not None:
                        plane.release(u)
                with cv:
                    for u in msg["ack_uuids"]:
                        ce._wave_parks.discard(u)
                    cv.notify_all()
                return
            key = (msg["pool"], msg["epoch"], src, msg["wave"],
                   msg.get("gen", 0))
            with cv:
                if msg["epoch"] < ce._wave_epochs.get(msg["pool"], 0):
                    return   # stale epoch: its run is over
                ce._wave_inbox[key] = msg
                cv.notify_all()

        ce.tag_register(TAG_WAVE, _on_msg)
        ce._wave_inbox_cv = cv
    return ce._wave_inbox, cv


def _rank_mesh_geometry() -> Optional[Tuple[int, int]]:
    """(gp, gq) of the per-rank chip mesh from ``device_mesh_shape``, or
    None when no mesh is configured.  A pure function of params, so
    every SPMD rank derives the same geometry."""
    from ...devices.cuda import parse_mesh_shape
    try:
        gp, gq = parse_mesh_shape(params.get("device_mesh_shape") or "")
    except (ValueError, TypeError):
        return None
    return (gp, gq) if gp * gq > 1 else None


def lane_device_pool(nb_ranks: int, device: Any = None) -> List[Any]:
    """rank -> the chip (``parallel.mesh.Chip``) the collective lane
    reduces on, from the chip pool of ``device`` (``devices.chip_pool``:
    the physical cards, or ``device_cuda_virtual_chips`` logical chips
    on ``cuda:0``; raising without a card unless ``device`` or
    ``device_cuda_platform`` names the host).  With ``device_mesh_shape``
    set, rank r owns the disjoint chip slice the device layer carves at
    ``r * k``, so its lane chip is chip 0 of that slice; without, or when
    the pool cannot hold every rank's slice, the ranks share the pool's
    chips in turn (on one card and no virtual chips, all share chip
    0)."""
    from ...devices import chip_pool
    pool = chip_pool(device)
    geom = _rank_mesh_geometry()
    if geom is not None:
        k = geom[0] * geom[1]
        # slices must be DISJOINT; a pool the carving wraps keeps the
        # pre-mesh layout
        if len(pool) >= nb_ranks * k:
            return [pool[r * k] for r in range(nb_ranks)]
    return [pool[r % len(pool)] for r in range(nb_ranks)]


def _dist_world() -> int:
    """The torch.distributed world size (0 when no process group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


class _CollectiveLane:
    """ONE sum per broadcast group instead of P point-to-point sends (the
    reference's dynamic trees are parsec/remote_dep.c:272-358).

    A broadcast tile group becomes a single all-reduce over the group's
    members: every member contributes a stacked tensor that is ZERO
    except at the rows it sources, so the sum over members IS the
    broadcast.  Adding zeros is exact, so a lane broadcast delivers the
    source's bits.

    Substrates:
    - ``multiproc``: one rank process each, ``torch.distributed``
      initialised with world size == nb_ranks (``dist_*`` knobs): each
      group is one ``all_reduce`` over gloo, staged through a host
      buffer.  Only FULL calls ride this mode: every process joins every
      call (non-members with zeros), in the same global order.
    - ``inproc``: SPMD rank threads of one process (the port's
      condition: ``wave_dist_collective=on`` and one process; on one
      card every rank's lane device is cuda:0).  Members deposit their
      contribution at a rendezvous keyed by (pool, epoch, wave, cid,
      members); the LAST depositor issues the one sum on the device and
      everyone picks the result up.  Partial groups (any >= 3 members,
      e.g. a 2D block-cyclic panel's column readers) reduce over just
      their members.  Each deposit carries an event recorded on its
      depositor's stream; the issuer's stream waits on them, and every
      pick-up waits on the issuer's event (``data.mark_ready`` /
      ``wait_ready``), never on a host synchronisation.
    """

    def __init__(self, mode: str, nb_ranks: int, rank: int,
                 rendezvous=None, timeout: float = 120.0,
                 dead_fn=None, reduce_dtype: Optional[str] = None,
                 shared_feedback=None, stats=None) -> None:
        from ...parallel.mesh import ErrorFeedback, _quant_codec_of
        self.mode = mode
        self.nb_ranks = nb_ranks
        self.rank = rank
        self.timeout = timeout
        # reduced-precision lane (``wave_reduce_dtype``): each rank's
        # contribution quantizes AT THE BOUNDARY (blockwise bf16/int8 —
        # exactly the wire codecs, parallel/mesh.qdq) before the
        # deposit; the sum itself stays full precision.  Error feedback
        # engages only for callers that pass a stable ``fb_key`` naming
        # a recurring logical buffer: the broadcast-by-sum wave steps
        # carry DIFFERENT tiles every wave, so feeding one wave's
        # residual into the next would corrupt unrelated data
        self._qcodec = _quant_codec_of(reduce_dtype)
        self._efb = ErrorFeedback()
        self.quantized_reduces = 0
        # hierarchical reduction (``xfer_collective_redist``): deposits
        # stay full precision and the issuer reduces through
        # parallel/mesh.two_level_allreduce — full-precision partial
        # sums inside each ``xfer_group_size``-wide group, one qdq per
        # GROUP at the boundary.  ``shared_feedback`` (fabric-owned)
        # keeps each group's residual in ONE place whichever rank
        # thread issues; ``stats`` mirrors issue counts into the
        # engine's dplane_stats gauges
        self._two_level = bool(params.get("xfer_collective_redist"))
        gs = int(params.get("xfer_group_size"))
        if gs <= 0:
            geom = _rank_mesh_geometry()
            gs = geom[0] * geom[1] if geom is not None else 2
        self._group_size = max(2, gs)
        self._efb_shared = (shared_feedback if shared_feedback is not None
                            else ErrorFeedback())
        self._stats = stats
        self.two_level_reduces = 0
        # liveness probe for the rendezvous wait (ft/): the CE's
        # dead_peers, so an evicted member aborts the collective now
        self.dead_fn = dead_fn or (lambda: ())
        self._rdv = rendezvous   # shared (slots, results, condvar)
        # the issuer's sum: an attribute so tests can fault-inject it
        self._sum = lambda stacked: stacked.sum(dim=0)

    def _quantize_contrib(self, contrib: torch.Tensor, fb_key):
        """Quantize one contribution at the reduction boundary (through
        the same codec as the wire, so lane and wire round identically);
        dtype and shape are preserved."""
        from ...parallel.mesh import qdq
        if contrib.dtype not in (torch.float32, torch.float64):
            return contrib   # int/bool/f16 stay exact, and uncounted
        if fb_key is not None:
            out = self._efb.compensate(fb_key, contrib, self._qcodec, qdq)
        else:
            out = qdq(contrib, self._qcodec)
        self.quantized_reduces += 1
        return out

    def _two_level_issue(self, deposits, fb_key):
        """Issuer-side hierarchical reduction over the members' full-
        precision deposits: partial sums inside each group, one qdq per
        group at the boundary, the quantized partials summed.  Error
        feedback keys per (fb_key, group) live in the fabric-shared
        accumulator, so the carry is the same whichever thread issues."""
        from ...parallel.mesh import two_level_allreduce
        return two_level_allreduce(
            deposits, self._group_size, self._qcodec,
            feedback=self._efb_shared if fb_key is not None else None,
            key=fb_key)

    def reduce(self, key: Tuple, contrib: torch.Tensor,
               members: Optional[Tuple[int, ...]] = None,
               fb_key=None) -> torch.Tensor:
        """All-reduce one padded contribution stack; returns the sum on
        the contribution's device.

        ``members``: sorted tuple of participating ranks for a PARTIAL
        group (in-process substrate only: a multi-process call needs
        every process); None = all ranks.  ``fb_key``: stable name of a
        RECURRING logical buffer — opts this contribution into error
        feedback under the reduced-precision lane (None = quantize
        only)."""
        full = members is None or len(members) == self.nb_ranks
        parts = tuple(range(self.nb_ranks)) if full else members
        # the two-level routing decision is SPMD-pure (params, dtype,
        # member count): depositors and issuer always agree on whether
        # deposits are full precision or pre-quantized
        two_level = (self._qcodec is not None and self._two_level
                     and self.mode != "multiproc"
                     and contrib.dtype in (torch.float32, torch.float64)
                     and len(parts) > self._group_size)
        if self._qcodec is not None and not two_level:
            contrib = self._quantize_contrib(contrib, fb_key)
        if self.mode == "multiproc":
            if not full:
                raise WaveError("the multi-process lane schedules full "
                                "calls only")
            import torch.distributed as dist
            host = contrib.detach().to("cpu", copy=True)
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            return host.to(contrib.device)
        # in-process rendezvous: the last depositor issues the one sum
        key = key + (parts,)
        slots, results, cv = self._rdv
        with cv:
            mine = slots.setdefault(key, {})
            mine[self.rank] = mark_ready(contrib)
            if len(mine) == len(parts):
                try:
                    deps = [wait_ready(mine[r]).to(contrib.device)
                            for r in parts]
                    if two_level:
                        out = self._two_level_issue(deps, fb_key)
                    else:
                        out = self._sum(torch.stack(deps))
                    results[key] = [mark_ready(out), len(parts)]
                except BaseException:
                    # peers-only refcount: the issuer re-raises and
                    # never reaches the pick-up decrement below
                    results[key] = [None, len(parts) - 1]
                    raise
                finally:
                    del slots[key]
                    cv.notify_all()
            else:
                deadline = time.monotonic() + self.timeout
                while key not in results:
                    # collective abort on eviction (ft/): a member the
                    # failure detector declared dead will never deposit
                    dead = self.dead_fn()
                    gone = [r for r in parts
                            if r != self.rank and r in dead]
                    if gone or time.monotonic() > deadline:
                        # withdraw the deposit so a late issuer cannot
                        # fire with this rank's share unaccounted
                        ours = slots.get(key)
                        if ours is not None:
                            ours.pop(self.rank, None)
                            if not ours:
                                del slots[key]
                        if gone:
                            raise RankFailedError(
                                gone[0], f"evicted during collective-lane "
                                f"rendezvous {key}")
                        raise WaveError(
                            f"rank {self.rank}: collective-lane "
                            f"rendezvous {key} timed out")
                    cv.wait(0.1)
            ent = results[key]
            ent[1] -= 1
            out = ent[0]
            if ent[1] <= 0:
                del results[key]
        if out is None:
            raise WaveError(f"rank {self.rank}: collective-lane issuer "
                            f"failed for {key}")
        if two_level:
            # count per member so the per-rank gauge stays comparable
            self.two_level_reduces += 1
            if self._stats is not None:
                self._stats["two_level_reduces"] += 1
        return wait_ready(out).to(contrib.device)


class DistWaveRunner(WaveRunner):
    """Wave executor for a multi-rank PTG taskpool.

    ``comm`` is a RemoteDepEngine or a raw CommEngine; it defaults to the
    taskpool's attached engine (``tp.comm``).  Payload hop: cross-process
    transports get a DeviceDataPlane attached by default (tiles move
    device to device, the message carries only a descriptor; MCA
    ``wave_dist_plane`` = auto/on/off); rank threads of one process hand
    tensors over device to device (``comm_mesh_local``); otherwise tiles
    ride the CE's active messages as host bytes.  Multi-destination
    tiles propagate along static broadcast trees (``wave_dist_bcast`` =
    binomial/chain/star) with in-step re-forwarding, or the collective
    lane (``wave_dist_collective``).

    ``run(device=None)`` runs on ``cuda:0`` (raising without a card);
    ``run(device="cpu")`` over host tensors.
    """

    _multirank = True

    def __init__(self, tp, max_chunk: int = 256, comm=None,
                 comm_timeout: float = 120.0) -> None:
        comm = comm if comm is not None else getattr(tp, "comm", None)
        if comm is None:
            raise WaveError(
                "distributed wave needs a comm engine: pass comm= or "
                "attach the taskpool to a context with one")
        self.ce = getattr(comm, "ce", comm)
        if self.ce.nb_ranks != tp.nb_ranks:
            raise WaveError(
                f"comm engine spans {self.ce.nb_ranks} ranks but the "
                f"taskpool declares {tp.nb_ranks}")
        self.comm_timeout = comm_timeout
        super().__init__(tp, max_chunk=max_chunk)
        self.rank = int(tp.rank)
        self.nb_ranks = int(tp.nb_ranks)
        self._mesh_local = bool(params.get("comm_mesh_local"))
        self._rank_of_task = self._compute_task_ranks()
        self._levels = self._compute_levels()
        self._setup_collective_lane()
        self._check_lane_uniformity()
        self._build_comm_schedule()
        self._build_local_maps()
        _ensure_wave_inbox(self.ce)
        self._auto_device_plane()

    def _auto_device_plane(self) -> None:
        """The payload hop defaults to the device plane on cross-process
        transports.  MCA ``wave_dist_plane``: auto (attach on the TCP
        transport; in-process ranks hand tensors over directly), on
        (force), off.  Routing rule (the JAX package's): while the
        multi-process lane has groups scheduled, tiles do not ride the
        plane (in the JAX package a pull parked behind a peer's blocking
        all-reduce deadlocked; with gloo it does not, but every rank
        keeps the same rule, a pure function of the static schedule and
        params, so all ranks route alike).  ``_plane_ok`` gates USE, not
        just attachment: a plane an earlier runner attached is covered."""
        from ...comm.tcp import TCPCommEngine
        from ...comm.xfer import DeviceDataPlane
        mode = str(params.get("wave_dist_plane"))
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"wave_dist_plane={mode!r}: expected "
                             f"auto/on/off")
        hazard = (self._lane is not None and self._lane.mode == "multiproc"
                  and bool(self._lane_sched))
        self._plane_ok = (not hazard) or mode == "on"
        if mode == "off" or \
                getattr(self.ce, "device_plane", None) is not None:
            return
        if mode == "auto" and (not isinstance(self.ce, TCPCommEngine)
                               or hazard):
            return
        ctx = getattr(self.tp, "context", None)
        dev = ctx.device_by_type("cuda") if ctx is not None else None
        if dev is None:
            dev = resolve_device(None)
        DeviceDataPlane(self.ce, device=dev).exchange(
            timeout=self.comm_timeout)

    def _setup_collective_lane(self) -> None:
        """MCA ``wave_dist_collective`` = auto/on/off.  auto: attach the
        multi-process lane when ``torch.distributed`` spans exactly one
        process per rank (the ``dist_*`` knobs); otherwise trees.  on:
        that, or the in-process lane when every rank is a thread of this
        process (one process); anything else raises.  The decision is a
        pure function of process topology and params, so all SPMD ranks
        agree; ``stats["collective_lane"]`` names what was chosen."""
        self._lane: Optional[_CollectiveLane] = None
        mode = str(params.get("wave_dist_collective"))
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"wave_dist_collective={mode!r}: expected "
                             f"auto/on/off")
        if mode == "off" or self.nb_ranks < 2:
            return
        # validated before any attach: a typo'd knob fails loudly
        from ...parallel.mesh import _quant_codec_of
        reduce_dtype = str(params.get("wave_reduce_dtype"))
        _quant_codec_of(reduce_dtype)
        stats = getattr(self.ce, "dplane_stats", None)
        world = _dist_world()
        if world == self.nb_ranks:
            self._lane = _CollectiveLane(
                "multiproc", self.nb_ranks, self.rank,
                timeout=self.comm_timeout, reduce_dtype=reduce_dtype,
                stats=stats)
            return
        if mode != "on":
            return   # auto: no multi-process group -> trees
        in_process = world <= 1 and all(
            self.ce.mesh_local_with(r) for r in range(self.nb_ranks))
        if not in_process:
            raise WaveError(
                f"wave_dist_collective=on: no lane can attach — "
                f"torch.distributed spans {world} processes for "
                f"{self.nb_ranks} ranks, and the ranks are not threads of "
                f"one process")
        from ...parallel.mesh import ErrorFeedback
        fab = getattr(self.ce, "fabric", None) or self.ce
        with _LANE_RDV_LOCK:   # SPMD threads race the attach
            rdv = getattr(fab, "_lane_rdv", None)
            if rdv is None:
                rdv = ({}, {}, threading.Condition())
                fab._lane_rdv = rdv
            # two-level residuals are per GROUP, applied by whichever
            # rank thread issues: one fabric-owned accumulator
            efb = getattr(fab, "_lane_efb", None)
            if efb is None:
                efb = ErrorFeedback()
                fab._lane_efb = efb
        self._lane = _CollectiveLane(
            "inproc", self.nb_ranks, self.rank, rendezvous=rdv,
            timeout=self.comm_timeout,
            dead_fn=lambda ce=self.ce: getattr(ce, "dead_peers", ()),
            reduce_dtype=reduce_dtype, shared_feedback=efb, stats=stats)

    def _check_lane_uniformity(self) -> None:
        """Enforce SPMD-identical lane scheduling on multi-process
        deployments (one process per rank in one torch.distributed
        group): exchange ``lane_digest()`` over the CE and fail fast on a
        mismatch instead of hanging in a half-joined all-reduce.  Rank
        threads of one process share one params registry, so uniformity
        holds by construction and the exchange is skipped."""
        if self.nb_ranks < 2 or _dist_world() != self.nb_ranks:
            return
        check_lane_schedule_uniformity(
            self.ce, lane_digest(), timeout=min(30.0, self.comm_timeout))

    # ------------------------------------------------------------------ #
    # static analysis                                                    #
    # ------------------------------------------------------------------ #
    def _compute_task_ranks(self) -> np.ndarray:
        dag = self.dag
        out = np.zeros(dag.n_tasks, np.int32)
        for p in self.plans:
            if p.ast.affinity_collection is None:
                raise WaveError(
                    f"{p.ast.name}: no affinity (': desc(...)') — every "
                    f"class needs one in distributed wave mode (task "
                    f"ownership IS the affinity)")
        for t in range(dag.n_tasks):
            tc = self.plans[int(dag.class_of[t])].tc
            out[t] = tc.rank_of_instance(tc.env_of(dag.locals_of[t]))
        return out

    def _wire_tname_of(self, tc, f, env):
        """[type_remote] on the instance's bound in-dep applies when the
        producer lives on ANOTHER rank (consumer-side resolution, the
        remote_dep_mpi.c:766 datatype lookup; parsec_reshape.c): the
        exchange still ships the raw tile — the masked wire cast runs in
        the consumer's body call, per instance (local edges ignore it).
        Both ends derive ranks from the same static affinity, so the
        decision is SPMD-consistent."""
        for d in f.deps_in():
            t = d.resolve(env)
            if t is None:
                continue
            if t.kind != "task" or d.properties.get("type") is not None:
                return None   # the local [type] rule already applies
            nm = d.properties.get("type_remote")
            if nm is None or nm == "full":
                return None
            prank = tc.producer_rank_of(t, env)
            if prank is None or prank == tc.rank_of_instance(env):
                return None   # local edge: the wire type never applies
            val = self.tp.global_env.get(nm)
            if not isinstance(val, Datatype) and \
                    nm not in ("lower", "upper", "full"):
                raise WaveError(
                    f"{tc.ast.name}.{f.name}: [type_remote={nm}] is "
                    f"neither a Datatype global nor a region shorthand")
            return nm
        return None

    def _compute_levels(self) -> List[np.ndarray]:
        """Dependence levels of the DAG = the wave schedule (a task's
        wave is 1 + the max wave of its predecessors; level i executes
        as wave i+1, wave 0 is the pre-exchange)."""
        dag = self.dag
        indeg = dag.indegree.copy()
        frontier = [int(t) for t in np.nonzero(indeg == 0)[0]]
        levels: List[np.ndarray] = []
        seen = 0
        while frontier:
            levels.append(np.asarray(sorted(frontier), np.int32))
            seen += len(frontier)
            nxt: List[int] = []
            for t in frontier:
                for e in range(int(dag.indptr[t]), int(dag.indptr[t + 1])):
                    s = int(dag.succ[e])
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        nxt.append(s)
            frontier = nxt
        if seen != dag.n_tasks:
            raise WaveError("cycle in lowered DAG")
        return levels

    def _home_rank(self, cid: int, idx: int) -> int:
        coll = self.collections[self.pool_names[cid]]
        return int(coll.rank_of(*self._pool_coords[cid][idx]))

    def _build_comm_schedule(self) -> None:
        """Derive the full exchange schedule from the slot table.

        Timeline semantics (what pool execution does): a read at wave w
        sees the last write at any wave < w, else the home/staged value.
        Every (reader rank != value-source rank) pair becomes one pushed
        tile after the source wave; last writes additionally push home.
        The schedule is a pure function of the DAG and the distribution,
        so all SPMD ranks compute the same one."""
        dag = self.dag
        wave_of = np.zeros(dag.n_tasks, np.int32)
        for lv, members in enumerate(self._levels):
            wave_of[members] = lv + 1
        self._wave_of = wave_of

        writers: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        readers: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        for t in range(dag.n_tasks):
            p = self.plans[int(dag.class_of[t])]
            w, r = int(wave_of[t]), int(self._rank_of_task[t])
            for k in range(len(p.flow_idx)):
                if p.written[k]:
                    key = (int(self._slot_out_coll[t, k]),
                           int(self._slot_out[t, k]))
                    writers.setdefault(key, []).append((w, t, r))
                    if p.wb_name[k] is not None and self._wb_apply[t, k]:
                        # a masked writeback READS the destination tile
                        # (out-of-region merge): its current value must
                        # be local even for WRITE-only flows
                        readers.setdefault(key, []).append((w, t, r))
                    if int(self._wbx_cid[t, k]) >= 0:
                        # dual-output flow: the extra masked scatter both
                        # reads and writes its memory target
                        keyx = (int(self._wbx_cid[t, k]),
                                int(self._wbx_idx[t, k]))
                        writers.setdefault(keyx, []).append((w, t, r))
                        readers.setdefault(keyx, []).append((w, t, r))
                if p.reads[k]:
                    key = (int(self._slot_coll[t, k]), int(self._slot[t, k]))
                    readers.setdefault(key, []).append((w, t, r))

        transfers: Set[Tuple[int, int, int, int, int]] = set()
        ws_sorted: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        for key, wl in writers.items():
            ws = sorted(wl)
            for a, b in zip(ws, ws[1:]):
                if a[0] == b[0] and a[1] != b[1]:
                    cid, idx = key
                    raise WaveError(
                        f"two writers of tile {self._pool_coords[cid][idx]}"
                        f" in {self.pool_names[cid]} share wave {a[0]} "
                        f"(tasks {a[1]}, {b[1]}): the DAG races")
            ws_sorted[key] = ws

        for key, rl in readers.items():
            ws = ws_sorted.get(key, ())
            # scratch pools (NEW flows) have no home: pre-write reads see
            # zeros on every rank — consistent without a transfer
            is_scratch = key[0] >= self._n_real_colls
            home = None if is_scratch else self._home_rank(*key)
            for (w, _t, r) in rl:
                src_wave, src_rank = 0, home
                for (ww, _wt, wr) in ws:
                    if ww >= w:
                        break
                    src_wave, src_rank = ww, wr
                if src_rank is not None and src_rank != r:
                    transfers.add((src_wave, src_rank, r) + key)

        returns: Set[Tuple[int, int, int, int, int]] = set()
        for key, ws in ws_sorted.items():
            if key[0] >= self._n_real_colls:
                continue   # scratch: nothing to return home
            w, _t, r = ws[-1]
            home = self._home_rank(*key)
            if r != home:
                transfers.add((w, r, home) + key)
                returns.add((w, r, home) + key)

        # Collective propagation (the reference's remote_dep.c:272-358
        # re-forward): a tile with several same-wave destinations ships
        # along a STATIC broadcast tree instead of P point-to-point sends
        # from the source.  Every edge carries its sender's tree depth
        # ("gen"); a comm step processes gens in order — send gen g
        # (g = 0 from my pools, g > 0 from tiles just received), then
        # absorb gen-g arrivals — so forwards are deadlock-free by
        # construction (gen-g messages depend only on gens < g).
        topo = str(params.get("wave_dist_bcast"))
        if topo not in ("binomial", "chain", "star"):
            raise ValueError(f"wave_dist_bcast={topo!r}: expected "
                             f"binomial/chain/star")
        grouped: Dict[Tuple[int, int, int, int], List[int]] = {}
        for (w, src, dst, cid, idx) in transfers:
            grouped.setdefault((w, src, cid, idx), []).append(dst)
        edges: Set[Tuple[int, int, int, int, int, int]] = set()
        # lane_sched[wave][(cid, members)] -> sorted [(idx, src)]: a
        # broadcast group rides ONE collective per (wave, pool, member
        # set); members is the sorted participant tuple ({src} | dsts),
        # identical on every rank, so the rendezvous and the reduce
        # order agree globally
        lane_sched: Dict[int, Dict[Tuple[int, Tuple[int, ...]],
                                   List[Tuple[int, int]]]] = {}
        # multi-process partial groups synchronise EVERY process; below
        # this member share the |dsts| sends are cheaper than a full
        # call (a pure function of the schedule and params).  In-process
        # groups cost only their members and take no threshold
        min_pct = int(params.get("wave_dist_collective_min_pct"))
        for (w, src, cid, idx), dsts in grouped.items():
            dsts = sorted(set(dsts))
            # never for a single destination (a 1-dst collective loses
            # to one send); partial groups ride both substrates
            if self._lane is not None and len(dsts) >= 2:
                members = tuple(sorted({src, *dsts}))
                if not (self._lane.mode == "multiproc"
                        and len(dsts) < self.nb_ranks - 1
                        and len(members) * 100
                        < self.nb_ranks * min_pct):
                    lane_sched.setdefault(w, {}).setdefault(
                        (cid, members), []).append((idx, src))
                    continue
            if topo == "star" or len(dsts) == 1:
                for d in dsts:
                    edges.add((w, src, d, cid, idx, 0))
                continue
            parts = [src] + dsts          # identical on every rank
            frontier = [(0, 0)]
            while frontier:
                nxt = []
                for pos, depth in frontier:
                    for cpos in bcast_children(pos, len(parts), topo):
                        edges.add((w, parts[pos], parts[cpos],
                                   cid, idx, depth))
                        nxt.append((cpos, depth + 1))
                frontier = nxt

        # sends[wave][gen][dst][cid] -> sorted idx list (src == me);
        # recvs[wave][gen] -> sorted src list
        sends: Dict[int, Dict[int, Dict[int, Dict[int, List[int]]]]] = {}
        recvs: Dict[int, Dict[int, Set[int]]] = {}
        for (w, src, dst, cid, idx, g) in edges:
            if src == self.rank:
                (sends.setdefault(w, {}).setdefault(g, {})
                 .setdefault(dst, {}).setdefault(cid, [])).append(idx)
            if dst == self.rank:
                recvs.setdefault(w, {}).setdefault(g, set()).add(src)
        for by_gen in sends.values():
            for by_dst in by_gen.values():
                for by_coll in by_dst.values():
                    for lst in by_coll.values():
                        lst.sort()
        self._sends = sends
        self._recvs = {w: {g: sorted(s) for g, s in by_gen.items()}
                       for w, by_gen in recvs.items()}
        self._bcast_topo = topo
        self._lane_sched = {w: {c: sorted(v) for c, v in by_c.items()}
                            for w, by_c in lane_sched.items()}
        self._transfers = {(w, s, d, c, i)
                           for (w, s, d, c, i, _g) in edges}
        self._returns = returns & self._transfers
        self._n_transfers = len(self._transfers)

    def transfer_kind(self, tr: Tuple[int, int, int, int, int]) -> str:
        """"pre" (the wave-0 pre-exchange of home tiles), "return" (a
        last write shipped home) or "push" (a write shipped to a remote
        reader) for one (wave, src, dst, cid, idx) of the schedule."""
        if tr[0] == 0:
            return "pre"
        return "return" if tr in self._returns else "push"

    def schedule_summary(self) -> Dict[str, Any]:
        """This rank's share of the static schedule: per kind, the tiles
        and bytes it sends and receives, and the lane's groups and tiles
        it takes part in."""
        out: Dict[str, Any] = {}
        for kind in ("pre", "push", "return"):
            out[kind] = {"sent": 0, "sent_bytes": 0, "recv": 0,
                         "recv_bytes": 0}
        nbytes: Dict[int, int] = {}
        for tr in sorted(self._transfers):
            w, s, d, cid, _i = tr
            if self.rank not in (s, d):
                continue
            if cid not in nbytes:
                shape, dt = self._pool_tile_spec(cid)
                nbytes[cid] = int(np.prod(shape)) * np.dtype(dt).itemsize
            ent = out[self.transfer_kind(tr)]
            side = "sent" if s == self.rank else "recv"
            ent[side] += 1
            ent[side + "_bytes"] += nbytes[cid]
        groups = tiles = 0
        for by_grp in self._lane_sched.values():
            for (_cid, members), entries in by_grp.items():
                if self.rank in members:
                    groups += 1
                    tiles += len(entries)
        out["lane"] = {"groups": groups, "tiles": tiles}
        return out

    def _build_local_maps(self) -> None:
        """SLICED pools: this rank stages only the tiles it touches —
        local task slots plus the endpoints of transfers it takes part
        in.  The exchange schedule keeps speaking GLOBAL tile indices on
        the wire, translated to pool rows at gathers and scatters
        (``_g2l``; wave.py translates kernel indices through it)."""
        n_pools = self._n_real_colls + len(self._scratch)
        sizes = [len(self._pool_coords[c])
                 for c in range(self._n_real_colls)]
        for sp in sorted(self._scratch.values(), key=lambda s: s["cid"]):
            sizes.append(sp["n"])
        touched: List[set] = [set() for _ in range(n_pools)]
        for t in np.nonzero(self._rank_of_task == self.rank)[0]:
            p = self.plans[int(self.dag.class_of[t])]
            for k in range(len(p.flow_idx)):
                touched[int(self._slot_coll[t, k])].add(
                    int(self._slot[t, k]))
                if p.written[k]:
                    touched[int(self._slot_out_coll[t, k])].add(
                        int(self._slot_out[t, k]))
                    if int(self._wbx_cid[t, k]) >= 0:
                        touched[int(self._wbx_cid[t, k])].add(
                            int(self._wbx_idx[t, k]))
        for (_w, src, dst, cid, idx) in self._transfers:
            if src == self.rank or dst == self.rank:
                touched[cid].add(idx)
        for by_grp in self._lane_sched.values():
            # lane tiles: every group MEMBER is an endpoint
            for (cid, members), entries in by_grp.items():
                if self.rank in members:
                    touched[cid].update(i for (i, _s) in entries)
        self._l2g = [np.asarray(sorted(s), np.int32) for s in touched]
        g2l = []
        for c in range(n_pools):
            m = np.full(max(sizes[c], 1), -1, np.int32)
            if len(self._l2g[c]):
                m[self._l2g[c]] = np.arange(len(self._l2g[c]),
                                            dtype=np.int32)
            g2l.append(m)
        self._g2l = g2l

    def _pool_tile_spec(self, cid: int):
        """(tile_shape, numpy dtype) of one pool, without staging it.
        NOT the (mb, nb) block size: edge tiles of a short matrix can be
        smaller than the block while still uniform across the pool."""
        if cid < self._n_real_colls:
            coll = self.collections[self.pool_names[cid]]
            sh = self._pool_shapes[cid]
            dt = getattr(coll, "dtype", None)
            if sh is None or dt is None:
                # materialize a LOCALLY-OWNED tile only: the pool's first
                # global coord may live on another rank, and data_of
                # there would fabricate or fetch what is not ours.
                # Without an owned coord the collection must declare the
                # static contract
                c0 = next(
                    (c for c in self._pool_coords[cid]
                     if int(coll.rank_of(*c)) == self.rank), None)
                if c0 is None:
                    raise WaveError(
                        f"rank {self.rank}: collection "
                        f"{self.pool_names[cid]!r} declares no static "
                        f"tile_shape/dtype and this rank owns no tile of "
                        f"the pool — the collective lane requires the "
                        f"static contract on non-member ranks (set "
                        f"tile_shape/dtype on the collection)")
                arr = np.asarray(coll.data_of(*c0).sync_to_host().payload)
                sh = tuple(arr.shape) if sh is None else sh
                dt = arr.dtype if dt is None else dt
            return tuple(sh), np.dtype(dt)
        sp = next(s for s in self._scratch.values() if s["cid"] == cid)
        if sp["shape"] is not None:
            return tuple(sp["shape"]), np.dtype(sp["dtype"])
        return self._pool_tile_spec(sp["like"])

    def build_pools(self, device=None, sharding=None) -> Tuple:
        """Stage only this rank's slice of every pool (see
        ``_build_local_maps``) on ``device`` (None: cuda:0, raising
        without a card); ``self.stage_in_bytes`` holds the host bytes
        moved.  ``sharding`` (each rank's pools split across its own
        chips) needs a tile split across chips (part D2c) and raises."""
        if sharding is not None:
            raise NotImplementedError(
                "build_pools(sharding=...): a rank's sliced pools split "
                "across its own chips need a tile split across chips "
                "(ROADMAP Queue 1, part D2c)")
        device = resolve_device(device)
        pools: List[Any] = []
        staged = 0
        for cid, name in enumerate(self.pool_names):
            loc = self._l2g[cid]
            if cid not in self._used_colls or not len(loc):
                pools.append(torch.zeros((0,), device=device))
                continue
            coll = self.collections[name]
            coords = self._pool_coords[cid]
            tiles = [np.asarray(
                coll.data_of(*coords[int(g)]).sync_to_host().payload)
                for g in loc]
            pool = torch.empty((len(tiles),) + tiles[0].shape,
                               dtype=_torch_dtype(tiles[0].dtype),
                               device=device)
            for i, t in enumerate(tiles):
                if t.shape != tiles[0].shape:
                    raise WaveError(
                        f"{name}: tiles {tiles[0].shape} and {t.shape} in "
                        f"one pool; a ragged tiling needs tile_shape")
                pool[i].copy_(torch.from_numpy(np.ascontiguousarray(t)))
                staged += t.nbytes
            pools.append(pool)
        for sp in sorted(self._scratch.values(), key=lambda s: s["cid"]):
            loc = self._l2g[sp["cid"]]
            if not len(loc):
                pools.append(torch.zeros((0,), device=device))
                continue
            shape, dt = self._pool_tile_spec(sp["cid"])
            pools.append(torch.zeros((len(loc),) + shape,
                                     dtype=_torch_dtype(dt), device=device))
        self.stage_in_bytes = staged
        self.device = device
        return tuple(pools)

    # ------------------------------------------------------------------ #
    # execution                                                          #
    # ------------------------------------------------------------------ #
    def execute(self, pools: Tuple) -> Tuple:
        ce = self.ce
        inbox, cv = _ensure_wave_inbox(ce)
        pool_name = self.tp.name
        with cv:
            epoch = ce._wave_epochs[pool_name] = (
                ce._wave_epochs.get(pool_name, 0) + 1)
        self._cur = (pool_name, epoch)
        self._sent_tiles = self._recv_tiles = self._fwd_tiles = 0
        self._fwd_host_stacks = self._fwd_device_stacks = 0
        self._lane_calls = self._lane_joins = self._lane_tiles = 0
        self._mesh_sends = self._plane_sends = self._host_sends = 0
        self._msgs = 0
        pools = list(pools)
        if self.device is None:
            self.device = pools[0].device
        ok = False
        t0 = time.perf_counter()
        try:
            pools = self._comm_step(0, pools)
            n_calls = 0
            for lv, members in enumerate(self._levels):
                mine = members[self._rank_of_task[members] == self.rank]
                if mine.size:
                    pools, nc = self._execute_frontier(
                        mine, self.dag.class_of[mine], pools)
                    pools = list(pools)
                    n_calls += nc
                pools = self._comm_step(lv + 1, pools)
            ok = True
            lane = self._lane
            # WaveRunner.stats' schema plus the exchange counters
            self.stats = {
                "tasks": self.dag.n_tasks,
                "waves": len(self._levels),
                "kernel_calls": n_calls,
                "dispatch_secs": round(time.perf_counter() - t0, 6),
                "compiled_kernels": sum(len(p.kernels)
                                        for p in self.plans)
                + len(self._fused_kerns),
                "local_tasks": int((self._rank_of_task == self.rank).sum()),
                "transfers_scheduled": self._n_transfers,
                "messages_sent": self._msgs,
                "tiles_sent": self._sent_tiles,
                "tiles_recv": self._recv_tiles,
                "tiles_forwarded": self._fwd_tiles,
                "fwd_host_stacks": self._fwd_host_stacks,
                "fwd_device_stacks": self._fwd_device_stacks,
                "mesh_local_sends": self._mesh_sends,
                "plane_sends": self._plane_sends,
                "host_sends": self._host_sends,
                "bcast_topology": self._bcast_topo,
                "collective_lane": lane.mode if lane is not None else None,
                "collective_calls": self._lane_calls,
                "collective_joins": self._lane_joins,
                "collective_tiles": self._lane_tiles,
                "collective_reduce_dtype": (
                    lane._qcodec if lane is not None else None),
                "collective_quantized": (
                    lane.quantized_reduces if lane is not None else 0),
                "collective_two_level": (
                    lane.two_level_reduces if lane is not None else 0),
                "device_plane": (getattr(self.ce, "device_plane", None)
                                 is not None and self._plane_ok),
                "local_tiles": int(sum(len(g) for g in self._l2g)),
            }
        finally:
            # drop anything still keyed to this run (abort and timeout
            # paths must not leak tile payloads on the long-lived CE),
            # and wait out the consumers' park acks (device-plane hop);
            # on the exception path acks may never come, so the real
            # error does not wait a second full timeout
            with cv:
                for k in [k for k in inbox
                          if k[0] == pool_name and k[1] == epoch]:
                    del inbox[k]
            self._drain_parks(timeout=self.comm_timeout if ok else 1.0)
        plog.debug.verbose(
            3, "dist wave %s rank %d: %d/%d tasks in %d waves, %d body "
            "calls, %d transfers scheduled", pool_name, self.rank,
            int((self._rank_of_task == self.rank).sum()), self.dag.n_tasks,
            len(self._levels), n_calls, self._n_transfers)
        return tuple(pools)

    def _lrows(self, cid: int, idxs, device) -> torch.Tensor:
        """This rank's pool rows of global tile indices ``idxs``, as an
        index tensor on ``device``."""
        lidx = self._g2l[cid][np.asarray(idxs, np.int64)]
        return torch.from_numpy(lidx.astype(np.int64)).to(device)

    def _lane_step(self, w: int, pools: List) -> List:
        """This wave's broadcast groups, ONE collective each per (wave,
        pool, member set): gather my sourced rows into a zero-padded
        contribution stack, all-reduce over the group (sum ==
        broadcast), scatter the result into my staged pool rows.  Groups
        this rank is not a member of are skipped in-process (their
        members rendezvous without us) and joined with zeros across
        processes.  None of these tiles appear in ``_sends``."""
        sched = self._lane_sched.get(w)
        if not sched:
            return pools
        pool_name, epoch = self._cur
        multiproc = self._lane.mode == "multiproc"
        dev = self.device
        # sorted keys: every rank walks its shared groups in the same
        # global order, so the blocking rendezvous can never cycle — and
        # every process issues the same calls in the same order
        for cid, members in sorted(sched):
            member = self.rank in members
            if not member and not multiproc:
                continue
            entries = sched[(cid, members)]
            idxs = [i for (i, _s) in entries]
            srcs = np.asarray([s for (_i, s) in entries], np.int32)
            n = len(entries)
            npad = 1 << max(0, (n - 1).bit_length())   # fixed sizes
            shape, dt = self._pool_tile_spec(cid)
            # the dtype is the spec's, a pure function every process
            # agrees on (a non-member's pool may be a placeholder)
            contrib = torch.zeros((npad,) + tuple(shape),
                                  dtype=_torch_dtype(dt), device=dev)
            mine = np.nonzero(srcs == self.rank)[0] if member \
                else np.empty(0, np.int64)
            if len(mine):
                rows = pools[cid].index_select(
                    0, self._lrows(cid, [idxs[j] for j in mine], dev))
                contrib.index_copy_(
                    0, torch.from_numpy(mine.astype(np.int64)).to(dev),
                    rows)
            out = self._lane.reduce(
                (pool_name, epoch, w, cid), contrib,
                members=None if multiproc else members)
            if not member:
                # joined the SPMD call with zeros: counted apart, so
                # collective_calls keeps meaning "carried MY tiles"
                self._lane_joins += 1
                continue
            self._lane_calls += 1
            pools[cid].index_copy_(0, self._lrows(cid, idxs, dev),
                                   out[:n].to(pools[cid].dtype))
            self._lane_tiles += n
        return pools

    def _payload(self, dst: int, gathered: Any, plane) -> Any:
        """What carries one gathered stack to ``dst``: a plane
        descriptor (the tensor parked for a device-to-device pull), the
        tensor itself to a rank thread of this process (device to
        device: it is a fresh stack no one mutates), or read-only host
        bytes."""
        if is_device_array(gathered):
            mark_ready(gathered)   # the gather ran on this thread's stream
            if plane is not None:
                u, shape, dt = plane.register(gathered)
                _ib, cv = _ensure_wave_inbox(self.ce)
                with cv:
                    self.ce._wave_parks.add(u)
                self._plane_sends += 1
                return {"xfer": (u, tuple(shape), dt, plane.descriptor(u))}
            if self._mesh_local and self.ce.mesh_local_with(dst):
                self._mesh_sends += 1
                return gathered
            gathered = to_host_array(gathered)
        payload = np.asarray(gathered)
        try:
            # a fresh stack no one mutates: read-only lets the TCP chunk
            # path send it zero-copy instead of re-snapshotting
            payload.setflags(write=False)
        except ValueError:
            pass   # foreign-base view: already safe
        self._host_sends += 1
        return payload

    def _comm_step(self, w: int, pools: List) -> List:
        """Push my wave-w writes to their remote readers, then absorb what
        wave w wrote elsewhere that I will read (payload hops: see
        ``_payload``)."""
        pools = self._lane_step(w, pools)
        pool_name, epoch = self._cur
        # _plane_ok: the routing rule of _auto_device_plane, which also
        # covers planes attached by earlier runners
        plane = (getattr(self.ce, "device_plane", None)
                 if self._plane_ok else None)
        send_gens = self._sends.get(w, {})
        recv_gens = self._recvs.get(w, {})
        if not send_gens and not recv_gens:
            return pools
        dev = self.device
        max_gen = max(list(send_gens) + list(recv_gens))
        # every incoming tile of this wave, applied as one in-place
        # scatter per pool
        upd: Dict[int, Tuple[List[int], List[Any]]] = {}
        pulled: List[Tuple[int, int]] = []   # (src, uuid)
        # tiles received at gen < g, kept for my gen-g re-forwards
        fwd_cache: Dict[Tuple[int, int], Any] = {}
        for g in range(max_gen + 1):
            for dst in sorted(send_gens.get(g, ())):
                colls = []
                for cid in sorted(send_gens[g][dst]):
                    idxs = send_gens[g][dst][cid]   # GLOBAL on the wire
                    if g == 0:
                        # the tree root: the value is in my pools
                        gathered = pools[cid].index_select(
                            0, self._lrows(cid, idxs, dev))
                    else:
                        # re-forward what a parent just sent me; rows
                        # stay on the device whenever any row is a tensor
                        rows = [fwd_cache[(cid, i)] for i in idxs]
                        if all(isinstance(r, np.ndarray) for r in rows):
                            gathered = np.stack(rows)
                            self._fwd_host_stacks += 1
                        else:
                            gathered = torch.stack(
                                [torch.as_tensor(r).to(dev) for r in rows])
                            self._fwd_device_stacks += 1
                        self._fwd_tiles += len(idxs)
                    colls.append((cid, idxs,
                                  self._payload(dst, gathered, plane)))
                    self._sent_tiles += len(idxs)
                # a tile payload message: eligible for the lossy
                # quantized wire codecs toward peers that negotiated one
                self.ce.send_am(dst, TAG_WAVE,
                                {"pool": pool_name, "epoch": epoch,
                                 "wave": w, "gen": g, "colls": colls,
                                 "_qz_ok": True})
                self._msgs += 1
            for src in recv_gens.get(g, ()):
                msg = self._await_msg(src, w, g)
                for cid, idxs, payload in msg["colls"]:
                    if isinstance(payload, dict):
                        if plane is None:  # not assert: survive python -O
                            raise WaveError(
                                f"rank {self.rank}: peer {src} sent a "
                                f"device-plane transfer descriptor but "
                                f"this rank has no DeviceDataPlane "
                                f"attached (attach one on every rank)")
                        u, shape, dt, desc = payload["xfer"]
                        arr = plane.pull(src, u, tuple(shape), dt,
                                         desc=desc)
                        pulled.append((src, u))
                    elif is_device_array(payload):
                        arr = wait_ready(payload)   # mesh-local hand-over
                    else:
                        arr = np.asarray(payload)
                    lst = upd.setdefault(cid, ([], []))
                    lst[0].extend(idxs)
                    lst[1].append(arr)
                    self._recv_tiles += len(idxs)
                    if g < max_gen:
                        for i, idx in enumerate(idxs):
                            fwd_cache[(cid, idx)] = arr[i]
        if pulled:
            # the ack releases the producer's park: a pull returns once
            # its bytes landed
            by_src: Dict[int, List[int]] = {}
            for (s, u) in pulled:
                by_src.setdefault(s, []).append(u)
            for s, uuids in by_src.items():
                self.ce.send_am(s, TAG_WAVE, {"ack_uuids": uuids})
        for cid, (idxs, arrs) in upd.items():
            vals = torch.cat([torch.as_tensor(a).to(dev) for a in arrs])
            pools[cid].index_copy_(0, self._lrows(cid, idxs, dev),
                                   vals.to(pools[cid].dtype))
        return pools

    def _drain_parks(self, timeout: float) -> None:
        """Wait for consumers' park acks so no transfer buffers leak on
        the long-lived CE (warn instead of failing a completed run)."""
        _ib, cv = _ensure_wave_inbox(self.ce)
        deadline = time.monotonic() + timeout
        while True:
            with cv:
                n = len(self.ce._wave_parks)
            if n == 0:
                return
            if time.monotonic() > deadline:
                plog.warning("rank %d: %d wave transfer park(s) never "
                             "acked within %.0fs", self.rank, n, timeout)
                return
            self.ce.progress()
            with cv:
                cv.wait(0.0005)

    def _await_msg(self, src: int, w: int, gen: int = 0) -> Dict:
        pool_name, epoch = self._cur
        key = (pool_name, epoch, src, w, gen)
        inbox, cv = _ensure_wave_inbox(self.ce)
        deadline = time.monotonic() + self.comm_timeout
        while True:
            with cv:
                msg = inbox.pop(key, None)
            if msg is not None:
                return msg
            self.ce.progress()
            # failure detection AFTER the drain: the peer's final message
            # may have been queued right before it died — progress() just
            # delivered it.  A cleanly finished peer cannot send the owed
            # message either
            if src in getattr(self.ce, "dead_peers", ()) \
                    or self.ce.peer_finished(src):
                with cv:
                    msg = inbox.pop(key, None)
                if msg is not None:
                    return msg
                raise RankFailedError(
                    src, f"gone owing wave-{w} exchange for {pool_name}")
            with cv:
                if key in inbox:
                    continue
                cv.wait(0.0005)
            if time.monotonic() > deadline:
                raise WaveError(
                    f"rank {self.rank}: no wave-exchange message {key} "
                    f"within {self.comm_timeout}s (peer dead or schedules "
                    f"diverged)")

    # ------------------------------------------------------------------ #
    # pool staging                                                       #
    # ------------------------------------------------------------------ #
    def scatter_pools(self, pools: Tuple) -> None:
        """Register this rank's results: only tiles it OWNS and staged
        (their home is here and some task touched them; untouched owned
        tiles were never staged and their home copies stand).  The final
        returns brought every last write home first, so owned tiles are
        current on their owner.

        Write-back is LAZY by default: each owned tile's newest copy
        becomes a LazyPoolCopy slicing the device pool on first read, so
        a single-tile host read pulls exactly one tile.  MCA
        ``wave_lazy_writeback=0`` pulls the owned rows eagerly."""
        if not bool(params.get("wave_lazy_writeback")):
            return self._scatter_pools_eager(pools)
        from .turbo import LazyPoolCopy, _PoolHolder
        holder = _PoolHolder()
        holder.pools = pools
        if self.device is not None and self.device.type == "cuda":
            # a read of a row may queue on another stream (the device
            # module's): it waits for this thread's, which ran the wave
            holder.ready = torch.cuda.Event()
            holder.ready.record()
        self._wb_holder = holder   # pools live as long as the copies
        did = self._writeback_device_id()
        for cid, name in enumerate(self.pool_names):
            if cid not in self._written_rows or cid >= self._n_real_colls:
                continue
            coll = self.collections[name]
            coords = self._pool_coords[cid]
            for j, g in enumerate(self._l2g[cid]):
                c = coords[int(g)]
                if int(coll.rank_of(*c)) != self.rank:
                    continue
                data = coll.data_of(*c)
                old = data.get_copy(did)
                if old is not None:
                    data._detach_copy(old)
                h0 = data.get_copy(0)
                lazy = LazyPoolCopy(data, did, holder, cid, j,
                                    dtt=None if h0 is None else h0.dtt)
                data.attach_copy(lazy)
                lazy.coherency = Coherency.OWNED
                data.version_bump(did)

    def _writeback_device_id(self) -> int:
        """Device slot for the lazy result copies: the context's device
        module when one is attached, else slot 1 (any non-host id works:
        ``sync_to_host`` without a device list converts directly)."""
        ctx = getattr(self.tp, "context", None)
        if ctx is not None:
            for d in getattr(ctx, "devices", ()):
                if d.device_type == "cuda":
                    return d.device_index
        return 1

    def _scatter_pools_eager(self, pools: Tuple) -> None:
        for cid, name in enumerate(self.pool_names):
            if cid not in self._written_rows or cid >= self._n_real_colls:
                continue
            coll = self.collections[name]
            coords = self._pool_coords[cid]
            owned = [(j, int(g)) for j, g in enumerate(self._l2g[cid])
                     if int(coll.rank_of(*coords[int(g)])) == self.rank]
            if not owned:
                continue
            idx = torch.tensor([j for j, _g in owned], dtype=torch.int64,
                               device=pools[cid].device)
            host = pools[cid].index_select(0, idx).cpu().numpy()
            for row, (_j, g) in enumerate(owned):
                data = coll.data_of(*coords[g])
                hc = data.host_copy()
                if hc.payload is None:
                    hc.payload = host[row].copy()
                else:
                    np.copyto(hc.payload, host[row])
                data.version_bump(0)

    def run(self, device=None) -> None:
        """Stage in this rank's slice, execute, register the results;
        ``device`` None is cuda:0 (raising without a card), "cpu" the
        host."""
        pools = self.execute(self.build_pools(device))
        self.scatter_pools(pools)
