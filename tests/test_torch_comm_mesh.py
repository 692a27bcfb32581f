"""The port's mesh transport (comm/mesh.py): in-process ranks pinned to
devices, payloads moved device to device, control messages in the
process — the JAX package's ``tests/test_comm_mesh.py`` cases on
``[cpu] * n`` devices (one card would give ``[cuda:0] * n``).

Plus the port's own hazard: a torch tile is mutable, where a JAX device
array is not.  A payload handed to another rank of this process must not
change when its producer rewrites the tile right after the send, so the
mesh-local path of remote_dep ships a private device copy taken on the
producer's stream.  The tests rewrite the tile in place right after the
send, at the engine level and end to end through DTD.
"""
import threading
import types

import numpy as np
import pytest
import torch

import parsec_tpu_torch
from parsec_tpu_torch.collections import DictCollection, TwoDimBlockCyclic
from parsec_tpu_torch.comm import MeshFabric, RemoteDepEngine
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.utils.params import params
from parsec_tpu_torch.utils.spmd import spmd_threads

SPMD_TIMEOUT = 120

CHAIN_JDF = """
descA [ type="collection" ]
NB [ type="int" ]

T(k)

k = 0 .. NB

: descA( k, 0 )

RW X <- (k == 0) ? descA( 0, 0 ) : X T( k-1 )
     -> (k < NB) ? X T( k+1 )
     -> (k == NB) ? descA( NB, 0 )

BODY
{
    X = np.asarray(X) + 1.0
}
END
"""


def _mesh_fabric(nb_ranks):
    return MeshFabric(devices=["cpu"] * nb_ranks)


def _host_ctx(eng):
    """A context with no device module (host bodies), as the JAX
    package's ``enable_tpu=False``."""
    with params.cmdline_override("device_cuda_enabled", "0"):
        return parsec_tpu_torch.Context(nb_cores=1, comm=eng)


def _run_chain(nb_ranks, mb=48):
    """A chain crossing ranks every hop, its payload above the short
    limit: every hop is a GET rendezvous served by the mesh."""
    fabric = _mesh_fabric(nb_ranks)

    def rank_fn(rank, fabric):
        ctx = _host_ctx(RemoteDepEngine(fabric.engine(rank)))
        try:
            nhops = 2 * nb_ranks
            coll = TwoDimBlockCyclic((nhops + 1) * mb, mb, mb, mb,
                                     P=nb_ranks, Q=1, nodes=nb_ranks,
                                     rank=rank, dtype=np.float32)
            coll.name = "descA"
            tp = ptg.compile_jdf(CHAIN_JDF, name="meshchain").new(
                descA=coll, NB=nhops, rank=rank, nb_ranks=nb_ranks)
            ctx.add_taskpool(tp)
            ctx.wait()
            if coll.rank_of(nhops, 0) == rank:
                return float(np.asarray(coll.tile(nhops, 0))[0, 0])
            return None
        finally:
            ctx.fini()

    with params.cmdline_override("runtime_comm_short_limit", "64"):
        results, fabric = spmd_threads(nb_ranks, rank_fn,
                                       timeout=SPMD_TIMEOUT, fabric=fabric)
    return results, fabric


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_mesh_chain_data_plane(nb_ranks):
    results, fabric = _run_chain(nb_ranks)
    assert [v for v in results if v is not None] == [float(2 * nb_ranks + 1)]
    # every hop's payload crossed as a device tensor
    assert fabric.d2d_transfers >= 2 * nb_ranks
    assert fabric.d2d_bytes > 0
    assert fabric.msg_count > 0    # the control plane is still AMs


def test_mesh_engine_get_lands_on_requester_device():
    """A GET-served buffer is a copy on the requester's device."""
    fabric = _mesh_fabric(2)
    e0, e1 = fabric.engine(0), fabric.engine(1)
    src = torch.arange(16.0).reshape(4, 4)
    h = e0.mem_register(src)
    got = []
    e1.get(0, h.handle_id, got.append)
    e0.progress()
    e1.progress()
    assert len(got) == 1
    arr = got[0]
    assert arr.device == fabric.devices[1]
    assert arr.data_ptr() != src.data_ptr()
    np.testing.assert_allclose(arr.numpy(), src.numpy())


def test_mesh_put_device_region_rebinds():
    fabric = _mesh_fabric(2)
    e0, e1 = fabric.engine(0), fabric.engine(1)
    h = e1.mem_register(torch.zeros(4, 4))
    e0.put(1, h.handle_id, np.full((4, 4), 7.0, np.float32))
    e1.progress()
    arr = e1._mem[h.handle_id].array
    assert isinstance(arr, torch.Tensor)
    assert arr.device == fabric.devices[1]
    np.testing.assert_allclose(arr.numpy(), 7.0)


def test_mesh_fabric_needs_enough_devices():
    with pytest.raises(RuntimeError):
        MeshFabric(nb_ranks=10 ** 6)
    # explicit devices pin several ranks to one device
    assert MeshFabric(devices=["cpu"] * 3).nb_ranks == 3


def test_dtd_chain_over_mesh():
    """The DTD cross-rank (tile, seq) data plane over the mesh transport:
    a chain alternating between 2 ranks, payload above the short limit,
    host bodies (the hops ride GET replies device to device)."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import (AFFINITY, INOUT, INPUT, VALUE,
                                          unpack_args)
    nb_ranks, N = 2, 6

    def rank_fn(rank, fabric):
        ctx = _host_ctx(RemoteDepEngine(fabric.engine(rank)))
        try:
            coll = DictCollection(nodes=nb_ranks, rank=rank)
            coll.name = "C"
            coll.add("x", 0, np.zeros(128) if rank == 0 else None)
            anchors = {}
            for r in range(nb_ranks):
                a = DictCollection(nodes=nb_ranks, rank=rank)
                a.name = f"anchor{r}"
                a.add("a", r, np.zeros(1) if r == rank else None)
                anchors[r] = a
            tp = dtd.taskpool_new("meshchain")
            ctx.add_taskpool(tp)
            tile = tp.tile_of(coll, "x")

            def bump(es, task):
                x, _anchor, k = unpack_args(task)
                assert x[0] == k, f"task {k} saw {x[0]}"
                x[0] += 1.0

            for k in range(N):
                at = tp.tile_of(anchors[k % nb_ranks], "a")
                tp.insert_task(bump, (tile, INOUT),
                               (at, INPUT | AFFINITY), (k, VALUE))
            tp.data_flush_all()
            tp.wait()
            ctx.wait()
            if rank == 0:
                return float(np.asarray(
                    coll.data_of("x").get_copy(0).payload)[0])
            return None
        finally:
            ctx.fini()

    with params.cmdline_override("runtime_comm_short_limit", "64"):
        results, fabric = spmd_threads(nb_ranks, rank_fn,
                                       timeout=SPMD_TIMEOUT,
                                       fabric=_mesh_fabric(nb_ranks))
    assert results[0] == float(N)
    assert fabric.d2d_transfers > 0
    assert fabric.d2d_bytes > 0


# --------------------------------------------------------------------- #
# the mutable-tile hazard of the mesh-local path                        #
# --------------------------------------------------------------------- #
def test_mesh_local_dtd_send_survives_rewrite_after_send():
    """rank 0 hands a device tensor to rank 1 and rewrites it in place
    right after: rank 1 receives the value at send time (a private copy
    travelled), counted as a mesh-local send, with no host staging."""
    fabric = _mesh_fabric(2)
    rde0 = RemoteDepEngine(fabric.engine(0))
    rde1 = RemoteDepEngine(fabric.engine(1))
    tp = types.SimpleNamespace(comm_tp_id=7)
    t = torch.full((64, 64), 1.0)
    rde0.dtd_send(tp, "x", 1, 1, t)
    t.add_(100.0)                 # the producer's next write, in place
    got = []
    rde1.dtd_expect(tp, "x", 1, got.append)
    rde1.ce.progress()
    assert len(got) == 1 and isinstance(got[0], torch.Tensor)
    assert torch.all(got[0] == 1.0)
    assert got[0].data_ptr() != t.data_ptr()
    assert rde0.stats["mesh_local_sends"] == 1
    assert rde0.stats["host_staged_bytes"] == 0
    assert fabric.d2d_transfers == 1
    assert fabric.d2d_bytes == 64 * 64 * 4


def test_mesh_local_activation_survives_rewrite_after_send():
    """The same through a PTG activation: the payload of a completed
    task's flow goes to a peer of this process as a private copy."""
    from parsec_tpu_torch.comm.engine import TAG_ACTIVATE
    fabric = _mesh_fabric(2)
    rde0 = RemoteDepEngine(fabric.engine(0))
    RemoteDepEngine(fabric.engine(1))
    got = []
    fabric.engines[1].tag_register(TAG_ACTIVATE,
                                   lambda src, msg: got.append(msg))
    tp = types.SimpleNamespace(comm_tp_id=3)
    t = torch.full((32, 32), 2.0)
    rde0.activate_batch(tp, None, {0: t}, {1: [(0, (0,), "X", 0)]})
    t.mul_(-1.0)
    fabric.engines[1].progress()
    assert len(got) == 1
    assert torch.all(got[0]["data"] == 2.0)
    assert rde0.stats["mesh_local_sends"] == 1
    assert rde0.stats["host_staged_bytes"] == 0


def test_mesh_local_off_stages_through_the_host():
    """comm_mesh_local=0: the same send is host bytes, no device tensor
    crosses."""
    with params.cmdline_override("comm_mesh_local", "0"):
        fabric = _mesh_fabric(2)
        rde0 = RemoteDepEngine(fabric.engine(0))
        rde1 = RemoteDepEngine(fabric.engine(1))
    tp = types.SimpleNamespace(comm_tp_id=7)
    rde0.dtd_send(tp, "x", 1, 1, torch.full((4, 4), 3.0))
    got = []
    rde1.dtd_expect(tp, "x", 1, got.append)
    rde1.ce.progress()
    assert isinstance(got[0], np.ndarray) and np.all(got[0] == 3.0)
    assert rde0.stats["mesh_local_sends"] == 0
    assert rde0.stats["host_staged_bytes"] == 4 * 4 * 4
    assert fabric.d2d_transfers == 0


def test_dtd_device_chain_rewrite_after_send_end_to_end():
    """DTD over the mesh with device chores (contexts on the host's
    device module): rank 0 writes the tile IN PLACE, rank 1 reads it,
    rank 0 rewrites it in place at once.  The reader sees the first
    value (the private copy), every hop is mesh-local, no host staging,
    and the last value comes home exact."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, INPUT
    seen = []

    def rank_fn(rank, fabric):
        ctx = parsec_tpu_torch.Context(
            nb_cores=2, comm=RemoteDepEngine(fabric.engine(rank)),
            device="cpu")
        try:
            def coll(name, key, owner, shape):
                c = DictCollection(nodes=2, rank=rank)
                c.name = name
                c.add(key, owner, np.zeros(shape, np.float32)
                      if owner == rank else None)
                return c

            tile_c = coll("C", "x", 0, (64, 64))
            anchors = [coll(f"anchor{r}", "a", r, (1, 1)) for r in range(2)]
            boots = [coll(f"boot{r}", "b", r, (1, 1)) for r in range(2)]
            tp = dtd.taskpool_new("rewrite")
            ctx.add_taskpool(tp)

            def write(es, task):
                raise RuntimeError(f"{task.snprintf()} ran its host body")

            def read(es, task):
                from parsec_tpu_torch.dsl.dtd import unpack_args
                x, _a = unpack_args(task)
                seen.append(float(x[0, 0]))

            for r in range(2):   # create the class with a boot task
                tp.insert_task(write, (tp.tile_of(boots[r], "b"), INOUT),
                               (tp.tile_of(anchors[r], "a"),
                                INPUT | AFFINITY))
            # in place: the chore mutates the tile it is given
            tp.add_chore(write, "cuda", lambda x, a: x.add_(1.0))
            tile = tp.tile_of(tile_c, "x")
            tp.insert_task(write, (tile, INOUT),
                           (tp.tile_of(anchors[0], "a"), INPUT | AFFINITY))
            tp.insert_task(read, (tile, INPUT),
                           (tp.tile_of(anchors[1], "a"), INPUT | AFFINITY))
            tp.insert_task(write, (tile, INOUT),
                           (tp.tile_of(anchors[0], "a"), INPUT | AFFINITY))
            tp.insert_task(write, (tile, INOUT),
                           (tp.tile_of(anchors[1], "a"), INPUT | AFFINITY))
            tp.data_flush_all()
            tp.wait()
            ctx.wait()
            out = {"mesh": ctx.comm.stats["mesh_local_sends"],
                   "host": ctx.comm.stats["host_staged_bytes"]}
            if rank == 0:
                from parsec_tpu_torch.data.data import to_host_array
                out["x"] = to_host_array(
                    tile_c.data_of("x").get_copy(0).payload)
            return out
        finally:
            ctx.fini()

    results, fabric = spmd_threads(2, rank_fn, timeout=SPMD_TIMEOUT,
                                   fabric=_mesh_fabric(2))
    assert seen == [1.0]
    assert np.all(results[0]["x"] == 3.0)
    assert all(r["mesh"] > 0 and r["host"] == 0 for r in results), results
    assert fabric.d2d_transfers > 0


@pytest.mark.gpu
def test_mesh_local_private_copy_orders_on_streams_gpu():
    """On the card the private copy queues on the producer's device
    module stream behind a long kernel, and the consumer's stage-in waits
    for its event: the consumer reads the value at send time even while
    the producer keeps writing on its stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from parsec_tpu_torch.data.data import wait_ready
    fabric = MeshFabric(devices=["cuda:0"] * 2)
    rde0 = RemoteDepEngine(fabric.engine(0))
    rde1 = RemoteDepEngine(fabric.engine(1))
    ctx_stream = torch.cuda.Stream()
    rde0.context = types.SimpleNamespace(
        device_by_type=lambda t: types.SimpleNamespace(stream=ctx_stream))
    tp = types.SimpleNamespace(comm_tp_id=1)
    big = torch.randn(4096, 4096, device="cuda")
    with torch.cuda.stream(ctx_stream):
        x = big
        for _ in range(10):
            x = x @ big / 4096.0
        t = torch.full((1024, 1024), 5.0, device="cuda") + 0.0 * x[0, 0]
    rde0.dtd_send(tp, "x", 1, 1, t)
    with torch.cuda.stream(ctx_stream):
        t.add_(1.0)
    got = []
    rde1.dtd_expect(tp, "x", 1, got.append)
    rde1.ce.progress()
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        val = wait_ready(got[0]).clone()
    other.synchronize()
    assert torch.all(val == 5.0)
    assert threading.active_count() >= 1
