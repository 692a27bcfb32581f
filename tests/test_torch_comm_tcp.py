"""The port's ranks as OS processes over the TCP comm engine.

The test spawns this file once per rank (``python test_torch_comm_tcp.py
<mode> <hops>`` under ``if __name__ == "__main__"``) with the launcher
contract in the environment — ``PARSEC_MCA_comm_transport=tcp``,
``comm_endpoints``, ``comm_rank`` — and ``device_cuda_platform=cpu``:
``parsec_tpu_torch.init()`` wires the TCP engine itself.  Every rank
process has its own deadline and is killed past it, so a hang fails one
test.  Mirrors the JAX package's ``tests/test_comm_tcp.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EADDRINUSE_RC = 75      # a rank could not bind its endpoint: retry

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
    X[0, 0] = X[0, 0] + 1.0
}
END
"""
FAIL_JDF = CHAIN_JDF.replace("X[0, 0] = X[0, 0] + 1.0", "X = hook(X, k)")
N, NB, NRHS = 96, 32, 16


# ---------------------------------------------------------------------- #
# the rank driver (runs in the spawned processes)                        #
# ---------------------------------------------------------------------- #
def _run_chain(ctx, rank, nb_ranks, hops, fail=False):
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    mb = 16
    coll = TwoDimBlockCyclic((hops + 1) * mb, mb, mb, mb, P=nb_ranks, Q=1,
                             nodes=nb_ranks, rank=rank)
    coll.name = "descA"
    kill_k = hops // 2 + (1 - (hops // 2) % 2)   # an odd k: rank 1's

    def hook(X, k):
        if rank == 1 and k == kill_k:
            os._exit(3)   # simulated crash: no teardown, no goodbye
        X[0, 0] = X[0, 0] + 1.0
        return X

    tp = ptt.ptg.compile_jdf(FAIL_JDF if fail else CHAIN_JDF,
                             name="chain").new(
        descA=coll, NB=hops, rank=rank, nb_ranks=nb_ranks)
    tp.global_env["hook"] = hook
    ctx.add_taskpool(tp)
    if fail:
        from parsec_tpu_torch.comm.engine import RankFailedError
        try:
            ctx.wait()
        except RuntimeError as exc:
            return {"detected": isinstance(exc.__cause__, RankFailedError),
                    "failed_rank": getattr(exc.__cause__, "rank", None)}
        return {"detected": False}
    ctx.wait()
    return {"tiles": {str(k): float(coll.tile(k, 0)[0, 0])
                      for k in range(hops + 1) if coll.rank_of(k, 0) == rank}}


def _run_dtd(ctx, rank, nb_ranks, hops):
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import DictCollection
    from parsec_tpu_torch.dsl.dtd import (AFFINITY, INOUT, INPUT, VALUE,
                                          unpack_args)
    coll = DictCollection(nodes=nb_ranks, rank=rank)
    coll.name = "C"
    coll.add("x", 0, np.zeros(512) if rank == 0 else None)  # 4 KB payload
    anchors = {}
    for r in range(nb_ranks):
        a = DictCollection(nodes=nb_ranks, rank=rank)
        a.name = f"anchor{r}"
        a.add("a", r, np.zeros(1) if r == rank else None)
        anchors[r] = a
    tp = ptt.dtd.taskpool_new("tcpdtd")
    ctx.add_taskpool(tp)
    tile = tp.tile_of(coll, "x")

    def bump(es, task):
        x, _anchor, k = unpack_args(task)
        if x[0] != k:
            raise AssertionError(f"task {k} saw {x[0]}")
        x[0] += 1.0

    for k in range(hops):
        tp.insert_task(bump, (tile, INOUT),
                       (tp.tile_of(anchors[k % nb_ranks], "a"),
                        INPUT | AFFINITY), (k, VALUE))
    tp.data_flush_all()
    tp.wait()
    ctx.wait()
    out = {}
    if rank == 0:
        out["x"] = float(coll.data_of("x").get_copy(0).payload[0])
    return out


def _run_dposv(ctx, rank, nb_ranks, plane=False):
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    M = ptt.ops.make_spd(N)
    rng = np.random.RandomState(1)
    Bm = (rng.rand(N, NRHS) - 0.5).astype(np.float32)
    dp = None
    if plane:
        from parsec_tpu_torch.comm import DeviceDataPlane
        dp = DeviceDataPlane(ctx.comm.ce, device=ctx.device_by_type("cuda"))
        dp.exchange()

    def dist(src, P, Q):
        d = TwoDimBlockCyclic(src.shape[0], src.shape[1], NB, NB, P=P, Q=Q,
                              nodes=nb_ranks, rank=rank)
        for (i, j) in d.local_tiles():
            np.copyto(d.tile(i, j),
                      src[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB])
        return d

    A = dist(M, 2, nb_ranks // 2)
    B = dist(Bm, nb_ranks, 1)
    A.name, B.name = "descA", "descB"
    ptt.ops.dposv(ctx, A, B, rank=rank, nb_ranks=nb_ranks)
    tiles = {}
    for name, d in (("A", A), ("B", B)):
        for (i, j) in d.local_tiles():
            host = d.data_of(i, j).sync_to_host(ctx.devices).payload
            tiles[f"{name}{i},{j}"] = np.asarray(host).tolist()
    dev = ctx.device_by_type("cuda")
    out = {"tiles": tiles, "device_tasks": dev.stats["tasks"],
           "host_staged_bytes": ctx.comm.stats["host_staged_bytes"]}
    if dp is not None:
        out.update(pulls=dp.stats["pulls"], leaked=dp.leaked_parks,
                   plane_sends=ctx.comm.stats["plane_sends"],
                   rendezvous_host=ctx.comm.stats["rendezvous_host"])
    return out


def _run_ipc(ctx, rank):
    """Rank 0 parks a seeded tile on the CUDA-IPC plane and sends its
    descriptor; rank 1 pulls it into its own memory, checks the bits and
    ACKs; rank 0 waits for the ACK to release the park."""
    import time
    import torch
    from parsec_tpu_torch.comm import DeviceDataPlane
    from parsec_tpu_torch.comm.engine import TAG_USER_BASE
    from parsec_tpu_torch.comm.xfer import TAG_XFER_ACK
    ce = ctx.comm.ce
    dev = ctx.device_by_type("cuda")
    plane = DeviceDataPlane(ce, device=dev)
    plane.exchange()
    ref = torch.from_numpy(np.random.RandomState(11).rand(1024, 1024)
                           .astype(np.float32))
    box = []
    ce.tag_register(TAG_USER_BASE + 5, lambda src, p: box.append(p))
    deadline = time.monotonic() + 60
    if rank == 0:
        # a view at an offset inside a larger allocation: the handle
        # names the base allocation, the offset travels with it
        # (tiles are written on the device module's stream, as a task
        # body's kernel writes them)
        with torch.cuda.stream(dev.stream):
            big = torch.zeros(3, 1024, 1024, device=dev.torch_device)
            big[1].copy_(ref.to(dev.torch_device))
        u, shape, dtype = plane.register(big[1])
        with torch.cuda.stream(dev.stream):
            big.zero_()        # later writes must not reach the consumer
        ce.send_am(1, TAG_USER_BASE + 5, {"uuid": u, "shape": shape,
                                          "dtype": dtype,
                                          "desc": plane.descriptor(u)})
        while plane.leaked_parks and time.monotonic() < deadline:
            ce.progress()
            time.sleep(0.001)
        out = {"leaked": plane.leaked_parks,
               "backend": plane.backend_name}
    else:
        while not box and time.monotonic() < deadline:
            ce.progress()
            time.sleep(0.001)
        m = box[0]
        got = plane.pull(0, m["uuid"], m["shape"], m["dtype"],
                         desc=m["desc"])
        same = bool(torch.equal(got.cpu(), ref))
        ce.send_am(0, TAG_XFER_ACK, {"uuid": m["uuid"]})
        out = {"same": same, "device": str(got.device),
               "pulls": plane.stats["pulls"],
               "bytes": plane.stats["bytes_pulled"]}
    ce.sync()
    return out


def _rank_main(mode: str, hops: int) -> int:
    sys.path.insert(0, ROOT)
    import errno
    import parsec_tpu_torch as ptt
    try:
        ctx = ptt.init(nb_cores=1)   # light on the CPU: tests run beside
    except OSError as exc:
        if exc.errno == errno.EADDRINUSE:
            return EADDRINUSE_RC
        raise
    rank, nb_ranks = ctx.rank, ctx.nb_ranks
    try:
        if mode in ("chain", "fail"):
            out = _run_chain(ctx, rank, nb_ranks, hops, fail=mode == "fail")
        elif mode == "dtd":
            out = _run_dtd(ctx, rank, nb_ranks, hops)
        elif mode == "ipc":
            out = _run_ipc(ctx, rank)
        else:
            out = _run_dposv(ctx, rank, nb_ranks,
                             plane=mode == "dposv_plane")
        out["rank"] = rank
        out["msgs"] = ctx.comm.ce.fabric.msg_count
    finally:
        if mode != "fail":
            ctx.fini()
    print(json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------- #
# the tests                                                              #
# ---------------------------------------------------------------------- #
def _spawn(nb_ranks, mode, hops=0, env_extra=None, deadline=120,
           expect_rcs=None, on_card=False):
    """Run the rank processes; each is killed past ``deadline`` seconds.
    A rank that lost its endpoint to another process (the ports are
    probed free, then bound later) makes the whole set rerun on fresh
    ports."""
    from parsec_tpu_torch.comm import free_ports
    expect_rcs = expect_rcs or [0] * nb_ranks
    for _attempt in range(4):
        ports = free_ports(nb_ranks)
        procs = []
        for r in range(nb_ranks):
            env = dict(os.environ)
            env.update({
                "PARSEC_MCA_comm_transport": "tcp",
                "PARSEC_MCA_comm_endpoints": ",".join(
                    f"127.0.0.1:{p}" for p in ports),
                "PARSEC_MCA_comm_rank": str(r)})
            if not on_card:
                env.update({"PARSEC_MCA_device_cuda_platform": "cpu",
                            "CUDA_VISIBLE_DEVICES": ""})
            env.update(env_extra or {})
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(hops)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        try:
            for p in procs:
                try:
                    out, err = p.communicate(timeout=deadline)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    pytest.fail(f"a rank passed its {deadline} s deadline")
                outs.append((p.returncode, out, err))
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        if any(rc == EADDRINUSE_RC for rc, _o, _e in outs):
            continue
        for want, (rc, out, err) in zip(expect_rcs, outs):
            assert rc == want, (rc, out[-2000:], err[-4000:])
        return [json.loads(o.strip().splitlines()[-1]) if rc == 0 else None
                for rc, o, _e in outs]
    pytest.fail("endpoints kept colliding with other processes")


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_ptg_chain_across_processes(nb_ranks):
    hops = 7
    reps = _spawn(nb_ranks, "chain", hops)
    merged = {}
    for r in reps:
        merged.update({int(k): v for k, v in r["tiles"].items()})
    expect = {k: 0.0 for k in range(hops + 1)}
    expect[0] = 1.0
    expect[hops] = float(hops + 1)
    assert merged == expect
    assert all(r["msgs"] > 0 for r in reps)


def test_dtd_chain_across_processes():
    reps = _spawn(2, "dtd", 6)
    assert reps[0]["x"] == 6.0


def _solve_check(reps, plane):
    import parsec_tpu_torch as ptt
    M = ptt.ops.make_spd(N)
    rng = np.random.RandomState(1)
    Bm = (rng.rand(N, NRHS) - 0.5).astype(np.float32)
    X = np.zeros((N, NRHS), np.float32)
    for r in reps:
        for key, t in r["tiles"].items():
            if key.startswith("B"):
                i = int(key[1:].split(",")[0])
                X[i * NB:(i + 1) * NB] = np.asarray(t, np.float32)
        assert r["device_tasks"] > 0
    ref = np.linalg.solve(M.astype(np.float64), Bm.astype(np.float64))
    assert np.abs(X - ref).max() < 1e-3
    # bit-identical to the one-rank dposv on the same input
    ctx = ptt.init(nb_cores=2, device="cpu")
    try:
        from parsec_tpu_torch.collections import TwoDimBlockCyclic
        A1 = TwoDimBlockCyclic(N, N, NB, NB).from_numpy(M)
        B1 = TwoDimBlockCyclic(N, NRHS, NB, NB).from_numpy(Bm)
        ptt.ops.dposv(ctx, A1, B1)
    finally:
        ctx.fini()
    np.testing.assert_array_equal(X, B1.to_numpy())
    if plane:
        assert sum(r["pulls"] for r in reps) > 0
        assert sum(r["pulls"] for r in reps) == \
            sum(r["plane_sends"] for r in reps)
        assert all(r["leaked"] == 0 for r in reps)
        # no tile above the short limit was staged through the host
        assert all(r["rendezvous_host"] == 0 for r in reps)


def test_dposv_across_processes_host_staged():
    reps = _spawn(2, "dposv")
    _solve_check(reps, plane=False)
    assert all(r["host_staged_bytes"] > 0 for r in reps)


def test_dposv_across_processes_device_plane_loopback():
    """The device data plane on its loopback backend (a context on the
    CPU): every cross-rank tile above the short limit is pulled through
    the plane, ACKed, and no park is left behind (the short limit is cut
    below the 4 KB tiles so that every tile takes the plane)."""
    reps = _spawn(2, "dposv_plane", env_extra={
        "PARSEC_MCA_runtime_comm_short_limit": "1024"})
    _solve_check(reps, plane=True)


def test_rank_failure_detected_not_hung():
    """Rank 1 hard-exits mid-chain: rank 0's wait() raises a
    RankFailedError-caused RuntimeError well before its deadline
    instead of hanging in termination detection."""
    reps = _spawn(2, "fail", 8, env_extra={
        "PARSEC_MCA_comm_failure_strict": "1"}, expect_rcs=[0, 3])
    assert reps[0]["detected"] is True
    assert reps[0]["failed_rank"] == 1


@pytest.mark.gpu
def test_cuda_ipc_plane_between_two_processes():
    """Two rank processes on one card: rank 0 parks a tile (a view inside
    a larger allocation) on the CUDA-IPC plane, rank 1 pulls it device
    to device, the bits match, the ACK releases the park and none is
    left behind."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA IPC has no CPU mode")
    r0, r1 = _spawn(2, "ipc", on_card=True)
    assert r0["backend"] == "ipc"
    assert r1["same"] is True and r1["device"].startswith("cuda")
    assert r1["pulls"] == 1 and r1["bytes"] == 1024 * 1024 * 4
    assert r0["leaked"] == 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
