"""The distributed wave across rank processes: the TCP comm engine between
processes, the payload hop over host bytes or the device plane (the
socket loopback on the CPU), and the multi-process collective lane over
``torch.distributed`` (gloo).

The test spawns this file once per rank (``python
test_torch_wave_dist_procs.py <mode>``) with the launcher contract in the
environment — ``PARSEC_MCA_comm_transport=tcp``, ``comm_endpoints``,
``comm_rank``, ``device_cuda_platform=cpu``, and for the lane
``dist_coordinator``, ``dist_num_processes`` and ``dist_process_id`` —
so ``parsec_tpu_torch.init()`` wires the TCP engine and joins the gloo
process group itself.  Every rank process has its own deadline.  Each
run's factor must equal the one-rank wave's bit for bit.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EADDRINUSE_RC = 75      # a rank could not bind its endpoint: retry
N, NB = 256, 64
DEADLINE = 150          # seconds a rank process may take


def _matrix():
    from parsec_tpu_torch.ops import make_spd
    return make_spd(N, dtype=np.float64)


# ---------------------------------------------------------------------- #
# the rank driver (runs in the spawned processes)                        #
# ---------------------------------------------------------------------- #
def _rank_main(mode: str) -> int:
    sys.path.insert(0, ROOT)
    import errno
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.wave import WaveError
    try:
        ctx = ptt.init(nb_cores=1)
    except OSError as exc:
        if exc.errno == errno.EADDRINUSE:
            return EADDRINUSE_RC
        raise
    except RuntimeError as exc:   # the gloo store's port was taken
        if "address already in use" in str(exc).lower():
            return EADDRINUSE_RC
        raise
    rank, nb_ranks = ctx.rank, ctx.nb_ranks
    out = {"rank": rank}
    try:
        P = 2 if nb_ranks == 2 else nb_ranks
        coll = TwoDimBlockCyclic(N, N, NB, NB, dtype=np.float64, P=P,
                                 Q=nb_ranks // P, nodes=nb_ranks, rank=rank)
        coll.name = "descA"
        M = _matrix()
        for (i, j) in coll.local_tiles():
            np.copyto(coll.tile(i, j),
                      M[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB])
        tp = ptt.ops.dpotrf_taskpool(coll, rank=rank, nb_ranks=nb_ranks)
        try:
            w = ptt.ptg.wave(tp, comm=ctx.comm)
        except WaveError as exc:
            out["wave_error"] = str(exc)
        else:
            w.run(device="cpu")
            plane = ctx.comm.ce.device_plane
            out.update(stats={k: v for k, v in w.stats.items()
                              if isinstance(v, (int, float, str, bool,
                                                type(None)))},
                       plane=None if plane is None else plane.backend_name,
                       leaked=0 if plane is None else plane.leaked_parks,
                       tiles={f"{i},{j}": np.asarray(coll.tile(i, j)).tolist()
                              for (i, j) in coll.local_tiles() if i >= j})
    finally:
        ctx.fini()
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------- #
# the tests                                                              #
# ---------------------------------------------------------------------- #
def _spawn(nb_ranks, env_extra=None, per_rank=None, gloo=False):
    """Run the rank processes; each is killed past DEADLINE.  Ports are
    probed free and bound later, so a collision (a rank exiting with
    EADDRINUSE_RC; its peers would wait on it) kills the set and reruns
    it on fresh ports.  Each rank's output goes to a file, so waiting on
    one rank never blocks another on a full pipe."""
    from parsec_tpu_torch.comm import free_ports
    for _attempt in range(4):
        ports = free_ports(nb_ranks + 1)
        procs, files = [], []
        for r in range(nb_ranks):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("PARSEC_MCA_")}
            env.update({
                "PARSEC_MCA_comm_transport": "tcp",
                "PARSEC_MCA_comm_endpoints": ",".join(
                    f"127.0.0.1:{p}" for p in ports[:nb_ranks]),
                "PARSEC_MCA_comm_rank": str(r),
                "PARSEC_MCA_device_cuda_platform": "cpu",
                "CUDA_VISIBLE_DEVICES": ""})
            if gloo:
                # the TCP store on a port of its own, apart from the
                # comm engine's listeners
                env.update({
                    "PARSEC_MCA_dist_coordinator":
                        f"127.0.0.1:{ports[nb_ranks]}",
                    "PARSEC_MCA_dist_num_processes": str(nb_ranks),
                    "PARSEC_MCA_dist_process_id": str(r)})
            env.update(env_extra or {})
            env.update((per_rank or {}).get(r, {}))
            out, err = tempfile.TemporaryFile("w+"), \
                tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "rank"],
                cwd=ROOT, env=env, stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + DEADLINE
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() == EADDRINUSE_RC for p in procs):
                    break
                if time.monotonic() > deadline:
                    pytest.fail(f"a rank passed its {DEADLINE} s deadline")
                time.sleep(0.05)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        outs = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            outs.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
        if any(rc == EADDRINUSE_RC for rc, _o, _e in outs):
            continue
        for rc, out, err in outs:
            assert rc == 0, (rc, out[-2000:], err[-4000:])
        return [json.loads(o.strip().splitlines()[-1])
                for _rc, o, _e in outs]
    pytest.fail("endpoints kept colliding with other processes")


def _one_rank_factor():
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.wave import WaveRunner
    from parsec_tpu_torch.ops import dpotrf_taskpool
    A = TwoDimBlockCyclic(N, N, NB, NB, dtype=np.float64).from_numpy(
        _matrix())
    WaveRunner(dpotrf_taskpool(A)).run(device="cpu")
    return np.tril(A.to_numpy())


def _assembled(reps):
    L = np.zeros((N, N))
    for r in reps:
        for key, t in r["tiles"].items():
            i, j = map(int, key.split(","))
            L[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB] = np.asarray(t)
    return L


@pytest.mark.parametrize("plane", ["off", "auto"])
def test_dist_wave_across_two_processes(plane):
    """Two rank processes over TCP: host bytes (wave_dist_plane=off) or
    the device plane _auto_device_plane attaches (the socket loopback
    here, CUDA IPC on the card); the factor is the one-rank wave's."""
    reps = _spawn(2, {"PARSEC_MCA_wave_dist_plane": plane})
    assert np.array_equal(_assembled(reps), _one_rank_factor())
    for r in reps:
        st = r["stats"]
        assert st["collective_lane"] is None
        assert st["tiles_sent"] > 0 and st["mesh_local_sends"] == 0
        if plane == "off":
            assert r["plane"] is None and st["plane_sends"] == 0
            assert st["host_sends"] == st["messages_sent"]
        else:
            assert r["plane"] == "loopback" and st["device_plane"]
            assert st["plane_sends"] > 0 and st["host_sends"] == 0
            assert r["leaked"] == 0


def test_dist_wave_multiproc_lane_over_gloo():
    """Four rank processes in one gloo process group: under the default
    wave_dist_collective=auto the multi-process lane engages (each
    broadcast group one all_reduce, non-members joining with zeros), the
    lane-schedule digests agree, no tile rides the plane while the lane
    has groups, and the factor is the one-rank wave's bit for bit."""
    reps = _spawn(4, gloo=True)
    assert np.array_equal(_assembled(reps), _one_rank_factor())
    for r in reps:
        st = r["stats"]
        assert st["collective_lane"] == "multiproc"
        assert st["collective_calls"] + st["collective_joins"] > 0
        assert st["plane_sends"] == 0 and not st["device_plane"]
    assert sum(r["stats"]["collective_tiles"] for r in reps) > 0


def test_dist_wave_lane_params_diverging_fail_fast():
    """A process whose lane params differ from its peers' fails at runner
    setup with the digest mismatch, instead of hanging in a half-joined
    all_reduce."""
    reps = _spawn(2, gloo=True,
                  per_rank={1: {"PARSEC_MCA_wave_reduce_dtype": "bf16"}})
    assert all("diverge" in r.get("wave_error", "") for r in reps), reps


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))
