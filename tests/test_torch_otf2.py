"""The port's OTF2 export and live counter aggregation
(parsec_tpu_torch/profiling/{otf2,aggregator}.py).  Mirrors the JAX
package's ``tests/test_otf2_aggregator.py`` (its tools' CLI tests
excepted), holds the OTF2 archive byte for byte against the JAX
writer's for the same events, and checks that the two obs-backed
endpoints refuse (obs is not carried yet)."""
import json
import os
import socket
import time

import numpy as np
import pytest

import parsec_tpu_torch as ptt
from parsec_tpu_torch import dtd
from parsec_tpu_torch.dsl.dtd import INOUT, VALUE, unpack_args
from parsec_tpu_torch.profiling.aggregator import (AggregatorServer,
                                                   SDEPusher,
                                                   fleet_to_prometheus)
from parsec_tpu_torch.profiling.otf2 import (_have_real_otf2, read_otf2,
                                             write_otf2)
from parsec_tpu_torch.profiling.sde import SDERegistry
from parsec_tpu_torch.profiling.trace import Profile
from parsec_tpu_torch.utils.params import params

fallback_only = pytest.mark.skipif(
    _have_real_otf2(), reason="real otf2 bindings write genuine archives")


def _sample_profile(profile_cls=Profile, rank=3):
    prof = profile_cls(rank=rank, info={"app": "unit"})
    prof._t0 = 0
    st = prof.stream(0, "worker-0")
    st.events = [(10, "B", "exec:gemm", None), (40, "E", "exec:gemm", None),
                 (45, "C", "PARSEC::TASKS_RETIRED", 1.0),
                 (50, "i", "mark", None),
                 (52, "X", "dev:potrf", {"dur_ns": 30})]
    st2 = prof.stream(1, "comm")
    st2.events = [(12, "B", "am:activate", None),
                  (20, "E", "am:activate", None)]
    return prof


def _archive_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@fallback_only
def test_otf2_roundtrip(tmp_path):
    prof = _sample_profile()
    prof._streams[0].events = prof._streams[0].events[:4]
    anchor = write_otf2(prof, str(tmp_path / "arch"))
    assert os.path.exists(anchor)
    back = read_otf2(anchor)
    assert back.rank == prof.rank
    assert back.info["app"] == "unit"
    assert sorted(back._streams) == [0, 1]
    for tid in (0, 1):
        orig = [(ts, ph, key) for ts, ph, key, _ in
                prof._streams[tid].events]
        got = [(ts, ph, key) for ts, ph, key, _ in
               back._streams[tid].events]
        assert got == orig
    cv = [e for e in back._streams[0].events if e[1] == "C"]
    assert cv and cv[0][3] == 1.0


@fallback_only
def test_otf2_preserves_noncontiguous_stream_ids(tmp_path):
    prof = Profile(rank=0)
    prof._t0 = 0
    prof.stream(0, "worker").events = [(5, "B", "x", None),
                                       (9, "E", "x", None)]
    prof.stream(100, "comm").events = [(7, "i", "mark", None)]
    back = read_otf2(write_otf2(prof, str(tmp_path / "arch")))
    assert sorted(back._streams) == [0, 100]
    assert back._streams[100].name == "comm"


@fallback_only
def test_otf2_archive_structure(tmp_path):
    anchor = write_otf2(_sample_profile(), str(tmp_path / "arch"))
    root = os.path.dirname(anchor)
    assert os.path.basename(anchor) == "anchor.otf2"
    for f in ("global.def", "0.evt", "1.evt"):
        assert os.path.exists(os.path.join(root, "traces", f))


@fallback_only
def test_otf2_rejects_garbage(tmp_path):
    p = tmp_path / "arch"
    os.makedirs(p)
    (p / "anchor.otf2").write_bytes(b"not an anchor at all")
    with pytest.raises(ValueError):
        read_otf2(str(p))


@fallback_only
def test_otf2_bytes_equal_to_jax_writer(tmp_path):
    """The same events give the same archive, file for file and byte for
    byte, from either package's writer (X spans expanded alike)."""
    from parsec_tpu.profiling.otf2 import write_otf2 as jax_write_otf2
    from parsec_tpu.profiling.trace import Profile as JaxProfile
    write_otf2(_sample_profile(), str(tmp_path / "torch"))
    jax_write_otf2(_sample_profile(JaxProfile), str(tmp_path / "jax"))
    ours = _archive_bytes(str(tmp_path / "torch"))
    theirs = _archive_bytes(str(tmp_path / "jax"))
    assert sorted(ours) == sorted(theirs) == \
        ["anchor.otf2", "traces/0.evt", "traces/1.evt", "traces/global.def"]
    assert ours == theirs


@fallback_only
def test_otf2_of_a_real_run_equals_jax_writer(tmp_path):
    """A profiled DTD run of the port, written by both writers."""
    from parsec_tpu.profiling.otf2 import write_otf2 as jax_write_otf2
    ctx = ptt.Context(nb_cores=1, device="cpu", profile=True)
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        tile = tp.tile_of_array(np.zeros((4, 4), np.float32))

        def bump(es, task):
            x, a = unpack_args(task)
            x += a

        for _ in range(3):
            tp.insert_task(bump, (tile, INOUT), (1.0, VALUE))
        tp.data_flush_all()
        tp.wait()
    finally:
        ctx.fini()
    prof = ctx.profile
    assert sum(len(st.events) for st in prof._streams.values()) > 0
    write_otf2(prof, str(tmp_path / "torch"))
    jax_write_otf2(prof, str(tmp_path / "jax"))
    assert _archive_bytes(str(tmp_path / "torch")) == \
        _archive_bytes(str(tmp_path / "jax"))
    back = read_otf2(str(tmp_path / "torch"))
    assert sorted(back._streams) == sorted(prof._streams)


# --------------------------------------------------------------------- #
# live aggregation                                                      #
# --------------------------------------------------------------------- #
def _wait_pushes(srv, n):
    deadline = time.time() + 5
    while srv.nb_pushes < n and time.time() < deadline:
        time.sleep(0.01)


def test_aggregator_push_and_fleet():
    srv = AggregatorServer().start()
    try:
        for rank in (0, 1, 2):
            sde = SDERegistry()
            sde.inc("PARSEC::TASKS_RETIRED", 10 * (rank + 1))
            assert SDEPusher(sde, srv.address, rank=rank,
                             interval=60).push_once()
        _wait_pushes(srv, 3)
        agg = srv.fleet()["counters"]["PARSEC::TASKS_RETIRED"]
        assert agg["fleet"]["nb_ranks"] == 3
        assert agg["fleet"]["sum_of_last"] == 10 + 20 + 30
        assert agg["ranks"]["2"]["last"] == 30
    finally:
        srv.stop()


def test_aggregator_query_over_tcp():
    srv = AggregatorServer().start()
    try:
        sde = SDERegistry()
        sde.inc("X", 7)
        SDEPusher(sde, srv.address, rank=0, interval=60).push_once()
        _wait_pushes(srv, 1)
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            s.sendall(b"QUERY\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        fleet = json.loads(buf.decode())
        assert fleet["counters"]["X"]["fleet"]["sum_of_last"] == 7
    finally:
        srv.stop()


def test_pusher_survives_dead_server():
    sde = SDERegistry()
    sde.inc("X", 1)
    p = SDEPusher(sde, "127.0.0.1:1", rank=0, interval=60)  # refused
    assert p.push_once() is False


def test_fleet_minmax_span_all_samples():
    srv = AggregatorServer().start()
    try:
        sde = SDERegistry()
        p = SDEPusher(sde, srv.address, rank=0, interval=60)
        sde.inc("X", 100)
        assert p.push_once()
        sde.inc("X", -95)
        assert p.push_once()
        _wait_pushes(srv, 2)
        agg = srv.fleet()["counters"]["X"]["fleet"]
        assert agg["max"] == 100 and agg["min"] == 5
        assert agg["sum_of_last"] == 5
    finally:
        srv.stop()


def test_aggregator_ignores_nonobject_json():
    srv = AggregatorServer().start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            s.sendall(b"5\n[]\n")
            s.sendall(json.dumps({"rank": 0, "counters": {"X": 1}}).encode()
                      + b"\n")
            _wait_pushes(srv, 1)
        assert srv.fleet()["counters"]["X"]["fleet"]["sum_of_last"] == 1
    finally:
        srv.stop()


def test_obs_backed_endpoints_refuse():
    """/metrics and /health are backed by obs/ now: the functions answer
    (a strict-parser-clean exposition, a fleet health document), and the
    HTTP server answers 200 on every endpoint, none of them 501."""
    from parsec_tpu_torch.obs import parse_exposition
    srv = AggregatorServer().start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            s.sendall(json.dumps({"rank": 0, "counters": {"X": 1},
                                  "health": {"rank": 0,
                                             "status": 0}}).encode()
                      + b"\n")
            _wait_pushes(srv, 1)
        samples = parse_exposition(fleet_to_prometheus(srv.fleet()))
        assert samples[("x", (("rank", "0"),))] == 1.0, samples
        assert srv.health_fleet()["nb_ranks"] == 1
        for path in ("/metrics", "/health", "/timeline"):
            with socket.create_connection((srv.host, srv.port),
                                          timeout=5) as s:
                s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
                buf = b""
                while True:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            assert buf.split(b"\r\n")[0].split()[1] == b"200", (path, buf)
    finally:
        srv.stop()


def test_bad_push_address_does_not_kill_context():
    params.set_cmdline("sde_push", "myhost")  # missing :port
    try:
        ctx = ptt.Context(nb_cores=1, device="cpu")
        assert ctx._sde_pusher is None
        ctx.fini()
    finally:
        params.reset()


def test_context_sde_push_param():
    """--mca sde_push wires a pusher into the context; real task
    counters arrive at the server, including the final at-fini push."""
    srv = AggregatorServer().start()
    try:
        params.set_cmdline("sde_push", srv.address)
        params.set_cmdline("sde_push_interval_ms", "50")
        ctx = ptt.Context(nb_cores=2, device="cpu")
        try:
            tp = dtd.taskpool_new()
            ctx.add_taskpool(tp)
            tile = tp.tile_of_array(np.zeros((4, 4), np.float32))

            def bump(es, task):
                x, a = unpack_args(task)
                x += a

            for _ in range(5):
                tp.insert_task(bump, (tile, INOUT), (1.0, VALUE))
            tp.data_flush_all()
            tp.wait()
        finally:
            ctx.fini()
        retired = None
        deadline = time.time() + 5
        while retired is None and time.time() < deadline:
            retired = srv.fleet()["counters"].get("PARSEC::TASKS_RETIRED")
            if retired is None:
                time.sleep(0.01)
        assert retired is not None
        assert retired["fleet"]["sum_of_last"] >= 5
    finally:
        params.reset()
        srv.stop()
