"""MetricsRegistry + Prometheus exposition: histograms, the strict
line-format parser, mempool accounting gauges, the aggregator's
/metrics HTTP endpoint, and the context-level metrics switch.

The port's counterpart of the JAX package's ``tests/test_obs_metrics.py``, run on
the port with ``device="cpu"``.
"""
import math
import socket

import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.obs import (MetricsRegistry, parse_exposition, render,
                            sanitize_name)
from parsec_tpu_torch.obs.prometheus import fleet_to_prometheus


def test_histogram_buckets_and_mean():
    m = MetricsRegistry()
    h = m.histogram("PARSEC::TEST::LAT", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.05, 0.5):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(0.5555)
    # cumulative: <=1ms: 1, <=10ms: 2, <=100ms: 3, +Inf: 4
    assert [c for _le, c in snap["buckets"]] == [1, 2, 3, 4]
    assert math.isinf(snap["buckets"][-1][0])
    assert h.mean() == pytest.approx(0.5555 / 4)


def test_sanitize_name():
    assert sanitize_name("PARSEC::COMM::BYTES_SENT") == "parsec_comm_bytes_sent"
    assert sanitize_name("PARSEC::DEVICE::cpu:0::MEM_USED") == \
        "parsec_device_cpu_0_mem_used"
    assert sanitize_name("9bad") == "m_9bad"


def test_render_parses_and_roundtrips_values():
    m = MetricsRegistry()
    m.inc("PARSEC::COMM::BYTES_SENT", 4096)
    m.gauge("PARSEC::SCHEDULER::PENDING_TASKS", lambda: 3)
    m.histogram("PARSEC::TASK::EXEC_SECONDS",
                buckets=(0.01, 1.0)).observe(0.5)
    text = render(m, labels={"rank": "2"})
    samples = parse_exposition(text)  # the line-format check
    lbl = (("rank", "2"),)
    assert samples[("parsec_comm_bytes_sent", lbl)] == 4096
    assert samples[("parsec_scheduler_pending_tasks", lbl)] == 3
    assert samples[("parsec_task_exec_seconds_count", lbl)] == 1
    assert samples[("parsec_task_exec_seconds_sum", lbl)] == 0.5
    assert samples[("parsec_task_exec_seconds_bucket",
                    (("le", "+Inf"), ("rank", "2")))] == 1
    assert samples[("parsec_task_exec_seconds_bucket",
                    (("le", "0.01"), ("rank", "2")))] == 0
    # counter vs gauge typing comes from the SDE owned/poll split
    assert "# TYPE parsec_comm_bytes_sent counter" in text
    assert "# TYPE parsec_scheduler_pending_tasks gauge" in text


def test_render_cross_kind_collision_single_type():
    """A name owned as a counter in one registry and polled as a gauge
    in another must expose exactly once (duplicate # TYPE lines make
    Prometheus reject the whole scrape)."""
    from parsec_tpu_torch.profiling.sde import SDERegistry
    m = MetricsRegistry()
    m.inc("PARSEC::X", 7)
    extra = SDERegistry()
    extra.register_poll("PARSEC::X", lambda: 99)
    text = render(m, extra_sde=extra)
    assert text.count("# TYPE parsec_x ") == 1
    assert parse_exposition(text)[("parsec_x", ())] == 7  # counter wins


@pytest.mark.parametrize("bad", [
    "no_value_here",
    "1leading_digit 5",
    'metric{unterminated="x} 1',
    "# BOGUS comment kind",
    "name{a=1} 2",           # unquoted label value
])
def test_parse_exposition_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_exposition(bad + "\n")


def test_mempool_named_gauges_and_highwater():
    from parsec_tpu_torch.core.mempool import Mempool
    from parsec_tpu_torch.profiling.sde import sde
    pool = Mempool(lambda: np.empty((4,), np.float32), name="test_scratch")
    try:
        a = pool.allocate()
        b = pool.allocate()
        assert pool.nb_allocs == 2 and pool.nb_hits == 0
        assert pool.outstanding_hwm == 2
        pool.free(a)
        assert pool.nb_outstanding == 1
        c = pool.allocate()   # freelist hit
        assert pool.nb_hits == 1
        assert sde.read("PARSEC::MEMPOOL::TEST_SCRATCH::ALLOCS") == 3
        assert sde.read("PARSEC::MEMPOOL::TEST_SCRATCH::OUTSTANDING_HWM") == 2
        assert sde.read("PARSEC::MEMPOOL::TEST_SCRATCH::OUTSTANDING") == 2
        pool.free(b)
        pool.free(c)
        assert sde.read("PARSEC::MEMPOOL::TEST_SCRATCH::OUTSTANDING") == 0
        # only two elements were ever constructed (c reused a's slot)
        assert sde.read("PARSEC::MEMPOOL::TEST_SCRATCH::CACHED") == 2
        assert sde.read("PARSEC::MEMPOOL::TEST_SCRATCH::CONSTRUCTED") == 2
        # the gauges hold only WEAK refs to the pool (a strong ref would
        # pin every cached buffer for the process lifetime)
        import weakref
        wr = weakref.ref(pool)
        del a, b, c
    finally:
        pool.unregister_gauges()
    assert "PARSEC::MEMPOOL::TEST_SCRATCH::ALLOCS" not in sde.names()
    del pool
    import gc
    gc.collect()
    assert wr() is None, "SDE gauges kept the pool alive"


def test_mempool_gauges_visible_in_context_exposition():
    """Named-pool gauges live on the process-global registry but must
    surface through the per-context exposition (guide §9.1 table)."""
    from parsec_tpu_torch.core.mempool import Mempool
    pool = Mempool(lambda: np.empty((4,), np.float32), name="ctx_vis")
    try:
        pool.free(pool.allocate())
        ctx = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
        try:
            text = ctx.obs.render_prometheus(labels={"rank": "0"})
        finally:
            ctx.fini()
        samples = parse_exposition(text)
        assert samples[("parsec_mempool_ctx_vis_allocs",
                        (("rank", "0"),))] == 1
    finally:
        pool.unregister_gauges()


def test_aggregator_http_metrics_endpoint():
    from parsec_tpu_torch.profiling.aggregator import AggregatorServer
    srv = AggregatorServer("127.0.0.1", 0).start()
    try:
        srv._ingest({"rank": 0, "ts": 1.0,
                     "counters": {"PARSEC::TASKS_RETIRED": 11}})
        srv._ingest({"rank": 1, "ts": 1.0,
                     "counters": {"PARSEC::TASKS_RETIRED": 31}})
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            s.sendall(b"GET /metrics HTTP/1.0\r\nHost: x\r\n\r\n")
            buf = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        head, _, body = buf.partition(b"\r\n\r\n")
        assert b"200 OK" in head
        samples = parse_exposition(body.decode())
        assert samples[("parsec_tasks_retired", (("rank", "0"),))] == 11
        assert samples[("parsec_tasks_retired", (("rank", "1"),))] == 31
        # the same body parses as what fleet_to_prometheus renders
        assert body.decode() == fleet_to_prometheus(srv.fleet())
    finally:
        srv.stop()


def test_context_metrics_param_without_profile():
    """metrics=1 alone (no trace capture) feeds the task-latency
    histogram and renders parseable exposition; the PINS sites go quiet
    again after fini."""
    from parsec_tpu_torch.profiling.pins import pins_is_active
    parsec_tpu_torch.params.set_cmdline("metrics", "1")
    try:
        ctx = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
    finally:
        parsec_tpu_torch.params.unset_cmdline("metrics")
    try:
        assert ctx.obs.enabled and ctx.profile is None
        tp = parsec_tpu_torch.dtd.taskpool_new()
        ctx.add_taskpool(tp)
        for _ in range(4):
            tp.insert_task(lambda es, task: None)
        tp.wait()
        hist = ctx.metrics.histogram("PARSEC::TASK::EXEC_SECONDS")
        assert hist.count >= 4
        parse_exposition(ctx.obs.render_prometheus(labels={"rank": "0"}))
    finally:
        ctx.fini()
    assert not pins_is_active()


def test_context_disabled_fast_path():
    """Without profile/metrics the engine gets NO span sink (the
    one-attribute fast path) while pull gauges still answer."""
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    fabric = LocalFabric(1)
    eng = RemoteDepEngine(fabric.engine(0))
    ctx = parsec_tpu_torch.Context(nb_cores=1, comm=eng, device="cpu")
    try:
        assert not ctx.obs.enabled
        assert eng.ce._obs is None
        assert all(dev._obs is None for dev in ctx.devices)
        assert ctx.sde.read("PARSEC::COMM::PENDING_MESSAGES") == 0
        assert "PARSEC::COMM::ACTIVATES_SENT" in ctx.sde.snapshot()
        assert any(n.startswith("PARSEC::DEVICE::") for n in ctx.sde.names())
    finally:
        ctx.fini()


def test_device_pipeline_gauges_in_exposition():
    """The batched-dispatch pipeline gauges (guide §9.1: batch
    occupancy, prefetch hit rate, dispatch us/task) must surface in the
    Prometheus exposition after a dpotrf run, with live values."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
    from parsec_tpu_torch.utils.params import params

    with params.cmdline_override("device_tpu_max", "1"):
        ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=2)
        try:
            M = make_spd(192)
            A = TwoDimBlockCyclic(192, 192, 32, 32,
                                  dtype=np.float32).from_numpy(M)
            ctx.add_taskpool(dpotrf_taskpool(A))
            ctx.wait()
            text = ctx.obs.render_prometheus(labels={"rank": "0"})
        finally:
            ctx.fini()
    samples = parse_exposition(text)
    rows = {n for (n, _l) in samples}
    for want in ("batch_occupancy", "prefetch_hit_rate", "dispatch_us"):
        assert any(n.startswith("parsec_device_") and n.endswith(want)
                   for n in rows), (want, sorted(rows))
    occ = [v for (n, _l), v in samples.items()
           if n.startswith("parsec_device_") and n.endswith("batch_occupancy")]
    assert max(occ) >= 2.0, f"dpotrf run never batched: occupancy={occ}"
    disp = [v for (n, _l), v in samples.items()
            if n.startswith("parsec_device_") and n.endswith("dispatch_us")]
    assert max(disp) > 0.0


def test_overlap_gauges_in_exposition():
    """the live OVERLAP_FRACTION / EXPOSED_COMM_US
    gauges and the prefetch/segment counters must surface in the
    Prometheus exposition during a dpotrf run — the overlap pipeline's
    health is measurable while it runs, not only in the offline
    critpath report."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
    from parsec_tpu_torch.utils.params import params

    with params.cmdline_override("metrics", "1"), \
         params.cmdline_override("device_tpu_max", "1"), \
         params.cmdline_override("device_flush_segments", "4"):
        fab = LocalFabric(1)
        eng = RemoteDepEngine(fab.engine(0))
        ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=2, comm=eng)
        try:
            M = make_spd(256)
            A = TwoDimBlockCyclic(256, 256, 32, 32,
                                  dtype=np.float32).from_numpy(M)
            ctx.add_taskpool(dpotrf_taskpool(A))
            ctx.wait()
            text = ctx.obs.render_prometheus(labels={"rank": "0"})
        finally:
            ctx.fini()
    samples = parse_exposition(text)

    def val(name):
        got = [v for (n, _l), v in samples.items() if n == name]
        assert got, (name, sorted(n for (n, _l) in samples))
        return got[0]

    frac = val("parsec_obs_overlap_fraction")
    assert 0.0 <= frac <= 1.0
    assert val("parsec_obs_exposed_comm_us") >= 0.0
    # the segment counters prove the pipelined flush path really ran
    segd = [v for (n, _l), v in samples.items()
            if n.startswith("parsec_device_")
            and n.endswith("segmented_flushes")]
    segs = [v for (n, _l), v in samples.items()
            if n.startswith("parsec_device_")
            and n.endswith("flush_segments")]
    assert segd and max(segd) > 0.0, "dpotrf run never segmented a flush"
    assert segs and max(segs) >= 2 * max(segd)
    # prefetched-GET outcomes are distinct gauges (a single-rank run
    # never prefetches — the live >0 case rides test_overlap_pipeline)
    for suffix in ("gets", "hits", "misses", "cancels"):
        assert val(f"parsec_comm_prefetch_{suffix}") == 0.0


def test_flow_and_clock_gauges_in_exposition():
    """the FLOW_SENT/FLOW_RECV counters and the
    per-peer CLOCK_OFFSET_US gauges surface in the Prometheus
    exposition during a flow-traced 2-rank run."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
    from parsec_tpu_torch.utils.params import params
    

def spmd(nb_ranks, fn, timeout=120, fabric=None):
    from parsec_tpu_torch.utils.spmd import spmd_threads
    return spmd_threads(nb_ranks, fn, timeout=timeout, fabric=fabric)

    n, nb, ranks = 128, 32, 2
    M = make_spd(n, dtype=np.float32)
    with params.cmdline_override("metrics", "1"), \
            params.cmdline_override("obs_flow", "1"), \
            params.cmdline_override("comm_mesh_local", "0"):
        def rank_fn(r, fab):
            eng = RemoteDepEngine(fab.engine(r))
            ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng)
            try:
                coll = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32,
                                         P=ranks, Q=1, nodes=ranks,
                                         rank=r)
                coll.name = "descA"
                coll.from_numpy(M.copy())
                ctx.add_taskpool(dpotrf_taskpool(coll, rank=r,
                                                 nb_ranks=ranks))
                ctx.wait()
                return ctx.obs.render_prometheus(
                    labels={"rank": str(r)})
            finally:
                ctx.fini()
        texts, _fab = spmd(ranks, rank_fn)
    total_sent = total_recv = 0.0
    for r, text in enumerate(texts):
        samples = parse_exposition(text)

        def val(name, samples=samples):
            got = [v for (n_, _l), v in samples.items() if n_ == name]
            assert got, name
            return got[0]

        total_sent += val("parsec_obs_flow_sent")
        total_recv += val("parsec_obs_flow_recv")
        # the per-peer clock gauge exists (same-clock fabric: 0.0)
        assert val(f"parsec_obs_clock_offset_us_r{1 - r}") == 0.0
    assert total_sent > 0, "flow tracing never stamped a message"
    assert total_sent == total_recv, (total_sent, total_recv)
