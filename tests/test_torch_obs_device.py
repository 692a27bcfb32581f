"""The device module's telemetry (obs ``DeviceObs`` on ``devices/cuda.py``).

With telemetry on, every dispatch of the device module becomes a
``dev:busy`` interval and every host copy a ``dev:xfer_in`` /
``dev:xfer_out`` span; ``obs.analyze`` reports the device-busy time and
``rank_wall_split`` splits a rank's wall into its parts.  On host
tensors (``device="cpu"``, what these tests run) the intervals are the
host's; on the card they come from timed CUDA events on the module's
stream (the ``gpu`` tests).  Telemetry never changes a result.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import parsec_tpu_torch
from parsec_tpu_torch import obs
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.obs.critpath import load_trace_intervals
from parsec_tpu_torch.ops import dpotrf, make_spd
from parsec_tpu_torch.utils.params import params


@contextlib.contextmanager
def _knobs(**over):
    with contextlib.ExitStack() as st:
        for k, v in over.items():
            st.enter_context(params.cmdline_override(k, str(v)))
        yield


def _factor(device, telemetry, n=256, nb=64, **knobs):
    """dpotrf of one seeded matrix; returns (L, the device module's
    stats, its sink or None, the trace document or None, wall ns)."""
    import time
    if telemetry:
        knobs["metrics"] = "1"
    with _knobs(**knobs):
        ctx = parsec_tpu_torch.init(nb_cores=2, device=device,
                                    profile=telemetry)
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb).from_numpy(make_spd(n))
            dev = ctx.device_by_type("cuda")
            t0 = time.monotonic_ns()
            dpotrf(ctx, A)
            if dev.is_cuda:
                torch.cuda.synchronize()
            t1 = time.monotonic_ns()
            sink = dev._obs
            L = A.to_numpy()
            if sink is not None:
                sink.flush()   # the pulls of to_numpy
            doc = None
            if telemetry:
                ctx.stamp_profile_meta()
                doc = ctx.profile.to_chrome_trace()
            return L, dict(dev.stats), sink, doc, (t0, t1)
        finally:
            ctx.fini()


def _spans(doc, name):
    """(start, end, args) of ``doc``'s spans called ``name``, on the
    host monotonic clock in ns, sorted."""
    t0 = doc["metadata"]["trace_t0_ns"]
    return sorted((t0 + iv.begin * 1e3, t0 + iv.end * 1e3, iv.args)
                  for iv in load_trace_intervals(doc) if iv.name == name)


def _check_intervals(doc, stats, wall, slack_ns=0):
    """``slack_ns``: the anchor's uncertainty when event instants are
    placed on the host clock (half the anchor's synchronize)."""
    busy = _spans(doc, "dev:busy")
    assert len(busy) == stats["batches"] + (stats["dispatch_tasks"]
                                            - stats["batched_tasks"])
    assert sum(a["tasks"] for *_, a in busy) == stats["tasks"]
    for (a0, a1, _a), (b0, _b1, _b) in zip(busy, busy[1:]):
        assert a0 <= a1 <= b0, "dispatch intervals overlap on one stream"
    assert 0 < sum(t1 - t0 for t0, t1, _ in busy) <= wall[1] - wall[0]
    assert all(wall[0] - slack_ns <= t0 and t1 <= wall[1] + slack_ns
               for t0, t1, _ in busy)
    ins = _spans(doc, "dev:xfer_in")
    assert ins and all(a["bytes"] > 0 for *_, a in ins)


def test_dispatch_intervals_disjoint_and_result_unchanged():
    L0, st0, sink0, doc0, _ = _factor("cpu", telemetry=False)
    assert sink0 is None and doc0 is None
    L1, st1, sink1, doc1, wall = _factor("cpu", telemetry=True)
    np.testing.assert_array_equal(L0, L1)
    assert st0["tasks"] == st1["tasks"] and st0["batches"] == st1["batches"]
    _check_intervals(doc1, st1, wall)


def test_trace_spans_report_and_wall_split():
    _L, st, sink, doc, wall = _factor("cpu", telemetry=True)
    summary = obs.validate_chrome_trace(doc)
    assert summary["spans"] > 0
    busy = _spans(doc, "dev:busy")
    rep = obs.analyze([doc])
    dev = rep["device"][0]
    assert dev["dispatches"] == len(busy) > 0
    assert dev["busy_us"] == pytest.approx(
        sum(t1 - t0 for t0, t1, _ in busy) / 1e3, rel=1e-6)
    assert "device busy per rank" in obs.format_report(rep)
    t0_ns = doc["metadata"]["trace_t0_ns"]
    w0, w1 = (wall[0] - t0_ns) / 1e3, (wall[1] - t0_ns) / 1e3
    split = obs.rank_wall_split(load_trace_intervals(doc), 0, w0, w1)
    assert split["wall_us"] == pytest.approx(w1 - w0)
    assert split["device_compute_us"] == pytest.approx(
        dev["busy_us"], rel=1e-6)
    for part in ("device_compute", "h2d", "d2h", "host_wait_for_copy",
                 "comm_send", "comm_deliver", "rest"):
        assert 0 <= split[f"{part}_us"] <= split["wall_us"] + 1e-6, part
    assert split["h2d_us"] > 0


def test_wall_split_on_synthetic_spans():
    """Each part is the union of its spans clipped to the wall; the rest
    is the wall no listed span covers; exposed wait is per link."""
    from parsec_tpu_torch.obs.critpath import Interval
    ivs = [Interval(0, 1, "dev:busy", 10, 40, {}),
           Interval(0, 1, "dev:busy", 30, 60, {}),      # overlaps: union
           Interval(0, 2, "dev:xfer_in", 0, 12, {}),    # clipped at 5
           Interval(0, 2, "dev:xfer_out", 90, 120, {}),  # clipped at 100
           Interval(0, 3, "comm:send", 70, 75, {"src": 0, "dst": 1}),
           Interval(0, 3, "comm:deliver:activate", 76, 80,
                    {"src": 1, "dst": 0}),
           Interval(0, 4, "exec:GEMM", 77, 78, {}),
           # two concurrent GETs on one link: their union counts once
           Interval(0, 3, "comm:get", 82, 88, {"src": 1}),
           Interval(0, 3, "comm:get", 84, 89, {"src": 1}),
           Interval(1, 1, "dev:busy", 0, 100, {})]       # another rank
    s = obs.rank_wall_split(ivs, 0, 5, 100)
    assert s["wall_us"] == 95
    assert s["device_compute_us"] == 50
    assert s["h2d_us"] == 7 and s["d2h_us"] == 10
    assert s["comm_send_us"] == 5 and s["comm_deliver_us"] == 4
    assert s["exposed_wait_us"] == {"R0->R1": 5.0, "R1->R0": 10.0}
    assert obs.per_link_exposed_wait(ivs)[0]["R1->R0"] == 14.0   # a sum
    # covered: [5, 60] (busy and the H2D overlap), [70, 75], [76, 80],
    # [82, 89] (the GETs' exposed wait), [90, 100]
    assert s["rest_us"] == 95 - (55 + 5 + 4 + 7 + 10)


def test_cpu_device_records_every_copy_direction():
    """Eviction write-back and pull_to_host record D2H; stage-in and
    prestage record H2D (host spans on host tensors)."""
    with _knobs(metrics="1"):
        ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu", profile=True)
        try:
            dev = ctx.device_by_type("cuda")
            from parsec_tpu_torch.data.data import data_new_with_payload
            d = data_new_with_payload(np.ones((8, 8), np.float32),
                                      device_id=0, key=0)
            assert dev.prestage_data(d)
            copy = d.get_copy(dev.device_index)
            copy.payload = copy.payload * 2
            copy.version += 1
            dev.pull_to_host(d)
            dev._obs.flush()
            doc = ctx.profile.to_chrome_trace()
            got = [(e["name"], e["args"]["bytes"])
                   for e in doc["traceEvents"]
                   if e["name"].startswith("dev:xfer")]
            assert got == [("dev:xfer_in", 256), ("dev:xfer_out", 256)]
            hist = ctx.metrics.histogram(obs.COMM_XFER_SECONDS)
            assert hist.snapshot()["count"] == 2
        finally:
            ctx.fini()


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the intervals come from timed "
                    "CUDA events")


@pytest.mark.gpu
def test_event_intervals_on_the_card(cuda_card, monkeypatch):
    """On cuda:0: the busy intervals come from timed events, are
    disjoint and inside the wall; no timed event without telemetry; the
    GEMM kernel's launches and the factor are the same either way (per
    task dispatch, so the launches do not hang on the host's timing:
    one a GEMM or SYRK task)."""
    from parsec_tpu_torch.ops import kernels
    timed = []
    real = torch.cuda.Event

    def event(*a, **kw):
        if kw.get("enable_timing"):
            timed.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(torch.cuda, "Event", event)
    nt = 8
    n0 = kernels.matmul_launches
    L0, st0, sink0, _doc, _w = _factor(None, telemetry=False, n=2048,
                                       nb=256, device_batch_max=1)
    launches0 = kernels.matmul_launches - n0
    assert sink0 is None and not timed
    n1 = kernels.matmul_launches
    L1, st1, sink1, doc, wall = _factor(None, telemetry=True, n=2048,
                                        nb=256, device_batch_max=1)
    assert kernels.matmul_launches - n1 == launches0 == \
        nt * (nt - 1) * (nt - 2) // 6 + nt * (nt - 1) // 2
    assert timed and sink1 is not None
    np.testing.assert_array_equal(L0, L1)
    _check_intervals(doc, st1, wall, slack_ns=200_000)
    # a D2H copy is timed from its start event: its span ends at the
    # host's return and starts at or after the host's ask
    assert _spans(doc, "dev:xfer_out")
    assert obs.analyze([doc])["device"][0]["busy_us"] > 0
