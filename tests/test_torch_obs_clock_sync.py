"""Clock-offset estimation: the NTP-style midpoint method
piggybacked on K_PING/K_PONG — wire round-trips of the extension,
near-zero estimates on a shared clock, the asymmetric-delay error
bound via the existing ft_inject delay directive, mixed-version peers
staying on plain pings, and the gauges.

The port's counterpart of the JAX package's ``tests/test_clock_sync.py``, run on
the port with ``device="cpu"``.
"""
import threading
import time

import pytest

from parsec_tpu_torch.comm import wire
from parsec_tpu_torch.utils.params import params


def _tcp_pair(flow=(True, True), inject=""):
    from contextlib import ExitStack

    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports

    eps = [("127.0.0.1", p) for p in free_ports(2)]
    engines = [None, None]
    with ExitStack() as st:
        if inject:
            st.enter_context(params.cmdline_override("ft_inject", inject))

        def boot(r):
            engines[r] = TCPCommEngine(r, eps, obs_flow=flow[r])
        ts = [threading.Thread(target=boot, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    return engines


def _wait_offsets(eng, peer, n_min=3, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with eng._stat_lock:
            n = eng._clock_n.get(peer, 0)
        if n >= n_min:
            return eng.clock_offset_us(peer)
        time.sleep(0.02)
    return eng.clock_offset_us(peer)


# ---------------------------------------------------------------------- #
# wire framing                                                           #
# ---------------------------------------------------------------------- #
def test_ping_extension_roundtrip_and_back_compat():
    plain = wire.pack_ping(3, 12345)
    assert len(plain) == 13           # <BIQ — the knob-unset frame
    assert wire.parse_ping(memoryview(plain)) == (3, 12345)
    assert wire.ping_clock(memoryview(plain)) is None

    ext = wire.pack_ping(3, 12345, clock_ns=0)
    assert len(ext) == 21             # + the trailing clock word
    # old parsers read the leading fields positionally and ignore the
    # trailing clock word — the mixed-version contract
    assert wire.parse_ping(memoryview(ext)) == (3, 12345)
    assert wire.ping_clock(memoryview(ext)) == 0

    pong = wire.pack_ping(3, 12345, pong=True, clock_ns=999)
    assert wire.ping_clock(memoryview(pong)) == 999
    assert memoryview(pong)[0] == wire.K_PONG


# ---------------------------------------------------------------------- #
# the estimator over real sockets                                        #
# ---------------------------------------------------------------------- #
def test_offsets_near_zero_on_shared_clock():
    """Both engines live in one process (one monotonic clock): the
    estimate must be bounded by the loopback round trip — a handful of
    ms even on a loaded CI host, nowhere near a real cross-host skew."""
    e0, e1 = _tcp_pair()
    try:
        off0 = _wait_offsets(e0, 1)
        off1 = _wait_offsets(e1, 0)
        assert off0 is not None and off1 is not None, \
            "clock sampler produced no estimate"
        assert abs(off0) < 10_000, off0
        assert abs(off1) < 10_000, off1
        # read once: the sampler refines the estimate between two reads
        offs = e0.clock_offsets_us()
        assert set(offs) == {1}, offs
        assert abs(offs[1]) < 10_000, offs
    finally:
        e0.fini()
        e1.fini()


def test_asymmetric_delay_bounds_estimate_error():
    """an injected asymmetric link delay (rank 0's
    outbound probes sleep ``d`` ms via the existing ft_inject delay
    directive with ``hb=1``) must bound the estimate error: the true
    offset is 0 (shared clock), the midpoint method's error is half
    the path asymmetry, so rank 0's estimate lands near +d/2 — within
    (0, d] — while rank 1's (symmetric legs) stays near zero."""
    d_ms = 40.0
    e0, e1 = _tcp_pair(inject=f"delay:rank=0:pct=100:ms={d_ms}:hb=1")
    try:
        off0 = _wait_offsets(e0, 1, timeout=20.0)
        off1 = _wait_offsets(e1, 0, timeout=20.0)
        assert off0 is not None and off1 is not None
        # the delayed request leg shows up as ~+d/2; bounded by d
        assert d_ms * 1e3 * 0.2 < off0 <= d_ms * 1e3, off0
        # the undelayed direction stays an order of magnitude tighter
        assert abs(off1) < d_ms * 1e3 * 0.25, off1
    finally:
        e0.fini()
        e1.fini()


def test_mixed_version_peer_never_gets_the_extension():
    """A peer whose HELLO lacks "tr" (knob unset there) receives plain
    13-byte pings only, so neither side ever estimates an offset —
    byte-identical wire toward old builds."""
    e0, e1 = _tcp_pair(flow=(True, False))
    try:
        # give the sampler time to (not) produce anything
        time.sleep(0.5)
        assert e0.clock_offset_us(1) is None
        assert e1.clock_offset_us(0) is None
        assert e0.clock_offsets_us() == {}
        # and the negotiation really declined (not just a silent race)
        p = e0._peer_to(1)
        deadline = time.time() + 5
        while time.time() < deadline and not p.hello_seen:
            time.sleep(0.01)
        assert p.hello_seen and not p.tr_ok
    finally:
        e0.fini()
        e1.fini()


def test_flow_knob_off_means_no_sampler_thread():
    e0, e1 = _tcp_pair(flow=(False, False))
    try:
        assert e0._clock_thread is None and e1._clock_thread is None
        assert e0.clock_offsets_us() == {}
    finally:
        e0.fini()
        e1.fini()


def test_detector_probes_feed_the_estimator():
    """ft_ping itself sends the extension toward tr-peers: detector
    probes contribute midpoint samples without the sampler thread."""
    e0, e1 = _tcp_pair()
    try:
        p = e0._peer_to(1)
        deadline = time.time() + 5
        while time.time() < deadline and not p.tr_ok:
            time.sleep(0.01)
        assert p.tr_ok
        assert e0.ft_ping(1, 7, time.monotonic_ns())
        off = _wait_offsets(e0, 1, n_min=1)
        assert off is not None
    finally:
        e0.fini()
        e1.fini()


# ---------------------------------------------------------------------- #
# gauges + metadata export                                               #
# ---------------------------------------------------------------------- #
def test_clock_offset_gauges_registered_under_the_knob():
    from parsec_tpu_torch.comm import LocalFabric
    from parsec_tpu_torch.obs import (CommObs, MetricsRegistry,
                                OBS_CLOCK_OFFSET_PREFIX)

    name = f"{OBS_CLOCK_OFFSET_PREFIX}::R1"
    with params.cmdline_override("obs_flow", "1"):
        fab = LocalFabric(2)
        eng = fab.engine(0)
        m = MetricsRegistry()
        CommObs(m).register_engine_gauges(eng)
    # in-process fabrics are same-clock: the gauge exists and reads 0
    assert m.read(name) == 0.0
    assert eng.clock_offset_us(1) == 0.0
    assert eng.clock_offsets_us() == {1: 0.0}
    # knob off: a big fleet's metrics sampling must not pay per-peer
    # polls for a disabled feature — the gauge is not registered
    fab2 = LocalFabric(2)
    m2 = MetricsRegistry()
    CommObs(m2).register_engine_gauges(fab2.engine(0))
    assert name not in m2.sde.snapshot()


def test_offsets_land_in_trace_metadata():
    import json as _json

    import parsec_tpu_torch
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine

    fab = LocalFabric(2)
    eng = RemoteDepEngine(fab.engine(0))
    ctx = parsec_tpu_torch.Context(device="cpu", nb_cores=1, comm=eng, profile=True)
    try:
        ctx.stamp_profile_meta()
        doc = ctx.profile.to_chrome_trace()
        assert doc["metadata"]["rank"] == 0
        assert "trace_t0_ns" in doc["metadata"]
        offs = _json.loads(doc["metadata"]["clock_offsets_us"])
        assert offs == {"1": 0.0}
    finally:
        ctx.fini()
