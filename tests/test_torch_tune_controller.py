"""The port's closed-loop self-tuning controller (``tune/``), against
tests/test_tune_controller.py's twelve tests and against the JAX
package's controller.

The decision matrix is driven with synthetic window digests: the
deterministic legs per family (escalation, budget cap, revert memory,
hysteresis, peers without the "tn" capability), the knob-unset
inertness contract, and the frame-capture identity of the knob-unset
wire over two TCP engines on localhost.  The parity tests feed the same
digest sequences, made from a numpy seed, through both packages'
``Controller`` over the same fake engine and device, and require the
same moves, reverts, annotations and knob values, window by window
(exact: the controller is integer and float bookkeeping with no
summation order to differ).
"""
import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.tune import (CODEC_COST, CODEC_LADDER, Controller,
                                   register_tune_gauges)
from parsec_tpu_torch.utils.params import params


# ---------------------------------------------------------------------- #
# synthetic actuation targets                                            #
# ---------------------------------------------------------------------- #
class FakeEngine:
    """The transport tuning seams the controller actuates against."""

    def __init__(self, tunable=True):
        self.tunable = tunable
        self.sent = []          # (peer, payload) from tune_send (rx dir)
        self.codecs = {}        # peer -> codec from set_quant_codec (tx)
        self.rx_counts = {}     # peer -> (raw, quant) for rx_quant_ratio

    def tune_to(self, peer):
        return self.tunable

    def tune_send(self, peer, payload):
        self.sent.append((peer, dict(payload)))
        return True

    def set_quant_codec(self, peer, codec):
        self.codecs[peer] = codec
        return True

    def active_quant_codec(self, peer):
        return self.codecs.get(peer)

    def rx_quant_ratio(self, peer):
        return self.rx_counts.get(peer, (0, 0))


class FakeDevice:
    """A device exposing the hill-climbed knobs and the stats the
    controller differences per window."""

    def __init__(self, batch_max=16):
        self.name = "fake0"
        self.batch_max = batch_max
        self.prefetch_depth = 4
        self.flush_segments = 4
        self.stats = {"batches": 0, "batched_tasks": 0,
                      "dispatch_ns": 0, "dispatch_tasks": 0,
                      "prefetch_issued": 0, "prefetch_hits": 0,
                      "segmented_flushes": 0}

    def window(self, batches=0, tasks=0, ns=0, n=0,
               pf_issued=0, pf_hits=0, flushes=0):
        """Advance the cumulative stats by one window's worth."""
        self.stats["batches"] += batches
        self.stats["batched_tasks"] += tasks
        self.stats["dispatch_ns"] += ns
        self.stats["dispatch_tasks"] += n
        self.stats["prefetch_issued"] += pf_issued
        self.stats["prefetch_hits"] += pf_hits
        self.stats["segmented_flushes"] += flushes


class FakeLive:
    """The subscriber seam's annotate target."""

    def __init__(self):
        self.annotations = []

    def annotate(self, name, args):
        self.annotations.append((name, dict(args)))


def make_ctl(eng=None, devices=(), budget=1e-1, hysteresis=2, cls=Controller,
             **kw):
    live = FakeLive()
    ctl = cls(0, live, engine=eng, devices=devices, residual_budget=budget,
              hysteresis=hysteresis, **kw)
    return ctl, live


def slow_bw_digest(win, peer=1, bw=1.0):
    return {"window": win, "links": {}, "bw": {peer: bw}, "fired": ()}


def hot_link_digest(win, src=1, z=9.0):
    return {"window": win,
            "links": {f"R{src}->R0": {"warm": True, "z": z}},
            "bw": {}, "fired": ()}


# ---------------------------------------------------------------------- #
# leg 1: a bandwidth-bound link escalates (both directions)              #
# ---------------------------------------------------------------------- #
def test_tx_bw_floor_escalates_one_rung_per_cooldown():
    eng = FakeEngine()
    ctl, live = make_ctl(eng, budget=1e-1, hysteresis=2)
    walls = []
    for w in range(12):
        ctl.on_window(slow_bw_digest(w))
        walls.append(eng.codecs.get(1))
    # two sustained-slow windows arm the move, then one rung per
    # cooldown period: qbf16 first, qint8 after, never in one jump
    assert walls[0] is None
    assert "qbf16" in walls
    assert eng.codecs[1] == "qint8"
    assert walls.index("qbf16") < walls.index("qint8")
    assert ctl.counts["codec_moves"] == 2
    assert ctl.counts["decisions"] == 2
    names = [n for n, _ in live.annotations]
    assert names.count("tune:codec") == 2
    dirs = {a["dir"] for n, a in live.annotations if n == "tune:codec"}
    assert dirs == {"tx"}


def test_rx_exposed_z_renegotiates_the_sender():
    eng = FakeEngine()
    ctl, live = make_ctl(eng, budget=1e-2, hysteresis=2)
    for w in range(4):
        ctl.on_window(hot_link_digest(w))
    # the rx direction actuates by ASKING the sender (K_TUNE payload),
    # never by touching this rank's own tx codec
    assert eng.sent and eng.sent[0][0] == 1
    assert eng.sent[0][1] == {"op": "codec", "codec": "qbf16"}
    assert eng.codecs == {}
    assert ctl.counts["codec_moves"] == 1


# ---------------------------------------------------------------------- #
# leg 2: the residual budget caps the ladder                             #
# ---------------------------------------------------------------------- #
def test_residual_budget_caps_the_ladder():
    # 1e-2 affords qbf16 (cost 1e-2) but not qint8 (cost 1e-1)
    eng = FakeEngine()
    ctl, _ = make_ctl(eng, budget=1e-2, hysteresis=1)
    assert ctl.max_rung == CODEC_LADDER.index("qbf16")
    assert CODEC_COST["qbf16"] == 1e-2
    for w in range(20):
        ctl.on_window(slow_bw_digest(w))
    assert eng.codecs[1] == "qbf16"        # stuck at the budget's rung
    assert ctl.counts["codec_moves"] == 1
    # zero budget affords nothing: the family is inert
    eng2 = FakeEngine()
    ctl2, live2 = make_ctl(eng2, budget=0.0, hysteresis=1)
    for w in range(10):
        ctl2.on_window(slow_bw_digest(w))
        ctl2.on_window(hot_link_digest(w))
    assert eng2.codecs == {} and eng2.sent == []
    assert ctl2.counts["codec_moves"] == 0
    assert live2.annotations == []


# ---------------------------------------------------------------------- #
# leg 3: a regressing device move is rolled back                         #
# ---------------------------------------------------------------------- #
def test_device_move_reverts_on_objective_regress():
    dev = FakeDevice(batch_max=16)
    ctl, live = make_ctl(devices=(dev,), hysteresis=2)
    # window 0 only establishes the stats baseline (deltas are zero);
    # then 2 windows of sparse occupancy (2 tasks/batch vs max 16) at
    # a healthy 10 us/task objective arm and commit the halving move
    for w in range(3):
        dev.window(batches=10, tasks=20, ns=200_000, n=20)
        ctl.on_window({"window": w, "links": {}, "bw": {}, "fired": ()})
    assert dev.batch_max == 8
    assert ctl.counts["device_moves"] == 1
    # the move is on probation: the objective EWMA now regresses far
    # past regress_pct, so the probation judgment restores the old value
    for w in range(3, 5):
        dev.window(batches=10, tasks=20, ns=2_000_000, n=20)
        ctl.on_window({"window": w, "links": {}, "bw": {}, "fired": ()})
    assert dev.batch_max == 16
    assert ctl.counts["reverts"] == 1
    names = [n for n, _ in live.annotations]
    assert names == ["tune:device", "tune:revert"]
    revert = live.annotations[1][1]
    assert revert["knob"] == "batch_max" and revert["to"] == 16


def test_device_move_sticks_when_objective_holds():
    dev = FakeDevice(batch_max=16)
    ctl, _ = make_ctl(devices=(dev,), hysteresis=2)
    for w in range(6):
        dev.window(batches=10, tasks=20, ns=200_000, n=20)
        ctl.on_window({"window": w, "links": {}, "bw": {}, "fired": ()})
    # steady objective: the halving survives probation and, after the
    # cooldown, the still-sparse signal earns the next halving
    assert dev.batch_max <= 8
    assert ctl.counts["reverts"] == 0


# ---------------------------------------------------------------------- #
# leg 4: hysteresis holds under an oscillating signal                    #
# ---------------------------------------------------------------------- #
def test_oscillating_signal_never_commits_a_move():
    eng = FakeEngine()
    dev = FakeDevice(batch_max=16)
    ctl, live = make_ctl(eng, devices=(dev,), hysteresis=2)
    for w in range(20):
        if w % 2 == 0:      # slow window ...
            ctl.on_window(slow_bw_digest(w))
            dev.window(batches=10, tasks=20, ns=200_000, n=20)
        else:               # ... then a healthy one: streaks never reach 2
            ctl.on_window({"window": w,
                           "links": {"R1->R0": {"warm": True, "z": 0.1}},
                           "bw": {1: 500.0}, "fired": ()})
            dev.window(batches=10, tasks=140, ns=200_000, n=140)
    assert eng.codecs == {} and eng.sent == []
    assert dev.batch_max == 16
    assert ctl.counts["decisions"] == 0
    assert live.annotations == []


# ---------------------------------------------------------------------- #
# leg 5: peers without the "tn" capability are never renegotiated       #
# ---------------------------------------------------------------------- #
def test_mixed_version_peer_never_renegotiated():
    eng = FakeEngine(tunable=False)      # peer without the "tn" HELLO cap
    ctl, live = make_ctl(eng, budget=1e-1, hysteresis=1)
    for w in range(10):
        ctl.on_window(slow_bw_digest(w))
        ctl.on_window(hot_link_digest(w))
    assert eng.sent == [] and eng.codecs == {}
    assert ctl.counts["codec_moves"] == 0
    assert live.annotations == []


# ---------------------------------------------------------------------- #
# leg 6: knob unset constructs nothing                                   #
# ---------------------------------------------------------------------- #
def test_tune_auto_unset_constructs_no_controller():
    ctx = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
    try:
        assert ctx.obs.tuner is None
        assert ctx.obs.live is None      # tune_auto is what implies it
    finally:
        ctx.fini()


def test_tune_auto_set_constructs_controller_and_gauges():
    with params.cmdline_override("tune_auto", "1"), \
            params.cmdline_override("tune_residual_budget", "1e-1"):
        ctx = parsec_tpu_torch.Context(nb_cores=1, device="cpu")
        try:
            tn = ctx.obs.tuner
            assert tn is not None
            assert tn.max_rung == CODEC_LADDER.index("qint8")
            # the device family acts on the context's device module
            assert ctx.device_by_type("cuda") in tn.devices
            snap = ctx.sde.snapshot()
            for g in ("PARSEC::TUNE::DECISIONS", "PARSEC::TUNE::REVERTS",
                      "PARSEC::TUNE::OBJECTIVE_US"):
                assert g in snap, f"{g} gauge not registered: missing"
            # the stage-compile family is carried but inert: this
            # package compiles no stages, so repeated self-straggler
            # windows exclude nothing
            assert tn.stage_classes_fn() == []
            for w in range(4 * tn.straggler_windows):
                tn.on_window({"window": w, "links": {}, "bw": {},
                              "fired": [{"kind": "straggler",
                                         "suspect": 0, "link": None}]})
            assert tn.counts["stagec_moves"] == 0 and tn._excluded == []
        finally:
            ctx.fini()


def test_wire_capture_tune_bit_identity():
    """The frame-level differential: toward a peer that never advertised
    "tn" (or "sv"), a tune_auto (or serve) sender's data frames are
    BIT-IDENTICAL to the knob-unset run, and the unset legs carry no
    tuning bytes at all; only the knob-set end's HELLO grows its
    advertisement."""
    from parsec_tpu_torch.comm import wire
    from test_torch_comm_wire import _capture_leg
    hello_a, a, got_a = _capture_leg()
    hello_b, b, _ = _capture_leg()
    hello_t, t, got_t = _capture_leg(tune_r0=True)
    hello_s, s, got_s = _capture_leg(serve_r0=True)
    assert a and a == b == t == s
    assert hello_a == hello_b
    assert not any(len(f) > 8 and f[8] == wire.K_TUNE for f in a + t)
    base = set(wire.parse_hello(memoryview(hello_a)[8:]))
    assert "tn" not in base and "sv" not in base
    assert set(wire.parse_hello(memoryview(hello_t)[8:])) == \
        base | {"tr", "lv", "tn"}
    assert set(wire.parse_hello(memoryview(hello_s)[8:])) == \
        base | {"tr", "lv", "sv"}
    assert all("_tr" not in m for m in got_a + got_t + got_s)


# ---------------------------------------------------------------------- #
# rx de-escalation: a codec that shows no win steps back down            #
# ---------------------------------------------------------------------- #
def test_rx_codec_without_win_steps_back_down():
    eng = FakeEngine()
    ctl, live = make_ctl(eng, budget=1e-2, hysteresis=1)
    ctl.on_window(hot_link_digest(0))
    assert eng.sent[-1][1]["codec"] == "qbf16"
    # the requested codec never moves a quantized byte: after
    # 2*hysteresis idle windows the controller walks it back
    for w in range(1, 6):
        ctl.on_window({"window": w, "links": {}, "bw": {}, "fired": ()})
    assert eng.sent[-1][1] == {"op": "codec", "codec": None}
    downs = [a for n, a in live.annotations
             if n == "tune:codec" and a["why"] == "no win"]
    assert downs and downs[-1]["codec"] == "lossless"


def test_rx_codec_with_real_win_is_kept():
    eng = FakeEngine()
    ctl, _ = make_ctl(eng, budget=1e-2, hysteresis=1)
    ctl.on_window(hot_link_digest(0))
    raw = quant = 0
    for w in range(1, 8):
        raw += 100_000
        quant += 25_000          # 4x compression: a clear win
        eng.rx_counts[1] = (raw, quant)
        ctl.on_window({"window": w, "links": {}, "bw": {}, "fired": ()})
    assert eng.sent[-1][1]["codec"] == "qbf16"   # never de-escalated
    assert len(eng.sent) == 1


# ---------------------------------------------------------------------- #
# the tuning seams of the TCP engine, both ends set                      #
# ---------------------------------------------------------------------- #
def test_tcp_k_tune_renegotiates_the_peers_codec():
    """Both ends with tune_auto: "tn" negotiates, a K_TUNE frame from
    rank 1 installs qbf16 as rank 0's send codec toward it (applied on
    rank 0's receiver thread), an unknown codec is refused, and the
    rx accounting starts at zero."""
    from test_torch_comm_wire import _engines_with, _peer_obj, _wait
    e0, e1 = _engines_with([dict(tune_auto=True), dict(tune_auto=True)])
    try:
        assert _wait(lambda: _peer_obj(e0, 1) is not None
                     and _peer_obj(e0, 1).hello_seen
                     and _peer_obj(e1, 0) is not None
                     and _peer_obj(e1, 0).hello_seen)
        assert e0.tune_to(1) and e1.tune_to(0)
        assert e1.rx_quant_ratio(0) == (0, 0)
        assert e0.active_quant_codec(1) is None
        assert e1.tune_send(0, {"op": "codec", "codec": "qbf16"})
        assert _wait(lambda: e0.active_quant_codec(1) == "qbf16")
        assert not e0.set_quant_codec(1, "no-such-codec")
        assert e0.set_quant_codec(1, None)
        assert e0.active_quant_codec(1) is None
    finally:
        e0.fini()
        e1.fini()


# ---------------------------------------------------------------------- #
# parity with the JAX package's controller                               #
# ---------------------------------------------------------------------- #
def _digests(seed, n):
    """A seeded mix of window digests and device-stat advances: slow and
    fast send bandwidth, hot and cool inbound links, sparse and
    saturated batches, prefetch misses, segmented flushes, rx quantized
    byte counts, and self-straggler firings."""
    rng = np.random.RandomState(seed)
    out = []
    raw = quant = 0
    for w in range(n):
        peer = int(rng.randint(1, 3))
        dg = {"window": w, "links": {}, "bw": {}, "fired": []}
        if rng.rand() < 0.6:
            dg["bw"][peer] = float(rng.choice([1.0, 5.0, 300.0]))
        if rng.rand() < 0.6:
            dg["links"][f"R{peer}->R0"] = {"warm": bool(rng.rand() < 0.8),
                                           "z": float(rng.choice(
                                               [0.5, 4.0, 9.0]))}
        if rng.rand() < 0.4:
            dg["fired"].append({"kind": "straggler", "suspect": 0,
                                "link": None})
        tasks = int(rng.choice([10, 20, 150]))
        dev = dict(batches=10, tasks=tasks,
                   ns=int(rng.choice([100_000, 200_000, 4_000_000])),
                   n=tasks, pf_issued=int(rng.choice([0, 10])),
                   pf_hits=int(rng.choice([0, 2, 10])),
                   flushes=int(rng.choice([0, 3])))
        if rng.rand() < 0.5:
            raw += 100_000
            quant += int(rng.choice([25_000, 99_000]))
        out.append((dg, dev, {1: (raw, quant), 2: (raw // 2, quant // 2)}))
    return out


def _drive(cls, seed, hysteresis, budget):
    """One controller of ``cls`` over the seeded sequence; its trace of
    annotations, counts, engine actions and device knobs per window."""
    eng, dev = FakeEngine(), FakeDevice(batch_max=16)
    ctl, live = make_ctl(eng, devices=(dev,), budget=budget,
                         hysteresis=hysteresis, cls=cls,
                         overlap_fn=lambda: 0.25,
                         stage_classes_fn=lambda: ["GEMM", "TRSM"])
    trace = []
    for dg, step, rx in _digests(seed, 60):
        dev.window(**step)
        eng.rx_counts = dict(rx)
        ctl.on_window(dg)
        trace.append((dict(ctl.counts), ctl.objective_us(),
                      list(eng.sent), dict(eng.codecs),
                      (dev.batch_max, dev.prefetch_depth,
                       dev.flush_segments),
                      [ctl.codec_index(p) for p in (1, 2)]))
    return trace, live.annotations, list(ctl._excluded)


@pytest.mark.parametrize("seed,hysteresis,budget", [
    (0, 1, 1e-1), (1, 2, 1e-1), (2, 2, 1e-2), (3, 3, 0.0)])
def test_controller_moves_match_jax_package(seed, hysteresis, budget):
    """The same digests through both packages' controllers: every move,
    revert, annotation, objective and knob value agrees, window by
    window (the stage-compile family included, with a class list both
    are given; its exclusion knob is restored after each run)."""
    from parsec_tpu.tune import Controller as JaxController
    from parsec_tpu.utils.params import params as jax_params
    with params.cmdline_override("stage_compile_exclude", ""):
        got = _drive(Controller, seed, hysteresis, budget)
        port_excl = params.get("stage_compile_exclude")
    with jax_params.cmdline_override("stage_compile_exclude", ""):
        ref = _drive(JaxController, seed, hysteresis, budget)
        jax_excl = jax_params.get("stage_compile_exclude")
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2] and port_excl == jax_excl
    assert got[1], "the sequence moved nothing: it tests nothing"


def test_register_tune_gauges_match_jax_package():
    """Both packages register the same PARSEC::TUNE::* names, and the
    per-peer ACTIVE_CODEC gauge of a peer that appears later."""
    from parsec_tpu.profiling.sde import SDERegistry as JaxSDE
    from parsec_tpu.tune import Controller as JaxController
    from parsec_tpu.tune import register_tune_gauges as jax_register
    from parsec_tpu_torch.profiling.sde import SDERegistry
    names = []
    for cls, reg, sde in ((Controller, register_tune_gauges, SDERegistry()),
                          (JaxController, jax_register, JaxSDE())):
        eng = FakeEngine()
        ctl, _ = make_ctl(eng, hysteresis=1, cls=cls)
        reg(sde, ctl)
        ctl.on_window(slow_bw_digest(0, peer=3))
        snap = sde.snapshot()
        names.append(sorted(snap))
        assert snap["PARSEC::TUNE::ACTIVE_CODEC::R3"] == \
            CODEC_LADDER.index("qbf16")
    assert names[0] == names[1]
