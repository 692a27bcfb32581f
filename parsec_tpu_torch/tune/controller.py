"""The self-tuning controller: health-window digests in, knob moves out.

One :class:`Controller` per context (constructed by ``ContextObs`` when
``tune_auto`` is set), subscribed to :meth:`LiveHealth.tick`'s window
digest.  All decision logic runs on the monitor thread — one digest at
a time, no internal locking needed; the counters the gauges poll are
plain ints (atomic reads under the GIL).

Decision families
-----------------
codec   The wire-codec ladder ``(None, qbf16, qint8)`` with declared
        relative-residual costs ``(0, 1e-2, 1e-1)``; the budget param
        caps how high the ladder may go.  Two directions per peer:
        *rx* (this rank's inbound link looks bandwidth-bound — window
        exposed-wait z above threshold — so ask the SENDER to quantize
        via a K_TUNE frame) and *tx* (this rank's own send-bandwidth
        EWMA toward the peer collapsed below the floor, so quantize
        locally).  De-escalation: a requested codec that moves no
        quantized bytes for ``2*hysteresis`` windows, or compresses
        worse than ``no_win_ratio``, shows no win and steps back down.
        Mixed-version peers (no "tn" HELLO capability) are never
        renegotiated.
device  Hill-climb on ``batch_max`` / ``prefetch_depth`` /
        ``flush_segments`` from per-window deltas of the device stats
        (``CudaDevice.stats``; a ``CudaMeshDevice`` reads the same
        knobs at each dispatch).  One move per device at a time; a
        move's effect is judged after ``hysteresis`` windows against
        the us/task dispatch-objective EWMA and ROLLED BACK if the
        objective regressed by more than ``regress_pct`` — the revert
        memory that keeps a bad step from sticking.  On a CUDA device
        ``dispatch_ns`` is the host's enqueue time (launches are
        asynchronous), so the objective judges host dispatch, not
        device time.
stagec  A rank whose exec-busy keeps collapsing while compiled stages
        are live (the self-straggler detector firing
        ``straggler_windows`` windows in a row) gets the dominant
        compiled class appended to ``stage_compile_exclude``, so the
        next taskpool over the same spec replans without it.  The
        class list comes from the context's live stage compilers
        (``tp._stagec``, stagec/runtime.py); a context running no
        compiled stage names no class, and the family stays inert.

Every committed move bumps ``PARSEC::TUNE::DECISIONS`` and emits one
``tune:<family>`` instant annotation on the health stream; every
rollback bumps ``PARSEC::TUNE::REVERTS`` and emits ``tune:revert``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.spans import (TUNE_ACTIVE_CODEC_PREFIX, TUNE_DECISIONS,
                         TUNE_OBJECTIVE_US, TUNE_REVERTS)

#: The codec ladder, lossless first; index == the ACTIVE_CODEC gauge
#: value and the rung the escalation logic climbs one step at a time.
CODEC_LADDER: Tuple[Optional[str], ...] = (None, "qbf16", "qint8")

#: Declared relative-residual cost of each rung (what one hop through
#: the codec may spend of ``tune_residual_budget``): bf16 keeps 8
#: mantissa bits (~1e-2 relative), int8 blockwise ~1e-1.  A rung is
#: reachable only while its cost fits the budget.
CODEC_COST: Dict[Optional[str], float] = {None: 0.0,
                                          "qbf16": 1e-2,
                                          "qint8": 1e-1}

# device knob bounds the hill-climber may not leave
_BATCH_MAX_CAP = 1024
_PREFETCH_CAP = 16
_FLUSH_SEG_CAP = 16
_EXCLUDE_CAP = 4       # never exclude more classes than this


def _ladder_index(codec: Optional[str]) -> int:
    try:
        return CODEC_LADDER.index(codec)
    except ValueError:   # unknown codec string from a newer peer
        return 0


class Controller:
    """Closed-loop tuner over one rank's live-health window digests."""

    def __init__(self, rank: int, live: Any, *,
                 engine: Any = None,
                 devices: Tuple[Any, ...] = (),
                 residual_budget: float = 1e-2,
                 hysteresis: int = 2,
                 z_thresh: float = 3.0,
                 bw_floor_mbps: float = 32.0,
                 no_win_ratio: float = 0.95,
                 occupancy_hi: float = 0.85,
                 occupancy_lo: float = 0.3,
                 prefetch_lo: float = 0.5,
                 overlap_lo: float = 0.5,
                 regress_pct: float = 0.05,
                 straggler_windows: int = 3,
                 overlap_fn: Optional[Callable[[], float]] = None,
                 stage_classes_fn: Optional[Callable[[], List[str]]] = None,
                 ) -> None:
        self.rank = int(rank)
        self.live = live
        # the transport is optional (in-process fabrics have no wire
        # codecs) and must expose the tuning seams to participate
        self.engine = engine if engine is not None and \
            hasattr(engine, "tune_send") else None
        self.devices = list(devices)
        self.hysteresis = max(1, int(hysteresis))
        self.z_thresh = float(z_thresh)
        self.bw_floor_mbps = float(bw_floor_mbps)
        self.no_win_ratio = float(no_win_ratio)
        self.occupancy_hi = float(occupancy_hi)
        self.occupancy_lo = float(occupancy_lo)
        self.prefetch_lo = float(prefetch_lo)
        self.overlap_lo = float(overlap_lo)
        self.regress_pct = float(regress_pct)
        self.straggler_windows = max(1, int(straggler_windows))
        self.overlap_fn = overlap_fn
        self.stage_classes_fn = stage_classes_fn
        # the highest ladder rung the residual budget admits
        budget = max(0.0, float(residual_budget))
        self.max_rung = max(i for i, c in enumerate(CODEC_LADDER)
                            if CODEC_COST[c] <= budget)
        self.counts = {"decisions": 0, "reverts": 0,
                       "codec_moves": 0, "device_moves": 0,
                       "stagec_moves": 0}
        self._peers: Dict[int, Dict[str, Any]] = {}
        self._devs: Dict[int, Dict[str, Any]] = {}
        self._objective: Optional[float] = None   # us/task EWMA
        self._strag_streak = 0
        self._excluded: List[str] = []
        self._sde: Any = None
        self._gauged_peers: set = set()

    # ------------------------------------------------------------------ #
    # plumbing                                                           #
    # ------------------------------------------------------------------ #
    def objective_us(self) -> float:
        return round(self._objective, 1) if self._objective is not None \
            else 0.0

    def codec_index(self, peer: int) -> int:
        """The ACTIVE_CODEC gauge: the ladder rung of the codec this
        rank actually applies on its send side toward ``peer``."""
        eng = self.engine
        if eng is None:
            return 0
        return _ladder_index(eng.active_quant_codec(peer))

    def _annotate(self, name: str, args: Dict[str, Any]) -> None:
        try:
            self.live.annotate(name, args)
        except Exception:   # noqa: BLE001 - telemetry must not raise
            pass

    def _ensure_codec_gauge(self, peer: int) -> None:
        sde = self._sde
        if sde is None or peer in self._gauged_peers:
            return
        self._gauged_peers.add(peer)
        sde.register_poll(f"{TUNE_ACTIVE_CODEC_PREFIX}::R{peer}",
                          lambda p=peer: self.codec_index(p))

    def _peer_state(self, peer: int) -> Dict[str, Any]:
        st = self._peers.get(peer)
        if st is None:
            st = {"rx_rung": 0, "rx_up": 0, "rx_idle": 0,
                  "tx_rung": 0, "tx_up": 0, "tx_idle": 0,
                  "cool": 0, "last_rx": (0, 0)}
            self._peers[peer] = st
            self._ensure_codec_gauge(peer)
        return st

    # ------------------------------------------------------------------ #
    # the window tick                                                    #
    # ------------------------------------------------------------------ #
    def on_window(self, dg: Dict[str, Any]) -> None:
        """One health window folded: run every decision family.  Called
        on the monitor thread (LiveHealth subscriber seam); exceptions
        are swallowed by the caller, but decision logic is defensive
        anyway — a sick family must not starve the others."""
        try:
            self._codec_step(dg)
        except Exception:   # noqa: BLE001
            pass
        try:
            self._device_step(dg)
        except Exception:   # noqa: BLE001
            pass
        try:
            self._stagec_step(dg)
        except Exception:   # noqa: BLE001
            pass

    # ------------------------------------------------------------------ #
    # family 1: the wire-codec ladder                                    #
    # ------------------------------------------------------------------ #
    def _codec_step(self, dg: Dict[str, Any]) -> None:
        eng = self.engine
        if eng is None or self.max_rung == 0:
            return
        win = int(dg.get("window", 0))
        # rx direction: inbound links R<src>->R<me> whose window
        # exposed-wait z crossed the straggler threshold are
        # bandwidth-bound — ask the sender to climb one rung
        for link, info in (dg.get("links") or {}).items():
            try:
                src = int(link.split("->")[0][1:])
            except (ValueError, IndexError):
                continue
            if src == self.rank:
                continue
            st = self._peer_state(src)
            hot = bool(info.get("warm")) and \
                float(info.get("z", 0.0)) > self.z_thresh
            st["rx_up"] = st["rx_up"] + 1 if hot else 0
            if (st["cool"] == 0 and st["rx_up"] >= self.hysteresis
                    and st["rx_rung"] < self.max_rung
                    and eng.tune_to(src)):
                self._move_rx(eng, src, st, st["rx_rung"] + 1, win,
                              why=f"exposed z={info.get('z')}")
        # tx direction: this rank's own send-bandwidth EWMA toward a
        # peer collapsed below the floor — quantize locally
        for peer, bw in (dg.get("bw") or {}).items():
            peer = int(peer)
            if peer == self.rank or bw is None:
                continue
            st = self._peer_state(peer)
            slow = 0.0 < float(bw) < self.bw_floor_mbps
            st["tx_up"] = st["tx_up"] + 1 if slow else 0
            if (st["cool"] == 0 and st["tx_up"] >= self.hysteresis
                    and st["tx_rung"] < self.max_rung
                    and eng.tune_to(peer)):
                new = st["tx_rung"] + 1
                if eng.set_quant_codec(peer, CODEC_LADDER[new]):
                    st["tx_rung"] = new
                    st["tx_up"] = 0
                    st["cool"] = self.hysteresis
                    self.counts["decisions"] += 1
                    self.counts["codec_moves"] += 1
                    self._annotate("tune:codec", {
                        "dir": "tx", "peer": peer, "window": win,
                        "codec": CODEC_LADDER[new] or "lossless",
                        "why": f"send bw {float(bw):.1f}MB/s < "
                               f"{self.bw_floor_mbps:.0f}"})
        # de-escalation: a requested rx codec that lands no quantized
        # bytes (or compresses worse than no_win_ratio) shows no win
        for peer, st in self._peers.items():
            if st["cool"] > 0:
                st["cool"] -= 1
            if st["rx_rung"] <= 0:
                continue
            pre, post = eng.rx_quant_ratio(peer)
            d_pre = pre - st["last_rx"][0]
            d_post = post - st["last_rx"][1]
            st["last_rx"] = (pre, post)
            no_win = d_pre == 0 or \
                (d_pre > 0 and d_post / d_pre > self.no_win_ratio)
            st["rx_idle"] = st["rx_idle"] + 1 if no_win else 0
            if (st["rx_idle"] >= 2 * self.hysteresis
                    and eng.tune_to(peer)):
                self._move_rx(eng, peer, st, st["rx_rung"] - 1,
                              int(dg.get("window", 0)), why="no win")

    def _move_rx(self, eng: Any, peer: int, st: Dict[str, Any],
                 rung: int, win: int, why: str) -> None:
        codec = CODEC_LADDER[rung]
        if not eng.tune_send(peer, {"op": "codec", "codec": codec}):
            return
        st["rx_rung"] = rung
        st["rx_up"] = 0
        st["rx_idle"] = 0
        st["cool"] = self.hysteresis
        self.counts["decisions"] += 1
        self.counts["codec_moves"] += 1
        self._annotate("tune:codec", {
            "dir": "rx", "peer": peer, "window": win,
            "codec": codec or "lossless", "why": why})

    # ------------------------------------------------------------------ #
    # family 2: device pipeline-shape hill-climb                         #
    # ------------------------------------------------------------------ #
    def _device_step(self, dg: Dict[str, Any]) -> None:
        win = int(dg.get("window", 0))
        tot_ns = tot_tasks = 0
        for i, dev in enumerate(self.devices):
            stats = getattr(dev, "stats", None)
            if not isinstance(stats, dict) or "dispatch_ns" not in stats:
                continue
            st = self._devs.setdefault(i, {
                "cool": 0, "pend": None, "streak": {},
                "last": dict(stats)})
            last = st["last"]
            d = {k: stats.get(k, 0) - last.get(k, 0) for k in
                 ("batches", "batched_tasks", "dispatch_ns",
                  "dispatch_tasks", "prefetch_issued", "prefetch_hits",
                  "segmented_flushes")}
            st["last"] = dict(stats)
            tot_ns += d["dispatch_ns"]
            tot_tasks += d["dispatch_tasks"]
            self._climb(dev, i, st, d, win)
        if tot_tasks > 0:
            sample = (tot_ns / 1e3) / tot_tasks
            self._objective = sample if self._objective is None \
                else 0.5 * self._objective + 0.5 * sample

    def _climb(self, dev: Any, idx: int, st: Dict[str, Any],
               d: Dict[str, int], win: int) -> None:
        name = getattr(dev, "name", None) or f"dev{idx}"
        pend = st["pend"]
        if pend is not None:
            # a move is on probation: judge it after hysteresis windows
            # against the objective EWMA it was taken at
            pend["age"] += 1
            if pend["age"] < self.hysteresis:
                return
            obj = self._objective
            base = pend["baseline"]
            if (obj is not None and base is not None
                    and obj > base * (1.0 + self.regress_pct)):
                setattr(dev, pend["knob"], pend["old"])
                self.counts["reverts"] += 1
                self._annotate("tune:revert", {
                    "dev": name, "knob": pend["knob"], "window": win,
                    "to": pend["old"],
                    "why": f"objective {obj:.1f}us/task > "
                           f"{base:.1f} +{self.regress_pct:.0%}"})
                st["cool"] = self.hysteresis
            st["pend"] = None
            return
        if st["cool"] > 0:
            st["cool"] -= 1
            return
        move = self._propose(dev, d)
        if move is None:
            st["streak"] = {}
            return
        knob, new, why = move
        # hysteresis = the SAME move re-proposed this many times: a
        # contradictory proposal on the same knob (halve one window,
        # double the next) restarts that knob's count, while a window
        # won by a DIFFERENT knob leaves it intact — priority
        # interleaving is not oscillation (a clean window still clears
        # everything above)
        key = (knob, new)
        streak = {k: v for k, v in st["streak"].items()
                  if k == key or k[0] != knob}
        streak[key] = streak.get(key, 0) + 1
        st["streak"] = streak
        if streak[key] < self.hysteresis:
            return
        old = getattr(dev, knob)
        setattr(dev, knob, new)
        st["pend"] = {"knob": knob, "old": old, "age": 0,
                      "baseline": self._objective}
        st["streak"] = {}
        self.counts["decisions"] += 1
        self.counts["device_moves"] += 1
        self._annotate("tune:device", {
            "dev": name, "knob": knob, "window": win,
            "from": old, "to": new, "why": why})

    def _propose(self, dev: Any,
                 d: Dict[str, int]) -> Optional[Tuple[str, int, str]]:
        """The single highest-priority knob move this window's stats
        deltas support, or None when the shape looks right."""
        bmax = int(getattr(dev, "batch_max", 1))
        if d["batches"] > 0 and bmax > 0:
            occ = d["batched_tasks"] / d["batches"]
            if occ >= self.occupancy_hi * bmax and bmax < _BATCH_MAX_CAP:
                return ("batch_max", min(_BATCH_MAX_CAP, bmax * 2),
                        f"occupancy {occ:.1f}/{bmax} saturated")
            if bmax > 1 and occ <= self.occupancy_lo * bmax:
                return ("batch_max", max(1, bmax // 2),
                        f"occupancy {occ:.1f}/{bmax} sparse")
        if d["prefetch_issued"] > 0:
            hit = d["prefetch_hits"] / d["prefetch_issued"]
            depth = int(getattr(dev, "prefetch_depth", 0))
            if hit < self.prefetch_lo and depth < _PREFETCH_CAP:
                return ("prefetch_depth", depth + 1,
                        f"prefetch hit-rate {hit:.2f}")
        if d["segmented_flushes"] > 0 and self.overlap_fn is not None:
            try:
                ov = float(self.overlap_fn())
            except Exception:   # noqa: BLE001
                ov = 1.0
            segs = int(getattr(dev, "flush_segments", 1))
            if ov < self.overlap_lo and segs < _FLUSH_SEG_CAP:
                return ("flush_segments", segs + 1,
                        f"overlap fraction {ov:.2f}")
        return None

    # ------------------------------------------------------------------ #
    # family 3: stage-compile exclusion                                  #
    # ------------------------------------------------------------------ #
    def _stagec_step(self, dg: Dict[str, Any]) -> None:
        if self.stage_classes_fn is None or \
                len(self._excluded) >= _EXCLUDE_CAP:
            return
        fired = any(f.get("kind") == "straggler"
                    and f.get("suspect") == self.rank
                    and f.get("link") is None
                    for f in (dg.get("fired") or ()))
        self._strag_streak = self._strag_streak + 1 if fired else 0
        if self._strag_streak < self.straggler_windows:
            return
        self._strag_streak = 0
        try:
            classes = list(self.stage_classes_fn() or ())
        except Exception:   # noqa: BLE001
            return
        from ..utils.params import params
        cur = str(params.get_or("stage_compile_exclude", "string", "")
                  or "")
        have = {c.strip() for c in cur.split(",") if c.strip()}
        victim = next((c for c in classes
                       if c and c not in have), None)
        if victim is None:
            return
        params.set_cmdline("stage_compile_exclude",
                           f"{cur},{victim}" if cur else victim)
        self._excluded.append(victim)
        self.counts["decisions"] += 1
        self.counts["stagec_moves"] += 1
        self._annotate("tune:stagec", {
            "exclude": victim, "window": int(dg.get("window", 0)),
            "why": f"self-straggler x{self.straggler_windows} with "
                   f"compiled stages live"})


def register_tune_gauges(sde: Any, ctl: Controller) -> None:
    """Register the PARSEC::TUNE::* poll gauges for one controller
    (per-peer ACTIVE_CODEC gauges self-register as peers appear)."""
    ctl._sde = sde
    sde.register_poll(TUNE_DECISIONS, lambda: ctl.counts["decisions"])
    sde.register_poll(TUNE_REVERTS, lambda: ctl.counts["reverts"])
    sde.register_poll(TUNE_OBJECTIVE_US, ctl.objective_us)
    for peer in list(ctl._peers):
        ctl._ensure_codec_gauge(peer)
