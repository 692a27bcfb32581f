"""Comm-engine telemetry: byte counters balancing across ranks, matched
get/put spans, pending-message gauges (span tracing
and SDE counters in the comm layer; ref: the T3 premise that
compute/collective overlap must be *measured* before it can be
optimized, arXiv:2401.16677).

The port's counterpart of the JAX package's ``tests/test_obs_comm.py``, run on
the port with ``device="cpu"``.
"""
import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
from parsec_tpu_torch.dsl import ptg
from parsec_tpu_torch.obs import (COMM_ACTIVE_TRANSFERS, COMM_BYTES_RECEIVED,
                            COMM_BYTES_SENT, COMM_MSGS_RECEIVED,
                            COMM_MSGS_SENT, COMM_PENDING_MESSAGES, CommObs,
                            MetricsRegistry)
from parsec_tpu_torch.profiling.trace import Profile



def spmd(nb_ranks, fn, timeout=120, fabric=None):
    from parsec_tpu_torch.utils.spmd import spmd_threads
    return spmd_threads(nb_ranks, fn, timeout=timeout, fabric=fabric)


def _span_counts(profile, name):
    """(#complete spans, #with a valid begin+end) for one span name.
    Comm spans are complete ("X") events: ts is the begin, ts+dur the
    end — equal counts mean every transfer produced a matched pair."""
    doc = profile.to_chrome_trace()
    spans = [e for e in doc["traceEvents"]
             if e.get("name") == name and e.get("ph") == "X"]
    matched = sum(1 for e in spans
                  if isinstance(e.get("ts"), (int, float))
                  and isinstance(e.get("dur"), (int, float))
                  and e["dur"] >= 0)
    return len(spans), matched


def _instrumented_pair():
    fabric = LocalFabric(2)
    engines, metrics, profiles = [], [], []
    for r in range(2):
        eng = fabric.engine(r)
        m = MetricsRegistry()
        p = Profile(rank=r)
        obs = CommObs(m, profile=p)
        obs.register_engine_gauges(eng)
        eng._obs = obs
        engines.append(eng)
        metrics.append(m)
        profiles.append(p)
    return engines, metrics, profiles


def test_get_put_spans_and_byte_balance():
    """Every one-sided get/put produces one matched begin/end span, and
    sent/received byte totals balance across the two ranks."""
    (e0, e1), (m0, m1), (p0, p1) = _instrumented_pair()
    src = np.arange(16, dtype=np.float64).reshape(4, 4)
    h1 = e1.mem_register(src)
    got = []
    e0.get(1, h1.handle_id, got.append)
    # active-transfer gauge is live while the GET is outstanding
    assert m0.read(COMM_ACTIVE_TRANSFERS) == 1
    e1.progress()   # serve the GET request
    e0.progress()   # deliver the data reply
    assert got and np.array_equal(got[0], src)
    assert m0.read(COMM_ACTIVE_TRANSFERS) == 0

    dst = np.zeros((4, 4))
    h0 = e0.mem_register(dst)
    e1.put(0, h0.handle_id, np.ones((4, 4)))
    e0.progress()   # apply the PUT
    np.testing.assert_array_equal(dst, 1.0)

    assert _span_counts(p0, "comm:get") == (1, 1)
    assert _span_counts(p1, "comm:put") == (1, 1)
    # sends happened on both ranks (request one way, data back)
    sent = m0.read(COMM_BYTES_SENT) + m1.read(COMM_BYTES_SENT)
    recv = m0.read(COMM_BYTES_RECEIVED) + m1.read(COMM_BYTES_RECEIVED)
    assert sent > 0 and sent == recv
    msent = m0.read(COMM_MSGS_SENT) + m1.read(COMM_MSGS_SENT)
    mrecv = m0.read(COMM_MSGS_RECEIVED) + m1.read(COMM_MSGS_RECEIVED)
    assert msent == mrecv == 3  # get-req, get-data, put-data


def test_pending_message_gauge_counts_deferred():
    (e0, e1), (m0, m1), _ = _instrumented_pair()
    e0.send_am(1, 77, {"x": 1})   # tag 77 has no handler on rank 1
    e1.progress()
    assert m1.read(COMM_PENDING_MESSAGES) == 1
    # arrival was still counted so totals balance
    assert m1.read(COMM_MSGS_RECEIVED) == 1
    seen = []
    e1.tag_register(77, lambda s, p: seen.append((s, p)))
    assert seen == [(0, {"x": 1})]
    assert m1.read(COMM_PENDING_MESSAGES) == 0


CHAIN_JDF = """
descA [ type="collection" ]
NB [ type="int" ]

Step(k)

k = 0 .. NB

: descA( k, 0 )

RW A <- (k == 0) ? descA( k, 0 ) : A Step( k-1 )
     -> (k == NB) ? descA( k, 0 ) : A Step( k+1 )

BODY
{
    A[0, 0] += 1.0
}
END
"""


def _chain_rank(rank, fabric, nb_ranks, NB, tile=4):
    eng = RemoteDepEngine(fabric.engine(rank))
    ctx = parsec_tpu_torch.Context(nb_cores=1, comm=eng, device="cpu",
                             profile=True)
    try:
        coll = TwoDimBlockCyclic((NB + 1) * tile, tile, tile, tile,
                                 P=nb_ranks, Q=1, nodes=nb_ranks, rank=rank)
        coll.name = "descA"
        tp = ptg.compile_jdf(CHAIN_JDF, name="chain").new(
            descA=coll, NB=NB, rank=rank, nb_ranks=nb_ranks)
        ctx.add_taskpool(tp)
        ctx.wait()
        eng.ce.progress()  # drain any trailing replies before sampling
        snap = ctx.sde.snapshot()
        gets = _span_counts(ctx.profile, "comm:get")
        return snap, gets
    finally:
        ctx.fini()


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_multirank_chain_byte_balance(nb_ranks):
    """Every hop of the chain is a remote dep; with the short-message
    limit forced to 0 every payload goes through the GET rendezvous.
    Across ranks the sent and received totals must agree, and every
    rank's GETs show up as matched span pairs."""
    NB = 7
    parsec_tpu_torch.params.set_cmdline("runtime_comm_short_limit", "0")
    try:
        results, _fabric = spmd(
            nb_ranks, lambda r, f: _chain_rank(r, f, nb_ranks, NB))
    finally:
        parsec_tpu_torch.params.unset_cmdline("runtime_comm_short_limit")
    sent = sum(s.get(COMM_BYTES_SENT, 0) for s, _ in results)
    recv = sum(s.get(COMM_BYTES_RECEIVED, 0) for s, _ in results)
    assert sent > 0 and sent == recv
    msgs_s = sum(s.get(COMM_MSGS_SENT, 0) for s, _ in results)
    msgs_r = sum(s.get(COMM_MSGS_RECEIVED, 0) for s, _ in results)
    assert msgs_s == msgs_r
    total_gets = 0
    for _snap, (b, e) in results:
        assert b == e  # matched begin/end pairs on every rank
        total_gets += b
    # NB cross-rank hops, each a rendezvous GET (round-robin row
    # distribution makes every hop remote)
    assert total_gets == NB
