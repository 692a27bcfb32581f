"""CI smoke: the ex02 chain runs with tracing + metrics enabled on the
port, its exported trace validates against the minimal Chrome-trace
schema, and the report (``obs.analyze`` / ``obs.format_report``, what
the JAX package's tools/obs_report.py prints) gives the critical path,
breakdown and overlap from it — so a telemetry regression fails tier-1.

The port's counterpart of the JAX package's ``tests/test_obs_smoke.py``
(its examples/ex02_chain.py runs inline here), run on the port with
``device="cpu"``.
"""
import json
import os
import sys

import numpy as np
import pytest

import parsec_tpu_torch
from parsec_tpu_torch.obs import analyze, format_report, validate_chrome_trace

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

CHAIN_JDF = """
taskdist [ type="collection" ]
NB       [ type="int" ]

Task(k)

k = 0 .. NB

: taskdist( k )

RW  A <- (k == 0) ? NEW : A Task( k-1 )   [ shape=1 dtype=int64 ]
      -> (k < NB) ? A Task( k+1 )

BODY
{
    if k == 0:
        A[...] = 0
    else:
        A[...] += 1
}
END
"""


def _ex02_chain(NB):
    """examples/ex02_chain.py's main, on the port."""
    from parsec_tpu_torch.collections import LocalArrayCollection
    from parsec_tpu_torch.dsl import ptg
    ctx = parsec_tpu_torch.init(nb_cores=2, device="cpu")
    try:
        taskdist = LocalArrayCollection(np.zeros((NB + 1, 1), dtype=np.int64),
                                        NB + 1)
        tp = ptg.compile_jdf(CHAIN_JDF, name="chain02").new(
            taskdist=taskdist, NB=NB)
        ctx.add_taskpool(tp)
        ctx.wait()
        assert tp.completed and tp.nb_local_tasks == NB + 1
    finally:
        ctx.fini()


@pytest.fixture
def traced_ex02(tmp_path):
    """Run the ex02 chain with profile + DOT + metrics on; yields
    (trace_path, dot_path)."""
    prefix = str(tmp_path / "smoke")
    parsec_tpu_torch.params.set_cmdline("profile", prefix)
    parsec_tpu_torch.params.set_cmdline("profiling_dot", prefix)
    parsec_tpu_torch.params.set_cmdline("metrics", "1")
    try:
        _ex02_chain(6)
    finally:
        parsec_tpu_torch.params.unset_cmdline("profile")
        parsec_tpu_torch.params.unset_cmdline("profiling_dot")
        parsec_tpu_torch.params.unset_cmdline("metrics")
    trace = tmp_path / "smoke.rank0.trace.json"
    dot = tmp_path / "smoke.rank0.dot"
    assert trace.exists(), "profile prefix did not produce a trace file"
    assert dot.exists(), "profiling_dot did not produce a DOT file"
    return str(trace), str(dot)


def test_ex02_trace_validates_and_reports(traced_ex02):
    trace, dot = traced_ex02
    with open(trace) as fh:
        doc = json.load(fh)
    summary = validate_chrome_trace(doc)
    assert summary["spans"] >= 7          # one exec span per chain task
    assert summary["metadata"] >= 2       # process_name + thread_name
    names = {e["name"] for e in doc["traceEvents"]}
    assert "process_name" in names and "thread_name" in names
    assert any(n.startswith("exec:") for n in names)
    # SDE counters were sampled into the trace at fini
    assert any(e.get("ph") == "C" for e in doc["traceEvents"])

    # the report end-to-end: critical path + breakdown + overlap
    with open(dot) as fh:
        report = analyze([doc], fh.read())
    out = format_report(report)
    assert "critical path:" in out
    assert "per-task-class breakdown:" in out
    assert "overlap" in out
    # the chain is sequential: critical path == total exec (7 tasks)
    cp = report["critical_path"]
    assert cp["nb_tasks"] == 7
    assert cp["length_us"] == pytest.approx(cp["total_exec_us"], rel=1e-6)


def test_binary_trace_roundtrip_with_obs_streams(tmp_path):
    """The .ptt binary dump must survive the new comm/device streams and
    non-JSON info payloads (repr fallback)."""
    import numpy as np
    from parsec_tpu_torch.profiling.binfmt import read_profile
    from parsec_tpu_torch.profiling.trace import Profile
    p = Profile(rank=0)
    st = p.stream(1 << 20, "comm")
    st.begin("comm:send", info={"arr": np.zeros(3)})  # not JSON-serializable
    st.end("comm:send")
    # complete ("X") span, 4000 ns long (timestamps on the profile base)
    st.span("comm:get", p._t0 + 1000, p._t0 + 5000, {"bytes": 64})
    out = p.dump_binary(str(tmp_path / "t"))
    rp = read_profile(out)  # rebased at t0=0
    assert rp.nb_events() == 3
    # the .ptt toolchain sees the X span as an interval of its duration
    import ptt_dump
    ivs = ptt_dump.intervals_of(list(rp._streams.values())[0])
    assert ("comm:get", 1000, 5000, {"bytes": 64, "dur_ns": 4000}) in ivs
    # chrome export with the same payload must not crash either
    out_json = p.dump(str(tmp_path / "t.json"))
    with open(out_json) as fh:
        doc = json.load(fh)
    validate_chrome_trace(doc)
