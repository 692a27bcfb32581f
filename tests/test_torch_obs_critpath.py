"""obs/critpath: critical-path extraction, interval algebra, and the
compute/comm overlap fraction on deterministic synthetic traces.

The port's counterpart of the JAX package's ``tests/test_critpath.py``, run on
the port with ``device="cpu"``.
"""
import pytest

from parsec_tpu_torch.obs import analyze, critical_path, parse_dot
from parsec_tpu_torch.obs.critpath import (load_trace_intervals, merge_intervals,
                                     overlap_us)


def _exec_span(pid, tid, cls, task, b, e):
    return [
        {"name": f"exec:{cls}", "ph": "B", "pid": pid, "tid": tid, "ts": b,
         "args": {"task": task}},
        {"name": f"exec:{cls}", "ph": "E", "pid": pid, "tid": tid, "ts": e},
    ]


def _comm_span(pid, b, e, name="comm:get"):
    return [
        {"name": name, "ph": "B", "pid": pid, "tid": 999, "ts": b},
        {"name": name, "ph": "E", "pid": pid, "tid": 999, "ts": e},
    ]


def _doc(events):
    return {"traceEvents": events, "metadata": {}}


def _dot(edges, nodes):
    lines = ["digraph dag {", "  node [style=filled];"]
    for nid, label in nodes.items():
        lines.append(f'  {nid} [label="{label}",fillcolor="#88CCEE",thid=0];')
    for a, b in edges:
        lines.append(f"  {a} -> {b};")
    lines.append("}")
    return "\n".join(lines)


def test_chain_critical_path_equals_total():
    """A pure chain has zero parallelism: the critical path IS the sum
    of every task's span time."""
    events = (_exec_span(0, 0, "STEP", "STEP(0)", 0, 100)
              + _exec_span(0, 0, "STEP", "STEP(1)", 100, 150)
              + _exec_span(0, 0, "STEP", "STEP(2)", 150, 175))
    dot = _dot([("STEP_0_", "STEP_1_"), ("STEP_1_", "STEP_2_")],
               {"STEP_0_": "STEP(0)", "STEP_1_": "STEP(1)",
                "STEP_2_": "STEP(2)"})
    report = analyze([_doc(events)], dot_text=dot)
    cp = report["critical_path"]
    assert cp["length_us"] == pytest.approx(175.0)
    assert cp["length_us"] == pytest.approx(cp["total_exec_us"])
    assert cp["tasks"] == ["STEP(0)", "STEP(1)", "STEP(2)"]
    assert cp["parallelism"] == pytest.approx(1.0)


def test_two_branch_critical_path_below_total():
    """root -> {b1, b2} -> join: the critical path takes the longer
    branch and is strictly below total exec time."""
    events = (_exec_span(0, 0, "R", "R(0)", 0, 10)
              + _exec_span(0, 0, "B", "B(1)", 10, 40)    # 30 us
              + _exec_span(0, 1, "B", "B(2)", 10, 30)    # 20 us
              + _exec_span(0, 0, "J", "J(0)", 40, 45))   # 5 us
    dot = _dot([("R_0_", "B_1_"), ("R_0_", "B_2_"),
                ("B_1_", "J_0_"), ("B_2_", "J_0_")],
               {"R_0_": "R(0)", "B_1_": "B(1)", "B_2_": "B(2)",
                "J_0_": "J(0)"})
    report = analyze([_doc(events)], dot_text=dot)
    cp = report["critical_path"]
    assert cp["length_us"] == pytest.approx(10 + 30 + 5)
    assert cp["tasks"] == ["R(0)", "B(1)", "J(0)"]
    assert cp["total_exec_us"] == pytest.approx(65.0)
    assert cp["length_us"] < cp["total_exec_us"]
    assert cp["parallelism"] > 1.0


def test_critical_path_rejects_cycles():
    with pytest.raises(ValueError, match="cycle"):
        critical_path({"a": 1.0, "b": 1.0}, [("a", "b"), ("b", "a")])


def test_parse_dot_grapher_format():
    from parsec_tpu_torch.profiling.grapher import Grapher

    class _T:
        def __init__(self, label, tc):
            self._label, self.task_class = label, type("TC", (), {"name": tc})
        def snprintf(self):
            return self._label

    class _ES:
        th_id = 0

    g = Grapher()
    g.enable()
    g.task_executed(_ES(), _T("A(0)", "A"))
    g.task_executed(_ES(), _T("A(1)", "A"))
    g.dep(_T("A(0)", "A"), "A(1)", flow="X")
    labels, edges = parse_dot(g.to_dot())
    assert set(labels.values()) == {"A(0)", "A(1)"}
    assert edges == [("A(0)", "A(1)")]


def test_interval_algebra():
    assert merge_intervals([(0, 10), (5, 20), (30, 40)]) == [(0, 20), (30, 40)]
    assert merge_intervals([]) == []
    assert overlap_us([(0, 100)], [(50, 150)]) == pytest.approx(50.0)
    assert overlap_us([(0, 10), (20, 30)], [(5, 25)]) == pytest.approx(10.0)
    assert overlap_us([(0, 10)], [(20, 30)]) == 0.0


def test_overlap_fraction_per_rank():
    """Comm half-hidden under compute -> fraction 0.5; a second rank
    with fully exposed comm -> fraction 0.0."""
    events = (_exec_span(0, 0, "K", "K(0)", 0, 100)
              + _comm_span(0, 50, 150)
              + _exec_span(1, 0, "K", "K(1)", 0, 100)
              + _comm_span(1, 100, 200))
    report = analyze([_doc(events)])
    assert report["overlap"][0]["overlap_fraction"] == pytest.approx(0.5)
    assert report["overlap"][0]["comm_us"] == pytest.approx(100.0)
    assert report["overlap"][1]["overlap_fraction"] == pytest.approx(0.0)
    # per-class breakdown is keyed by rank then class
    assert report["by_class"][0]["K"]["count"] == 1
    assert report["by_class"][0]["K"]["total_us"] == pytest.approx(100.0)


def test_unmatched_events_are_dropped():
    """A stray E without B (or truncated B) must not produce intervals."""
    events = [{"name": "exec:X", "ph": "E", "pid": 0, "tid": 0, "ts": 5.0}]
    assert load_trace_intervals(_doc(events)) == []
