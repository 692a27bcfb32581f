"""Recording a CUDA graph (parsec_tpu_torch/dsl/graph.py) while Python's
cyclic collector has graphs to free.

A graph runner and the block that owns it refer to each other, so a
dropped block and its CUDA graph are freed by the collector, in whatever
thread allocates when it runs.  A collection in a thread that is
capturing would destroy that graph inside the capture, which CUDA
refuses and which invalidates the capture.  These tests make the
collector run as often as it can while a body is recorded.  They import
no JAX and need the card: a CUDA graph has no CPU mode.
"""
import gc

import pytest
import torch

from parsec_tpu_torch.dsl.graph import CaptureError, GraphRunner


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _runner(body):
    return GraphRunner(lambda state, device, note: note("body") or
                       {"x": body(state["x"])}, "block", lambda: ["x"])


def _recorded_graph(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.add_(1)
    return g


@pytest.fixture
def eager_collector():
    """Collect at every allocation of a container."""
    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(1, 1, 1)
    yield
    gc.set_threshold(*thresholds)
    gc.collect()


@pytest.mark.gpu
def test_record_survives_a_collection_of_dropped_graphs(cuda_device,
                                                        eager_collector):
    """Recorded graphs become cyclic garbage during the capture of a
    body, which then allocates: the collector does not free them inside
    the capture, which records and replays the body's result."""
    x = torch.arange(8, dtype=torch.float32, device=cuda_device)
    held = [_recorded_graph(x.clone()) for _ in range(3)]
    calls = []

    def body(t):
        calls.append(t)
        if len(calls) == 2:              # the capture, after the warm-up
            cycle = [held[:]]
            cycle.append(cycle)          # only the collector frees it
            held.clear()
            del cycle
        junk = [[i] for i in range(100)]  # the collector runs here
        del junk
        return t * 2

    runner = _runner(body)
    out = runner.run({"x": x}, cuda_device)
    assert runner.recorded and runner.replays == 1
    assert torch.equal(out["x"], x * 2)
    assert gc.isenabled()
    gc.collect()                         # frees the dropped graphs


@pytest.mark.gpu
def test_failed_record_restores_the_collector(cuda_device):
    """A body that syncs with the host cannot be recorded; the collector
    is on again after the CaptureError, as it was before."""
    x = torch.ones(4, device=cuda_device)
    runner = _runner(lambda t: t + float(t.sum().item()))
    with pytest.raises(CaptureError, match="task body cannot be recorded"):
        runner.run({"x": x}, cuda_device)
    assert gc.isenabled()
