"""The port (parsec_tpu_torch) stands alone: it imports neither JAX nor the
JAX package, and it never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the test process holds both frameworks)
import numpy as np  # noqa: F401
import pytest
import torch

import parsec_tpu_torch
from parsec_tpu_torch.utils.params import params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "parsec_tpu_torch")


def _forbidden(mod):
    """JAX, jaxlib or the JAX package; ``parsec_tpu_torch`` itself shares
    the prefix, so the package names are matched exactly."""
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "parsec_tpu")


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_sources_import_no_jax():
    """Every import statement of the package and chip_smoke.py, lazy
    ones inside functions included (the comm layer and the device data
    plane among them)."""
    bad = []
    seen = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("comm/engine.py", "comm/wire.py", "comm/local.py",
                "comm/tcp.py", "comm/remote_dep.py", "comm/xfer.py",
                "xfer/loopback.py", "utils/spmd.py", "core/sync.py",
                "core/mempool.py", "utils/debug_history.py",
                "utils/checkpoint.py", "ft/__init__.py", "ft/inject.py",
                "ft/detector.py", "ft/restart.py", "devices/template.py",
                "collections/ops.py", "dsl/ptg/unparse.py",
                "profiling/otf2.py", "profiling/aggregator.py",
                "bindings/__init__.py", "bindings/build.py",
                "bindings/chelper.py", "obs/__init__.py", "obs/metrics.py",
                "obs/prometheus.py", "obs/spans.py", "obs/critpath.py",
                "obs/live.py", "tune/__init__.py", "tune/controller.py",
                "serve/__init__.py", "serve/fairness.py",
                "serve/server.py", "serve/client.py",
                "stagec/__init__.py", "stagec/plan.py", "stagec/lower.py",
                "stagec/runtime.py", "stagec/chain.py",
                "stagec/sharded.py"):
        assert os.path.join("parsec_tpu_torch", mod) in seen, mod
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_cpu_dpotrf_loads_no_jax():
    """A fresh interpreter imports the port and factors a small matrix on
    the CPU device; no JAX module is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import parsec_tpu_torch as ptt
        from parsec_tpu_torch.collections import TwoDimBlockCyclic
        import parsec_tpu_torch.comm, parsec_tpu_torch.xfer
        import parsec_tpu_torch.utils.spmd
        import parsec_tpu_torch.tune, parsec_tpu_torch.serve
        ctx = ptt.init(nb_cores=2, device="cpu")
        M = ptt.ops.make_spd(96)
        A = TwoDimBlockCyclic(96, 96, 32, 32).from_numpy(M)
        ptt.ops.dpotrf(ctx, A)
        ctx.fini()
        L = np.tril(A.to_numpy())
        assert np.abs(L @ L.T - M).max() < 5e-4
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parsec_tpu")))
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PARSEC_MCA_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


#: one CPU drive of each module of parsec_tpu_torch/ops/ beyond dpotrf
OPS_DRIVES = {
    "dtrsm": """
        A = TwoDimBlockCyclic(96, 96, 32, 32).from_numpy(ptt.ops.make_spd(96))
        B = TwoDimBlockCyclic(96, 32, 32, 32).from_numpy(np.ones((96, 32), np.float32))
        ptt.ops.dposv(ctx, A, B)
        assert np.isfinite(B.to_numpy()).all()
    """,
    "dgetrf": """
        A = TwoDimBlockCyclic(96, 96, 32, 32).from_numpy(ptt.ops.make_diag_dominant(96))
        ptt.ops.dgetrf_nopiv(ctx, A)
        LU, perm = ptt.ops.dgetrf(ptt.ops.make_diag_dominant(96), nb=32, device="cpu")
        assert np.isfinite(A.to_numpy()).all() and LU.shape == (96, 96)
    """,
    "dgeqrf": """
        A = TwoDimBlockCyclic(96, 64, 32, 32).from_numpy(np.eye(96, 64, dtype=np.float32))
        ptt.ops.dgeqrf(ctx, A)
        assert np.isfinite(A.to_numpy()).all()
    """,
    "pdgemm": """
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(np.eye(64, dtype=np.float32))
        C = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(np.eye(64, dtype=np.float32))
        ptt.ops.pdgemm(ctx, A, A, C, alpha=2.0, beta=1.0, transa="t")
        assert np.array_equal(C.to_numpy(), 3 * np.eye(64))
    """,
    "inverse": """
        L = np.linalg.cholesky(ptt.ops.make_spd(64)).astype(np.float32)
        assert ptt.ops.dpotri(L, device="cpu").shape == (64, 64)
        X = ptt.ops.dgesv(ptt.ops.make_diag_dominant(64), np.ones((64, 2)), nb=32, device="cpu")
        assert X.shape == (64, 2)
    """,
}


@pytest.mark.parametrize("module", sorted(OPS_DRIVES))
def test_cpu_ops_modules_load_no_jax(module):
    """A fresh interpreter drives ``ops/<module>.py`` on the CPU device;
    no JAX module is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import parsec_tpu_torch as ptt
        from parsec_tpu_torch.collections import TwoDimBlockCyclic
        ctx = ptt.init(nb_cores=2, device="cpu")
    """) + textwrap.dedent(OPS_DRIVES[module]) + textwrap.dedent("""
        ctx.fini()
        assert "parsec_tpu_torch.ops.%s" in sys.modules
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parsec_tpu")))
    """ % module)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PARSEC_MCA_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


#: one CPU drive of each module of the DTD front end, its composition and
#: whole-graph capture
FRONT_END_DRIVES = {
    "dsl.dtd": """
        tp = ptt.dtd.taskpool_new(); ctx.add_taskpool(tp)
        t = tp.tile_of_array(np.ones((4, 4), np.float32))
        body = lambda es, task: None
        tp.insert_task(body, (t, ptt.dtd.INOUT))
        tp.add_chore(body, "cuda", lambda x: x * 2)
        tp.insert_task(body, (t, ptt.dtd.INOUT))
        tp.data_flush_all(); tp.wait()
        assert ctx.device_by_type("cuda").stats["tasks"] >= 1
    """,
    "dsl.dtd.capture": """
        from parsec_tpu_torch.dsl.dtd.capture import dtd_capture
        g = dtd_capture(device="cpu")
        t = g.tile_of_array(np.ones((4, 4), np.float32))
        g.insert_task(ptt.ops.gemm_nn, (t, ptt.dtd.INOUT), (t, ptt.dtd.INPUT), (t, ptt.dtd.INPUT))
        g.run()
        assert float(g.value(t)[0, 0]) == 5.0
    """,
    "dsl.ptg.capture": """
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        ptt.ptg.capture(ptt.ops.dpotrf_taskpool(A)).run(device="cpu")
        assert np.isfinite(A.to_numpy()).all()
    """,
    "dsl.ptg.to_dtd": """
        from parsec_tpu_torch.dsl.ptg.to_dtd import ptg_to_dtd
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        ptg_to_dtd(ptt.ops.dpotrf_taskpool(A), ctx)
        assert np.isfinite(A.to_numpy()).all()
    """,
    "runtime.compound": """
        a, b = ptt.dtd.taskpool_new(), ptt.dtd.taskpool_new()
        log = []
        a.insert_task(lambda es, t: log.append("a"))
        b.insert_task(lambda es, t: log.append("b"))
        ctx.add_taskpool(ptt.compose(a, b)); ctx.wait()
        assert log == ["a", "b"]
    """,
    "runtime.recursive": """
        tp = ptt.dtd.taskpool_new(); ctx.add_taskpool(tp)
        log = []
        def parent(es, task):
            sub = ptt.dtd.taskpool_new()
            sub.insert_task(lambda e, t: log.append("child"))
            return ptt.recursive_call(es, task, sub)
        tp.insert_task(parent); tp.wait()
        assert log == ["child"]
    """,
    "native": """
        from parsec_tpu_torch.core.lists import Lifo
        assert Lifo.__module__ == "_parsec_torch_native"
    """,
    "dsl.ptg.lower": """
        from parsec_tpu_torch.utils.params import params
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        with params.cmdline_override("ptg_dep_management", "static"), \
                params.cmdline_override("ptg_dispatch", "classic"):
            tp = ptt.ops.dpotrf_taskpool(A)
            ctx.add_taskpool(tp); ctx.wait()
        assert tp._engine is not None and np.isfinite(A.to_numpy()).all()
    """,
    "dsl.ptg.turbo": """
        from parsec_tpu_torch.utils.params import params
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        with params.cmdline_override("ptg_dep_management", "static"):
            tp = ptt.ops.dpotrf_taskpool(A)
            ctx.add_taskpool(tp); ctx.wait()
        assert tp._turbo is not None and np.isfinite(A.to_numpy()).all()
    """,
    "dsl.ptg.wave": """
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        ptt.ptg.wave(ptt.ops.dpotrf_taskpool(A)).run(device="cpu")
        assert np.isfinite(A.to_numpy()).all()
    """,
    "core.sync": """
        from parsec_tpu_torch.core.sync import RWLock, ValueArray
        lock = RWLock(); lock.write_lock(); lock.write_unlock()
        va = ValueArray(2); va.push_back(b"ab"); assert va.get(0) == b"ab"
    """,
    "core.mempool": """
        from parsec_tpu_torch.core.mempool import Mempool
        pool = Mempool(lambda: np.empty(4)); a = pool.allocate(); pool.free(a)
        assert pool.allocate() is a
    """,
    "utils.debug_history": """
        from parsec_tpu_torch.utils import debug_history
        debug_history.enable(8); debug_history.history.mark("x")
        assert len(debug_history.history) == 1; debug_history.disable()
    """,
    "utils.checkpoint": """
        import tempfile
        from parsec_tpu_torch.utils import checkpoint as ckpt
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        ptt.ops.dpotrf(ctx, A)
        p = tempfile.mkdtemp() + "/ck"
        ckpt.save_collection(A, p, context=ctx)
        B = TwoDimBlockCyclic(64, 64, 32, 32)
        assert ckpt.restore_collection(B, p) == 4
        assert np.array_equal(B.to_numpy(), A.to_numpy())
    """,
    "ft.restart": """
        import tempfile
        from parsec_tpu_torch.ft import RestartPolicy, run_with_restart
        A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(ptt.ops.make_spd(64))
        st = run_with_restart(ctx, [lambda: ptt.ops.dpotrf_taskpool(A)], [A],
                              tempfile.mkdtemp() + "/ck", RestartPolicy())
        assert st["snapshots"] == 2
    """,
    "ft.detector": """
        from parsec_tpu_torch.comm import LocalFabric
        from parsec_tpu_torch.ft import FaultInjector, HeartbeatDetector
        fab = LocalFabric(2); e0 = fab.engine(0); fab.engine(1)
        HeartbeatDetector(e0, 0.1, 1.0).stop()
        assert FaultInjector.from_spec("kill:rank=0", 0).has_task_actions
        assert "parsec_tpu_torch.ft.inject" in sys.modules
    """,
    "devices.template": """
        from parsec_tpu_torch.devices import TemplateDevice
        ctx.devices.append(TemplateDevice(len(ctx.devices)))
        assert ctx.device_by_type("template") is not None
    """,
    "collections.ops": """
        from parsec_tpu_torch.collections import ops as cops
        A = TwoDimBlockCyclic(8, 8, 4, 4).from_numpy(np.ones((8, 8), np.float32))
        d = cops.reduce_all(ctx, A, lambda a, b, _: a + b)
        assert float(d.to_numpy()[0, 0]) == 4.0
    """,
    "dsl.ptg.unparse": """
        from parsec_tpu_torch.dsl.ptg.parser import parse_jdf
        from parsec_tpu_torch.dsl.ptg.unparse import unparse
        jdf = sys.modules["parsec_tpu_torch.ops.dpotrf"].DPOTRF_L_JDF
        assert "BODY" in unparse(parse_jdf(jdf, name="d"))
    """,
    "profiling.otf2": """
        import tempfile
        from parsec_tpu_torch.profiling.otf2 import read_otf2, write_otf2
        from parsec_tpu_torch.profiling.trace import Profile
        prof = Profile(rank=0); prof._t0 = 0
        prof.stream(0, "w").events = [(1, "i", "m", None)]
        assert read_otf2(write_otf2(prof, tempfile.mkdtemp())).rank == 0
    """,
    "profiling.aggregator": """
        from parsec_tpu_torch.profiling.aggregator import AggregatorServer
        srv = AggregatorServer().start(); srv.stop()
    """,
    "obs": """
        from parsec_tpu_torch import obs
        from parsec_tpu_torch.utils.params import params
        with params.cmdline_override("metrics", "1"), \
                params.cmdline_override("obs_live", "1"):
            c2 = ptt.init(nb_cores=2, device="cpu", profile=True)
            A = TwoDimBlockCyclic(96, 96, 32, 32).from_numpy(
                ptt.ops.make_spd(96))
            ptt.ops.dpotrf(c2, A)
            c2.stamp_profile_meta()
            doc = c2.profile.to_chrome_trace()
            text = c2.obs.render_prometheus()
            c2.fini()
        obs.validate_chrome_trace(doc)
        assert "device" in obs.analyze([doc])
        assert obs.parse_exposition(text)
    """,
    "obs.live": """
        from parsec_tpu_torch.obs.live import LiveHealth, fleet_health
        lh = LiveHealth(0)
        lh.note_comm(0, 1000, src=1)
        lh.tick()
        assert fleet_health({0: lh.snapshot()})["nb_ranks"] == 1
    """,
    "stagec.runtime": """
        from parsec_tpu_torch.utils.params import params
        A = TwoDimBlockCyclic(128, 128, 32, 32).from_numpy(
            ptt.ops.make_spd(128))
        with params.cmdline_override("stage_compile", "1"):
            tp = ptt.ops.dpotrf_taskpool(A)
            ctx.add_taskpool(tp)
            ctx.wait()
        assert tp._stagec is not None
        assert ctx.stage_stats["stage_tasks"] == 20
    """,
    "stagec.chain": """
        from parsec_tpu_torch.utils.params import params
        A = TwoDimBlockCyclic(128, 128, 32, 32).from_numpy(
            ptt.ops.make_spd(128))
        B = TwoDimBlockCyclic(128, 8, 32, 8).from_numpy(
            np.ones((128, 8), np.float32))
        with params.cmdline_override("stage_compile", "1"):
            ptt.ops.dposv(ctx, A, B)
        assert ctx.stage_stats["chain_links"] == 2
    """,
    "stagec.sharded": """
        ctx.fini()
        from parsec_tpu_torch.utils.params import params
        A = TwoDimBlockCyclic(160, 160, 32, 32).from_numpy(
            ptt.ops.make_spd(160))
        with params.cmdline_override("stage_compile", "1"), \
                params.cmdline_override("device_mesh_shape", "2x2"), \
                params.cmdline_override("device_cuda_virtual_chips", "4"):
            ctx = ptt.init(nb_cores=2, device="cpu")
            ctx.add_taskpool(ptt.ops.dpotrf_taskpool(A))
            ctx.wait()
        assert ctx.stage_stats["stage_sharded"] >= 1
    """,
    "bindings.chelper": """
        from parsec_tpu_torch.bindings import chelper
        assert chelper.device_names(ctx) == "cpu,cpu"
    """,
    "collections.subtile": """
        from parsec_tpu_torch.collections import SubtileView
        arr = np.zeros((8, 8), np.float32)
        SubtileView(arr, 4, 4).data_of(1, 1).get_copy(0).payload[:] = 1
        assert arr.sum() == 16
    """,
}


@pytest.mark.parametrize("module", sorted(FRONT_END_DRIVES))
def test_cpu_front_end_modules_load_no_jax(module):
    """A fresh interpreter drives one module of the DTD front end, pool
    composition or graph capture on the CPU; no JAX module is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import parsec_tpu_torch as ptt
        from parsec_tpu_torch.collections import TwoDimBlockCyclic
        ctx = ptt.init(nb_cores=2, device="cpu")
    """) + textwrap.dedent(FRONT_END_DRIVES[module]) + textwrap.dedent("""
        ctx.fini()
        assert "parsec_tpu_torch.%s" in sys.modules
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parsec_tpu")))
    """ % module)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PARSEC_MCA_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_cpu_train_step_loads_no_jax():
    """A fresh interpreter takes two Adam steps of a small MoE model with
    flash attention on the CPU (the flash backward, parallel/moe.py,
    models/train.py); no JAX module is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from parsec_tpu_torch import models
        cfg = models.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                       d_head=8, seq_len=16, batch=2,
                                       n_experts=2, attention="flash",
                                       remat=True)
        params = models.init_params(cfg)
        state = models.adam_init(params)
        step = models.make_train_step(cfg, device="cpu")
        tokens = np.arange(32).reshape(2, 16) % 64
        for _ in range(2):
            params, state, loss = step(params, state, tokens,
                                       np.roll(tokens, -1, axis=1))
        assert np.isfinite(loss.item()) and int(state["count"]) == 2
        for mod in ("parallel.moe", "models.train", "ops.kernels"):
            assert "parsec_tpu_torch." + mod in sys.modules
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parsec_tpu")))
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PARSEC_MCA_")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_init_without_card_raises(monkeypatch):
    """No CUDA and no device="cpu": init raises instead of falling back;
    the device_cuda_platform knob selects the CPU explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PARSEC_MCA_device_cuda_platform", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parsec_tpu_torch.init(nb_cores=1)
    with params.cmdline_override("device_cuda_platform", "cpu"):
        ctx = parsec_tpu_torch.init(nb_cores=1)
        try:
            assert ctx.device_by_type("cuda").torch_device.type == "cpu"
        finally:
            ctx.fini()


@pytest.mark.parametrize("knob,value", [
    ("stage_compile_xrank", "1"),
    ("device_mesh_shape", "2x2"), ("device_donate", "1"),
    ("device_batch_mode", "vmap")])
def test_trimmed_knobs_raise(knob, value):
    """A knob asking for what this package does not carry raises; a chip
    mesh larger than the chip pool (one host chip, with no
    device_cuda_virtual_chips) raises instead of falling back.
    stage_compile_xrank left this list: cross-rank SPMD stages are
    carried, so init accepts it (and a pool of one rank plans no
    cross-rank wave)."""
    if knob == "stage_compile_xrank":
        from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
        from parsec_tpu_torch.collections import TwoDimBlockCyclic
        with params.cmdline_override(knob, value), \
                params.cmdline_override("stage_compile", "1"):
            ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
            try:
                A = TwoDimBlockCyclic(64, 64, 32, 32).from_numpy(
                    make_spd(64))
                tp = dpotrf_taskpool(A)
                ctx.add_taskpool(tp)
                ctx.wait()
                assert tp._stagec.plan.xwaves == []
            finally:
                ctx.fini()
        return
    exc = RuntimeError if knob == "device_mesh_shape" \
        else NotImplementedError
    with params.cmdline_override(knob, value):
        with pytest.raises(exc):
            parsec_tpu_torch.init(nb_cores=1, device="cpu")


def test_tune_auto_knob_is_carried():
    """tune_auto is no longer a trimmed knob: init builds the self-tuning
    controller (and the live monitor it rides), subscribed to the
    monitor's window tick and acting on the device module."""
    from parsec_tpu_torch.tune import Controller
    with params.cmdline_override("tune_auto", "1"):
        ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
        try:
            assert isinstance(ctx.obs.tuner, Controller)
            assert ctx.obs.live is not None
            assert ctx.obs.tuner.on_window in ctx.obs.live._subscribers
            assert ctx.obs.tuner.devices == list(ctx.devices)
        finally:
            ctx.fini()


def test_serve_knob_is_carried():
    """serve is no longer a trimmed knob: init builds the live monitor a
    SessionServer charges each tenant's latency into, and a server opens
    on the context."""
    from parsec_tpu_torch.serve import SessionServer
    with params.cmdline_override("serve", "1"):
        ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
        try:
            assert ctx.obs.live is not None and ctx.obs.tuner is None
            with SessionServer(ctx) as srv:
                assert ctx.serve_fairness is srv.fairness
        finally:
            ctx.fini()


def test_comm_mesh_local_knob_is_carried():
    """comm_mesh_local is no longer a trimmed knob: init accepts it on
    and off, and the comm layer reads it."""
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    for value, on in (("1", True), ("0", False)):
        with params.cmdline_override("comm_mesh_local", value):
            ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
            ctx.fini()
            rde = RemoteDepEngine(LocalFabric(2).engine(0))
            assert rde.mesh_local_to(1) is on


def test_ft_elastic_knob_is_carried():
    """ft_elastic is no longer a trimmed knob: init accepts every mode
    (a one-rank context attaches no coordinator), and an unknown mode
    raises ValueError where a policy reads it."""
    from parsec_tpu_torch.ft import ElasticPolicy
    for mode in ("shrink", "grow", "both"):
        with params.cmdline_override("ft_elastic", mode):
            ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
            try:
                assert ctx._ft_elastic is None
                assert ElasticPolicy(lambda g: ([], [])).mode == mode
            finally:
                ctx.fini()
    with params.cmdline_override("ft_elastic", "sideways"):
        with pytest.raises(ValueError, match="ft_elastic"):
            ElasticPolicy(lambda g: ([], []))


def test_multirank_and_static_deps_raise():
    """Static dependency management on several ranks raises (the static
    engines lower one rank's task space; the JAX package quietly runs the
    hash path there, this package refuses).  In the hash mode a remote
    successor with no comm engine attached raises the JAX package's
    RuntimeError, and so does a context of two ranks with no engine."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.ops import dpotrf_taskpool
    with pytest.raises(ValueError, match="without a comm engine"):
        parsec_tpu_torch.init(nb_cores=1, device="cpu", nb_ranks=2)
    with params.cmdline_override("ptg_dep_management", "static"):
        tp = dpotrf_taskpool(TwoDimBlockCyclic(64, 64, 32, 32, P=2),
                             nb_ranks=2)
        with pytest.raises(NotImplementedError):
            tp.startup_hook(None, tp)
    with params.cmdline_override("ptg_dep_management", "hash"):
        ctx = parsec_tpu_torch.init(nb_cores=1, device="cpu")
        try:
            A = TwoDimBlockCyclic(64, 64, 32, 32, P=2, nodes=2, rank=0)
            for (i, j) in A.local_tiles():
                np.copyto(A.tile(i, j), np.eye(32, dtype=np.float32) * 4)
            ctx.add_taskpool(dpotrf_taskpool(A, rank=0, nb_ranks=2))
            with pytest.raises(RuntimeError) as err:
                ctx.wait()
            assert isinstance(err.value.__cause__, RuntimeError)
            assert "no comm engine is attached" in str(err.value.__cause__)
        finally:
            ctx.fini()


def test_native_import_writes_nothing_under_the_packages(tmp_path):
    """A fresh interpreter imports parsec_tpu_torch.native and builds the
    native core once more into a scratch directory: no file under
    parsec_tpu/ or parsec_tpu_torch/ is added or changed (the library
    goes to build/native/)."""
    def snapshot():
        # the JAX package's own extensions (parsec_tpu/**/*.so) are
        # rebuilt by its imports and tests in other workers; the port's
        # library name is checked for there instead
        out = {}
        for top in ("parsec_tpu", "parsec_tpu_torch"):
            for dirpath, dirs, files in os.walk(os.path.join(ROOT, top)):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for f in files:
                    assert not f.startswith("_parsec_torch_native"), f
                    if top == "parsec_tpu" and f.endswith(".so"):
                        continue
                    p = os.path.join(dirpath, f)
                    st = os.stat(p)
                    out[p] = (st.st_mtime_ns, st.st_size)
        return out

    before = snapshot()
    code = textwrap.dedent("""
        import sys
        from pathlib import Path
        import parsec_tpu_torch.native as native
        from parsec_tpu_torch.native import build
        so = build.build(out_dir=Path(sys.argv[1]))
        print(native.native.__file__)
        print(so)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parsec_tpu")))
    """)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib, scratch, mods = proc.stdout.strip().splitlines()[-3:]
    assert os.path.dirname(lib) == os.path.join(ROOT, "build", "native")
    assert os.path.dirname(scratch) == str(tmp_path)
    assert mods == "[]"
    assert snapshot() == before
