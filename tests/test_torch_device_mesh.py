"""The port's chip mesh of one rank (``device_mesh_shape``,
devices/cuda.py ``CudaMeshDevice``) against tests/test_device_mesh.py.

On the CPU the chips are ``device_cuda_virtual_chips`` host chips with no
streams, so the placement, hops, sharded dispatch and their bookkeeping
all run; where the JAX package warns and falls back (too few chips, a
failing sharded dispatch) the port raises.  The parity test takes the
same seeded matrix through the JAX package's 2 x 2 mesh dpotrf (on
conftest's 8 virtual CPU devices) and through the port's.  The card-only
variants are marked ``gpu``.
"""
import threading
from contextlib import ExitStack

import numpy as np
import pytest
import torch

import parsec_tpu_torch as ptt
from parsec_tpu_torch.collections import TwoDimBlockCyclic
from parsec_tpu_torch.ops import dpotrf_taskpool, make_spd
from parsec_tpu_torch.utils.params import params

ATOL = 5e-4   # tests/test_torch_dpotrf.py's bound on fp32 factors


def _knobs(shape=None, chips=None, extra=()):
    stack = ExitStack()
    if shape is not None:
        stack.enter_context(params.cmdline_override("device_mesh_shape",
                                                    shape))
    if chips is not None:
        stack.enter_context(params.cmdline_override(
            "device_cuda_virtual_chips", str(chips)))
    for k, v in extra:
        stack.enter_context(params.cmdline_override(k, v))
    return stack


def _mesh_ctx(shape="2x2", chips=4, nb_cores=2, device="cpu"):
    with _knobs(shape, chips):
        return ptt.init(nb_cores=nb_cores, device=device)


def _run_dpotrf(n, nb, shape, chips=4, device="cpu", seed=None):
    """One interpreted-runtime dpotrf; returns (L, device stats, device)."""
    with _knobs(shape, chips if shape else None):
        ctx = ptt.init(nb_cores=2, device=device)
    try:
        M = make_spd(n) if seed is None else _spd(n, seed)
        A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        ptt.ops.dpotrf(ctx, A)
        dev = ctx.device_by_type("cuda")
        return np.tril(A.to_numpy()), dict(dev.stats), dev
    finally:
        ctx.fini()


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, n)
    return (X @ X.T / n + n * np.eye(n)).astype(np.float32)


def test_mesh_device_attached_and_shaped():
    from parsec_tpu_torch.devices.cuda import CudaMeshDevice
    ctx = _mesh_ctx("2x2")
    try:
        dev = ctx.device_by_type("cuda")
        assert isinstance(dev, CudaMeshDevice)
        assert dev.mesh_shards == 4
        assert dev.grid == (2, 2)
        assert len({c.id for c in dev.chips}) == 4
        assert all(c.device == torch.device("cpu") and c.stream is None
                   for c in dev.chips)
        assert ctx.device_mesh is dev.mesh
        assert dev.mesh.shape["tp"] == 2 and dev.mesh.shape["sp"] == 2
        # the devices list holds ONLY the host + the mesh device
        assert [d.device_type for d in ctx.devices] == ["cpu", "cuda"]
        assert dev.name == "cpu:mesh2x2"
    finally:
        ctx.fini()
    ctx = ptt.init(nb_cores=1, device="cpu")
    try:
        assert ctx.device_mesh is None
    finally:
        ctx.fini()


def test_mesh_shape_parse():
    from parsec_tpu_torch.devices.cuda import parse_mesh_shape
    assert parse_mesh_shape("2x2") == (2, 2)
    assert parse_mesh_shape("4") == (1, 4)
    assert parse_mesh_shape("") == (1, 1)
    assert parse_mesh_shape("1x1") == (1, 1)
    assert parse_mesh_shape("2X3") == (2, 3)


@pytest.mark.parametrize("shape,chips", [("2x2", None), ("8x4", 4),
                                         ("3", 2)])
def test_mesh_too_few_chips_raises(shape, chips):
    """The JAX package warns and attaches one device per chip; the port
    raises, naming both knobs, and attaches nothing."""
    with pytest.raises(RuntimeError, match="device_cuda_virtual_chips") as ei:
        _mesh_ctx(shape, chips)
    assert "device_mesh_shape" in str(ei.value)


def test_mesh_one_chip_shape_is_no_mesh():
    from parsec_tpu_torch.devices.cuda import CudaMeshDevice
    ctx = _mesh_ctx("1x1", None)
    try:
        assert not isinstance(ctx.device_by_type("cuda"), CudaMeshDevice)
        assert ctx.device_mesh is None
    finally:
        ctx.fini()


def test_mesh_block_cyclic_placement():
    """Collection tiles pin to their block-cyclic mesh position and the
    resident copy stays there."""
    A = TwoDimBlockCyclic(128, 128, 32, 32, dtype=np.float32)
    ctx = _mesh_ctx("2x2")
    try:
        dev = ctx.device_by_type("cuda")
        for (m, n) in A.tiles():
            pr, pc = A.mesh_position_of(m, n, dev.grid)
            assert (pr, pc) == (m % 2, n % 2)
            assert dev._chip_of(A.data_of(m, n)) is dev.chips[pr * 2 + pc]
            assert dev._placement(A.data_of(m, n), dev.chips[3]) \
                is dev.chips[pr * 2 + pc]
    finally:
        ctx.fini()


def test_mesh_dpotrf_bit_exact_vs_single_chip():
    """The sharded mesh path is BIT-EXACT vs the single-chip batched path
    for the groups a dpotrf flushes; tiles end up resident on every
    chip."""
    L_single, st_s, _ = _run_dpotrf(256, 32, None)
    L_mesh, st_m, dev = _run_dpotrf(256, 32, "2x2")
    assert "mesh_dispatches" not in st_s
    assert st_m["mesh_dispatches"] > 0, st_m
    assert st_m["mesh_tasks"] >= 4 * st_m["mesh_dispatches"]
    assert st_m["tasks"] == dev.executed_tasks == 120
    assert st_m["mesh_moves"] > 0
    assert st_m["collective_bytes"] >= st_m["mesh_moves"] * 32 * 32 * 4
    assert all(b > 0 for b in dev.resident_bytes_per_chip())
    np.testing.assert_array_equal(L_mesh, L_single)


def test_mesh_dpotrf_matches_jax_mesh():
    """Parity: one seeded SPD matrix (n = 256, nb = 32) through the JAX
    package's 2 x 2 mesh dpotrf (8 virtual CPU devices) and the port's
    2 x 2 mesh of host chips agree within ATOL, and both mesh paths
    sharded their flush groups."""
    import parsec_tpu
    from parsec_tpu.collections import TwoDimBlockCyclic as JTwoDimBlockCyclic
    from parsec_tpu.ops import dpotrf_taskpool as jdpotrf_taskpool
    from parsec_tpu.parallel.mesh import has_shard_map
    from parsec_tpu.utils.params import params as jparams
    if not has_shard_map():
        pytest.skip("this jax build has no shard_map (the JAX package's "
                    "mesh device falls back there)")
    n, nb = 256, 32
    M = _spd(n, 11)
    with jparams.cmdline_override("device_mesh_shape", "2x2"):
        jctx = parsec_tpu.init(nb_cores=2)
    try:
        jdev = jctx.device_by_type("tpu")
        assert jdev.mesh_shards == 4
        JA = JTwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        jctx.add_taskpool(jdpotrf_taskpool(JA))
        jctx.wait()
        L_jax = np.tril(JA.to_numpy())
        assert jdev.stats["mesh_dispatches"] > 0
    finally:
        jctx.fini()
    L, st, _ = _run_dpotrf(n, nb, "2x2", seed=11)
    assert st["mesh_dispatches"] > 0
    np.testing.assert_allclose(L, L_jax, atol=ATOL)
    np.testing.assert_allclose(L @ L.T, M, atol=ATOL * n)


def _dtd_burst(shape, burst=16, nb=32):
    """A same-class DTD burst C <- C - A B^T through ops.linalg.gemm_nt as
    the CUDA chore (as tests/test_device_mesh.py's); returns (the C
    tiles, device stats, device)."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT
    from parsec_tpu_torch.ops.linalg import gemm_nt
    with _knobs(shape, 4 if shape else None):
        ctx = ptt.init(nb_cores=1, device="cpu")
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)

        def body(es, task):
            c, a, b = dtd.unpack_args(task)
            c -= a @ b.T

        boot = tp.tile_of_array(np.zeros((nb, nb), np.float32))
        tp.insert_task(body, (boot, INOUT), (boot, INPUT), (boot, INPUT))
        tp.add_chore(body, "cuda", gemm_nt, stacked=True)
        rng = np.random.RandomState(7)
        tiles = [[tp.tile_of_array(rng.rand(nb, nb).astype(np.float32))
                  for _ in range(3)] for _ in range(burst)]
        for c, a, b in tiles:
            tp.insert_task(body, (c, INOUT), (a, INPUT), (b, INPUT))
        tp.wait()
        dev = ctx.device_by_type("cuda")
        outs = [np.array(c.data.sync_to_host(ctx.devices).payload)
                for c, _a, _b in tiles]
        return outs, dict(dev.stats), dev
    finally:
        ctx.fini()


def test_mesh_dtd_burst_sharded_and_bit_exact():
    """A same-class DTD burst shards over the chips (slot-blocks, one
    stacked call a chip) and agrees bit for bit with one chip."""
    outs_s, st_s, _ = _dtd_burst(None)
    outs_m, st_m, dev = _dtd_burst("2x2")
    assert st_m["mesh_dispatches"] >= 1, st_m
    assert st_m["mesh_tasks"] >= 4 * st_m["mesh_dispatches"]
    assert st_s["batches"] >= 1
    for a, b in zip(outs_s, outs_m):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(7)
    for got in outs_m:
        c, a, b = (rng.rand(32, 32).astype(np.float32) for _ in range(3))
        np.testing.assert_allclose(got, c - a @ b.T, rtol=1e-5, atol=1e-5)


def test_mesh_sharded_dispatch_failure_raises(monkeypatch):
    """The JAX package clears ``spec.mesh_ok`` and reruns a failing
    sharded dispatch on one chip; the port raises from wait() and the
    DAG is NOT quietly finished on one chip."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.devices import batching
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT

    def boom(*a, **kw):
        raise RuntimeError("injected sharded-dispatch failure")

    monkeypatch.setattr(batching, "cached_sharded_callable", boom)
    with _knobs("2x2", 4):
        ctx = ptt.init(nb_cores=1, device="cpu")
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)

        def body(es, task):
            c, a = dtd.unpack_args(task)
            c += a

        boot = tp.tile_of_array(np.zeros((8, 8), np.float32))
        tp.insert_task(body, (boot, INOUT), (boot, INPUT))
        tp.add_chore(body, "cuda", lambda c, a: c + a)
        rng = np.random.RandomState(3)
        tiles = [[tp.tile_of_array(rng.rand(8, 8).astype(np.float32))
                  for _ in range(2)] for _ in range(8)]
        for c, a in tiles:
            tp.insert_task(body, (c, INOUT), (a, INPUT))
        with pytest.raises(RuntimeError, match="DAG aborted") as ei:
            tp.wait()
        assert "injected sharded-dispatch" in str(ei.value.__cause__)
        dev = ctx.device_by_type("cuda")
        assert dev.stats["mesh_dispatches"] == 0
        # the failed group did not run on one chip instead
        assert dev.stats["batches"] == 0
        assert dev.stats["tasks"] < 1 + len(tiles)
    finally:
        ctx.fini()


def test_mesh_group_not_dividing_chips_runs_on_one_chip():
    """The shape rule: a flush group whose size the chip count does not
    divide runs as one stacked launch on the first task's home chip,
    counted in ``batches`` but not ``mesh_dispatches``."""
    outs_m, st_m, dev = _dtd_burst("2x2", burst=2)
    outs_s, _st, _ = _dtd_burst(None, burst=2)
    assert st_m["batches"] >= 1 and st_m["mesh_dispatches"] == 0
    for a, b in zip(outs_s, outs_m):
        np.testing.assert_array_equal(a, b)


def test_mesh_local_fast_path_multirank():
    """2 SPMD rank threads on a LocalFabric, each owning a 2 x 2 mesh of
    the 8 virtual chips (ids 0-3 and 4-7), interpreted runtime:
    intra-process dependencies ship private device copies (the
    mesh-local path) and the assembled factor is bit-identical to one
    rank on one chip."""
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    from parsec_tpu_torch.utils.spmd import spmd_threads

    n, nb, R = 128, 32, 2
    M = make_spd(n)
    L_one, _st, _ = _run_dpotrf(n, nb, None)

    def rank_fn(r, fab):
        eng = RemoteDepEngine(fab.engine(r))
        with _knobs("2x2", 8):
            ctx = ptt.Context(nb_cores=1, comm=eng, device="cpu")
        try:
            dev = ctx.device_by_type("cuda")
            A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32,
                                  P=2, Q=1, nodes=R, rank=r).from_numpy(M)
            A.name = "descA"
            ctx.add_taskpool(dpotrf_taskpool(A, rank=r, nb_ranks=R))
            ctx.wait()
            owned = {c: np.array(A.data_of(*c).sync_to_host(
                ctx.devices).payload)
                for c in A.tiles() if A.rank_of(*c) == r}
            return (eng.stats["mesh_local_sends"], owned,
                    [c.id for c in dev.chips], dev.stats["mesh_dispatches"])
        finally:
            ctx.fini()

    results, _ = spmd_threads(R, rank_fn, timeout=240, fabric=LocalFabric(R))
    L = np.zeros((n, n), np.float32)
    for (_ml, owned, _ids, _md) in results:
        for (m, k), t in owned.items():
            L[m * nb:(m + 1) * nb, k * nb:(k + 1) * nb] = t
    L = np.tril(L)
    np.testing.assert_array_equal(L, L_one)
    assert sum(ml for ml, *_ in results) > 0, \
        "no activation took the mesh-local device path"
    assert results[0][2] == [0, 1, 2, 3] and results[1][2] == [4, 5, 6, 7]


def test_rank_mesh_carves_disjoint_chips():
    """The lane's chip pool gives each rank the SAME chip slice the
    device layer carves (rank * k), and each rank's mesh device owns
    disjoint chips; a pool the carving wraps keeps the pre-mesh
    layout.  (Pools split across chips are part D2c.)"""
    from parsec_tpu_torch.comm import LocalFabric, RemoteDepEngine
    from parsec_tpu_torch.dsl.ptg.wave_dist import lane_device_pool
    from parsec_tpu_torch.utils.spmd import spmd_threads
    with _knobs("2x2", 8):
        lane = lane_device_pool(2, device="cpu")
        assert [c.id for c in lane] == [0, 4]

        def rank_fn(r, fab):
            ctx = ptt.Context(nb_cores=1, device="cpu",
                              comm=RemoteDepEngine(fab.engine(r)))
            try:
                return [c.id for c in ctx.device_by_type("cuda").chips]
            finally:
                ctx.fini()

        ids, _ = spmd_threads(2, rank_fn, timeout=60, fabric=LocalFabric(2))
    assert ids[0][0] == lane[0].id and ids[1][0] == lane[1].id
    assert not set(ids[0]) & set(ids[1])
    with _knobs("2x2", 4):
        assert [c.id for c in lane_device_pool(2, device="cpu")] == [0, 1]
    with _knobs(None, 3):
        assert [c.id for c in lane_device_pool(4, device="cpu")] == \
            [0, 1, 2, 0]
    with _knobs(None, None):
        pool = lane_device_pool(2, device="cpu")
        assert [c.id for c in pool] == [0, 0]
        assert pool[0].device == torch.device("cpu")


def test_lane_group_size_follows_mesh_geometry():
    """The collective lane's default group (``xfer_group_size`` 0) is the
    rank mesh's chip count, else 2."""
    from parsec_tpu_torch.dsl.ptg.wave_dist import _CollectiveLane
    def lane():
        return _CollectiveLane("inproc", 2, 0, rendezvous=({}, {}, threading.Condition()))

    with _knobs("2x2", 8):
        assert lane()._group_size == 4
    with _knobs("1x3", 3):
        assert lane()._group_size == 3
    with _knobs("2x2", 8, extra=(("xfer_group_size", "5"),)):
        assert lane()._group_size == 5
    assert lane()._group_size == 2


def test_mesh_move_is_a_private_copy_on_the_source_chip():
    """The hop's bookkeeping, visible on host chips: a tensor resident on
    chip 0 moved to chip 1 is a private copy tagged with chip 1 (a later
    write to the source does not reach it), counted once per target and
    drained set; a hop of a hop copies again; a tensor already on its
    target, or a host array, passes through."""
    ctx = _mesh_ctx("2x2")
    try:
        dev = ctx.device_by_type("cuda")
        c0, c1, c2 = dev.chips[:3]
        src = dev._tag(torch.arange(16, dtype=torch.float32), c0)
        assert src._ptt_chip is c0
        assert dev._move(src, c0) is src
        moved = dev._move(src, c1)
        assert moved is not src and moved._ptt_chip is c1
        assert dev._move(src, c1) is moved          # memoised
        src.add_(100.0)                             # the writer goes on
        assert torch.equal(moved, torch.arange(16, dtype=torch.float32))
        again = dev._move(moved, c2)
        assert again._ptt_chip is c2 and again is not moved
        arr = np.ones(3)
        assert dev._move(arr, c1) is arr
        assert dev.stats["mesh_moves"] == 2
        assert dev.stats["collective_bytes"] == 2 * 16 * 4
        dev._dispatch_ready(None, [])               # ends the drained set
        assert not dev._move_cache
    finally:
        ctx.fini()


def _chain(device):
    """T1 writes X on chip 0; T2 on chip 1 reads X into Y (a hop); T3 on
    chip 0 rewrites X right after.  Returns (X, Y, stats)."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT
    nb = 1024 if device != "cpu" else 32
    # one launch a task, so each runs on its own home chip
    with _knobs("2x2", 4, extra=(("device_batch_max", "1"),)):
        ctx = ptt.init(nb_cores=1, device=device)
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        dev = ctx.device_by_type("cuda")

        def add1(es, task):
            x, = dtd.unpack_args(task)
            x += 1.0

        def reads(es, task):
            y, x = dtd.unpack_args(task)
            y[...] = y @ y.T / nb + x

        X = tp.tile_of_array(np.zeros((nb, nb), np.float32))   # chip 0
        Y = tp.tile_of_array(np.eye(nb, dtype=np.float32))     # chip 1
        boot = tp.tile_of_array(np.zeros((nb, nb), np.float32))
        tp.insert_task(add1, (boot, INOUT))
        tp.insert_task(reads, (boot, INOUT), (boot, INPUT))
        tp.add_chore(add1, "cuda", lambda x: x.add_(1.0))
        # a slow reader on chip 1 (several products), an in-place writer
        # on chip 0
        def slow(y, x):
            z = y
            for _ in range(8):
                z = z @ z.T / nb
            return y + x + 0.0 * z[:1, :1]
        tp.add_chore(reads, "cuda", slow)
        base = dict(dev.stats)
        tp.insert_task(add1, (X, INOUT))
        tp.insert_task(reads, (Y, INOUT), (X, INPUT))
        for _ in range(3):
            tp.insert_task(add1, (X, INOUT))
        tp.wait()
        st = {k: dev.stats[k] - base.get(k, 0) for k in
              ("mesh_moves", "tasks")}
        st["chips"] = (dev._chip_of(X.data).id, dev._chip_of(Y.data).id)
        x = np.array(X.data.sync_to_host(ctx.devices).payload)
        y = np.array(Y.data.sync_to_host(ctx.devices).payload)
        return x, y, st
    finally:
        ctx.fini()


def test_mesh_cross_chip_chain_ordering():
    """The ordering logic of a write after another chip's read: the
    reader on chip 1 sees X as T1 left it, never T3's rewrites; the one
    hop is one event the reader's chip waits for."""
    x, y, st = _chain("cpu")
    assert st["chips"] == (0, 1)
    np.testing.assert_array_equal(x, np.full_like(x, 4.0))
    np.testing.assert_allclose(y, np.eye(32) + 1.0, rtol=0, atol=1e-6)
    assert st["mesh_moves"] == 1
    assert st["tasks"] >= 5   # and the boot tasks, if they ran late


def test_mesh_hint_insertion_order():
    """Keyless DTD tiles carry their insertion order as ``mesh_hint``, so
    the mesh device round-robins them across its chips the same way on
    every run."""
    from parsec_tpu_torch import dtd
    ctx = _mesh_ctx("2x2")
    try:
        tp = dtd.taskpool_new()
        ctx.add_taskpool(tp)
        dev = ctx.device_by_type("cuda")
        tiles = [tp.tile_of_array(np.zeros(2, np.float32))
                 for _ in range(9)]
        assert [t.data.mesh_hint for t in tiles] == list(range(9))
        assert [dev._chip_of(t.data).id for t in tiles] == \
            [i % 4 for i in range(9)]
        tp2 = dtd.taskpool_new()
        assert tp2.tile_of_array(np.zeros(2)).data.mesh_hint == 0
        tp.wait()
    finally:
        ctx.fini()


def test_mesh_shards_gauge():
    from parsec_tpu_torch.obs.spans import register_device_gauges
    from parsec_tpu_torch.profiling.sde import SDERegistry
    ctx = _mesh_ctx("1x4")
    try:
        sde = SDERegistry()
        dev = ctx.device_by_type("cuda")
        register_device_gauges(sde, dev)
        assert sde.read(f"PARSEC::DEVICE::{dev.name}::MESH_SHARDS") == 4
        assert sde.read(f"PARSEC::DEVICE::{dev.name}::MESH_MOVES") == 0
    finally:
        ctx.fini()


def test_model_code_keeps_size_one_on_a_chip_mesh():
    """make_mesh lays chips out over axes, and the model runs on a mesh of
    chips: on a (tp 2, sp 2) mesh of 4 host chips the port's forward
    gives the JAX package's logits on its (tp 2, sp 2) mesh of 4 virtual
    CPU devices, and a train step runs.  Outside a shard every axis has
    size 1."""
    import dataclasses

    import jax

    from parsec_tpu import models as jmodels
    from parsec_tpu import parallel as jpar
    from parsec_tpu_torch import models, parallel
    from parsec_tpu_torch.parallel.mesh import Chip
    chips = [Chip(i, torch.device("cpu")) for i in range(4)]
    mesh = parallel.make_mesh(sizes={"tp": 2, "sp": 2}, devices=chips)
    assert mesh.shape == {"dp": 1, "pp": 1, "tp": 2, "sp": 2, "ep": 1}
    assert list(mesh.devices.flat) == chips and mesh.size == 4
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="do not cover"):
        parallel.make_mesh(sizes={"tp": 3}, devices=chips)
    assert parallel.axis_size("tp") == 1 and parallel.axis_index("sp") == 0
    cfg = models.TransformerConfig(vocab=16, d_model=16, n_heads=2,
                                   d_head=8, seq_len=8, batch=2)
    jcfg = jmodels.TransformerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})
    tokens = np.random.RandomState(5).randint(0, 16, (2, 8)).astype(np.int32)
    jmesh = jpar.make_mesh(sizes={"tp": 2, "sp": 2},
                           devices=jax.devices("cpu")[:4])
    ref = np.asarray(jax.jit(jmodels.make_forward(jcfg, jmesh))(
        jmodels.init_params(jcfg, 0), tokens))
    params = models.init_params(cfg, 0)
    got = models.make_forward(cfg, mesh)(params, tokens)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    _, _, loss = models.make_train_step(cfg, mesh)(
        params, models.adam_init(params), tokens, np.roll(tokens, -1, 1))
    assert np.isfinite(loss.item())


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_mesh_cross_chip_chain_on_card():
    """On the card: T2's slow reader on chip 1's stream and T3's in-place
    rewrites of X on chip 0's stream race; the hop copy taken on chip 0's
    stream keeps T2 on the value T1 left."""
    _card()
    x, y, st = _chain(None)
    assert st["chips"] == (0, 1)
    np.testing.assert_array_equal(x, np.full_like(x, 4.0))
    np.testing.assert_allclose(y, np.eye(1024) + 1.0, rtol=0, atol=1e-5)
    assert st["mesh_moves"] == 1


@pytest.mark.gpu
def test_mesh_dpotrf_on_card_bit_exact_and_every_chip_launches():
    _card()
    from parsec_tpu_torch.ops import kernels
    L_single, _st, _ = _run_dpotrf(1024, 128, None, device=None)
    L_mesh, st, dev = _run_dpotrf(1024, 128, "2x2", device=None)
    np.testing.assert_array_equal(L_mesh, L_single)
    assert st["mesh_dispatches"] > 0
    assert all(n > 0 for n in dev.chip_gemm_launches), dev.chip_gemm_launches
    assert len({c.stream for c in dev.chips}) == 4
    assert kernels.matmul_launches > 0


@pytest.mark.gpu
def test_mesh_over_physical_cards():
    """With no virtual chips the pool is the physical cards: a 2 x 2 mesh
    over four cards places tiles and launches on each card's chip, and
    the factor is bit-identical to one card's."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    L_single, _st, _ = _run_dpotrf(2048, 256, None, device=None)
    with _knobs("2x2"):
        ctx = ptt.init(nb_cores=2)
    try:
        dev = ctx.device_by_type("cuda")
        assert [c.device.index for c in dev.chips] == [0, 1, 2, 3]
        M = make_spd(2048)
        A = TwoDimBlockCyclic(2048, 2048, 256, 256,
                              dtype=np.float32).from_numpy(M)
        ptt.ops.dpotrf(ctx, A)
        L_mesh = np.tril(A.to_numpy())
        assert dev.stats["mesh_dispatches"] > 0
        assert all(n > 0 for n in dev.chip_gemm_launches)
    finally:
        ctx.fini()
    np.testing.assert_array_equal(L_mesh, L_single)
