"""The transformer's train step over four chips, dp 2 x tp 2 with flash
attention and tp 2 x sp 2 with the ring: four host chips here, four
logical chips of one card (``device_cuda_virtual_chips``) or four
physical cards on a machine that has them.

Each case runs two steps' gradients from the same state inside a worker
thread joined under a timeout (a backward that waited on a peer would
hang the card's one autograd thread), holds them bit-identical, and holds
the loss and every gradient to the one-device step on the CPU.  The card
cases are marked ``gpu`` and skip without a card; this file imports no
JAX, so it runs on the card's machine as it is.
"""
import threading
from contextlib import ExitStack

import numpy as np
import pytest
import torch

from parsec_tpu_torch import models, parallel
from parsec_tpu_torch.models import train
from parsec_tpu_torch.ops import kernels
from parsec_tpu_torch.utils.params import params as knobs

STEP_S = 300.0       # a step on any of these meshes ends well within this
TOL = 2e-3           # the one-device CPU step, summed in other orders
WHERE = ["cpu", pytest.param("card", marks=pytest.mark.gpu),
         pytest.param("cards", marks=pytest.mark.gpu)]


def _mesh(where: str, sizes: dict, stack: ExitStack):
    if where == "cpu":
        return parallel.make_mesh(sizes=sizes,
                                  devices=[torch.device("cpu")] * 4)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    if where == "cards":
        if torch.cuda.device_count() < 4:
            pytest.skip("needs four cards")
        return parallel.make_mesh(sizes=sizes, devices=[
            torch.device("cuda", i) for i in range(4)])
    stack.enter_context(knobs.cmdline_override("device_cuda_virtual_chips",
                                               "4"))
    return parallel.make_mesh(sizes=sizes)


def _within(seconds: float, fn):
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:   # handed to the test's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if err:
        raise err[0]
    return out[0]


@pytest.mark.parametrize("where", WHERE)
def test_dp2_tp2_step_is_bit_identical_and_matches_one_device(where):
    # per layer and run: each of the 4 shards' forward and backward
    _check_step(where, {"dp": 2, "tp": 2}, "flash", 4, 4)


@pytest.mark.parametrize("where", WHERE)
def test_tp2_sp2_ring_step_is_bit_identical_and_matches_one_device(where):
    """The ring's group node over sp, twice (one per tp slice): on the
    card its backward recomputes each shard's ring on that shard's chip
    (a card of its own on four cards).  Per layer and run: the stats
    kernel on 1 + 2 blocks in each sp group; the backward is the plain
    ring's."""
    _check_step(where, {"tp": 2, "sp": 2}, "ring", 2 * (1 + 2), 0)


def _check_step(where: str, sizes: dict, attention: str, stats: int,
                bwd: int) -> None:
    """Two gradients from one state within a timeout, bit-identical, the
    kernels' launches on the card, the train step, and the loss and every
    gradient against the one-device step on the CPU."""
    cfg = models.TransformerConfig(vocab=96, d_model=64, n_heads=4,
                                   d_head=16, layers_per_stage=2, d_ff=128,
                                   seq_len=64, batch=4, attention=attention)
    host = models.init_params(cfg, 1)
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 64)))
    labels = torch.roll(tokens, -1, 1)
    with ExitStack() as stack:
        mesh = _mesh(where, sizes, stack)
        dev = mesh.device
        p = models.params_to(host, dev)
        t, y = tokens.to(dev), labels.to(dev)
        before = (kernels.flash_stats_launches, kernels.flash_bwd_launches)
        runs = [_within(STEP_S, lambda: train.value_and_grad(
            cfg, p, t, y, mesh=mesh)) for _ in range(2)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (kernels.flash_stats_launches - before[0],
                    kernels.flash_bwd_launches - before[1]) == \
                (2 * cfg.n_layers * stats, 2 * cfg.n_layers * bwd)
        new, _, loss = _within(STEP_S, lambda: models.make_train_step(
            cfg, mesh, lr=1e-3)(p, models.adam_init(p), tokens, labels))
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb) and all(
        torch.equal(a, b) for a, b in zip(train.tree_leaves(ga),
                                          train.tree_leaves(gb)))
    assert torch.equal(loss, la)
    ref_loss, ref = train.value_and_grad(cfg, host, tokens, labels)
    np.testing.assert_allclose(la.item(), ref_loss.item(), rtol=TOL)
    for g, r in zip(train.tree_leaves(ga), train.tree_leaves(ref)):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=TOL,
                                   atol=TOL)
    assert all(torch.isfinite(a).all() for a in train.tree_leaves(new))


#: remat over meshes whose layers hold collectives: the tp psums with
#: flash attention, the sp ring
REMAT_MESHES = {"dp2_tp2_flash": ({"dp": 2, "tp": 2}, "flash"),
                "sp4_ring": ({"sp": 4}, "ring")}


@pytest.mark.parametrize("where", WHERE)
@pytest.mark.parametrize("case", list(REMAT_MESHES))
def test_remat_step_is_bit_identical_to_no_remat(case, where):
    """remat on a mesh with collectives inside the layers: each layer is
    one node over its (tp, sp, ep) group whose backward recomputes every
    member in its shard.  The loss, every gradient, and the train step's
    new parameters and Adam state are bit-identical to the same mesh's
    step without remat.  On the card the recompute launches each layer's
    forward kernels once more; the backward launches the same kernels."""
    import dataclasses
    sizes, attention = REMAT_MESHES[case]
    cfg = models.TransformerConfig(vocab=96, d_model=64, n_heads=4,
                                   d_head=16, layers_per_stage=2, d_ff=128,
                                   seq_len=64, batch=4, attention=attention)
    host = models.init_params(cfg, 1)
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 64)))
    labels = torch.roll(tokens, -1, 1)
    got = {}
    with ExitStack() as stack:
        mesh = _mesh(where, sizes, stack)
        dev = mesh.device
        p = models.params_to(host, dev)
        t, y = tokens.to(dev), labels.to(dev)
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            before = (kernels.flash_stats_launches,
                      kernels.flash_bwd_launches)
            lg = _within(STEP_S, lambda: train.value_and_grad(
                c, p, t, y, mesh=mesh))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = (kernels.flash_stats_launches - before[0],
                        kernels.flash_bwd_launches - before[1])
            step = _within(STEP_S, lambda: models.make_train_step(
                c, mesh, lr=1e-3)(p, models.adam_init(p), tokens, labels))
            got[remat] = (lg, step, launches)
    (la, ga), (pa, sa, sla), na = got[False]
    (lb, gb), (pb, sb, slb), nb = got[True]
    assert torch.equal(la, lb) and torch.equal(sla, slb)
    leaves = [[x for tree in trees for x in train.tree_leaves(tree)]
              for trees in ((ga, pa, sa), (gb, pb, sb))]
    assert len(leaves[0]) == len(leaves[1])
    for a, b in zip(*leaves):
        assert torch.equal(a, b)
    if where != "cpu":
        assert nb == (2 * na[0], na[1]) and na[0] > 0


@pytest.mark.parametrize("case", list(REMAT_MESHES))
def test_remat_step_matches_reference(case):
    """The remat step on the same mesh against the JAX package's
    ``remat=True`` step (``jax.checkpoint`` in each layer, inside
    ``shard_map_compat``) on conftest's CPU devices: the loss to 2e-4,
    every gradient to 1e-3 (rtol and atol), the mesh tests' tolerances.
    JAX is imported here only, so the card's cases above run without
    it."""
    import dataclasses

    import jax
    from jax.sharding import PartitionSpec as JP

    from parsec_tpu import models as jmodels
    from parsec_tpu import parallel as jpar
    from parsec_tpu.models.transformer import loss_shard as jloss_shard
    sizes, attention = REMAT_MESHES[case]
    cfg = models.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                   d_head=8, layers_per_stage=2, d_ff=64,
                                   seq_len=32, batch=4, attention=attention,
                                   remat=True)
    jcfg = jmodels.TransformerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})
    jparams = jmodels.init_params(jcfg, seed=3)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len)).astype(
        np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    jmesh = jpar.make_mesh(sizes=sizes, devices=jax.devices("cpu")[:4])
    pspecs = jmodels.param_specs(jcfg)
    fn = jpar.shard_map_compat(
        lambda p, t, y: jax.value_and_grad(
            lambda pp: jloss_shard(jcfg, pp, t, y))(p),
        jmesh, in_specs=(pspecs, JP("dp", "sp"), JP("dp", "sp")),
        out_specs=(JP(), pspecs))
    ref_loss, ref_grads = jax.jit(fn)(jparams, tokens, labels)
    params = models.params_from_numpy(jax.tree.map(np.asarray, jparams))
    mesh = parallel.make_mesh(sizes=sizes, devices=[torch.device("cpu")] * 4)
    loss, grads = _within(STEP_S, lambda: train.value_and_grad(
        cfg, params, torch.from_numpy(tokens.astype(np.int64)),
        torch.from_numpy(labels.astype(np.int64)), mesh=mesh))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-4)
    ref = jax.tree.map(np.asarray, ref_grads)
    got = train.tree_leaves(grads)
    want = train.tree_leaves(models.params_from_numpy(ref))
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-3,
                                   atol=1e-3)
