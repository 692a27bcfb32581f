"""Gradient correctness of the port's train step over meshes of several
chips, against tests/test_grad_correctness.py's three cases.

The port's sharded loss and its gradients (``value_and_grad(...,
mesh=)``: the shards' joint loss, one backward over the global leaves)
are held against the JAX package's sharded ones under its
``shard_map_compat`` on the same mesh, at the reference's tolerances
(rtol 1e-5 on the loss; rtol 5e-4, atol 5e-5 on every gradient), and
against the port's own one-device ``value_and_grad``.  The sharded
Switch aux loss is estimated per dp token block (tests/
test_grad_correctness.py ``aux_blocks``), so with experts the one-device
reference is the mean over the dp blocks of the one-device values.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

if not hasattr(jax, "shard_map"):
    pytest.skip("jax.shard_map (VMA tracking) not available in this jax",
                allow_module_level=True)

from parsec_tpu import models as jmodels  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu.models.transformer import loss_shard as jloss_shard  # noqa
from parsec_tpu_torch import models, parallel  # noqa: E402
from parsec_tpu_torch.models import train  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
CPU = torch.device("cpu")

CASES = {
    # ep is unused by a dense model, and the residual stream is
    # redundant across tp
    "dense_ep2_tp2": ({"dp": 2, "tp": 2, "ep": 2},
                      dict(n_experts=0)),
    "moe_ep2": ({"dp": 2, "tp": 2, "ep": 2},
                dict(n_experts=4, moe_top_k=2)),
    "pp2_sp2": ({"pp": 2, "sp": 2, "ep": 2},
                dict(n_experts=0, n_stages=2, layers_per_stage=1,
                     n_micro=2)),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, a in tree.items():
            out.update(_flat(a, prefix + name + "/"))
        return out
    return {prefix: np.asarray(tree)}


def _jax_sharded(jcfg, sizes, params, tokens, labels):
    n = int(np.prod(list(sizes.values())))
    mesh = jpar.make_mesh(sizes=sizes, devices=jax.devices("cpu")[:n])
    pspecs = jmodels.param_specs(jcfg)

    def shard(p, t, y):
        return jax.value_and_grad(lambda pp: jloss_shard(jcfg, pp, t, y))(p)

    fn = jpar.shard_map_compat(shard, mesh,
                               in_specs=(pspecs, JP("dp", "sp"),
                                         JP("dp", "sp")),
                               out_specs=(JP(), pspecs))
    return jax.jit(fn)(params, tokens, labels)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_grads_match_reference(case):
    sizes, extra = CASES[case]
    cfg = models.TransformerConfig(vocab=17, d_model=8, n_heads=4,
                                   d_head=4, d_ff=8, seq_len=8, batch=4,
                                   **extra)
    jcfg = jmodels.TransformerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})
    jparams = jmodels.init_params(jcfg, seed=3)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, cfg.vocab,
                         size=(cfg.batch, cfg.seq_len)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    ref_loss, ref_grads = _jax_sharded(jcfg, sizes, jparams, tokens, labels)
    ref = _flat(jax.tree.map(np.asarray, ref_grads))

    params = models.params_from_numpy(jax.tree.map(np.asarray, jparams))
    n = int(np.prod(list(sizes.values())))
    mesh = parallel.make_mesh(sizes=sizes, devices=[CPU] * n)
    t, y = (torch.from_numpy(a.astype(np.int64)) for a in (tokens, labels))
    loss, grads = train.value_and_grad(cfg, params, t, y, mesh=mesh)
    got = _flat(grads)
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=LOSS_RTOL)
    assert got and list(got) == list(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g, ref[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL,
                                   err_msg=f"gradient mismatch at {name}")

    # the port's own one-device step; with experts, the dp blocks' mean
    blocks = sizes.get("dp", 1) if cfg.n_experts else 1
    b = cfg.batch // blocks
    ones = [train.value_and_grad(cfg, params, t[i * b:(i + 1) * b],
                                 y[i * b:(i + 1) * b])
            for i in range(blocks)]
    one_loss = sum(r[0].item() for r in ones) / blocks
    one = {name: sum(_flat(r[1])[name] for r in ones) / blocks
           for name in got}
    np.testing.assert_allclose(loss.item(), one_loss, rtol=LOSS_RTOL)
    for name, g in got.items():
        np.testing.assert_allclose(g, one[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL,
                                   err_msg=f"vs one device at {name}")
