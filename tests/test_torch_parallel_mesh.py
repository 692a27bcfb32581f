"""The port's parallel primitives and train step over meshes of several
chips against tests/test_parallel.py, case by case.

Each case runs the JAX function under its ``shard_map_compat`` on
conftest's virtual CPU devices and the port's under its own on a mesh of
CPU chips (one thread a shard), on the same numpy inputs, at the JAX
tests' tolerances.  The flash ring runs its kernel's plain version here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

if not hasattr(jax, "shard_map"):
    pytest.skip("jax.shard_map (VMA tracking) not available in this jax",
                allow_module_level=True)

from parsec_tpu import models as jmodels  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu_torch import models, parallel  # noqa: E402

P = parallel.spec
CPU = torch.device("cpu")
TOL = 2e-4          # test_parallel.py's bound on attention and MoE
TRAJ_TOL = 2e-3     # a loss trajectory, as test_torch_train.py holds it


def _mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return parallel.make_mesh(sizes=sizes, devices=[CPU] * n)


def _jmesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jpar.make_mesh(sizes=sizes, devices=jax.devices("cpu")[:n])


def _qkv(B=2, H=4, T=16, Dh=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(B, H, T, Dh)).astype(np.float32)
            for _ in range(3)]


SEQ = (None, None, "sp")


def _over_sp(jfn, fn, arrays, sp=4):
    """jfn under the JAX shard_map and fn under the port's, over sp."""
    ref = jpar.shard_map_compat(jfn, _jmesh(sp=sp),
                                in_specs=(JP(*SEQ),) * len(arrays),
                                out_specs=JP(*SEQ))(
        *(jnp.asarray(a) for a in arrays))
    got = parallel.shard_map_compat(fn, _mesh(sp=sp),
                                    in_specs=(P(*SEQ),) * len(arrays),
                                    out_specs=P(*SEQ))(
        *(torch.from_numpy(a) for a in arrays))
    return got, np.asarray(ref)


def test_sync_axes():
    for spec in ((("pp", None, "tp")), (), (("dp", "tp"),)):
        assert parallel.sync_axes(P(*spec)) == jpar.sync_axes(JP(*spec))
    assert parallel.sync_axes(P("pp", None, "tp")) == ("dp", "sp", "ep")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_local(causal):
    q, k, v = _qkv()
    got, ref = _over_sp(
        lambda q, k, v: jpar.ring_attention(q, k, v, "sp", causal=causal),
        lambda q, k, v: parallel.ring_attention(q, k, v, "sp",
                                                causal=causal), (q, k, v))
    local = parallel.local_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), local.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ring_attention_matches_plain_ring(causal):
    """The kernel ring (one node over the sp group; the kernel's plain
    version here) against the plain ring, forward AND gradients, and
    against the JAX package's flash ring and the single-shard
    reference."""
    q, k, v = _qkv(T=32)
    w = torch.cos(torch.arange(q.shape[-1], dtype=torch.float32))

    def run(use_kernel):
        f = parallel.shard_map_compat(
            lambda q, k, v: parallel.ring_attention(
                q, k, v, "sp", causal=causal, use_kernel=use_kernel),
            _mesh(sp=4), in_specs=(P(*SEQ),) * 3, out_specs=P(*SEQ))
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v)]
        out = f(*leaves)
        return out, torch.autograd.grad((out * w).sum(), leaves)

    out_k, g_k = run(True)
    out_p, g_p = run(False)
    np.testing.assert_allclose(out_k.detach().numpy(),
                               out_p.detach().numpy(), rtol=TOL, atol=TOL)
    for a, b in zip(g_k, g_p):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    jf = jpar.shard_map_compat(
        lambda q, k, v: jpar.ring_attention(q, k, v, "sp", causal=causal,
                                            use_pallas=True),
        _jmesh(sp=4), in_specs=(JP(*SEQ),) * 3, out_specs=JP(*SEQ))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jg = jax.grad(lambda a, b, c: (jf(a, b, c) * jnp.cos(
        jnp.arange(q.shape[-1]))).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(out_k.detach().numpy(),
                               np.asarray(jf(jq, jk, jv)), rtol=TOL,
                               atol=TOL)
    for a, b in zip(g_k, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    local = parallel.local_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)), causal=causal,
                                     use_kernel=False)
    np.testing.assert_allclose(out_k.detach().numpy(), local.numpy(),
                               rtol=TOL, atol=TOL)


def test_ulysses_matches_local():
    q, k, v = _qkv()
    got, ref = _over_sp(
        lambda q, k, v: jpar.ulysses_attention(q, k, v, "sp", causal=True),
        lambda q, k, v: parallel.ulysses_attention(q, k, v, "sp",
                                                   causal=True), (q, k, v))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_heads_to_sequence_round_trip_matches_jax():
    (x,) = _qkv(H=8, seed=5)[:1]
    got, ref = _over_sp(
        lambda a: jpar.sequence_to_heads(jpar.heads_to_sequence(a) * 2.0),
        lambda a: parallel.sequence_to_heads(
            parallel.heads_to_sequence(a) * 2.0), (x,))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), x * 2.0)


def _gpipe_inputs(S, M, mb, D, seed):
    rng = np.random.RandomState(seed)
    Ws = (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(M, mb, D)).astype(np.float32)
    return Ws, x


def test_gpipe_matches_sequential():
    """4 stages, each multiplies by its own matrix: the pipeline's result
    is the sequential composition, and the JAX package's."""
    S, M, mb, D = 4, 3, 2, 8
    Ws, x = _gpipe_inputs(S, M, mb, D, 1)
    want = x
    for s in range(S):
        want = np.einsum("mbd,dk->mbk", want, Ws[s])

    def jrun(ws, xm):
        out = jpar.gpipe(lambda w, a: jnp.einsum("bd,dk->bk", a, w[0]),
                         ws, xm, "pp")
        return jpar.last_stage_value(out, "pp")

    def run(ws, xm):
        out = parallel.gpipe(lambda w, a: a @ w[0], ws, xm, "pp")
        return parallel.last_stage_value(out, "pp")

    ref = jpar.shard_map_compat(jrun, _jmesh(pp=4),
                                in_specs=(JP("pp"), JP()),
                                out_specs=JP())(Ws, x)
    got = parallel.shard_map_compat(run, _mesh(pp=4),
                                    in_specs=(P("pp"), P()),
                                    out_specs=P())(*(torch.from_numpy(a)
                                                     for a in (Ws, x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_gpipe_gradient_flows():
    """The gradient of a 2-stage pipeline's last-stage loss with respect
    to the stage weights, against the JAX package's."""
    S, M, mb, D = 2, 2, 2, 4
    Ws, x = _gpipe_inputs(S, M, mb, D, 2)
    Ws = (Ws * np.sqrt(D)).astype(np.float32)

    def jloss(ws, xm):
        out = jpar.gpipe(lambda w, a: jnp.tanh(jnp.einsum("bd,dk->bk", a,
                                                          w[0])),
                         ws, xm, "pp")
        return jpar.last_stage_value(jnp.sum(out ** 2), "pp")

    jg = jpar.shard_map_compat(lambda ws, xm: jax.grad(jloss)(ws, xm),
                               _jmesh(pp=2), in_specs=(JP("pp"), JP()),
                               out_specs=JP("pp"))(Ws, x)

    def loss(ws, xm):
        out = parallel.gpipe(lambda w, a: torch.tanh(a @ w[0]), ws, xm, "pp")
        return parallel.last_stage_value((out ** 2).sum(), "pp")

    w = torch.from_numpy(Ws).requires_grad_(True)
    total = parallel.shard_map_compat(loss, _mesh(pp=2),
                                      in_specs=(P("pp"), P()),
                                      out_specs=P())(w, torch.from_numpy(x))
    (g,) = torch.autograd.grad(total, w)
    assert g.shape == (S, D, D) and torch.isfinite(g).all()
    assert g.abs().max() > 0
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_moe_expert_parallel_matches_single():
    rng = np.random.RandomState(3)
    B, T, D, F, E = 2, 4, 8, 16, 4
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    gate = rng.normal(size=(D, E)).astype(np.float32)
    w1 = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32)
    specs = (P(), P(), P("ep"), P("ep"))
    args = [torch.from_numpy(a) for a in (x, gate, w1, w2)]
    one = parallel.moe_ffn(*args, "ep", top_k=2)
    got = parallel.shard_map_compat(
        lambda x, g, a, b: parallel.moe_ffn(x, g, a, b, "ep", top_k=2),
        _mesh(ep=4), in_specs=specs, out_specs=P())(*args)
    ref = jpar.shard_map_compat(
        lambda x, g, a, b: jpar.moe_ffn(x, g, a, b, "ep", top_k=2),
        _jmesh(ep=4), in_specs=(JP(), JP(), JP("ep"), JP("ep")),
        out_specs=JP())(x, gate, w1, w2)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_train_step_reduces_loss():
    """The 5-axis train step on make_mesh(8) (dp 2, tp 2, sp 2: ring
    attention, MoE, two microbatches): the loss falls over 8 steps, and
    the 8 losses are the JAX package's on its make_mesh(8)."""
    jmesh = jpar.make_mesh(8)
    mesh = parallel.make_mesh(devices=[CPU] * 8)
    sz = dict(zip(jmesh.axis_names, jmesh.devices.shape))
    assert mesh.shape == sz
    cfg = models.TransformerConfig(
        vocab=32, d_model=16, n_heads=2 * sz["tp"] * sz["sp"], d_head=4,
        n_stages=sz["pp"], layers_per_stage=1, d_ff=4 * sz["tp"],
        n_experts=2 * sz["ep"], seq_len=4 * sz["sp"],
        batch=2 * sz["dp"] * 2, n_micro=2)
    jcfg = jmodels.TransformerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab,
                         size=(cfg.batch, cfg.seq_len)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    jp = jmodels.init_params(jcfg)
    js = jmodels.adam_init(jp)
    jstep = jmodels.make_train_step(jcfg, jmesh, lr=5e-3)
    params = models.init_params(cfg)
    state = models.adam_init(params)
    step = models.make_train_step(cfg, mesh, lr=5e-3)
    ref, got = [], []
    for _ in range(8):
        jp, js, jl = jstep(jp, js, tokens, labels)
        params, state, loss = step(params, state, tokens, labels)
        ref.append(float(jl))
        got.append(loss.item())
    assert all(np.isfinite(got)) and got[-1] < got[0], got
    np.testing.assert_allclose(got, ref, rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.mark.parametrize("attention", ["ring", "ulysses", "flash"])
def test_forward_over_a_mesh_matches_jax(attention):
    """make_forward on dp 2 x sp 2 (tp 2 for flash, whose sequence is
    one shard's) against the JAX package's on the same mesh."""
    sizes = dict(dp=2, tp=2) if attention == "flash" else dict(dp=2, sp=2)
    cfg = models.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                   d_head=8, layers_per_stage=2, d_ff=64,
                                   seq_len=32, batch=4, attention=attention)
    jcfg = jmodels.TransformerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"})
    tokens = np.random.RandomState(4).randint(0, 64, (4, 32)).astype(
        np.int32)
    ref = np.asarray(jax.jit(jmodels.make_forward(jcfg, _jmesh(**sizes)))(
        jmodels.init_params(jcfg, 1), tokens))
    got = models.make_forward(cfg, _mesh(**sizes))(models.init_params(cfg, 1),
                                                   tokens)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_model_mesh_checks():
    """flash over sp > 1 and remat with collectives inside the layers
    raise; a mesh whose axis does not divide a dimension raises."""
    cfg = models.TransformerConfig(vocab=16, d_model=16, n_heads=2,
                                   d_head=8, seq_len=8, batch=2,
                                   attention="flash")
    with pytest.raises(ValueError, match="sequence-parallel"):
        models.make_forward(cfg, _mesh(sp=2))
    with pytest.raises(ValueError, match="remat"):
        models.make_train_step(dataclasses.replace(cfg, remat=True),
                               _mesh(tp=2))
    models.make_train_step(dataclasses.replace(cfg, remat=True), _mesh(dp=2))
    with pytest.raises(ValueError, match="does not split"):
        models.make_forward(cfg, _mesh(tp=4))(models.init_params(cfg),
                                              np.zeros((2, 8), np.int64))
