"""The port's training path (parsec_tpu_torch: the flash backward, the
ring's VJP, MoE, Adam, loss_shard and make_train_step) against the JAX
package's.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart on the CPU, where the port's kernel wrappers take
their plain versions.  The JAX side runs as its own tests run it: the
Pallas flash kernel in interpret mode, the model and the parallel
primitives under ``shard_map_compat`` on a one-device mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

pltpu = pytest.importorskip("jax.experimental.pallas.tpu",
                            reason="pallas TPU dialect not importable")
if not hasattr(jax, "shard_map"):
    pytest.skip("jax.shard_map (VMA tracking) not available in this jax",
                allow_module_level=True)

from parsec_tpu import models as jmodels  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu.models import transformer as jtr  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu_torch import models, parallel  # noqa: E402
from parsec_tpu_torch.models import train  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402

GRAD_TOL = 5e-4      # flash gradients, as tests/test_pallas.py holds them
RING_TOL = 2e-4      # the ring, as tests/test_parallel.py holds it
MOE_TOL = 2e-4       # MoE, as test_moe_expert_parallel_matches_single
ADAM_TOL = 1e-6      # one elementwise update in fp32
LOSS_RTOL = 1e-5     # as tests/test_grad_correctness.py holds the loss
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5    # ... and the gradients
TRAJ_TOL = 2e-3      # a 3-step trajectory, as test_parallel.py holds it

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_head=8, layers_per_stage=2,
             d_ff=64, seq_len=32, batch=2)


def _jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    return jmodels.TransformerConfig(**fields)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, a in tree.items():
            out.update(_flat(a, prefix + name + "/"))
        return out
    return {prefix: np.asarray(tree)}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab,
                         (cfg.batch, cfg.seq_len)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


# ---------------------------------------------------------------------- #
# the flash backward                                                     #
# ---------------------------------------------------------------------- #
FLASH_CASES = [(64, 64, True), (64, 64, False), (32, 48, True),
               (48, 32, True), (32, 48, False)]


def _flash_inputs(T, Tk, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(1, 2, T, 8) * 0.5).astype(np.float32)
    k, v = ((rng.randn(1, 2, Tk, 8) * 0.5).astype(np.float32)
            for _ in range(2))
    g = rng.randn(1, 2, T, 8).astype(np.float32)
    return q, k, v, g


def _pallas_vjp(q, k, v, g, causal):
    _, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, causal=causal, block_q=16, block_k=16), q, k, v)
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("T,Tk,causal", FLASH_CASES)
def test_flash_bwd_plain_matches_pallas_vjp(T, Tk, causal):
    q, k, v, g = _flash_inputs(T, Tk, seed=T + Tk)
    ref = _pallas_vjp(q, k, v, g, causal)
    o, m, l = kernels.flash_attention_stats_plain(*_t(q, k, v),
                                                  causal=causal)
    got = kernels.flash_attention_bwd_plain(*_t(q, k, v), o, m, l,
                                            *_t(g), causal=causal,
                                            block_k=16)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("T,Tk,causal", FLASH_CASES)
def test_flash_autograd_matches_pallas_vjp(T, Tk, causal):
    """Autograd through the port's flash_attention (its Function: the
    stats forward, the backward wrapper) against jax.vjp of the Pallas
    kernel; the launch counters stay put on the CPU."""
    q, k, v, g = _flash_inputs(T, Tk, seed=3 * T + Tk)
    ref = _pallas_vjp(q, k, v, g, causal)
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    before = (kernels.flash_launches, kernels.flash_stats_launches,
              kernels.flash_bwd_launches)
    out = kernels.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), *_t(g))
    assert (kernels.flash_launches, kernels.flash_stats_launches,
            kernels.flash_bwd_launches) == before
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_flash_bwd_takes_a_strided_cotangent_and_checks_shapes():
    """The cotangent of a transposed output is made contiguous by the
    Function; the backward wrapper refuses nonconforming operands."""
    q, k, v, g = _t(*_flash_inputs(32, 32, seed=9))
    q.requires_grad_(True)
    out = kernels.flash_attention(q, k, v)
    (dq_strided,) = torch.autograd.grad(out.transpose(1, 2), q,
                                        g.transpose(1, 2))
    (dq,) = torch.autograd.grad(kernels.flash_attention(q, k, v), q, g)
    assert torch.equal(dq_strided, dq)
    o, m, l = kernels.flash_attention_stats_plain(q.detach(), k, v, True)
    with pytest.raises(ValueError, match="m"):
        kernels.flash_attention_bwd(q, k, v, o, m[..., 1:], l, g)
    with pytest.raises(ValueError, match="do"):
        kernels.flash_attention_bwd(q, k, v, o, m, l, g[..., 1:, :])


# ---------------------------------------------------------------------- #
# the ring's VJP                                                         #
# ---------------------------------------------------------------------- #
def _sp1_vjp(fn):
    """The VJP of fn(q, k, v) on a one-device sp mesh."""
    mesh = jpar.make_mesh(sizes={"sp": 1}, devices=jax.devices("cpu")[:1])
    spec = P(None, None, "sp")

    def vjp(q, k, v, g):
        return jax.vjp(fn, q, k, v)[1](g)

    return jax.jit(jpar.shard_map_compat(vjp, mesh, in_specs=(spec,) * 4,
                                         out_specs=(spec,) * 3))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_vjp_matches_jax(use_kernel, causal):
    rng = np.random.RandomState(4)
    q, k, v, g = (rng.normal(size=(2, 4, 32, 8)).astype(np.float32)
                  for _ in range(4))
    ref = _sp1_vjp(lambda q, k, v: jpar.ring_attention(
        q, k, v, "sp", causal=causal, use_pallas=use_kernel))(
            *(jnp.asarray(x) for x in (q, k, v, g)))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = parallel.ring_attention(tq, tk, tv, "sp", causal=causal,
                                  use_kernel=use_kernel)
    got = torch.autograd.grad(out, (tq, tk, tv), *_t(g))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RING_TOL,
                                   atol=RING_TOL)


# ---------------------------------------------------------------------- #
# MoE and the pipeline                                                   #
# ---------------------------------------------------------------------- #
def _moe_inputs(seed=3, E=4):
    rng = np.random.RandomState(seed)
    B, T, D, F = 2, 4, 8, 16
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    gate = rng.normal(size=(D, E)).astype(np.float32)
    w1 = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32)
    g = rng.normal(size=(B, T, D)).astype(np.float32)
    return x, gate, w1, w2, g


def _ep1(fn, in_specs, out_specs):
    mesh = jpar.make_mesh(sizes={"ep": 1}, devices=jax.devices("cpu")[:1])
    return jax.jit(jpar.shard_map_compat(fn, mesh, in_specs=in_specs,
                                         out_specs=out_specs))


@pytest.mark.parametrize("top_k,E", [(2, 4), (1, 4), (4, 4)])
@pytest.mark.parametrize("shared_logits", [False, True])
def test_moe_ffn_matches_jax(top_k, E, shared_logits):
    """Values and the gradients of x, gate, w1 and w2 on a one-device ep
    mesh; with shared_logits the gate logits come in precomputed, as the
    model passes them."""
    x, gate, w1, w2, g = _moe_inputs(E=E)

    def jfn(x, gate, w1, w2):
        gl = jnp.einsum("btd,de->bte", x, gate) if shared_logits else None
        return jpar.moe_ffn(x, gate, w1, w2, "ep", top_k=top_k,
                            gate_logits=gl)

    def jvjp(x, gate, w1, w2, g):
        out, vjp = jax.vjp(jfn, x, gate, w1, w2)
        return (out, *vjp(g))

    ref = _ep1(jvjp, (P(), P(), P("ep"), P("ep"), P()),
               (P(), P(), P(), P("ep"), P("ep")))(
        *(jnp.asarray(a) for a in (x, gate, w1, w2, g)))
    tx, tgate, tw1, tw2 = (a.requires_grad_(True)
                           for a in _t(x, gate, w1, w2))
    gl = torch.einsum("btd,de->bte", tx, tgate) if shared_logits else None
    out = parallel.moe_ffn(tx, tgate, tw1, tw2, "ep", top_k=top_k,
                           gate_logits=gl)
    got = (out, *torch.autograd.grad(out, (tx, tgate, tw1, tw2), *_t(g)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=MOE_TOL, atol=MOE_TOL)


def test_load_balance_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.normal(size=(2, 6, 4)).astype(np.float32)
    logits[0, 0] = [1.0, 3.0, 3.0, 0.0]       # a tie: the first index wins
    ref, ref_grad = jax.value_and_grad(jpar.load_balance_loss)(
        jnp.asarray(logits))
    (tl,) = _t(logits)
    tl.requires_grad_(True)
    got = parallel.load_balance_loss(tl)
    (grad,) = torch.autograd.grad(got, tl)
    np.testing.assert_allclose(got.item(), float(ref), rtol=MOE_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                               rtol=MOE_TOL, atol=MOE_TOL)
    assert parallel.load_balance_loss(torch.tensor(
        [[1.0, 3.0, 3.0, 0.0]])).item() == pytest.approx(
        float(jpar.load_balance_loss(jnp.asarray([[1.0, 3.0, 3.0, 0.0]]))))


def test_gpipe_with_aux_matches_jax():
    """gpipe(with_aux=True) at pp = 1: outputs and the aux summed over the
    microbatches, and the gradient flows to the stage parameters."""
    rng = np.random.RandomState(2)
    w = rng.normal(size=(1, 4, 4)).astype(np.float32)
    x = rng.normal(size=(3, 2, 4)).astype(np.float32)

    def jstage(w, a):
        y = jnp.tanh(jnp.einsum("bd,dk->bk", a, w[0]))
        return y, jnp.sum(y ** 2)

    def jloss(w, xm):
        out, aux = jpar.gpipe(jstage, w, xm, "pp", with_aux=True)
        return jpar.last_stage_value(jnp.sum(out) + aux, "pp")

    mesh = jpar.make_mesh(sizes={"pp": 1}, devices=jax.devices("cpu")[:1])
    ref_loss, ref_grad = jax.jit(jpar.shard_map_compat(
        jax.value_and_grad(jloss), mesh, in_specs=(P("pp"), P()),
        out_specs=(P(), P("pp"))))(jnp.asarray(w), jnp.asarray(x))
    tw, tx = _t(w, x)
    tw.requires_grad_(True)

    def stage(w, a):
        y = torch.tanh(a @ w[0])
        return y, (y ** 2).sum()

    out, aux = parallel.gpipe(stage, tw, tx, "pp", with_aux=True)
    assert out.shape == x.shape
    loss = out.sum() + aux
    (grad,) = torch.autograd.grad(loss, tw)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------- #
# Adam                                                                   #
# ---------------------------------------------------------------------- #
def test_adam_update_matches_jax():
    rng = np.random.RandomState(6)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 2)}}
    params, grads, mu, nu = (jax.tree.map(
        lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
        for scale in (1.0, 0.1, 0.01, 0.001))
    nu = jax.tree.map(np.abs, nu)
    state = {"mu": mu, "nu": nu, "count": np.int32(4)}
    ref_p, ref_s = params, state
    got_p = models.params_from_numpy(params)
    got_s = models.params_from_numpy(state)
    assert got_s["count"].dtype == torch.int32 and got_s["count"].dim() == 0
    for _ in range(2):
        ref_p, ref_s = jmodels.adam_update(ref_p, grads, ref_s, lr=3e-3)
        got_p, got_s = models.adam_update(
            got_p, models.params_from_numpy(grads), got_s, lr=3e-3)
    assert int(got_s["count"]) == int(ref_s["count"]) == 6
    assert got_s["count"].dtype == torch.int32
    for ref, got in ((ref_p, got_p), (ref_s["mu"], got_s["mu"]),
                     (ref_s["nu"], got_s["nu"])):
        r, g = _flat(_numpy_tree(ref)), _flat(got)
        assert r.keys() == g.keys()
        for name in r:
            np.testing.assert_allclose(g[name], r[name], rtol=ADAM_TOL,
                                       atol=ADAM_TOL, err_msg=name)


def test_adam_init_and_specs_match_jax():
    cfg = models.TransformerConfig(**SMALL, n_experts=2)
    params = models.init_params(cfg)
    state = models.adam_init(params)
    ref = jmodels.adam_init(jmodels.init_params(_jax_cfg(cfg)))
    assert _flat(state).keys() == _flat(_numpy_tree(ref)).keys()
    assert all(not a.any() for a in _flat(state).values())
    assert state["count"].dtype == torch.int32
    specs = models.opt_state_specs(models.param_specs(cfg))
    jspecs = jmodels.opt_state_specs(jmodels.param_specs(_jax_cfg(cfg)))
    assert specs["count"] == tuple(jspecs["count"])
    assert specs["mu"] == specs["nu"] == models.param_specs(cfg)


# ---------------------------------------------------------------------- #
# parameters                                                             #
# ---------------------------------------------------------------------- #
def _spec_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, P))


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_and_specs_equal_jax(n_experts, seed):
    cfg = models.TransformerConfig(**{**SMALL, "layers_per_stage": 1},
                                   n_experts=n_experts, n_stages=2)
    ref = _flat(jmodels.init_params(_jax_cfg(cfg), seed))
    got = _flat(models.init_params(cfg, seed))
    assert list(got) == list(ref)           # the same leaves, in order
    for name, a in got.items():
        assert a.dtype == ref[name].dtype and a.shape == ref[name].shape
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    assert models.param_specs(cfg) == _spec_tuples(
        jmodels.param_specs(_jax_cfg(cfg)))


def test_shard_params_places_the_tree_on_the_mesh():
    cfg = models.TransformerConfig(**SMALL)
    params = models.init_params(cfg)
    mesh = parallel.make_mesh(devices=["cpu"])
    placed = models.shard_params(params, mesh, models.param_specs(cfg))
    assert all(placed["stages"][n] is params["stages"][n]
               for n in params["stages"])


# ---------------------------------------------------------------------- #
# loss and gradients                                                     #
# ---------------------------------------------------------------------- #
def _jax_value_and_grad(cfg, params, tokens, labels):
    jcfg = _jax_cfg(cfg)
    pspecs = jmodels.param_specs(jcfg)

    def shard(p, t, y):
        return jax.value_and_grad(lambda pp: jtr.loss_shard(jcfg, pp, t,
                                                            y))(p)

    fn = jpar.shard_map_compat(shard, jpar.make_mesh(1),
                               in_specs=(pspecs, P("dp", "sp"),
                                         P("dp", "sp")),
                               out_specs=(P(), pspecs))
    return jax.jit(fn)(params, tokens, labels)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("attention", ["ring", "flash", "local", "ulysses"])
def test_loss_and_grads_match_jax(attention, n_experts, n_micro, remat):
    cfg = models.TransformerConfig(**SMALL, attention=attention,
                                   n_experts=n_experts, n_micro=n_micro,
                                   remat=remat)
    tokens, labels = _batch(cfg, seed=7)
    jparams = jmodels.init_params(_jax_cfg(cfg), 3)
    ref_loss, ref_grads = _jax_value_and_grad(cfg, jparams, tokens, labels)
    params = models.params_from_numpy(_numpy_tree(jparams))
    loss, grads = train.value_and_grad(cfg, params, *_t(tokens.astype(
        np.int64), labels.astype(np.int64)))
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=LOSS_RTOL)
    ref, got = _flat(_numpy_tree(ref_grads)), _flat(grads)
    assert list(got) == list(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g, ref[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_remat_gives_the_same_gradients():
    """remat recomputes the same layer arithmetic: bit-equal on the CPU."""
    cfg = models.TransformerConfig(**SMALL, attention="flash", n_experts=4)
    params = models.init_params(cfg, 1)
    tokens, labels = _t(*(a.astype(np.int64) for a in _batch(cfg, 2)))
    a = train.value_and_grad(cfg, params, tokens, labels)
    b = train.value_and_grad(dataclasses.replace(cfg, remat=True), params,
                             tokens, labels)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(
        train.tree_leaves(a[1]), train.tree_leaves(b[1])))
    assert all(p.grad is None for p in train.tree_leaves(params))


# ---------------------------------------------------------------------- #
# the train step                                                         #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("attention,n_experts", [("flash", 0), ("ring", 4)])
def test_train_trajectory_matches_jax(attention, n_experts):
    """Three steps from the same carried-over state (parameters and Adam
    moments after one JAX step) give the JAX step's losses and
    parameters."""
    cfg = models.TransformerConfig(**SMALL, attention=attention,
                                   n_experts=n_experts)
    jcfg = _jax_cfg(cfg)
    tokens, labels = _batch(cfg, seed=1)
    jstep = jmodels.make_train_step(jcfg, jpar.make_mesh(1), lr=5e-3)
    jp, js = jmodels.init_params(jcfg, 2), None
    js = jmodels.adam_init(jp)
    jp, js, _ = jstep(jp, js, tokens, labels)
    params = models.params_from_numpy(_numpy_tree(jp))
    state = models.params_from_numpy(_numpy_tree(js))
    step = models.make_train_step(cfg, lr=5e-3, device="cpu")
    ref, got = [], []
    for _ in range(3):
        jp, js, jl = jstep(jp, js, tokens, labels)
        params, state, loss = step(params, state, tokens, labels)
        ref.append(float(jl))
        got.append(loss.item())
    np.testing.assert_allclose(got, ref, rtol=TRAJ_TOL, atol=TRAJ_TOL)
    assert int(state["count"]) == int(js["count"]) == 4
    r, g = _flat(_numpy_tree(jp)), _flat(params)
    for name in r:
        np.testing.assert_allclose(g[name], r[name], rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=name)


def test_train_step_reduces_loss_with_experts():
    """The port's counterpart of test_parallel.py's
    test_train_step_reduces_loss at size 1: experts on, two microbatches,
    eight steps."""
    cfg = models.TransformerConfig(vocab=32, d_model=16, n_heads=2,
                                   d_head=4, d_ff=4, n_experts=2,
                                   seq_len=4, batch=4, n_micro=2)
    params = models.init_params(cfg)
    state = models.adam_init(params)
    step = models.make_train_step(cfg, lr=5e-3, device="cpu")
    tokens, labels = _batch(cfg, seed=0)
    losses = []
    for _ in range(8):
        params, state, loss = step(params, state, tokens, labels)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_train_step_is_functional_and_checks_inputs():
    cfg = models.TransformerConfig(**SMALL, attention="flash")
    params = models.init_params(cfg)
    before = _flat(params)
    state = models.adam_init(params)
    step = models.make_train_step(cfg, device="cpu")
    tokens, labels = _batch(cfg)
    new_params, new_state, loss = step(params, state, tokens, labels)
    assert loss.dim() == 0 and not loss.requires_grad
    assert all(np.array_equal(a, before[n]) for n, a in _flat(params).items())
    assert int(state["count"]) == 0 and int(new_state["count"]) == 1
    assert not any(t.requires_grad for t in train.tree_leaves(new_params))
    with pytest.raises(ValueError, match="labels"):
        step(params, state, tokens, np.full_like(labels, cfg.vocab))
    with pytest.raises(RuntimeError, match="inference_mode"):
        with torch.inference_mode():
            step(params, state, tokens, labels)
    with pytest.raises(ValueError, match="moe_top_k"):
        models.make_train_step(dataclasses.replace(cfg, n_experts=2,
                                                   moe_top_k=0),
                               device="cpu")


def test_train_step_takes_inference_tensors():
    """Parameters made under inference_mode (a served model's) enter the
    step as fresh leaves."""
    cfg = models.TransformerConfig(**SMALL)
    with torch.inference_mode():
        params = models.params_to(models.init_params(cfg), "cpu")
        params = {**params, "ln_f": params["ln_f"] * 1.0}
    step = models.make_train_step(cfg, device="cpu")
    tokens, labels = _batch(cfg)
    _p, _s, loss = step(params, models.adam_init(params), tokens, labels)
    assert np.isfinite(loss.item())


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("attention,remat,counts", [
    ("flash", False, (0, 2, 2)), ("flash", True, (0, 4, 2)),
    ("ring", False, (0, 2, 0))])
def test_train_step_on_card_matches_cpu(cuda_device, attention, remat,
                                        counts):
    """Two steps on the card against the CPU port: the losses and the
    parameters within the trajectory tolerance, and the kernels'
    launches (forward, stats instance, backward) per step exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = models.TransformerConfig(**SMALL, attention=attention,
                                   remat=remat)
    tokens, labels = _batch(cfg, seed=3)
    params = models.init_params(cfg, 4)
    results = {}
    for dev in ("cpu", None):
        step = models.make_train_step(cfg, device=dev)
        p, s = params, models.adam_init(params)
        losses = []
        for _ in range(2):
            before = (kernels.flash_launches, kernels.flash_stats_launches,
                      kernels.flash_bwd_launches)
            p, s, loss = step(p, s, tokens, labels)
            losses.append(loss.item())
            after = (kernels.flash_launches, kernels.flash_stats_launches,
                     kernels.flash_bwd_launches)
            want = (0, 0, 0) if dev == "cpu" else counts
            assert tuple(a - b for a, b in zip(after, before)) == want
        results[dev] = (losses, _flat(models.params_to(p, "cpu")))
    np.testing.assert_allclose(results[None][0], results["cpu"][0],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    for name, a in results[None][1].items():
        np.testing.assert_allclose(a, results["cpu"][1][name],
                                   rtol=TRAJ_TOL, atol=TRAJ_TOL,
                                   err_msg=name)


def test_make_train_step_without_card_raises(monkeypatch):
    """No CUDA and no device="cpu": the step refuses instead of falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.make_train_step(models.TransformerConfig(**SMALL))
