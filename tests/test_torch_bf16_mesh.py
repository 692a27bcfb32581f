"""The port's transformer at bf16 over the model's mesh against the JAX
package's bf16 mesh: dp 2 x tp 2 with flash attention, sp 4 with the
ring and with Ulysses, pp 2 (GPipe, two microbatches), tp 2 x ep 2 with
experts (4, top 2), and remat on and off on dp 2 x tp 2 and sp 4.

Both sides take the same config at the tiny ``SMALL`` widths of
``test_torch_bf16.py`` (batch 4), the same ``init_params`` tree at bf16
and the same token ids.  The JAX package runs on conftest's virtual CPU
devices, jit-compiled as its own tests run it; the port on four host
chips (a thread a shard, ``parallel/shard_map.py``), where its kernels
take their plain versions.  The ``gpu``-marked ``card`` and ``cards``
variants run the port's side of the same cases on four logical chips of
one card (``device_cuda_virtual_chips``) or on four cards, against the
same JAX side on the CPU.

What the tolerances count.  Each bf16 rounding may put the two packages
a unit of 2^-8 apart at the largest entry, since they sum the same
exact products in other orders:
- a psum adds the shards' bf16 partials in fp32 and rounds once, as
  XLA's all-reduce does (``test_bf16_collectives_match_jax``: bit for
  bit); so a tp 2 sum rounds twice (each partial, then the sum) where
  one chip rounds once, and an sp 4, dp 2 or replica sum once more;
- the logits end two layers of four roundings each, and the last
  place differences of one layer grow through the next: within
  ``LOGITS_RTOL`` (5e-2) of the JAX mesh's;
- one layer's VJP ends about ten roundings in a row (the products'
  cotangents, GELU's and RMSNorm's, the residual adds, dq, dk, dv; then
  its psum over the shards): ``LAYER_GRAD_RTOL``, ten units of 2^-8;
  a gradient of the whole model ends both layers' backward, whose last
  place differences grow through the layer below as the logits' do:
  ``GRAD_RTOL``, the 5e-2 that ``test_torch_bf16.py`` holds the one
  device packages' whole-depth gradients to (through Adam's first
  moment, ``MOMENT_RTOL``);
- the loss is an fp32 mean of fp32 cross-entropies: ``LOSS_RTOL``.

Experts.  The top-k gate is discontinuous: where a token's k-th and
(k+1)-th gate probabilities lie within ``FRAGILE_ULPS`` ulps of each
other, a rounding of the layer's input may hand the token to another
expert, on either package's side, and its output then differs by O(1).
The gate is held from one input: its logits within an ulp of JAX's,
its probabilities bit for bit on the same logits, and every token that
keeps other experts fragile.  The MoE layers, whose gate inputs the two
packages round apart, are held token by token on the tokens both route
to the same experts and that are not fragile (``MOE_LAYER_RTOL``: the
gate's roundings come between the dense layer's), and their gradients
by layer with the other tokens' cotangents zeroed.  The
JAX package's second bf16 MoE step raises (its ``lax.scan`` carry turns
fp32), so the MoE step is held at step 1 only, and the port's step 2 to
the dense path's dtypes and a falling loss.
"""
import dataclasses
import functools
import importlib
import threading
from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from parsec_tpu import models as jmodels  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu.models import transformer as jtr  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu.parallel import moe as jmoe  # noqa: E402
from parsec_tpu_torch import models, parallel  # noqa: E402
from parsec_tpu_torch.models import train, transformer  # noqa: E402
from parsec_tpu_torch.parallel import moe  # noqa: E402
from parsec_tpu_torch.parallel import shard_map as sm  # noqa: E402
from parsec_tpu_torch.utils.params import params as knobs  # noqa: E402
from test_torch_bf16 import (  # noqa: E402
    BF16, BF16_RTOL, LOGITS_RTOL, LOSS_RTOL, LR, MOMENT_RTOL, PARAM_ATOL,
    PARAM_SHARE, SMALL, _dtype_name, _f32, _flat, _jax_cfg, _rel)

#: one layer's VJP, every gradient, relative max error: ten roundings
#: in a row
LAYER_GRAD_RTOL = 10 * 2 ** -8
#: every gradient of the whole model: both layers' backward
GRAD_RTOL = MOMENT_RTOL["mu"]
#: a MoE layer's output from the same input, token by token: about ten
#: roundings in a row too (the dense layer's four, and between them the
#: gate's logits, exp, sum, quotient and renormalisation)
MOE_LAYER_RTOL = LAYER_GRAD_RTOL
#: a token is fragile when its k-th and (k+1)-th gate probabilities lie
#: within this many ulps of the k-th: one ulp of a logit moves its exp
#: by about two ulps, so the gap between two probabilities by up to four,
#: and logits an ulp apart may then send it to other experts
FRAGILE_ULPS = 4
STEP_S = 300.0       # a call on any of these meshes ends well within this

MESHES = {
    "dp2_tp2_flash": ({"dp": 2, "tp": 2}, dict(attention="flash")),
    "dp2_tp2_flash_remat": ({"dp": 2, "tp": 2},
                            dict(attention="flash", remat=True)),
    "sp4_ring": ({"sp": 4}, dict(attention="ring")),
    "sp4_ring_remat": ({"sp": 4}, dict(attention="ring", remat=True)),
    "sp4_ulysses": ({"sp": 4}, dict(attention="ulysses")),
    "pp2_flash": ({"pp": 2}, dict(attention="flash", n_stages=2,
                                  layers_per_stage=1, n_micro=2)),
    "tp2_ep2_moe": ({"tp": 2, "ep": 2},
                    dict(attention="flash", n_experts=4, moe_top_k=2)),
}
DENSE = [c for c, (_, ch) in MESHES.items() if not ch.get("n_experts")]
FORWARDS = [c for c in DENSE if "remat" not in c]
WHERE = ["cpu", pytest.param("card", marks=pytest.mark.gpu),
         pytest.param("cards", marks=pytest.mark.gpu)]


@pytest.fixture(params=WHERE)
def where(request):
    """Where the port's side runs: host chips, four logical chips of one
    card, or four cards; a card case skips where there is none."""
    if request.param != "cpu":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")
        if request.param == "cards" and torch.cuda.device_count() < 4:
            pytest.skip("needs four cards")
        _jax_through_pallas(request.getfixturevalue("monkeypatch"))
    return request.param


def _jax_through_pallas(mp):
    """The JAX package's ring and Ulysses attention through its Pallas
    kernels (interpret mode), as the port's run on a card: those round p
    to bf16 before P·V, and the JAX package takes them only for
    128-aligned shards on a TPU (at these widths its ring and local
    attention take the jnp path, which does not round p)."""
    jring = importlib.import_module("parsec_tpu.parallel.ring_attention")
    jseq = importlib.import_module("parsec_tpu.parallel.sequence")
    mp.setattr(jtr, "ring_attention",
               functools.partial(jring.ring_attention, use_pallas=True))
    mp.setattr(jseq, "local_attention",
               lambda q, k, v, causal=True: pk.flash_attention(
                   q, k, v, causal=causal))


# ---------------------------------------------------------------------- #
# the two meshes and the JAX side                                        #
# ---------------------------------------------------------------------- #
def _config(case: str):
    sizes, changes = MESHES[case]
    cfg = models.TransformerConfig(**{**SMALL, "batch": 4, **changes},
                                   dtype=BF16)
    return sizes, cfg, _jax_cfg(cfg)


def _data(cfg):
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_mesh(sizes: dict):
    n = int(np.prod(list(sizes.values())))
    return jpar.make_mesh(sizes=sizes, devices=jax.devices("cpu")[:n])


def _port_mesh(where: str, sizes: dict, stack: ExitStack):
    """The port's mesh: host chips, logical chips of one card, or cards."""
    n = int(np.prod(list(sizes.values())))
    if where == "cpu":
        return parallel.make_mesh(sizes=sizes,
                                  devices=[torch.device("cpu")] * n)
    torch.backends.cuda.matmul.allow_tf32 = False
    if where == "cards":
        return parallel.make_mesh(sizes=sizes, devices=[
            torch.device("cuda", i) for i in range(n)])
    stack.enter_context(knobs.cmdline_override("device_cuda_virtual_chips",
                                               "4"))
    return parallel.make_mesh(sizes=sizes)


def _within(fn):
    """``fn()`` on a thread joined under STEP_S (a backward that waited
    on a peer would hang the card's autograd thread)."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:   # handed to the test's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(STEP_S)
    assert not t.is_alive(), f"did not finish within {STEP_S} s"
    if err:
        raise err[0]
    return out[0]


def _host(tree):
    """A tree of tensors (any device) as CPU tensors."""
    return train.tree_map(lambda t: t.detach().cpu(), tree)


def _jax_value_and_grad(jcfg, jmesh, jparams, tokens, labels):
    pspecs = jmodels.param_specs(jcfg)
    fn = jpar.shard_map_compat(
        lambda p, t, y: jax.value_and_grad(
            lambda q: jtr.loss_shard(jcfg, q, t, y))(p),
        jmesh, in_specs=(pspecs, JP("dp", "sp"), JP("dp", "sp")),
        out_specs=(JP(), pspecs))
    return jax.jit(fn)(jparams, tokens, labels)


def _same(a, b) -> bool:
    """Two trees of tensors bit-identical, leaf by leaf."""
    la, lb = train.tree_leaves(a), train.tree_leaves(b)
    return len(la) == len(lb) and all(map(torch.equal, la, lb))


# ---------------------------------------------------------------------- #
# the collectives on bf16 operands                                       #
# ---------------------------------------------------------------------- #
COLLECTIVES = {
    "psum_sp4": ({"sp": 4}, lambda x: sm.psum(x, "sp"),
                 lambda x: jax.lax.psum(x, "sp")),
    "psum_dp2_tp2": ({"dp": 2, "tp": 2}, lambda x: sm.psum(x, ("dp", "tp")),
                     lambda x: jax.lax.psum(x, ("dp", "tp"))),
    "all_to_all_sp4": ({"sp": 4},
                       lambda x: sm.all_to_all(x, "sp", 1, 0),
                       lambda x: jax.lax.all_to_all(x, "sp", 1, 0,
                                                    tiled=True)),
    "ppermute_sp4": ({"sp": 4},
                     lambda x: sm.ppermute(x, "sp", [(0, 1), (1, 2), (2, 3),
                                                     (3, 0)]),
                     lambda x: jax.lax.ppermute(x, "sp", [(0, 1), (1, 2),
                                                          (2, 3), (3, 0)])),
}


@pytest.mark.parametrize("op", list(COLLECTIVES))
def test_bf16_collectives_match_jax(op):
    """psum, all_to_all and ppermute on bf16 operands over four shards,
    bit for bit the JAX package's lax collectives on conftest's devices:
    a psum sums the bf16 partials in fp32 and rounds once, as XLA does
    (summing them in bf16 add by add rounds each add, and a third of an
    sp 4 sum's entries then differ)."""
    sizes, port_fn, jax_fn = COLLECTIVES[op]
    axes = tuple(sizes)
    rng = np.random.RandomState(len(op))
    x = rng.randn(8 * 4, 4 * 16).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = jax.jit(jpar.shard_map_compat(
        jax_fn, _jax_mesh(sizes), in_specs=JP(axes),
        out_specs=JP(axes)))(xj)
    mesh = parallel.make_mesh(sizes=sizes,
                              devices=[torch.device("cpu")] * 4)
    got = parallel.shard_map_compat(
        port_fn, mesh, in_specs=parallel.spec(axes),
        out_specs=parallel.spec(axes))(
            torch.from_numpy(np.asarray(xj).astype(np.float32)).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_f32(got), _f32(ref))


def test_bf16_replicated_gradient_sums_once_as_jax():
    """The gradient of a bf16 leaf replicated over four shards is the sum
    of its shards' cotangents in fp32, rounded once, as the JAX package's
    psum of them under shard_map: bit for bit.  Each shard holds one row
    of x, so its cotangent of w is that row, exactly."""
    rng = np.random.RandomState(3)
    wj, xj = (jnp.asarray(rng.randn(*s).astype(np.float32), jnp.bfloat16)
              for s in ((256,), (4, 256)))
    sizes = {"dp": 2, "sp": 2}

    def jloss(w, x):
        return jax.lax.psum((x * w).astype(jnp.float32).sum(), ("dp", "sp"))

    ref = jax.jit(jpar.shard_map_compat(
        lambda w, x: jax.grad(jloss)(w, x), _jax_mesh(sizes),
        in_specs=(JP(), JP(("dp", "sp"))), out_specs=JP()))(wj, xj)
    w, x = (torch.from_numpy(np.asarray(a).astype(np.float32)).to(BF16)
            for a in (wj, xj))
    w.requires_grad_(True)
    mesh = parallel.make_mesh(sizes=sizes,
                              devices=[torch.device("cpu")] * 4)
    loss = parallel.shard_map_compat(
        lambda w, x: sm.psum((x * w).float().sum(), ("dp", "sp")), mesh,
        in_specs=(parallel.spec(), parallel.spec(("dp", "sp"))),
        out_specs=parallel.spec())(w, x)
    got, = torch.autograd.grad(loss, [w])
    assert got.dtype == BF16
    np.testing.assert_array_equal(_f32(got), _f32(ref))


# ---------------------------------------------------------------------- #
# the dense model over each mesh                                         #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", FORWARDS)
def test_bf16_mesh_forward_matches_jax(case, where):
    """make_forward over the mesh at bf16: fp32 logits of the global
    shape, within LOGITS_RTOL of the JAX package's mesh forward."""
    sizes, cfg, jcfg = _config(case)
    jparams = jmodels.init_params(jcfg, 0)
    tokens, _ = _data(cfg)
    ref = np.asarray(jax.jit(jmodels.make_forward(jcfg, _jax_mesh(sizes)))(
        jparams, tokens))
    params = models.params_from_numpy(jax.tree.map(np.asarray, jparams))
    with ExitStack() as stack:
        mesh = _port_mesh(where, sizes, stack)
        out = _within(lambda: models.make_forward(cfg, mesh)(
            models.params_to(params, mesh.device), tokens)).cpu()
    assert out.dtype == torch.float32
    assert out.shape == (cfg.batch, cfg.seq_len, cfg.vocab)
    assert _rel(out, ref) < LOGITS_RTOL


@pytest.mark.parametrize("case", DENSE)
def test_bf16_mesh_value_and_grad_matches_jax(case, where):
    """value_and_grad over the mesh at bf16 (its psums over tp, dp and
    sp, the replicated leaves' sums): the loss within LOSS_RTOL and every
    gradient, in bf16, within GRAD_RTOL of the JAX package's mesh, twice
    bit-identical.  With remat the JAX side checkpoints each layer, and
    the port's step is bit-identical to its step without remat on the
    same mesh."""
    sizes, cfg, jcfg = _config(case)
    jparams = jmodels.init_params(jcfg, 0)
    tokens, labels = _data(cfg)
    ref_loss, ref = _jax_value_and_grad(jcfg, _jax_mesh(sizes), jparams,
                                        tokens, labels)
    params = models.params_from_numpy(jax.tree.map(np.asarray, jparams))
    t, y = (torch.from_numpy(a.astype(np.int64)) for a in (tokens, labels))
    with ExitStack() as stack:
        mesh = _port_mesh(where, sizes, stack)
        p = models.params_to(params, mesh.device)
        t, y = t.to(mesh.device), y.to(mesh.device)
        runs = [_within(lambda: train.value_and_grad(cfg, p, t, y,
                                                     mesh=mesh))
                for _ in range(2)]
        if cfg.remat:
            plain = _within(lambda: train.value_and_grad(
                dataclasses.replace(cfg, remat=False), p, t, y, mesh=mesh))
            assert torch.equal(plain[0], runs[0][0])
            assert _same(plain[1], runs[0][1])
    (loss, grads), (loss2, grads2) = runs
    assert torch.equal(loss, loss2) and _same(grads, grads2)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    got, want = _flat(_host(grads)), _flat(jax.tree.map(np.asarray, ref))
    assert got.keys() == want.keys()
    for name, r in want.items():
        assert _dtype_name(got[name]) == str(r.dtype), name
        assert _rel(got[name], r) < GRAD_RTOL, name


@pytest.mark.parametrize("case", FORWARDS)
def test_bf16_mesh_train_steps_match_jax(case, where):
    """Two train steps over the mesh from init_params at bf16, each port
    step from the JAX step's carried state: every leaf's dtype as JAX's
    (fp32 parameters with bf16 moments after the first, all fp32 after
    the second), the loss within LOSS_RTOL, the parameters and moments by
    the rules of test_bf16_train_steps_match_jax."""
    sizes, cfg, jcfg = _config(case)
    tokens, labels = _data(cfg)
    jstep = jmodels.make_train_step(jcfg, _jax_mesh(sizes), lr=LR)
    jp = jmodels.init_params(jcfg, 2)
    js = jmodels.adam_init(jp)
    with ExitStack() as stack:
        mesh = _port_mesh(where, sizes, stack)
        step = models.make_train_step(cfg, mesh, lr=LR)
        for i in range(2):
            p = models.params_from_numpy(jax.tree.map(np.asarray, jp))
            s = models.params_from_numpy(jax.tree.map(np.asarray, js))
            jp, js, jloss = jstep(jp, js, tokens, labels)
            p, s, loss = _within(lambda: step(p, s, tokens, labels))
            _check_step(i, _host(p), _host(s), loss.item(), jp, js,
                        float(jloss))


def _check_step(i, p, s, loss, jp, js, jloss, moments: bool = True):
    """Step ``i``'s state against the JAX package's: every dtype, the
    loss, each parameter within 2 lr, at most PARAM_SHARE of the tree's
    entries more than PARAM_ATOL apart (counted over the tree: a norm's
    gain of 64 entries is too small a sample for a share of its own, and
    after the second step an entry whose gradient is small against its
    leaf's largest moves by its gradient's relative error), and the
    moments within MOMENT_RTOL."""
    ref = _flat({"params": jp, **js})
    got = _flat({"params": p, **s})
    assert {n: _dtype_name(t) for n, t in got.items()} == \
        {n: str(a.dtype) for n, a in ref.items()}, i
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    apart = entries = 0
    for name, r in _flat(jp).items():
        d = np.abs(_f32(got["params/" + name]) - _f32(r))
        assert d.max() <= 2 * LR * (1 + 2 ** -6), (i, name)
        apart += int((d > PARAM_ATOL).sum())
        entries += d.size
    assert apart <= PARAM_SHARE * entries, (i, apart, entries)
    for part in ("mu", "nu") if moments else ():
        for name, r in _flat(js[part]).items():
            assert _rel(got[f"{part}/{name}"], r) < MOMENT_RTOL[part], \
                (i, part, name)


# ---------------------------------------------------------------------- #
# experts: the gate, and the MoE model over tp 2 x ep 2                  #
# ---------------------------------------------------------------------- #
def _ulp(p: np.ndarray) -> np.ndarray:
    """bf16's unit in the last place at each (positive) p."""
    return 2.0 ** (np.floor(np.log2(np.maximum(p, 2.0 ** -126))) - 7)


def _fragile(probs, k: int) -> np.ndarray:
    """Each token whose k-th and (k+1)-th gate probabilities lie within
    FRAGILE_ULPS ulps of the k-th."""
    p = -np.sort(-_f32(probs), axis=-1)
    return p[..., k - 1] - p[..., k] <= FRAGILE_ULPS * _ulp(p[..., k - 1])


def _routes(probs, k: int) -> np.ndarray:
    """The experts each token keeps: at or above its k-th probability."""
    p = _f32(probs)
    return p >= -np.sort(-p, axis=-1)[..., k - 1:k]


def test_bf16_moe_gate_matches_jax():
    """The gate at bf16 on the same input: its logits (fp32 sums rounded
    once, in other orders) within an ulp of JAX's; on JAX's logits the
    probabilities, the experts every token keeps and the load-balance
    loss bit for bit (``torch.softmax`` rounds a bf16 softmax once, JAX's
    rounds exp, the sum and the quotient: a quarter of the probabilities
    then differ by an ulp and about one token in twenty keeps other
    experts); from its own logits the layer's output within BF16_RTOL on
    every token that is not fragile, and its VJP, the fragile tokens'
    cotangents zeroed, within LAYER_GRAD_RTOL."""
    E, k = 4, 2
    rng = np.random.RandomState(5)
    (xj, gj, w1j, w2j, dyj) = (
        jnp.asarray(rng.randn(*s).astype(np.float32) * sc, jnp.bfloat16)
        for s, sc in (((8, 256, 32), 1.0), ((32, E), 0.02),
                      ((E, 32, 64), 32 ** -0.5), ((E, 64, 32), 64 ** -0.5),
                      ((8, 256, 32), 1.0)))
    x, g, w1, w2, dy = (torch.from_numpy(np.asarray(a).astype(np.float32))
                        .to(BF16) for a in (xj, gj, w1j, w2j, dyj))
    lj = jnp.einsum("btd,de->bte", xj, gj)
    logits = moe.gate_product(x, g)
    assert logits.dtype == BF16
    assert np.all(np.abs(_f32(logits) - _f32(lj)) <= _ulp(np.abs(_f32(lj))))
    same = torch.from_numpy(_f32(lj)).to(BF16)
    pj = jax.nn.softmax(lj, axis=-1)
    probs = moe.softmax(same)
    np.testing.assert_array_equal(_f32(probs), _f32(pj))
    np.testing.assert_array_equal(_routes(probs, k), _routes(pj, k))
    assert moe.load_balance_loss(same).item() == \
        float(jmoe.load_balance_loss(lj))
    # the layer from its own logits: fragile tokens may route apart
    fragile = _fragile(moe.softmax(logits), k)
    assert fragile.mean() < 0.5         # most tokens are held
    dyj = jnp.where(fragile[..., None], 0, dyj)
    out_j, *ref = _jax_moe_vjp(k, xj, gj, w1j, w2j, dyj)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, w1, w2)]
    out = moe.moe_ffn(*leaves, "ep", top_k=k)
    d = np.abs(_f32(out) - _f32(out_j))[~fragile]
    assert out.dtype == BF16
    assert d.max() / np.abs(_f32(out_j)).max() < BF16_RTOL
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(_f32(dyj)).to(BF16))
    for a, b in zip(grads, ref):
        assert a.dtype == BF16 and _rel(a, b) < LAYER_GRAD_RTOL


def _jax_moe_vjp(k, x, gate, w1, w2, dy):
    """The JAX package's ``moe_ffn`` (its gate logits shared, as its
    model passes them) and its VJP on a one-device ep mesh."""
    def vjp(x, gate, w1, w2, dy):
        out, back = jax.vjp(lambda *a: jmoe.moe_ffn(
            *a, "ep", top_k=k, gate_logits=jnp.einsum("...d,de->...e",
                                                      a[0], a[1])),
            x, gate, w1, w2)
        return (out, *back(dy))

    mesh = jpar.make_mesh(sizes={"ep": 1}, devices=jax.devices("cpu")[:1])
    return jax.jit(jpar.shard_map_compat(
        vjp, mesh, in_specs=(JP(), JP(), JP("ep"), JP("ep"), JP()),
        out_specs=(JP(), JP(), JP(), JP("ep"), JP("ep"))))(
            x, gate, w1, w2, dy)


def _moe_layers(where: str, stack: ExitStack):
    """The tp 2 x ep 2 MoE case: its configs, the JAX init tree and the
    port's copy, the port's mesh, one layer on each mesh (the JAX layer
    with its gate logits, and its VJP; the port's), and the port's gate
    logits as its layers compute them (one shard's: every shard holds
    the same)."""
    sizes, cfg, jcfg = _config("tp2_ep2_moe")
    jparams = jmodels.init_params(jcfg, 0)
    jmesh, mesh = _jax_mesh(sizes), _port_mesh(where, sizes, stack)
    data = JP("dp", "sp")
    jspecs = {n: JP(*s[2:])
              for n, s in jmodels.param_specs(jcfg)["stages"].items()}

    def jfn(lp, x):
        return jtr._layer(jcfg, lp, x, 0.0)[0]

    def jfn_gate(lp, x):
        """The layer and its gate logits, traced out of its moe_ffn."""
        box, real = [], jtr.moe_ffn

        def keep(*args, gate_logits=None, **kw):
            box.append(gate_logits)
            return real(*args, gate_logits=gate_logits, **kw)

        jtr.moe_ffn = keep
        try:
            return jfn(lp, x), box[0]
        finally:
            jtr.moe_ffn = real

    jlayer = jax.jit(jpar.shard_map_compat(
        jfn_gate, jmesh, in_specs=(jspecs, data), out_specs=(data, data)))
    jvjp = jax.jit(jpar.shard_map_compat(
        lambda lp, x, dy: jax.vjp(jfn, lp, x)[1](dy), jmesh,
        in_specs=(jspecs, data, data), out_specs=(jspecs, data)))
    model = transformer.Transformer(cfg)
    tspecs = {n: parallel.spec(*s[2:])
              for n, s in models.param_specs(cfg)["stages"].items()}
    layer = parallel.shard_map_compat(
        lambda lp, x: model._layer(lp, x, 0.0)[0], mesh,
        in_specs=(tspecs, parallel.spec("dp", "sp")),
        out_specs=parallel.spec("dp", "sp"))
    seen = []
    real = transformer.moe_ffn

    def recording(*args, gate_logits=None, **kw):
        seen.append(gate_logits.detach().cpu())
        return real(*args, gate_logits=gate_logits, **kw)

    mp = stack.enter_context(pytest.MonkeyPatch.context())
    mp.setattr(transformer, "moe_ffn", recording)
    params = models.params_to(
        models.params_from_numpy(jax.tree.map(np.asarray, jparams)),
        mesh.device)
    return cfg, jparams, params, mesh, jlayer, jvjp, layer, seen


def test_bf16_moe_layers_match_jax_token_by_token(where):
    """Each MoE layer over tp 2 x ep 2 from the JAX layer's own input:
    every token that both packages route to the same experts (each by
    its own gate logits) and that is not fragile within MOE_LAYER_RTOL of
    the JAX layer's output, and each layer's VJP, the other tokens'
    cotangents zeroed, within LAYER_GRAD_RTOL for every parameter and the
    input.  Fragile tokens are left out even where the two forwards route
    them alike: the JAX VJP recomputes its forward in another compiled
    program, which may round the gate input otherwise.  Most tokens are
    held."""
    with ExitStack() as stack:
        cfg, jparams, params, mesh, jlayer, jvjp, layer, seen = \
            _moe_layers(where, stack)
        dev, k = mesh.device, cfg.moe_top_k
        tokens, _ = _data(cfg)
        xj = (jparams["embed"][tokens] + jparams["pos"][None]).astype(
            jnp.bfloat16)
        rng = np.random.RandomState(8)
        for i in range(cfg.n_layers):
            lpj = jax.tree.map(lambda a: a[0, i], jparams["stages"])
            lp = {n: a[0, i] for n, a in params["stages"].items()}
            x = torch.from_numpy(_f32(xj)).to(dev, BF16)
            seen.clear()
            with torch.no_grad():
                y = _within(lambda: layer(lp, x)).cpu()
            yj, gj = jlayer(lpj, xj)
            probs = moe.softmax(seen[0])
            held = ((_routes(probs, k)
                     == _routes(jax.nn.softmax(gj, axis=-1), k)).all(-1)
                    & ~_fragile(probs, k))
            assert held.mean() > 0.5, (i, held.mean())
            d = np.abs(_f32(y) - _f32(yj))[held]
            assert d.max() / np.abs(_f32(yj)).max() < MOE_LAYER_RTOL, i
            dy = rng.randn(*y.shape).astype(np.float32)
            dy[~held] = 0.0
            dyj = jnp.asarray(dy, jnp.bfloat16)
            ref_lp, ref_x = jvjp(lpj, xj, dyj)
            leaves = {n: a.detach().clone().requires_grad_(True)
                      for n, a in lp.items()}
            xl = x.clone().requires_grad_(True)
            names = sorted(leaves)
            got = _within(lambda: torch.autograd.grad(
                layer(leaves, xl), [xl] + [leaves[n] for n in names],
                torch.from_numpy(_f32(dyj)).to(dev, BF16)))
            refs = [ref_x] + [ref_lp[n] for n in names]
            for name, a, b in zip(["x"] + names, got, refs):
                assert a.dtype == BF16, (i, name)
                assert _rel(a.cpu(), b) < LAYER_GRAD_RTOL, (i, name)
            xj = yj


def test_bf16_moe_mesh_step_1_matches_jax(where):
    """One train step of the MoE model over tp 2 x ep 2 from init_params
    at bf16: the loss within LOSS_RTOL of the JAX mesh's, the dtypes as
    JAX's, the parameters by the PARAM_* rules (the moments hold the
    whole-depth gradients, where fragile tokens route apart; the
    gradients are held by layer above).  The JAX package's second step
    raises; the port's second step from its own state makes every leaf
    fp32 as the dense path's does, keeps q, k and v in bf16 (the MoE
    output takes the stream's type, as the dense FFN's) and lowers the
    loss."""
    sizes, cfg, jcfg = _config("tp2_ep2_moe")
    tokens, labels = _data(cfg)
    jp0 = jmodels.init_params(jcfg, 2)
    js0 = jmodels.adam_init(jp0)
    jp, js, jloss = jmodels.make_train_step(jcfg, _jax_mesh(sizes), lr=LR)(
        jp0, js0, tokens, labels)
    seen = []
    real = transformer.Transformer._attention
    with ExitStack() as stack:
        mesh = _port_mesh(where, sizes, stack)
        step = models.make_train_step(cfg, mesh, lr=LR)
        p, s, loss = _within(lambda: step(
            models.params_from_numpy(jax.tree.map(np.asarray, jp0)),
            models.params_from_numpy(jax.tree.map(np.asarray, js0)),
            tokens, labels))
        _check_step(0, _host(p), _host(s), loss.item(), jp, js,
                    float(jloss), moments=False)
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(transformer.Transformer, "_attention",
                   lambda self, q, k, v: seen.append(
                       (q.dtype, k.dtype, v.dtype)) or real(self, q, k, v))
        p2, s2, loss2 = _within(lambda: step(p, s, tokens, labels))
    assert {_dtype_name(t) for t in train.tree_leaves(_host(p2))
            + train.tree_leaves(_host(s2["mu"]))
            + train.tree_leaves(_host(s2["nu"]))} == {"float32"}
    assert seen and set(seen) == {(BF16, BF16, BF16)}
    assert np.isfinite(loss2.item()) and loss2.item() < loss.item()


@pytest.mark.gpu
def test_bf16_moe_gate_on_card_matches_jax():
    """The MoE gate at GPT-2-small width on the card (8 x 1024 tokens,
    768 wide, 4 experts at init_params' 0.02 scale): its bf16 logits
    within an ulp of the JAX package's on the CPU (both fp32 sums rounded
    once), the tokens that keep other experts all fragile, and the
    layer's output (3072 hidden, 256 tokens) within BF16_RTOL on every
    token that is not.  A bf16 ``torch.einsum`` here is a cuBLAS bf16
    GEMM, which PyTorch's default lets reduce in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    E, k, D, Fd = 4, 2, 768, 3072
    rng = np.random.RandomState(6)
    (xj, gj, w1j, w2j) = (
        jnp.asarray(rng.randn(*s).astype(np.float32) * sc, jnp.bfloat16)
        for s, sc in (((8, 1024, D), 1.0), ((D, E), 0.02),
                      ((E, D, Fd), D ** -0.5), ((E, Fd, D), Fd ** -0.5)))
    x, g, w1, w2 = (torch.from_numpy(np.asarray(a).astype(np.float32))
                    .to(dev, BF16) for a in (xj, gj, w1j, w2j))
    lj = jnp.einsum("btd,de->bte", xj, gj)
    logits = moe.gate_product(x, g).cpu()
    assert np.all(np.abs(_f32(logits) - _f32(lj)) <= _ulp(np.abs(_f32(lj))))
    pj = jax.nn.softmax(lj, axis=-1)
    probs = moe.softmax(logits.to(dev)).cpu()
    other = (_routes(probs, k) != _routes(pj, k)).any(-1)
    assert not (other & ~_fragile(probs, k)).any()
    n = 256
    ref = _jax_moe_vjp(k, xj[0, :n], gj, w1j, w2j, xj[0, :n])[0]
    out = moe.moe_ffn(x[0, :n], g, w1, w2, "ep", top_k=k).cpu()
    keep = ~_fragile(probs[0, :n], k)
    d = np.abs(_f32(out) - _f32(ref))[keep]
    assert d.max() / np.abs(_f32(ref)).max() < BF16_RTOL
