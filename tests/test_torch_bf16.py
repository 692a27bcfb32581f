"""The port at bf16 (parsec_tpu_torch: the bf16 kernels' plain versions,
``params_from_numpy``, the transformer and Adam at ``dtype=bfloat16``)
against the JAX package's.

The same numpy inputs, made from a seed and rounded to bf16, go through
the JAX function and its PyTorch counterpart on the CPU, where the
port's kernel wrappers take their plain versions.  The JAX side runs as
its own tests run it: the Pallas kernels in interpret mode, the model
and its training step under ``shard_map_compat`` on a one-device mesh.
The ``gpu``-marked tests hold the bf16 CUDA instances against their
plain versions on a card and skip where there is none.

Tolerances come from bf16's unit roundoff, 2^-8 (about 3.9e-3): both
sides compute in fp32 from the same bf16 values and round once, but sum
in other orders, so a result may differ by a unit in its last place; the
Pallas forward rounds p at the running max of its key block, the plain
version at the row's max.  Values are compared in fp32.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

pltpu = pytest.importorskip("jax.experimental.pallas.tpu",
                            reason="pallas TPU dialect not importable")
if not hasattr(jax, "shard_map"):
    pytest.skip("jax.shard_map (VMA tracking) not available in this jax",
                allow_module_level=True)

from parsec_tpu import models as jmodels  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu.models import train as jtrain  # noqa: E402
from parsec_tpu.models import transformer as jtr  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu_torch import models  # noqa: E402
from parsec_tpu_torch.models import train, transformer  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402
from test_torch_flash_tc import CARD_CASES  # noqa: E402

BF16 = torch.bfloat16
#: a kernel's plain version against the Pallas kernel, and one layer
#: against the JAX layer on the same input: relative max error, a few
#: units of 2^-8
BF16_RTOL = 1e-2
#: the row statistics m and l: fp32 sums of the same exact products
STATS_TOL = 1e-5
#: whole 2-layer logits, relative max error: each layer's last-place
#: differences grow through the next (JAX's own bf16 logits are 6 to 17 %
#: off its fp32 ones at these widths); and at most half that drift
LOGITS_RTOL = 5e-2
#: the share of GELU's bf16 outputs that may differ from JAX's: the fp32
#: products sum in another order, which can flip a last bit
GELU_SHARE = 1e-2
#: one train step from the same carried-over state: the loss, relative
LOSS_RTOL = 2e-4
#: ... and the parameters: Adam's first step moves each by about lr
#: times the sign of its gradient, so a gradient near 0 that rounds to
#: the other sign moves it 2 lr the other way; at most this share of the
#: entries may differ by more than PARAM_ATOL, none by more than 2 lr
PARAM_ATOL, PARAM_SHARE = 1e-4, 0.1
#: ... and the moments, relative max error: the bf16 gradients of the
#: two packages differ by up to about 4 % of their largest entry (one
#: layer's VJP on the same input by up to 1.5 %: rounding orders compound
#: through the layers), and nu holds their squares, twice that
MOMENT_RTOL = {"mu": 5e-2, "nu": 1e-1}
LR = 5e-3

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_head=8, layers_per_stage=2,
             d_ff=64, seq_len=32, batch=2)


def _jax_cfg(cfg):
    """The JAX package's config with the port config's fields and dtype."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    dtype = {torch.float32: jnp.float32, BF16: jnp.bfloat16}[cfg.dtype]
    return jmodels.TransformerConfig(**fields, dtype=dtype)


def _from_jax(tree):
    """A JAX tree as CPU tensors of the same dtypes and values, through
    fp32 numpy arrays (every bf16 value is exact in fp32): the tests
    other than params_from_numpy's do not depend on it."""
    if isinstance(tree, dict):
        return {name: _from_jax(a) for name, a in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


def _bf16(*xs):
    """numpy fp32 arrays rounded to bf16, as JAX arrays and as tensors
    (the same bits)."""
    js = [jnp.asarray(x, dtype=jnp.bfloat16) for x in xs]
    return js, [_from_jax(j) for j in js]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(got, ref):
    """Relative max error, in fp32."""
    got, ref = _f32(got), _f32(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, a in tree.items():
            out.update(_flat(a, prefix + name + "/"))
        return out
    return {prefix: tree}


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _qkv(T, Tk, seed, D=8):
    rng = np.random.RandomState(seed)
    return _bf16(*(rng.randn(1, 2, t, D).astype(np.float32) * s
                   for t, s in ((T, 1.0), (Tk, 1.0), (Tk, 0.5))))


FLASH_CASES = [(64, 64, True, 16), (64, 64, False, 16), (32, 48, True, 16),
               (48, 32, True, 16), (64, 64, True, 512)]


# ---------------------------------------------------------------------- #
# the kernels' plain versions against the Pallas kernels                 #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("T,Tk,causal,block", FLASH_CASES)
def test_flash_plain_matches_pallas_bf16(T, Tk, causal, block):
    """The forward (o) and the stats forward (o, m, l) at bf16: o in
    bf16, m and l in fp32."""
    (qj, kj, vj), (q, k, v) = _qkv(T, Tk, seed=T + Tk)
    ref = pk.flash_attention(qj, kj, vj, causal=causal, block_q=block,
                             block_k=block)
    out = kernels.flash_attention(q, k, v, causal=causal)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert _rel(out, ref) < BF16_RTOL
    ro, rm, rl = pk.flash_attention_stats(qj, kj, vj, causal=causal,
                                          block_q=block, block_k=block)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    assert o.dtype == BF16 and m.dtype == l.dtype == torch.float32
    assert _rel(o, ro) < BF16_RTOL
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=STATS_TOL,
                               atol=STATS_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), rtol=STATS_TOL,
                               atol=STATS_TOL)


def test_flash_plain_rounds_p_where_pallas_does_bf16():
    """With one key block the Pallas kernel rounds p at the row's max, as
    the plain version does: o agrees but for last-place flips of the
    fp32 sums' order.  Without the rounding of p a large share differs."""
    (qj, kj, vj), (q, k, v) = _qkv(64, 64, seed=5, D=16)
    ref = _f32(pk.flash_attention(qj, kj, vj, causal=True))
    out = kernels.flash_attention_plain(q, k, v, causal=True).float().numpy()
    unrounded = kernels.attention_plain(q, k, v, causal=True).float().numpy()
    assert (out != ref).mean() <= 0.02
    assert (unrounded != ref).mean() > 5 * max((out != ref).mean(), 0.01)


@pytest.mark.parametrize("T,Tk,causal,block", FLASH_CASES)
def test_flash_bwd_plain_matches_pallas_vjp_bf16(T, Tk, causal, block):
    """dq, dk and dv at bf16 from the plain backward (o, m, l of the
    stats plain version) and from autograd through ``flash_attention``,
    against jax.vjp of the Pallas kernel, which upcasts and casts each
    gradient once."""
    (qj, kj, vj, gj), (q, k, v, g) = _bf16(*(
        np.random.RandomState(T * Tk + 1).randn(1, 2, t, 8)
        .astype(np.float32) for t in (T, Tk, Tk, T)))
    _, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, causal=causal, block_q=block, block_k=block), qj, kj, vj)
    ref = vjp(gj)
    o, m, l = kernels.flash_attention_stats_plain(q, k, v, causal=causal)
    plain = kernels.flash_attention_bwd_plain(q, k, v, o, m, l, g,
                                              causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad(kernels.flash_attention(*leaves,
                                                       causal=causal),
                               leaves, g)
    for got in (plain, auto):
        for a, b in zip(got, ref):
            assert a.dtype == BF16 and b.dtype == jnp.bfloat16
            assert _rel(a, b) < BF16_RTOL


@pytest.mark.parametrize("m,k,n", [(64, 48, 40), (128, 512, 96)])
def test_matmul_plain_matches_pallas_bf16(m, k, n):
    """``matmul`` at bf16 and its VJP (the kernel on the transposes):
    bf16 out, the products summed in fp32 and rounded once."""
    rng = np.random.RandomState(m + k + n)
    (aj, bj, gj), (a, b, g) = _bf16(rng.randn(m, k).astype(np.float32),
                                    rng.randn(k, n).astype(np.float32),
                                    rng.randn(m, n).astype(np.float32))
    out, vjp = jax.vjp(lambda a, b: pk.matmul(a, b, block_m=32, block_n=32,
                                              block_k=16), aj, bj)
    leaves = [x.clone().requires_grad_(True) for x in (a, b)]
    got = kernels.matmul(*leaves)
    assert got.dtype == BF16 and out.dtype == jnp.bfloat16
    assert _rel(got, out) < BF16_RTOL
    for x, ref in zip(torch.autograd.grad(got, leaves, g), vjp(gj)):
        assert x.dtype == BF16 and ref.dtype == jnp.bfloat16
        assert _rel(x, ref) < BF16_RTOL
    # the plain version is the fp32 product of the widened operands,
    # rounded once
    assert torch.equal(kernels.gemm_plain(a, b),
                       (a.float() @ b.float()).to(BF16))


def test_check_cuda_operands_takes_one_type_of_two():
    """The CUDA wrappers' check: all fp32 (the fp32 instance) or all bf16
    (the bf16 one), row statistics fp32; operands of mixed types, or of
    another type, raise before any launch."""
    def fake(dtype):
        return types.SimpleNamespace(device=torch.device("cuda", 0),
                                     dtype=dtype, is_contiguous=lambda: True)

    f32, b16 = fake(torch.float32), fake(BF16)
    assert kernels._check_cuda_operands("op", (f32, f32)) == "f32"
    assert kernels._check_cuda_operands("op", (b16, b16), (f32, f32)) == \
        "bf16"
    for ts, stats in [((b16, f32), ()), ((f32, b16), ()),
                      ((b16, b16), (b16, f32)),
                      ((fake(torch.float64),) * 2, ())]:
        with pytest.raises(TypeError):
            kernels._check_cuda_operands("op", ts, stats)


# ---------------------------------------------------------------------- #
# the model's state across the packages (fault 1)                        #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n_experts", [0, 4])
def test_params_from_numpy_carries_a_bf16_tree_bit_for_bit(n_experts):
    """A JAX bf16 tree (numpy's bfloat16 extension type, which
    torch.from_numpy refuses) crosses as bf16 tensors of the same bits,
    and the port's init_params at bf16 makes the same tree."""
    cfg = models.TransformerConfig(**SMALL, n_experts=n_experts, dtype=BF16)
    jparams = jmodels.init_params(_jax_cfg(cfg), 1)
    tree = models.params_from_numpy(jax.tree.map(np.asarray, jparams))
    ref, got = _flat(jparams), _flat(tree)
    own = _flat(models.init_params(cfg, 1))
    assert got.keys() == ref.keys() == own.keys()
    for name, t in got.items():
        bits = np.asarray(ref[name]).view(np.int16)
        assert t.dtype == own[name].dtype == BF16, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), bits,
                                      err_msg=name)
        assert torch.equal(t, own[name]), name


# ---------------------------------------------------------------------- #
# the forward at bf16                                                    #
# ---------------------------------------------------------------------- #
def _jax_layer(jcfg, lp, x):
    """The JAX package's _layer, x split over dp and sp as
    forward_shard's activations are."""
    return jpar.shard_map_compat(
        lambda lp, x: jtr._layer(jcfg, lp, x, 0.0)[0], jpar.make_mesh(1),
        in_specs=(jax.tree.map(lambda _: jpar.spec(), lp),
                  jpar.spec("dp", "sp")),
        out_specs=jpar.spec("dp", "sp"))(lp, x)


@pytest.mark.parametrize("attention", ["flash", "ring"])
def test_bf16_layers_match_jax(attention):
    """Each layer of the bf16 model on the JAX layer's own input, and the
    head on the last: bf16 out, within BF16_RTOL."""
    cfg = models.TransformerConfig(**SMALL, attention=attention, dtype=BF16)
    jcfg = _jax_cfg(cfg)
    jparams = jmodels.init_params(jcfg, 0)
    params = _from_jax(jparams)
    model = transformer.Transformer(cfg)
    rng = np.random.RandomState(4)
    (xj,), (x,) = _bf16(rng.randn(2, cfg.seq_len, cfg.d_model)
                        .astype(np.float32))
    for i in range(cfg.n_layers):
        lpj = jax.tree.map(lambda a: a[0, i], jparams["stages"])
        lp = {name: a[0, i] for name, a in params["stages"].items()}
        ref = _jax_layer(jcfg, lpj, xj)
        got = model._layer(lp, x, 0.0)[0]
        assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
        assert _rel(got, ref) < BF16_RTOL, i
        # the next layer starts from the JAX layer's output
        xj = ref
        x = _from_jax(ref)
    y = jtr._rmsnorm(xj, jparams["ln_f"])
    ref = jnp.einsum("btd,vd->btv", y.astype(jnp.float32),
                     jparams["embed"].astype(jnp.float32))
    got = model._head(params, x)
    assert got.dtype == torch.float32
    assert _rel(got, ref) < BF16_RTOL


@pytest.mark.parametrize("attention", ["flash", "ring"])
def test_bf16_forward_matches_jax(attention):
    """make_forward at bf16 (fp32 logits) against the JAX forward at
    bf16, within LOGITS_RTOL and within half of JAX's own drift from its
    fp32 forward."""
    cfg = models.TransformerConfig(**SMALL, attention=attention, dtype=BF16)
    jcfg = _jax_cfg(cfg)
    jparams = jmodels.init_params(jcfg, 0)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len)).astype(np.int32)
    ref = np.asarray(jax.jit(jmodels.make_forward(jcfg, jpar.make_mesh(1)))(
        jparams, tokens))
    ref32 = np.asarray(jax.jit(jmodels.make_forward(
        dataclasses.replace(jcfg, dtype=jnp.float32), jpar.make_mesh(1)))(
            jax.tree.map(lambda a: a.astype(jnp.float32), jparams), tokens))
    out = models.make_forward(cfg, device="cpu")(
        _from_jax(jparams), tokens)
    assert out.dtype == torch.float32
    assert out.shape == (cfg.batch, cfg.seq_len, cfg.vocab)
    assert _rel(out, ref) < min(LOGITS_RTOL, 0.5 * _rel(ref32, ref))


def test_bf16_gelu_runs_on_the_fp32_product(monkeypatch):
    """The FFN's hidden activation (GELU's output in bf16) against JAX's,
    element by element, on the same input: GELU of the fp32 product,
    rounded once.  The output projection is zeroed so that the FFN's
    input is rmsnorm(x) in both packages."""
    cfg = models.TransformerConfig(**SMALL, attention="flash", dtype=BF16)
    jparams = jmodels.init_params(_jax_cfg(cfg), 2)
    params = _from_jax(jparams)
    lp = {name: a[0, 0] for name, a in params["stages"].items()}
    lp["wo"] = torch.zeros_like(lp["wo"])
    rng = np.random.RandomState(6)
    (xj,), (x,) = _bf16(rng.randn(2, cfg.seq_len, cfg.d_model)
                        .astype(np.float32))
    seen = []
    gelu = F.gelu

    def recording_gelu(z, *args, **kw):
        seen.append(gelu(z, *args, **kw))
        return seen[-1]

    monkeypatch.setattr(F, "gelu", recording_gelu)
    transformer.Transformer(cfg)._layer(lp, x, 0.0)
    monkeypatch.setattr(F, "gelu", gelu)
    assert len(seen) == 1
    got = seen[0].to(BF16).float().numpy()
    h2 = jtr._rmsnorm(xj, jparams["stages"]["ln2"][0, 0])
    ref = _f32(jax.nn.gelu(jnp.einsum(
        "btd,df->btf", h2, jparams["stages"]["w1"][0, 0],
        preferred_element_type=jnp.float32)).astype(jnp.bfloat16))
    differ = got != ref
    assert differ.mean() <= GELU_SHARE, differ.mean()
    # what differs, differs in the last place
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------- #
# Adam and the train step at bf16 (fault 2)                              #
# ---------------------------------------------------------------------- #
def test_adam_update_promotes_as_jax_bf16():
    """Two Adam updates of a bf16 tree: ``m / c1`` promotes to fp32, so
    the parameters come out fp32 with bf16 moments after the first and
    every leaf is fp32 after the second (its gradients fp32, as the fp32
    parameters' are); values as JAX's, each Python constant rounded to
    the type it meets."""
    rng = np.random.RandomState(3)
    shapes = {"a": (8, 16), "b": {"c": (32,)}}
    jp = jax.tree.map(lambda s: jnp.asarray(rng.randn(*s), jnp.bfloat16),
                      shapes, is_leaf=lambda s: isinstance(s, tuple))
    js = jtrain.adam_init(jp)
    p = _from_jax(jp)
    s = train.adam_init(p)
    for k, gdtype in enumerate((jnp.bfloat16, jnp.float32)):
        jg = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape) * 1e-3,
                                                gdtype), jp)
        g = _from_jax(jg)
        jp, js = jtrain.adam_update(jp, jg, js, lr=LR)
        p, s = train.adam_update(p, g, s, lr=LR)
        for ref, got in ((jp, p), (js, s)):
            rf, gf = _flat(ref), _flat(got)
            assert {n: _dtype_name(t) for n, t in gf.items()} == \
                {n: str(a.dtype) for n, a in rf.items()}, k
            for n in rf:
                np.testing.assert_allclose(_f32(gf[n]), _f32(rf[n]),
                                           rtol=2 ** -8, atol=1e-7,
                                           err_msg=f"{n} after {k + 1}")
    assert {_dtype_name(t) for t in train.tree_leaves(p)} == {"float32"}


TRAIN_CASES = [("flash", False), ("flash", True), ("ring", False)]


@pytest.mark.parametrize("attention,remat", TRAIN_CASES)
def test_bf16_train_steps_match_jax(attention, remat):
    """Two steps from init_params at bf16 and three more, each port step
    from the JAX step's carried-over state: every parameter's and
    moment's dtype as JAX's after each step (fp32 parameters and bf16
    moments after the first, all fp32 after the second), the loss within
    LOSS_RTOL, the parameters and moments within PARAM_* and
    MOMENT_RTOL.  Then the port's own two steps from its own init give
    the same dtypes, and q, k and v stay bf16 throughout."""
    cfg = models.TransformerConfig(**SMALL, attention=attention,
                                   remat=remat, dtype=BF16)
    jcfg = _jax_cfg(cfg)
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    jstep = jmodels.make_train_step(jcfg, jpar.make_mesh(1), lr=LR)
    step = models.make_train_step(cfg, lr=LR, device="cpu")
    jp = jmodels.init_params(jcfg, 2)
    js = jmodels.adam_init(jp)
    for i in range(5):
        p = _from_jax(jp)
        s = _from_jax(js)
        jp, js, jloss = jstep(jp, js, tokens, labels)
        p, s, loss = step(p, s, tokens, labels)
        ref = _flat({"params": jp, **js})
        got = _flat({"params": p, **s})
        assert {n: _dtype_name(t) for n, t in got.items()} == \
            {n: str(a.dtype) for n, a in ref.items()}, i
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=LOSS_RTOL)
        for name, r in _flat(jp).items():
            d = np.abs(_f32(got["params/" + name]) - _f32(r))
            assert d.max() <= 2 * LR * (1 + 2 ** -6), (i, name)
            assert (d > PARAM_ATOL).mean() <= PARAM_SHARE, (i, name)
        for part in ("mu", "nu"):
            for name, r in _flat(js[part]).items():
                assert _rel(got[f"{part}/{name}"], r) < MOMENT_RTOL[part], \
                    (i, part, name)
    expect = {1: ("float32", "bfloat16"), 2: ("float32", "float32")}
    p = models.init_params(cfg, 2)
    s = train.adam_init(p)
    seen = []
    real = transformer.Transformer._attention
    for i in (1, 2):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(transformer.Transformer, "_attention",
                       lambda self, q, k, v: seen.append(
                           (q.dtype, k.dtype, v.dtype))
                       or real(self, q, k, v))
            p, s, _ = step(p, s, tokens, labels)
        assert {_dtype_name(t) for t in train.tree_leaves(p)} == \
            {expect[i][0]}
        assert {_dtype_name(t) for t in train.tree_leaves(s["mu"])
                + train.tree_leaves(s["nu"])} == {expect[i][1]}
    assert seen and set(seen) == {(BF16, BF16, BF16)}


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _card_qkv(dev, B, H, T, Tk, D, seed=7):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, H, t, D).astype(np.float32))
                 .to(dev, BF16) for t in (T, Tk, Tk, T))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_bf16_flash_kernels_match_plain_on_card(cuda_device, case):
    """The bf16 forward, stats and backward instances against their
    plain versions, each counted on its own counter (none of the fp32
    ones)."""
    *shape, causal = case
    q, k, v, do = _card_qkv(cuda_device, *shape)
    before = {n: getattr(kernels, n) for n in (
        "flash_launches", "flash_stats_launches", "flash_bwd_launches",
        "flash_bf16_launches", "flash_stats_bf16_launches",
        "flash_bwd_bf16_launches")}
    o = kernels.flash_attention(q, k, v, causal=causal)
    so, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    grads = kernels.flash_attention_bwd(q, k, v, so, m, l, do, causal)
    torch.cuda.synchronize()
    after = {n: getattr(kernels, n) for n in before}
    assert {n: after[n] - before[n] for n in before} == {
        "flash_launches": 0, "flash_stats_launches": 0,
        "flash_bwd_launches": 0, "flash_bf16_launches": 1,
        "flash_stats_bf16_launches": 1, "flash_bwd_bf16_launches": 1}
    ref = kernels.flash_attention_stats_plain(q, k, v, causal=causal)
    assert o.dtype == so.dtype == BF16 and m.dtype == torch.float32
    assert _rel(o.cpu(), ref[0].cpu()) < BF16_RTOL
    assert _rel(so.cpu(), ref[0].cpu()) < BF16_RTOL
    for a, b in zip((m, l), ref[1:]):
        assert _rel(a.cpu(), b.cpu()) < 1e-4
    plain = kernels.flash_attention_bwd_plain(q, k, v, so, m, l, do, causal)
    for a, b in zip(grads, plain):
        assert a.dtype == BF16 and _rel(a.cpu(), b.cpu()) < BF16_RTOL
    again = kernels.flash_attention_bwd(q, k, v, so, m, l, do, causal)
    assert all(map(torch.equal, grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,trans_b", [
    ((1, 256, 256, 256), False), ((3, 999, 1001, 997), True),
    ((1, 130, 70, 36), False)])
def test_bf16_gemm_kernel_matches_plain_on_card(cuda_device, shape,
                                                trans_b):
    z, m, n, k = shape
    rng = np.random.RandomState(6)
    a = torch.from_numpy(rng.randn(z, m, k).astype(np.float32)).to(
        cuda_device, BF16)
    b = torch.from_numpy(rng.randn(z, *((n, k) if trans_b else (k, n)))
                         .astype(np.float32)).to(cuda_device, BF16)
    before = kernels.matmul_bf16_launches, kernels.matmul_launches
    out = kernels.gemm(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert (kernels.matmul_bf16_launches, kernels.matmul_launches) == (
        before[0] + 1, before[1])
    ref = kernels.gemm_plain(a, b, trans_b=trans_b)
    assert out.dtype == BF16 and _rel(out.cpu(), ref.cpu()) < BF16_RTOL
    for i in range(z):
        assert torch.equal(out[i], kernels.gemm(a[i], b[i], trans_b=trans_b))


@pytest.mark.gpu
def test_bf16_kernels_refuse_mixed_types_on_card(cuda_device):
    """A call whose operands mix fp32 and bf16 raises and launches
    nothing; so does the bf16 GEMM with a C operand."""
    q, k, v, do = _card_qkv(cuda_device, 1, 2, 64, 64, 16)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=True)
    counters = [n for n in kernels.__all__ if n.endswith("_launches")]
    before = [getattr(kernels, n) for n in counters]
    with pytest.raises(TypeError):
        kernels.flash_attention(q, k.float(), v)
    with pytest.raises(TypeError):
        kernels.flash_attention_stats(q.float(), k, v)
    with pytest.raises(TypeError):
        kernels.flash_attention_bwd(q, k, v, o, m.to(BF16), l, do)
    with pytest.raises(TypeError):
        kernels.gemm(q[0, 0], k[0, 0].float(), trans_b=True)
    with pytest.raises(ValueError):
        kernels.gemm(q[0, 0], k[0, 0], torch.zeros(64, 64, dtype=BF16,
                                                   device=cuda_device),
                     trans_b=True)
    assert [getattr(kernels, n) for n in counters] == before


@pytest.mark.gpu
def test_bf16_train_step_on_card_launches_bf16_instances(cuda_device):
    """Two flash steps of the bf16 model on the card: each launches the
    bf16 stats and backward instances once a layer and no fp32 flash
    instance; the dtypes after each step as the JAX package's; the loss
    within BF16_RTOL of the CPU port's."""
    cfg = models.TransformerConfig(**SMALL, attention="flash", dtype=BF16)
    params = models.init_params(cfg, 0)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len))
    labels = np.roll(tokens, -1, axis=1)
    step = models.make_train_step(cfg, lr=LR)
    cpu = models.make_train_step(cfg, lr=LR, device="cpu")
    p, s = params, models.adam_init(params)
    cp, cs = params, models.adam_init(params)
    for i, moments in ((1, "bfloat16"), (2, "float32")):
        counts = [kernels.flash_stats_bf16_launches,
                  kernels.flash_bwd_bf16_launches,
                  kernels.flash_stats_launches, kernels.flash_bwd_launches]
        p, s, loss = step(p, s, tokens, labels)
        cp, cs, closs = cpu(cp, cs, tokens, labels)
        torch.cuda.synchronize()
        assert [kernels.flash_stats_bf16_launches - counts[0],
                kernels.flash_bwd_bf16_launches - counts[1],
                kernels.flash_stats_launches - counts[2],
                kernels.flash_bwd_launches - counts[3]] == [
                    cfg.n_layers, cfg.n_layers, 0, 0]
        assert {_dtype_name(t) for t in train.tree_leaves(p)} == {"float32"}
        assert {_dtype_name(t) for t in train.tree_leaves(s["mu"])} == \
            {moments}
        assert abs(loss.item() - closs.item()) < BF16_RTOL * closs.item()
