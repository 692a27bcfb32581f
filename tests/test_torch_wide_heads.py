"""The port's flash attention at head widths above 128
(parsec_tpu_torch.ops.kernels: the wide sources ``csrc/flash_attention_wide.cu``
and ``csrc/flash_attention_bwd_wide.cu``) and the transformer with
256-wide heads, against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart on the CPU, where the port's flash wrappers
compute with their plain PyTorch versions.  The JAX side runs as its own
tests run it: the Pallas kernels in interpret mode, the model and its
training step under ``shard_map_compat`` on a one-device mesh.  The
``gpu``-marked tests hold the wide CUDA kernels against the plain
versions on a card and skip where there is none; on the card run them
with

    JAX_PLATFORMS=cpu python -m pytest -m gpu tests/test_torch_wide_heads.py

Tolerances: fp32 within 2e-5, as tests/test_pallas.py holds the Pallas
kernel (the row statistics within 1e-4, as test_torch_attention.py holds
them).  bf16 within 1e-2 relative max error, a few units of bf16's unit
roundoff 2^-8: both sides compute in fp32 from the same bf16 values and
round once, but sum in other orders, and the Pallas forward rounds p at
the running max of its key block, the plain version at the row's max.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pltpu = pytest.importorskip("jax.experimental.pallas.tpu",
                            reason="pallas TPU dialect not importable")
if not hasattr(jax, "shard_map"):
    pytest.skip("jax.shard_map (VMA tracking) not available in this jax",
                allow_module_level=True)

from parsec_tpu import models as jmodels  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu.models import transformer as jtr  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu_torch import models  # noqa: E402
from parsec_tpu_torch.models import train  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402

BF16 = torch.bfloat16
FLASH_TOL = 2e-5     # fp32 o, dq, dk, dv: tests/test_pallas.py's bound
STATS_TOL = 1e-4     # fp32 m and l, as test_torch_attention.py holds them
BF16_RTOL = 1e-2     # bf16 results, relative max error (see above)
#: the model's fp32 logits, summed in another order by the two packages
LOGITS_TOL = 2e-4
#: the bf16 model's logits: each layer's last-place differences grow
#: through the next (as tests/test_torch_bf16.py holds them)
BF16_LOGITS_RTOL = 5e-2
#: one fp32 step's loss, and its parameters and moments from the same
#: carried-over state (as tests/test_torch_train.py holds a trajectory)
LOSS_RTOL, TRAJ_TOL = 1e-5, 2e-3
#: one bf16 step from the same state: the loss; the parameters, each
#: moved by about lr times its gradient's sign, so a gradient near 0 that
#: rounds to the other sign moves it 2 lr the other way (at most
#: PARAM_SHARE of the entries off by more than PARAM_ATOL); the moments
#: (as tests/test_torch_bf16.py holds them)
BF16_LOSS_RTOL = 2e-4
PARAM_ATOL, PARAM_SHARE = 1e-4, 0.1
MOMENT_RTOL = {"mu": 5e-2, "nu": 1e-1}
LR = 5e-3
WIDTHS = [160, 200, 256]
#: the issue's small model with 256-wide heads
WIDE = dict(vocab=64, d_model=32, n_heads=2, d_head=256, d_ff=64,
            seq_len=64, n_stages=1, layers_per_stage=2, batch=2)
CSRC = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
WIDE_COUNTERS = ("flash_wide_launches", "flash_stats_wide_launches",
                 "flash_bwd_wide_launches", "flash_wide_bf16_launches",
                 "flash_stats_wide_bf16_launches",
                 "flash_bwd_wide_bf16_launches")
NARROW_COUNTERS = ("flash_launches", "flash_stats_launches",
                   "flash_bwd_launches", "flash_bf16_launches",
                   "flash_stats_bf16_launches", "flash_bwd_bf16_launches")


def _inputs(T, Tk, D, seed, dtype, cotangent=False):
    """q, k, v (and a cotangent) from a seeded numpy draw, as JAX arrays
    and as CPU tensors of the same values in ``dtype``."""
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(1, 2, t, D) * 0.3).astype(np.float32)
          for t in (T, Tk, Tk) + ((T,) if cotangent else ())]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    js = [jnp.asarray(x, dtype=jdt) for x in xs]
    return js, [models.params_from_numpy(j) for j in js]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(got, ref):
    """Relative max error, in fp32."""
    got, ref = _f32(got), _f32(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _close(got, ref, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=FLASH_TOL,
                                   atol=FLASH_TOL)
    else:
        assert _rel(got, ref) < BF16_RTOL


def _jax_cfg(cfg):
    """The JAX package's config with the port config's fields and dtype."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    dtype = {torch.float32: jnp.float32, BF16: jnp.bfloat16}[cfg.dtype]
    return jmodels.TransformerConfig(**fields, dtype=dtype)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, a in tree.items():
            out.update(_flat(a, prefix + name + "/"))
        return out
    return {prefix[:-1]: tree}


def _port(tree):
    """A JAX tree as the port's CPU tensors of the same dtypes and bits."""
    return models.params_from_numpy(jax.tree.map(np.asarray, tree))


def _batch(cfg):
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _dtypes(tree) -> dict:
    return {name: str(a.dtype).replace("torch.", "")
            for name, a in _flat(tree).items()}


# ---------------------------------------------------------------------- #
# the kernels' plain versions against the Pallas kernels, D > 128        #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,Tk,causal", [(64, 64, True), (64, 64, False),
                                         (32, 48, True)])
@pytest.mark.parametrize("D", WIDTHS)
def test_wide_flash_matches_pallas(D, T, Tk, causal, dtype):
    """The forward and the stats forward at D in {160, 200, 256}: o in
    the operands' type, m and l in fp32."""
    (qj, kj, vj), (q, k, v) = _inputs(T, Tk, D, seed=D + T, dtype=dtype)
    ref = pk.flash_attention(qj, kj, vj, causal=causal, block_q=16,
                             block_k=16)
    out = kernels.flash_attention(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, ref, dtype)
    ro, rm, rl = pk.flash_attention_stats(qj, kj, vj, causal=causal,
                                          block_q=16, block_k=16)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    assert o.dtype == dtype and m.dtype == l.dtype == torch.float32
    _close(o, ro, dtype)
    for got, r in ((m, rm), (l, rl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(r),
                                   rtol=STATS_TOL, atol=STATS_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,Tk,causal", [(64, 64, True), (48, 32, False)])
@pytest.mark.parametrize("D", WIDTHS)
def test_wide_flash_vjp_matches_pallas(D, T, Tk, causal, dtype):
    """dq, dk and dv from the backward's plain version (o, m, l of the
    stats plain version) and from autograd through ``flash_attention``,
    against jax.vjp of the Pallas kernel."""
    (qj, kj, vj, gj), (q, k, v, g) = _inputs(T, Tk, D, seed=3 * D + Tk,
                                             dtype=dtype, cotangent=True)
    _, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, causal=causal, block_q=16, block_k=16), qj, kj, vj)
    ref = vjp(gj)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    plain = kernels.flash_attention_bwd(q, k, v, o, m, l, g, causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad(kernels.flash_attention(*leaves,
                                                       causal=causal),
                               leaves, g)
    for got in (plain, auto):
        for a, b in zip(got, ref):
            assert a.dtype == dtype
            _close(a, b, dtype)


def test_head_width_limit_and_any_width_on_the_cpu():
    """The CUDA kernels take D up to FLASH_D_MAX = 256 (the tuned sources
    up to FLASH_D_NARROW = 128); wider on a card raises by name.  On the
    CPU the plain versions take any D, as the Pallas kernel does: D = 300
    against interpret-mode Pallas, forward, statistics and VJP."""
    assert kernels.FLASH_D_MAX == 256 and kernels.FLASH_D_NARROW == 128
    for D in (1, 128, 129, 256):
        kernels._check_head_width("flash_attention", D)
    for D in (0, 257, 300):
        with pytest.raises(ValueError, match=r"1\.\.256 \(FLASH_D_MAX\).*"
                                             r"Queue 2\(a\)"):
            kernels._check_head_width("flash_attention", D)
    (qj, kj, vj, gj), (q, k, v, g) = _inputs(32, 32, 300, seed=11,
                                             dtype=torch.float32,
                                             cotangent=True)
    ref, vjp = jax.vjp(lambda q, k, v: pk.flash_attention(
        q, k, v, causal=True, block_q=16, block_k=16), qj, kj, vj)
    _close(kernels.flash_attention(q, k, v), ref, torch.float32)
    ro, rm, rl = pk.flash_attention_stats(qj, kj, vj, causal=True,
                                          block_q=16, block_k=16)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=True)
    _close(o, ro, torch.float32)
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=STATS_TOL,
                               atol=STATS_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), rtol=STATS_TOL,
                               atol=STATS_TOL)
    for a, b in zip(kernels.flash_attention_bwd(q, k, v, o, m, l, g),
                    vjp(gj)):
        _close(a, b, torch.float32)


# ---------------------------------------------------------------------- #
# how the wide kernels are built                                         #
# ---------------------------------------------------------------------- #
def _code(path: pathlib.Path) -> str:
    """A source's text without its comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


def test_wide_sources_build_one_library_each():
    """Each wide source is a library of its own holding both types'
    instances (tag None), keyed on the source and the shared header;
    the header's D_MAX is FLASH_D_MAX and the tuned sources keep
    D_MAX = FLASH_D_NARROW."""
    for name in ("flash_attention_wide", "flash_attention_bwd_wide"):
        assert kernels._LIBRARIES[name] == (name, None, ())
        assert kernels._nvcc_command(name)[-1] == str(CSRC / f"{name}.cu")
        assert kernels._headers(name) == ["flash_wide.cuh"]
        code = _code(CSRC / f"{name}.cu")
        assert re.search(r"\bint ptt_flash_(fwd|bwd)_wide_f32\(", code)
        assert re.search(r"\bint ptt_flash_(fwd|bwd)_wide_bf16\(", code)
    header = _code(CSRC / "flash_wide.cuh")
    assert re.search(r"constexpr int D_MAX = (\d+);", header).group(1) == \
        str(kernels.FLASH_D_MAX)
    for name in ("flash_attention", "flash_attention_bf16",
                 "flash_attention_bwd", "flash_attention_bwd_bf16"):
        got = re.search(r"constexpr int D_MAX = (\d+);",
                        _code(CSRC / f"{name}.cu")).group(1)
        assert got == str(kernels.FLASH_D_NARROW), name


def test_wide_sources_sum_without_atomics():
    """No atomic anywhere in the wide sources: every output is written
    by one block, dQ summed over key tiles in order inside it, so
    repeated launches give the same bits."""
    for name in ("flash_attention_wide.cu", "flash_attention_bwd_wide.cu",
                 "flash_wide.cuh"):
        code = _code(CSRC / name)
        assert not re.search(r"\bred\.|\batom\.|atomic[A-Z]", code), name


def test_wide_counters_start_at_zero_and_are_exported():
    for name in WIDE_COUNTERS:
        assert name in kernels.__all__
        assert isinstance(getattr(kernels, name), int)


# ---------------------------------------------------------------------- #
# the model with 256-wide heads                                          #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_params_from_numpy_carries_a_wide_head_tree(dtype):
    """The JAX package's init_params at d_head 256 crosses through
    params_from_numpy as the port's own init_params tree, bit for bit."""
    cfg = models.TransformerConfig(**WIDE, dtype=dtype)
    jparams = jmodels.init_params(_jax_cfg(cfg), 1)
    got = _flat(_port(jparams))
    own = _flat(models.init_params(cfg, 1))
    assert got.keys() == own.keys() == _flat(jparams).keys()
    assert own["stages/wqkv"].shape == (1, 2, 32, 3, 2, 256)
    assert own["stages/wo"].shape == (1, 2, 2, 256, 32)
    for name, t in got.items():
        assert t.dtype == own[name].dtype == dtype, name
        assert torch.equal(t, own[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("attention", ["flash", "ring"])
def test_wide_model_logits_match_jax(attention, dtype):
    """make_forward with 256-wide heads against the JAX forward: fp32
    within LOGITS_TOL; bf16 (fp32 logits) within BF16_LOGITS_RTOL and
    within half of JAX's own drift from its fp32 forward."""
    cfg = models.TransformerConfig(**WIDE, attention=attention, dtype=dtype)
    jcfg = _jax_cfg(cfg)
    jparams = jmodels.init_params(jcfg, 0)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len)).astype(np.int32)
    ref = np.asarray(jax.jit(jmodels.make_forward(jcfg, jpar.make_mesh(1)))(
        jparams, tokens))
    out = models.make_forward(cfg, device="cpu")(
        _port(jparams), tokens)
    assert out.dtype == torch.float32
    assert out.shape == (cfg.batch, cfg.seq_len, cfg.vocab)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        return
    ref32 = np.asarray(jax.jit(jmodels.make_forward(
        dataclasses.replace(jcfg, dtype=jnp.float32), jpar.make_mesh(1)))(
            jax.tree.map(lambda a: a.astype(jnp.float32), jparams), tokens))
    assert _rel(out, ref) < min(BF16_LOGITS_RTOL, 0.5 * _rel(ref32, ref))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_wide_train_step_matches_jax(dtype):
    """Adam steps with 256-wide heads (attention="flash"): the first from
    the same init, then one from the JAX step's carried-over state.  After
    each, every leaf's dtype as JAX's (at bf16: fp32 parameters with bf16
    moments, then all fp32) and the loss as JAX's.  The parameters and
    moments: at fp32 after the second step; at bf16 after the first,
    where each parameter moves by lr times its gradient's sign (after the
    second the bf16 gradients' own drift from fp32, which
    test_wide_bf16_gradients_within_jax_drift holds, moves them
    further)."""
    cfg = models.TransformerConfig(**WIDE, attention="flash", dtype=dtype)
    jcfg = _jax_cfg(cfg)
    tokens, labels = _batch(cfg)
    jstep = jmodels.make_train_step(jcfg, jpar.make_mesh(1), lr=LR)
    step = models.make_train_step(cfg, lr=LR, device="cpu")
    jp = jmodels.init_params(jcfg, 2)
    js = jmodels.adam_init(jp)
    loss_tol = LOSS_RTOL if dtype == torch.float32 else BF16_LOSS_RTOL
    for i in range(2):
        p, s, loss = step(_port(jp), _port(js), tokens, labels)
        jp, js, jloss = jstep(jp, js, tokens, labels)
        ref = _flat({"params": _port(jp), **_port(js)})
        got = _flat({"params": p, **s})
        assert _dtypes(got) == _dtypes(ref), i
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=loss_tol)
        if dtype == torch.float32 and i == 1:
            for name in ref:
                np.testing.assert_allclose(_f32(got[name]), _f32(ref[name]),
                                           rtol=TRAJ_TOL, atol=TRAJ_TOL,
                                           err_msg=name)
        if dtype == BF16 and i == 0:
            for name in ref:
                part = name.split("/")[0]
                if part == "params":
                    d = np.abs(_f32(got[name]) - _f32(ref[name]))
                    assert d.max() <= 2 * LR * (1 + 2 ** -6), name
                    assert (d > PARAM_ATOL).mean() <= PARAM_SHARE, name
                elif part in MOMENT_RTOL:
                    assert _rel(got[name], ref[name]) < MOMENT_RTOL[part], \
                        name


def _jax_value_and_grad(jcfg, params, tokens, labels):
    """The JAX package's loss and gradients on a one-device mesh."""
    pspecs = jmodels.param_specs(jcfg)

    def shard(p, t, y):
        return jax.value_and_grad(lambda pp: jtr.loss_shard(jcfg, pp, t,
                                                            y))(p)

    return jax.jit(jpar.shard_map_compat(
        shard, jpar.make_mesh(1),
        in_specs=(pspecs, jpar.spec("dp", "sp"), jpar.spec("dp", "sp")),
        out_specs=(jpar.spec(), pspecs)))(params, tokens, labels)


def test_wide_bf16_gradients_within_jax_drift():
    """Every gradient of the bf16 model with 256-wide heads against the
    JAX package's at bf16, from the same parameters and batch: within
    half of JAX's own bf16 gradient's drift from its fp32 one (the port's
    and JAX's bf16 gradients differ by a few percent, rounding orders
    compounding through the layers, as at 8-wide heads), and the loss
    within BF16_LOSS_RTOL."""
    cfg = models.TransformerConfig(**WIDE, attention="flash", dtype=BF16)
    jcfg = _jax_cfg(cfg)
    tokens, labels = _batch(cfg)
    jp = jmodels.init_params(jcfg, 2)
    loss, grads = train.value_and_grad(
        cfg, _port(jp), *(torch.as_tensor(a, dtype=torch.int64)
                          for a in (tokens, labels)))
    jloss, jgrads = _jax_value_and_grad(jcfg, jp, tokens, labels)
    _, jgrads32 = _jax_value_and_grad(
        dataclasses.replace(jcfg, dtype=jnp.float32),
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), tokens, labels)
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=BF16_LOSS_RTOL)
    got, ref, ref32 = (_flat(t) for t in (grads, _port(jgrads),
                                          _port(jgrads32)))
    assert _dtypes(got) == _dtypes(ref)
    for name, g in got.items():
        assert _rel(g, ref[name]) < 0.5 * _rel(ref[name], ref32[name]), name


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card(dev, B, H, T, Tk, D, dtype, seed=7):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, H, t, D).astype(np.float32))
                 .to(dev, dtype) for t in (T, Tk, Tk, T))


def _misaligned(x):
    """The same values in a contiguous view one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def _counts():
    return {n: getattr(kernels, n) for n in WIDE_COUNTERS + NARROW_COUNTERS}


#: (B, H, T, Tk, D, causal): ragged T, T above and below Tk, D not a
#: multiple of 8 or 16, and the widest
CARD_CASES = [(1, 2, 1000, 1000, 160, True), (1, 2, 1000, 1000, 200, False),
              (1, 2, 1000, 1000, 256, True), (1, 2, 300, 1000, 256, False),
              (1, 2, 1000, 300, 200, True), (2, 1, 77, 130, 129, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_wide_kernels_match_plain_on_card(cuda_device, case, dtype):
    """Each wide instance against its plain version on the card: o, dq,
    dk, dv within 1e-4 (fp32) or BF16_RTOL, m and l within 1e-4; the
    backward's repeats bit-equal; misaligned views bit-exact against
    aligned copies; only the wide instances launch."""
    B, H, T, Tk, D, causal = case
    tol = 1e-4 if dtype == torch.float32 else BF16_RTOL
    q, k, v, do = _card(cuda_device, B, H, T, Tk, D, dtype)
    before = _counts()
    o = kernels.flash_attention(q, k, v, causal=causal)
    o2, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    grads = kernels.flash_attention_bwd(q, k, v, o2, m, l, do, causal)
    again = kernels.flash_attention_bwd(q, k, v, o2, m, l, do, causal)
    torch.cuda.synchronize()
    tag = "_bf16" if dtype == BF16 else ""
    after = _counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: (2 if n == f"flash_bwd_wide{tag}_launches" else
            1 if n in (f"flash_wide{tag}_launches",
                       f"flash_stats_wide{tag}_launches") else 0)
        for n in after}
    assert all(map(torch.equal, grads, again))
    ro = kernels.flash_attention_plain(q, k, v, causal=causal)
    rs = kernels.flash_attention_stats_plain(q, k, v, causal=causal)
    rg = kernels.flash_attention_bwd_plain(q, k, v, o2, m, l, do, causal)
    for got, ref in [(o, ro), (o2, rs[0])] + list(zip(grads, rg)):
        assert got.dtype == dtype
        assert _rel(got, ref) < tol
    for got, ref in zip((m, l), rs[1:]):
        assert _rel(got, ref) < 1e-4
    mis = [_misaligned(x) for x in (q, k, v, o2, do)]
    assert torch.equal(kernels.flash_attention(*mis[:3], causal=causal), o)
    assert all(map(torch.equal, kernels.flash_attention_bwd(
        *mis[:4], m, l, mis[4], causal), grads))


@pytest.mark.gpu
def test_wide_training_forward_and_backward_on_card(cuda_device):
    """autograd through flash_attention at D = 256 on the card: the stats
    forward and the backward of the wide sources, once each, and the
    gradients of the plain versions'."""
    q, k, v, do = _card(cuda_device, 1, 2, 512, 512, 256, torch.float32)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = _counts()
    got = torch.autograd.grad(kernels.flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    after = _counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: 1 if n in ("flash_stats_wide_launches",
                      "flash_bwd_wide_launches") else 0 for n in after}
    o, m, l = kernels.flash_attention_stats_plain(q, k, v, causal=True)
    for a, b in zip(got, kernels.flash_attention_bwd_plain(q, k, v, o, m,
                                                           l, do)):
        assert _rel(a, b) < 1e-4


@pytest.mark.gpu
def test_head_width_257_raises_on_card(cuda_device):
    """Past FLASH_D_MAX a CUDA call raises by name and launches nothing;
    it neither falls back to the plain version nor to the CPU."""
    q, k, v, do = _card(cuda_device, 1, 1, 16, 16, 257, torch.float32)
    before = _counts()
    with pytest.raises(ValueError, match="FLASH_D_MAX"):
        kernels.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="FLASH_D_MAX"):
        kernels.flash_attention_stats(q, k, v)
    m = torch.zeros(1, 1, 16, device=cuda_device)
    with pytest.raises(ValueError, match="FLASH_D_MAX"):
        kernels.flash_attention_bwd(q, k, v, q, m, m, do)
    assert _counts() == before
