"""The port's transformer forward (parsec_tpu_torch.models) against the
JAX package's.

The same parameters (the port's ``init_params`` makes the JAX package's
draws) and the same token ids, made from a seed, go through the JAX
``make_forward`` on a one-device mesh and the port's
``make_forward(device="cpu")``, which takes each kernel's plain PyTorch
version.  The JAX side runs as its own tests run it on the CPU: the
Pallas flash kernel in interpret mode for attention="flash", the jnp
attention paths otherwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
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
from parsec_tpu_torch import models, parallel  # noqa: E402
from parsec_tpu_torch.models import transformer  # noqa: E402

LOGITS_TOL = 2e-4    # fp32, summed in another order by the two packages

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_head=8, layers_per_stage=2,
             d_ff=64, seq_len=32, batch=2)


def _jax_cfg(cfg):
    """The JAX package's config with the port config's fields."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    return jmodels.TransformerConfig(**fields)


def _tokens(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab,
                       (cfg.batch, cfg.seq_len)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for name, a in tree.items():
            out.update(_flat(a, prefix + name + "/"))
        return out
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------------- #
# parameters                                                             #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg", [
    models.TransformerConfig(**SMALL),
    models.TransformerConfig(vocab=50, d_model=24, n_heads=3, d_head=8,
                             n_stages=2, layers_per_stage=1, d_ff=40,
                             seq_len=16)])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_equal_jax(cfg, seed):
    ref = _flat(jmodels.init_params(_jax_cfg(cfg), seed))
    got = _flat(models.init_params(cfg, seed))
    assert got.keys() == ref.keys()
    for name, a in got.items():
        assert a.dtype == ref[name].dtype and a.shape == ref[name].shape
        np.testing.assert_array_equal(a, ref[name], err_msg=name)


def test_params_from_numpy_round_trips():
    cfg = models.TransformerConfig(**SMALL)
    jparams = jmodels.init_params(_jax_cfg(cfg), 1)
    tree = models.params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert all(isinstance(t, torch.Tensor)
               for t in jax.tree.leaves(models.params_to(tree, "cpu")))
    ref, got = _flat(jparams), _flat(tree)
    assert got.keys() == ref.keys()
    for name, a in got.items():
        assert a.dtype == ref[name].dtype
        np.testing.assert_array_equal(a, ref[name], err_msg=name)


# ---------------------------------------------------------------------- #
# the forward                                                            #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("attention", ["ring", "flash", "local", "ulysses"])
def test_forward_matches_jax(attention, n_micro):
    cfg = models.TransformerConfig(**SMALL, attention=attention,
                                   n_micro=n_micro)
    tokens = _tokens(cfg)
    jfwd = jax.jit(jmodels.make_forward(_jax_cfg(cfg), jpar.make_mesh(1)))
    ref = np.asarray(jfwd(jmodels.init_params(_jax_cfg(cfg), 0), tokens))
    out = models.make_forward(cfg, device="cpu")(
        models.init_params(cfg, 0), tokens)
    assert out.shape == (cfg.batch, cfg.seq_len, cfg.vocab)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


def test_forward_over_stages_and_meshes_agrees():
    """Two stages of one layer equal one stage of two (pp = 1 runs every
    layer in order), and a mesh over the CPU equals device="cpu"."""
    one = models.TransformerConfig(**SMALL)
    two = dataclasses.replace(one, n_stages=2, layers_per_stage=1)
    p1 = models.init_params(one, 0)
    p2 = {**p1, "stages": {name: a.reshape(2, 1, *a.shape[2:])
                           for name, a in p1["stages"].items()}}
    tokens = torch.from_numpy(_tokens(one, seed=1))
    a = models.make_forward(one, device="cpu")(p1, tokens)
    mesh = parallel.make_mesh(devices=[torch.device("cpu")])
    b = models.make_forward(two, mesh)(p2, tokens)
    assert torch.equal(a, b)


@pytest.mark.parametrize("attention", ["ring", "flash"])
def test_layer_pieces_match_jax(attention):
    """_rmsnorm and one _layer against the JAX package's."""
    from parsec_tpu.models import transformer as jtr
    cfg = models.TransformerConfig(**SMALL, attention=attention)
    rng = np.random.RandomState(2)
    x = rng.randn(2, cfg.seq_len, cfg.d_model).astype(np.float32)
    g = (rng.rand(cfg.d_model) + 0.5).astype(np.float32)
    np.testing.assert_allclose(
        transformer.Transformer._rmsnorm(torch.from_numpy(x),
                                         torch.from_numpy(g)).numpy(),
        np.asarray(jtr._rmsnorm(x, g)), rtol=1e-6, atol=1e-6)
    params = models.init_params(cfg, 0)
    lp = {name: a[0, 0] for name, a in params["stages"].items()}
    # x sharded over dp and sp, as forward_shard's activations are
    jlayer = jpar.shard_map_compat(
        lambda lp, x: jtr._layer(_jax_cfg(cfg), lp, x, 0.0)[0],
        jpar.make_mesh(1),
        in_specs=(jax.tree.map(lambda _: jpar.spec(), lp),
                  jpar.spec("dp", "sp")),
        out_specs=jpar.spec("dp", "sp"))
    ref = np.asarray(jlayer({n: a.numpy() for n, a in lp.items()}, x))
    got = transformer.Transformer(cfg)._layer(lp, torch.from_numpy(x),
                                              0.0)[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


# ---------------------------------------------------------------------- #
# what raises                                                            #
# ---------------------------------------------------------------------- #
def test_make_forward_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = models.TransformerConfig(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.make_forward(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(1)


def test_moe_raises():
    """MoE runs (its parameters are the expert leaves); what raises is a
    gate that keeps no expert."""
    cfg = models.TransformerConfig(**SMALL, n_experts=4)
    assert {"gate", "w1e", "w2e"} <= set(models.init_params(cfg)["stages"])
    models.make_forward(cfg, device="cpu")
    bad = dataclasses.replace(cfg, moe_top_k=0)
    with pytest.raises(ValueError, match="moe_top_k"):
        models.make_forward(bad, device="cpu")
    with pytest.raises(ValueError, match="moe_top_k"):
        models.make_train_step(bad, device="cpu")


@pytest.mark.parametrize("kw", [dict(n_devices=2),
                                dict(devices=["cpu", "cpu"]),
                                dict(n_devices=4, devices=["cpu"])])
def test_multi_device_mesh_raises(kw):
    """A mesh over two CPU devices builds (its two chips factor onto dp);
    two chips from a pool of one raise, naming the knob that declares
    logical chips; a device count that does not match the devices
    raises."""
    if kw == dict(devices=["cpu", "cpu"]):
        mesh = parallel.make_mesh(**kw)
        assert mesh.size == 2 and mesh.shape["dp"] == 2
        assert all(c.device == torch.device("cpu")
                   for c in mesh.devices.flat)
        return
    from parsec_tpu_torch.utils.params import params
    with params.cmdline_override("device_cuda_platform", "cpu"), \
            params.cmdline_override("device_cuda_virtual_chips", "0"):
        err = RuntimeError if "devices" not in kw else ValueError
        match = ("device_cuda_virtual_chips" if err is RuntimeError
                 else "n_devices=4")
        with pytest.raises(err, match=match):
            parallel.make_mesh(**kw)


def test_bad_inputs_raise():
    cfg = models.TransformerConfig(**SMALL, n_micro=2)
    fwd = models.make_forward(cfg, device="cpu")
    params = models.init_params(cfg)
    with pytest.raises(ValueError, match="token ids"):
        fwd(params, np.full((2, 8), cfg.vocab))
    with pytest.raises(ValueError, match="microbatches"):
        fwd(params, np.zeros((3, 8), np.int64))
    with pytest.raises(ValueError, match="attention"):
        models.make_forward(dataclasses.replace(cfg, attention="nope"),
                            device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        models.make_forward(cfg, parallel.make_mesh(devices=["cpu"]),
                            device="meta")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        parallel.axis_size("xx")


def test_cpu_forward_loads_no_jax():
    """A fresh interpreter runs the port's forward on the CPU; no JAX
    module is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from parsec_tpu_torch import models
        cfg = models.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                       d_head=8, seq_len=16, batch=2)
        logits = models.make_forward(cfg, device="cpu")(
            models.init_params(cfg), np.zeros((2, 16), np.int64))
        assert tuple(logits.shape) == (2, 16, 64)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "parsec_tpu")))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("attention,counter", [
    ("ring", "flash_stats_launches"), ("flash", "flash_launches"),
    ("local", "flash_launches"), ("ulysses", "flash_launches")])
def test_forward_on_card_matches_cpu(cuda_device, attention, counter):
    from parsec_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = models.TransformerConfig(**SMALL, attention=attention)
    params, tokens = models.init_params(cfg, 0), _tokens(cfg)
    before = getattr(kernels, counter)
    out = models.make_forward(cfg)(params, tokens)
    torch.cuda.synchronize()
    assert getattr(kernels, counter) == before + cfg.n_layers
    ref = models.make_forward(cfg, device="cpu")(params, tokens)
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
