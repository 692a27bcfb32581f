"""The port's tile kernels (parsec_tpu_torch.ops) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart.  On the CPU the port's GEMM wrapper computes with
its plain PyTorch version, and the JAX ``pallas_kernels.matmul`` runs its
Pallas kernel in interpret mode, as tests/test_pallas.py runs it.  The
``gpu``-marked test holds the CUDA kernel against the plain version on a
card and skips where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pltpu = pytest.importorskip("jax.experimental.pallas.tpu",
                            reason="pallas TPU dialect not importable")

from parsec_tpu.ops import linalg as jlinalg  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu_torch.ops import kernels, linalg  # noqa: E402

TOL = 1e-4   # fp32, sums taken in another order by the two packages


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _spd_tiles(rng, n, nb):
    """n SPD diagonal tiles (T) and n panel tiles (C)."""
    b = rng.rand(n, nb, nb) - 0.5
    t = (b @ b.transpose(0, 2, 1)) / nb + np.eye(nb)
    return t.astype(np.float32), _rand(rng, n, nb, nb)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------- #
# matmul: the shapes of test_pallas.py                                   #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("m,k,n,block", [(96, 128, 64, 32), (32, 48, 32, 16)])
def test_matmul_matches_pallas(m, k, n, block):
    rng = np.random.RandomState(1)
    a, b = _rand(rng, m, k), _rand(rng, k, n)
    ref = np.asarray(pk.matmul(jnp.asarray(a), jnp.asarray(b),
                               block_m=block, block_n=block, block_k=block))
    out = kernels.matmul(_t(a), _t(b)).numpy()
    assert out.shape == (m, n) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_matmul_grad_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _rand(rng, 32, 48), _rand(rng, 48, 32)
    ga, gb = jax.grad(lambda x, y: jnp.sum(pk.matmul(x, y, 16, 16, 16) ** 2),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = _t(a).requires_grad_(True)
    tb = _t(b).requires_grad_(True)
    (kernels.matmul(ta, tb) ** 2).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("trans_b", [False, True])
def test_gemm_contract_ragged(trans_b):
    """Out = beta*C + alpha*(A op(B)) at shapes no block size divides."""
    rng = np.random.RandomState(3)
    a, c = _rand(rng, 37, 29), _rand(rng, 37, 51)
    b = _rand(rng, 51, 29) if trans_b else _rand(rng, 29, 51)
    out = kernels.gemm(_t(a), _t(b), _t(c), trans_b=trans_b,
                       alpha=-0.5, beta=2.0).numpy()
    ref = 2.0 * c.astype(np.float64) - 0.5 * (a.astype(np.float64)
                                              @ (b.T if trans_b else b))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shapes,trans_b", [
    (((4, 5), (6, 4)), False),           # K mismatch
    (((4, 5), (6, 4)), True),            # K mismatch, B transposed
    (((2, 4, 5), (3, 5, 6)), False),     # batch mismatch
    (((4, 5), (2, 5, 6)), False),        # rank mismatch
])
def test_gemm_rejects_nonconforming(shapes, trans_b):
    a, b = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        kernels.gemm(a, b, trans_b=trans_b)


def test_gemm_rejects_bad_c_and_device():
    a, b = torch.zeros(4, 5), torch.zeros(5, 6)
    with pytest.raises(ValueError):
        kernels.gemm(a, b, torch.zeros(4, 5), beta=1.0)
    with pytest.raises(ValueError):
        kernels.gemm(a.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------- #
# tile bodies, with a leading batch dimension                            #
# ---------------------------------------------------------------------- #
def _dominant_tiles(rng, n, nb):
    a = rng.rand(n, nb, nb) - 0.5
    a[:, np.arange(nb), np.arange(nb)] = np.abs(a).sum(axis=2) + 1.0
    return a.astype(np.float32)


def _bodies(rng, n, nb):
    t, c = _spd_tiles(rng, n, nb)
    a, b = _rand(rng, n, nb, nb), _rand(rng, n, nb, nb)
    lt = np.stack([np.linalg.cholesky(x.astype(np.float64)) for x in t]
                  ).astype(np.float32)
    # a packed, well-conditioned LU tile: unit-lower L below the
    # diagonal, U on and above
    lu = np.stack([np.tril(x, -1) / nb + np.triu(y) + nb * np.eye(nb)
                   for x, y in zip(a, b)]).astype(np.float32)
    ut = np.triu(t) + np.eye(nb, dtype=np.float32)
    q2 = _rand(rng, n, 2 * nb, 2 * nb)
    return {
        "potrf": ((t,), jlinalg.potrf, linalg.potrf),
        "trsm_panel": ((lt, c), jlinalg.trsm_panel, linalg.trsm_panel),
        "syrk_ln": ((c, a), jlinalg.syrk_ln, linalg.syrk_ln),
        "gemm_nt": ((c, a, b), jlinalg.gemm_nt, linalg.gemm_nt),
        "gemm_nn": ((c, a, b), jlinalg.gemm_nn, linalg.gemm_nn),
        "gemm_nn_sub": ((c, a, b), jlinalg.gemm_nn_sub, linalg.gemm_nn_sub),
        "gemm": ((c, a, b), lambda x, y, z: jlinalg.gemm(x, y, z, 1.5, 0.5),
                 lambda x, y, z: linalg.gemm(x, y, z, 1.5, 0.5)),
        "gemm_tn_sub": ((c, a, b), jlinalg.gemm_tn_sub, linalg.gemm_tn_sub),
        "unmqr": ((a, c), jlinalg.unmqr, linalg.unmqr),
        "tsmqr": ((q2, a, b), jlinalg.tsmqr, linalg.tsmqr),
        "geqrt": ((a,), jlinalg.geqrt, linalg.geqrt),
        "geqrt_r": ((a,), jlinalg.geqrt_r, linalg.geqrt_r),
        "tsqrt": ((ut, a), jlinalg.tsqrt, linalg.tsqrt),
        "tsqrt_r": ((ut, a), jlinalg.tsqrt_r, linalg.tsqrt_r),
        "getrf_nopiv": ((_dominant_tiles(rng, n, nb),), jlinalg.getrf_nopiv,
                        linalg.getrf_nopiv),
        "trsm_lower": ((lt, c), jlinalg.trsm_lower, linalg.trsm_lower),
        "trsm_lower_trans": ((lt, c), jlinalg.trsm_lower_trans,
                             linalg.trsm_lower_trans),
        "trsm_lower_unit": ((lu, c), jlinalg.trsm_lower_unit,
                            linalg.trsm_lower_unit),
        "trsm_upper_right": ((lu, c), jlinalg.trsm_upper_right,
                             linalg.trsm_upper_right),
        "axpy": ((c, a), lambda x, y: jlinalg.axpy(x, y, -2.0),
                 lambda x, y: linalg.axpy(x, y, -2.0)),
        "scal": ((c,), lambda x: jlinalg.scal(x, 3.0),
                 lambda x: linalg.scal(x, 3.0)),
        "transpose": ((a,), jlinalg.transpose, linalg.transpose),
    }


BODIES = ["potrf", "trsm_panel", "syrk_ln", "gemm_nt", "gemm_nn",
          "gemm_nn_sub", "gemm", "gemm_tn_sub", "unmqr", "tsmqr", "geqrt",
          "geqrt_r", "tsqrt", "tsqrt_r", "getrf_nopiv", "trsm_lower",
          "trsm_lower_trans", "trsm_lower_unit", "trsm_upper_right", "axpy",
          "scal", "transpose"]


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("body", BODIES)
def test_tile_body_matches_jax(body, nb):
    """Each body against the JAX package's on the same tiles; the QR
    bodies' orthogonal factors included (both take LAPACK's Householder
    signs), getrf_nopiv through its plain masked loop."""
    args, jfn, tfn = _bodies(np.random.RandomState(4), 3, nb)[body]
    outs = _outputs(tfn(*(_t(x) for x in args)))
    for i in range(outs[0].shape[0]):
        refs = _outputs(jfn(*(jnp.asarray(x[i]) for x in args)))
        assert len(refs) == len(outs)
        for out, ref in zip(outs, refs):
            np.testing.assert_allclose(out[i].numpy(), np.asarray(ref),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("body", BODIES)
def test_tile_body_batched_equals_per_slice(body, nb):
    args, _jfn, tfn = _bodies(np.random.RandomState(5), 4, nb)[body]
    batched = _outputs(tfn(*(_t(x) for x in args)))
    assert all(b.is_contiguous() for b in batched)
    for i in range(batched[0].shape[0]):
        single = _outputs(tfn(*(_t(x[i]) for x in args)))
        for b, s in zip(batched, single):
            assert s.is_contiguous()
            assert torch.equal(b[i], s), (body, nb, i)


#: each product body as the GEMM kernel's call it must make:
#: (body's arguments) -> (A, B, C, trans_b, alpha, beta) of kernels.gemm
GEMM_CALLS = {
    "gemm_nn": lambda c, a, b: (a, b, c, False, 1.0, 1.0),
    "gemm_nn_sub": lambda c, a, b: (a, b, c, False, -1.0, 1.0),
    "gemm": lambda c, a, b: (a, b, c, False, 1.5, 0.5),
    "gemm_tn_sub": lambda c, a, b: (a.mT.contiguous(), b, c, False, -1.0,
                                    1.0),
    "unmqr": lambda q, c: (q.mT.contiguous(), c, None, False, 1.0, 0.0),
    "tsmqr": lambda q2, a1, a2: (q2.mT.contiguous(),
                                 torch.cat([a1, a2], dim=-2), None, False,
                                 1.0, 0.0),
    "gemm_nt": lambda c, a, b: (a, b, c, True, -1.0, 1.0),
    "syrk_ln": lambda t, a: (a, a, t, True, -1.0, 1.0),
}


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("body", sorted(GEMM_CALLS))
def test_product_body_is_one_gemm(monkeypatch, body, batch):
    """Every product body is exactly one call of the GEMM wrapper, whose
    CPU path is the plain version: bit-equal to ``gemm_plain`` on the
    operands the body must pass, single and batched."""
    args, _jfn, tfn = _bodies(np.random.RandomState(8), batch or 1, 32)[body]
    ts = [_t(x if batch else x[0]) for x in args]
    calls = []
    real = kernels.gemm
    monkeypatch.setattr(kernels, "gemm",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = torch.cat([o for o in _outputs(tfn(*ts))], dim=-2)
    assert len(calls) == 1
    a, b, c, trans_b, alpha, beta = GEMM_CALLS[body](*ts)
    ref = kernels.gemm_plain(a, b, c, trans_b=trans_b, alpha=alpha,
                             beta=beta)
    assert torch.equal(out, ref)


def test_each_source_builds_to_its_own_library():
    """Every csrc/*.cu is a library of its own, keyed on its own source;
    an unknown name raises before nvcc is looked for."""
    import pathlib
    csrc = pathlib.Path(kernels.__file__).resolve().parent.parent / "csrc"
    assert sorted(kernels._SOURCES) == sorted(p.stem
                                              for p in csrc.glob("*.cu"))
    paths = {name: kernels._library_path(name) for name in kernels._SOURCES}
    assert all(p.name.startswith(name + "_") for name, p in paths.items())
    assert len({p.parent for p in paths.values()}) == 1
    with pytest.raises(ValueError, match="no CUDA source"):
        kernels.build(["nope"])


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,trans_b", [
    ((1, 256, 256, 256), True), ((8, 256, 256, 256), True),
    ((1, 100, 70, 37), False), ((3, 100, 70, 37), True),
    # M, N, K not multiples of 4 nor of the 128x64 block tile; z = 3
    ((1, 999, 1001, 997), True), ((1, 999, 1001, 997), False),
    ((3, 999, 1001, 997), True),
    # K a multiple of 4 (16-byte copies) but not of the 32-deep slab
    ((1, 130, 70, 36), True), ((2, 130, 70, 36), False)])
def test_gemm_kernel_matches_plain_on_card(cuda_device, shape, trans_b):
    z, m, n, k = shape
    rng = np.random.RandomState(6)
    a = _t(_rand(rng, z, m, k)).to(cuda_device)
    b = _t(_rand(rng, z, n, k) if trans_b
           else _rand(rng, z, k, n)).to(cuda_device)
    c = _t(_rand(rng, z, m, n)).to(cuda_device)
    before = kernels.matmul_launches
    out = kernels.gemm(a, b, c, trans_b=trans_b, alpha=-1.0, beta=1.0)
    torch.cuda.synchronize()
    assert kernels.matmul_launches == before + 1
    ref = kernels.gemm_plain(a, b, c, trans_b=trans_b, alpha=-1.0, beta=1.0)
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL
    for i in range(z):
        single = kernels.gemm(a[i], b[i], c[i], trans_b=trans_b,
                              alpha=-1.0, beta=1.0)
        assert torch.equal(out[i], single)
    with pytest.raises(TypeError):
        kernels.gemm(a.double(), b.double(), trans_b=trans_b)


def _misaligned(x):
    """The same values in a contiguous view 4 bytes past a 16-byte
    boundary, as ``torch.empty(n + 1)[1:].view(...)`` makes one."""
    out = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out.copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("trans_b", [True, False])
def test_gemm_kernel_takes_misaligned_views_on_card(cuda_device, trans_b):
    """A contiguous view at an odd float offset runs the kernel's 4-byte
    copy variant: within tolerance of the plain version, and bit-exact
    against the 16-byte variant on aligned copies of the same values."""
    rng = np.random.RandomState(7)
    a, b, c = (_t(_rand(rng, 256, 256)).to(cuda_device) for _ in range(3))
    ua, ub, uc = map(_misaligned, (a, b, c))
    before = kernels.matmul_launches
    out = kernels.gemm(ua, ub, uc, trans_b=trans_b, alpha=-1.0, beta=1.0)
    torch.cuda.synchronize()
    assert kernels.matmul_launches == before + 1
    ref = kernels.gemm_plain(a, b, c, trans_b=trans_b, alpha=-1.0, beta=1.0)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < TOL
    assert torch.equal(out, kernels.gemm(a, b, c, trans_b=trans_b,
                                         alpha=-1.0, beta=1.0))
