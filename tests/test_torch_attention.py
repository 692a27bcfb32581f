"""The port's flash attention and its parallel attentions
(parsec_tpu_torch.ops.kernels, parsec_tpu_torch.parallel) against the
JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart.  On the CPU the port's flash wrappers compute
with their plain PyTorch versions; the JAX ``pallas_kernels`` functions
run their Pallas kernels in interpret mode, as tests/test_pallas.py runs
them, and the JAX ring, local and Ulysses attentions run under
``shard_map_compat`` on a one-device sp mesh.  The ``gpu``-marked tests
hold the CUDA kernel against the plain versions on a card and skip where
there is none.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

pltpu = pytest.importorskip("jax.experimental.pallas.tpu",
                            reason="pallas TPU dialect not importable")
if not hasattr(pltpu, "CompilerParams"):
    pytest.skip("jax.experimental.pallas.tpu.CompilerParams not available",
                allow_module_level=True)

from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402
from parsec_tpu_torch.parallel import (  # noqa: E402
    local_attention, ring_attention, ulysses_attention)

FLASH_TOL = 2e-5    # fp32, as tests/test_pallas.py holds the Pallas kernel
STATS_TOL = 1e-4    # fp32, as test_flash_stats_merge_across_blocks
RING_TOL = 2e-4     # fp32, as tests/test_parallel.py holds the ring


def _qkv(B=2, H=2, T=64, D=16, Tk=None, seed=0, uniform=False):
    rng = np.random.RandomState(seed)
    Tk = T if Tk is None else Tk
    if uniform:
        return tuple(rng.rand(B, H, t, D).astype(np.float32)
                     for t in (T, Tk, Tk))
    return tuple((rng.randn(B, H, t, D) * 0.3).astype(np.float32)
                 for t in (T, Tk, Tk))


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


# ---------------------------------------------------------------------- #
# flash forward: the shapes of test_pallas.py                            #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("T,block,causal", [(64, 16, True), (64, 16, False),
                                            (48, 32, True)])
def test_flash_matches_pallas(T, block, causal):
    q, k, v = _qkv(T=T)
    ref = np.asarray(pk.flash_attention(*_j(q, k, v), causal=causal,
                                        block_q=block, block_k=block))
    out = kernels.flash_attention(*_t(q, k, v), causal=causal)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=FLASH_TOL,
                               atol=FLASH_TOL)


def test_flash_default_is_causal_with_default_scale():
    q, k, v = _qkv(T=32, D=8, seed=1)
    ref = np.asarray(pk.flash_attention(*_j(q, k, v)))
    out = kernels.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), ref, rtol=FLASH_TOL,
                               atol=FLASH_TOL)
    scaled = kernels.flash_attention(*_t(q, k, v), scale=0.5)
    ref = np.asarray(pk.flash_attention(*_j(q, k, v), scale=0.5))
    np.testing.assert_allclose(scaled.numpy(), ref, rtol=FLASH_TOL,
                               atol=FLASH_TOL)


@pytest.mark.parametrize("T,Tk", [(32, 48), (48, 32)])
def test_flash_local_index_causal_when_t_differs(T, Tk):
    """Row i sees keys 0..i whatever Tk is, as the Pallas kernel masks."""
    q, k, v = _qkv(T=T, Tk=Tk, seed=2)
    ref = np.asarray(pk.flash_attention(*_j(q, k, v), causal=True,
                                        block_q=16, block_k=16))
    out = kernels.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=FLASH_TOL,
                               atol=FLASH_TOL)


# ---------------------------------------------------------------------- #
# flash forward with statistics                                          #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("T,Tk,causal", [(64, 64, False), (64, 64, True),
                                         (32, 48, True), (48, 32, True),
                                         (32, 48, False)])
def test_flash_stats_match_pallas(T, Tk, causal):
    q, k, v = _qkv(T=T, Tk=Tk, seed=3, uniform=True)
    ro, rm, rl = (np.asarray(x) for x in pk.flash_attention_stats(
        *_j(q, k, v), causal=causal, block_q=16, block_k=16))
    o, m, l = kernels.flash_attention_stats(*_t(q, k, v), causal=causal)
    assert m.shape == l.shape == q.shape[:3]
    assert m.dtype == l.dtype == torch.float32
    for got, ref in ((o, ro), (m, rm), (l, rl)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=STATS_TOL,
                                   atol=STATS_TOL)


def test_flash_stats_merge_across_blocks():
    """Stats over two key sets merged by the documented rule equal
    attention over their concatenation; causal row 0 has l == 1."""
    B, H, T, D = 2, 2, 64, 16
    rng = np.random.RandomState(3)
    q, k1, v1, k2, v2 = (rng.rand(B, H, T, D).astype(np.float32)
                         for _ in range(5))
    o1, m1, l1 = kernels.flash_attention_stats(*_t(q, k1, v1))
    o2, m2, l2 = kernels.flash_attention_stats(*_t(q, k2, v2))
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m) * l1
    w2 = torch.exp(m2 - m) * l2
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / (w1 + w2)[..., None]
    kf, vf = np.concatenate([k1, k2], 2), np.concatenate([v1, v2], 2)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kf) * (D ** -0.5)
    ref = np.asarray(jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1),
                                vf))
    np.testing.assert_allclose(o.numpy(), ref, rtol=STATS_TOL,
                               atol=STATS_TOL)
    _oc, _mc, lc = kernels.flash_attention_stats(*_t(q, k1, v1), causal=True)
    np.testing.assert_allclose(lc.numpy()[..., 0], 1.0, atol=1e-5)


def test_flash_stats_plain_dead_rows_match_reference():
    """A row whose every score is at or below -1e30 keeps the JAX
    reference's conventions: raw m, l = 0 and o = 0."""
    rng = np.random.RandomState(4)
    q = rng.rand(1, 2, 8, 4).astype(np.float32) + 1
    q[:, :, :3] *= -1            # rows 0..2: every score <= -4e30
    k = rng.rand(1, 2, 8, 4).astype(np.float32) + 1
    v = rng.randn(1, 2, 8, 4).astype(np.float32)
    ro, rm, rl = (np.asarray(x) for x in pk._flash_stats_reference(
        *_j(q, k, v), causal=False, scale=1e30))
    o, m, l = kernels.flash_attention_stats_plain(*_t(q, k, v), scale=1e30)
    assert (rl[..., :3] == 0).all() and (ro[:, :, :3] == 0).all()
    np.testing.assert_array_equal(l.numpy(), rl)
    np.testing.assert_array_equal(o.numpy(), ro)
    np.testing.assert_allclose(m.numpy(), rm, rtol=1e-6)


# ---------------------------------------------------------------------- #
# ring, local and Ulysses attention on a one-device sp mesh              #
# ---------------------------------------------------------------------- #
def _sp1(fn):
    mesh = jpar.make_mesh(sizes={"sp": 1}, devices=jax.devices("cpu")[:1])
    return jpar.shard_map_compat(fn, mesh, in_specs=(P(None, None, "sp"),) * 3,
                                 out_specs=P(None, None, "sp"))


def _ring_qkv(T=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.normal(size=(2, 4, T, 8)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax(use_kernel, causal):
    q, k, v = _ring_qkv(T=32)
    ref = np.asarray(_sp1(lambda q, k, v: jpar.ring_attention(
        q, k, v, "sp", causal=causal, use_pallas=use_kernel))(*_j(q, k, v)))
    out = ring_attention(*_t(q, k, v), "sp", causal=causal,
                         use_kernel=use_kernel)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RING_TOL,
                               atol=RING_TOL)


@pytest.mark.parametrize("use_kernel", [None, True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_local_matches_jax(use_kernel, causal):
    q, k, v = _ring_qkv(seed=1)
    ref = np.asarray(_sp1(lambda q, k, v: jpar.local_attention(
        q, k, v, causal=causal, use_pallas=False))(*_j(q, k, v)))
    out = local_attention(*_t(q, k, v), causal=causal, use_kernel=use_kernel)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RING_TOL,
                               atol=RING_TOL)


def test_ulysses_matches_jax():
    q, k, v = _ring_qkv(seed=2)
    ref = np.asarray(_sp1(lambda q, k, v: jpar.ulysses_attention(
        q, k, v, "sp", causal=True))(*_j(q, k, v)))
    out = ulysses_attention(*_t(q, k, v), "sp", causal=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RING_TOL,
                               atol=RING_TOL)


def test_ring_kernel_path_equals_plain_ring_on_cpu():
    """use_kernel=True merges the stats of the plain version; it agrees
    with the plain online-softmax ring."""
    q, k, v = _t(*_ring_qkv(T=24, seed=3))
    a = ring_attention(q, k, v, use_kernel=True)
    b = ring_attention(q, k, v, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=RING_TOL, atol=RING_TOL)


# ---------------------------------------------------------------------- #
# the wrappers' contract                                                 #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shapes", [
    ((2, 2, 8, 4), (2, 2, 8, 5), (2, 2, 8, 5)),     # D mismatch
    ((2, 2, 8, 4), (2, 3, 8, 4), (2, 3, 8, 4)),     # H mismatch
    ((2, 2, 8, 4), (2, 2, 8, 4), (2, 2, 9, 4)),     # k, v differ
    ((2, 8, 4), (2, 8, 4), (2, 8, 4)),               # not 4-D
    ((2, 2, 8, 4), (2, 2, 0, 4), (2, 2, 0, 4)),     # no keys
])
@pytest.mark.parametrize("fn", [kernels.flash_attention,
                                kernels.flash_attention_stats])
def test_flash_rejects_nonconforming(fn, shapes):
    with pytest.raises(ValueError):
        fn(*(torch.zeros(s) for s in shapes))


def test_flash_cpu_takes_plain_and_counts_nothing():
    q, k, v = _t(*_qkv(T=16, D=8, seed=5))
    before = (kernels.flash_launches, kernels.flash_stats_launches)
    kernels.flash_attention(q, k, v)
    kernels.flash_attention_stats(q, k, v)
    assert (kernels.flash_launches, kernels.flash_stats_launches) == before
    with pytest.raises(ValueError):
        kernels.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_flash_plain_is_differentiable_on_cpu():
    """On the CPU the plain version carries the gradient (the JAX VJP's
    values), through the plain statistics and the plain backward."""
    q, k, v = _qkv(B=1, H=2, T=32, D=8, seed=6)
    gj = jax.grad(lambda q, k, v: jnp.sum(pk.flash_attention(
        q, k, v, block_q=16, block_k=16) ** 2), argnums=(0, 1, 2))(
            *_j(q, k, v))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    (kernels.flash_attention(tq, tk, tv) ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                                   atol=5e-4)


# ---------------------------------------------------------------------- #
# on the card                                                            #
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


CARD_CASES = [(2, 3, 256, 256, 64, True), (2, 3, 256, 256, 64, False),
              (1, 2, 1000, 1000, 40, True), (1, 2, 256, 384, 64, True),
              (1, 2, 256, 200, 64, True), (1, 1, 70, 130, 128, False),
              # D not a multiple of 4 (4-byte copies), the widest D, T not
              # a multiple of the query tile, T != Tk both ways
              (1, 2, 300, 300, 33, True), (1, 2, 1000, 1000, 128, True),
              (1, 2, 1000, 1000, 64, True), (1, 2, 1000, 1500, 64, True),
              (1, 2, 1000, 300, 64, True), (1, 2, 300, 1000, 64, False)]


def _card_qkv(dev, B, H, T, Tk, D, seed=7):
    q, k, v = _qkv(B=B, H=H, T=T, Tk=Tk, D=D, seed=seed)
    return tuple(x.to(dev) for x in _t(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, case):
    *shape, causal = case
    q, k, v = _card_qkv(cuda_device, *shape)
    before = kernels.flash_launches
    out = kernels.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_launches == before + 1
    ref = kernels.flash_attention_plain(q, k, v, causal=causal)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < STATS_TOL
    with pytest.raises(TypeError):
        kernels.flash_attention(q.double(), k.double(), v.double())


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_flash_stats_kernel_matches_plain_on_card(cuda_device, case):
    *shape, causal = case
    q, k, v = _card_qkv(cuda_device, *shape)
    before = kernels.flash_stats_launches
    got = kernels.flash_attention_stats(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.flash_stats_launches == before + 1
    ref = kernels.flash_attention_stats_plain(q, k, v, causal=causal)
    for a, b in zip(got, ref):
        assert ((a - b).abs().max() / b.abs().max()).item() < STATS_TOL


def _misaligned(x):
    """The same values in a contiguous view 4 bytes past a 16-byte
    boundary."""
    out = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out.copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_take_misaligned_views_on_card(cuda_device, causal):
    """Misaligned operands run the kernels' 4-byte copy variant: within
    tolerance of the plain versions, and bit-exact against the 16-byte
    variant on aligned copies of the same values."""
    qkv = _card_qkv(cuda_device, 1, 2, 300, 300, 64)
    uqkv = tuple(map(_misaligned, qkv))
    out = kernels.flash_attention(*uqkv, causal=causal)
    got = kernels.flash_attention_stats(*uqkv, causal=causal)
    torch.cuda.synchronize()
    ref = kernels.flash_attention_plain(*qkv, causal=causal)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < STATS_TOL
    for a, b in zip(got, kernels.flash_attention_stats_plain(*qkv,
                                                             causal=causal)):
        assert ((a - b).abs().max() / b.abs().max()).item() < STATS_TOL
    assert torch.equal(out, kernels.flash_attention(*qkv, causal=causal))
    assert all(map(torch.equal, got,
                   kernels.flash_attention_stats(*qkv, causal=causal)))


def _card_grad_inputs(dev, B, H, T, Tk, D, seed=8):
    q, k, v = _card_qkv(dev, B, H, T, Tk, D, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    return q, k, v, torch.randn(q.shape, generator=g, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_flash_gradient_matches_plain_on_card(cuda_device, case):
    """Autograd through flash_attention on the card: one launch of the
    stats instance forward, one of the backward kernel, and dq, dk, dv
    within tolerance of the plain backward on the plain statistics."""
    *shape, causal = case
    q, k, v, do = _card_grad_inputs(cuda_device, *shape)
    before = (kernels.flash_launches, kernels.flash_stats_launches,
              kernels.flash_bwd_launches)
    leaves = tuple(t.clone().requires_grad_(True) for t in (q, k, v))
    out = kernels.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (kernels.flash_launches, kernels.flash_stats_launches,
            kernels.flash_bwd_launches) == (before[0], before[1] + 1,
                                            before[2] + 1)
    o, m, l = kernels.flash_attention_stats_plain(q, k, v, causal=causal)
    ref = kernels.flash_attention_bwd_plain(q, k, v, o, m, l, do,
                                            causal=causal)
    for a, b in zip(got, ref):
        assert ((a - b).abs().max() / b.abs().max()).item() < STATS_TOL


@pytest.mark.gpu
def test_flash_stats_refuses_gradients_on_card(cuda_device):
    """The stats kernel has no backward, as in the JAX package: while
    grad mode is on, an input that needs a gradient raises."""
    q, k, v = _card_qkv(cuda_device, 1, 2, 64, 64, 16)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.flash_attention_stats(q, k, v)
    with torch.no_grad():
        kernels.flash_attention_stats(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 33, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_takes_misaligned_views_on_card(cuda_device, causal, D):
    """Misaligned operands take the 4-byte-copy instance of the backward
    kernel: the bits of aligned copies of the same values (D = 64 and 128
    take the 16-byte instance there, D = 33 the 4-byte one both ways)."""
    q, k, v, do = _card_grad_inputs(cuda_device, 1, 2, 300, 300, D)
    with torch.no_grad():
        o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    args = (q, k, v, o, m, l, do)
    got = kernels.flash_attention_bwd(*map(_misaligned, args), causal)
    ref = kernels.flash_attention_bwd(*args, causal)
    torch.cuda.synchronize()
    assert all(map(torch.equal, got, ref))


def _bwd_within(args, causal, seconds=10.0):
    """One backward launch, waited for against a deadline: a dQ turn that
    never comes fails the test instead of stalling the run (the stuck
    kernel cannot be stopped, so the process's card is lost with it)."""
    out = kernels.flash_attention_bwd(*args, causal)
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > seconds:
            pytest.fail(f"flash_attention_bwd not done after {seconds} s")
        time.sleep(0.001)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_flash_bwd_is_deterministic_on_card(cuda_device, case):
    """No float atomics: dQ is summed in key-tile order, so three launches
    on the same inputs are bit-equal."""
    *shape, causal = case
    q, k, v, do = _card_grad_inputs(cuda_device, *shape)
    with torch.no_grad():
        o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
    args = (q, k, v, o, m, l, do)
    first = _bwd_within(args, causal)
    for _ in range(2):
        assert all(map(torch.equal, first, _bwd_within(args, causal)))


@pytest.mark.gpu
def test_flash_bwd_oversubscribed_grid_finishes_on_card(cuda_device):
    """[16, 16, 2048, 64] causal: thousands of work items for a grid the
    card holds at once, so blocks wait on dQ turns of items handed out
    long before.  It finishes within its deadline, matches the plain
    version and repeats bit for bit."""
    q, k, v, do = _card_grad_inputs(cuda_device, 16, 16, 2048, 2048, 64)
    with torch.no_grad():
        o, m, l = kernels.flash_attention_stats(q, k, v, causal=True)
    args = (q, k, v, o, m, l, do)
    first = _bwd_within(args, True)
    assert all(map(torch.equal, first, _bwd_within(args, True)))
    ref = kernels.flash_attention_bwd_plain(*args, causal=True)
    for a, b in zip(first, ref):
        assert ((a - b).abs().max() / b.abs().max()).item() < STATS_TOL


# ---------------------------------------------------------------------- #
# the backward kernel's host side, on the CPU                            #
# ---------------------------------------------------------------------- #
def test_flash_bwd_cpu_takes_plain_and_counts_nothing():
    """CPU tensors take the plain backward, bit for bit, and launch
    nothing."""
    q, k, v = _t(*_qkv(T=40, D=8, Tk=24, seed=11))
    do = torch.from_numpy(np.random.RandomState(12).randn(*q.shape)
                          .astype(np.float32))
    o, m, l = kernels.flash_attention_stats_plain(q, k, v, causal=True)
    before = kernels.flash_bwd_launches
    got = kernels.flash_attention_bwd(q, k, v, o, m, l, do)
    assert kernels.flash_bwd_launches == before
    ref = kernels.flash_attention_bwd_plain(q, k, v, o, m, l, do)
    assert all(map(torch.equal, got, ref))


@pytest.mark.parametrize("bh,T,n", [(1, 1, 2), (96, 1024, 1537),
                                    (3, 65, 7), (2, 64, 3)])
def test_flash_bwd_counters_are_zeroed_int32(bh, T, n):
    """One int32 turn counter for each (b*h, 64-row query tile), then the
    work-item counter, all zero."""
    c = kernels._flash_bwd_counters(bh, T, torch.device("cpu"))
    assert c.shape == (n,) and c.dtype == torch.int32
    assert not c.any()


def _bwd_schedule(bh, T, Tk, D, causal):
    """The backward kernel's schedule as its source states it: 64-row
    query tiles, key tiles of 128 keys up to D = 64 and 64 beyond; work
    item w = key tile * bh + slice, handed out in ascending w; an item
    walks its visible query tiles from the last down; key tile j adds
    into a query tile's dQ once that tile's counter reads j."""
    bq, bk = kernels.FLASH_BWD_BQ, (128 if D <= 64 else 64)
    nq, nk = -(-T // bq), -(-Tk // bk)
    return [(w // bh, w % bh,
             [qt for qt in range(nq - 1, -1, -1)
              if not causal or qt * bq + bq - 1 >= (w // bh) * bk])
            for w in range(bh * nk)], nq, nk, bq, bk


@pytest.mark.parametrize("bh,T,Tk,D,causal", [
    (3, 1024, 1024, 64, True), (2, 300, 1000, 64, False),
    (2, 1000, 300, 128, True), (4, 130, 300, 33, True),
    (1, 64, 64, 64, True), (5, 200, 333, 128, False)])
@pytest.mark.parametrize("slots", [1, 3, 64])
def test_flash_bwd_schedule_orders_dq_and_cannot_deadlock(bh, T, Tk, D,
                                                          causal, slots):
    """Over the schedule: every visible (query tile, key tile) pair is
    walked exactly once; the key tiles a query tile waits on form 0..J,
    so the turns are dense; every awaited item is handed out before its
    waiter; and ``slots`` resident blocks, each stepping one query tile
    at a time and blocking on its turn, finish every item (no
    deadlock)."""
    items, nq, nk, bq, bk = _bwd_schedule(bh, T, Tk, D, causal)
    index = {(kt, b): w for w, (kt, b, _) in enumerate(items)}
    pairs = [(b, qt, kt) for kt, b, walk in items for qt in walk]
    assert len(pairs) == len(set(pairs))
    for b in range(bh):
        for qt in range(nq):
            rows = range(qt * bq, min(T, qt * bq + bq))
            seen = sorted(kt for kt in range(nk) if any(
                not causal or r >= kt * bk
                for r in rows if kt * bk < Tk))
            waiters = sorted(kt for bb, q, kt in pairs if (bb, q) ==
                             (b, qt))
            assert waiters == seen == list(range(len(seen)))
            assert all(index[(j - 1, b)] < index[(j, b)]
                       for j in waiters[1:])
    turn = {(b, qt): 0 for b in range(bh) for qt in range(nq)}
    running, nxt = [], 0
    while nxt < len(items) or running:
        while len(running) < slots and nxt < len(items):
            running.append([nxt, 0])
            nxt += 1
        moved = False
        for blk in list(running):
            kt, b, walk = items[blk[0]]
            if blk[1] == len(walk):
                running.remove(blk)
                moved = True
            elif turn[(b, walk[blk[1]])] == kt:
                turn[(b, walk[blk[1]])] += 1
                blk[1] += 1
                moved = True
        assert moved, "every resident block waits: deadlock"
    assert all(turn[(b, qt)] == len({kt for bb, q, kt in pairs
                                     if (bb, q) == (b, qt)})
               for b, qt in turn)
