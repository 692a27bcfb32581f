"""The port's SPMD executor (parallel/shard_map.py, behind
``shard_map_compat``) against tests/test_shard_map_compat.py, and the
executor's own guarantees.

The JAX side runs its ``shard_map_compat`` on conftest's virtual CPU
devices; the port runs on a mesh of CPU chips, one thread a shard, with
inputs made from the same numpy seed.  The executor's own tests: every
replica of a replicated output is equal, two runs are bit-identical, a
shard that raises (or misses a rendezvous) makes the call raise in time
with no thread left, and the backward runs after every shard thread has
exited (a collective that blocked in its backward would hang there, so
it runs under a join timeout).
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

if not hasattr(jax, "shard_map"):
    pytest.skip("jax.shard_map (VMA tracking) not available in this jax",
                allow_module_level=True)

from parsec_tpu import parallel as jpar  # noqa: E402
from parsec_tpu_torch import parallel  # noqa: E402
from parsec_tpu_torch.parallel import shard_map as sm  # noqa: E402
from parsec_tpu_torch.parallel.mesh import (has_shard_map,  # noqa: E402
                                            match_vma, shard_map_fwd,
                                            vary_on)

P = parallel.spec
CPU = torch.device("cpu")
JOIN_S = 60.0        # a backward or a failing call ends well within this


def _mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return parallel.make_mesh(sizes=sizes, devices=[CPU] * n)


def _jmesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jpar.make_mesh(sizes=sizes, devices=jax.devices("cpu")[:n])


def _shard_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("ptt-shard-")]


# ---------------------------------------------------------------------- #
# tests/test_shard_map_compat.py, on the port                            #
# ---------------------------------------------------------------------- #
def test_has_shard_map_true_here():
    assert has_shard_map() and jpar.mesh.has_shard_map()


@pytest.mark.parametrize("axis,out_spec", [("tp", (None, "sp")),
                                           ("sp", ("tp", None))])
def test_axis_name_plumbing_psum_per_axis(axis, out_spec):
    """psum reduces over EXACTLY the named axis of the (tp 2, sp 2) mesh,
    as the JAX package's does."""
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    ref = np.asarray(jpar.shard_map_compat(
        lambda xs: jax.lax.psum(xs, axis), _jmesh(tp=2, sp=2),
        in_specs=JP("tp", "sp"), out_specs=JP(*out_spec))(jnp.asarray(x)))
    got = parallel.shard_map_compat(
        lambda xs: parallel.psum(xs, axis), _mesh(tp=2, sp=2),
        in_specs=P("tp", "sp"), out_specs=P(*out_spec))(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    want = x[:2] + x[2:] if axis == "tp" else x[:, :2] + x[:, 2:]
    np.testing.assert_array_equal(got.numpy(), want)


def test_replicated_output_spec():
    x = np.arange(8, dtype=np.float32)
    got = parallel.shard_map_compat(
        lambda xs: parallel.psum(xs.sum(), ("tp", "sp")), _mesh(tp=2, sp=2),
        in_specs=P(("tp", "sp")), out_specs=P())(torch.from_numpy(x))
    assert float(got) == float(x.sum())


def test_vary_on_promotes_scan_carry():
    """vary_on is the identity here (one graph has no varying axes); the
    scan-carry pattern it serves gives the JAX package's sum."""
    x = np.arange(16, dtype=np.float32)

    def body(xs):
        acc = vary_on(torch.zeros(()), ("sp",), like=xs)
        for v in xs:
            acc = acc + v
        return parallel.psum(acc, "sp")

    got = parallel.shard_map_compat(body, _mesh(sp=4), in_specs=P("sp"),
                                    out_specs=P())(torch.from_numpy(x))
    assert float(got) == float(x.sum())


def test_match_vma_promotes_to_reference():
    """match_vma is the identity; the running max over rows, reduced over
    sp (a psum of each shard's max in its own row), is the JAX pmax."""
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    ref = np.asarray(jpar.shard_map_compat(
        lambda xs: jax.lax.pmax(jax.lax.scan(
            lambda m, r: (jnp.maximum(m, r), ()),
            jpar.mesh.match_vma(jnp.full((2,), -1.0), xs), xs)[0], "sp"),
        _jmesh(sp=4), in_specs=JP("sp", None), out_specs=JP())(
            jnp.asarray(x)))

    def body(xs):
        m = match_vma(torch.full((2,), -1.0), xs)
        for row in xs:
            m = torch.maximum(m, row)
        mine = torch.zeros(4, 2)
        mine[parallel.axis_index("sp")] = m
        return parallel.psum(mine, "sp").amax(dim=0)

    got = parallel.shard_map_compat(body, _mesh(sp=4),
                                    in_specs=P("sp", None),
                                    out_specs=P())(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_match_vma_identity_outside_tracing():
    x = torch.ones(3)
    assert match_vma(x, x) is x and vary_on(x, ()) is x


def test_grad_of_replicated_leaf_is_presummed():
    """The gradient of a REPLICATED leaf through a psum'd forward sums its
    shards' contributions exactly once."""
    x = np.arange(4, dtype=np.float32) + 1.0
    jg = jax.grad(lambda w, xs: jpar.shard_map_compat(
        lambda w, xs: jax.lax.psum((w * xs).sum(), "sp"), _jmesh(sp=4),
        in_specs=(JP(), JP("sp")), out_specs=JP())(w, xs))(
            jnp.float32(2.0), jnp.asarray(x))
    w = torch.tensor(2.0, requires_grad=True)
    loss = parallel.shard_map_compat(
        lambda w, xs: parallel.psum((w * xs).sum(), "sp"), _mesh(sp=4),
        in_specs=(P(), P("sp")), out_specs=P())(w, torch.from_numpy(x))
    (g,) = torch.autograd.grad(loss, w)
    np.testing.assert_allclose(float(g), float(x.sum()), rtol=1e-6)
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-6)


def test_shard_map_fwd_matches_compat_forward():
    x = torch.arange(16, dtype=torch.float32)
    mesh = _mesh(tp=2, sp=2)
    a = parallel.shard_map_compat(lambda xs: xs * 2.0, mesh,
                                  in_specs=P(("tp", "sp")),
                                  out_specs=P(("tp", "sp")))(x)
    b = shard_map_fwd(lambda xs: xs * 2.0, mesh, in_specs=P(("tp", "sp")),
                      out_specs=P(("tp", "sp")))(x)
    assert torch.equal(a, b) and torch.equal(a, x * 2.0)


# ---------------------------------------------------------------------- #
# the other collectives against lax                                      #
# ---------------------------------------------------------------------- #
def test_ppermute_and_all_to_all_match_lax():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    perm = [(0, 2), (2, 1), (1, 3)]       # shard 0 receives nothing
    spec = (None, None, "sp")

    def jbody(xs):
        return (jax.lax.ppermute(xs, "sp", perm),
                jax.lax.all_to_all(xs, "sp", split_axis=1, concat_axis=2,
                                   tiled=True))

    def body(xs):
        return (parallel.ppermute(xs, "sp", perm),
                parallel.all_to_all(xs, "sp", split_axis=1, concat_axis=2))

    ref = jpar.shard_map_compat(jbody, _jmesh(sp=4), in_specs=JP(*spec),
                                out_specs=(JP(*spec), JP(*spec)))(
        jnp.asarray(x))
    got = parallel.shard_map_compat(body, _mesh(sp=4), in_specs=P(*spec),
                                    out_specs=(P(*spec), P(*spec)))(
        torch.from_numpy(x))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_collective_gradients_match_lax():
    """The VJPs of psum, pmean, ppermute and all_to_all (each one node
    over its group) against jax.grad of the same shard_map'd function."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(4, 8, 6)).astype(np.float32)
    w = rng.normal(size=(4, 8, 6)).astype(np.float32)
    perm = [(i, (i + 1) % 4) for i in range(4)]

    def jf(xs, ws):
        y = jax.lax.ppermute(jnp.tanh(xs), "sp", perm)
        y = jax.lax.all_to_all(y * ws, "sp", split_axis=1, concat_axis=0,
                               tiled=True)
        return jax.lax.psum((y ** 2).sum(), "sp") \
            + jax.lax.pmean(y.sum(), "sp")

    def f(xs, ws):
        y = parallel.ppermute(torch.tanh(xs), "sp", perm)
        y = parallel.all_to_all(y * ws, "sp", split_axis=1, concat_axis=0)
        return parallel.psum((y ** 2).sum(), "sp") \
            + parallel.pmean(y.sum(), "sp")

    spec = ("sp",)
    ref = jax.grad(lambda a, b: jpar.shard_map_compat(
        jf, _jmesh(sp=4), in_specs=(JP(*spec), JP(*spec)),
        out_specs=JP())(a, b), argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w)]
    loss = parallel.shard_map_compat(f, _mesh(sp=4),
                                     in_specs=(P(*spec), P(*spec)),
                                     out_specs=P())(*leaves)
    for a, b in zip(torch.autograd.grad(loss, leaves), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------- #
# the executor's own guarantees                                          #
# ---------------------------------------------------------------------- #
def test_every_replica_of_a_replicated_output_is_equal():
    """Each shard's copy of a psum'd value, stacked over every axis, is
    bit-equal to the value a P() output returns (shard 0's)."""
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(8, 5)).astype(np.float32))
    mesh = _mesh(dp=2, tp=2, sp=2)
    axes = ("dp", "tp", "sp")

    def body(xs):
        r = parallel.psum(torch.tanh(xs) * 3.0, axes)
        return r, r[None]

    one, every = parallel.shard_map_compat(
        body, mesh, in_specs=P(axes), out_specs=(P(), P(axes)))(x)
    assert every.shape == (8, 1, 5)
    for row in every:
        assert torch.equal(row, one)
    np.testing.assert_allclose(one.numpy(), torch.tanh(x).mul(3.0).sum(
        0, keepdim=True).numpy(), rtol=1e-6, atol=1e-6)


def _ring_loss(leaves, mesh):
    """A loss through every collective and the flash ring's group node
    (its kernel's plain version on the CPU)."""
    q, k, v, w = leaves

    def body(q, k, v, w):
        a = parallel.ring_attention(q, k, v, "sp", causal=True,
                                    use_kernel=True)
        b = parallel.ring_attention(q, k, v, "sp", causal=False,
                                    use_kernel=False)
        u = parallel.sequence_to_heads(parallel.heads_to_sequence(a + b))
        y = parallel.ppermute(u * w, "sp", [(i, (i + 1) % 4)
                                            for i in range(4)])
        return parallel.psum((y ** 2).sum(), ("dp", "sp"))

    spec = P("dp", None, "sp")
    return parallel.shard_map_compat(body, mesh, in_specs=(spec,) * 4,
                                     out_specs=P())(q, k, v, w)


def _qkvw(seed=3):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(size=(4, 4, 16, 8))
                             .astype(np.float32)).requires_grad_(True)
            for _ in range(4)]


def test_two_runs_are_bit_identical():
    mesh = _mesh(dp=2, sp=4)
    runs = []
    for _ in range(2):
        leaves = _qkvw()
        loss = _ring_loss(leaves, mesh)
        runs.append([loss] + list(torch.autograd.grad(loss, leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_backward_runs_after_every_shard_thread_exited():
    """The forward returns with every shard thread joined; the backward
    then runs alone, under a join timeout: a per-shard collective that
    waited for its peers in its backward would hang here."""
    leaves = _qkvw(4)
    loss = _ring_loss(leaves, _mesh(dp=2, sp=4))
    assert not _shard_threads()
    out = []
    t = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(loss, leaves)), daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "the backward did not finish"
    assert len(out) == 1 and all(torch.isfinite(g).all() for g in out[0])


def test_a_shard_that_raises_makes_the_call_raise(monkeypatch):
    monkeypatch.setattr(sm, "RENDEZVOUS_TIMEOUT", JOIN_S)

    def body(xs):
        if parallel.axis_index("sp") == 1:
            raise ValueError("shard one fails")
        return parallel.psum(xs, "sp")

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard one fails"):
        parallel.shard_map_compat(body, _mesh(dp=2, sp=4),
                                  in_specs=P("sp"), out_specs=P())(
            torch.arange(8.0))
    assert time.monotonic() - t0 < JOIN_S / 2
    assert not _shard_threads()


def test_a_missed_rendezvous_times_out_naming_the_shards(monkeypatch):
    monkeypatch.setattr(sm, "RENDEZVOUS_TIMEOUT", 0.5)

    def body(xs):
        if parallel.axis_index("sp") == 0:
            return xs                  # never joins its group's psum
        return parallel.psum(xs, "sp")

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"psum over \('sp',\).*missing"):
        parallel.shard_map_compat(body, _mesh(sp=4), in_specs=P("sp"),
                                  out_specs=P())(torch.arange(8.0))
    assert time.monotonic() - t0 < JOIN_S / 2
    assert not _shard_threads()


def test_the_timeout_bounds_a_stall_not_the_whole_run(monkeypatch):
    """A run longer than the timeout that keeps reaching its rendezvous
    completes; a shard that stays in its body past it makes the call
    raise, naming it."""
    monkeypatch.setattr(sm, "RENDEZVOUS_TIMEOUT", 0.5)

    def steady(xs):
        for _ in range(5):
            time.sleep(0.2)
            xs = parallel.psum(xs, "sp")
        return xs

    got = parallel.shard_map_compat(steady, _mesh(sp=2), in_specs=P("sp"),
                                    out_specs=P())(torch.ones(2))
    assert got.item() == 32.0

    def stalls(xs):
        if parallel.axis_index("sp") == 1:
            time.sleep(1.2)
        return parallel.psum(xs, "sp")

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"missing.*in their bodies: \[1\]"):
        parallel.shard_map_compat(stalls, _mesh(sp=2), in_specs=P("sp"),
                                  out_specs=P())(torch.ones(2))
    assert time.monotonic() - t0 < 2.5
    assert not _shard_threads()


def test_rendezvous_stress_under_fast_switching():
    """More shards than this test needs cores, a thread switch every
    microsecond, and hundreds of rendezvous: every psum's value is exact
    (a lost deposit or a crossed slot would change it)."""
    rounds = 200
    mesh = _mesh(dp=2, tp=2, sp=2)

    def body(xs):
        k = float(xs.item())
        out = []
        for r in range(rounds):
            out.append(parallel.psum(torch.tensor(k * 1000.0 + r),
                                     ("dp", "tp", "sp") if r % 2
                                     else "tp"))
        return torch.stack(out)[None]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = parallel.shard_map_compat(
            body, mesh, in_specs=P(("dp", "tp", "sp")),
            out_specs=P(("dp", "tp", "sp")))(torch.arange(8.0))
    finally:
        sys.setswitchinterval(old)
    for k in range(8):
        dp, tp, sp = k // 4, (k // 2) % 2, k % 2
        mates = [dp * 4 + t * 2 + sp for t in range(2)]
        for r in range(rounds):
            want = (sum(range(8)) * 1000.0 + 8 * r) if r % 2 else \
                (sum(mates) * 1000.0 + 2 * r)
            assert got[k, r].item() == want
    assert not _shard_threads()


def test_size_one_groups_are_the_identity_and_outside_is_size_one():
    x = torch.arange(6.0)
    assert parallel.psum(x, "tp") is x and parallel.axis_size("sp") == 1
    got = parallel.shard_map_compat(
        lambda xs: (parallel.psum(xs, "tp"), parallel.axis_size("sp"),
                    parallel.psum(1, "sp")),
        _mesh(sp=2), in_specs=P("sp"), out_specs=(P("sp"), P(), P()))(x)
    assert torch.equal(got[0], x) and got[1] == 2 and got[2] == 2
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_map_compat(lambda xs: xs, _mesh(sp=4),
                                  in_specs=P("sp"), out_specs=P("sp"))(x)
    assert sm.current_shard() is None
