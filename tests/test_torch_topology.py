"""Topology discovery and locality-aware scheduling in the port
(runtime/topology.py; the lfq steal chain of sched_lfq_module.c:59-199)
against the JAX package's: the cases of tests/test_topology.py, each
run through both packages, the observations compared and held to the
reference's values.  The DAG case holds the port's factor to the JAX
package's under every locality policy.
"""
import numpy as np
import pytest

import parsec_tpu
import parsec_tpu.runtime.topology
import parsec_tpu.sched
import parsec_tpu_torch
import parsec_tpu_torch.runtime.topology
import parsec_tpu_torch.sched

JAX = parsec_tpu
PORT = parsec_tpu_torch


def _both(fn):
    """``fn(package)`` through the JAX package and the port: the two
    observations, which must agree; returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want, (got, want)
    return got


def _init(m, nb_cores):
    if m is PORT:
        return m.init(nb_cores=nb_cores, device="cpu")
    return m.init(nb_cores=nb_cores)


def _fake_topo(m):
    """2 packages x 1 NUMA each x 2 L3-sharing pairs x SMT-2: cpus 0-7;
    (0,1) SMT on core A share L2; (0,1,2,3) share L3/numa0/pkg0; (4..7)
    mirror on package 1."""
    topo = m.runtime.topology
    cpus = {}
    for c in range(8):
        pkg = c // 4
        core = (pkg << 16) | ((c % 4) // 2)
        l2 = (c // 2) * 2          # SMT pair shares L2
        l3 = pkg * 4               # whole package shares L3
        cpus[c] = topo.CPUInfo(cpu=c, core=core, l2=l2, l3=l3, numa=pkg,
                               package=pkg)
    return topo.HostTopology(cpus)


def test_parse_cpulist():
    got = _both(lambda m: (m.runtime.topology.parse_cpulist("0-3,8,10-11"),
                           m.runtime.topology.parse_cpulist(""),
                           m.runtime.topology.parse_cpulist("5")))
    assert got == ([0, 1, 2, 3, 8, 10, 11], [], [5])


def test_distance_ladder():
    pairs = [(0, 0), (0, 1), (0, 2), (0, 4), (2, 3)]
    got = _both(lambda m: [_fake_topo(m).distance(a, b) for a, b in pairs])
    # self, SMT sibling, same L3, other package, SMT sibling
    assert got == [0, 1, 3, 6, 1]


def test_steal_order_is_locality_sorted():
    order = _both(lambda m: list(_fake_topo(m).steal_order(0, range(8))))
    # sibling first, then L3-mates, then the far package
    assert order[0] == 1
    assert set(order[1:3]) == {2, 3}
    assert set(order[3:]) == {4, 5, 6, 7}
    t = _fake_topo(PORT)
    d = [t.distance(0, c) for c in order]
    assert d == sorted(d), "steal order must be non-decreasing distance"


def test_discover_on_this_host():
    def discover(m):
        t = m.runtime.topology.HostTopology.discover()
        return sorted(t.cpus), all(t.distance(c, c) == 0 for c in t.cpus)
    cpus, zero = _both(discover)
    assert len(cpus) >= 1 and zero


def _ctx_with_fake_binding(m, nb_cores, sched, topo, binding):
    ctx = _init(m, nb_cores)
    ctx._topology_override = topo
    ctx._topo_binding_override = binding
    ctx.scheduler = m.sched.sched_new(sched)
    ctx.scheduler.install(ctx)
    for es in ctx.execution_streams:
        ctx.scheduler.flow_init(es)
    return ctx


def _lfq_chain(m):
    topo = _fake_topo(m)
    binding = {0: 0, 1: 4, 2: 1, 3: 2}   # th1 is FAR (pkg1), th2 SMT-near
    ctx = _ctx_with_fake_binding(m, 4, "lfq", topo, binding)
    try:
        chain = ctx.scheduler.steal_chain(ctx.execution_streams[0])
        return [binding[p.th_id] for p in chain], chain[0].th_id
    finally:
        ctx.fini()


def test_lfq_steal_chain_locality_ordered():
    """With bound threads the lfq steal chain walks nearest-first, not
    the id ring."""
    cores, first = _both(_lfq_chain)
    topo = _fake_topo(PORT)
    dists = [topo.distance(0, c) for c in cores]
    assert dists == sorted(dists)
    assert cores[0] == 1            # SMT sibling stolen from first
    assert cores[-1] == 4           # far package last
    assert first != 1               # not the plain id ring


def _lhq_groups(m):
    topo = _fake_topo(m)
    binding = {0: 0, 1: 1, 2: 4, 3: 5}   # two per package
    ctx = _ctx_with_fake_binding(m, 4, "lhq", topo, binding)
    try:
        es = ctx.execution_streams
        return ([es[0]._lhq_gid == es[1]._lhq_gid,
                 es[2]._lhq_gid == es[3]._lhq_gid,
                 es[0]._lhq_gid != es[2]._lhq_gid],
                len(ctx.scheduler._group_queues))
    finally:
        ctx.fini()


def test_lhq_groups_by_l3_domain():
    """lhq's middle level is the topology's L3 domain when bound: ESes on
    one package share a queue, the far package gets its own."""
    assert _both(_lhq_groups) == ([True, True, True], 2)


def _lhq_unbound(m):
    ctx = _init(m, 2)
    try:
        sched = m.sched.sched_new("lhq")
        sched.install(ctx)
        for es in ctx.execution_streams:
            sched.flow_init(es)
        return [es._lhq_gid[0] for es in ctx.execution_streams]
    finally:
        ctx.fini()


def test_lhq_unbound_falls_back_to_vp():
    assert _both(_lhq_unbound) == ["vp", "vp"]


def _factor(m, sched, M):
    from importlib import import_module
    T = import_module(m.__name__ + ".collections").TwoDimBlockCyclic
    ops = import_module(m.__name__ + ".ops")
    params = import_module(m.__name__ + ".utils.params").params
    with params.cmdline_override("sched", sched):
        ctx = _init(m, 2)
        try:
            A = T(512, 512, 128, 128, dtype=np.float32).from_numpy(M)
            ctx.add_taskpool(ops.dpotrf_taskpool(A))
            ctx.wait()
            return np.tril(A.to_numpy())
        finally:
            ctx.fini()


@pytest.mark.parametrize("sched", ["lfq", "lhq", "ltq"])
def test_schedulers_still_run_dags(sched):
    """Each locality policy still runs a real DAG: the port's dpotrf
    factor within 5e-4 of the JAX package's (fp32 tiles; the two
    packages' GEMMs sum in other orders) and of numpy's Cholesky."""
    M = parsec_tpu_torch.ops.make_spd(512, dtype=np.float32)
    got, want = _factor(PORT, sched, M), _factor(JAX, sched, M)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert np.allclose(got.astype(np.float64),
                       np.linalg.cholesky(M.astype(np.float64)), atol=1e-2)
