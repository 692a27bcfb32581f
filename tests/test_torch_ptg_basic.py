"""The PTG front end of the port (dsl/ptg: parsing, instantiation, the
dynamic runtime over host bodies) against the JAX package's: the cases
of tests/test_ptg_basic.py (the reference's tutorial examples Ex02,
Ex04_ChainData and Ex05_Broadcast and its tests/dsl/ptg), each run
through both packages on the CPU, the observations compared and held to
the reference's values.
"""
import numpy as np
import pytest

import parsec_tpu
import parsec_tpu.collections.collection
import parsec_tpu.dsl.ptg
import parsec_tpu_torch
import parsec_tpu_torch.collections.collection
import parsec_tpu_torch.dsl.ptg

JAX = parsec_tpu
PORT = parsec_tpu_torch

CHAIN_JDF = """
mydata  [ type="collection" ]
NB      [ type="int" ]

Task(k)

k = 0 .. NB

: mydata( k )

RW  A <- (k == 0)  ? mydata( k ) : A Task( k-1 )
      -> (k == NB) ? mydata( k ) : A Task( k+1 )

BODY
{
    A[0] += 1
}
END
"""

BCAST_JDF = """
mydata  [ type="collection" ]
NB      [ type="int" hidden=on default="(6)" ]

TaskBcast(k)

k = 0 .. 0

: mydata( k )

RW  A <- mydata( k )
      -> A TaskRecv( 0 .. NB .. 2 )

BODY
{
    A[0] = 42.0
}
END

TaskRecv(n)

n = 0 .. NB .. 2

: mydata( n )

READ A <- A TaskBcast( 0 )

BODY
{
    sink(n, A[0])
}
END
"""

CTL_JDF = """
NT [ type="int" ]
dummy [ type="collection" ]

First(k)

k = 0 .. NT

: dummy( k )

CTL X -> X Second( k )

BODY
{
    order.append(("first", k))
}
END

Second(k)

k = 0 .. NT

: dummy( k )

CTL X <- X First( k )

BODY
{
    order.append(("second", k))
}
END
"""

DIAMOND_JDF = """
A_coll [ type="collection" ]

Top(k)
k = 0 .. 0
: A_coll( 0 )
RW  A <- A_coll( 0 )
      -> A Left( 0 )
      -> A Right( 0 )
BODY
{
    A[0] = 1.0
}
END

Left(k)
k = 0 .. 0
: A_coll( 0 )
READ A <- A Top( 0 )
CTL  X -> X Bottom( 0 )
BODY
{
    log.append(("L", A[0]))
}
END

Right(k)
k = 0 .. 0
: A_coll( 0 )
READ A <- A Top( 0 )
CTL  X -> X Bottom( 0 )
BODY
{
    log.append(("R", A[0]))
}
END

Bottom(k)
k = 0 .. 0
: A_coll( 0 )
CTL X <- X Left( 0 )
      <- X Right( 0 )
BODY
{
    log.append(("B", None))
}
END
"""

PRIO_JDF = """
NT [ type="int" ]
dummy [ type="collection" ]

T(k)
k = 0 .. NT
: dummy( k )
; k
BODY
{
    out.append(k)
}
END
"""

GUARD_SINGLE_JDF = """
NT [ type="int" ]
dummy [ type="collection" ]

P(k)
k = 0 .. NT
: dummy( k )
RW A <- dummy( k )
     -> (k < NT) ? A C( k+1 )
BODY
{
    A[0] = k
}
END

C(k)
k = 1 .. NT
: dummy( k )
READ A <- A P( k-1 )
BODY
{
    got.append((k, A[0]))
}
END
"""

NULL_INPUT_JDF = """
dummy [ type="collection" ]
NT [ type="int" ]

T(k)
k = 0 .. NT-1
: dummy( k )
READ A <- (k > 0) ? dummy( k-1 )
BODY
{
    got.append((k, None if A is None else float(A[0, 0])))
}
END
"""



def _both(fn):
    """``fn(package)`` through the JAX package and the port: the two
    observations, which must agree; returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want, (got, want)
    return got


def _f(v):
    """A host body's value (a one-element array, or a scalar) as a float."""
    return float(np.asarray(v).reshape(-1)[0])


def _ctx(m, **kw):
    if m is PORT:
        kw["device"] = "cpu"
    return m.init(nb_cores=kw.pop("nb_cores", 2), **kw)


def _run(m, jdf, name, setup, **globals_):
    """Compile ``jdf`` in package ``m``, instantiate it with ``globals_``,
    let ``setup(tp)`` bind host-side names, run it on a fresh context;
    returns the taskpool."""
    ctx = _ctx(m)
    try:
        tp = m.dsl.ptg.compile_jdf(jdf, name=name).new(**globals_)
        setup(tp)
        ctx.add_taskpool(tp)
        ctx.wait()
        return tp
    finally:
        ctx.fini()


def _chain(m):
    arr = np.array([[300.0]])
    Dict = m.collections.collection.DictCollection

    # single-datum collection where every index maps to datum 0 (the Ex04
    # pattern: one memory cell walked by the whole chain)
    class Single(Dict):
        def data_of(self, *idx):
            return Dict.data_of(self, 0)

        def rank_of(self, *idx):
            return 0
    s = Single()
    s.add(0, 0, arr[0])
    tp = _run(m, CHAIN_JDF, "chain", lambda tp: None, mydata=s, NB=20)
    return tp.completed, tp.nb_local_tasks, float(arr[0, 0])


def test_chain_data():
    """Ex04_ChainData: a chain of NB+1 tasks each incrementing the datum."""
    assert _both(_chain) == (True, 21, 321.0)


def _bcast(m):
    received = []
    coll = m.collections.collection.LocalArrayCollection(np.zeros((8, 1)), 8)

    def setup(tp):
        tp.global_env["sink"] = lambda n, v: received.append((n, _f(v)))
    tp = _run(m, BCAST_JDF, "bcast", setup, mydata=coll)
    return sorted(received), tp.nb_local_tasks


def test_broadcast_range_fanout():
    """Ex05: one producer broadcasts to a strided range of consumers."""
    assert _both(_bcast) == ([(0, 42.0), (2, 42.0), (4, 42.0), (6, 42.0)],
                             1 + 4)


def _no_data(m):
    class NoData(m.collections.collection.DictCollection):
        def rank_of(self, *i):
            return 0
    return NoData()


def _ctl(m):
    order = []

    def setup(tp):
        tp.global_env["order"] = order
    _run(m, CTL_JDF, "ctl", setup, NT=5, dummy=_no_data(m))
    return len(order), all(order.index(("first", k))
                           < order.index(("second", k)) for k in range(6))


def test_ctl_flow_ordering():
    """Pure control dependencies order tasks without moving data (ref:
    tests/dsl/ptg controlgather)."""
    assert _both(_ctl) == (12, True)


def _diamond(m):
    log = []
    coll = m.collections.collection.LocalArrayCollection(np.zeros((1, 1)), 1)

    def setup(tp):
        tp.global_env["log"] = log
    _run(m, DIAMOND_JDF, "diamond", setup, A_coll=coll)
    return (len(log), log[-1], sorted(tag for tag, _v in log[:2]),
            [_f(v) for _t, v in log[:2]])


def test_diamond_multi_input():
    """A task with two task-sourced inputs fires exactly once, after both."""
    assert _both(_diamond) == (3, ("B", None), ["L", "R"], [1.0, 1.0])


def _prio(m):
    ctx = m.Context(nb_cores=1, scheduler="ap",
                    **({"device": "cpu"} if m is PORT else {}))
    try:
        out = []
        tp = m.dsl.ptg.compile_jdf(PRIO_JDF, name="prio").new(
            NT=9, dummy=_no_data(m))
        tp.global_env["out"] = out
        ctx.add_taskpool(tp)
        ctx.wait()
        return out
    finally:
        ctx.fini()


def test_priority_expression():
    """Higher-priority instances run first under the ap scheduler."""
    assert _both(_prio) == list(range(9, -1, -1))


BAD_JDFS = [
    "T(k)\nk = 0 .. 3\n: c( k )\nBODY\nx\nEND\n",      # unknown coll
    "c [type=x]\nT(k)\nk = 0 .. 3\n: c( k )\n",         # no body
    """
c [type=x]
T(k)
k = 0 .. 1
: c( k )
RW A <- c( k ) -> A Nope( k )
BODY
x = 1
END
""",                                                     # unknown class
]


@pytest.mark.parametrize("case", range(len(BAD_JDFS)))
def test_parse_errors(case):
    """Both packages refuse the same malformed specs."""
    def refuse(m):
        try:
            m.dsl.ptg.compile_jdf(BAD_JDFS[case])
        except m.dsl.ptg.JDFParseError:
            return "JDFParseError"
        return None
    assert _both(refuse) == "JDFParseError"


def _missing_global(m):
    f = m.dsl.ptg.compile_jdf(PRIO_JDF, name="prio")
    seen = []
    for kw in ({"NT": 3}, {"NT": 3, "dummy": None, "extra": 1}):
        try:
            f.new(**kw)
            seen.append(None)
        except TypeError:
            seen.append("TypeError")
    return seen


def test_missing_global_raises():
    """A missing global and an unknown one are TypeErrors."""
    assert _both(_missing_global) == ["TypeError", "TypeError"]


def _guard(m):
    got = []
    coll = m.collections.collection.LocalArrayCollection(np.zeros((8, 1)), 8)

    def setup(tp):
        tp.global_env["got"] = got
    _run(m, GUARD_SINGLE_JDF, "guard", setup, NT=3, dummy=coll)
    return sorted((k, _f(v)) for k, v in got)


def test_guarded_single_target_dep():
    """``(cond) ? target`` with no alternative: the edge exists only when
    the guard holds."""
    assert _both(_guard) == [(1, 0.0), (2, 1.0), (3, 2.0)]


def _null_input(m):
    got = []
    arr = np.arange(8, dtype=np.float64).reshape(8, 1)
    coll = m.collections.collection.LocalArrayCollection(arr, 8)

    def setup(tp):
        tp.global_env["got"] = got
    _run(m, NULL_INPUT_JDF, "nullin", setup, NT=3, dummy=coll)
    return sorted(got, key=lambda x: x[0])


def test_null_input_when_all_guards_false():
    """A guarded input dep with no ':' alternative binds NULL (None) where
    the guard is false."""
    assert _both(_null_input) == [(0, None), (1, 0.0), (2, 1.0)]
