"""Reshape scenarios of the port (dsl/ptg/runtime.py's ``[type]``,
``[type_remote]`` and ``[type_data]`` properties, data/reshape.py)
against the JAX package's: the cases of tests/test_reshape_parity.py
(the reference's tests/collections/reshape/), each run through both
packages on the CPU — one rank, or two rank threads over the in-process
fabric — the tiles, what the bodies saw and the reshape repository's
conversion counts compared, and held to the reference's values.

Property semantics (parsec_reshape.c):
- ``[type=T]``        local reshape: consumers get a converted copy;
- ``[type_remote=T]`` wire type only: reshapes cross-rank edges, is
                      IGNORED on local edges (pointer semantics);
- ``[type_data=T]``   datatype reading from / writing back to the matrix
                      (masked writeback: elements outside the region keep
                      their old values).
"""
from importlib import import_module

import numpy as np

import parsec_tpu
import parsec_tpu_torch

JAX = parsec_tpu
PORT = parsec_tpu_torch
N = 4

LOCAL_NO_RESHAPE = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A SET_ZEROS( 0 )   [type_remote=lower]
BODY
{
}
END

SET_ZEROS(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- A READ_A( 0 )      [type_remote=lower]
     -> descA( 0, 0 )
BODY
{
    A[:] = 0.0
}
END
"""

AVOIDABLE = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )      [type_data=full]
     -> A WRITE_A( 0 )
BODY
{
}
END

WRITE_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- A READ_A( 0 )
     -> descA( 0, 0 )      [type=full type_data=full]
BODY
{
    A[:] = 0.0
}
END
"""

LOCAL_INPUT_RESHAPE = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A SET_ZEROS( 0 )
BODY
{
}
END

SET_ZEROS(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- A READ_A( 0 )      [type=lower]
     -> A WRITE_A( 0 )
BODY
{
    out['seen_by_zeros'] = np.array(A)
    A[:] = 0.0
}
END

WRITE_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- A SET_ZEROS( 0 )
     -> descA( 0, 0 )      [type=lower type_data=lower]
BODY
{
}
END
"""

LOCAL_OUTPUT_RESHAPE = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A SET_ZEROS( 0 )   [type=lower]
BODY
{
}
END

SET_ZEROS(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- A READ_A( 0 )
     -> descA( 0, 0 )      [type=lower type_data=lower]
BODY
{
    out['seen_by_zeros'] = np.array(A)
    A[:] = 0.0
}
END
"""

LOCAL_READ_RESHAPE = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )      [type_data=lower]
     -> descA( 0, 0 )      [type=lower type_data=lower]
BODY
{
    out['seen'] = np.array(A)
    A[:] = 0.0
}
END
"""

LU_LL = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A UP( 0 )
     -> A LO( 0 )
BODY
{
}
END

UP(k)
k = 0 .. 0
: descA( 0, 0 )
READ A <- A READ_A( 0 )    [type=upper]
BODY
{
    out['upper'] = np.array(A)
}
END

LO(k)
k = 0 .. 0
: descA( 0, 0 )
READ A <- A READ_A( 0 )    [type=lower]
BODY
{
    out['lower'] = np.array(A)
}
END
"""

SINGLE_COPY = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A CONS( 0 .. 3 )
BODY
{
}
END

CONS(k)
k = 0 .. 3
: descA( 0, 0 )
READ A <- A READ_A( 0 )    [type=lower]
BODY
{
    out[('seen', k)] = np.array(A)
}
END
"""

REMOTE_READ = """
descA [ type="collection" ]
out [ type="object" ]

Prod(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A Cons( 0 )
BODY
{
    A += 1.0
}
END

Cons(k)
k = 0 .. 0
: descA( 1, 0 )
READ A <- A Prod( 0 )      [type_remote=lower]
BODY
{
    out['seen'] = np.array(A)
}
END
"""

REMOTE_NO_RE_RESHAPE = """
descA [ type="collection" ]
out [ type="object" ]

Prod(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )      [type_data=lower]
     -> A Cons( 0 )        [type=lower]
BODY
{
}
END

Cons(k)
k = 0 .. 0
: descA( 1, 0 )
READ A <- A Prod( 0 )      [type_remote=lower]
BODY
{
    out['seen'] = np.array(A)
}
END
"""

REMOTE_MULTI_OUTS = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A TASK_A( 0 )      [type_remote=upper]
     -> B TASK_A( 0 )      [type_remote=lower]
BODY
{
}
END

TASK_A(k)
k = 0 .. 0
: descA( 1, 0 )
RW A <- A READ_A( 0 )      [type_remote=upper]
     -> descA( 1, 0 )
READ B <- A READ_A( 0 )    [type_remote=lower]
BODY
{
    out['A'] = np.array(A)
    out['B'] = np.array(B)
    A[:] = np.triu(A) + np.tril(B, -1)
}
END
"""

REMOTE_MULTI_DEPS = """
descA [ type="collection" ]
out [ type="object" ]

READ_A(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> A UP( 0 )          [type_remote=upper]
     -> A LO( 0 )          [type_remote=lower]
BODY
{
}
END

UP(k)
k = 0 .. 0
: descA( 1, 0 )
READ A <- A READ_A( 0 )    [type_remote=upper]
BODY
{
    out['upper'] = np.array(A)
}
END

LO(k)
k = 0 .. 0
: descA( 1, 0 )
READ A <- A READ_A( 0 )    [type_remote=lower]
BODY
{
    out['lower'] = np.array(A)
}
END
"""

HOME_MASKED_WB = """
descA [ type="collection" ]
out [ type="object" ]

ZERO_LOWER(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> descA( 0, 0 )      [type_data=lower]
BODY
{
    A[:] = 0.0
}
END
"""

DEVICE_THEN_MASKED_WB = """
descA [ type="collection" ]
out [ type="object" ]

Dev(k)
k = 0 .. 0
: descA( 0, 0 )
RW A <- descA( 0, 0 )
     -> descA( 0, 0 )
CTL C -> C WB( 0 )
BODY [type=tpu]
{
    A = A * 3.0
}
END

WB(k)
k = 0 .. 0
: descA( 0, 0 )
CTL C <- C Dev( 0 )
RW A <- descA( 0, 0 )
     -> descA( 0, 0 )      [type_data=lower]
BODY
{
    A = A + 10.0
}
END
"""



def _base():
    return np.arange(N * N, dtype=np.float64).reshape(N, N) + 1.0


def _pkg(m, jdf):
    """The package's pieces, and ``jdf`` in its dialect (the port's
    device bodies are ``type=cuda``)."""
    ptg = import_module(m.__name__ + ".dsl.ptg")
    T = import_module(m.__name__ + ".collections").TwoDimBlockCyclic
    if m is PORT:
        jdf = jdf.replace("[type=tpu]", "[type=cuda]")
    return ptg, T, jdf


def _run_local(m, jdf_text, name):
    """One rank: returns (the tile, what the bodies left in ``out``, the
    reshape repository's conversions and hits)."""
    ptg, T, jdf_text = _pkg(m, jdf_text)
    ctx = (m.init(nb_cores=1, device="cpu") if m is PORT
           else m.init(nb_cores=1))
    try:
        coll = T(N, N, N, N, dtype=np.float64)
        coll.name = "descA"
        coll.from_numpy(_base())
        out = {}
        tp = ptg.compile_jdf(jdf_text, name=name).new(descA=coll, out=out)
        ctx.add_taskpool(tp)
        ctx.wait()
        st = tp.reshape_repo.stats
        return (np.array(coll.data_of(0, 0).host_copy().payload), out,
                (st["conversions"], st["hits"]))
    finally:
        ctx.fini()


def _run_remote(m, jdf_text, name):
    """Two rank threads over the package's in-process fabric: returns
    (per rank what the bodies left in ``out``, rank 1's tile, per rank
    the reshape repository's conversions)."""
    ptg, T, jdf_text = _pkg(m, jdf_text)
    RemoteDepEngine = import_module(m.__name__ + ".comm").RemoteDepEngine
    spmd_threads = import_module(m.__name__ + ".utils.spmd").spmd_threads
    outs = [dict() for _ in range(2)]
    tiles = [None, None]

    def rank_fn(rank, fabric):
        eng = RemoteDepEngine(fabric.engine(rank))
        ctx = (m.Context(nb_cores=1, comm=eng, device="cpu") if m is PORT
               else m.Context(nb_cores=1, comm=eng, enable_tpu=False))
        try:
            coll = T(2 * N, N, N, N, P=2, Q=1, nodes=2, rank=rank,
                     dtype=np.float64)
            coll.name = "descA"
            coll.from_numpy(np.vstack([_base(), np.zeros((N, N))]))
            tp = ptg.compile_jdf(jdf_text, name=name).new(
                descA=coll, out=outs[rank], rank=rank, nb_ranks=2)
            ctx.add_taskpool(tp)
            ctx.wait()
            if coll.rank_of(1, 0) == rank:
                tiles[1] = np.array(coll.data_of(1, 0).host_copy().payload)
            return tp.reshape_repo.stats["conversions"]
        finally:
            ctx.fini()

    conversions, _ = spmd_threads(2, rank_fn, timeout=60)
    return outs, tiles[1], conversions


def _same(got, want):
    """Arrays, dicts of arrays and counts, compared exactly."""
    if isinstance(got, dict):
        assert sorted(got, key=repr) == sorted(want, key=repr), (got, want)
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        assert got == want, (got, want)


def _local(jdf, name):
    got = _run_local(PORT, jdf, name)
    _same(got, _run_local(JAX, jdf, name))
    return got


def _remote(jdf, name):
    got = _run_remote(PORT, jdf, name)
    _same(got, _run_remote(JAX, jdf, name))
    return got


def test_local_no_reshape_type_remote_ignored():
    """type_remote only: the ORIGINAL copy passes; zeroing it zeroes the
    whole tile."""
    tile, _, (conv, _h) = _local(LOCAL_NO_RESHAPE, "local_no_reshape")
    np.testing.assert_array_equal(tile, np.zeros((N, N)))
    assert conv == 0


def test_avoidable_reshape_no_spurious_copy():
    """The default type everywhere: no spurious copy."""
    tile, _, (conv, _h) = _local(AVOIDABLE, "avoidable")
    np.testing.assert_array_equal(tile, np.zeros((N, N)))
    assert conv == 0


def test_local_input_reshape_masked_writeback():
    """[type] on an input dep converts for the successors; the masked
    [type_data] writeback zeroes ONLY the lower region."""
    base = _base()
    tile, out, (conv, _h) = _local(LOCAL_INPUT_RESHAPE,
                                   "local_input_reshape")
    np.testing.assert_array_equal(out["seen_by_zeros"], np.tril(base))
    np.testing.assert_array_equal(tile, np.triu(base, 1))
    assert conv == 1


def test_local_output_reshape_on_out_dep():
    """[type] on the producer's OUT dep."""
    base = _base()
    tile, out, (conv, _h) = _local(LOCAL_OUTPUT_RESHAPE,
                                   "local_output_reshape")
    np.testing.assert_array_equal(out["seen_by_zeros"], np.tril(base))
    np.testing.assert_array_equal(tile, np.triu(base, 1))
    assert conv == 1


def test_local_read_reshape_from_memory():
    """[type_data] reading from the matrix; the home tile is not mutated
    by the read-side conversion."""
    base = _base()
    tile, out, (conv, _h) = _local(LOCAL_READ_RESHAPE, "local_read_reshape")
    np.testing.assert_array_equal(out["seen"], np.tril(base))
    np.testing.assert_array_equal(tile, np.triu(base, 1))
    assert conv == 1


def test_local_input_LU_LL_chained_reshapes():
    """Two DIFFERENT types of the same copy: two conversions."""
    base = _base()
    _, out, (conv, _h) = _local(LU_LL, "lu_ll")
    np.testing.assert_array_equal(out["upper"], np.triu(base))
    np.testing.assert_array_equal(out["lower"], np.tril(base))
    assert conv == 2


def test_input_dep_single_copy_shared():
    """Four consumers share ONE converted copy."""
    base = _base()
    _, out, (conv, hits) = _local(SINGLE_COPY, "single_copy")
    for k in range(4):
        np.testing.assert_array_equal(out[("seen", k)], np.tril(base))
    assert conv == 1 and hits >= 3


def test_remote_read_reshape():
    """A cross-rank edge typed lower: converted once, on the wire path."""
    base = _base()
    outs, _, conv = _remote(REMOTE_READ, "remote_read")
    np.testing.assert_array_equal(outs[1]["seen"], np.tril(base + 1.0))
    assert "seen" not in outs[0]
    assert sum(conv) == 1


def test_remote_no_re_reshape():
    """The producer's copy is already lower-typed: the consumer's matching
    type_remote does NOT reconvert (one conversion in all)."""
    base = _base()
    outs, _, conv = _remote(REMOTE_NO_RE_RESHAPE, "no_re_reshape")
    np.testing.assert_array_equal(outs[1]["seen"], np.tril(base))
    assert sum(conv) == 1


def test_remote_multiple_outs_same_pred_flow():
    """One producer flow shipped under TWO wire types to two flows of the
    same consumer (the upper + lower merge)."""
    base = _base()
    outs, tile, _ = _remote(REMOTE_MULTI_OUTS, "multi_outs")
    np.testing.assert_array_equal(outs[1]["A"], np.triu(base))
    np.testing.assert_array_equal(outs[1]["B"], np.tril(base))
    np.testing.assert_array_equal(tile, np.triu(base) + np.tril(base, -1))


def test_remote_multiple_outs_multiple_deps():
    """One producer flow feeding DIFFERENT consumer classes under
    different wire types."""
    base = _base()
    outs, _, _ = _remote(REMOTE_MULTI_DEPS, "multi_deps")
    np.testing.assert_array_equal(outs[1]["upper"], np.triu(base))
    np.testing.assert_array_equal(outs[1]["lower"], np.tril(base))


def test_masked_writeback_of_home_bound_flow():
    """A body that zeroes a home-bound flow in place: only the lower
    region lands, the upper part keeps the ORIGINAL values."""
    tile, _, _ = _local(HOME_MASKED_WB, "home_masked")
    np.testing.assert_array_equal(tile, np.triu(_base(), 1))


def test_masked_writeback_sees_device_resident_newest():
    """A device chore leaves A*3 newest on the device; the masked binding
    pulls that version before detaching: lower 3*base+10, upper 3*base."""
    base = _base()
    tile, _, _ = _local(DEVICE_THEN_MASKED_WB, "dev_masked")
    expect = np.where(np.tril(np.ones((N, N), bool)),
                      3.0 * base + 10.0, 3.0 * base)
    np.testing.assert_array_equal(tile, expect)
