"""The data substrate of the port (coherency protocol, arenas, data
repos) against the JAX package's: the cases of tests/test_data_coherency.py,
each run through both packages, the observations compared and held to
the reference's values (parsec/data.c's ownership-transfer semantics,
parsec_data_transfer_ownership_to_copy, parsec/data.c:286-370).
"""
import numpy as np

import parsec_tpu.data.arena
import parsec_tpu.data.data
import parsec_tpu.data.datarepo
import parsec_tpu.data.datatype
import parsec_tpu_torch.data.arena
import parsec_tpu_torch.data.data
import parsec_tpu_torch.data.datarepo
import parsec_tpu_torch.data.datatype

JAX = parsec_tpu
PORT = parsec_tpu_torch


def _both(fn):
    """``fn(package)`` through the JAX package and the port: the two
    observations, which must agree; returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want, (got, want)
    return got


def _single_copy_owned(m):
    d = m.data.data.data_new_with_payload(np.zeros(4))
    c = d.get_copy(0)
    return c.coherency.name, c.version, d.owner_device


def test_single_copy_owned():
    assert _both(_single_copy_owned) == ("OWNED", 1, 0)


def _read_transfer(m):
    dd = m.data.data
    d = dd.data_new_with_payload(np.arange(4.0))
    dev_copy = dd.DataCopy(d, 1)
    d.attach_copy(dev_copy)
    src = d.start_transfer_ownership(1, dd.FlowAccess.READ)
    from_host = src is d.get_copy(0)
    dev_copy.payload = src.payload.copy()
    d.complete_transfer_ownership(1, dd.FlowAccess.READ)
    return (from_host, dev_copy.coherency.name, dev_copy.version,
            dev_copy.readers, d.get_copy(0).coherency.name)


def test_read_transfer_creates_shared():
    # the host copy stays the owner
    assert _both(_read_transfer) == (True, "SHARED", 1, 1, "OWNED")


def _write_transfer(m):
    dd = m.data.data
    d = dd.data_new_with_payload(np.arange(4.0))
    dev_copy = dd.DataCopy(d, 1)
    d.attach_copy(dev_copy)
    src = d.start_transfer_ownership(1, dd.FlowAccess.RW)
    dev_copy.payload = src.payload.copy()
    d.complete_transfer_ownership(1, dd.FlowAccess.RW)
    before = (dev_copy.coherency.name, d.owner_device,
              d.get_copy(0).coherency.name)
    v = d.version_bump(1)
    return before + (v, d.newest_copy() is dev_copy)


def test_write_transfer_moves_ownership():
    assert _both(_write_transfer) == ("OWNED", 1, "SHARED", 2, True)


def _valid_copy(m):
    dd = m.data.data
    d = dd.data_new_with_payload(np.zeros(2))
    return d.start_transfer_ownership(0, dd.FlowAccess.READ) is None


def test_valid_copy_no_transfer_needed():
    assert _both(_valid_copy) is True


def _newest_after_device_write(m):
    dd = m.data.data
    d = dd.data_new_with_payload(np.zeros(2))
    dev = dd.DataCopy(d, 1, payload=np.ones(2))
    d.attach_copy(dev)
    d.complete_transfer_ownership(1, dd.FlowAccess.RW)
    d.version_bump(1)
    # host now stale: a host reader must pull from device 1
    src = d.start_transfer_ownership(0, dd.FlowAccess.READ)
    return src is dev, src.version


def test_newest_copy_after_device_write():
    assert _both(_newest_after_device_write) == (True, 2)


def _arena_caps(m):
    dtt = m.data.datatype.Datatype(np.float32, (8, 8))
    ar = m.data.arena.Arena(dtt, max_used=2, max_cached=1)
    b1 = ar.allocate()
    b2 = ar.allocate()
    capped = ar.allocate(block=False) is None  # max_used cap
    ar.free(b1)
    b3 = ar.allocate()
    recycled = b3 is b1
    ar.free(b2)
    ar.free(b3)
    return capped, recycled, ar.cached, ar.used   # max_cached cap


def test_arena_reuse_and_caps():
    assert _both(_arena_caps) == (True, True, 1, 0)


def _arena_copy(m):
    dtt = m.data.datatype.Datatype(np.float64, (4,))
    ar = m.data.arena.Arena(dtt, max_used=4, max_cached=4)
    c = ar.new_copy(m.data.data.Data())
    used = ar.used
    c.release()
    return used, ar.used, ar.cached


def test_arena_backed_copy_recycles_on_release():
    assert _both(_arena_copy) == (1, 0, 1)


def _regions(m):
    Datatype = m.data.datatype.Datatype
    dtt = Datatype(np.float32, (3, 3), region="lower")
    mask = dtt.mask()
    full = dtt.contiguous()
    return (mask.tolist(), dtt.nb_elts, full.mask() is None,
            dtt.compatible_wire(full))


def test_datatype_regions():
    mask, nb_elts, full_unmasked, compatible = _both(_regions)
    assert mask[2][0] and mask[1][1] and not mask[0][2]
    assert nb_elts == 9 and full_unmasked and not compatible


def _dtt_of_array(m):
    dtt = m.data.datatype.dtt_of_array(np.zeros((5, 3), np.float32))
    return tuple(dtt.shape), np.dtype(dtt.dtype).name, dtt.nb_elts


def test_dtt_of_array():
    assert _both(_dtt_of_array) == ((5, 3), "float32", 15)


def _repo(m):
    repo = m.data.datarepo.DataRepo(nb_flows=2)
    e = repo.lookup_and_create("k")
    e.set_output(0, None)
    repo.entry_addto_usage_limit("k", 2)
    seen = [repo.lookup("k") is e]
    repo.entry_used_once("k")
    seen.append(repo.lookup("k") is e)   # one consumer left + producer
    repo.entry_release("k")              # producer done
    seen.append(repo.lookup("k") is e)
    repo.entry_used_once("k")            # last consumer
    seen.append(repo.lookup("k") is None)
    return tuple(seen), len(repo)


def test_datarepo_usage_count_reclaim():
    assert _both(_repo) == ((True, True, True, True), 0)
