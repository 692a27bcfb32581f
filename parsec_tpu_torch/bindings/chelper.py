"""Python side of the C embedding API (imported by parsec_tpu_c.c).

The C shim keeps opaque PyObject handles and calls these functions; task
bodies are C function pointers invoked through ctypes with raw tile
buffer addresses (ref: the Fortran bindings delegate the same way into
the C runtime, parsec/fortran/parsecf.F90).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import numpy as np

import parsec_tpu_torch
from parsec_tpu_torch import dtd
from parsec_tpu_torch.dsl.dtd import INOUT, INPUT, OUTPUT, unpack_args

_MODES = {0: INPUT, 1: OUTPUT, 2: INOUT}
_BODYT = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.c_int, ctypes.c_void_p)
_bodies: Dict[Tuple[int, int], Any] = {}


def init(nb_cores: int):
    """A context with the device module on cuda:0, as ``init()`` (it
    raises without a card unless ``device_cuda_platform`` names the
    CPU)."""
    return parsec_tpu_torch.Context(
        nb_cores=nb_cores if nb_cores > 0 else None)


def device_names(ctx) -> str:
    """The context's devices, comma-separated (``cpu,cuda:0``)."""
    return ",".join(d.name for d in ctx.devices)


def fini(ctx) -> None:
    ctx.fini()


def taskpool_new(ctx):
    tp = dtd.taskpool_new()
    ctx.add_taskpool(tp)
    return tp


def tile_of_dense(tp, addr: int, rows: int, cols: int):
    buf = (ctypes.c_float * (rows * cols)).from_address(addr)
    arr = np.frombuffer(buf, dtype=np.float32).reshape(rows, cols)
    return tp.tile_of_array(arr)


def _body_of(fn_addr: int, user_addr: int):
    """One DTD task class per distinct C (fn, user) pair — cached so
    repeated inserts reuse the class (ref: DTD task-class hash)."""
    key = (fn_addr, user_addr)
    body = _bodies.get(key)
    if body is None:
        cfn = _BODYT(fn_addr)
        user = ctypes.c_void_p(user_addr)

        def body(es, task):
            args = unpack_args(task)
            ptrs = (ctypes.c_void_p * len(args))(
                *[a.ctypes.data for a in args])
            cfn(ptrs, len(args), user)

        body.__name__ = f"c_body_{fn_addr:#x}"
        _bodies[key] = body
    return body


def insert_task(tp, fn_addr: int, user_addr: int, tiles, modes) -> int:
    args = [(t, _MODES[int(m)]) for t, m in zip(tiles, modes)]
    tp.insert_task(_body_of(fn_addr, user_addr), *args)
    return 0


def data_flush_all(tp) -> int:
    tp.data_flush_all()
    return 0


def taskpool_wait(tp) -> int:
    tp.wait()
    return 0


def version() -> str:
    return getattr(parsec_tpu_torch, "__version__", "0.1")
