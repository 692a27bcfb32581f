"""The port's template device module (parsec_tpu_torch/devices/
template.py — the skeleton cloned to bring up a new device type) and
the PTG routing of ``BODY [type=<other>]`` to it.  Mirrors the JAX
package's ``tests/test_template_device.py`` with the port's result
held against the JAX package's, and chains CUDA-body and template
tasks over the device module (CPU tensors here; the card in
chip_smoke.py's template phase)."""
import numpy as np
import pytest

import parsec_tpu
import parsec_tpu_torch as ptt
from parsec_tpu_torch.devices import TemplateDevice
from parsec_tpu_torch.dsl import ptg

JDF = """
descA [ type="collection" ]
NB [ type="int" ]

Scale(k)

k = 0 .. NB-1

: descA( k )

RW A <- descA( k )
     -> descA( k )

BODY [type=template]
{
    A = A * 3.0
}
END
"""


def _run(attach_template):
    from parsec_tpu_torch.collections.collection import LocalArrayCollection
    ctx = ptt.Context(nb_cores=2, device="cpu")
    try:
        dev = None
        if attach_template:
            dev = TemplateDevice(len(ctx.devices))
            ctx.devices.append(dev)
        base = np.concatenate(
            [np.full((4, 4), float(i + 1), np.float32) for i in range(5)])
        coll = LocalArrayCollection(base, nb_chunks=5)
        coll.name = "descA"
        tp = ptg.compile_jdf(JDF, name="scale").new(descA=coll, NB=5)
        ctx.add_taskpool(tp)
        ctx.wait()
        vals = [float(np.asarray(coll.data_of(i).newest_copy().payload)[0, 0])
                for i in range(5)]
        return vals, dev
    finally:
        ctx.fini()


def _run_jax(attach_template):
    from parsec_tpu.collections.collection import LocalArrayCollection
    from parsec_tpu.devices import TemplateDevice as JaxTemplateDevice
    from parsec_tpu.dsl import ptg as jax_ptg
    ctx = parsec_tpu.Context(nb_cores=2, enable_tpu=False)
    try:
        if attach_template:
            ctx.devices.append(JaxTemplateDevice(len(ctx.devices)))
        base = np.concatenate(
            [np.full((4, 4), float(i + 1), np.float32) for i in range(5)])
        coll = LocalArrayCollection(base, nb_chunks=5)
        coll.name = "descA"
        tp = jax_ptg.compile_jdf(JDF, name="scale").new(descA=coll, NB=5)
        ctx.add_taskpool(tp)
        ctx.wait()
        return [float(np.asarray(coll.data_of(i).newest_copy().payload)[0, 0])
                for i in range(5)]
    finally:
        ctx.fini()


@pytest.mark.parametrize("attach", [True, False])
def test_template_result_equal_to_jax(attach):
    assert _run(attach)[0] == _run_jax(attach)


def test_template_device_executes_chores():
    vals, dev = _run(attach_template=True)
    assert vals == [3.0 * (i + 1) for i in range(5)]
    assert dev.stats["tasks"] == 5
    assert dev.executed_tasks == 5


def test_template_body_falls_through_without_device():
    """No device of that type attached: HookReturn.NEXT falls through to
    the interpreted host chore."""
    vals, _ = _run(attach_template=False)
    assert vals == [3.0 * (i + 1) for i in range(5)]


def test_custom_executor_is_used():
    from parsec_tpu_torch.collections.collection import LocalArrayCollection
    calls = []

    def executor(fn, task, arrays):
        calls.append(task.task_class.name)
        return fn(task, arrays)

    ctx = ptt.Context(nb_cores=1, device="cpu")
    try:
        ctx.devices.append(TemplateDevice(len(ctx.devices),
                                          executor=executor))
        coll = LocalArrayCollection(np.ones((2, 2), np.float32), nb_chunks=1)
        coll.name = "descA"
        tp = ptg.compile_jdf(JDF, name="scale").new(descA=coll, NB=1)
        ctx.add_taskpool(tp)
        ctx.wait()
    finally:
        ctx.fini()
    assert calls == ["Scale"]


CHAIN_JDF = """
descA [ type="collection" ]

First(k)

k = 0 .. 0

: descA( 0, 0 )

RW A <- descA( 0, 0 )
     -> A Middle( k )

BODY [type=cuda]
{
    A = A * 2.0 + 1.0
}
END

Middle(k)

k = 0 .. 0

: descA( 0, 0 )

RW A <- A First( k )
     -> A Last( k )

BODY [type=template]
{
    A = A * 3.0 - 5.0
}
END

Last(k)

k = 0 .. 0

: descA( 0, 0 )

RW A <- A Middle( k )
     -> descA( 0, 0 )

BODY [type=cuda]
{
    A = A * 0.5
}
END
"""


def test_cuda_template_cuda_chain():
    """A CUDA-body task, a template task, a CUDA-body task on one tile:
    the template sees the device module's newest copy, and the last
    task stages the template's host write back in; exact against the
    plain chain."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    rng = np.random.RandomState(3)
    M = rng.standard_normal((32, 32)).astype(np.float32)
    ctx = ptt.Context(nb_cores=2, device="cpu")
    try:
        tdev = TemplateDevice(len(ctx.devices))
        ctx.devices.append(tdev)
        cdev = ctx.device_by_type("cuda")
        A = TwoDimBlockCyclic(32, 32, 32, 32,
                              dtype=np.float32).from_numpy(M)
        A.name = "descA"
        tp = ptg.compile_jdf(CHAIN_JDF, name="chain").new(descA=A)
        ctx.add_taskpool(tp)
        ctx.wait()
        assert cdev.stats["tasks"] == 2 and tdev.stats["tasks"] == 1
        got = A.to_numpy()
    finally:
        ctx.fini()
    one, two, three = np.float32(1), np.float32(2), np.float32(3)
    exp = ((M * two + one) * three - np.float32(5)) * np.float32(0.5)
    np.testing.assert_array_equal(got, exp)
