"""Enumerate a compiled JDF's task DAG without executing it
(ref: tools/dagenum.c — offline DAG enumeration; here built on the
capture planner's symbolic dep resolution).

The importable core of the JAX package's ``tools/dagenum.py``, kept here
so the port's verifier never imports the JAX package: the cycle pass of
:mod:`.ptg_check` runs :func:`enumerate_factory` over a small concrete
instantiation of a spec.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..collections.collection import DataCollection


class _DummyCollection(DataCollection):
    """Stands in for any collection global: data_of is never touched by
    planning (only rank_of via affinity, and tiles() for I/O shapes)."""

    def __init__(self, mt: int, nt: int) -> None:
        super().__init__(1, 0)
        self.mt, self.nt = mt, nt

    def rank_of(self, *a) -> int:
        return 0

    def tiles(self) -> List[Tuple[int, int]]:
        return [(i, j) for i in range(self.mt) for j in range(self.nt)]

    def data_of(self, *a):
        raise RuntimeError("dagenum never materializes data")


def enumerate_factory(factory: Any, env: Dict[str, Any], mt: int = 4,
                      nt: int = 4) -> Tuple[Any, List[Any]]:
    """Bind ``env`` globals (declared collection globals not in ``env``
    get dummy mt x nt holders), instantiate, and run the capture
    planner's symbolic dep resolution. Returns ``(tp, order)`` where
    ``order`` is the topologically-sorted instance list (each with
    resolved ``preds``). Raises ``CaptureError`` on a dependency
    cycle."""
    env = dict(env)
    for g in factory.jdf.globals:
        if g.name not in env and g.properties.get("type") == "collection":
            env[g.name] = _DummyCollection(mt, nt)
    tp = factory.new(**env)
    from ..dsl.ptg.capture import plan
    return tp, plan(tp)


def enumerate_text(text: str, env: Dict[str, Any], mt: int = 4, nt: int = 4,
                   name: str = "jdf") -> Tuple[Any, List[Any]]:
    """``enumerate_factory`` over raw JDF source text."""
    from ..dsl import ptg
    return enumerate_factory(ptg.compile_jdf(text, name=name), env, mt, nt)
