"""PTG — Parameterized Task Graph front end (the JDF DSL).

Public surface (analog of parsec_ptgpp + the generated constructor):

    factory = ptg.compile_jdf(text)          # parse + check, reusable
    tp = factory.new(mydata=coll, NB=20)     # == parsec_<name>_new(...)
    ctx.add_taskpool(tp); ctx.wait()

ref: parsec/interfaces/ptg/ptg-compiler (13.7k LoC C tool); here parsing
and "code generation" happen at compile_jdf time, once, independent of the
problem size — the defining property of PTG (README.rst:21-27).
"""
from __future__ import annotations

import os
from typing import Optional

from .ast import JDFFile
from .capture import (CaptureError, CapturedSequence, CapturedTaskpool,
                      capture, capture_sequence)
from .lower import LoweredDAG, lower
from .parser import JDFParseError, parse_jdf
from .runtime import PTGTaskClass, PTGTaskpool
from .wave import WaveError, WaveRunner, wave
from .wave_dist import TAG_WAVE, DistWaveRunner, lane_device_pool


class JDFFactory:
    """Compiled JDF: instantiate with globals to get a taskpool."""

    def __init__(self, jdf: JDFFile) -> None:
        self.jdf = jdf
        self.name = jdf.name

    def new(self, *, rank: int = 0, nb_ranks: int = 1, **global_env) -> PTGTaskpool:
        return PTGTaskpool(self.jdf, global_env, rank=rank, nb_ranks=nb_ranks)


def compile_jdf(text: str, name: Optional[str] = None) -> JDFFactory:
    """Compile JDF source text (the parsec_ptgpp analog)."""
    if name is None:
        name = "jdf"
    return JDFFactory(parse_jdf(text, name=name))


def compile_jdf_file(path: str) -> JDFFactory:
    with open(path) as fh:
        text = fh.read()
    name = os.path.splitext(os.path.basename(path))[0]
    return JDFFactory(parse_jdf(text, name=name))


__all__ = ["compile_jdf", "compile_jdf_file", "JDFFactory", "JDFParseError",
           "PTGTaskpool", "PTGTaskClass", "CaptureError", "CapturedSequence",
           "CapturedTaskpool", "capture", "capture_sequence", "lower",
           "LoweredDAG", "wave", "WaveRunner", "WaveError",
           "DistWaveRunner", "TAG_WAVE", "lane_device_pool"]
