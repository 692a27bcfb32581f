"""Native (C++) runtime core: lock-free containers, hash table,
zone-malloc and the static DAG engine (``NativeDAG``).

The reference implements its whole hot host path in C (SURVEY.md §2.1);
this package is the equivalent layer.  On first import it compiles
``_native.cpp`` with ``g++`` into ``build/native/`` (native/build.py) and
loads the extension.  A failed build or load raises: the core containers
(core/lists.py, core/hbbuffer.py, core/hashtable.py, data/arena.py) and
the static engines (dsl/ptg/lower.py, turbo.py, wave.py) run on it, and
nothing falls back to the pure-Python containers, which stay importable
as the plain versions the parity tests drive beside the native ones.

Exports: ``native`` (the extension module) and ``load``.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

from . import build as _build


def load(source: Path = _build.SOURCE,
         out_dir: Path = _build.BUILD_DIR) -> ModuleType:
    """Build (if needed) and import the extension compiled from
    ``source``; raises RuntimeError when it does not build or load."""
    path = _build.build(source, out_dir)
    cached = sys.modules.get(_build.MODULE)
    if cached is not None and getattr(cached, "__file__", None) == str(path):
        return cached
    spec = importlib.util.spec_from_file_location(_build.MODULE, path)
    if spec is None or spec.loader is None:
        raise RuntimeError(f"cannot load the native core from {path}")
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except ImportError as exc:
        raise RuntimeError(f"cannot load the native core from {path}: "
                           f"{exc}") from exc
    sys.modules[_build.MODULE] = mod
    return mod


native = load()
