"""Build driver for the C embedding library (libparsec_tpu_c.so).

    python -m parsec_tpu_torch.bindings.build [--force]

Compiles parsec_tpu_c.c against the running interpreter's libpython
(python3-config --embed equivalent) into ``build/bindings/<key>/`` at
the root of the checkout, never into the package directory; ``<key>``
is a hash of the source, the header, the flags and the interpreter, so
a changed source or another Python builds anew.  A failed compile
raises RuntimeError with the compiler's output.  C programs then build
with:

    cc app.c -I <this dir> -L <lib dir> -lparsec_tpu_c \
       -L$(python3-config --prefix)/lib -lpython3.X \
       -Wl,-rpath,<lib dir> -Wl,-rpath,$LIBDIR

(``include_dir()``, ``libpath()``, ``python_link_flags()``) and run with
PYTHONPATH including the repo root.  Without a card they need
``PARSEC_MCA_device_cuda_platform=cpu``: ``ptc_init`` runs the device
module on cuda:0, like ``init()``.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import List, Optional

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "parsec_tpu_c.c"
_HDR = _DIR / "parsec_tpu_c.h"
BUILD_DIR = _DIR.parents[1] / "build" / "bindings"
_FLAGS = ("-O2", "-shared", "-fPIC", "-Wall")


def include_dir() -> str:
    """The directory holding ``parsec_tpu_c.h``."""
    return str(_DIR)


def compiler() -> str:
    """The C compiler the library and its programs build with."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler (gcc or cc) on PATH to build "
                           "the C bindings")
    return cc


def python_link_flags() -> List[str]:
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = (sysconfig.get_config_var("LDVERSION")
           or sysconfig.get_config_var("VERSION"))
    return [f"-L{libdir}", f"-lpython{ver}",
            f"-Wl,-rpath,{libdir}"] + \
        (sysconfig.get_config_var("LIBS") or "").split()


def libpath(out_dir: Optional[Path] = None) -> str:
    """Where the library built from this checkout's sources lives."""
    key = hashlib.sha256(_SRC.read_bytes() + _HDR.read_bytes()
                         + " ".join(_FLAGS).encode()
                         + sys.version.encode()).hexdigest()[:16]
    return str(Path(out_dir or BUILD_DIR) / key / "libparsec_tpu_c.so")


def build(force: bool = False, verbose: bool = False,
          out_dir: Optional[Path] = None) -> str:
    """Compile the shim unless a library of the same sources, flags and
    interpreter exists (or ``force``); return its path."""
    so = Path(libpath(out_dir))
    if so.exists() and not force:
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists() and not force:
                return str(so)   # another process built it meanwhile
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
            os.close(fd)
            include = sysconfig.get_paths()["include"]
            cmd = [compiler(), *_FLAGS, f"-I{include}", f"-I{_DIR}",
                   str(_SRC), "-o", tmp] + python_link_flags()
            if verbose:
                print("+", " ".join(cmd), file=sys.stderr)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"the C bindings did not build "
                                   f"({' '.join(cmd)}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)    # atomic: a reader sees all or none
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return str(so)


if __name__ == "__main__":
    print(build(force="--force" in sys.argv, verbose=True))
