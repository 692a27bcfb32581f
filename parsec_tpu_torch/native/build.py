"""Building the native C++ runtime core.

Compiles ``_native.cpp`` into the ``_parsec_torch_native`` CPython
extension with ``g++`` (one translation unit, no pybind11 or setuptools)
into ``build/native/`` at the root of the checkout, never into the
package directory.  The library's name carries a hash of the source, the
flags and the interpreter's ABI, so a changed source or another Python
builds anew and a stale library is never loaded.  Concurrent first uses
(several test workers) take a file lock: one compiles, the others wait
and load its result.

    python -m parsec_tpu_torch.native.build     # build, print the path
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path

MODULE = "_parsec_torch_native"
SOURCE = Path(__file__).resolve().parent / "_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
          "-Wall")


def library_path(source: Path = SOURCE, out_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``source`` lives."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = hashlib.sha256(Path(source).read_bytes()
                         + " ".join(_FLAGS).encode()
                         + suffix.encode()).hexdigest()[:16]
    return Path(out_dir) / f"{MODULE}_{key}{suffix}"


def build(source: Path = SOURCE, out_dir: Path = BUILD_DIR,
          verbose: bool = False) -> Path:
    """Compile ``source`` unless a library of the same source, flags and
    ABI exists; return its path.  A failed compile raises RuntimeError
    with the compiler's output."""
    out = library_path(source, out_dir)
    if out.exists():
        return out
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():        # another process built it meanwhile
                return out
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = ["g++", *_FLAGS,
                   f"-I{sysconfig.get_paths()['include']}", str(source),
                   "-o", tmp]
            if verbose:
                print("+", " ".join(cmd), file=sys.stderr)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                os.unlink(tmp)
                raise RuntimeError(f"cannot run g++ to build the native "
                                   f"core: {exc}") from exc
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed to build {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)    # atomic: a reader sees all or none
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


if __name__ == "__main__":
    print(build(verbose=True))
