"""Hand-written CUDA kernels for the hot operations.

The port's counterpart of the JAX package's ``ops/pallas_kernels.py``.
Eight CUDA sources live under ``csrc/``; the bf16 GEMM's and backward's
share the header ``csrc/hopper.cuh``, the two wide-head sources
``csrc/flash_wide.cuh``:

- ``gemm``: the blocked GEMM of ``csrc/matmul.cu`` at fp32,
  ``Out = beta*C + alpha*(A @ op(B))`` over an optional leading batch
  dimension, one launch for the whole batch, and the tensor-core GEMM of
  ``csrc/matmul_bf16.cu`` at bf16 (wgmma fed by TMA).  It replaces the Pallas
  ``_matmul_kernel`` and carries the tile Cholesky's GEMM and SYRK
  updates (ops/linalg.py).  ``matmul`` is its differentiable form: the
  backward runs the same kernel on the transposes (dA = g B^T,
  dB = A^T g), as the Pallas version's custom VJP does.
- ``flash_attention`` and ``flash_attention_stats``: the flash
  attention forward on ``[B, H, T, D]``, the second also returning each
  row's raw running max ``m`` and denominator ``l`` (``[B, H, T]``):
  ``csrc/flash_attention.cu`` at fp32, the tensor-core kernel of
  ``csrc/flash_attention_bf16.cu`` (wgmma on bf16 tiles fed by TMA) at
  bf16, for head widths D <= 128; ``csrc/flash_attention_wide.cu`` at
  both types for 128 < D <= ``FLASH_D_MAX`` (256).  They replace the
  Pallas ``_flash_fwd_kernel`` and ``_flash_fwd_stats_kernel`` and carry
  the transformer's attention (models/transformer.py, parallel/).
- ``flash_attention_bwd``: the flash backward of
  ``csrc/flash_attention_bwd.cu`` at fp32 and the tensor-core kernel of
  ``csrc/flash_attention_bwd_bf16.cu`` at bf16 for D <= 128,
  ``csrc/flash_attention_bwd_wide.cu`` at both types for 128 < D <= 256,
  dq, dk and dv from the
  forward's raw row statistics, in place of the jnp VJP ``_flash_vjp_bwd`` of the
  Pallas ``_flash``.  ``flash_attention`` is differentiable through it:
  while grad mode is on and an input needs a gradient, its forward
  launches the STATS instance of the forward kernel (to keep m and l for
  the backward) and its backward launches this kernel.  Under
  ``torch.no_grad()`` or ``torch.inference_mode()`` it launches the
  instance without statistics.  ``flash_attention_stats`` has no
  backward on the card (nor has the JAX package's): its differentiated
  use is the ring, whose VJP recomputes through the plain ring.

Every kernel has an fp32 and a bf16 instance.  The bf16 ones take bf16
operands, sum in fp32 and round where the Pallas kernels round at bf16:
the GEMM once at the end (``matmul`` and its gradient only: the tile
bodies' ``gemm`` with C, alpha and beta stays fp32), the forward p to
bf16 before P.V (but not in l) and o once at the end, the backward dq,
dk and dv once at the end (m, l and the dQ scratch stay fp32).  The bf16
backward's tensor-core products also take P and dS rounded to bf16
(the JAX VJP keeps both in fp32; FlashAttention and SDPA round them as
this kernel does; the wide backward keeps them fp32, as the VJP does).
The operands of one call share one of the two types; mixed types raise.
A CUDA tensor with D > ``FLASH_D_MAX`` raises ``ValueError``; a CPU
tensor computes at any D, as the JAX package does.

Each kernel is built with ``nvcc`` into a library of its type: the fp32
libraries ``matmul``, ``flash_attention`` and ``flash_attention_bwd``
from the sources of those names, and the bf16 ones of the same names
with ``_bf16`` from ``matmul_bf16.cu``, ``flash_attention_bf16.cu`` and
``flash_attention_bwd_bf16.cu``; ``flash_attention_bf16_phases`` builds
the bf16 forward once more with ``-DPTT_PHASE_CLOCKS``, a measurement
build that sums the clocks of each phase of its loop and that no path
launches.  The wide sources build one library each,
``flash_attention_wide`` and ``flash_attention_bwd_wide``, holding both
types' instances.  Each is built at the first launch of one of its
kernels, into ``build/kernels/`` at the root of the checkout, keyed on a
hash of the source, the headers of ``csrc/`` it includes and the flags,
and loaded with ``ctypes``; ``build()`` compiles them all at once, one
``nvcc`` per library.  Nothing is compiled when the module is imported.

A wrapper takes its kernel's plain PyTorch version (``gemm_plain``,
``flash_attention_plain``, ``flash_attention_stats_plain``,
``flash_attention_bwd_plain``) only for tensors on the CPU.  On a CUDA
tensor it launches the kernel or raises: a build or launch failure is
never hidden by a fallback.

``matmul_launches``, ``flash_launches``, ``flash_stats_launches`` and
``flash_bwd_launches`` count launches by kernel instance: the forward
instance, the STATS instance (``flash_attention_stats``, and
``flash_attention``'s forward while it records for a backward: a
training forward counts there, one a call) and the backward (one a
call, for its two launches: the delta pass and the persistent kernel).
``matmul_bf16_launches``, ``flash_bf16_launches``,
``flash_stats_bf16_launches`` and ``flash_bwd_bf16_launches`` count the
bf16 instances' launches the same way, and ``flash_wide_launches``,
``flash_stats_wide_launches`` and ``flash_bwd_wide_launches`` (with
their ``..._wide_bf16_launches`` twins) the wide instances' (the wide
backward: one a call, for its three launches: delta, dK and dV, dQ).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["attention_plain", "build", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_plain", "flash_attention_stats",
           "flash_attention_stats_plain",
           "flash_bf16_launches", "flash_bwd_bf16_launches",
           "flash_bwd_launches", "flash_bwd_wide_bf16_launches",
           "flash_bwd_wide_launches", "flash_launches",
           "flash_stats_bf16_launches", "flash_stats_launches",
           "flash_stats_wide_bf16_launches", "flash_stats_wide_launches",
           "flash_wide_bf16_launches", "flash_wide_launches", "gemm",
           "gemm_plain", "load", "matmul", "matmul_bf16_launches",
           "matmul_launches", "thread_matmul_launches"]

#: launches of each kernel instance since the process started (or since a
#: caller reset it to 0); the plain versions do not count
matmul_launches = 0
flash_launches = 0
flash_stats_launches = 0
flash_bwd_launches = 0
matmul_bf16_launches = 0
flash_bf16_launches = 0
flash_stats_bf16_launches = 0
flash_bwd_bf16_launches = 0
flash_wide_launches = 0
flash_stats_wide_launches = 0
flash_bwd_wide_launches = 0
flash_wide_bf16_launches = 0
flash_stats_wide_bf16_launches = 0
flash_bwd_wide_bf16_launches = 0
#: the GEMM kernel's launches by the calling thread, counted at the same
#: place: in-process rank threads share the module's totals
_per_thread = threading.local()
#: the totals' increments: shard and rank threads launch concurrently
_count_lock = threading.Lock()


def thread_matmul_launches() -> int:
    """The GEMM kernel's launches made by the calling thread."""
    return getattr(_per_thread, "matmul", 0)

#: the Pallas kernels' mask value, kept so masked rows match
NEG_INF = -1e30
#: the largest head width the flash kernels take on a CUDA tensor (the
#: wide sources' ``D_MAX``); the Pallas kernels take any: wider heads are
#: ROADMAP Queue 2(a)
FLASH_D_MAX = 256
#: the largest head width of the tuned sources (their ``D_MAX``); wider
#: heads take the wide sources
FLASH_D_NARROW = 128
#: query rows per tile of both D <= 128 backward kernels (``BQ`` in each
#: source): the turn counters' scratch is sized for it (the wide backward
#: takes none)
FLASH_BWD_BQ = 64

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: ``-Xptxas -v``: ptxas reports each kernel's registers, spills and
#: shared memory; ``build`` keeps the report beside the library
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
               "-v")


def _declare(fn, argtypes) -> None:
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int


def _declare_attributes(fn) -> None:
    """An ``..._attributes(i, out, name)`` entry point: a library's kernel
    instances, one by one."""
    _declare(fn, [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_char_p)])


def _declare_matmul(lib: ctypes.CDLL, tag: str) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    _declare(lib.ptt_matmul_f32, [p, p, p, p, i, i, i, i, ll, ll, ll, ll, i,
                                  i, i, i, i, f, f, p])


def _declare_matmul_bf16(lib: ctypes.CDLL, tag: str) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # no C, alpha or beta
    _declare(lib.ptt_matmul_bf16, [p, p, p, i, i, i, i, ll, ll, ll, i, i, i,
                                   i, p])
    # the tensor-core kernel's instances
    _declare_attributes(lib.ptt_matmul_bf16_attributes)


def _declare_flash(lib: ctypes.CDLL, tag: str) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _declare(getattr(lib, f"ptt_flash_fwd_{tag}"),
             [p, p, p, p, i, i, i, i, i, f, p])
    _declare(getattr(lib, f"ptt_flash_fwd_stats_{tag}"),
             [p, p, p, p, p, p, i, i, i, i, i, f, p])


def _declare_flash_bf16(lib: ctypes.CDLL, tag: str) -> None:
    _declare_flash(lib, tag)
    # the tensor-core kernel's instances
    _declare_attributes(lib.ptt_flash_fwd_bf16_attributes)


def _declare_flash_wide(lib: ctypes.CDLL, tag: Optional[str]) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for t in _TAGS.values():     # both types' instances in one library
        _declare(getattr(lib, f"ptt_flash_fwd_wide_{t}"),
                 [p] * 6 + [i] * 5 + [f, p])
    _declare_attributes(lib.ptt_flash_fwd_wide_attributes)


def _declare_flash_bwd_wide(lib: ctypes.CDLL, tag: Optional[str]) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for t in _TAGS.values():
        _declare(getattr(lib, f"ptt_flash_bwd_wide_{t}"),
                 [p] * 11 + [i] * 5 + [f, p])
    _declare_attributes(lib.ptt_flash_bwd_wide_attributes)


def _declare_flash_bwd(lib: ctypes.CDLL, tag: str) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the bf16 entry takes one pointer more: dQ's fp32 scratch
    _declare(getattr(lib, f"ptt_flash_bwd_{tag}"),
             [p] * (12 if tag == "f32" else 13)
             + [ctypes.c_longlong, i, i, i, i, i, f, p])
    _declare_attributes(lib.ptt_flash_bwd_attributes)


#: each CUDA source (``csrc/<name>.cu``) and the C signatures of its
#: libraries
_SOURCES = {"matmul": _declare_matmul, "matmul_bf16": _declare_matmul_bf16,
            "flash_attention": _declare_flash,
            "flash_attention_bf16": _declare_flash_bf16,
            "flash_attention_bwd": _declare_flash_bwd,
            "flash_attention_bwd_bf16": _declare_flash_bwd,
            "flash_attention_wide": _declare_flash_wide,
            "flash_attention_bwd_wide": _declare_flash_bwd_wide}
#: the element types the kernels have instances for, and each one's tag:
#: the suffix of its C entry points and of its counters
_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: each library: its source, its element type's tag (None: both types'
#: instances in one library) and its nvcc flags beyond ``_NVCC_FLAGS``;
#: ``<name>`` is the fp32 library of a kernel, ``<name>_bf16`` its bf16
#: one, each from a source of its own; the wide sources' libraries hold
#: both types
_LIBRARIES = {"matmul": ("matmul", "f32", ()),
              "matmul_bf16": ("matmul_bf16", "bf16", ()),
              "flash_attention": ("flash_attention", "f32", ()),
              "flash_attention_bf16": ("flash_attention_bf16", "bf16", ()),
              # a measurement build, on no path: the clocks of each phase
              "flash_attention_bf16_phases": ("flash_attention_bf16", "bf16",
                                              ("-DPTT_PHASE_CLOCKS",)),
              "flash_attention_bwd": ("flash_attention_bwd", "f32", ()),
              "flash_attention_bwd_bf16": ("flash_attention_bwd_bf16",
                                           "bf16", ()),
              # 128 < D <= 256, fp32 and bf16
              "flash_attention_wide": ("flash_attention_wide", None, ()),
              "flash_attention_bwd_wide": ("flash_attention_bwd_wide", None,
                                           ())}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (not on PATH, nor under "
                           "$CUDA_HOME/bin): cannot build the CUDA kernels")
    return nvcc


def _nvcc_command(name: str) -> list:
    """nvcc's arguments for library ``name`` but the output: the flags,
    the library's own and its source."""
    source, _tag, flags = _LIBRARIES[name]
    return [*_NVCC_FLAGS, *flags, str(_CSRC / f"{source}.cu")]


def _headers(source: str) -> list:
    """The headers of ``csrc/`` that ``csrc/<source>.cu`` includes
    (``#include "<name>"``), in the order it names them."""
    text = (_CSRC / f"{source}.cu").read_text()
    return re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M)


def _library_path(name: str) -> Path:
    """Where library ``name`` is built: keyed on its source, the headers
    of ``csrc/`` it includes and the flags, so an edit to any of them
    builds it anew."""
    source, _tag, flags = _LIBRARIES[name]
    text = (_CSRC / f"{source}.cu").read_bytes()
    for header in _headers(source):
        text += (_CSRC / header).read_bytes()
    key = hashlib.sha256(
        text + " ".join(_NVCC_FLAGS + flags).encode()).hexdigest()
    return _BUILD_DIR / f"{name}_{key[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile each library named (default: every one, the fp32 and bf16
    builds of every source) unless a build of the same source and flags
    exists, one ``nvcc`` per library, all started together; return each
    library's path.  nvcc's output (ptxas's report) is kept beside each
    library it builds, as ``<library>.log``."""
    names = list(_LIBRARIES if names is None else names)
    for name in names:
        if name not in _LIBRARIES:
            raise ValueError(f"no CUDA source named {name!r}")
    out = {name: _library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            jobs.append((name, tmp, subprocess.Popen(
                [nvcc, "-o", tmp, *_nvcc_command(name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for name, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed to build {name}:\n{log}")
            else:   # atomic: a concurrent build sees all or none
                out[name].with_suffix(".log").write_text(log)
                os.replace(tmp, out[name])
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _name, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Library ``name`` (``_LIBRARIES``), loaded once per process with its
    C signatures declared."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            source, tag, _flags = _LIBRARIES[name]
            lib = ctypes.CDLL(str(build([name])[name]))
            _SOURCES[source](lib, tag)
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def _check_cuda_operands(op: str, ts: Tuple[torch.Tensor, ...],
                         stats: Tuple[torch.Tensor, ...] = ()) -> str:
    """What every CUDA kernel here takes: contiguous tensors on one
    device, the operands ``ts`` all fp32 or all bf16 (an instance's type)
    and the row statistics ``stats`` fp32; returns the instance's tag."""
    dev, dtype = ts[0].device, ts[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    if dtype not in _TAGS:
        raise TypeError(f"{op}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    for t, want in [(t, dtype) for t in ts] + [(t, torch.float32)
                                               for t in stats]:
        if t.device != dev:
            raise ValueError(f"{op}: tensors on {dev} and {t.device}")
        if t.dtype != want:
            raise TypeError(f"{op}: operands of mixed types: {want} and "
                            f"{t.dtype} (the row statistics are float32)")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous tensors")
    return _TAGS[dtype]


def _count(name: str, tag: str) -> None:
    """One launch more on the counter of ``name``'s ``tag`` instance."""
    counter = name if tag == "f32" else name.replace("_launches",
                                                     "_bf16_launches")
    with _count_lock:
        globals()[counter] += 1


def _library(source: str, tag: str) -> ctypes.CDLL:
    return load(source if tag == "f32" else f"{source}_bf16")


def _check_head_width(op: str, D: int) -> None:
    """A CUDA call's head width: the kernels take 1..FLASH_D_MAX."""
    if not 1 <= D <= FLASH_D_MAX:
        raise ValueError(f"{op}: the CUDA kernels take head widths "
                         f"1..{FLASH_D_MAX} (FLASH_D_MAX), got {D}; wider "
                         f"heads are ROADMAP Queue 2(a), still to port")


def _raise_launch(op: str, lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: "
                           f"{lib.ptt_error_string(rc).decode()} ({rc})")


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               c: Optional[torch.Tensor] = None, *, trans_b: bool = False,
               alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """The kernel's plain version: ``beta*C + alpha*(A @ op(B))`` with
    ``torch.matmul`` in fp32 (bf16 operands widened: their products are
    exact in fp32), rounded once to bf16 for bf16 operands.  A leading
    batch dimension is looped over, so each slice is exactly the
    unbatched computation."""
    if a.dim() == 3:
        return torch.stack([
            gemm_plain(a[i], b[i], None if c is None else c[i],
                       trans_b=trans_b, alpha=alpha, beta=beta)
            for i in range(a.shape[0])])
    p = alpha * torch.matmul(a.float(), (b.mT if trans_b else b).float())
    p = p if c is None else beta * c.float() + p
    return p.to(torch.bfloat16) if a.dtype == torch.bfloat16 else p


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         *, trans_b: bool = False, alpha: float = 1.0,
         beta: float = 0.0) -> torch.Tensor:
    """``Out = beta*C + alpha*(A @ op(B))``, ``op(B) = B^T`` when
    ``trans_b``.  A is ``[M, K]``, B ``[N, K]`` (trans_b) or ``[K, N]``,
    C ``[M, N]`` or None; all may carry one leading batch dimension,
    which becomes the kernel's ``gridDim.z``.  CPU tensors take the plain
    version; CUDA tensors must be contiguous and on one device, fp32, or
    bf16 without C and with alpha 1 (the bf16 instance: ``A @ op(B)``
    summed in fp32, rounded once to bf16)."""
    ts = (a, b) if c is None else (a, b, c)
    if any(t.dim() != a.dim() for t in ts) or a.dim() not in (2, 3):
        raise ValueError(f"gemm: expected 2-D or batched 3-D tensors, got "
                         f"shapes {[tuple(x.shape) for x in ts]}")
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2:]
    N, Kb = (b.shape[-2:] if trans_b else b.shape[-1:] + b.shape[-2:-1])
    if Kb != K or b.shape[:-2] != a.shape[:-2]:
        raise ValueError(f"gemm: A {tuple(a.shape)} and B {tuple(b.shape)} "
                         f"(trans_b={trans_b}) do not conform")
    if c is not None and tuple(c.shape) != tuple(a.shape[:-1]) + (N,):
        raise ValueError(f"gemm: C {tuple(c.shape)} is not "
                         f"{tuple(a.shape[:-1]) + (N,)}")
    if a.device.type == "cpu":
        return gemm_plain(a, b, c, trans_b=trans_b, alpha=alpha, beta=beta)
    tag = _check_cuda_operands("gemm", ts)
    if tag == "bf16" and (c is not None or alpha != 1.0):
        raise ValueError("gemm: the bf16 instance computes A @ op(B) alone "
                         "(no C, alpha 1), as the Pallas matmul does")
    if batch > 65535:
        raise ValueError(f"gemm: batch {batch} exceeds gridDim.z")
    out = torch.empty(tuple(a.shape[:-1]) + (N,), dtype=a.dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    lib = _library("matmul", tag)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if tag == "f32":
            rc = lib.ptt_matmul_f32(
                a.data_ptr(), b.data_ptr(),
                None if c is None else c.data_ptr(), out.data_ptr(), batch,
                M, N, K, M * K, b.shape[-2] * b.shape[-1], M * N, M * N,
                K, b.shape[-1], N, N, int(trans_b), float(alpha),
                float(beta), stream)
        else:
            rc = lib.ptt_matmul_bf16(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, N, K,
                M * K, b.shape[-2] * b.shape[-1], M * N, K, b.shape[-1], N,
                int(trans_b), stream)
    _raise_launch("gemm", lib, rc)
    _count("matmul_launches", tag)
    if tag == "f32":
        _per_thread.matmul = getattr(_per_thread, "matmul", 0) + 1
    return out


class _Matmul(torch.autograd.Function):
    """A @ B through the GEMM kernel; the backward runs the kernel on the
    transposes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return gemm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = gemm(g, b, trans_b=True).to(a.dtype)        # g @ B^T
        if ctx.needs_input_grad[1]:
            db = gemm(a.mT.contiguous(), g).to(b.dtype)      # A^T @ g
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[M, K] @ [K, N]`` through the GEMM kernel, accumulated in fp32,
    in the operands' type (fp32 or bf16); differentiable."""
    return _Matmul.apply(a, b)


# ---------------------------------------------------------------------- #
# flash attention                                                        #
# ---------------------------------------------------------------------- #
def _attention_shapes(op: str, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """(B, H, T, Tk, D) of ``q [B, H, T, D]``, ``k, v [B, H, Tk, D]``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{op}: expected q [B, H, T, D] and k, v "
                         f"[B, H, Tk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    if k.shape[:2] != q.shape[:2] or k.shape[3] != D:
        raise ValueError(f"{op}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not conform")
    if k.shape[2] == 0:
        raise ValueError(f"{op}: no keys (Tk = 0)")
    return B, H, T, k.shape[2], D


def _masked_scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """``scale * q.k^T`` in fp32, causally masked to -1e30 with the
    local-index convention (row i sees keys 0..i, also when T != Tk)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        T, Tk = q.shape[2], k.shape[2]
        keep = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    return s


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """A materialised masked softmax in fp32 times the widened v, rounded
    once to q's type: the JAX package's ``local_attention`` off the
    kernel."""
    _attention_shapes("attention", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_masked_scores(q, k, causal, scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel's plain version: ``attention_plain`` at fp32;
    at bf16 the stats kernel's plain version's ``o``, which rounds p to
    bf16 before P.V as the Pallas kernel does."""
    _attention_shapes("flash_attention", q, k, v)
    if q.dtype == torch.bfloat16:
        return flash_attention_stats_plain(q, k, v, causal, scale)[0]
    return attention_plain(q, k, v, causal, scale)


def flash_attention_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = False,
                                scale: Optional[float] = None):
    """The stats kernel's plain version, the counterpart of
    ``_flash_stats_reference``: ``(o, m, l)`` with each row's raw max and
    denominator.  A row with no visible key keeps m = -1e30, l = 0 and
    o = 0; only o is safe-normalised.  p enters P.V in v's type (rounded
    to bf16 at bf16, as the Pallas kernel's ``p.astype(v.dtype)``; the
    reference does not round it) and l unrounded; o is rounded once."""
    _attention_shapes("flash_attention_stats", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    dead = m <= NEG_INF
    l = torch.where(dead, 0.0, p.sum(dim=-1))
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                     v.float()) / l_safe[..., None]
    o = torch.where(dead[..., None], 0.0, o).to(q.dtype)
    return o, m, l


def _flash_launch(op: str, q, k, v, causal: bool, scale: Optional[float],
                  stats: bool):
    """Check the operands and launch the forward kernel of the operands'
    type and head width (``csrc/flash_attention.cu`` at fp32,
    ``csrc/flash_attention_bf16.cu`` at bf16, ``csrc/flash_attention_wide.cu``
    at either for D > 128), counting the instance launched; returns ``o``
    or ``(o, m, l)``."""
    B, H, T, Tk, D = _attention_shapes(op, q, k, v)
    tag = _check_cuda_operands(op, (q, k, v))
    _check_head_width(op, D)
    if B * H > 65535:
        raise ValueError(f"{op}: B*H = {B * H} exceeds gridDim.y")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if T == 0 or B * H == 0:
        return (o, m, l) if stats else o
    wide = D > FLASH_D_NARROW
    lib = load("flash_attention_wide") if wide else _library(
        "flash_attention", tag)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if wide:     # one entry point: m and l are written when given
            rc = getattr(lib, f"ptt_flash_fwd_wide_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                m.data_ptr() if stats else None,
                l.data_ptr() if stats else None, B * H, T, Tk, D,
                int(causal), float(scale), stream)
        elif stats:
            rc = getattr(lib, f"ptt_flash_fwd_stats_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                m.data_ptr(), l.data_ptr(), B * H, T, Tk, D, int(causal),
                float(scale), stream)
        else:
            rc = getattr(lib, f"ptt_flash_fwd_{tag}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B * H, T, Tk, D, int(causal), float(scale), stream)
    _raise_launch(op, lib, rc)
    counter = "flash_stats_launches" if stats else "flash_launches"
    _count(counter.replace("_launches", "_wide_launches") if wide
           else counter, tag)
    return (o, m, l) if stats else o


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward keeps the row
    statistics of the STATS instance (the plain version's on the CPU),
    the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            o, m, l = flash_attention_stats_plain(q, k, v, causal, scale)
        else:
            o, m, l = _flash_launch("flash_attention", q, k, v, causal,
                                    scale, True)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        # the cotangent of a transposed, reshaped output is a strided view
        dq, dk, dv = flash_attention_bwd(q, k, v, o, m, l, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention forward, ``q [B, H, T, D]``, ``k, v [B, H, Tk, D]``
    -> ``[B, H, T, D]``; ``scale`` defaults to ``D ** -0.5``.  CPU tensors
    take the plain versions; CUDA tensors must be contiguous, all fp32 or
    all bf16 (the kernel's instance of that type), with
    ``D <= FLASH_D_MAX`` (256; the wide kernels above 128).
    Differentiable: while grad mode is on and an input needs a gradient,
    the forward keeps the row statistics and the backward is
    ``flash_attention_bwd``."""
    _attention_shapes("flash_attention", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, float(scale))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    return _flash_launch("flash_attention", q, k, v, causal, scale, False)


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          scale: Optional[float] = None):
    """Flash attention over one key set, returning ``(o, m, l)``: ``o``
    normalised within THIS k/v set, ``m`` and ``l`` each row's raw running
    max and denominator (``[B, H, T]`` fp32).  Merge rule for two sets a
    and b::

        m = max(m_a, m_b);  w_x = exp(m_x - m) * l_x
        o = (o_a w_a + o_b w_b) / (w_a + w_b);  l = w_a + w_b

    The same contract as ``flash_attention`` otherwise, but no backward
    on a CUDA tensor: while grad mode is on, an input that needs a
    gradient raises."""
    if q.device.type == "cpu":
        return flash_attention_stats_plain(q, k, v, causal, scale)
    if _needs_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_stats: the stats kernel has no backward, as "
            "in the JAX package (ROADMAP Queue 2(a)); the ring "
            "differentiates through its own VJP.  Call it under "
            "torch.no_grad() or torch.inference_mode()")
    return _flash_launch("flash_attention_stats", q, k, v, causal, scale,
                         True)


# ---------------------------------------------------------------------- #
# flash attention backward                                               #
# ---------------------------------------------------------------------- #
def _pick_block(t: int, pref: int) -> int:
    """The Pallas wrapper's block: the largest power-of-two fraction of
    ``pref`` that divides ``t``."""
    b = min(pref, t)
    while t % b:
        b //= 2
    return max(b, 1)


def _bwd_shapes(q, k, v, o, m, l, do) -> Tuple[int, int, int, int, int]:
    B, H, T, Tk, D = _attention_shapes("flash_attention_bwd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's {tuple(q.shape)}")
    if m.shape != (B, H, T) or l.shape != (B, H, T):
        raise ValueError(f"flash_attention_bwd: m {tuple(m.shape)} and l "
                         f"{tuple(l.shape)} must be {(B, H, T)}")
    return B, H, T, Tk, D


def flash_attention_bwd_plain(q, k, v, o, m, l, do, causal: bool = True,
                              scale: Optional[float] = None,
                              block_k: int = 512):
    """The backward kernel's plain version: the JAX package's
    ``_flash_vjp_bwd`` in torch ops, blockwise over key blocks of
    ``_pick_block(Tk, block_k)``.  Its first scan (the row statistics) is
    the forward's ``m`` and ``l``, given here; then dv and
    ``delta = rowsum(P * dP)`` block by block; then dq and dk.  The -1e30
    mask with the local-index causal rule, and l == 0 -> 1.  All in fp32
    from the widened inputs, each gradient rounded once to its input's
    type.  ``o`` is not read: the kernel takes ``delta = rowsum(dO * O)``,
    the same number in fp32 (at bf16 it carries o's rounding)."""
    B, H, T, Tk, D = _bwd_shapes(q, k, v, o, m, l, do)
    if scale is None:
        scale = D ** -0.5
    bk = _pick_block(Tk, block_k)
    qf, gf = q.float(), do.float()
    l_safe = torch.where(l == 0.0, 1.0, l.float())
    qpos = torch.arange(T, device=q.device)

    def block_p_dp(j):
        kb = k[:, :, j * bk:(j + 1) * bk].float()
        vb = v[:, :, j * bk:(j + 1) * bk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        if causal:
            kpos = j * bk + torch.arange(bk, device=q.device)
            s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
        p = torch.exp(s - m.float()[..., None]) / l_safe[..., None]
        return kb, p, torch.einsum("bhqd,bhkd->bhqk", gf, vb)

    # pass 2: dv per block, and delta accumulated blockwise
    delta = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    dvs = []
    for j in range(Tk // bk):
        _kb, p, dp = block_p_dp(j)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, gf))
        delta = delta + (p * dp).sum(-1)
    # pass 3: dq and dk
    dq = torch.zeros_like(qf)
    dks = []
    for j in range(Tk // bk):
        kb, p, dp = block_p_dp(j)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


def _flash_bwd_counters(bh: int, T: int,
                       device: torch.device) -> torch.Tensor:
    """The backward kernel's zeroed int32 scratch: a turn counter for each
    (b*h, query tile of ``FLASH_BWD_BQ`` rows), which orders the dQ sum
    by key tile, then the counter that hands out work items."""
    return torch.zeros(bh * -(-T // FLASH_BWD_BQ) + 1, dtype=torch.int32,
                       device=device)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v, causal, scale)``
    for the cotangent ``do``, given the forward's ``o`` and its raw row
    max ``m`` and denominator ``l`` (``flash_attention_stats``).  CPU
    tensors take the plain version; CUDA tensors must be contiguous and on
    one device with ``D <= FLASH_D_MAX``: q, k, v, o and do all fp32 or
    all bf16 (the kernel's instance of that type), m and l fp32.  Up to
    D = 128 at bf16 the wrapper allocates an fp32 scratch for dQ's
    ordered sum, which the kernel rounds once into dq; wider heads take
    the wide kernel (``csrc/flash_attention_bwd_wide.cu``), which sums
    each dq row in registers and needs no scratch or turn counters."""
    B, H, T, Tk, D = _bwd_shapes(q, k, v, o, m, l, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, m, l, do, causal, scale)
    op = "flash_attention_bwd"
    tag = _check_cuda_operands(op, (q, k, v, o, do), (m, l))
    _check_head_width(op, D)
    if scale is None:
        scale = D ** -0.5
    dq = torch.empty_like(q)
    if T == 0 or B * H == 0:     # no query sees a key
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if D > FLASH_D_NARROW:
        lib = load("flash_attention_bwd_wide")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = getattr(lib, f"ptt_flash_bwd_wide_{tag}")(
                *(x.data_ptr() for x in (q, k, v, o, m, l, do, dq, dk, dv,
                                         delta)),
                B * H, T, Tk, D, int(causal), float(scale), stream)
        _raise_launch(op, lib, rc)
        _count("flash_bwd_wide_launches", tag)
        return dq, dk, dv
    counters = _flash_bwd_counters(B * H, T, q.device)
    lib = _library("flash_attention_bwd", tag)
    args = [q, k, v, o, m, l, do, dq, dk, dv, delta]
    if tag == "bf16":      # dQ's ordered sum, in fp32
        args.append(torch.empty(q.shape, dtype=torch.float32,
                                device=q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"ptt_flash_bwd_{tag}")(
            *(x.data_ptr() for x in args), counters.data_ptr(),
            counters.numel(), B * H, T, Tk, D,
            int(causal), float(scale), stream)
    _raise_launch(op, lib, rc)
    _count("flash_bwd_launches", tag)
    return dq, dk, dv
