"""Hand-written CUDA kernels for the hot operations.

The port's counterpart of the JAX package's ``ops/pallas_kernels.py``.
Three CUDA sources live under ``csrc/``:

- ``gemm``: the blocked fp32 GEMM of ``csrc/matmul.cu``,
  ``Out = beta*C + alpha*(A @ op(B))`` over an optional leading batch
  dimension, one launch for the whole batch.  It replaces the Pallas
  ``_matmul_kernel`` and carries the tile Cholesky's GEMM and SYRK
  updates (ops/linalg.py).  ``matmul`` is its differentiable form: the
  backward runs the same kernel on the transposes (dA = g B^T,
  dB = A^T g), as the Pallas version's custom VJP does.
- ``flash_attention`` and ``flash_attention_stats``: the fp32 flash
  attention forward of ``csrc/flash_attention.cu`` on ``[B, H, T, D]``,
  the second also returning each row's raw running max ``m`` and
  denominator ``l`` (``[B, H, T]``).  They replace the Pallas
  ``_flash_fwd_kernel`` and ``_flash_fwd_stats_kernel`` and carry the
  transformer's attention (models/transformer.py, parallel/).
- ``flash_attention_bwd``: the flash backward of
  ``csrc/flash_attention_bwd.cu``, dq, dk and dv from the forward's raw
  row statistics, in place of the jnp VJP ``_flash_vjp_bwd`` of the
  Pallas ``_flash``.  ``flash_attention`` is differentiable through it:
  while grad mode is on and an input needs a gradient, its forward
  launches the STATS instance of the forward kernel (to keep m and l for
  the backward) and its backward launches this kernel.  Under
  ``torch.no_grad()`` or ``torch.inference_mode()`` it launches the
  instance without statistics.  ``flash_attention_stats`` has no
  backward on the card (nor has the JAX package's): its differentiated
  use is the ring, whose VJP recomputes through the plain ring.

Each source is compiled with ``nvcc`` at the first launch of one of its
kernels into ``build/kernels/`` at the root of the checkout, keyed on a
hash of the source and flags, and loaded with ``ctypes``; ``build()``
compiles them all at once, one ``nvcc`` per source.  Nothing is compiled
when the module is imported.

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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["build", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "flash_attention_stats", "flash_attention_stats_plain",
           "flash_bwd_launches", "flash_launches", "flash_stats_launches",
           "gemm", "gemm_plain", "load", "matmul", "matmul_launches",
           "thread_matmul_launches"]

#: launches of each kernel since the process started (or since a caller
#: reset it to 0); the plain versions do not count
matmul_launches = 0
flash_launches = 0
flash_stats_launches = 0
flash_bwd_launches = 0
#: the GEMM kernel's launches by the calling thread, counted at the same
#: place: in-process rank threads share the module's totals
_per_thread = threading.local()


def thread_matmul_launches() -> int:
    """The GEMM kernel's launches made by the calling thread."""
    return getattr(_per_thread, "matmul", 0)

#: the Pallas kernels' mask value, kept so masked rows match
NEG_INF = -1e30
#: the largest head width the flash kernel takes
FLASH_D_MAX = 128
#: query rows per tile of the backward kernel (``BQ`` in its source)
FLASH_BWD_BQ = 64

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def _declare_matmul(lib: ctypes.CDLL) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.ptt_matmul_f32.argtypes = [p, p, p, p, i, i, i, i, ll, ll, ll, ll,
                                   i, i, i, i, i, f, f, p]
    lib.ptt_matmul_f32.restype = ctypes.c_int


def _declare_flash(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ptt_flash_fwd_f32.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
    lib.ptt_flash_fwd_f32.restype = ctypes.c_int
    lib.ptt_flash_fwd_stats_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            f, p]
    lib.ptt_flash_fwd_stats_f32.restype = ctypes.c_int


def _declare_flash_bwd(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ptt_flash_bwd_f32.argtypes = [p] * 12 + [ctypes.c_longlong, i, i, i,
                                                 i, i, f, p]
    lib.ptt_flash_bwd_f32.restype = ctypes.c_int
    lib.ptt_flash_bwd_attributes.argtypes = [
        i, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char_p)]
    lib.ptt_flash_bwd_attributes.restype = ctypes.c_int


#: each CUDA source (``csrc/<name>.cu``) and the C signatures of its library
_SOURCES = {"matmul": _declare_matmul, "flash_attention": _declare_flash,
            "flash_attention_bwd": _declare_flash_bwd}

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


def _library_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"{name}_{key[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name (default: every source)
    unless a build of the same source and flags exists, one ``nvcc`` per
    source, all started together; return each library's path."""
    names = list(_SOURCES if names is None else names)
    for name in names:
        if name not in _SOURCES:
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
                [nvcc, *_NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for name, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed to build {name}.cu:\n{log}")
            else:   # atomic: a concurrent build sees all or none
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
    """The library built from ``csrc/<name>.cu``, loaded once per process
    with its C signatures declared."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _SOURCES[name](lib)
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def _check_cuda_operands(op: str, ts: Tuple[torch.Tensor, ...]) -> None:
    """What every CUDA kernel here takes: contiguous fp32 on one device."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{op}: tensors on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: the CUDA kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous tensors")


def _raise_launch(op: str, lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: "
                           f"{lib.ptt_error_string(rc).decode()} ({rc})")


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               c: Optional[torch.Tensor] = None, *, trans_b: bool = False,
               alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """The kernel's plain version: ``beta*C + alpha*(A @ op(B))`` with
    ``torch.matmul`` in fp32.  A leading batch dimension is looped over,
    so each slice is exactly the unbatched computation."""
    if a.dim() == 3:
        return torch.stack([
            gemm_plain(a[i], b[i], None if c is None else c[i],
                       trans_b=trans_b, alpha=alpha, beta=beta)
            for i in range(a.shape[0])])
    p = alpha * torch.matmul(a.float(), (b.mT if trans_b else b).float())
    return p if c is None else beta * c.float() + p


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         *, trans_b: bool = False, alpha: float = 1.0,
         beta: float = 0.0) -> torch.Tensor:
    """``Out = beta*C + alpha*(A @ op(B))``, ``op(B) = B^T`` when
    ``trans_b``.  A is ``[M, K]``, B ``[N, K]`` (trans_b) or ``[K, N]``,
    C ``[M, N]`` or None; all may carry one leading batch dimension,
    which becomes the kernel's ``gridDim.z``.  CPU tensors take the plain
    version; CUDA tensors must be contiguous fp32 on one device."""
    global matmul_launches
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
    _check_cuda_operands("gemm", ts)
    if batch > 65535:
        raise ValueError(f"gemm: batch {batch} exceeds gridDim.z")
    out = torch.empty(tuple(a.shape[:-1]) + (N,), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out
    lib = load("matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.ptt_matmul_f32(
            a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
            out.data_ptr(), batch, M, N, K,
            M * K, b.shape[-2] * b.shape[-1], M * N, M * N,
            K, b.shape[-1], N, N,
            int(trans_b), float(alpha), float(beta), stream)
    _raise_launch("gemm", lib, rc)
    matmul_launches += 1
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
    """``[M, K] @ [K, N]`` through the GEMM kernel, accumulated in fp32;
    differentiable."""
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel's plain version: a materialised masked softmax,
    as the JAX package's ``local_attention`` computes it off the kernel."""
    _attention_shapes("flash_attention", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_masked_scores(q, k, causal, scale), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = False,
                                scale: Optional[float] = None):
    """The stats kernel's plain version, the counterpart of
    ``_flash_stats_reference``: ``(o, m, l)`` with each row's raw max and
    denominator.  A row with no visible key keeps m = -1e30, l = 0 and
    o = 0; only o is safe-normalised."""
    _attention_shapes("flash_attention_stats", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    dead = m <= NEG_INF
    l = torch.where(dead, 0.0, p.sum(dim=-1))
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe[..., None]
    o = torch.where(dead[..., None], 0.0, o).to(q.dtype)
    return o, m, l


def _flash_launch(op: str, q, k, v, causal: bool, scale: Optional[float],
                  stats: bool):
    """Check the operands and launch the kernel of
    ``csrc/flash_attention.cu``, counting the instance launched; returns
    ``o`` or ``(o, m, l)``."""
    global flash_launches, flash_stats_launches
    B, H, T, Tk, D = _attention_shapes(op, q, k, v)
    _check_cuda_operands(op, (q, k, v))
    if not 1 <= D <= FLASH_D_MAX:
        raise ValueError(f"{op}: the CUDA kernel takes head widths "
                         f"1..{FLASH_D_MAX}, got {D}")
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
    lib = load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if stats:
            rc = lib.ptt_flash_fwd_stats_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                m.data_ptr(), l.data_ptr(), B * H, T, Tk, D, int(causal),
                float(scale), stream)
        else:
            rc = lib.ptt_flash_fwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B * H, T, Tk, D, int(causal), float(scale), stream)
    _raise_launch(op, lib, rc)
    if stats:
        flash_stats_launches += 1
    else:
        flash_launches += 1
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
    take the plain versions; CUDA tensors must be contiguous fp32 with
    ``D <= 128``.  Differentiable: while grad mode is on and an input
    needs a gradient, the forward keeps the row statistics and the
    backward is ``flash_attention_bwd``."""
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
    mask with the local-index causal rule, and l == 0 -> 1.  ``o`` is
    not read: the kernel takes ``delta = rowsum(dO * O)``, the same
    number."""
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
    tensors take the plain version; CUDA tensors must be contiguous fp32
    on one device with ``D <= 128``."""
    global flash_bwd_launches
    B, H, T, Tk, D = _bwd_shapes(q, k, v, o, m, l, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, m, l, do, causal, scale)
    op = "flash_attention_bwd"
    _check_cuda_operands(op, (q, k, v, o, m, l, do))
    if not 1 <= D <= FLASH_D_MAX:
        raise ValueError(f"{op}: the CUDA kernel takes head widths "
                         f"1..{FLASH_D_MAX}, got {D}")
    if scale is None:
        scale = D ** -0.5
    dq = torch.empty_like(q)
    if T == 0 or B * H == 0:     # no query sees a key
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    counters = _flash_bwd_counters(B * H, T, q.device)
    lib = load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_flash_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            counters.data_ptr(), counters.numel(), B * H, T, Tk, D,
            int(causal), float(scale), stream)
    _raise_launch(op, lib, rc)
    flash_bwd_launches += 1
    return dq, dk, dv
