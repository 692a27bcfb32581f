"""Tile linear-algebra kernels: the BODY payloads of the dense tile
algorithms (dpotrf, dtrsm/dposv, dgetrf_nopiv, dgeqrf, pdgemm).

The port's counterpart of the JAX package's ``ops/linalg.py``, with the
same names and maths.  Each body takes one tile per argument, or a stack
of tiles with a leading batch dimension (the device module's batched
dispatch, devices/batching.py), and returns new contiguous tensors,
matching the device module's stage-out convention.  Transposes are
``.mT`` and concatenations run along ``dim=-2``, so one code serves both
forms.

- Every product body (``syrk_ln``, ``gemm_nt``, ``gemm_nn``,
  ``gemm_nn_sub``, ``gemm``, ``gemm_tn_sub``, ``unmqr``, ``tsmqr``) runs
  the hand-written GEMM kernel (ops/kernels.py), ``Out = beta*C +
  alpha*A op(B)`` accumulated in fp32; a batch is ONE launch over
  ``gridDim.z``, each slice doing the per-task arithmetic in the same
  order, so batched results are bit-exact.  The kernel transposes B
  natively but not A: the three bodies that need A^T pass a contiguous
  copy (``transpose``).
- The factorisations and triangular solves (``potrf``, ``trsm_*``,
  ``geqrt*``, ``tsqrt*``, ``getrf_nopiv``) stay ``torch.linalg`` and loop
  over a batch one tile at a time: a batched library call may pick
  another algorithm than the per-tile one and break that bit-exactness.
  None of them was Pallas in the JAX package.

On CPU tensors every body computes with the plain PyTorch versions.
"""
from __future__ import annotations

import functools

import torch

from . import kernels


def _per_tile(fn):
    """Run ``fn`` tile by tile over a leading batch dimension and stack
    the results (each output of a tuple on its own)."""
    @functools.wraps(fn)
    def body(*args):
        if args[0].dim() != 3:
            return fn(*args)
        outs = [fn(*tiles) for tiles in zip(*args)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)
    return body


def transpose(x: torch.Tensor) -> torch.Tensor:
    """x^T as a new contiguous tensor.  The GEMM kernel reads its A
    operand as stored, so the bodies that need A^T copy it here."""
    return x.mT.contiguous()


# ---------------------------------------------------------------------- #
# tile Cholesky                                                          #
# ---------------------------------------------------------------------- #
@_per_tile
def potrf(t: torch.Tensor) -> torch.Tensor:
    """Cholesky of one diagonal tile: T = chol_L(T).  ``cholesky_ex``
    does not synchronise with the host to check ``info``; a tile that is
    not positive definite yields NaNs, as in the JAX package."""
    # LAPACK-style results come back column-major; tiles stay row-major
    return torch.linalg.cholesky_ex(t, check_errors=False).L.contiguous()


@_per_tile
def trsm_panel(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Right-looking panel solve: C <- C * T^{-T} with T lower triangular
    (L[m,k] = A[m,k] L[k,k]^{-T})."""
    return torch.linalg.solve_triangular(t.mT, c, upper=True,
                                         left=False).contiguous()


def syrk_ln(t: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """T <- T - A A^T, over the whole tile (not only its lower triangle),
    so tiles match the JAX package's layout."""
    return kernels.gemm(a, a, t, trans_b=True, alpha=-1.0, beta=1.0)


def gemm_nt(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C <- C - A B^T."""
    return kernels.gemm(a, b, c, trans_b=True, alpha=-1.0, beta=1.0)


# ---------------------------------------------------------------------- #
# general products                                                       #
# ---------------------------------------------------------------------- #
def gemm_nn(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C <- C + A B."""
    return kernels.gemm(a, b, c, alpha=1.0, beta=1.0)


def gemm_nn_sub(c: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """C <- C - A B (trailing update of LU, forward substitution)."""
    return kernels.gemm(a, b, c, alpha=-1.0, beta=1.0)


def gemm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         alpha: float = 1.0, beta: float = 1.0, *,
         trans_b: bool = False) -> torch.Tensor:
    """C <- beta*C + alpha*A op(B), op(B) = B^T when ``trans_b`` (the
    kernel reads B transposed in place; pdgemm's TRANSB = 't')."""
    return kernels.gemm(a, b, c, trans_b=trans_b, alpha=alpha, beta=beta)


def gemm_tn_sub(c: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """C <- C - A^T B (backward-substitution update)."""
    return kernels.gemm(transpose(a), b, c, alpha=-1.0, beta=1.0)


def axpy(y: torch.Tensor, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return y + alpha * x


def scal(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return alpha * x


# ---------------------------------------------------------------------- #
# tile QR: explicit orthogonal factors (see ops/dgeqrf.py)               #
# ---------------------------------------------------------------------- #
@_per_tile
def geqrt(a: torch.Tensor):
    """QR of one diagonal tile: returns (R, Q) with A = Q R; the explicit
    Q plays the role of the reference's compact-WY pair (V, T)."""
    q, r = torch.linalg.qr(a, mode="complete")
    return r.contiguous(), q.contiguous()


@_per_tile
def geqrt_r(a: torch.Tensor):
    """Last-panel geqrt: no Q consumers exist, so only R is formed; the
    Q output is a zero placeholder."""
    return torch.linalg.qr(a, mode="r").R.contiguous(), torch.zeros_like(a)


def unmqr(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Apply Q^T from geqrt to a tile right of the diagonal: C <- Q^T C."""
    return kernels.gemm(transpose(q), c)


@_per_tile
def tsqrt(r: torch.Tensor, a: torch.Tensor):
    """Triangle-on-top-of-square QR: factor [R; A] (R upper triangular).
    Returns (R', Z, Q2): the updated nb x nb triangle, the zeroed square
    block, and the orthogonal factor of the stacked system."""
    nb = r.shape[-2]
    q2, rf = torch.linalg.qr(torch.cat([r, a], dim=-2), mode="complete")
    return rf[:nb].contiguous(), torch.zeros_like(a), q2.contiguous()


@_per_tile
def tsqrt_r(r: torch.Tensor, a: torch.Tensor):
    """Last-panel tsqrt: R-only factorization of [R; A], zero Q2
    placeholder (no tsmqr consumers on the final panel)."""
    nb = r.shape[-2]
    rf = torch.linalg.qr(torch.cat([r, a], dim=-2), mode="r").R
    n2 = nb + a.shape[-2]
    return (rf[:nb].contiguous(), torch.zeros_like(a),
            torch.zeros((n2, n2), dtype=r.dtype, device=r.device))


def tsmqr(q2: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor):
    """Apply Q2^T from tsqrt to a stacked tile pair:
    [A1; A2] <- Q2^T [A1; A2].  One launch over the stacked pair; each
    half is copied out contiguous, so a batch's halves are stacks too."""
    top = a1.shape[-2]
    s = kernels.gemm(transpose(q2), torch.cat([a1, a2], dim=-2))
    return s[..., :top, :].contiguous(), s[..., top:, :].contiguous()


# ---------------------------------------------------------------------- #
# tile LU without pivoting, and the triangular solves                    #
# ---------------------------------------------------------------------- #
def getrf_nopiv_plain(a: torch.Tensor) -> torch.Tensor:
    """The JAX package's algorithm in torch ops: n full-shape masked
    rank-1 updates (unit-lower L strictly below the diagonal, U on and
    above).  The CPU path of ``getrf_nopiv``, and its plain version."""
    if a.dim() == 3:
        return torch.stack([getrf_nopiv_plain(x) for x in a])
    rows = torch.arange(a.shape[0], device=a.device)
    cols = torch.arange(a.shape[1], device=a.device)
    acc = a
    for k in range(min(a.shape)):
        col = acc[:, k]
        l = torch.where(rows > k, col / acc[k, k], 0.0)
        row = torch.where(cols > k, acc[k, :], 0.0)
        acc = acc - torch.outer(l, row)
        acc[:, k] = torch.where(rows > k, l, col)
    return acc


@_per_tile
def getrf_nopiv(a: torch.Tensor) -> torch.Tensor:
    """LU without pivoting of one square diagonal tile, in the same
    storage.  A CUDA tile goes through ``lu_factor_ex(pivot=False)``
    (PyTorch implements it on CUDA only); a CPU tile through the plain
    masked loop.  A zero pivot yields inf/NaN, as in the JAX package."""
    if a.device.type == "cpu":
        return getrf_nopiv_plain(a)
    return torch.linalg.lu_factor_ex(a, pivot=False).LU.contiguous()


@_per_tile
def trsm_lower_unit(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Row-panel update for LU: C <- L^{-1} C, L = unit-lower of T."""
    return torch.linalg.solve_triangular(t, c, upper=False,
                                         unitriangular=True).contiguous()


@_per_tile
def trsm_lower(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C <- L^{-1} C, L = (non-unit) lower of T (forward substitution)."""
    return torch.linalg.solve_triangular(t, c, upper=False).contiguous()


@_per_tile
def trsm_lower_trans(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C <- L^{-T} C, L = lower of T (backward substitution)."""
    return torch.linalg.solve_triangular(t.mT, c, upper=True).contiguous()


@_per_tile
def trsm_upper_right(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Column-panel update for LU: C <- C U^{-1}, U = upper of T."""
    return torch.linalg.solve_triangular(t, c, upper=True,
                                         left=False).contiguous()
