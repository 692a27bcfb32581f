"""Matrix inverses and the general solve — the DPLASMA potri-family slice
(trtri, lauum, potri) and gesv via getrf/getrs.

As in the JAX package's ``ops/inverse.py``, these are whole-matrix
programs, not task DAGs: a triangular inverse is one triangular solve
against the identity, lauum one large product.  Each takes an array or a
tensor and runs on ``device`` (default ``cuda:0``, raising without a
card; ``device="cpu"`` runs on the host), returning tensors there.
"""
from __future__ import annotations

from typing import Any

import torch

from ..devices import as_tensor
from .dgetrf import dgetrf

__all__ = ["dtrtri", "dlauum", "dpotri", "dgetrs", "dgesv"]


def dtrtri(T: Any, lower: bool = True, unit_diagonal: bool = False,
           device: Any = None) -> torch.Tensor:
    """Inverse of a triangular matrix (ref algorithm: DPLASMA ztrtri)."""
    T = as_tensor(T, device)
    eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    return torch.linalg.solve_triangular(T, eye, upper=not lower,
                                         unitriangular=unit_diagonal)


def dlauum(T: Any, lower: bool = True, device: Any = None) -> torch.Tensor:
    """L^T L (lower) / U U^T (upper) — the lauum kernel of potri.  The
    product follows the caller's ``torch.backends.cuda.matmul.allow_tf32``
    (off by PyTorch's default, so fp32 inputs accumulate in fp32)."""
    T = as_tensor(T, device)
    Tt = torch.tril(T) if lower else torch.triu(T)
    return Tt.mT @ Tt if lower else Tt @ Tt.mT


def dpotri(L: Any, lower: bool = True, device: Any = None) -> torch.Tensor:
    """SPD inverse from the Cholesky factor: A^{-1} = L^{-T} L^{-1}
    (ref: DPLASMA zpotri = ztrtri + zlauum).  ``L`` is dpotrf's output
    (lower triangle holds the factor)."""
    return dlauum(dtrtri(L, lower=lower, device=device), lower=lower,
                  device=device)


def dgetrs(LU: Any, perm: Any, B: Any, device: Any = None) -> torch.Tensor:
    """Solve A X = B from dgetrf's packed factors and row permutation."""
    if LU.shape[0] != LU.shape[1]:
        raise ValueError(
            f"dgetrs needs square packed factors, got {tuple(LU.shape)} "
            f"(rectangular dgetrf output has no solve)")
    LU = as_tensor(LU, device)
    perm = as_tensor(perm, LU.device).long()
    Y = torch.linalg.solve_triangular(LU, as_tensor(B, LU.device)[perm],
                                      upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(LU, Y, upper=True)


def dgesv(A: Any, B: Any, nb: int = 256, device: Any = None) -> torch.Tensor:
    """General solve A X = B: pivoted LU + two triangular solves
    (ref: DPLASMA zgesv)."""
    LU, perm = dgetrf(A, nb=nb, device=device)
    return dgetrs(LU, perm, B, device=LU.device)
