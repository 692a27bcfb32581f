"""Tile kernels (hand-written CUDA kernels and torch.linalg for task
BODYs) and the tile algorithms built on them (dpotrf, dposv, dgetrf_nopiv,
dgeqrf, pdgemm), the pivoted LU and the inverses."""
from . import kernels
from .kernels import flash_attention
from .linalg import (axpy, gemm, gemm_nn, gemm_nn_sub, gemm_nt,
                     gemm_tn_sub, geqrt, geqrt_r, getrf_nopiv, potrf, scal,
                     syrk_ln, transpose, trsm_lower, trsm_lower_trans,
                     trsm_lower_unit, trsm_panel, trsm_upper_right, tsmqr,
                     tsqrt, tsqrt_r, unmqr)
from . import dpotrf as dpotrf_module
from .dpotrf import dpotrf, dpotrf_factory, dpotrf_taskpool, make_spd
from .dgeqrf import dgeqrf, dgeqrf_factory, dgeqrf_taskpool
from .inverse import dgesv, dgetrs, dlauum, dpotri, dtrtri
from .dgetrf import (dgetrf, dgetrf_factory, dgetrf_nopiv, dgetrf_nopiv_taskpool,
                     make_diag_dominant)
from .pdgemm import pdgemm, pdgemm_factory, pdgemm_taskpool
from .dtrsm import (dposv, dtrsm_lower_taskpool, dtrsm_lower_trans_taskpool)

__all__ = ["potrf", "trsm_panel", "syrk_ln", "gemm_nt", "gemm_nn",
           "gemm_nn_sub", "gemm", "axpy", "scal", "transpose",
           "geqrt", "geqrt_r", "unmqr", "tsqrt", "tsqrt_r", "tsmqr",
           "getrf_nopiv", "trsm_lower_unit", "trsm_upper_right",
           "dpotrf", "dpotrf_factory", "dpotrf_taskpool", "make_spd",
           "dgeqrf", "dgeqrf_factory", "dgeqrf_taskpool",
           "dgetrf", "dgetrf_nopiv", "dgetrf_nopiv_taskpool", "dgetrf_factory",
           "dtrtri", "dlauum", "dpotri", "dgetrs", "dgesv",
           "make_diag_dominant",
           "pdgemm", "pdgemm_factory", "pdgemm_taskpool",
           "dposv", "dtrsm_lower_taskpool", "dtrsm_lower_trans_taskpool",
           "trsm_lower", "trsm_lower_trans", "gemm_tn_sub",
           "kernels", "flash_attention"]
