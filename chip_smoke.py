#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parsec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--profile]

Phases, each reporting on its own lines:

1. device   the card's name, and its name and power limit from nvidia-smi;
2. build    every CUDA source of this checkout (csrc/*.cu), one nvcc for
            each, all started together, beside one nvcc -Xptxas -v for
            each, which then gives each kernel instance's registers and
            spills;
3. kernel   the GEMM kernel against its plain PyTorch version on the
            card, at the dpotrf path's tile shape (nb = 1024): matmul,
            gemm_nt, syrk_ln, a batched z = 8 launch, ragged 1000^3 and
            999 x 1001 x 997 products (both forms), a 130 x 70 x 36
            product, 4-byte-misaligned operands, a ragged z = 3 launch
            and the gradient; relative max error under 1e-4 (the two sum
            in different orders in fp32); batched launches bit-exact
            against single ones, misaligned against aligned copies;
4. attention both flash kernels against their plain versions on the
            card: [8, 12, 1024, 64] causal (the forward's shape) and
            non-causal, ragged T = Tk = 1000 with D = 40, 64 and 128,
            T = 256 with Tk = 384 and 200, T = 1000 with Tk = 1500 and
            300, T = 300 with Tk = 1000, D = 33, D = 128 with T = 200 and
            Tk = 333, 4-byte-misaligned operands (bit-exact against
            aligned copies); the stats kernel's m and l too, and the
            merge rule over two key sets against attention over their
            concatenation; relative max error under 1e-4; then the
            backward kernel against its plain version at every one of
            these cases and at [16, 16, 2048, 64] causal, a grid of
            work items many times what the card holds at once (dq, dk,
            dv from the stats kernel's o, m, l and a seeded cotangent),
            under 1e-4, three launches bit-equal at every case (each
            waited for against a deadline, so a stuck dQ turn fails
            instead of hanging), misaligned operands bit-exact against
            aligned copies;
4b. bodies  the DPLASMA family's product bodies (gemm_nn_sub, gemm_tn_sub,
            unmqr, tsmqr, gemm with alpha 1.5 and beta 0.5, and with B
            transposed) against the GEMM kernel's plain version on the
            operands each must pass, and getrf_nopiv's lu_factor_ex
            against its masked loop, at nb = 1024, single and batched
            z = 4; batched results bit-exact against single calls;
5. main     the dpotrf path at full size, through the entry points a user
            calls: init() -> TwoDimBlockCyclic.from_numpy -> ops.dpotrf
            on a 16384^2 fp32 matrix in 1024^2 tiles (816 tasks); every
            task on cuda:0, the GEMM kernel launched, the mean batch
            (GEMM and SYRK tasks per launch), and the factor's matvec
            residual under 1e-4;
5b. dplasma the rest of the family at the same size, one line each with
            the wall seconds, GFLOP/s by DPLASMA's flop counts, the tasks
            on cuda:0 against their count, the GEMM kernel's launches and
            mean batch, the stage-in/out bytes and a matvec residual
            (fp64 on the host, 4 random vectors) under 1e-4 (normwise
            for the solves and the pivoted dgetrf): dposv with
            1024 right-hand sides (dpotrf, then forward and backward
            substitution, 1088 tasks); dgetrf_nopiv of a diagonally
            dominant matrix (1496); dgeqrf of a uniform one (1496, with
            the Q/Q2 scratch bytes); pdgemm, alpha 1.5, beta 0.5, with
            op(A) = A and A^T (4096 device tasks each); then the
            whole-matrix dgetrf, dgesv and dpotri (of dposv's factor);
5c. dtd     the same tile Cholesky through the DTD front end on phase
            main's input: tile_of(A, (m, n)), POTRF/TRSM/SYRK/GEMM
            inserted in the k loop's order with the tile bodies as CUDA
            chores (add_chore after one boot task per class on a small
            tile), data_flush_all, wait; all 816 tasks on cuda:0 (a host
            body raises for any but a boot task), the GEMM kernel's
            launches and mean batch, the factor bit-identical to main's,
            its residual under 1e-4;
5d. dtd_gemm the reference's dtd_test_simple_gemm shape: C += A B over
            NT^3 = 4096 tasks, chore ops.gemm_nn, chained on C(m, n) in
            k order; all on cuda:0, GFLOP/s (2 N^3 over the wall), the
            residual;
6. bitexact batched and per-task dispatch give identical factors
            (N = 4096, NB = 512), dpotrf and dgetrf_nopiv;
6a. static  dpotrf at N = 16384, NB = 1024 with ptg_dep_management=static
            and ptg_dispatch=classic through init(): the lowered DAG and
            the native engine release every task; then
    turbo   the turbo native loop (ptg_dispatch=auto on a static pool):
            dpotrf at NB = 1024 (816 tasks) and NB = 512 (5984, the JAX
            package's runtime@NB=512), dgetrf_nopiv and dgeqrf at 1024,
            each GEMM-kernel task one launch, with
            turbo_dispatch_us_per_task (the loop's host seconds over the
            tasks); then
    wave    wave(tp).run() on cuda:0: dpotrf at NB = 1024 and 512 (the
            JAX package's wave@NB=1024/512), dgetrf_nopiv, pdgemm with
            op(A) = A and dgeqrf, with the runner's stats (waves, body
            calls) and the pools' stage-in bytes; dpotrf at 1024 needs
            fewer calls than a third of its tasks.  Each line has the
            wall (from the entry call to torch.cuda.synchronize()),
            GFLOP/s, the tasks run on cuda:0, the GEMM kernel's launches
            and mean batch, the residual under 1e-4 and the result's
            bit-identity to the interpreted path's on the same input
            (main's, dgetrf_nopiv's, dgeqrf's, pdgemm_nn's, and one
            interpreted dpotrf at NB = 512 run for it);
6b. capture dpotrf, dposv (capture_sequence of its three pools), pdgemm
            (op(A) = A, run through the context's device module, C left
            on the card), dgetrf_nopiv and dgeqrf each recorded as ONE
            CUDA graph: capture seconds (warm-up and record), the run's
            wall and its replay's device time (CUDA events), the GEMM
            launches recorded in the graph and the replays (apart: a
            replay counts nothing), the peak device memory; dpotrf runs
            twice, on main's input (bit-identical factor) and on another
            seeded matrix; every residual under 1e-4;
6c. dtd_capture phase dtd's Cholesky recorded through dtd_capture() and
            replayed; bit-identical to phase dtd's factor;
7. forward  the transformer path at GPT-2-small widths (vocab 50257,
            d_model 768, 12 heads of 64, 12 layers, d_ff 3072, sequence
            1024, batch 8, fp32, seeded random weights) through
            models.make_forward, once with attention="ring" (the stats
            kernel) and once with "flash" (the forward kernel): one
            warm-up and 3 seeded batches each, seconds and tokens/s per
            forward, 12 launches of the path's kernel per forward and
            none of the other, finite logits, ring and flash logits
            within 2e-4 of each other, and sequence 0 of the first batch
            within 2e-4 of the port's CPU run (plain versions, fp32);
7b. train   the same model trained through models.make_train_step, lr
            1e-3, one seeded batch with labels roll(tokens, -1): for
            attention="flash", "flash" with remat=True and "ring", one
            warm-up and 3 timed Adam steps, each step's seconds, tokens/s,
            peak device memory, loss (finite, lower at the last step than
            at the first) and launches, exact: 12 of the stats instance
            (the training forward of flash_attention; 24 with remat, which
            recomputes each layer) and 12 of the backward kernel a flash
            step, 12 stats launches and no backward a ring step (its VJP
            recomputes through the plain ring); two flash steps from the
            same state bit-identical in loss and gradients; remat within
            1e-5 of no remat; each layer's and the head's gradients (every
            parameter and dx) on sequence 0 within 1e-3 of the CPU port's
            on the card's input and cotangent, beside the CPU's
            fp32-vs-fp64 drift; the whole-depth loss against the CPU's,
            reported;
8. timing   each kernel at its path's shape, by CUDA events: the GEMM
            at nb = 1024 against torch.addmm, batched at z = 1, 4 and 16
            against torch.baddbmm, and at tsmqr's shape (2048 x 1024 x
            2048) against torch.mm, beside the A^T copies; each flash
            kernel at [8, 12, 1024, 64] causal against
            F.scaled_dot_product_attention (fp32; it returns o alone),
            beside its bound and its plain version; the backward kernel
            at the same shape against SDPA's backward (its forward plus
            backward less its forward), and each of its instances'
            registers, local (spill) bytes, shared memory and resident
            blocks an SM (cudaFuncGetAttributes);
9. profile  with --profile only: the dpotrf, DTD Cholesky, dgeqrf and
            pdgemm (both forms) paths, one replay of the captured dpotrf,
            the wave dpotrf at NB = 1024 (stage-in, waves and write-back),
            the pivoted dgetrf, one forward and one flash train step once
            more under torch.profiler, with device time by kernel (the
            A^T copies are the direct-copy kernel) and the device's busy
            share of the wall time; then the GEMM, stats and backward
            kernels and their library yardsticks once each, with the
            device kernels each call runs.

Any failure raises and exits non-zero; so does a machine where PyTorch
sees no CUDA device.  The line before the last is the kernels' record
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN, NB_MAIN = 16384, 1024
N_BITEXACT, NB_BITEXACT = 4096, 512
NRHS = 1024            # right-hand sides of dposv and dgesv: one tile column
ATTN_SHAPE = (8, 12, 1024, 64)   # B, H, T, D of the forward's attention
N_BATCHES = 3          # timed forwards per attention, after one warm-up
RTOL = 1e-4            # kernel vs plain version, relative max error
RESID_TOL = 1e-4       # matvec residual of each routine, fp32
#: dpotri's residual ||A (A^-1 x) - x|| / ||x||: at most about kappa(A) times
#: the inverse's relative error; synth_spd's A = (B + B^T)/2 + n I has its
#: eigenvalues within n +- ||B||_2 (about n +- 2 sqrt(n/12)), kappa < 1.01
DPOTRI_TOL = 1e-4
LOGITS_RTOL = 2e-4     # forward logits: ring vs flash, card vs CPU, fp32
TRAIN_STEPS = 3        # timed Adam steps per train path, after one warm-up
TRAIN_LR = 1e-3
#: each layer's and the head's gradients, card vs the CPU port on the same
#: input and cotangent, relative max error (fp32, summed in other orders)
GRAD_RTOL = 1e-3
REMAT_RTOL = 1e-5      # remat vs no remat, every gradient, on the card
F32_FLOPS = 67e12      # H100 SXM fp32 peak outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values in a contiguous view 4 bytes past a 16-byte
    boundary: the kernels' 4-byte-copy instances take it."""
    return torch.empty(x.numel() + 1, device=x.device)[1:].view(
        x.shape).copy_(x)


def rel_err(out: torch.Tensor, ref: torch.Tensor):
    d = (out.double() - ref.double()).abs().max().item()
    return d / ref.double().abs().max().item(), d


COUNTERS = ("matmul_launches", "flash_launches", "flash_stats_launches",
            "flash_bwd_launches")


def reset_counts() -> None:
    from parsec_tpu_torch.ops import kernels
    for name in COUNTERS:
        setattr(kernels, name, 0)


def counts() -> dict:
    from parsec_tpu_torch.ops import kernels
    return {name: getattr(kernels, name) for name in COUNTERS}


# ---------------------------------------------------------------------- #
# phases                                                                 #
# ---------------------------------------------------------------------- #
def phase_device() -> str:
    check(torch.cuda.is_available(), "PyTorch sees no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return name


def phase_build() -> None:
    from parsec_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    with ptxas_report():
        libs = kernels.build()
        for name in libs:
            kernels.load(name)
        log("build", seconds=f"{time.perf_counter() - t0:.3f}",
            libraries=",".join(so.name for so in libs.values()))


@contextlib.contextmanager
def ptxas_report():
    """Registers and spills of every kernel instance, from ``nvcc -Xptxas
    -v`` on each source (one nvcc each), started before the body (the
    build) and reported after it."""
    import re
    import tempfile
    from parsec_tpu_torch.ops import kernels
    flags = [f for f in kernels._NVCC_FLAGS if f not in ("-shared",)]
    kernels._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels._BUILD_DIR) as tmp:
        procs = {name: subprocess.Popen(
            [kernels._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
             f"{tmp}/{name}.o", str(kernels._CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in kernels._SOURCES}
        try:
            yield
        finally:
            reports = {name: p.communicate()[0]
                       for name, p in procs.items()}
    for name, text in reports.items():
        check(procs[name].returncode == 0,
              f"nvcc -Xptxas -v {name}:\n{text}")
        fn = None
        for line in text.splitlines():
            if (hit := re.search(r"Compiling entry function '(\w+)'", line)):
                fn, spills = hit.group(1), ("?", "?")
            elif (hit := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)):
                spills = hit.groups()
            elif (hit := re.search(r"Used (\d+) registers", line)) and fn:
                log("ptxas", source=f"{name}.cu", kernel=demangle(fn),
                    registers=hit.group(1), spill_stores=spills[0],
                    spill_loads=spills[1])
                fn = None


def demangle(symbol: str) -> str:
    """The kernel's C++ name, through the toolkit's cu++filt if it has one."""
    from pathlib import Path
    from parsec_tpu_torch.ops import kernels
    tool = Path(kernels._nvcc()).parent / "cu++filt"
    if not tool.exists():
        return symbol
    return subprocess.run([str(tool), symbol], capture_output=True, text=True
                          ).stdout.strip().replace(" ", "") or symbol


def phase_kernel(dev: torch.device, seed: int) -> float:
    """Kernel vs plain version on the card; returns the max abs error
    over the cases at the shapes the main path launches."""
    from parsec_tpu_torch.ops import kernels, linalg
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    nb = NB_MAIN
    a, b, c = rnd(nb, nb), rnd(nb, nb), rnd(nb, nb)
    a8, b8, c8 = rnd(8, nb, nb), rnd(8, nb, nb), rnd(8, nb, nb)
    r1, r2 = rnd(1000, 1000), rnd(1000, 1000)
    # M, N, K not multiples of 4, nor of the 128x64 block tile
    ra, rc = rnd(999, 997), rnd(999, 1001)
    rb_t, rb = rnd(1001, 997), rnd(997, 1001)
    ua, ub, uc = (misaligned(rnd(nb, nb)) for _ in range(3))
    sa, sb, sc = rnd(130, 36), rnd(70, 36), rnd(130, 70)
    a3, b3, c3 = rnd(3, 999, 997), rnd(3, 1001, 997), rnd(3, 999, 1001)
    nt = dict(trans_b=True, alpha=-1.0, beta=1.0)
    # (case, kernel, plain version, at a shape the main path launches)
    cases = [
        ("matmul", lambda: kernels.matmul(a, b),
         lambda: kernels.gemm_plain(a, b), False),
        ("gemm_nt", lambda: linalg.gemm_nt(c, a, b),
         lambda: kernels.gemm_plain(a, b, c, **nt), True),
        ("syrk_ln", lambda: linalg.syrk_ln(c, a),
         lambda: kernels.gemm_plain(a, a, c, **nt), True),
        ("gemm_nt_z8", lambda: linalg.gemm_nt(c8, a8, b8),
         lambda: kernels.gemm_plain(a8, b8, c8, **nt), True),
        ("ragged_1000", lambda: kernels.gemm(r1, r2),
         lambda: kernels.gemm_plain(r1, r2), False),
        ("ragged_1000_nt", lambda: linalg.gemm_nt(r1, r2, r1),
         lambda: kernels.gemm_plain(r2, r1, r1, **nt), False),
        ("ragged_999x1001x997_nt", lambda: linalg.gemm_nt(rc, ra, rb_t),
         lambda: kernels.gemm_plain(ra, rb_t, rc, **nt), False),
        ("ragged_999x1001x997",
         lambda: kernels.gemm(ra, rb, rc, alpha=-1.0, beta=1.0),
         lambda: kernels.gemm_plain(ra, rb, rc, alpha=-1.0, beta=1.0),
         False),
        ("misaligned_gemm_nt", lambda: linalg.gemm_nt(uc, ua, ub),
         lambda: kernels.gemm_plain(ua, ub, uc, **nt), False),
        ("misaligned_matmul", lambda: kernels.gemm(ua, ub),
         lambda: kernels.gemm_plain(ua, ub), False),
        ("small_130x70x36_nt", lambda: linalg.gemm_nt(sc, sa, sb),
         lambda: kernels.gemm_plain(sa, sb, sc, **nt), False),
        ("ragged_z3_nt", lambda: linalg.gemm_nt(c3, a3, b3),
         lambda: kernels.gemm_plain(a3, b3, c3, **nt), False),
    ]
    worst = 0.0
    for name, fn, plain, on_path in cases:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        rel, absd = rel_err(out, ref)
        if on_path:
            worst = max(worst, absd)
        log("kernel", case=name, shape=tuple(out.shape), rel_err=rel,
            max_abs_err=absd)
        check(rel < RTOL, f"kernel {name}: relative error {rel} >= {RTOL}")
    # one batched launch is bit-exact against single launches: z = 8 at the
    # main path's tile (16-byte copies), z = 3 ragged (4-byte copies)
    for name, (cz, az, bz) in (("gemm_nt_z8_vs_single", (c8, a8, b8)),
                               ("gemm_nt_z3_ragged_vs_single", (c3, a3, b3))):
        batched = linalg.gemm_nt(cz, az, bz)
        for i in range(cz.shape[0]):
            check(torch.equal(batched[i], linalg.gemm_nt(cz[i], az[i], bz[i])),
                  f"{name}: batched slice {i} differs from its single launch")
        torch.cuda.synchronize()
        log("kernel", case=name, bit_exact=True)
    # the 4-byte-copy variant does the same arithmetic as the 16-byte one
    check(torch.equal(linalg.gemm_nt(uc, ua, ub),
                      linalg.gemm_nt(uc.clone(), ua.clone(), ub.clone())),
          "misaligned and aligned copies of one gemm_nt differ")
    log("kernel", case="misaligned_vs_aligned", bit_exact=True)
    # gradient: the backward runs the kernel on the transposes
    ak = a.clone().requires_grad_(True)
    bk = b.clone().requires_grad_(True)
    (kernels.matmul(ak, bk) ** 2).sum().backward()
    ap = a.clone().requires_grad_(True)
    bp = b.clone().requires_grad_(True)
    (torch.matmul(ap, bp) ** 2).sum().backward()
    torch.cuda.synchronize()
    for name, x, ref in (("grad_a", ak.grad, ap.grad),
                         ("grad_b", bk.grad, bp.grad)):
        rel, absd = rel_err(x, ref)
        log("kernel", case=name, shape=tuple(x.shape), rel_err=rel,
            max_abs_err=absd)
        check(rel < RTOL, f"kernel {name}: relative error {rel} >= {RTOL}")
    return worst


def phase_bodies(dev: torch.device, seed: int) -> float:
    """The DPLASMA family's new product bodies against the GEMM kernel's
    plain version on the operands they must pass, and getrf_nopiv's
    lu_factor_ex against its masked loop, at nb = 1024, single and
    batched z = 4 (batched launches bit-exact against single ones);
    returns the GEMM's max abs error over them."""
    from parsec_tpu_torch.ops import kernels, linalg
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    nb, z = NB_MAIN, 4
    a, b, c = (torch.randn(z, nb, nb, generator=g, device=dev)
               for _ in range(3))
    q2 = torch.randn(z, 2 * nb, 2 * nb, generator=g, device=dev)
    d = torch.rand(z, nb, nb, generator=g, device=dev) - 0.5
    d += torch.diag_embed(d.abs().sum(-1) + 1)
    plain = kernels.gemm_plain
    # (body, its plain version, operands)
    cases = {
        "gemm_nn_sub": (linalg.gemm_nn_sub,
                        lambda c, a, b: plain(a, b, c, alpha=-1.0, beta=1.0),
                        (c, a, b)),
        "gemm_tn_sub": (linalg.gemm_tn_sub,
                        lambda c, a, b: plain(a.mT, b, c, alpha=-1.0,
                                              beta=1.0), (c, a, b)),
        "unmqr": (linalg.unmqr, lambda q, c: plain(q.mT, c), (a, c)),
        "tsmqr": (lambda q2, a1, a2: torch.cat(linalg.tsmqr(q2, a1, a2),
                                               dim=-2),
                  lambda q2, a1, a2: plain(q2.mT, torch.cat([a1, a2], -2)),
                  (q2, a, b)),
        "gemm_a1.5_b0.5": (lambda c, a, b: linalg.gemm(c, a, b, 1.5, 0.5),
                           lambda c, a, b: plain(a, b, c, alpha=1.5,
                                                 beta=0.5), (c, a, b)),
        "gemm_a1.5_b0.5_transb": (
            lambda c, a, b: linalg.gemm(c, a, b, 1.5, 0.5, trans_b=True),
            lambda c, a, b: plain(a, b, c, trans_b=True, alpha=1.5,
                                  beta=0.5), (c, a, b)),
        "getrf_nopiv": (linalg.getrf_nopiv, linalg.getrf_nopiv_plain, (d,)),
    }
    worst = 0.0
    for name, (body, ref_fn, args) in cases.items():
        for zz in (1, z):
            xs = [x[0] if zz == 1 else x for x in args]
            out, ref = body(*xs), ref_fn(*xs)
            torch.cuda.synchronize()
            rel, absd = rel_err(out, ref)
            if name != "getrf_nopiv":
                worst = max(worst, absd)
            log("bodies", case=name, z=zz, shape=tuple(out.shape),
                rel_err=rel, max_abs_err=absd)
            check(rel < RTOL, f"body {name} z={zz}: relative error {rel} "
                              f">= {RTOL}")
        batched = body(*args)
        for i in range(z):
            check(torch.equal(batched[i], body(*(x[i] for x in args))),
                  f"{name}: batched slice {i} differs from its single call")
        torch.cuda.synchronize()
        log("bodies", case=f"{name}_z{z}_vs_single", bit_exact=True)
    return worst


def phase_attention(dev: torch.device, seed: int) -> dict:
    """Both flash kernels vs their plain versions on the card; returns
    each kernel's max abs error at the forward's shape."""
    from parsec_tpu_torch.ops import kernels
    g = torch.Generator(device=dev).manual_seed(seed + 4)

    def qkv(B, H, T, Tk, D):
        return tuple(torch.randn(B, H, t, D, generator=g, device=dev)
                     for t in (T, Tk, Tk))

    B, H, T, D = ATTN_SHAPE
    # (case, q/k/v, causal, at the forward's shape)
    cases = [("fwd_causal", qkv(B, H, T, T, D), True, True),
             ("fwd_noncausal", qkv(B, H, T, T, D), False, False),
             ("ragged_1000_d40", qkv(2, 4, 1000, 1000, 40), True, False),
             ("t256_tk384", qkv(2, 4, 256, 384, 64), True, False),
             ("t256_tk200", qkv(2, 4, 256, 200, 64), True, False),
             ("t1000_d64", qkv(2, 4, 1000, 1000, 64), True, False),
             ("t1000_tk1500", qkv(2, 4, 1000, 1500, 64), True, False),
             ("t1000_tk300", qkv(2, 4, 1000, 300, 64), True, False),
             ("t300_tk1000_noncausal", qkv(2, 4, 300, 1000, 64), False,
              False),
             ("d33", qkv(2, 4, 300, 300, 33), True, False),
             ("d128", qkv(2, 4, 1000, 1000, 128), True, False),
             ("d128_t200_tk333_noncausal", qkv(2, 4, 200, 333, 128), False,
              False),
             ("misaligned_d64", tuple(map(misaligned,
                                          qkv(2, 4, 1000, 1000, 64))),
              True, False)]
    worst = {"flash": 0.0, "flash_stats": 0.0}
    for name, (q, k, v), causal, on_path in cases:
        o = kernels.flash_attention(q, k, v, causal=causal)
        stats = kernels.flash_attention_stats(q, k, v, causal=causal)
        ref = kernels.flash_attention_plain(q, k, v, causal=causal)
        ref_stats = kernels.flash_attention_stats_plain(q, k, v,
                                                        causal=causal)
        torch.cuda.synchronize()
        results = [("flash", "o", o, ref)] + [
            ("flash_stats", part, a, b)
            for part, a, b in zip("oml", stats, ref_stats)]
        for kernel, part, a, b in results:
            rel, absd = rel_err(a, b)
            if on_path:
                worst[kernel] = max(worst[kernel], absd)
            log("attention", kernel=kernel, case=name, out=part,
                shape=tuple(a.shape), causal=causal, rel_err=rel,
                max_abs_err=absd)
            check(rel < RTOL, f"{kernel} {name} {part}: relative error "
                              f"{rel} >= {RTOL}")
    # the 4-byte-copy variant does the same arithmetic as the 16-byte one
    unaligned = cases[-1][1]
    aligned = tuple(x.clone() for x in unaligned)
    check(torch.equal(kernels.flash_attention(*unaligned),
                      kernels.flash_attention(*aligned)),
          "flash_attention: misaligned and aligned copies differ")
    check(all(map(torch.equal,
                  kernels.flash_attention_stats(*unaligned, causal=True),
                  kernels.flash_attention_stats(*aligned, causal=True))),
          "flash_attention_stats: misaligned and aligned copies differ")
    log("attention", case="misaligned_vs_aligned", bit_exact=True)
    # the merge rule over two key sets == attention over their union
    q, k1, v1 = qkv(2, 4, 256, 384, 64)
    _q, k2, v2 = qkv(2, 4, 256, 200, 64)
    o1, m1, l1 = kernels.flash_attention_stats(q, k1, v1)
    o2, m2, l2 = kernels.flash_attention_stats(q, k2, v2)
    m = torch.maximum(m1, m2)
    w1, w2 = torch.exp(m1 - m) * l1, torch.exp(m2 - m) * l2
    merged = (o1 * w1[..., None] + o2 * w2[..., None]) / (w1 + w2)[..., None]
    ref = kernels.flash_attention_plain(q, torch.cat([k1, k2], 2),
                                        torch.cat([v1, v2], 2), causal=False)
    torch.cuda.synchronize()
    rel, absd = rel_err(merged, ref)
    log("attention", kernel="flash_stats", case="merge_384+200",
        rel_err=rel, max_abs_err=absd)
    check(rel < RTOL, f"stats merge: relative error {rel} >= {RTOL}")
    worst["flash_bwd"] = attention_backward(dev, cases, g)
    return worst


#: the backward's oversubscribed case: 256 (b, h) slices of 2048 rows,
#: thousands of work items for a grid of one block an SM
BWD_BIG_SHAPE = (16, 16, 2048, 64)
#: seconds a backward launch may take before its dQ turns count as stuck
BWD_DEADLINE_S = 20.0


def finish_within(what: str, seconds: float) -> None:
    """Wait for the work queued so far on the current stream, failing
    after ``seconds``: a kernel that waits forever (a dQ turn nobody
    takes) cannot be stopped, so the process exits at once."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > seconds:
            print(f"{what}: not finished after {seconds} s", flush=True)
            os._exit(1)
        time.sleep(0.001)


def attention_backward(dev: torch.device, cases, g) -> float:
    """The backward kernel against its plain version on the same q, k, v,
    the stats kernel's o, m, l and a seeded cotangent, at every case of
    the forward's and at BWD_BIG_SHAPE; three launches bit-equal at every
    case; misaligned operands bit-exact against aligned copies.  Returns
    the max abs error at the forward's shape."""
    from parsec_tpu_torch.ops import kernels
    B, H, T, D = BWD_BIG_SHAPE
    big = tuple(torch.randn(B, H, T, D, generator=g, device=dev)
                for _ in range(3))
    worst = 0.0
    args = {}
    for name, (q, k, v), causal, on_path in cases + [
            ("big_16x16x2048_d64", big, True, False)]:
        do = torch.randn(q.shape, generator=g, device=dev)
        o, m, l = kernels.flash_attention_stats(q, k, v, causal=causal)
        args[name] = (q, k, v, o, m, l, do, causal)
        t0 = time.perf_counter()
        got = kernels.flash_attention_bwd(*args[name])
        finish_within(f"flash_bwd {name}", BWD_DEADLINE_S)
        seconds = time.perf_counter() - t0
        # no float atomics: the same inputs give the same bits
        for _ in range(2):
            again = kernels.flash_attention_bwd(*args[name])
            finish_within(f"flash_bwd {name}", BWD_DEADLINE_S)
            check(all(map(torch.equal, got, again)),
                  f"flash_bwd {name}: launches on the same inputs differ")
        del again
        ref = kernels.flash_attention_bwd_plain(*args[name])
        torch.cuda.synchronize()
        for part, a, b in zip(("dq", "dk", "dv"), got, ref):
            rel, absd = rel_err(a, b)
            if on_path:
                worst = max(worst, absd)
            log("attention", kernel="flash_bwd", case=name, out=part,
                shape=tuple(a.shape), causal=causal, rel_err=rel,
                max_abs_err=absd)
            check(rel < RTOL, f"flash_bwd {name} {part}: relative error "
                              f"{rel} >= {RTOL}")
        log("attention", kernel="flash_bwd", case=name, repeat_launches=3,
            bit_exact=True, first_launch_s=f"{seconds:.4f}")
        del got, ref
    del args["big_16x16x2048_d64"], big
    # the 4-byte-copy instance does the arithmetic of the 16-byte one
    *unaligned, causal = args["misaligned_d64"]
    unaligned = [misaligned(x) for x in unaligned]
    aligned = [x.clone() for x in unaligned]
    check(all(map(torch.equal,
                  kernels.flash_attention_bwd(*unaligned, causal),
                  kernels.flash_attention_bwd(*aligned, causal))),
          "flash_attention_bwd: misaligned and aligned copies differ")
    log("attention", kernel="flash_bwd", case="misaligned_vs_aligned",
        bit_exact=True)
    return worst


def synth_spd(n: int, seed: int) -> np.ndarray:
    """A = (B + B^T)/2 + n I with B uniform in [-0.5, 0.5), in O(n^2)."""
    rng = np.random.default_rng(seed)
    b = rng.random((n, n), dtype=np.float32) - np.float32(0.5)
    a = (b + b.T) * np.float32(0.5)
    a[np.diag_indices(n)] += np.float32(n)
    return a


def synth_dominant(n: int, seed: int) -> np.ndarray:
    """B uniform in [-0.5, 0.5) with each diagonal entry raised to its
    row's absolute sum + 1: LU-stable without pivoting, in O(n^2)."""
    a = uniform(n, n, seed=seed)
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + np.float32(1)
    return a


def uniform(*shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32) - np.float32(0.5)


def matvec(M: np.ndarray, X: np.ndarray, trans: bool = False,
           part: str = None, rows: int = 2048) -> np.ndarray:
    """op(part(M)) @ X in fp64, reading M in blocks of rows: ``part``
    "upper" keeps M's upper triangle, "unit_lower" its strictly lower one
    plus a unit diagonal (packed LU factors); ``trans`` takes M^T."""
    m, n = M.shape
    out = np.zeros((n if trans else m, X.shape[1]))
    for r0 in range(0, m, rows):
        blk = M[r0:r0 + rows].astype(np.float64)
        if part == "upper":
            blk = np.triu(blk, r0)
        elif part == "unit_lower":
            blk = np.tril(blk, r0 - 1)
            i = np.arange(blk.shape[0])
            i = i[r0 + i < n]
            blk[i, r0 + i] = 1.0
        if trans:
            out += blk.T @ X[r0:r0 + rows]
        else:
            out[r0:r0 + rows] = blk @ X
    return out


def norm_inf(M: np.ndarray, rows: int = 2048) -> float:
    return max(float(np.abs(M[r0:r0 + rows].astype(np.float64)).sum(1).max())
               for r0 in range(0, M.shape[0], rows))


def rel_inf(diff: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(diff).max() / np.abs(ref).max())


def vectors(n: int, seed: int) -> np.ndarray:
    """4 random fp64 vectors: residuals are matrix-vector products."""
    return np.random.default_rng(seed + 1).random((n, 4))


def residual(L: np.ndarray, M: np.ndarray, seed: int) -> float:
    """||L (L^T X) - A X||_inf / ||A X||_inf over 4 random vectors."""
    X = vectors(M.shape[0], seed)
    ref = matvec(M, X)
    return rel_inf(matvec(L, matvec(L, X, trans=True)) - ref, ref)


def lu_residual(LU: np.ndarray, M: np.ndarray, seed: int,
                perm: np.ndarray = None):
    """||L (U X) - (A X)[perm]||_inf over 4 random vectors X, L and U
    packed in LU, relative to ||(A X)[perm]||_inf and normwise, relative
    to ||A||_inf ||X||_inf (DPLASMA's form); returns both."""
    X = vectors(M.shape[0], seed)
    ref = matvec(M, X)
    if perm is not None:
        ref = ref[perm]
    diff = matvec(LU, matvec(LU, X, part="upper"), part="unit_lower") - ref
    return (rel_inf(diff, ref),
            float(np.abs(diff).max() / (norm_inf(M) * np.abs(X).max())))


def solve_residual(M: np.ndarray, X: np.ndarray, B: np.ndarray,
                   seed: int) -> float:
    """||A X - B||_inf / (||A||_inf ||X||_inf), applied to 4 random
    vectors v of the right-hand sides' width: X v and B v."""
    v = vectors(X.shape[1], seed)
    y = X.astype(np.float64) @ v
    return float(np.abs(matvec(M, y) - B.astype(np.float64) @ v).max()
                 / (norm_inf(M) * np.abs(y).max()))


def drive(submit, colls, device=None, around=contextlib.nullcontext):
    """The port's entry points on a fresh context: ``init()``, then
    ``submit(ctx)`` timed from submission to ``torch.cuda.synchronize()``
    (``around()`` entered around it alone); then every tile of ``colls``
    staged out through the device module.  Returns (the device module's
    stats at the end of the run, seconds, the collections as arrays)."""
    import parsec_tpu_torch as ptt
    ctx = ptt.init(nb_cores=4, device=device)
    try:
        dev = ctx.device_by_type("cuda")
        with around():
            t0 = time.perf_counter()
            submit(ctx)
            if dev.is_cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        st = dict(dev.stats, executed_tasks=dev.executed_tasks,
                  device=dev.name)
        t1 = time.perf_counter()
        for C in colls:
            for (m, n) in C.tiles():
                C.data_of(m, n).sync_to_host(ctx.devices)
        st["pull_bytes"] = dev.stats["stage_out_bytes"] - st["stage_out_bytes"]
        st["pull_seconds"] = time.perf_counter() - t1
        return st, seconds, [C.to_numpy() for C in colls]
    finally:
        ctx.fini()


def tiled(M: np.ndarray, nb: int):
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    return TwoDimBlockCyclic(*M.shape, nb, nb,
                             dtype=np.float32).from_numpy(M)


def run_dpotrf(M: np.ndarray, nb: int, device=None,
               around=contextlib.nullcontext):
    """The dpotrf path on ``M``; returns (L, stats, seconds)."""
    import parsec_tpu_torch as ptt
    A = tiled(M, nb)
    st, seconds, (L,) = drive(lambda ctx: ptt.ops.dpotrf(ctx, A), [A],
                              device=device, around=around)
    st["nt"] = A.nt
    return np.tril(L), st, seconds


def report(phase: str, st: dict, seconds: float, flops: float, tasks: int,
           gemm_tasks: int, launches: int, resid: float, tol: float,
           **extra) -> None:
    """One phase's line, then its checks: every device task on cuda:0,
    the GEMM kernel launched, the residual under its bound."""
    log(phase, device=st["device"], tasks=st["tasks"], expected_tasks=tasks,
        executed_tasks=st["executed_tasks"], seconds=f"{seconds:.4f}",
        gflops=f"{flops / seconds / 1e9:.2f}", matmul_launches=launches,
        gemm_kernel_tasks=gemm_tasks,
        mean_z=f"{gemm_tasks / max(launches, 1):.3f}",
        batches=st["batches"], batched_tasks=st["batched_tasks"],
        stage_in_bytes=st["stage_in_bytes"],
        stage_out_bytes=st["stage_out_bytes"], pull_bytes=st["pull_bytes"],
        pull_seconds=f"{st['pull_seconds']:.4f}",
        stack_bytes=st["stack_bytes"], **extra, residual=resid)
    check(st["device"] == "cuda:0", f"{phase}: ran on {st['device']}")
    check(st["tasks"] == tasks and st["executed_tasks"] == tasks,
          f"{phase}: {st['tasks']} of {tasks} tasks ran on the device")
    check(launches > 0, f"{phase}: the path launched the GEMM kernel no time")
    check(resid < tol, f"{phase}: residual {resid} >= {tol}")


def phase_main(seed: int, n: int = N_MAIN, nb: int = NB_MAIN):
    """Drive dpotrf at full size; returns the kernel's launches and the
    factor."""
    from parsec_tpu_torch.ops import kernels
    M = synth_spd(n, seed)
    reset_counts()
    L, st, seconds = run_dpotrf(M, nb)
    launches = kernels.matmul_launches
    nt = st["nt"]
    # GEMM and SYRK tasks, each one z-slice of a GEMM launch
    gemm_tasks = nt * (nt - 1) * (nt - 2) // 6 + nt * (nt - 1) // 2
    check(np.isfinite(L).all(), "the factor holds non-finite values")
    report("main", st, seconds, n ** 3 / 3, nt * (nt + 1) * (nt + 2) // 6,
           gemm_tasks, launches, residual(L, M, seed), RESID_TOL, n=n, nb=nb)
    return launches, L


def phase_dposv(seed: int, n: int = N_MAIN, nb: int = NB_MAIN,
                nrhs: int = NRHS):
    """dpotrf, forward and backward substitution, three pools in turn over
    the same collections; returns the kernel's launches and the factor."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.ops import kernels
    M = synth_spd(n, seed)
    Bm = uniform(n, nrhs, seed=seed + 10)
    A, B = tiled(M, nb), tiled(Bm, nb)
    reset_counts()
    st, seconds, (L, X) = drive(lambda ctx: ptt.ops.dposv(ctx, A, B), [A, B])
    launches = kernels.matmul_launches
    mt, nt = A.mt, B.nt
    solve = mt * nt + mt * (mt - 1) // 2 * nt
    report("dposv", st, seconds, n ** 3 / 3 + 2.0 * n * n * nrhs,
           mt * (mt + 1) * (mt + 2) // 6 + 2 * solve,
           mt * (mt - 1) * (mt - 2) // 6 + mt * (mt - 1) // 2
           + mt * (mt - 1) * nt, launches,
           solve_residual(M, X, Bm, seed), RESID_TOL, n=n, nb=nb, nrhs=nrhs)
    return launches, np.tril(L)


def lu_counts(nt: int):
    """(tasks, trailing-update tasks) of the tile LU and QR graphs on an
    nt x nt grid: nt diagonal, 2 x nt(nt-1)/2 panel, sum k^2 updates."""
    updates = (nt - 1) * nt * (2 * nt - 1) // 6
    return nt + nt * (nt - 1) + updates, updates


def phase_getrf_nopiv(seed: int, n: int = N_MAIN, nb: int = NB_MAIN):
    """Returns the kernel's launches and the packed LU factor."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.ops import kernels
    M = synth_dominant(n, seed + 11)
    A = tiled(M, nb)
    reset_counts()
    st, seconds, (LU,) = drive(lambda ctx: ptt.ops.dgetrf_nopiv(ctx, A), [A])
    launches = kernels.matmul_launches
    tasks, gemm_tasks = lu_counts(A.nt)
    report("dgetrf_nopiv", st, seconds, 2.0 * n ** 3 / 3, tasks, gemm_tasks,
           launches, lu_residual(LU, M, seed)[0], RESID_TOL, n=n, nb=nb)
    return launches, LU


def phase_geqrf(seed: int, n: int = N_MAIN, nb: int = NB_MAIN):
    """Tile QR; its Q and Q2 scratch flows are staged in from the host
    (the scratch_bytes of the line).  Returns the kernel's launches and
    the factored matrix."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.ops import kernels
    M = uniform(n, n, seed=seed + 12)
    A = tiled(M, nb)
    reset_counts()
    st, seconds, (out,) = drive(lambda ctx: ptt.ops.dgeqrf(ctx, A), [A])
    launches = kernels.matmul_launches
    nt = A.nt
    tasks, tsmqr = lu_counts(nt)
    X = vectors(n, seed)
    ref = matvec(M, matvec(M, X), trans=True)
    got = matvec(out, matvec(out, X, part="upper"), trans=True, part="upper")
    report("dgeqrf", st, seconds, 4.0 * n ** 3 / 3, tasks,
           nt * (nt - 1) // 2 + tsmqr, launches, rel_inf(got - ref, ref),
           RESID_TOL, n=n, nb=nb,
           scratch_bytes=4 * (nt * nb * nb + nt * (nt - 1) // 2 * 4 * nb * nb),
           below_diagonal_max=float(np.abs(np.tril(out, -1)).max()))
    return launches, out


def phase_pdgemm(seed: int, n: int = N_MAIN, nb: int = NB_MAIN,
                 alpha: float = 1.5, beta: float = 0.5):
    """C <- alpha op(A) B + beta C, once with op(A) = A and once with A^T;
    returns the kernel's launches over both and op(A) = A's result."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.ops import kernels
    Am, Bm, Cm = (uniform(n, n, seed=seed + 13 + i) for i in range(3))
    X = vectors(n, seed)
    cx = beta * matvec(Cm, X)
    bx = matvec(Bm, X)
    total, results = 0, {}
    for transa in ("n", "t"):
        A, B, C = tiled(Am, nb), tiled(Bm, nb), tiled(Cm, nb)
        reset_counts()
        st, seconds, (Cout,) = drive(
            lambda ctx: ptt.ops.pdgemm(ctx, A, B, C, alpha=alpha, beta=beta,
                                       transa=transa), [C])
        launches = kernels.matmul_launches
        total += launches
        ref = alpha * matvec(Am, bx, trans=transa == "t") + cx
        report(f"pdgemm_{transa}n", st, seconds, 2.0 * n ** 3, C.nt ** 3,
               C.nt ** 3, launches, rel_inf(matvec(Cout, X) - ref, ref),
               RESID_TOL, n=n, nb=nb, alpha=alpha, beta=beta)
        results[transa] = Cout
    return total, results["n"]


def phase_dense(dev: torch.device, seed: int, L: np.ndarray,
                n: int = N_MAIN, nb: int = NB_MAIN, nrhs: int = NRHS) -> None:
    """The whole-matrix routines on ``dev``: the pivoted dgetrf, dgesv,
    and dpotri of the dposv phase's factor."""
    import parsec_tpu_torch as ptt

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    M = uniform(n, n, seed=seed + 16)
    Md = torch.from_numpy(M).to(dev)
    (LU, perm), seconds = timed(lambda: ptt.ops.dgetrf(Md, nb=nb, device=dev))
    check(LU.device == dev, f"dgetrf ran on {LU.device}")
    perm = perm.cpu().numpy()
    # gated normwise: on this zero-mean A, ||(A x)[perm]|| sums cancelling
    # terms and sits far below ||A|| ||x||, so the relative form reads
    # ordinary fp32 rounding as a large share of the bound
    rel_ax, resid = lu_residual(LU.cpu().numpy(), M, seed, perm)
    del LU
    log("dgetrf", device=str(dev), n=n, nb=nb, seconds=f"{seconds:.4f}",
        gflops=f"{2.0 * n ** 3 / 3 / seconds / 1e9:.2f}",
        rows_moved=int((perm != np.arange(n)).sum()),
        residual_rel_ax=rel_ax, residual=resid)
    check(resid < RESID_TOL, f"dgetrf: residual {resid} >= {RESID_TOL}")
    Bm = uniform(n, nrhs, seed=seed + 17)
    X, seconds = timed(lambda: ptt.ops.dgesv(
        Md, torch.from_numpy(Bm).to(dev), nb=nb, device=dev))
    resid = solve_residual(M, X.cpu().numpy(), Bm, seed)
    del X, Md
    log("dgesv", device=str(dev), n=n, nb=nb, nrhs=nrhs,
        seconds=f"{seconds:.4f}",
        gflops=f"{(2.0 * n ** 3 / 3 + 2.0 * n * n * nrhs) / seconds / 1e9:.2f}",
        residual=resid)
    check(resid < RESID_TOL, f"dgesv: residual {resid} >= {RESID_TOL}")
    Ld = torch.from_numpy(L).to(dev)
    inv, seconds = timed(lambda: ptt.ops.dpotri(Ld, device=dev))
    inv = inv.cpu().numpy()
    del Ld
    torch.cuda.empty_cache()
    X = vectors(n, seed)
    resid = rel_inf(matvec(synth_spd(n, seed), matvec(inv, X)) - X, X)
    log("dpotri", device=str(dev), n=n, seconds=f"{seconds:.4f}",
        gflops=f"{2.0 * n ** 3 / 3 / seconds / 1e9:.2f}", residual=resid,
        bound=DPOTRI_TOL)
    check(resid < DPOTRI_TOL, f"dpotri: residual {resid} >= {DPOTRI_TOL}")


def phase_bitexact(seed: int, n: int = N_BITEXACT, nb: int = NB_BITEXACT,
                   device=None) -> None:
    """Batched and per-task dispatch give identical factors, dpotrf and
    dgetrf_nopiv."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.utils.params import params
    cases = {"dpotrf": (synth_spd(n, seed + 2), ptt.ops.dpotrf),
             "dgetrf_nopiv": (synth_dominant(n, seed + 3),
                              ptt.ops.dgetrf_nopiv)}
    for name, (M, factor) in cases.items():
        out = {}
        for bmax in (1, 16):
            with params.cmdline_override("device_batch_max", str(bmax)):
                A = tiled(M, nb)
                st, _s, (F,) = drive(lambda ctx: factor(ctx, A), [A],
                                     device=device)
                out[bmax] = F, st["batches"]
        same = bool(np.array_equal(out[1][0], out[16][0]))
        log("bitexact", routine=name, n=n, nb=nb,
            batches_per_task=out[1][1], batches_batched=out[16][1],
            identical=same)
        check(out[1][1] == 0 and out[16][1] > 0,
              f"{name}: batches {out[1][1]} / {out[16][1]}")
        check(same, f"{name}: batched and per-task factors differ")


# ---------------------------------------------------------------------- #
# the static PTG engines: classic static, turbo, wave                    #
# ---------------------------------------------------------------------- #
def chol_tasks(nt: int):
    """(tasks, GEMM-kernel tasks: SYRK and GEMM) of the tile Cholesky."""
    return (nt * (nt + 1) * (nt + 2) // 6,
            nt * (nt - 1) * (nt - 2) // 6 + nt * (nt - 1) // 2)


def engine_case(routine: str, seed: int, n: int, nb: int, inputs: dict):
    """One routine's input (kept in ``inputs`` across the engine phases),
    taskpool maker, flop count, task counts and residual, as the
    interpreted phases use them: returns (make() -> (taskpool, result
    collection), flops, tasks, GEMM-kernel tasks, resid(out) -> float)."""
    import parsec_tpu_torch as ptt
    nt = n // nb
    if routine not in inputs:
        inputs[routine] = {
            "dpotrf": lambda: (synth_spd(n, seed),),
            "dgetrf_nopiv": lambda: (synth_dominant(n, seed + 11),),
            "dgeqrf": lambda: (uniform(n, n, seed=seed + 12),),
            "pdgemm": lambda: tuple(uniform(n, n, seed=seed + 13 + i)
                                    for i in range(3))}[routine]()
    mats = inputs[routine]
    M = mats[0]
    if routine == "dpotrf":
        return (lambda: (lambda A: (ptt.ops.dpotrf_taskpool(A), A))(
            tiled(M, nb)), n ** 3 / 3, *chol_tasks(nt),
            lambda out: residual(np.tril(out), M, seed))
    if routine == "dgetrf_nopiv":
        tasks, updates = lu_counts(nt)
        return (lambda: (lambda A: (ptt.ops.dgetrf_nopiv_taskpool(A), A))(
            tiled(M, nb)), 2.0 * n ** 3 / 3, tasks, updates,
            lambda out: lu_residual(out, M, seed)[0])
    if routine == "dgeqrf":
        tasks, tsmqr = lu_counts(nt)

        def resid(out):
            X = vectors(n, seed)
            ref = matvec(M, matvec(M, X), trans=True)
            got = matvec(out, matvec(out, X, part="upper"), trans=True,
                         part="upper")
            return rel_inf(got - ref, ref)
        return (lambda: (lambda A: (ptt.ops.dgeqrf_taskpool(A), A))(
            tiled(M, nb)), 4.0 * n ** 3 / 3, tasks,
            nt * (nt - 1) // 2 + tsmqr, resid)
    Am, Bm, Cm = mats

    def make():
        C = tiled(Cm, nb)
        return ptt.ops.pdgemm_taskpool(tiled(Am, nb), tiled(Bm, nb), C,
                                       alpha=1.5, beta=0.5), C

    def resid(out):
        X = vectors(n, seed)
        ref = 1.5 * matvec(Am, matvec(Bm, X)) + 0.5 * matvec(Cm, X)
        return rel_inf(matvec(out, X) - ref, ref)
    return make, 2.0 * n ** 3, nt ** 3 + 2 * nt * nt, nt ** 3, resid


def held_to_ref(routine: str, key, F: np.ndarray, refs: dict, resid):
    """(residual, bit-identical) of an engine's result against the
    interpreted one (``refs[key]``, its residual computed once and kept
    beside it): a bit-identical array has that very residual."""
    ref = refs[key]
    if not isinstance(ref, tuple):
        ref = refs[key] = (ref, resid(ref))
    if routine == "dpotrf":
        F = np.tril(F)
    same = bool(np.array_equal(F, np.tril(ref[0]) if routine == "dpotrf"
                               else ref[0]))
    return (ref[1] if same else resid(F)), same


def engine_report(phase: str, routine: str, seconds: float, flops: float,
                  tasks: int, gemm_tasks: int, launches: int, resid: float,
                  identical: bool, device: str, ran: int, **extra) -> None:
    """One engine path's line, then its checks: every task run on
    cuda:0, the GEMM kernel launched, the residual under its bound, the
    result bit-identical to the interpreted path's."""
    log(phase, routine=routine, device=device, tasks=ran,
        expected_tasks=tasks, seconds=f"{seconds:.4f}",
        gflops=f"{flops / seconds / 1e9:.2f}", matmul_launches=launches,
        gemm_kernel_tasks=gemm_tasks,
        mean_z=f"{gemm_tasks / max(launches, 1):.3f}", **extra,
        residual=resid, identical_to_interpreted=identical)
    check(device == "cuda:0", f"{phase} {routine}: ran on {device}")
    check(ran == tasks, f"{phase} {routine}: {ran} of {tasks} tasks ran")
    check(launches > 0, f"{phase} {routine}: the GEMM kernel was launched "
          f"no time")
    check(resid < RESID_TOL, f"{phase} {routine}: residual {resid} >= "
          f"{RESID_TOL}")
    check(identical, f"{phase} {routine}: the result differs from the "
          f"interpreted one")


def run_pool(make, dispatch: str = None):
    """One taskpool through init() and the context (the interpreted hash
    mode, or with ``dispatch`` ptg_dep_management=static and that
    ptg_dispatch), its result collection pulled through the device
    module; returns (taskpool, stats, seconds, result)."""
    from parsec_tpu_torch.utils.params import params
    tp, out = make()

    def submit(ctx):
        ctx.add_taskpool(tp)
        ctx.wait()

    with contextlib.ExitStack() as knobs:
        if dispatch is not None:
            knobs.enter_context(params.cmdline_override(
                "ptg_dep_management", "static"))
            knobs.enter_context(params.cmdline_override("ptg_dispatch",
                                                        dispatch))
        st, seconds, (F,) = drive(submit, [out])
    return tp, st, seconds, F


def phase_static(seed: int, refs: dict, inputs: dict, n: int = N_MAIN,
                 nb: int = NB_MAIN) -> int:
    """dpotrf with static dependency management on the classic per-task
    dispatch: the lowered DAG and the native engine release every task;
    the factor bit-identical to phase main's."""
    from parsec_tpu_torch.ops import kernels
    make, flops, tasks, gemm_tasks, resid = engine_case(
        "dpotrf", seed, n, nb, inputs)
    reset_counts()
    tp, st, seconds, F = run_pool(make, "classic")
    launches = kernels.matmul_launches
    check(tp._engine is not None and tp._turbo is None,
          "static: the classic static engine did not engage")
    res, same = held_to_ref("dpotrf", ("dpotrf", nb), F, refs, resid)
    engine_report("static", "dpotrf", seconds, flops, tasks, gemm_tasks,
                  launches, res, same, st["device"], st["executed_tasks"],
                  n=n, nb=nb, device_tasks=st["tasks"],
                  batches=st["batches"], stage_in_bytes=st["stage_in_bytes"],
                  pull_seconds=f"{st['pull_seconds']:.4f}")
    check(st["tasks"] == tasks, f"static: {st['tasks']} device tasks")
    return launches


def phase_turbo(seed: int, refs: dict, inputs: dict, n: int = N_MAIN,
                nb: int = NB_MAIN) -> dict:
    """The turbo native loop (ptg_dispatch=auto on a static pool): dpotrf
    at nb and nb / 2 (the JAX package's runtime@NB=512 bench mode),
    dgetrf_nopiv and dgeqrf at nb; each GEMM-kernel task one launch.
    ``refs`` holds the interpreted results by (routine, nb); one missing
    is run here.  Returns the GEMM kernel's launches by case."""
    from parsec_tpu_torch.ops import kernels
    out = {}
    for routine, tnb in (("dpotrf", nb), ("dpotrf", nb // 2),
                         ("dgetrf_nopiv", nb), ("dgeqrf", nb)):
        make, flops, tasks, gemm_tasks, resid = engine_case(
            routine, seed, n, tnb, inputs)
        if (routine, tnb) not in refs:    # the interpreted path's result
            _tp, st, seconds, refs[(routine, tnb)] = run_pool(make)
            log("turbo", reference=f"interpreted {routine}", nb=tnb,
                seconds=f"{seconds:.4f}", device=st["device"],
                tasks=st["tasks"])
        reset_counts()
        tp, st, seconds, F = run_pool(make, "auto")
        launches = kernels.matmul_launches
        check(tp._turbo is not None, f"turbo {routine}: the native loop "
              f"did not engage")
        check(launches == gemm_tasks, f"turbo {routine}: {launches} GEMM "
              f"launches for {gemm_tasks} GEMM-kernel tasks")
        ts = tp._turbo.stats
        key = routine if tnb == nb else f"{routine}_nb{tnb}"
        res, same = held_to_ref(routine, (routine, tnb), F, refs, resid)
        engine_report(
            "turbo", key, seconds, flops, tasks, gemm_tasks, launches, res,
            same, st["device"], st["executed_tasks"], n=n, nb=tnb,
            device_tasks=st["tasks"], kernel_calls=ts["kernel_calls"],
            loop_seconds=ts["dispatch_secs"],
            turbo_dispatch_us_per_task=f"{ts['dispatch_secs'] / tasks * 1e6:.2f}",
            stage_in_bytes=tp._turbo.stage_in_bytes,
            pull_seconds=f"{st['pull_seconds']:.4f}")
        out[key] = launches
    return out


def phase_wave(seed: int, refs: dict, inputs: dict, n: int = N_MAIN,
               nb: int = NB_MAIN) -> dict:
    """wave(tp) on cuda:0 and the three steps of its run(), timed from
    the wave() call with a synchronize after each step (construction
    with the slot tables, build_pools' stage-in, execute's waves and
    their device work, scatter_pools' write-back): dpotrf at nb and
    nb / 2 (the JAX package's wave@NB=1024/512 bench modes),
    dgetrf_nopiv, pdgemm with op(A) = A and dgeqrf; each result
    bit-identical to the interpreted path's (``refs``); dpotrf at nb
    needs fewer body calls than a third of its tasks.  Returns the GEMM
    kernel's launches by case."""
    from parsec_tpu_torch.dsl import ptg
    from parsec_tpu_torch.ops import kernels
    out = {}
    for routine, tnb in (("dpotrf", nb), ("dpotrf", nb // 2),
                         ("dgetrf_nopiv", nb), ("pdgemm", nb),
                         ("dgeqrf", nb)):
        make, flops, tasks, gemm_tasks, resid = engine_case(
            routine, seed, n, tnb, inputs)
        tp, A = make()
        reset_counts()
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        w = ptg.wave(tp)
        marks.append(time.perf_counter())
        pools = w.build_pools()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        pools = w.execute(pools)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        w.scatter_pools(pools)
        del pools
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        seconds = marks[-1] - marks[0]
        steps = dict(zip(("construct_seconds", "stage_in_seconds",
                          "execute_seconds", "write_back_seconds"),
                         (f"{b - a:.4f}" for a, b in zip(marks, marks[1:]))))
        launches = kernels.matmul_launches
        ws = w.stats
        key = routine if tnb == nb else f"{routine}_nb{tnb}"
        res, same = held_to_ref(routine, (routine, tnb), A.to_numpy(),
                                refs, resid)
        engine_report("wave", key, seconds, flops, tasks, gemm_tasks,
                      launches, res, same, str(w.device), ws["tasks"],
                      n=n, nb=tnb, waves=ws["waves"],
                      kernel_calls=ws["kernel_calls"],
                      dispatch_seconds=ws["dispatch_secs"],
                      compiled_kernels=ws["compiled_kernels"],
                      stage_in_bytes=w.stage_in_bytes, **steps)
        if key == "dpotrf":
            check(ws["kernel_calls"] < tasks / 3,
                  f"wave dpotrf: {ws['kernel_calls']} calls for {tasks} "
                  f"tasks")
        out[key] = launches
        del w, tp, A
    return out

# ---------------------------------------------------------------------- #
# the DTD front end and whole-graph capture                              #
# ---------------------------------------------------------------------- #
def dtd_boot(tp, classes, nb: int):
    """Register each DTD task class with its CUDA chore: a class exists
    from its first insert, so each takes one boot task on a small tile
    first.  ``classes`` is [(name, chore, access modes)]; returns the host
    bodies by name.  A host body runs only for a boot task (insertion
    index below the count of boot tasks): for any other task it raises."""
    n_boot = len(classes)

    def host_body(name):
        def body(es, task):
            if task.locals[0] >= n_boot:
                raise RuntimeError(f"{task.snprintf()} ran its host body")
        body.__name__ = name
        return body

    bodies = {}
    boot = tp.tile_of_array(np.eye(nb, dtype=np.float32))
    for name, chore, modes in classes:
        bodies[name] = host_body(name)
        tp.insert_task(bodies[name], *[(boot, m) for m in modes])
        tp.add_chore(bodies[name], "cuda", chore)
    return bodies


def dtd_cholesky(ctx, A) -> int:
    """The tile Cholesky of A through DTD: tile_of(A, (m, n)), POTRF,
    TRSM, SYRK and GEMM inserted in the k loop's order with the tile
    bodies as CUDA chores, then data_flush_all and wait; returns the
    tasks inserted after the boot tasks."""
    from parsec_tpu_torch import dtd, ops
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT
    tp = dtd.taskpool_new("dtd_potrf")
    ctx.add_taskpool(tp)
    b = dtd_boot(tp, [("POTRF", ops.potrf, (INOUT,)),
                      ("TRSM", ops.trsm_panel, (INPUT, INOUT)),
                      ("SYRK", ops.syrk_ln, (INOUT, INPUT)),
                      ("GEMM", ops.gemm_nt, (INOUT, INPUT, INPUT))], A.nb)
    nt, tasks = A.nt, 0
    T = lambda m, n: tp.tile_of(A, (m, n))   # noqa: E731
    for k in range(nt):
        tp.insert_task(b["POTRF"], (T(k, k), INOUT))
        for m in range(k + 1, nt):
            tp.insert_task(b["TRSM"], (T(k, k), INPUT), (T(m, k), INOUT))
        for m in range(k + 1, nt):
            tp.insert_task(b["SYRK"], (T(m, m), INOUT), (T(m, k), INPUT))
            for n in range(k + 1, m):
                tp.insert_task(b["GEMM"], (T(m, n), INOUT), (T(m, k), INPUT),
                               (T(n, k), INPUT))
            tasks += 1 + (m - k - 1)
        tasks += 1 + (nt - k - 1)
    tp.data_flush_all()
    tp.wait()
    return tasks


def dtd_report(phase: str, st: dict, seconds: float, flops: float,
               expected: int, inserted: int, boot: int, gemm_tasks: int,
               launches: int, resid: float, **extra) -> None:
    """A DTD phase's line and checks: the inserted tasks all on cuda:0
    (a host body raises for any but a boot task), the GEMM kernel
    launched, the residual under its bound."""
    boot_on_device = st["tasks"] - inserted
    log(phase, device=st["device"], tasks=inserted, expected_tasks=expected,
        boot_tasks=boot, device_tasks=st["tasks"],
        boot_on_device=boot_on_device, seconds=f"{seconds:.4f}",
        gflops=f"{flops / seconds / 1e9:.2f}", matmul_launches=launches,
        gemm_kernel_tasks=gemm_tasks,
        mean_z=f"{gemm_tasks / max(launches, 1):.3f}",
        batches=st["batches"], batched_tasks=st["batched_tasks"],
        stage_in_bytes=st["stage_in_bytes"],
        stage_out_bytes=st["stage_out_bytes"], **extra, residual=resid)
    check(st["device"] == "cuda:0", f"{phase}: ran on {st['device']}")
    check(inserted == expected, f"{phase}: {inserted} tasks inserted, "
                                f"expected {expected}")
    check(0 <= boot_on_device <= boot,
          f"{phase}: {st['tasks']} device tasks for {inserted} inserted "
          f"and {boot} boot tasks")
    check(launches > 0, f"{phase}: the path launched the GEMM kernel no time")
    check(resid < RESID_TOL, f"{phase}: residual {resid} >= {RESID_TOL}")


def phase_dtd(seed: int, L_ptg: np.ndarray, n: int = N_MAIN,
              nb: int = NB_MAIN):
    """The DTD tile Cholesky on phase main's input; its factor must be
    bit-identical to the PTG one.  Returns the launches and the factor."""
    from parsec_tpu_torch.ops import kernels
    M = synth_spd(n, seed)
    A = tiled(M, nb)
    box = {}
    reset_counts()
    st, seconds, (L,) = drive(
        lambda ctx: box.setdefault("tasks", dtd_cholesky(ctx, A)), [A])
    launches = kernels.matmul_launches
    nt = A.nt
    L = np.tril(L)
    same = bool(np.array_equal(L, L_ptg))
    dtd_report("dtd", st, seconds, n ** 3 / 3, nt * (nt + 1) * (nt + 2) // 6,
               box["tasks"], 4, nt * (nt - 1) * (nt - 2) // 6
               + nt * (nt - 1) // 2, launches, residual(L, M, seed), n=n,
               nb=nb, identical_to_ptg=same)
    check(same, "dtd: the DTD factor differs from the PTG one")
    return launches, L


def phase_dtd_gemm(seed: int, n: int = N_MAIN, nb: int = NB_MAIN) -> int:
    """dtd_test_simple_gemm's shape: C += A B over NT^3 tasks, chore
    ops.gemm_nn, chained on C(m, n) in k order."""
    from parsec_tpu_torch import dtd, ops
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT
    from parsec_tpu_torch.ops import kernels
    Am, Bm, Cm = (uniform(n, n, seed=seed + 30 + i) for i in range(3))
    A, B, C = tiled(Am, nb), tiled(Bm, nb), tiled(Cm, nb)
    box = {}

    def submit(ctx):
        tp = dtd.taskpool_new("dtd_gemm")
        ctx.add_taskpool(tp)
        b = dtd_boot(tp, [("GEMM", ops.gemm_nn, (INOUT, INPUT, INPUT))], nb)
        nt = C.nt
        for k in range(nt):
            for m in range(nt):
                for j in range(nt):
                    tp.insert_task(b["GEMM"], (tp.tile_of(C, (m, j)), INOUT),
                                   (tp.tile_of(A, (m, k)), INPUT),
                                   (tp.tile_of(B, (k, j)), INPUT))
        box["tasks"] = nt ** 3
        tp.data_flush_all()
        tp.wait()

    reset_counts()
    st, seconds, (Cout,) = drive(submit, [C])
    launches = kernels.matmul_launches
    X = vectors(n, seed)
    ref = matvec(Am, matvec(Bm, X)) + matvec(Cm, X)
    nt = C.nt
    dtd_report("dtd_gemm", st, seconds, 2.0 * n ** 3, nt ** 3, box["tasks"],
               1, nt ** 3, launches, rel_inf(matvec(Cout, X) - ref, ref),
               n=n, nb=nb)
    return launches


def graph_report(phase: str, routine: str, cg, runs, resid: float,
                 tasks: int, peak: int, **extra) -> tuple:
    """A captured graph's line and checks; returns (the GEMM kernel's
    launches that ran through its wrapper, the warm-up's; {recorded,
    replays}: the launches recorded in the graph and the replays that
    re-ran them, which no counter sees)."""
    from parsec_tpu_torch.ops import kernels
    g = cg.graph
    log(phase, routine=routine, tasks=tasks,
        capture_seconds=f"{g.capture_seconds:.4f}",
        warmup_gemm_launches=g.warmup_gemm_launches,
        captured_gemm_launches=g.captured_gemm_launches, replays=g.replays,
        run_seconds=",".join(f"{s:.4f}" for s, _ in runs),
        replay_seconds=",".join(f"{ms / 1e3:.4f}" for _, ms in runs),
        peak_mem_gb=f"{peak / 1e9:.3f}", **extra, residual=resid)
    check(cg.nb_tasks == tasks, f"{phase} {routine}: {cg.nb_tasks} tasks "
                                f"captured, expected {tasks}")
    check(g.captured_gemm_launches > 0,
          f"{phase} {routine}: the graph holds no GEMM kernel launch")
    check(g.replays == len(runs), f"{phase} {routine}: {g.replays} replays "
                                  f"for {len(runs)} runs")
    check(g.warmup_gemm_launches > 0,
          f"{phase} {routine}: the warm-up launched the GEMM kernel no time")
    check(kernels.matmul_launches
          == g.warmup_gemm_launches + g.captured_gemm_launches,
          f"{phase} {routine}: the counter read {kernels.matmul_launches}, "
          f"not the warm-up's and the record's launches")
    check(resid < RESID_TOL, f"{phase} {routine}: residual {resid} >= "
                             f"{RESID_TOL}")
    return g.warmup_gemm_launches, dict(recorded=g.captured_gemm_launches,
                                        replays=g.replays)


def run_graph(cg, device=None):
    """One run() of a captured graph: (wall seconds to synchronize,
    device seconds of its replay in ms)."""
    t0 = time.perf_counter()
    if device is None:
        cg.run()
    else:
        cg.run(device=device)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, cg.graph.replay_ms


def free_graph(cg) -> None:
    import gc
    cg.graph.reset()
    del cg
    gc.collect()
    torch.cuda.empty_cache()


def phase_capture(seed: int, L_ptg: np.ndarray, n: int = N_MAIN,
                  nb: int = NB_MAIN) -> tuple:
    """dpotrf, dposv (capture_sequence of its three pools), pdgemm
    (op(A) = A), dgetrf_nopiv and dgeqrf each recorded as ONE CUDA graph
    and replayed; dpotrf run twice, on phase main's input (bit-identical
    factor) and on another seeded matrix.  Returns, by routine, the GEMM
    kernel's launches that ran through its wrapper (the warm-up's), and
    each graph's recorded launches and replays (graph_report)."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl import ptg
    from parsec_tpu_torch.ops.dtrsm import (dtrsm_lower_taskpool,
                                            dtrsm_lower_trans_taskpool)
    launches, graphs = {}, {}
    nt = n // nb
    # dpotrf: run() on cuda:0, results stored back as host copies
    M = synth_spd(n, seed)
    A = tiled(M, nb)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cg = ptg.capture(ptt.ops.dpotrf_taskpool(A))
    cg.record()
    runs = [run_graph(cg)]
    L0 = np.tril(A.to_numpy())
    same = bool(np.array_equal(L0, L_ptg))
    M2 = synth_spd(n, seed + 20)
    A.from_numpy(M2)
    runs.append(run_graph(cg))
    L2 = np.tril(A.to_numpy())
    launches["dpotrf"], graphs["dpotrf"] = graph_report(
        "capture", "dpotrf", cg, runs,
                 max(residual(L0, M, seed), residual(L2, M2, seed)),
                 nt * (nt + 1) * (nt + 2) // 6,
                 torch.cuda.max_memory_allocated(), identical_to_ptg=same)
    check(same, "capture dpotrf: the captured factor differs from the "
                "interpreted one")
    free_graph(cg)
    del A, M2, L0, L2
    # dposv: one graph over the three pools
    Bm = uniform(n, NRHS, seed=seed + 10)
    A, B = tiled(M, nb), tiled(Bm, nb)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    cg = ptg.capture_sequence([ptt.ops.dpotrf_taskpool(A),
                               dtrsm_lower_taskpool(A, B),
                               dtrsm_lower_trans_taskpool(A, B)])
    cg.record()
    runs = [run_graph(cg)]
    mt, rt = A.mt, B.nt
    # each substitution: its TRSM and GEMM tasks, and a host task reading
    # each tile of the factor
    solve = mt * rt + mt * (mt - 1) // 2 * rt + mt * (mt + 1) // 2
    launches["dposv"], graphs["dposv"] = graph_report(
        "capture", "dposv", cg, runs,
                 solve_residual(M, B.to_numpy(), Bm, seed),
                 mt * (mt + 1) * (mt + 2) // 6 + 2 * solve,
                 torch.cuda.max_memory_allocated())
    free_graph(cg)
    del A, B, Bm, M
    # pdgemm: run(device=<the context's device module>), results kept as
    # device copies and read back through the module
    Am, Bm, Cm = (uniform(n, n, seed=seed + 13 + i) for i in range(3))
    A, B, C = tiled(Am, nb), tiled(Bm, nb), tiled(Cm, nb)
    ctx = ptt.init(nb_cores=4)
    try:
        dev = ctx.device_by_type("cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        cg = ptg.capture(ptt.ops.pdgemm_taskpool(A, B, C, alpha=1.5,
                                                 beta=0.5))
        cg.record(device=dev)
        runs = [run_graph(cg, device=dev)]
        X = vectors(n, seed)
        ref = 1.5 * matvec(Am, matvec(Bm, X)) + 0.5 * matvec(Cm, X)
        on_device = sum(C.data_of(m, j).newest_copy().device_id
                        == dev.device_index for (m, j) in C.tiles())
        Cout = C.to_numpy()
        # the GEMM tasks, and a host task reading each tile of A and B
        launches["pdgemm"], graphs["pdgemm"] = graph_report(
            "capture", "pdgemm_nn", cg, runs,
                     rel_inf(matvec(Cout, X) - ref, ref), nt ** 3 + 2 * nt * nt,
                     torch.cuda.max_memory_allocated(),
                     tiles_left_on_device=on_device)
        check(on_device == nt * nt, f"capture pdgemm: {on_device} of "
                                    f"{nt * nt} C tiles left on the card")
        free_graph(cg)
    finally:
        ctx.fini()
    # the LU and QR graphs: lu_factor_ex(pivot=False) and linalg.qr
    # record too
    lu = {"dgetrf_nopiv": (synth_dominant(n, seed + 11),
                           ptt.ops.dgetrf_nopiv_taskpool),
          "dgeqrf": (uniform(n, n, seed=seed + 12), ptt.ops.dgeqrf_taskpool)}
    for routine, (M, taskpool) in lu.items():
        A = tiled(M, nb)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        cg = ptg.capture(taskpool(A))
        cg.record()
        runs = [run_graph(cg)]
        out = A.to_numpy()
        if routine == "dgetrf_nopiv":
            resid = lu_residual(out, M, seed)[0]
        else:
            X = vectors(n, seed)
            ref = matvec(M, matvec(M, X), trans=True)
            got = matvec(out, matvec(out, X, part="upper"), trans=True,
                         part="upper")
            resid = rel_inf(got - ref, ref)
        launches[routine], graphs[routine] = graph_report(
            "capture", routine, cg, runs, resid, lu_counts(nt)[0],
            torch.cuda.max_memory_allocated())
        free_graph(cg)
        del A, out
    return launches, graphs


def phase_dtd_capture(seed: int, L_dtd: np.ndarray, n: int = N_MAIN,
                      nb: int = NB_MAIN) -> tuple:
    """The dtd phase's Cholesky recorded through dtd_capture() and
    replayed once; bit-identical to phase dtd's factor.  Returns what
    graph_report does."""
    from parsec_tpu_torch import ops
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT
    from parsec_tpu_torch.dsl.dtd.capture import dtd_capture
    M = synth_spd(n, seed)
    nt = n // nb
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    g = dtd_capture()
    T = {(m, k): g.tile_of_array(M[m * nb:(m + 1) * nb, k * nb:(k + 1) * nb],
                                 key=(m, k))
         for m in range(nt) for k in range(m + 1)}
    for k in range(nt):
        g.insert_task(ops.potrf, (T[k, k], INOUT))
        for m in range(k + 1, nt):
            g.insert_task(ops.trsm_panel, (T[k, k], INPUT), (T[m, k], INOUT))
        for m in range(k + 1, nt):
            g.insert_task(ops.syrk_ln, (T[m, m], INOUT), (T[m, k], INPUT))
            for j in range(k + 1, m):
                g.insert_task(ops.gemm_nt, (T[m, j], INOUT),
                              (T[m, k], INPUT), (T[j, k], INPUT))
    g.record()
    runs = [run_graph(g)]
    L = np.zeros((n, n), np.float32)
    for (m, k), t in T.items():
        L[m * nb:(m + 1) * nb, k * nb:(k + 1) * nb] = g.value(t).cpu().numpy()
    same = bool(np.array_equal(L, L_dtd))
    counts = graph_report("dtd_capture", "dtd_potrf", g, runs,
                          residual(L, M, seed), nt * (nt + 1) * (nt + 2) // 6,
                          torch.cuda.max_memory_allocated(),
                          identical_to_dtd=same)
    check(same, "dtd_capture: the captured factor differs from phase dtd's")
    free_graph(g)
    return counts


def gpt2_small(attention: str):
    """GPT-2 small's widths (OpenAI's gpt2 config: n_embd 768, n_head 12,
    n_layer 12, n_positions 1024, vocab_size 50257, FFN 4 x 768) as the
    JAX model's config, fp32, batch 8."""
    from parsec_tpu_torch.models import TransformerConfig
    return TransformerConfig(vocab=50257, d_model=768, n_heads=12,
                             d_head=64, n_stages=1, layers_per_stage=12,
                             d_ff=3072, n_experts=0, seq_len=1024, batch=8,
                             n_micro=1, attention=attention,
                             dtype=torch.float32)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {name: tree_map(fn, a) for name, a in tree.items()}
    return fn(tree)


def check_against_cpu(cfg, params, host_params, seq0, card_logits) -> None:
    """Sequence 0 of the first batch against the port on the CPU (plain
    versions).  The seeded model amplifies rounding from layer to layer
    (its scores are large: wqkv is drawn at 1/sqrt(H)), so whole-depth
    fp32 logits that sum in another order drift far apart; they are
    reported beside the CPU's own fp32-vs-fp64 drift.  The gate holds
    each layer and the head to the CPU on the same input."""
    from parsec_tpu_torch import models
    t0 = time.perf_counter()
    cpu32 = models.make_forward(cfg, device="cpu")(host_params, seq0)
    cpu_seconds = time.perf_counter() - t0
    cpu64 = models.make_forward(
        dataclasses.replace(cfg, dtype=torch.float64), device="cpu")(
            tree_map(torch.Tensor.double, host_params), seq0)
    log("forward", case="cpu_fp32_vs_cpu_fp64", layers=cfg.n_layers,
        rel_err=rel_err(cpu32, cpu64)[0], cpu_seconds=f"{cpu_seconds:.3f}")
    for attention, logits in card_logits.items():
        log("forward", case=f"{attention}_vs_cpu_whole_depth",
            rel_err=rel_err(logits[:1].cpu(), cpu32)[0],
            rel_err_vs_fp64=rel_err(logits[:1].cpu(), cpu64)[0])
    # each layer and the head on the card vs the CPU, on the card's input
    card = models.Transformer(cfg)
    worst = 0.0
    with torch.inference_mode():
        tokens = torch.as_tensor(seq0, dtype=torch.int64)
        x = card._embed(params, tokens.to(params["embed"].device))
        ref = card._embed(host_params, tokens)
        check(torch.equal(x.cpu(), ref), "embeddings differ from the CPU's")
        def layer(tree, i):
            return tree_map(lambda a: a.reshape(-1, *a.shape[2:])[i], tree)

        for i in range(cfg.n_layers):
            y = card._layer(layer(params["stages"], i), x, 0.0)[0]
            rel, absd = rel_err(y.cpu(), card._layer(
                layer(host_params["stages"], i), x.cpu(), 0.0)[0])
            log("forward", case="layer_vs_cpu", layer=i, rel_err=rel,
                max_abs_err=absd)
            worst = max(worst, rel)
            x = y
        rel, absd = rel_err(card._head(params, x).cpu(),
                            card._head(host_params, x.cpu()))
    log("forward", case="head_vs_cpu", rel_err=rel, max_abs_err=absd)
    worst = max(worst, rel)
    check(worst < LOGITS_RTOL, f"card vs CPU on the same input: relative "
                               f"error {worst} >= {LOGITS_RTOL}")


def phase_forward(dev: torch.device, seed: int) -> dict:
    """The transformer path through make_forward with attention="ring"
    and "flash"; returns each flash kernel's launches on its path."""
    from parsec_tpu_torch import models
    cfg = gpt2_small("ring")
    t0 = time.perf_counter()
    host_params = models.init_params(cfg, seed)
    params = models.params_to(host_params, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in (params["embed"], params["pos"],
                                       params["ln_f"],
                                       *params["stages"].values()))
    log("forward", params=n_params,
        init_seconds=f"{time.perf_counter() - t0:.3f}")
    rng = np.random.RandomState(seed + 5)
    batches = [rng.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len))
               for _ in range(1 + N_BATCHES)]
    per_layer = {"ring": "flash_stats_launches", "flash": "flash_launches"}
    first = {}
    launches = {}
    for attention, counter in per_layer.items():
        fwd = models.make_forward(dataclasses.replace(cfg,
                                                      attention=attention))
        reset_counts()
        fwd(params, batches[0])                   # warm-up
        torch.cuda.synchronize()
        seconds = []
        for i, tokens in enumerate(batches[1:]):
            t0 = time.perf_counter()
            logits = fwd(params, tokens)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            check(tuple(logits.shape) == (cfg.batch, cfg.seq_len, cfg.vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"{attention}: logits of shape {tuple(logits.shape)} "
                  f"or not finite")
            if i == 0:
                first[attention] = logits
        got = counts()
        n_fwd = 1 + N_BATCHES
        want = {name: cfg.n_layers * n_fwd if name == counter else 0
                for name in COUNTERS}
        launches[attention] = got[counter]
        mean = sum(seconds) / len(seconds)
        log("forward", attention=attention, forwards=n_fwd,
            seconds=",".join(f"{x:.6f}" for x in seconds),
            mean_seconds=f"{mean:.6f}",
            tokens_per_s=f"{cfg.batch * cfg.seq_len / mean:.1f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            **got)
        check(got == want, f"{attention}: launches {got}, expected {want}")
    rel, absd = rel_err(first["ring"], first["flash"])
    log("forward", case="ring_vs_flash", rel_err=rel, max_abs_err=absd)
    check(rel < LOGITS_RTOL, f"ring vs flash logits: {rel} >= "
                             f"{LOGITS_RTOL}")
    check_against_cpu(cfg, params, host_params, batches[1][:1], first)
    return launches


#: each train path's config changes and its kernels' launches per step:
#: the training forward of flash_attention runs the stats instance (remat
#: runs it again in the backward), the ring's backward recomputes through
#: the plain ring
TRAIN_PATHS = {
    "flash": (dict(attention="flash"),
              {"flash_stats_launches": 12, "flash_bwd_launches": 12}),
    "flash_remat": (dict(attention="flash", remat=True),
                    {"flash_stats_launches": 24, "flash_bwd_launches": 12}),
    "ring": (dict(attention="ring"), {"flash_stats_launches": 12})}


def phase_train(dev: torch.device, seed: int) -> dict:
    """Adam steps at GPT-2-small widths through models.make_train_step
    for each train path; then determinism, remat against no remat, each
    layer's gradients against the CPU port, and the whole-depth loss.
    Returns each path's launches by counter."""
    from parsec_tpu_torch import models
    from parsec_tpu_torch.models import train
    cfg = gpt2_small("flash")
    host_params = models.init_params(cfg, seed)
    params = models.params_to(host_params, dev)
    rng = np.random.RandomState(seed + 7)
    tokens = rng.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len))
    labels = np.roll(tokens, -1, axis=1)
    launches = {}
    for name, (changes, per_step) in TRAIN_PATHS.items():
        step = models.make_train_step(dataclasses.replace(cfg, **changes),
                                      lr=TRAIN_LR)
        p, state = params, models.adam_init(params)
        want = {c: per_step.get(c, 0) for c in COUNTERS}
        losses, seconds = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()      # held before the path
        for i in range(1 + TRAIN_STEPS):          # a warm-up, then timed
            reset_counts()
            t0 = time.perf_counter()
            p, state, loss = step(p, state, tokens, labels)
            torch.cuda.synchronize()
            if i:
                seconds.append(time.perf_counter() - t0)
            got = counts()
            check(got == want, f"train {name} step {i}: launches {got}, "
                               f"expected {want}")
            losses.append(loss.item())
        launches[name] = {c: n * (1 + TRAIN_STEPS)
                          for c, n in per_step.items()}
        mean = sum(seconds) / len(seconds)
        log("train", path=name, steps=1 + TRAIN_STEPS,
            seconds=",".join(f"{x:.6f}" for x in seconds),
            mean_seconds=f"{mean:.6f}",
            tokens_per_s=f"{cfg.batch * cfg.seq_len / mean:.1f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            held_before_gb=f"{base / 1e9:.2f}",
            losses=",".join(repr(x) for x in losses), **got)
        check(all(np.isfinite(losses)), f"train {name}: losses {losses}")
        check(losses[-1] < losses[0], f"train {name}: the loss did not "
                                      f"fall: {losses}")
        del p, state, step
        torch.cuda.empty_cache()
    t = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    y = torch.as_tensor(labels, dtype=torch.int64, device=dev)
    a = train.value_and_grad(cfg, params, t, y)
    b = train.value_and_grad(cfg, params, t, y)
    same = bool(torch.equal(a[0], b[0])) and all(
        map(torch.equal, train.tree_leaves(a[1]), train.tree_leaves(b[1])))
    log("train", case="repeat_step_flash", bit_identical=same)
    check(same, "two flash steps from the same state differ")
    del b
    r = train.value_and_grad(dataclasses.replace(cfg, remat=True), params,
                             t, y)
    rel = max([rel_err(r[0], a[0])[0]] + [
        rel_err(x, ref)[0] for x, ref in zip(train.tree_leaves(r[1]),
                                             train.tree_leaves(a[1]))])
    same = bool(torch.equal(r[0], a[0])) and all(
        map(torch.equal, train.tree_leaves(r[1]), train.tree_leaves(a[1])))
    log("train", case="remat_vs_no_remat", rel_err=rel, bit_identical=same)
    check(rel < REMAT_RTOL, f"remat vs no remat: {rel} >= {REMAT_RTOL}")
    del a, r
    torch.cuda.empty_cache()
    check_grads_against_cpu(cfg, params, host_params, tokens[:1],
                            labels[:1])
    return launches


def check_grads_against_cpu(cfg, params, host_params, tokens0,
                            labels0) -> None:
    """Each layer's VJP and the head's (with the loss) on sequence 0, on
    the card and on the CPU (plain versions), from the card's input and
    the card's upstream cotangent; every parameter gradient and dx
    within GRAD_RTOL, beside the CPU's own fp32-vs-fp64 drift of the
    same VJP (the plain attention computes in fp32 there too).  The
    whole-depth loss is reported, not gated (the forward's reason: the
    seeded model amplifies rounding layer by layer)."""
    import torch.nn.functional as F
    from parsec_tpu_torch import models
    dev = params["embed"].device
    model = models.Transformer(cfg)

    def leaf(x):
        return x.detach().clone().requires_grad_(True)

    def layer(tree, i):
        return tree_map(lambda a: leaf(a.reshape(-1, *a.shape[2:])[i]),
                        tree)

    def layer_vjp(lp, x, dy):
        x = leaf(x)
        out = model._layer(lp, x, 0.0)[0]
        names = sorted(lp)
        grads = torch.autograd.grad(out, [x] + [lp[n] for n in names], dy)
        return out.detach(), dict(zip(["x"] + names, grads))

    def head_vjp(tree, x, labels):
        x, ln_f, embed = leaf(x), leaf(tree["ln_f"]), leaf(tree["embed"])
        logits = model._head({"ln_f": ln_f, "embed": embed}, x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        grads = torch.autograd.grad(loss, (x, ln_f, embed))
        return loss.detach(), dict(zip(("x", "ln_f", "embed"), grads))

    def compare(part, card, cpu32, cpu64):
        worst = 0.0
        for name in card:
            rel, absd = rel_err(card[name].cpu(), cpu32[name])
            log("train", case="grad_vs_cpu", part=part, grad=name,
                rel_err=rel, max_abs_err=absd,
                cpu_fp32_vs_fp64=rel_err(cpu32[name], cpu64[name])[0])
            worst = max(worst, rel)
        return worst

    t_host = torch.as_tensor(tokens0, dtype=torch.int64)
    y_host = torch.as_tensor(labels0, dtype=torch.int64)
    host64 = tree_map(torch.Tensor.double, host_params)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    with torch.no_grad():                     # the card's layer inputs
        xs = [model._embed(params, t_host.to(dev))]
        for i in range(cfg.n_layers):
            xs.append(model._layer(layer(params["stages"], i), xs[-1],
                                   0.0)[0])
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, card = head_vjp(params, xs[-1], y_host.to(dev))
        _, cpu32 = head_vjp(host_params, xs[-1].cpu(), y_host)
        _, cpu64 = head_vjp(host64, xs[-1].cpu().double(), y_host)
        worst = compare("head", card, cpu32, cpu64)
        dy = card["x"]
        for i in reversed(range(cfg.n_layers)):
            _, card = layer_vjp(layer(params["stages"], i), xs[i], dy)
            _, cpu32 = layer_vjp(layer(host_params["stages"], i),
                                 xs[i].cpu(), dy.cpu())
            _, cpu64 = layer_vjp(layer(host64["stages"], i),
                                 xs[i].cpu().double(), dy.cpu().double())
            worst = max(worst, compare(f"layer{i}", card, cpu32, cpu64))
            dy = card["x"]
    log("train", case="grads_vs_cpu", layers=cfg.n_layers, worst_rel=worst,
        cpu_seconds=f"{time.perf_counter() - t0:.3f}")
    check(worst < GRAD_RTOL, f"card vs CPU gradients on the same input: "
                             f"relative error {worst} >= {GRAD_RTOL}")
    with torch.no_grad():
        card_loss = models.loss_shard(cfg, params, t_host.to(dev),
                                      y_host.to(dev)).item()
        cpu_loss = models.loss_shard(cfg, host_params, t_host,
                                     y_host).item()
        cpu64_loss = models.loss_shard(cfg64, host64, t_host, y_host).item()
    log("train", case="whole_depth_loss_vs_cpu", card=repr(card_loss),
        cpu_fp32=repr(cpu_loss), cpu_fp64=repr(cpu64_loss),
        rel_err=abs(card_loss - cpu_loss) / abs(cpu_loss),
        cpu_fp32_vs_fp64=abs(cpu_loss - cpu64_loss) / abs(cpu64_loss))


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def phase_timing(dev: torch.device, seed: int) -> dict:
    """Each kernel at its path's shape by CUDA events, beside its bound,
    its plain version and one library call; returns the records."""
    import torch.nn.functional as F
    from parsec_tpu_torch.ops import kernels, linalg
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    nb = NB_MAIN
    a, b, c = (torch.randn(nb, nb, generator=g, device=dev)
               for _ in range(3))
    recs = {"gemm": dict(
        ms=time_ms(lambda: linalg.gemm_nt(c, a, b)),
        plain_ms=time_ms(lambda: kernels.gemm_plain(
            a, b, c, trans_b=True, alpha=-1.0, beta=1.0)),
        library_ms=time_ms(lambda: torch.addmm(c, a, b.mT, alpha=-1)),
        # A, B, C read once, Out written once
        **bound(2.0 * nb ** 3, 4 * nb * nb * 4))}
    # the batch sizes the dpotrf path launches (phase main logs its mean z)
    for z in (1, 4, 16):
        az, bz, cz = (torch.randn(z, nb, nb, generator=g, device=dev)
                      for _ in range(3))
        ms = time_ms(lambda: linalg.gemm_nt(cz, az, bz), iters=20)
        lib = time_ms(lambda: torch.baddbmm(cz, az, bz.mT, alpha=-1),
                      iters=20)
        bd = bound(2.0 * z * nb ** 3, 4 * z * nb * nb * 4)
        log("timing", case=f"gemm_nt nb={nb} z={z} fp32", kernel_ms=ms,
            library_ms=lib, library="torch.baddbmm", **bd,
            kernel_tflops=f"{2.0 * z * nb ** 3 / ms / 1e9:.3f}",
            library_tflops=f"{2.0 * z * nb ** 3 / lib / 1e9:.3f}",
            roofline_share=f"{bd['bound_ms'] / ms:.4f}")
        del az, bz, cz
    # tsmqr's product: Q2^T [A1; A2], M = K = 2 nb, N = nb, beside one
    # library call of the same function and the body's A^T copy
    q2, s2 = (torch.randn(2 * nb, w, generator=g, device=dev)
              for w in (2 * nb, nb))
    q2t = q2.mT.contiguous()
    ms = time_ms(lambda: kernels.gemm(q2t, s2), iters=20)
    lib = time_ms(lambda: torch.mm(q2t, s2), iters=20)
    work = 2.0 * (2 * nb) * nb * (2 * nb)
    bd = bound(work, (4 * nb * nb + 2 * 2 * nb * nb) * 4)
    log("timing", case=f"gemm tsmqr M={2 * nb} N={nb} K={2 * nb} fp32",
        kernel_ms=ms, library_ms=lib, library="torch.mm",
        plain_ms=time_ms(lambda: kernels.gemm_plain(q2t, s2), iters=20),
        **bd, kernel_tflops=f"{work / ms / 1e9:.3f}",
        roofline_share=f"{bd['bound_ms'] / ms:.4f}",
        body_ms=time_ms(lambda: linalg.tsmqr(q2, s2[:nb], s2[nb:]),
                        iters=20))
    for shape, x in (((2 * nb, 2 * nb), q2), ((nb, nb), a)):
        # one read and one write of the tile
        log("timing", case=f"transpose copy {shape} fp32",
            copy_ms=time_ms(lambda: linalg.transpose(x), iters=20),
            **bound(0.0, 2 * 4 * x.numel()))
    del q2, s2, q2t
    B, H, T, D = ATTN_SHAPE
    q, k, v = (torch.randn(B, H, T, D, generator=g, device=dev)
               for _ in range(3))
    # causal: 4 D flops (Q.K^T and P.V) for each of the T(T+1)/2 visible
    # (query, key) pairs of a row block; Q, K, V read once, O written once
    flops = 4.0 * B * H * D * T * (T + 1) / 2
    qkvo = 4 * B * H * T * D * 4
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=20)
    recs["flash"] = dict(
        ms=time_ms(lambda: kernels.flash_attention(q, k, v), iters=20),
        plain_ms=time_ms(lambda: kernels.flash_attention_plain(q, k, v),
                         iters=20),
        library_ms=library_ms, **bound(flops, qkvo))
    recs["flash_stats"] = dict(
        ms=time_ms(lambda: kernels.flash_attention_stats(q, k, v,
                                                         causal=True),
                   iters=20),
        plain_ms=time_ms(lambda: kernels.flash_attention_stats_plain(
            q, k, v, causal=True), iters=20),
        library_ms=library_ms,            # o alone: no call returns m, l
        **bound(flops, qkvo + 2 * B * H * T * 4))
    # the backward: five products of 2 D flops for each visible pair (S
    # and dP recomputed, dV, dK, dQ); Q, K, V, O, dO, m, l read once, dQ,
    # dK, dV written once.  The library's backward is SDPA's forward plus
    # backward less its forward.
    do = torch.randn(B, H, T, D, generator=g, device=dev)
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=True)
    leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    sdpa_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, do),
        iters=20)
    recs["flash_bwd"] = dict(
        ms=time_ms(lambda: kernels.flash_attention_bwd(q, k, v, o, m, l, do),
                   iters=20),
        plain_ms=time_ms(lambda: kernels.flash_attention_bwd_plain(
            q, k, v, o, m, l, do), iters=5),
        library_ms=sdpa_fwd_bwd_ms - library_ms,
        **bound(2.5 * flops, 2 * qkvo + 2 * B * H * T * 4))
    log("timing", case=f"scaled_dot_product_attention forward+backward "
                       f"{list(ATTN_SHAPE)} causal fp32",
        library_ms=sdpa_fwd_bwd_ms, forward_ms=library_ms)
    backward_instances()
    del leaves, do, o, m, l
    cases = {"gemm": (f"gemm_nt nb={nb} fp32", 2.0 * nb ** 3),
             "flash": (f"flash_attention {list(ATTN_SHAPE)} causal fp32",
                       flops),
             "flash_stats": (f"flash_attention_stats {list(ATTN_SHAPE)} "
                             f"causal fp32", flops),
             "flash_bwd": (f"flash_attention_bwd {list(ATTN_SHAPE)} causal "
                           f"fp32", 2.5 * flops)}
    for key, (case, work) in cases.items():
        rec = recs[key]
        log("timing", case=case, kernel_ms=rec["ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            plain_ms=rec["plain_ms"], library_ms=rec["library_ms"],
            kernel_tflops=f"{work / rec['ms'] / 1e9:.3f}",
            roofline_share=f"{rec['bound_ms'] / rec['ms']:.4f}")
    return recs


def backward_instances() -> None:
    """Each instance of the backward's library (the delta pass first):
    registers and local (spill) bytes a thread, static and dynamic shared
    memory (at the instance's widest D) and resident blocks an SM, from
    cudaFuncGetAttributes through ptt_flash_bwd_attributes."""
    import ctypes
    from parsec_tpu_torch.ops import kernels
    lib = kernels.load("flash_attention_bwd")
    out, name = (ctypes.c_int * 5)(), ctypes.c_char_p()
    i = 0
    while (rc := lib.ptt_flash_bwd_attributes(i, out,
                                              ctypes.byref(name))) == 0:
        log("timing", instance=name.value.decode(), registers=out[0],
            local_bytes=out[1], static_smem_bytes=out[2],
            dynamic_smem_bytes=out[3], blocks_per_sm=out[4])
        i += 1
    check(rc == -1, f"ptt_flash_bwd_attributes({i}): "
                    f"{lib.ptt_error_string(rc).decode()}")


def profile_report(label: str, prof, seconds: float, top: int = 12) -> None:
    """Device time by kernel from a profiler run, and the device's busy
    share of the wall time (the union of its kernel and copy intervals)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(evs), f"{label}: the profiler recorded no device activity")
    by_name: dict = {}
    for e in evs:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy_us, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy_us += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy_us += e0 - s0
    log("profile", path=label, seconds=f"{seconds:.4f}",
        device_events=len(evs), device_busy_ms=f"{busy_us / 1e3:.3f}",
        busy_share=f"{busy_us / 1e6 / seconds:.4f}")
    for name, (calls, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        log("profile", path=label, calls=calls, ms=f"{us / 1e3:.3f}",
            share_of_busy=f"{us / busy_us:.4f}", kernel=repr(name[:100]))


def phase_profile(dev: torch.device, seed: int, n: int = N_MAIN,
                  nb: int = NB_MAIN) -> None:
    """The dpotrf, DTD Cholesky, dgeqrf and pdgemm (op(A) = A and A^T)
    paths, one replay of the captured dpotrf, the pivoted dgetrf (one
    host sync a panel) and one ring forward (after a warm-up) once more
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch import models
    from parsec_tpu_torch.dsl import ptg
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prof = profile(activities=acts)
    _L, _st, seconds = run_dpotrf(synth_spd(n, seed), nb,
                                  around=lambda: prof)
    profile_report("dpotrf", prof, seconds)
    A = tiled(synth_spd(n, seed), nb)
    prof = profile(activities=acts)
    _st, seconds, _ = drive(lambda ctx: dtd_cholesky(ctx, A), [],
                            around=lambda: prof)
    profile_report("dtd", prof, seconds)
    # one replay of the captured dpotrf, its host copies in and out
    A = tiled(synth_spd(n, seed), nb)
    cg = ptg.capture(ptt.ops.dpotrf_taskpool(A))
    cg.record()
    with profile(activities=acts) as prof:
        seconds, _ms = run_graph(cg)
    profile_report("capture_dpotrf", prof, seconds)
    free_graph(cg)
    # the wave engine: pools staged in once, batched calls, one pull
    A = tiled(synth_spd(n, seed), nb)
    w = ptg.wave(ptt.ops.dpotrf_taskpool(A))
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        w.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    profile_report("wave_dpotrf", prof, seconds)
    del w
    A = tiled(uniform(n, n, seed=seed + 12), nb)
    prof = profile(activities=acts)
    _st, seconds, _ = drive(lambda ctx: ptt.ops.dgeqrf(ctx, A), [],
                            around=lambda: prof)
    profile_report("dgeqrf", prof, seconds)
    Am, Bm, Cm = (uniform(n, n, seed=seed + 13 + i) for i in range(3))
    for transa in ("n", "t"):
        A, B, C = tiled(Am, nb), tiled(Bm, nb), tiled(Cm, nb)
        prof = profile(activities=acts)
        _st, seconds, _ = drive(
            lambda ctx: ptt.ops.pdgemm(ctx, A, B, C, alpha=1.5, beta=0.5,
                                       transa=transa), [],
            around=lambda: prof)
        profile_report(f"pdgemm_{transa}n", prof, seconds)
    del A, B, C, Am, Bm, Cm
    Md = torch.from_numpy(uniform(n, n, seed=seed + 16)).to(dev)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        LU, _perm = ptt.ops.dgetrf(Md, nb=nb, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    profile_report("dgetrf", prof, seconds)
    del Md, LU
    torch.cuda.empty_cache()
    cfg = gpt2_small("ring")
    params = models.params_to(models.init_params(cfg, seed), dev)
    tokens = np.random.RandomState(seed + 5).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len))
    fwd = models.make_forward(cfg)
    fwd(params, tokens)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fwd(params, tokens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    profile_report("forward_ring", prof, seconds)
    del fwd
    # one flash train step after a warm-up step
    cfg = dataclasses.replace(cfg, attention="flash")
    step = models.make_train_step(cfg, lr=TRAIN_LR)
    labels = np.roll(tokens, -1, axis=1)
    p, state, _ = step(params, models.adam_init(params), tokens, labels)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        p, state, _ = step(p, state, tokens, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    profile_report("train_flash", prof, seconds, top=16)
    del p, state, params, step
    torch.cuda.empty_cache()
    profile_yardsticks(dev, seed)


def profile_yardsticks(dev: torch.device, seed: int) -> None:
    """Each kernel and the library call it is timed against, once at the
    path's shape under torch.profiler: which device kernels each runs, and
    their device time."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from parsec_tpu_torch.ops import kernels, linalg
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    a, b, c = (torch.randn(4, NB_MAIN, NB_MAIN, generator=g, device=dev)
               for _ in range(3))
    q, k, v, do = (torch.randn(*ATTN_SHAPE, generator=g, device=dev)
                   for _ in range(4))
    o, m, l = kernels.flash_attention_stats(q, k, v, causal=True)
    leaves = tuple(x.clone().requires_grad_(True) for x in (q, k, v))
    calls = {"gemm_nt": lambda: linalg.gemm_nt(c[0], a[0], b[0]),
             "torch.addmm": lambda: torch.addmm(c[0], a[0], b[0].mT,
                                                alpha=-1),
             "gemm_nt z=4": lambda: linalg.gemm_nt(c, a, b),
             "torch.baddbmm z=4": lambda: torch.baddbmm(c, a, b.mT,
                                                        alpha=-1),
             "flash_attention_stats": lambda: kernels.flash_attention_stats(
                 q, k, v, causal=True),
             "F.scaled_dot_product_attention":
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True),
             "flash_attention_bwd": lambda: kernels.flash_attention_bwd(
                 q, k, v, o, m, l, do),
             "F.scaled_dot_product_attention forward+backward":
                 lambda: torch.autograd.grad(F.scaled_dot_product_attention(
                     *leaves, is_causal=True), leaves, do)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    # one session (one per call loses events); each call synchronises
    # inside its own range, so its device work falls within that range
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in calls.items():
            with record_function(label):
                fn()
                torch.cuda.synchronize()
    evs = prof.events()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in evs
              if e.device_type == DeviceType.CPU and e.name in calls]
    for e in evs:
        if e.device_type != DeviceType.CUDA:
            continue
        call = next((name for name, t0, t1 in ranges
                     if t0 <= e.time_range.start <= t1), "unattributed")
        log("profile", path="yardstick", call=call,
            us=f"{e.time_range.elapsed_us():.2f}", kernel=repr(e.name[:140]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also run the dpotrf, wave dpotrf, dgeqrf, pdgemm "
                         "and dgetrf paths, one forward and one train step "
                         "under torch.profiler and print device time by "
                         "kernel")
    args = ap.parse_args(argv)
    # the package must come from this checkout; importing it first means a
    # directory holding only this script fails before any result
    import parsec_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gemm_err = phase_kernel(dev, args.seed)
    attn_err = phase_attention(dev, args.seed)
    gemm_err = max(gemm_err, phase_bodies(dev, args.seed))
    # each path run with the counters set to 0 just before it
    gemm_launches = {}
    gemm_launches["dpotrf"], L_ptg = phase_main(args.seed)
    gemm_launches["dtd"], L_dtd = phase_dtd(args.seed, L_ptg)
    gemm_launches["dtd_gemm"] = phase_dtd_gemm(args.seed)
    gemm_launches["dposv"], factor = phase_dposv(args.seed)
    gemm_launches["dgetrf_nopiv"], LU = phase_getrf_nopiv(args.seed)
    gemm_launches["dgeqrf"], QR = phase_geqrf(args.seed)
    gemm_launches["pdgemm"], C_nn = phase_pdgemm(args.seed)
    phase_dense(dev, args.seed, factor)
    del factor
    phase_bitexact(args.seed)
    # the static engines, each factor held against the interpreted one
    refs = {("dpotrf", NB_MAIN): L_ptg, ("dgetrf_nopiv", NB_MAIN): LU,
            ("dgeqrf", NB_MAIN): QR, ("pdgemm", NB_MAIN): C_nn}
    del LU, QR, C_nn
    inputs = {}
    t0 = time.perf_counter()
    gemm_launches["static"] = phase_static(args.seed, refs, inputs)
    for phase in (phase_turbo, phase_wave):
        for key, n in phase(args.seed, refs, inputs).items():
            gemm_launches[f"{phase.__name__[6:]}_{key}"] = n
    log("engines", phases="static,turbo,wave",
        seconds=f"{time.perf_counter() - t0:.1f}")
    del refs, inputs
    # a captured path's entry counts the warm-up's launches, which ran
    # through the wrapper; its graph's recorded launches and replays are
    # kept apart, under graph_launches
    graph_launches = {}
    launches, graphs = phase_capture(args.seed, L_ptg)
    for routine in launches:
        gemm_launches[f"capture_{routine}"] = launches[routine]
        graph_launches[f"capture_{routine}"] = graphs[routine]
    del L_ptg
    gemm_launches["dtd_capture"], graph_launches["dtd_capture"] = \
        phase_dtd_capture(args.seed, L_dtd)
    del L_dtd
    attn_launches = phase_forward(dev, args.seed)
    train_launches = phase_train(dev, args.seed)
    recs = phase_timing(dev, args.seed)
    if args.profile:
        phase_profile(dev, args.seed)
    src = "parsec_tpu_torch/csrc/"
    tpu = "parsec_tpu/ops/pallas_kernels.py:"
    print(json.dumps({"kernels": [
        dict(name="gemm_f32", route="cuda", source=src + "matmul.cu",
             replaces=tpu + "395", launches=gemm_launches,
             graph_launches=graph_launches, max_abs_err=gemm_err,
             **recs["gemm"]),
        dict(name="flash_fwd_f32", route="cuda",
             source=src + "flash_attention.cu", replaces=tpu + "68",
             launches={"forward_flash": attn_launches["flash"]},
             max_abs_err=attn_err["flash"], **recs["flash"]),
        # the training forward of flash_attention runs this instance too
        dict(name="flash_fwd_stats_f32", route="cuda",
             source=src + "flash_attention.cu", replaces=tpu + "115",
             launches={"forward_ring": attn_launches["ring"],
                       **{f"train_{path}": n["flash_stats_launches"]
                          for path, n in train_launches.items()}},
             max_abs_err=attn_err["flash_stats"], **recs["flash_stats"]),
        dict(name="flash_bwd_f32", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=tpu + "287",
             launches={f"train_{path}": n["flash_bwd_launches"]
                       for path, n in train_launches.items()
                       if "flash_bwd_launches" in n},
             max_abs_err=attn_err["flash_bwd"], **recs["flash_bwd"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
