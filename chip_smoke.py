#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parsec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--profile]

Phases, each reporting on its own lines:

1. device   the card's name, and its name and power limit from nvidia-smi;
2. build    every CUDA source of this checkout (csrc/*.cu), one nvcc for
            each, all started together; then each kernel instance's
            registers and spills, from nvcc -Xptxas -v;
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
            concatenation; relative max error under 1e-4;
5. main     the dpotrf path at full size, through the entry points a user
            calls: init() -> TwoDimBlockCyclic.from_numpy -> ops.dpotrf
            on a 16384^2 fp32 matrix in 1024^2 tiles (816 tasks); every
            task on cuda:0, the GEMM kernel launched, the mean batch
            (GEMM and SYRK tasks per launch), and the factor's matvec
            residual under 1e-4;
6. bitexact batched and per-task dispatch give identical factors
            (N = 4096, NB = 512);
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
8. timing   each kernel at its path's shape, by CUDA events: the GEMM
            at nb = 1024 against torch.addmm, and batched at z = 1, 4
            and 16 against torch.baddbmm, each flash kernel at
            [8, 12, 1024, 64] causal against
            F.scaled_dot_product_attention (fp32; it returns o alone),
            beside its bound and its plain version;
9. profile  with --profile only: the dpotrf path and one forward once
            more under torch.profiler, with device time by kernel and
            the device's busy share of the wall time; then the GEMM and
            stats kernels and their library yardsticks once each, with
            the device kernels each call runs.

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
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN, NB_MAIN = 16384, 1024
N_BITEXACT, NB_BITEXACT = 4096, 512
ATTN_SHAPE = (8, 12, 1024, 64)   # B, H, T, D of the forward's attention
N_BATCHES = 3          # timed forwards per attention, after one warm-up
RTOL = 1e-4            # kernel vs plain version, relative max error
RESID_TOL = 1e-4       # matvec residual of the factor, fp32
LOGITS_RTOL = 2e-4     # forward logits: ring vs flash, card vs CPU, fp32
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


COUNTERS = ("matmul_launches", "flash_launches", "flash_stats_launches")


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
    libs = kernels.build()
    for name in libs:
        kernels.load(name)
    log("build", seconds=f"{time.perf_counter() - t0:.3f}",
        libraries=",".join(so.name for so in libs.values()))
    ptxas_report()


def ptxas_report() -> None:
    """Registers and spills of every kernel instance, from ``nvcc -Xptxas
    -v`` on each source (one nvcc each, all at once)."""
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
        reports = {name: p.communicate()[0] for name, p in procs.items()}
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
    return worst


def synth_spd(n: int, seed: int) -> np.ndarray:
    """A = (B + B^T)/2 + n I with B uniform in [-0.5, 0.5), in O(n^2)."""
    rng = np.random.default_rng(seed)
    b = rng.random((n, n), dtype=np.float32) - np.float32(0.5)
    a = (b + b.T) * np.float32(0.5)
    a[np.diag_indices(n)] += np.float32(n)
    return a


def residual(L: np.ndarray, M: np.ndarray, seed: int) -> float:
    """||L (L^T X) - A X||_inf / ||A X||_inf over 4 random vectors."""
    X = np.random.default_rng(seed + 1).random((M.shape[0], 4))
    Lf = L.astype(np.float64)
    ref = M.astype(np.float64) @ X
    return float(np.abs(Lf @ (Lf.T @ X) - ref).max() / np.abs(ref).max())


def run_dpotrf(M: np.ndarray, nb: int, nb_cores: int, device=None,
               around=contextlib.nullcontext):
    """The port's main path on ``M``; returns (L, stats, seconds).
    ``around()`` is entered around the timed factorization alone."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    ctx = ptt.init(nb_cores=nb_cores, device=device)
    try:
        n = M.shape[0]
        A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32).from_numpy(M)
        dev = ctx.device_by_type("cuda")
        with around():
            t0 = time.perf_counter()
            ptt.ops.dpotrf(ctx, A)
            if dev.is_cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        t1 = time.perf_counter()
        for (m, k) in A.tiles():     # stage-out through the device module
            A.data_of(m, k).sync_to_host(ctx.devices)
        stats = dict(dev.stats, executed_tasks=dev.executed_tasks,
                     device=dev.name, stage_out_s=time.perf_counter() - t1,
                     nt=A.nt)
        return np.tril(A.to_numpy()), stats, seconds
    finally:
        ctx.fini()


def phase_main(seed: int, n: int = N_MAIN, nb: int = NB_MAIN,
               device=None) -> int:
    """Drive dpotrf at full size; returns the kernel's launches."""
    from parsec_tpu_torch.ops import kernels
    M = synth_spd(n, seed)
    reset_counts()
    L, st, seconds = run_dpotrf(M, nb, nb_cores=4, device=device)
    launches = kernels.matmul_launches
    nt = st["nt"]
    n_tasks = nt * (nt + 1) * (nt + 2) // 6
    # GEMM and SYRK tasks, each one z-slice of a GEMM launch
    gemm_tasks = nt * (nt - 1) * (nt - 2) // 6 + nt * (nt - 1) // 2
    resid = residual(L, M, seed)
    log("main", device=st["device"], n=n, nb=nb, tasks=st["tasks"],
        expected_tasks=n_tasks, executed_tasks=st["executed_tasks"],
        seconds=f"{seconds:.4f}",
        gflops=f"{n ** 3 / 3 / seconds / 1e9:.2f}",
        batches=st["batches"], batched_tasks=st["batched_tasks"],
        stage_in_bytes=st["stage_in_bytes"],
        stage_out_bytes=st["stage_out_bytes"],
        stage_out_seconds=f"{st['stage_out_s']:.4f}",
        stack_bytes=st["stack_bytes"], matmul_launches=launches,
        gemm_syrk_tasks=gemm_tasks,
        mean_z=f"{gemm_tasks / max(launches, 1):.3f}", residual=resid)
    check(st["tasks"] == n_tasks and st["executed_tasks"] == n_tasks,
          f"{st['tasks']} of {n_tasks} tasks ran on the device")
    check(launches > 0, "the main path launched the GEMM kernel no time")
    check(np.isfinite(L).all(), "the factor holds non-finite values")
    check(resid < RESID_TOL, f"residual {resid} >= {RESID_TOL}")
    return launches


def phase_bitexact(seed: int, n: int = N_BITEXACT, nb: int = NB_BITEXACT,
                   device=None) -> None:
    from parsec_tpu_torch.utils.params import params
    M = synth_spd(n, seed + 2)
    out = {}
    for bmax in (1, 16):
        with params.cmdline_override("device_batch_max", str(bmax)):
            out[bmax] = run_dpotrf(M, nb, nb_cores=4, device=device)
    (L1, s1, _), (L16, s16, _) = out[1], out[16]
    same = bool(np.array_equal(L1, L16))
    log("bitexact", n=n, nb=nb, batches_per_task=s1["batches"],
        batches_batched=s16["batches"], identical=same)
    check(s1["batches"] == 0 and s16["batches"] > 0,
          f"batches {s1['batches']} / {s16['batches']}")
    check(same, "batched and per-task factors differ")


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
            y = card._layer(layer(params["stages"], i), x)
            rel, absd = rel_err(y.cpu(), card._layer(
                layer(host_params["stages"], i), x.cpu()))
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
    cases = {"gemm": (f"gemm_nt nb={nb} fp32", 2.0 * nb ** 3),
             "flash": (f"flash_attention {list(ATTN_SHAPE)} causal fp32",
                       flops),
             "flash_stats": (f"flash_attention_stats {list(ATTN_SHAPE)} "
                             f"causal fp32", flops)}
    for key, (case, work) in cases.items():
        rec = recs[key]
        log("timing", case=case, kernel_ms=rec["ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            plain_ms=rec["plain_ms"], library_ms=rec["library_ms"],
            kernel_tflops=f"{work / rec['ms'] / 1e9:.3f}",
            roofline_share=f"{rec['bound_ms'] / rec['ms']:.4f}")
    return recs


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
    """The dpotrf path and one ring forward (after a warm-up) once more
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from parsec_tpu_torch import models
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prof = profile(activities=acts)
    _L, _st, seconds = run_dpotrf(synth_spd(n, seed), nb, nb_cores=4,
                                  around=lambda: prof)
    profile_report("dpotrf", prof, seconds)
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
    q, k, v = (torch.randn(*ATTN_SHAPE, generator=g, device=dev)
               for _ in range(3))
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
                                                        is_causal=True)}
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
                    help="also run the dpotrf path and one forward under "
                         "torch.profiler and print device time by kernel")
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
    gemm_launches = phase_main(args.seed)
    phase_bitexact(args.seed)
    attn_launches = phase_forward(dev, args.seed)
    recs = phase_timing(dev, args.seed)
    if args.profile:
        phase_profile(dev, args.seed)
    src = "parsec_tpu_torch/csrc/"
    tpu = "parsec_tpu/ops/pallas_kernels.py:"
    print(json.dumps({"kernels": [
        dict(name="gemm_f32", route="cuda", source=src + "matmul.cu",
             replaces=tpu + "395", launches=gemm_launches,
             max_abs_err=gemm_err, **recs["gemm"]),
        dict(name="flash_fwd_f32", route="cuda",
             source=src + "flash_attention.cu", replaces=tpu + "68",
             launches=attn_launches["flash"], max_abs_err=attn_err["flash"],
             **recs["flash"]),
        dict(name="flash_fwd_stats_f32", route="cuda",
             source=src + "flash_attention.cu", replaces=tpu + "115",
             launches=attn_launches["ring"],
             max_abs_err=attn_err["flash_stats"], **recs["flash_stats"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
