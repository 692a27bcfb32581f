#!/usr/bin/env python3
"""Hold the kernels built from another tree's sources (a parent commit's
``parsec_tpu_torch/csrc``) against this tree's, on one NVIDIA card.

    mkdir -p build/kernels/parent
    git archive HEAD parsec_tpu_torch/csrc | tar -x -C build/kernels/parent
    python3 kernel_parity.py build/kernels/parent/parsec_tpu_torch/csrc

The libraries compared are built from sources of the same name with the
same flags in both trees: the fp32 GEMM (``matmul.cu``), the fp32 flash
forward and stats (``flash_attention.cu``), the fp32 flash backward
(``flash_attention_bwd.cu``) and the bf16 flash forward and stats
(``flash_attention_bf16.cu``).  Each case calls this tree's wrapper
twice, once with the other tree's library loaded in place of this
tree's, and compares every output bit for bit.  Then each library is
timed at its path's shape in the order other, this, this, other:
host-inclusive CUDA events (``chip_smoke.time_ms``, as the smoke's
timing phase) and torch.profiler's kernel time (``chip_smoke.device_ms``).

Prints the card's name and power limit, one JSON object a line for each
case and timing, and the bit-equality verdict last; writes the same
lines to ``chiprun_out/kernel_parity.jsonl``.  Exits 1 when an output
differs, 2 without a card or without the other tree's sources.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

#: the libraries compared
LIBRARIES = ("matmul", "flash_attention", "flash_attention_bwd",
             "flash_attention_bf16")
#: attention cases (B, H, T, Tk, D, causal) beside the path's shape
ATTN_CASES = [(2, 3, 1000, 1000, 40, False), (2, 3, 256, 384, 64, True),
              (1, 2, 200, 333, 128, True), (2, 2, 300, 1000, 33, False)]


def _label(B, H, T, Tk, D, causal) -> str:
    return f"{[B, H, T, Tk, D]}{' causal' if causal else ''}"


def main(other_csrc: Path) -> int:
    from chip_smoke import ATTN_SHAPE, NB_MAIN, device_ms, time_ms
    from parsec_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("kernel_parity: no CUDA card", file=sys.stderr)
        return 2
    missing = [s for s in LIBRARIES
               if not (other_csrc / f"{kernels._LIBRARIES[s][0]}.cu")
               .exists()]
    if missing:
        print(f"kernel_parity: {other_csrc} lacks {missing}",
              file=sys.stderr)
        return 2
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / "kernel_parity.jsonl", "w")

    def emit(**rec) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    # the other tree's libraries, one nvcc each, beside this tree's build
    build_dir = kernels._BUILD_DIR / "other"
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc, t0 = kernels._nvcc(), time.perf_counter()
    jobs = {}
    for name in LIBRARIES:
        source, _tag, flags = kernels._LIBRARIES[name]
        so = build_dir / f"{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [nvcc, "-o", str(so), *kernels._NVCC_FLAGS, *flags,
             str(other_csrc / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels.build(list(LIBRARIES))
    ours, theirs = {}, {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other {name}:\n{log}")
        source, tag, _flags = kernels._LIBRARIES[name]
        lib = ctypes.CDLL(str(so))
        kernels._SOURCES[source](lib, tag)
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        theirs[name], ours[name] = lib, kernels.load(name)
    emit(build_s=time.perf_counter() - t0)

    def run(name: str, lib, fn):
        kernels._libs[name] = lib
        try:
            res = fn()
            torch.cuda.synchronize()
            return res if isinstance(res, tuple) else (res,)
        finally:
            kernels._libs[name] = ours[name]

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    from parsec_tpu_torch.ops import linalg
    nb = NB_MAIN
    cases = []      # (library, case, fn)
    a, b, c = (rnd(nb, nb) for _ in range(3))
    a4, b4, c4 = (rnd(4, nb, nb) for _ in range(3))
    ra, rb = rnd(999, 997), rnd(997, 1001)
    cases += [("matmul", f"gemm_nt nb={nb}", lambda: linalg.gemm_nt(c, a, b)),
              ("matmul", f"gemm_nt nb={nb} z=4",
               lambda: linalg.gemm_nt(c4, a4, b4)),
              ("matmul", "gemm 999x1001x997", lambda: kernels.gemm(ra, rb))]
    attn = [(*ATTN_SHAPE[:3], ATTN_SHAPE[2], ATTN_SHAPE[3], True)]
    attn += ATTN_CASES
    for dtype, fwd in ((torch.float32, "flash_attention"),
                       (torch.bfloat16, "flash_attention_bf16")):
        for B, H, T, Tk, D, causal in attn:
            q = rnd(B, H, T, D, dtype=dtype)
            k, v = (rnd(B, H, Tk, D, dtype=dtype) for _ in range(2))
            label = _label(B, H, T, Tk, D, causal)
            cases += [(fwd, f"forward {label}",
                       lambda q=q, k=k, v=v, causal=causal:
                       kernels.flash_attention(q, k, v, causal=causal)),
                      (fwd, f"stats {label}",
                       lambda q=q, k=k, v=v, causal=causal:
                       kernels.flash_attention_stats(q, k, v,
                                                     causal=causal))]
            if dtype == torch.float32:
                o, m, l = kernels.flash_attention_stats(q, k, v,
                                                        causal=causal)
                do = rnd(B, H, T, D)
                cases.append(("flash_attention_bwd", f"backward {label}",
                              lambda q=q, k=k, v=v, o=o, m=m, l=l, do=do,
                              causal=causal: kernels.flash_attention_bwd(
                                  q, k, v, o, m, l, do, causal)))
    equal = True
    for name, case, fn in cases:
        got, want = run(name, ours[name], fn), run(name, theirs[name], fn)
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        equal &= same
        emit(library=name, case=case, dtype=str(got[0].dtype)[6:],
             outputs=len(got), bit_equal=same)
    # timing at each library's path shape: other, this, this, other
    path = _label(*attn[0])
    timed = {"matmul": [f"gemm_nt nb={nb}"],
             "flash_attention": [f"forward {path}", f"stats {path}"],
             "flash_attention_bwd": [f"backward {path}"],
             "flash_attention_bf16": [f"forward {path}", f"stats {path}"]}
    by_case = {(n, cs): fn for n, cs, fn in cases}
    for name in LIBRARIES:
        for case in timed[name]:
            fn = by_case[(name, case)]
            for who, lib in (("other", theirs[name]), ("this", ours[name]),
                             ("this", ours[name]), ("other", theirs[name])):
                kernels._libs[name] = lib
                try:
                    ms = time_ms(fn, iters=20)
                    dev_ms, split = device_ms(fn)
                finally:
                    kernels._libs[name] = ours[name]
                emit(library=name, case=case, build=who, ms=ms,
                     device_ms=dev_ms, device_split=split)
    emit(bit_equal=equal, cases=len(cases))
    sink.close()
    return 0 if equal else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(Path(sys.argv[1]).resolve()))
