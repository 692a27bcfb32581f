#!/usr/bin/env python3
"""Time the CUDA-graph records of stage-compiled dpotrf with another
tree's record path (a parent commit's ``parsec_tpu_torch/dsl/graph.py``)
against this tree's, on one NVIDIA card.

    mkdir -p build/kernels/parent
    git archive HEAD parsec_tpu_torch/dsl/graph.py | tar -x -C build/kernels/parent
    python3 record_parity.py build/kernels/parent/parsec_tpu_torch/dsl/graph.py

Each round factors the SPD matrix of ``chip_smoke.py``'s stage legs
(n = 16384, nb = 1024) on a new context with whole-stage compilation
on, so every stage is recorded anew, with ``GraphRunner._record`` taken
from one tree or the other: a warm-up round with this tree's (the
process's one-time costs: the GEMM kernel's build, the libraries'
handles; not counted), then other, this, this, other, twice.  A round
reports the stages' record seconds (warm-up and capture, from the
programs' facts), the run's wall and whether the factor has the bits
of the first round's.

Prints the card's name and power limit and one JSON object a line for
each round, then the median record seconds of each tree; writes the
same lines to ``chiprun_out/record_parity.jsonl``.  Exits 1 when a
factor differs, 2 without a card or without the other tree's file.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

ORDER = ("warm-up",) + ("other", "this", "this", "other") * 2


def main(other_graph: Path) -> int:
    from chip_smoke import (N_MAIN, NB_MAIN, knobs, stagec_pools,
                            stagec_programs, synth_spd, tiled)
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl.graph import GraphRunner
    if not torch.cuda.is_available():
        print("record_parity: no CUDA card", file=sys.stderr)
        return 2
    if not other_graph.is_file():
        print(f"record_parity: no {other_graph}", file=sys.stderr)
        return 2
    # the other module resolves its relative imports in this package
    spec = importlib.util.spec_from_file_location(
        "parsec_tpu_torch.dsl._graph_other", other_graph)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    records = {"this": GraphRunner._record, "warm-up": GraphRunner._record,
               "other": other.GraphRunner._record}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / "record_parity.jsonl", "w")

    def emit(**rec) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    M = synth_spd(N_MAIN, 0)
    first, same = None, True
    seconds = {"this": [], "other": [], "warm-up": []}
    for i, tree in enumerate(ORDER):
        GraphRunner._record = records[tree]
        with knobs({"stage_compile": "1"}):
            ctx = ptt.init(nb_cores=4)
            try:
                A = tiled(M, NB_MAIN)
                tp = ptt.ops.dpotrf_taskpool(A)
                wall, _peak = stagec_pools(ctx, [tp])
                rows = stagec_programs([tp])
                L = np.tril(A.to_numpy())
                del A, tp
            finally:
                ctx.fini()
        gc.collect()
        torch.cuda.empty_cache()
        if first is None:
            first = L
        bits = bool(np.array_equal(L, first))
        same = same and bits
        rec = sum(r.get("record_seconds", 0) for r in rows)
        seconds[tree].append(rec)
        emit(round=i, tree=tree, record_seconds=rec, wall=wall,
             stages=len(rows),
             downgraded=sum(r["status"] == "downgraded" for r in rows),
             bits_of_first=bits)
    GraphRunner._record = records["this"]
    emit(median_record_seconds={t: statistics.median(seconds[t])
                                for t in ("this", "other")},
         bit_equal=same)
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(Path(sys.argv[1])))
