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
4c. batch_semantics a device body written for one tile keeps its
            single-tile semantics when the device module or the wave
            engine groups its tasks: 16 independent tasks, each
            A = A - A * A.sum() on its own 1024 x 1024 fp32 tile, at
            device_batch_max 16 (one worker, so the burst groups),
            through the interpreted PTG path, DTD (add_chore, unmarked)
            and the wave engine on cuda:0; each tile within 1e-5
            relative of numpy in fp64, task by task; each path's batch
            count (dispatch groups, and the wave's body calls);
5. main     the dpotrf path at full size, through the entry points a user
            calls: init() -> TwoDimBlockCyclic.from_numpy -> ops.dpotrf
            on a 16384^2 fp32 matrix in 1024^2 tiles (816 tasks); every
            task on cuda:0, the GEMM kernel launched, the mean batch
            (GEMM and SYRK tasks per launch), and the factor's matvec
            residual under 1e-4;
5a. obs     telemetry on one rank: dpotrf at main's size and input with
            profile=True and the metrics knob, through init(); the
            report of obs.analyze (per-class breakdown, overlap fraction,
            device-busy seconds from the timed CUDA events around each
            dispatch), the rank's wall split (obs.rank_wall_split), the
            H2D and D2H copies' event-timed seconds beside the host's
            spans and waits; checks: the dispatch intervals disjoint on
            the one stream, their sum positive and within the wall, the
            factor bit-identical to main's, the Prometheus exposition
            parsing; under --profile the same run under torch.profiler,
            its busy share printed beside the events' share;
5a". serve two tenants on one context (serve=1, serve_admission=queue,
            init() on cuda:0, a SessionServer): "latency" (weight 2)
            submits 2 dpotrf taskpools and "bulk" (weight 1, opened with
            max_pools=2) 3, each on phase main's input at its size, in
            the order latency, bulk, latency, bulk, bulk; bulk's third
            submission (the fifth) is queued and drained when one of its
            pools retires.  Each tenant's p50 and p99 latency from the
            live monitor (LiveHealth), the wall and the order in which
            the pools finished (printed, not checked: it depends on
            timing).  Checks: every factor bit-identical to phase main's
            (the same input factored alone); 5 admitted, 1 queued, 0
            rejected, and the PARSEC::SERVE::* gauges (2 tenants, nothing
            in flight at the end, a p99 latency for each); the GEMM
            kernel launched;
5a'. mesh  one rank's chip mesh on the card: device_mesh_shape=2x2 over
            device_cuda_virtual_chips logical chips of cuda:0, each an
            index and a CUDA stream of its own, phase main's input.
            (a) dpotrf through init() -> ops.dpotrf with 4 chips: the
            factor bit-identical to phase main's, sharded flush groups
            (mesh_dispatches > 0, mesh_tasks >= 4 a dispatch), all 816
            tasks CUDA-body tasks on the mesh device, the GEMM kernel
            launched on each of the 4 chip streams (counted per chip,
            summing to the kernel's counter); the wall, hops and their
            bytes, the resident bytes per chip and the memory budget;
            (b) 16 DTD tasks C <- C - A B^T on 1024 x 1024 tiles, chore
            ops.linalg.gemm_nt, on the mesh and on one chip: bit-identical,
            the mesh's burst sharded; (c) 2 rank threads on a LocalFabric,
            8 chips, each rank a 2 x 2 mesh of its own (ids 0-3 and 4-7),
            dpotrf with A on 2 x 1: the assembled factor bit-identical to
            phase main's, mesh-local sends, GEMM launches on every rank;
            under --profile (a) once more under torch.profiler (path
            mesh_dpotrf, and the share of the GEMM kernel's time during
            which two chip streams ran it at once);
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
5b'. stagec whole-stage compilation (stage_compile=1: each verified
            stage one recorded CUDA graph, replayed as one chore; every
            GEMM and SYRK body the GEMM kernel): (1) dpotrf at main's
            size and input, the factor bit-identical to main's; stages,
            staged tasks, residue, records, fallbacks (0), the GEMM
            kernel's launches (the records' warm-ups and captures, the
            device module's dispatches, which sum to the wrapper's
            count; the graphs' recorded launches and their replays),
            record seconds, the last replay's device time, the wall and
            the peak device memory; (2) a second dpotrf pool on the
            same context: the cache hits (no new record), the factor
            identical again; the context's fini then frees the graphs;
            (3) dposv at dposv's size with the chain on: X
            bit-identical to phase dposv's, chain links > 0, no chain
            fallback; (4) and (5) at N = 8192 (cut from 16384 to save
            time), each factor bit-identical to one chip's interpreted
            run at that N: (4) dpotrf with stage_compile_exclude=SYRK,
            residue groups dispatching as bursts between the recorded
            stages; (5) a 2 x 2 mesh of 4 logical chips, wave-front
            stages sharded over the chips, the GEMM kernel's recorded
            launches per chip; (6) cross-rank stages
            (stage_compile_xrank=1): dpotrf at main's size and input over
            2 rank threads on loopback TCP (P = 2, Q = 1), one logical
            lane chip each (device_cuda_virtual_chips=2): every wave
            front spanning both ranks one program over the two chips,
            "xs" negotiated both ways, cross-rank stage tasks and block
            records on both ranks, no fallback, elided activations that
            carry no payload, the factor bit-identical to main's, the
            GEMM launches accounted as in (1) over both ranks; the
            [stagec.xrank] line gives each rank's wall, the cross-rank
            waves, the records' and the replays' seconds; under
            --profile, (2) once more under torch.profiler (path
            stagec_dpotrf).  The seventh leg runs inside multirank's
            dposv_2 spawn (stagec.ranks_2): dposv again with the knob,
            stages on both ranks, X bit-identical to the same spawn's
            run without it.  After phase capture,
            [stagec.walls] puts the interpreted, stage-compiled and
            captured walls of this call side by side;
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
5d'. wave_dist the distributed wave (dsl/ptg/wave_dist.py) in this
            process: 4 SPMD rank threads on MeshFabric([cuda:0] * 4),
            each building phase main's input on 2 x 2 (its own tiles
            filled) and calling wave(tp, comm=ce).run(): broadcast trees
            (wave_dist_collective=off), the in-process lane (on), the
            lane at wave_reduce_dtype=bf16.  Per
            rank: the wall (a barrier to torch.cuda.synchronize()),
            waves, body calls, its tasks against its CUDA-body tasks,
            its GEMM launches (counted on its thread), the static
            schedule's tiles and bytes sent and received by kind
            (pre-exchange, pushes, returns), lane groups, calls, tiles
            and quantized contributions, mesh-local sends and their
            device-to-device bytes, the sliced pools' stage-in bytes.
            Checks: the factor bit-identical to phase main's for trees
            and the lane; the bf16 lane's max |L - L_main| / max |L_main|
            under 1e-2 with quantized reductions; every rank's tasks on
            cuda:0, GEMM launches on every rank, no stack through the
            host, each rank's pools under the matrix's bytes;
   mesh_chain_2 dtd_chain_2 (below) on MeshFabric([cuda:0] * 2): two
            rank threads with a context each, every hop mesh-local (the
            producer's private device copy), no tile through the host,
            the tile exact as the TCP chain's;
5e. multirank dposv across rank processes on the one card, through the
            entry points a user calls: the script spawns itself as
            ``chip_smoke.py --rank R --nb-ranks N --run RUN`` with
            PARSEC_MCA_comm_transport=tcp, comm_endpoints and comm_rank
            in each rank's environment, and init() wires the TCP comm
            engine.  Runs at N = 16384, NB = 1024, 1024 right-hand sides,
            on phase dposv's input: dposv_2 (2 ranks, A on 2 x 1, B on
            2 x 1, tiles staged through the host over TCP), dposv_4 (4
            ranks, A on 2 x 2, B on 4 x 1) and dposv_2_ipc (dposv_2 with
            the CUDA-IPC device data plane); then dtd_chain_2, one
            1024 x 1024 tile through 64 CUDA-chore hops alternating
            between 2 ranks.  Each rank prints its wall (a barrier, the
            call, torch.cuda.synchronize()), its GEMM launches, its
            device tasks against its local CUDA-body tasks, its wire
            messages and bytes and its plane's pulls, bytes and leaked
            parks, and saves its tiles; the parent (idle on the card
            meanwhile) assembles factor and X: both residuals under
            1e-4, both bit-identical to phase dposv's, every local
            CUDA-body task on the card and GEMM launches on every rank,
            no tile above the short limit staged through the host in the
            IPC run and no park leaked, the chain's value exact.  A rank
            that exits non-zero or passes its 300 s deadline fails the
            phase.  Inside each dposv spawn, after its dposv (and its
            redist moves), the ranks run one distributed-wave dpotrf of
            phase main's input on the run's grid ([wave_dist.<run>]
            lines, as phase wave_dist's): dposv_2 over TCP as host bytes
            (wave_dist_plane=off), dposv_2_ipc over its CUDA-IPC plane
            (no stack through the host, no park left), dposv_4 with its
            ranks in one torch.distributed gloo group (the dist_*
            knobs), so the multi-process lane carries the broadcast
            groups; each factor bit-identical to phase main's;
    redist  inside the dposv_2 and dposv_2_ipc spawns, after each rank's
            timed dposv (the newest versions of A's tiles still on the
            card) and before it saves its tiles, three moves of the
            factor A through collections.redistribute, in this order:
            (b) the whole A from 2 x 1 to 1 x 2 at NB 1024 through the
            collective planner (xfer_collective_redist: coalesced
            alltoall rounds over the TCP wire in dposv_2, over the
            CUDA-IPC plane in dposv_2_ipc), (a) the same move on the DTD
            path, (c) A[100:12100, 200:12200] at NB 1024 on 2 x 1 into a
            12288 x 12288 target at NB 768 on 1 x 2, at offset (50, 0)
            (the fragment walk).  Per move: seconds (barrier to
            barrier), the global redist_bytes and the bytes landed per
            rank, wire messages and bytes, planner rounds and
            transfers, plane pulls, GB/s over the region's bytes; the
            parent assembles each target, bit-identical to the matching
            slice of phase dposv's factor (its tiles above the diagonal:
            the input);
5e'. obs_2  telemetry on two ranks: ONE spawn of two rank processes
            (dposv_2: phase dposv's input, A and B on 2 x 1, TCP, with
            heartbeats every 0.5 s in every run), each running dposv
            with telemetry off, then on (init and fini
            between them; "on" = profile, metrics, obs_flow, obs_live,
            and sde_push to an aggregator the parent serves).  Each rank
            returns per run its wall, GEMM launches, device tasks against
            its CUDA-body tasks and a hash of every local result tile;
            per "on" run its Chrome trace, its exposition's series and
            its clock-offset estimate.  The parent merges the two traces
            (obs.merge_trace_docs), stitches the flows, runs
            distributed_critical_path and per_link_exposed_wait, and
            prints rank 0's wall split into device compute (events), H2D
            and D2H, comm sends and deliveries, the exposed wait on each
            link and the rest, and the walls with telemetry on and off.
            A third run, "tune", sets tune_auto (the self-tuning
            controller on the live monitor's window tick) with
            tune_residual_budget=0, so the codec ladder stays lossless:
            each rank prints its controller's decisions, reverts,
            objective (us a task of host dispatch) and final batch_max,
            prefetch_depth and flush_segments, and the wall against
            "off"; its PARSEC::TUNE::* gauges must be registered.
            Under --profile two more runs split "on": "trace" (profile
            alone) and "counters" (the knobs, no trace).  Checks: factor
            and X bit-identical to phase dposv's in every run; every
            rank's device tasks equal its CUDA-body tasks and
            the GEMM kernel launched on both; every stitched flow has
            both halves; the clock offset under 1 ms; each exposition
            parses and names device, comm, ft and health series; the
            aggregator's fleet /health merge reports both ranks;
5f. ft      dposv (A and B on 2 x 1, the TCP engine, phase dposv's
            generators at N = FT_N = 4096) through ft.run_with_restart over
            its three pools, a snapshot of A and B after every stage
            (pulled from the card) under a temporary directory the phase
            removes: ft_kill_2 (ft_inject kills rank 1 inside stage 1,
            heartbeats every 0.05 s with a 2 s timeout; rank 1 stays
            dark until rank 0 has raised RankFailedError, so the
            heartbeat detector must find the death; fresh rank processes
            resume from the stage-1 snapshot), ft_taskfail_2 (a task
            fault on rank 0 inside stage 2 aborts it, as the strict
            contract does on several ranks; fresh processes resume from
            the stage-2 snapshot), ft_taskfail_1 (the same fault on one
            rank, rolled back in-world into the card-resident
            collections and retried once) and ft_clean_2 (no fault).
            Each rank prints its wall, its snapshots (bytes, D2H and
            .npz seconds), restores, retries, GEMM launches and device
            tasks against its CUDA-body tasks per attempt; each run its
            detector and detection latency, the disk its snapshots took,
            and the factor and X, bit-identical to one rank's dposv at
            that N, with residuals under 1e-4;
5f'. elastic_3 the same dposv on 3 rank processes (A and B on 3 x 1)
            through run_with_restart with an ElasticPolicy under
            ft_elastic=shrink, a snapshot every stage; ft_inject kills
            rank 2 halfway through its stage-1 tasks.  In ONE spawn the
            survivors detect it, agree on members (0, 1), rebuild on
            2 x 1 (world ranks kept), reshard-restore the stage-1
            snapshot (rank 2's shards read from disk) and replay.  The
            recovery wall (rank 2's silence to the survivors' end) is
            printed beside ft_kill_2's, with its parts: detection,
            agreement, rebuild, the reshard-restore (shard load and
            move), replay.  Checks: outcomes ok/ok/InjectedKill, grid
            (0, 1), one resize, reshard bytes > 0, device tasks equal
            CUDA-body tasks in every finished attempt, GEMM launches on
            both survivors after the resize, factor and X bit-identical
            to one rank's dposv at FT_N, residuals under 1e-4;
5g. template a CUDA-body task, a BODY [type=template] task on an
            attached TemplateDevice and a CUDA-body task on one 1024 x
            1024 tile: exact against the plain chain, the template's
            write staged back in;
    collection_ops reduce_all and apply (collections/ops.py) on the
            dpotrf factor held on the card: the host bodies pull it,
            the sum within 1e-4, apply exact;
    bindings the C shim (bindings/) built with the system C compiler
            and a C program run against it: ptc_init on the card
            (cpu,cuda:0), an 8-task DTD chain through the C API, exact;
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
7c. spmd    the same model over meshes of the card's 4 logical chips
            (device_cuda_virtual_chips, a stream each; one thread a
            shard, every collective one autograd node over its group),
            phase forward's seeded parameters: make_forward on dp 2 x tp 2
            (flash), sp 4 (ring), sp 4 (ulysses) and pp 2 (2 stages of 6
            layers, 4 microbatches, flash), one warm-up and 3 batches
            each, seconds, tokens/s, peak memory, launches exact (48 of
            the flash forward, 120 of the stats kernel for the ring: shard
            i runs i + 1 blocks a layer; GPipe skips its bubble ticks),
            the logits within 2e-4 of one chip's with the same attention
            (else each layer and the head on the mesh from one chip's
            input, within 2e-4); make_train_step on dp 2 x tp 2 (flash)
            and sp 4 (ring), a warm-up and 3 steps, the loss falling,
            launches exact per step (48 stats and 48 backward; 120 stats
            and none), the first step's gradients twice (bit-identical)
            and within 1e-3 of one chip's value_and_grad (else each
            layer's VJP on the mesh from one chip's input and cotangent);
            one step of tp 2 x ep 2 with 4 experts, top 2, its loss and
            gradients within 1e-3 of one chip's; then remat on dp 2 x tp 2
            (flash) and sp 4 (ring): one step from the same state with
            remat off and on, the loss, new parameters and Adam moments
            bit-identical, the remat step's launches (the recompute runs
            each layer's forward kernels once more), and the peak memory
            (torch.cuda.max_memory_allocated) of each;
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
9. profile  with --profile only (and rank 0 of multirank dposv_2, in its
            timed run, so that run's wall includes the profiler): the
            dpotrf, DTD Cholesky, dgeqrf and
            pdgemm (both forms) paths, one replay of the captured dpotrf,
            the wave dpotrf at NB = 1024 (stage-in, waves and write-back),
            the pivoted dgetrf, one forward and one flash train step once
            more under torch.profiler, with device time by kernel (the
            A^T copies are the direct-copy kernel) and the device's busy
            share of the wall time; then the GEMM, stats and backward
            kernels and their library yardsticks once each, with the
            device kernels each call runs.

Each phase's seconds (host clock) is a ``[phase_seconds]`` line of its
own, printed when the phase ends.

Any failure raises and exits non-zero; so does a machine where PyTorch
sees no CUDA device.  The line before the last is the kernels' record
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import errno
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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


#: the SPD inputs made (or read) in this process, by (n, seed), newest
#: last: the phases ask for phase main's again and again, and making one
#: at N = 16384 takes seconds of host time
_SPD: dict = {}
SPD_KEEP = 3
#: the environment variable naming the directory where the parent
#: leaves each input its rank processes need (spd_N_SEED.npy)
SPD_DIR_ENV = "CHIP_SMOKE_SPD_DIR"
_spd_dir: list = []


def synth_spd(n: int, seed: int, copy: bool = True) -> np.ndarray:
    """A = (B + B^T)/2 + n I with B uniform in [-0.5, 0.5), in O(n^2):
    a private copy of the one this process keeps (``copy=False``: the
    kept one, read only), made once, or in a rank process read from
    the parent's file."""
    key = (n, seed)
    a = _SPD.pop(key, None)
    if a is None:
        path = os.path.join(os.environ.get(SPD_DIR_ENV, ""),
                            f"spd_{n}_{seed}.npy")
        a = np.load(path) if os.environ.get(SPD_DIR_ENV) \
            and os.path.exists(path) else make_spd(n, seed)
    _SPD[key] = a
    while len(_SPD) > SPD_KEEP:
        _SPD.pop(next(iter(_SPD)))
    return a.copy() if copy else a


def make_spd(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.random((n, n), dtype=np.float32) - np.float32(0.5)
    # (b + b^T) / 2 block by block: the same values as the whole-matrix
    # sum, without its cache-hostile transposed pass
    a = np.empty_like(b)
    t = 512
    for i in range(0, n, t):
        for j in range(0, n, t):
            np.add(b[i:i + t, j:j + t], b[j:j + t, i:i + t].T,
                   out=a[i:i + t, j:j + t])
    a *= np.float32(0.5)
    a[np.diag_indices(n)] += np.float32(n)
    return a


def share_spd(n: int, seed: int) -> dict:
    """Leave synth_spd(n, seed) in a file for rank processes; returns
    the environment that points them at it."""
    import atexit
    if not _spd_dir:
        _spd_dir.append(tempfile.mkdtemp(prefix="chip_smoke_spd_"))
        atexit.register(shutil.rmtree, _spd_dir[0], True)
    path = os.path.join(_spd_dir[0], f"spd_{n}_{seed}.npy")
    if not os.path.exists(path):
        np.save(path + ".part.npy", synth_spd(n, seed, copy=False))
        os.replace(path + ".part.npy", path)
    return {SPD_DIR_ENV: _spd_dir[0]}


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
        if hasattr(dev, "chips"):   # a chip mesh (phase mesh)
            st.update(chip_gemm_launches=list(dev.chip_gemm_launches),
                      resident_per_chip=dev.resident_bytes_per_chip(),
                      mem_budget=dev.mem_budget,
                      chip_ids=[c.id for c in dev.chips],
                      chip_streams=len({c.stream for c in dev.chips}))
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


#: walls of this call, host clock: the interpreted, stage-compiled and
#: captured dpotrf and dposv ([stagec.walls], after phase capture)
WALLS: dict = {}


def phase_main(seed: int, n: int = N_MAIN, nb: int = NB_MAIN):
    """Drive dpotrf at full size; returns the kernel's launches and the
    factor."""
    from parsec_tpu_torch.ops import kernels
    M = synth_spd(n, seed)
    reset_counts()
    L, st, seconds = run_dpotrf(M, nb)
    WALLS["dpotrf_interpreted"] = seconds
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
    WALLS["dposv_interpreted"] = seconds
    launches = kernels.matmul_launches
    mt, nt = A.mt, B.nt
    solve = mt * nt + mt * (mt - 1) // 2 * nt
    report("dposv", st, seconds, n ** 3 / 3 + 2.0 * n * n * nrhs,
           mt * (mt + 1) * (mt + 2) // 6 + 2 * solve,
           mt * (mt - 1) * (mt - 2) // 6 + mt * (mt - 1) // 2
           + mt * (mt - 1) * nt, launches,
           solve_residual(M, X, Bm, seed), RESID_TOL, n=n, nb=nb, nrhs=nrhs)
    return launches, np.tril(L), X


# ---------------------------------------------------------------------- #
# stagec: whole-stage compilation, each stage one recorded CUDA graph    #
# ---------------------------------------------------------------------- #
STAGEC_EXCLUDE = "SYRK"   # (4): the device class left to the residue
STAGEC_CUT_N = 8192       # (4) and (5): their N, cut from N_MAIN
#: the multirank spawns whose ranks run dposv once more with the knob on
STAGEC_IN_SPAWNS = ("dposv_2",)
XRANK_RANKS = 2           # (6): rank threads on loopback TCP, P = 2, Q = 1
XRANK_CORES = 3           # (6): worker threads of each rank's context


def stagec_programs(pools) -> list:
    """Every stage of ``pools``' compilers, with its program's facts."""
    return [row for tp in pools if getattr(tp, "_stagec", None) is not None
            for row in tp._stagec.program_report()]


def stagec_launches(rows, prev=None) -> dict:
    """The GEMM kernel's launches of the stages' programs in this run:
    ``warmup`` and ``captured``, those of the records made in it (each
    counted once through the wrapper: a warm-up ran them, a capture only
    recorded them), ``recorded`` (what the graphs hold), their
    ``replays`` and the launches those replays ran (recorded x replays,
    per program; a replay counts nothing).  ``prev``: the rows of an
    earlier run of the same programs (a cache hit), whose records and
    replays are not this run's."""
    before = {r["stage"]: r for r in (prev or ()) if "replays" in r}
    warm, cap, rec, reps, ran = 0, 0, 0, 0, 0
    for r in rows:
        if "captured_gemm_launches" not in r:
            continue
        p = before.get(r["stage"], {})
        k = r["replays"] - p.get("replays", 0)
        warm += r["warmup_gemm_launches"] - p.get("warmup_gemm_launches", 0)
        cap += (r["captured_gemm_launches"]
                - p.get("captured_gemm_launches", 0))
        rec += r["captured_gemm_launches"]
        reps += k
        ran += r["captured_gemm_launches"] * k
    return dict(warmup=warm, captured=cap, recorded=rec, replays=reps,
                replayed_launches=ran)


def stagec_account(name: str, lc: dict, counter: int,
                   dispatched: int) -> int:
    """Checks that the wrapper's count in one leg is the records'
    warm-ups and captures plus the launches of the device module's
    dispatches (residue bursts; a stage's replay adds none), and returns
    the launches that ran through the wrapper: warm-ups and dispatches."""
    check(counter == lc["warmup"] + lc["captured"] + dispatched,
          f"{name}: the wrapper counted {counter} GEMM launches, not the "
          f"records' {lc['warmup']} warm-up + {lc['captured']} captured "
          f"+ {dispatched} dispatched")
    return lc["warmup"] + dispatched


def stagec_line(phase: str, st: dict, rows: list, seconds: float,
                peak: int, lc: dict, dispatched: int, **extra) -> None:
    facts = [r for r in rows if "record_seconds" in r]
    last = [r["replay_ms"] for r in facts if r["replay_ms"] is not None]
    log(phase, stages=len(rows), stage_tasks=st["stage_tasks"],
        stage_compiles=st["stage_compiles"],
        stage_fallbacks=st["stage_fallbacks"],
        stage_dispatches=st["stage_dispatches"],
        stage_sharded=st["stage_sharded"],
        chain_links=st["chain_links"],
        chain_fallbacks=st["chain_fallbacks"],
        residue_batches=st["residue_batches"],
        residue_batch_tasks=st["residue_batch_tasks"],
        prestage_issued=st["prestage_issued"],
        prestage_hits=st["prestage_hits"],
        warmup_launches=lc["warmup"], captured_launches=lc["captured"],
        dispatched_launches=dispatched, recorded=lc["recorded"],
        replays=lc["replays"], replayed_launches=lc["replayed_launches"],
        record_seconds=f"{sum(r['record_seconds'] for r in facts):.4f}",
        replay_device_ms=f"{sum(last):.3f}",
        seconds=f"{seconds:.4f}", peak_mem_gb=f"{peak / 1e9:.3f}", **extra)
    check(st["stage_fallbacks"] == 0 and st["chain_fallbacks"] == 0,
          f"{phase}: {st['stage_fallbacks']} stage and "
          f"{st['chain_fallbacks']} chain fallbacks")


def stagec_pools(ctx, pools, **kn):
    """Add and wait for ``pools`` on ``ctx`` (the stages' knobs set),
    timed from submission to torch.cuda.synchronize(); returns the
    seconds and the peak device memory of the run."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for tp in pools:
        ctx.add_taskpool(tp)
        ctx.wait()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_stagec(seed: int, L_main: np.ndarray, X_dposv: np.ndarray,
                 n: int = N_MAIN, nb: int = NB_MAIN, nrhs: int = NRHS,
                 profile: bool = False) -> tuple:
    """Legs (1) to (6) of whole-stage compilation (see the module's
    docstring); returns the GEMM kernel's launches through its wrapper
    by leg (the records' warm-ups and the residue's dispatches), and by
    leg the graphs' recorded launches, replays and the launches those
    replays ran."""
    import gc
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.devices.batching import live_stage_entries
    from parsec_tpu_torch.ops import kernels
    launches, graphs = {}, {}
    nt = n // nb
    tasks = nt * (nt + 1) * (nt + 2) // 6
    M = synth_spd(n, seed)
    # (1) and (2): two dpotrf pools on one context, the second a cache hit
    with knobs({"stage_compile": "1"}):
        ctx = ptt.init(nb_cores=4)
        try:
            dev = ctx.device_by_type("cuda")
            prev = None
            for leg in (1, 2):
                A = tiled(M, nb)
                tp = ptt.ops.dpotrf_taskpool(A)
                before = dict(ctx.stage_stats)
                entries = live_stage_entries()
                reset_counts()
                d0 = dev.gemm_launches
                if leg == 2 and profile:
                    from torch.profiler import ProfilerActivity
                    from torch.profiler import profile as tprof
                    with tprof(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                        seconds, peak = stagec_pools(ctx, [tp])
                    profile_report("stagec_dpotrf", prof, seconds)
                else:
                    seconds, peak = stagec_pools(ctx, [tp])
                counter, dispatched = (kernels.matmul_launches,
                                       dev.gemm_launches - d0)
                st = {k: v - before[k] for k, v in ctx.stage_stats.items()}
                rows = stagec_programs([tp])
                plan = tp._stagec.plan
                L = np.tril(A.to_numpy())
                same = bool(np.array_equal(L, L_main))
                del A, L
                name = "stagec.dpotrf" if leg == 1 else "stagec.dpotrf_again"
                WALLS[f"dpotrf_stagec_{leg}"] = seconds
                lc = stagec_launches(rows, prev)
                stagec_line(name, st, rows, seconds, peak, lc, dispatched,
                            n=n, nb=nb, tasks=tasks, staged=plan.n_staged,
                            residue=plan.n_residue,
                            new_cache_entries=live_stage_entries() - entries,
                            identical=same)
                check(same, f"{name}: the factor is not bit-identical to "
                            f"phase main's")
                check(st["stage_tasks"] == tasks,
                      f"{name}: {st['stage_tasks']} of {tasks} tasks staged")
                check(lc["recorded"] > 0 and lc["replays"] > 0,
                      f"{name}: graphs recorded {lc['recorded']} GEMM "
                      f"launches, replayed {lc['replays']} times")
                if leg == 1:
                    check(st["stage_compiles"] > 0 and lc["warmup"] > 0,
                          f"{name}: {st['stage_compiles']} records, the "
                          f"warm-ups launched the GEMM kernel "
                          f"{lc['warmup']} times")
                else:
                    check(st["stage_compiles"] == 0
                          and live_stage_entries() == entries,
                          f"{name}: the second pool recorded "
                          f"{st['stage_compiles']} stages (a cache miss)")
                launches[f"stagec_dpotrf_{leg}"] = stagec_account(
                    name, lc, counter, dispatched)
                graphs[f"stagec_dpotrf_{leg}"] = lc
                prev = rows
                del tp, plan
            # the context's fini drops the programs and plans it used:
            # the graphs' memory pools and static slots go with them
            gc.collect()
            held, entries = torch.cuda.memory_allocated(), live_stage_entries()
        finally:
            ctx.fini()
    del dev, ctx
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_allocated()
    log("stagec.cache", entries=entries, left=live_stage_entries(),
        held_gb=f"{held / 1e9:.3f}", freed_gb=f"{freed / 1e9:.3f}")
    check(entries > 0 and live_stage_entries() == 0 and freed > 0,
          f"stagec.cache: fini left {live_stage_entries()} of {entries} "
          f"entries, freed {freed} of {held} bytes")
    # (3) dposv with the chain on, through ops.dposv
    Bm = uniform(n, nrhs, seed=seed + 10)
    A, B = tiled(M, nb), tiled(Bm, nb)
    with knobs({"stage_compile": "1", "stage_compile_chain": "1"}):
        ctx = ptt.init(nb_cores=4)
        try:
            dev = ctx.device_by_type("cuda")
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ptt.ops.dposv(ctx, A, B)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counter, dispatched = kernels.matmul_launches, dev.gemm_launches
            st = dict(ctx.stage_stats)
            chain = ctx._stage_chain
            rows = stagec_programs(chain._keep if chain is not None else [])
            rejects = list(chain.rejects) if chain is not None else []
            X = B.to_numpy()
        finally:
            ctx.fini()
    same = bool(np.array_equal(X, X_dposv))
    WALLS["dposv_stagec"] = seconds
    lc = stagec_launches(rows)
    stagec_line("stagec.dposv", st, rows, seconds, peak, lc, dispatched,
                n=n, nb=nb, nrhs=nrhs, rejects=len(rejects), identical=same)
    check(same, "stagec.dposv: X is not bit-identical to phase dposv's")
    check(st["chain_links"] > 0, f"stagec.dposv: the chain did not engage "
                                 f"({rejects})")
    check(lc["recorded"] > 0 and lc["replays"] > 0 and lc["warmup"] > 0,
          f"stagec.dposv: {lc}")
    launches["stagec_dposv"] = stagec_account("stagec.dposv", lc, counter,
                                              dispatched)
    graphs["stagec_dposv"] = lc
    del A, B, X, rows, M
    # (4) and (5) at N cut to STAGEC_CUT_N, held against one chip's
    # interpreted factor of the same matrix
    nm = STAGEC_CUT_N
    ntm = nm // nb
    tasks_m = ntm * (ntm + 1) * (ntm + 2) // 6
    Mm = synth_spd(nm, seed + 30)
    reset_counts()
    L1, _st1, one_chip_s = run_dpotrf(Mm, nb)
    # (4) residue-heavy: SYRK left to the residue, as bursts
    A = tiled(Mm, nb)
    with knobs({"stage_compile": "1",
                "stage_compile_exclude": STAGEC_EXCLUDE}):
        ctx = ptt.init(nb_cores=4)
        try:
            dev = ctx.device_by_type("cuda")
            tp = ptt.ops.dpotrf_taskpool(A)
            reset_counts()
            seconds, peak = stagec_pools(ctx, [tp])
            counter, dispatched = kernels.matmul_launches, dev.gemm_launches
            st = dict(ctx.stage_stats)
            rows = stagec_programs([tp])
            plan = tp._stagec.plan
            dev_tasks = dev.stats["tasks"]
            L = np.tril(A.to_numpy())
        finally:
            ctx.fini()
    same = bool(np.array_equal(L, L1))
    lc = stagec_launches(rows)
    stagec_line("stagec.residue", st, rows, seconds, peak, lc, dispatched,
                n=nm, nb=nb, exclude=STAGEC_EXCLUDE, staged=plan.n_staged,
                residue=plan.n_residue,
                residue_groups=len(plan.residue_groups),
                device_tasks=dev_tasks, identical_to_one_chip=same)
    check(same, "stagec.residue: the factor is not bit-identical to the "
                "interpreted one")
    check(st["residue_batches"] > 0 and plan.n_residue > 0
          and st["stage_tasks"] + plan.n_residue == tasks_m
          and dev_tasks == tasks_m,
          f"stagec.residue: {st['residue_batches']} bursts, "
          f"{plan.n_residue} residue, {dev_tasks} device tasks of "
          f"{tasks_m}")
    check(lc["recorded"] > 0 and lc["replays"] > 0 and dispatched > 0,
          f"stagec.residue: {lc} and {dispatched} dispatched launches")
    launches["stagec_residue"] = stagec_account("stagec.residue", lc,
                                                counter, dispatched)
    graphs["stagec_residue"] = lc
    del A, L, rows, plan, tp
    # (5) a 2 x 2 mesh of logical chips
    A = tiled(Mm, nb)
    with knobs({"stage_compile": "1", "device_mesh_shape": MESH_SHAPE,
                "device_cuda_virtual_chips": MESH_CHIPS}):
        ctx = ptt.init(nb_cores=4)
        try:
            dev = ctx.device_by_type("cuda")
            tp = ptt.ops.dpotrf_taskpool(A)
            reset_counts()
            seconds, peak = stagec_pools(ctx, [tp])
            counter, dispatched = kernels.matmul_launches, dev.gemm_launches
            st = dict(ctx.stage_stats)
            rows = stagec_programs([tp])
            device_name = dev.name
            moves = dev.stats["mesh_moves"]
            L = np.tril(A.to_numpy())
        finally:
            ctx.fini()
    same = bool(np.array_equal(L, L1))
    per_chip = [0] * MESH_CHIPS
    for r in rows:
        for c, k in enumerate(r.get("captured_per_chip") or ()):
            per_chip[c] += k * r["replays"]
    lc = stagec_launches(rows)
    stagec_line("stagec.mesh", st, rows, seconds, peak, lc, dispatched,
                n=nm, nb=nb, shape=MESH_SHAPE, chips=MESH_CHIPS,
                device=device_name,
                sharded_stages=sum(1 for r in rows if r.get("sharded")),
                sharded_gemm_launches_by_chip="/".join(map(str, per_chip)),
                mesh_moves=moves, one_chip_seconds=f"{one_chip_s:.4f}",
                identical_to_one_chip=same)
    check(device_name == "cuda:mesh2x2", f"stagec.mesh: ran on {device_name}")
    check(st["stage_sharded"] > 0 and all(k > 0 for k in per_chip),
          f"stagec.mesh: {st['stage_sharded']} sharded dispatches, GEMM "
          f"launches by chip {per_chip}")
    check(st["stage_tasks"] == tasks_m,
          f"stagec.mesh: {st['stage_tasks']} tasks staged")
    check(same, "stagec.mesh: the factor is not bit-identical to one "
                "chip's")
    launches["stagec_mesh"] = stagec_account("stagec.mesh", lc, counter,
                                             dispatched)
    graphs["stagec_mesh"] = dict(lc, sharded_by_chip=per_chip)
    del A, L, rows, Mm, L1
    launches["stagec_xrank"], graphs["stagec_xrank"] = stagec_xrank(
        seed, L_main, n, nb)
    return launches, graphs


def xrank_rank(M: np.ndarray, n: int, nb: int, rank: int, engine,
               barrier) -> dict:
    """Leg (6)'s rank thread: this rank's tiles of ``M`` on the P = 2,
    Q = 1 grid, one stage-compiled dpotrf pool on a context over
    ``engine`` (a TCP engine built with the knobs set), timed from a
    ``barrier`` to torch.cuda.synchronize(), which waits for the barrier
    once more: a device-wide synchronize while the other rank records a
    stage would break its capture.  Every activation this rank
    sends is looked at: one that names a parked payload ("xs") must
    carry no data, handle or xfer.  Returns the rank's record, its owned
    lower tiles pulled to the host under ``tiles``."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.comm import RemoteDepEngine
    from parsec_tpu_torch.comm.engine import TAG_ACTIVATE
    seen = {"xs": 0, "xs_with_payload": 0, "with_data": 0}
    send = engine.send_am

    def watched(dst, tag, msg):
        if tag == TAG_ACTIVATE and isinstance(msg, dict):
            payload = any(msg.get(k) is not None
                          for k in ("data", "handle", "xfer"))
            seen["xs"] += "xs" in msg
            seen["xs_with_payload"] += "xs" in msg and payload
            seen["with_data"] += payload
        return send(dst, tag, msg)

    engine.send_am = watched
    comm = RemoteDepEngine(engine)
    ctx = ptt.Context(nb_cores=XRANK_CORES, comm=comm)
    try:
        A = TwoDimBlockCyclic(n, n, nb, nb, P=XRANK_RANKS, Q=1,
                              nodes=XRANK_RANKS, rank=rank,
                              dtype=np.float32)
        A.name = "descA"
        for (i, j) in A.local_tiles():
            np.copyto(A.tile(i, j),
                      M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        tp = ptt.ops.dpotrf_taskpool(A, rank=rank, nb_ranks=XRANK_RANKS)
        dev = ctx.device_by_type("cuda")
        d0 = dev.gemm_launches
        barrier.wait()
        t0 = time.perf_counter()
        try:
            ctx.add_taskpool(tp)
            ctx.wait()
        except BaseException:
            barrier.abort()   # the other rank stops waiting for this one
            raise
        barrier.wait()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        plan = tp._stagec.plan
        rec = dict(rank=rank, wall=wall, st=dict(ctx.stage_stats),
                   dispatched=dev.gemm_launches - d0,
                   rows=tp._stagec.program_report(),
                   xwaves=len(plan.xwaves), stages=len(plan.stages),
                   elisions=comm.stats["xs_elisions"],
                   activates=comm.stats["activates_sent"], **seen)
        rec["tiles"] = {(i, j): np.asarray(A.data_of(i, j).sync_to_host()
                                           .payload).copy()
                        for (i, j) in A.local_tiles() if i >= j}
    finally:
        ctx.fini()
    return rec


def stagec_xrank(seed: int, L_main: np.ndarray, n: int, nb: int) -> tuple:
    """Leg (6): cross-rank stages over XRANK_RANKS rank threads of this
    process on loopback TCP, one logical lane chip each, on phase main's
    input; the factor held to phase main's bit for bit.  Returns the GEMM
    kernel's launches through its wrapper and the graphs' facts, both
    ranks together."""
    import gc
    from parsec_tpu_torch.comm.tcp import TCPCommEngine, free_ports
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.utils.spmd import spmd_threads
    M = synth_spd(n, seed, copy=False)
    held = torch.cuda.memory_allocated()
    kn = {"stage_compile": "1", "stage_compile_xrank": "1",
          "device_cuda_virtual_chips": XRANK_RANKS}
    with knobs(kn):
        # the "xs" token rides the HELLO: the engines are built with the
        # knob set, in parallel (each constructor dials its peers)
        for attempt in range(5):
            eps = [("127.0.0.1", p) for p in free_ports(XRANK_RANKS)]
            try:
                engines, _ = spmd_threads(
                    XRANK_RANKS, lambda r, _f: TCPCommEngine(r, eps),
                    timeout=RANK_DEADLINE)
                break
            except OSError as exc:
                if exc.errno != errno.EADDRINUSE or attempt == 4:
                    raise
        links = [engines[r].xstage_to(p) for r in range(XRANK_RANKS)
                 for p in range(XRANK_RANKS) if p != r]
        barrier = threading.Barrier(XRANK_RANKS, timeout=RANK_DEADLINE)
        reset_counts()
        t0 = time.perf_counter()
        recs, _ = spmd_threads(
            XRANK_RANKS, lambda r, _f: xrank_rank(M, n, nb, r, engines[r],
                                                  barrier),
            timeout=RANK_DEADLINE)
        seconds = time.perf_counter() - t0
    counter = kernels.matmul_launches
    # the ranks' fini dropped their blocks and plans; a block and its
    # graph runner refer to each other, so the collector frees them
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    L = assemble_tiles(recs, n, nb)
    same = bool(np.array_equal(L, L_main))
    del L
    sts = [r["st"] for r in recs]
    rows = [row for r in recs for row in r["rows"]]
    blocks = [row for row in rows if row.get("xrank")]
    dispatched = sum(r["dispatched"] for r in recs)
    lc = stagec_launches(rows)
    per = lambda key: "/".join(str(s[key]) for s in sts)  # noqa: E731
    nt = n // nb
    log("stagec.xrank", ranks=XRANK_RANKS, grid=f"{XRANK_RANKS}x1", n=n,
        nb=nb, xs_links="/".join(map(str, links)),
        wall="/".join(f"{r['wall']:.4f}" for r in recs),
        run_seconds=f"{seconds:.1f}", xwaves=recs[0]["xwaves"],
        stages="/".join(str(r["stages"]) for r in recs),
        stage_tasks=per("stage_tasks"), xstage_tasks=per("xstage_tasks"),
        xstage_compiles=per("xstage_compiles"),
        stage_compiles=per("stage_compiles"),
        xstage_collective_bytes=per("xstage_collective_bytes"),
        xstage_fallbacks=per("xstage_fallbacks"),
        stage_fallbacks=per("stage_fallbacks"),
        xs_elisions="/".join(str(r["elisions"]) for r in recs),
        activations_sent="/".join(str(r["activates"]) for r in recs),
        activations_with_payload="/".join(str(r["with_data"])
                                          for r in recs),
        elided_with_payload=sum(r["xs_with_payload"] for r in recs),
        warmup_launches=lc["warmup"], captured_launches=lc["captured"],
        dispatched_launches=dispatched, recorded=lc["recorded"],
        replays=lc["replays"], replayed_launches=lc["replayed_launches"],
        block_replayed_launches=sum(b["captured_gemm_launches"]
                                    * b["replays"] for b in blocks),
        record_seconds=f"{sum(r['record_seconds'] for r in rows):.4f}",
        block_record_seconds=f"{sum(b['record_seconds'] for b in blocks):.4f}",
        replay_seconds=f"{sum(r['replay_ms'] or 0 for r in rows) / 1e3:.4f}",
        block_replay_seconds=(
            f"{sum(b['replay_ms'] or 0 for b in blocks) / 1e3:.4f}"),
        left_after_fini_gb=f"{left / 1e9:.3f}", identical=same)
    check(all(links), f"stagec.xrank: \"xs\" was not negotiated both "
                      f"ways ({links})")
    check(all(s["xstage_tasks"] > 0 and s["xstage_compiles"] > 0
              and s["xstage_collective_bytes"] > 0 for s in sts),
          f"stagec.xrank: cross-rank stages did not engage on both ranks "
          f"({per('xstage_tasks')} tasks, {per('xstage_compiles')} "
          f"records)")
    check(all(s["xstage_fallbacks"] == 0 and s["stage_fallbacks"] == 0
              for s in sts),
          f"stagec.xrank: {per('xstage_fallbacks')} cross-rank and "
          f"{per('stage_fallbacks')} stage fallbacks")
    check(sum(s["stage_tasks"] for s in sts)
          == nt * (nt + 1) * (nt + 2) // 6,
          f"stagec.xrank: {per('stage_tasks')} tasks staged")
    check(sum(r["elisions"] for r in recs) > 0
          and sum(r["xs"] for r in recs) > 0
          and sum(r["xs_with_payload"] for r in recs) == 0,
          f"stagec.xrank: {sum(r['elisions'] for r in recs)} elisions, "
          f"{sum(r['xs_with_payload'] for r in recs)} of them with a "
          f"payload on the wire")
    check(same, "stagec.xrank: the factor is not bit-identical to phase "
                "main's")
    check(left < 1 << 30, f"stagec.xrank: the ranks' fini left {left} "
                          f"bytes allocated on the card")
    check(sum(b["captured_gemm_launches"] for b in blocks) > 0
          and all(b["replays"] >= 1 for b in blocks),
          f"stagec.xrank: the blocks recorded "
          f"{sum(b['captured_gemm_launches'] for b in blocks)} GEMM "
          f"launches over {len(blocks)} blocks")
    return stagec_account("stagec.xrank", lc, counter, dispatched), \
        dict(lc, blocks=len(blocks))


def rank_stagec(ctx, args, B_ref) -> dict:
    """Leg (7) of phase stagec, inside a multirank spawn: this rank's
    share of dposv once more on fresh inputs with stage_compile on; X
    (its B tiles) against the same spawn's run without it."""
    import parsec_tpu_torch as ptt
    nb_ranks, (P, Q), PB, _ = MULTIRANK_RUNS[args.run]
    rank = ctx.rank
    A, B = rank_inputs(args, rank, nb_ranks, (P, Q), PB)
    before = dict(ctx.stage_stats)
    ctx.comm.ce.sync()
    with knobs({"stage_compile": "1"}):
        t0 = time.perf_counter()
        ptt.ops.dposv(ctx, A, B, rank=rank, nb_ranks=nb_ranks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = {k: v - before[k] for k, v in ctx.stage_stats.items()}
    same = all(np.array_equal(
        np.asarray(B.data_of(*c).sync_to_host(ctx.devices).payload),
        np.asarray(B_ref.data_of(*c).sync_to_host(ctx.devices).payload))
        for c in B.tiles() if B.rank_of(*c) == rank)
    rejects = (len(ctx._stage_chain.rejects)
               if ctx._stage_chain is not None else 0)
    return dict(wall=wall, identical=bool(same), chain_rejects=rejects,
                **{k: st[k] for k in ("stage_tasks", "stage_compiles",
                                      "stage_fallbacks", "chain_links",
                                      "chain_fallbacks", "stage_dispatches",
                                      "residue_batches")})


# ---------------------------------------------------------------------- #
# batch semantics: a grouped dispatch keeps each body's single-tile       #
# meaning                                                                #
# ---------------------------------------------------------------------- #
PROBE_TASKS = 16
PROBE_RTOL = 1e-5      # each tile against numpy in fp64, relative max
PROBE_JDF = """
descA [ type="collection" ]
NT [ type="int" ]

T(k)

k = 0 .. NT-1

: descA( k, 0 )

RW A <- descA( k, 0 )
     -> descA( k, 0 )

BODY [type=cuda]
{
    A = A - A * A.sum()
}
END
"""


def probe_report(path: str, got: np.ndarray, want: np.ndarray, nb: int,
                 **extra) -> None:
    """One path's line: its worst tile's relative max error against
    numpy in fp64, then the check."""
    errs = []
    for k in range(PROBE_TASKS):
        g = got[k * nb:(k + 1) * nb].astype(np.float64)
        w = want[k * nb:(k + 1) * nb]
        errs.append(float(np.abs(g - w).max() / np.abs(w).max()))
    log("batch_semantics", path=path, tasks=PROBE_TASKS, **extra,
        max_rel_err=max(errs))
    check(max(errs) <= PROBE_RTOL,
          f"batch_semantics {path}: relative error {max(errs)} > "
          f"{PROBE_RTOL}")


def phase_batch_semantics(seed: int, nb: int = NB_MAIN) -> None:
    """16 independent A = A - A * A.sum() tasks at device_batch_max 16
    through interpreted PTG, DTD and the wave engine on cuda:0, each
    tile held against numpy in fp64 (the body sums ITS tile: a body run
    once over the stacked tiles would sum all 16)."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch import dtd, ptg
    from parsec_tpu_torch.dsl.dtd import INOUT, unpack_args
    from parsec_tpu_torch.utils.params import params
    M = uniform(PROBE_TASKS * nb, nb, seed=seed + 50)
    want = M.astype(np.float64)
    for k in range(PROBE_TASKS):
        t = want[k * nb:(k + 1) * nb]
        t -= t * t.sum()
    with params.cmdline_override("device_batch_max", str(PROBE_TASKS)):
        # one worker: the submitting thread accumulates the burst
        ctx = ptt.init(nb_cores=1)
        try:
            A = tiled(M, nb)
            ctx.add_taskpool(ptg.compile_jdf(PROBE_JDF, name="probe").new(
                NT=PROBE_TASKS, descA=A))
            ctx.wait()
            dev = ctx.device_by_type("cuda")
            for (m, n) in A.tiles():
                A.data_of(m, n).sync_to_host(ctx.devices)
            st = dict(dev.stats)
            check(dev.name == "cuda:0" and st["tasks"] == PROBE_TASKS,
                  f"batch_semantics ptg: {st['tasks']} tasks on {dev.name}")
            check(st["batches"] > 0, "batch_semantics ptg: no task grouped")
            probe_report("ptg", A.to_numpy(), want, nb,
                         batches=st["batches"],
                         batched_tasks=st["batched_tasks"],
                         stack_bytes=st["stack_bytes"])
        finally:
            ctx.fini()
        ctx = ptt.init(nb_cores=1)
        try:
            tp = dtd.taskpool_new("probe")
            ctx.add_taskpool(tp)

            def body(es, task):   # host body: the boot task's
                (x,) = unpack_args(task)
                x -= x * x.sum()

            tp.insert_task(body, (tp.tile_of_array(
                np.zeros((nb, nb), np.float32)), INOUT))
            tp.add_chore(body, "cuda", lambda x: x - x * x.sum())
            tiles = [tp.tile_of_array(M[k * nb:(k + 1) * nb].copy())
                     for k in range(PROBE_TASKS)]
            for t in tiles:
                tp.insert_task(body, (t, INOUT))
            tp.data_flush_all()
            tp.wait()
            dev = ctx.device_by_type("cuda")
            st = dict(dev.stats)
            check(st["tasks"] >= PROBE_TASKS and st["batches"] > 0,
                  f"batch_semantics dtd: {st['tasks']} device tasks, "
                  f"{st['batches']} groups")
            probe_report("dtd", np.concatenate(
                [np.asarray(t.data.get_copy(0).payload) for t in tiles]),
                want, nb, batches=st["batches"],
                batched_tasks=st["batched_tasks"],
                stack_bytes=st["stack_bytes"])
        finally:
            ctx.fini()
    A = tiled(M, nb)
    w = ptg.wave(ptg.compile_jdf(PROBE_JDF, name="probe").new(
        NT=PROBE_TASKS, descA=A))
    w.run()
    torch.cuda.synchronize()
    check(str(w.device) == "cuda:0" and w.stats["tasks"] == PROBE_TASKS,
          f"batch_semantics wave: {w.stats['tasks']} tasks on {w.device}")
    probe_report("wave", A.to_numpy(), want, nb, waves=w.stats["waves"],
                 body_calls=w.stats["kernel_calls"])


# ---------------------------------------------------------------------- #
# obs: telemetry on one rank                                             #
# ---------------------------------------------------------------------- #
def copy_report(phase: str, ivs) -> None:
    """The H2D and D2H copies of a rank's trace intervals: event-timed
    copy seconds (``dev:xfer_*``) beside the host's waits before them
    (``dev:wait_*``) and the host's whole spans (their sum)."""
    for d, name in (("in", "h2d"), ("out", "d2h")):
        xs = [iv for iv in ivs if iv.name == f"dev:xfer_{d}"]
        copy_s = sum(iv.duration for iv in xs) / 1e6
        wait_s = sum(iv.duration for iv in ivs
                     if iv.name == f"dev:wait_{d}") / 1e6
        host_s = copy_s + wait_s
        log(phase, copies=name, n=len(xs),
            bytes=sum(iv.args["bytes"] for iv in xs),
            copy_seconds=f"{copy_s:.6f}", host_wait_seconds=f"{wait_s:.6f}",
            copy_share_of_host_span=(f"{copy_s / host_s:.4f}"
                                     if host_s > 0 else "n/a"))


def busy_intervals(ivs) -> list:
    """The ``dev:busy`` spans of a rank's trace: (start, end) µs."""
    return sorted((iv.begin, iv.end) for iv in ivs if iv.name == "dev:busy")


def check_busy(phase: str, ivs, wall_s: float) -> float:
    """The dispatch intervals disjoint on the one stream, their sum
    positive and within the wall; returns the sum in seconds."""
    busy = busy_intervals(ivs)
    overlaps = sum(1 for a, b in zip(busy, busy[1:]) if b[0] < a[1])
    busy_s = sum(e - b for b, e in busy) / 1e6
    log(phase, dispatches=len(busy), busy_seconds=f"{busy_s:.6f}",
        wall_seconds=f"{wall_s:.6f}", busy_share=f"{busy_s / wall_s:.4f}",
        overlapping_intervals=overlaps)
    check(overlaps == 0, f"{phase}: {overlaps} dispatch intervals overlap")
    check(0 < busy_s <= wall_s, f"{phase}: busy {busy_s} s, wall {wall_s} s")
    return busy_s


def split_report(phase: str, split: dict) -> None:
    wall = split["wall_us"]
    parts = {k[:-3]: v for k, v in split.items()
             if k.endswith("_us") and k != "wall_us"
             and not isinstance(v, dict)}
    log(phase, wall_seconds=f"{wall / 1e6:.6f}",
        **{f"{k}_seconds": f"{v / 1e6:.6f}" for k, v in parts.items()},
        **{f"{k}_share": f"{v / wall:.4f}" for k, v in parts.items()})
    for link, us in split["exposed_wait_us"].items():
        log(phase, link=link, exposed_wait_seconds=f"{us / 1e6:.6f}",
            share=f"{us / wall:.4f}")


def phase_obs(seed: int, L_ref: np.ndarray, n: int = N_MAIN,
              nb: int = NB_MAIN, profile: bool = False) -> int:
    """dpotrf at main's size and input with profile=True and metrics
    on; returns the GEMM kernel's launches."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch import obs
    from parsec_tpu_torch.obs.critpath import load_trace_intervals
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.utils.params import params
    M = synth_spd(n, seed)
    A = tiled(M, nb)
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
    with params.cmdline_override("metrics", "1"):
        ctx = ptt.init(nb_cores=4, profile=True)
        try:
            dev = ctx.device_by_type("cuda")
            reset_counts()
            with prof:
                t0 = time.monotonic_ns()
                ptt.ops.dpotrf(ctx, A)
                torch.cuda.synchronize()
                t1 = time.monotonic_ns()
            launches = kernels.matmul_launches
            tasks = dev.stats["tasks"]
            for (m, k) in A.tiles():
                A.data_of(m, k).sync_to_host(ctx.devices)
            dev._obs.flush()   # the pulls' events
            ctx.stamp_profile_meta()
            doc = ctx.profile.to_chrome_trace()
            expo = obs.parse_exposition(ctx.obs.render_prometheus())
        finally:
            ctx.fini()
    same = bool(np.array_equal(np.tril(A.to_numpy()), L_ref))
    summary = obs.validate_chrome_trace(doc)
    rep = obs.analyze([doc])
    for line in obs.format_report(rep).splitlines():
        print(f"[obs] report | {line}", flush=True)
    ivs = load_trace_intervals(doc)
    busy_s = check_busy("obs", ivs, (t1 - t0) / 1e9)
    t0_tr = doc["metadata"]["trace_t0_ns"]
    split_report("obs.split", obs.rank_wall_split(
        ivs, 0, (t0 - t0_tr) / 1e3, (t1 - t0_tr) / 1e3))
    copy_report("obs", ivs)
    ov = rep["overlap"][0]
    log("obs", device=dev.name, tasks=tasks, matmul_launches=launches,
        trace_spans=summary["spans"], trace_events=summary["events"],
        series=len(expo), overlap_fraction=f"{ov['overlap_fraction']:.4f}",
        factor_identical=same)
    check(dev.name == "cuda:0" and launches > 0,
          f"obs: ran on {dev.name}, {launches} GEMM launches")
    check(rep["device"][0]["busy_us"] > 0, "obs: no device-busy span")
    check(same, "obs: the factor differs from main's")
    check(any(k[0].startswith("parsec_device_cuda_0") for k in expo),
          "obs: the exposition names no device series")
    if profile:
        prof_busy = profile_report("obs_dpotrf", prof, (t1 - t0) / 1e9)
        log("obs", events_busy_share=f"{busy_s / ((t1 - t0) / 1e9):.4f}",
            profiler_busy_share=f"{prof_busy / 1e6 / ((t1 - t0) / 1e9):.4f}")
    return launches


# ---------------------------------------------------------------------- #
# multirank: rank processes over the TCP comm engine                     #
# ---------------------------------------------------------------------- #
#: run -> (ranks, A grid P x Q, B grid P, device data plane)
MULTIRANK_RUNS = {"dposv_2": (2, (2, 1), 2, False),
                  "dposv_4": (4, (2, 2), 4, False),
                  "dposv_2_ipc": (2, (2, 1), 2, True)}
DTD_HOPS = 64
RANK_DEADLINE = 300.0    # seconds a rank process may take
#: the runs whose ranks also move the factor between distributions
#: (phase redist), after the timed dposv and before saving their tiles
REDIST_RUNS = ("dposv_2", "dposv_2_ipc")
#: the runs whose ranks then run one distributed-wave dpotrf of phase
#: main's input (A on the run's grid), each with its knobs: dposv_2 moves
#: the exchanged tiles as host bytes over TCP, dposv_2_ipc over the
#: CUDA-IPC plane its ranks attached, dposv_4 joins a torch.distributed
#: (gloo) group at init(), so the multi-process lane engages under auto
WAVE_IN_SPAWNS = {"dposv_2": {"wave_dist_plane": "off"},
                  "dposv_2_ipc": {}, "dposv_4": {}}
GLOO_RUNS = ("dposv_4",)
#: phase wave_dist: 4 rank threads of this process on
#: MeshFabric([cuda:0] * 4), A on 2 x 2, the runs: broadcast trees, the
#: in-process lane, the lane quantizing its contributions to bf16
WAVE_DIST_RANKS, WAVE_DIST_GRID = 4, (2, 2)
WAVE_DIST_RUNS = (("trees", {"wave_dist_collective": "off"}),
                  ("lane", {"wave_dist_collective": "on"}),
                  ("lane_bf16", {"wave_dist_collective": "on",
                                 "wave_reduce_dtype": "bf16"}))
#: the bf16 lane's bound on max |L - L_exact| / max |L_exact|, L_exact
#: phase main's factor (the JAX package's tests/test_quantize.py:255-295)
WAVE_BF16_TOL = 1e-2


def local_cuda_tasks(pools, rank: int, cuda_only: bool = True) -> int:
    """Tasks of ``pools`` placed on ``rank`` whose class has a CUDA body
    (every class's with ``cuda_only=False``)."""
    n = 0
    for tp in pools:
        for tc in tp.task_classes:
            if cuda_only and not any(c.device_type == "cuda"
                                     for c in tc.incarnations):
                continue
            n += sum(1 for loc in tc.iter_space()
                     if tc.rank_of_instance(tc.env_of(loc)) == rank)
    return n


#: the input matrix inside a rank process, synthesised once: its dposv
#: and its distributed wave read the same one
def rank_matrix(n: int, seed: int) -> np.ndarray:
    """synth_spd(n, seed) as this rank process keeps it (read only)."""
    return synth_spd(n, seed, copy=False)


def rank_inputs(args, rank: int, nb_ranks: int, grid, PB: int):
    """This rank's share of phase dposv's input: A on ``grid``, B on
    PB x 1, only the local tiles filled."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    n, nb = args.n, args.nb
    M = rank_matrix(n, args.seed)
    Bm = uniform(n, args.nrhs, seed=args.seed + 10)

    def dist(src, p, q):
        d = TwoDimBlockCyclic(src.shape[0], src.shape[1], nb, nb, P=p, Q=q,
                              nodes=nb_ranks, rank=rank, dtype=np.float32)
        for (i, j) in d.local_tiles():
            np.copyto(d.tile(i, j), src[i * nb:(i + 1) * nb,
                                        j * nb:(j + 1) * nb])
        return d

    A, B = dist(M, *grid), dist(Bm, PB, 1)
    A.name, B.name = "descA", "descB"
    return A, B


def save_tiles(ctx, out: str, A, B) -> None:
    """This rank's factor (lower tiles) and X, pulled through the device
    module, one .npy a tile under ``out``."""
    for name, d in (("A", A), ("B", B)):
        for (i, j) in d.local_tiles():
            if name == "A" and i < j:
                continue   # the factor is the lower triangle
            host = d.data_of(i, j).sync_to_host(ctx.devices)
            np.save(os.path.join(out, f"{name}_{i}_{j}.npy"),
                    np.asarray(host.payload))


def redist_region(n: int, nb: int):
    """Move (c) at N = 16384, NB = 1024: A[100:12100, 200:12200] into a
    12288 x 12288 target at NB 768, at target offset (50, 0); the same
    proportions at a smaller n (the CPU rehearsal).  Returns (disi_Y,
    disj_Y, rows, cols, target n, target NB, disi_T, disj_T)."""
    def sc(x):
        return x * n // N_MAIN
    return (sc(100), sc(200), sc(12000), sc(12000), sc(12288), 3 * nb // 4,
            sc(50), 0)


def rank_redist(ctx, args, A, dp) -> dict:
    """Phase redist on this rank, after the timed dposv while the newest
    versions of A's tiles may still be on the card: (b) the whole A from
    2 x 1 to 1 x 2 at the same NB through the collective planner
    (xfer_collective_redist on; the TCP wire, or the IPC plane where one
    is attached), (a) the same move on the DTD path, (c) a sub-region
    into a target of another size, tile and offset (the fragment walk).
    Each move is timed from a barrier to a barrier and reports the
    global ``redist_bytes``, the bytes landed here, the wire messages and
    bytes this rank sent, the planner's rounds and transfers, the plane's
    pulls.  Saves (b)'s and (c)'s local tiles (as Rb_*, Rc_*); (a)'s must
    equal (b)'s, tile for tile."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic, redistribute
    from parsec_tpu_torch.utils.params import params
    rank, n, nb = ctx.rank, args.n, args.nb
    ce = ctx.comm.ce
    iy, jy, rows, cols, tn, tnb, it, jt = redist_region(n, nb)

    def target(lm, tb, name):
        T = TwoDimBlockCyclic(lm, lm, tb, tb, P=1, Q=2, nodes=2, rank=rank,
                              dtype=np.float32)
        T.name = name
        return T

    def move(T, region, planner):
        sent0 = (ce.fabric.msg_count, ce.fabric.bytes_count)
        pulls0 = dp.stats["pulls"] if dp is not None else 0
        ce.sync()
        t0 = time.perf_counter()
        with params.cmdline_override("xfer_collective_redist",
                                     "1" if planner else "0"):
            tp = redistribute(A, T, *region, context=ctx)
        ce.sync()
        seconds = time.perf_counter() - t0
        return dict(seconds=seconds, redist_bytes=tp.redist_bytes,
                    landed_bytes=sum(int(np.prod(T.tile_shape(*c))) * 4
                                     for c in T.local_tiles()),
                    msgs=ce.fabric.msg_count - sent0[0],
                    bytes=ce.fabric.bytes_count - sent0[1],
                    planned=hasattr(tp, "plan_digest"),
                    rounds=getattr(tp, "redist_rounds", 0),
                    transfers=getattr(tp, "redist_transfers", 0),
                    plane_pulls=(dp.stats["pulls"] - pulls0
                                 if dp is not None else 0))

    def host(T, c):
        return np.asarray(T.data_of(*c).sync_to_host(ctx.devices).payload)

    whole = (n, n, 0, 0, 0, 0)
    Tb, Ta = target(n, nb, "redist_b"), target(n, nb, "redist_a")
    Tc = target(tn, tnb, "redist_c")
    out = {"b": move(Tb, whole, True), "a": move(Ta, whole, False),
           "c": move(Tc, (rows, cols, iy, jy, it, jt), False)}
    out["a_equals_b"] = all(np.array_equal(host(Ta, c), host(Tb, c))
                            for c in Tb.local_tiles())
    for name, T in (("Rb", Tb), ("Rc", Tc)):
        for (i, j) in T.local_tiles():
            np.save(os.path.join(args.out, f"{name}_{i}_{j}.npy"),
                    host(T, (i, j)))
    return out


def rank_dposv(ctx, args, plane: bool) -> dict:
    """One rank's share of dposv at phase dposv's size and input."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.ops import kernels
    nb_ranks, (P, Q), PB, _ = MULTIRANK_RUNS[args.run]
    rank = ctx.rank
    A, B = rank_inputs(args, rank, nb_ranks, (P, Q), PB)
    expected = local_cuda_tasks(
        [ptt.ops.dpotrf_taskpool(A, rank=rank, nb_ranks=nb_ranks),
         ptt.ops.dtrsm_lower_taskpool(A, B, rank=rank, nb_ranks=nb_ranks),
         ptt.ops.dtrsm_lower_trans_taskpool(A, B, rank=rank,
                                            nb_ranks=nb_ranks)], rank)
    dp = None
    if plane:
        from parsec_tpu_torch.comm import DeviceDataPlane
        dp = DeviceDataPlane(ctx.comm.ce, device=ctx.device_by_type("cuda"))
        dp.exchange()
    dev = ctx.device_by_type("cuda")
    ce = ctx.comm.ce
    # --profile: rank 0 of dposv_2 runs its share under torch.profiler
    prof = contextlib.nullcontext()
    if args.profile and rank == 0 and args.run == "dposv_2":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    ce.sync()
    reset_counts()
    with prof:
        t0 = time.perf_counter()
        ptt.ops.dposv(ctx, A, B, rank=rank, nb_ranks=nb_ranks)
        if dev.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not isinstance(prof, contextlib.nullcontext):
        profile_report(f"multirank_{args.run}_rank{rank}", prof, wall)
    out = dict(wall=wall, matmul_launches=kernels.matmul_launches,
               device=dev.name, device_tasks=dev.stats["tasks"],
               local_cuda_tasks=expected, msgs=ce.fabric.msg_count,
               bytes=ce.fabric.bytes_count,
               host_staged_bytes=ctx.comm.stats["host_staged_bytes"],
               rendezvous_host=ctx.comm.stats["rendezvous_host"],
               plane_sends=ctx.comm.stats["plane_sends"],
               stage_in_bytes=dev.stats["stage_in_bytes"],
               stage_out_bytes=dev.stats["stage_out_bytes"])
    if dp is not None:
        out.update(plane_pulls=dp.stats["pulls"],
                   plane_bytes=dp.stats["bytes_pulled"],
                   leaked_parks=dp.leaked_parks,
                   plane_backend=dp.backend_name)
    if args.run in STAGEC_IN_SPAWNS:
        out["stagec"] = rank_stagec(ctx, args, B)
    if args.run in REDIST_RUNS:
        out["redist"] = rank_redist(ctx, args, A, dp)
        if dp is not None:
            out["leaked_parks"] = dp.leaked_parks
    if args.run in WAVE_IN_SPAWNS:
        out["wave"] = rank_wave(ctx, args, dp)
    save_tiles(ctx, args.out, A, B)
    return out


def rank_dtd_chain(ctx, args) -> dict:
    """One 1024 x 1024 tile homed on rank 0 through DTD_HOPS tasks
    alternating between the 2 ranks, each a CUDA chore adding 1."""
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.collections import DictCollection
    from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, INPUT
    rank, nb = ctx.rank, args.nb
    dev = ctx.device_by_type("cuda")

    def coll(name, key, owner, shape):
        c = DictCollection(nodes=2, rank=rank)
        c.name = name
        c.add(key, owner, np.zeros(shape, np.float32)
              if owner == rank else None)
        return c

    tile_c = coll("C", "x", 0, (nb, nb))
    anchors = [coll(f"anchor{r}", "a", r, (1, 1)) for r in range(2)]
    boots = [coll(f"boot{r}", "b", r, (1, 1)) for r in range(2)]
    tp = dtd.taskpool_new("dtd_chain")
    ctx.add_taskpool(tp)
    n_boot = 1           # this rank's own boot task: insertion index 0

    def hop(es, task):
        if task.locals[0] >= n_boot:
            raise RuntimeError(f"{task.snprintf()} ran its host body")

    for r in range(2):   # every rank creates the class with a boot task
        tp.insert_task(hop, (tp.tile_of(boots[r], "b"), INOUT),
                       (tp.tile_of(anchors[r], "a"), INPUT | AFFINITY))
    tp.add_chore(hop, "cuda", lambda x, a: x + 1.0)
    ctx.comm.ce.sync()
    tile = tp.tile_of(tile_c, "x")
    t0 = time.perf_counter()
    for k in range(DTD_HOPS):
        tp.insert_task(hop, (tile, INOUT),
                       (tp.tile_of(anchors[k % 2], "a"), INPUT | AFFINITY))
    tp.data_flush_all()
    tp.wait()
    if dev.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(wall=wall, device=dev.name, device_tasks=dev.stats["tasks"],
               local_cuda_tasks=DTD_HOPS // 2, msgs=ctx.comm.ce.fabric.msg_count,
               bytes=ctx.comm.ce.fabric.bytes_count)
    if rank == 0:
        from parsec_tpu_torch.data.data import to_host_array
        # the home copy may hold a tensor handed over device to device
        x = to_host_array(tile_c.data_of("x").get_copy(0).payload)
        out["exact"] = bool(np.all(x == np.float32(DTD_HOPS)))
    return out


@contextlib.contextmanager
def knobs(kv: dict):
    """The port's knobs set for a block (the process's registry, shared
    by its rank threads), restored after."""
    from parsec_tpu_torch.utils.params import params
    with contextlib.ExitStack() as stack:
        for k, v in kv.items():
            stack.enter_context(params.cmdline_override(k, str(v)))
        yield


def wave_dist_rank(M: np.ndarray, n: int, nb: int, rank: int, nb_ranks: int,
                   grid, comm, sync) -> dict:
    """One rank's distributed-wave dpotrf of ``M`` at NB ``nb``, A on
    ``grid`` with only this rank's tiles filled: ``wave(tp, comm=comm)``,
    then ``run()`` on cuda:0 from ``sync()`` (a barrier) to
    ``torch.cuda.synchronize()``.  Returns the rank's record, its owned
    lower tiles pulled to the host under ``tiles``."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.ops import kernels
    A = TwoDimBlockCyclic(n, n, nb, nb, P=grid[0], Q=grid[1],
                          nodes=nb_ranks, rank=rank, dtype=np.float32)
    A.name = "descW"
    for (i, j) in A.local_tiles():
        np.copyto(A.tile(i, j), M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
    tp = ptt.ops.dpotrf_taskpool(A, rank=rank, nb_ranks=nb_ranks)
    expected = local_cuda_tasks([tp], rank)
    w = ptt.ptg.wave(tp, comm=comm)
    ce = getattr(comm, "ce", comm)
    sent0 = getattr(ce, "d2d_sent_bytes", 0)
    sync()
    l0 = kernels.thread_matmul_launches()
    t0 = time.perf_counter()
    w.run()
    if w.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = w.stats
    rec = dict(rank=rank, wall=wall, device=str(w.device),
               waves=st["waves"], kernel_calls=st["kernel_calls"],
               local_tasks=st["local_tasks"], local_cuda_tasks=expected,
               matmul_launches=kernels.thread_matmul_launches() - l0,
               stage_in_bytes=w.stage_in_bytes,
               local_tiles=st["local_tiles"], sched=w.schedule_summary(),
               lane=st["collective_lane"],
               lane_calls=st["collective_calls"],
               lane_joins=st["collective_joins"],
               lane_tiles=st["collective_tiles"],
               quantized=st["collective_quantized"],
               reduce_dtype=st["collective_reduce_dtype"],
               messages=st["messages_sent"], tiles_sent=st["tiles_sent"],
               tiles_recv=st["tiles_recv"],
               tiles_forwarded=st["tiles_forwarded"],
               mesh_local_sends=st["mesh_local_sends"],
               plane_sends=st["plane_sends"], host_sends=st["host_sends"],
               device_plane=st["device_plane"],
               d2d_bytes=getattr(ce, "d2d_sent_bytes", 0) - sent0)
    t1 = time.perf_counter()
    rec["tiles"] = {(i, j): np.asarray(A.data_of(i, j).sync_to_host()
                                       .payload).copy()
                    for (i, j) in A.local_tiles() if i >= j}
    rec["pull_seconds"] = time.perf_counter() - t1
    return rec


def rank_wave(ctx, args, dp) -> dict:
    """Inside a dposv spawn, after its dposv: one distributed-wave dpotrf
    of phase main's input on the run's grid, with WAVE_IN_SPAWNS' knobs;
    the owned factor tiles saved as W_i_j.npy under ``args.out``."""
    nb_ranks, grid, _PB, _plane = MULTIRANK_RUNS[args.run]
    M = rank_matrix(args.n, args.seed)
    pulls0 = dp.stats["pulls"] if dp is not None else 0
    with knobs(WAVE_IN_SPAWNS[args.run]):
        rec = wave_dist_rank(M, args.n, args.nb, ctx.rank, nb_ranks, grid,
                             ctx.comm, ctx.comm.ce.sync)
    for (i, j), t in rec.pop("tiles").items():
        np.save(os.path.join(args.out, f"W_{i}_{j}.npy"), t)
    if dp is not None:
        rec.update(plane_pulls=dp.stats["pulls"] - pulls0,
                   leaked_parks=dp.leaked_parks)
    return rec


def wave_dist_lines(phase: str, recs: list, n: int) -> None:
    """One line per rank of a distributed-wave run, then its checks:
    every local task on cuda:0 and of a class with a CUDA body, the GEMM
    kernel launched on every rank, the sliced pools under the matrix."""
    for r in recs:
        sc = r["sched"]
        log(phase, rank=r["rank"], device=r["device"],
            wall=f"{r['wall']:.4f}", waves=r["waves"],
            kernel_calls=r["kernel_calls"], local_tasks=r["local_tasks"],
            local_cuda_tasks=r["local_cuda_tasks"],
            matmul_launches=r["matmul_launches"],
            **{f"{k}_sent": f"{sc[k]['sent']}/{sc[k]['sent_bytes']}"
               for k in ("pre", "push", "return")},
            **{f"{k}_recv": f"{sc[k]['recv']}/{sc[k]['recv_bytes']}"
               for k in ("pre", "push", "return")},
            lane=r["lane"], lane_groups=sc["lane"]["groups"],
            lane_calls=r["lane_calls"], lane_joins=r["lane_joins"],
            lane_tiles=r["lane_tiles"], quantized=r["quantized"],
            messages=r["messages"], tiles_sent=r["tiles_sent"],
            tiles_recv=r["tiles_recv"],
            tiles_forwarded=r["tiles_forwarded"],
            mesh_local_sends=r["mesh_local_sends"],
            d2d_bytes=r["d2d_bytes"], plane_sends=r["plane_sends"],
            plane_pulls=r.get("plane_pulls", 0),
            leaked_parks=r.get("leaked_parks", 0),
            host_sends=r["host_sends"], local_tiles=r["local_tiles"],
            stage_in_bytes=r["stage_in_bytes"],
            pull_seconds=f"{r['pull_seconds']:.4f}")
        check(r["device"] == "cuda:0",
              f"{phase}: rank {r['rank']} ran on {r['device']}")
        check(r["local_tasks"] == r["local_cuda_tasks"],
              f"{phase}: rank {r['rank']} ran {r['local_tasks']} tasks on "
              f"the card of its {r['local_cuda_tasks']} CUDA-body tasks")
        check(r["matmul_launches"] > 0,
              f"{phase}: rank {r['rank']} launched the GEMM kernel no time")
        check(r["stage_in_bytes"] < n * n * 4,
              f"{phase}: rank {r['rank']} staged {r['stage_in_bytes']} "
              f"bytes, not under the matrix's {n * n * 4}")


def assemble_tiles(recs: list, n: int, nb: int) -> np.ndarray:
    out = np.zeros((n, n), np.float32)
    for r in recs:
        for (i, j), t in r.pop("tiles").items():
            out[i * nb:i * nb + t.shape[0], j * nb:j * nb + t.shape[1]] = t
    return np.tril(out)


def phase_wave_dist(seed: int, L_main: np.ndarray, n: int = N_MAIN,
                    nb: int = NB_MAIN, profile: bool = False) -> dict:
    """The distributed wave in this process: WAVE_DIST_RANKS rank threads
    on MeshFabric([cuda:0] * 4) (exchanged stacks handed over device to
    device), A on WAVE_DIST_GRID, phase main's input; each WAVE_DIST_RUNS
    run's factor assembled and held to phase main's: bit-identical for
    trees and the lane, within WAVE_BF16_TOL with quantized reductions
    for the bf16 lane.  Under --profile the lane run runs under
    torch.profiler (the busy share).  Returns each run's GEMM launches
    by rank."""
    from parsec_tpu_torch.comm import MeshFabric
    from parsec_tpu_torch.utils.spmd import spmd_threads
    M = synth_spd(n, seed)
    dev = torch.device("cuda", 0)
    launches = {}
    for name, kv in WAVE_DIST_RUNS:
        fabric = MeshFabric(devices=[dev] * WAVE_DIST_RANKS)

        def rank_fn(r, f):
            return wave_dist_rank(M, n, nb, r, WAVE_DIST_RANKS,
                                  WAVE_DIST_GRID, f.engine(r),
                                  f.barrier.wait)

        prof = contextlib.nullcontext()
        if profile and name == "lane":
            from torch.profiler import ProfilerActivity, profile as tprof
            prof = tprof(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
        reset_counts()
        t0 = time.perf_counter()
        with knobs(kv), prof:
            recs, _ = spmd_threads(WAVE_DIST_RANKS, rank_fn,
                                   timeout=RANK_DEADLINE, fabric=fabric)
        seconds = time.perf_counter() - t0
        if not isinstance(prof, contextlib.nullcontext):
            profile_report(f"wave_dist_{name}", prof,
                           max(r["wall"] for r in recs))
        phase = f"wave_dist.{name}"
        wave_dist_lines(phase, recs, n)
        L = assemble_tiles(recs, n, nb)
        err = float(np.abs(L - L_main).max() / np.abs(L_main).max())
        same = bool(np.array_equal(L, L_main))
        del L
        log(phase, ranks=WAVE_DIST_RANKS,
            grid=f"{WAVE_DIST_GRID[0]}x{WAVE_DIST_GRID[1]}", n=n, nb=nb,
            wall=f"{max(r['wall'] for r in recs):.4f}",
            d2d_bytes=fabric.d2d_bytes, d2d_transfers=fabric.d2d_transfers,
            run_seconds=f"{seconds:.1f}", identical=same, rel_err=err)
        check(all(r["host_sends"] == 0 for r in recs)
              and sum(r["mesh_local_sends"] for r in recs) > 0,
              f"{phase}: an exchanged stack went through the host")
        if "wave_reduce_dtype" in kv:
            check(all(r["lane"] == "inproc" and r["reduce_dtype"] == "qbf16"
                      for r in recs), f"{phase}: the bf16 lane did not run")
            check(sum(r["quantized"] for r in recs) > 0,
                  f"{phase}: no reduction was quantized")
            check(err < WAVE_BF16_TOL,
                  f"{phase}: {err} not under {WAVE_BF16_TOL}")
        else:
            check(same, f"{phase}: the factor is not bit-identical to "
                        f"phase main's (rel err {err})")
            lane = kv["wave_dist_collective"] == "on"
            check(all((r["lane"] == "inproc") == lane for r in recs)
                  and (sum(r["lane_calls"] for r in recs) > 0) == lane,
                  f"{phase}: the lane's engagement is not the run's")
        launches[name] = [r["matmul_launches"] for r in recs]
    return launches


def phase_mesh_chain(seed: int, nb: int = NB_MAIN) -> None:
    """dtd_chain_2 on MeshFabric([cuda:0] * 2): two rank threads of this
    process, each with its own context on the card, one nb x nb tile
    through DTD_HOPS CUDA-chore hops alternating between them.  Every
    hop is mesh-local (the producer's private device copy travels, no
    host bytes); the tile is exact, as the TCP chain's."""
    import types
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.comm import MeshFabric, RemoteDepEngine
    from parsec_tpu_torch.utils.spmd import spmd_threads
    fabric = MeshFabric(devices=[torch.device("cuda", 0)] * 2)
    args = types.SimpleNamespace(nb=nb, seed=seed)

    def rank_fn(r, f):
        ctx = ptt.Context(nb_cores=2, comm=RemoteDepEngine(f.engine(r)))
        try:
            out = rank_dtd_chain(ctx, args)
            out.update(rank=r, mesh_local_sends=ctx.comm.stats[
                "mesh_local_sends"],
                host_staged_bytes=ctx.comm.stats["host_staged_bytes"],
                rendezvous_host=ctx.comm.stats["rendezvous_host"],
                d2d_bytes=f.engines[r].d2d_sent_bytes)
            return out
        finally:
            ctx.fini()

    t0 = time.perf_counter()
    recs, _ = spmd_threads(2, rank_fn, timeout=RANK_DEADLINE, fabric=fabric)
    for r in recs:
        boot_on_device = r["device_tasks"] - r["local_cuda_tasks"]
        log("mesh_chain_2", rank=r["rank"], device=r["device"],
            hops=DTD_HOPS, wall=f"{r['wall']:.4f}",
            device_tasks=r["device_tasks"],
            local_cuda_tasks=r["local_cuda_tasks"],
            boot_on_device=boot_on_device,
            mesh_local_sends=r["mesh_local_sends"],
            d2d_bytes=r["d2d_bytes"],
            host_staged_bytes=r["host_staged_bytes"],
            rendezvous_host=r["rendezvous_host"], msgs=r["msgs"],
            exact=r.get("exact"))
        check(r["device"] == "cuda:0" and 0 <= boot_on_device <= 1,
              f"mesh_chain_2: rank {r['rank']} ran {r['device_tasks']} "
              f"device tasks for {r['local_cuda_tasks']} hops")
        check(r["mesh_local_sends"] > 0 and r["host_staged_bytes"] == 0
              and r["rendezvous_host"] == 0,
              f"mesh_chain_2: rank {r['rank']} staged tiles through the "
              f"host ({r['host_staged_bytes']} bytes)")
    check(recs[0]["exact"] is True, "mesh_chain_2: the tile is not exact")
    log("mesh_chain_2", d2d_bytes=fabric.d2d_bytes,
        d2d_transfers=fabric.d2d_transfers,
        seconds=f"{time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------- #
# serve: two tenants sharing one context through a SessionServer        #
# ---------------------------------------------------------------------- #
#: tenant -> (weight, max in-flight pools; 0 = no cap)
SERVE_TENANTS = {"latency": (2, 0), "bulk": (1, 2)}
#: the submissions in order: bulk's third (the fifth) is queued
SERVE_ORDER = ("latency", "bulk", "latency", "bulk", "bulk")
SERVE_DEADLINE = 600.0   # seconds a submission may take to finish


def phase_serve(seed: int, L_ref: np.ndarray, n: int = N_MAIN,
                nb: int = NB_MAIN) -> int:
    """serve (module docstring, 5a"); returns the GEMM launches."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.obs.spans import (SERVE_ADMITTED,
                                            SERVE_INFLIGHT_PREFIX,
                                            SERVE_P99_LATENCY_PREFIX,
                                            SERVE_QUEUED, SERVE_REJECTED,
                                            SERVE_TENANTS as TENANTS_GAUGE)
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.serve import SessionServer
    M = synth_spd(n, seed)
    colls = [tiled(M, nb) for _ in SERVE_ORDER]
    del M
    nt = colls[0].nt
    tasks = nt * (nt + 1) * (nt + 2) // 6
    with knobs({"serve": "1", "serve_admission": "queue"}):
        ctx = ptt.init(nb_cores=4)
        try:
            dev = ctx.device_by_type("cuda")
            srv = SessionServer(ctx)
            for name, (weight, max_pools) in SERVE_TENANTS.items():
                srv.open_tenant(name, weight=weight, max_pools=max_pools)
            reset_counts()
            t0 = time.perf_counter()
            subs, queued_at_submit = [], []
            for k, (tenant, A) in enumerate(zip(SERVE_ORDER, colls)):
                subs.append(srv.submit(
                    tenant, lambda A=A: ptt.ops.dpotrf_taskpool(A),
                    nbytes=n * n * 4, ntasks=tasks, name=f"{tenant}_{k}"))
                queued_at_submit.append(subs[-1].taskpool is None)
            done = [s.wait(SERVE_DEADLINE) for s in subs]
            if dev.is_cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.matmul_launches
            stats = srv.stats()["tenants"]
            snap = ctx.sde.snapshot()
            health = ctx.obs.live.snapshot().get("per_tenant", {})
            finished = sorted(range(len(subs)), key=lambda k: (
                subs[k].t_submit_ns + subs[k].lat_us * 1e3))
            for A in colls:
                for (m, j) in A.tiles():
                    A.data_of(m, j).sync_to_host(ctx.devices)
            st = dict(dev.stats)
            srv.close()
        finally:
            ctx.fini()
    same = [bool(np.array_equal(np.tril(A.to_numpy()), L_ref))
            for A in colls]
    del colls
    for k, sub in enumerate(subs):
        log("serve", submission=k, tenant=sub.tenant, name=sub.name,
            queued_at_submit=queued_at_submit[k], done=done[k],
            error=sub.error, latency_s=f"{sub.lat_us / 1e6:.4f}",
            factor_identical=same[k])
    for name in SERVE_TENANTS:
        h, t = health.get(name, {}), stats[name]
        log("serve", tenant=name, weight=t["weight"],
            pools_done=t["pools_done"],
            live_p50_lat_s=f"{h.get('p50_lat_us', 0.0) / 1e6:.4f}",
            live_p99_lat_s=f"{h.get('p99_lat_us', 0.0) / 1e6:.4f}",
            server_p50_lat_s=f"{t['p50_lat_us'] / 1e6:.4f}",
            server_p99_lat_s=f"{t['p99_lat_us'] / 1e6:.4f}")
    # a counter that was never bumped is not in the snapshot
    gauges = {g: snap.get(g, 0) for g in (TENANTS_GAUGE, SERVE_ADMITTED,
                                          SERVE_QUEUED, SERVE_REJECTED)}
    log("serve", n=n, nb=nb, submissions=len(subs), wall=f"{wall:.4f}",
        matmul_launches=launches, device_tasks=st["tasks"],
        expected_device_tasks=tasks * len(subs),
        finish_order=",".join(subs[k].name for k in finished),
        **{g.split("::")[-1].lower(): v for g, v in gauges.items()})
    check(all(done) and all(s.error is None for s in subs),
          f"serve: submissions done {done}, errors "
          f"{[s.error for s in subs]}")
    check(all(same), f"serve: factors identical to main's: {same}")
    check(queued_at_submit == [False] * 4 + [True],
          f"serve: queued at submission {queued_at_submit}")
    check(gauges == {TENANTS_GAUGE: 2, SERVE_ADMITTED: 5, SERVE_QUEUED: 1,
                     SERVE_REJECTED: 0},
          f"serve: admission gauges {gauges}")
    for name in SERVE_TENANTS:
        inflight = snap.get(f"{SERVE_INFLIGHT_PREFIX}::{name}")
        p99 = snap.get(f"{SERVE_P99_LATENCY_PREFIX}::{name}")
        check(inflight == 0 and p99 is not None and p99 > 0
              and stats[name]["pools_done"] == SERVE_ORDER.count(name)
              and health.get(name, {}).get("pools_done")
              == SERVE_ORDER.count(name),
              f"serve: tenant {name}: in flight {inflight}, p99 {p99}, "
              f"{stats[name]}, live {health.get(name)}")
    check(st["tasks"] == tasks * len(subs),
          f"serve: {st['tasks']} device tasks of {tasks * len(subs)}")
    check(launches > 0, "serve: the path launched the GEMM kernel no time")
    return launches


# ---------------------------------------------------------------------- #
# mesh: one rank's chip mesh over logical chips of the card              #
# ---------------------------------------------------------------------- #
#: phase mesh: device_mesh_shape over device_cuda_virtual_chips logical
#: chips of the one card, each a stream of its own
MESH_SHAPE = "2x2"
MESH_CHIPS = 4           # (a), (b): one rank's 2 x 2 mesh
MESH_RANK_CHIPS = 8      # (c): 2 rank threads, each owning 4 of them
MESH_RANKS = 2
MESH_BURST = 16          # (b): same-class DTD tasks C <- C - A B^T


def mesh_knobs(chips: int):
    return knobs({"device_mesh_shape": MESH_SHAPE,
                  "device_cuda_virtual_chips": chips})


def mesh_line(phase: str, st: dict, **extra) -> None:
    log(phase, device=st["device"], tasks=st["tasks"],
        executed_tasks=st["executed_tasks"], batches=st["batches"],
        batched_tasks=st["batched_tasks"],
        mesh_dispatches=st.get("mesh_dispatches", 0),
        mesh_tasks=st.get("mesh_tasks", 0),
        mesh_moves=st.get("mesh_moves", 0),
        collective_bytes=st.get("collective_bytes", 0),
        chip_gemm_launches="/".join(map(str, st.get("chip_gemm_launches",
                                                    []))),
        stage_in_bytes=st["stage_in_bytes"], **extra)


def mesh_dpotrf(M: np.ndarray, nb: int, around=contextlib.nullcontext):
    """dpotrf through init() -> ops.dpotrf on a 2 x 2 mesh of the card's
    logical chips; returns (L, stats, seconds)."""
    import parsec_tpu_torch as ptt
    A = tiled(M, nb)
    with mesh_knobs(MESH_CHIPS):
        st, seconds, (L,) = drive(lambda ctx: ptt.ops.dpotrf(ctx, A), [A],
                                  around=around)
    return np.tril(L), st, seconds


def mesh_burst(seed: int, nb: int, mesh: bool) -> tuple:
    """(b): MESH_BURST DTD tasks C <- C - A B^T on nb x nb fp32 tiles,
    chore ops.linalg.gemm_nt (stacked), on the 2 x 2 mesh or on one
    chip; returns (the C tiles, stats, the GEMM kernel's launches)."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch import dtd
    from parsec_tpu_torch.dsl.dtd import INOUT, INPUT
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.ops.linalg import gemm_nt
    rng = np.random.RandomState(seed + 40)
    host = [[rng.rand(nb, nb).astype(np.float32) for _ in range(3)]
            for _ in range(MESH_BURST)]
    with (mesh_knobs(MESH_CHIPS) if mesh else contextlib.nullcontext()):
        ctx = ptt.init(nb_cores=1)
    try:
        dev = ctx.device_by_type("cuda")
        tp = dtd.taskpool_new("mesh_burst")
        ctx.add_taskpool(tp)

        def body(es, task):   # the boot task's (insertion index 0) only
            if task.locals[0] >= 1:
                raise RuntimeError(f"{task.snprintf()} ran its host body")

        boot = tp.tile_of_array(np.zeros((nb, nb), np.float32))
        tp.insert_task(body, (boot, INOUT), (boot, INPUT), (boot, INPUT))
        tp.add_chore(body, "cuda", gemm_nt, stacked=True)
        tiles = [[tp.tile_of_array(a) for a in row] for row in host]
        reset_counts()
        t0 = time.perf_counter()
        for c, a, b in tiles:
            tp.insert_task(body, (c, INOUT), (a, INPUT), (b, INPUT))
        tp.wait()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        st = dict(dev.stats, executed_tasks=dev.executed_tasks,
                  device=dev.name, seconds=seconds,
                  chip_gemm_launches=list(getattr(dev, "chip_gemm_launches",
                                                  [])))
        outs = [np.array(c.data.sync_to_host(ctx.devices).payload)
                for c, _a, _b in tiles]
        return outs, st, kernels.matmul_launches
    finally:
        ctx.fini()


def mesh_rank(M: np.ndarray, n: int, nb: int, rank: int, fabric) -> dict:
    """(c): one of MESH_RANKS rank threads, its own context owning a
    2 x 2 mesh of the card's logical chips, dpotrf of ``M`` with A on
    MESH_RANKS x 1 (its own tiles filled), interpreted runtime, from a
    barrier to torch.cuda.synchronize(); its owned lower tiles pulled
    to the host under ``tiles``."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.comm import RemoteDepEngine
    eng = RemoteDepEngine(fabric.engine(rank))
    ctx = ptt.Context(nb_cores=2, comm=eng)
    try:
        dev = ctx.device_by_type("cuda")
        A = TwoDimBlockCyclic(n, n, nb, nb, P=MESH_RANKS, Q=1,
                              nodes=MESH_RANKS, rank=rank, dtype=np.float32)
        A.name = "descMesh"
        for (i, j) in A.local_tiles():
            np.copyto(A.tile(i, j),
                      M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb])
        tp = ptt.ops.dpotrf_taskpool(A, rank=rank, nb_ranks=MESH_RANKS)
        expected = local_cuda_tasks([tp], rank)
        eng.ce.sync()
        t0 = time.perf_counter()
        ctx.add_taskpool(tp)
        ctx.wait()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = dict(dev.stats, rank=rank, wall=wall, device=dev.name,
                   executed_tasks=dev.executed_tasks,
                   local_cuda_tasks=expected,
                   chip_ids=[c.id for c in dev.chips],
                   chip_gemm_launches=list(dev.chip_gemm_launches),
                   mesh_local_sends=eng.stats["mesh_local_sends"],
                   host_staged_bytes=eng.stats["host_staged_bytes"])
        rec["tiles"] = {(i, j): np.array(A.data_of(i, j).sync_to_host(
            ctx.devices).payload) for (i, j) in A.local_tiles() if i >= j}
        return rec
    finally:
        ctx.fini()


def phase_mesh(seed: int, L_main: np.ndarray, n: int = N_MAIN,
               nb: int = NB_MAIN, profile: bool = False) -> dict:
    """One rank's chip mesh on the card (device_mesh_shape=2x2 over
    device_cuda_virtual_chips logical chips, a stream each), phase main's
    input: (a) dpotrf through ops.dpotrf, the factor bit-identical to
    phase main's, sharded flush groups, every device task a CUDA-body
    task, the GEMM kernel launched on each of the 4 chip streams; (b) a
    DTD burst at full tile width, bit-identical to one chip; (c) 2 rank
    threads on a LocalFabric, each owning a 2 x 2 mesh of 8 chips, the
    assembled factor bit-identical to phase main's, mesh-local sends,
    disjoint chips, GEMM launches on every rank.  Under --profile (a)
    runs once more under torch.profiler (path mesh_dpotrf, with the
    share of GEMM-kernel time two chip streams overlapped).  Returns the
    GEMM launches by run, and by chip or rank."""
    from parsec_tpu_torch.comm import LocalFabric
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.utils.spmd import spmd_threads
    M = synth_spd(n, seed)
    nt = n // nb
    tasks = nt * (nt + 1) * (nt + 2) // 6
    launches, per = {}, {}
    # (a) dpotrf on a 2 x 2 mesh
    reset_counts()
    L, st, seconds = mesh_dpotrf(M, nb)
    total = kernels.matmul_launches
    same = bool(np.array_equal(L, L_main))
    del L
    mesh_line("mesh.dpotrf", st, shape=MESH_SHAPE, chips=MESH_CHIPS, n=n,
              nb=nb, seconds=f"{seconds:.4f}",
              gflops=f"{n ** 3 / 3 / seconds / 1e9:.2f}",
              expected_tasks=tasks, matmul_launches=total,
              chip_ids="/".join(map(str, st["chip_ids"])),
              chip_streams=st["chip_streams"],
              resident_bytes_per_chip="/".join(
                  map(str, st["resident_per_chip"])),
              mem_budget=st["mem_budget"], identical=same)
    check(st["device"] == "cuda:mesh2x2",
          f"mesh.dpotrf: ran on {st['device']}")
    check(st["tasks"] == tasks and st["executed_tasks"] == tasks,
          f"mesh.dpotrf: {st['tasks']} of {tasks} CUDA-body tasks ran on "
          f"the device")
    check(st["mesh_dispatches"] > 0
          and st["mesh_tasks"] >= MESH_CHIPS * st["mesh_dispatches"],
          f"mesh.dpotrf: {st['mesh_dispatches']} sharded dispatches of "
          f"{st['mesh_tasks']} tasks")
    check(st["chip_streams"] == MESH_CHIPS,
          f"mesh.dpotrf: {st['chip_streams']} streams for {MESH_CHIPS} "
          f"chips")
    check(all(k > 0 for k in st["chip_gemm_launches"])
          and sum(st["chip_gemm_launches"]) == total,
          f"mesh.dpotrf: GEMM launches by chip "
          f"{st['chip_gemm_launches']} (total {total})")
    check(same, "mesh.dpotrf: the factor is not bit-identical to phase "
                "main's")
    launches["mesh_dpotrf"] = total
    per["mesh_dpotrf_by_chip"] = st["chip_gemm_launches"]
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        prof = tprof(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
        _L, _st, seconds = mesh_dpotrf(M, nb, around=lambda: prof)
        profile_report("mesh_dpotrf", prof, seconds)
        stream_overlap("mesh_dpotrf", prof)
    # (b) a DTD burst on the mesh and on one chip
    outs_m, st_m, l_m = mesh_burst(seed, nb, mesh=True)
    outs_s, st_s, l_s = mesh_burst(seed, nb, mesh=False)
    same = all(np.array_equal(a, b) for a, b in zip(outs_m, outs_s))
    for label, stx, lx in (("mesh", st_m, l_m), ("one_chip", st_s, l_s)):
        mesh_line("mesh.dtd_burst", stx, run=label, burst=MESH_BURST,
                  nb=nb, seconds=f"{stx['seconds']:.4f}",
                  matmul_launches=lx, identical=same)
        check(0 <= stx["tasks"] - MESH_BURST <= 1,
              f"mesh.dtd_burst.{label}: {stx['tasks']} device tasks for "
              f"{MESH_BURST}")
        check(lx > 0, f"mesh.dtd_burst.{label}: no GEMM launch")
    check(st_m["mesh_dispatches"] >= 1,
          "mesh.dtd_burst: the burst never sharded over the chips")
    check(same, "mesh.dtd_burst: the mesh's tiles differ from one chip's")
    launches["mesh_dtd_burst"], launches["mesh_dtd_burst_one_chip"] = \
        l_m, l_s
    del outs_m, outs_s
    # (c) 2 rank threads, each owning a 2 x 2 mesh of 8 chips
    fabric = LocalFabric(MESH_RANKS)
    reset_counts()
    with mesh_knobs(MESH_RANK_CHIPS):
        recs, _ = spmd_threads(
            MESH_RANKS, lambda r, f: mesh_rank(M, n, nb, r, f),
            timeout=RANK_DEADLINE, fabric=fabric)
    for r in recs:
        mesh_line("mesh.ranks_2", r, rank=r["rank"], wall=f"{r['wall']:.4f}",
                  local_cuda_tasks=r["local_cuda_tasks"],
                  chip_ids="/".join(map(str, r["chip_ids"])),
                  mesh_local_sends=r["mesh_local_sends"],
                  host_staged_bytes=r["host_staged_bytes"])
        check(r["device"] == "cuda:mesh2x2"
              and r["tasks"] == r["executed_tasks"] == r["local_cuda_tasks"],
              f"mesh.ranks_2: rank {r['rank']} ran {r['tasks']} tasks on "
              f"{r['device']} of its {r['local_cuda_tasks']}")
        check(sum(r["chip_gemm_launches"]) > 0,
              f"mesh.ranks_2: rank {r['rank']} launched the GEMM kernel "
              f"no time")
    ids = [set(r["chip_ids"]) for r in recs]
    check(ids[0] == {0, 1, 2, 3} and ids[1] == {4, 5, 6, 7},
          f"mesh.ranks_2: the ranks' chips {ids} are not 0-3 and 4-7")
    check(sum(r["mesh_local_sends"] for r in recs) > 0,
          "mesh.ranks_2: no tile took the mesh-local path")
    L = assemble_tiles(recs, n, nb)
    same = bool(np.array_equal(L, L_main))
    del L
    log("mesh.ranks_2", ranks=MESH_RANKS, chips=MESH_RANK_CHIPS,
        wall=f"{max(r['wall'] for r in recs):.4f}",
        matmul_launches=kernels.matmul_launches, identical=same)
    check(same, "mesh.ranks_2: the factor is not bit-identical to phase "
                "main's")
    launches["mesh_ranks_2"] = kernels.matmul_launches
    per["mesh_ranks_2_by_rank"] = [sum(r["chip_gemm_launches"])
                                   for r in recs]
    return launches, per


def stream_overlap(label: str, prof, kernel: str = "gemm_f32_kernel",
                   prefix: str = "gemm") -> None:
    """The share of a kernel's device time (the union of its intervals;
    ``kernel`` a substring of its name) during which launches of it on
    two or more streams ran at once, from the profiler's device events
    (their stream in ``device_resource_id``)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and kernel in e.name]
    check(bool(evs), f"{label}: the profiler recorded no {kernel}")
    marks = sorted([(e.time_range.start, 1, e.device_resource_id)
                    for e in evs]
                   + [(e.time_range.end, -1, e.device_resource_id)
                      for e in evs])
    active: dict = {}
    union = both = 0.0
    last = marks[0][0]
    for t, d, sid in marks:
        live = sum(1 for v in active.values() if v > 0)
        if live >= 1:
            union += t - last
        if live >= 2:
            both += t - last
        last = t
        active[sid] = active.get(sid, 0) + d
    log("profile", path=label, **{
        f"{prefix}_streams": len({e.device_resource_id for e in evs}),
        f"{prefix}_kernels": len(evs),
        f"{prefix}_union_ms": f"{union / 1e3:.3f}",
        f"{prefix}_overlap_ms": f"{both / 1e3:.3f}",
        f"{prefix}_overlap_share": f"{both / union:.4f}" if union else "0"})


def rank_worker(args) -> int:
    """One rank process of the multirank phase: init() wires the TCP
    comm engine from the comm knobs in the environment."""
    import parsec_tpu_torch as ptt
    # the ranks share the host's cores: 4 workers a rank as on one rank,
    # fewer when that would oversubscribe the host (4 ranks on 8 cores)
    cores = max(1, min(4, (os.cpu_count() or 4) // args.nb_ranks))
    if args.run == "obs_2":
        out = rank_obs(args, cores)
        out.update(rank=args.rank, run=args.run, nb_cores=cores)
        print(json.dumps(out), flush=True)
        return 0
    ctx = ptt.init(nb_cores=cores)
    try:
        check(ctx.nb_ranks == args.nb_ranks and ctx.rank == args.rank,
              f"rank {ctx.rank} of {ctx.nb_ranks}, asked for {args.rank} "
              f"of {args.nb_ranks}")
        if args.run == "dtd_chain_2":
            out = rank_dtd_chain(ctx, args)
        elif args.run in FT_RUNS or args.run in ELASTIC_RUNS:
            out = rank_ft(ctx, args)
        else:
            out = rank_dposv(ctx, args, MULTIRANK_RUNS[args.run][3])
    finally:
        ctx.fini()
    out.update(rank=args.rank, run=args.run, nb_cores=cores)
    print(json.dumps(out), flush=True)
    return 0


def spawn_ranks(run: str, nb_ranks: int, seed: int, out_dir: str,
                n: int, nb: int, nrhs: int, profile: bool = False,
                extra_env: dict = None, extra_args: list = None,
                dist: bool = False) -> list:
    """Start the rank processes of ``run`` (knobs of ``extra_env`` and
    flags of ``extra_args`` added to each; with ``dist`` the ``dist_*``
    knobs of one gloo process group, its store on a port of its own) and
    wait for them; a rank that exits non-zero or passes RANK_DEADLINE
    fails the phase (every rank is killed first).  One rank runs without
    a comm engine.  Returns each rank's JSON record."""
    from parsec_tpu_torch.comm import free_ports
    ports = free_ports(nb_ranks + 1)
    shared = share_spd(n, seed)
    procs = []
    for r in range(nb_ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PARSEC_MCA_comm_", "PARSEC_MCA_ft_",
                                    "PARSEC_MCA_dist_"))}
        if nb_ranks > 1:
            env.update(PARSEC_MCA_comm_transport="tcp",
                       PARSEC_MCA_comm_endpoints=",".join(
                           f"127.0.0.1:{p}" for p in ports[:nb_ranks]),
                       PARSEC_MCA_comm_rank=str(r))
        if dist:
            env.update(PARSEC_MCA_dist_coordinator=f"127.0.0.1:{ports[-1]}",
                       PARSEC_MCA_dist_num_processes=str(nb_ranks),
                       PARSEC_MCA_dist_process_id=str(r))
        env.update(shared)
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--rank", str(r), "--nb-ranks", str(nb_ranks), "--run", run,
             "--out", out_dir, "--n", str(n), "--nb", str(nb),
             "--nrhs", str(nrhs)] + (["--profile"] if profile else [])
            + list(extra_args or ()),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + RANK_DEADLINE
    outs = [None] * nb_ranks
    try:
        for r, p in enumerate(procs):
            try:
                outs[r] = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multirank {run}: rank {r} passed its "
                                   f"{RANK_DEADLINE:.0f} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stdout.write(err[-6000:])
            raise RuntimeError(f"multirank {run}: rank {r} exited "
                               f"{p.returncode}")
        lines = out.strip().splitlines()
        for line in lines[:-1]:
            if line.startswith("[profile]"):
                print(line, flush=True)
        recs.append(json.loads(lines[-1]))
    return recs


def dposv_source(factor: np.ndarray, M: np.ndarray, nb: int) -> np.ndarray:
    """What a rank's A holds after dposv, whole: the factor in the lower
    and diagonal tiles (POTRF leaves the diagonal tiles' upper triangle
    zero, as np.tril does), the input in the tiles above the diagonal,
    which dposv never writes."""
    S = factor.copy()
    for j in range(nb, M.shape[1], nb):   # tile column j // nb
        S[:j, j:j + nb] = M[:j, j:j + nb]
    return S


def redist_report(run: str, recs: list, out_dir: str, S: np.ndarray,
                  n: int, nb: int) -> dict:
    """The parent's half of phase redist: assemble each move's target
    from the ranks' tiles, hold it bit for bit to the matching slice of
    S (phase dposv's factor, its upper tiles the input), print one line
    a move and return each move's seconds."""
    iy, jy, rows, cols, tn, tnb, it, jt = redist_region(n, nb)
    Rb = assemble(out_dir, "Rb", (n, n), nb)
    Rc = assemble(out_dir, "Rc", (tn, tn), tnb)
    want_c = np.zeros_like(Rc)
    want_c[it:it + rows, jt:jt + cols] = S[iy:iy + rows, jy:jy + cols]
    same = {"b": bool(np.array_equal(Rb, S)),
            "a": bool(np.array_equal(Rb, S))
            and all(r["redist"]["a_equals_b"] for r in recs),
            "c": bool(np.array_equal(Rc, want_c))}
    del Rb, Rc, want_c
    region = {"a": n * n * 4, "b": n * n * 4, "c": rows * cols * 4}
    what = {"b": "planner", "a": "dtd", "c": "fragments"}
    seconds = {}
    for k in ("b", "a", "c"):
        mv = [r["redist"][k] for r in recs]
        s = max(m["seconds"] for m in mv)
        seconds[k] = s
        log(f"redist.{run}", move=k, path=what[k],
            planned=mv[0]["planned"], seconds=f"{s:.4f}",
            region_bytes=region[k], redist_bytes=mv[0]["redist_bytes"],
            landed_bytes="/".join(str(m["landed_bytes"]) for m in mv),
            wire_msgs="/".join(str(m["msgs"]) for m in mv),
            wire_bytes="/".join(str(m["bytes"]) for m in mv),
            rounds=mv[0]["rounds"], transfers=mv[0]["transfers"],
            plane_pulls="/".join(str(m["plane_pulls"]) for m in mv),
            gbps=f"{region[k] / s / 1e9:.3f}", identical=same[k])
        check(same[k], f"redist.{run}: move {k} is not bit-identical to "
                       f"phase dposv's factor")
        check(all(m["redist_bytes"] == mv[0]["redist_bytes"] for m in mv),
              f"redist.{run}: move {k}'s redist_bytes differ between ranks")
        check(mv[0]["planned"] == (k == "b"),
              f"redist.{run}: move {k} took the wrong path")
    return seconds


def assemble(out_dir: str, name: str, shape, nb: int) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    for f in os.listdir(out_dir):
        if f.startswith(name + "_"):
            i, j = map(int, f[len(name) + 1:-4].split("_"))
            t = np.load(os.path.join(out_dir, f))
            out[i * nb:i * nb + t.shape[0], j * nb:j * nb + t.shape[1]] = t
    return out


def wave_report(run: str, recs: list, n: int, plane: bool,
                same: bool) -> None:
    """The parent's half of a spawn's distributed wave: its lines and
    checks (the factor bit-identical to phase main's; over CUDA IPC every
    stack on the plane and no park left; on dposv_4 the multi-process
    lane, on the others the trees)."""
    phase = f"wave_dist.{run}"
    ws = [r["wave"] for r in recs]
    wave_dist_lines(phase, ws, n)
    log(phase, ranks=len(recs), wall=f"{max(w['wall'] for w in ws):.4f}",
        lane=ws[0]["lane"], device_plane=ws[0]["device_plane"],
        identical=same)
    check(same, f"{phase}: the factor is not bit-identical to phase main's")
    for w in ws:
        if plane:
            check(w["plane_sends"] > 0 and w["host_sends"] == 0
                  and w["leaked_parks"] == 0,
                  f"{phase}: rank {w['rank']} sent {w['host_sends']} "
                  f"stacks through the host, {w['leaked_parks']} parks "
                  f"left")
        else:
            check(w["plane_sends"] == 0,
                  f"{phase}: rank {w['rank']} sent on a device plane")
        want = "multiproc" if run in GLOO_RUNS else None
        check(w["lane"] == want, f"{phase}: lane {w['lane']}, not {want}")
    if not plane:
        check(sum(w["host_sends"] for w in ws) > 0,
              f"{phase}: no stack travelled as host bytes")
    if run in GLOO_RUNS:
        check(sum(w["lane_calls"] for w in ws) > 0,
              f"{phase}: the multi-process lane carried no tile")


def phase_multirank(seed: int, factor: np.ndarray, X1: np.ndarray,
                    L_main: np.ndarray, n: int = N_MAIN, nb: int = NB_MAIN,
                    nrhs: int = NRHS, profile: bool = False):
    """dposv across 2 and 4 rank processes, host-staged and over the
    CUDA-IPC plane (the redist moves inside dposv_2 and dposv_2_ipc, a
    distributed-wave dpotrf inside every spawn, held to phase main's
    factor ``L_main``), then the DTD chain; returns each dposv run's GEMM
    launches by rank, and each spawn's wave's under wave_dist_<run>."""
    M = synth_spd(n, seed)
    Bm = uniform(n, nrhs, seed=seed + 10)
    flops = n ** 3 / 3 + 2.0 * n * n * nrhs
    launches = {}
    S = None
    for run, (nb_ranks, grid, PB, plane) in MULTIRANK_RUNS.items():
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{run}_")
        try:
            t0 = time.perf_counter()
            recs = spawn_ranks(run, nb_ranks, seed, out_dir, n, nb, nrhs,
                               profile, dist=run in GLOO_RUNS)
            spawn_s = time.perf_counter() - t0
            L = assemble(out_dir, "A", (n, n), nb)
            X = assemble(out_dir, "B", (n, nrhs), nb)
            if run in WAVE_IN_SPAWNS:
                W = np.tril(assemble(out_dir, "W", (n, n), nb))
                same_W = bool(np.array_equal(W, L_main))
                del W
                wave_report(run, recs, n, plane, same_W)
                launches[f"wave_dist_{run}"] = [
                    r["wave"]["matmul_launches"] for r in recs]
            if run in REDIST_RUNS:
                if S is None:
                    S = dposv_source(factor, M, nb)
                t1 = time.perf_counter()
                moved = redist_report(run, recs, out_dir, S, n, nb)
                log(f"redist.{run}", moves_s=f"{sum(moved.values()):.4f}",
                    check_s=f"{time.perf_counter() - t1:.1f}")
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        wall = max(r["wall"] for r in recs)
        same_L = bool(np.array_equal(L, factor))
        same_X = bool(np.array_equal(X, X1))
        resid_x = solve_residual(M, X, Bm, seed)
        resid_l = residual(L, M, seed)
        del L, X
        for r in recs:
            log(f"multirank.{run}", rank=r["rank"], device=r["device"],
                nb_cores=r["nb_cores"], wall=f"{r['wall']:.4f}",
                matmul_launches=r["matmul_launches"],
                device_tasks=r["device_tasks"],
                local_cuda_tasks=r["local_cuda_tasks"], msgs=r["msgs"],
                bytes=r["bytes"], host_staged_bytes=r["host_staged_bytes"],
                rendezvous_host=r["rendezvous_host"],
                plane_sends=r["plane_sends"],
                plane_pulls=r.get("plane_pulls", 0),
                plane_bytes=r.get("plane_bytes", 0),
                leaked_parks=r.get("leaked_parks", 0),
                stage_in_bytes=r["stage_in_bytes"],
                stage_out_bytes=r["stage_out_bytes"])
        log(f"multirank.{run}", ranks=nb_ranks, a_grid=f"{grid[0]}x{grid[1]}",
            b_grid=f"{PB}x1",
            plane=recs[0].get("plane_backend", "none"), n=n, nb=nb,
            nrhs=nrhs, wall=f"{wall:.4f}",
            gflops=f"{flops / wall / 1e9:.2f}",
            spawn_to_exit_s=f"{spawn_s:.1f}", factor_identical=same_L,
            x_identical=same_X, residual=resid_x, factor_residual=resid_l)
        for r in recs:
            check(r["device"] == "cuda:0",
                  f"{run}: rank {r['rank']} ran on {r['device']}")
            check(r["device_tasks"] == r["local_cuda_tasks"],
                  f"{run}: rank {r['rank']} ran {r['device_tasks']} device "
                  f"tasks of its {r['local_cuda_tasks']} CUDA-body tasks")
            check(r["matmul_launches"] > 0,
                  f"{run}: rank {r['rank']} launched the GEMM kernel no time")
            if plane:
                check(r["rendezvous_host"] == 0,
                      f"{run}: rank {r['rank']} staged "
                      f"{r['rendezvous_host']} tiles through the host")
                check(r["leaked_parks"] == 0,
                      f"{run}: rank {r['rank']} leaked "
                      f"{r['leaked_parks']} parks")
        if plane:
            check(all(r["plane_backend"] == "ipc" for r in recs),
                  f"{run}: the device plane ran on "
                  f"{recs[0]['plane_backend']}, not CUDA IPC")
            pulls = sum(r["plane_pulls"] for r in recs)
            check(pulls > 0 and pulls == sum(r["plane_sends"] for r in recs),
                  f"{run}: {pulls} plane pulls for "
                  f"{sum(r['plane_sends'] for r in recs)} plane sends")
        check(resid_x < RESID_TOL and resid_l < RESID_TOL,
              f"{run}: residuals {resid_x}, {resid_l} >= {RESID_TOL}")
        check(same_L and same_X, f"{run}: factor identical {same_L}, X "
                                 f"identical {same_X} to one rank's")
        launches[run] = [r["matmul_launches"] for r in recs]
        if run in STAGEC_IN_SPAWNS:
            for r in recs:
                sc = r["stagec"]
                log(f"stagec.ranks_{nb_ranks}", run=run, rank=r["rank"],
                    wall=f"{sc['wall']:.4f}", **{k: v for k, v in sc.items()
                                                 if k != "wall"})
                check(sc["stage_tasks"] > 0 and sc["identical"]
                      and sc["stage_fallbacks"] == 0
                      and sc["chain_fallbacks"] == 0,
                      f"stagec.ranks_{nb_ranks}: rank {r['rank']}: {sc}")
    recs = spawn_ranks("dtd_chain_2", 2, seed, tempfile.gettempdir(), n, nb,
                       nrhs)
    for r in recs:
        # the boot task may run its class's chore when the chore was
        # added before the boot task was dispatched (as in phase dtd)
        boot_on_device = r["device_tasks"] - r["local_cuda_tasks"]
        log("multirank.dtd_chain_2", rank=r["rank"], device=r["device"],
            hops=DTD_HOPS, wall=f"{r['wall']:.4f}",
            device_tasks=r["device_tasks"],
            local_cuda_tasks=r["local_cuda_tasks"],
            boot_on_device=boot_on_device, msgs=r["msgs"],
            bytes=r["bytes"], exact=r.get("exact"))
        check(r["device"] == "cuda:0" and 0 <= boot_on_device <= 1,
              f"dtd_chain_2: rank {r['rank']} ran {r['device_tasks']} "
              f"device tasks for {r['local_cuda_tasks']} hops and 1 boot "
              f"task")
    check(recs[0]["exact"] is True, "dtd_chain_2: the tile is not exact")
    return launches


# ---------------------------------------------------------------------- #
# obs_2: telemetry on two rank processes                                 #
# ---------------------------------------------------------------------- #
#: the runs of each rank, in order, in ONE spawn; --profile appends
#: two runs that split "on" in its halves
OBS_MODES = ("off", "on", "tune")
OBS_PROFILE_MODES = ("trace", "counters")
#: mode -> (the trace: profile=True, the telemetry knobs)
OBS_MODE_KNOBS = {
    "off": (False, ()),
    "on": (True, ("metrics", "obs_flow", "obs_live", "sde_push")),
    "tune": (False, ("tune_auto", "tune_residual_budget")),
    "trace": (True, ()),
    "counters": (False, ("metrics", "obs_flow", "obs_live", "sde_push")),
}
#: a telemetry knob's value where it is not "1" (sde_push: the
#: aggregator's address); a zero residual budget keeps every link of the
#: tune run lossless
OBS_KNOB_VALUES = {"tune_residual_budget": "0"}
#: the knobs that arm the flow allocator on the TCP engine
OBS_FLOW_KNOBS = ("obs_flow", "obs_live", "tune_auto")
#: the tune run's gauges
TUNE_GAUGES = ("PARSEC::TUNE::DECISIONS", "PARSEC::TUNE::REVERTS",
               "PARSEC::TUNE::OBJECTIVE_US")
#: heartbeats in every run (the ft series of the exposition need a
#: detector, and "off" must differ from "on" by telemetry alone)
OBS_HEARTBEAT_S = "0.5"
#: the series each rank's exposition must name
OBS_SERIES = ("parsec_device_", "parsec_comm_", "parsec_ft_",
              "parsec_obs_health_")
CLOCK_OFFSET_MAX_US = 1000.0
OBS_CLOCK_SETTLE_S = 1.0


def tile_hashes(ctx, A, B) -> dict:
    """sha1 of every local result tile (the factor's lower tiles and X),
    pulled through the device module, keyed name_i_j."""
    import hashlib
    out = {}
    for name, d in (("A", A), ("B", B)):
        for (i, j) in d.local_tiles():
            if name == "A" and i < j:
                continue
            host = d.data_of(i, j).sync_to_host(ctx.devices)
            out[f"{name}_{i}_{j}"] = hashlib.sha1(np.ascontiguousarray(
                host.payload).tobytes()).hexdigest()
    return out


def rank_obs(args, cores: int) -> dict:
    """One rank of obs_2: dposv runs in the modes of ``--obs-modes``
    (telemetry off, on, off, on, ...), a fresh context (and TCP engine,
    on its own ports) for each."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.utils.params import params
    ports = [int(p) for p in args.obs_ports.split(",")]
    runs = []
    for k, mode in enumerate(args.obs_modes.split(",")):
        knobs = {"comm_endpoints": ",".join(
                     f"127.0.0.1:{p}" for p in ports[2 * k:2 * k + 2]),
                 "ft_heartbeat_interval": OBS_HEARTBEAT_S}
        trace, names = OBS_MODE_KNOBS[mode]
        knobs.update({name: args.push if name == "sde_push"
                      else OBS_KNOB_VALUES.get(name, "1")
                      for name in names})
        with contextlib.ExitStack() as st:
            for key, v in knobs.items():
                st.enter_context(params.cmdline_override(key, v))
            ctx = ptt.init(nb_cores=cores, profile=trace)
            try:
                rec = rank_obs_run(ctx, args, mode, k)
            finally:
                ctx.fini()
        rec["mode"] = mode
        runs.append(rec)
    return {"runs": runs, "device": runs[0]["device"]}


def rank_obs_run(ctx, args, mode: str, k: int) -> dict:
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch import obs
    from parsec_tpu_torch.obs.critpath import load_trace_intervals
    from parsec_tpu_torch.ops import kernels
    nb_ranks, (P, Q), PB, _ = MULTIRANK_RUNS["dposv_2"]
    rank = ctx.rank
    A, B = rank_inputs(args, rank, nb_ranks, (P, Q), PB)
    expected = local_cuda_tasks(
        [ptt.ops.dpotrf_taskpool(A, rank=rank, nb_ranks=nb_ranks),
         ptt.ops.dtrsm_lower_taskpool(A, B, rank=rank, nb_ranks=nb_ranks),
         ptt.ops.dtrsm_lower_trans_taskpool(A, B, rank=rank,
                                            nb_ranks=nb_ranks)], rank)
    dev = ctx.device_by_type("cuda")
    ce = ctx.comm.ce
    ce.sync()
    reset_counts()
    t0 = time.monotonic_ns()
    ptt.ops.dposv(ctx, A, B, rank=rank, nb_ranks=nb_ranks)
    if dev.is_cuda:
        torch.cuda.synchronize()
    t1 = time.monotonic_ns()
    rec = dict(wall=(t1 - t0) / 1e9, matmul_launches=kernels.matmul_launches,
               device=dev.name, device_tasks=dev.stats["tasks"],
               local_cuda_tasks=expected,
               hashes=tile_hashes(ctx, A, B),
               obs_sink=dev._obs is not None, flow=ce._flow is not None)
    if mode == "tune":
        tn = ctx.obs.tuner
        snap = ctx.sde.snapshot()
        rec.update(tune=dict(
            decisions=tn.counts["decisions"], reverts=tn.counts["reverts"],
            device_moves=tn.counts["device_moves"],
            codec_moves=tn.counts["codec_moves"],
            objective_us=tn.objective_us(), batch_max=dev.batch_max,
            prefetch_depth=dev.prefetch_depth,
            flush_segments=dev.flush_segments,
            live_windows=ctx.obs.live.counts["windows"],
            codecs=[tn.codec_index(p) for p in range(ctx.nb_ranks)
                    if p != rank],
            gauges={g: g in snap for g in TUNE_GAUGES}))
    if mode != "on":
        return rec
    dev._obs.flush()   # the pulls' events
    # the clock sampler pings every 0.25 s: let a few samples land while
    # both ranks are idle before the estimate is read and stamped
    time.sleep(OBS_CLOCK_SETTLE_S)
    ctx.stamp_profile_meta()
    doc = ctx.profile.to_chrome_trace()
    path = os.path.join(args.out, f"obs_run{k}.rank{rank}.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    names = [key[0] for key in
             obs.parse_exposition(ctx.obs.render_prometheus())]
    busy = busy_intervals(load_trace_intervals(doc))
    t0_tr = doc["metadata"]["trace_t0_ns"]
    rec.update(
        trace=path, window_us=[(t0 - t0_tr) / 1e3, (t1 - t0_tr) / 1e3],
        series=len(names),
        series_found={p: any(n.startswith(p) for n in names)
                      for p in OBS_SERIES},
        clock_offset_us=ce.clock_offset_us(1 - rank),
        busy_seconds=sum(e - b for b, e in busy) / 1e6,
        dispatches=len(busy),
        overlapping_intervals=sum(1 for a, b in zip(busy, busy[1:])
                                  if b[0] < a[1]),
        live_windows=ctx.obs.live.counts["windows"])
    return rec


def phase_obs_ranks(seed: int, factor: np.ndarray, X1: np.ndarray,
                    n: int = N_MAIN, nb: int = NB_MAIN, nrhs: int = NRHS,
                    profile: bool = False) -> dict:
    """obs_2 (module docstring, 5e'); returns the GEMM launches of each
    rank's runs."""
    modes = OBS_MODES + (OBS_PROFILE_MODES if profile else ())
    import hashlib
    from parsec_tpu_torch import obs
    from parsec_tpu_torch.comm import free_ports
    from parsec_tpu_torch.obs.critpath import load_trace_intervals
    from parsec_tpu_torch.profiling.aggregator import AggregatorServer
    ref = {}
    for name, M in (("A", factor), ("B", X1)):
        for i in range(M.shape[0] // nb):
            for j in range(M.shape[1] // nb):
                if name == "A" and i < j:
                    continue
                ref[f"{name}_{i}_{j}"] = hashlib.sha1(np.ascontiguousarray(
                    M[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]).tobytes()
                ).hexdigest()
    srv = AggregatorServer().start()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_2_")
    try:
        t0 = time.perf_counter()
        recs = spawn_ranks(
            "obs_2", 2, seed, out_dir, n, nb, nrhs,
            extra_args=["--obs-ports", ",".join(
                str(p) for p in free_ports(2 * len(modes))),
                "--obs-modes", ",".join(modes),
                "--push", f"{srv.host}:{srv.port}"])
        spawn_s = time.perf_counter() - t0
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                srv.health_fleet()["nb_ranks"] < 2:
            time.sleep(0.05)
        health = srv.health_fleet()
        reports = {}
        for k, mode in enumerate(modes):
            if mode != "on":
                continue
            docs = []
            for r in recs:
                with open(r["runs"][k]["trace"]) as fh:
                    docs.append(json.load(fh))
            reports[k] = (docs, obs.merge_trace_docs(docs),
                          obs.analyze(docs))
    finally:
        srv.stop()
        shutil.rmtree(out_dir, ignore_errors=True)
    walls = {mode: [] for mode in modes}
    launches = {}
    for r in recs:
        for k, run in enumerate(r["runs"]):
            walls[run["mode"]].append(run["wall"])
            launches[f"rank{r['rank']}_run{k}_{run['mode']}"] = \
                run["matmul_launches"]
            same = all(ref.get(key) == h for key, h in run["hashes"].items())
            log("obs_2", rank=r["rank"], run=k, mode=run["mode"],
                wall=f"{run['wall']:.4f}",
                matmul_launches=run["matmul_launches"],
                device_tasks=run["device_tasks"],
                local_cuda_tasks=run["local_cuda_tasks"],
                tiles=len(run["hashes"]), tiles_identical=same,
                obs_sink=run["obs_sink"], flow=run["flow"],
                **({} if run["mode"] != "on" else dict(
                    busy_seconds=f"{run['busy_seconds']:.6f}",
                    dispatches=run["dispatches"],
                    overlapping_intervals=run["overlapping_intervals"],
                    clock_offset_us=run["clock_offset_us"],
                    series=run["series"], live_windows=run["live_windows"],
                    **{f"has_{p.strip('_')}": v for p, v in
                       run["series_found"].items()})),
                **({} if run["mode"] != "tune" else {
                    k2: (json.dumps(v) if isinstance(v, (dict, list))
                         else v) for k2, v in run["tune"].items()}))
            check(run["device"] == "cuda:0",
                  f"obs_2: rank {r['rank']} ran on {run['device']}")
            check(same and len(run["hashes"]) > 0,
                  f"obs_2: rank {r['rank']} run {k} ({run['mode']}) differs "
                  f"from phase dposv's factor or X")
            check(run["device_tasks"] == run["local_cuda_tasks"],
                  f"obs_2: rank {r['rank']} run {k} ran "
                  f"{run['device_tasks']} device tasks of its "
                  f"{run['local_cuda_tasks']} CUDA-body tasks")
            check(run["matmul_launches"] > 0,
                  f"obs_2: rank {r['rank']} launched the GEMM kernel no time")
            trace, names = OBS_MODE_KNOBS[run["mode"]]
            check(run["obs_sink"] == (trace or bool(names))
                  and run["flow"] == any(f in names
                                         for f in OBS_FLOW_KNOBS),
                  f"obs_2: rank {r['rank']} run {k} ({run['mode']}): sink "
                  f"{run['obs_sink']}, flow {run['flow']}")
            if run["mode"] == "tune":
                tn = run["tune"]
                check(all(tn["gauges"].values()),
                      f"obs_2: rank {r['rank']} tune run gauges "
                      f"{tn['gauges']}")
                check(tn["codec_moves"] == 0 and not any(tn["codecs"]),
                      f"obs_2: rank {r['rank']} tune run left the lossless "
                      f"rung at a zero budget: {tn}")
            if run["mode"] == "on":
                off = run["clock_offset_us"]
                check(off is not None and abs(off) < CLOCK_OFFSET_MAX_US,
                      f"obs_2: rank {r['rank']} clock offset {off} us")
                check(all(run["series_found"].values()),
                      f"obs_2: rank {r['rank']} exposition lacks "
                      f"{run['series_found']}")
                check(run["overlapping_intervals"] == 0
                      and run["busy_seconds"] > 0,
                      f"obs_2: rank {r['rank']} busy intervals "
                      f"{run['overlapping_intervals']} overlapping, "
                      f"{run['busy_seconds']} s")
    for k, (docs, merged, rep) in reports.items():
        v = obs.validate_chrome_trace(merged)
        cr = rep["cross_rank"]
        dcp = cr["critical_path"]
        log("obs_2", run=k, merged_events=v["events"], flows=v["flows"],
            unmatched_flows=v["unmatched_flows"],
            flow_edges=cr["flow_edges"],
            edges_per_link=json.dumps(cr["edges_per_link"]),
            negative_lag_edges=cr["negative_lag_edges"],
            min_lag_us=cr["min_lag_us"],
            critical_path_seconds=f"{dcp['length_us'] / 1e6:.6f}",
            critical_path_cross_edges=dcp["cross_edges"],
            per_link_exposed_us=json.dumps(cr["per_link_exposed_us"]))
        for line in obs.format_report(rep).splitlines():
            print(f"[obs_2] run={k} report | {line}", flush=True)
        check(v["flows"] > 0 and v["unmatched_flows"] == 0
              and cr["unmatched_flows"] == 0,
              f"obs_2: run {k}: {v['flows']} flows, "
              f"{v['unmatched_flows']} without both halves")
        r0 = next(r for r in recs if r["rank"] == 0)["runs"][k]
        ivs0 = load_trace_intervals(docs[0])
        split_report(f"obs_2.split run={k} rank=0", obs.rank_wall_split(
            ivs0, 0, *r0["window_us"]))
        copy_report(f"obs_2.copies run={k} rank=0", ivs0)
    mean = {m: sum(w) / len(w) for m, w in walls.items()}
    log("obs_2", ranks=2, n=n, nb=nb, nrhs=nrhs,
        **{f"walls_{m}": ",".join(f"{w:.4f}" for w in ws)
           for m, ws in walls.items()},
        **{f"mean_wall_{m}": f"{w:.4f}" for m, w in mean.items()},
        on_over_off=f"{mean['on'] / mean['off']:.4f}",
        tune_over_off=f"{mean['tune'] / mean['off']:.4f}",
        fleet_health_ranks=health["nb_ranks"],
        fleet_health_status=health["status"],
        spawn_to_exit_s=f"{spawn_s:.1f}")
    check(health["nb_ranks"] == 2,
          f"obs_2: the fleet /health merge reports {health['nb_ranks']} "
          f"ranks")
    return launches


# ---------------------------------------------------------------------- #
# ft: dposv killed, failed and rolled back through ft.run_with_restart   #
# ---------------------------------------------------------------------- #
#: run -> rank processes.  ft_kill_2: rank 1 chaos-killed inside stage 1,
#: rank 0 detects it by heartbeat, a fresh incarnation resumes from the
#: stage-1 snapshot; ft_taskfail_2: a task fault on rank 0 inside stage 2
#: aborts that rank (the strict contract refuses an in-world retry on
#: several ranks) and the job with it (rank 0 goes dark, rank 1's
#: detector evicts it), a fresh incarnation resumes from the stage-2
#: snapshot;
#: ft_taskfail_1: the same fault on one rank, rolled back in-world into
#: card-resident collections and retried; ft_clean_2: no fault
FT_RUNS = {"ft_kill_2": 2, "ft_taskfail_2": 2, "ft_taskfail_1": 1,
           "ft_clean_2": 2}
#: ft's and elastic_3's N: their rank processes' start-up and recovery,
#: not the size, are what they exercise; 16384 made the script run past
#: 1100 s of its 1200 s on a slow machine, and with 8192 it took 952 s
#: on one once phase stagec had its cross-rank leg
FT_N = 4096
FT_HEARTBEAT = {"PARSEC_MCA_ft_heartbeat_interval": "0.05",
                "PARSEC_MCA_ft_heartbeat_timeout": "2"}
FT_RETRIES = 1
FT_DARK_S = 120.0        # a killed rank stays dark at most this long
#: phase elastic_3: dposv on 3 rank processes (A, B on 3 x 1) under
#: ft_elastic=shrink; rank ELASTIC_KILLED is killed inside stage 1 and
#: the survivors shrink in-world to 2 x 1
ELASTIC_RUNS = ("elastic_3",)
ELASTIC_RANKS, ELASTIC_KILLED = 3, 2


def ft_reference(seed: int, n: int = FT_N, nb: int = NB_MAIN,
                 nrhs: int = NRHS):
    """One rank's dposv on phase dposv's generators at ``n``: the factor
    and X the ft and elastic runs are held to."""
    import parsec_tpu_torch as ptt
    A = tiled(synth_spd(n, seed), nb)
    B = tiled(uniform(n, nrhs, seed=seed + 10), nb)
    _st, _seconds, (L, X) = drive(lambda ctx: ptt.ops.dposv(ctx, A, B),
                                  [A, B])
    return np.tril(L), X


def ft_stages(A, B, rank: int, nb_ranks: int) -> list:
    """The three pools dposv composes, as fresh-pool factories."""
    import parsec_tpu_torch as ptt
    return [lambda: ptt.ops.dpotrf_taskpool(A, rank=rank, nb_ranks=nb_ranks),
            lambda: ptt.ops.dtrsm_lower_taskpool(A, B, rank=rank,
                                                 nb_ranks=nb_ranks),
            lambda: ptt.ops.dtrsm_lower_trans_taskpool(A, B, rank=rank,
                                                       nb_ranks=nb_ranks)]


def ft_stage_tasks(n: int, nb: int, nrhs: int, nb_ranks: int, rank: int,
                   cuda_only: bool) -> list:
    """Each stage's tasks placed on ``rank`` (A and B on nb_ranks x 1),
    from the collections' shapes alone: no tile is allocated."""
    from parsec_tpu_torch.collections import TwoDimBlockCyclic
    A, B = (TwoDimBlockCyclic(n, w, nb, nb, P=nb_ranks, Q=1, nodes=nb_ranks,
                              rank=rank, dtype=np.float32)
            for w in (n, nrhs))
    return [local_cuda_tasks([mk()], rank, cuda_only)
            for mk in ft_stages(A, B, rank, nb_ranks)]


def rank_ft(ctx, args) -> dict:
    """One rank's dposv through ``run_with_restart`` (snapshots under
    ``args.ckpt``, every stage), timed per attempt, snapshot and
    restore; a rank that failed reports how and where, a killed rank
    stays dark until its peers have raised or finished, a rank that
    finished saves its tiles.  The elastic run builds its collections
    through an ElasticPolicy's rebuild (on the grid of the members) and
    also reports its agreement, rebuilds, grid and elastic counters."""
    import parsec_tpu_torch as ptt  # noqa: F401
    from parsec_tpu_torch.ft import (ElasticPolicy, RestartPolicy,
                                     run_with_restart)
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.utils import checkpoint as ckpt
    restart = sys.modules["parsec_tpu_torch.ft.restart"]
    rank, nb_ranks = ctx.rank, ctx.nb_ranks
    n, nb, nrhs = args.n, args.nb, args.nrhs
    elastic = args.run in ELASTIC_RUNS
    dev = ctx.device_by_type("cuda")
    attempts, snaps, restores, kills, detects = [], [], [], [], []
    agrees, rebuilds, live = [], [], {}

    def attempt(i, mk):
        def make():
            attempts.append((i, dev.stats["tasks"],
                             local_cuda_tasks([mk()], rank)))
            return mk()
        return make

    if elastic:
        M = synth_spd(n, args.seed)
        Bm = uniform(n, nrhs, seed=args.seed + 10)

        def rebuild(grid):
            """dposv's collections and stages on the grid of ``grid``'s
            members (world ranks stay world ranks), local tiles filled
            with phase dposv's input; a resize reshard-restores over
            them."""
            t0 = time.time()
            A, B = (grid.collection(n, w, nb, nb, dtype=np.float32)
                    for w in (n, nrhs))
            A.name, B.name = "descA", "descB"
            for d, src in ((A, M), (B, Bm)):
                for (i, j) in d.local_tiles():
                    np.copyto(d.tile(i, j), src[i * nb:(i + 1) * nb,
                                                j * nb:(j + 1) * nb])
            live.update(A=A, B=B)
            rebuilds.append((t0, time.time(), kernels.matmul_launches))
            return ([attempt(i, mk) for i, mk in
                     enumerate(ft_stages(A, B, rank, nb_ranks))], [A, B])

        co = ctx._ft_elastic
        agree0 = co.agree

        def timed_agree(*a, **kw):
            t0 = time.time()
            try:
                return agree0(*a, **kw)
            finally:
                agrees.append((t0, time.time()))

        co.agree = timed_agree
        stages = colls = None
    else:
        A, B = rank_inputs(args, rank, nb_ranks, (nb_ranks, 1), nb_ranks)
        live.update(A=A, B=B)
        stages = [attempt(i, mk) for i, mk in
                  enumerate(ft_stages(A, B, rank, nb_ranks))]
        colls = [A, B]

    save0, restore0 = restart._save, restart._restore

    def timed_save(collections, prefix, stage, context):
        before, t0 = dict(ckpt.save_stats), time.perf_counter()
        save0(collections, prefix, stage, context)
        st = ckpt.save_stats
        snaps.append(dict(stage=stage, s=time.perf_counter() - t0,
                          pull_s=st["pull_s"] - before["pull_s"],
                          write_s=st["write_s"] - before["write_s"],
                          bytes=st["bytes"] - before["bytes"]))

    def timed_restore(collections, prefix, stage, context=None,
                      reshard=False):
        es = ctx.comm.ce.elastic_stats if ctx.comm is not None else {}
        load0 = es.get("reshard_load_us", 0)
        t0 = time.time()
        restore0(collections, prefix, stage, context, reshard=reshard)
        restores.append(dict(stage=stage, s=time.time() - t0, t0=t0,
                             t1=time.time(), reshard=reshard,
                             load_s=(es.get("reshard_load_us", 0)
                                     - load0) / 1e6))

    restart._save, restart._restore = timed_save, timed_restore
    ce = ctx.comm.ce if ctx.comm is not None else None
    if ce is not None:
        silence0, failure0 = ce.ft_silence, ce.on_peer_failure

        def timed_silence():
            kills.append(time.time())
            silence0()

        def timed_failure(peer, reason):
            detects.append((time.time(), peer, reason))
            failure0(peer, reason)

        ce.ft_silence, ce.on_peer_failure = timed_silence, timed_failure
        ce.sync()
    reset_counts()
    status, reason, stats = "ok", "", {}
    t0 = time.perf_counter()
    try:
        stats = run_with_restart(
            ctx, stages, colls, os.path.join(args.ckpt, "dposv"),
            RestartPolicy("restart", retries=FT_RETRIES, every=1),
            resume_from=args.resume_from,
            elastic=ElasticPolicy(rebuild) if elastic else None)
    except RuntimeError as exc:
        root = exc.__cause__ or exc
        status, reason = type(root).__name__, str(root)
    if dev.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    end_t = time.time()
    # per attempt: device tasks against the stage's local CUDA-body tasks
    ends = [a[1] for a in attempts[1:]] + [dev.stats["tasks"]]
    per = []
    for k, (stage, before, expected) in enumerate(attempts):
        done = (attempts[k + 1][0] == stage + 1 if k + 1 < len(attempts)
                else status == "ok")
        per.append(dict(stage=stage, device_tasks=ends[k] - before,
                        local_cuda_tasks=expected, finished=done))
    if status == "ok":
        save_tiles(ctx, args.out, live["A"], live["B"])
    open(os.path.join(args.out, f"rank{rank}_{status}"), "w").close()
    if ce is not None and status not in ("ok", "RankFailedError"):
        # this rank's own stage failed (or it was killed): its peers must
        # find it by their heartbeat detectors, not by this process's
        # exit, so it stays dark with its sockets open until every peer
        # has raised or finished
        if not ce._ft_silenced:
            ce.ft_silence()
        deadline = time.monotonic() + FT_DARK_S
        peers = [p for p in range(nb_ranks) if p != rank]
        while time.monotonic() < deadline and not all(
                any(f.startswith(f"rank{p}_") for f in os.listdir(args.out))
                for p in peers):
            time.sleep(0.05)
    det = ctx._ft_detector
    out = dict(status=status, reason=reason[:200], wall=wall,
               device=dev.name, matmul_launches=kernels.matmul_launches,
               attempts=per, snapshots=snaps, restores=restores,
               retries=stats.get("retries", 0),
               last_snapshot=stats.get("last_snapshot"),
               failed_stage=attempts[-1][0] if status != "ok" else None,
               kill_t=kills[0] if kills else None,
               detect_t=detects[0][0] if detects else None,
               detect_reason=detects[0][2][:120] if detects else "",
               evictions=det.evictions if det is not None else 0)
    if elastic:
        out.update(grid=stats.get("grid"), resizes=stats.get("resizes", 0),
                   elastic_stats=dict(ce.elastic_stats), agrees=agrees,
                   rebuilds=rebuilds, end_t=end_t,
                   launches_after_resize=(kernels.matmul_launches
                                          - rebuilds[-1][2]
                                          if len(rebuilds) > 1 else 0))
    return out


def ft_line(run: str, inc: int, spawn_s: float, r: dict) -> None:
    snaps = r["snapshots"]
    log(f"ft.{run}", incarnation=inc, rank=r["rank"], status=r["status"],
        wall=f"{r['wall']:.4f}", spawn_to_exit_s=f"{spawn_s:.1f}",
        snapshots=len(snaps),
        snapshot_bytes=sum(s["bytes"] for s in snaps),
        snapshot_s=",".join(f"{s['stage']}:{s['s']:.3f}" for s in snaps),
        snapshot_d2h_s=f"{sum(s['pull_s'] for s in snaps):.3f}",
        snapshot_write_s=f"{sum(s['write_s'] for s in snaps):.3f}",
        restore_s=",".join(f"{s['stage']}:{s['s']:.3f}"
                           for s in r["restores"]) or "-",
        retries=r["retries"], last_snapshot=r["last_snapshot"],
        failed_stage=r["failed_stage"], evictions=r["evictions"],
        matmul_launches=r["matmul_launches"],
        device_tasks="/".join(str(a["device_tasks"]) for a in r["attempts"]),
        local_cuda_tasks="/".join(str(a["local_cuda_tasks"])
                                  for a in r["attempts"]),
        attempt_stages="/".join(f"{a['stage']}{'' if a['finished'] else '!'}"
                                for a in r["attempts"]),
        reason=json.dumps(r["reason"][:80]))


def phase_ft(seed: int, factor: np.ndarray, X1: np.ndarray,
             n: int = N_MAIN, nb: int = NB_MAIN, nrhs: int = NRHS) -> dict:
    """dposv through ft.run_with_restart on rank processes (the dposv_2
    layout), with a chaos kill, a task fault and none; returns each
    run's GEMM launches by incarnation and rank, and each failed run's
    recovery wall in seconds."""
    M = synth_spd(n, seed)
    Bm = uniform(n, nrhs, seed=seed + 10)
    launches, recoveries = {}, {}
    for run, nb_ranks in FT_RUNS.items():
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{run}_")
        ckpt_dir = os.path.join(out_dir, "ckpt")
        os.makedirs(ckpt_dir)
        env = {}
        if run == "ft_kill_2":
            # inside stage 1 (the forward solve) of rank 1
            n0, n1, _ = ft_stage_tasks(n, nb, nrhs, 2, 1, cuda_only=False)
            env = dict(FT_HEARTBEAT,
                       PARSEC_MCA_ft_inject=f"kill:rank=1:after="
                                            f"{n0 + max(1, n1 // 2)}")
        elif run.startswith("ft_taskfail"):
            # inside stage 2 (the backward solve) of rank 0
            n0, n1, n2 = ft_stage_tasks(n, nb, nrhs, nb_ranks, 0,
                                        cuda_only=False)
            env = dict(FT_HEARTBEAT if nb_ranks > 1 else {},
                       PARSEC_MCA_ft_inject=f"taskfail:rank=0:nth="
                                            f"{n0 + n1 + max(1, n2 // 2)}")
        incs = []
        try:
            args = ["--ckpt", ckpt_dir]
            while True:
                t0 = time.perf_counter()
                recs = spawn_ranks(run, nb_ranks, seed, out_dir, n, nb, nrhs,
                                   extra_env=env, extra_args=args)
                incs.append((time.perf_counter() - t0, recs, time.time()))
                if all(r["status"] == "ok" for r in recs) or len(incs) == 2:
                    break
                # a fresh incarnation from the last snapshot set every
                # rank wrote: the failed stage's, or a later one's
                resume = min(r["failed_stage"] if r["status"] != "ok"
                             else r["last_snapshot"] for r in recs)
                args = ["--ckpt", ckpt_dir, "--resume-from", str(resume)]
                env = dict(FT_HEARTBEAT)
            disk = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                       for f in os.listdir(ckpt_dir))
            L = assemble(out_dir, "A", (n, n), nb)
            X = assemble(out_dir, "B", (n, nrhs), nb)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        same_L = bool(np.array_equal(L, factor))
        same_X = bool(np.array_equal(X, X1))
        resid_x = solve_residual(M, X, Bm, seed)
        resid_l = residual(L, M, seed)
        del L, X
        for inc, (spawn_s, recs, _) in enumerate(incs, 1):
            for r in recs:
                ft_line(run, inc, spawn_s, r)
        first, final = incs[0][1], incs[-1][1]
        detected_by, latency, recovery = "-", None, None
        if nb_ranks > 1 and run != "ft_clean_2":
            # the survivor's detector against the failed rank's silence;
            # recovery: that silence to the fresh incarnation's end
            surv, dead = (first[0], first[1]) if run == "ft_kill_2" \
                else (first[1], first[0])
            detected_by = ("heartbeat" if "heartbeat" in surv["detect_reason"]
                           else "socket" if surv["detect_reason"] else "none")
            if surv["detect_t"] is not None and dead["kill_t"] is not None:
                latency = surv["detect_t"] - dead["kill_t"]
                recovery = recoveries[run] = incs[-1][2] - dead["kill_t"]
        log(f"ft.{run}", ranks=nb_ranks, incarnations=len(incs),
            walls="/".join(f"{max(r['wall'] for r in recs):.4f}"
                           for _, recs, _ in incs),
            spawn_to_exit_s="/".join(f"{s:.1f}" for s, _, _ in incs),
            retries=sum(r["retries"] for r in final),
            detected_by=detected_by,
            detection_latency_s=(f"{latency:.4f}" if latency is not None
                                 else "-"),
            recovery_wall_s=(f"{recovery:.1f}" if recovery is not None
                             else "-"),
            checkpoint_disk_bytes=disk,
            gemm_launches_by_rank="/".join(
                str(r["matmul_launches"]) for r in final),
            factor_identical=same_L, x_identical=same_X,
            residual=resid_x, factor_residual=resid_l)
        statuses = [[r["status"] for r in recs] for _, recs, _ in incs]
        want = {"ft_kill_2": [["RankFailedError", "InjectedKill"],
                              ["ok", "ok"]],
                "ft_taskfail_2": [["InjectedTaskFault", "RankFailedError"],
                                  ["ok", "ok"]],
                "ft_taskfail_1": [["ok"]],
                "ft_clean_2": [["ok", "ok"]]}[run]
        check(statuses == want, f"{run}: outcomes {statuses}, wanted {want}")
        if nb_ranks > 1 and run != "ft_clean_2":
            check(detected_by == "heartbeat",
                  f"{run}: the survivor detected the failed rank by "
                  f"{detected_by}")
        if run == "ft_kill_2":
            check(first[1]["failed_stage"] == 1,
                  f"ft_kill_2: the kill fell in stage "
                  f"{first[1]['failed_stage']}, not 1")
        if run == "ft_taskfail_2":
            check(first[0]["failed_stage"] == 2,
                  f"ft_taskfail_2: the fault fell in stage "
                  f"{first[0]['failed_stage']}, not 2")
        check(sum(r["retries"] for r in final) ==
              (FT_RETRIES if run == "ft_taskfail_1" else 0),
              f"{run}: {sum(r['retries'] for r in final)} in-world retries")
        for r in final:
            check(r["device"] == "cuda:0",
                  f"{run}: rank {r['rank']} ran on {r['device']}")
            check(r["matmul_launches"] > 0,
                  f"{run}: rank {r['rank']} launched the GEMM kernel no time")
        for _, recs, _ in incs:
            for r in recs:
                for a in r["attempts"]:
                    check(not a["finished"]
                          or a["device_tasks"] == a["local_cuda_tasks"],
                          f"{run}: rank {r['rank']} stage {a['stage']}: "
                          f"{a['device_tasks']} device tasks of its "
                          f"{a['local_cuda_tasks']} CUDA-body tasks")
        check(resid_x < RESID_TOL and resid_l < RESID_TOL,
              f"{run}: residuals {resid_x}, {resid_l} >= {RESID_TOL}")
        check(same_L and same_X, f"{run}: factor identical {same_L}, X "
                                 f"identical {same_X} to phase dposv's")
        launches[run] = [[r["matmul_launches"] for r in recs]
                         for _, recs, _ in incs]
    return launches, recoveries


def phase_elastic(seed: int, factor: np.ndarray, X1: np.ndarray,
                  recoveries: dict, n: int = N_MAIN, nb: int = NB_MAIN,
                  nrhs: int = NRHS) -> list:
    """dposv on 3 rank processes (A and B on 3 x 1, TCP, heartbeats
    every 0.05 s with a 2 s timeout) through ft.run_with_restart with an
    ElasticPolicy under ft_elastic=shrink, a snapshot every stage;
    ft_inject kills rank 2 halfway through its stage-1 tasks.  The
    survivors must detect it, agree on members (0, 1), rebuild on 2 x 1,
    reshard-restore the stage-1 snapshot (rank 2's shards read from
    disk) and replay, in the same processes: one spawn.  Prints the
    recovery wall (rank 2's silence to the survivors' end) beside
    ft_kill_2's from the same call, and its parts; returns the
    survivors' GEMM launches."""
    M = synth_spd(n, seed)
    Bm = uniform(n, nrhs, seed=seed + 10)
    run, k = "elastic_3", ELASTIC_KILLED
    n0, n1, _ = ft_stage_tasks(n, nb, nrhs, ELASTIC_RANKS, k,
                               cuda_only=False)
    env = dict(FT_HEARTBEAT, PARSEC_MCA_ft_elastic="shrink",
               PARSEC_MCA_ft_inject=f"kill:rank={k}:after="
                                    f"{n0 + max(1, n1 // 2)}")
    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{run}_")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    os.makedirs(ckpt_dir)
    try:
        t0 = time.perf_counter()
        recs = spawn_ranks(run, ELASTIC_RANKS, seed, out_dir, n, nb, nrhs,
                           extra_env=env, extra_args=["--ckpt", ckpt_dir])
        spawn_s, spawn_end = time.perf_counter() - t0, time.time()
        L = assemble(out_dir, "A", (n, n), nb)
        X = assemble(out_dir, "B", (n, nrhs), nb)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    same_L = bool(np.array_equal(L, factor))
    same_X = bool(np.array_equal(X, X1))
    resid_x = solve_residual(M, X, Bm, seed)
    resid_l = residual(L, M, seed)
    del L, X
    dead = recs[k]
    surv = [r for r in recs if r["rank"] != k]
    for r in recs:
        ft_line(run, 1, spawn_s, r)
    kill_t = dead["kill_t"]
    parts = {}
    if kill_t is not None and all(r["agrees"] and len(r["rebuilds"]) > 1
                                  for r in surv):
        reshards = [[x for x in r["restores"] if x["reshard"]][0]
                    for r in surv]
        parts = dict(
            detection_s=min(r["detect_t"] for r in surv) - kill_t,
            agreement_s=max(r["agrees"][-1][1] - r["agrees"][-1][0]
                            for r in surv),
            rebuild_s=max(r["rebuilds"][-1][1] - r["rebuilds"][-1][0]
                          for r in surv),
            reshard_restore_s=max(x["s"] for x in reshards),
            shard_load_s=max(x["load_s"] for x in reshards),
            reshard_move_s=max(x["s"] - x["load_s"] for x in reshards),
            replay_s=max(r["end_t"] - x["t1"]
                         for r, x in zip(surv, reshards)))
    recovery = (max(r["end_t"] for r in surv) - kill_t
                if kill_t is not None else None)
    ft_kill = recoveries.get("ft_kill_2")
    log(f"ft.{run}", ranks=ELASTIC_RANKS, killed=k,
        spawn_to_exit_s=f"{spawn_s:.1f}",
        walls="/".join(f"{r['wall']:.4f}" for r in recs),
        recovery_wall_s=(f"{recovery:.3f}" if recovery is not None
                         else "-"),
        recovery_to_exit_s=(f"{spawn_end - kill_t:.3f}"
                            if kill_t is not None else "-"),
        ft_kill_2_recovery_wall_s=(f"{ft_kill:.3f}" if ft_kill is not None
                                   else "-"),
        **{k_: f"{v:.4f}" for k_, v in parts.items()},
        grids="/".join(str(r.get("grid")) for r in surv),
        resizes="/".join(str(r.get("resizes")) for r in surv),
        reshard_bytes="/".join(str(r["elastic_stats"]["reshard_bytes"])
                               for r in surv),
        launches_after_resize="/".join(str(r["launches_after_resize"])
                                       for r in surv),
        factor_identical=same_L, x_identical=same_X, residual=resid_x,
        factor_residual=resid_l)
    statuses = [r["status"] for r in recs]
    want = ["ok"] * ELASTIC_RANKS
    want[k] = "InjectedKill"
    check(statuses == want, f"{run}: outcomes {statuses}, wanted {want}")
    check(bool(parts), f"{run}: the survivors recorded no resize")
    check(dead["failed_stage"] == 1,
          f"{run}: the kill fell in stage {dead['failed_stage']}, not 1")
    for r in surv:
        es = r["elastic_stats"]
        check(tuple(r["grid"] or ()) == (0, 1) and r["resizes"] == 1
              and es["elastic_resizes"] == 1 and es["reshard_bytes"] > 0,
              f"{run}: rank {r['rank']} grid {r['grid']}, resizes "
              f"{r['resizes']}, counters {es}")
        check(r["device"] == "cuda:0",
              f"{run}: rank {r['rank']} ran on {r['device']}")
        check(r["launches_after_resize"] > 0,
              f"{run}: rank {r['rank']} launched the GEMM kernel no time "
              f"after the resize")
    # the first survivor to learn of the death, by its own detector (the
    # other may learn it first from that survivor's membership view)
    first = min(surv, key=lambda r: r["detect_t"] or float("inf"))
    check("heartbeat" in first["detect_reason"],
          f"{run}: the death was first detected by "
          f"{first['detect_reason']!r}")
    for r in recs:
        for a in r["attempts"]:
            check(not a["finished"]
                  or a["device_tasks"] == a["local_cuda_tasks"],
                  f"{run}: rank {r['rank']} stage {a['stage']}: "
                  f"{a['device_tasks']} device tasks of its "
                  f"{a['local_cuda_tasks']} CUDA-body tasks")
    check(resid_x < RESID_TOL and resid_l < RESID_TOL,
          f"{run}: residuals {resid_x}, {resid_l} >= {RESID_TOL}")
    check(same_L and same_X, f"{run}: factor identical {same_L}, X "
                             f"identical {same_X} to phase dposv's")
    return [r["matmul_launches"] for r in surv]


TEMPLATE_JDF = """
descA [ type="collection" ]

First(k)

k = 0 .. 0

: descA( 0, 0 )

RW A <- descA( 0, 0 )
     -> A Middle( k )

BODY [type=cuda]
{
    A = A * 2.0 + 1.0
}
END

Middle(k)

k = 0 .. 0

: descA( 0, 0 )

RW A <- A First( k )
     -> A Last( k )

BODY [type=template]
{
    A = A * 3.0 - 5.0
}
END

Last(k)

k = 0 .. 0

: descA( 0, 0 )

RW A <- A Middle( k )
     -> descA( 0, 0 )

BODY [type=cuda]
{
    A = A * 0.5
}
END
"""


def phase_template(seed: int, nb: int = NB_MAIN) -> None:
    """A CUDA-body task, a BODY [type=template] task on an attached
    TemplateDevice and a CUDA-body task on one tile: the template task
    reads the card's newest copy, the last task stages its write back
    in; the tile exact against the plain chain."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.devices import TemplateDevice
    M = uniform(nb, nb, seed=seed + 20)
    ctx = ptt.init(nb_cores=4)
    try:
        tdev = TemplateDevice(len(ctx.devices))
        ctx.devices.append(tdev)
        cdev = ctx.device_by_type("cuda")
        A = tiled(M, nb)
        A.name = "descA"
        t0 = time.perf_counter()
        ctx.add_taskpool(ptt.ptg.compile_jdf(TEMPLATE_JDF, name="chain")
                         .new(descA=A))
        ctx.wait()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = A.to_numpy()
        st = dict(cdev.stats)
    finally:
        ctx.fini()
    exp = ((M * np.float32(2) + np.float32(1)) * np.float32(3)
           - np.float32(5)) * np.float32(0.5)
    exact = bool(np.array_equal(got, exp))
    log("template", device=cdev.name, cuda_tasks=st["tasks"],
        template_tasks=tdev.stats["tasks"], stage_in_bytes=st["stage_in_bytes"],
        stage_out_bytes=st["stage_out_bytes"], seconds=f"{seconds:.4f}",
        exact=exact)
    check(cdev.name == "cuda:0" and st["tasks"] == 2
          and tdev.stats["tasks"] == 1,
          f"template: {st['tasks']} CUDA and {tdev.stats['tasks']} "
          f"template tasks on {cdev.name}")
    # the first task's input and the template's output, each staged in
    check(st["stage_in_bytes"] >= 2 * M.nbytes,
          f"template: {st['stage_in_bytes']} bytes staged in, under "
          f"{2 * M.nbytes}")
    check(exact, "template: the tile differs from the plain chain")


def phase_collection_ops(seed: int, L_ptg: np.ndarray, n: int = N_MAIN,
                         nb: int = NB_MAIN) -> int:
    """reduce_all and apply (collections/ops.py) on the dpotrf factor held
    in a card-resident collection; returns the GEMM launches of the two
    factorizations."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.collections import ops as cops
    from parsec_tpu_torch.ops import kernels
    M = synth_spd(n, seed)
    reset_counts()
    ctx = ptt.init(nb_cores=4)
    try:
        dev = ctx.device_by_type("cuda")
        A1, A2 = tiled(M, nb), tiled(M, nb)
        for A in (A1, A2):
            ptt.ops.dpotrf(ctx, A)
        torch.cuda.synchronize()
        on_card = all(A.data_of(i, j).newest_copy().device_id
                      == dev.device_index
                      for A in (A1, A2) for (i, j) in A.tiles() if i >= j)
        launches = kernels.matmul_launches
        pulls = dev.stats["stage_out_bytes"]
        t0 = time.perf_counter()
        total = cops.reduce_all(ctx, A1, lambda a, b, _: a + b).to_numpy()
        reduce_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cops.apply(ctx, A2, lambda t, region, m, k, args: t * np.float32(0.5),
                   uplo="lower")
        apply_s = time.perf_counter() - t0
        pulled = dev.stats["stage_out_bytes"] - pulls
        F = A1.to_numpy()
        G = A2.to_numpy()
    finally:
        ctx.fini()
    nt = n // nb
    tiles = F.reshape(nt, nb, nt, nb).transpose(0, 2, 1, 3)
    exp = tiles.astype(np.float64).sum(axis=(0, 1))
    rel = float(np.abs(total - exp).max() / np.abs(exp).max())
    half = np.array_equal(G.reshape(nt, nb, nt, nb).transpose(0, 2, 1, 3)
                          [np.tril_indices(nt)],
                          tiles[np.tril_indices(nt)] * np.float32(0.5))
    upper = np.array_equal(G.reshape(nt, nb, nt, nb).transpose(0, 2, 1, 3)
                           [np.triu_indices(nt, 1)],
                           tiles[np.triu_indices(nt, 1)])
    same = bool(np.array_equal(np.tril(F), L_ptg))
    log("collection_ops", device=dev.name, n=n, nb=nb, factor_on_card=on_card,
        pulled_bytes=pulled, reduce_all_s=f"{reduce_s:.4f}",
        apply_s=f"{apply_s:.4f}", reduce_all_rel_err=rel,
        apply_exact=bool(half and upper), factor_identical=same,
        matmul_launches=launches)
    check(on_card and pulled >= 2 * nt * (nt + 1) // 2 * nb * nb * 4,
          f"collection_ops: factor on the card {on_card}, {pulled} bytes "
          f"pulled by the host bodies")
    check(rel < RTOL, f"collection_ops: reduce_all off by {rel}")
    check(half and upper and same,
          f"collection_ops: apply exact {half and upper}, factor identical "
          f"{same}")
    return launches


C_DRIVER = r"""
#include <stdio.h>
#include "parsec_tpu_c.h"

static void saxpy_body(float **tiles, int ntiles, void *user) {
    float a = *(float *)user;
    float *y = tiles[0];
    const float *x = tiles[1];
    for (int i = 0; i < 1024; i++) y[i] += a * x[i];
}

int main(void) {
    ptc_context *ctx = ptc_init(2);
    if (!ctx) { fprintf(stderr, "init: %s\n", ptc_last_error()); return 1; }
    printf("version=%s\n", ptc_version());
    printf("devices=%s\n", ptc_device_names(ctx));
    static float ybuf[1024], xbuf[1024];
    float a = 3.0f;
    for (int i = 0; i < 1024; i++) { ybuf[i] = 1.0f; xbuf[i] = (float)i; }
    ptc_taskpool *tp = ptc_dtd_taskpool_new(ctx);
    if (!tp) { fprintf(stderr, "tp: %s\n", ptc_last_error()); return 1; }
    ptc_tile *y = ptc_tile_of_dense(tp, ybuf, 32, 32);
    ptc_tile *x = ptc_tile_of_dense(tp, xbuf, 32, 32);
    ptc_tile *tiles[2] = { y, x };
    int modes[2] = { PTC_INOUT, PTC_INPUT };
    for (int k = 0; k < 8; k++) {
        if (ptc_insert_task(tp, saxpy_body, &a, 2, tiles, modes) != 0) {
            fprintf(stderr, "insert: %s\n", ptc_last_error());
            return 1;
        }
    }
    if (ptc_data_flush_all(tp) != 0 || ptc_taskpool_wait(tp) != 0) {
        fprintf(stderr, "wait: %s\n", ptc_last_error());
        return 1;
    }
    for (int i = 0; i < 1024; i++) {
        float want = 1.0f + 24.0f * (float)i;   /* exact in fp32 */
        if (ybuf[i] != want) {
            fprintf(stderr, "y[%d] = %f != %f\n", i, ybuf[i], want);
            return 2;
        }
    }
    ptc_tile_free(y);
    ptc_tile_free(x);
    ptc_taskpool_free(tp);
    ptc_fini(ctx);
    printf("C-BINDING-OK\n");
    return 0;
}
"""


def phase_bindings() -> None:
    """Build the C shim and a C program against it, and run the program:
    ptc_init on the card, an 8-task DTD saxpy chain through the C API,
    the values exact."""
    from parsec_tpu_torch.bindings import build as bbuild
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    so = bbuild.build()
    work = tempfile.mkdtemp(prefix="chip_smoke_bindings_")
    try:
        src = os.path.join(work, "driver.c")
        with open(src, "w") as fh:
            fh.write(C_DRIVER)
        exe = os.path.join(work, "driver")
        subprocess.run([bbuild.compiler(), "-O1", src, "-o", exe,
                        f"-I{bbuild.include_dir()}", so,
                        f"-Wl,-rpath,{os.path.dirname(so)}"]
                       + bbuild.python_link_flags(), check=True)
        build_s = time.perf_counter() - t0
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PARSEC_MCA_")}
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        r = subprocess.run([exe], capture_output=True, text=True,
                           timeout=300, env=env)
        run_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    devices = next((line.split("=", 1)[1] for line in r.stdout.splitlines()
                    if line.startswith("devices=")), "")
    log("bindings", library=os.path.relpath(so, root), rc=r.returncode,
        devices=devices, build_s=f"{build_s:.1f}", run_s=f"{run_s:.1f}",
        ok="C-BINDING-OK" in r.stdout)
    check(r.returncode == 0 and "C-BINDING-OK" in r.stdout,
          f"bindings: the C program failed ({r.returncode}): "
          f"{r.stderr[-2000:]}")
    check("cuda:0" in devices.split(","),
          f"bindings: ptc_init's context holds {devices!r}, not cuda:0")


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
    first.  ``classes`` is [(name, chore, access modes)], each chore an
    ops/linalg.py tile body declared stacked; returns the host
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
        # the tile bodies (ops/linalg.py) take a leading batch dimension
        tp.add_chore(bodies[name], "cuda", chore, stacked=True)
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
    WALLS["dpotrf_captured"] = runs[0][0]
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
    WALLS["dposv_captured"] = runs[0][0]
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


def phase_forward(dev: torch.device, seed: int):
    """The transformer path through make_forward with attention="ring"
    and "flash"; returns each flash kernel's launches on its path and the
    seeded host parameters."""
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
    return launches, host_params


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


def phase_train(dev: torch.device, seed: int, host_params: dict) -> dict:
    """Adam steps at GPT-2-small widths through models.make_train_step
    for each train path, from phase forward's seeded host parameters;
    then determinism, remat against no remat, each layer's gradients
    against the CPU port, and the whole-depth loss.  Returns each path's
    launches by counter."""
    from parsec_tpu_torch import models
    from parsec_tpu_torch.models import train
    cfg = gpt2_small("flash")
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


# ---------------------------------------------------------------------- #
# spmd: the transformer over meshes of the card's logical chips          #
# ---------------------------------------------------------------------- #
SPMD_CHIPS = 4           # logical chips of the card, a stream each
#: each mesh forward: its axes, its config changes, the kernel counter it
#: launches and its launches per forward (the ring: shard i runs i + 1
#: blocks a layer, 1 + 2 + 3 + 4 = 10; GPipe skips its bubble ticks)
SPMD_FORWARDS = {
    "dp2_tp2_flash": ({"dp": 2, "tp": 2}, dict(attention="flash"),
                      "flash_launches", 48),
    "sp4_ring": ({"sp": 4}, dict(attention="ring"),
                 "flash_stats_launches", 120),
    "sp4_ulysses": ({"sp": 4}, dict(attention="ulysses"),
                    "flash_launches", 48),
    "pp2_flash": ({"pp": 2}, dict(attention="flash", n_stages=2,
                                  layers_per_stage=6, n_micro=4),
                  "flash_launches", 48)}
#: each mesh train path and its launches per step (the training forward
#: runs the stats instance; the ring's backward recomputes the plain ring)
SPMD_TRAIN = {
    "dp2_tp2_flash": ({"dp": 2, "tp": 2}, dict(attention="flash"),
                      {"flash_stats_launches": 48,
                       "flash_bwd_launches": 48}),
    "sp4_ring": ({"sp": 4}, dict(attention="ring"),
                 {"flash_stats_launches": 120})}
#: expert parallelism: the JAX package's dense-dispatch MoE, 4 experts,
#: top 2; dp and sp stay 1 (the sharded Switch aux loss is estimated per
#: (dp, sp) token block, so there it differs from one chip's by design)
SPMD_MOE = ({"tp": 2, "ep": 2}, dict(attention="flash", n_experts=4,
                                     moe_top_k=2),
            {"flash_stats_launches": 48, "flash_bwd_launches": 48})
#: the SPMD_TRAIN paths stepped once more with remat on: each layer one
#: node over its (tp, sp) group, recomputed in its shards in the backward
SPMD_REMAT = ("dp2_tp2_flash", "sp4_ring")


def restage(params: dict, cfg) -> dict:
    """The tree with its stages as ``cfg``'s [n_stages, layers_per_stage]:
    init_params draws the same numbers in the same order for any split."""
    return {**params, "stages": {
        n: a.reshape(cfg.n_stages, cfg.layers_per_stage, *a.shape[2:])
        for n, a in params["stages"].items()}}


def moe_params(params: dict, cfg, seed: int, dev: torch.device) -> dict:
    """The dense tree's embeddings, norms and attention, with a seeded
    gate and expert FFNs drawn on the card at init_params' scales."""
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    S, L = cfg.n_stages, cfg.layers_per_stage
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(*shape, scale):
        return torch.randn(*shape, generator=g, device=dev) * scale

    stages = {n: params["stages"][n] for n in ("ln1", "ln2", "wqkv", "wo")}
    stages.update(gate=w(S, L, D, E, scale=0.02),
                  w1e=w(S, L, E, D, F, scale=D ** -0.5),
                  w2e=w(S, L, E, F, D, scale=F ** -0.5))
    return {**params, "stages": stages}


def nudged(params: dict) -> dict:
    """Every parameter one ulp up: the one-chip baseline of how far the
    seeded model's whole depth carries a rounding difference."""
    return tree_map(lambda a: torch.nextafter(a, torch.full_like(
        a, float("inf"))), params)


def layer_params(params: dict, i: int) -> dict:
    return {n: a.reshape(-1, *a.shape[2:])[i]
            for n, a in params["stages"].items()}


def spmd_pieces(cfg, mesh):
    """The embedding, one layer and the head over ``mesh`` (activations
    split over dp and sp), and one chip's layer: the per-layer comparison
    when a whole-depth one misses its gate.  A MoE layer returns its
    load-balance loss beside its output."""
    from parsec_tpu_torch import models, parallel
    model = models.Transformer(cfg)
    data = parallel.spec("dp", "sp")
    lspec = {n: parallel.spec(*s[2:])
             for n, s in models.param_specs(cfg)["stages"].items()}
    moe = bool(cfg.n_experts)

    def one_layer(lp, x):
        y, aux = model._layer(lp, x, 0.0)
        return (y, aux) if moe else y

    embed = parallel.shard_map_compat(
        lambda ep, t: model._embed(ep, t), mesh,
        in_specs=(parallel.spec(), data), out_specs=data)
    layer = parallel.shard_map_compat(
        one_layer, mesh, in_specs=(lspec, data),
        out_specs=(data, parallel.spec()) if moe else data)
    head = parallel.shard_map_compat(
        lambda hp, x: model._head(hp, x), mesh,
        in_specs=(parallel.spec(), data), out_specs=data)
    return model, embed, layer, head, one_layer


def _parts(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def spmd_forward_by_layer(name: str, cfg, mesh, params, tokens) -> float:
    """The embedding, each layer (with a MoE layer's load-balance loss)
    and the head on the mesh against one chip's, from one chip's input to
    each; returns the worst relative error."""
    model, embed, layer, head, one_layer = spmd_pieces(cfg, mesh)
    with torch.inference_mode():
        tok = torch.as_tensor(tokens).to(params["embed"].device)
        ep = {"embed": params["embed"], "pos": params["pos"]}
        x = model._embed(ep, tok)
        worst, absd = rel_err(embed(ep, tok), x)
        log("spmd.forward", mesh=name, case="embed_vs_one_chip",
            rel_err=worst, max_abs_err=absd)
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            want = _parts(one_layer(lp, x))
            for part, got, ref in zip(("x", "aux"), _parts(layer(lp, x)),
                                      want):
                rel, absd = rel_err(got, ref)
                log("spmd.forward", mesh=name, case="layer_vs_one_chip",
                    layer=i, part=part, rel_err=rel, max_abs_err=absd)
                worst = max(worst, rel)
            x = want[0]
        hp = {"ln_f": params["ln_f"], "embed": params["embed"]}
        rel, absd = rel_err(head(hp, x), model._head(hp, x))
    log("spmd.forward", mesh=name, case="head_vs_one_chip", rel_err=rel,
        max_abs_err=absd)
    return max(worst, rel)


def spmd_grads_by_layer(name: str, cfg, mesh, params, tokens,
                        labels) -> float:
    """The VJPs of the head with the loss, of each layer (every parameter
    and dx; a MoE layer's load-balance loss with its weight in the loss)
    and of the embedding on the mesh against one chip's, from one chip's
    inputs and cotangents; returns the worst relative error."""
    import torch.nn.functional as F
    model, embed, layer, head, one_layer = spmd_pieces(cfg, mesh)
    # d loss / d (a layer's load-balance loss), as loss_shard weighs it
    aux_cot = torch.tensor(cfg.aux_loss_weight
                           / (cfg.n_layers * cfg.n_micro),
                           device=tokens.device)

    def leaf(x):
        return x.detach().clone().requires_grad_(True)

    def vjp(fn, tree, x, cot=None, labels=None, wrt_x=True):
        tree = {n: leaf(a) for n, a in tree.items()}
        if wrt_x:
            x = leaf(x)
        out = _parts(fn(tree, x))
        if labels is not None:
            out = [F.cross_entropy(out[0].reshape(-1, out[0].shape[-1]),
                                   labels.reshape(-1))]
        cots = None if cot is None else [cot, aux_cot][:len(out)]
        names = sorted(tree)
        wrt = ([x] if wrt_x else []) + [tree[n] for n in names]
        grads = torch.autograd.grad(out, wrt, cots)
        return dict(zip((["x"] if wrt_x else []) + names, grads))

    def compare(part, got, ref):
        worst = 0.0
        for g in ref:
            rel, absd = rel_err(got[g], ref[g])
            log("spmd.train", mesh=name, case="grad_vs_one_chip_by_layer",
                part=part, grad=g, rel_err=rel, max_abs_err=absd)
            worst = max(worst, rel)
        return worst

    ep = {"embed": params["embed"], "pos": params["pos"]}
    with torch.no_grad():
        xs = [model._embed(ep, tokens)]
        for i in range(cfg.n_layers):
            xs.append(_parts(one_layer(layer_params(params, i), xs[-1]))[0])
    hp = {"ln_f": params["ln_f"], "embed": params["embed"]}
    with torch.enable_grad():
        ref = vjp(model._head, hp, xs[-1], labels=labels)
        worst = compare("head", vjp(head, hp, xs[-1], labels=labels), ref)
        dy = ref["x"]
        for i in reversed(range(cfg.n_layers)):
            lp = layer_params(params, i)
            ref = vjp(one_layer, lp, xs[i], dy)
            worst = max(worst, compare(f"layer{i}",
                                       vjp(layer, lp, xs[i], dy), ref))
            dy = ref["x"]
        ref = vjp(model._embed, ep, tokens, dy, wrt_x=False)
        worst = max(worst, compare("embed", vjp(embed, ep, tokens, dy,
                                                wrt_x=False), ref))
    return worst


def spmd_mesh(sizes: dict):
    """A mesh of the card's logical chips, checked: every chip on cuda:0
    with a stream of its own."""
    from parsec_tpu_torch import parallel
    mesh = parallel.make_mesh(sizes=sizes)
    chips = list(mesh.devices.flat)
    check(all(c.device == torch.device("cuda", 0) for c in chips)
          and len({id(c.stream) for c in chips}) == len(chips),
          f"mesh {sizes}: chips {chips} are not logical chips of cuda:0 "
          f"with a stream each")
    return mesh


def spmd_grads(name: str, cfg, mesh, params, tokens, labels) -> None:
    """The first step's loss and gradients on the mesh, twice (bit-equal),
    against one chip's value_and_grad within GRAD_RTOL: the loss at whole
    depth, the gradients per layer when a whole-depth one misses it."""
    from parsec_tpu_torch.models import train
    t = torch.as_tensor(tokens, dtype=torch.int64, device=params[
        "embed"].device)
    y = torch.as_tensor(labels, dtype=torch.int64, device=t.device)
    a = train.value_and_grad(cfg, params, t, y, mesh=mesh)
    b = train.value_and_grad(cfg, params, t, y, mesh=mesh)
    same = bool(torch.equal(a[0], b[0])) and all(
        map(torch.equal, train.tree_leaves(a[1]), train.tree_leaves(b[1])))
    log("spmd.train", mesh=name, case="repeat_grads", bit_identical=same)
    check(same, f"{name}: two gradients from the same state differ")
    del b
    r = train.value_and_grad(cfg, params, t, y)
    loss_rel = rel_err(a[0], r[0])[0]
    log("spmd.train", mesh=name, case="loss_vs_one_chip",
        loss=repr(a[0].item()), one_chip=repr(r[0].item()), rel_err=loss_rel)
    check(loss_rel < GRAD_RTOL, f"{name}: loss vs one chip {loss_rel} >= "
                                f"{GRAD_RTOL}")
    worst = 0.0
    flat = zip(_leaf_names(a[1]), train.tree_leaves(a[1]),
               train.tree_leaves(r[1]))
    for leaf_name, g, ref in flat:
        rel, absd = rel_err(g, ref)
        log("spmd.train", mesh=name, case="grad_vs_one_chip", grad=leaf_name,
            rel_err=rel, max_abs_err=absd)
        worst = max(worst, rel)
    del a, r
    torch.cuda.empty_cache()
    if worst < GRAD_RTOL:
        return
    by_layer = spmd_grads_by_layer(name, cfg, mesh, params, t, y)
    r = train.value_and_grad(cfg, params, t, y)
    n = train.value_and_grad(cfg, nudged(params), t, y)
    drift = max(rel_err(g, ref)[0] for g, ref in zip(
        train.tree_leaves(n[1]), train.tree_leaves(r[1])))
    del r, n
    log("spmd.train", mesh=name, case="whole_depth_missed_gate",
        whole_depth_worst_rel=worst, by_layer_worst_rel=by_layer,
        one_chip_one_ulp_nudge_worst_rel=drift)
    check(by_layer < GRAD_RTOL, f"{name}: gradients by layer vs one chip "
                                f"{by_layer} >= {GRAD_RTOL}")


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, a in tree.items()
                for n in _leaf_names(a, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def spmd_counts(launches: dict, counter: str) -> dict:
    """One kernel's launches on each spmd path that launched it."""
    return {path: n[counter] for path, n in launches.items()
            if counter in n}


def phase_spmd(dev: torch.device, seed: int, host_params: dict) -> dict:
    """The transformer over meshes of the card's logical chips
    (``device_cuda_virtual_chips``): each mesh forward against one chip's
    logits, each mesh train path's steps, determinism and gradients
    against one chip's, and expert parallelism's step.  Returns each
    path's launches by counter."""
    from parsec_tpu_torch import models
    cfg = gpt2_small("flash")
    params = models.params_to(host_params, dev)
    rng = np.random.RandomState(seed + 9)
    batches = [rng.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len))
               for _ in range(1 + N_BATCHES)]
    tokens = np.random.RandomState(seed + 7).randint(
        0, cfg.vocab, (cfg.batch, cfg.seq_len))
    labels = np.roll(tokens, -1, axis=1)
    launches = {}
    with knobs({"device_cuda_virtual_chips": SPMD_CHIPS}):
        for name, (sizes, changes, counter, per_fwd) in \
                SPMD_FORWARDS.items():
            c = dataclasses.replace(cfg, **changes)
            p = restage(params, c)
            ref = models.make_forward(c)(p, batches[1])   # one chip
            mesh = spmd_mesh(sizes)
            fwd = models.make_forward(c, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            fwd(p, batches[0])                         # warm-up
            torch.cuda.synchronize()
            seconds = []
            for i, toks in enumerate(batches[1:]):
                t0 = time.perf_counter()
                logits = fwd(p, toks)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                check(tuple(logits.shape) == (cfg.batch, cfg.seq_len,
                                              cfg.vocab)
                      and bool(torch.isfinite(logits).all()),
                      f"spmd {name}: logits {tuple(logits.shape)} or not "
                      f"finite")
                if i == 0:
                    first = logits
            got = counts()
            n_fwd = 1 + N_BATCHES
            want = {k: per_fwd * n_fwd if k == counter else 0
                    for k in COUNTERS}
            rel, absd = rel_err(first, ref)
            mean = sum(seconds) / len(seconds)
            log("spmd.forward", mesh=name, chips=mesh.size, forwards=n_fwd,
                seconds=",".join(f"{x:.6f}" for x in seconds),
                mean_seconds=f"{mean:.6f}",
                tokens_per_s=f"{cfg.batch * cfg.seq_len / mean:.1f}",
                peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                rel_err_vs_one_chip=rel, max_abs_err=absd, **got)
            check(got == want, f"spmd {name}: launches {got}, expected "
                               f"{want}")
            launches[f"spmd_forward_{name}"] = {counter: got[counter]}
            del first, logits, ref, fwd
            if rel >= LOGITS_RTOL:
                worst = spmd_forward_by_layer(name, c, mesh, p, batches[1])
                one = models.make_forward(c)
                drift = rel_err(one(nudged(p), batches[1]),
                                one(p, batches[1]))[0]
                log("spmd.forward", mesh=name,
                    case="whole_depth_missed_gate", whole_depth_rel=rel,
                    by_layer_worst_rel=worst,
                    one_chip_one_ulp_nudge_rel=drift)
                check(worst < LOGITS_RTOL, f"spmd {name}: by layer vs one "
                                           f"chip {worst} >= {LOGITS_RTOL}")
            torch.cuda.empty_cache()
        train_paths = dict(SPMD_TRAIN, moe_tp2_ep2=SPMD_MOE)
        for name, (sizes, changes, per_step) in train_paths.items():
            c = dataclasses.replace(cfg, **changes)
            p0 = moe_params(params, c, seed, dev) if c.n_experts else params
            mesh = spmd_mesh(sizes)
            step = models.make_train_step(c, mesh, lr=TRAIN_LR)
            p, state = p0, models.adam_init(p0)
            want = {k: per_step.get(k, 0) for k in COUNTERS}
            n_steps = 1 if c.n_experts else 1 + TRAIN_STEPS
            losses, seconds = [], []
            ran = dict.fromkeys(per_step, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for i in range(n_steps):               # a warm-up, then timed
                reset_counts()
                t0 = time.perf_counter()
                p, state, loss = step(p, state, tokens, labels)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                got = counts()
                check(got == want, f"spmd train {name} step {i}: launches "
                                   f"{got}, expected {want}")
                for k in ran:
                    ran[k] += got[k]
                losses.append(loss.item())
            timed = seconds[1:] or seconds
            mean = sum(timed) / len(timed)
            log("spmd.train", mesh=name, chips=mesh.size, steps=n_steps,
                seconds=",".join(f"{x:.6f}" for x in seconds),
                mean_seconds=f"{mean:.6f}",
                tokens_per_s=f"{cfg.batch * cfg.seq_len / mean:.1f}",
                peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                losses=",".join(repr(x) for x in losses), **got)
            check(all(np.isfinite(losses)), f"spmd {name}: losses {losses}")
            check(n_steps == 1 or losses[-1] < losses[0],
                  f"spmd {name}: the loss did not fall: {losses}")
            launches[f"spmd_train_{name}"] = ran
            del p, state, step
            torch.cuda.empty_cache()
            spmd_grads(name, c, mesh, p0, tokens, labels)
            del p0
            torch.cuda.empty_cache()
        for name in SPMD_REMAT:
            launches[f"spmd_remat_{name}"] = spmd_remat(
                name, cfg, params, tokens, labels)
    return launches


def spmd_remat(name: str, cfg, params: dict, tokens, labels) -> dict:
    """One train step of an SPMD_TRAIN path from the same state with
    remat off, then on: the loss, the new parameters and the Adam moments
    bit-identical, the remat step's launches (each layer's forward kernels
    once more, in the recompute; the same backward), each step's peak
    memory.  Returns the remat step's launches."""
    from parsec_tpu_torch import models
    from parsec_tpu_torch.models import train
    sizes, changes, per_step = SPMD_TRAIN[name]
    mesh = spmd_mesh(sizes)
    got = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, **changes)
        step = models.make_train_step(c, mesh, lr=TRAIN_LR)
        state = models.adam_init(params)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        p, state, loss = step(params, state, tokens, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # to the host, so the other step's peak does not count them
        got[remat] = ([a.cpu() for a in train.tree_leaves(p)]
                      + [a.cpu() for a in train.tree_leaves(state)],
                      loss.item(), counts(), peak, seconds)
        del p, state, loss, step
    (a, la, na, pa, sa), (b, lb, nb, pb, sb) = got[False], got[True]
    same = la == lb and len(a) == len(b) and all(map(torch.equal, a, b))
    want = {k: 0 for k in COUNTERS}
    want.update({k: v * (2 if k == "flash_stats_launches" else 1)
                 for k, v in per_step.items()})
    log("spmd.remat", mesh=name, chips=mesh.size, loss=repr(lb),
        loss_no_remat=repr(la), bit_identical=same,
        seconds=f"{sb:.6f}", seconds_no_remat=f"{sa:.6f}",
        peak_mem_gb=f"{pb / 1e9:.2f}", peak_mem_gb_no_remat=f"{pa / 1e9:.2f}",
        **nb)
    check(same, f"spmd remat {name}: the step differs from the step "
                f"without remat")
    check(na == {k: per_step.get(k, 0) for k in COUNTERS} and nb == want,
          f"spmd remat {name}: launches {nb} (without remat {na}), "
          f"expected {want}")
    torch.cuda.empty_cache()
    return {k: nb[k] for k in per_step}


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


def profile_report(label: str, prof, seconds: float, top: int = 12) -> float:
    """Device time by kernel from a profiler run, and the device's busy
    share of the wall time (the union of its kernel and copy intervals);
    returns the busy microseconds."""
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
    return busy_us


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
    del p, state, step
    torch.cuda.empty_cache()
    # one dp 2 x tp 2 flash step over 4 logical chips, after a warm-up
    with knobs({"device_cuda_virtual_chips": SPMD_CHIPS}):
        step = models.make_train_step(cfg, spmd_mesh({"dp": 2, "tp": 2}),
                                      lr=TRAIN_LR)
        p, state, _ = step(params, models.adam_init(params), tokens, labels)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            p, state, _ = step(p, state, tokens, labels)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    profile_report("spmd_train", prof, seconds, top=16)
    stream_overlap("spmd_train", prof, kernel="flash_", prefix="flash")
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


@contextlib.contextmanager
def phase_clock(name: str):
    """A phase's seconds, host clock, on a line of its own."""
    t0 = time.perf_counter()
    yield
    log("phase_seconds", name=name, seconds=f"{time.perf_counter() - t0:.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also run the dpotrf, wave dpotrf, dgeqrf, pdgemm "
                         "and dgetrf paths, one forward and one train step "
                         "under torch.profiler and print device time by "
                         "kernel")
    # the multirank phase's rank processes (this script, spawned)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nb-ranks", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=N_MAIN, help=argparse.SUPPRESS)
    ap.add_argument("--nb", type=int, default=NB_MAIN, help=argparse.SUPPRESS)
    ap.add_argument("--nrhs", type=int, default=NRHS, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume-from", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--obs-ports", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--obs-modes", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--push", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    # the package must come from this checkout; importing it first means a
    # directory holding only this script fails before any result
    import parsec_tpu_torch  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.rank is not None:
        return rank_worker(args)

    kind = phase_device()
    dev = torch.device("cuda", 0)
    # phase main's input, made while nvcc builds the kernels in processes
    # of its own; the phases take copies of it
    prep = threading.Thread(target=synth_spd,
                            args=(N_MAIN, args.seed, False))
    prep.start()
    with phase_clock("build"):
        phase_build()
    prep.join()
    with phase_clock("kernel"):
        gemm_err = phase_kernel(dev, args.seed)
    with phase_clock("attention"):
        attn_err = phase_attention(dev, args.seed)
    with phase_clock("bodies"):
        gemm_err = max(gemm_err, phase_bodies(dev, args.seed))
    with phase_clock("batch_semantics"):
        phase_batch_semantics(args.seed)
    # each path run with the counters set to 0 just before it
    gemm_launches = {}
    with phase_clock("main"):
        gemm_launches["dpotrf"], L_ptg = phase_main(args.seed)
    with phase_clock("obs"):
        gemm_launches["obs_dpotrf"] = phase_obs(args.seed, L_ptg,
                                                profile=args.profile)
    with phase_clock("serve"):
        gemm_launches["serve"] = phase_serve(args.seed, L_ptg)
    with phase_clock("mesh"):
        mesh_launches, mesh_per = phase_mesh(args.seed, L_ptg,
                                             profile=args.profile)
    gemm_launches.update(mesh_launches)
    with phase_clock("dtd"):
        gemm_launches["dtd"], L_dtd = phase_dtd(args.seed, L_ptg)
    with phase_clock("dtd_gemm"):
        gemm_launches["dtd_gemm"] = phase_dtd_gemm(args.seed)
    with phase_clock("dplasma"):
        gemm_launches["dposv"], factor, X_dposv = phase_dposv(args.seed)
        gemm_launches["dgetrf_nopiv"], LU = phase_getrf_nopiv(args.seed)
        gemm_launches["dgeqrf"], QR = phase_geqrf(args.seed)
        gemm_launches["pdgemm"], C_nn = phase_pdgemm(args.seed)
        phase_dense(dev, args.seed, factor)
    # recorded stage graphs' launches and replays, apart (as capture's)
    graph_launches = {}
    with phase_clock("stagec"):
        launches, graphs = phase_stagec(args.seed, L_ptg, X_dposv,
                                        profile=args.profile)
    gemm_launches.update(launches)
    graph_launches.update(graphs)
    with phase_clock("wave_dist"):
        wave_dist = phase_wave_dist(args.seed, L_ptg, profile=args.profile)
        for run, per_rank in wave_dist.items():
            gemm_launches[f"wave_dist_{run}"] = sum(per_rank)
        phase_mesh_chain(args.seed)
    # the rank processes share the card: the parent keeps off it
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with phase_clock("multirank"):
        multirank = phase_multirank(args.seed, factor, X_dposv, L_ptg,
                                    profile=args.profile)
    for run, per_rank in multirank.items():
        gemm_launches[f"multirank_{run}"] = sum(per_rank)
    with phase_clock("obs_2"):
        obs_launches = phase_obs_ranks(args.seed, factor, X_dposv,
                                       profile=args.profile)
    gemm_launches["obs_dposv_2"] = sum(obs_launches.values())
    del factor, X_dposv
    with phase_clock("ft"):
        factor, X_dposv = ft_reference(args.seed)
        ft, recoveries = phase_ft(args.seed, factor, X_dposv, n=FT_N)
    for run, incs in ft.items():
        gemm_launches[run] = sum(sum(per_rank) for per_rank in incs)
    with phase_clock("elastic_3"):
        elastic_launches = phase_elastic(args.seed, factor, X_dposv,
                                         recoveries, n=FT_N)
    gemm_launches["elastic_3"] = sum(elastic_launches)
    del factor, X_dposv
    with phase_clock("template"):
        phase_template(args.seed)
    with phase_clock("collection_ops"):
        gemm_launches["collection_ops"] = phase_collection_ops(args.seed,
                                                               L_ptg)
    with phase_clock("bindings"):
        phase_bindings()
    with phase_clock("bitexact"):
        phase_bitexact(args.seed)
    # the static engines, each factor held against the interpreted one
    refs = {("dpotrf", NB_MAIN): L_ptg, ("dgetrf_nopiv", NB_MAIN): LU,
            ("dgeqrf", NB_MAIN): QR, ("pdgemm", NB_MAIN): C_nn}
    del LU, QR, C_nn
    inputs = {}
    with phase_clock("engines"):
        gemm_launches["static"] = phase_static(args.seed, refs, inputs)
        for phase in (phase_turbo, phase_wave):
            for key, n in phase(args.seed, refs, inputs).items():
                gemm_launches[f"{phase.__name__[6:]}_{key}"] = n
    del refs, inputs
    # a captured path's entry counts the warm-up's launches, which ran
    # through the wrapper; its graph's recorded launches and replays are
    # kept apart, under graph_launches
    with phase_clock("capture"):
        launches, graphs = phase_capture(args.seed, L_ptg)
    for routine in launches:
        gemm_launches[f"capture_{routine}"] = launches[routine]
        graph_launches[f"capture_{routine}"] = graphs[routine]
    log("stagec.walls", **{k: f"{v:.4f}" for k, v in WALLS.items()})
    del L_ptg
    with phase_clock("dtd_capture"):
        gemm_launches["dtd_capture"], graph_launches["dtd_capture"] = \
            phase_dtd_capture(args.seed, L_dtd)
    del L_dtd
    with phase_clock("forward"):
        attn_launches, host_params = phase_forward(dev, args.seed)
    with phase_clock("train"):
        train_launches = phase_train(dev, args.seed, host_params)
    with phase_clock("spmd"):
        spmd_launches = phase_spmd(dev, args.seed, host_params)
    del host_params
    with phase_clock("timing"):
        recs = phase_timing(dev, args.seed)
    if args.profile:
        with phase_clock("profile"):
            phase_profile(dev, args.seed)
    src = "parsec_tpu_torch/csrc/"
    tpu = "parsec_tpu/ops/pallas_kernels.py:"
    print(json.dumps({"kernels": [
        dict(name="gemm_f32", route="cuda", source=src + "matmul.cu",
             replaces=tpu + "395", launches=gemm_launches,
             graph_launches=graph_launches,
             multirank_launches_per_rank={f"multirank_{run}": per_rank
                                          for run, per_rank
                                          in multirank.items()},
             wave_dist_launches_per_rank=wave_dist,
             mesh_launches_by_chip_or_rank=mesh_per,
             ft_launches_by_incarnation_and_rank=ft,
             elastic_3_launches_by_survivor=elastic_launches,
             obs_2_launches_by_rank_and_run=obs_launches,
             max_abs_err=gemm_err,
             **recs["gemm"]),
        dict(name="flash_fwd_f32", route="cuda",
             source=src + "flash_attention.cu", replaces=tpu + "68",
             launches={"forward_flash": attn_launches["flash"],
                       **spmd_counts(spmd_launches, "flash_launches")},
             max_abs_err=attn_err["flash"], **recs["flash"]),
        # the training forward of flash_attention runs this instance too
        dict(name="flash_fwd_stats_f32", route="cuda",
             source=src + "flash_attention.cu", replaces=tpu + "115",
             launches={"forward_ring": attn_launches["ring"],
                       **{f"train_{path}": n["flash_stats_launches"]
                          for path, n in train_launches.items()},
                       **spmd_counts(spmd_launches,
                                     "flash_stats_launches")},
             max_abs_err=attn_err["flash_stats"], **recs["flash_stats"]),
        dict(name="flash_bwd_f32", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=tpu + "287",
             launches={**{f"train_{path}": n["flash_bwd_launches"]
                          for path, n in train_launches.items()
                          if "flash_bwd_launches" in n},
                       **spmd_counts(spmd_launches, "flash_bwd_launches")},
             max_abs_err=attn_err["flash_bwd"], **recs["flash_bwd"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
