"""Sharded stage variants: run a wave-front stage's rows over the rank's
chip mesh.

When the rank's device module is a chip MESH (``device_mesh_shape``,
``CudaMeshDevice``: logical chips of one card, each with a stream of its
own, or physical cards) the planner emits per-(level, class) wave-front
stages, and this module runs each eligible one spread over every chip:
the member rows are cut into one block per chip in the mesh's flat
order, and each chip runs its block on its own stream.  A block is a
program of its own, recorded once as a CUDA graph on its chip's device
and replayed on the chip's stream (on the CPU: run eagerly).  Each row
runs the body exactly as the single-chip stage would, with the row's
own environment, so a body's declared LOCALS reach each row as that
row's values — bit-identical to the single-chip graph and to the
interpreted runtime.

Eligibility (a planning decision, checked here at spawn because it
needs the layout): a single class, every member flow bound to its own
exclusive slot (no shared tiles, no NEW/NULL bindings, no intra-stage
edge), and a member count divisible by the chip count.  An ineligible
stage takes the single-chip graph.  A block that fails to record, or a
dispatch that fails, RAISES — the JAX package's fallback to the fused
single-chip callable is not carried, as the device module's sharded
batched dispatch does not fall back either.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["wavefront_info", "build_wavefront_callable",
           "dispatch_sharded"]


class WavefrontInfo:
    """Per-stage metadata for the sharded dispatch: which packed slot
    feeds each (member, flow) and where each output row lands."""

    __slots__ = ("class_name", "flow_names", "arg_slots", "code",
                 "envs", "out_mem_map", "edge_map", "n", "nargs")

    def __init__(self, class_name: str, flow_names: List[str],
                 arg_slots: List[List[int]], code: Any, envs: List[Dict],
                 out_mem_map: List[Tuple[int, int]],
                 edge_map: List[Tuple[int, int]]) -> None:
        self.class_name = class_name
        self.flow_names = flow_names
        self.arg_slots = arg_slots        # [member][flow] -> slot index
        self.code = code
        #: each member's environment (globals + its locals: a body that
        #: reads a declared local sees its own row's value)
        self.envs = envs
        #: layout.out_mem order -> (member index, flow index)
        self.out_mem_map = out_mem_map
        #: layout.edge_outs order -> (member index, flow index)
        self.edge_map = edge_map
        self.n = len(arg_slots)
        self.nargs = len(flow_names)


def wavefront_info(tp, stage, layout, codes) -> Optional[WavefrontInfo]:
    """Analyze a stage for sharded eligibility; None = single-chip."""
    members = stage.members
    if not members:
        return None
    cls = members[0].tc.ast.name
    if any(m.tc.ast.name != cls for m in members):
        return None
    tc_ast = members[0].tc.ast
    nonctl = [f for f in tc_ast.flows if not f.is_ctl]
    from ..dsl.ptg.capture import _producer_locals
    class_ast = {tc.ast.name: tc.ast for tc in tp.task_classes}
    mkeys = stage.member_keys
    arg_slots: List[List[int]] = []
    used = set()
    for inst in members:
        row: List[int] = []
        for f in nonctl:
            slot = None
            for d in f.deps_in():
                t = d.resolve(inst.env)
                if t is None:
                    continue
                if t.kind == "task":
                    pk = (t.task_class, _producer_locals(
                        class_ast, t.task_class,
                        tuple(a(inst.env) for a in t.args)))
                    if pk in mkeys:
                        return None   # intra-stage edge: not a wave front
                    slot = layout.slot_of_act(inst.key, f.name)
                elif t.kind == "memory":
                    coords = tuple(int(a(inst.env)) for a in t.args)
                    slot = layout.mem_index.get((t.collection, coords))
                break
            if slot is None and not f.deps_in():
                for d in f.deps_out():
                    t = d.resolve(inst.env)
                    if t is not None and t.kind == "memory":
                        coords = tuple(int(a(inst.env)) for a in t.args)
                        slot = layout.mem_index.get((t.collection, coords))
                        break
            if slot is None or slot in used:
                return None   # NEW/NULL binding or a shared tile
            used.add(slot)
            row.append(slot)
        arg_slots.append(row)

    # output row mapping: which (member, flow) produced each written
    # tile and each edge live-out
    flow_pos = {f.name: j for j, f in enumerate(nonctl)}
    writer: Dict[Tuple, Tuple[int, int]] = {}
    for i, inst in enumerate(members):
        for f in nonctl:
            if f.access not in ("RW", "WRITE"):
                continue
            for d in f.deps_out():
                t = d.resolve(inst.env)
                if t is None or t.kind != "memory":
                    continue
                coords = tuple(int(a(inst.env)) for a in t.args)
                writer[(t.collection, coords)] = (i, flow_pos[f.name])
    out_mem_map: List[Tuple[int, int]] = []
    for si in layout.out_mem:
        key = layout.mem_slots[si][0]
        if key not in writer:
            return None
        out_mem_map.append(writer[key])
    mindex = {m.key: i for i, m in enumerate(members)}
    edge_map = [(mindex[mk], flow_pos[fn])
                for (mk, fn) in layout.edge_outs]
    return WavefrontInfo(cls, [f.name for f in nonctl], arg_slots,
                         codes[cls], [dict(m.env) for m in members],
                         out_mem_map, edge_map)


class WavefrontProgram:
    """A wave-front stage over the chips of a mesh device: chip ``c``
    (the mesh's flat order) runs rows ``[c*n/k, (c+1)*n/k)``.  Each
    chip's block records once, as one CUDA graph on the chip's device,
    and replays on the chip's stream; ``captured_per_chip`` holds the
    GEMM kernel's launches each block's graph recorded (a replay re-runs
    them uncounted)."""

    def __init__(self, dev, info: WavefrontInfo, rank: int,
                 shapes: Tuple) -> None:
        """``shapes``: the stage's slot shapes ((shape, dtype name) per
        packed slot)."""
        from ..dsl.graph import GraphRunner
        self.info = info
        self.rank = rank
        self.shapes = shapes
        self.chips = list(dev.chips)
        k = len(self.chips)
        if info.n % k:
            raise ValueError(f"a wave front of {info.n} rows does not "
                             f"split over {k} chips")
        self.per = info.n // k
        self.record_seconds = 0.0
        self.blocks = [
            GraphRunner(self._block_fn(c), f"wave front of "
                        f"{info.class_name}, chip {c}",
                        self._written)
            for c in range(k)]

    def _written(self) -> List[Tuple[int, int]]:
        return [(r, o) for r in range(self.per)
                for o in range(self.info.nargs)]

    def _block_fn(self, c: int):
        """Chip ``c``'s block: state {(row, flow): tensor} in, the
        post-body value of every flow of every row out."""
        import torch
        info, per, rank = self.info, self.per, self.rank

        def execute(state, device, note):
            out = {}
            for r in range(per):
                env = dict(info.envs[c * per + r])
                for j, fname in enumerate(info.flow_names):
                    env[fname] = state[(r, j)]
                env["np"] = np
                env["torch"] = torch
                env["es_rank"] = rank
                env["this_task"] = None
                note(f"{info.class_name} row {c * per + r}")
                exec(info.code, env)
                for j, fname in enumerate(info.flow_names):
                    out[(r, j)] = env.get(fname)
            return out
        return execute

    def record(self) -> None:
        """Record every chip's block over zero-filled rows (CUDA chips
        only; on the CPU the blocks run eagerly)."""
        import torch
        t0 = time.perf_counter()
        for c, (chip, gr) in enumerate(zip(self.chips, self.blocks)):
            device = torch.device(chip.device)
            if device.type != "cuda":
                continue
            zeros = {}
            for r in range(self.per):
                slots = self.info.arg_slots[c * self.per + r]
                for j, si in enumerate(slots):
                    s, d = self.shapes[si]
                    zeros[(r, j)] = torch.zeros(s, dtype=getattr(torch, d),
                                                device=device)
            gr.record(zeros, device, chip.stream)
        self.record_seconds += time.perf_counter() - t0

    @property
    def captured_per_chip(self) -> List[int]:
        return [gr.captured_gemm_launches or 0 for gr in self.blocks]

    @property
    def captured_gemm_launches(self) -> int:
        return sum(self.captured_per_chip)

    @property
    def warmup_gemm_launches(self) -> int:
        return sum(gr.warmup_gemm_launches or 0 for gr in self.blocks)

    @property
    def replays(self) -> int:
        return max((gr.replays for gr in self.blocks), default=0)

    def facts(self) -> Dict[str, Any]:
        last = [gr.replay_ms for gr in self.blocks if gr.replays]
        return {"warmup_gemm_launches": self.warmup_gemm_launches,
                "captured_gemm_launches": self.captured_gemm_launches,
                "captured_per_chip": self.captured_per_chip,
                "replays": self.replays,
                "record_seconds": self.record_seconds,
                "replay_ms": max(last) if last else None,
                "sharded": True}


def build_wavefront_callable(dev, info: WavefrontInfo, rank: int,
                             shapes: Tuple) -> WavefrontProgram:
    """The wave-front program of ``info`` over ``dev``'s chips, every
    block recorded now (a block that cannot be recorded raises
    :class:`~..dsl.graph.CaptureError`; nothing falls back)."""
    prog = WavefrontProgram(dev, info, rank, shapes)
    prog.record()
    return prog


def dispatch_sharded(dev, prog: WavefrontProgram,
                     arrays: List[Any]) -> Tuple[List[Any], List[Any]]:
    """Run ``prog`` on the stage's slot tensors: each chip's rows move to
    it (``dev._move``: a hop is one copy on the source chip's stream and
    one wait), its block replays on its stream, and the module's stream
    waits for every chip, so the stage task's completion event covers
    them all.  Returns ``(tile_outs, edge_outs)`` in layout order, each
    tagged with the chip that wrote it."""
    import torch
    info, per = prog.info, prog.per
    results: List[Dict[Tuple[int, int], Any]] = []
    for c, (chip, gr) in enumerate(zip(prog.chips, prog.blocks)):
        # the chip's stream (the stage task's own dispatch interval, on
        # the module's stream, covers the whole wave front)
        with dev.on_stream(chip):
            rows = {(r, j): dev._move(arrays[info.arg_slots[c * per + r][j]],
                                      chip)
                    for r in range(per) for j in range(info.nargs)}
            device = torch.device(chip.device)
            if device.type == "cuda":
                out = gr.run(rows, device)
            else:
                out = gr._execute(rows, device, lambda label: None)
            results.append({k: dev._tag(v, chip) for k, v in out.items()
                            if v is not None})
    if dev.is_cuda:
        # the module's stream joins every chip: readers ordered after it
        # (and the stage task's event) see every block's results
        main = dev._stream_at(None)
        for chip in prog.chips:
            if chip.stream is not None and chip.stream is not main:
                main.wait_stream(chip.stream)

    def row(i: int, o: int):
        c, r = divmod(i, per)
        return results[c].get((r, o))

    tile_outs = [row(i, o) for (i, o) in info.out_mem_map]
    edge_outs = [row(i, o) for (i, o) in info.edge_map]
    return tile_outs, edge_outs
