"""DTD graph capture: record an insert-task sequence, replay it as ONE
CUDA graph.

Counterpart of dsl/ptg/capture.py for the dynamic front end. DTD's
correctness model is sequential consistency: the inserted order is by
definition a valid serialization of the discovered DAG (ref: the
insert-loop semantics of parsec_dtd_insert_task, insert_function.h:284 —
deps are derived from tile access order). So capture needs no dependency
analysis at all: run the recorded tasks in insertion order with tensors
as tile payloads, recorded once into a CUDA graph (dsl/graph.py) and
replayed with one host call per ``run()``.

Scope: task bodies must be the *functional* chore form (the
``add_chore`` convention: one positional arg per inserted param —
tensors for tiles, raw values for VALUE — returning tensors for written
flows in order). Host bodies that mutate numpy arrays in place go
through the runtime instead. Single rank, like PTG capture.

    g = dtd_capture()                      # cuda:0; device="cpu" is eager
    a = g.tile_of_array(np.ones((n, n), np.float32))
    g.insert_task(lambda x, s: x * s, (a, INOUT), (2.0, VALUE))
    # one positional arg per param, OUTPUT tiles included (their
    # incoming value may be None when the tile starts write-only)
    g.insert_task(ops.gemm_nn, (c, INOUT), (a, INPUT), (b, INPUT))
    g.run()                                # one replay for the whole graph
    result = g.value(c)                    # a tensor on the graph's device
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import CaptureError, GraphRunner
from . import INPUT, OUTPUT, VALUE, AccessMode

__all__ = ["CaptureError", "CapturedDTDGraph", "CaptureTile", "dtd_capture"]


class CaptureTile:
    """Handle for one logical tile in a captured graph (the
    parsec_dtd_tile_of analog; identity is the user key; ``idx`` is the
    uniform internal state key, since user keys may mix types)."""

    __slots__ = ("key", "idx", "initial")
    _fresh = itertools.count()

    def __init__(self, key: Any, idx: int, initial: Optional[Any]) -> None:
        self.key = key
        self.idx = idx
        self.initial = initial


class CapturedDTDGraph:
    """A recorded insert sequence and its graph on ``device`` (a torch
    device: None means cuda:0 and raises without a card; ``"cpu"`` runs
    the chores eagerly over host tensors)."""

    def __init__(self, device: Any = None) -> None:
        from ...devices import resolve_device
        self.device = resolve_device(device)
        self._tiles: Dict[Any, CaptureTile] = {}
        # (fn, [(kind, payload)]) where kind in {"tile","value"} and for
        # tiles payload = (tile, written?, read?)
        self._tasks: List[Tuple[Callable, List[Tuple[str, Any]]]] = []
        self.graph = GraphRunner(self._execute, "dtd_capture",
                                 self._written_tiles)
        self._result: Optional[Dict[int, Any]] = None
        self._initial: Dict[int, Any] = {}

    # ------------------------------------------------------------------ #
    # recording (the insert-task surface)                                #
    # ------------------------------------------------------------------ #
    def tile_of_array(self, array: Any, key: Any = None) -> CaptureTile:
        if key is None:
            key = ("anon", next(CaptureTile._fresh))
        t = self._tiles.get(key)
        if t is None:
            t = CaptureTile(key, len(self._tiles), array)
            self._tiles[key] = t
        elif t.initial is not array:
            # re-binding an existing key keeps the FIRST initial; a caller
            # expecting fresh contents would silently compute on stale data
            raise ValueError(
                f"tile key {key!r} already registered with a different "
                f"initial array; captured tiles bind their initial once")
        return t

    def tile(self, key: Any, shape=None, dtype=None) -> CaptureTile:
        """NEW-tile analog: zeros when a shape is given; with no shape
        the tile's first access must be write-only (OUTPUT). A shapeless
        tile may later be re-declared WITH a shape (binds zeros then);
        conflicting shape/dtype re-declarations raise."""
        t = self._tiles.get(key)
        if t is None:
            init = None if shape is None else np.zeros(
                shape, dtype if dtype is not None else np.float32)
            t = CaptureTile(key, len(self._tiles), init)
            self._tiles[key] = t
        elif shape is not None:
            if t.initial is None:
                t.initial = np.zeros(
                    shape, dtype if dtype is not None else np.float32)
            elif (tuple(t.initial.shape) != tuple(shape)
                    or (dtype is not None
                        and _np_dtype(t.initial) != np.dtype(dtype))):
                raise ValueError(
                    f"tile key {key!r} already registered with "
                    f"shape={tuple(t.initial.shape)} "
                    f"dtype={t.initial.dtype}; got shape={tuple(shape)} "
                    f"dtype={dtype}")
        return t

    def insert_task(self, fn: Callable, *args) -> None:
        """``fn`` is the functional chore; ``args`` follow the DTD
        convention: (tile, INPUT|INOUT|OUTPUT) or (value, VALUE) pairs,
        bare values implying VALUE. An insert after a run records the
        graph anew at the next run."""
        parsed: List[Tuple[str, Any]] = []
        for a in args:
            if isinstance(a, tuple) and len(a) == 2 \
                    and isinstance(a[1], AccessMode):
                val, mode = a
            else:
                val, mode = a, VALUE
            if mode & VALUE:
                parsed.append(("value", val))
                continue
            if not isinstance(val, CaptureTile):
                raise TypeError(
                    f"tracked argument must be a CaptureTile, got {type(val)}")
            parsed.append(("tile", (val, bool(mode & OUTPUT),
                                    bool(mode & INPUT))))
        self._tasks.append((fn, parsed))
        self.graph.reset()
        self._result = None

    @property
    def nb_tasks(self) -> int:
        return len(self._tasks)

    # ------------------------------------------------------------------ #
    # execution                                                          #
    # ------------------------------------------------------------------ #
    def _execute(self, state: Dict[int, Any], device: torch.device,
                 note=lambda label: None) -> Dict[int, Any]:
        state = dict(state)
        for i, (fn, parsed) in enumerate(self._tasks):
            call_args = []
            written: List[CaptureTile] = []
            for kind, payload in parsed:
                if kind == "value":
                    call_args.append(payload)
                else:
                    tile, writes, _reads = payload
                    call_args.append(state[tile.idx])
                    if writes:
                        written.append(tile)
            name = getattr(fn, "__name__", repr(fn))
            note(f"{name}#{i}")
            outs = fn(*call_args)
            if written:
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                if len(outs) != len(written):
                    raise ValueError(
                        f"{name}: returned {len(outs)} outputs for "
                        f"{len(written)} written flows")
                for tile, out in zip(written, outs):
                    state[tile.idx] = out
        return state

    def _written_tiles(self) -> List[int]:
        """The tiles some task writes (OUTPUT or INOUT)."""
        return sorted({payload[0].idx for _fn, parsed in self._tasks
                       for kind, payload in parsed
                       if kind == "tile" and payload[1]})

    def _initial_state(self) -> Dict[int, Any]:
        # a tile with no initial array is fine iff its first access is
        # write-only (pure OUTPUT): the incoming value is never read, so
        # its placeholder None only ever reaches the body as the
        # conventionally-ignored positional arg
        first_read: Dict[int, bool] = {}
        for _fn, parsed in self._tasks:
            for kind, payload in parsed:
                if kind != "tile":
                    continue
                tile, _writes, reads = payload
                if tile.idx not in first_read:
                    first_read[tile.idx] = reads
        missing = [t.key for t in self._tiles.values()
                   if t.initial is None and first_read.get(t.idx, False)]
        if missing:
            raise ValueError(f"tiles {missing!r} have no initial array")
        return {t.idx: t.initial for t in self._tiles.values()}

    def record(self) -> None:
        """Warm up and record the CUDA graph on the tiles' initial
        arrays without running it (``run`` records on first use); a
        chore that cannot be recorded raises :class:`CaptureError`."""
        if self.device.type != "cuda":
            raise ValueError(f"record: a CUDA graph needs a CUDA device, "
                             f"got {self.device}")
        self.graph.record(self._initial_state(), self.device)

    def run(self, state: Optional[Dict[int, Any]] = None) -> Dict[int, Any]:
        """Execute the captured graph (one replay on the card) on the
        tiles' initial arrays, or on ``state`` ({tile.idx: array}); the
        results are readable per tile via :meth:`value`.  Returns
        {tile.idx: tensor} for every tile."""
        inputs = state or self._initial_state()
        self._result = self.graph.run(inputs, self.device)
        self._initial = inputs
        return {t.idx: self.value(t) for t in self._tiles.values()}

    def value(self, tile: CaptureTile) -> Any:
        """The tile's tensor after the last run (the data_flush analog)."""
        if self._result is None:
            raise RuntimeError("run() the captured graph first")
        if tile.idx in self._result:
            return self._result[tile.idx]
        init = self._initial.get(tile.idx)
        if init is None or isinstance(init, torch.Tensor):
            return init
        return torch.from_numpy(np.asarray(init)).to(self.device)


def _np_dtype(x: Any) -> np.dtype:
    """The numpy dtype of an array or a tensor."""
    return np.dtype(str(x.dtype).replace("torch.", ""))


def dtd_capture(device: Any = None) -> CapturedDTDGraph:
    """A new captured DTD graph on ``device`` (None: cuda:0)."""
    return CapturedDTDGraph(device)
