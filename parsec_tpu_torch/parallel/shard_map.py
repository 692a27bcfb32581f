"""SPMD over a mesh in one process: the executor behind
``shard_map_compat``, and the collectives the transformer's axes use.

The JAX package runs its model over a mesh with ``jax.shard_map`` and the
``lax`` collectives (``psum``, ``pmean``, ``ppermute``, ``all_to_all``,
``axis_index``); XLA compiles one program per shard.  ``lax`` is a
library, not a module of the JAX package, so this module has no
counterpart there to mirror: it is the port's own SPMD layer.

**One thread per shard, one autograd graph.**  :func:`shard_map` runs the
body once per shard, each on a thread of its own bound to its chip of the
mesh (``parallel.mesh.Chip``: a physical card, or a logical chip, which is
the card's device and a CUDA stream of its own).  The body sees its axis
environment: :func:`axis_size` and :func:`axis_index` answer for the
calling shard.  Every collective is ONE autograd node over its whole
group, issued when every member has deposited its operand; its backward
holds every member's cotangent at once, so it never waits for a peer.
The backward is one call, made after every shard thread has returned.
PyTorch runs every CUDA backward node of one device on one worker
thread: a node a shard whose backward waited for its peers would
deadlock that thread, on one card at the first wait.

The graph is the global function's own, so gradients are exact by
construction (the JAX package's varying-manual-axes bookkeeping has no
counterpart here): the inputs are split by one node (:class:`_Scatter`)
whose backward sums each replicated leaf's contributions in shard
coordinate order, and backpropagating from one replica of a replicated
loss is the true gradient.

**The rendezvous.**  Each member deposits its operand under a key made of
the collective's axes, its group and the member's count of calls on that
group; member 0 of the group (in coordinate order, never the last to
arrive) issues the node.  The issuer's stream waits on every member's
stream before it reads a deposit, and every member's stream waits on the
issuer's before it reads its result; a tensor read on another stream than
its allocation's is recorded on that stream for the caching allocator.
Sums go in coordinate order, and the issuer is always member 0, so the
graph, and its backward's order, are the same on every run: two runs are
bit-identical.  The calling thread watches the run: when no shard has
deposited, issued or returned for :data:`RENDEZVOUS_TIMEOUT` seconds, the
call raises, naming each open rendezvous's group and the shards missing
from it, and the shards still in their bodies; a shard that raises makes
every peer leave its wait and the call raise.

A mesh of one chip runs the body on the calling thread, and every
collective over a group of one is the identity.

**Remat.**  :func:`remat` recomputes a function whose collectives span a
group (a transformer layer over tp, sp and ep) in the backward: one node
over the group keeps each member's arguments, and its backward runs the
members again, each on a thread bound to its chip in a run of the group
alone, then backpropagates through them in one call.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import AXES, Chip, Mesh, PartitionSpec

#: seconds a run may go without progress (a deposit, an issued collective
#: or a shard's return) before the call raises
RENDEZVOUS_TIMEOUT = 300.0

_tls = threading.local()


class _Aborted(Exception):
    """Raised in a shard whose run was ended by another shard's error."""


class _Shard:
    """The calling thread's place in a run: its flat index in the mesh,
    its coordinates by axis, its chip, and its count of calls per
    collective group."""

    def __init__(self, run: "_Run", index: int) -> None:
        self.run = run
        self.index = index
        self.coords = run.coords[index]
        self.chip = run.chips[index]
        self.calls: Dict[Any, int] = {}


def current_shard() -> Optional[_Shard]:
    """The calling thread's shard, or None outside a shard."""
    return getattr(_tls, "shard", None)


def _axes_of(axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes are {AXES}")
    return names


def axis_size(axis_name) -> int:
    """The size of a mesh axis (or the product over several) for the
    calling shard; 1 outside a shard."""
    names = _axes_of(axis_name)
    sh = current_shard()
    if sh is None:
        return 1
    return int(np.prod([sh.run.shape[a] for a in names]))


def axis_index(axis_name: str) -> int:
    """The calling shard's coordinate on ``axis_name``; 0 outside a shard."""
    (name,) = _axes_of(axis_name)
    sh = current_shard()
    return 0 if sh is None else sh.coords[name]


# ---------------------------------------------------------------------- #
# streams and devices                                                    #
# ---------------------------------------------------------------------- #
def _on_chip(chip) -> contextlib.AbstractContextManager:
    """The chip's device and stream, current for the block (nothing on
    the CPU)."""
    if chip.device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(chip.device))
    if chip.stream is not None:
        stack.enter_context(torch.cuda.stream(chip.stream))
    return stack


def _stream(chip):
    if chip.device.type != "cuda":
        return None
    return chip.stream if chip.stream is not None \
        else torch.cuda.current_stream(chip.device)


def _read_on(t: Any, chip) -> None:
    """Tell the caching allocator that ``t`` is read on ``chip``'s stream,
    so its block is not handed out again before that stream is done (a
    tensor of another card is read through a copy, not on this stream)."""
    s = _stream(chip)
    if s is not None and isinstance(t, torch.Tensor) and t.is_cuda \
            and t.device == s.device:
        t.record_stream(s)


def _wait(waiter, on) -> None:
    """``waiter``'s stream waits for the work queued on ``on``'s so far."""
    a, b = _stream(waiter), _stream(on)
    if a is not None and b is not None and a != b:
        a.wait_stream(b)


def _autograd_streams(chips) -> List[Chip]:
    """The streams autograd runs a group node's backward on, one a CUDA
    device of ``chips``: the cotangents are ready there, and the
    gradients must be."""
    return [Chip(-1, d, torch.cuda.current_stream(d))
            for d in dict.fromkeys(c.device for c in chips)
            if d.type == "cuda"]


def _move(t: torch.Tensor, src, dst) -> torch.Tensor:
    """``t`` (written on chip ``src``) as a tensor ``dst`` may read: the
    same tensor on the same device, else a copy queued on ``src``'s
    stream that ``dst``'s current stream waits for."""
    if t.device == dst.device:
        return t
    with _on_chip(src), _on_chip(dst):
        return t.to(dst.device)


def _private(t: torch.Tensor, src, dst) -> torch.Tensor:
    """A tensor of ``t``'s values that is ``dst``'s own: a clone on the
    same device (an output of a node must not alias another output)."""
    out = _move(t, src, dst)
    return out.clone() if out is t else out


# ---------------------------------------------------------------------- #
# the run and its rendezvous                                             #
# ---------------------------------------------------------------------- #
class _Slot:
    def __init__(self, op: str, n: int, group: Dict[str, int]) -> None:
        self.op = op
        self.group = group         # the coordinates its members share
        self.inputs: Optional[List[Any]] = [None] * n
        self.here: set = set()     # the members' positions that arrived
        self.outputs: Optional[List[Any]] = None
        self.taken = 0


class _Run:
    """One call of a shard_map'd function: the mesh's shards, their
    rendezvous slots, the time of the last progress, the shards that
    returned, and the first error a shard raised."""

    def __init__(self, shape: Dict[str, int], coords: List[Dict[str, int]],
                 chips: List[Chip]) -> None:
        self.shape = shape
        self.timeout = RENDEZVOUS_TIMEOUT
        self.coords = coords
        self.chips = chips
        self.cond = threading.Condition()
        self.slots: Dict[Any, _Slot] = {}
        self.error: Optional[Tuple[int, BaseException]] = None
        self.progress = time.monotonic()
        self.returned: set = set()
        self._groups: Dict[Any, Tuple[int, ...]] = {}

    @classmethod
    def of_mesh(cls, mesh: Mesh) -> "_Run":
        """A run over every shard of ``mesh``."""
        dims = [mesh.shape[a] for a in AXES]
        coords = [{a: int(c) for a, c in
                   zip(AXES, np.unravel_index(k, dims))}
                  for k in range(mesh.size)]
        chips = [d if isinstance(d, Chip) else Chip(k, torch.device(d))
                 for k, d in enumerate(mesh.devices.flat)]
        return cls(mesh.shape, coords, chips)

    def group(self, index: int, axes: Tuple[str, ...]) -> Tuple[int, ...]:
        """The flat indices of ``index``'s group over ``axes`` (the shards
        equal to it on every other axis), in coordinate order: row-major
        over ``axes`` in the order given."""
        key = (index, axes)
        found = self._groups.get(key)
        if found is None:
            mine = self.coords[index]
            members = [k for k, cs in enumerate(self.coords)
                       if all(cs[a] == mine[a] for a in AXES
                              if a not in axes)]
            members.sort(key=lambda k: tuple(self.coords[k][a]
                                             for a in axes))
            found = self._groups[key] = tuple(members)
        return found

    def fail(self, index: int, err: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = (index, err)
            self.cond.notify_all()

    def _await(self, ready: Callable[[], bool]) -> None:
        """Wait under the lock until ``ready()``, or raise if the run
        failed (a shard raised, or the calling thread saw it stall)."""
        while not ready():
            if self.error is not None:
                raise _Aborted()
            self.cond.wait()

    def _progressed(self) -> None:
        """Under the lock: the run moved on; wake every waiter."""
        self.progress = time.monotonic()
        self.cond.notify_all()

    def watch(self, threads: Sequence[threading.Thread]) -> None:
        """On the calling thread: wait until every shard returned; raise
        when the run made no progress for ``timeout`` seconds, naming
        what it waits for, after ending every shard's wait."""
        with self.cond:
            while len(self.returned) < len(threads):
                idle = time.monotonic() - self.progress
                if idle >= self.timeout:
                    break
                self.cond.wait(self.timeout - idle)
            else:
                return
            report = self._stall_report()
            if self.error is None:
                self.error = (-1, TimeoutError(report))
            self.cond.notify_all()
        for t in threads:
            t.join(1.0)
        still = [t.name for t in threads if t.is_alive()]
        raise TimeoutError(f"{report}; threads still alive: {still}")

    def _stall_report(self) -> str:
        """Under the lock: each open rendezvous and who it waits for, and
        the shards in their bodies."""
        parts, waiting = [], set()
        for (axes, members, count), slot in self.slots.items():
            gone = [m for i, m in enumerate(members) if i not in slot.here]
            waiting.update(m for i, m in enumerate(members)
                           if i in slot.here and (slot.outputs is None
                                                  or slot.outputs[i]
                                                  is not None))
            what = (f"shards {gone} of {list(members)} missing" if gone
                    else f"shard {members[0]} did not issue it")
            parts.append(f"{slot.op} over {axes} (group {slot.group}, "
                         f"call {count}): {what}")
        busy = [k for k in range(len(self.coords))
                if k not in self.returned and k not in waiting]
        return (f"shard_map over {self.shape}: no progress for "
                f"{self.timeout} s; " + "; ".join(parts)
                + f"; shards in their bodies: {busy}")

    def exchange(self, sh: _Shard, op: str, axes: Tuple[str, ...],
                 operand: Any, issue: Callable) -> Any:
        """Deposit ``operand`` for ``sh``'s group over ``axes``; member 0
        calls ``issue(operands, chips)``, which returns one output per
        member in coordinate order, and each member gets its own."""
        members = self.group(sh.index, axes)
        if len(members) != int(np.prod([self.shape[a] for a in axes])):
            # a run of one group (a recompute) holds no shard off it
            raise RuntimeError(f"{op} over {axes} reaches shards outside "
                               f"this run's {len(self.coords)}")
        pos = members.index(sh.index)
        count = sh.calls.get((axes, members), 0)
        sh.calls[(axes, members)] = count + 1
        key = (axes, members, count)

        with self.cond:
            slot = self.slots.get(key)
            if slot is None:
                slot = self.slots[key] = _Slot(
                    op, len(members),
                    {a: sh.coords[a] for a in AXES if a not in axes})
            if slot.op != op:
                raise RuntimeError(f"shard {sh.index} called {op} over "
                                   f"{axes} where its group called "
                                   f"{slot.op} (call {count})")
            slot.inputs[pos] = operand
            slot.here.add(pos)
            self._progressed()
            if pos == 0:
                self._await(lambda: len(slot.here) == len(members))
        if pos == 0:
            chips = [self.chips[m] for m in members]
            for c, deposit in zip(chips[1:], slot.inputs[1:]):
                _wait(chips[0], c)
                for t in _flatten(deposit):
                    _read_on(t, chips[0])
            outs = issue(slot.inputs, chips)
            for c, out in zip(chips[1:], outs[1:]):
                _wait(c, chips[0])
                for t in _flatten(out):
                    _read_on(t, c)
            with self.cond:
                slot.inputs = None           # the operands' last reference
                slot.outputs = list(outs)
                self._progressed()
        with self.cond:
            self._await(lambda: slot.outputs is not None)
            out = slot.outputs[pos]
            slot.outputs[pos] = None
            slot.taken += 1
            if slot.taken == len(members):
                del self.slots[key]
        return out


def group_call(op: str, axis_name, operand: Any, issue: Callable) -> Any:
    """A collective over ``axis_name``'s group (one axis or several):
    member 0 calls ``issue(operands, chips)`` once for the group (one
    autograd node, so its backward never waits on a peer) and each member
    gets its entry of the returned list.  The ring's flash path is one."""
    sh = current_shard()
    return sh.run.exchange(sh, op, _axes_of(axis_name), operand, issue)


# ---------------------------------------------------------------------- #
# the collectives: one autograd node over the group                      #
# ---------------------------------------------------------------------- #
def _sum_in_order(xs: Sequence[torch.Tensor], chips, at) -> torch.Tensor:
    """x_0 + x_1 + ... in coordinate order, on chip ``at``."""
    acc = _move(xs[0], chips[0], at)
    for x, c in zip(xs[1:], chips[1:]):
        acc = acc + _move(x, c, at)
    return acc


class _Psum(torch.autograd.Function):
    """Every member's output is the sum of the members' operands; the
    cotangent of each operand is the sum of the members' cotangents."""

    @staticmethod
    def forward(ctx, chips, *xs):
        ctx.chips = chips
        total = _sum_in_order(xs, chips, chips[0])
        return tuple([total] + [_private(total, chips[0], c)
                                for c in chips[1:]])

    @staticmethod
    def backward(ctx, *gs):
        chips = ctx.chips
        total = _sum_in_order(gs, chips, chips[0])
        return (None, total) + tuple(_private(total, chips[0], c)
                                     for c in chips[1:])


def psum(x: Any, axis_name) -> Any:
    """The sum of ``x`` over the group of shards that differ only on
    ``axis_name`` (one axis or several), replicated on each member.  A
    Python number is multiplied by the group's size, as ``lax.psum(1,
    axis)`` counts the group."""
    n = axis_size(axis_name)
    if not isinstance(x, torch.Tensor):
        return x * n
    if n == 1:
        return x
    return group_call("psum", axis_name, x,
                     lambda xs, chips: _Psum.apply(chips, *xs))


def pmean(x: Any, axis_name) -> Any:
    """``psum(x) / n`` over the group."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    return psum(x, axis_name) / n


class _Ppermute(torch.autograd.Function):
    """Member ``dst`` receives member ``src``'s operand for each pair of
    ``perm``; a member no pair sends to receives zeros."""

    @staticmethod
    def forward(ctx, chips, perm, *xs):
        ctx.chips, ctx.perm = chips, perm
        src_of = {d: s for s, d in perm}
        return tuple(_private(xs[src_of[j]], chips[src_of[j]], chips[j])
                     if j in src_of else torch.zeros_like(xs[j])
                     for j in range(len(chips)))

    @staticmethod
    def backward(ctx, *gs):
        chips = ctx.chips
        dst_of = dict(ctx.perm)
        return (None, None) + tuple(
            _private(gs[dst_of[i]], chips[dst_of[i]], chips[i])
            if i in dst_of else torch.zeros_like(gs[i])
            for i in range(len(chips)))


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` holds (source, destination) pairs of
    coordinates on ``axis_name``."""
    n = axis_size(axis_name)
    perm = tuple((int(s) % n, int(d) % n) for s, d in perm)
    if len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: a destination repeats in {perm}")
    if n == 1:
        return x if perm else torch.zeros_like(x)
    return group_call("ppermute", axis_name, x,
                     lambda xs, chips: _Ppermute.apply(chips, perm, *xs))


def _all_to_all(xs, chips, split_axis: int, concat_axis: int):
    """Each output on the issuer's device (chip 0), then moved to its
    member."""
    n = len(chips)
    parts = [torch.chunk(_move(x, c, chips[0]), n, dim=split_axis)
             for x, c in zip(xs, chips)]
    return tuple(
        _move(torch.cat([parts[i][j] for i in range(n)], dim=concat_axis),
              chips[0], chips[j])
        for j in range(n))


class _AllToAll(torch.autograd.Function):
    """Member j's output is the concatenation over members i, in order, of
    the j-th of i's ``n`` chunks; the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, chips, split_axis, concat_axis, *xs):
        ctx.chips, ctx.axes = chips, (split_axis, concat_axis)
        return _all_to_all(xs, chips, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, *gs):
        split_axis, concat_axis = ctx.axes
        return (None, None, None) + _all_to_all(gs, ctx.chips, concat_axis,
                                                split_axis)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` is cut into ``n`` chunks
    along ``split_axis``; member j gets every member's j-th chunk,
    concatenated along ``concat_axis`` in member order."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form")
    n = axis_size(axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    if n == 1:
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return group_call("all_to_all", axis_name, x,
                     lambda xs, chips: _AllToAll.apply(
                         chips, split_axis, concat_axis, *xs))


# ---------------------------------------------------------------------- #
# specs: splitting the inputs, assembling the outputs                    #
# ---------------------------------------------------------------------- #
def _entries(spec, ndim: int) -> List[Tuple[str, ...]]:
    """A leaf spec as one tuple of axis names per dimension."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"tensor's {ndim} dimensions")
    out = []
    for e in spec + (None,) * (ndim - len(spec)):
        out.append(() if e is None else _axes_of(e))
    return out


def _is_leaf_spec(spec) -> bool:
    return isinstance(spec, PartitionSpec) or (
        isinstance(spec, tuple)
        and all(e is None or isinstance(e, (str, tuple)) for e in spec)
        and all(isinstance(x, str) for e in spec
                if isinstance(e, tuple) for x in e))


def _pair(spec, tree, where: str) -> List[Tuple[Any, Any]]:
    """The leaves of ``tree`` with each one's leaf spec.  ``spec`` is a
    tree of the same shape (a dict for a dict, a list or plain tuple of
    the same length for a list or tuple), or a leaf spec for the whole
    subtree (a ``PartitionSpec`` always is one)."""
    if isinstance(tree, dict):
        if isinstance(spec, dict):
            if set(spec) != set(tree):
                raise ValueError(f"{where}: spec keys {sorted(spec)} are "
                                 f"not the tree's {sorted(tree)}")
            return [p for k in tree for p in _pair(spec[k], tree[k],
                                                   f"{where}/{k}")]
    elif isinstance(tree, (list, tuple)):
        if isinstance(spec, (list, tuple)) \
                and not isinstance(spec, PartitionSpec) \
                and len(spec) == len(tree):
            return [p for i, (s, t) in enumerate(zip(spec, tree))
                    for p in _pair(s, t, f"{where}[{i}]")]
    else:
        if not _is_leaf_spec(spec):
            raise ValueError(f"{where}: {spec!r} is not a leaf spec")
        return [(tree, spec)]
    if not _is_leaf_spec(spec):
        raise ValueError(f"{where}: {spec!r} does not match the tree")
    return [(t, spec) for t in _flatten(tree)]


def _flatten(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _rebuild(like, leaves) -> Any:
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(like)


class _Layout:
    """How one leaf splits over the mesh: each shard's slice of it."""

    def __init__(self, run: _Run, x: torch.Tensor, spec, where: str):
        entries = _entries(spec, x.dim())
        used = [a for e in entries for a in e]
        if len(set(used)) != len(used):
            raise ValueError(f"{where}: an axis repeats in {spec}")
        self.slices = []
        for cs in run.coords:
            sl = []
            for d, axes in enumerate(entries):
                n = int(np.prod([run.shape[a] for a in axes]))
                if x.shape[d] % n:
                    raise ValueError(f"{where}: dimension {d} of "
                                     f"{tuple(x.shape)} does not split "
                                     f"{n} ways over {axes}")
                i = 0
                for a in axes:
                    i = i * run.shape[a] + cs[a]
                size = x.shape[d] // n
                sl.append(slice(i * size, (i + 1) * size))
            self.slices.append(tuple(sl))


class _Scatter(torch.autograd.Function):
    """The differentiable leaves split over every shard in one node; its
    backward sums each leaf's cotangents in shard coordinate order."""

    @staticmethod
    def forward(ctx, run, home, layouts, *xs):
        ctx.run, ctx.home, ctx.layouts = run, home, layouts
        ctx.shapes = [x.shape for x in xs]
        outs = []
        for k, chip in enumerate(run.chips):
            for x, lay in zip(xs, layouts):
                part = _move(x[lay.slices[k]], home, chip)
                if part.device == x.device:
                    _read_on(x, chip)
                outs.append(part)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        run, home, layouts = ctx.run, ctx.home, ctx.layouts
        n = len(layouts)
        grads = []
        for i, lay in enumerate(layouts):
            g = None
            for k, chip in enumerate(run.chips):
                part = _move(gs[k * n + i], chip, home)
                if g is None:
                    g = torch.zeros(ctx.shapes[i], dtype=part.dtype,
                                    device=part.device)
                g[lay.slices[k]] += part
            grads.append(g)
        return (None, None, None) + tuple(grads)


def _assemble(run: _Run, parts: List[Any], spec, where: str,
              dst) -> Any:
    """One output leaf from every shard's: replicated axes take
    coordinate 0's value (shard 0's for a fully replicated leaf), split
    dimensions concatenate in coordinate order, on ``dst``'s device."""
    first = parts[0]
    if not isinstance(first, torch.Tensor):
        return first
    entries = _entries(spec, first.dim())
    used = {a for e in entries for a in e}
    blocks = {}
    for k, cs in enumerate(run.coords):
        if any(cs[a] for a in AXES if a not in used):
            continue
        key = []
        for axes in entries:
            i = 0
            for a in axes:
                i = i * run.shape[a] + cs[a]
            key.append(i)
        blocks[tuple(key)] = _move(parts[k], run.chips[k], dst)
    split = [d for d, axes in enumerate(entries) if axes]

    def build(prefix: Dict[int, int], level: int) -> torch.Tensor:
        if level == len(split):
            return blocks[tuple(prefix.get(d, 0)
                                for d in range(len(entries)))]
        d = split[level]
        n = int(np.prod([run.shape[a] for a in entries[d]]))
        return torch.cat([build({**prefix, d: i}, level + 1)
                          for i in range(n)], dim=d)

    return build({}, 0)


# ---------------------------------------------------------------------- #
# the executor                                                           #
# ---------------------------------------------------------------------- #
def shard_map(f: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``f`` run once per shard of ``mesh`` on that shard's slices of the
    arguments (split by ``in_specs``: a leaf spec for every argument, or
    one spec tree per argument), its outputs assembled by ``out_specs``.
    Differentiable through every split, collective and assembly; see the
    module docstring for the threads, the rendezvous and the graph."""

    def call(*args):
        if mesh.size == 1:
            return _run_one(f, mesh, args)
        return _run_threads(f, mesh, in_specs, out_specs, args)

    return call


def _run_one(f, mesh, args):
    """A mesh of one chip: the body on the calling thread, as is."""
    prev = current_shard()
    _tls.shard = _Shard(_Run.of_mesh(mesh), 0)
    try:
        return f(*args)
    finally:
        _tls.shard = prev


def _arg_specs(in_specs, args) -> List[Any]:
    if isinstance(in_specs, PartitionSpec):
        return [in_specs] * len(args)
    specs = list(in_specs)
    if len(specs) != len(args):
        raise ValueError(f"shard_map: {len(specs)} in_specs for "
                         f"{len(args)} arguments")
    return specs


def _run_threads(f, mesh, in_specs, out_specs, args):
    if current_shard() is not None:
        raise RuntimeError("shard_map: a shard cannot start another mesh")
    run = _Run.of_mesh(mesh)
    home = run.chips[0]
    pairs = [p for i, (s, a) in enumerate(zip(_arg_specs(in_specs, args),
                                               args))
             for p in _pair(s, a, f"in_specs[{i}]")]
    leaves = [x for x, _ in pairs]
    layouts = [_Layout(run, x, s, "in_specs")
               if isinstance(x, torch.Tensor) else None for x, s in pairs]
    grad = torch.is_grad_enabled()
    infer = torch.is_inference_mode_enabled()
    diff = [i for i, x in enumerate(leaves) if grad and
            isinstance(x, torch.Tensor) and x.requires_grad]
    # every chip's stream starts after the caller's work on its device
    caller = {}
    for c in run.chips:
        if c.device.type == "cuda" and c.device not in caller:
            caller[c.device] = torch.cuda.current_stream(c.device)
    for c in run.chips:
        for s in caller.values():
            cs = _stream(c)
            if cs is not None and cs != s and cs.device == s.device:
                cs.wait_stream(s)

    def shard_args(sh: _Shard) -> List[Any]:
        k = sh.index
        mine = list(leaves)
        for i, (x, lay) in enumerate(zip(leaves, layouts)):
            if lay is not None and i not in diff:
                mine[i] = _move(x[lay.slices[k]], home, sh.chip)
                _read_on(x, sh.chip)
        if diff:
            parts = run.exchange(
                sh, "scatter", AXES, None,
                lambda _ops, _chips: _split(
                    _Scatter.apply(run, home, [layouts[i] for i in diff],
                                   *[leaves[i] for i in diff]),
                    len(diff)))
            for i, part in zip(diff, parts):
                mine[i] = part
        out, it = [], iter(mine)
        for a in args:
            n = len(_flatten(a))
            out.append(_rebuild(a, [next(it) for _ in range(n)]))
        return out

    results = _run_bodies(run, lambda sh: f(*shard_args(sh)), grad, infer,
                          f"a mesh {mesh.shape}")
    # the caller's streams wait for every chip's
    for c in run.chips:
        s, cs = caller.get(c.device), _stream(c)
        if s is not None and cs is not None and cs != s:
            s.wait_stream(cs)
    out_like = results[0]
    per_shard = [_flatten(r) for r in results]
    specs = [s for _, s in _pair(out_specs, out_like, "out_specs")]
    assembled = []
    for i, spec in enumerate(specs):
        parts = [p[i] for p in per_shard]
        for t in parts:     # read (or handed over) on the caller's stream
            if isinstance(t, torch.Tensor) and t.device in caller:
                t.record_stream(caller[t.device])
        assembled.append(_assemble(run, parts, spec, f"out_specs[{i}]",
                                   home))
    return _rebuild(out_like, assembled)


def _run_bodies(run: _Run, body: Callable[[_Shard], Any], grad: bool,
                infer: bool, what: str) -> List[Any]:
    """``body(shard)`` once per shard of ``run``, each on a thread of its
    own bound to its chip, watched by the calling thread (see
    ``_Run.watch``); returns their results in shard order.  The first
    error a shard raised is raised here, noting the shard and ``what``
    ran."""
    results: List[Any] = [None] * len(run.coords)

    def main(k: int) -> None:
        sh = _tls.shard = _Shard(run, k)
        try:
            with _on_chip(sh.chip), torch.inference_mode(infer), \
                    torch.set_grad_enabled(grad):
                results[k] = body(sh)
        except _Aborted:
            pass
        except BaseException as err:   # handed to the caller below
            run.fail(k, err)
        finally:
            _tls.shard = None
            with run.cond:
                run.returned.add(k)
                run._progressed()

    threads = [threading.Thread(target=main, args=(k,), daemon=True,
                                name=f"ptt-shard-{k}")
               for k in range(len(run.coords))]
    for t in threads:
        t.start()
    run.watch(threads)
    for t in threads:
        t.join()
    if run.error is not None:
        k, err = run.error
        if k >= 0:
            err.add_note(f"raised in shard {k} {run.coords[k]} of {what}")
        raise err
    return results


# ---------------------------------------------------------------------- #
# recomputation: remat of a function whose collectives span a group      #
# ---------------------------------------------------------------------- #
def _detached(x: Any) -> Any:
    """A leaf of ``x``'s values with its requires_grad (non-tensors as
    they are)."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.detach().requires_grad_(x.requires_grad)


class _RematPlan:
    """What a group's remat node needs to run its members again: the
    function, the arguments' tree shape, each member's non-tensor leaves
    (its tensors are the node's saved inputs), and the group's
    coordinates and chips (a run of the group alone)."""

    def __init__(self, fn, args_like, deposits, run: _Run,
                 members: Tuple[int, ...], chips) -> None:
        self.fn, self.args_like = fn, args_like
        self.tensor_pos = [i for i, x in enumerate(deposits[0][0])
                           if isinstance(x, torch.Tensor)]
        self.leaves = [[None if i in self.tensor_pos else x
                        for i, x in enumerate(d[0])] for d in deposits]
        self.outs: Optional[List[Any]] = [(d[1], d[2]) for d in deposits]
        self.n_out = len(deposits[0][1])
        self.shape = run.shape
        self.coords = [run.coords[m] for m in members]
        self.chips = list(chips)


class _RematGroup(torch.autograd.Function):
    """One node over a group of shards that ran ``fn`` (see :func:`remat`):
    its inputs are every member's tensor arguments in coordinate order,
    its outputs every member's results, computed before the node was
    made; it keeps only the inputs."""

    @staticmethod
    def forward(ctx, plan, *ins):
        ctx.plan = plan
        ctx.save_for_backward(*ins)
        outs, diff = [], []
        for member, flags in plan.outs:
            outs += member
            diff += flags
        plan.outs = None       # the node holds its inputs only
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, diff)
                                      if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        plan = ctx.plan
        saved = ctx.saved_tensors
        n_in, n_out = len(plan.tensor_pos), plan.n_out
        chips = plan.chips
        entry = _autograd_streams(chips)
        members = []
        for k, chip in enumerate(chips):
            leaves = list(plan.leaves[k])
            for j, pos in enumerate(plan.tensor_pos):
                leaves[pos] = saved[k * n_in + j]
            with _on_chip(chip):
                for e in entry:
                    _wait(chip, e)
                for t in list(gs[k * n_out:(k + 1) * n_out]) + leaves:
                    _read_on(t, chip)
            members.append(leaves)

        def again(sh: _Shard):
            leaves = [_detached(x) for x in members[sh.index]]
            out = plan.fn(*_rebuild(plan.args_like, leaves))
            return leaves, _flatten(out)

        redone = _run_bodies(_Run(plan.shape, plan.coords, chips), again,
                             True, False, "a remat recompute")
        outs, cots, wrt = [], [], []
        for k, (leaves, out) in enumerate(redone):
            for o, g in zip(out, gs[k * n_out:(k + 1) * n_out]):
                if o.requires_grad and g is not None:
                    outs.append(o)
                    cots.append(g)
            wrt += [leaves[pos] for pos in plan.tensor_pos]
        need = [i for i, x in enumerate(wrt) if x.requires_grad]
        grads: List[Any] = [None] * len(wrt)
        if outs and need:
            got = torch.autograd.grad(outs, [wrt[i] for i in need], cots,
                                      allow_unused=True)
            for i, g in zip(need, got):
                grads[i] = g
        for chip in chips:
            for e in entry:
                _wait(e, chip)
        for g in grads:
            for e in entry:
                _read_on(g, e)
        return (None,) + tuple(grads)


def remat(fn: Callable, axis_name, *args) -> Any:
    """``fn(*args)`` in a shard, recomputed in the backward, where ``fn``
    holds collectives over ``axis_name``'s group (one axis or several; a
    collective over another axis raises in the recompute).  ``fn``
    returns a tensor or a tree of tensors.

    The forward runs ``fn`` as a plain call would (grad mode on, the
    same kernels), keeps its results and drops its graph; the group's
    members then make ONE autograd node that keeps only their arguments.
    Its backward runs every member's ``fn`` again, each on a thread of
    its own bound to its chip, in a run of the group alone at the
    forward's coordinates (so its collectives rejoin their group, in the
    same order on the same shapes), and backpropagates through all of
    them in one call.  ``torch.utils.checkpoint`` cannot: it recomputes
    on autograd's thread, outside every shard."""
    sh = current_shard()
    axes = _axes_of(axis_name)
    leaves = _flatten(args)
    with torch.enable_grad():
        out = fn(*_rebuild(args, [_detached(x) for x in leaves]))
    flat = _flatten(out)
    deposit = (leaves, [o.detach() for o in flat],
               [o.requires_grad for o in flat])
    out_like = _rebuild(out, [None] * len(flat))
    args_like = _rebuild(args, [None] * len(leaves))
    del out, flat              # the forward's graph goes here

    def issue(deposits, chips):
        members = sh.run.group(sh.index, axes)
        plan = _RematPlan(fn, args_like, deposits, sh.run, members, chips)
        ins = [d[0][i] for d in deposits for i in plan.tensor_pos]
        n = plan.n_out
        got = _RematGroup.apply(plan, *ins)
        return [list(got[k * n:(k + 1) * n]) for k in range(len(chips))]

    got = sh.run.exchange(sh, "remat", axes, deposit, issue)
    return _rebuild(out_like, got)


def _split(outs: Tuple[torch.Tensor, ...], n: int) -> List[List[Any]]:
    return [list(outs[k * n:(k + 1) * n]) for k in range(len(outs) // n)]
