"""Batch- and stream-safety lint over PTG BODY code and DTD chore functions.

The device layer (devices/cuda.py + devices/batching.py) decides per
class at dispatch time: a ``this_task`` read withholds the class's batch
spec (``dsl/ptg/runtime.py`` ``_device_batch_spec``), a host sync inside
a device body stalls the module's stream, and whole-graph capture
(dsl/graph.py) refuses a body that syncs with the host. This pass
predicts those costs statically from the stdlib ``ast`` of the body
source, so a spec author learns them before the first run.

Finding codes (BDY2xx, the JAX package's numbering):

- ``BDY200`` body-syntax: the body is not valid Python.
- ``BDY201`` this-task: a device body reads ``this_task`` — the class
  NEVER batches (no batch spec is built; every instance pays its own
  dispatch).
- ``BDY202`` host-sync: a device body forces the host to wait for the
  card — a numpy call on a flow payload, ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``print``/``open``/``input``, or an
  ``if``/``while`` whose test reads a flow payload. Each stalls the
  module's stream mid-dispatch and makes whole-graph capture raise
  ``CaptureError`` for the class. (The JAX package's layer downgrades
  such a class to per-task dispatch instead; this one never downgrades.)
- ``BDY203`` nondeterminism: a device body reads wall-clock time or an
  unseeded random stream — grouped dispatches lose the bit-exact
  batched-vs-per-task guarantee.
- ``BDY204`` aliased-args (note): two flows of one class read the same
  memory tile, so one device buffer sits at two argument slots. The
  stage compiler (stagec/runtime.py) keeps donation off for every stage
  holding such a class (``stage_compile_donate``); per-task donation is
  refused outright by this package (``device_donate`` raises).
- ``BDY205`` missing-write (warn): a device body never assigns one of
  its written (RW/WRITE) flow names — the staged-out "result" is the
  unmodified input.

Only accelerator bodies (``BODY [type=cuda]``) are checked: host bodies
run on the interpreter where all of this is legal.
"""
from __future__ import annotations

import ast as pyast
import inspect
import textwrap
from typing import Callable, List, Optional, Sequence, Set, Tuple

from ..dsl.ptg.ast import JDFFile, RangeExpr, TaskClassAST
from . import Finding

#: the device type whose bodies run on the accelerator module
DEVICE_TYPE = "cuda"
#: attribute roots whose call on a flow payload pulls it to the host
_HOST_ROOTS = {"np", "numpy"}
#: builtins whose call in a device body synchronises with the host
_HOST_CALLS = {"print", "open", "input"}
#: tensor methods that copy a device tensor to the host
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: attribute roots that make a body nondeterministic across dispatches
_NONDET_ROOTS = {"random", "time", "datetime", "uuid"}

_SYNC_COST = ("it stalls the device module's stream mid-dispatch and "
              "whole-graph capture raises CaptureError for the class")


def _attr_chain(node: pyast.AST) -> List[str]:
    """``np.random.rand`` -> ["np", "random", "rand"]; [] if not a
    simple name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, pyast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, pyast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _names_under(node: pyast.AST) -> Set[str]:
    return {n.id for n in pyast.walk(node) if isinstance(n, pyast.Name)}


def _call_args_names(node: pyast.Call) -> Set[str]:
    out: Set[str] = set()
    for a in list(node.args) + [k.value for k in node.keywords]:
        out |= _names_under(a)
    return out


def _check_device_source(tree: pyast.AST, where: str, label: str,
                         flow_names: Sequence[str],
                         findings: List[Finding]) -> None:
    """The host-sync and nondeterminism predicates shared by PTG device
    bodies and DTD chore functions."""
    flow_set = set(flow_names)
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Call):
            func = node.func
            if isinstance(func, pyast.Attribute) \
                    and func.attr in _HOST_METHODS:
                # on any receiver, a call result included (x.sum().item())
                findings.append(Finding(
                    "BDY202",
                    f"{label}: .{func.attr}() copies a device tensor to "
                    f"the host — {_SYNC_COST}", where, severity="warn"))
                continue
            chain = _attr_chain(func)
            if not chain:
                continue
            root = chain[0]
            if len(chain) == 1 and root in _HOST_CALLS:
                findings.append(Finding(
                    "BDY202",
                    f"{label}: call to {root}() syncs with the host — "
                    f"{_SYNC_COST}", where, severity="warn"))
            elif root in _HOST_ROOTS:
                if len(chain) > 1 and chain[1] == "random":
                    findings.append(Finding(
                        "BDY203",
                        f"{label}: {'.'.join(chain)}(...) draws from a "
                        f"process-global random stream — grouped "
                        f"dispatches lose bit-exact reproducibility "
                        f"(pass a seeded generator's draw as a flow)",
                        where, severity="warn"))
                elif _call_args_names(node) & flow_set:
                    findings.append(Finding(
                        "BDY202",
                        f"{label}: {'.'.join(chain)}(...) on a flow "
                        f"payload copies the device tensor to the host "
                        f"— {_SYNC_COST} (use torch.*)",
                        where, severity="warn"))
            elif root in _NONDET_ROOTS:
                findings.append(Finding(
                    "BDY203",
                    f"{label}: {'.'.join(chain)}(...) is "
                    f"nondeterministic — grouped dispatches lose the "
                    f"bit-exact batched-vs-per-task guarantee",
                    where, severity="warn"))
        elif isinstance(node, (pyast.If, pyast.While)):
            hot = _names_under(node.test) & flow_set
            if hot:
                findings.append(Finding(
                    "BDY202",
                    f"{label}: {'if' if isinstance(node, pyast.If) else 'while'} "
                    f"on flow payload {sorted(hot)} reads a device value "
                    f"on the host — {_SYNC_COST} (use torch.where)",
                    where, severity="warn"))


def _assigned_names(tree: pyast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in pyast.walk(tree):
        targets: List[pyast.AST] = []
        if isinstance(node, pyast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (pyast.AugAssign, pyast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for el in pyast.walk(t):
                if isinstance(el, pyast.Name):
                    out.add(el.id)
                elif isinstance(el, pyast.Subscript) and \
                        isinstance(el.value, pyast.Name):
                    out.add(el.value.id)  # A[...] = / A[...] +=
    return out


def _aliased_tiles(tc: TaskClassAST) -> List[Tuple[str, str, str]]:
    """Pairs of non-CTL flows whose in-deps read a textually identical
    memory tile: (flow_a, flow_b, "coll(args)")."""
    def norm(t) -> Optional[str]:
        if t is None or t.kind != "memory":
            return None
        args = []
        for a in t.args:
            if isinstance(a, RangeExpr):
                return None  # broadcast range: not a single tile
            args.append(a.src.replace(" ", ""))
        return f"{t.collection}({','.join(args)})"

    tiles: List[Tuple[str, str]] = []
    for f in tc.flows:
        if f.is_ctl:
            continue
        for d in f.deps_in():
            for t in (d.target, d.alt_target):
                key = norm(t)
                if key is not None:
                    tiles.append((f.name, key))
    out: List[Tuple[str, str, str]] = []
    for i, (fa, ka) in enumerate(tiles):
        for fb, kb in tiles[i + 1:]:
            if ka == kb and fa != fb:
                out.append((fa, fb, ka))
    return out


def check_jdf_bodies(jdf: JDFFile, name: Optional[str] = None
                     ) -> List[Finding]:
    """Lint every accelerator BODY of a parsed JDF."""
    name = name or jdf.name
    findings: List[Finding] = []
    for tc in jdf.task_classes:
        flow_names = [f.name for f in tc.flows if not f.is_ctl]
        written = [f.name for f in tc.flows
                   if not f.is_ctl and f.access in ("RW", "WRITE")]
        for fa, fb, tile in _aliased_tiles(tc):
            findings.append(Finding(
                "BDY204",
                f"{tc.name}: flows {fa!r} and {fb!r} read the same tile "
                f"{tile} — one device buffer sits at two argument slots "
                f"(compiled stages holding this class do not donate; "
                f"per-task donation is refused: device_donate "
                f"raises)", f"{name} {tc.name}", severity="note"))
        for b in tc.bodies:
            if b.device_type != DEVICE_TYPE:
                continue  # host bodies: everything here is legal
            where = f"{name}:{b.line} {tc.name}.BODY" if b.line else \
                f"{name} {tc.name}.BODY"
            label = f"{tc.name} BODY[{b.device_type}]"
            try:
                tree = pyast.parse(b.code)
            except SyntaxError as exc:
                findings.append(Finding(
                    "BDY200", f"{label}: body is not valid Python: {exc}",
                    where))
                continue
            if "this_task" in _names_under(tree):
                findings.append(Finding(
                    "BDY201",
                    f"{label}: reads this_task (per-task runtime "
                    f"state) — the class NEVER batches: no batch spec "
                    f"is built, every instance pays its own dispatch",
                    where, severity="warn"))
            _check_device_source(tree, where, label, flow_names, findings)
            if written and not (_assigned_names(tree) & set(written)):
                findings.append(Finding(
                    "BDY205",
                    f"{label}: never assigns any written flow "
                    f"({', '.join(written)}) — the staged-out result "
                    f"is the unmodified input", where, severity="warn"))
    return findings


def check_function(fn: Callable | str, name: Optional[str] = None,
                   device: bool = True) -> List[Finding]:
    """Lint a DTD task function (or raw function source) with the same
    predicates. ``device=True`` assumes the function runs as a CUDA
    chore (``add_chore``), where host syncs matter; host-only task
    functions can pass ``device=False`` to get only the nondeterminism
    checks."""
    if callable(fn):
        label = name or getattr(fn, "__name__", "task_fn")
        try:
            src = textwrap.dedent(inspect.getsource(fn))
        except (OSError, TypeError):
            return [Finding("BDY200", f"{label}: source unavailable "
                            f"(lambda/builtin?)", label, severity="note")]
    else:
        src = textwrap.dedent(fn)
        label = name or "task_fn"
    try:
        tree = pyast.parse(src)
    except SyntaxError as exc:
        return [Finding("BDY200", f"{label}: not valid Python: {exc}",
                        label)]
    findings: List[Finding] = []
    # DTD payload args: the function's positional parameters stand in
    # for flow payloads
    params: List[str] = []
    for node in pyast.walk(tree):
        if isinstance(node, (pyast.FunctionDef, pyast.AsyncFunctionDef)):
            params = [a.arg for a in node.args.args]
            break
    if "this_task" in params or "this_task" in _names_under(tree):
        findings.append(Finding(
            "BDY201", f"{label}: reads this_task — the class never "
            f"batches (per-task dispatch only)", label, severity="warn"))
    dev_findings: List[Finding] = []
    _check_device_source(tree, label, label, params, dev_findings)
    findings.extend(f for f in dev_findings
                    if device or f.code == "BDY203")
    return findings
