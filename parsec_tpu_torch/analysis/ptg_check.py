"""Compile-time JDF dataflow verification (the ``jdf_sanity_checks`` analog).

Operates on the parsed AST (:mod:`..dsl.ptg.ast`) — everything here runs
before a taskpool is instantiated, so a mis-written spec fails in
milliseconds at compile time instead of hanging a multirank run.

Finding codes (PTG1xx; see docs/guide.md):

- ``PTG100`` parse-error: the text does not parse as JDF at all.
- ``PTG101`` dangling-endpoint: a dep names an unknown task class, an
  unknown flow of a known class, or an unknown collection global.
- ``PTG102`` ctl-data-mismatch: a CTL flow is wired to a data flow (or
  vice versa) — control edges carry no payload.
- ``PTG103`` write-endpoint: an out-dep feeds data into a WRITE-only
  peer flow.  WRITE flows *produce* values (their inputs are ``NEW`` or
  nothing); data arriving over such an edge is silently dropped.
- ``PTG104`` arity-mismatch: a task dep-target's argument count differs
  from the target class's parameter list.
- ``PTG105`` non-reciprocal-dep: ``A.X -> B.Y`` without a matching
  ``B.Y <- A.X`` (or an in-dep without the producer's out-dep).
  Activations are producer-driven and input counts consumer-declared,
  so a one-sided edge is a lost activation or an input that never
  arrives — at runtime, a hang.
- ``PTG106`` unused-global (warn): a declared global referenced by no
  expression, body, affinity, or dep property.
- ``PTG107`` unused-local (warn): a non-parameter local referenced
  nowhere (parameters are exempt: they name the instance space).
- ``PTG108`` unsatisfiable-guard: a dep guard that is statically false
  (constant-false, or a self-comparison like ``k < k``) — the edge can
  never fire.
- ``PTG109`` dependency-cycle: a concrete instantiation of the graph
  (enumerated via :mod:`.dagenum`) has a CTL/data cycle.
- ``PTG180`` enumeration-skipped (note): the cycle pass could not
  instantiate the spec with the provided globals.
"""
from __future__ import annotations

import ast as pyast
import re
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..dsl.ptg.ast import (DepAST, DepTarget, Expr, JDFFile, RangeExpr,
                           TaskClassAST)
from . import Finding


# --------------------------------------------------------------------- #
# helpers                                                               #
# --------------------------------------------------------------------- #
def _names_in(src: Optional[str]) -> Set[str]:
    """All identifier names (including attribute roots) in a Python
    expression/statement source.  Over-approximates usage, which is the
    right direction for unused-symbol checks (no false positives)."""
    if not src:
        return set()
    try:
        tree = pyast.parse(src)
    except SyntaxError:
        # not Python (a dep property such as shape="MB x NB"): every
        # identifier-shaped token counts as a use
        return set(re.findall(r"[A-Za-z_]\w*", src))
    return {n.id for n in pyast.walk(tree) if isinstance(n, pyast.Name)}


def _expr_names(e: Any) -> Set[str]:
    if e is None:
        return set()
    if isinstance(e, RangeExpr):
        out = _expr_names(e.lo) | _expr_names(e.hi)
        if e.step is not None:
            out |= _expr_names(e.step)
        return out
    if isinstance(e, Expr):
        return _names_in(e.src)
    return set()


def _dep_origin(d: DepAST, fallback: str = "") -> str:
    """Best source location for a dep: any Expr the parser stamped."""
    cands: List[Any] = [d.guard]
    for t in (d.target, d.alt_target):
        if t is not None:
            for a in t.args:
                cands.append(a.lo if isinstance(a, RangeExpr) else a)
    for c in cands:
        o = getattr(c, "origin", None)
        if o:
            return o
    return fallback


def _targets(d: DepAST) -> Iterable[DepTarget]:
    for t in (d.target, d.alt_target):
        if t is not None:
            yield t


# --------------------------------------------------------------------- #
# pass 1: endpoint existence / direction / arity                        #
# --------------------------------------------------------------------- #
def _check_endpoints(jdf: JDFFile, findings: List[Finding]) -> None:
    gnames = {g.name for g in jdf.globals}
    classes = {tc.name: tc for tc in jdf.task_classes}
    for tc in jdf.task_classes:
        for f in tc.flows:
            for d in f.deps:
                where = _dep_origin(d, f"{jdf.name} {tc.name}.{f.name}")
                for t in _targets(d):
                    if t.kind == "memory":
                        if t.collection not in gnames:
                            findings.append(Finding(
                                "PTG101",
                                f"{tc.name}.{f.name}: dep references "
                                f"unknown collection {t.collection!r}",
                                where))
                        continue
                    if t.kind != "task":
                        continue
                    peer = classes.get(t.task_class)
                    if peer is None:
                        findings.append(Finding(
                            "PTG101",
                            f"{tc.name}.{f.name}: dep targets unknown "
                            f"task class {t.task_class!r}", where))
                        continue
                    pf = next((x for x in peer.flows if x.name == t.flow),
                              None)
                    if pf is None:
                        findings.append(Finding(
                            "PTG101",
                            f"{tc.name}.{f.name}: dep targets unknown "
                            f"flow {t.task_class}.{t.flow}", where))
                        continue
                    if f.is_ctl != pf.is_ctl:
                        findings.append(Finding(
                            "PTG102",
                            f"{tc.name}.{f.name} ({f.access}) is wired "
                            f"to {t.task_class}.{t.flow} ({pf.access}): "
                            f"CTL flows only connect to CTL flows",
                            where))
                    if d.direction == "out" and pf.access == "WRITE" \
                            and not f.is_ctl:
                        findings.append(Finding(
                            "PTG103",
                            f"{tc.name}.{f.name} -> {t.task_class}."
                            f"{t.flow}: target flow is WRITE-only and "
                            f"takes no input — the sent data is dropped",
                            where))
                    if len(t.args) != len(peer.params):
                        findings.append(Finding(
                            "PTG104",
                            f"{tc.name}.{f.name}: dep target "
                            f"{t.task_class}({len(t.args)} args) does "
                            f"not match its parameter list "
                            f"({', '.join(peer.params)})", where))


# --------------------------------------------------------------------- #
# pass 2: dependency reciprocity                                        #
# --------------------------------------------------------------------- #
def _check_reciprocity(jdf: JDFFile, findings: List[Finding]) -> None:
    classes = {tc.name for tc in jdf.task_classes}
    outs: Dict[Tuple[str, str, str, str], str] = {}
    ins: Dict[Tuple[str, str, str, str], str] = {}
    for tc in jdf.task_classes:
        for f in tc.flows:
            for d in f.deps:
                for t in _targets(d):
                    if t.kind != "task" or t.task_class not in classes:
                        continue
                    key = (tc.name, f.name, t.task_class, t.flow)
                    where = _dep_origin(d, f"{jdf.name} {tc.name}.{f.name}")
                    (outs if d.direction == "out" else ins).setdefault(
                        key, where)
    for (a, af, b, bf), where in outs.items():
        if (b, bf, a, af) not in ins:
            findings.append(Finding(
                "PTG105",
                f"{a}.{af} -> {b}.{bf} has no matching inbound dep "
                f"({b}.{bf} never lists <- {af} {a}(...)): the "
                f"activation is sent but never counted — at runtime, "
                f"a lost input or a hang", where))
    for (b, bf, a, af), where in ins.items():
        if (a, af, b, bf) not in outs:
            findings.append(Finding(
                "PTG105",
                f"{b}.{bf} <- {af} {a}(...) has no matching outbound "
                f"dep ({a}.{af} never lists -> {bf} {b}(...)): the "
                f"input is counted but never produced — at runtime, "
                f"a hang", where))


# --------------------------------------------------------------------- #
# pass 3: unused globals / locals                                       #
# --------------------------------------------------------------------- #
def _all_referenced(jdf: JDFFile) -> Set[str]:
    used: Set[str] = set()
    for block in list(jdf.prologue) + list(jdf.epilogue):
        used |= _names_in(block)
    for g in jdf.globals:
        d = g.properties.get("default")
        if d is not None:
            used |= _names_in(d)
    for tc in jdf.task_classes:
        used |= _class_referenced(tc)
        if tc.affinity_collection:
            used.add(tc.affinity_collection)
    return used


def _class_referenced(tc: TaskClassAST) -> Set[str]:
    """Names referenced by a class's expressions, bodies, and deps."""
    used: Set[str] = set()
    for ld in tc.locals:
        if ld.range is not None:
            used |= _expr_names(ld.range)
        if ld.expr is not None:
            used |= _expr_names(ld.expr)
    for e in tc.affinity_args:
        used |= _expr_names(e)
    used |= _expr_names(tc.priority)
    for f in tc.flows:
        for d in f.deps:
            used |= _expr_names(d.guard)
            for t in _targets(d):
                if t.kind == "memory" and t.collection:
                    used.add(t.collection)
                for a in t.args:
                    used |= _expr_names(a)
            for pv in d.properties.values():
                used |= _names_in(pv)
    for b in tc.bodies:
        used |= _names_in(b.code)
    return used


def _check_unused(jdf: JDFFile, findings: List[Finding]) -> None:
    used = _all_referenced(jdf)
    for g in jdf.globals:
        if g.hidden or g.name in used:
            continue
        findings.append(Finding(
            "PTG106", f"global {g.name!r} is never referenced by any "
            f"expression, body, affinity, or dep property",
            f"{jdf.name} {g.name}", severity="warn"))
    for tc in jdf.task_classes:
        cused = _class_referenced(tc)
        for ld in tc.locals:
            if ld.name in tc.params or ld.name in cused:
                continue
            kind = "derived local" if ld.range is None else "range local"
            findings.append(Finding(
                "PTG107", f"{tc.name}: {kind} {ld.name!r} is never "
                f"referenced" + ("" if ld.range is None else
                                 " (it multiplies the instance space "
                                 "with identical copies)"),
                f"{jdf.name} {tc.name}", severity="warn"))


# --------------------------------------------------------------------- #
# pass 4: statically-unsatisfiable guards                               #
# --------------------------------------------------------------------- #
_NEVER_OPS = (pyast.Lt, pyast.Gt, pyast.NotEq)


def _guard_unsat(src: str) -> Optional[str]:
    try:
        tree = pyast.parse(src, mode="eval").body
    except SyntaxError:
        return None
    if isinstance(tree, pyast.Constant) and not tree.value:
        return f"guard {src!r} is constant false"
    if isinstance(tree, pyast.Compare) and len(tree.ops) == 1 \
            and isinstance(tree.ops[0], _NEVER_OPS) \
            and pyast.dump(tree.left) == pyast.dump(tree.comparators[0]):
        return f"guard {src!r} compares an expression against itself"
    return None


def _check_guards(jdf: JDFFile, findings: List[Finding]) -> None:
    for tc in jdf.task_classes:
        for f in tc.flows:
            for d in f.deps:
                if d.guard is None:
                    continue
                why = _guard_unsat(d.guard.src)
                if why:
                    findings.append(Finding(
                        "PTG108",
                        f"{tc.name}.{f.name}: {why} — the "
                        f"{'alternative' if d.alt_target else 'edge'} "
                        f"can never fire",
                        _dep_origin(d, f"{jdf.name} {tc.name}.{f.name}")))


# --------------------------------------------------------------------- #
# pass 5: cycle detection via concrete enumeration                      #
# --------------------------------------------------------------------- #
def default_enum_env(jdf: JDFFile, int_default: int = 4) -> Dict[str, Any]:
    """Small concrete global bindings for cycle enumeration: declared
    defaults evaluate first; remaining int-typed (or untyped, non-
    collection) globals bind to ``int_default``.  Collection globals are
    left for the enumerator's dummy-collection synthesis."""
    env: Dict[str, Any] = {}
    for g in jdf.globals:
        if g.properties.get("type") == "collection":
            continue
        d = g.properties.get("default")
        if d is not None:
            try:
                env[g.name] = Expr(d)(dict(env))
                continue
            except Exception:
                pass
        env[g.name] = int_default
    return env


def check_cycles(text: str, name: str = "jdf",
                 env: Optional[Dict[str, Any]] = None,
                 tiles: Tuple[int, int] = (4, 4),
                 jdf: Optional[JDFFile] = None) -> List[Finding]:
    """Enumerate one small concrete instantiation of the spec and report
    a PTG109 on a dependency cycle (over :mod:`.dagenum`). ``jdf`` skips
    the re-parse when the caller already holds the AST."""
    from ..dsl.graph import CaptureError
    from . import dagenum
    try:
        from ..dsl import ptg
        factory = ptg.JDFFactory(jdf) if jdf is not None \
            else ptg.compile_jdf(text, name=name)
        if env is None:
            env = default_enum_env(factory.jdf)
        dagenum.enumerate_factory(factory, env, tiles[0], tiles[1])
    except CaptureError as exc:
        if "cycle" in str(exc):
            return [Finding(
                "PTG109", f"dependency cycle in the enumerated instance "
                f"graph ({exc})", name)]
        return [Finding("PTG180", f"cycle enumeration failed: {exc}",
                        name, severity="note")]
    except Exception as exc:
        return [Finding("PTG180", f"cycle enumeration failed: "
                        f"{type(exc).__name__}: {exc}", name,
                        severity="note")]
    return []


# --------------------------------------------------------------------- #
# public API                                                            #
# --------------------------------------------------------------------- #
def verify_jdf(jdf: JDFFile) -> List[Finding]:
    """All static AST passes (no enumeration) over a parsed JDF."""
    findings: List[Finding] = []
    _check_endpoints(jdf, findings)
    _check_reciprocity(jdf, findings)
    _check_unused(jdf, findings)
    _check_guards(jdf, findings)
    return findings


def verify_jdf_text(text: str, name: str = "jdf",
                    enum_env: Optional[Dict[str, Any]] = None,
                    cycles: bool = True,
                    jdf: Optional[JDFFile] = None) -> List[Finding]:
    """Parse + verify JDF source text.  Parse failures come back as
    findings (PTG100/PTG101) instead of raising, so a lint run over many
    specs reports them all.  ``cycles`` additionally enumerates a small
    concrete instantiation (``enum_env`` overrides the global guesses).
    ``jdf`` supplies an already-parsed AST so a multi-pass caller
    (``python -m parsec_tpu_torch.analysis``) parses each spec exactly
    once."""
    if jdf is None:
        from ..dsl.ptg.parser import JDFParseError, parse_jdf
        try:
            jdf = parse_jdf(text, name=name)
        except JDFParseError as exc:
            msg = str(exc)
            code = ("PTG101" if ("bad dep target" in msg
                                 or "unknown collection" in msg
                                 or "no flow named" in msg
                                 or "no task class" in msg) else "PTG100")
            return [Finding(code, msg, name)]
        except SyntaxError as exc:
            return [Finding("PTG100", str(exc), name)]
    findings = verify_jdf(jdf)
    if cycles and not any(f.severity == "error" for f in findings):
        findings.extend(check_cycles(text, name, env=enum_env, jdf=jdf))
    return findings
