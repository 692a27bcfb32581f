"""JDF unparser: AST back to canonical JDF text
(ref: parsec/interfaces/ptg/ptg-compiler/jdf_unparse.c — the reference
regenerates .jdf source from its AST for tooling and debugging; the
roundtrip parse(unparse(ast)) must preserve structure).
"""
from __future__ import annotations

from typing import List

from .ast import DepAST, DepTarget, JDFFile, RangeExpr, TaskClassAST


def _range_src(r) -> str:
    if isinstance(r, RangeExpr):
        s = f"{r.lo.src} .. {r.hi.src}"
        if r.step is not None:
            s += f" .. {r.step.src}"
        return s
    return r.src


def _target_src(t: DepTarget) -> str:
    if t.kind == "null":
        return "NULL"
    if t.kind == "new":
        return "NEW"
    args = ", ".join(_range_src(a) for a in t.args)
    if t.kind == "memory":
        return f"{t.collection}( {args} )"
    return f"{t.flow} {t.task_class}( {args} )"


def _prop_val(v: str) -> str:
    # quote anything the unquoted \S+ grammar could not re-read intact
    if v and " " not in v and "\t" not in v and '"' not in v and "]" not in v:
        return v
    return '"' + v.replace('"', "") + '"'


def _props_src(props) -> str:
    if not props:
        return ""
    inner = " ".join(f"{k}={_prop_val(v)}" for k, v in props.items())
    return f"  [{inner}]"


def _dep_src(d: DepAST) -> str:
    arrow = "<-" if d.direction == "in" else "->"
    body = _target_src(d.target)
    if d.guard is not None:
        body = f"({d.guard.src}) ? {body}"
        if d.alt_target is not None:
            body += f" : {_target_src(d.alt_target)}"
    return f"{arrow} {body}{_props_src(d.properties)}"


def unparse_task_class(tc: TaskClassAST) -> str:
    head = f"{tc.name}({', '.join(tc.params)})"
    head += _props_src(tc.properties)
    out: List[str] = [head, ""]
    for ld in tc.locals:
        if ld.range is not None:
            out.append(f"{ld.name} = {_range_src(ld.range)}")
        else:
            out.append(f"{ld.name} = {ld.expr.src}")
    out.append("")
    if tc.affinity_collection is not None:
        args = ", ".join(a.src for a in tc.affinity_args)
        out.append(f": {tc.affinity_collection}( {args} )")
        out.append("")
    for f in tc.flows:
        deps = f.deps
        head = f"{f.access:<5s} {f.name} "
        if deps:
            out.append(head + _dep_src(deps[0]))
            pad = " " * len(head)
            for d in deps[1:]:
                out.append(pad + _dep_src(d))
        else:
            out.append(head.rstrip())
    out.append("")
    if tc.priority is not None:
        out.append(f"; {tc.priority.src}")
        out.append("")
    for b in tc.bodies:
        props = _props_src(b.properties).strip()
        out.append(f"BODY {props}".rstrip())
        out.append("{")
        for line in b.code.splitlines():
            out.append(f"    {line}" if line.strip() else "")
        out.append("}")
        out.append("END")
        out.append("")
    return "\n".join(out)


def unparse(jdf: JDFFile) -> str:
    """Canonical JDF text for the whole file."""
    out: List[str] = []
    for block in jdf.prologue:
        # the grammar only recognizes externs with a language tag; the
        # block carries its own newlines, so emit delimiters inline for
        # an exact roundtrip
        out.append('extern "PYTHON" %{' + block + "%}")
        out.append("")
    for g in jdf.globals:
        props = _props_src(g.properties).strip()
        out.append(f"{g.name} {props}".rstrip())
    out.append("")
    for tc in jdf.task_classes:
        out.append(unparse_task_class(tc))
    for block in jdf.epilogue:
        out.append('extern "PYTHON" %{' + block + "%}")
        out.append("")
    return "\n".join(out) + "\n"
