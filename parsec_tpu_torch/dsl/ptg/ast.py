"""JDF AST + expression compilation.

Reference behavior: the PTG compiler parses ``.jdf`` files — globals with
properties, task classes with parameter ranges, derived locals, affinity,
guarded dataflow (incl. broadcast ranges), CTL flows, per-device BODY
sections, priority expressions — into an AST (``jdf.h``) checked by ``jdf.c``
(ref: parsec/interfaces/ptg/ptg-compiler/parsec.y:1-1345, jdf.h).

Re-design: expressions are Python (the reference embeds C and
compiles it; we embed Python and ``compile()`` it once per expression —
the "inline function" analog, ref jdf2c.c:8038). C-style ``&&``, ``||``,
``!`` are transliterated so reference-style guards read naturally.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

_C2PY = [
    (re.compile(r"&&"), " and "),
    (re.compile(r"\|\|"), " or "),
    (re.compile(r"!(?![=])"), " not "),
    (re.compile(r"%\{\s*return\s+(.*?);?\s*%\}", re.S), r"(\1)"),
]


def c2py(expr: str) -> str:
    expr = expr.strip()
    for pat, rep in _C2PY:
        expr = pat.sub(rep, expr)
    return expr.strip()


class Expr:
    """One compiled expression evaluated against {globals+locals}.

    ``origin`` is the source context the parser threads through
    (``file:line task.flow``); it becomes the compile filename, so both
    compile-time SyntaxErrors and runtime tracebacks point at the JDF
    line that wrote the expression instead of a truncated ``<jdf:...>``
    tag."""

    __slots__ = ("src", "origin", "_code")

    def __init__(self, src: str, origin: Optional[str] = None) -> None:
        self.src = c2py(src)
        self.origin = origin
        try:
            self._code = compile(self.src, origin or f"<jdf:{self.src[:40]}>",
                                 "eval")
        except SyntaxError as e:
            where = f"{origin}: " if origin else ""
            raise SyntaxError(
                f"{where}bad JDF expression {src!r}: {e}") from None

    def __call__(self, env: Dict[str, Any]) -> Any:
        try:
            return eval(self._code, {"__builtins__": _SAFE_BUILTINS}, env)
        except NameError as e:
            # rewrap only when the name is missing from the expression's
            # own eval frame (tb: __call__ -> eval'd code, nothing
            # deeper); a NameError raised inside a helper the expression
            # calls keeps its real traceback pointing at the helper
            tb = e.__traceback__
            if self.origin is None or tb is None or tb.tb_next is None \
                    or tb.tb_next.tb_next is not None:
                raise
            raise NameError(f"{self.origin}: {e} in {self.src!r}") from None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Expr({self.src!r})"


_SAFE_BUILTINS = {
    "abs": abs, "min": min, "max": max, "int": int, "float": float,
    "range": range, "len": len, "divmod": divmod, "round": round,
    "True": True, "False": False, "None": None,
}


def split_top(s: str, sep: str) -> List[str]:
    """Split on sep at paren/bracket depth 0."""
    parts, depth, cur, i = [], 0, [], 0
    n, ls = len(s), len(sep)
    while i < n:
        ch = s[i]
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if depth == 0 and s.startswith(sep, i):
            parts.append("".join(cur))
            cur = []
            i += ls
            continue
        cur.append(ch)
        i += 1
    parts.append("".join(cur))
    return parts


@dataclass
class RangeExpr:
    """``lo .. hi [.. step]`` — inclusive, like JDF ranges."""
    lo: Expr
    hi: Expr
    step: Optional[Expr] = None

    def values(self, env: Dict[str, Any]):
        lo, hi = self.lo(env), self.hi(env)
        st = self.step(env) if self.step is not None else 1
        return range(lo, hi + (1 if st > 0 else -1), st)

    @staticmethod
    def parse(src: str, origin: Optional[str] = None) -> "RangeExpr | Expr":
        parts = split_top(src, "..")
        if len(parts) == 1:
            return Expr(src, origin)
        if len(parts) == 2:
            return RangeExpr(Expr(parts[0], origin), Expr(parts[1], origin))
        if len(parts) == 3:
            return RangeExpr(Expr(parts[0], origin), Expr(parts[1], origin),
                             Expr(parts[2], origin))
        raise SyntaxError(f"{origin + ': ' if origin else ''}bad range: {src!r}")


@dataclass
class GlobalDef:
    name: str
    properties: Dict[str, str] = field(default_factory=dict)

    @property
    def hidden(self) -> bool:
        return self.properties.get("hidden", "").lower() in ("on", "true", "1")

    @property
    def default(self) -> Optional[Expr]:
        d = self.properties.get("default")
        return Expr(d) if d is not None else None


@dataclass
class LocalDef:
    """``k = 0 .. NB [.. step]`` (a parameter range) or ``loc = expr``
    (a derived local)."""
    name: str
    range: Optional[RangeExpr]    # None for derived locals
    expr: Optional[Expr] = None   # set for derived locals


@dataclass
class DepTarget:
    """Where a dependency edge points."""
    kind: str                     # "task" | "memory" | "new" | "null"
    collection: Optional[str] = None     # memory: global name of collection
    task_class: Optional[str] = None     # task: peer class name
    flow: Optional[str] = None           # task: peer flow name
    args: List[Any] = field(default_factory=list)  # Expr | RangeExpr


@dataclass
class DepAST:
    """``[guard ?] target [: alt_target]`` with optional [type=...] props."""
    direction: str                # "in" | "out"
    guard: Optional[Expr]
    target: DepTarget
    alt_target: Optional[DepTarget] = None
    properties: Dict[str, str] = field(default_factory=dict)

    def resolve(self, env: Dict[str, Any]) -> Optional[DepTarget]:
        """Pick the applicable target for this instance (None == no edge)."""
        if self.guard is None:
            return self.target
        if self.guard(env):
            return self.target
        return self.alt_target  # may be None: guarded single-target dep


@dataclass
class FlowAST:
    name: str
    access: str                   # "RW" | "READ" | "WRITE" | "CTL"
    deps: List[DepAST] = field(default_factory=list)

    @property
    def is_ctl(self) -> bool:
        return self.access == "CTL"

    def deps_in(self) -> List[DepAST]:
        return [d for d in self.deps if d.direction == "in"]

    def deps_out(self) -> List[DepAST]:
        return [d for d in self.deps if d.direction == "out"]


@dataclass
class BodyAST:
    code: str
    properties: Dict[str, str] = field(default_factory=dict)
    # compiled lazily by the runtime
    _compiled: Any = None
    # 1-based source line of the BODY keyword (0 = unknown): threaded by
    # the parser so body lints report real spec lines
    line: int = 0

    @property
    def device_type(self) -> str:
        return self.properties.get("type", "cpu").lower()

    @property
    def stacked(self) -> bool:
        """``BODY [... batch=stacked]``: the body takes a leading batch
        dimension, so a batched dispatch may run it once over stacked
        tiles; any other body keeps single-tile semantics."""
        return self.properties.get("batch", "").lower() == "stacked"


@dataclass
class TaskClassAST:
    name: str
    params: List[str]
    properties: Dict[str, str] = field(default_factory=dict)
    locals: List[LocalDef] = field(default_factory=list)
    affinity_collection: Optional[str] = None
    affinity_args: List[Expr] = field(default_factory=list)
    flows: List[FlowAST] = field(default_factory=list)
    priority: Optional[Expr] = None
    bodies: List[BodyAST] = field(default_factory=list)

    def locals_from_param_args(self, arg_values) -> tuple:
        """Translate positional dep-target args (which follow this class's
        PARAM list, e.g. ``P RPANEL( m, k )``) into the locals tuple
        (range definitions in declaration order). The two orders can
        differ; producer-driven activation never notices, but any
        consumer-side instance lookup must translate."""
        arg_values = tuple(arg_values)
        if len(self.params) != len(arg_values):
            return arg_values
        by_name = dict(zip(self.params, arg_values))
        out = []
        for ld in self.locals:
            if ld.range is None:
                continue
            if ld.name not in by_name:
                return arg_values  # non-param range local: keep positional
            out.append(by_name[ld.name])
        return tuple(out)

    def flow_by_name(self, name: str) -> FlowAST:
        for f in self.flows:
            if f.name == name:
                return f
        raise KeyError(f"{self.name}: no flow named {name}")


@dataclass
class JDFFile:
    name: str
    prologue: List[str] = field(default_factory=list)   # python code blocks
    epilogue: List[str] = field(default_factory=list)
    globals: List[GlobalDef] = field(default_factory=list)
    task_classes: List[TaskClassAST] = field(default_factory=list)

    def task_class_by_name(self, name: str) -> TaskClassAST:
        for tc in self.task_classes:
            if tc.name == name:
                return tc
        raise KeyError(f"no task class {name} in {self.name}")


def parse_properties(src: str) -> Dict[str, str]:
    """``[ key=value key2="value" ]`` property lists."""
    props: Dict[str, str] = {}
    src = src.strip()
    if src.startswith("["):
        src = src[1:]
    if src.endswith("]"):
        src = src[:-1]
    for m in re.finditer(r'(\w+)\s*=\s*("([^"]*)"|\S+)', src):
        key = m.group(1)
        val = m.group(3) if m.group(3) is not None else m.group(2)
        props[key] = val
    return props
